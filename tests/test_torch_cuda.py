"""The port's Hopper kernels on the card (marker ``cuda``; skip without one).

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: codec bit-equal to the plain version; f64 contractions within
1e-12 relative, f32 within 1e-5 (the same products summed in another
order); the ELL SpMV and the Givens step bit-equal (the same operations in
the same order); solves within one iteration of the plain route, two kernel
solves bit-equal (the kernels use no float atomics), and a graph-replayed
device-driver solve bit-equal to the host driver's.
"""
import pytest
import torch

from repro_torch.core import frsz2 as F
from repro_torch.core.accessor import format_by_name
from repro_torch.kernels import ops
from repro_torch.solver import gmres
from repro_torch.sparse import make_problem, rhs_for


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,bs", [(torch.float64, 32, 32),
                                        (torch.float32, 16, 128),
                                        (torch.float64, 8, 1)])
def test_kernels_match_plain_on_card(cuda, dtype, l, bs):
    gen = torch.Generator(device=cuda).manual_seed(0)
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    x = torch.randn((9, 3001), generator=gen, dtype=dtype, device=cuda)
    ops.reset_launches()
    bk = ops.compress(x, spec)
    bp = ops.compress(x, spec, kernel=False)
    assert torch.equal(bk.codes, bp.codes) and torch.equal(bk.exps, bp.exps)
    assert torch.equal(ops.decompress(bk), ops.decompress(bp, kernel=False))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for fn, v in ((ops.matvec, x[0]), (ops.rmatvec, x[:, 0])):
        yk, yp = fn(bk, v), fn(bk, v, kernel=False)
        assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())
    assert all(c == 1 for k, c in ops.LAUNCHES.items()
               if k.startswith("frsz2_")), ops.LAUNCHES


@pytest.mark.cuda
def test_solve_on_card_matches_plain_route_and_repeats(cuda):
    A, target = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    ops.reset_launches()
    r1 = gmres(A, b, storage="frsz2_32", m=40, target_rrn=target)
    # the device driver hands each basis row to the ELL kernel coded, so it
    # decompresses no row; every other kernel runs
    assert ops.LAUNCHES["frsz2_decompress"] == 0, ops.LAUNCHES
    assert all(v > 0 for k, v in ops.LAUNCHES.items()
               if k != "frsz2_decompress"), ops.LAUNCHES
    r2 = gmres(A, b, storage="frsz2_32", m=40, target_rrn=target)
    rp = gmres(A, b, storage=format_by_name("frsz2_32", use_kernels=False),
               m=40, target_rrn=target)
    assert r1.converged and rp.converged
    assert abs(r1.iterations - rp.iterations) <= 1
    assert r1.iterations == r2.iterations and torch.equal(r1.x, r2.x)


@pytest.mark.cuda
@pytest.mark.parametrize("vdt,spec", [
    (torch.float64, None), (torch.float32, None),
    (torch.float64, F.FrszSpec(bs=32, l=32, dtype=torch.float64)),
    (torch.float64, F.FrszSpec(bs=128, l=16, dtype=torch.float64)),
    (torch.float32, F.FrszSpec(bs=8, l=8, dtype=torch.float32))])
def test_ell_kernels_match_plain_on_card(cuda, vdt, spec):
    """Both sum each row in slot order: the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    nr, nc, w = 1000, 1337, 9
    cols = torch.randint(0, nc, (nr, w), generator=gen, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn((nr, w), generator=gen, dtype=vdt, device=cuda)
    cols[:, 6:] = 0                        # padding slots: val 0, col 0
    vals[:, 6:] = 0.0
    vals[7] = 0.0                          # an empty row
    x = torch.randn((nc,), generator=gen, dtype=vdt, device=cuda)
    op = x if spec is None else ops.compress(x.to(spec.dtype), spec)
    ops.reset_launches()
    yk = ops.ell_spmv(vals, cols, op)
    yp = ops.ell_spmv(vals, cols, op, kernel=False)
    assert torch.equal(yk, yp)
    key = "ell_spmv" if spec is None else "ell_spmv_frsz2"
    assert ops.LAUNCHES[key] == 1 and sum(ops.LAUNCHES.values()) == 1


@pytest.mark.cuda
def test_givens_kernel_matches_plain_on_card(cuda):
    from repro_torch.kernels import ref

    gen = torch.Generator(device=cuda).manual_seed(2)
    m = 30
    L = ref.givens_layout(m)
    sk, sp = ref.givens_init_ref(m, cuda), ref.givens_init_ref(m, cuda)
    sk[L["g"]] = sp[L["g"]] = 2.0
    b_norm = torch.tensor(2.0, dtype=torch.float64, device=cuda)
    for j in range(m):
        h = torch.randn((j + 1,), generator=gen, dtype=torch.float64,
                        device=cuda)
        hj1 = torch.rand((), generator=gen, dtype=torch.float64, device=cuda)
        w_pre = 2 * hj1
        fired = torch.tensor(j % 3 == 0, device=cuda)
        # the target stops the cycle part way: dead steps are covered too
        for s, k in ((sk, True), (sp, False)):
            ops.givens_step(s, h, hj1, w_pre, fired, b_norm, j, m, 1e-4,
                            kernel=k)
    assert torch.equal(sk, sp)


@pytest.mark.cuda
def test_graph_replayed_device_solve_equals_host_solve(cuda):
    A, target = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    for fmt in ("frsz2_32", "float64"):
        rh = gmres(A, b, storage=fmt, m=40, target_rrn=target, driver="host")
        ops.reset_launches()
        r1 = gmres(A, b, storage=fmt, m=40, target_rrn=target)  # captures
        r2 = gmres(A, b, storage=fmt, m=40, target_rrn=target)  # replays
        assert ops.LAUNCHES["gmres_givens"] > 0
        for rd in (r1, r2):
            assert (rd.iterations, rd.restarts) == (rh.iterations, rh.restarts)
            assert rd.bytes_read == rh.bytes_read
            assert rd.op_reads == rh.op_reads
            assert torch.equal(rd.x, rh.x)
