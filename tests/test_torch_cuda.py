"""The port's Hopper kernels on the card (marker ``cuda``; skip without one).

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: codec bit-equal to the plain version; f64 contractions within
1e-12 relative, f32 within 1e-5 (the same products summed in another
order); solves within one iteration of the plain route, and two kernel
solves bit-equal (the kernels use no float atomics).
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
    assert all(c == 1 for c in ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.cuda
def test_solve_on_card_matches_plain_route_and_repeats(cuda):
    A, target = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    ops.reset_launches()
    r1 = gmres(A, b, storage="frsz2_32", m=40, target_rrn=target)
    assert all(v > 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
    r2 = gmres(A, b, storage="frsz2_32", m=40, target_rrn=target)
    rp = gmres(A, b, storage=format_by_name("frsz2_32", use_kernels=False),
               m=40, target_rrn=target)
    assert r1.converged and rp.converged
    assert abs(r1.iterations - rp.iterations) <= 1
    assert r1.iterations == r2.iterations and torch.equal(r1.x, r2.x)
