"""The port's Hopper kernels on the card (marker ``cuda``; skip without one).

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerances: codec bit-equal to the plain version; f64 contractions within
1e-12 relative, f32 within 1e-5 (the same products summed in another
order); the ELL SpMV and the Givens step bit-equal (the same operations in
the same order); solves within one iteration of the plain route, two kernel
solves bit-equal (the kernels use no float atomics), and a graph-replayed
device-driver solve bit-equal to the host driver's.  The block kernels:
f64 block contractions within 1e-12 relative (f32 1e-5), the batched ELL
and the block Givens step bit-equal, and the block device driver's solve
(captured, then replayed) bit-equal to the block host driver's.  The
scaled FRSZ2 decode inside the ELL kernel bit-equal to decompress (after
``+ 0.0``) on every l = 16 code, the compiled ELL widths (7, 27) bit-equal
to plain and to a second call, and the block dots with one-hot rows of W
equal to the decoded basis and to a second call.  The
decode attention: with f32 q within 1e-5 of its plain version, relative
to the largest output (f32 sums in another order, base-2 exponentials);
with bf16 q within 2^-7 (one bf16 step); a cache written on the card bit-equal to one written on the
CPU; yi-9b ``reduced()`` decode logits on the card within 1e-3 of the CPU's
(relative to the largest logit: f32 matrix products in another order).
The redesigned matvec and block combine: the matvec within 1e-12 (f64) /
1e-5 (f32) of its plain version at rows 1..101 across its row-ring and
row-group edges, two calls bit-equal, x one-hot equal
to the decoded basis; the combine bit-equal to the row-order plain sum
(``ref.block_combine_rows_ref``: the first combine kernel's sum) at M = 8
... 808, one-hot rows of Y equal to the decoded basis; both across the
scaled decode's guard (exponents in the flush zone and past 2*bias) equal
to ``decompress``, NaN where it is NaN.  A float16 basis write on the card
bit-equal to numpy's single rounding.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import frsz2 as F
from repro_torch.core.accessor import (BasisAccessor, BlockBasisAccessor,
                                      NativeFormat, format_by_name)
from repro_torch.kernels import cardcheck, ops, ref
from repro_torch.kernels.cardcheck import EDGE_ROWS, same_values
from repro_torch.solver import gmres, gmres_batched
from repro_torch.sparse import make_problem, rhs_for
from repro_torch.configs import get_arch
from repro_torch.models import decode_step, init_params, kvcache, prefill


#: the scalar FRSZ2 codec and contraction kernels; the scalar device path;
#: the kernels only the block path launches
SCALAR_CODEC = ("frsz2_compress", "frsz2_decompress", "frsz2_matvec",
                "frsz2_rmatvec")
SCALAR_DEVICE_PATH = ("frsz2_compress", "frsz2_matvec", "frsz2_rmatvec",
                      "ell_spmv", "ell_spmv_frsz2", "gmres_givens")
BLOCK_ONLY = ("frsz2_block_dots", "frsz2_block_combine", "gmres_block_givens")


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
    assert all(ops.LAUNCHES[k] == 1 for k in SCALAR_CODEC), ops.LAUNCHES
    assert not any(ops.LAUNCHES[k] for k in BLOCK_ONLY), ops.LAUNCHES


@pytest.mark.cuda
def test_solve_on_card_matches_plain_route_and_repeats(cuda):
    A, target = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    ops.reset_launches()
    r1 = gmres(A, b, storage="frsz2_32", m=40, target_rrn=target)
    # the device driver hands each basis row to the ELL kernel coded, so it
    # decompresses no row; every other kernel of the scalar path runs, and
    # no kernel of the block path
    assert ops.LAUNCHES["frsz2_decompress"] == 0, ops.LAUNCHES
    assert all(ops.LAUNCHES[k] > 0 for k in SCALAR_DEVICE_PATH), ops.LAUNCHES
    assert not any(ops.LAUNCHES[k] for k in BLOCK_ONLY), ops.LAUNCHES
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
@pytest.mark.parametrize("vdt,w,offset", [(torch.float64, 7, 0),
                                          (torch.float64, 7, 1),
                                          (torch.float32, 27, 0),
                                          (torch.float64, 27, 1)])
def test_ell_compiled_widths_match_plain_on_card(cuda, vdt, w, offset):
    """The widths compiled in (7, 27): a ragged last warp tile, tiles that
    do not start 16-byte aligned (``offset`` rows into a larger array),
    dense, coded and batched operands; bit-equal to plain and to a second
    call."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    nr, nc = 1001, 1337
    cols = torch.randint(0, nc, (nr + offset, w), generator=gen, device=cuda,
                         dtype=torch.int32)[offset:]
    vals = torch.randn((nr + offset, w), generator=gen, dtype=vdt,
                       device=cuda)[offset:]
    x = torch.randn((nc,), generator=gen, dtype=vdt, device=cuda)
    X = torch.randn((3, nc), generator=gen, dtype=vdt, device=cuda)
    for op in (x, X, ops.compress(x, F.FrszSpec(bs=32, l=32, dtype=vdt)),
               ops.compress(x, F.FrszSpec(bs=64, l=16, dtype=vdt))):
        yk = ops.ell_spmv(vals, cols, op)
        assert torch.equal(yk, ops.ell_spmv(vals, cols, op, kernel=False))
        assert torch.equal(yk, ops.ell_spmv(vals, cols, op))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ibits", [(torch.float64, torch.int64),
                                         (torch.float32, torch.int32)])
def test_scaled_decode_through_ell_on_card(cuda, dtype, ibits):
    """An identity operator on a coded vector of every l = 16 code under
    exponents in the flush zone, on the guard's edges, inside it and at
    2*bias+1: the ELL kernel's scaled decode gives the bits of decompress
    (after ``+ 0.0``, which both sides take alike)."""
    bias = 1023 if dtype == torch.float64 else 127
    c = torch.arange(1 << 16, device=cuda)
    codes = (c - (c >= (1 << 15)).long() * (1 << 16)).to(torch.int16)
    emax = torch.tensor([0, 1, 14, 15, 16, 40, bias, 2 * bias - 1, 2 * bias,
                         2 * bias + 1], dtype=torch.int32, device=cuda)
    bs = 32
    per = codes.numel() // bs
    bc = F.BlockCompressed(codes=codes.reshape(per, bs).repeat(emax.numel(), 1),
                           exps=emax.repeat_interleave(per), n=emax.numel()
                           * codes.numel(),
                           spec=F.FrszSpec(bs=bs, l=16, dtype=dtype))
    want = (ops.decompress(bc) + 0.0).view(ibits)
    for w in (7, 1):
        cols = torch.zeros((bc.n, w), dtype=torch.int32, device=cuda)
        cols[:, 0] = torch.arange(bc.n, dtype=torch.int32, device=cuda)
        vals = torch.zeros((bc.n, w), dtype=dtype, device=cuda)
        vals[:, 0] = 1.0
        got = (ops.ell_spmv(vals, cols, bc) + 0.0).view(ibits)
        assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
def test_block_dots_one_hot_and_repeat_on_card(cuda):
    """One-hot rows of W pick the decoded basis at their columns; two calls
    give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    m, p, n = 5, 8, 9000
    acc = BlockBasisAccessor(fmt=format_by_name("frsz2_32", bs=32,
                                                arith_dtype=torch.float64),
                             m=m, p=p, n=n, arith_dtype=torch.float64,
                             device=cuda)
    store = acc.empty()
    for j in range(m):
        acc.write_block(store, j, torch.randn((p, n), generator=gen,
                                              dtype=torch.float64,
                                              device=cuda))
    bc = F.BlockCompressed(codes=store["codes"], exps=store["exps"],
                           n=acc.n_flat, spec=spec)
    at = [0, 31, 32, 255, 256, 4097, 8191, n - 1]
    W = torch.zeros((p, n), dtype=torch.float64, device=cuda)
    W[torch.arange(p), torch.tensor(at)] = 1.0
    H = ops.block_dots(bc, W, p=p, rows=m)
    V = ops.decompress(bc).reshape(m, p, -1)[:, :, :n]
    for b, c in enumerate(at):
        assert torch.equal(H[:, :, b], V[:, :, c])
    Wr = torch.randn((p, n), generator=gen, dtype=torch.float64, device=cuda)
    assert torch.equal(ops.block_dots(bc, Wr, p=p, rows=m),
                       ops.block_dots(bc, Wr, p=p, rows=m))


@pytest.mark.cuda
def test_givens_kernel_matches_plain_on_card(cuda):
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,bs,p", [(torch.float64, 32, 32, 8),
                                          (torch.float64, 16, 64, 3),
                                          (torch.float32, 32, 8, 1),
                                          (torch.float64, 8, 128, 16)])
def test_block_kernels_match_plain_on_card(cuda, dtype, l, bs, p):
    gen = torch.Generator(device=cuda).manual_seed(4)
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    m, n = 9, 3001
    acc = BlockBasisAccessor(fmt=format_by_name(f"frsz2_{l}", bs=bs,
                                                arith_dtype=dtype),
                             m=m, p=p, n=n, arith_dtype=dtype, device=cuda)
    store = acc.empty()
    for j in range(m):
        acc.write_block(store, j, torch.randn((p, n), generator=gen,
                                              dtype=dtype, device=cuda))
    bc = F.BlockCompressed(codes=store["codes"], exps=store["exps"],
                           n=acc.n_flat, spec=spec)
    W = torch.randn((p, n), generator=gen, dtype=dtype, device=cuda)
    Y = torch.randn((m, p, p), generator=gen, dtype=dtype, device=cuda)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    ops.reset_launches()
    for rows in (m, 4):
        hk = ops.block_dots(bc, W, p=p, rows=rows)
        hp = ops.block_dots(bc, W, p=p, rows=rows, kernel=False)
        assert float((hk - hp).abs().max()) <= tol * float(hp.abs().max())
        ok = ops.block_combine(bc, Y[:rows], p=p)
        op = ops.block_combine(bc, Y[:rows], p=p, kernel=False)
        assert float((ok - op).abs().max()) <= tol * float(op.abs().max())
        assert not ok[:, n:].any()                 # segment padding
    assert ops.LAUNCHES["frsz2_block_dots"] == 2
    assert ops.LAUNCHES["frsz2_block_combine"] == 2


@pytest.mark.cuda
def test_batched_ell_and_block_givens_match_plain_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    A, _ = make_problem("synth:atmosmod", 4096, device=cuda)
    E = A.to_ell()
    X = torch.randn((5, A.shape[0]), generator=gen, dtype=torch.float64,
                    device=cuda)
    ops.reset_launches()
    assert torch.equal(ops.ell_spmv(E.vals, E.cols, X),
                       ops.ell_spmv(E.vals, E.cols, X, kernel=False))
    assert ops.LAUNCHES["ell_spmv"] == 1
    m, p = 12, 4
    L = ref.block_givens_layout(m, p)
    sk = ref.block_givens_init_ref(m, p, cuda)
    sk[L["G"]:L["G"] + p * p] = torch.eye(p, device=cuda).reshape(-1)
    sp = sk.clone()
    bn = torch.ones((p,), dtype=torch.float64, device=cuda)
    for j in range(m):
        H = torch.randn((j + 1, p, p), generator=gen, dtype=torch.float64,
                        device=cuda)
        T = torch.triu(torch.randn((p, p), generator=gen, dtype=torch.float64,
                                   device=cuda))
        if j == 3:
            T[2] = 0.0                             # a deflated direction
        fired = torch.tensor(j % 2 == 1, device=cuda)
        # the target stops the cycle part way: dead steps are covered too
        for s, k in ((sk, True), (sp, False)):
            ops.block_givens_step(s, H, T, fired, bn, j, m, p, 1e-3, kernel=k)
        assert torch.equal(sk, sp), j


@pytest.mark.cuda
def test_graph_replayed_block_solve_equals_host_solve(cuda):
    A, target = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    t = torch.arange(b.shape[0], dtype=b.dtype, device=cuda)
    B = torch.stack([b, b * 1.1 + 0.05 * torch.sin(2 * t), torch.cos(t)])
    for fmt in ("frsz2_32", "float64"):
        kw = dict(storage=fmt, m=30, target_rrn=target, method="block")
        rh = gmres_batched(A, B, driver="host", **kw)
        ops.reset_launches()
        r1 = gmres_batched(A, B, **kw)                         # captures
        r2 = gmres_batched(A, B, **kw)                         # replays
        assert ops.LAUNCHES["gmres_block_givens"] > 0
        if fmt == "frsz2_32":
            assert ops.LAUNCHES["frsz2_block_dots"] > 0
            assert ops.LAUNCHES["frsz2_matvec"] == 0
        for rd in (r1, r2):
            for a, c in zip(rd, rh):
                assert a.converged
                assert (a.iterations, a.restarts) == (c.iterations,
                                                      c.restarts)
                assert (a.bytes_read, a.op_reads) == (c.bytes_read,
                                                      c.op_reads)
                assert torch.equal(a.x, c.x)


def _coded_kv(gen, B, Hkv, S, D, l, exp_dtype, dev):
    spec = F.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest",
                      exp_dtype=exp_dtype)
    bcs = []
    for _ in range(2):
        x = torch.randn((B, Hkv, S, D), generator=gen, device=dev)
        bc = ops.compress(x, spec)
        bcs.append(F.BlockCompressed(codes=bc.codes, exps=bc.exps, n=D,
                                     spec=spec))
    return bcs


@pytest.mark.cuda
@pytest.mark.parametrize("D,l,G,exp_dtype,qdt", [
    (128, 16, 8, torch.uint8, torch.float32),
    (128, 8, 8, torch.uint8, torch.bfloat16),
    (64, 16, 2, torch.int32, torch.float32),
    (64, 8, 1, torch.uint8, torch.float32),
    (128, 16, 3, torch.uint8, torch.float32),
    (128, 16, 12, torch.int32, torch.bfloat16)])
def test_decode_attention_matches_plain_on_card(cuda, D, l, G, exp_dtype,
                                                qdt):
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, Hkv, S = 3, 2, 1000
    kbc, vbc = _coded_kv(gen, B, Hkv, S, D, l, exp_dtype, cuda)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda).to(qdt)
    lengths = torch.tensor([1, 517, S], dtype=torch.int32, device=cuda)
    ops.reset_launches()
    ok = ops.decode_attention(q, kbc, vbc, lengths)
    assert ops.LAUNCHES["decode_attn"] == 1
    op = ops.decode_attention(q, kbc, vbc, lengths, kernel=False)
    assert ok.dtype == op.dtype == qdt
    err = float((ok.float() - op.float()).abs().max())
    if qdt == torch.float32:
        assert err <= 1e-5 * float(op.abs().max())
    else:
        assert err <= 2 ** -7
    assert torch.equal(ok, ops.decode_attention(q, kbc, vbc, lengths))


@pytest.mark.cuda
def test_kv_cache_and_decode_on_card_match_cpu(cuda):
    cfg = get_arch("yi-9b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 25),
                           generator=torch.Generator().manual_seed(1))

    def to(tree):
        return ({k: to(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.to(cuda))

    on_card = to(params)
    lc, cc = prefill(params, cfg, tokens[:, :24], cache_len=32)
    lg, cg = prefill(on_card, cfg, tokens[:, :24].to(cuda), cache_len=32)
    assert float((lg.cpu() - lc).abs().max()) <= 1e-3 * float(lc.abs().max())
    ops.reset_launches()
    dc, cc = decode_step(params, cfg, cc, tokens[:, 24])
    dg, cg = decode_step(on_card, cfg, cg, tokens[:, 24].to(cuda))
    assert ops.LAUNCHES["decode_attn"] == cfg.num_layers
    assert ops.LAUNCHES["frsz2_compress"] == 2 * cfg.num_layers
    assert float((dg.cpu() - dc).abs().max()) <= 1e-3 * float(dc.abs().max())
    # the compress kernel writes the plain codec's bits: the same K/V
    # written on the card and on the CPU give the same cache
    fmt = kvcache.cache_format(cfg.kv_format)
    x = torch.randn((2, 5, 2, cfg.hd), generator=torch.Generator()
                    .manual_seed(2))
    lens = torch.tensor([3, 7], dtype=torch.int32)
    caches = []
    for dev in ("cpu", cuda):
        c = {n: t[0] for n, t in kvcache.init_cache(fmt, 1, 2, 2, 16, cfg.hd,
                                                    device=dev).items()}
        kvcache.append(c, x.to(dev), (2 * x).to(dev), lens.to(dev), fmt)
        caches.append(c)
    for n in caches[0]:
        assert torch.equal(caches[0][n], caches[1][n].cpu()), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,bs,n", [(torch.float64, 32, 32, 20011),
                                          (torch.float64, 16, 128, 4096),
                                          (torch.float64, 8, 8, 3001),
                                          (torch.float64, 32, 1, 3001),
                                          (torch.float32, 32, 32, 5003),
                                          (torch.float32, 16, 8, 2048)])
def test_matvec_rows_and_one_hot_on_card(cuda, dtype, l, bs, n):
    gen = torch.Generator(device=cuda).manual_seed(12)
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    V = torch.randn((101, n), generator=gen, dtype=dtype, device=cuda)
    bc = ops.compress(V, spec)
    x = torch.randn((n,), generator=gen, dtype=dtype, device=cuda)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for r in EDGE_ROWS:
        sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r], n=n,
                                spec=spec)
        ops.reset_launches()
        yk = ops.matvec(sub, x)
        assert ops.LAUNCHES["frsz2_matvec"] == 1
        yp = ops.matvec(sub, x, kernel=False)
        assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())
        assert torch.equal(yk, ops.matvec(sub, x))
    Vd = ops.decompress(bc)
    for c in (0, 1, 3, 4, 1023, 1024, n - 1):
        e = torch.zeros_like(x)
        e[c] = 1.0
        assert same_values(ops.matvec(bc, e), Vd[:, c].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bias", cardcheck.GUARD_DTYPES)
@pytest.mark.parametrize("l", [32, 16, 8])
def test_matvec_and_combine_across_the_decode_guard_on_card(cuda, dtype,
                                                            bias, l):
    """Exponents in the flush zone, on the guard's edges and past 2*bias:
    the matvec (a code in one column, x one-hot there) and the combine (one
    segment row, Y = 1) give the decoded values."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    bad, _ = cardcheck.matvec_across_guard(dtype, bias, l, gen)
    assert not bad
    ok, _ = cardcheck.combine_across_guard(dtype, bias, l, gen)
    assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,bs,p,n", [(torch.float64, 32, 32, 8, 9000),
                                            (torch.float64, 16, 128, 3, 3001),
                                            (torch.float64, 8, 8, 16, 1001),
                                            (torch.float64, 32, 1, 1, 2000),
                                            (torch.float32, 32, 32, 8, 4096),
                                            (torch.float32, 16, 8, 3, 777)])
def test_block_combine_row_order_bits_on_card(cuda, dtype, l, bs, p, n):
    """The combine is the row-order fma sum bit for bit at every row count,
    repeats its bits, and one-hot rows of Y give the decoded basis rows."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    m = max(EDGE_ROWS)
    acc = BlockBasisAccessor(fmt=format_by_name(f"frsz2_{l}", bs=bs,
                                                arith_dtype=dtype),
                             m=m, p=p, n=n, arith_dtype=dtype, device=cuda)
    store = acc.empty()
    for j in range(m):
        acc.write_block(store, j, torch.randn((p, n), generator=gen,
                                              dtype=dtype, device=cuda))
    bc = F.BlockCompressed(codes=store["codes"], exps=store["exps"],
                           n=acc.n_flat, spec=spec)
    Y = torch.randn((m, p, p), generator=gen, dtype=dtype, device=cuda)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for rows in EDGE_ROWS:
        ops.reset_launches()
        got = ops.block_combine(bc, Y[:rows], p=p)
        assert ops.LAUNCHES["frsz2_block_combine"] == 1
        codes, exps, _ = ops._block_view(bc, p, rows)
        want = ref.block_combine_rows_ref(codes, exps,
                                          Y[:rows].reshape(rows * p, p), spec)
        assert torch.equal(got, want), rows
        plain = ops.block_combine(bc, Y[:rows], p=p, kernel=False)
        assert float((got - plain).abs().max()) <= tol * float(
            plain.abs().max())
        assert torch.equal(got, ops.block_combine(bc, Y[:rows], p=p))
    M = m * p
    at = [i for i in (0, 7, 8, 127, 128, 129, 511) if i < M - 1][:p - 1]
    at.append(M - 1)
    Y1 = torch.zeros_like(Y)
    for b, i in enumerate(at):
        Y1[i // p, i % p, b] = 1.0
    out = ops.block_combine(bc, Y1, p=p)
    V = ops.decompress(bc).reshape(M, acc.n_seg)
    for b, i in enumerate(at):
        assert same_values(out[b], V[i])


@pytest.mark.cuda
def test_float16_basis_write_rounds_once_on_card(cuda):
    rng = np.random.default_rng(15)
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    x = np.concatenate([rng.standard_normal(200_000), ties + 2.0 ** -40,
                        ties - 2.0 ** -40, [65519.99, 65520.0, 1e300,
                                            2.0 ** -25, 1.5 * 2.0 ** -24]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float16).view(np.int16)
    acc = BasisAccessor(fmt=NativeFormat(dtype=torch.float16), m=1, n=x.size,
                        device=cuda)
    store = acc.empty()
    acc.write_row(store, 0, torch.from_numpy(x).to(cuda))
    assert np.array_equal(store[0].cpu().numpy().view(np.int16), want)
