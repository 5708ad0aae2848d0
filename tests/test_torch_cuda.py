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
The redesigned rmatvec bit-equal to its row-order plain sum
(``ref.rmatvec_rows_ref``) at rows 1..101, at every f32/f64 codec spot, on
codes at an offset, across the decode guard, in a graph replay.
The redesigned matvec and block combine: the matvec within 1e-12 (f64) /
1e-5 (f32) of its plain version at rows 1..101 across its row-ring and
row-group edges, two calls bit-equal, x one-hot equal
to the decoded basis; the combine bit-equal to the row-order plain sum
(``ref.block_combine_rows_ref``: the first combine kernel's sum) at M = 8
... 808, one-hot rows of Y equal to the decoded basis; both across the
scaled decode's guard (exponents in the flush zone and past 2*bias) equal
to ``decompress``, NaN where it is NaN.  A float16 basis write on the card
bit-equal to numpy's f64 -> f32 -> f16 (the JAX reference's rounding).  The redesigned batched ELL (the
matrix read once for all q columns) bit-equal to plain and to a second call
at q 1..16, w 5/7/27, f32/f64, aligned or not.  The redesigned decode
attention at lengths across its 64-position tiles and its splits (with an
empty row, S not a multiple of the tile), a cache of more than one block a
row, and K/V blocks across the scaled decode's guard: V rows equal to
``decompress``, K within 1e-5 of plain; on a wrapped ring cache at G = 5
and 6 against the masked softmax; its split rule's wave from the
kernel's occupancy query.  The redesigned row codec bit-equal to the
plain codec at 65,536 and 70,000 rows (one launch each), at a ragged n for
every spot of ``cardcheck.CODEC_SPOTS`` in both roundings and on views at
an offset; the fused KV-cache write bit-equal to its plain version (one
launch for K and V) on K/V as the model hands them and on strided views,
f32/f16/bf16, l 8/16, D 64/128, decode and prefill writes, a ring, and
positions past the cache, which are dropped.  Operator planning: an RCM
solve on the card with the CPU port's iterations, restarts and
``bytes_read``, x within 1e-9 relative, and a repeated one replaying its
captured cycle (no new graph, equal launches, equal bits); each emulator's
roundtrip on the card bit-equal to the CPU's for ``sz_abs`` and
``zfp_fr`` (power-of-two block maxima included), within an ulp but for one
entry in 10^4 for ``sz_pwrel``; an ``emul:`` basis in the captured device
cycle bit-equal to the host driver's.  The sharded solve on a NCCL group of
one rank: the coded dots' wire (kernels 1 and 2 at ``WIRE_SPEC``)
bit-equal to the plain codec on the CPU; a captured sharded cycle (its
collectives inside the graph) replayed with equal bits, and with the plain
transport the unsharded solve's iterations, restarts and ``bytes_read``, x
within 1e-12 relative.  The MoE family: ``moe_block`` on the card with the
CPU route's routing (slots and drops) and output within 1e-5 of the
largest entry; mixtral ``reduced()`` past its window (a rolled prefill and
wrapping decode steps) on the card within 1e-3 of the CPU's logits, the
flash-decode kernel once a layer on its FRSZ2 ring.  The encoder-decoder
and VLM families: the flash-decode kernel on a cross cache read whole at
whisper-medium's and llama-3.2-vision-11b's serving shapes against the
masked softmax (the tolerances above), the cross cache's prefill write
bit-equal to the CPU's, and whisper and the VLM ``reduced()`` on the card
within 1e-3 of the CPU's logits, the cross caches' exponents bit-equal.
The analysis gate's card-only audits (``-k gate``): a second same-shape
solve of either driver captures no graph (and, with the graph cache
bypassed, the audit finds the new capture); a warmed solve's host reads
and host-to-device copies equal its ``HOST_TRAFFIC`` (an extra read is
found); the f64 audit on kernels 1-6 and the fixed-trajectory reads on
the kernel route; the collective census on a NCCL group of one rank, CGS2
and MGS.  MGS's second pass as an IF node of the captured cycles (``-k
mgs``): one replayed scalar (block) cycle runs kernels 3 and 4 (7 and 8)
m + (fired steps) times by the profiler's count, m at eta 0 and 2m at eta
1.5, equal to ``ops.LAUNCHES``; its state and basis bit-equal to the
eager cycle's; a second solve captures nothing.
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
    # one fused cache write a layer, K and V together; no row compress
    assert ops.LAUNCHES["frsz2_cache_write"] == cfg.num_layers
    assert ops.LAUNCHES["frsz2_compress"] == 0
    assert float((dg.cpu() - dc).abs().max()) <= 1e-3 * float(dc.abs().max())
    # the cache-write kernel writes the plain codec's bits: the same K/V
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


#: the rmatvec's card cases: the solver's frsz2_32 and frsz2_16, every code
#: width, a block size under the codes a word (bs 1 and 8 at l 8), n a
#: multiple of no word and a row length that is no multiple of a word
RMATVEC_CASES = [(torch.float64, 32, 32, 20011), (torch.float64, 16, 32, 4096),
                 (torch.float64, 16, 128, 3001), (torch.float64, 8, 8, 3001),
                 (torch.float64, 32, 1, 3001), (torch.float32, 32, 32, 5003),
                 (torch.float32, 16, 8, 2048), (torch.float32, 8, 1, 1001)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,bs,n", RMATVEC_CASES)
def test_rmatvec_row_order_bits_on_card(cuda, dtype, l, bs, n):
    """The rmatvec is the row-order fma sum (``ref.rmatvec_rows_ref``) bit
    for bit at rows 1..101 across its ring turns, one launch each, within
    1e-12 (f64) / 1e-5 (f32) of the plain matrix product, repeats its bits;
    so on codes one code past a 16-byte word (the kernel's one-by-one
    route), and in one replay of a captured call."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    V = torch.randn((101, n), generator=gen, dtype=dtype, device=cuda)
    bc = ops.compress(V, spec)
    h = torch.randn((101,), generator=gen, dtype=dtype, device=cuda)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for r in EDGE_ROWS:
        sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r], n=n,
                                spec=spec)
        assert cardcheck.rmatvec_rows_equal(sub, h[:r]), r
        yk = ops.rmatvec(sub, h[:r])
        yp = ops.rmatvec(sub, h[:r], kernel=False)
        assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())
        assert torch.equal(yk, ops.rmatvec(sub, h[:r]))
    assert cardcheck.rmatvec_rows_equal(cardcheck.offset_view(bc), h)
    assert cardcheck.replay_equals_eager(lambda: ops.rmatvec(bc, h))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,l,bs", [s for s in cardcheck.CODEC_SPOTS
                                        if s[0] in (torch.float32,
                                                    torch.float64)])
def test_rmatvec_spots_on_card(cuda, dtype, l, bs):
    """Every f32/f64 spot of ``cardcheck.CODEC_SPOTS`` at a ragged n =
    1001: bit-equal to the row-order plain sum, also on codes at an
    offset."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    bc = ops.compress(cardcheck.spread_values((5, 1001), dtype, gen), spec)
    h = torch.randn((5,), generator=gen, dtype=dtype, device=cuda)
    assert cardcheck.rmatvec_rows_equal(bc, h)
    assert cardcheck.rmatvec_rows_equal(cardcheck.offset_view(bc), h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bias", cardcheck.GUARD_DTYPES)
@pytest.mark.parametrize("l", [32, 16, 8])
@pytest.mark.parametrize("bs", [32, 2])
def test_rmatvec_across_the_decode_guard_on_card(cuda, dtype, bias, l, bs):
    """Exponents in the flush zone, on the guard's edges and past 2*bias,
    one exponent a word (bs 32) and several (bs 2): each row, h one-hot
    there, gives its decoded values, NaN where they are NaN."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    bad, _ = cardcheck.rmatvec_across_guard(dtype, bias, l, bs, gen)
    assert not bad


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
    """The card's float16 basis write rounds f64 -> f32 -> f16, as the JAX
    reference and the CPU route do (the name predates that rule)."""
    rng = np.random.default_rng(15)
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    x = np.concatenate([rng.standard_normal(200_000), ties + 2.0 ** -40,
                        ties - 2.0 ** -40, [65519.99, 65520.0, 1e300,
                                            2.0 ** -25, 1.5 * 2.0 ** -24]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float32).astype(np.float16).view(np.int16)
    acc = BasisAccessor(fmt=NativeFormat(dtype=torch.float16), m=1, n=x.size,
                        device=cuda)
    store = acc.empty()
    acc.write_row(store, 0, torch.from_numpy(x).to(cuda))
    assert np.array_equal(store[0].cpu().numpy().view(np.int16), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w", [5, 7, 27])
def test_batched_ell_bits_at_every_q_on_card(cuda, dtype, w):
    """The batched launch reads vals/cols once for all q columns and sums
    each column in slot order: bit-equal to plain and to a second call, also
    where vals/cols do not start 16-byte aligned (one row into a larger
    array)."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    nr, nc = 1001, 1337
    for offset in (0, 1):
        cols = torch.randint(0, nc, (nr + offset, w), generator=gen,
                             device=cuda, dtype=torch.int32)[offset:]
        vals = torch.randn((nr + offset, w), generator=gen, dtype=dtype,
                           device=cuda)[offset:]
        cols[::5, w // 2:] = 0                 # padding slots: val 0, col 0
        vals[::5, w // 2:] = 0.0
        for q in (1, 2, 3, 8, 9, 16):
            X = torch.randn((q, nc), generator=gen, dtype=dtype, device=cuda)
            ops.reset_launches()
            Y = ops.ell_spmv(vals, cols, X)
            assert ops.LAUNCHES["ell_spmv"] == 1
            assert torch.equal(Y, ops.ell_spmv(vals, cols, X, kernel=False)), \
                (offset, q)
            assert torch.equal(Y, ops.ell_spmv(vals, cols, X)), (offset, q)


@pytest.mark.cuda
@pytest.mark.parametrize("D,l,G,exp_dtype,qdt", [
    (128, 16, 8, torch.uint8, torch.float32),
    (128, 8, 8, torch.int32, torch.bfloat16),
    (64, 16, 2, torch.int32, torch.float32),
    (64, 8, 1, torch.uint8, torch.float32),
    (128, 16, 3, torch.uint8, torch.float32),
    (128, 8, 12, torch.uint8, torch.float32),
    (64, 16, 12, torch.int32, torch.bfloat16)])
def test_decode_attention_tile_edges_on_card(cuda, D, l, G, exp_dtype, qdt):
    """Lengths 0, 1, T-1, T, T+1 and across a 128-position split
    (``cardcheck.ATTN_EDGE_LENGTHS``, T = 64) in a cache of S = 319, not a
    multiple of the tile: within 1e-5 of the largest plain output (f32 q)
    or 2^-7 (bf16 q), an empty row 0, two calls bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    lens = cardcheck.ATTN_EDGE_LENGTHS
    S, Hkv = max(lens) + 2, 2
    kbc, vbc = _coded_kv(gen, len(lens), Hkv, S, D, l, exp_dtype, cuda)
    q = torch.randn((len(lens), Hkv * G, D), generator=gen,
                    device=cuda).to(qdt)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _, err, rel = cardcheck.attn_pair(q, kbc, vbc, lengths)
    if qdt == torch.float32:
        assert rel <= cardcheck.ATTN_TOL, (err, rel)
    else:
        assert err <= cardcheck.ATTN_TOL_BF16, err
    out = ops.decode_attention(q, kbc, vbc, lengths)
    assert not out[0].any()
    assert torch.equal(out, ops.decode_attention(q, kbc, vbc, lengths))


@pytest.mark.cuda
def test_decode_attention_several_blocks_a_row_on_card(cuda):
    """A cache coded with bs = 32 < D = 128 (four exponents a position):
    every position takes the guarded decode, within 1e-5 of plain."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    B, Hkv, G, S, D = 3, 2, 8, 200, 128
    spec = F.FrszSpec(bs=32, l=16, dtype=torch.float32, rounding="nearest",
                      exp_dtype=torch.uint8)
    kv = [ops.compress(torch.randn((B, Hkv, S, D), generator=gen,
                                   device=cuda), spec) for _ in range(2)]
    q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda)
    lengths = torch.tensor([5, 77, S], dtype=torch.int32, device=cuda)
    _, _, rel = cardcheck.attn_pair(q, *kv, lengths)
    assert rel <= cardcheck.ATTN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("D,l", [(128, 16), (64, 8)])
def test_decode_attention_resident_blocks_on_card(cuda, D, l):
    """The split rule's wave is the kernel's own occupancy: a positive
    number of split blocks an SM (at most 2048 threads / 128), the same for
    f32 and bf16 q of one group tile, and splits that put the grid of the
    serving shape into one wave of them."""
    from repro_torch.kernels import decode_attn as KA

    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for G in (1, 2, 3, 8, 12):
        n = {KA.resident_blocks(G, D, 1, l, qd, dev)
             for qd in (torch.float32, torch.bfloat16)}
        assert len(n) == 1
        per_sm, rem = divmod(n.pop(), sms)
        assert rem == 0 and 1 <= per_sm <= 16
    resident = KA.resident_blocks(8, D, 1, l, torch.float32, dev)
    chunk, nsplit = KA.splits(8, 4, 8, 2120, resident)
    assert 8 * 4 * nsplit <= resident


@pytest.mark.cuda
@pytest.mark.parametrize("exp_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("l", [16, 8])
def test_decode_attention_across_the_decode_guard_on_card(cuda, l, exp_dtype):
    """K and V blocks with exponents in the flush zone, on the guard's
    edges, inside it and at 2*bias+1: V rows equal to ``decompress``, the
    K case within 1e-5 of plain (``cardcheck.attn_across_guard``)."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    v_ok, rel, _ = cardcheck.attn_across_guard(l, exp_dtype, gen)
    assert v_ok
    assert rel <= cardcheck.ATTN_TOL


@pytest.mark.cuda
def test_row_codec_edges_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(18)
    assert cardcheck.codec_edges(gen) == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("l,D", [(16, 128), (8, 64), (16, 64), (8, 128),
                                 (16, 112)])
@pytest.mark.parametrize("case", ["decode", "prefill", "ring", "strided",
                                  "unaligned"])
def test_cache_write_matches_plain_on_card(cuda, dtype, l, D, case):
    """One launch writes K and V; every cache buffer equals the plain
    version's (D = 112: bs outside ``kernel_supported``, still the kernel's
    route on the card).  decode: T = 1 at lengths 0, 5, S - 1 and S (dropped);
    prefill: T = S at lengths 3 (the tail dropped), then T = S - 8 from 0
    (lengths None), clearing the 8 positions past it, as ``build_cache``
    does; ring: a prefill of 3 * ring
    positions and a decode step past the ring;
    strided / unaligned: K/V sliced from a wider tensor at an offset of 8
    or 3 values, T = 4."""
    B, Hkv, S = 4, 2, 40
    gen = torch.Generator(device=cuda).manual_seed(D + l)
    fmt = kvcache.cache_format(f"frsz2_{l}")
    spec = fmt.spec(D)

    def kv(T, width=D):
        return [(torch.randn((B, T, Hkv, width), generator=gen, device=cuda)
                 * 4.0).to(dtype) for _ in range(2)]

    ring = 16 if case == "ring" else 0
    S_cache = ring or S
    if case == "decode":
        writes = [(kv(1), torch.tensor([0, 5, S - 1, S], dtype=torch.int32,
                                       device=cuda))]
    elif case == "prefill":
        writes = [(kv(S), torch.full((B,), 3, dtype=torch.int32,
                                     device=cuda)), (kv(S - 8), None)]
    elif case == "ring":
        writes = [(kv(3 * ring), None), (kv(1), torch.tensor(
            [3 * ring, 17, 0, 5], dtype=torch.int32, device=cuda))]
    else:                       # aligned for vector loads, or off by 3
        off = 8 if case == "strided" else 3
        wide = kv(4, 2 * D + 8)
        writes = [([w[..., off:D + off] for w in wide],
                   torch.tensor([0, 1, 20, 36], dtype=torch.int32, device=cuda))]
    caches = []
    for kernel in (True, False):
        c = {n: t[0] for n, t in kvcache.init_cache(fmt, 1, B, Hkv, S_cache, D,
                                                    device=cuda).items()}
        for t in c.values():
            t.fill_(7)                   # what is not written or cleared stays
        ops.reset_launches()
        for (k, v), lengths in writes:
            # a write from position 0 clears the rest, as build_cache's
            clear = k.shape[1] if lengths is None and not ring else None
            ops.cache_write(k, v, lengths, c["k_codes"], c["k_exps"],
                            c["v_codes"], c["v_exps"], spec, ring=ring,
                            clear_from=clear, kernel=kernel)
        assert ops.LAUNCHES["frsz2_cache_write"] == (len(writes) if kernel
                                                     else 0)
        caches.append(c)
    for n in caches[0]:
        assert torch.equal(caches[0][n], caches[1][n]), n
    # and through kvcache as the model calls it
    (k, v), lengths = writes[-1]
    c = {n: t[0] for n, t in kvcache.init_cache(fmt, 1, B, Hkv, S_cache, D,
                                                device=cuda).items()}
    ops.reset_launches()
    if lengths is None:
        kvcache.build_cache(k, v, fmt, cache_len=S_cache, ring=ring, out=c)
    else:
        kvcache.append(c, k, v, lengths, fmt, ring=ring)
    assert ops.LAUNCHES["frsz2_cache_write"] == 1
    assert ops.LAUNCHES["frsz2_compress"] == 0


@pytest.mark.cuda
def test_cache_write_raises_on_card_outside_kernel(cuda):
    """A CUDA write the kernel does not take (D = 256) raises: the plain
    version does not run on the card in its place."""
    D = 256
    fmt = kvcache.cache_format("frsz2_16")
    c = {n: t[0] for n, t in kvcache.init_cache(fmt, 1, 2, 2, 8, D,
                                                device=cuda).items()}
    x = torch.zeros((2, 1, 2, D), dtype=torch.bfloat16, device=cuda)
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="no kernel"):
        kvcache.append(c, x, x, torch.zeros(2, dtype=torch.int32,
                                             device=cuda), fmt)
    assert ops.LAUNCHES["frsz2_cache_write"] == 0


#: zamba2-7b's head_dim: a block size (bs = D) that is no power of two
HD112 = 112


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [8, 16])
def test_decode_attention_head_dim_112_on_card(cuda, l, qdt, G):
    """D = bs = 112 (one block a row, no power of two) on the kernel, once
    a call: lengths 0, 1, T-1, T, T+1 and a full row of S = 300, within
    1e-5 of the largest plain output (f32 q) or 2^-7 (bf16 q), an empty
    row 0, two calls bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(112 + l + G)
    T = cardcheck.TILE
    S, Hkv = 300, 2
    lens = (0, 1, T - 1, T, T + 1, S)
    kbc, vbc = _coded_kv(gen, len(lens), Hkv, S, HD112, l, torch.uint8, cuda)
    q = torch.randn((len(lens), Hkv * G, HD112), generator=gen,
                    device=cuda).to(qdt)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    ops.reset_launches()
    out, err, rel = cardcheck.attn_pair(q, kbc, vbc, lengths)
    assert ops.LAUNCHES["decode_attn"] == 1
    if qdt == torch.float32:
        assert rel <= cardcheck.ATTN_TOL, (err, rel)
    else:
        assert err <= cardcheck.ATTN_TOL_BF16, err
    assert not out[0].any()
    assert torch.equal(out, ops.decode_attention(q, kbc, vbc, lengths))


@pytest.mark.cuda
def test_decode_attention_raises_on_card_outside_kernel(cuda, monkeypatch):
    """A CUDA attention the kernel does not take (D = 96) raises before any
    launch; the plain version never runs on the card in its place."""
    gen = torch.Generator(device=cuda).manual_seed(96)
    kbc, vbc = _coded_kv(gen, 2, 2, 40, 96, 16, torch.uint8, cuda)
    q = torch.randn((2, 4, 96), generator=gen, device=cuda)
    lengths = torch.tensor([3, 40], dtype=torch.int32, device=cuda)

    def forbidden(*a, **kw):
        raise AssertionError("the plain decode attention ran on the card")

    monkeypatch.setattr(ref, "decode_attn_ref", forbidden)
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="no kernel"):
        ops.decode_attention(q, kbc, vbc, lengths)
    assert ops.LAUNCHES["decode_attn"] == 0


def _to_card(tree, dev):
    return ({k: _to_card(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("falcon-mamba-7b", {}),
    ("zamba2-7b", dict(head_dim=HD112, num_heads=2, num_kv_heads=2,
                       d_model=224))])
def test_ssm_families_on_card_match_cpu(cuda, name, kw):
    """falcon-mamba and zamba2 ``reduced()`` (zamba2 at its head_dim of
    112): prefill and two decode steps on the card within 1e-3 of the CPU's
    logits (relative to the largest), the SSM states within 1e-3; zamba2's
    shared block attends through the kernel once an application a step
    and writes its cache once, falcon-mamba launches no FRSZ2 kernel."""
    import dataclasses

    cfg = dataclasses.replace(get_arch(name).reduced(), **kw)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 34),
                           generator=torch.Generator().manual_seed(1))
    on_card = _to_card(params, cuda)
    lc, cc = prefill(params, cfg, tokens[:, :32], cache_len=36)
    ops.reset_launches()
    lg, cg = prefill(on_card, cfg, tokens[:, :32].to(cuda), cache_len=36)
    apps = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert ops.LAUNCHES["frsz2_cache_write"] == apps
    assert float((lg.cpu() - lc).abs().max()) <= 1e-3 * float(lc.abs().max())
    for t in (32, 33):
        ops.reset_launches()
        dc, cc = decode_step(params, cfg, cc, tokens[:, t])
        dg, cg = decode_step(on_card, cfg, cg, tokens[:, t].to(cuda))
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        want = ({"decode_attn": apps, "frsz2_cache_write": apps} if apps
                else {})
        assert got == want
        assert float((dg.cpu() - dc).abs().max()) <= 1e-3 * float(
            dc.abs().max())
    for n in ("ssm_h", "ssm_conv"):
        a, b = cg[n].cpu().float(), cc[n].float()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), n


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_rcm_solve_on_card_matches_cpu_and_replays(cuda, storage):
    """``reorder="rcm"`` on the card (device driver, captured cycles)
    against the port on the CPU: iterations, restarts and ``bytes_read``
    equal, x within 1e-9 relative; a repeated RCM solve fetches the plan
    from its cache and replays the captured cycle (no new graph, the same
    launches, the same bits)."""
    from repro_torch.solver.gmres import _GRAPHS

    Ac, target = make_problem("synth:unstructured", 4096, device="cpu")
    A = Ac.to(cuda)
    bc, _ = rhs_for(Ac, device="cpu")
    kw = dict(storage=storage, m=40, target_rrn=target, reorder="rcm")
    rc = gmres(Ac, bc, driver="host", **kw)
    r1 = gmres(A, bc.to(cuda), **kw)
    keys = set(_GRAPHS)
    ops.reset_launches()
    r2 = gmres(A, bc.to(cuda), **kw)
    launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    r3 = gmres(A, bc.to(cuda), **kw)
    assert set(_GRAPHS) == keys and dict(ops.LAUNCHES) == launches
    for r in (r1, r2, r3):
        assert r.converged and r.iterations == rc.iterations
        assert r.restarts == rc.restarts and r.bytes_read == rc.bytes_read
        rel = float(torch.linalg.vector_norm(r.x.cpu() - rc.x)
                    / torch.linalg.vector_norm(rc.x))
        assert rel <= 1e-9, rel
    assert torch.equal(r2.x, r3.x) and torch.equal(r1.x, r2.x)
    rn = gmres(A, bc.to(cuda), storage=storage, m=40, target_rrn=target,
               reorder="none")
    assert rn.iterations == r1.iterations


EMUL_NAMES = ["emul:sz_abs:1e-10", "emul:sz_abs:1e-6", "emul:sz_pwrel:1e-6",
              "emul:sz_pwrel:1e-4", "emul:zfp_fr:32", "emul:zfp_fr:16",
              "emul:zfp_fr:8"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EMUL_NAMES)
def test_emulator_roundtrip_on_card_matches_cpu(cuda, name):
    """Each emulator's roundtrip on the card against the same roundtrip on
    the CPU: bit-equal for ``sz_abs`` and ``zfp_fr`` (rows of Krylov-like
    values, and for ``zfp_fr`` blocks whose maxima sit on powers of two
    and a few ulps off them); ``sz_pwrel``, whose ``log``/``exp`` are the
    device's, within one ulp but for at most one entry in 10^4, inside its
    relative bound."""
    from repro_torch.core import emulators as TE

    fmt = format_by_name(name)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((8, 4099))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rows = [x, x * 1e-7]
    if "zfp" in name:
        ks = np.arange(-200, 201)
        for ulps in (-2, 0, 1, 3):
            t = np.zeros((ks.size, 4))
            t[:, 0] = np.ldexp(1.0 + ulps * 2.0 ** -52, ks)
            t[:, 2] = np.ldexp(-0.45, ks)
            rows.append(TE._zfp_inv_lift(torch.from_numpy(t)).numpy()
                        .reshape(1, -1))
    for v in rows:
        vc = torch.from_numpy(np.ascontiguousarray(v))
        want = fmt.roundtrip(vc)
        got = fmt.roundtrip(vc.to(cuda)).cpu()
        ulps = (got.view(torch.int64) - want.view(torch.int64)).abs()
        if "pwrel" in name:
            assert int((ulps > 1).sum()) <= v.size // 10_000
            eb = float(name.rsplit(":", 1)[1])
            nz = vc != 0
            assert bool(((got - vc).abs()[nz]
                         <= eb * vc.abs()[nz] * (1 + 1e-9)).all())
        else:
            assert torch.equal(got.view(torch.int64),
                               want.view(torch.int64)), int((ulps > 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["emul:sz_abs:1e-10", "emul:sz_pwrel:1e-6",
                                  "emul:zfp_fr:32"])
def test_emulated_device_cycle_matches_host_driver_on_card(cuda, name):
    """An ``emul:`` basis in the captured device cycle (the roundtrip runs
    inside the CUDA graph) against the host driver on the card: equal
    iterations, restarts, ``bytes_read`` and ``op_reads``, the same bits;
    the second solve replays."""
    from repro_torch.solver.gmres import _GRAPHS

    A, target = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    rh = gmres(A, b, storage=name, m=40, target_rrn=target, driver="host")
    r1 = gmres(A, b, storage=name, m=40, target_rrn=target)
    keys = set(_GRAPHS)
    r2 = gmres(A, b, storage=name, m=40, target_rrn=target)
    assert set(_GRAPHS) == keys
    assert rh.converged
    for rd in (r1, r2):
        assert (rd.iterations, rd.restarts) == (rh.iterations, rh.restarts)
        assert rd.bytes_read == rh.bytes_read and rd.op_reads == rh.op_reads
        assert torch.equal(rd.x, rh.x)


# ---------------------------------------------------------------------------
# Slice 6: the sharded solve on a NCCL group of one rank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """A NCCL group of world size 1 on cuda:0 (initialized eagerly, as a
    captured cycle needs), with a gloo group of the same rank beside it for
    the plain route on the CPU; torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.dist import init_rank

    rdv = tmp_path_factory.mktemp("nccl") / "rendezvous"
    init_rank(0, 1, f"file://{rdv}")
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_dots_wire_codec_bit_equal_to_plain_route(nccl):
    """``ShardedFormat`` dots on the coded transport: the wire runs kernels
    1 and 2 at ``WIRE_SPEC`` (one launch each) and gives the bits of the
    plain codec on the CPU (the gloo group), for every stored row's
    partial and for the live prefix."""
    from repro_torch.core.accessor import ShardedFormat
    from repro_torch.dist import collectives

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(31)
    inner = format_by_name("frsz2_32")
    acc = BasisAccessor(fmt=ShardedFormat(inner=inner), m=101, n=20_000,
                        device=cuda)
    store = acc.empty()
    for j in range(101):
        v = torch.randn((20_000,), generator=gen, dtype=torch.float64,
                        device=cuda)
        acc.write_row(store, j, v / torch.linalg.vector_norm(v)
                      * 2.0 ** (j % 9 - 4))
    w = torch.randn((20_000,), generator=gen, dtype=torch.float64,
                    device=cuda)
    partials = inner.dots(store, w, torch.float64, 20_000, 101)
    ops.reset_launches()
    got = acc.dots(store, w, 37)
    assert ops.LAUNCHES["frsz2_compress"] == 1
    assert ops.LAUNCHES["frsz2_decompress"] == 1
    want = collectives.compressed_psum(partials.cpu(), nccl)
    assert torch.equal(got.cpu(), want[:37])
    full = collectives.compressed_psum(partials, None)
    assert torch.equal(full.cpu(), want)
    assert torch.equal(collectives.compressed_pmean(partials, None).cpu(),
                       collectives.compressed_pmean(partials.cpu(), nccl))


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["plain", "compressed",
                                       "compressed+norms"])
def test_captured_sharded_cycle_replays_with_equal_bits(nccl, transport):
    """``gmres(..., shard=1)`` on the card: the cycle is captured once with
    its NCCL collectives inside and replayed; a second solve captures
    nothing new and gives the same bits.  The plain transport takes the
    unsharded device solve's iterations, restarts and ``bytes_read``."""
    from repro_torch.solver.gmres import _GRAPHS

    cuda = torch.device("cuda")
    A, target = make_problem("synth:atmosmod", 8000, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    kw = dict(storage="frsz2_32", m=40, target_rrn=target, shard=1,
              shard_transport=transport, shard_matvec="halo")
    r1 = gmres(A, b, **kw)
    keys = set(_GRAPHS)
    ops.reset_launches()
    r2 = gmres(A, b, **kw)
    assert set(_GRAPHS) == keys
    assert r1.converged and r1.iterations == r2.iterations
    assert torch.equal(r1.x, r2.x)
    assert ops.LAUNCHES["ell_spmv"] > 0 and ops.LAUNCHES["gmres_givens"] > 0
    assert ops.LAUNCHES["ell_spmv_frsz2"] == 0
    if transport == "plain":
        ru = gmres(A, b, storage="frsz2_32", m=40, target_rrn=target)
        assert (r2.iterations, r2.restarts) == (ru.iterations, ru.restarts)
        assert r2.bytes_read == ru.bytes_read
        assert (torch.linalg.vector_norm(r2.x - ru.x)
                <= 1e-12 * torch.linalg.vector_norm(ru.x))


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_block_on_card_matches_cpu(cuda, arch):
    """``moe_block`` (reduced, f32) on the card against the CPU route: the
    same routing (slots and drops; capacity factor 0.5 drops choices) and
    the output within 1e-5 of the largest entry, the aux loss within 1e-5
    relative (f32 products summed in another order)."""
    import dataclasses

    from repro_torch.models import layers

    cfg = dataclasses.replace(get_arch(arch).reduced(), capacity_factor=0.5)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn((2, 96, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    oc, ac = layers.moe_block(x, lp, cfg)
    og, ag = layers.moe_block(x.to(cuda), _to(lp, cuda), cfg)
    assert float((og.cpu() - oc).abs().max()) <= 1e-5 * float(oc.abs().max())
    assert abs(float(ag) - float(ac)) <= 1e-5 * abs(float(ac))
    g, cap = layers.moe_capacity(cfg, 2 * 96)
    h = layers.rms_norm(x, lp["ln"]).reshape(-1, g, cfg.d_model)
    gates = torch.softmax(h @ lp["router"], dim=-1)
    sc = layers._top_k_dispatch(gates, cfg.top_k, cap)
    sg = layers._top_k_dispatch(gates.to(cuda), cfg.top_k, cap)
    for a, b in zip(sc, sg):
        assert torch.equal(a, b.cpu())
    assert not bool(sc[2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_format", ["frsz2_16", "bf16"])
def test_moe_ring_decode_on_card_matches_cpu(cuda, kv_format):
    """mixtral ``reduced()`` (window 64) past its window: a prefill of 80
    tokens (the ring rolled) and three decode steps (each wrapping) on the
    card against the CPU route, logits within 1e-3 of the largest; every
    step runs the flash-decode kernel once a layer on the FRSZ2 ring."""
    import dataclasses

    cfg = dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                              kv_format=kv_format)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 83),
                           generator=torch.Generator().manual_seed(1))
    on_card = _to(params, cuda)
    lc, cc = prefill(params, cfg, tokens[:, :80], cache_len=84)
    lg, cg = prefill(on_card, cfg, tokens[:, :80].to(cuda), cache_len=84)
    assert next(iter(cg["self"].values())).shape[3] == cfg.window
    assert float((lg.cpu() - lc).abs().max()) <= 1e-3 * float(lc.abs().max())
    for t in range(80, 83):
        ops.reset_launches()
        dc, cc = decode_step(params, cfg, cc, tokens[:, t])
        dg, cg = decode_step(on_card, cfg, cg, tokens[:, t].to(cuda))
        frsz = kv_format.startswith("frsz2")
        assert ops.LAUNCHES["decode_attn"] == (cfg.num_layers if frsz else 0)
        assert float((dg.cpu() - dc).abs().max()) <= (
            1e-3 * float(dc.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [5, 6])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_decode_attention_on_a_wrapped_ring_on_card(cuda, G, qdt):
    """The flash-decode kernel on a ring cache (``kvcache.attend`` with a
    ring: lengths clamped to the slots) at llama4's and mixtral's query
    groups, against the reference's masked softmax over the ring
    (``kvcache.masked_attend``): f32 q within 1e-5 of the largest output,
    bf16 q within one bf16 step; one launch."""
    ring, B, Hkv, D = 192, 3, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(G)
    fmt = kvcache.cache_format("frsz2_16")
    k = torch.randn((B, ring + 101, Hkv, D), generator=gen, device=cuda)
    v = torch.randn((B, ring + 101, Hkv, D), generator=gen, device=cuda)
    lc = kvcache.build_cache(k, v, fmt, ring=ring)
    lengths = torch.tensor([ring + 101, ring + 1, 2 * ring + 5],
                           dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda).to(qdt)
    ops.reset_launches()
    got = kvcache.attend(q, lc, lengths, fmt, window=ring, ring=ring)
    assert ops.LAUNCHES["decode_attn"] == 1
    want = kvcache.masked_attend(q, lc, lengths, fmt, ring=ring)
    err = float((got.float() - want.float()).abs().max())
    tol = cardcheck.ATTN_TOL if qdt == torch.float32 else (
        cardcheck.ATTN_TOL_BF16)
    assert err <= tol * float(want.float().abs().max())


#: the cross caches at serving size: whisper-medium's 16 kv heads of
#: head_dim 64 over 1,536 frames (G = 1) and llama-3.2-vision-11b's 8 of
#: 128 over 1,664 image tokens (G = 4), 8 rows, every position valid
CROSS_SHAPES = {"whisper": (16, 1, 64, 1536), "vlm": (8, 4, 128, 1664)}


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("model", sorted(CROSS_SHAPES))
def test_decode_attention_on_full_length_cross_cache_on_card(cuda, model, l,
                                                             qdt):
    """Kernel 9 on a cross cache read whole (a cache written by
    ``build_cache`` from bf16 K/V as the prefill writes it, lengths = S on
    every row), through ``kvcache.attend`` as a decode step calls it:
    against the masked softmax (``kvcache.masked_attend``), f32 q within
    1e-5 of the largest output and bf16 q within one bf16 step; one
    launch."""
    Hkv, G, D, S = CROSS_SHAPES[model]
    B = 8
    gen = torch.Generator(device=cuda).manual_seed(l + G)
    fmt = kvcache.cache_format(f"frsz2_{l}")
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    lc = kvcache.build_cache(k, v, fmt)
    lengths = torch.full((B,), S, dtype=torch.int32, device=cuda)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=cuda).to(qdt)
    ops.reset_launches()
    got = kvcache.attend(q, lc, lengths, fmt)
    assert ops.LAUNCHES["decode_attn"] == 1
    want = kvcache.masked_attend(q, lc, lengths, fmt)
    err = float((got.float() - want.float()).abs().max())
    tol = cardcheck.ATTN_TOL if qdt == torch.float32 else (
        cardcheck.ATTN_TOL_BF16)
    assert err <= tol * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("model", sorted(CROSS_SHAPES))
def test_cross_cache_write_on_card_bit_equal_to_cpu(cuda, model, l):
    """The cross cache's prefill write (``build_cache`` of the whole
    source, no padding) on the card: one launch, codes and exponents
    bit-equal to the same write on the CPU."""
    Hkv, _, D, S = CROSS_SHAPES[model]
    gen = torch.Generator().manual_seed(l)
    fmt = kvcache.cache_format(f"frsz2_{l}")
    k, v = ((torch.randn((2, S, Hkv, D), generator=gen) * 3)
            .to(torch.bfloat16) for _ in range(2))
    want = kvcache.build_cache(k, v, fmt)
    ops.reset_launches()
    got = kvcache.build_cache(k.to(cuda), v.to(cuda), fmt)
    assert ops.LAUNCHES["frsz2_cache_write"] == 1
    for n, t in want.items():
        assert torch.equal(got[n].cpu(), t), n


@pytest.mark.cuda
@pytest.mark.parametrize("kv_format", ["frsz2_16", "bf16"])
@pytest.mark.parametrize("name", ["whisper-medium", "llama-3.2-vision-11b"])
def test_cross_families_on_card_match_cpu(cuda, name, kv_format):
    """whisper and the VLM ``reduced()``: prefill and two decode steps on
    the card within 1e-3 of the CPU's logits (relative to the largest), on
    the same frames or image embeddings; in ``frsz2_16`` the prefill
    writes every self and cross cache once, a decode step writes the self
    caches and attends once a self layer and once a cross block, and the
    cross caches' exponents end bit-equal to the CPU's (the f32 K/V differ
    in their last bits); in ``bf16`` no FRSZ2 kernel runs."""
    import dataclasses

    from repro_torch.launch.serve import aux_for
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch(name).reduced(), kv_format=kv_format)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 34),
                           generator=torch.Generator().manual_seed(1))
    aux = aux_for(cfg, 2, torch.Generator().manual_seed(2))
    on_card = _to_card(params, cuda)
    R, X = lm.kv_layers(cfg), lm.cross_layers(cfg)
    frsz = kv_format.startswith("frsz2")
    lc, cc = prefill(params, cfg, tokens[:, :32], aux, cache_len=36)
    ops.reset_launches()
    lg, cg = prefill(on_card, cfg, tokens[:, :32].to(cuda),
                     _to_card(aux, cuda), cache_len=36)
    assert ops.LAUNCHES["frsz2_cache_write"] == (R + X if frsz else 0)
    assert float((lg.cpu() - lc).abs().max()) <= 1e-3 * float(lc.abs().max())
    for t in (32, 33):
        ops.reset_launches()
        dc, cc = decode_step(params, cfg, cc, tokens[:, t])
        dg, cg = decode_step(on_card, cfg, cg, tokens[:, t].to(cuda))
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        assert got == ({"decode_attn": R + X, "frsz2_cache_write": R}
                       if frsz else {})
        assert float((dg.cpu() - dc).abs().max()) <= 1e-3 * float(
            dc.abs().max())
    if frsz:
        for n, t in cc["cross"].items():
            if n.endswith("_exps"):
                assert torch.equal(cg["cross"][n].cpu(), t), n


# ---------------------------------------------------------------------------
# training: the FRSZ2-coded AdamW moments (kernels 1 and 2 on one row a
# leaf) and the backward of every family
# ---------------------------------------------------------------------------

#: the optimizer state's spec (``optim.AdamWConfig.state_spec``)
OPT_SPEC = F.FrszSpec(bs=128, l=16, dtype=torch.float32, rounding="nearest")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [262_144_000, 1_000_003])
def test_optimizer_codec_row_on_card(cuda, n):
    """One row of n values (yi-9b's embedding at full width; a ragged n
    whose tail block is part padding): one launch of each kernel, codes,
    exponents and decode bit-equal to the plain codec."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(n, generator=gen, device=cuda)
    x *= torch.exp2(torch.randint(-30, 30, (n,), generator=gen, device=cuda)
                    .float())
    x[:4096] = 0.0
    ops.reset_launches()
    bc = ops.compress(x, OPT_SPEC)
    values = ops.decompress(bc)
    assert bc.codes.shape == (-(-n // 128), 128)
    assert ops.LAUNCHES["frsz2_compress"] == 1
    assert ops.LAUNCHES["frsz2_decompress"] == 1
    assert cardcheck.row_codes_equal(x, bc)
    assert cardcheck.row_decode_equal(bc, values)


@pytest.mark.cuda
def test_coded_adamw_step_on_card_matches_cpu(cuda):
    """One coded AdamW update on the card bit-equal to the same update on
    the CPU (gradients under the clip, so the global norm's sum order does
    not enter), each leaf's m and v through kernels 2 then 1."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves

    g = torch.Generator().manual_seed(0)
    shapes = {"embed": (64, 48), "ln": (3, 48), "b": (48,), "w": (3, 48, 70)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g) * 3e-3 for k, s in
              shapes.items()} for _ in range(2)]
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10,
                      compress_state=True)
    state = adamw_init(params, cfg)
    params, state, _ = adamw_update(grads[0], state, params, cfg)
    want_p, want_s, _ = adamw_update(grads[1], state, params, cfg)
    card = lambda t: {k: v.to(cuda) for k, v in t.items()}  # noqa: E731
    card_state = {part: {k: F.BlockCompressed(codes=v.codes.to(cuda),
                                              exps=v.exps.to(cuda), n=v.n,
                                              spec=v.spec)
                         for k, v in state[part].items()} for part in "mv"}
    card_state["step"] = state["step"]
    ops.reset_launches()
    got_p, got_s, st = adamw_update(card(grads[1]), card_state,
                                    card(params), cfg)
    assert ops.LAUNCHES["frsz2_compress"] == 2 * len(shapes)
    assert ops.LAUNCHES["frsz2_decompress"] == 2 * len(shapes)
    assert float(st["grad_norm"]) < cfg.grad_clip
    for k in shapes:
        assert torch.equal(got_p[k].cpu(), want_p[k]), k
        for part in "mv":
            a, b = got_s[part][k], want_s[part][k]
            assert torch.equal(a.codes.cpu(), b.codes), (part, k)
            assert torch.equal(a.exps.cpu(), b.exps), (part, k)
    assert int(got_s["step"]) == 2 and len(tree_leaves(got_p)) == 4


@pytest.mark.cuda
def test_adamw_square_root_on_card_is_correctly_rounded(cuda):
    """The update's f32 root on the card (CUDA's f32 ``sqrt``) equals
    numpy's IEEE root bit for bit, as the CPU's route through f64 does."""
    from repro_torch.optim.adamw import _sqrt

    rng = np.random.default_rng(5)
    x = (rng.random(1 << 22, dtype=np.float32)
         * np.exp2(rng.integers(-120, 120, 1 << 22)).astype(np.float32))
    got = _sqrt(torch.from_numpy(x).to(cuda)).cpu().numpy()
    assert np.array_equal(got.view(np.uint32), np.sqrt(x).view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [
    F.FrszSpec(bs=128, l=21, dtype=torch.float32, rounding="nearest"),
    F.FrszSpec(bs=96, l=16, dtype=torch.float32, rounding="nearest")],
    ids=["l21", "bs96"])
def test_coded_adamw_raises_on_card_outside_kernel(cuda, spec):
    """The coded AdamW has no plain fallback on the card: a state spec that
    kernels 1 and 2 do not take raises at init and at update, and nothing
    is launched."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 48), generator=g),
              "b": torch.randn((48,), generator=g)}
    grads = {k: v * 1e-3 for k, v in params.items()}
    cfg = AdamWConfig(compress_state=True, state_spec=spec)
    state = adamw_init(params, cfg)
    card = lambda t: {k: v.to(cuda) for k, v in t.items()}  # noqa: E731
    card_state = {part: {k: F.BlockCompressed(codes=v.codes.to(cuda),
                                              exps=v.exps.to(cuda), n=v.n,
                                              spec=v.spec)
                         for k, v in state[part].items()} for part in "mv"}
    card_state["step"] = state["step"]
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="no kernel"):
        adamw_init(card(params), cfg)
    with pytest.raises(NotImplementedError, match="no kernel"):
        adamw_update(card(grads), card_state, card(params), cfg)
    assert not any(ops.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yi-9b", "mixtral-8x22b", "falcon-mamba-7b",
                                  "zamba2-7b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_loss_backward_on_card_matches_cpu(cuda, name):
    """``loss_fn`` and its backward at ``reduced()`` on the card: the loss
    within 1e-4 of the CPU's (relative), each gradient leaf within 1e-3 of
    its largest CPU entry (f32 products and sums in another order; MoE
    routing the same), and no kernel launched (the trunk has none)."""
    from repro_torch.launch.serve import aux_for
    from repro_torch.launch.train import value_and_grad
    from repro_torch.tree import tree_leaves

    cfg = get_arch(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens,
             **aux_for(cfg, 2, torch.Generator().manual_seed(2))}
    lc, gc = value_and_grad(params, cfg, batch)
    ops.reset_launches()
    lg, gg = value_and_grad(_to_card(params, cuda), cfg,
                            _to_card(batch, cuda))
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        assert torch.isfinite(a).all()
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())


# ---------------------------------------------------------------------------
# Slice 8: the analysis gate's card-only audits
# ---------------------------------------------------------------------------


def _gate_problem(dtype=None):
    from repro_torch.analysis import traceaudit

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return traceaudit.problem(180, "cuda", dtype=dtype)[:2]


@pytest.mark.cuda
def test_gate_recapture_clean_and_finds_an_uncached_graph(monkeypatch):
    """A second same-shape solve of either driver captures nothing; with
    the graph cache bypassed it captures again, a ``retrace`` finding."""
    import importlib

    from repro_torch.analysis import traceaudit
    from repro_torch.solver import block as BL

    G = importlib.import_module("repro_torch.solver.gmres")
    A, b = _gate_problem()
    info = {}
    assert traceaudit.audit_recapture(A, b, info=info) == []
    for label in ("recapture[device]", "recapture[block]"):
        caps = info[label]["captures"]
        assert caps[0] >= 1 and caps[1] == caps[0], (label, info[label])
    monkeypatch.setattr(G, "_cached_graph", lambda key, build: build())
    monkeypatch.setattr(BL, "_cached_graph", lambda key, build: build())
    got = traceaudit.audit_recapture(A, b)
    assert {f.rule for f in got} == {"retrace"}
    assert {f.path for f in got} == {"trace:recapture[device]",
                                     "trace:recapture[block]"}


@pytest.mark.cuda
def test_gate_host_reads_as_documented_and_finds_an_extra_read(
        monkeypatch):
    """A warmed solve of either driver makes exactly the host reads and
    copies its ``HOST_TRAFFIC`` documents; an extra read in the restart
    loop is a ``transfer`` finding."""
    import importlib

    from repro_torch.analysis import traceaudit

    G = importlib.import_module("repro_torch.solver.gmres")
    A, b = _gate_problem()
    info = {}
    assert traceaudit.audit_host_reads(A, b, info=info) == []
    row = info["host-reads[device]"]
    assert row["reads"] == row["expected_reads"] == 1 + 3 * 2
    assert row["h2d_copies"] == row["expected_copies"] == 2
    update = G._solve_and_update

    def planted(*args, **kw):
        x = update(*args, **kw)
        float(x[0])                                   # the planted read
        return x

    monkeypatch.setattr(G, "_solve_and_update", planted)
    got = traceaudit.audit_host_reads(A, b)
    assert [f.path for f in got] == ["trace:host-reads[device]"]
    assert got[0].rule == "transfer"


@pytest.mark.cuda
def test_gate_f64_and_reads_audits_on_the_card():
    """The f64 audit of an frsz2_16 cycle at f32 arithmetic on kernels 1-6,
    and the fixed-trajectory reads audit on the kernel route."""
    from repro_torch.analysis import traceaudit, traffic

    A32, b32 = _gate_problem(np.float32)
    info = {}
    assert traceaudit.audit_f64_leak(A32, b32, info=info) == []
    assert traffic.run_local_traffic("cuda", info=info) == []
    assert info["reads[frsz2_32]"]["iterations"] == [18]


@pytest.mark.cuda
def test_gate_census_on_a_nccl_group_of_one(nccl):
    """The census on the NCCL group of one rank: every matvec mode and the
    rows-mode solve (its cycles replayed from a graph that holds their
    collectives) priced as the models price them."""
    from repro_torch.analysis import traffic

    info = {}
    assert traffic.census_world(0, "cuda", info=info) == []
    solve = info["census[rows]"]
    assert solve["priced"]["cycle"] == solve["model"]["cycle"]
    assert solve["priced"]["cycle"]["dots"] > 0


# ---------------------------------------------------------------------------
# Slice 9: MGS's second pass as an IF node of the captured cycles
# ---------------------------------------------------------------------------


def _last_cycle():
    from repro_torch.solver.gmres import _GRAPHS

    return next(reversed(_GRAPHS.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("eta", [0.0, 1.5, 0.3])
def test_captured_mgs_cycle_sweeps_twice_only_where_it_fires(cuda, eta):
    """A captured scalar MGS cycle (frsz2_32, m = 20) replayed under the
    profiler: kernels 3 and 4 run m + (fired steps) times, m at eta 0 and
    2m at eta 1.5, equal to ``ops.LAUNCHES``; the IF node's condition
    kernel and the Givens step run m times.  The replay's state and basis
    equal, bit for bit, the cycle run eagerly (both passes, then
    ``torch.where``) on the same inputs; a second solve captures
    nothing."""
    import importlib

    from repro_torch.solver import clear_graph_cache
    from repro_torch.solver.gmres import _GRAPHS

    G = importlib.import_module("repro_torch.solver.gmres")
    A, _ = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    m = 20
    kw = dict(storage="frsz2_32", m=m, max_iters=2 * m, target_rrn=0.0,
              eta=eta)
    clear_graph_cache()
    r1 = gmres(A, b, **kw)
    cyc = _last_cycle()
    graph, keys = cyc.graph, set(_GRAPHS)
    r2 = gmres(A, b, **kw)
    assert set(_GRAPHS) == keys and cyc.graph is graph
    assert torch.equal(r1.x, r2.x)
    np.testing.assert_array_equal(r1.fired, r2.fired)
    beta = torch.linalg.vector_norm(b)
    ops.reset_launches()
    got = {}
    counted = cardcheck.profiled_launches(
        lambda: got.update(out=cyc(b, beta, beta)))
    fired = int(got["out"][4].sum())
    if eta == 0.0:
        assert fired == 0
    elif eta == 1.5:
        assert fired == m
    for k in ("frsz2_matvec", "frsz2_rmatvec"):
        assert counted[k] == ops.LAUNCHES[k] == m + fired, (k, counted)
    assert counted["graph_if"] == ops.LAUNCHES["graph_if"] == m
    assert counted["gmres_givens"] == ops.LAUNCHES["gmres_givens"] == m
    # the same inputs through the eager cycle
    matvec, eta_, target, ortho, precond, fused, dist = cyc._args
    store = cyc.acc.empty()
    state = torch.empty_like(cyc.state)
    G._device_cycle(matvec, cyc.acc, store, state, cyc.init, cyc.r,
                    cyc.beta, cyc.b_norm, eta_, target, ortho, precond,
                    fused, dist)
    assert torch.equal(state, cyc.state)
    for key in ("codes", "exps"):
        assert torch.equal(store[key], cyc.store[key])


@pytest.mark.cuda
@pytest.mark.parametrize("eta", [0.0, 1.5])
def test_captured_block_mgs_cycle_sweeps_twice_only_where_it_fires(cuda,
                                                                   eta):
    """The block cycle (frsz2_32, p = 3, m = 8) replayed under the
    profiler: kernels 7 and 8 run m times at eta 0 and 2m at eta 1.5,
    equal to ``ops.LAUNCHES``; its state and basis bit-equal to the eager
    cycle's; a second solve captures nothing."""
    from repro_torch.solver import block as BL
    from repro_torch.solver import clear_graph_cache
    from repro_torch.solver.gmres import _GRAPHS

    A, _ = make_problem("synth:atmosmod", 4096, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    t = torch.arange(b.shape[0], dtype=b.dtype, device=cuda)
    B = torch.stack([b, torch.sin(t), torch.cos(3 * t)])
    m = 8
    kw = dict(storage="frsz2_32", m=m, max_iters=2 * m, target_rrn=0.0,
              eta=eta, method="block")
    clear_graph_cache()
    r1 = gmres_batched(A, B, **kw)
    cyc = _last_cycle()
    graph, keys = cyc.graph, set(_GRAPHS)
    r2 = gmres_batched(A, B, **kw)
    assert set(_GRAPHS) == keys and cyc.graph is graph
    assert all(torch.equal(a.x, c.x) for a, c in zip(r1, r2))
    bn = torch.linalg.vector_norm(B, dim=1)
    ops.reset_launches()
    got = {}
    counted = cardcheck.profiled_launches(
        lambda: got.update(out=cyc(B, bn)))
    fired = int(got["out"][4].sum())
    assert fired == (0 if eta == 0.0 else m)
    for k in ("frsz2_block_dots", "frsz2_block_combine"):
        assert counted[k] == ops.LAUNCHES[k] == m + fired, (k, counted)
    assert counted["gmres_block_givens"] == m
    bmv, eta_, target, ortho, branch_free, dist = cyc._args
    store = cyc.acc.empty()
    state = torch.empty_like(cyc.state)
    BL._block_cycle(bmv, cyc.acc, store, state, cyc.init, cyc.W0, cyc.bn,
                    eta_, target, ortho, branch_free, dist)
    assert torch.equal(state, cyc.state)
    for key in ("codes", "exps"):
        assert torch.equal(store[key], cyc.store[key])


@pytest.mark.cuda
def test_gate_mgs_census_on_a_nccl_group_of_one(nccl):
    """The census of a warmed MGS sharded solve on one NCCL rank: the
    replays add the second pass's all-reduces only at the fired steps, and
    the recorded bytes equal ``cycle_wire_bytes`` with those steps."""
    from repro_torch.analysis import traffic

    info = {}
    assert traffic.census_world(0, "cuda", info=info, ortho="mgs") == []
    solve = info["census[rows, mgs]"]
    assert solve["priced"]["cycle"] == solve["model"]["cycle"]
    assert solve["fired"] is not None


@pytest.mark.cuda
def test_if_node_bodies_never_capture_on_the_capturing_stream(cuda):
    """An IF node's body is captured on a stream of its own: however far
    PyTorch's round-robin stream pool has turned (one more stream taken
    before every other capture, past two whole turns of the pool), the
    body's stream is never the stream the graph captures on, and every
    capture builds its node."""
    from repro_torch.solver import graphs

    x = torch.arange(8.0, device="cuda")
    y = torch.zeros_like(x)
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    for i in range(70):
        for _ in range(i % 2):
            torch.cuda.Stream()
        g = torch.cuda.CUDAGraph()
        with graphs.capturing(g) as cap, torch.cuda.graph(g):
            assert cap.stream != torch.cuda.current_stream()
            with graphs.device_if(pred) as put:
                put(y, x + 1.0)
        y.zero_()
        g.replay()
        assert torch.equal(y, x + 1.0)


#: the eta of the over-ranks MGS solve: a mixed fired pattern in both of
#: its cycles (8 and 4 of 40 steps at P = 1 on the CPU)
OVER_RANKS_ETA = 0.4


def _mgs_ranks(rank, dev, mode):
    """One rank of the over-ranks tests: a sharded frsz2_32 MGS solve
    (atmosmod n 8000, m 40; eta :data:`OVER_RANKS_ETA` for ``"if"``, the
    default eta else) over every rank.
    ``mode``: ``"forced"`` puts the pass into an IF node with its
    reductions on NCCL (the error text); ``"select"`` makes the peer gather
    unreachable (the branch-free route); ``"if"`` the default route.  Two
    solves (capture, replay), the unsharded solve, one replayed cycle's
    launches against the same cycle run eagerly, the IF bodies' recorded
    collectives; for ``"if"`` also the census and the reads audit of the
    fixed trajectory at the same eta."""
    import traceback

    import repro_torch.solver.sharded as S
    from repro_torch.analysis import traffic
    from repro_torch.dist.collectives import gather_objects
    from repro_torch.kernels import peer_gather
    from repro_torch.solver import clear_graph_cache, graphs
    from repro_torch.solver import pipeline as PL

    P = torch.distributed.get_world_size()
    A, target = make_problem("synth:atmosmod", 8000, device=dev)
    b, _ = rhs_for(A, device=dev)
    kw = dict(storage="frsz2_32", m=40, target_rrn=target)
    if mode == "if":
        kw["eta"] = OVER_RANKS_ETA
    if mode == "forced":
        PL._second_pass = lambda fired, dist: graphs.device_if(fired)
        try:
            gmres(A, b, shard=P, **kw)
        except Exception:
            return dict(error=traceback.format_exc())
        return dict(error=None)
    if mode == "select":
        peer_gather.reachable = lambda group, device: False
        S._REACHABLE.clear()
    rs = [gmres(A, b, shard=P, **kw) for _ in range(2)]
    fired_by_rank = gather_objects(rs[1].fired.tolist())
    cyc = cardcheck.last_sharded_cycle()
    fired, launches, eager_equal = cardcheck.replay_against_eager(cyc)
    body_calls = sorted({c.name for body in cyc.bodies for c in body.calls})
    ru = gmres(A, b, **kw)
    out = dict(route=rs[1].second_pass, iters=[r.iterations for r in rs],
               unsharded=ru.iterations, fired=rs[1].fired.sum(1).tolist(),
               unsharded_fired=ru.fired.sum(1).tolist(),
               equal=bool(torch.equal(rs[0].x, rs[1].x)),
               fired_on_every_rank=all(f == fired_by_rank[0]
                                       for f in fired_by_rank),
               cycle_fired=fired, launches=launches, m=kw["m"],
               eager_equal=eager_equal, bodies=len(cyc.bodies),
               body_calls=body_calls)
    clear_graph_cache()
    if mode == "if":
        info = {}
        out["census"] = [f.render() for f in traffic.census_world(
            rank, dev, info=info, ortho="mgs", eta=OVER_RANKS_ETA)]
        out["census_info"] = info["census[rows, mgs]"]
        out["reads"] = [f.render() for f in traffic.audit_reads(
            A, b, storage="frsz2_32", m=20, k=2, info=info, ortho="mgs",
            eta=OVER_RANKS_ETA, shard=P)]
        out["reads_info"] = info["reads[frsz2_32, mgs, shard=%d]" % P]
        clear_graph_cache()
    return out


def _over_ranks(mode):
    from repro_torch.dist import spawn

    P = min(torch.cuda.device_count(), 4)
    if P < 2:
        pytest.skip("needs two cards or more")
    return P, spawn(_mgs_ranks, P, mode, device="cuda", timeout_s=300)


@pytest.mark.cuda
def test_mgs_over_ranks_keeps_the_branch_free_pass(cuda):
    """Over cards that cannot reach each other's memory (the peer gather
    made unreachable here) the sharded MGS cycle keeps the branch-free
    pass, chosen from that capability and not from the group's size: it
    solves in the unsharded iterations, replays with equal bits, and runs
    both sweeps at every step.  Why it may not simply put the pass into an
    IF node with its reductions on NCCL: CUDA refuses NCCL's collectives
    inside a conditional node (the capture fails with "invalid
    argument"), kept here as the record."""
    P, forced = _over_ranks("forced")
    assert forced["error"] is not None
    assert "invalid argument" in forced["error"], forced["error"][-2000:]
    _, got = _over_ranks("select")
    assert got["route"] == "select"
    assert got["equal"] and got["eager_equal"], got
    assert got["fired_on_every_rank"], got
    assert got["iters"] == [got["unsharded"]] * 2, got
    m = got["m"]
    assert got["launches"]["frsz2_rmatvec"] == 2 * m, got["launches"]
    assert got["launches"]["peer_gather"] == 0 and got["bodies"] == 0
    cause = [ln for ln in forced["error"].splitlines() if "CUDA error" in ln]
    print(f"\n[mgs over {P} ranks] forced IF node on NCCL: {cause[:1]}; "
          f"branch-free pass: {got['iters']} it")


@pytest.mark.cuda
def test_mgs_over_ranks_runs_the_pass_in_the_if_node(cuda):
    """Over 2-4 cards with peer access the sharded MGS cycle holds its
    second pass in an IF node a step, its reductions over the peer gather
    (no NCCL call in any body): at eta 0.4 a replayed cycle launches
    kernels 3 and 4 m + fired times and the peer gather twice a fired step
    (the dots and the norm); the replay equals the eagerly run cycle bit
    for bit and the replayed solve the captured one; the iterations are
    the unsharded solve's within one (NCCL sums the first pass's partials
    in another order than one card sums its rows, so a borderline step
    may fire or converge otherwise), and every rank fired at the same
    steps; the census and the reads audit equal their models with the
    fired steps."""
    P, got = _over_ranks("if")
    assert got["route"] == "if+peer_gather"
    m, fired = got["m"], got["cycle_fired"]
    assert 0 < fired < m, got
    assert got["bodies"] == m and got["body_calls"] == ["peer_gather"]
    launches = got["launches"]
    for k in ("frsz2_matvec", "frsz2_rmatvec"):
        assert launches[k] == m + fired, (k, launches)
    assert launches["graph_if"] == m
    assert launches["peer_gather"] == 2 * fired
    assert got["equal"] and got["eager_equal"], got
    assert got["fired_on_every_rank"], got
    assert got["iters"][0] == got["iters"][1], got
    assert abs(got["iters"][1] - got["unsharded"]) <= 1, got
    assert got["census"] == [] and got["reads"] == [], got
    info = got["census_info"]
    assert 0 < sum(info["fired"]) < 2 * 8, info["fired"]
    assert info["priced"]["cycle"] == info["model"]["cycle"]
    print(f"\n[mgs over {P} ranks] IF node + peer gather: {got['iters']} it"
          f" (unsharded {got['unsharded']}), fired {got['fired']}; one "
          f"cycle: {fired} fired, kernels 3/4 {launches['frsz2_rmatvec']}, "
          f"peer gathers {launches['peer_gather']}; census cycle "
          f"{info['priced']['cycle']}")


@pytest.mark.cuda
def test_peer_gather_on_a_nccl_group_of_one(nccl):
    """The kernel at one rank against its plain version (NCCL's
    all-gather, the decode, the sum in rank order), bit for bit: f64 at
    the scalar body's (m + 1), the block body's (m + 1) p^2 and a norm's
    0-d, f32, and the wire's codes of (m + 1) values summed into f64 and
    f32; twice each (the slots' two parities), the call counters advancing
    once a call.  At one rank the sum is the buffer itself (its decode,
    coded)."""
    from repro_torch.dist import collectives
    from repro_torch.kernels import peer_gather
    from repro_torch.solver.sharded import second_pass_bytes

    gen = torch.Generator(device="cuda").manual_seed(31)
    route = peer_gather.Route(None, "cuda", second_pass_bytes(100, 8))
    region = route.region       # a live one of this group may be reused
    assert region.chunks == peer_gather._chunks(1, region.slot_bytes) >= 12
    before = region.counters.clone()
    calls = 0
    cases = [((101,), torch.float64, None), ((101, 8, 8), torch.float64, None),
             ((), torch.float64, None), ((101,), torch.float32, None),
             ((101,), torch.float32, torch.float64),
             ((101,), torch.float32, torch.float32)]
    for shape, dtype, coded_into in cases:
        x = torch.randn(shape, generator=gen, dtype=dtype, device="cuda")
        src, kw, want = x, {}, x
        if coded_into is not None:
            bc = ops.compress(x, collectives.WIRE_SPEC)
            src = collectives._pack(bc)
            kw = dict(coded=bc, out_dtype=coded_into)
            want = ops.decompress(bc).to(coded_into)
        for _ in range(2):
            ops.reset_launches()
            got = peer_gather.reduce(src, route, **kw)  # graphlint: ok[raw-collective] the kernel against its plain version
            assert ops.LAUNCHES["peer_gather"] == 1
            plain = peer_gather.reduce(src, route, kernel=False, **kw)  # graphlint: ok[raw-collective] its plain version
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, plain) and torch.equal(got, want)
            calls += 1
    assert torch.equal(region.counters, before + calls)


_TRAP_CHILD = r"""
import ctypes, sys
import torch
from repro_torch.kernels import build, peer_gather as PG
P, slot = 2, 256
total = ctypes.c_longlong(0)
PG._call("peer_gather_region_bytes", [ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)], P, 1, slot,
         ctypes.byref(total))
hsize = build.bind("peer_gather", "peer_gather_handle_bytes", [])()
bases = []
for _ in range(P):
    base, h = ctypes.c_void_p(), ctypes.create_string_buffer(hsize)
    PG._call("peer_gather_alloc", [ctypes.c_longlong, PG._PP, PG._P],
             total.value, ctypes.byref(base), h)
    bases.append(base.value)
peers = torch.tensor(bases, dtype=torch.int64, device="cuda")
counters = torch.zeros(P, dtype=torch.int64, device="cuda")
x = torch.ones(8, dtype=torch.float64, device="cuda")
out = torch.empty(8, dtype=torch.float64, device="cuda")
# rank 0 of two; rank 1 never calls: the kernel waits 0.2 s for its flag
PG._call("peer_gather_run", PG._RUN, peers.data_ptr(), 0, P, 1, x.data_ptr(),
         64, slot, 1, 8, 0, 1, out.data_ptr(), counters.data_ptr(),
         200_000_000, build.stream())
try:
    torch.cuda.synchronize()
except Exception as exc:
    print("TRAPPED", type(exc).__name__, str(exc).splitlines()[0])
    sys.exit(0)
print("NO TRAP")
"""


@pytest.mark.cuda
def test_peer_gather_traps_when_a_peer_never_comes(cuda, tmp_path):
    """A rank whose peer takes the other branch (or stops) gets a CUDA
    error from the kernel's bounded wait, not a hang: rank 0 of two whose
    rank 1 never calls, with a 0.2 s bound, in a process of its own (a
    trap ends the process's context)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", _TRAP_CHILD], env=env,
                          capture_output=True, text=True, timeout=120)
    assert "TRAPPED" in proc.stdout, (proc.stdout, proc.stderr[-2000:])
    print(f"\n[peer gather] a peer that never comes: {proc.stdout.strip()}")


# ---------------------------------------------------------------------------
# Slice 11: the solver's storage formats and pipeline options on the card
# ---------------------------------------------------------------------------

#: (problem, storage, options) of the options the card tests drive at
#: n = 8000 (``-k options``)
OPTION_CASES = [
    ("synth:atmosmod", "float32", {}),
    ("synth:atmosmod", "float16", {}),
    ("synth:atmosmod", "frsz2_16", {}),
    ("synth:atmosmod", "mixed:2:frsz2_32", {}),
    ("synth:atmosmod", "frsz2_32", {"ortho": "cgs2"}),
    ("synth:atmosmod", None, {"policy": "adaptive"}),
    ("synth:varcoef", "frsz2_32", {"precond": "jacobi"}),
    ("synth:lung", "frsz2_32", {}),
]
FRSZ2_KERNELS = ("frsz2_compress", "frsz2_matvec", "frsz2_rmatvec")


def _option_launches(storage, kw):
    """(kernels that must launch, kernels that must not) in a device solve
    of an option."""
    if storage in ("float32", "float16"):
        return (("ell_spmv", "gmres_givens", "graph_if"),
                FRSZ2_KERNELS + ("frsz2_decompress", "ell_spmv_frsz2"))
    if "precond" in kw:           # the preconditioned operand is decoded
        return (FRSZ2_KERNELS + ("frsz2_decompress", "ell_spmv",
                                 "gmres_givens", "graph_if"),
                ("ell_spmv_frsz2",))
    path = FRSZ2_KERNELS + ("ell_spmv_frsz2", "ell_spmv", "gmres_givens")
    if kw.get("ortho") == "cgs2":  # two passes at every step, no IF node
        return path, ("frsz2_decompress", "graph_if")
    return path + ("graph_if",), ("frsz2_decompress",)


@pytest.mark.cuda
@pytest.mark.parametrize("name,storage,kw", OPTION_CASES,
                         ids=[f"{p.split(':')[1]}-{s}-"
                              f"{'-'.join(map(str, k.values())) or 'mgs'}"
                              for p, s, k in OPTION_CASES])
def test_options_device_driver_equals_host_on_card(cuda, name, storage, kw):
    """Each storage format and pipeline option at n = 8000 on the card: the
    device driver (captured, then replayed) bit-equal to the host driver
    (iterations, restarts, ``bytes_read``, ``op_reads``, x); a second and a
    third solve capture no graph and launch the same kernels as often; the
    kernels each option's path launches, and no other FRSZ2 kernel.  The
    adaptive policy captures one graph a level it reaches, each launching
    its own format's kernels.  ``synth:lung`` has ELL width 4: its SpMV
    runs the row kernel."""
    from repro_torch.kernels import ell_spmv as KE
    from repro_torch.solver.gmres import _GRAPHS
    from repro_torch.solver.pipeline import resolve_policy

    A, target = make_problem(name, 8000, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    sk = dict(storage=storage, m=50, max_iters=6000, target_rrn=target, **kw)
    rh = gmres(A, b, driver="host", **sk)
    keys = set(_GRAPHS)
    r1 = gmres(A, b, **sk)
    new = [_GRAPHS[k] for k in _GRAPHS if k not in keys]
    keys = set(_GRAPHS)
    ops.reset_launches()
    r2 = gmres(A, b, **sk)
    launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    r3 = gmres(A, b, **sk)
    assert set(_GRAPHS) == keys and dict(ops.LAUNCHES) == launches
    assert rh.converged
    for r in (r1, r2, r3):
        assert (r.iterations, r.restarts) == (rh.iterations, rh.restarts)
        assert r.bytes_read == rh.bytes_read and r.op_reads == rh.op_reads
        assert torch.equal(r.x, rh.x)
    must, never = _option_launches(storage, kw)
    assert all(launches[k] > 0 for k in must), launches
    assert not any(launches[k] for k in never), launches
    if "policy" in kw:
        policy = resolve_policy(kw["policy"], None, torch.float64, target, 50)
        levels = {policy.level(float(rr), i) for i, rr in
                  enumerate(r2.restart_rrns[:len(r2.fired)])}
        assert len(new) == len(levels) >= 2, (len(new), levels)
        for cyc in new:
            coded = any(cyc.launches.get(k) for k in FRSZ2_KERNELS)
            assert coded == ("frsz2" in cyc.acc.fmt.name), cyc.launches
    else:
        assert len(new) == 1
    if name == "synth:lung":
        assert KE.body(A._ell().vals.shape[1]) == "row"


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "float16"])
def test_options_native_basis_captures_in_bounded_memory_on_card(cuda,
                                                                storage):
    """A float32 / float16 basis at n = 1,000,000, m = 100: one captured
    cycle and its IF nodes hold the rows' f64 conversions in chunks of a
    fixed size.  Converting the first j rows whole at step j put a copy a
    row larger at every step into the graph's pools (about 40 GB here), and
    the full-width float32 capture ran out of the card's memory.  The
    capture now reserves under 4 GiB beyond the store, and the replayed
    solve is bit-equal to the host driver's."""
    from repro_torch.solver import clear_graph_cache

    clear_graph_cache()
    torch.cuda.empty_cache()
    A, target = make_problem("synth:atmosmod", 1_000_000, device=cuda)
    b, _ = rhs_for(A, device=cuda)
    kw = dict(storage=storage, m=100, max_iters=100, target_rrn=target)
    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    r1 = gmres(A, b, **kw)
    grown = torch.cuda.max_memory_reserved() - base
    r2 = gmres(A, b, **kw)
    rh = gmres(A, b, driver="host", **kw)
    assert grown < 4 * 2**30, grown / 2**30
    assert r1.iterations == r2.iterations == rh.iterations > 0
    assert torch.equal(r1.x, r2.x) and torch.equal(r2.x, rh.x)
    clear_graph_cache()
