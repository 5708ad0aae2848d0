"""Shared checks of the redesigned kernels on the card.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both hold the kernels to
these, so the two cannot drift apart: the row counts that cross the matvec's,
the rmatvec's and the block combine's tilings, the lengths that cross the
decode attention's tiles and splits, bit comparison of values, seeded
codes, the checks across the scaled decode's guard (matvec, rmatvec, block
combine, decode attention), the rmatvec against its row-order plain sum
and on codes at an offset, the row codec's spot list and edge cases (rows
past the old grid limit, a ragged n, views at an offset), each launching
once, and the codec on one long row (an AdamW moment of a whole leaf)
against the plain codec a block-aligned chunk at a time, a captured
cycle's replay against the same cycle run eagerly, and one captured call
replayed against the eager call.  Each
check runs the kernel through ``ops`` (so it launches on a CUDA generator's
device) and compares with the plain ``decompress`` or the plain version of
the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attn import TILE

#: rows across the matvec's and the rmatvec's 8-row ring turns and the
#: matvec's 128-row groups, and block rows across the combine's ring turns
#: and Y tiles (p = 8: M = 8 ... 808)
EDGE_ROWS = (1, 2, 7, 33, 64, 65, 101)

#: (value dtype, exponent bias) of the checks across the guard
GUARD_DTYPES = ((torch.float64, 1023), (torch.float32, 127))

#: decode attention: lengths at and across its tile's edges and a
#: two-tile split's
ATTN_EDGE_LENGTHS = (0, 1, TILE - 1, TILE, TILE + 1, 2 * TILE, 2 * TILE + 1,
                     5 * TILE - 3)
#: the row codec's spot checks: (value dtype, l, bs), each in both
#: roundings, at a ragged n
CODEC_SPOTS = ((torch.float32, 32, 32), (torch.float32, 16, 128),
               (torch.float32, 8, 64), (torch.float64, 16, 128),
               (torch.float64, 32, 1), (torch.float64, 8, 8),
               (torch.float16, 16, 32), (torch.float16, 8, 128),
               (torch.bfloat16, 16, 8), (torch.bfloat16, 8, 32))
#: rows at and past 65,535, the first codec's grid limit: (rows, n, value
#: dtype, l, bs, rounding); the first is the serving prefill's K write
CODEC_MANY_ROWS = ((65536, 128, torch.float32, 16, 128, "nearest"),
                   (70000, 96, torch.float64, 32, 32, "truncate"))

#: f32 q: max |kernel - plain| over max |plain| (f32 sums in another order,
#: base-2 exponentials); bf16 q: one bf16 step, absolute
ATTN_TOL, ATTN_TOL_BF16 = 1e-5, 2 ** -7


def bits(t: torch.Tensor) -> torch.Tensor:
    """The integer view of a float tensor of 2, 4 or 8 bytes."""
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
        t.element_size()])


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits after ``+ 0.0`` (so -0 and +0 meet), NaN where the other
    is NaN (NaN payloads are not compared)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    a0 = torch.where(na, torch.zeros_like(a), a) + 0.0
    b0 = torch.where(nb, torch.zeros_like(b), b) + 0.0
    return torch.equal(na, nb) and torch.equal(bits(a0), bits(b0))


def rand_codes(shape, l: int, gen: torch.Generator) -> torch.Tensor:
    """Seeded l-bit codes of every sign and size, in the codec's container."""
    c = torch.randint(0, 1 << l, shape, generator=gen, device=gen.device)
    if l > 8:
        c = c - (c >= (1 << (l - 1))).long() * (1 << l)
    return c.to(F.code_dtype(l))


def guard_exponents(l: int, bias: int, gen: torch.Generator) -> torch.Tensor:
    """Block exponents across the scaled decode's guards: the flush zone
    0..l-2, its edge l-1 and a few above, a seeded spread, the one-FMA
    decode's top edge 2*bias + l - 54 (f64) and its neighbours, 2*bias - 1,
    2*bias and 2*bias + 1 (Inf/NaN patterns)."""
    spread = torch.randint(0, 2 * bias + 2, (8,), generator=gen,
                           device=gen.device)
    top = 2 * bias + l - 54
    return torch.cat([torch.arange(l + 9, device=gen.device), spread,
                      torch.tensor([top - 1, top, top + 1, 2 * bias - 1,
                                    2 * bias, 2 * bias + 1],
                                   device=gen.device)]).to(torch.int32)


def matvec_across_guard(dtype, bias: int, l: int,
                        gen: torch.Generator) -> tuple[list[int], int]:
    """The matvec on rows whose one exponent crosses the guard: a code in
    one column, zeros elsewhere, x one-hot there, so each row's product is
    the decoded code.  Returns (columns whose rows differ from
    ``decompress``, rows checked)."""
    dev = gen.device
    spec = F.FrszSpec(bs=32, l=l, dtype=dtype)
    E = guard_exponents(l, bias, gen)
    R = E.numel()
    bad = []
    for c in (0, 5, 33, 63):
        codes = torch.zeros((R, 2, 32), dtype=F.code_dtype(l), device=dev)
        codes.view(R, 64)[:, c] = rand_codes((R,), l, gen)
        bc = F.BlockCompressed(codes=codes,
                               exps=E[:, None].repeat(1, 2).contiguous(),
                               n=64, spec=spec)
        x = torch.zeros((64,), dtype=dtype, device=dev)
        x[c] = 1.0
        if not same_values(ops.matvec(bc, x, kernel=True),
                           ops.decompress(bc, kernel=False)[:, c]):
            bad.append(c)
    return bad, 4 * R


def combine_across_guard(dtype, bias: int, l: int,
                         gen: torch.Generator) -> tuple[bool, int]:
    """The combine over one segment row whose codec blocks carry exponents
    across the guard, Y = 1: the output is the decoded row (fma(1, v, 0)).
    Returns (equal to ``decompress``, codes checked)."""
    dev = gen.device
    spec = F.FrszSpec(bs=32, l=l, dtype=dtype)
    E = guard_exponents(l, bias, gen)
    E = torch.cat([E, E[:(-E.numel()) % 4]])    # whole 16-byte words
    nb = E.numel()
    bc = F.BlockCompressed(codes=rand_codes((1, nb, 32), l, gen),
                           exps=E[None].contiguous(), n=nb * 32, spec=spec)
    Y = torch.ones((1, 1, 1), dtype=dtype, device=dev)
    got = ops.block_combine(bc, Y, p=1, kernel=True)[0]
    return same_values(got, ops.decompress(bc, kernel=False)[0]), nb * 32


def rmatvec_across_guard(dtype, bias: int, l: int, bs: int,
                         gen: torch.Generator) -> tuple[list[int], int]:
    """The rmatvec over nine rows (past its ring of eight) whose codec
    blocks carry exponents across the guard (:func:`guard_exponents`, a
    whole number of 16-byte words of codes a row at bs = 2): row k holds
    seeded codes, the others zero codes (+0 at any exponent), h is one-hot
    at k, so the output is row k decoded (``fma(1, v, +0)``, equal after
    ``+ 0.0``).  bs = 2 spreads a word over several codec blocks (the out of
    line decode, an exponent a code).  Returns (rows whose output differs
    from ``decompress``, codes checked)."""
    dev = gen.device
    spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
    E = guard_exponents(l, bias, gen)
    E = torch.cat([E, E[:(-E.numel()) % 8]])
    R, nb = 9, E.numel()
    exps = E[None].repeat(R, 1).contiguous()
    bad = []
    for k in range(R):
        codes = torch.zeros((R, nb, bs), dtype=F.code_dtype(l), device=dev)
        codes[k] = rand_codes((nb, bs), l, gen)
        bc = F.BlockCompressed(codes=codes, exps=exps, n=nb * bs, spec=spec)
        h = torch.zeros((R,), dtype=dtype, device=dev)
        h[k] = 1.0
        if not same_values(ops.rmatvec(bc, h, kernel=True),
                           ops.decompress(bc, kernel=False)[k]):
            bad.append(k)
    return bad, R * nb * bs


def rmatvec_rows_equal(bc: F.BlockCompressed, h: torch.Tensor) -> bool:
    """The rmatvec kernel over ``bc``'s rows bit-equal to its row-order
    plain version (``ref.rmatvec_rows_ref``), one launch."""
    from repro_torch.kernels import ref

    before = ops.LAUNCHES["frsz2_rmatvec"]
    got = ops.rmatvec(bc, h, kernel=True)
    want = ref.rmatvec_rows_ref(bc.codes, bc.exps, h, bc.spec)[:bc.n]
    return (ops.LAUNCHES["frsz2_rmatvec"] == before + 1
            and torch.equal(bits(got), bits(want)))


def offset_view(bc: F.BlockCompressed, by: int = 1) -> F.BlockCompressed:
    """``bc`` with its codes copied into a view ``by`` codes past the start
    of a larger buffer (the row stride unchanged): codes that do not start
    on a 16-byte word."""
    flat = torch.zeros(bc.codes.numel() + by, dtype=bc.codes.dtype,
                       device=bc.codes.device)
    codes = flat[by:].view(bc.codes.shape)
    codes.copy_(bc.codes)
    return F.BlockCompressed(codes=codes, exps=bc.exps, n=bc.n, spec=bc.spec)


def replay_equals_eager(fn) -> bool:
    """``fn()`` eagerly, then captured in a CUDA graph (after a warm-up on
    a side stream) and replayed once: the replay's output bit-equal to the
    eager call's."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = fn()
    g.replay()
    torch.cuda.synchronize()
    return torch.equal(bits(got), bits(want))


def attn_pair(q, k_bc, v_bc, lengths, **kw):
    """Decode attention, kernel against plain on the same inputs: (kernel
    output, max abs error, that over the largest |plain output|)."""
    ok = ops.decode_attention(q, k_bc, v_bc, lengths, kernel=True, **kw)
    op = ops.decode_attention(q, k_bc, v_bc, lengths, kernel=False, **kw)
    if ok.dtype != q.dtype or op.dtype != q.dtype or ok.shape != op.shape:
        raise AssertionError("decode attention: kernel and plain differ in "
                             "type or shape")
    err = float((ok.float() - op.float()).abs().max())
    return ok, err, err / float(op.float().abs().max())


def attn_across_guard(l: int, exp_dtype,
                      gen: torch.Generator) -> tuple[bool, float, int]:
    """Decode attention (D = bs = 128, one block a position) over K and V
    positions whose block exponents cross the scaled decode's guard
    (:func:`guard_exponents` of f32, one exponent a sequence).

    V: every sequence has length 1, so each output row is its position 0's
    V row, decoded: it must equal ``decompress`` (``same_values``; NaN and
    Inf patterns at 2*bias+1 included).  K: length 2; position 0 holds one
    code (either sign, an integer bit of 0, so finite at every exponent) in
    column 5, position 1 zeros; q is one-hot in column 5 at 2^(127 - e), so
    with ``sm_scale`` 8 every logit lies in (-8, 8); V is 1.0 at position 0 and 0 at 1, so each
    output is position 0's softmax weight: held to the plain version within
    ``ATTN_TOL`` of the largest output.  Returns (V equal to ``decompress``,
    the K case's relative error, sequences checked)."""
    dev = gen.device
    D, S, G = 128, 3, 2
    spec = F.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest",
                      exp_dtype=exp_dtype)
    E = guard_exponents(l, 127, gen)
    B = E.numel()
    exps = torch.full((B, 1, S, 1), 127, dtype=torch.int32, device=dev)
    exps[:, 0, 0, 0] = E
    exps = exps.to(exp_dtype)

    def bc(codes):
        return F.BlockCompressed(codes=codes, exps=exps, n=D, spec=spec)

    # V across the guard, K random at exponent 127
    v_bc = bc(rand_codes((B, 1, S, 1, D), l, gen))
    k_bc = F.BlockCompressed(codes=rand_codes((B, 1, S, 1, D), l, gen),
                             exps=torch.full_like(exps, 127), n=D, spec=spec)
    q = torch.randn((B, G, D), generator=gen, device=dev)
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, k_bc, v_bc, ones, kernel=True)
    want = ops.decompress(v_bc, kernel=False)[:, 0, 0]
    v_ok = same_values(got, want[:, None].expand(B, G, D))

    # K across the guard
    kc = torch.zeros((B, 1, S, 1, D), dtype=F.code_dtype(l), device=dev)
    sig = torch.randint(1, 1 << (l - 2), (B,), generator=gen, device=dev)
    sign = torch.randint(0, 2, (B,), generator=gen, device=dev)
    code = sig + sign * (1 << (l - 1))
    if l > 8:
        code = code - (code >= (1 << (l - 1))).long() * (1 << l)
    kc[:, 0, 0, 0, 5] = code.to(kc.dtype)
    vx = torch.zeros((B, 1, S, D), device=dev)
    vx[:, :, 0] = 1.0
    v1 = ops.compress(vx, spec, kernel=False)
    qk = torch.zeros((B, G, D), device=dev)
    qk[:, :, 5] = torch.ldexp(torch.ones((B, 1), device=dev),
                              (127 - E.long())[:, None])
    _, _, rel = attn_pair(qk, bc(kc), F.BlockCompressed(
        codes=v1.codes, exps=v1.exps, n=D, spec=spec), ones + 1, sm_scale=8.0)
    return v_ok, rel, B


def spread_values(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """Seeded values over 2^-8..2^8 of every sign, a zero every 7th."""
    x = torch.randn(shape, generator=gen, dtype=torch.float64, device=gen.device)
    x = x * torch.exp2(torch.randint(-8, 8, shape, generator=gen,
                                     device=gen.device).double())
    x = x.to(dtype)
    x.view(-1)[::7] = 0.0
    return x


def codec_check(x: torch.Tensor, spec: F.FrszSpec, out=None) -> str | None:
    """The row codec on ``x`` (into ``out``, if given) against the plain
    codec: codes, exponents and decoded values bit-equal, and one launch
    each of compress and decompress.  Returns what differed, or None."""
    before = dict(ops.LAUNCHES)
    bk = ops.compress(x, spec, out=out, kernel=True)
    vk = ops.decompress(bk, kernel=True)
    launches = {k: ops.LAUNCHES[k] - before[k]
                for k in ("frsz2_compress", "frsz2_decompress")}
    bp = ops.compress(x, spec, kernel=False)
    vp = ops.decompress(bp, kernel=False)
    what = f"{spec.name} {spec.rounding} {tuple(x.shape)}"
    if not (torch.equal(bk.codes, bp.codes) and torch.equal(bk.exps, bp.exps)):
        return f"compress != plain for {what}"
    if not torch.equal(bits(vk), bits(vp)):
        return f"decompress != plain for {what}"
    if any(v != 1 for v in launches.values()):
        return f"{what}: launches {launches}, one each expected"
    return None


def codec_edges(gen: torch.Generator) -> list[str]:
    """The row codec past the old grid limit (:data:`CODEC_MANY_ROWS`), at
    a ragged n = 1001 for every spot of :data:`CODEC_SPOTS` in both
    roundings, and on views at an offset (values, codes and exponents that
    start off their vector alignment, n odd): what differed, if anything."""
    faults = []
    for rows, n, dtype, l, bs, rounding in CODEC_MANY_ROWS:
        spec = F.FrszSpec(bs=bs, l=l, dtype=dtype, rounding=rounding)
        faults.append(codec_check(spread_values((rows, n), dtype, gen), spec))
    for dtype, l, bs in CODEC_SPOTS:
        for rounding in ("truncate", "nearest"):
            spec = F.FrszSpec(bs=bs, l=l, dtype=dtype, rounding=rounding)
            faults.append(codec_check(spread_values((5, 1001), dtype, gen),
                                      spec))
    for dtype, l, bs in ((torch.float64, 32, 32), (torch.float32, 16, 128),
                         (torch.bfloat16, 8, 8)):
        spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
        n = 4099
        nb = -(-n // bs)
        x = spread_values((n + 3,), dtype, gen)[3:]
        codes = torch.empty(nb * bs + 1, dtype=F.code_dtype(l),
                            device=gen.device)[1:].view(nb, bs)
        exps = torch.empty(nb + 1, dtype=torch.int32, device=gen.device)[1:]
        faults.append(codec_check(x, spec, out=(codes, exps)))
    return [f for f in faults if f]


#: values of a long row compared at a time: the plain codec's int64
#: temporaries of a whole 360 M-value leaf would take tens of GB
ROW_CHUNK = 1 << 24


def row_codes_equal(x: torch.Tensor, bc: F.BlockCompressed) -> bool:
    """The codes and exponents of one row ``x`` (n values) as the kernel
    wrote them (``bc``, (nb, bs) and (nb,)) bit-equal to the plain codec's,
    a chunk of whole blocks at a time (the codec is blockwise)."""
    x = x.reshape(-1)
    spec, n, bs = bc.spec, x.numel(), bc.spec.bs
    codes, exps = bc.codes.reshape(-1, bs), bc.exps.reshape(-1)
    chunk = ROW_CHUNK - ROW_CHUNK % bs
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        want = F.compress(x[a:b], spec)
        blk = slice(a // bs, -(-b // bs))
        if not (torch.equal(codes[blk], want.codes)
                and torch.equal(exps[blk], want.exps.to(exps.dtype))):
            return False
    return True


def row_decode_equal(bc: F.BlockCompressed, values: torch.Tensor) -> bool:
    """``values`` (the kernel's decode of the one-row ``bc``) bit-equal to
    the plain decode, a chunk of whole blocks at a time."""
    values = values.reshape(-1)
    spec, bs = bc.spec, bc.spec.bs
    codes, exps = bc.codes.reshape(-1, bs), bc.exps.reshape(-1)
    chunk = ROW_CHUNK - ROW_CHUNK % bs
    for a in range(0, bc.n, chunk):
        b = min(a + chunk, bc.n)
        blk = slice(a // bs, -(-b // bs))
        part = F.BlockCompressed(codes=codes[blk], exps=exps[blk], n=b - a,
                                 spec=spec)
        if not torch.equal(bits(values[a:b]), bits(F.decompress(part))):
            return False
    return True


#: the CUDA function that one launch of each wrapper runs once, by its
#: ``ops.LAUNCHES`` name (the matvec and the block dots also run a finish
#: kernel; the ELL kernels have several variants and are left out)
LAUNCH_KERNELS = {"frsz2_matvec": "matvec_rows_kernel",
                  "frsz2_rmatvec": "rmatvec_rows_kernel",
                  "frsz2_block_dots": "block_dots_partial",
                  "frsz2_block_combine": "block_combine_kernel",
                  "gmres_givens": "givens_step_kernel",
                  "gmres_block_givens": "block_givens_step_kernel",
                  "graph_if": "set_condition"}


def _kernel_base(name: str) -> str:
    """``void ns::kernel<T, 7>(args)`` -> ``kernel``."""
    name = name.replace("(anonymous namespace)", "anon")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def profiled_launches(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` and count the card's executions
    of each :data:`LAUNCH_KERNELS` kernel, by wrapper name: what a replayed
    graph really ran (its IF nodes' bodies only where they ran), which a
    replay's ``ops.LAUNCHES`` must equal."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [_kernel_base(e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: names.count(sym) for k, sym in LAUNCH_KERNELS.items()}


def last_sharded_cycle():
    """The most recently used sharded scalar cycle of the graph cache."""
    from repro_torch.solver.gmres import _GRAPHS, _DeviceCycle

    return next(c for c in reversed(_GRAPHS.values())
                if isinstance(c, _DeviceCycle) and c._args[-1].sharded)


def replay_against_eager(cyc) -> tuple[int, dict, bool]:
    """Replay the captured scalar cycle ``cyc`` once on its own last
    inputs, counting its launches, then run the same cycle eagerly (the
    route a capture's warm-up takes: both passes, ``torch.where``) on the
    same inputs into a fresh store and state.  Sharded, every rank calls
    it together.  Returns the replay's fired steps, its launches
    (``ops.LAUNCHES``) and whether the two runs agree bit for bit (state
    and basis)."""
    import importlib

    G = importlib.import_module("repro_torch.solver.gmres")
    r, beta, bn = cyc.r.clone(), cyc.beta.clone(), cyc.b_norm.clone()
    ops.reset_launches()
    out = cyc(r, beta, bn)
    launches = dict(ops.LAUNCHES)
    matvec, eta, target, ortho, precond, fused, dist = cyc._args
    store = cyc.acc.empty()
    state = torch.empty_like(cyc.state)
    G._device_cycle(matvec, cyc.acc, store, state, cyc.init, r, beta, bn,
                    eta, target, ortho, precond, fused, dist)
    stores = (store.values(), cyc.store.values()) if isinstance(store, dict) \
        else ((store,), (cyc.store,))
    equal = torch.equal(state, cyc.state) and all(
        torch.equal(a, b) for a, b in zip(*stores))
    return int(out[4].sum()), launches, equal


def profiled_split(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` and split the card's time by
    kernel: ``kernels`` the busy microseconds of each kernel (by its base
    name; copies and sets by the profiler's name), largest first,
    ``launches`` their counts, ``busy_us`` the union of the card's busy
    intervals and ``span_us`` the time from the first one's start to the
    last one's end (so ``1 - busy / span`` is the card's idle share while
    ``fn`` ran)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, _kernel_base(e.name))
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return dict(kernels={}, launches={}, busy_us=0.0, span_us=0.0)
    times, counts = Counter(), Counter()
    busy, end = 0.0, spans[0][0]
    for s, e, name in spans:
        times[name] += e - s
        counts[name] += 1
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return dict(kernels=dict(times.most_common()), launches=dict(counts),
                busy_us=busy, span_us=end - spans[0][0])
