#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build  — compile every Hopper kernel from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one process per source, all at once);
2. device — the card's name and power limit as ``nvidia-smi`` prints them;
3. kernels at the main-path shape — frsz2_32 (bs=32, l=32, f64 values) on a
   101-row basis of n = 1,259,712 (``synth:atmosmod --n 1270432``): each
   kernel against its plain PyTorch version on the card (codec bit-equal,
   contractions within 1e-12 relative at r = 101 and r = 51 rows), spot
   checks of f32/f16/bf16 values, l = 8/16, bs = 1/8/64/128 and a ragged n;
   the matvec at 1, 2, 7, 33, 64, 65 and 101 rows, two calls bit-equal,
   x one-hot equal to the decoded basis, and rows whose exponents cross the scaled decode's
   guard (flush zone, 2*bias+1) equal to ``decompress``;
   the ELL SpMV on that operator, dense and with a frsz2_32-coded operand,
   bit-equal to its plain version and to a second call, with spot checks of
   f32 values, a ragged column count and bs = 8/64/128; the scaled FRSZ2
   decode through the ELL kernel (an identity operator on coded vectors of
   every l = 16 code and of l = 8 and l = 32 codes, at exponents in the
   flush zone, on the guard's edges and at 2*bias+1, w = 7 and w = 1)
   bit-equal to ``ops.decompress`` after ``+ 0.0``; the Givens step of
   the device cycle over m = 100 steps, bit-equal to its plain version; and
   CUDA-event times (median of 30) beside the byte bound, the plain version
   and a PyTorch call computing the same function (``torch.mv`` on the
   decoded basis, ``torch.sparse_csr_tensor @ x``);
4. solve to convergence — a float16 basis write on the card bit-equal to
   numpy's ``astype(float16)`` (f64 rounded once; PyTorch's own conversion
   on the card is counted against it), then ``synth:atmosmod`` n = 8000,
   m = 100, frsz2_32 and
   float64, MGS: the device driver (one CUDA graph replay per restart)
   against the host driver (equal iterations, restarts, ``bytes_read`` and
   ``op_reads``, x within 1e-10), two device solves bit-equal, and the
   kernel route against the plain route on the card;
5. full-width solve — ``synth:atmosmod --n 1270432``, m = 100, float64 and
   frsz2_32 with a bounded iteration budget, through ``gmres`` as a user
   calls it, host driver (slice 1's path) and device driver (slice 2's
   path, twice: capture, then replay), each with the launch counts set to 0
   just before and read just after.  The device driver matches the host
   driver as in phase 4; every kernel of a path launched in its frsz2_32
   solve, and no FRSZ2 kernel in the float64 ones;
6. block kernels at the main-path block shape — a frsz2_32 block basis of
   p = 8 segments of n_seg = 1,259,776: the fused block dots and block
   combine against their plain versions (within 1e-12 relative) at 101 and
   51 live block rows, with spot checks (f32 values, p = 1 and 3, a ragged
   n, bs = 1/8/64/128, l = 8/16); the block dots twice, bit-equal, and with
   one-hot rows of W equal to the decoded basis at those columns; the
   block combine bit-equal to the row-order plain sum (one fma a segment
   row, the first combine kernel's sum) at 1, 2, 7, 33, 64, 65 and 101
   block rows (M = 8..808) and in every spot check, twice bit-equal, with
   one-hot rows of Y equal to the decoded basis rows, and across the
   decode guard equal to ``decompress``; the
   batched ELL SpMV (8 operands, one launch) bit-equal to its plain version
   and to a second call; the block Givens step of the
   block cycle bit-equal to its plain version over m = 100 steps at p = 8;
   CUDA-event times beside the bound, the plain version and ``torch.mm``
   on the decoded basis (``torch.sparse_csr_tensor @ X`` for the ELL);
7. block solves (slice 3's path) — ``gmres_batched`` at n = 8000, p = 8,
   m = 100, float64 and frsz2_32: the block device driver against the block
   host driver (equal per-column iterations, restarts, ``bytes_read``,
   ``op_reads``, bits of X), the kernel route against the plain route and
   the vmap baseline; then at full width (n = 1,259,712, p = 8 right-hand
   sides from ``_batch_rhs``, m = 100), block on the device driver twice
   (capture, then replay) and on the host driver, and vmap, each with the
   launch counts set to 0 just before and read just after: every column
   converges, the drivers agree, every kernel of the block path launches in
   the frsz2_32 block solve and no FRSZ2 kernel in the float64 one.

8. decode attention (slice 4's kernel) at the ``decode_32k`` length with
   yi-9b's heads — B = 8, Hkv = 4, G = 8, D = 128, S = 32768, lengths from
   a seed in [1, S] and one full row, FRSZ2 K/V with uint8 exponents, l = 16
   and l = 8: the kernel against its plain version on the card (within
   1e-5 of the largest output), spot checks (D = 64, G = 1/2/3/4/12, S = 1000, bf16 q, int32
   exponents, a length-1 row), CUDA-event times beside the bound, the plain
   version and ``scaled_dot_product_attention`` on the decoded K/V with a
   length mask, at S = 32768 and at phase 9's serving shape (S = 2120,
   lengths 2048-2112);
9. serving yi-9b at full width and depth (48 layers, bf16, random weights
   from a seed): the teacher-forcing check (prefill + one decode step
   against the parallel forward, B = 2, S = 256) for ``bf16`` and
   ``frsz2_16`` caches, within 5e-2 of the largest logit; then
   ``serve`` as a user calls it, 16 requests over 8 slots, prompt 2048,
   32 new tokens each (64 decode steps, a 2120-position cache) for
   ``frsz2_16``, ``frsz2_8`` and ``bf16``, each with the launch counts set
   to 0 just before and read just after: 32 tokens in range per request,
   finite logits, ``decode_attn`` launched 48 times a decode step in the
   FRSZ2 runs and never in the ``bf16`` one, ``frsz2_compress`` twice a
   layer per prefill and decode step.  After each FRSZ2 run, on what that
   run served: the last layer's cache codes and exponents bit-equal to the
   plain compress of the K/V that the prefill (B x Hkv x 2048 rows) and the
   last decode step wrote there, and the kernel against its plain version
   on the last decode attention's q, cache and lengths (bf16 q as served,
   within one bf16 step of the largest output; the same q in f32, within
   1e-5 of it).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import functools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 outside the tensor cores at
# 34 TFLOP/s.  The codec does integer bit work only, for which the data sheet
# lists no peak rate: its bound is its bytes.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12         # f32 outside the tensor cores (data sheet)

N_MAIN = 1270432           # --n of the paper-sized atmosmod problem
M = 100                    # restart length
R_FULL, R_HALF = 101, 51   # live basis rows: m + 1, and half of it
REPS = 30
FULL_MAX_ITERS = 500

#: kernels by the path whose solve launches them: slice 1's host driver
#: reads each basis row decompressed; slice 2's device driver hands it to
#: the ELL kernel coded (``ell_spmv_frsz2``) and steps the least squares
#: with ``gmres_givens``.  Both run the dense ELL kernel on every residual.
HOST_PATH = ("frsz2_compress", "frsz2_decompress", "frsz2_matvec",
             "frsz2_rmatvec", "ell_spmv")
DEVICE_PATH = ("frsz2_compress", "frsz2_matvec", "frsz2_rmatvec", "ell_spmv",
               "ell_spmv_frsz2", "gmres_givens")
#: slice 3's block path: each block row written and read back through the
#: codec, the fused block contractions, the batched ELL, the block Givens
#: step; no scalar contraction
BLOCK_PATH = ("frsz2_compress", "frsz2_decompress", "frsz2_block_dots",
              "frsz2_block_combine", "ell_spmv", "gmres_block_givens")
P_BLOCK = 8                # right-hand sides of the block solves

#: phase 8: yi-9b's heads at the decode_32k length (``SHAPES``)
ATTN_B, ATTN_HKV, ATTN_G, ATTN_D, ATTN_S = 8, 4, 8, 128, 32768
#: f32 q: max |kernel - plain| over max |plain| (f32 sums in another order,
#: base-2 exponentials); bf16 q: one bf16 step (2^-7 absolute in the spot
#: checks, 2^-7 of the largest output on the served cache)
ATTN_TOL, ATTN_TOL_BF16 = 1e-5, 2 ** -7
#: phase 9: the serving run, and the teacher-forcing check's tolerance
SERVE_ARCH = "yi-9b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 16, 8, 2048, 32
SERVE_FORMATS = ("frsz2_16", "frsz2_8", "bf16")
TF_B, TF_S, TF_TOL = 2, 256, 5e-2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` in ms (CUDA events).  A sleep kernel
    ahead of each start event keeps the card busy while the host enqueues
    ``fn``, so the events bracket device work, not Python overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float = 0.0, peak: float = FP64_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, ms, plain_ms, nbytes, flops, err,
          library_ms=None, peak=FP64_FLOPS, **extra):
    """One kernel's record for the ``{"kernels": [...]}`` line, printed as
    it is measured; ``launches`` is filled in from the path's run."""
    b, by = bound_ms(nbytes, flops, peak)
    e = dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=b, bound_by=by, library_ms=library_ms,
             status="matches plain", **extra)
    emit(e)
    return e


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.library(name)
    dt = time.perf_counter() - t0
    print(f"[build] {len(paths)} libraries in {dt:.1f} s -> {build.build_dir()}")
    for name in sorted(paths):
        log = build.build_dir() / f"{name}.log"
        text = log.read_text() if log.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        print(f"[build] {name}: {len(regs)} kernels, at most "
              f"{max(regs, default=0)} registers, "
              f"{sum(1 for x in spills if x)} with spills")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {name} capability {cap} count {torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")
    check(cap == (9, 0), f"the kernels are built for sm_90a, card is {cap}")
    return line


def _bits(t):
    import torch

    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
        t.element_size()])


def _codec_pair(x, spec):
    """Kernel and plain compress/decompress of ``x``; asserts bit equality.

    Returns the kernel's codes and values and the largest differences from
    the plain version: in code units for compress (codes and exponents),
    in values for decompress."""
    import torch

    from repro_torch.kernels import ops

    bk = ops.compress(x, spec, kernel=True)
    bp = ops.compress(x, spec, kernel=False)
    code_err = max(float((a.long() - b.long()).abs().max())
                   for a, b in ((bk.codes, bp.codes), (bk.exps, bp.exps)))
    check(torch.equal(bk.codes, bp.codes) and torch.equal(bk.exps, bp.exps),
          f"compress != plain for {spec.name} shape {tuple(x.shape)}")
    vk = ops.decompress(bk, kernel=True)
    vp = ops.decompress(bp, kernel=False)
    check(torch.equal(_bits(vk), _bits(vp)),
          f"decompress != plain for {spec.name} shape {tuple(x.shape)}")
    value_err = float((vk.double() - vp.double()).abs().max())
    return bk, vk, code_err, value_err


def _contraction_err(bc, vec, op, r):
    """Relative max error of the kernel against the plain version."""
    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r], n=bc.n,
                            spec=bc.spec)
    fn = ops.matvec if op == "matvec" else ops.rmatvec
    yk = fn(sub, vec, kernel=True)
    yp = fn(sub, vec, kernel=False)
    abs_err = float((yk - yp).abs().max())
    return abs_err, abs_err / float(yp.abs().max()), sub


def _matvec_guard_checks(dev):
    """The matvec on rows whose one codec block exponent crosses the guard
    (``cardcheck.matvec_across_guard``): equal to ``decompress``."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck

    gen = torch.Generator(device=dev).manual_seed(31)
    checked = 0
    for dtype, bias in cardcheck.GUARD_DTYPES:
        for l in (32, 16, 8):
            bad, rows = cardcheck.matvec_across_guard(dtype, bias, l, gen)
            check(not bad, f"matvec across the guard ({F.dtype_name(dtype)}, "
                           f"l={l}, columns {bad}) != decompress")
            checked += rows
    print(f"[kernels] matvec across the decode guards: {checked} rows (f64/f32,"
          " l 8/16/32, exponents 0..l+8, a spread, 2*bias+l-55..2*bias+l-53, "
          "2*bias-1..2*bias+1) equal to decompress")


def _matvec_checks(bc, Vdec, w):
    """The matvec at the main-path shape: within 1e-12 of its plain version
    at EDGE_ROWS live rows; two calls bit-equal; one-hot x equal to the
    decoded basis."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import EDGE_ROWS, same_values

    for r in EDGE_ROWS:
        _, rel, _ = _contraction_err(bc, w, "matvec", r)
        check(rel <= 1e-12, f"matvec r={r} relative error {rel:.3e} > 1e-12")
    sub = F.BlockCompressed(codes=bc.codes[:R_FULL], exps=bc.exps[:R_FULL],
                            n=bc.n, spec=bc.spec)
    y = ops.matvec(sub, w, kernel=True)
    check(torch.equal(y, ops.matvec(sub, w, kernel=True)),
          "matvec: two calls differ")
    n = bc.n
    at = [0, 1, 3, 4, 1023, 1024, 4097, n // 2 + 5, n - 1]
    for c in at:
        x = torch.zeros_like(w)
        x[c] = 1.0
        check(same_values(ops.matvec(sub, x, kernel=True),
                          Vdec[:R_FULL, c].contiguous()),
              f"matvec with x one-hot at column {c} != the decoded basis")
    print(f"[kernels] matvec at rows {list(EDGE_ROWS)} within 1e-12; two "
          f"calls bit-equal; x one-hot at columns {at} equal to the decoded "
          "basis")
    _matvec_guard_checks(bc.codes.device)


def phase_kernels():
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    s = round(N_MAIN ** (1 / 3))
    n = s * s * s
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    V = torch.randn((R_FULL, n), generator=gen, dtype=torch.float64, device=dev)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)   # Krylov-like rows
    w = torch.randn((n,), generator=gen, dtype=torch.float64, device=dev)

    bc, Vdec, code_err, value_err = _codec_pair(V, spec)
    results = {}
    for r in (R_FULL, R_HALF):
        h = torch.randn((r,), generator=gen, dtype=torch.float64, device=dev)
        for op, vec in (("matvec", w), ("rmatvec", h)):
            abs_err, rel, _ = _contraction_err(bc, vec, op, r)
            check(rel <= 1e-12, f"{op} r={r} relative error {rel:.3e} > 1e-12")
            results[(op, r)] = dict(abs=abs_err, rel=rel, vec=vec)
            print(f"[kernels] {op} r={r}: max abs err {abs_err:.3e}, "
                  f"relative {rel:.3e}")

    # spot checks: other value types, code widths, block sizes, ragged n
    g2 = torch.Generator(device=dev).manual_seed(7)
    spots = [(torch.float32, 32, 32), (torch.float32, 16, 128),
             (torch.float32, 8, 64), (torch.float64, 16, 128),
             (torch.float64, 32, 1), (torch.float64, 8, 8),
             (torch.float16, 16, 32), (torch.float16, 8, 128),
             (torch.bfloat16, 16, 8), (torch.bfloat16, 8, 32)]
    for dtype, l, bs in spots:
        for rounding in ("truncate", "nearest"):
            sp = F.FrszSpec(bs=bs, l=l, dtype=dtype, rounding=rounding)
            x = torch.randn((5, 1001), generator=g2, dtype=torch.float64,
                            device=dev)
            x = (x * torch.exp2(torch.randint(-8, 8, (5, 1001), generator=g2,
                                              device=dev).double())).to(dtype)
            x[0, ::7] = 0.0
            sbc, *_ = _codec_pair(x, sp)
            if dtype in (torch.float32, torch.float64):
                tol = 1e-12 if dtype == torch.float64 else 1e-5
                hv = torch.randn((5,), generator=g2, dtype=dtype, device=dev)
                xv = torch.randn((1001,), generator=g2, dtype=dtype, device=dev)
                for op, vec in (("matvec", xv), ("rmatvec", hv)):
                    _, rel, _ = _contraction_err(sbc, vec, op, 5)
                    check(rel <= tol, f"{op} {sp.name} relative error {rel:.3e}")
    print(f"[kernels] spot checks passed: {len(spots) * 2} specs, ragged n=1001")
    _matvec_checks(bc, Vdec, w)

    # times at the main-path shape
    npad = bc.codes.shape[1] * spec.bs
    nb = bc.codes.shape[1]
    row_bytes = npad * 4 + nb * 4
    x_row = V[7].contiguous()
    codes_row = torch.empty_like(bc.codes[0])
    exps_row = torch.empty_like(bc.exps[0])
    row_bc = F.BlockCompressed(codes=bc.codes[7], exps=bc.exps[7], n=n,
                               spec=spec)
    entries = {}
    codec_src = "src/repro_torch/kernels/csrc/frsz2_codec.cu"
    dot_src = "src/repro_torch/kernels/csrc/frsz2_dot.cu"
    entries["frsz2_compress"] = entry(
        "frsz2_compress", codec_src, "src/repro/kernels/frsz2_kernel.py:113",
        timed(lambda: ops.compress(x_row, spec, out=(codes_row, exps_row),
                                   kernel=True)),
        timed(lambda: ops.compress(x_row, spec, out=(codes_row, exps_row),
                                   kernel=False)),
        n * 8 + row_bytes, 0.0, code_err, shape=f"1 x {n}",
        err_unit="code")
    entries["frsz2_decompress"] = entry(
        "frsz2_decompress", codec_src, "src/repro/kernels/frsz2_kernel.py:75",
        timed(lambda: ops.decompress(row_bc, kernel=True)),
        timed(lambda: ops.decompress(row_bc, kernel=False)),
        row_bytes + n * 8, 0.0, value_err, shape=f"1 x {n}")
    for r in (R_FULL, R_HALF):
        sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r], n=n,
                                spec=spec)
        Vr = Vdec[:r]
        for op, fn, lib, replaces in (
                ("matvec", ops.matvec, lambda Vr=Vr: torch.mv(Vr, w),
                 "src/repro/kernels/frsz2_dot.py:77"),
                ("rmatvec", ops.rmatvec,
                 lambda Vr=Vr, r=r: torch.mv(Vr.t(), results[("rmatvec", r)]["vec"]),
                 "src/repro/kernels/frsz2_dot.py:114")):
            vec = results[(op, r)]["vec"]
            nbytes = r * row_bytes + n * 8 + r * 8
            e = entry(f"frsz2_{op}", dot_src, replaces,
                      timed(lambda fn=fn, sub=sub, vec=vec: fn(sub, vec,
                                                                kernel=True)),
                      timed(lambda fn=fn, sub=sub, vec=vec: fn(sub, vec,
                                                                kernel=False)),
                      nbytes, 2.0 * r * n, results[(op, r)]["abs"],
                      library_ms=timed(lib), rows=r, shape=f"{r} x {n}",
                      library="torch.mv on the decoded f64 basis")
            if r == R_FULL:
                entries[f"frsz2_{op}"] = e
    del V, Vdec, bc
    torch.cuda.empty_cache()
    return entries


def _rel_err(yk, yp):
    """(max abs error, the same relative to max |plain|)."""
    abs_err = float((yk.double() - yp.double()).abs().max())
    return abs_err, abs_err / max(float(yp.double().abs().max()), 1e-300)


def _all_codes(l, gen):
    """Every code of l <= 16 bits; for l = 32, the edge codes (0, the sign
    alone, 1, all ones, the largest and smallest fields of either sign)
    and seeded codes, 2^16 in all.  As the codec's signed containers."""
    import torch

    from repro_torch.core import frsz2 as F

    dev = gen.device
    if l <= 16:
        c = torch.arange(1 << l, device=dev)
    else:
        edges = torch.tensor([0, 1 << 31, 1, (1 << 32) - 1, (1 << 31) - 1,
                              (1 << 31) + 1, 1 << 30, 3 << 30], device=dev)
        c = torch.cat([edges, torch.randint(0, 1 << 32, ((1 << 16) - 8,),
                                            generator=gen, device=dev)])
    if l < 64 and l > 8:
        c = c - (c >= (1 << (l - 1))).long() * (1 << l)
    return c.to(F.code_dtype(l))


def _identity_ell_checks(dev):
    """The scaled decode through the ELL kernel: an identity operator on a
    coded vector built directly from codes and exponents (every l = 16
    code, l = 8 codes, 2^16 l = 32 codes, each block under exponents
    0..l+8, a seeded spread, 2*bias and 2*bias+1) equals ``ops.decompress``
    of the same vector, as integer bits after ``+ 0.0``.  Slot 0 of row i
    holds entry i; at w = 7 (the compiled width) the other slots hold entry
    0, code 0 (+0), with value 0."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(17)
    bs = 32
    checked = 0
    for dtype, bias, ibits in ((torch.float64, 1023, torch.int64),
                               (torch.float32, 127, torch.int32)):
        for l in (16, 32, 8):
            codes = _all_codes(l, gen)
            spread = torch.randint(0, 2 * bias + 2, (16,), generator=gen,
                                   device=dev)
            emax = torch.cat([torch.arange(l + 9, device=dev), spread,
                              torch.tensor([2 * bias - 1, 2 * bias,
                                            2 * bias + 1], device=dev)])
            per = codes.numel() // bs
            spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
            bc = F.BlockCompressed(
                codes=codes.reshape(per, bs).repeat(emax.numel(), 1),
                exps=emax.to(torch.int32).repeat_interleave(per),
                n=emax.numel() * codes.numel(), spec=spec)
            n = bc.n
            want = ops.decompress(bc, kernel=True) + 0.0
            check(torch.equal(want.view(ibits),
                              (ops.decompress(bc, kernel=False) + 0.0
                               ).view(ibits)),
                  f"decompress kernel != plain on every code, l={l}")
            for w in (7, 1):
                cols = torch.zeros((n, w), dtype=torch.int32, device=dev)
                cols[:, 0] = torch.arange(n, dtype=torch.int32, device=dev)
                vals = torch.zeros((n, w), dtype=dtype, device=dev)
                vals[:, 0] = 1.0
                got = ops.ell_spmv(vals, cols, bc, kernel=True) + 0.0
                check(torch.equal(got.view(ibits), want.view(ibits)),
                      f"scaled decode through ell_spmv_frsz2 != decompress "
                      f"({F.dtype_name(dtype)}, l={l}, w={w}): "
                      f"{int((got.view(ibits) != want.view(ibits)).sum())} "
                      "entries differ")
                checked += n
            del bc, want, cols, vals, got
    print(f"[ell] scaled decode: {checked} coded entries through the ELL "
          "kernel (w 7 and 1, f64/f32, l 8/16/32, exponents 0..l+8, a "
          "spread, 2*bias, 2*bias+1) bit-equal to decompress")


def phase_ell(A):
    """The ELL SpMV kernels on the main-path operator, and spot checks."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = A.device
    E = A.to_ell()
    nr, w = E.vals.shape
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((nr,), generator=gen, dtype=torch.float64, device=dev)
    v = x / torch.linalg.vector_norm(x)                # a Krylov-like row
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    bc = ops.compress(v, spec)
    errs = {}
    for name, operand in (("ell_spmv", x), ("ell_spmv_frsz2", bc)):
        yk = ops.ell_spmv(E.vals, E.cols, operand, kernel=True)
        yp = ops.ell_spmv(E.vals, E.cols, operand, kernel=False)
        errs[name] = _rel_err(yk, yp)
        check(torch.equal(yk, yp), f"{name} != plain: relative error "
                                   f"{errs[name][1]:.3e}")
        check(torch.equal(ops.ell_spmv(E.vals, E.cols, operand, kernel=True),
                          yk), f"{name}: two calls differ")
        print(f"[ell] {name} n={nr} w={w}: bit-equal to plain, two calls "
              "bit-equal")
    _identity_ell_checks(dev)

    # spot checks: f32 values, a ragged column count, other block sizes
    g2 = torch.Generator(device=dev).manual_seed(5)
    nr2, nc2, w2 = 777, 1001, 5
    cols = torch.randint(0, nc2, (nr2, w2), generator=g2, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((nr2, w2), generator=g2, dtype=torch.float64, device=dev)
    pad = torch.rand((nr2, w2), generator=g2, device=dev) < 0.2
    cols[pad] = 0
    vals[pad] = 0.0
    xr = torch.randn((nc2,), generator=g2, dtype=torch.float64, device=dev)
    spots = 0
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        vd = vals.to(dtype)
        operands = [xr.to(dtype)] + [
            ops.compress(xr.to(dtype), F.FrszSpec(bs=bs, l=l, dtype=dtype))
            for bs, l in ((8, 32), (64, 16), (128, 8), (32, 32))]
        for op in operands:
            _, rel = _rel_err(ops.ell_spmv(vd, cols, op, kernel=True),
                              ops.ell_spmv(vd, cols, op, kernel=False))
            check(rel <= tol, f"ell spot check {dtype} relative error {rel:.3e}")
            spots += 1
    # the main path's operator in f32 values
    _, rel = _rel_err(ops.ell_spmv(E.vals.float(), E.cols, x, kernel=True),
                      ops.ell_spmv(E.vals.float(), E.cols, x, kernel=False))
    check(rel <= 1e-6, f"ell f32 main-shape relative error {rel:.3e}")
    print(f"[ell] spot checks passed: {spots + 1} (f32/f64 values, nc=1001 "
          "ragged, frsz2 bs 8/32/64/128, l 8/16/32)")

    # times; the bound counts vals, cols, the operand and y once each
    mat_bytes = E.vals.numel() * 8 + E.cols.numel() * 4
    indptr = A.indptr
    csr = torch.sparse_csr_tensor(indptr, A.indices, A.data, size=A.shape)
    src = "src/repro_torch/kernels/csrc/ell_spmv.cu"
    entries = {}
    for name, operand, x_bytes, replaces in (
            ("ell_spmv", x, nr * 8, "src/repro/kernels/ell_spmv.py:49"),
            ("ell_spmv_frsz2", bc, bc.codes.numel() * 4 + bc.exps.numel() * 4,
             "src/repro/kernels/ell_spmv.py:76")):
        lib_x = x if name == "ell_spmv" else ops.decompress(bc)
        entries[name] = entry(
            name, src, replaces,
            timed(lambda op=operand: ops.ell_spmv(E.vals, E.cols, op,
                                                  kernel=True)),
            timed(lambda op=operand: ops.ell_spmv(E.vals, E.cols, op,
                                                  kernel=False)),
            mat_bytes + x_bytes + nr * 8, 2.0 * nr * w, errs[name][0],
            library_ms=timed(lambda lx=lib_x: csr @ lx),
            shape=f"{nr} x {w}, nnz {A.nnz}",
            library="torch.sparse_csr_tensor @ x (decoded operand)")
    return entries


def phase_givens():
    """The device cycle's Givens step over a cycle of m = 100 steps: kernel
    bit-equal to its plain version; its time at the last step."""
    import torch

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    m = M
    L = ref.givens_layout(m)
    sk, sp = ref.givens_init_ref(m, dev), ref.givens_init_ref(m, dev)
    b_norm = torch.tensor(3.0, dtype=torch.float64, device=dev)
    for s in (sk, sp):
        s[L["g"]] = 1.5
    steps = []
    for j in range(m):
        h = torch.randn((j + 1,), generator=gen, dtype=torch.float64,
                        device=dev)
        hj1 = torch.rand((), generator=gen, dtype=torch.float64, device=dev)
        w_pre = hj1 + torch.rand((), generator=gen, dtype=torch.float64,
                                 device=dev)
        fired = hj1 < 0.7 * w_pre
        steps.append((h, hj1, w_pre, fired))
        ops.givens_step(sk, h, hj1, w_pre, fired, b_norm, j, m, 1e-300,
                        kernel=True)
        ops.givens_step(sp, h, hj1, w_pre, fired, b_norm, j, m, 1e-300,
                        kernel=False)
    check(torch.equal(sk, sp), "gmres_givens != plain over a 100-step cycle")
    check(float(sk[L["alive"]]) == 1.0, "Givens cycle died on random input")
    err = float((sk - sp).abs().max())
    print(f"[givens] m={m}: kernel bit-equal to plain over {m} steps")
    h, hj1, w_pre, fired = steps[-1]
    j = m - 1
    # bytes: h, the three scalars, cs/sn/g read and R's column, cs, sn, g,
    # est written; flops: 6 per earlier rotation plus the new one
    nbytes = (j + 1) * 8 + 3 * 8 + 2 * j * 8 + 2 * 8 + (j + 2) * 8 + 6 * 8
    return {"gmres_givens": entry(
        "gmres_givens", "src/repro_torch/kernels/csrc/gmres_step.cu",
        "src/repro/solver/gmres.py:159 (jnp in the device cycle; no Pallas "
        "kernel: a helper, not a TPU-kernel port)",
        timed(lambda: ops.givens_step(sk, h, hj1, w_pre, fired, b_norm, j, m,
                                      1e-300, kernel=True)),
        timed(lambda: ops.givens_step(sp, h, hj1, w_pre, fired, b_norm, j, m,
                                      1e-300, kernel=False), reps=5),
        nbytes, 6.0 * j + 10.0, err, shape=f"step j={j} of m={m}",
        helper=True)}


def _solve_row(label, A, b, x_sol, fmt, target, max_iters, driver):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres(A, b, storage=fmt, m=M, max_iters=max_iters, target_rrn=target,
                driver=driver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    err = float(torch.linalg.vector_norm(res.x - x_sol)
                / torch.linalg.vector_norm(x_sol))
    row = dict(phase=label, n=A.shape[0], format=getattr(fmt, "name", fmt),
               driver=driver, iters=res.iterations, restarts=res.restarts,
               rrn=res.rrn, converged=bool(res.converged), x_err=err,
               wall_s=wall, wall_per_iter_ms=wall * 1e3 / max(res.iterations, 1),
               bytes_read=res.bytes_read,
               bytes_read_per_s=res.bytes_read / wall, op_reads=res.op_reads,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    return res, row


def _check_launches(row, path, what):
    """Every kernel of ``path`` launched; no other FRSZ2 kernel did."""
    lc = row["launches"]
    check(all(lc[k] > 0 for k in path), f"{what} skipped a kernel: {lc}")
    check(not any(v for k, v in lc.items()
                  if k.startswith("frsz2_") and k not in path),
          f"{what} launched a kernel off its path: {lc}")


def _check_drivers_agree(dev_res, host_res, dev_row, host_row, what):
    import torch

    for key in ("iters", "restarts", "bytes_read", "op_reads"):
        check(dev_row[key] == host_row[key],
              f"{what}: device driver {key} {dev_row[key]} != host "
              f"{host_row[key]}")
    rel = float(torch.linalg.vector_norm(dev_res.x - host_res.x)
                / torch.linalg.vector_norm(host_res.x))
    check(rel <= 1e-10, f"{what}: device x vs host x relative {rel:.3e}")
    return rel


def _f16_write_check():
    """A float16 basis write on the card rounds f64 once, as numpy does;
    returns how many of the same values PyTorch's own ``.to(float16)`` on
    the card rounds otherwise.  Also times one such write of a main-path
    row (n = 1,259,712) beside the double-rounding ``copy_``."""
    import numpy as np
    import torch

    from repro_torch.core.accessor import BasisAccessor, NativeFormat

    rng = np.random.default_rng(16)
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    x = np.concatenate([rng.standard_normal(1_000_000),
                        rng.standard_normal(100_000) * 1e-5,
                        rng.standard_normal(100_000) * 6e4,
                        ties + 2.0 ** -40, ties - 2.0 ** -40,
                        [0.0, -0.0, np.inf, -np.inf, 1e300, 1e-300, 65519.99,
                         65520.0, 2.0 ** -25, 1.5 * 2.0 ** -24]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float16).view(np.int16)
    xt = torch.from_numpy(x).to("cuda")
    acc = BasisAccessor(fmt=NativeFormat(dtype=torch.float16), m=2,
                        n=x.size, device="cuda")
    store = acc.empty()
    acc.write_row(store, 1, xt)
    got = store[1].cpu().numpy().view(np.int16)
    check(np.array_equal(got, want), f"float16 basis write on the card != "
          f"numpy's astype(float16) in {int((got != want).sum())} values")
    plain = xt.to(torch.float16).cpu().numpy().view(np.int16)
    n_diff = int((plain != want).sum())
    print(f"[solve] float16 basis write on the card: bit-equal to numpy's "
          f"astype(float16) on {x.size} values; PyTorch's own .to(float16) "
          f"on the card differs from it in {n_diff}")
    n = round(N_MAIN ** (1 / 3)) ** 3
    row = BasisAccessor(fmt=NativeFormat(dtype=torch.float16), m=1, n=n,
                        device="cuda")
    rs = row.empty()
    v = torch.randn((n,), dtype=torch.float64, device="cuda")
    once = timed(lambda: row.write_row(rs, 0, v))
    twice = timed(lambda: rs[0].copy_(v))
    print(f"[solve] float16 basis write of n = {n}: {once * 1e3:.1f} us "
          f"rounding once, {twice * 1e3:.1f} us as one copy_ (rounding twice)")
    return n_diff


def phase_solve():
    import torch

    from repro_torch.core.accessor import format_by_name
    from repro_torch.sparse import make_problem, rhs_for

    _f16_write_check()
    A, target = make_problem("synth:atmosmod", 8000, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    rows = {}
    for fmt in ("frsz2_32", "float64"):
        h, rh = _solve_row("solve", A, b, x_sol, fmt, target, 20000, "host")
        d1, rd1 = _solve_row("solve-capture", A, b, x_sol, fmt, target, 20000,
                             "device")
        d2, rd2 = _solve_row("solve", A, b, x_sol, fmt, target, 20000,
                             "device")
        check(d1.converged and h.converged, f"n=8000 {fmt} did not converge")
        check(rd1["x_err"] < 1e-6, f"n=8000 {fmt} solution error "
                                   f"{rd1['x_err']:.3e}")
        rel = _check_drivers_agree(d1, h, rd1, rh, f"n=8000 {fmt}")
        check(d1.iterations == d2.iterations and torch.equal(d1.x, d2.x),
              f"n=8000 {fmt}: two device solves differ: not deterministic")
        rows[fmt] = (h, rh, d2, rd2)
        print(f"[solve] {fmt}: device {d1.iterations} it = host "
              f"{h.iterations} it, x rel diff {rel:.3e}, two device solves "
              "bit-equal")
    _check_launches(rows["frsz2_32"][1], HOST_PATH, "n=8000 host frsz2_32")
    _check_launches(rows["frsz2_32"][3], DEVICE_PATH, "n=8000 device frsz2_32")
    _check_launches(rows["float64"][3], ("ell_spmv", "gmres_givens"),
                    "n=8000 device float64")
    plain = format_by_name("frsz2_32", use_kernels=False)
    p, rp = _solve_row("solve-plain", A, b, x_sol, plain, target, 20000,
                       "host")
    k = rows["frsz2_32"][0]
    check(p.converged, "n=8000 plain-route solve did not converge")
    check(abs(k.iterations - p.iterations) <= 1,
          f"kernel route {k.iterations} vs plain {p.iterations} iterations")
    check(not any(v for kk, v in rp["launches"].items()
                  if kk.startswith("frsz2_")),
          f"plain route launched FRSZ2 kernels: {rp['launches']}")
    print(f"[solve] kernel route {k.iterations} it, plain route "
          f"{p.iterations} it")


def phase_full_width(A, target):
    """Each path's full-width frsz2_32 solve, counts read just after it:
    returns the launches per kernel from the path that runs it."""
    import torch

    from repro_torch.sparse import rhs_for

    b, x_sol = rhs_for(A, device="cuda")
    launches = {}
    for fmt in ("float64", "frsz2_32"):
        h, rh = _solve_row("full", A, b, x_sol, fmt, target, FULL_MAX_ITERS,
                           "host")
        d1, rd1 = _solve_row("full-capture", A, b, x_sol, fmt, target,
                             FULL_MAX_ITERS, "device")
        d2, rd2 = _solve_row("full", A, b, x_sol, fmt, target,
                             FULL_MAX_ITERS, "device")
        for res in (h, d1, d2):
            check(bool(torch.isfinite(res.x).all()) and res.rrn < 1.0,
                  f"{fmt} full-width solve did not reduce the residual")
        rel = _check_drivers_agree(d2, h, rd2, rh, f"full-width {fmt}")
        check(torch.equal(d1.x, d2.x), f"full-width {fmt}: two device "
                                       "solves differ")
        print(f"[full] {fmt}: device {d2.iterations} it = host "
              f"{h.iterations} it, x rel diff {rel:.3e}; walls host "
              f"{rh['wall_s']:.4f} s, device first {rd1['wall_s']:.4f} s, "
              f"second {rd2['wall_s']:.4f} s; peak memory device "
              f"{rd1['peak_mem_bytes'] / 2**30:.2f} GiB")
        if fmt == "float64":
            _check_launches(rh, ("ell_spmv",), "float64 host solve")
            _check_launches(rd2, ("ell_spmv", "gmres_givens"),
                            "float64 device solve")
        else:
            _check_launches(rh, HOST_PATH, "frsz2_32 host solve (slice 1)")
            _check_launches(rd2, DEVICE_PATH, "frsz2_32 device solve (slice 2)")
            launches = {k: rh["launches"][k] for k in HOST_PATH}
            launches.update({k: rd2["launches"][k] for k in DEVICE_PATH})
            paths = {k: "host" for k in HOST_PATH}
            paths.update({k: "device" for k in DEVICE_PATH})
    return launches, paths


def release():
    """Free the captured cycles (their stores and graph pools) and the
    allocator's cache between phases."""
    import torch

    from repro_torch.solver import clear_graph_cache

    clear_graph_cache()
    torch.cuda.empty_cache()


def _block_store(spec, p, n, rows, gen):
    """A frsz2 block basis of ``rows`` block rows of ``p`` Krylov-like
    (unit-norm) vectors of length ``n``, written as the block cycle writes
    it; returns the accessor, the store and its BlockCompressed view."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.core.accessor import BlockBasisAccessor, FrszFormat

    acc = BlockBasisAccessor(fmt=FrszFormat(spec), m=rows, p=p, n=n,
                             arith_dtype=spec.dtype, device="cuda")
    store = acc.empty()
    for i in range(rows):
        W = torch.randn((p, n), generator=gen, dtype=torch.float64,
                        device="cuda")
        W /= torch.linalg.vector_norm(W, dim=1, keepdim=True)
        acc.write_block(store, i, W.to(spec.dtype))
    bc = F.BlockCompressed(codes=store["codes"], exps=store["exps"],
                           n=acc.n_flat, spec=spec)
    return acc, store, bc


def _block_pair(bc, p, W, Y, rows):
    """Kernel and plain block dots and combine; relative errors."""
    from repro_torch.kernels import ops

    out = {}
    for op, fn, arg in (("dots", ops.block_dots, W),
                        ("combine", ops.block_combine, Y)):
        kw = dict(p=p, rows=rows) if op == "dots" else dict(p=p)
        a = arg if op == "dots" else arg[:rows]
        out[op] = _rel_err(fn(bc, a, kernel=True, **kw),
                           fn(bc, a, kernel=False, **kw))
    return out


def _one_hot_dots_check(bc, p, n, n_seg, spec):
    """Block dots against one-hot rows of W: each column of H is the
    decoded basis at that row's column (one product by 1, the rest by 0),
    at columns on chunk, stage and step edges of the kernel."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = bc.codes.device
    q = 8
    at = [0, 1, 255, 256, 4095, 4097, n_seg // 2 + 5, n - 1]
    W1 = torch.zeros((q, n), dtype=spec.dtype, device=dev)
    W1[torch.arange(q), torch.tensor(at)] = 1.0
    H = ops.block_dots(bc, W1, p=p, rows=R_FULL, kernel=True)
    M = R_FULL * p
    nbs = n_seg // spec.bs
    cv = bc.codes[:R_FULL].reshape(M, nbs, spec.bs)
    ev = bc.exps[:R_FULL].reshape(M, nbs)
    for b, c in enumerate(at):
        blk = c // spec.bs
        v = ops.decompress(F.BlockCompressed(
            codes=cv[:, blk:blk + 1].contiguous(),
            exps=ev[:, blk:blk + 1].contiguous(), n=spec.bs, spec=spec),
            kernel=False)[:, c % spec.bs]
        check(torch.equal(H[:, :, b].reshape(M), v),
              f"block dots with a one-hot row at column {c} != the decoded "
              "basis there")
    print(f"[block] dots with one-hot W rows at columns {at}: equal to the "
          "decoded basis")


def _combine_rows_equal(bc, p, Y, rows):
    """The combine kernel bit-equal to the row-order plain sum (one fma a
    segment row, rows in order: the first combine kernel's sum)."""
    import torch

    from repro_torch.kernels import ops, ref

    got = ops.block_combine(bc, Y[:rows], p=p, kernel=True)
    codes, exps, _ = ops._block_view(bc, p, rows)
    want = ref.block_combine_rows_ref(codes, exps,
                                      Y[:rows].reshape(rows * p, -1), bc.spec)
    return torch.equal(got, want)


def _combine_guard_checks(dev):
    """The combine over one segment row whose codec blocks carry exponents
    across the guard, Y = 1 (``cardcheck.combine_across_guard``): equal to
    ``decompress``."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck

    gen = torch.Generator(device=dev).manual_seed(37)
    checked = 0
    for dtype, bias in cardcheck.GUARD_DTYPES:
        for l in (32, 16, 8):
            ok, codes = cardcheck.combine_across_guard(dtype, bias, l, gen)
            check(ok, f"block combine across the guard "
                      f"({F.dtype_name(dtype)}, l={l}) != decompress")
            checked += codes
    print(f"[block] combine across the decode guards: {checked} codes (f64/f32,"
          " l 8/16/32, exponents 0..l+8, a spread, 2*bias+l-55..2*bias+l-53, "
          "2*bias-1..2*bias+1) equal to decompress")


def _combine_checks(bc, p, Y, n_seg, spec):
    """The combine at the main-path block shape: bit-equal to the row-order
    plain sum at EDGE_ROWS block rows (M = 8 ... 808) and to a second call;
    one-hot Y rows equal to the decoded basis rows, at segment rows on the
    edges of the ring turns and Y tiles."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import EDGE_ROWS, same_values

    for r in EDGE_ROWS:
        check(_combine_rows_equal(bc, p, Y, r),
              f"block combine rows={r} != the row-order plain sum")
    out = ops.block_combine(bc, Y, p=p, kernel=True)
    check(torch.equal(out, ops.block_combine(bc, Y, p=p, kernel=True)),
          "block combine: two calls differ")
    del out
    q = Y.shape[2]
    M = R_FULL * p
    at = [i for i in (0, 7, 8, 127, 128, 129, 511) if i < M - 1][:q - 1] + [M - 1]
    Y1 = torch.zeros_like(Y)
    for b, i in enumerate(at):
        Y1[i // p, i % p, b] = 1.0
    out = ops.block_combine(bc, Y1, p=p, kernel=True)
    nbs = n_seg // spec.bs
    cv = bc.codes[:R_FULL].reshape(M, nbs, spec.bs)
    ev = bc.exps[:R_FULL].reshape(M, nbs)
    for b, i in enumerate(at):
        v = ops.decompress(F.BlockCompressed(codes=cv[i], exps=ev[i], n=n_seg,
                                             spec=spec), kernel=False)
        check(same_values(out[b], v), f"block combine with a one-hot Y row "
                                      f"at segment row {i} != the decoded row")
    print(f"[block] combine bit-equal to the row-order plain sum at block rows"
          f" {list(EDGE_ROWS)} (M = {EDGE_ROWS[0] * p}..{M}) and to a second "
          f"call; one-hot Y rows at segment rows {at} equal to the decoded "
          "basis")
    _combine_guard_checks(bc.codes.device)


def phase_block_kernels(A):
    """The block kernels at the main-path block shape, and spot checks."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    n = A.shape[0]
    p = q = P_BLOCK
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    acc, store, bc = _block_store(spec, p, n, R_FULL, gen)
    n_seg = acc.n_seg
    W = torch.randn((q, n), generator=gen, dtype=torch.float64, device=dev)
    Y = torch.randn((R_FULL, p, q), generator=gen, dtype=torch.float64,
                    device=dev)
    errs = {}
    for r in (R_FULL, R_HALF):
        errs[r] = _block_pair(bc, p, W, Y, r)
        for op, (abs_err, rel) in errs[r].items():
            check(rel <= 1e-12, f"block {op} r={r} relative error "
                                f"{rel:.3e} > 1e-12")
            print(f"[block] {op} rows={r} (p={p}, n_seg={n_seg}): max abs "
                  f"err {abs_err:.3e}, relative {rel:.3e}")
    check(torch.equal(ops.block_dots(bc, W, p=p, rows=R_FULL, kernel=True),
                      ops.block_dots(bc, W, p=p, rows=R_FULL, kernel=True)),
          "block dots: two calls differ")
    _one_hot_dots_check(bc, p, n, n_seg, spec)
    _combine_checks(bc, p, Y, n_seg, spec)

    # spot checks: f32 values, p = 1 and 3, a ragged n, other bs and l
    g2 = torch.Generator(device=dev).manual_seed(8)
    spots = [(torch.float32, 32, 32, 8), (torch.float64, 32, 32, 1),
             (torch.float64, 32, 32, 3), (torch.float64, 32, 8, 4),
             (torch.float64, 32, 64, 3), (torch.float64, 16, 128, 8),
             (torch.float32, 8, 32, 16), (torch.float64, 32, 32, 13),
             (torch.float64, 32, 1, 3), (torch.float32, 16, 8, 1)]
    for dtype, l, bs, pp in spots:
        sp = F.FrszSpec(bs=bs, l=l, dtype=dtype)
        _, _, sbc = _block_store(sp, pp, 1001, 7, g2)
        Ws = torch.randn((pp, 1001), generator=g2, dtype=dtype, device=dev)
        Ys = torch.randn((7, pp, pp), generator=g2, dtype=dtype, device=dev)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for rows in (7, 3):
            for op, (_, rel) in _block_pair(sbc, pp, Ws, Ys, rows).items():
                check(rel <= tol, f"block {op} spot {sp.name} p={pp} "
                                  f"rows={rows}: relative error {rel:.3e}")
            check(_combine_rows_equal(sbc, pp, Ys, rows),
                  f"block combine spot {sp.name} p={pp} rows={rows} != the "
                  "row-order plain sum")
    print(f"[block] spot checks passed: {len(spots)} (f32/f64, p 1/3/4/8/13/"
          "16, n=1001 ragged, bs 1/8/32/64/128, l 8/16/32; the combine "
          "bit-equal to the row-order plain sum)")

    # the batched ELL SpMV: one launch for p operands, bit-equal
    E = A.to_ell()
    X = torch.randn((p, n), generator=gen, dtype=torch.float64, device=dev)
    yk = ops.ell_spmv(E.vals, E.cols, X, kernel=True)
    yp = ops.ell_spmv(E.vals, E.cols, X, kernel=False)
    check(torch.equal(yk, yp), "batched ell_spmv != plain")
    check(torch.equal(ops.ell_spmv(E.vals, E.cols, X, kernel=True), yk),
          "batched ell_spmv: two calls differ")
    print(f"[block] batched ell_spmv ({p} x {n}, w={E.vals.shape[1]}): "
          "bit-equal to plain")

    # the block Givens step over a cycle of m = 100 block steps
    m = M
    L = ref.block_givens_layout(m, p)
    sk = ref.block_givens_init_ref(m, p, dev)
    S = torch.triu(torch.rand((p, p), generator=gen, dtype=torch.float64,
                              device=dev)) + torch.eye(p, device=dev)
    sk[L["G"]:L["G"] + p * p] = S.reshape(-1)
    sp = sk.clone()
    bn = 1.0 + torch.rand((p,), generator=gen, dtype=torch.float64,
                          device=dev)
    for j in range(m):
        H = torch.randn((j + 1, p, p), generator=gen, dtype=torch.float64,
                        device=dev)
        T = torch.triu(torch.rand((p, p), generator=gen, dtype=torch.float64,
                                  device=dev)) + 0.5 * torch.eye(p, device=dev)
        fired = torch.tensor(j % 3 == 0, device=dev)
        ops.block_givens_step(sk, H, T, fired, bn, j, m, p, 1e-300,
                              kernel=True)
        ops.block_givens_step(sp, H, T, fired, bn, j, m, p, 1e-300,
                              kernel=False)
        check(torch.equal(sk, sp), f"gmres_block_givens != plain at step {j}")
    check(float(sk[L["alive"]]) == 1.0, "block Givens cycle died on random "
                                        "input")
    print(f"[block] block Givens step m={m} p={p}: kernel bit-equal to plain "
          f"over {m} steps")

    # times
    entries = {}
    src = "src/repro_torch/kernels/csrc/frsz2_block.cu"
    nb = n_seg // spec.bs
    seg_bytes = n_seg * 4 + nb * 4
    for r in (R_FULL, R_HALF):
        M_rows = r * p
        Vdec = ops.decompress(F.BlockCompressed(
            codes=bc.codes[:r].reshape(M_rows, nb, spec.bs),
            exps=bc.exps[:r].reshape(M_rows, nb), n=n_seg, spec=spec))
        Wp = torch.nn.functional.pad(W, (0, n_seg - n))
        Y2 = Y[:r].reshape(M_rows, q)
        flops = 2.0 * M_rows * n_seg * q
        for op, call, lib, replaces, io_bytes in (
                ("dots", lambda k, r=r: ops.block_dots(bc, W, p=p, rows=r,
                                                       kernel=k),
                 lambda V=Vdec, Wp=Wp: V @ Wp.T,
                 "src/repro/kernels/frsz2_block.py:64",
                 q * n_seg * 8 + M_rows * q * 8),
                ("combine", lambda k, r=r: ops.block_combine(bc, Y[:r], p=p,
                                                             kernel=k),
                 lambda V=Vdec, Y2=Y2: Y2.T @ V,
                 "src/repro/kernels/frsz2_block.py:104",
                 M_rows * q * 8 + q * n_seg * 8)):
            e = entry(f"frsz2_block_{op}", src, replaces,
                      timed(functools.partial(call, True)),
                      timed(functools.partial(call, False), reps=3),
                      M_rows * seg_bytes + io_bytes, flops, errs[r][op][0],
                      library_ms=timed(lib), rows=r, p=p, q=q,
                      shape=f"{r} x {p} x {n_seg}",
                      library="torch.mm on the decoded f64 basis",
                      path="block")
            if r == R_FULL:
                entries[f"frsz2_block_{op}"] = e
        del Vdec
    mat_bytes = E.vals.numel() * 8 + E.cols.numel() * 4
    csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    XT = X.T.contiguous()
    entries["ell_spmv_batched"] = entry(
        "ell_spmv_batched", "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "src/repro/kernels/ell_spmv.py:49 (jax.vmap over ell_spmv_2d, "
        "src/repro/solver/block.py:219)",
        timed(lambda: ops.ell_spmv(E.vals, E.cols, X, kernel=True)),
        timed(lambda: ops.ell_spmv(E.vals, E.cols, X, kernel=False)),
        mat_bytes + 2 * p * n * 8, 2.0 * p * E.vals.numel(), 0.0,
        library_ms=timed(lambda: csr @ XT), kernel="ell_spmv",
        shape=f"{p} x {n} x {E.vals.shape[1]}", path="block",
        library="torch.sparse_csr_tensor @ X (n, 8)")
    j = m - 1
    H = torch.randn((j + 1, p, p), generator=gen, dtype=torch.float64,
                    device=dev)
    T = torch.triu(torch.rand((p, p), generator=gen, dtype=torch.float64,
                              device=dev)) + 0.5 * torch.eye(p, device=dev)
    fired = torch.tensor(False, device=dev)
    jp = j * p
    # bytes: H, T, bn, cs/sn of the jp earlier columns read; R's column
    # block, G's 2p rows, cs/sn's p rows and est written.  Flops: 6 per
    # element rotation, p columns, jp*p earlier and p*p new rotations
    nbytes = ((j + 1) * p * p + p * p + p + 2 * jp * p
              + (m + 1) * p * p + 2 * 2 * p * p + 2 * p * p + p) * 8
    flops = 6.0 * p * (jp * p + p * p)
    entries["gmres_block_givens"] = entry(
        "gmres_block_givens", "src/repro_torch/kernels/csrc/gmres_step.cu",
        "src/repro/solver/block.py:140 (jnp _block_apply_prior and "
        "_block_triangularize in the block cycle; no Pallas kernel: a "
        "helper, not a TPU-kernel port)",
        timed(lambda: ops.block_givens_step(sk, H, T, fired, bn, j, m, p,
                                            1e-300, kernel=True)),
        timed(lambda: ops.block_givens_step(sp, H, T, fired, bn, j, m, p,
                                            1e-300, kernel=False), reps=3),
        nbytes, flops, 0.0, shape=f"block step j={j} of m={m}, p={p}",
        helper=True, path="block")
    del store, bc
    return entries


def _block_row(label, A, B, x_sol, fmt, target, max_iters, method, driver):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres_batched

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres_batched(A, B, storage=fmt, m=M, max_iters=max_iters,
                        target_rrn=target, method=method, driver=driver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    X = torch.stack([r.x for r in res])
    err = float(torch.linalg.vector_norm(res[0].x - x_sol)
                / torch.linalg.vector_norm(x_sol))
    p = B.shape[0]
    row = dict(phase=label, n=A.shape[0], p=p, method=method,
               format=getattr(fmt, "name", fmt), driver=driver,
               iters=[r.iterations for r in res],
               restarts=[r.restarts for r in res],
               converged=all(r.converged for r in res),
               rrn_max=max(r.rrn for r in res), x_err_rhs0=err,
               wall_s=wall, wall_per_solve_s=wall / p,
               bytes_read_per_rhs=sum(r.bytes_read for r in res) / p,
               op_reads_per_rhs=sum(r.op_reads for r in res) / p,
               bytes_read=[r.bytes_read for r in res],
               op_reads=[r.op_reads for r in res],
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    return res, X, row


def _check_block_drivers(dev_X, host_X, dev_row, host_row, what):
    import torch

    for key in ("iters", "restarts", "bytes_read", "op_reads"):
        check(dev_row[key] == host_row[key],
              f"{what}: block device driver {key} {dev_row[key]} != host "
              f"{host_row[key]}")
    check(torch.equal(dev_X, host_X), f"{what}: block device X != host X")


def phase_block_solve():
    """Block solves at n = 8000: device vs host driver, kernel vs plain
    route, and the vmap baseline."""
    from repro_torch.core.accessor import format_by_name
    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.sparse import make_problem, rhs_for

    A, target = make_problem("synth:atmosmod", 8000, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    host_rows = {}
    for fmt in ("frsz2_32", "float64"):
        _, Xh, rh = _block_row("block-solve", A, B, x_sol, fmt, target,
                               20000, "block", "host")
        host_rows[fmt] = rh
        _, Xd1, rd1 = _block_row("block-solve-capture", A, B, x_sol, fmt,
                                 target, 20000, "block", "device")
        _, Xd2, rd2 = _block_row("block-solve", A, B, x_sol, fmt, target,
                                 20000, "block", "device")
        _, _, rv = _block_row("vmap-solve", A, B, x_sol, fmt, target, 20000,
                              "vmap", "device")
        for r in (rh, rd1, rd2, rv):
            check(r["converged"], f"n=8000 {fmt} {r['method']} "
                                  f"{r['driver']} did not converge")
        _check_block_drivers(Xd1, Xh, rd1, rh, f"n=8000 {fmt}")
        _check_block_drivers(Xd2, Xh, rd2, rh, f"n=8000 {fmt} replay")
        if fmt == "frsz2_32":
            _check_launches(rd2, BLOCK_PATH, "n=8000 block frsz2_32")
        print(f"[block-solve] {fmt}: block device = host, iterations "
              f"{rd2['iters']}, restarts {rd2['restarts'][0]}; vmap "
              f"{rv['iters']}; bytes per RHS block/vmap "
              f"{rd2['bytes_read_per_rhs'] / rv['bytes_read_per_rhs']:.3f}")
    plain = format_by_name("frsz2_32", use_kernels=False)
    _, _, rp = _block_row("block-solve-plain", A, B, x_sol, plain, target,
                          20000, "block", "host")
    check(rp["converged"], "n=8000 plain-route block solve did not converge")
    rk = host_rows["frsz2_32"]
    check(all(abs(a - b) <= 1 for a, b in zip(rp["iters"], rk["iters"])),
          f"block kernel route {rk['iters']} vs plain {rp['iters']}")
    check(not any(v for k, v in rp["launches"].items()
                  if k.startswith("frsz2_")),
          f"plain route launched FRSZ2 kernels: {rp['launches']}")
    print(f"[block-solve] kernel route {rk['iters']}, plain route "
          f"{rp['iters']}")


def phase_block_full_width(A, target):
    """Slice 3's path at full width: returns its launches per kernel, read
    from the frsz2_32 block device-driver solve (the replay)."""
    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.sparse import rhs_for

    b, x_sol = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    launches = {}
    for fmt in ("float64", "frsz2_32"):
        _, Xd1, rd1 = _block_row("block-full-capture", A, B, x_sol, fmt,
                                 target, FULL_MAX_ITERS, "block", "device")
        _, Xd2, rd2 = _block_row("block-full", A, B, x_sol, fmt, target,
                                 FULL_MAX_ITERS, "block", "device")
        _, Xh, rh = _block_row("block-full", A, B, x_sol, fmt, target,
                               FULL_MAX_ITERS, "block", "host")
        release()
        _, _, rv = _block_row("vmap-full", A, B, x_sol, fmt, target,
                              FULL_MAX_ITERS, "vmap", "device")
        release()
        for r in (rd1, rd2, rh, rv):
            check(r["converged"], f"full-width {fmt} {r['method']} "
                                  f"{r['driver']}: a column did not converge")
        _check_block_drivers(Xd1, Xh, rd1, rh, f"full-width {fmt}")
        _check_block_drivers(Xd2, Xh, rd2, rh, f"full-width {fmt} replay")
        ratio = rd2["bytes_read_per_rhs"] / rv["bytes_read_per_rhs"]
        print(f"[block-full] {fmt}: block iterations {rd2['iters']} "
              f"restarts {rd2['restarts'][0]}, vmap {rv['iters']}; walls "
              f"block device first {rd1['wall_s']:.4f} s, replay "
              f"{rd2['wall_s']:.4f} s, host {rh['wall_s']:.4f} s, vmap "
              f"{rv['wall_s']:.4f} s; peak memory block "
              f"{rd1['peak_mem_bytes'] / 2**30:.2f} GiB, vmap "
              f"{rv['peak_mem_bytes'] / 2**30:.2f} GiB; modelled basis "
              f"bytes per RHS block/vmap {ratio:.3f}")
        if fmt == "float64":
            _check_launches(rd2, ("ell_spmv", "gmres_block_givens"),
                            "float64 block solve")
        else:
            _check_launches(rd2, BLOCK_PATH, "frsz2_32 block solve (slice 3)")
            launches = {k: rd2["launches"][k] for k in BLOCK_PATH}
    return launches


def _attn_inputs(gen, B, Hkv, G, S, D, l, exp_dtype, qdt=None):
    """Seeded q and K/V coded on the card by the compress kernel."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    spec = F.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest",
                      exp_dtype=exp_dtype)
    bcs = []
    for _ in range(2):
        x = torch.randn((B, Hkv, S, D), generator=gen, device=dev)
        bc = ops.compress(x, spec)
        bcs.append(F.BlockCompressed(codes=bc.codes, exps=bc.exps, n=D,
                                     spec=spec))
        del x
    q = torch.randn((B, Hkv * G, D), generator=gen, device=dev)
    return q if qdt is None else q.to(qdt), bcs[0], bcs[1]


def _attn_pair(q, kbc, vbc, lengths, **kw):
    """Kernel and plain decode attention; returns (kernel out, max abs err,
    max abs err over the largest |plain output|)."""
    from repro_torch.kernels import ops

    ok = ops.decode_attention(q, kbc, vbc, lengths, kernel=True, **kw)
    op = ops.decode_attention(q, kbc, vbc, lengths, kernel=False, **kw)
    check(ok.dtype == op.dtype == q.dtype and ok.shape == op.shape,
          "decode attention kernel and plain disagree on type or shape")
    err = float((ok.float() - op.float()).abs().max())
    return ok, err, err / float(op.float().abs().max())


def phase_decode_attn():
    """Slice 4's kernel at the decode_32k length with yi-9b's heads."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    B, Hkv, G, D, S = ATTN_B, ATTN_HKV, ATTN_G, ATTN_D, ATTN_S
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[-1] = S
    valid = int(lengths.sum())
    print(f"[attn] B={B} Hkv={Hkv} G={G} D={D} S={S}; lengths "
          f"{lengths.tolist()}")
    entries = {}
    src = "src/repro_torch/kernels/csrc/decode_attn.cu"
    for l in (16, 8):
        q, kbc, vbc = _attn_inputs(gen, B, Hkv, G, S, D, l, torch.uint8)
        ok, err, rel = _attn_pair(q, kbc, vbc, lengths)
        print(f"[attn] l={l}: kernel vs plain max abs error {err:.3e}, "
              f"{rel:.3e} of the largest output (tolerance {ATTN_TOL})")
        check(rel <= ATTN_TOL, f"decode_attn l={l}: max abs error {err:.3e}"
                               f" is {rel:.3e} of the largest output")
        # the PyTorch call computing the same function: SDPA over the
        # decoded K/V, the G query heads of a kv head as its G queries
        kd = ops.decompress(kbc, kernel=True).view(B, Hkv, S, D)
        vd = ops.decompress(vbc, kernel=True).view(B, Hkv, S, D)
        q4 = q.view(B, Hkv, G, D)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]
                )[:, None, None, :]
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, q4, kd, vd,
            attn_mask=mask)
        lib_err = float((sdpa().reshape(B, Hkv * G, D) - ok).abs().max())
        check(lib_err <= ATTN_TOL * float(ok.abs().max()),
              f"SDPA on the decoded cache differs by {lib_err:.3e}")
        code_bytes = F.code_dtype(l).itemsize
        nbytes = (2 * valid * Hkv * (D * code_bytes + 1)
                  + 2 * B * Hkv * G * D * 4)
        flops = 4.0 * valid * Hkv * G * D
        e = entry("decode_attn", src, "src/repro/kernels/decode_attn.py:85",
                  timed(lambda: ops.decode_attention(q, kbc, vbc, lengths,
                                                     kernel=True)),
                  timed(lambda: ops.decode_attention(q, kbc, vbc, lengths,
                                                     kernel=False), reps=3),
                  nbytes, flops, err, library_ms=timed(sdpa),
                  peak=FP32_FLOPS, l=l, rel_err=rel,
                  shape=f"B={B} Hkv={Hkv} G={G} D={D} S={S}, "
                        f"{valid} valid positions",
                  library="scaled_dot_product_attention on the decoded "
                          "f32 K/V with a length mask",
                  library_err=lib_err, path="serve")
        if l == 16:
            entries["decode_attn"] = e
        del q, kbc, vbc, kd, vd, ok, sdpa
        torch.cuda.empty_cache()

    # the serve shape (phase 9's cache: 2120 positions, lengths 2048-2112)
    S2 = SERVE_PROMPT + 2 * SERVE_NEW + 8
    lens2 = torch.randint(SERVE_PROMPT, SERVE_PROMPT + 2 * SERVE_NEW + 1, (B,),
                          generator=gen, device=dev, dtype=torch.int32)
    q, kbc, vbc = _attn_inputs(gen, B, Hkv, G, S2, D, 16, torch.uint8)
    _, err2, rel2 = _attn_pair(q, kbc, vbc, lens2)
    check(rel2 <= ATTN_TOL, f"decode_attn at the serve shape: {rel2:.3e} of "
                            "the largest output")
    kd = ops.decompress(kbc, kernel=True).view(B, Hkv, S2, D)
    vd = ops.decompress(vbc, kernel=True).view(B, Hkv, S2, D)
    mask2 = (torch.arange(S2, device=dev)[None, :] < lens2[:, None]
             )[:, None, None, :]
    valid2 = int(lens2.sum())
    serve = dict(
        serve_shape=f"B={B} Hkv={Hkv} G={G} D={D} S={S2}, lengths "
                    f"{int(lens2.min())}-{int(lens2.max())}, {valid2} valid "
                    "positions, l=16",
        serve_ms=timed(lambda: ops.decode_attention(q, kbc, vbc, lens2,
                                                    kernel=True)),
        serve_bound_ms=bound_ms(2 * valid2 * Hkv * (D * 2 + 1)
                                + 2 * B * Hkv * G * D * 4,
                                4.0 * valid2 * Hkv * G * D, FP32_FLOPS)[0],
        serve_library_ms=timed(functools.partial(
            torch.nn.functional.scaled_dot_product_attention,
            q.view(B, Hkv, G, D), kd, vd, attn_mask=mask2)),
        serve_rel_err=rel2)
    entries["decode_attn"].update(serve)
    print(f"[attn] serve shape {serve['serve_shape']}: kernel "
          f"{serve['serve_ms'] * 1e3:.1f} us, bound "
          f"{serve['serve_bound_ms'] * 1e3:.2f} us, SDPA on the decoded K/V "
          f"{serve['serve_library_ms'] * 1e3:.1f} us; kernel vs plain "
          f"{rel2:.3e} of the largest output")
    del q, kbc, vbc, kd, vd
    torch.cuda.empty_cache()

    # spot checks: head width, group sizes, ragged S, bf16 q, int32
    # exponents, a length-1 row
    g2 = torch.Generator(device=dev).manual_seed(77)
    spots = [(64, 16, 2, torch.uint8, torch.float32),
             (64, 8, 1, torch.int32, torch.float32),
             (128, 16, 4, torch.uint8, torch.bfloat16),
             (128, 8, 3, torch.uint8, torch.float32),
             (128, 16, 12, torch.int32, torch.float32),
             (64, 16, 8, torch.uint8, torch.bfloat16)]
    lens = torch.tensor([1, 517, 1000], dtype=torch.int32, device=dev)
    for D_, l, G_, edt, qdt in spots:
        q, kbc, vbc = _attn_inputs(g2, 3, 2, G_, 1000, D_, l, edt, qdt)
        _, err, rel = _attn_pair(q, kbc, vbc, lens)
        ok = rel <= ATTN_TOL if qdt == torch.float32 else err <= ATTN_TOL_BF16
        check(ok, f"decode_attn spot D={D_} l={l} G={G_} {edt} {qdt}: max "
                  f"abs error {err:.3e}, {rel:.3e} of the largest output")
    print(f"[attn] spot checks passed: {len(spots)} (D 64/128, G 1/2/3/4/8/"
          "12, S=1000, bf16 q, int32 exponents, a length-1 row)")
    return entries


def _serve_config(kv_format):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(SERVE_ARCH), kv_format=kv_format)


def _teacher_forcing(params, kv_format):
    """Relative errors of prefill's and one decode step's logits against
    the parallel forward over S+1 tokens."""
    import torch

    from repro_torch.models import decode_step, prefill, trunk
    from repro_torch.models.layers import rms_norm

    cfg = _serve_config(kv_format)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TF_B, TF_S + 1), generator=gen,
                           device="cuda")
    h, _ = trunk(params, cfg, tokens)

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).float()

    want, want2 = head(h[:, TF_S - 1]), head(h[:, TF_S])
    del h
    got, cache = prefill(params, cfg, tokens[:, :TF_S], cache_len=TF_S + 4)
    got2, _ = decode_step(params, cfg, cache, tokens[:, TF_S])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(got, want), rel(got2, want2)


class _ServeTap:
    """For one serve run, keeps the inputs of the last decode attention and
    the K/V of the last two cache writes of each kind (prefill, decode):
    the last layer's K and V.  ``kvcache.encode_heads`` and
    ``ops.decode_attention`` are wrapped for the run and run unchanged."""

    def __init__(self, prompt: int):
        from repro_torch.kernels import ops
        from repro_torch.models import kvcache

        self.prompt = prompt
        self.prefill, self.decode, self.attn = [], [], None
        self._slots = ((kvcache, "encode_heads"), (ops, "decode_attention"))
        self._orig = [getattr(m, n) for m, n in self._slots]

    def __enter__(self):
        encode, attend = self._orig

        def encode_heads(x, fmt, head_dim):
            keep = self.prefill if x.shape[-2] == self.prompt else self.decode
            keep.append(x)
            del keep[:-2]
            return encode(x, fmt, head_dim)

        def decode_attention(q, k_bc, v_bc, lengths, **kw):
            self.attn = (q, k_bc, v_bc, lengths, kw)
            return attend(q, k_bc, v_bc, lengths, **kw)

        for (m, n), f in zip(self._slots, (encode_heads, decode_attention)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._slots, self._orig):
            setattr(m, n, f)


def _check_served_cache(tap, fmt_name):
    """The last layer's coded K/V and its last decode attention, as served,
    against the plain versions; returns the errors."""
    import torch

    from repro_torch.kernels import ops

    check(tap.attn is not None and len(tap.prefill) == len(tap.decode) == 2,
          f"{fmt_name}: the serve run wrote or read no FRSZ2 cache")
    q, kbc, vbc, lengths, kw = tap.attn
    B, Hkv, S = kbc.exps.shape[:3]
    pos = lengths.reshape(B).long() - 1          # the last decode write
    bi = torch.arange(B, device=pos.device)
    rows = 0
    for bc, xp, xd in zip((kbc, vbc), tap.prefill, tap.decode):
        # prefill: positions [0, prompt); decode: position lengths - 1
        for x, codes, exps in (
                (xp, bc.codes[:, :, :SERVE_PROMPT], bc.exps[:, :, :SERVE_PROMPT]),
                (xd[:, :, 0], bc.codes[bi, :, pos], bc.exps[bi, :, pos])):
            want = ops.compress(x.float(), bc.spec, kernel=False)
            check(torch.equal(codes.reshape(want.codes.shape), want.codes)
                  and torch.equal(exps.reshape(want.exps.shape),
                                  want.exps.to(exps.dtype)),
                  f"{fmt_name}: served cache codes differ from the plain "
                  f"compress of the same K/V ({tuple(x.shape)})")
            rows += x.numel() // x.shape[-1]
    _, err16, rel16 = _attn_pair(q, kbc, vbc, lengths, **kw)
    check(rel16 <= ATTN_TOL_BF16,
          f"{fmt_name}: decode_attn on the served cache, {q.dtype} q: max abs "
          f"error {err16:.3e}, {rel16:.3e} of the largest output")
    _, err32, rel32 = _attn_pair(q.float(), kbc, vbc, lengths, **kw)
    check(rel32 <= ATTN_TOL,
          f"{fmt_name}: decode_attn on the served cache, f32 q: max abs "
          f"error {err32:.3e}, {rel32:.3e} of the largest output")
    lens = lengths.reshape(B).tolist()
    print(f"[serve] {fmt_name} served cache: {rows} coded rows of the last "
          f"layer bit-equal to the plain compress; decode_attn vs plain at "
          f"B={B} Hkv={Hkv} G={q.shape[1] // Hkv} S={S} lengths "
          f"{min(lens)}..{max(lens)}: {q.dtype} q {err16:.3e} ({rel16:.3e} "
          f"of the largest output), f32 q {err32:.3e} ({rel32:.3e})")
    return dict(served_attn_err=err16, served_attn_rel_err=rel16,
                served_attn_err_f32q=err32, served_attn_rel_err_f32q=rel32,
                served_rows_bit_equal=rows)


def phase_serve(device_line):
    """Slice 4's path: yi-9b served at full width and depth."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeConfig, decode_steps, serve
    from repro_torch.models import init_params, kvcache

    cfg = _serve_config("frsz2_16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in
                  _leaves(params))
    print(f"[serve] {SERVE_ARCH}: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd={cfg.hd}, "
          f"{cfg.dtype}; {w_bytes / 1e9:.3f} GB of weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    for fmt in ("bf16", "frsz2_16"):
        e1, e2 = _teacher_forcing(params, fmt)
        print(f"[serve] teacher forcing {fmt}: prefill {e1:.3e}, decode "
              f"{e2:.3e} (relative to the largest logit, tolerance {TF_TOL})")
        check(e1 <= TF_TOL and e2 <= TF_TOL,
              f"teacher forcing {fmt}: {e1:.3e}, {e2:.3e} > {TF_TOL}")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]
    sc = ServeConfig(slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                     max_new=SERVE_NEW)
    steps = decode_steps(len(reqs), sc)
    sc.max_ctx = SERVE_PROMPT + steps + 8
    # the byte bound of a decode step: every weight but the embedding
    # table, and the cache positions it reads (mean over the run's steps)
    step_w = w_bytes - params["embed"].numel() * params["embed"].element_size()
    mean_len = SERVE_PROMPT + (steps + 1) / 2
    rows, launches = [], {}
    for fmt_name in SERVE_FORMATS:
        cfg_f = _serve_config(fmt_name)
        fmt = kvcache.cache_format(fmt_name)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        with _ServeTap(SERVE_PROMPT) as tap:
            ops.reset_launches()
            t = time.perf_counter()
            out = serve(cfg_f, sc, reqs, params=params, device="cuda",
                        verbose=False, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(ops.LAUNCHES)
        check(sorted(out) == list(range(len(reqs))), "serve lost a request")
        check(all(len(v) == SERVE_NEW and all(0 <= x < cfg.vocab_size
                                              for x in v)
                  for v in out.values()),
              f"{fmt_name}: a completion is not {SERVE_NEW} tokens in range")
        check(stats["nonfinite_logits"] == 0,
              f"{fmt_name}: {stats['nonfinite_logits']} logits not finite")
        check(len(stats["step_s"]) == steps and len(stats["prefill_s"]) == 1,
              f"{fmt_name}: {len(stats['step_s'])} decode steps, "
              f"{len(stats['prefill_s'])} prefills")
        frsz = fmt.kind == "frsz2"
        want = {"decode_attn": cfg.num_layers * steps if frsz else 0,
                "frsz2_compress": 2 * cfg.num_layers * (1 + steps)
                if frsz else 0}
        for k, n in want.items():
            check(got[k] == n, f"{fmt_name}: {k} launched {got[k]} times, "
                               f"the path implies {n}")
        others = {k: v for k, v in got.items() if v and k not in want}
        check(not others, f"{fmt_name}: other kernels launched: {others}")
        served = _check_served_cache(tap, fmt_name) if frsz else {}
        del tap
        per_pos = (cfg.hd * fmt.bits_per_value(cfg.hd) / 8) * 2
        cache_read = (cfg.num_layers * SERVE_SLOTS * cfg.num_kv_heads
                      * mean_len * per_pos)
        step_bound = (step_w + cache_read) / HBM_BYTES_PER_S * 1e3
        step_ms = statistics.median(stats["step_s"]) * 1e3
        row = dict(phase="serve", kv_format=fmt_name, arch=SERVE_ARCH,
                   requests=len(reqs), slots=SERVE_SLOTS,
                   prompt=SERVE_PROMPT, max_new=SERVE_NEW,
                   max_ctx=sc.max_ctx, decode_steps=steps,
                   prefill_s=stats["prefill_s"],
                   step_ms_median=step_ms,
                   step_ms_min=min(stats["step_s"]) * 1e3,
                   decode_tokens_per_s=SERVE_SLOTS * steps
                   / sum(stats["step_s"]),
                   step_bound_ms=step_bound,
                   step_weight_bytes=step_w, step_cache_bytes=cache_read,
                   wall_s=wall,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   cache_nbytes=kvcache.cache_nbytes(
                       fmt, cfg.num_layers, SERVE_SLOTS, cfg.num_kv_heads,
                       sc.max_ctx, cfg.hd),
                   launches={k: v for k, v in got.items() if v},
                   sample=out[0][:8], device=device_line, **served)
        emit(row)
        rows.append(row)
        if fmt_name == "frsz2_16":
            launches = got
    for r in rows:
        print(f"[serve] {r['kv_format']}: prefill {r['prefill_s'][0]:.3f} s, "
              f"decode step median {r['step_ms_median']:.2f} ms (bound "
              f"{r['step_bound_ms']:.2f} ms), {r['decode_tokens_per_s']:.1f} "
              f"tokens/s, peak {r['peak_mem_bytes'] / 2**30:.2f} GiB, cache "
              f"{r['cache_nbytes'] / 1e9:.3f} GB")
    return launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.sparse import make_problem

    t_start = time.perf_counter()
    phase_build()
    device_line = phase_device()
    t0 = time.perf_counter()
    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    torch.cuda.synchronize()
    print(f"[setup] n={A.shape[0]} nnz={A.nnz} in "
          f"{time.perf_counter() - t0:.1f} s")
    entries = phase_kernels()
    entries.update(phase_ell(A))
    entries.update(phase_givens())
    phase_solve()
    launches, paths = phase_full_width(A, target)
    release()
    entries.update(phase_block_kernels(A))
    release()
    phase_block_solve()
    release()
    block_launches = phase_block_full_width(A, target)
    del A
    release()
    entries.update(phase_decode_attn())
    release()
    serve_launches = phase_serve(device_line)
    for name, e in entries.items():
        key = e.get("kernel", name)
        if e.get("path") == "block":
            e["launches"] = block_launches[key]
        elif e.get("path") == "serve":
            e["launches"] = serve_launches[key]
        else:
            e["launches"] = launches[key]
            e["path"] = paths[key]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    emit({"kernels": list(entries.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
