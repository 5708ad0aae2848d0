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
   checks of f32/f16/bf16 values, l = 8/16, bs = 1/8/64/128 and a ragged n,
   and CUDA-event times (median of 30) beside the byte bound, the plain
   version and, for the contractions, ``torch.mv`` on the decoded basis;
4. solve to convergence — ``synth:atmosmod`` n = 8000, m = 100, frsz2_32,
   MGS: kernel route (twice: identical iterations and bit-equal x) against
   the plain route on the card, plus a float64 row;
5. full-width solve — ``synth:atmosmod --n 1270432``, m = 100, float64 and
   frsz2_32 with a bounded iteration budget, through ``gmres`` as a user
   calls it; launch counts are set to 0 just before and read just after:
   every kernel ran in the frsz2_32 solve, none in the float64 one.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

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

N_MAIN = 1270432           # --n of the paper-sized atmosmod problem
M = 100                    # restart length
R_FULL, R_HALF = 101, 51   # live basis rows: m + 1, and half of it
REPS = 30
FULL_MAX_ITERS = 500


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


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    def entry(name, source, replaces, ms, plain_ms, nbytes, flops, err,
              library_ms=None, **extra):
        b, by = bound_ms(nbytes, flops)
        e = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=library_ms,
                 status="matches plain", **extra)
        emit(e)
        return e

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


def _solve_row(label, A, b, x_sol, fmt, target, max_iters):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres(A, b, storage=fmt, m=M, max_iters=max_iters, target_rrn=target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    err = float(torch.linalg.vector_norm(res.x - x_sol)
                / torch.linalg.vector_norm(x_sol))
    row = dict(phase=label, n=A.shape[0], format=getattr(fmt, "name", fmt),
               iters=res.iterations, restarts=res.restarts, rrn=res.rrn,
               converged=bool(res.converged), x_err=err, wall_s=wall,
               bytes_read=res.bytes_read,
               bytes_read_per_s=res.bytes_read / wall, op_reads=res.op_reads,
               launches=launches)
    emit(row)
    return res, row


def phase_solve():
    import torch

    from repro_torch.core.accessor import format_by_name
    from repro_torch.sparse import make_problem, rhs_for

    A, target = make_problem("synth:atmosmod", 8000, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    k1, rk1 = _solve_row("solve", A, b, x_sol, "frsz2_32", target, 20000)
    k2, _ = _solve_row("solve", A, b, x_sol, "frsz2_32", target, 20000)
    plain = format_by_name("frsz2_32", use_kernels=False)
    p, rp = _solve_row("solve-plain", A, b, x_sol, plain, target, 20000)
    _solve_row("solve", A, b, x_sol, "float64", target, 20000)
    check(k1.converged and p.converged, "n=8000 frsz2_32 solve did not converge")
    check(k1.x.shape == x_sol.shape and rk1["x_err"] < 1e-6,
          f"n=8000 frsz2_32 solution error {rk1['x_err']:.3e}")
    check(abs(k1.iterations - p.iterations) <= 1,
          f"kernel route {k1.iterations} vs plain {p.iterations} iterations")
    check(k1.iterations == k2.iterations and torch.equal(k1.x, k2.x),
          "two kernel-route solves differ: not deterministic")
    check(all(v > 0 for v in rk1["launches"].values()),
          f"kernel route skipped a kernel: {rk1['launches']}")
    check(not any(rp["launches"].values()),
          f"plain route launched kernels: {rp['launches']}")
    print(f"[solve] kernel {k1.iterations} it, plain {p.iterations} it, "
          "two kernel runs bit-equal")


def phase_full_width():
    import torch

    from repro_torch.sparse import make_problem, rhs_for

    t0 = time.perf_counter()
    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    torch.cuda.synchronize()
    print(f"[full] n={A.shape[0]} nnz={A.nnz} set up in "
          f"{time.perf_counter() - t0:.1f} s")
    rows = {}
    for fmt in ("float64", "frsz2_32"):
        res, rows[fmt] = _solve_row("full", A, b, x_sol, fmt, target,
                                    FULL_MAX_ITERS)
        check(bool(torch.isfinite(res.x).all()) and res.rrn < 1.0,
              f"{fmt} full-width solve did not reduce the residual")
    check(all(v > 0 for v in rows["frsz2_32"]["launches"].values()),
          f"frsz2_32 main path skipped a kernel: {rows['frsz2_32']['launches']}")
    check(not any(rows["float64"]["launches"].values()),
          f"float64 solve launched FRSZ2 kernels: {rows['float64']['launches']}")
    return rows["frsz2_32"]["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    phase_device()
    entries = phase_kernels()
    phase_solve()
    launches = phase_full_width()
    for name, e in entries.items():
        e["launches"] = launches[name]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    emit({"kernels": list(entries.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
