"""Kernels 3 and 4 (the fused FRSZ2 matvec and rmatvec) of two source
trees, timed in turns on one card.

    python -m repro_torch.kernels.dottime --against DIR [--reps 30]

Builds ``frsz2_dot.cu`` from this package's ``csrc/`` and from ``DIR``
(another checkout's ``src/repro_torch/kernels/csrc``) with the flags of
:mod:`repro_torch.kernels.build`, binds both through ctypes and, at the
main-path shape (101 rows of n = 1,259,712, f64 values, bs 32, l = 32 and
16: the bases of the frsz2_32 and frsz2_16 solves), times each tree's
matvec and rmatvec in turns, against, this, this, against (the median of
``reps`` CUDA events each), beside the byte bound (codes and exponents read
once, the dense vector read or written once, at 3.35 TB/s).  It prints one
JSON line a (kernel, l), with whether the two trees give the same bits and
whether this tree's rmatvec gives its row-order plain sum's
(``ref.rmatvec_rows_ref``), then the card's name and power limit.  A tree
whose rmatvec takes no ``vec`` argument (before its redesign) is called
without one.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import tempfile

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import build, ops, ref, sass
from repro_torch.kernels.cardcheck import bits
from repro_torch.kernels.frsz2_kernel import KIND, bs_log2

#: the main-path shape: atmosmodd's rows and a full basis of m + 1 rows
N, ROWS = 108 ** 3, 101
HBM_BYTES_PER_S = 3.35e12
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class Tree:
    """``frsz2_dot.cu`` of one source tree, built into ``out`` and bound."""

    def __init__(self, csrc: pathlib.Path, out: pathlib.Path):
        out.mkdir(parents=True)
        (path,) = sass.compile_sources(csrc, out, ("frsz2_dot.cu",))
        self.lib = ctypes.CDLL(str(path))
        self.vec = hasattr(self.lib, "frsz2_rmatvec_word_bytes")
        self.lib.frsz2_matvec.argtypes = [_P] * 5 + [_LL] * 3 + [_I] * 3 + [_P]
        self.lib.frsz2_rmatvec.argtypes = ([_P] * 4 + [_LL] * 3
                                           + [_I] * (4 if self.vec else 3) + [_P])
        self.lib.frsz2_matvec.restype = self.lib.frsz2_rmatvec.restype = _I
        self.chunk = self.lib.frsz2_matvec_chunk()

    def matvec(self, bc, x, partial, y):
        spec, codes = bc.spec, bc.codes.view(ROWS, -1)
        build.check(self.lib.frsz2_matvec(
            codes.data_ptr(), bc.exps.data_ptr(), x.data_ptr(),
            partial.data_ptr(), y.data_ptr(), ROWS, N, codes.shape[1],
            bs_log2(spec), KIND[spec.dtype], spec.l, build.stream()),
            "frsz2_matvec")

    def rmatvec(self, bc, h, y):
        spec, codes = bc.spec, bc.codes.view(ROWS, -1)
        args = [codes.data_ptr(), bc.exps.data_ptr(), h.data_ptr(),
                y.data_ptr(), ROWS, N, codes.shape[1], bs_log2(spec),
                KIND[spec.dtype], spec.l] + ([1] if self.vec else [])
        build.check(self.lib.frsz2_rmatvec(*args, build.stream()),
                    "frsz2_rmatvec")


def timed(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms (CUDA events), a sleep kernel
    ahead of each start so that the events bracket device work."""
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


def compare(trees: dict[str, Tree], reps: int) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1616)
    V = torch.randn((ROWS, N), generator=gen, dtype=torch.float64, device=dev)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    x = torch.randn((N,), generator=gen, dtype=torch.float64, device=dev)
    h = torch.randn((ROWS,), generator=gen, dtype=torch.float64, device=dev)
    rows = []
    for l in (32, 16):
        spec = F.FrszSpec(bs=32, l=l, dtype=torch.float64)
        bc = ops.compress(V, spec)
        nbytes = (bc.codes.numel() * bc.codes.element_size()
                  + bc.exps.numel() * 4 + N * 8 + ROWS * 8)
        for op in ("matvec", "rmatvec"):
            calls, outs = {}, {}
            for name, t in trees.items():
                if op == "matvec":
                    y = torch.empty((ROWS,), dtype=torch.float64, device=dev)
                    part = torch.empty((ROWS, -(-N // t.chunk)),
                                       dtype=torch.float64, device=dev)
                    calls[name] = (lambda t=t, y=y, part=part:
                                   t.matvec(bc, x, part, y))
                else:
                    y = torch.empty((N,), dtype=torch.float64, device=dev)
                    calls[name] = lambda t=t, y=y: t.rmatvec(bc, h, y)
                calls[name]()
                torch.cuda.synchronize()
                outs[name] = y
            times = {name: [] for name in trees}
            for name in ("against", "this", "this", "against"):
                times[name].append(timed(calls[name], reps))
            row = dict(kernel=op, l=l, shape=f"{ROWS} x {N}, bs 32, f64",
                       this_ms=times["this"], against_ms=times["against"],
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bits_equal=torch.equal(bits(outs["this"]),
                                              bits(outs["against"])))
            if op == "rmatvec":
                want = ref.rmatvec_rows_ref(bc.codes, bc.exps, h, spec)[:N]
                row["this_is_rows_ref"] = torch.equal(bits(outs["this"]),
                                                      bits(want))
            print(json.dumps(row), flush=True)
            rows.append(row)
        del bc
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="another tree's src/repro_torch/kernels/csrc")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dottime needs a CUDA card")
    build.BUILD.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD.parent) as d:
        trees = {"this": Tree(build.CSRC, pathlib.Path(d) / "this"),
                 "against": Tree(pathlib.Path(args.against).resolve(),
                                 pathlib.Path(d) / "against")}
        compare(trees, args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
