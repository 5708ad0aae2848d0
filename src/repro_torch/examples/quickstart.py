"""Quickstart: the FRSZ2 codec, the Accessor, and CB-GMRES in 60 lines.

  python -m repro_torch.examples.quickstart
  python -m repro_torch.examples.quickstart --device cpu

The JAX package's ``examples/quickstart.py``, section for section and line
for line: the ``FRSZ2_16`` codec on 4,096 f32 values and the paper's
``FrszSpec(bs=32, l=32, float64)`` (the plain codec of ``repro_torch.core``),
then ``gmres`` on ``synth:atmosmod`` for float64, float32 and frsz2_32 (the
device driver; on the card the frsz2_32 basis runs on the FRSZ2 kernels).
Inputs come from ``np.random.default_rng(0)``, as in the reference.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    FRSZ2_16,
    FrszSpec,
    bits_per_value,
    compress,
    decompress,
)
from repro_torch.device import resolve_device
from repro_torch.solver import gmres
from repro_torch.sparse import make_problem, rhs_for

FORMATS = ("float64", "float32", "frsz2_32")


def codec_demo(device="cuda") -> list[str]:
    """Section 1: the lines the codec prints."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).to(dev)

    bc = compress(x, FRSZ2_16)              # 16-bit codes, BS=128 blocks
    y = decompress(bc)
    rel = float((y - x).abs().max() / x.abs().max())
    lines = [f"frsz2_16: {bits_per_value(FRSZ2_16):.2f} bits/value, "
             f"max rel err {rel:.2e}"]

    # the paper's exact format: BS=32 (CUDA warp), l=32, f64 values
    paper_spec = FrszSpec(bs=32, l=32, dtype=torch.float64)
    x64 = torch.from_numpy(rng.standard_normal(4096)).to(dev)
    y64 = decompress(compress(x64, paper_spec))
    lines.append(f"frsz2_32(f64): {bits_per_value(paper_spec):.0f} "
                 f"bits/value, max rel err "
                 f"{float((y64 - x64).abs().max()):.2e}")
    return lines


def solve_demo(device="cuda", n: int = 4000) -> tuple[list[str], dict]:
    """Section 2: the lines the solves print, and each format's result."""
    A, target_rrn = make_problem("synth:atmosmod", n, device=device)
    b, _ = rhs_for(A, device=device)
    lines = [f"\nsolving synth:atmosmod n={A.shape[0]} nnz={A.nnz} "
             f"target rrn={target_rrn:.1e}"]
    results = {}
    for fmt in FORMATS:
        res = gmres(A, b, storage=fmt, m=50, max_iters=3000,
                    target_rrn=target_rrn)
        results[fmt] = res
        lines.append(f"  storage={fmt:9s} iterations={res.iterations:4d} "
                     f"rrn={res.rrn:.2e} converged={res.converged}")
    lines.append("\nfrsz2_32 storage matches float32's footprint but "
                 "converges in fewer iterations — the paper's headline "
                 "result.")
    return lines, results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    for line in codec_demo(args.device) + solve_demo(args.device)[0]:
        print(line)


if __name__ == "__main__":
    main()
