"""Plain PyTorch versions of the Hopper kernels: what each kernel computes.

The kernels in ``frsz2_kernel.py`` / ``frsz2_dot.py`` must match these:
bit for bit on the codec, to float tolerance on the contractions.  The
contractions accumulate in the value dtype of the spec (f64 for the solver's
formats).  On the CPU the wrappers in ``ops.py`` run these; on the card
``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.core import frsz2 as F


def compress_ref(x: torch.Tensor, spec: F.FrszSpec):
    """Returns (codes, exps) with codes shaped ``batch + (nb, bs)``."""
    bc = F.compress(x, spec)
    return bc.codes, bc.exps


def decompress_ref(codes: torch.Tensor, exps: torch.Tensor, spec: F.FrszSpec,
                   n: int | None = None) -> torch.Tensor:
    nb, bs = codes.shape[-2], codes.shape[-1]
    if n is None:
        n = nb * bs
    return F.decompress(F.BlockCompressed(codes=codes, exps=exps, n=n,
                                          spec=spec))


def matvec_ref(codes, exps, x, spec: F.FrszSpec) -> torch.Tensor:
    """y[i] = sum_j decompress(V)[i, j] * x[j].

    codes: (m, nb, bs); exps: (m, nb); x: (nb*bs,)  ->  y: (m,)
    """
    V = decompress_ref(codes, exps, spec)
    return V @ x.to(V.dtype)


def rmatvec_ref(codes, exps, h, spec: F.FrszSpec) -> torch.Tensor:
    """y[j] = sum_i h[i] * decompress(V)[i, j].

    codes: (m, nb, bs); exps: (m, nb); h: (m,)  ->  y: (nb*bs,)
    """
    V = decompress_ref(codes, exps, spec)
    return h.to(V.dtype) @ V
