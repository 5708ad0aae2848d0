"""Fused FRSZ2 decode + contraction on Hopper: bindings of ``csrc/frsz2_dot.cu``.

Port of the TPU kernels ``repro/kernels/frsz2_dot.py::matvec_2d`` (the
Arnoldi dots ``h = V w``) and ``::rmatvec_2d`` (the combine ``w -= V^T h``
and the solution update).  Codes are decoded in registers and never reach
device memory as values.  The products accumulate in the spec's value dtype
(the TPU kernels round every tile's dot to f32, ``frsz2_dot.py:66``/``:99``).
The matvec reduces across blocks through a scratch buffer of partial sums
and a second pass in a fixed order, so its result does not change from run
to run.  The source file says what bounds the kernels and how their design
answers it.

These functions launch and nothing else: :mod:`repro_torch.kernels.ops`
validates, allocates and counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import build
from repro_torch.kernels.frsz2_kernel import KIND, bs_log2

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (codes, exps, x|h, [partial,] y, rows, n, npad, bs_log2, kind, l, stream)
_MATVEC = [_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _P]
_RMATVEC = [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _P]


def chunk() -> int:
    """Columns one matvec block reduces (sizes the partial-sum buffer)."""
    return int(build.bind("frsz2_dot", "frsz2_matvec_chunk", [])())


def matvec_2d(codes: torch.Tensor, exps: torch.Tensor, x: torch.Tensor,
              partial: torch.Tensor, y: torch.Tensor, spec: F.FrszSpec) -> None:
    """codes (r, npad), exps (r, npad / bs), x (n,) -> y (r,); ``partial``
    is ``(r, ceil(n / chunk()))`` scratch."""
    rows, npad = codes.shape
    f = build.bind("frsz2_dot", "frsz2_matvec", _MATVEC)
    build.check(f(codes.data_ptr(), exps.data_ptr(), x.data_ptr(),
                  partial.data_ptr(), y.data_ptr(), rows, x.shape[0], npad,
                  bs_log2(spec), KIND[spec.dtype], spec.l, build.stream()),
                "frsz2_matvec")


def rmatvec_2d(codes: torch.Tensor, exps: torch.Tensor, h: torch.Tensor,
               y: torch.Tensor, spec: F.FrszSpec) -> None:
    """codes (r, npad), exps (r, npad / bs), h (r,) -> y (n,)."""
    rows, npad = codes.shape
    f = build.bind("frsz2_dot", "frsz2_rmatvec", _RMATVEC)
    build.check(f(codes.data_ptr(), exps.data_ptr(), h.data_ptr(),
                  y.data_ptr(), rows, y.shape[0], npad, bs_log2(spec),
                  KIND[spec.dtype], spec.l, build.stream()),
                "frsz2_rmatvec")
