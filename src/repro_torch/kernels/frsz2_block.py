"""Fused FRSZ2 decode + block contraction on Hopper: bindings of
``csrc/frsz2_block.cu``.

Port of the TPU kernels ``repro/kernels/frsz2_block.py::block_dots_2d``
(the block-GMRES dots ``H = V W^T``) and ``::block_combine_2d`` (the block
combine ``W -= Y^T V`` and the block solution update).  One decode of each
basis code serves all q right-hand sides; codes never reach device memory
as values.  The products accumulate in the spec's value dtype, in a fixed
order, so a contraction gives the same bits on every run.  The source file
says what bounds the kernels and how their design answers it.

Layouts (``ops.block_dots``/``ops.block_combine`` produce them from a flat
block store): ``codes (M, n_seg)``, one code per element, ``M = rows * p``
segment rows; ``exps (M, n_seg / bs)``; ``W (q, n_seg)``; ``Y (M, q)``.

These functions launch and nothing else: :mod:`repro_torch.kernels.ops`
validates, allocates and counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import build
from repro_torch.kernels.frsz2_kernel import KIND, bs_log2

#: segment rows one block-dots block covers, and the columns of W it stages
#: in shared memory at once; ``csrc/frsz2_block.cu`` uses the same
ROWS_PER_BLOCK = 64
SUB_COLS = 256

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (codes, exps, W, partial, Y, M, n_seg, q, chunk_cols, bs_log2, kind, l,
#  stream)
_DOTS = [_P, _P, _P, _P, _P, _LL, _LL, _I, _LL, _I, _I, _I, _P]
# (codes, exps, Y, out, M, n_seg, q, bs_log2, kind, l, stream)
_COMBINE = [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P]


def block_dots_2d(codes: torch.Tensor, exps: torch.Tensor, W: torch.Tensor,
                  partial: torch.Tensor, Y: torch.Tensor, chunk_cols: int,
                  spec: F.FrszSpec) -> None:
    """codes (M, n_seg), exps (M, n_seg / bs), W (q, n_seg) -> Y (M, q);
    ``partial`` is ``(M, ceil(n_seg / chunk_cols), q)`` scratch."""
    M, n_seg = codes.shape
    f = build.bind("frsz2_block", "frsz2_block_dots", _DOTS)
    build.check(f(codes.data_ptr(), exps.data_ptr(), W.data_ptr(),
                  partial.data_ptr(), Y.data_ptr(), M, n_seg, W.shape[0],
                  chunk_cols, bs_log2(spec), KIND[spec.dtype], spec.l,
                  build.stream()), "frsz2_block_dots")


def block_combine_2d(codes: torch.Tensor, exps: torch.Tensor, Y: torch.Tensor,
                     out: torch.Tensor, spec: F.FrszSpec) -> None:
    """codes (M, n_seg), exps (M, n_seg / bs), Y (M, q) -> out (q, n_seg)."""
    M, n_seg = codes.shape
    f = build.bind("frsz2_block", "frsz2_block_combine", _COMBINE)
    build.check(f(codes.data_ptr(), exps.data_ptr(), Y.data_ptr(),
                  out.data_ptr(), M, n_seg, Y.shape[1], bs_log2(spec),
                  KIND[spec.dtype], spec.l, build.stream()),
                "frsz2_block_combine")
