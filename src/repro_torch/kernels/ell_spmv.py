"""ELL SpMV on Hopper, dense or FRSZ2-coded operand: bindings of
``csrc/ell_spmv.cu``.

Port of the TPU kernels ``repro/kernels/ell_spmv.py::ell_spmv_2d`` and
``::ell_spmv_frsz2_2d``.  The TPU versions pad the rows to a tile multiple
and hold the whole operand in VMEM; these take ``vals``/``cols`` as they are
and gather the operand from L2.  The dense kernel takes a block of q
operands in one launch (``jax.vmap`` of ``ell_spmv_2d`` in the JAX
package's block-GMRES).  Each row sums its products in slot order,
so the result is the same bits as ``kernels/ref.py::ell_spmv_ref``.  The
source file says what bounds the kernels and how their design answers it.

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
# (vals, cols, x, y, nr, w, nc, q, kind, stream)
_DENSE = [_P, _P, _P, _P, _LL, _I, _LL, _I, _I, _P]
# (vals, cols, codes, exps, y, nr, w, bs_log2, code_kind, l, kind, stream)
_CODED = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P]

#: the widths the source compiles a tiled body for; every other width runs
#: the row kernel (``ell_row_kernel``, ``ell_row_batched_kernel``)
TILE_WIDTHS = (7, 27)


def body(w: int) -> str:
    """The body a launch at ELL width ``w`` runs: ``"tile"`` or ``"row"``."""
    return "tile" if w in TILE_WIDTHS else "row"


def ell_spmv_2d(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> None:
    """vals/cols (nr, w), x (q, nc) in the dtype of vals -> y (q, nr)."""
    nr, w = vals.shape
    q, nc = x.shape
    f = build.bind("ell_spmv", "ell_spmv", _DENSE)
    build.check(f(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                  nr, w, nc, q, KIND[vals.dtype], build.stream()), "ell_spmv")


def ell_spmv_frsz2_2d(vals: torch.Tensor, cols: torch.Tensor,
                      codes: torch.Tensor, exps: torch.Tensor,
                      y: torch.Tensor, spec: F.FrszSpec) -> None:
    """vals/cols (nr, w), operand codes (nb * bs,) + exps (nb,) -> y (nr,)."""
    nr, w = vals.shape
    f = build.bind("ell_spmv", "ell_spmv_frsz2", _CODED)
    build.check(f(vals.data_ptr(), cols.data_ptr(), codes.data_ptr(),
                  exps.data_ptr(), y.data_ptr(), nr, w, bs_log2(spec),
                  KIND[spec.dtype], spec.l, KIND[vals.dtype], build.stream()),
                "ell_spmv_frsz2")
