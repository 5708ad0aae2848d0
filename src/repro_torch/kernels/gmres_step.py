"""One Givens step of the GMRES cycle on Hopper: bindings of
``csrc/gmres_step.cu``.

Not a port of a TPU kernel: it replaces the jnp code of one Arnoldi step of
the JAX package's device cycle (``repro/solver/gmres.py:159-191``), so that
the captured cycle holds one graph node per step for it.  Its plain version
is ``kernels/ref.py::givens_step_ref``; both round every operation as the
host driver's Python floats do.

This function launches and nothing else: :mod:`repro_torch.kernels.ops`
validates and counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.frsz2_kernel import KIND

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# (state, h, hj1, w_pre, fired, b_norm, j, m, target, kind, stream)
_STEP = [_P, _P, _P, _P, _P, _P, _I, _I, _D, _I, _P]


def givens_step(state: torch.Tensor, h: torch.Tensor, hj1: torch.Tensor,
                w_pre: torch.Tensor, fired: torch.Tensor, b_norm: torch.Tensor,
                j: int, m: int, target: float) -> None:
    f = build.bind("gmres_step", "gmres_givens_step", _STEP)
    build.check(f(state.data_ptr(), h.data_ptr(), hj1.data_ptr(),
                  w_pre.data_ptr(), fired.data_ptr(), b_norm.data_ptr(), j, m,
                  float(target), KIND[h.dtype], build.stream()),
                "gmres_givens_step")
