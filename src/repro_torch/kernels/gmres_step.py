"""The Givens steps of the GMRES cycles on Hopper: bindings of
``csrc/gmres_step.cu``.

Not ports of TPU kernels: ``givens_step`` replaces the jnp code of one
Arnoldi step of the JAX package's device cycle
(``repro/solver/gmres.py:159-191``), ``block_givens_step`` that of one
block-GMRES step (``_block_apply_prior`` and ``_block_triangularize``,
``repro/solver/gmres.py:269-333``, as ``repro/solver/block.py:140-166``
calls them), so that a captured cycle holds one graph node per step for
its least squares.  Their plain versions are ``kernels/ref.py::
givens_step_ref`` and ``::block_givens_step_ref``; kernel and plain
version round every operation alike.

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
# (state, H, T, fired, bn_safe, j, m, p, target, stream)
_BLOCK = [_P, _P, _P, _P, _P, _I, _I, _I, _D, _P]


def givens_step(state: torch.Tensor, h: torch.Tensor, hj1: torch.Tensor,
                w_pre: torch.Tensor, fired: torch.Tensor, b_norm: torch.Tensor,
                j: int, m: int, target: float) -> None:
    f = build.bind("gmres_step", "gmres_givens_step", _STEP)
    build.check(f(state.data_ptr(), h.data_ptr(), hj1.data_ptr(),
                  w_pre.data_ptr(), fired.data_ptr(), b_norm.data_ptr(), j, m,
                  float(target), KIND[h.dtype], build.stream()),
                "gmres_givens_step")


def block_givens_step(state: torch.Tensor, H: torch.Tensor, T: torch.Tensor,
                      fired: torch.Tensor, bn_safe: torch.Tensor, j: int,
                      m: int, p: int, target: float) -> None:
    """H ((j+1)p, p), T (p, p), bn_safe (p,) f64; fired a 0-d bool."""
    f = build.bind("gmres_step", "gmres_block_givens_step", _BLOCK)
    build.check(f(state.data_ptr(), H.data_ptr(), T.data_ptr(),
                  fired.data_ptr(), bn_safe.data_ptr(), j, m, p,
                  float(target), build.stream()),
                "gmres_block_givens_step")
