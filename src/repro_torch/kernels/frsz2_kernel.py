"""FRSZ2 compress / decompress on Hopper: bindings of ``csrc/frsz2_codec.cu``.

Port of the TPU kernels ``repro/kernels/frsz2_kernel.py::compress_2d`` and
``::decompress_2d``.  The TPU versions tile a ``(M, 128)`` lane layout; these
take the basis row layout directly (one code per element, ``(rows, npad)``
codes and ``(rows, nb)`` exponents), so a basis write compresses straight
into its row of the store.  :func:`cache_write` is compress as the serving
KV cache calls it: K and V of one layer, cast, coded and scattered to their
cache positions in one launch.  The source file says what bounds the
kernels on the card and how their design answers it.

These functions launch and nothing else: :mod:`repro_torch.kernels.ops`
validates, allocates and counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import build

#: value kinds as the C entry points number them
KIND = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
        torch.bfloat16: 3}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (x|codes, codes|exps, exps|out, rows, n, npad, bs_log2, kind, l[, nearest],
#  stream), as the C entry points declare them
_COMPRESS = [_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _P]
_DECOMPRESS = [_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _P]
# (k, v, k strides (4), v strides (4), lengths, k codes, k exps, v codes,
#  v exps, B, T, Hkv, D, S, ring, clear_from, kind, l, stream)
_CACHE_WRITE = [_P, _P] + [_LL] * 8 + [_P] * 5 + [_I] * 9 + [_P]


def bs_log2(spec: F.FrszSpec) -> int:
    return spec.bs.bit_length() - 1


def compress_2d(x: torch.Tensor, codes: torch.Tensor, exps: torch.Tensor,
                spec: F.FrszSpec) -> None:
    """x (rows, n) -> codes (rows, npad), exps (rows, npad / bs), in place."""
    rows, n = x.shape
    npad = codes.shape[-1]
    f = build.bind("frsz2_codec", "frsz2_compress", _COMPRESS)
    build.check(f(x.data_ptr(), codes.data_ptr(), exps.data_ptr(), rows, n,
                  npad, bs_log2(spec), KIND[spec.dtype], spec.l,
                  int(spec.rounding == "nearest"), build.stream()),
                "frsz2_compress")


def decompress_2d(codes: torch.Tensor, exps: torch.Tensor, out: torch.Tensor,
                  spec: F.FrszSpec) -> None:
    """codes (rows, npad), exps (rows, npad / bs) -> out (rows, n), in place."""
    rows, n = out.shape
    npad = codes.shape[-1]
    f = build.bind("frsz2_codec", "frsz2_decompress", _DECOMPRESS)
    build.check(f(codes.data_ptr(), exps.data_ptr(), out.data_ptr(), rows, n,
                  npad, bs_log2(spec), KIND[spec.dtype], spec.l, build.stream()),
                "frsz2_decompress")


def cache_write(k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor | None,
                k_codes: torch.Tensor, k_exps: torch.Tensor,
                v_codes: torch.Tensor, v_exps: torch.Tensor, ring: int,
                clear_from: int, spec: F.FrszSpec) -> None:
    """k, v (B, T, Hkv, D) by strides; lengths (B,) int32 or None (0) ->
    codes (B, Hkv, S, D), exps (B, Hkv, S, 1) uint8 at positions
    ``lengths[b] + t`` (mod ``ring``), and positions ``[clear_from, S)``
    zeroed, in place."""
    B, T, Hkv, D = k.shape
    S = k_codes.shape[2]
    f = build.bind("frsz2_codec", "frsz2_cache_write", _CACHE_WRITE)
    build.check(f(k.data_ptr(), v.data_ptr(), *k.stride(), *v.stride(),
                  None if lengths is None else lengths.data_ptr(),
                  k_codes.data_ptr(), k_exps.data_ptr(), v_codes.data_ptr(),
                  v_exps.data_ptr(), B, T, Hkv, D, S, ring, clear_from,
                  KIND[k.dtype], spec.l, build.stream()),
                "frsz2_cache_write")
