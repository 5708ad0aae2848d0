"""Flash-decode attention over an FRSZ2-coded KV cache on Hopper: binding of
``csrc/decode_attn.cu``.

Port of the TPU kernel ``repro/kernels/decode_attn.py::decode_attn``: one
new token's GQA attention against a cache whose K and V are stored as FRSZ2
codes (``bs = head_dim``: one block and one exponent per (position, kv
head)), decoded in registers between the load and the dot, with an online
softmax and a per-sequence length mask.  The TPU kernel walks the cache in
``bs_s`` tiles of one sequential grid axis; this one splits the cache into
chunks that run in parallel (flash-decoding) and merges their partial
softmax states in a second, small kernel.  The source file says what bounds
it on the card and how its design answers it.

These functions launch and nothing else: :mod:`repro_torch.kernels.ops`
validates, allocates and counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import build
from repro_torch.kernels.frsz2_kernel import KIND, bs_log2

#: the widest group tile of query heads a split block serves
GROUP_TILE = 8
#: split blocks to aim for (about four per SM-resident slot on 132 SMs, so
#: that splits past a short sequence's length, which exit at once, leave no
#: long tail), and the fewest positions a split gets
TARGET_BLOCKS = 2048
MIN_CHUNK = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, kcodes, kexps, vcodes, vexps, lengths, part_acc, part_ml, out, B, Hkv,
#  G, S, D, nbd, bs_log2, l, q_kind, chunk, nsplit, sm_scale, stream)
_ATTN = [_P] * 9 + [_I] * 11 + [_F, _P]


def splits(B: int, Hkv: int, G: int, S: int) -> tuple[int, int]:
    """``(chunk, nsplit)``: positions per split and the number of splits.

    A function of the shapes only (never of the lengths, which live on the
    card), so the launch needs no host read."""
    tiles = B * Hkv * -(-G // GROUP_TILE)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    chunk = max(MIN_CHUNK, -(-S // want))
    return chunk, -(-S // chunk)


def decode_attn(q: torch.Tensor, kcodes: torch.Tensor, kexps: torch.Tensor,
                vcodes: torch.Tensor, vexps: torch.Tensor,
                lengths: torch.Tensor, part_acc: torch.Tensor,
                part_ml: torch.Tensor, out: torch.Tensor, chunk: int,
                spec: F.FrszSpec, sm_scale: float) -> None:
    """q (B, Hkv, G, D); codes (B, Hkv, S, D); exps (B, Hkv, S, nbd) uint8;
    lengths (B,) int32; part_acc (B, Hkv, G, nsplit, D) and part_ml
    (B, Hkv, G, nsplit, 2) f32 scratch -> out (B, Hkv, G, D), in place."""
    B, Hkv, G, D = q.shape
    S, nbd = kexps.shape[2], kexps.shape[3]
    f = build.bind("decode_attn", "decode_attn", _ATTN)
    build.check(f(q.data_ptr(), kcodes.data_ptr(), kexps.data_ptr(),
                  vcodes.data_ptr(), vexps.data_ptr(), lengths.data_ptr(),
                  part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                  B, Hkv, G, S, D, nbd, bs_log2(spec), spec.l,
                  KIND[q.dtype], chunk,
                  part_acc.shape[3], sm_scale, build.stream()),
                "decode_attn")
