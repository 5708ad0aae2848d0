"""Flash-decode attention over an FRSZ2-coded KV cache on Hopper: binding of
``csrc/decode_attn.cu``.

Port of the TPU kernel ``repro/kernels/decode_attn.py::decode_attn``: one
new token's GQA attention against a cache whose K and V are stored as FRSZ2
codes (``bs = head_dim``: one block and one exponent per (position, kv
head)), staged in shared memory a tile of positions at a time and decoded
once for all the query heads that share them, with an online softmax
updated once a tile and a per-sequence length mask.  The TPU kernel walks
the cache in ``bs_s`` tiles of one sequential grid axis; this one splits the
cache into chunks of whole tiles that run in parallel (flash-decoding) and
merges their partial softmax states in a second, small kernel.  The source file says what bounds
it on the card and how its design answers it.

These functions launch and nothing else: :mod:`repro_torch.kernels.ops`
validates, allocates and counts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import build
from repro_torch.kernels.frsz2_kernel import KIND

#: the widest group tile of query heads a split block serves
GROUP_TILE = 8
#: positions a split block stages and reduces at a time (``kTile`` in the
#: source); a split is a whole number of tiles
TILE = 64
#: the fewest positions a split gets (two tiles, so that one is in flight
#: while the other is computed) and the most: past it the grid takes several
#: waves instead of one, which long caches fill evenly
MIN_CHUNK, MAX_CHUNK = 2 * TILE, 8 * TILE

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, kcodes, kexps, vcodes, vexps, lengths, part_acc, part_ml, out, B, Hkv,
#  G, S, D, nbd, exp_shift, l, q_kind, chunk, nsplit, sm_scale, stream)
_ATTN = [_P] * 9 + [_I] * 11 + [_F, _P]
# (G, D, nbd, l, q_kind, *blocks)
_OCC = [_I] * 5 + [_P]


@functools.lru_cache(maxsize=None)
def resident_blocks(G: int, D: int, nbd: int, l: int, q_dtype: torch.dtype,
                    device: int) -> int:
    """Split blocks of the kernel for these shapes that the card ``device``
    holds at once: the CUDA occupancy of its instantiation (its shared
    memory and registers) times the SMs."""
    f = build.bind("decode_attn", "decode_attn_occupancy", _OCC)
    per_sm = ctypes.c_int(0)
    build.check(f(G, D, nbd, l, KIND[q_dtype], ctypes.addressof(per_sm)),
                "decode_attn_occupancy")
    if per_sm.value <= 0:
        raise RuntimeError(f"decode_attn: no split block fits an SM at G={G}, "
                           f"D={D}, l={l}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return per_sm.value * sms


def splits(B: int, Hkv: int, G: int, S: int, resident: int
           ) -> tuple[int, int]:
    """``(chunk, nsplit)``: positions per split (a multiple of :data:`TILE`)
    and the number of splits.

    The smallest chunk that puts the whole grid into one wave of
    ``resident`` blocks (:func:`resident_blocks`; a second, part-filled wave
    would leave SMs idle at its end), within ``[MIN_CHUNK, MAX_CHUNK]``.  A
    function of the shapes only (never of the lengths, which live on the
    card), so the launch needs no host read."""
    tiles = B * Hkv * -(-G // GROUP_TILE)
    want = max(1, resident // tiles)
    chunk = -(-S // want)
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, -(-chunk // TILE) * TILE))
    return chunk, -(-S // chunk)


def exp_shift(bs: int) -> int:
    """The shift that maps a code's column to its exponent in the row,
    ``d >> shift``: log2(bs), rounded up.  For a power of two that is the
    block index; for any other bs (zamba2's D = bs = 112) the row must be
    one block, and every column maps to 0."""
    return (bs - 1).bit_length()


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
                  B, Hkv, G, S, D, nbd, exp_shift(spec.bs), spec.l,
                  KIND[q.dtype], chunk,
                  part_acc.shape[3], sm_scale, build.stream()),
                "decode_attn")
