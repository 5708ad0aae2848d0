"""FRSZ2: block floating-point compression (paper Sec. IV), in plain PyTorch.

The format groups ``bs`` consecutive values into a block, stores the block's
maximum IEEE exponent ``e_max`` once, and stores each value as an ``l``-bit
code::

    c = [ sign | integer bit | fraction bits ]          (paper Eq. 2)

whose significand is the input significand (explicit leading 1) right-shifted
by ``k = e_max - e``.  Decompression recovers ``k`` from the position of the
code's leading one and re-packs an IEEE value.

This module is the plain-tensor codec: it defines the bits, supports every
code length ``l`` (including unaligned ones such as the paper's l=21, which
are bit-packed into 32-bit words) and every block size, and runs on any
device.  The CUDA kernels in :mod:`repro_torch.kernels` implement the aligned
fast paths (l in {8, 16, 32}, bs dividing 128) and must reproduce these bits
exactly.

PyTorch has no shifts, comparisons or ``max`` for ``uint16/32/64`` on the
CPU, so all bit arithmetic runs on ``int64`` tensors that hold the unsigned
pattern (zero-extended for 16/32-bit types; the raw pattern for 64-bit ones).
Every arithmetic ``>>`` is masked afterwards where its input can be negative,
and shift counts are clamped exactly as the reference format defines them.
Codes are stored in signed containers of the code width (``uint8``,
``int16``, ``int32``, ``int64``) holding the unsigned bit pattern.

Storage (paper Eq. 3, word size w=4 bytes)::

    ceil(n/bs) * ceil(bs*l/32) * 4   bytes of codes
  + ceil(n/bs) * 4                   bytes of exponents
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "FrszSpec",
    "BlockCompressed",
    "compress",
    "decompress",
    "storage_nbytes",
    "bits_per_value",
    "code_dtype",
    "dtype_name",
    "FRSZ2_32",
    "FRSZ2_21",
    "FRSZ2_16",
    "FRSZ2_8",
]


# ---------------------------------------------------------------------------
# IEEE-754 layout constants per value dtype
# ---------------------------------------------------------------------------

_IEEE = {
    torch.float32: dict(int=torch.int32, mant=23, expbits=8, bias=127, width=32),
    torch.float64: dict(int=torch.int64, mant=52, expbits=11, bias=1023, width=64),
    torch.bfloat16: dict(int=torch.int16, mant=7, expbits=8, bias=127, width=16),
    torch.float16: dict(int=torch.int16, mant=10, expbits=5, bias=15, width=16),
}


def dtype_name(dtype) -> str:
    """``torch.float64`` -> ``"float64"`` (numpy-style dtype names)."""
    return str(dtype).removeprefix("torch.")


def code_dtype(l: int) -> torch.dtype:
    """Container dtype of an aligned l-bit code (holds the unsigned pattern)."""
    if l <= 8:
        return torch.uint8
    if l <= 16:
        return torch.int16
    if l <= 32:
        return torch.int32
    return torch.int64


@dataclasses.dataclass(frozen=True)
class FrszSpec:
    """Static description of an FRSZ2 format.

    Attributes:
      bs: block size (values per shared exponent).  Paper: 32 (one CUDA warp).
      l: bits per compressed value (sign + integer bit + fraction bits).
      dtype: the value dtype the codec round-trips.
      rounding: 'truncate' (paper Sec. IV step 5: "cut") or 'nearest'
        (round-half-up before the cut).
      exp_dtype: storage dtype of the per-block exponent: ``torch.int32``
        (as in the paper: "frsz2_32 needs 33 bits per value on average") or
        ``torch.uint8`` (the KV cache's; it holds a biased exponent of at
        most 8 bits, so it takes f32, bf16 and f16 values only).
    """

    bs: int = 128
    l: int = 32
    dtype: Any = torch.float32
    rounding: str = "truncate"
    exp_dtype: Any = torch.int32

    def __post_init__(self):
        if self.l < 3:
            raise ValueError("l must be >= 3 (sign + integer bit + >=1 fraction bit)")
        ieee = _IEEE.get(self.dtype)
        if ieee is None:
            raise ValueError(f"unsupported value dtype {self.dtype}")
        if self.l > ieee["width"]:
            raise ValueError(f"l={self.l} exceeds dtype width {ieee['width']}")
        if 32 < self.l < 64:
            # the packed layout does 32-bit word arithmetic (a code spans at
            # most two words); the useful range is l <= 32, plus the
            # aligned l = 64 passthrough.
            raise ValueError("unaligned l in (32, 64) is unsupported")
        if self.rounding not in ("truncate", "nearest"):
            raise ValueError(f"unknown rounding {self.rounding!r}")
        if self.bs < 1:
            raise ValueError("bs must be positive")
        if self.exp_dtype not in (torch.int32, torch.uint8):
            raise ValueError("exp_dtype must be torch.int32 or torch.uint8")
        if self.exp_dtype == torch.uint8 and ieee["expbits"] > 8:
            raise ValueError(f"uint8 exponents cannot hold the {ieee['expbits']}"
                             f"-bit exponents of {dtype_name(self.dtype)}")

    # -- derived ------------------------------------------------------------
    @property
    def ieee(self):
        return _IEEE[self.dtype]

    @property
    def aligned(self) -> bool:
        """Aligned codes can be stored one-per-integer without bit packing."""
        return self.l in (8, 16, 32, 64)

    @property
    def words_per_block(self) -> int:
        """32-bit words of code storage per block (packed layout, Eq. 3)."""
        return -(-self.bs * self.l // 32)

    @property
    def name(self) -> str:
        return f"frsz2_{self.l}(bs={self.bs},{dtype_name(self.dtype)})"


FRSZ2_32 = FrszSpec(bs=128, l=32)
FRSZ2_21 = FrszSpec(bs=128, l=21)
FRSZ2_16 = FrszSpec(bs=128, l=16)
FRSZ2_8 = FrszSpec(bs=128, l=8)


# ---------------------------------------------------------------------------
# Compressed container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockCompressed:
    """FRSZ2-compressed tensor.

    The tensor is compressed along its *last* axis; leading axes are batch.
    ``codes`` has shape ``batch + (nblocks, bs)`` for aligned specs or
    ``batch + (nblocks, words_per_block)`` (``int32`` words) for packed specs.
    ``exps`` has shape ``batch + (nblocks,)``.  ``n`` is the logical length
    of the last axis (the tail block is zero-padded: zero codes decompress
    to exact zeros).
    """

    codes: torch.Tensor
    exps: torch.Tensor
    n: int
    spec: FrszSpec

    @property
    def shape(self):
        return tuple(self.exps.shape[:-1]) + (self.n,)

    @property
    def nblocks(self) -> int:
        return self.exps.shape[-1]

    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.exps.numel() * self.exps.element_size())

    def decompress(self) -> torch.Tensor:
        return decompress(self)


# ---------------------------------------------------------------------------
# Bit helpers (int64 tensors holding unsigned patterns)
# ---------------------------------------------------------------------------


def _mask(bits: int) -> int:
    """All-ones mask of ``bits`` bits as a Python int usable on int64."""
    return -1 if bits >= 64 else (1 << bits) - 1


def _to_unsigned64(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed container of ``bits`` bits -> int64 holding the unsigned value."""
    u = t.to(torch.int64)
    return u if bits >= 64 else u & _mask(bits)


def _from_unsigned64(u: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    """int64 holding an unsigned ``bits``-bit value -> signed container."""
    if bits >= 64:
        return u.to(dtype)
    if dtype == torch.uint8:
        return (u & 0xFF).to(dtype)
    u = u & _mask(bits)
    # two's-complement wrap into the signed container, spelled out
    return (u - (((u >> (bits - 1)) & 1) << bits)).to(dtype)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Branch-free bit length of non-negative int64 values (0 for 0).

    A binary search over the word, with no float round-trip: a conversion
    to float would round ``2^k - 1`` up for k > 53.
    """
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        t = x >> s
        hit = t != 0
        n = n + hit.to(torch.int64) * s
        x = torch.where(hit, t, x)
    return n + (x != 0).to(torch.int64)


# ---------------------------------------------------------------------------
# Compression (paper Sec. IV-A, 6 steps)
# ---------------------------------------------------------------------------


def _split_ieee(x: torch.Tensor, spec: FrszSpec):
    """Steps 1-2: extract sign, biased exponent, significand (explicit 1)."""
    ieee = spec.ieee
    mant, expbits, width = ieee["mant"], ieee["expbits"], ieee["width"]
    u = _to_unsigned64(x.to(spec.dtype).contiguous().view(ieee["int"]), width)
    sign = (u >> (mant + expbits)) & 1
    e = (u >> mant) & ((1 << expbits) - 1)
    m = u & ((1 << mant) - 1)
    # Subnormals (e == 0) are treated as zero: their magnitude is below
    # 2^(1-bias), irrelevant for normalized Krylov data (the leading-1 trick
    # requires normal numbers).
    normal = e > 0
    sig = torch.where(normal, m | (1 << mant), torch.zeros_like(m))
    return sign, e, sig


def _encode_block(sign, e, sig, emax, spec: FrszSpec):
    """Steps 3-5: normalize to e_max, prepend sign, cut to l bits."""
    ieee = spec.ieee
    mant, width, l = ieee["mant"], ieee["width"], spec.l
    k = emax[..., None] - e          # zeros have e=0 -> huge k -> code 0
    # fixed point with 1 integer bit + (l-2) fraction bits:
    # c_sig = sig * 2^(l-2) / 2^(mant+k)  ->  shift = mant - (l-2) + k
    shift = mant - (l - 2) + k
    rs = shift.clamp(0, width - 1)
    ls = (-shift).clamp(0, width - 1)
    big = shift >= width
    if spec.rounding == "nearest":
        # round-half-up prior to the cut; clamp on overflow of the field
        half = torch.where(rs > 0, torch.ones_like(rs) << (rs - 1).clamp(min=0),
                           torch.zeros_like(rs))
        sig = sig + torch.where(shift > 0, half, torch.zeros_like(half))
    # sig is non-negative and a left shift never reaches the sign bit
    # (sig < 2^(mant+1), ls <= l-2-mant), so int64 shifts act unsigned here
    csig = torch.where(shift >= 0, sig >> rs, sig << ls)
    csig = torch.where(big, torch.zeros_like(csig), csig)
    csig = torch.minimum(csig, torch.full_like(csig, (1 << (l - 1)) - 1))
    return (sign << (l - 1)) | csig


def compress(x: torch.Tensor, spec: FrszSpec = FRSZ2_32) -> BlockCompressed:
    """Compress ``x`` along its last axis into FRSZ2 blocks.

    Works for any leading batch shape.  The tail block is zero padded.
    """
    x = torch.as_tensor(x).to(spec.dtype)
    *batch, n = x.shape
    nb = -(-n // spec.bs)
    pad = nb * spec.bs - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(*batch, nb, spec.bs)

    sign, e, sig = _split_ieee(xb, spec)
    emax = e.amax(dim=-1)                       # step 1: block max exponent
    c = _encode_block(sign, e, sig, emax, spec)  # steps 2-5

    if spec.aligned:
        codes = _from_unsigned64(c, spec.l, code_dtype(spec.l))
    else:
        codes = _pack_bits(c, spec)
    return BlockCompressed(codes=codes, exps=emax.to(spec.exp_dtype), n=n,
                           spec=spec)


# ---------------------------------------------------------------------------
# Decompression (paper Sec. IV-B, 4 steps)
# ---------------------------------------------------------------------------


def _decode_block(c: torch.Tensor, emax: torch.Tensor, spec: FrszSpec):
    """int64 codes (unsigned l-bit patterns) + block exponents -> values."""
    ieee = spec.ieee
    mant, expbits, width, l = (ieee["mant"], ieee["expbits"], ieee["width"],
                               spec.l)
    sign = (c >> (l - 1)) & 1
    csig = c & ((1 << (l - 1)) - 1)
    zero = csig == 0
    # step 2: k = number of prefixed zeros in the (l-1)-wide field
    k = torch.where(zero, torch.zeros_like(csig), (l - 1) - _bit_length(csig))
    e = emax[..., None].to(torch.int64) - k
    # step 3: drop the leading 1; nf = l-2-k fraction bits remain
    nf = l - 2 - k
    lead = torch.ones_like(nf) << nf.clamp(min=0)
    frac = csig ^ torch.where(zero, torch.zeros_like(csig), lead)
    d = mant - nf                   # left shift if positive, right if negative
    m = torch.where(d >= 0, frac << d.clamp(0, width - 1),
                    frac >> (-d).clamp(0, width - 1))
    flush = zero | (e <= 0)         # flush to (signed) zero
    e = torch.where(flush, torch.zeros_like(e), e)
    m = torch.where(flush, torch.zeros_like(m), m)
    u = (sign << (mant + expbits)) | (e << mant) | m
    return _from_unsigned64(u, width, ieee["int"]).view(spec.dtype)


def decompress(bc: BlockCompressed) -> torch.Tensor:
    """Inverse of :func:`compress`; returns the logical ``batch + (n,)`` tensor."""
    spec = bc.spec
    if spec.aligned:
        c = _to_unsigned64(bc.codes, spec.l)
    else:
        c = _unpack_bits(bc.codes, spec)
    x = _decode_block(c, bc.exps, spec)
    *batch, nb, bs = x.shape
    return x.reshape(*batch, nb * bs)[..., : bc.n]


# ---------------------------------------------------------------------------
# Generic-l bit packing (plain route only; kernels use aligned l)
# ---------------------------------------------------------------------------


def _pack_layout(spec: FrszSpec, device):
    j = torch.arange(spec.bs, dtype=torch.int64, device=device)
    off = j * spec.l
    b0 = off % 32
    # shift-by-32 is guarded: where b0 == 0 there is no spill
    return off // 32, b0, (32 - b0).clamp(0, 31), b0 == 0


def _pack_bits(c: torch.Tensor, spec: FrszSpec) -> torch.Tensor:
    """Pack ``batch + (nb, bs)`` l-bit codes into ``batch + (nb, W)`` words.

    Each code straddles at most two 32-bit words; bit fields never overlap,
    so adding the pieces into the words is the same as or-ing them.
    """
    W = spec.words_per_block
    w0, b0, hi_shift, no_spill = _pack_layout(spec, c.device)
    lo = (c << b0) & 0xFFFFFFFF
    hi = torch.where(no_spill, torch.zeros_like(c), c >> hi_shift)
    words = torch.zeros((*c.shape[:-1], W + 1), dtype=torch.int64,
                        device=c.device)
    words.index_add_(-1, w0, lo)
    words.index_add_(-1, w0 + 1, hi)    # the +1 word catches the last spill
    return _from_unsigned64(words[..., :W], 32, torch.int32)


def _unpack_bits(words: torch.Tensor, spec: FrszSpec) -> torch.Tensor:
    """Inverse of :func:`_pack_bits` -> ``batch + (nb, bs)`` int64 codes."""
    w0, b0, hi_shift, no_spill = _pack_layout(spec, words.device)
    w = _to_unsigned64(words, 32)
    wpad = torch.cat([w, torch.zeros_like(w[..., :1])], dim=-1)
    lo = wpad[..., w0] >> b0
    hi = torch.where(no_spill, torch.zeros_like(lo),
                     (wpad[..., w0 + 1] << hi_shift) & 0xFFFFFFFF)
    return (lo | hi) & _mask(spec.l)


# ---------------------------------------------------------------------------
# Storage accounting (paper Eq. 3)
# ---------------------------------------------------------------------------


def storage_nbytes(n: int, spec: FrszSpec) -> int:
    """Bytes to store ``n`` values, per paper Eq. 3 (4-byte words)."""
    nb = -(-n // spec.bs)
    return nb * spec.words_per_block * 4 + nb * 4


def bits_per_value(spec: FrszSpec) -> float:
    """Average bits per value including the externalized exponent."""
    return (spec.words_per_block * 32 + 32) / spec.bs
