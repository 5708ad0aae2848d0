"""FRSZ2-compressed KV cache: the paper's technique inside LM serving.

The decode-time KV cache has the Krylov basis's access profile (paper
Sec. II): each entry is **written once** (at its token's step) and **re-read
on every later step**, a memory-bound stream that dominates long-context
decode.  K and V are stored as FRSZ2 blocks with ``bs = head_dim``: one
block, and one ``e_max``, per (position, kv head).  A block is always
produced whole at append time, so the paper's whole-block-write constraint
(Sec. IV-A) holds by construction.

Formats:
  * ``none``      — f32 cache (reference)
  * ``bf16``      — cast compression
  * ``frsz2_16``  — 16-bit codes + uint8 exponent  (~16.06 bits/value)
  * ``frsz2_8``   — 8-bit codes + uint8 exponent   (~8.06 bits/value)

The cache is a dict of preallocated tensors, layer-stacked ``(L, B, Hkv, S,
D)``; :func:`append` writes into a layer's view in place (the JAX package
returns a new array from ``.at[].set``; the values are the same, without a
copy of the cache per layer and step).  Codes are held as the codec's
signed containers (``int16`` for l = 16, ``uint8`` for l = 8) with the JAX
package's bit patterns.

On the card, an FRSZ2 cache is written by the cache-write kernel
(``ops.cache_write``: K and V of a layer in one launch, in a decode step
and in the prefill), and :func:`attend` over it runs the hand-written
flash-decode kernel (``ops.decode_attention``), a sliding-window ring
cache included; on the CPU both run their plain versions through the same
calls.  The raw formats, and a window without a ring, run the plain masked
softmax, which is where the JAX package runs jnp for them too.

The cache's writes and its coded decode attention run per rank on the
local shards under the dry run's sharding policy
(``repro_torch.dist.act_sharding.local_region``: DTensor has no rule for
them): K/V, lengths and caches sharded over the batch, heads replicated.
Outside the policy they are plain calls.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import frsz2 as F
from repro_torch.dist.act_sharding import local_region, zeros
from repro_torch.kernels import ops

f32 = torch.float32

__all__ = ["CacheFormat", "cache_format", "init_cache", "append", "attend",
           "masked_attend", "build_cache", "cache_nbytes", "encode_heads",
           "decode_heads"]

_RAW = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# logical names of the local regions' tensors: batch-sharded, the rest whole
_B = ("batch",)
_B4 = ("batch", None, None, None)
_B3 = ("batch", None, None)


@dataclasses.dataclass(frozen=True)
class CacheFormat:
    kind: str                  # 'raw' | 'frsz2'
    l: int = 16                # code bits (frsz2)
    raw_dtype: str = "bfloat16"

    def spec(self, head_dim: int) -> F.FrszSpec:
        return F.FrszSpec(bs=head_dim, l=self.l, dtype=torch.float32,
                          rounding="nearest", exp_dtype=torch.uint8)

    def code_dtype(self) -> torch.dtype:
        return F.code_dtype(self.l)

    def raw_torch_dtype(self) -> torch.dtype:
        return _RAW[self.raw_dtype]

    def bits_per_value(self, head_dim: int) -> float:
        if self.kind == "raw":
            return self.raw_torch_dtype().itemsize * 8
        return (head_dim * self.l + 8) / head_dim


def cache_format(name: str) -> CacheFormat:
    if name in ("none", "f32", "float32"):
        return CacheFormat(kind="raw", raw_dtype="float32")
    if name in ("bf16", "bfloat16"):
        return CacheFormat(kind="raw", raw_dtype="bfloat16")
    if name.startswith("frsz2_"):
        return CacheFormat(kind="frsz2", l=int(name.split("_")[1]))
    raise ValueError(f"unknown kv format {name!r}")


# ---------------------------------------------------------------------------
# codec on (..., D) vectors — one FRSZ2 block per trailing head_dim slice
# ---------------------------------------------------------------------------


def encode_heads(x: torch.Tensor, fmt: CacheFormat, head_dim: int):
    """x (..., D) -> (codes (..., D), exps (..., 1) uint8), ``nearest``
    rounding; through the compress kernel for a CUDA tensor."""
    bc = ops.compress(x.to(f32), fmt.spec(head_dim))
    return bc.codes.reshape(x.shape), bc.exps


def decode_heads(codes: torch.Tensor, exps: torch.Tensor, fmt: CacheFormat,
                 head_dim: int) -> torch.Tensor:
    """Inverse of :func:`encode_heads` -> (..., D) f32."""
    spec = fmt.spec(head_dim)
    bc = F.BlockCompressed(codes=codes.reshape(*codes.shape[:-1], 1, head_dim),
                           exps=exps, n=head_dim, spec=spec)
    return ops.decompress(bc)


# ---------------------------------------------------------------------------
# cache: dict of layer-stacked tensors, written in place
# ---------------------------------------------------------------------------


def init_cache(fmt: CacheFormat, L: int, B: int, Hkv: int, S: int, D: int,
               device=None) -> dict:
    """Layer-stacked zero cache.  Layout (L, B, Hkv, S, D)."""
    shape = (L, B, Hkv, S, D)
    names = (None, "batch")         # batch-sharded under the dry run's policy
    if fmt.kind == "raw":
        dt = fmt.raw_torch_dtype()
        return {"k": zeros(shape, names, dtype=dt, device=device),
                "v": zeros(shape, names, dtype=dt, device=device)}
    cd = fmt.code_dtype()
    eshape = (L, B, Hkv, S, 1)
    return {
        "k_codes": zeros(shape, names, dtype=cd, device=device),
        "k_exps": zeros(eshape, names, dtype=torch.uint8, device=device),
        "v_codes": zeros(shape, names, dtype=cd, device=device),
        "v_exps": zeros(eshape, names, dtype=torch.uint8, device=device),
    }


def append(layer_cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
           lengths: torch.Tensor, fmt: CacheFormat, *, ring: int = 0) -> dict:
    """Write k/v (B, T, Hkv, D) at per-sequence positions ``lengths``, in
    place into ``layer_cache`` (one layer's tensors), and return it.

    ``ring`` > 0 wraps positions modulo ``ring`` (sliding-window cache).
    Works for T == 1 (decode) and T == S (prefill bulk write).  An FRSZ2
    cache is written by ``ops.cache_write``, one launch for K and V on the
    card, which drops positions outside the cache as the JAX package's
    scatter does.  A raw cache's positions must lie inside it
    (``launch.serve`` sizes the cache so that there are none).
    """
    if fmt.kind == "frsz2":
        spec = fmt.spec(k_new.shape[-1])
        local_region(
            lambda k, v, lens, kc, ke, vc, ve: ops.cache_write(
                k, v, lens, kc, ke, vc, ve, spec, ring=ring),
            [], (_B4, _B4, _B, _B4, _B4, _B4, _B4),
            kernel="frsz2_cache_write")(
            k_new, v_new, lengths, layer_cache["k_codes"],
            layer_cache["k_exps"], layer_cache["v_codes"],
            layer_cache["v_exps"])
        return layer_cache
    local_region(lambda k, v, lens, kb, vb: _raw_append(k, v, lens, kb, vb,
                                                        ring),
                 [], (_B4, _B4, _B, _B4, _B4))(
        k_new, v_new, lengths, layer_cache["k"], layer_cache["v"])
    return layer_cache


def _raw_append(k_new, v_new, lengths, k_buf, v_buf, ring: int) -> None:
    """A raw cache's write of :func:`append`, in place."""
    B, T, Hkv, D = k_new.shape
    dev = k_new.device
    S = k_buf.shape[2]
    pos = lengths.to(torch.int64)[:, None] + torch.arange(T, device=dev)
    if ring:
        pos = pos % ring
    # one flat row index per (b, h, t) into the (B * Hkv * S, D) views
    rows = (torch.arange(B * Hkv, device=dev).view(B, Hkv, 1) * S
            + pos[:, None, :]).reshape(-1)
    for buf, x in ((k_buf, k_new), (v_buf, v_new)):
        buf.view(-1, D).index_copy_(
            0, rows, x.transpose(1, 2).reshape(-1, D).to(buf.dtype))


def _decoded(layer_cache: dict, fmt: CacheFormat, D: int):
    """The whole cache decoded -> k, v (B, Hkv, S, D) f32."""
    if fmt.kind == "raw":
        return layer_cache["k"].to(f32), layer_cache["v"].to(f32)
    return (decode_heads(layer_cache["k_codes"], layer_cache["k_exps"], fmt, D),
            decode_heads(layer_cache["v_codes"], layer_cache["v_exps"], fmt, D))


_NEG = -1e30


def attend(q: torch.Tensor, layer_cache: dict, lengths: torch.Tensor,
           fmt: CacheFormat, *, chunk: int = 0, window: int = 0,
           ring: int = 0) -> torch.Tensor:
    """Flash-decode semantics: q (B, H, D) against the (compressed) cache.

    ``window``: mask keys older than window.  ``ring``: the cache is a ring
    buffer of that size (positions stored modulo ring).  ``chunk`` is
    accepted for interface parity and ignored.  An FRSZ2 cache without a
    window, or with a ring (which decode always passes with a window), goes
    to ``ops.decode_attention``, which routes by device (the kernel on the
    card, its plain version on the CPU; both scale the logits rather than
    q), a ring at lengths clamped to the cache's slots; the rest (the raw
    formats, and a window without a ring, which decode never passes) is
    one masked softmax over the whole cache, as the JAX package's.
    """
    if fmt.kind == "frsz2" and (ring or not window):
        return local_region(
            lambda q, kc, ke, vc, ve, lens: _coded_attend(
                q, kc, ke, vc, ve, lens, fmt, ring),
            _B3, (_B3, _B4, _B4, _B4, _B4, _B), kernel="decode_attn")(
            q, layer_cache["k_codes"], layer_cache["k_exps"],
            layer_cache["v_codes"], layer_cache["v_exps"], lengths)
    return masked_attend(q, layer_cache, lengths, fmt, window=window,
                         ring=ring)


def _coded_attend(q, k_codes, k_exps, v_codes, v_exps, lengths,
                  fmt: CacheFormat, ring: int) -> torch.Tensor:
    """:func:`attend` over an FRSZ2 cache: ``ops.decode_attention``."""
    B, H, D = q.shape
    _, Hkv, S, _ = k_codes.shape
    if ring:
        # The ring route.  A cache of S <= ring slots holds position p
        # at slot p mod ring.  The reference's masked softmax
        # (masked_attend) takes slot kpos as valid iff its reconstructed
        # position lies in [len - ring, len): for kpos <= len - 1 that
        # is the largest p = kpos (mod ring) below len, which lies
        # there; for kpos >= len, ``wrap`` clamps to 0 and the
        # position is kpos itself, >= len.  So the valid slots are
        # exactly kpos < min(len, S): the flash-decode kernel's
        # prefix, at lengths clamped to S.  Softmax and P·V do not
        # depend on the order of the positions.  (The window, if
        # given as well, is the ring's own size and masks nothing
        # more, as in the reference's ring branch.)
        if S > ring:
            raise ValueError(
                f"a ring cache of {ring} positions holds {S} slots: "
                "the slots past the ring are never written")
        lengths = lengths.clamp(max=S)
    spec = fmt.spec(D)
    kbc, vbc = (F.BlockCompressed(codes=c.view(B, Hkv, S, 1, D), exps=e,
                                  n=D, spec=spec)
                for c, e in ((k_codes, k_exps), (v_codes, v_exps)))
    return ops.decode_attention(q, kbc, vbc, lengths, sm_scale=D ** -0.5)


def masked_attend(q: torch.Tensor, layer_cache: dict, lengths: torch.Tensor,
                  fmt: CacheFormat, *, window: int = 0, ring: int = 0
                  ) -> torch.Tensor:
    """The reference's decode attention: one masked softmax over the whole
    decoded cache, in f32 (the plain route of :func:`attend`, and what the
    flash-decode kernel is held against on a ring cache)."""
    B, H, D = q.shape
    buf = layer_cache["k"] if fmt.kind == "raw" else layer_cache["k_codes"]
    _, Hkv, S, _ = buf.shape
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).to(f32) * D ** -0.5
    k, v = _decoded(layer_cache, fmt, D)                      # (B,Hkv,S,D)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k)                # (B,Hkv,G,S)
    kpos = torch.arange(S, device=q.device)
    lens = lengths.to(torch.int64)[:, None]
    if ring:
        # ring buffer: slot holds absolute position p ≡ slot (mod ring),
        # p in [len - ring, len); reconstruct the absolute position.
        wrap = torch.div(lens - 1 - kpos[None, :], ring, rounding_mode="floor")
        abs_pos = kpos[None, :] + wrap.clamp(min=0) * ring
        valid = (abs_pos < lens) & (abs_pos >= lens - ring)
    else:
        valid = kpos[None, :] < lens                          # (B, S)
        if window:
            valid &= kpos[None, :] >= lens - window
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), 0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v)
    o = o / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return o.reshape(B, H, D).to(q.dtype)


def build_cache(k_all: torch.Tensor, v_all: torch.Tensor, fmt: CacheFormat, *,
                cache_len: int = 0, ring: int = 0, out: dict | None = None
                ) -> dict:
    """Bulk-construct one layer's cache from full-sequence K/V (prefill).

    k/v (B, S, Hkv, D) -> cache dict with S axis = cache_len (padded) or
    ring (last ``ring`` positions, placed at their modular slots).  The
    whole buffer is produced at once — the paper's whole-block-write
    discipline at maximum scale.  ``out`` (one layer's preallocated
    tensors of that length) is written in place and returned; the padding
    past the prompt is zeroed.  An FRSZ2 cache is written by
    ``ops.cache_write`` at positions ``[0, S)``, its padding cleared by the
    same launch, one for K and V on the card; with a ring, position
    ``p >= S - ring`` goes to slot ``p mod ring``, where the roll of the
    raw formats puts it.
    """
    B, S, Hkv, D = k_all.shape
    stored = min(S, ring) if ring else S
    target = max(cache_len or stored, stored)
    if out is None:
        out = {n: t[0] for n, t in init_cache(fmt, 1, B, Hkv, target, D,
                                              device=k_all.device).items()}
    if fmt.kind == "frsz2":
        spec = fmt.spec(D)
        local_region(
            lambda k, v, kc, ke, vc, ve: ops.cache_write(
                k, v, None, kc, ke, vc, ve, spec, ring=ring,
                clear_from=stored),
            [], (_B4,) * 6, kernel="frsz2_cache_write")(
            k_all, v_all, out["k_codes"], out["k_exps"], out["v_codes"],
            out["v_exps"])
        return out
    local_region(lambda k, v, kb, vb: _raw_build(k, v, kb, vb, ring),
                 [], (_B4,) * 4)(k_all, v_all, out["k"], out["v"])
    return out


def _raw_build(k_all, v_all, k_buf, v_buf, ring: int) -> None:
    """A raw cache's write of :func:`build_cache`, in place."""
    S = k_all.shape[1]
    stored = min(S, ring) if ring else S
    k_bhsd = k_all.transpose(1, 2)
    v_bhsd = v_all.transpose(1, 2)
    if ring and S > ring:
        shift = (S - ring) % ring
        k_bhsd = torch.roll(k_bhsd[:, :, S - ring:], shift, dims=2)
        v_bhsd = torch.roll(v_bhsd[:, :, S - ring:], shift, dims=2)
    for buf, x in ((k_buf, k_bhsd), (v_buf, v_bhsd)):
        buf[:, :, :stored].copy_(x)
        buf[:, :, stored:].zero_()


def cache_nbytes(fmt: CacheFormat, L, B, Hkv, S, D) -> int:
    n = L * B * Hkv * S
    if fmt.kind == "raw":
        return 2 * n * D * fmt.raw_torch_dtype().itemsize
    return 2 * n * (D * F.code_dtype(fmt.l).itemsize + 1)
