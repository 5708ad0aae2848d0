"""Dense building blocks: norms, RoPE, blocked attention, SwiGLU MLP.

Plain PyTorch: none of these is a TPU kernel in the JAX package, and the
matrix products stay ``torch.matmul``.  Attention for a prompt is
*blocked* (an online softmax over key chunks, in f32), so no O(S²) logits
buffer exists; the one new token of a decode step attends through
:func:`repro_torch.models.kvcache.attend` instead.  The layer loop is a
Python loop (``repro_torch.models.lm``), and nothing is sharded: the JAX
package's ``scan_or_unroll`` and sharding constraints have no counterpart.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

f32 = torch.float32

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "blocked_attention",
           "attention_block", "attention_qkv", "swiglu_block"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(f32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(f32)).to(x.dtype)


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=64)
def _freqs_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` copied to ``device`` once: a copy from pageable
    host memory per call would wait for the card at every layer."""
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, hd) with positions broadcastable to x's (..., S): (S,)
    in prefill, (B, 1) in decode, where each row gets its own position.

    The JAX package's ``apply_rope`` broadcasts decode's (B, 1) positions
    against (B, 1, H, hd) to (B, B, H, hd), so its decode step rotates
    every row by row 0's position and appends B positions per row; the
    visible values are the same whenever all rows have one length, as in
    its ``serve`` and in every test that compares the two.
    """
    hd = x.shape[-1]
    freqs = _freqs_on(hd, theta, x.device)
    ang = positions[..., None].to(f32) * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_NEG = -1e30


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk_q: int = 1024, chunk_k: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention without an O(S²) buffer.

    q: (B, Sq, H, hd);  k, v: (B, Sk, Hkv, hd);  H = G * Hkv.
    Returns (B, Sq, H, hd) in q.dtype.  ``window`` > 0 masks keys older
    than ``window`` positions (sliding-window attention).  K and V are
    repeated over the group and the softmax runs in f32, as the JAX
    package's.
    """
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    while Sq % cq:
        cq //= 2
    while Sk % ck:
        ck //= 2
    nq, nk = Sq // cq, Sk // ck
    scale = hd ** -0.5
    dev = q.device
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    outs = []
    for iq in range(nq):
        qi = q[:, iq * cq:(iq + 1) * cq].to(f32) * scale       # (B,cq,H,hd)
        qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
        o = torch.zeros((B, H, cq, hd), dtype=f32, device=dev)
        m = torch.full((B, H, cq), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, H, cq), dtype=f32, device=dev)
        for ik in range(nk):
            ki = k[:, ik * ck:(ik + 1) * ck].to(f32)          # (B,ck,H,hd)
            vi = v[:, ik * ck:(ik + 1) * ck].to(f32)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki)       # (B,H,cq,ck)
            kpos = ik * ck + torch.arange(ck, device=dev)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))              # (B,H,cq)
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vi)
            m = m_new
        o = o / l[..., None].clamp(min=1e-30)
        outs.append(o.transpose(1, 2))                        # (B,cq,H,hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_block(x: torch.Tensor, p: dict, cfg, *, positions,
                    kv_src=None, causal: bool = True, window: int = 0
                    ) -> torch.Tensor:
    """Pre-norm attention block.  ``kv_src`` switches to cross-attention."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"])
    src = h if kv_src is None else kv_src
    B, S, _ = h.shape
    Sk = src.shape[1]
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (src @ p["wk"]).reshape(B, Sk, Hkv, hd)
    v = (src @ p["wv"]).reshape(B, Sk, Hkv, hd)
    if kv_src is None:                                        # self-attn: RoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=causal and kv_src is None,
                          window=window, chunk_q=cfg.attn_chunk,
                          chunk_k=cfg.attn_chunk)
    return x + o.reshape(B, S, H * hd) @ p["wo"]


def attention_qkv(h: torch.Tensor, p: dict, cfg, *, positions):
    """Projection-only path used by the decode cache (returns q, k, v)."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B = h.shape[0]
    q = (h @ p["wq"]).reshape(B, -1, H, hd)
    k = (h @ p["wk"]).reshape(B, -1, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, -1, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def swiglu_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = rms_norm(x, p["ln"])
    act = Fn.silu(h @ p["wg"]) * (h @ p["wi"])
    return x + act @ p["wo"]
