"""Model assembly for serving: init / trunk / prefill / decode, for the
dense and MoE families.

The dense family is the pre-norm GQA decoder (internlm2, yi, granite,
mistral-nemo); the MoE family (mixtral, llama4-scout) replaces its SwiGLU
MLP with a grouped top-k MoE of SwiGLU experts (``layers.moe_block``),
and mixtral attends through a sliding window whose decode cache is a ring
of ``window`` slots.  Weights are a dict of layer-stacked ``(L, ...)``
tensors under the JAX package's names; the layer loop is a Python loop
over views of them.  The decode cache is a dict of preallocated ``(L, B,
Hkv, S, D)`` tensors (``repro_torch.models.kvcache``) that :func:`prefill`
fills and :func:`decode_step` appends to in place; on the card its FRSZ2
codes are written by the cache-write kernel and read by the flash-decode
kernel.

The other families of the registry (SSM, hybrid, encdec, VLM) and
training (``loss_fn``) wait for a later slice of the port: their branches
raise ``NotImplementedError``.

Random weights cannot match the JAX package's (``jax.random`` and
``torch.Generator`` give other numbers): :func:`init_params` draws its own,
and the parity tests carry the JAX package's weights across with
``repro_torch.convert.params_from_numpy``.
"""
from __future__ import annotations

import torch

from repro_torch.models import kvcache as kv
from repro_torch.models.config import ArchConfig, torch_dtype
from repro_torch.models.layers import (
    attention_block,
    attention_qkv,
    blocked_attention,
    moe_block,
    rms_norm,
    swiglu_block,
)

f32 = torch.float32

__all__ = ["init_params", "trunk", "init_decode_cache", "decode_step",
           "prefill"]


#: the families the port runs
FAMILIES = ("dense", "moe")


def _check_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{what} for the {cfg.family!r} family ({cfg.name}) waits for a "
            "later slice of the port (ROADMAP.md §1): the port runs the "
            "dense and moe families")


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _init(gen: torch.Generator, shape, scale: float, dtype, L: int = 0
          ) -> torch.Tensor:
    """``normal * scale`` in f32, cast to ``dtype``; with ``L`` a stack of L
    draws made one layer at a time, so the f32 temporary stays one layer."""
    dev = gen.device
    if not L:
        return (torch.randn(shape, generator=gen, dtype=f32, device=dev)
                * scale).to(dtype)
    out = torch.empty((L, *shape), dtype=dtype, device=dev)
    for i in range(L):
        out[i] = torch.randn(shape, generator=gen, dtype=f32,
                             device=dev) * scale
    return out


def _attn_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s_in = d ** -0.5
    s_out = (H * hd) ** -0.5 / (2 * max(cfg.num_layers, 1)) ** 0.5
    return {
        "ln": torch.ones((L, d), dtype=dt, device=gen.device),
        "wq": _init(gen, (d, H * hd), s_in, dt, L),
        "wk": _init(gen, (d, Hkv * hd), s_in, dt, L),
        "wv": _init(gen, (d, Hkv * hd), s_in, dt, L),
        "wo": _init(gen, (H * hd, d), s_out, dt, L),
    }


def _mlp_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s_out = ff ** -0.5 / (2 * max(cfg.num_layers, 1)) ** 0.5
    return {
        "ln": torch.ones((L, d), dtype=dt, device=gen.device),
        "wg": _init(gen, (d, ff), d ** -0.5, dt, L),
        "wi": _init(gen, (d, ff), d ** -0.5, dt, L),
        "wo": _init(gen, (ff, d), s_out, dt, L),
    }


def _moe_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    """The router in f32, the experts' ``wg``/``wi`` (E, d, ff) and ``wo``
    (E, ff, d) stacked per layer, as the reference's ``_moe_params``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_out = ff ** -0.5 / (2 * max(cfg.num_layers, 1)) ** 0.5
    return {
        "ln": torch.ones((L, d), dtype=dt, device=gen.device),
        "router": _init(gen, (d, E), d ** -0.5, f32, L),
        "wg": _init(gen, (E, d, ff), d ** -0.5, dt, L),
        "wi": _init(gen, (E, d, ff), d ** -0.5, dt, L),
        "wo": _init(gen, (E, ff, d), s_out, dt, L),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random weights at the reference's scales, on ``gen``'s device."""
    _check_family(cfg, "init_params")
    dt = torch_dtype(cfg.dtype)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    params = {
        "embed": _init(gen, (V, d), 0.02, dt),
        "final_ln": torch.ones((d,), dtype=dt, device=gen.device),
        "unembed": _init(gen, (d, V), d ** -0.5, dt),
    }
    layers = {"attn": _attn_params(gen, cfg, L, dt)}
    if cfg.family == "moe":
        layers["moe"] = _moe_params(gen, cfg, L, dt)
    else:
        layers["mlp"] = _mlp_params(gen, cfg, L, dt)
    params["layers"] = layers
    return params


def _ffn(h: torch.Tensor, lp: dict, cfg: ArchConfig):
    """The layer's feed-forward half: -> (h, aux loss or None)."""
    if cfg.family == "moe":
        return moe_block(h, lp["moe"], cfg)
    return swiglu_block(h, lp["mlp"]), None


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s views of a (nested) dict of stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# parallel forward (the teacher-forcing reference of the serving path)
# ---------------------------------------------------------------------------


def trunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
          aux_inputs=None):
    """tokens (B, S) -> (hidden states (B, S, d), aux loss): the MoE
    layers' load-balancing losses summed over layers (f32), 0 for the
    dense family."""
    _check_family(cfg, "trunk")
    B, S = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(S, device=h.device)
    aux = torch.zeros((), dtype=f32, device=h.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = attention_block(h, lp["attn"], cfg, positions=positions,
                            window=cfg.window)
        h, a = _ffn(h, lp, cfg)
        if a is not None:
            aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with (compressed) caches
# ---------------------------------------------------------------------------


def _cache_fmt(cfg: ArchConfig) -> kv.CacheFormat:
    return kv.cache_format(cfg.kv_format)


def _cache_seq(cfg: ArchConfig, S: int) -> int:
    """Allocated cache length: ring of `window` for SWA else full S."""
    return min(cfg.window, S) if cfg.window else S


def init_decode_cache(cfg: ArchConfig, B: int, S: int, device=None) -> dict:
    """Allocate the decode cache for max context S."""
    _check_family(cfg, "init_decode_cache")
    cache = {"lengths": torch.zeros((B,), dtype=torch.int32, device=device)}
    cache["self"] = kv.init_cache(_cache_fmt(cfg), cfg.num_layers, B,
                                  cfg.num_kv_heads, _cache_seq(cfg, S),
                                  cfg.hd, device=device)
    return cache


def _self_attn_decode(h, lp, cfg, layer_cache, lengths, fmt, ring):
    """One decode step of a self-attention block against its cache; writes
    the new position into ``layer_cache`` in place."""
    B = h.shape[0]
    hn = rms_norm(h, lp["ln"])
    q, k, v = attention_qkv(hn, lp, cfg, positions=lengths[:, None])
    kv.append(layer_cache, k, v, lengths, fmt, ring=ring)
    o = kv.attend(q[:, 0], layer_cache, lengths + 1, fmt,
                  chunk=cfg.decode_chunk, window=cfg.window, ring=ring)
    return h + (o.reshape(B, 1, -1) @ lp["wo"])


def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                tokens: torch.Tensor):
    """One-token decode.  tokens (B,) -> (logits (B, V) f32, cache).

    Writes the new token's K/V into ``cache`` and advances its lengths, in
    place (the JAX package returns a new cache), and returns it.
    """
    _check_family(cfg, "decode_step")
    fmt = _cache_fmt(cfg)
    lengths = cache["lengths"]
    h = params["embed"][tokens][:, None, :]                   # (B, 1, d)
    ring = cfg.window                 # a sliding-window cache is a ring
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        lc = _layer(cache["self"], i)
        h = _self_attn_decode(h, lp["attn"], cfg, lc, lengths, fmt, ring)
        h, _ = _ffn(h, lp, cfg)
    h = rms_norm(h[:, 0], params["final_ln"])
    logits = (h @ params["unembed"]).to(f32)
    cache["lengths"] = lengths + 1
    return logits, cache


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            aux_inputs=None, *, cache_len: int = 0):
    """Bulk-process a prompt: returns (last-token logits, populated cache).

    Runs the parallel forward (blocked attention) and writes each layer's
    cache whole into a preallocated buffer (no scatter: the paper's
    whole-block-write discipline).  ``cache_len`` pads the cache for later
    decode steps (defaults to the prompt length); a sliding-window cache
    is padded up to ``window`` slots at most.
    """
    _check_family(cfg, "prefill")
    fmt = _cache_fmt(cfg)
    B, S = tokens.shape
    h = params["embed"][tokens]
    dev = h.device
    positions = torch.arange(S, device=dev)
    ring = _cache_seq(cfg, S) if cfg.window else 0
    c_len = max(cache_len, _cache_seq(cfg, S))
    stored = min(S, ring) if ring else S
    # a sliding-window cache holds at most ``window`` slots, the ring that
    # decode_step writes (as init_decode_cache allocates it): the
    # reference pads it to cache_len, and its attend then counts the
    # never-written slots past the ring as keys (ROADMAP.md §3)
    n_slots = max(c_len, stored)
    if cfg.window:
        n_slots = min(n_slots, cfg.window)
    self_cache = kv.init_cache(fmt, cfg.num_layers, B, cfg.num_kv_heads,
                               n_slots, cfg.hd, device=dev)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        ap = lp["attn"]
        hn = rms_norm(h, ap["ln"])
        q, k, v = attention_qkv(hn, ap, cfg, positions=positions)
        o = blocked_attention(q, k, v, causal=True, window=cfg.window,
                              chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk)
        kv.build_cache(k, v, fmt, cache_len=c_len, ring=ring,
                       out=_layer(self_cache, i))
        _, _, H, hd = q.shape
        h = h + o.reshape(B, S, H * hd) @ ap["wo"]
        h, _ = _ffn(h, lp, cfg)
    h_last = rms_norm(h[:, -1], params["final_ln"])
    logits = (h_last @ params["unembed"]).to(f32)
    cache = {"self": self_cache,
             "lengths": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, cache
