"""Model assembly: init / train loss / trunk / prefill / decode, for the
dense, MoE, SSM, hybrid, encoder-decoder and VLM families.

The dense family is the pre-norm GQA decoder (internlm2, yi, granite,
mistral-nemo); the MoE family (mixtral, llama4-scout) replaces its SwiGLU
MLP with a grouped top-k MoE of SwiGLU experts (``layers.moe_block``),
and mixtral attends through a sliding window whose decode cache is a ring
of ``window`` slots.  The SSM family (falcon-mamba) is a pure Mamba1 stack
with no attention and no KV cache; the hybrid family (zamba2) is a Mamba2
stack with ONE shared attention + SwiGLU block applied after every
``attn_every`` layers (each application has its own KV cache, the weights
are shared), then the ``L % attn_every`` tail layers
(``repro_torch.models.ssm``).  The encoder-decoder family (whisper) runs a
bidirectional encoder over stub frame embeddings (``aux_inputs["frames"]``)
and a causal decoder whose every layer cross-attends to the encoder's
states; the VLM family (llama-3.2-vision) runs ``cross_attn_every`` self
layers, then one cross-attention + SwiGLU block over stub image embeddings
(``aux_inputs["image_embeds"]``), ``L // cross_attn_every`` rounds.  Weights
are a dict of layer-stacked ``(L, ...)`` tensors under the JAX package's
names; the layer loop is a Python loop over views of them, each stacked
tensor unbound once a forward (``_layers``: the backward of ``unbind`` is one
``stack``, where a select a layer would write a zero-filled gradient of
the whole stack each, L² in the depth).  The decode
cache is a dict of preallocated tensors: ``(L, B, Hkv, S, D)`` K/V
(``repro_torch.models.kvcache``; one layer an application of the shared
block in the hybrid family) under ``"self"``, the cross caches under
``"cross"`` (one layer a cross-attention block, written whole by
:func:`prefill` from the encoder or image states and only read by
:func:`decode_step`), and the SSM families' f32 states ``ssm_h`` and conv
states ``ssm_conv``, which :func:`prefill` fills and :func:`decode_step`
updates in place; on the card an FRSZ2 cache's codes are written by the
cache-write kernel and read by the flash-decode kernel.

Training: :func:`loss_fn` is the next-token cross entropy over the
:func:`trunk`, in sequence chunks so that no (B, S, V) logits exist, with
the reference's z-loss and MoE aux loss.  Under autograd with ``cfg.remat``
(the default) each layer is recomputed in its backward
(``layers.remat``, the reference's ``jax.checkpoint`` of a scan body), and
the SSM blocks recompute each scan chunk too.  Serving (:func:`prefill`,
:func:`decode_step`) runs under ``torch.no_grad``.

Random weights cannot match the JAX package's (``jax.random`` and
``torch.Generator`` give other numbers): :func:`init_params` draws its own,
and the parity tests carry the JAX package's weights across with
``repro_torch.convert.params_from_numpy``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch.dist import act_sharding
from repro_torch.dist.act_sharding import constrain
from repro_torch.models import kvcache as kv
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig, torch_dtype
from repro_torch.models.layers import (
    attention_block,
    attention_qkv,
    blocked_attention,
    moe_block,
    remat,
    rms_norm,
    swiglu_block,
)

f32 = torch.float32

__all__ = ["init_params", "trunk", "loss_fn", "init_decode_cache",
           "decode_step", "prefill", "kv_layers", "cross_layers",
           "cross_len", "META"]


#: the families the port runs: every family of the registry
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ArchConfig, what: str) -> None:
    """An unknown family raises ``ValueError``, as the reference's does."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{what}: unknown family {cfg.family!r} "
                         f"({cfg.name}); known: {', '.join(FAMILIES)}")


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


class _MetaDraws:
    """Stands in for a generator on the ``meta`` device: :func:`init_params`
    then gives every weight its shape and dtype and allocates nothing."""

    device = torch.device("meta")


#: pass as ``gen`` to :func:`init_params` for weights on the meta device
META = _MetaDraws()


def _init(gen: torch.Generator, shape, scale: float, dtype, L: int = 0
          ) -> torch.Tensor:
    """``normal * scale`` in f32, cast to ``dtype``; with ``L`` a stack of L
    draws made one layer at a time, so the f32 temporary stays one layer."""
    dev = gen.device
    if dev.type == "meta":
        return torch.empty((L, *shape) if L else shape, dtype=dtype,
                           device=dev)
    if not L:
        return (torch.randn(shape, generator=gen, dtype=f32, device=dev)
                * scale).to(dtype)
    out = torch.empty((L, *shape), dtype=dtype, device=dev)
    for i in range(L):
        out[i] = torch.randn(shape, generator=gen, dtype=f32,
                             device=dev) * scale
    return out


def _full(gen, shape, value: float, dtype, L: int = 0) -> torch.Tensor:
    """A constant tensor, stacked over L layers when ``L`` > 0."""
    return torch.full((L, *shape) if L else shape, value, dtype=dtype,
                      device=gen.device)


def _attn_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    """``L`` = 0: one unstacked block (the hybrid family's shared one)."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s_in = d ** -0.5
    s_out = (H * hd) ** -0.5 / (2 * max(cfg.num_layers, 1)) ** 0.5
    return {
        "ln": _full(gen, (d,), 1.0, dt, L),
        "wq": _init(gen, (d, H * hd), s_in, dt, L),
        "wk": _init(gen, (d, Hkv * hd), s_in, dt, L),
        "wv": _init(gen, (d, Hkv * hd), s_in, dt, L),
        "wo": _init(gen, (H * hd, d), s_out, dt, L),
    }


def _mlp_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s_out = ff ** -0.5 / (2 * max(cfg.num_layers, 1)) ** 0.5
    return {
        "ln": _full(gen, (d,), 1.0, dt, L),
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


def _dt_bias(gen, shape) -> torch.Tensor:
    """softplus^-1 of dt drawn log-uniform in [1e-3, 0.1], f32."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=f32, device=gen.device)
    u = torch.rand(shape, generator=gen, dtype=f32, device=gen.device)
    dt = torch.exp(u * float(math.log(0.1 / 1e-3)) + float(math.log(1e-3)))
    return torch.log(torch.expm1(dt))


def _mamba1_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    """The reference's ``_mamba1_params``: projections at its scales,
    ``A_log`` = log(1..N) on every channel, D = 1, f32 where it keeps f32."""
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = max(1, d // 16)
    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=gen.device))
    return {
        "ln": _full(gen, (d,), 1.0, dt, L),
        "in_proj": _init(gen, (d, 2 * di), d ** -0.5, dt, L),
        "conv_w": _init(gen, (W, di), W ** -0.5, dt, L),
        "conv_b": _full(gen, (di,), 0.0, dt, L),
        "x_proj": _init(gen, (di, R + 2 * N), di ** -0.5, dt, L),
        "dt_proj": _init(gen, (R, di), R ** -0.5, dt, L),
        "dt_bias": _dt_bias(gen, (L, di)),
        "A_log": a_log.expand(L, di, N).clone(),
        "D": _full(gen, (di,), 1.0, f32, L),
        "out_proj": _init(gen, (di, d), di ** -0.5
                          / (2 * cfg.num_layers) ** 0.5, dt, L),
    }


def _mamba2_params(gen, cfg: ArchConfig, L: int, dt) -> dict:
    """The reference's ``_mamba2_params``: one in-projection for z, x, B,
    C and dt, ``A_log`` = 0 and D = 1 per head, the gated output norm."""
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    Hs = di // cfg.ssm_head_dim
    return {
        "ln": _full(gen, (d,), 1.0, dt, L),
        "in_proj": _init(gen, (d, 2 * di + 2 * N + Hs), d ** -0.5, dt, L),
        "conv_w": _init(gen, (W, di), W ** -0.5, dt, L),
        "conv_b": _full(gen, (di,), 0.0, dt, L),
        "dt_bias": _dt_bias(gen, (L, Hs)),
        "A_log": _full(gen, (Hs,), 0.0, f32, L),
        "D": _full(gen, (Hs,), 1.0, f32, L),
        "out_ln": _full(gen, (di,), 1.0, dt, L),
        "out_proj": _init(gen, (di, d), di ** -0.5
                          / (2 * cfg.num_layers) ** 0.5, dt, L),
    }


def kv_layers(cfg: ArchConfig) -> int:
    """Layers of the self-attention KV cache (``cache["self"]``): one a
    self-attention layer, one an application of the hybrid's shared block,
    none in the SSM family.  The cross caches are not counted here:
    :func:`cross_layers`."""
    if cfg.family == "ssm":
        return 0
    return _rounds(cfg)[0] if cfg.family == "hybrid" else cfg.num_layers


def cross_layers(cfg: ArchConfig) -> int:
    """Layers of the cross-attention cache (``cache["cross"]``): one a
    decoder layer (encdec), one a cross block (VLM), none elsewhere."""
    if cfg.family == "encdec":
        return cfg.num_layers
    if cfg.family == "vlm":
        return _cross_rounds(cfg)
    return 0


def cross_len(cfg: ArchConfig) -> int:
    """Source positions a cross cache holds and every decode step reads:
    the encoder's frames (encdec) or the image tokens (VLM)."""
    if cfg.family == "encdec":
        return cfg.encoder_seq
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    return 0


def _cross_rounds(cfg: ArchConfig) -> int:
    """VLM: the rounds of ``cross_attn_every`` self layers and one cross
    block (the reference reshapes the L layers to (R, k), so k divides L)."""
    k = cfg.cross_attn_every
    if not k or cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: cross_attn_every={k} must divide "
                         f"num_layers={cfg.num_layers}")
    return cfg.num_layers // k


def _rounds(cfg: ArchConfig) -> tuple[int, int]:
    """Hybrid: (R applications of the shared block, the R * attn_every
    body layers before the tail)."""
    k = cfg.attn_every
    R = cfg.num_layers // k if k else 0
    return R, R * k


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random weights at the reference's scales, on ``gen``'s device; with
    ``gen=META`` the weights' shapes on the meta device, nothing drawn."""
    _check_family(cfg, "init_params")
    dt = torch_dtype(cfg.dtype)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    params = {
        "embed": _init(gen, (V, d), 0.02, dt),
        "final_ln": torch.ones((d,), dtype=dt, device=gen.device),
        "unembed": _init(gen, (d, V), d ** -0.5, dt),
    }
    if cfg.family == "ssm":
        params["layers"] = _mamba1_params(gen, cfg, L, dt)
        return params
    if cfg.family == "hybrid":
        _, body = _rounds(cfg)
        params["layers"] = _mamba2_params(gen, cfg, body, dt)
        if L - body:
            params["tail_layers"] = _mamba2_params(gen, cfg, L - body, dt)
        params["shared_attn"] = _attn_params(gen, cfg, 0, dt)
        params["shared_mlp"] = _mlp_params(gen, cfg, 0, dt)
        return params
    if cfg.family == "encdec":
        Le = cfg.encoder_layers
        params["encoder"] = {
            "layers": {"attn": _attn_params(gen, cfg, Le, dt),
                       "mlp": _mlp_params(gen, cfg, Le, dt)},
            "final_ln": torch.ones((d,), dtype=dt, device=gen.device),
        }
    layers = {"attn": _attn_params(gen, cfg, L, dt)}
    if cfg.family == "encdec":
        layers["cross"] = _attn_params(gen, cfg, L, dt)
    if cfg.family == "moe":
        layers["moe"] = _moe_params(gen, cfg, L, dt)
    else:
        layers["mlp"] = _mlp_params(gen, cfg, L, dt)
    params["layers"] = layers
    if cfg.family == "vlm":
        R = _cross_rounds(cfg)
        params["cross_layers"] = {"attn": _attn_params(gen, cfg, R, dt),
                                  "mlp": _mlp_params(gen, cfg, R, dt)}
    return params


def _ffn(h: torch.Tensor, lp: dict, cfg: ArchConfig):
    """The layer's feed-forward half: -> (h, aux loss or None)."""
    if cfg.family == "moe":
        return moe_block(h, lp["moe"], cfg)
    return swiglu_block(h, lp["mlp"]), None


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s views of a (nested) dict of stacked tensors (a decode
    cache's layer, written in place)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _layers(stacked: dict) -> list[dict]:
    """Every layer's views of a (nested) dict of stacked weights, each
    tensor unbound once: its backward is one ``stack`` of the layers'
    gradients."""
    parts = {k: _layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _ssm_layers(params: dict, cfg: ArchConfig):
    """The SSM families' layers in order: (layer index, its weights, the
    application of the shared block after it or None)."""
    if cfg.family == "ssm":
        for i, lp in enumerate(_layers(params["layers"])):
            yield i, lp, None
        return
    _, body = _rounds(cfg)
    k = cfg.attn_every
    layers = _layers(params["layers"]) if body else []
    if cfg.num_layers > body:
        layers += _layers(params["tail_layers"])
    for i, lp in enumerate(layers):
        yield i, lp, (i // k if i < body and i % k == k - 1 else None)


def _ssm_seq(cfg: ArchConfig):
    return ssm_mod.mamba1_seq if cfg.family == "ssm" else ssm_mod.mamba2_seq


def _cross_src(params: dict, cfg: ArchConfig, aux_inputs, dtype, B: int
               ) -> torch.Tensor:
    """The cross-attention source (B, cross_len, d): the encoder's states
    over ``aux_inputs["frames"]`` (encdec) or ``aux_inputs["image_embeds"]``
    (VLM), in the model's dtype."""
    key = "frames" if cfg.family == "encdec" else "image_embeds"
    if not aux_inputs or key not in aux_inputs:
        raise ValueError(f"the {cfg.family} family ({cfg.name}) needs "
                         f"aux_inputs[{key!r}]")
    src = aux_inputs[key].to(dtype)
    want = (B, cross_len(cfg), cfg.d_model)
    if tuple(src.shape) != want:
        raise ValueError(f"aux_inputs[{key!r}] is {tuple(src.shape)}, "
                         f"expected {want} (the decode steps read "
                         f"cross_len = {want[1]} positions)")
    if cfg.family == "vlm":
        return src
    # the bidirectional encoder, RoPE at the frames' positions
    enc_pos = torch.arange(src.shape[1], device=src.device)
    enc = params["encoder"]
    for lp in _layers(enc["layers"]):
        def body(x, lp=lp):
            x = attention_block(x, lp["attn"], cfg, positions=enc_pos,
                                causal=False)
            return swiglu_block(x, lp["mlp"])
        src = remat(cfg, body, src)
    return rms_norm(src, enc["final_ln"])


def _decoder(params: dict, cfg: ArchConfig, h: torch.Tensor, self_attn,
             cross_attn) -> torch.Tensor:
    """The encdec / VLM decoder stack over ``h``, with the attention halves
    given: ``self_attn(h, attention weights, layer i)`` and ``cross_attn(h,
    attention weights, cross layer c)`` (the forward's, the prefill's or a
    decode step's); the SwiGLU blocks are the same in all three.  whisper
    cross-attends in every layer, between its self-attention and its MLP;
    the VLM runs ``cross_attn_every`` self layers, then a cross block with
    its own MLP, ``L // cross_attn_every`` rounds (its layer ``r * k + j``
    is step j of round r, the reference's (R, k) reshape).  Each layer and
    each cross block is one :func:`~repro_torch.models.layers.remat`
    region."""
    layers = _layers(params["layers"])
    if cfg.family == "encdec":
        for i, lp in enumerate(layers):
            def body(x, lp=lp, i=i):
                x = self_attn(x, lp["attn"], i)
                x = cross_attn(x, lp["cross"], i)
                return swiglu_block(x, lp["mlp"])
            h = remat(cfg, body, h)
        return h
    k = cfg.cross_attn_every
    for r, cp in enumerate(_layers(params["cross_layers"])):
        for i in range(r * k, (r + 1) * k):
            def body(x, lp=layers[i], i=i):
                return swiglu_block(self_attn(x, lp["attn"], i), lp["mlp"])
            h = remat(cfg, body, h)

        def cross(x, cp=cp, r=r):
            return swiglu_block(cross_attn(x, cp["attn"], r), cp["mlp"])
        h = remat(cfg, cross, h)
    return h


# ---------------------------------------------------------------------------
# parallel forward (the teacher-forcing reference of the serving path)
# ---------------------------------------------------------------------------


def trunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
          aux_inputs=None):
    """tokens (B, S) -> (hidden states (B, S, d), aux loss): the MoE
    layers' load-balancing losses summed over layers (f32), 0 for the
    other families.  ``aux_inputs``: the encdec family's ``"frames"`` or
    the VLM's ``"image_embeds"``, (B, cross_len, d).  Each layer (each
    application of the hybrid's shared block, each encoder layer, each
    cross block) is one :func:`~repro_torch.models.layers.remat` region."""
    _check_family(cfg, "trunk")
    B, S = tokens.shape
    # the gather of ``embed[tokens]``; its backward sums the rows of a
    # repeated token in a fixed order (the indexing's backward on the CPU
    # adds them with atomics, in any order)
    h = Fn.embedding(tokens, params["embed"])
    # reduced where the vocab is sharded (the dry run's policy; the
    # identity otherwise), before a remat region saves it: DTensor's masked
    # partial of an embedding reduces once
    h = constrain(h, "batch", None, None)
    positions = torch.arange(S, device=h.device)
    aux = torch.zeros((), dtype=f32, device=h.device)
    if cfg.family in ("encdec", "vlm"):
        src = _cross_src(params, cfg, aux_inputs, h.dtype, B)
        h = _decoder(
            params, cfg, h,
            lambda x, ap, i: attention_block(x, ap, cfg, positions=positions),
            lambda x, ap, c: attention_block(x, ap, cfg, positions=positions,
                                             kv_src=src))
        return h, aux
    if cfg.family in ("ssm", "hybrid"):
        seq = _ssm_seq(cfg)

        def shared(x):
            x = attention_block(x, params["shared_attn"], cfg,
                                positions=positions)
            return swiglu_block(x, params["shared_mlp"])
        for _, lp, r in _ssm_layers(params, cfg):
            h = remat(cfg, lambda x, lp=lp: seq(x, lp, cfg), h)
            if r is not None:
                h = remat(cfg, shared, h)
        return h, aux

    def body(x, lp):
        x = attention_block(x, lp["attn"], cfg, positions=positions,
                            window=cfg.window)
        x, a = _ffn(x, lp, cfg)
        return x, (a if a is not None else torch.zeros_like(aux))
    for lp in _layers(params["layers"]):
        h, a = remat(cfg, lambda x, lp=lp: body(x, lp), h)
        aux = aux + a
    return h, aux


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            vocab_chunk: int = 1024, z_loss: float = 1e-4) -> torch.Tensor:
    """Next-token cross entropy of ``batch["tokens"]`` (B, S + 1), f32.

    The reference's ``loss_fn``: the hidden states of the first S tokens,
    RMS-normed, against the last S, in chunks of ``min(vocab_chunk, S)``
    positions (each chunk's (B, c, V) logits in f32, never the whole (B, S,
    V)), plus ``z_loss`` times the mean squared log-sum-exp and 0.01 times
    the MoE aux loss.  The batch's other keys (``"frames"``,
    ``"image_embeds"``) are the trunk's ``aux_inputs``.
    """
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h, aux = trunk(params, cfg, inputs,
                   {k: v for k, v in batch.items() if k != "tokens"})
    h = rms_norm(h, params["final_ln"])
    B, S, _ = h.shape
    c = min(vocab_chunk, S)
    if S % c:
        raise ValueError(f"the sequence ({S}) must be a multiple of the "
                         f"loss chunk ({c}), as in the reference")
    ce = torch.zeros((), dtype=f32, device=h.device)
    zl = torch.zeros((), dtype=f32, device=h.device)
    for s in range(0, S, c):
        logits = (h[:, s:s + c] @ params["unembed"]).to(f32)  # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        # the gathered logit reduced where the vocab is sharded (the dry
        # run's policy; the identity otherwise), before it loses its last
        # dim: DTensor's masked partial of a gather keeps the gather's shape
        tgt = constrain(logits.gather(-1, targets[:, s:s + c, None].long()),
                        "batch", None, None)[..., 0]
        ce = ce + (lse - tgt).sum()
        zl = zl + lse.square().sum()
    ntok = B * S
    return ce / ntok + z_loss * zl / ntok + 0.01 * aux


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
    cache = {"lengths": act_sharding.zeros((B,), ("batch",),
                                           dtype=torch.int32, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        cache.update(_ssm_state(cfg, B, device))
        if cfg.family == "ssm":
            return cache
    cache["self"] = kv.init_cache(_cache_fmt(cfg), kv_layers(cfg), B,
                                  cfg.num_kv_heads, _cache_seq(cfg, S),
                                  cfg.hd, device=device)
    if cross_layers(cfg):
        # the reference pads the cross cache to a multiple of 128 here,
        # where its prefill builds it unpadded (cross_len positions): the
        # decode steps read cross_len positions, so the padding never
        # enters a result (ROADMAP.md §3)
        cache["cross"] = kv.init_cache(
            _cache_fmt(cfg), cross_layers(cfg), B, cfg.num_kv_heads,
            _round_up(cross_len(cfg), 128), cfg.hd, device=device)
    return cache


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _ssm_state(cfg: ArchConfig, B: int, device) -> dict:
    """Zero SSM states: ``ssm_h`` f32, (L, B, di, N) for Mamba1 and (L, B,
    Hs, P, N) for Mamba2, and ``ssm_conv`` (L, B, W-1, di) in the model's
    dtype."""
    L, di, N, W = cfg.num_layers, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.family == "ssm":
        hshape = (L, B, di, N)
    else:
        P = cfg.ssm_head_dim
        hshape = (L, B, di // P, P, N)
    return {"ssm_h": act_sharding.zeros(hshape, (None, "batch"), dtype=f32,
                                        device=device),
            "ssm_conv": act_sharding.zeros((L, B, W - 1, di), (None, "batch"),
                                           dtype=torch_dtype(cfg.dtype),
                                           device=device)}


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


def _cross_attn_decode(h, lp, cfg, layer_cache, src_len, fmt):
    """One decode step of a cross-attention block against its cache (no
    RoPE; the cache is only read)."""
    B = h.shape[0]
    hn = rms_norm(h, lp["ln"])
    q = (hn @ lp["wq"]).reshape(B, cfg.num_heads, cfg.hd)
    o = kv.attend(q, layer_cache, src_len, fmt, chunk=cfg.decode_chunk)
    return h + (o.reshape(B, 1, -1) @ lp["wo"])


@torch.no_grad()
def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                tokens: torch.Tensor):
    """One-token decode.  tokens (B,) -> (logits (B, V) f32, cache).

    Writes the new token's K/V into ``cache`` and advances its lengths, in
    place (the JAX package returns a new cache), and returns it.  The cross
    caches are read whole (``cross_len`` positions a row), never written.
    """
    _check_family(cfg, "decode_step")
    fmt = _cache_fmt(cfg)
    lengths = cache["lengths"]
    h = params["embed"][tokens][:, None, :]                   # (B, 1, d)
    ring = cfg.window                 # a sliding-window cache is a ring
    if cfg.family in ("encdec", "vlm"):
        S_src = cross_len(cfg)
        buf = cache["cross"]["k" if fmt.kind == "raw" else "k_codes"]
        if buf.shape[3] < S_src:
            raise ValueError(f"the cross cache holds {buf.shape[3]} "
                             f"positions; a decode step reads {S_src}")
        src_len = torch.full((h.shape[0],), S_src, dtype=torch.int32,
                             device=h.device)
        h = _decoder(
            params, cfg, h,
            lambda x, ap, i: _self_attn_decode(
                x, ap, cfg, _layer(cache["self"], i), lengths, fmt, ring),
            lambda x, ap, c: _cross_attn_decode(
                x, ap, cfg, _layer(cache["cross"], c), src_len, fmt))
        return _decode_logits(params, h, cache, lengths)
    if cfg.family in ("ssm", "hybrid"):
        # the SSM states and the shared block's caches, updated in place
        step = (ssm_mod.mamba1_decode if cfg.family == "ssm"
                else ssm_mod.mamba2_decode)
        sh, sc = cache["ssm_h"], cache["ssm_conv"]
        for i, lp, r in _ssm_layers(params, cfg):
            h, (h1, c1) = step(h, lp, cfg, (sh[i], sc[i]))
            sh[i].copy_(h1)
            sc[i].copy_(c1)
            if r is not None:
                h = _self_attn_decode(h, params["shared_attn"], cfg,
                                      _layer(cache["self"], r), lengths,
                                      fmt, ring)
                h = swiglu_block(h, params["shared_mlp"])
        return _decode_logits(params, h, cache, lengths)
    for i, lp in enumerate(_layers(params["layers"])):
        lc = _layer(cache["self"], i)
        h = _self_attn_decode(h, lp["attn"], cfg, lc, lengths, fmt, ring)
        h, _ = _ffn(h, lp, cfg)
    return _decode_logits(params, h, cache, lengths)


def _decode_logits(params, h, cache, lengths):
    """The step's logits (B, V) f32; advances the cache's lengths."""
    h = rms_norm(h[:, 0], params["final_ln"])
    logits = (h @ params["unembed"]).to(f32)
    cache["lengths"] = lengths + 1
    return logits, cache


@torch.no_grad()
def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            aux_inputs=None, *, cache_len: int = 0):
    """Bulk-process a prompt: returns (last-token logits, populated cache).

    Runs the parallel forward (blocked attention, the SSM families'
    chunked scans) and writes each attention layer's cache whole into a
    preallocated buffer (no scatter: the paper's whole-block-write
    discipline), each cross-attention block's K/V of the source likewise
    (``aux_inputs``: the encdec family's ``"frames"``, the VLM's
    ``"image_embeds"``), and each SSM layer's last state and conv state.
    ``cache_len`` pads the KV cache for later decode steps (defaults to the
    prompt length); a sliding-window cache is padded up to ``window`` slots
    at most.
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
    cache = {"lengths": act_sharding.full((B,), S, ("batch",),
                                          dtype=torch.int32, device=dev)}

    def cross_and_cache(h, ap, src, layer_cache):
        """Cross-attention over the source (no RoPE, no mask); its K/V
        written whole into ``layer_cache`` (the reference projects them
        twice, for the cache and for the attention: the same bits)."""
        hn = rms_norm(h, ap["ln"])
        Hkv, hd = cfg.num_kv_heads, cfg.hd
        Ss = src.shape[1]
        q = (hn @ ap["wq"]).reshape(B, S, cfg.num_heads, hd)
        k = (src @ ap["wk"]).reshape(B, Ss, Hkv, hd)
        v = (src @ ap["wv"]).reshape(B, Ss, Hkv, hd)
        kv.build_cache(k, v, fmt, out=layer_cache)
        o = blocked_attention(q, k, v, causal=False, chunk_q=cfg.attn_chunk,
                              chunk_k=min(cfg.attn_chunk, Ss))
        return h + o.reshape(B, S, -1) @ ap["wo"]

    def attn_and_cache(h, ap, layer_cache):
        """Self-attention over the prompt; its K/V written whole into
        ``layer_cache``."""
        hn = rms_norm(h, ap["ln"])
        q, k, v = attention_qkv(hn, ap, cfg, positions=positions)
        o = blocked_attention(q, k, v, causal=True, window=cfg.window,
                              chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk)
        kv.build_cache(k, v, fmt, cache_len=c_len, ring=ring,
                       out=layer_cache)
        _, _, H, hd = q.shape
        return h + o.reshape(B, S, H * hd) @ ap["wo"]

    if cfg.family in ("ssm", "hybrid"):
        cache.update(_ssm_state(cfg, B, dev))
        if cfg.family == "hybrid":
            cache["self"] = kv.init_cache(fmt, kv_layers(cfg), B,
                                          cfg.num_kv_heads, n_slots, cfg.hd,
                                          device=dev)
        seq = _ssm_seq(cfg)
        for i, lp, r in _ssm_layers(params, cfg):
            h, (h1, c1) = seq(h, lp, cfg, return_state=True)
            cache["ssm_h"][i].copy_(h1)
            cache["ssm_conv"][i].copy_(c1)
            if r is not None:
                h = attn_and_cache(h, params["shared_attn"],
                                   _layer(cache["self"], r))
                h = swiglu_block(h, params["shared_mlp"])
    elif cfg.family in ("encdec", "vlm"):
        src = _cross_src(params, cfg, aux_inputs, h.dtype, B)
        cache["self"] = kv.init_cache(fmt, cfg.num_layers, B,
                                      cfg.num_kv_heads, n_slots, cfg.hd,
                                      device=dev)
        # unpadded (cross_len positions), as the reference's prefill builds
        # it
        cache["cross"] = kv.init_cache(fmt, cross_layers(cfg), B,
                                       cfg.num_kv_heads, src.shape[1],
                                       cfg.hd, device=dev)
        h = _decoder(
            params, cfg, h,
            lambda x, ap, i: attn_and_cache(x, ap, _layer(cache["self"], i)),
            lambda x, ap, c: cross_and_cache(x, ap, src,
                                             _layer(cache["cross"], c)))
    else:
        cache["self"] = kv.init_cache(fmt, cfg.num_layers, B,
                                      cfg.num_kv_heads, n_slots, cfg.hd,
                                      device=dev)
        for i, lp in enumerate(_layers(params["layers"])):
            h = attn_and_cache(h, lp["attn"], _layer(cache["self"], i))
            h, _ = _ffn(h, lp, cfg)
    h_last = rms_norm(h[:, -1], params["final_ln"])
    logits = (h_last @ params["unembed"]).to(f32)
    return logits, cache
