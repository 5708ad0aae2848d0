"""Analytic HBM-traffic model: what a well-fused execution must move.

The port of ``repro/roofline/analytic.py``, the same arithmetic on the
port's ``ArchConfig`` / ``ShapeConfig`` and ``kvcache.cache_format``.  The
dry run counts every op's operands and results
(``roofline.analysis.CostMode``), so its bytes over-count activation
traffic (every bf16<->f32 convert materializes).  This module computes the
complementary *floor*: the bytes a perfectly-fused execution must still
move per device per step.  The dry run reports both (``bytes_per_dev``
upper / ``bytes_model_per_dev`` floor).

Model (per device, per step), with TP = mesh 'model' size, chips = mesh
size, P = total param count, dtype = 2 B (bf16 weights):

train:
  weights   = mb · 3 · P·2 / TP          (fwd + dgrad + wgrad reads of the
                                          TP-sharded, FSDP-gathered weights)
            + mb · P·2 / TP              (writing the per-microbatch gather)
  optimizer = P/chips · (4·2 + 8·2 + 4)  (grad r/w f32, m+v r/w, param upd)
  acts      = L_eff · tok_loc · d · 4 · (w_fwd + w_remat + w_bwd)
              where the per-pass working-set widths count q,k,v,o, the two
              ffn projections and the residual (flash attention: no S² term)
  loss      = 2 · tok_loc · V/TP · 4     (logit chunk write+read per mb)

prefill:  weights once (amortized over tokens), acts fwd-only,
          + compressed-cache write (the paper's memory saving shows here)
decode:   weights + FULL cache read (the stream FRSZ2 compresses)
          + one-slot cache write + logits
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.kvcache import cache_format

__all__ = ["bytes_model"]


def _act_width(cfg: ArchConfig) -> float:
    """Per-token f32 words moved per layer per fwd pass, in units of d."""
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        base = (2 * di + 2 * di + 2 * d) / d       # in/out proj + residual
        if cfg.family == "hybrid":
            base += (4 * d + 3 * cfg.d_ff / 4) / d / cfg.attn_every
        return base
    attn = 4.0                                      # q, k, v, o (flash fused)
    ffn = 3.0 * cfg.d_ff / d                        # wg, wi products + down
    if cfg.family == "moe":
        ffn = 3.0 * cfg.d_ff / d * cfg.top_k + 2.0  # routed acts + dispatch
    res = 2.0
    extra = 1.0 if cfg.family in ("encdec", "vlm") else 0.0  # cross-attn o
    return attn + ffn + res + extra


def _params_bytes(cfg: ArchConfig) -> float:
    return cfg.param_count() * 2.0                  # bf16 weights


def _cache_bytes_total(cfg: ArchConfig, shape: ShapeConfig) -> float:
    fmt = cache_format(cfg.kv_format)
    B, S = shape.global_batch, shape.seq_len
    D, Hkv = cfg.hd, cfg.num_kv_heads
    bpv = fmt.bits_per_value(D) / 8.0
    Sc = min(cfg.window, S) if cfg.window else S
    per_layer = 2.0 * B * Hkv * Sc * D * bpv
    if cfg.family in ("dense", "moe"):
        n_attn = cfg.num_layers
    elif cfg.family == "encdec":
        n_attn = cfg.num_layers                      # self caches
        per_cross = 2.0 * B * Hkv * cfg.encoder_seq * D * bpv
        return n_attn * per_layer + cfg.num_layers * per_cross
    elif cfg.family == "vlm":
        n_attn = cfg.num_layers
        R = cfg.num_layers // cfg.cross_attn_every
        per_cross = 2.0 * B * Hkv * cfg.num_image_tokens * D * bpv
        return n_attn * per_layer + R * per_cross
    elif cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
    else:                                            # ssm: recurrent state
        return (cfg.num_layers * B * (cfg.d_inner * cfg.ssm_state
                                      if cfg.mamba_version == 1
                                      else cfg.d_inner * cfg.ssm_state)
                * 4.0)
    return n_attn * per_layer


def bytes_model(cfg: ArchConfig, shape: ShapeConfig, *, chips: int,
                tp: int, mb: int = 0) -> float:
    """Analytic well-fused HBM bytes per device per step."""
    B, S = shape.global_batch, shape.seq_len
    P2 = _params_bytes(cfg)
    L = cfg.num_layers + cfg.encoder_layers
    d = cfg.d_model
    V = cfg.vocab_size

    if shape.kind == "train":
        mb = mb or cfg.microbatch
        tok_loc = B * S / (chips / tp)              # tokens per model-group
        tok_dev = B * S / chips
        weights = mb * 4.0 * P2 / tp
        optimizer = (cfg.param_count() / chips) * (4 * 2 + 8 * 2 + 4.0)
        acts = (L * (B * S / chips) * d * 4.0
                * (_act_width(cfg) * 2.0 + 2.0))    # fwd+remat, ckpt r/w
        loss = 2.0 * mb * (B * S / mb / chips) * 4.0 * min(V, 4096)
        return weights + optimizer + acts + loss

    if shape.kind == "prefill":
        weights = 2.0 * P2 / tp
        acts = L * (B * S / chips) * d * 4.0 * _act_width(cfg)
        cache_w = _cache_bytes_total(cfg, shape) / chips
        return weights + acts + cache_w

    # decode / long_decode: the FRSZ2 target — weights + full cache stream
    weights = (cfg.active_param_count() * 2.0) / tp \
        if cfg.family == "moe" and B < 64 else P2 / tp
    cache_r = _cache_bytes_total(cfg, shape) / chips
    logits = B * V * 4.0 / chips
    token_io = 8.0 * B * d * L / chips
    return weights + cache_r + logits + token_io
