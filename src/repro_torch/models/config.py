"""Architecture configuration of the LM families (the port's own copy).

One dataclass covers the ten architectures of the JAX package's registry:
dense GQA/MQA decoders, MoE, encoder-decoder, VLM, SSM and hybrid, all of
which the port runs (``repro_torch.models.lm``).  ``.reduced()`` derives
the CPU test variant.

The paper's technique enters through ``kv_format``: the decode-time KV
cache is stored FRSZ2-compressed (block size = head_dim, one ``e_max`` per
(position, kv-head) — a block is always produced whole at append time, so
the paper's whole-block-write constraint holds by construction).

``dtype`` stays a string, as in the JAX package; :func:`torch_dtype` maps
it to a torch dtype.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype names)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}"
                         ) from None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024           # tokens per dispatch group

    # -- attention ------------------------------------------------------------
    window: int = 0                 # sliding-window size; 0 = full attention
    rope_theta: float = 1e4

    # -- SSM (mamba) ------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 0          # 1 | 2
    ssm_head_dim: int = 64          # mamba2 head size P
    attn_every: int = 0             # hybrid: shared attn after every k SSM layers
    ssm_chunk: int = 128            # scan chunk length

    # -- encoder-decoder --------------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0            # whisper: 1500 frames (stub embeddings)

    # -- VLM ----------------------------------------------------------------------
    cross_attn_every: int = 0       # a cross-attn layer after every k self layers
    num_image_tokens: int = 0       # stub patch embeddings

    # -- numerics / training ------------------------------------------------------
    dtype: str = "bfloat16"
    fsdp: bool = True               # shard weights' d_model axis over 'data'
    kv_format: str = "frsz2_16"     # none | bf16 | frsz2_16 | frsz2_8
    microbatch: int = 8             # gradient-accumulation steps per train step
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save MXU outputs)
    attn_chunk: int = 1024          # blocked-attention tile (train/prefill)
    decode_chunk: int = 1024        # KV chunk for decode attention
    unroll: bool = False            # unroll all scans (cost-probe compiles)

    # ---------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def supports_shape(self, shape: ShapeConfig) -> bool:
        return self.sub_quadratic or shape.kind != "long_decode"

    def param_count(self) -> int:
        """Approximate total parameters (embeddings included)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, Hkv, hd = self.num_heads, self.num_kv_heads, self.hd
        n = 2 * V * d  # embed + unembed
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d

        def dense_ffn():
            return 3 * d * ff

        if self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            dt_rank = max(1, d // 16)
            per = (d * 2 * di + di * self.ssm_conv + di * (dt_rank + 2 * N)
                   + dt_rank * di + di * N + di + di * d)
            n += L * (per + 2 * d)
        elif self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            Hs = di // self.ssm_head_dim
            per = (d * 2 * di + di * self.ssm_conv + di * (2 * N + 2 * Hs)
                   + Hs + di + di * d)
            n += L * (per + 2 * d)
            n += attn + dense_ffn() + 2 * d  # one shared attention block
        elif self.family == "moe":
            moe = d * self.num_experts + 3 * self.num_experts * d * ff
            n += L * (attn + moe + 2 * d)
        elif self.family == "encdec":
            n += (L + self.encoder_layers) * (attn + dense_ffn() + 2 * d)
            n += L * (attn + d)  # decoder cross-attention
        elif self.family == "vlm":
            n_cross = L // max(self.cross_attn_every, 1)
            n += L * (attn + dense_ffn() + 2 * d)
            n += n_cross * (attn + d)
        else:
            n += L * (attn + dense_ffn() + 2 * d)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if self.family != "moe" or not self.num_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        dead = L * 3 * d * ff * (self.num_experts - self.top_k)
        return self.param_count() - dead

    def reduced(self) -> ArchConfig:
        """Smoke-test configuration: same family/topology, tiny dims."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4 if self.attn_every == 0
                           else 2 * self.attn_every + 1),
            d_model=256,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    2 if self.num_kv_heads > 1 else 1)),
            d_ff=512,
            vocab_size=512,
            head_dim=64 if self.head_dim else 0,
            num_experts=min(self.num_experts, 4),
            moe_group=64,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            cross_attn_every=min(self.cross_attn_every, 2)
            if self.cross_attn_every else 0,
            num_image_tokens=min(self.num_image_tokens, 32),
            window=min(self.window, 64) if self.window else 0,
            microbatch=1,
            attn_chunk=64,
            decode_chunk=64,
            ssm_chunk=16,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}
