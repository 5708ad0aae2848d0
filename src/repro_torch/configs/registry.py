"""The architecture registry (the port's own copy of the JAX package's).

Ten published configurations; sources are cited per entry.  The frontend
stubs of whisper (conv audio) and llama-3.2 vision give precomputed
embeddings whose token counts the reference rounded to a multiple of 128
(1500 -> 1536 frames, 1601 -> 1664 patches).  The port serves every
family of the registry (``repro_torch.models.lm``): dense, MoE, SSM,
hybrid, encoder-decoder and VLM.
"""
from __future__ import annotations

from repro_torch.models.config import SHAPES, ArchConfig

__all__ = ["ARCHS", "get_arch", "SHAPES", "arch_names", "cells"]


ARCHS = {
    # — dense GQA —
    "internlm2-20b": ArchConfig(                  # [arXiv:2403.17297; hf]
        name="internlm2-20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92544, rope_theta=1e6,
        microbatch=16,                            # v5e HBM fit (EXPERIMENTS)
    ),
    "yi-9b": ArchConfig(                          # [arXiv:2403.04652; hf]
        name="yi-9b", family="dense",
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, rope_theta=1e4,
    ),
    "granite-20b": ArchConfig(                    # [arXiv:2405.04324; hf]
        name="granite-20b", family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152, rope_theta=1e4,
        microbatch=16,                            # v5e HBM fit (EXPERIMENTS)
    ),
    "mistral-nemo-12b": ArchConfig(      # [hf:mistralai/Mistral-Nemo-Base-2407]
        name="mistral-nemo-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1e6,
    ),
    # — audio enc-dec (conv frontend stubbed: 1500 frames -> 1536 aligned) —
    "whisper-medium": ArchConfig(                 # [arXiv:2212.04356]
        name="whisper-medium", family="encdec",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865,
        encoder_layers=24, encoder_seq=1536,
    ),
    # — MoE —
    "mixtral-8x22b": ArchConfig(                  # [arXiv:2401.04088; hf]
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        num_experts=8, top_k=2, window=4096, rope_theta=1e6,
        microbatch=16,                            # HBM fit; see EXPERIMENTS
    ),
    "llama4-scout-17b-a16e": ArchConfig(  # [hf:meta-llama/Llama-4-Scout-17B-16E]
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        num_experts=16, top_k=1, rope_theta=5e5,
        microbatch=16,                            # HBM fit; see EXPERIMENTS
    ),
    # — VLM (vision frontend stubbed: 1601 patches -> 1664 aligned) —
    "llama-3.2-vision-11b": ArchConfig(           # [hf:meta-llama/Llama-3.2-11B-Vision]
        name="llama-3.2-vision-11b", family="vlm",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        cross_attn_every=5, num_image_tokens=1664, rope_theta=5e5,
    ),
    # — SSM (attention-free) —
    "falcon-mamba-7b": ArchConfig(                # [arXiv:2410.05355]
        name="falcon-mamba-7b", family="ssm",
        num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=65024,
        ssm_state=16, ssm_conv=4, ssm_expand=2, mamba_version=1,
    ),
    # — hybrid: mamba2 body + ONE shared attention block every 6 layers —
    "zamba2-7b": ArchConfig(                      # [arXiv:2411.15242]
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        ssm_state=64, ssm_conv=4, ssm_expand=2, mamba_version=2,
        ssm_head_dim=64, attn_every=6,
    ),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def arch_names():
    return sorted(ARCHS)


def cells():
    """All assigned (arch × shape) dry-run cells, honoring documented skips."""
    for aname in arch_names():
        cfg = ARCHS[aname]
        for sname, shp in SHAPES.items():
            if not cfg.supports_shape(shp):
                continue  # long_500k on pure full-attention archs
            yield aname, sname
