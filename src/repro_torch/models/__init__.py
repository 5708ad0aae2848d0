"""Model zoo: the config system, and the training loss and serving path of
the dense, MoE, SSM, hybrid, encoder-decoder and VLM families."""
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.lm import (
    decode_step,
    init_decode_cache,
    init_params,
    loss_fn,
    prefill,
    trunk,
)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "decode_step",
           "init_decode_cache", "init_params", "loss_fn", "prefill", "trunk"]
