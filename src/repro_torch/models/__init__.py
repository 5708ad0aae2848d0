"""Model zoo: the config system and the serving path of the dense, MoE,
SSM and hybrid families."""
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.lm import (
    decode_step,
    init_decode_cache,
    init_params,
    prefill,
    trunk,
)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "decode_step",
           "init_decode_cache", "init_params", "prefill", "trunk"]
