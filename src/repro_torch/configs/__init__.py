"""Per-architecture configs (the assigned pool of the JAX package)."""
from repro_torch.configs.registry import ARCHS, SHAPES, arch_names, get_arch

__all__ = ["ARCHS", "SHAPES", "arch_names", "get_arch"]
