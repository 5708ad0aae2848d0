"""Distribution layer: the solver's reduction context (local only so far)."""
from repro_torch.dist import context
from repro_torch.dist.context import LOCAL, DistContext

__all__ = ["context", "DistContext", "LOCAL"]
