"""Distribution layer: the solver's reduction context (local only so far)
and the wire-byte accounting of the sharded matvec's collectives."""
from repro_torch.dist import collectives, context
from repro_torch.dist.context import LOCAL, DistContext

__all__ = ["collectives", "context", "DistContext", "LOCAL"]
