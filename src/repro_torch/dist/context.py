"""DistContext: the solver's single hook for distributed reductions.

The GMRES cycle computes every vector norm through one small object instead
of calling ``torch.linalg.vector_norm`` directly, so that a sharded context
can later turn norms into all-reduced sums of local squares without touching
the cycle.  This slice has the local context only: every reduction is the
plain local computation.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DistContext", "LOCAL"]


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where reductions happen.  Only the local context exists so far: the
    solver owns the full vectors and every reduction is local."""

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """||x|| of the vector ``x`` (a 0-d tensor on x's device)."""
        return torch.linalg.vector_norm(x)

    def col_norms(self, X: torch.Tensor) -> torch.Tensor:
        """``||X[b]||`` for each row-stacked vector of a block ``X (p, n)``."""
        return torch.linalg.vector_norm(X, dim=1)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Global sum of an already locally reduced value: itself, here."""
        return x


#: the default, single-device context: every reduction is local.
LOCAL = DistContext()
