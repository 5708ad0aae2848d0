"""DistContext: the solver's single hook for distributed reductions.

The port of ``repro/dist/context.py``.  The GMRES cycles compute every norm
and every reduced sum through one small object.  The local context
(:data:`LOCAL`, the default) is the plain local computation, bit-identical
to the unsharded solve.  A sharded context (``sharded=True``) is held by
every rank of a ``torch.distributed`` group, in place of the
reference's bound mesh axis: each vector is this rank's chunk of a
row-partitioned vector, and norms become all-reduced sums of local squares.
Every reduced value is then the same on every rank, so the ranks take the
same restart and convergence decisions and issue the same collectives.

``compressed_norms`` ships the local partial squares as FRSZ2 codes through
:func:`repro_torch.dist.collectives.compressed_psum`, the transport of the
sharded basis' dots.  For a scalar that costs more wire bytes than a plain
all-reduce (one 128-code block against 8 bytes); it exists so that a solve
can run every collective on the coded transport.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist import collectives as _collectives

__all__ = ["DistContext", "LOCAL"]


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where reductions happen: locally, or over a process group.

    ``sharded=False`` (the default) means the solver owns the full vectors
    and every reduction is local.  Otherwise each vector argument is this
    rank's chunk and reductions sum over ``group`` (``None``: the default
    group).
    """

    group: Any = None
    sharded: bool = False
    compressed_norms: bool = False

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Global sum of an already locally reduced value (any shape)."""
        if not self.sharded:
            return x
        if self.compressed_norms:
            return _collectives.compressed_psum(x, self.group)
        return _collectives.psum(x, self.group)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """||x|| of the (possibly row-partitioned) vector ``x``, a 0-d
        tensor on x's device."""
        if not self.sharded:
            return torch.linalg.vector_norm(x)
        return torch.sqrt(self.sum(torch.sum(torch.square(x))))

    def col_norms(self, X: torch.Tensor) -> torch.Tensor:
        """``||X[b]||`` for each row-stacked vector of a block ``X (p, n)``:
        one reduction of ``p`` partial squares."""
        if not self.sharded:
            return torch.linalg.vector_norm(X, dim=1)
        return torch.sqrt(self.sum(torch.sum(torch.square(X), dim=-1)))

    def spec(self) -> tuple:
        """Hashable identity for the captured-cycle cache."""
        if not self.sharded:
            return ("dist", None)
        return ("dist", "world" if self.group is None else id(self.group),
                self.compressed_norms)


#: the default, single-device context: every reduction is local.
LOCAL = DistContext()
