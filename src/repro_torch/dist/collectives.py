"""Wire-byte accounting of the sharded matvec's collectives.

The port's copy of the byte helpers of ``repro/dist/collectives.py`` that
operator planning prices with (:meth:`~repro_torch.sparse.plan.OperatorPlan.
matvec_wire_bytes`): the per-device payload of a neighbour exchange and of
a ring all-gather, plain or FRSZ2-coded.  The collectives themselves come
with the multi-GPU solve (slice 6 of the port).
"""
from __future__ import annotations

import torch

from repro_torch.core import frsz2 as F

__all__ = ["WIRE_SPEC", "exchange_bytes", "gather_bytes", "halo_wire_spec"]

#: wire codec: frsz2_16 over 128-value blocks (2 B codes + 4 B/128 exps)
WIRE_SPEC = F.FrszSpec(bs=128, l=16, dtype=torch.float32)


def halo_wire_spec(dtype) -> F.FrszSpec:
    """Wire codec for halo strips: frsz2 at *half* the operand width.

    Halo values feed the operator, so they ride a higher-fidelity codec than
    the dots' partial sums: frsz2_32 for f64 operands, frsz2_16 for f32.
    """
    if dtype == torch.float64:
        return F.FrszSpec(bs=128, l=32, dtype=torch.float64)
    return WIRE_SPEC


def exchange_bytes(sizes, *, compressed: bool = False,
                   plain_itemsize: int = 8, dtype=torch.float64) -> int:
    """Per-device wire payload of one exchange shipping ``sizes`` buffers.

    ``sizes`` is the per-collective operand length, the values one device
    *sends* in each: per-hop strips twice (once per direction) for the 1-D
    halo, per-round buffer lengths for the 3-D face exchange.  Compressed
    buffers ride :func:`halo_wire_spec` for ``dtype`` and pay FRSZ2's
    whole-block granularity per buffer (a 1-value corner still ships a
    128-code block).
    """
    if compressed:
        spec = halo_wire_spec(dtype)
        return sum(F.storage_nbytes(int(s), spec) for s in sizes)
    return int(sum(int(s) for s in sizes)) * plain_itemsize


def gather_bytes(n_local: int, n_shards: int, *,
                 plain_itemsize: int = 8) -> int:
    """Per-device wire payload of one tiled ring all-gather: each device
    transmits (and receives) ``n_shards - 1`` chunks, not just its own."""
    return (n_shards - 1) * n_local * plain_itemsize
