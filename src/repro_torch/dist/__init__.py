"""Distribution layer: the solver's reduction context, the sharded solve's
collectives (plain or FRSZ2-coded) and their wire-byte accounting, and the
process-per-rank launch helpers."""
from repro_torch.dist import collectives, context, launch
from repro_torch.dist.collectives import (
    compressed_pmean,
    compressed_psum,
    gather_bytes,
    gather_operand,
    halo_exchange,
    halo_exchange_3d,
    halo_wire_spec,
    psum,
    reduce_bytes,
)
from repro_torch.dist.context import LOCAL, DistContext
from repro_torch.dist.launch import init_rank, spawn

__all__ = ["collectives", "context", "launch", "DistContext", "LOCAL",
           "compressed_pmean", "compressed_psum", "gather_bytes",
           "gather_operand", "halo_exchange", "halo_exchange_3d",
           "halo_wire_spec", "psum", "reduce_bytes", "init_rank", "spawn"]
