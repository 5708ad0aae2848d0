"""Sparse formats (CSR/ELL), operator planning (reordering, padding, halo
probing, 3-D block partitioning), the row-partitioned matvec of the sharded
solve and the synthetic CFD problem suite."""
from repro_torch.sparse.csr import CSR, ELL, csr_from_coo
from repro_torch.sparse.halo_probe import (
    BlockPartition,
    HaloProbe,
    block_partition,
    factor_pgrid,
    grid_of,
    halo_probe,
)
from repro_torch.sparse.plan import OperatorPlan, plan_operator
from repro_torch.sparse.problems import (
    PROBLEMS,
    make_problem,
    problem_suite,
    rhs_for,
)
from repro_torch.sparse.reorder import permute_csr, rcm_permutation
from repro_torch.sparse.shard import partition_matvec

__all__ = [
    "CSR", "ELL", "csr_from_coo",
    "BlockPartition", "HaloProbe", "block_partition", "factor_pgrid",
    "grid_of", "halo_probe",
    "OperatorPlan", "plan_operator",
    "PROBLEMS", "make_problem", "problem_suite", "rhs_for",
    "permute_csr", "rcm_permutation", "partition_matvec",
]
