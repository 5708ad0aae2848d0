"""Sparse formats (CSR/ELL) and the synthetic CFD problem suite."""
from repro_torch.sparse.csr import CSR, ELL, csr_from_coo
from repro_torch.sparse.problems import (
    PROBLEMS,
    make_problem,
    problem_suite,
    rhs_for,
)

__all__ = [
    "CSR", "ELL", "csr_from_coo",
    "PROBLEMS", "make_problem", "problem_suite", "rhs_for",
]
