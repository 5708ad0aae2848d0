"""GMRES(m) / CB-GMRES with Accessor-backed compressed Krylov basis."""
from repro_torch.solver.gmres import GmresResult, cb_gmres, gmres, gmres_batched
from repro_torch.solver.pipeline import (
    AdaptivePolicy,
    CGS2Orthogonalizer,
    CallablePreconditioner,
    IdentityPreconditioner,
    JacobiPreconditioner,
    MGSOrthogonalizer,
    Orthogonalizer,
    PrecisionPolicy,
    Preconditioner,
    StaticPolicy,
    orthogonalizer_by_name,
    policy_by_name,
)
