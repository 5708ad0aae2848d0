"""GMRES(m) / CB-GMRES with Accessor-backed compressed Krylov basis."""
from repro_torch.solver.block import gmres_block
from repro_torch.solver.gmres import (
    GmresResult,
    cb_gmres,
    clear_graph_cache,
    gmres,
    gmres_batched,
)
from repro_torch.solver.pipeline import (
    AdaptivePolicy,
    BlockCGS2Orthogonalizer,
    BlockMGSOrthogonalizer,
    BlockOrthogonalizer,
    CGS2Orthogonalizer,
    CallablePreconditioner,
    IdentityPreconditioner,
    JacobiPreconditioner,
    MGSOrthogonalizer,
    Orthogonalizer,
    PrecisionPolicy,
    Preconditioner,
    StaticPolicy,
    block_orthogonalizer_by_name,
    block_qr,
    orthogonalizer_by_name,
    policy_by_name,
)
