"""The slice as a whole: the port's GMRES against the JAX host driver.

Both solve the same operator with the same right-hand side (JAX's
``rhs_for`` output, handed over as numpy, so an ulp of ``sin`` cannot split
them).  Tolerances:
* ``converged`` and ``stagnated``: equal;
* ``iterations``: within 1.  The two packages sum the same products in
  another order, which can move a borderline restart by one iteration (the
  precedent the JAX package set for its block3d partitioning);
* when the iterations agree: ``restarts``, ``bytes_read`` and ``op_reads``
  exactly equal, ``restart_rrns`` to 1e-8 relative above an absolute floor
  of 1e-14, ``x`` to 1e-9 relative.  The floor is the f64 rounding of
  forming ``b - A x`` itself (about n·eps·||A||·||x||/||b||): a restart RRN
  of 8e-10 is only resolved to about 2e-7 of itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solver import gmres as jgmres
from repro.sparse import make_problem as jmake
from repro.sparse import rhs_for as jrhs
from repro_torch.convert import csr_from_numpy
from repro_torch.solver import cb_gmres, gmres, gmres_batched

torch.set_num_threads(2)

CASES = [
    ("synth:atmosmod", dict(storage="float64")),
    ("synth:atmosmod", dict(storage="float32")),
    ("synth:atmosmod", dict(storage="frsz2_32")),
    ("synth:atmosmod", dict(storage="frsz2_16")),
    ("synth:atmosmod", dict(storage="mixed:2:frsz2_32")),
    ("synth:atmosmod", dict(storage="frsz2_32", ortho="cgs2")),
    ("synth:atmosmod", dict(policy="adaptive:auto")),
    ("synth:varcoef", dict(storage="frsz2_32", precond="jacobi")),
]


def _problem(name, n=512):
    A, target = jmake(name, n)
    b, _ = jrhs(A)
    At = csr_from_numpy(np.asarray(A.indptr), np.asarray(A.indices),
                        np.asarray(A.data), A.shape, device="cpu")
    return A, At, np.array(b), target


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{p}-{'-'.join(map(str, k.values()))}"
                              for p, k in CASES])
def test_port_matches_jax_host_driver(name, kw):
    A, At, b, target = _problem(name)
    rj = jgmres(A, jnp.asarray(b), m=40, target_rrn=target, driver="host",
                **kw)
    rt = gmres(At, torch.from_numpy(b), m=40, target_rrn=target, **kw)
    assert rt.converged == bool(rj.converged)
    assert rt.stagnated == bool(rj.stagnated)
    assert abs(rt.iterations - rj.iterations) <= 1, (rt.iterations,
                                                     rj.iterations)
    if rt.iterations == rj.iterations:
        assert rt.restarts == rj.restarts
        assert rt.bytes_read == rj.bytes_read
        assert rt.op_reads == rj.op_reads
        np.testing.assert_allclose(rt.restart_rrns, rj.restart_rrns,
                                   rtol=1e-8, atol=1e-14)
        xj = np.asarray(rj.x)
        assert (np.linalg.norm(rt.x.numpy() - xj)
                <= 1e-9 * np.linalg.norm(xj))
        assert rt.rrn_history.shape == np.asarray(rj.rrn_history).shape


def test_budget_and_trivial_rhs_edges():
    A, At, b, target = _problem("synth:atmosmod", 64)
    for max_iters in (0, 5):
        rj = jgmres(A, jnp.asarray(b), m=10, max_iters=max_iters,
                    target_rrn=target, driver="host", storage="frsz2_32")
        rt = cb_gmres(At, torch.from_numpy(b), m=10, max_iters=max_iters,
                      target_rrn=target)
        assert (rt.iterations, rt.restarts) == (rj.iterations, rj.restarts)
        assert rt.op_reads == rj.op_reads and rt.bytes_read == rj.bytes_read
        np.testing.assert_allclose(rt.rrn, float(rj.rrn), rtol=1e-10)
    # x0 already the solution: converged at the first restart residual
    x0 = np.linalg.solve(np.asarray(A.to_dense()), b)
    rt = gmres(At, torch.from_numpy(b), x0=torch.from_numpy(x0),
               storage="frsz2_32", m=10, target_rrn=1e-10)
    assert rt.converged and rt.iterations == 0 and rt.restarts == 1


def test_unported_options_raise_naming_the_roadmap():
    _, At, b, _ = _problem("synth:atmosmod", 64)
    bt = torch.from_numpy(b)
    for kw in (dict(shard=2), dict(reorder="rcm")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gmres(At, bt, **kw)
    for kw in (dict(shard=2), dict(reorder="rcm")):
        for method in ("vmap", "block"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                gmres_batched(At, bt[None], method=method, **kw)
    with pytest.raises(ValueError):
        gmres(At, bt, reorder="sideways")
    with pytest.raises(ValueError):
        gmres(At, bt, driver="warp")
