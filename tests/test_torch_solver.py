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
    ("synth:atmosmod", dict(storage="float16")),
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("call", ["host", "device", "vmap-host",
                                  "vmap-device", "block-host",
                                  "block-device"])
def test_zero_rhs_converges_at_first_restart(call, dtype):
    """b = 0: x = 0, converged in 0 iterations at the first restart, on
    every driver and batched method (the block method's ``bn_safe``), in
    f64 and in f32 arithmetic (where 1e-300 would round to 0)."""
    _, At, b, target = _problem("synth:atmosmod")
    zero = torch.zeros(b.shape, dtype=dtype)
    kw = dict(storage="frsz2_32", m=20, target_rrn=target)
    if "-" in call:
        method, driver = call.split("-")
        res = gmres_batched(At, torch.stack([zero, zero, zero]),
                            method=method, driver=driver, **kw)
    else:
        res = [gmres(At, zero, driver=call, **kw)]
    for r in res:
        assert r.converged and not r.stagnated
        assert (r.iterations, r.restarts) == (0, 1)
        assert r.rrn == 0.0 and r.bytes_read == 0.0
        assert torch.equal(r.x, torch.zeros_like(zero))


@pytest.mark.parametrize("driver", ["host", "device"])
def test_jax_reference_returns_nan_for_zero_rhs(driver):
    """The reference divides by ||b|| = 0 (``repro/solver/gmres.py``
    ``_restart_loop``): it runs to ``max_iters`` and returns x of NaN,
    unconverged.  The port returns x = 0, converged (the test above)."""
    A, _, b, target = _problem("synth:atmosmod")
    rj = jgmres(A, jnp.zeros_like(jnp.asarray(b)), m=20, max_iters=40,
                target_rrn=target, driver=driver, storage="frsz2_32")
    assert not bool(rj.converged) and rj.iterations == 40
    assert np.isnan(np.asarray(rj.x)).all()


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
