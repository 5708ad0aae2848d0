"""The port's RCM reordering and reordered solves against the JAX package's.

Tolerances:
* ``rcm_permutation``, ``inverse_permutation``, ``permute_csr``'s arrays,
  ``fingerprint``/``bandwidth`` (CSR and ELL), error messages: exact
  (``np.array_equal``; every tie-break of the reference's BFS kept);
* reordered solves, port ``rcm`` against JAX ``rcm`` (host drivers, and
  the port's device driver): ``converged``, ``iterations``, ``restarts``,
  ``bytes_read`` and ``op_reads`` equal, ``x`` within 1e-9 relative (the
  same operator, products summed in another order);
* port ``rcm`` against port ``none``: equal iterations and restarts, ``x``
  within 1e-9 relative, RRN within 1e-5 relative (a permutation only
  changes the reduction order inside norms and dots), as
  ``tests/test_reorder.py`` holds the reference.  With an FRSZ2 basis the
  RRNs need only both meet the target: its block exponents are taken over
  consecutive entries, which the permutation regroups (the final RRNs of a
  512-row frsz2_32 solve differ by about 1 %).
* the batched block method (``test_rcm_batched_matches_reference``):
  iterations within one of JAX ``rcm`` and of port ``none``; ``restarts``
  and ``bytes_read`` equal where the iterations agree, ``restarts``
  within one and the restart RRNs within 1e-6 relative where they
  overlap everywhere, and each side's ``bytes_read`` the reference's
  model of the iterations it ran (``_cycle_row_reads``).  On the CPU the
  port's block contractions are MKL matrix products, whose summation
  order MKL picks by the host's instruction set, and this solve's restart
  is borderline: on an AVX-512 host the port ``rcm`` solve stops at 29
  iterations with an RRN of 9.12e-14 against the target 1e-13, and at 30
  (4.04e-14) when MKL is pinned to its AVX2 path (``MKL_CBWR=AVX2``), as
  the reference does on hosts with and without AVX-512 (30, 4.1e-14).
  The north star's rule for a reduction order that moves a borderline
  restart (at most one iteration, documented) applies.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.launch import solve as jsolve
from repro.solver import gmres as jgmres
from repro.solver.gmres import gmres_batched as jgmres_batched
from repro.solver.gmres import _cycle_row_reads as j_cycle_row_reads
from repro.sparse import make_problem as jmake
from repro.sparse import reorder as JR
from repro.sparse import rhs_for as jrhs
from repro.sparse.csr import csr_from_coo as jcsr_from_coo
from repro_torch.convert import csr_from_numpy
from repro_torch.core import accessor as TA
from repro_torch.solver import gmres, gmres_batched
from repro_torch.solver.pipeline import (
    CallablePreconditioner,
    JacobiPreconditioner,
)
from repro_torch.sparse import problems as TP
from repro_torch.sparse import reorder as TR
from repro_torch.sparse.csr import ELL

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(Aj):
    """The reference CSR's arrays as a port CSR on the CPU (grid kept)."""
    At = csr_from_numpy(np.asarray(Aj.indptr), np.asarray(Aj.indices),
                        np.asarray(Aj.data), Aj.shape, device="cpu")
    if hasattr(Aj, "grid"):
        At.grid = Aj.grid
    return At


def _port_ell(Ej):
    return ELL(torch.from_numpy(np.array(Ej.cols)),
               torch.from_numpy(np.array(Ej.vals)), tuple(Ej.shape))


def _random_system(seed: int):
    """``tests/test_reorder.py``'s small diagonally dominant system with
    scattered couplings, as (reference CSR, b)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 160))
    k = 4 * n
    ri = rng.integers(0, n, k)
    ci = rng.integers(0, n, k)
    off = np.unique(np.stack([ri, ci]), axis=1)
    off = off[:, off[0] != off[1]]
    vals = rng.uniform(-1.0, 1.0, off.shape[1])
    diag = np.full(n, 1.0)
    np.add.at(diag, off[0], np.abs(vals))
    d = np.arange(n)
    A = jcsr_from_coo(np.concatenate([off[0], d]),
                      np.concatenate([off[1], d]),
                      np.concatenate([vals, 2.0 * diag]), (n, n))
    return A, rng.standard_normal(n)


def _assert_csr_equal(Bt, Bj):
    assert Bt.shape == tuple(Bj.shape)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(Bt, name).numpy(),
                                      np.asarray(getattr(Bj, name)))


PROBLEMS = [("synth:unstructured", 512), ("synth:unstructured", 4096),
            ("synth:lung", 300), ("synth:atmosmod", 1000),
            ("synth:stencil27", 512), ("synth:varcoef", 216),
            ("synth:widerange", 343)]


@pytest.mark.parametrize("name,n", PROBLEMS)
def test_rcm_permutation_matches_reference(name, n):
    Aj, _ = jmake(name, n)
    At = _port(Aj)
    pj = JR.rcm_permutation(Aj)
    pt = TR.rcm_permutation(At)
    assert pt.dtype == np.int64
    np.testing.assert_array_equal(pt, pj)
    Bj = JR.permute_csr(Aj, pj)
    Bt = TR.permute_csr(At, pt)
    _assert_csr_equal(Bt, Bj)
    assert Bt.fingerprint() == Bj.fingerprint()
    assert Bt.bandwidth() == Bj.bandwidth()
    assert not hasattr(Bt, "grid")            # a permuted grid is lost


@pytest.mark.parametrize("name,n", [("synth:unstructured", 512),
                                    ("synth:lung", 300)])
def test_rcm_on_ell_operator_matches_reference(name, n):
    """ELL inputs: the pattern comes from their live entries, the permuted
    operator comes back as a CSR — both equal to the reference's."""
    Aj, _ = jmake(name, n)
    Ej = Aj.to_ell()
    Et = _port_ell(Ej)
    pj = JR.rcm_permutation(Ej)
    np.testing.assert_array_equal(TR.rcm_permutation(Et), pj)
    _assert_csr_equal(TR.permute_csr(Et, pj), JR.permute_csr(Ej, pj))
    ij, xj = JR.pattern_of(Ej)
    it, xt = TR.pattern_of(Et)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(xt, xj)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_rcm_permutation_property_random_systems(seed):
    Aj, _ = _random_system(seed)
    At = _port(Aj)
    pj = JR.rcm_permutation(Aj)
    np.testing.assert_array_equal(TR.rcm_permutation(At), pj)
    _assert_csr_equal(TR.permute_csr(At, pj), JR.permute_csr(Aj, pj))
    # several components: a block-diagonal pair of systems
    Bj, _ = _random_system(seed + 1)
    n1, n2 = Aj.shape[0], Bj.shape[0]
    indptr = np.concatenate([np.asarray(Aj.indptr),
                             np.asarray(Bj.indptr)[1:] + Aj.nnz])
    indices = np.concatenate([np.asarray(Aj.indices),
                              np.asarray(Bj.indices) + n1])
    data = np.concatenate([np.asarray(Aj.data), np.asarray(Bj.data)])
    Cj = type(Aj)(jnp.asarray(indptr, jnp.int32),
                  jnp.asarray(indices, jnp.int32), jnp.asarray(data),
                  (n1 + n2, n1 + n2))
    Ct = csr_from_numpy(indptr, indices, data, Cj.shape, device="cpu")
    np.testing.assert_array_equal(TR.rcm_permutation(Ct),
                                  JR.rcm_permutation(Cj))


def test_inverse_permutation_matches_reference():
    perm = np.random.default_rng(0).permutation(1000)
    np.testing.assert_array_equal(TR.inverse_permutation(perm),
                                  JR.inverse_permutation(perm))
    iperm = TR.inverse_permutation(perm)
    np.testing.assert_array_equal(perm[iperm], np.arange(1000))


def test_reorder_errors_match_reference():
    class MatvecOnly:
        shape = (8, 8)

        def matvec(self, x):
            return x

    with pytest.raises(ValueError) as ej:
        JR.rcm_permutation(MatvecOnly())
    with pytest.raises(ValueError) as et:
        TR.rcm_permutation(MatvecOnly())
    assert str(et.value) == str(ej.value)
    assert TR.pattern_of(MatvecOnly()) is None
    Aj, _ = jmake("synth:lung", 32)
    with pytest.raises(ValueError) as ej:
        JR.permute_csr(Aj, np.arange(5))
    with pytest.raises(ValueError) as et:
        TR.permute_csr(_port(Aj), np.arange(5))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name,n", [("synth:unstructured", 512),
                                    ("synth:atmosmod", 1000),
                                    ("synth:lung", 300)])
def test_ell_fingerprint_and_bandwidth_match_reference(name, n):
    Aj, _ = jmake(name, n)
    Ej = Aj.to_ell()
    Et = _port(Aj).to_ell()
    np.testing.assert_array_equal(Et.cols.numpy(), np.asarray(Ej.cols))
    assert Et.fingerprint() == Ej.fingerprint()
    assert Et.bandwidth() == Ej.bandwidth()
    assert Et.fingerprint() != _port(Aj).fingerprint()


def test_permute_csr_keeps_dtype_and_problem_has_one_copy():
    """f32 values keep their dtype; the problem suite scrambles
    ``synth:unstructured`` with this module's ``permute_csr`` (its own copy
    is gone) and stays bit-equal to the reference's."""
    Aj, _ = jmake("synth:unstructured", 512, dtype=np.float32)
    At = _port(Aj)
    Bt = TR.permute_csr(At, TR.rcm_permutation(At))
    assert Bt.dtype == torch.float32 and Bt.device == At.device
    assert not hasattr(TP, "_permute_csr")
    Ut, _ = TP.make_problem("synth:unstructured", 4096, device="cpu")
    _assert_csr_equal(Ut, jmake("synth:unstructured", 4096)[0])


# ---------------------------------------------------------------------------
# reordered solves
# ---------------------------------------------------------------------------


def _unstructured(n=512):
    Aj, target = jmake("synth:unstructured", n)
    b, _ = jrhs(Aj)
    return Aj, _port(Aj), np.array(b), target


@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_rcm_solve_matches_reference(storage):
    Aj, At, b, target = _unstructured()
    kw = dict(storage=storage, m=20, max_iters=2000, target_rrn=target)
    rj = jgmres(Aj, jnp.asarray(b), driver="host", reorder="rcm", **kw)
    r0 = gmres(At, torch.from_numpy(b), driver="host", reorder="none", **kw)
    for driver in ("host", "device"):
        rt = gmres(At, torch.from_numpy(b), driver=driver, reorder="rcm",
                   **kw)
        assert rt.converged == bool(rj.converged) == True  # noqa: E712
        assert rt.iterations == rj.iterations, (driver, rt.iterations,
                                                rj.iterations)
        assert rt.restarts == rj.restarts
        assert rt.bytes_read == float(rj.bytes_read)
        assert rt.op_reads == float(rj.op_reads)
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x),
                                   rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(rt.rrn, float(rj.rrn), rtol=1e-5,
                                   atol=1e-16)
        # and the unreordered port solve
        assert rt.iterations == r0.iterations
        assert rt.restarts == r0.restarts
        assert rt.bytes_read == r0.bytes_read
        np.testing.assert_allclose(rt.x.numpy(), r0.x.numpy(), rtol=1e-9,
                                   atol=1e-13)
        if storage == "float64":
            np.testing.assert_allclose(rt.rrn, r0.rrn, rtol=1e-5, atol=1e-16)
        else:
            # FRSZ2 takes a block exponent over 32 consecutive entries,
            # which RCM regroups: another compressed basis, whose final RRN
            # differs at the percent level below the target
            assert max(rt.rrn, r0.rrn) <= target


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000))
def test_rcm_solve_parity_property(seed):
    """Permute -> solve -> un-permute matches the plain f64 solve on both
    drivers (``tests/test_reorder.py::test_rcm_solve_parity_property``)."""
    Aj, b = _random_system(seed)
    At, bt = _port(Aj), torch.from_numpy(b)
    kw = dict(m=12, max_iters=600, target_rrn=1e-11, storage="float64")
    for driver in ("device", "host"):
        r0 = gmres(At, bt, driver=driver, reorder="none", **kw)
        r1 = gmres(At, bt, driver=driver, reorder="rcm", **kw)
        assert r1.iterations == r0.iterations, (driver, seed)
        assert r1.restarts == r0.restarts, (driver, seed)
        assert r1.converged == r0.converged, (driver, seed)
        np.testing.assert_allclose(r1.x.numpy(), r0.x.numpy(), rtol=1e-9,
                                   atol=1e-13)
        np.testing.assert_allclose(r1.rrn, r0.rrn, rtol=1e-5, atol=1e-16)


def _block_bytes(r, m, row_bytes):
    """The reference's modelled basis reads (``_cycle_row_reads``, one MGS
    pass) of a block solve of ``r.iterations`` over ``r.restarts`` cycles,
    each full but the last, that re-orthogonalizes at every step (block
    MGS does in this solve): the bytes its column ran, whatever the count."""
    last = r.iterations - m * (r.restarts - 1)
    return row_bytes * sum(
        j_cycle_row_reads(j, 1, j * (j + 1) // 2)
        for j in [m] * (r.restarts - 1) + [last])


@pytest.mark.parametrize("method", ["vmap", "block"])
def test_rcm_batched_matches_reference(method):
    Aj, At, b, target = _unstructured()
    B = np.stack([b, 1.1 * b])
    kw = dict(m=20, max_iters=2000, target_rrn=target, method=method,
              storage="frsz2_32")
    # the block method's MKL products sum in a host-dependent order that
    # moves this solve's borderline restart by one (module docstring)
    slack = 1 if method == "block" else 0
    row = TA.format_by_name("frsz2_32").nbytes(1, b.size)
    rj = jgmres_batched(Aj, jnp.asarray(B), reorder="rcm", driver="host",
                        **kw)
    for driver in ("host", "device"):
        rt = gmres_batched(At, torch.from_numpy(B), reorder="rcm",
                           driver=driver, **kw)
        r0 = gmres_batched(At, torch.from_numpy(B), reorder="none",
                           driver=driver, **kw)
        for a, j, z in zip(rt, rj, r0):
            assert a.converged and z.converged, (method, driver)
            assert abs(a.iterations - j.iterations) <= slack, (
                method, driver, a.iterations, j.iterations)
            assert abs(a.iterations - z.iterations) <= slack, (
                method, driver, a.iterations, z.iterations)
            if a.iterations == j.iterations:
                assert a.restarts == j.restarts
                assert a.bytes_read == float(j.bytes_read)
            assert abs(a.restarts - j.restarts) <= slack
            n = min(len(a.restart_rrns), len(j.restart_rrns))
            np.testing.assert_allclose(
                np.asarray(a.restart_rrns[:n], np.float64),
                np.asarray(j.restart_rrns[:n], np.float64), rtol=1e-6)
            if method == "block":
                # each side's modelled reads for the iterations it ran
                assert float(j.bytes_read) == _block_bytes(j, 20, row)
                assert a.bytes_read == _block_bytes(a, 20, row)
            np.testing.assert_allclose(a.x.numpy(), np.asarray(j.x),
                                       rtol=1e-9, atol=1e-13)
            np.testing.assert_allclose(a.x.numpy(), z.x.numpy(), rtol=1e-9,
                                       atol=1e-13)


def test_rcm_x0_parity():
    """A warm start from a nonzero x0 maps through the same permutation."""
    Aj, At, b, target = _unstructured()
    kw = dict(m=20, max_iters=2000, target_rrn=target)
    x0 = 0.9 * gmres(At, torch.from_numpy(b), reorder="none", **kw).x
    w0 = gmres(At, torch.from_numpy(b), x0=x0, reorder="none", **kw)
    w1 = gmres(At, torch.from_numpy(b), x0=x0, reorder="rcm", **kw)
    wj = jgmres(Aj, jnp.asarray(b), x0=jnp.asarray(x0.numpy()),
                reorder="rcm", driver="host", **kw)
    assert w1.iterations == w0.iterations == wj.iterations
    np.testing.assert_allclose(w1.x.numpy(), w0.x.numpy(), rtol=1e-9,
                               atol=1e-13)
    X0 = torch.stack([x0, 0.5 * x0])
    B = torch.from_numpy(np.stack([b, b]))
    for method in ("vmap", "block"):
        a = gmres_batched(At, B, X0=X0, reorder="rcm", method=method, **kw)
        z = gmres_batched(At, B, X0=X0, reorder="none", method=method, **kw)
        for ra, rz in zip(a, z):
            assert ra.iterations == rz.iterations
            np.testing.assert_allclose(ra.x.numpy(), rz.x.numpy(),
                                       rtol=1e-9, atol=1e-13)


def test_rcm_jacobi_preconditioner_permutes():
    """Name-resolved Jacobi builds from the reordered operator; a
    user-supplied instance is conjugated through ``permuted()`` — both
    match the unreordered preconditioned solve and the reference's."""
    Aj, target = jmake("synth:varcoef", 216)
    b = np.array(jrhs(Aj)[0])
    At, bt = _port(Aj), torch.from_numpy(b)
    kw = dict(m=30, max_iters=4000, target_rrn=target)
    r0 = gmres(At, bt, precond="jacobi", reorder="none", **kw)
    r1 = gmres(At, bt, precond="jacobi", reorder="rcm", **kw)
    rj = jgmres(Aj, jnp.asarray(b), precond="jacobi", reorder="rcm",
                driver="host", **kw)
    assert r1.iterations == r0.iterations == rj.iterations
    np.testing.assert_allclose(r1.x.numpy(), r0.x.numpy(), rtol=1e-9,
                               atol=1e-13)
    pre = JacobiPreconditioner.from_operator(At)
    r2 = gmres(At, bt, precond=pre, reorder="rcm", **kw)
    assert r2.iterations == r0.iterations
    np.testing.assert_allclose(r2.x.numpy(), r0.x.numpy(), rtol=1e-9,
                               atol=1e-13)
    # permuted() is the conjugation P M^{-1} P^T, memoized per permutation
    perm = np.random.default_rng(3).permutation(At.shape[0])
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(
        At.shape[0]))
    p1 = pre.permuted(perm)
    assert pre.permuted(perm) is p1
    np.testing.assert_array_equal(p1.apply(v[perm]).numpy(),
                                  pre.apply(v)[perm].numpy())
    # a padded-space permutation sees the diagonal identity-extended
    ext = np.concatenate([perm, np.arange(At.shape[0], At.shape[0] + 3)])
    pe = pre.permuted(ext)
    assert pe.inv_diag.shape[0] == At.shape[0] + 3
    assert torch.equal(pe.inv_diag[-3:], torch.ones(3, dtype=torch.float64))


def test_reorder_validation():
    Aj, _ = jmake("synth:lung", 64)
    At = _port(Aj)
    b = torch.ones(64, dtype=torch.float64)
    with pytest.raises(ValueError, match="reorder mode"):
        gmres(At, b, reorder="bogus", m=5, max_iters=5)
    with pytest.raises(ValueError, match="cannot be reordered"):
        gmres(None, b, matvec=lambda v: v, reorder="rcm", m=5, max_iters=5)
    with pytest.raises(ValueError, match="callable preconditioner"):
        gmres(At, b, precond=lambda x: x, reorder="rcm", m=5, max_iters=5)
    with pytest.raises(NotImplementedError, match="cannot be permuted"):
        gmres(At, b, precond=CallablePreconditioner(lambda x: x),
              reorder="rcm", m=5, max_iters=5)
    with pytest.raises(ValueError, match="reorder mode"):
        gmres_batched(At, b[None], reorder="bogus", method="block", m=5,
                      max_iters=5)
    with pytest.raises(RuntimeError, match="process group"):
        gmres(At, b, shard=2, m=5, max_iters=5)


def test_auto_declines_unpermutable_preconditioner():
    """``reorder="auto"`` is the default: off the sharded path it permutes
    nothing, so a bare callable hook solves exactly as with ``"none"``;
    only an explicit ``"rcm"`` refuses the hook."""
    _, At, b, target = _unstructured()
    bt = torch.from_numpy(b)
    hook = lambda x: 1.0 * x  # noqa: E731
    kw = dict(m=20, max_iters=2000, target_rrn=target, precond=hook)
    ra = gmres(At, bt, reorder="auto", **kw)
    rn = gmres(At, bt, reorder="none", **kw)
    assert ra.converged and ra.iterations == rn.iterations
    assert torch.equal(ra.x, rn.x)
    with pytest.raises(ValueError, match="callable preconditioner"):
        gmres(At, bt, reorder="rcm", **kw)


def test_cli_reorder_rows_match_reference(tmp_path):
    """``--reorder none`` and ``--reorder rcm`` through the port's CLI give
    the JAX CLI's rows: iterations, restarts, ``bytes_read`` and the
    ``reorder`` field as asked; ``rcm`` prints the plan's summary, the
    reference plan's ``describe()`` string."""
    from repro.sparse import plan_operator as jplan

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for reorder in ("none", "rcm"):
        out = tmp_path / f"{reorder}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.solve", "--device",
             "cpu", "--problem", "synth:unstructured", "--n", "512", "--m",
             "20", "--formats", "float64,frsz2_32", "--reorder", reorder,
             "--json", str(out)],
            capture_output=True, text=True, env=env, timeout=300,
            check=False)
        assert proc.returncode == 0, proc.stderr
        rows = json.loads(out.read_text())
        ref = jsolve.solve_suite("synth:unstructured", 512,
                                 ["float64", "frsz2_32"], m=20,
                                 reorder=reorder, verbose=False)
        for r, j in zip(rows, ref, strict=True):
            assert list(r) == list(j)
            for key in ("format", "iters", "restarts", "bytes_read",
                        "reorder", "converged"):
                assert r[key] == j[key], (reorder, key, r[key], j[key])
        described = jplan(jmake("synth:unstructured", 512)[0], 1,
                          reorder="rcm").describe()
        assert (described in proc.stdout) == (reorder == "rcm")
