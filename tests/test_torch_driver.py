"""The port's device driver, on the CPU: against the JAX package's device
driver, against the port's host driver, and at the guard's edges.

On the CPU the device cycle runs eagerly (no CUDA graph) with the plain
Givens step; on the card ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
replay it as a graph.  Tolerances:

* against the JAX device driver, those of ``tests/test_torch_solver.py``:
  ``converged``/``stagnated`` equal, iterations within 1 (another summation
  order can move a borderline restart), and when they agree ``restarts``,
  ``bytes_read``, ``op_reads`` exactly, ``restart_rrns`` to 1e-8 relative
  above 1e-14, ``x`` to 1e-9 relative;
* against the port's host driver: iterations, restarts, ``bytes_read`` and
  ``op_reads`` exactly equal, ``x`` within 1e-12 relative (the two share
  every operation, so in fact the bits agree);
* the plain Givens step against the host loop's rotations: bit-equal.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solver import gmres as jgmres
from repro.sparse import make_problem as jmake
from repro.sparse import rhs_for as jrhs
from repro_torch.convert import csr_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.solver import gmres
from repro_torch.solver.pipeline import resolve_preconditioner
from repro_torch.sparse import make_problem, rhs_for

torch.set_num_threads(2)

G = importlib.import_module("repro_torch.solver.gmres")


def _problem(name="synth:atmosmod", n=512):
    A, target = jmake(name, n)
    b, _ = jrhs(A)
    At = csr_from_numpy(np.asarray(A.indptr), np.asarray(A.indices),
                        np.asarray(A.data), A.shape, device="cpu")
    return A, At, np.array(b), target


JAX_CASES = [dict(storage="float64"), dict(storage="frsz2_32"),
             dict(storage="frsz2_32", ortho="cgs2"),
             dict(policy="adaptive:auto")]


@pytest.mark.parametrize("kw", JAX_CASES,
                         ids=["-".join(map(str, k.values())) for k in JAX_CASES])
def test_device_driver_matches_jax_device_driver(kw):
    A, At, b, target = _problem()
    rj = jgmres(A, jnp.asarray(b), m=40, target_rrn=target, driver="device",
                **kw)
    rt = gmres(At, torch.from_numpy(b), m=40, target_rrn=target,
               driver="device", **kw)
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


HOST_CASES = [
    ("synth:atmosmod", dict(storage="float64")),
    ("synth:atmosmod", dict(storage="float32")),
    ("synth:atmosmod", dict(storage="frsz2_32")),
    ("synth:atmosmod", dict(storage="frsz2_16")),
    ("synth:atmosmod", dict(storage="mixed:2:frsz2_32")),
    ("synth:atmosmod", dict(storage="frsz2_32", ortho="cgs2")),
    ("synth:atmosmod", dict(policy="adaptive:auto")),
    ("synth:varcoef", dict(storage="frsz2_32", precond="jacobi")),
]


@pytest.mark.parametrize("name,kw", HOST_CASES,
                         ids=[f"{p}-{'-'.join(map(str, k.values()))}"
                              for p, k in HOST_CASES])
def test_device_driver_matches_host_driver(name, kw):
    _, At, b, target = _problem(name)
    bt = torch.from_numpy(b)
    rh = gmres(At, bt, m=40, target_rrn=target, driver="host", **kw)
    rd = gmres(At, bt, m=40, target_rrn=target, driver="device", **kw)
    assert rd.converged and rh.converged
    assert (rd.iterations, rd.restarts) == (rh.iterations, rh.restarts)
    assert rd.bytes_read == rh.bytes_read and rd.op_reads == rh.op_reads
    assert (torch.linalg.vector_norm(rd.x - rh.x)
            <= 1e-12 * torch.linalg.vector_norm(rh.x))
    np.testing.assert_array_equal(rd.rrn_history, rh.rrn_history)


def test_device_driver_is_the_default_and_user_matvec_works():
    _, At, b, target = _problem(n=216)
    bt = torch.from_numpy(b)
    rd = gmres(At, bt, storage="frsz2_32", m=20, target_rrn=target)
    rh = gmres(At, bt, storage="frsz2_32", m=20, target_rrn=target,
               driver="host")
    assert rd.iterations == rh.iterations and torch.equal(rd.x, rh.x)
    # a bare matvec callable: the device cycle reads each row decompressed
    ru = gmres(None, bt, storage="frsz2_32", m=20, target_rrn=target,
               matvec=At.matvec)
    assert ru.iterations == rh.iterations and torch.equal(ru.x, rh.x)


def test_device_driver_stagnation_parity():
    """widerange stalls frsz2 (paper Fig. 9b): both drivers must cut off
    at the same iteration via the stagnation guard."""
    _, At, b, _ = _problem("synth:widerange", 256)
    bt = torch.from_numpy(b)
    kw = dict(storage="frsz2_32", m=20, max_iters=400, target_rrn=1e-12)
    rh = gmres(At, bt, driver="host", **kw)
    rd = gmres(At, bt, driver="device", **kw)
    assert (rh.iterations, rh.restarts) == (rd.iterations, rd.restarts)
    assert rh.converged == rd.converged and rh.stagnated == rd.stagnated


def test_stagnated_flag_reported_by_both_drivers(monkeypatch):
    """The stagnation guard, pinned as the JAX package pins it: a stub cycle
    whose estimate meets the target exactly at its last step while the
    update is a no-op (g = 0), so every cycle repeats and the guard must cut
    the solve off at the 5th flat cycle in both drivers."""
    m, target = 4, 1e-8
    est = target * np.linspace(2.0, 0.9, m)
    R = np.eye(m + 1, m)

    def fake_cycle(matvec, acc, b_norm, store, w0, beta, eta, tgt, ortho,
                   precond, dist=None):
        return R.copy(), np.zeros(m + 1), est.copy(), 0, np.zeros(m, bool)

    def fake_device_cycle(matvec, acc, store, state, init, r, beta, b_norm,
                          eta, tgt, ortho, precond, fused, dist=None):
        L = ref.givens_layout(m)
        state.copy_(init)
        state[:L["g"]] = torch.from_numpy(R.ravel())
        state[L["g"]:L["est"]] = 0.0
        state[L["est"]:L["extra"]] = torch.from_numpy(est)

    monkeypatch.setattr(G, "_cycle", fake_cycle)
    monkeypatch.setattr(G, "_device_cycle", fake_device_cycle)
    A, _ = make_problem("synth:atmosmod", 64, device="cpu")
    b, _ = rhs_for(A, device="cpu")
    kw = dict(storage="float64", m=m, max_iters=97, target_rrn=target)
    rh = gmres(A, b, driver="host", **kw)
    rd = gmres(A, b, driver="device", **kw)
    for r in (rh, rd):
        assert not r.converged and r.stagnated
        assert r.iterations == 5 * m
    assert rh.restarts == rd.restarts


def test_not_stagnated_on_budget_exhaustion_or_convergence():
    _, At, b, _ = _problem("synth:widerange", 256)
    rb = gmres(At, torch.from_numpy(b), storage="frsz2_32", m=20,
               max_iters=40, target_rrn=1e-12)
    assert not rb.converged and not rb.stagnated
    _, At2, b2, t2 = _problem(n=216)
    rc = gmres(At2, torch.from_numpy(b2), m=20, max_iters=2000, target_rrn=t2)
    assert rc.converged and not rc.stagnated


def test_zero_iteration_budget_reports_initial_residual():
    _, At, b, _ = _problem(n=64)
    bt = torch.from_numpy(b)
    rh = gmres(At, bt, driver="host", m=5, max_iters=0)
    rd = gmres(At, bt, driver="device", m=5, max_iters=0)
    assert not rh.converged and not rd.converged
    assert rh.iterations == rd.iterations == 0
    np.testing.assert_allclose(rd.rrn, rh.rrn, rtol=1e-12)
    np.testing.assert_allclose(rd.rrn, 1.0, rtol=1e-12)      # x0 = 0


def test_device_driver_trivial_rhs_converges_immediately():
    A, At, b, _ = _problem(n=216)
    x0 = np.linalg.solve(np.asarray(A.to_dense()), b)
    res = gmres(At, torch.from_numpy(b), x0=torch.from_numpy(x0), m=20,
                max_iters=100, target_rrn=1e-10)
    assert res.converged and res.iterations == 0 and res.restarts == 1


def _host_rotations(cols, hj1s, w_pres, fired, beta, b_norm, target, m):
    """The host loop's least squares (``_cycle``), written out in numpy."""
    R = np.zeros((m + 1, m))
    g = np.zeros(m + 1)
    g[0] = beta
    cs, sn = np.zeros(m), np.zeros(m)
    est = np.full(m, np.inf)
    extra = 0
    for j in range(m):
        col = list(cols[j]) + [hj1s[j]]
        extra += fired[j] * (j + 1)
        breakdown = hj1s[j] <= 1e-30 * w_pres[j] + 1e-300
        for i in range(j):
            a, bb = col[i], col[i + 1]
            col[i] = cs[i] * a + sn[i] * bb
            col[i + 1] = -sn[i] * a + cs[i] * bb
        a, bb = col[j], col[j + 1]
        d = math.sqrt(a * a + bb * bb)
        c, s = (a / d, bb / d) if d > 0 else (1.0, 0.0)
        col[j] = c * a + s * bb
        col[j + 1] = 0.0
        gj = g[j]
        g[j] = c * gj
        g[j + 1] = -s * gj
        R[:j + 2, j] = col
        cs[j], sn[j] = c, s
        est[j] = abs(g[j + 1]) / b_norm
        if breakdown or not est[j] > target:
            est[j + 1:] = est[j]
            break
    return R, g, est, extra


@pytest.mark.parametrize("target,breakdown_at", [(0.0, None), (1e-3, None),
                                                 (0.0, 7)])
def test_plain_givens_step_is_bit_equal_to_host_rotations(target,
                                                          breakdown_at, rng):
    m = 12
    cols = [rng.standard_normal(j + 1) * 10.0 ** rng.integers(-3, 3)
            for j in range(m)]
    hj1s = rng.random(m) * 0.5
    w_pres = hj1s + rng.random(m)
    if breakdown_at is not None:
        hj1s[breakdown_at] = 0.0
    fired = rng.random(m) < 0.5
    beta, b_norm = 1.7, 2.3
    R, g, est, extra = _host_rotations(cols, hj1s, w_pres, fired, beta,
                                       b_norm, target, m)
    L = ref.givens_layout(m)
    state = ref.givens_init_ref(m, "cpu")
    state[L["g"]] = beta
    f64 = torch.float64
    for j in range(m):
        ops.givens_step(state, torch.tensor(cols[j], dtype=f64),
                        torch.tensor(hj1s[j], dtype=f64),
                        torch.tensor(w_pres[j], dtype=f64),
                        torch.tensor(bool(fired[j])),
                        torch.tensor(b_norm, dtype=f64), j, m, target)
    s = state.numpy()
    live = int(np.argmax(est <= target)) + 1 if (est <= target).any() else m
    np.testing.assert_array_equal(s[:L["g"]].reshape(m + 1, m), R)
    np.testing.assert_array_equal(s[L["g"]:L["g"] + live + 1], g[:live + 1])
    np.testing.assert_array_equal(s[L["est"]:L["extra"]], est)
    assert s[L["extra"]] == extra
    assert s[L["alive"]] == float(live == m and est[-1] > target
                                  and breakdown_at is None)


def test_graph_cache_keys_by_identity_not_content():
    A, _ = make_problem("synth:atmosmod", 64, device="cpu")
    B, _ = make_problem("synth:atmosmod", 64, device="cpu")
    assert A.fingerprint() == B.fingerprint()          # equal matrices
    ka, pins = G._operator_key(A, None)
    assert ka == G._operator_key(A, None)[0]           # same tensors
    assert ka != G._operator_key(B, None)[0]           # other addresses
    assert A in pins                                   # pinned by the entry
    # the Jacobi preconditioner is built once per operator object, so
    # repeated solves of it hit one captured cycle
    p1 = resolve_preconditioner("jacobi", A)
    p2 = resolve_preconditioner("jacobi", A)
    assert G._precond_key(p1) == G._precond_key(p2)
    assert G._precond_key(p1) != G._precond_key(
        resolve_preconditioner("jacobi", B))


# ---------------------------------------------------------------------------
# MGS's conditional second pass: solver.graphs.device_if and the fired slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pred", [True, False])
def test_device_if_writes_only_where_pred_holds(pred):
    """Outside a capture (the CPU, a capture's warm-up) the block runs and
    ``put`` keeps ``dst``'s own bits where ``pred`` is false, non-finite
    values included; where it is true ``dst`` takes the value's bits."""
    from repro_torch.solver.graphs import device_if

    dst = torch.tensor([1.0, float("inf"), -0.0, float("nan")],
                       dtype=torch.float64)
    keep = dst.clone()
    value = torch.tensor([float("nan"), 2.0, 0.0, -3.5], dtype=torch.float64)
    scalar = torch.tensor(5.0, dtype=torch.float64)
    ran = []
    with device_if(torch.tensor(pred)) as put:
        ran.append(True)
        put(dst, value)
        put(scalar, scalar * 2)
    assert ran == [True]
    want = value if pred else keep
    assert torch.equal(dst.view(torch.int64), want.view(torch.int64))
    assert float(scalar) == (10.0 if pred else 5.0)


def test_device_if_takes_a_0d_bool_only():
    from repro_torch.solver.graphs import device_if

    for bad in (torch.tensor(1.0), torch.tensor([True])):
        with pytest.raises(ValueError, match="0-d bool"):
            with device_if(bad):
                pass


def _row_bytes(storage, n, m):
    from repro_torch.core.accessor import BasisAccessor, format_by_name

    acc = BasisAccessor(fmt=format_by_name(storage), m=m + 1, n=n,
                        arith_dtype=torch.float64, device="cpu")
    return acc.nbytes() / acc.m


@pytest.mark.parametrize("eta", [0.3, 1 / math.sqrt(2)])
@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_fired_slots_equal_the_host_drivers_steps(storage, eta):
    """On a fixed trajectory (``target_rrn=0``: every step live, k full
    cycles) the device cycle's ``fired`` slots equal the steps where the
    host driver's MGS re-orthogonalized; at eta 0.3 some steps fire and
    some do not."""
    A, _ = make_problem("synth:atmosmod", 512, device="cpu")
    b, _ = rhs_for(A, device="cpu")
    m, k = 20, 2
    kw = dict(storage=storage, m=m, max_iters=k * m, target_rrn=0.0, eta=eta)
    rd = gmres(A, b, driver="device", **kw)
    rh = gmres(A, b, driver="host", **kw)
    assert rd.fired.shape == (k, m) and rd.fired.dtype == bool
    np.testing.assert_array_equal(rd.fired, rh.fired)
    if eta == 0.3:
        assert 0 < rd.fired.sum() < k * m
    extra = sum(j + 1 for c in range(k) for j in range(m) if rd.fired[c, j])
    want = (k * G._cycle_row_reads(m, 1, 0) + extra) * _row_bytes(
        storage, b.shape[0], m)
    assert rd.bytes_read == rh.bytes_read == want
    assert torch.equal(rd.x, rh.x)


@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_mgs_fires_never_at_eta_0_and_always_at_eta_1_5(storage):
    """One trajectory, two extremes: ``||w_orth|| < 0 * ||w||`` never
    holds, ``< 1.5 ||w||`` always does.  ``bytes_read`` counts one sweep a
    step, plus every step's rows at eta 1.5; the JAX device driver's
    agrees."""
    A, At, b, _ = _problem(n=512)
    m, k = 12, 2
    rows = _row_bytes(storage, b.shape[0], m)
    for eta, fired in ((0.0, False), (1.5, True)):
        kw = dict(storage=storage, m=m, max_iters=k * m, target_rrn=0.0,
                  eta=eta)
        rd = gmres(At, torch.from_numpy(b), driver="device", **kw)
        rh = gmres(At, torch.from_numpy(b), driver="host", **kw)
        rj = jgmres(A, jnp.asarray(b), driver="device", **kw)
        assert (rd.fired == fired).all() and (rh.fired == fired).all()
        extra = k * m * (m + 1) // 2 if fired else 0
        want = (k * G._cycle_row_reads(m, 1, 0) + extra) * rows
        assert rd.bytes_read == rh.bytes_read == float(rj.bytes_read) == want
        assert rd.op_reads == rh.op_reads == float(rj.op_reads)
        assert rd.iterations == rh.iterations == int(rj.iterations) == k * m
        assert torch.equal(rd.x, rh.x)
