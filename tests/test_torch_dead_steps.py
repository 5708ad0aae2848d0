"""The device cycle's dead steps, on the CPU: what a replay that skips them
must leave, and how it is counted.

A captured unsharded cycle holds each Arnoldi step in IF nodes keyed on
the least-squares state's ``alive`` slot, so that a replay on the card runs
no step after the last live one.  On the CPU the cycle runs eagerly, every
step, and must leave the state that such a replay leaves: the host
driver's ``R``, ``g`` and ``extra``, ``est`` in full (the step that drops
``alive`` writes the tail the dead steps would repeat) and ``fired`` 0 at
the dead steps.  A sharded cycle holds collectives in each step, which no
IF node takes: it keeps all ``m`` steps, each writing its ``fired`` slot.
The replay's count (``gmres._replayed``) adds a step body's launches only
at the steps that ran.  Bit-equal throughout: the same operations in the
same order.
"""
import importlib
import math

import numpy as np
import pytest
import torch

from repro_torch.core.accessor import BasisAccessor, format_by_name
from repro_torch.dist import census
from repro_torch.dist.context import DistContext
from repro_torch.kernels import ops, ref
from repro_torch.solver import gmres, graphs
from repro_torch.solver.pipeline import (
    IdentityPreconditioner,
    orthogonalizer_by_name,
)
from repro_torch.sparse import make_problem, rhs_for

torch.set_num_threads(2)

G = importlib.import_module("repro_torch.solver.gmres")

M = 20
#: (target, steps of the first cycle): one that converges mid-cycle, and
#: one that runs the whole cycle and restarts (synth:atmosmod, n 512)
TARGETS = {"converges": (1e-6, 19), "restarts": (4e-14, M)}


def _problem():
    A, _ = make_problem("synth:atmosmod", 512, device="cpu")
    b, _ = rhs_for(A, device="cpu")
    return A, b


def _acc(storage, n, m=M):
    return BasisAccessor(fmt=format_by_name(storage), m=m + 1, n=n,
                         arith_dtype=torch.float64, device="cpu")


class _OneRank(DistContext):
    """A sharded context of one rank with no process group: its sums are
    the local values, so it runs the sharded cycle's route on the CPU."""

    def sum(self, x):
        return x


@pytest.mark.parametrize("case", sorted(TARGETS))
@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_eager_cycle_leaves_the_host_cycles_state(storage, case):
    """One cycle from ``r0 = b``: the eager device cycle's ``R``, ``g``,
    ``est`` (in full, the tail past the last live step included),
    ``extra`` and ``fired`` (0 at the dead steps) equal the host
    driver's, bit for bit."""
    target, live = TARGETS[case]
    A, b = _problem()
    beta = torch.linalg.vector_norm(b)
    ortho = orthogonalizer_by_name("mgs")
    pc = IdentityPreconditioner()
    eta = 1 / math.sqrt(2)
    acc = _acc(storage, b.shape[0])
    R, g, est, extra, fired = G._cycle(
        A.matvec, acc, float(beta), acc.empty(), b, beta, eta, target,
        ortho, pc)
    cyc = G._DeviceCycle(A.matvec, acc, eta, target, ortho, pc, fused=True)
    Rd, gd, estd, extrad, firedd = cyc(b, beta, beta)
    assert np.count_nonzero(np.isfinite(est)) == M
    assert int(np.argmax(est <= target)) + 1 == live if live < M else (
        est > target).all()
    for want, got in ((R, Rd), (g, gd), (est, estd)):
        np.testing.assert_array_equal(got, want)
    assert extrad == extra
    np.testing.assert_array_equal(firedd, fired)
    assert not firedd[live:].any()
    L = ref.givens_layout(M)
    assert (cyc.state[L["fired"] + live:L["size"]] == 0).all()


@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_device_solve_marks_the_host_drivers_fired_steps(storage):
    """A solve that restarts twice and stops part way through its third
    cycle: both drivers' ``fired`` arrays equal, dead steps 0, and the
    solution, history and restart residuals bit-equal."""
    A, b = _problem()
    target, _ = TARGETS["restarts"]
    kw = dict(storage=storage, m=M, target_rrn=target)
    rh = gmres(A, b, driver="host", **kw)
    rd = gmres(A, b, driver="device", **kw)
    assert rd.restarts == rh.restarts == 3 and rd.iterations % M
    np.testing.assert_array_equal(rd.fired, rh.fired)
    assert not rd.fired[-1, rd.iterations % M:].any()
    assert torch.equal(rd.x, rh.x)
    np.testing.assert_array_equal(rd.rrn_history, rh.rrn_history)
    np.testing.assert_array_equal(rd.restart_rrns, rh.restart_rrns)


@pytest.mark.parametrize("target", [1e-6, 0.0])
def test_givens_step_ref_writes_the_tail_it_stops_at(target, rng):
    """The plain Givens step: the step that drops ``alive`` writes its
    ``est`` into ``est[j+1:m]``, so a cycle that runs no more steps
    leaves the ``est`` of one that runs them all (each dead step repeats
    its predecessor's), with ``fired`` set at the live steps only."""
    m = 12
    L = ref.givens_layout(m)
    f64 = torch.float64
    cols = [rng.standard_normal(j + 1) for j in range(m)]
    hj1s = 0.1 ** np.arange(1, m + 1)           # the estimate falls
    fired = rng.random(m) < 0.5
    states = []
    for stop in (True, False):
        s = ref.givens_init_ref(m, "cpu")
        s[L["g"]] = 1.0
        for j in range(m):
            if stop and not s[L["alive"]]:
                break
            ref.givens_step_ref(s, torch.tensor(cols[j], dtype=f64),
                                torch.tensor(hj1s[j], dtype=f64),
                                torch.tensor(1.0, dtype=f64),
                                torch.tensor(bool(fired[j])),
                                torch.tensor(1.0, dtype=f64), j, m, target)
        states.append(s)
    assert torch.equal(states[0], states[1])
    est = states[0][L["est"]:L["extra"]].numpy()
    live = int(np.argmax(est <= target)) + 1 if (est <= target).any() else m
    np.testing.assert_array_equal(est[live:], est[live - 1])
    got = states[0][L["fired"]:L["size"]].numpy() != 0
    np.testing.assert_array_equal(got[:live], fired[:live])
    assert not got[live:].any()
    assert (target > 0) == (live < m)


def _body(tag, name, call):
    return graphs.Body({name: 1}, [call], tag)


@pytest.mark.parametrize("ran", [0, 2, 4])
def test_replayed_counts_step_bodies_only_at_the_steps_that_ran(ran):
    """Hand-made bodies of a 4-step cycle, two nodes a step in the order a
    capture closes them (MGS's second pass, tagged ``"fired"``, nested in
    the step's node, tagged ``"step"``): a replay that ran ``ran`` steps
    adds the step's launches and collectives ``ran`` times, the pass's at
    each step whose ``fired`` slot is set, the graph's own once."""
    m = 4
    bodies = [b for j in range(m) for b in (
        _body("fired", "pass", f"pass{j}"), _body("step", "step", f"step{j}"))]
    fired = np.array([True, False, True, False]) & (np.arange(m) < ran)
    before = dict(ops.LAUNCHES)
    ops.LAUNCHES.update(step=0, graph_if=0, **{"pass": 0})
    try:
        with census.Census() as c:
            G._replayed({"graph_if": m}, ["graph"], bodies, fired, ran)
        got = {k: ops.LAUNCHES[k] for k in ("step", "pass", "graph_if")}
    finally:
        for k in ("step", "pass"):
            ops.LAUNCHES.pop(k)
        ops.LAUNCHES.update(before)
    assert got == dict(step=ran, graph_if=m, **{"pass": int(fired.sum())})
    want = ["graph"] + [x for j in range(ran) for x in (
        *([f"pass{j}"] if fired[j] else []), f"step{j}")]
    assert c.calls == want


def test_replayed_without_steps_run_counts_every_step_and_checks_nodes():
    """A cycle whose nodes are MGS's alone (a sharded one): every fired
    step counts, and bodies that do not split evenly over the steps
    raise."""
    fired = np.array([True, True, False])
    bodies = [_body("fired", "pass", f"pass{j}") for j in range(3)]
    before = dict(ops.LAUNCHES)
    ops.LAUNCHES["pass"] = 0
    try:
        G._replayed({}, [], bodies, fired)
        assert ops.LAUNCHES["pass"] == 2
        with pytest.raises(RuntimeError, match="the same number a step"):
            G._replayed({}, [], bodies[:2], fired)
    finally:
        ops.LAUNCHES.pop("pass")
        ops.LAUNCHES.update(before)


@pytest.mark.parametrize("sharded", [False, True])
def test_the_skip_route_is_chosen_by_dist(sharded, monkeypatch):
    """Without a card: an unsharded cycle puts each step into an IF node
    keyed on the f64 ``alive`` slot (tag ``"step"``), MGS's second pass
    into one keyed on ``fired`` inside it; a sharded one (one rank, no
    group: the branch-free pass) has no node at all.  Each leaves the host driver's
    bits (under the same ``dist``) at the live steps; the unsharded one
    ``fired`` 0 past them."""
    A, b = _problem()
    beta = torch.linalg.vector_norm(b)
    seen = []
    real = graphs.device_if

    def recording(pred, tag="fired"):
        seen.append((tag, pred.dtype))
        return real(pred, tag=tag)

    monkeypatch.setattr(graphs, "device_if", recording)
    target, _ = TARGETS["converges"]
    dist = _OneRank(sharded=True) if sharded else DistContext()
    acc = _acc("frsz2_32", b.shape[0])
    L = ref.givens_layout(M)
    state = torch.empty(L["size"], dtype=torch.float64)
    G._device_cycle(A.matvec, acc, acc.empty(), state,
                    ref.givens_init_ref(M, "cpu"), b, beta, beta,
                    1 / math.sqrt(2), target, orthogonalizer_by_name("mgs"),
                    IdentityPreconditioner(), True, dist)
    f64, flag = torch.float64, torch.bool
    if sharded:
        assert seen == []                      # the select route, no node
    else:
        assert seen == [("step", f64), ("fired", flag)] * M
    host = G._cycle(A.matvec, acc, float(beta), acc.empty(), b, beta,
                    1 / math.sqrt(2), target, orthogonalizer_by_name("mgs"),
                    IdentityPreconditioner(), dist)
    live = int(np.argmax(host[2] <= target)) + 1
    assert live < M
    s = state.numpy()
    np.testing.assert_array_equal(s[:L["g"]].reshape(M + 1, M), host[0])
    np.testing.assert_array_equal(s[L["est"]:L["extra"]], host[2])
    fired = s[L["fired"]:L["size"]] != 0
    np.testing.assert_array_equal(fired[:live], host[4][:live])
    if not sharded:
        assert not fired[live:].any()
