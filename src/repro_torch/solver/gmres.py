"""Restarted GMRES(m) with a compressed Krylov basis (CB-GMRES, paper Fig. 1).

The port of ``repro/solver/gmres.py``'s two drivers, decision for decision:

  * Arnoldi with the orthogonalization expressed as the two Accessor hot
    loops ``h = V_j w`` (dots) and ``w -= V_j^T h`` (combine);
  * conditional re-orthogonalization when ``h_{j+1,j} < eta * ||w_pre||``;
  * Givens-rotation least squares on the Hessenberg matrix, giving the
    implicit residual estimate ``|g_{j+1}|`` per inner iteration;
  * restart after ``m`` vectors with the explicit residual recomputed;
  * the basis behind a :class:`~repro_torch.core.accessor.BasisAccessor` in
    any storage format: float64/float32/float16, FRSZ2 (the Hopper kernels
    on the card), or mixed.

Both drivers share the restart loop (:func:`_restart_loop`): the explicit
residuals, the choice of the stopping iteration ``j_stop``, the back
substitution on the host in f64, the solution update, the stagnation guard,
and ``bytes_read`` / ``op_reads`` (the modelled basis and operator traffic,
computed exactly as the reference computes them).  They differ in the cycle:

  * ``driver="device"`` (the default, as in the reference): one cycle runs
    all ``m`` iterations with an ``alive`` mask and no host read, as the
    reference's ``fori_loop`` does (:func:`_device_cycle`).  On CUDA it is
    captured once per policy level as a CUDA graph and replayed once per
    restart; MGS's second pass is an IF node of the graph, which runs only
    at the steps where it fires (:mod:`repro_torch.solver.graphs`).  ``R``,
    ``g``, ``est``, the extra-sweep count and the steps where MGS fired
    come back in one tensor, one host read per restart.  On the CPU the same
    cycle runs eagerly.
  * ``driver="host"``: the cycle loops in Python and reads each step's
    Hessenberg column on the host (:func:`_cycle`), stopping once ``alive``
    drops.  It is the parity oracle of the device driver.

The two give the same bits: the device cycle's Givens step
(``ops.givens_step``) rounds as the host's Python floats do, and both
drivers normalize basis rows by the same tensor division.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.core.accessor import BasisAccessor
from repro_torch.dist import census
from repro_torch.dist.context import LOCAL
from repro_torch.kernels import ops, peer_gather, ref
from repro_torch.solver import graphs
from repro_torch.solver.pipeline import (
    CallablePreconditioner,
    IdentityPreconditioner,
    JacobiPreconditioner,
    orthogonalizer_by_name,
    resolve_policy,
    resolve_preconditioner,
)
from repro_torch.sparse.csr import CSR, ELL

__all__ = ["GmresResult", "gmres", "gmres_batched", "cb_gmres",
           "clear_graph_cache"]

_TINY = 1e-300


def _norm_floor(dtype) -> float:
    """The least norm divided by, in ``dtype``: ``_TINY`` where it is
    representable (f64), else the dtype's smallest normal, so that a zero
    right-hand side never divides by 0 in f32 either."""
    return max(_TINY, torch.finfo(dtype).tiny)


@dataclasses.dataclass
class GmresResult:
    x: torch.Tensor              # final solution approximation
    rrn: float                   # true relative residual norm at exit
    iterations: int              # total inner iterations executed
    converged: bool
    rrn_history: np.ndarray      # implicit residual estimate per iteration
    restart_rrns: np.ndarray     # explicit RRN measured at each restart
    restarts: int
    bytes_read: float = 0.0      # modelled basis read traffic (bytes)
    stagnated: bool = False      # stopped by the stagnation guard
    op_reads: float = 0.0        # modelled full passes over the operator
    # (restarts run, m): the steps of each cycle where MGS re-orthogonalized;
    # the host driver runs (and marks) only the live steps, the device
    # driver all m, dead ones too; none for CGS2
    fired: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), bool))
    # where MGS's second pass runs in a captured cycle
    # (DistContext.second_pass): "if" (unsharded), "if+peer_gather" or
    # "select" (sharded: its reductions over the peer gather in the IF
    # node, or branch-free at every step where the cards lack peer access)
    second_pass: str = "if"


def _givens(a: float, b: float) -> tuple[float, float]:
    """Stable Givens rotation: (c, s) with [c s; -s c]ᵀ [a;b] = [r;0]."""
    denom = math.sqrt(a * a + b * b)
    if denom > 0:
        return a / denom, b / denom
    return 1.0, 0.0


def _normalized(w: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """``w / max(nrm, tiny)`` for a 0-d ``nrm``: one tensor division, the
    same in both drivers (on CUDA, dividing by a Python float would multiply
    by its reciprocal instead, which can differ in the last bit)."""
    return w / torch.clamp(nrm, min=_TINY)


# ---------------------------------------------------------------------------
# Host-looped cycle (the parity oracle)
# ---------------------------------------------------------------------------


@census.cycle
def _cycle(matvec: Callable, acc: BasisAccessor, b_norm: float, store, w0,
           beta: torch.Tensor, eta: float, target: float, ortho, precond,
           dist=LOCAL):
    """One GMRES(m) cycle.  w0 = r0 (unnormalized); beta = ||r0|| (0-d).

    Writes the basis into ``store`` in place and returns ``(R, g, est,
    extra_rows, fired)``: the rotated Hessenberg ``R`` (m+1, m), the
    rotated rhs ``g`` (m+1,), the implicit residual estimate per inner
    iteration, the count of basis rows swept by extra (conditional)
    orthogonalization passes of live iterations, and those iterations
    (``fired``, (m,) bool).

    In the reference every one of the ``m`` iterations runs and an
    ``alive`` flag masks those after the estimate met the target (or the
    Arnoldi process broke down): their Hessenberg columns are not taken,
    their ``est`` entries repeat the last live one, and they add nothing to
    ``extra_rows``.  Here the loop stops once ``alive`` drops and fills
    ``est`` the same way, which gives the same results.
    """
    m = acc.m - 1
    acc.write_row(store, 0, _normalized(w0, beta))

    R = np.zeros((m + 1, m))
    g = np.zeros(m + 1)
    g[0] = float(beta)
    cs = np.zeros(m)
    sn = np.zeros(m)
    est = np.full(m, np.inf)
    extra_rows = 0
    fired_steps = np.zeros(m, bool)

    for j in range(m):
        v = acc.read_row(store, j)
        w = matvec(precond.apply(v)).to(acc.arith_dtype)
        w_pre = dist.norm(w)
        w, h, hj1_t, fired = ortho(acc, store, w, j + 1, eta, dist, w_pre)
        extra_rows += fired * (j + 1)
        fired_steps[j] = fired

        *col, hj1, w_pre = torch.cat(
            [h, torch.stack([hj1_t, w_pre])]).tolist()  # one host read per step
        breakdown = hj1 <= 1e-30 * w_pre + _TINY
        acc.write_row(store, j + 1, _normalized(w, hj1_t))

        # Hessenberg column = [h_{1:j,j}; h_{j+1,j}] then apply rotations
        col.append(hj1)
        for i in range(j):
            a, bb = col[i], col[i + 1]
            col[i] = cs[i] * a + sn[i] * bb
            col[i + 1] = -sn[i] * a + cs[i] * bb
        c, s = _givens(col[j], col[j + 1])
        col[j] = c * col[j] + s * col[j + 1]
        col[j + 1] = 0.0
        gj = g[j]
        g[j] = c * gj
        g[j + 1] = -s * gj

        R[: j + 2, j] = col
        cs[j] = c
        sn[j] = s
        resid = abs(g[j + 1]) / b_norm
        est[j] = resid
        if breakdown or not resid > target:       # alive drops
            est[j + 1:] = resid
            break
    return R, g, est, extra_rows, fired_steps


# ---------------------------------------------------------------------------
# Device cycle: all m iterations, no host read, one CUDA graph per level
# ---------------------------------------------------------------------------


@census.cycle
def _device_cycle(matvec: Callable, acc: BasisAccessor, store, state, init,
                  r, beta, b_norm, eta: float, target: float, ortho, precond,
                  fused: bool, dist=LOCAL) -> None:
    """One GMRES(m) cycle with no host read (the reference's ``_cycle``).

    ``r``, ``beta`` and ``b_norm`` are tensors (``beta``, ``b_norm`` 0-d);
    the basis goes into ``store`` and the least squares into ``state`` (f64,
    laid out as :func:`repro_torch.kernels.ref.givens_layout`), both in
    place, with ``fired`` (1 at each step where MGS re-orthogonalized).
    All ``m`` iterations run: once ``alive`` drops (the estimate met
    ``target``, or a breakdown), the Givens step takes no more columns and
    repeats the last ``est``.  ``fused``: the operator reads each FRSZ2
    basis row as codes (the ELL kernel decodes in registers) instead of a
    decompressed row; it needs the operator's own matvec and no
    preconditioner, and gives the same bits.
    """
    m = acc.m - 1
    L = ref.givens_layout(m)
    acc.write_row(store, 0, _normalized(r, beta))
    state.copy_(init)
    state[L["g"]].copy_(beta)
    for j in range(m):
        if fused:
            w = matvec(acc.operand(store, j))
        else:
            w = matvec(precond.apply(acc.read_row(store, j)))
        w = w.to(acc.arith_dtype)
        w_pre = dist.norm(w)
        w, h, hj1, fired = ortho.branch_free(acc, store, w, j + 1, eta, dist,
                                             w_pre)
        state[L["fired"] + j].copy_(fired)
        acc.write_row(store, j + 1, _normalized(w, hj1))
        ops.givens_step(state, h, hj1, w_pre, fired, b_norm, j, m, target)


def _capture(run: Callable):
    """Capture ``run()`` as a CUDA graph: ``(graph, launches, calls,
    bodies)``.

    ``run`` first runs once on a side stream (every kernel library is then
    built and loaded, cuBLAS has its workspace) and counts the launches it
    really makes; the capture then counts them again, and those counts are
    taken back out of ``ops.LAUNCHES`` and returned, for :func:`_replayed`
    to add per replay (a replay runs no Python), with the collectives the
    graph holds (:func:`repro_torch.dist.census.capturing`).  What the
    graph's IF nodes hold is kept apart, one
    :class:`~repro_torch.solver.graphs.Body` a node in the order of the
    steps, and left out of ``launches`` and ``calls``.  A failed capture
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                 # warm-up: real launches
    torch.cuda.current_stream().wait_stream(side)
    before = dict(ops.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with census.capturing() as calls, graphs.capturing(graph) as cap, \
            torch.cuda.graph(graph):
        run()
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for body in cap.bodies:
        for k, v in body.launches.items():
            launches[k] -= v
    ops.LAUNCHES.update(before)               # a capture launches nothing
    return graph, launches, calls, cap.bodies


def _replayed(launches: dict, calls, bodies, fired) -> None:
    """Count a replay: its graph's launches and collectives, and those of
    the IF node of each step ``j`` where ``fired[j]`` is set (a graph
    without IF nodes has no ``bodies``)."""
    if bodies and len(bodies) != len(fired):
        raise RuntimeError(f"{len(bodies)} IF nodes in a cycle of "
                           f"{len(fired)} steps: one a step expected")
    for k, v in launches.items():
        ops.LAUNCHES[k] += v
    census.replayed(calls)
    for body, ran in zip(bodies, fired):
        if ran:
            for k, v in body.launches.items():
                ops.LAUNCHES[k] += v
            census.replayed(body.calls)


class _DeviceCycle:
    """The device cycle of one policy level, with its own basis store, its
    least-squares state and static inputs.

    On CUDA the first call runs the cycle once on a side stream (every
    kernel library is then built and loaded, cuBLAS has its workspace),
    captures it as a CUDA graph and keeps the kernel launches the capture
    counted; every call then copies its inputs into the static ones,
    replays the graph and adds those launches to ``ops.LAUNCHES`` (a replay
    runs no Python, so it would count nothing), with those of MGS's second
    pass at the steps where it fired.  A failed capture or replay raises.
    On the CPU every call runs the cycle eagerly.  A sharded ``dist`` puts
    its collectives (NCCL on the card) inside the graph.
    """

    def __init__(self, matvec, acc: BasisAccessor, eta: float, target: float,
                 ortho, precond, fused: bool, pins=(), dist=LOCAL):
        m = acc.m - 1
        self.acc = acc
        self.store = acc.empty()
        self.init = ref.givens_init_ref(m, acc.device)
        self.state = torch.empty_like(self.init)
        ad, dev = acc.arith_dtype, self.init.device
        self.r = torch.empty((acc.n,), dtype=ad, device=dev)
        self.beta = torch.empty((), dtype=ad, device=dev)
        self.b_norm = torch.empty((), dtype=ad, device=dev)
        self._args = (matvec, eta, target, ortho, precond, fused, dist)
        self.pins = pins            # keeps the tensors the graph reads alive
        self.graph = None
        self.launches: dict[str, int] = {}
        self.calls = ()             # the collectives the graph holds
        self.bodies = ()            # its IF nodes' (graphs.Body), by step
        self.fresh = False          # zero the store before the next cycle

    def _run(self) -> None:
        matvec, eta, target, ortho, precond, fused, dist = self._args
        _device_cycle(matvec, self.acc, self.store, self.state, self.init,
                      self.r, self.beta, self.b_norm, eta, target, ortho,
                      precond, fused, dist)

    def __call__(self, r, beta, b_norm):
        self.r.copy_(r)
        self.beta.copy_(beta)
        self.b_norm.copy_(b_norm)
        if self.state.is_cuda and self.graph is None:
            self.graph, self.launches, self.calls, self.bodies = _capture(
                self._run)
        if self.fresh:              # after a capture's warm-up wrote it
            _zero_store(self.store)
            self.fresh = False
        if self.state.is_cuda:
            self.graph.replay()
        else:
            self._run()
        m = self.acc.m - 1
        L = ref.givens_layout(m)
        # one host read per restart; a copy, since on the CPU .cpu() would
        # hand back the state itself, which the next cycle overwrites
        out = self.state.cpu().numpy().copy()
        fired = out[L["fired"]:L["fired"] + m] != 0
        if self.state.is_cuda:
            _replayed(self.launches, self.calls, self.bodies, fired)
        return (out[:L["g"]].reshape(m + 1, m), out[L["g"]:L["est"]],
                out[L["est"]:L["extra"]], int(out[L["extra"]]), fired)


#: captured cycles (scalar and block), least recently used first.  A graph
#: reads its operator, preconditioner and store by address, so the key is
#: the identity of those tensors (never a content fingerprint: an equal
#: matrix elsewhere would be read through stale pointers) and the entry
#: pins them.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_GRAPHS_SIZE = 8


def clear_graph_cache() -> None:
    """Drop every captured cycle, with the basis stores and the graph
    memory it holds (a full-width block basis holds gigabytes), and free
    the peer gather's regions, which the graphs read by address (on the
    card every rank of their groups calls it together)."""
    _GRAPHS.clear()
    peer_gather.free_regions()


def _cached_graph(key, build):
    """The cached cycle under ``key``, or ``build()`` cached there."""
    cyc = _GRAPHS.get(key)
    if cyc is not None:
        _GRAPHS.move_to_end(key)
        return cyc
    cyc = _GRAPHS[key] = build()
    while len(_GRAPHS) > _GRAPHS_SIZE:
        _GRAPHS.popitem(last=False)
    return cyc


def _operator_key(A, user_matvec, plan=None):
    """What the captured cycle reads through the operator: key and pins.

    A plan with a content fingerprint contributes its ``key`` (content,
    executed reorder, matvec mode); the identity of the tensors the graph
    reads stays in the key beside it, since a replay reads them by address.
    A plan-cache hit hands back the same operator, hence the same graph."""
    if user_matvec is not None:
        return ("matvec", id(user_matvec)), (user_matvec,)
    ell = A._ell() if isinstance(A, CSR) else A
    if isinstance(ell, ELL):
        key = ("ell", id(ell.vals), id(ell.cols))
        if plan is not None and plan.key[0] is not None:
            key = ("plan", plan.key) + key
        return key, (A, ell.vals, ell.cols)
    return ("obj", id(A)), (A,)


def _precond_key(p):
    if isinstance(p, IdentityPreconditioner):
        return ("identity",), ()
    if isinstance(p, JacobiPreconditioner):
        return ("jacobi", id(p.inv_diag)), (p.inv_diag,)
    if isinstance(p, CallablePreconditioner):
        return ("fn", id(p.fn)), (p.fn,)
    return ("obj", id(p)), (p,)


def _device_cycle_for(A, user_matvec, matvec, acc, eta, target, ortho,
                      precond, fused, plan=None, dist=LOCAL) -> _DeviceCycle:
    """The level's cycle: on CUDA from the cache (captured on first use),
    on the CPU a fresh one."""
    if torch.device(acc.device).type != "cuda":
        return _DeviceCycle(matvec, acc, eta, target, ortho, precond, fused,
                            dist=dist)
    op_key, op_pins = _operator_key(A, user_matvec, plan)
    pc_key, pc_pins = _precond_key(precond)
    key = (op_key, pc_key, acc.fmt, acc.m, acc.n, acc.arith_dtype,
           str(torch.device(acc.device)), type(ortho), ortho.name,
           float(eta), float(target), fused, dist.spec())
    return _cached_graph(key, lambda: _DeviceCycle(
        matvec, acc, eta, target, ortho, precond, fused, op_pins + pc_pins,
        dist))


def _zero_store(store) -> None:
    """Zero a basis store in place (a tensor or a dict of them)."""
    if isinstance(store, dict):
        for v in store.values():
            _zero_store(v)
    else:
        store.zero_()


# ---------------------------------------------------------------------------
# The restart loop both drivers share
# ---------------------------------------------------------------------------


def _solve_and_update(acc: BasisAccessor, store, R, g, j_stop: int, x0,
                      precond):
    """y = argmin ||beta e1 - H y|| (truncated at j_stop), x = x0 + M^{-1}V y.

    Only the live rows ``y[:j_stop]`` are combined: rows past ``j_stop`` may
    hold non-finite values after a breakdown, and a zero coefficient would
    not keep them out (0 * inf is nan)."""
    m = acc.m - 1
    active = np.arange(m) < j_stop
    # back substitution on the leading (j_stop, j_stop) block of R
    Rm = np.where(active[None, :] & active[:, None], R[:m, :m], 0.0)
    Rm = Rm + np.where(np.eye(m, dtype=bool) & ~active[:, None], 1.0, 0.0)
    gm = np.where(active, g[:m], 0.0)
    y = np.zeros(m)
    for jj in range(m - 1, -1, -1):
        yi = (gm[jj] - np.dot(Rm[jj], y)) / Rm[jj, jj]
        y[jj] = yi if active[jj] else 0.0
    yt = torch.as_tensor(y[:j_stop], dtype=acc.arith_dtype, device=x0.device)
    return x0 + precond.apply(acc.combine(store, yt))


def _block_solve_and_update(acc, store, R, G, j_stop: int, X0, precond):
    """Block least squares: ``Y = argmin ||G - R Y||`` over the leading
    ``j_stop`` block columns, then ``X = X0 + M^{-1} (V Y)``.

    ``R ((m+1)p, mp)`` is the rotated stacked Hessenberg, ``G ((m+1)p,
    p)`` the rotated rhs, both on the host.  Deflated directions have an
    exactly zero diagonal entry (their whole column is zero); they get a
    zero coefficient, which is the minimization over the deflated subspace
    (``repro/solver/gmres.py::_block_solve_and_update``).  The back
    substitution runs on the host in f64; only the ``j_stop`` live block
    rows are combined."""
    p = acc.p
    k = j_stop * p
    Rk = R[:k, :k]
    solved = np.abs(np.diagonal(Rk)) > _TINY
    Y = np.zeros((k, p))
    for jj in range(k - 1, -1, -1):
        if solved[jj]:
            Y[jj] = (G[jj] - Rk[jj, jj + 1:] @ Y[jj + 1:]) / Rk[jj, jj]
    Yt = torch.as_tensor(Y.reshape(j_stop, p, p), dtype=acc.arith_dtype,
                         device=X0.device)
    return X0 + _apply_rows(precond, acc.block_combine(store, Yt))


def _apply_rows(precond, X):
    """The right preconditioner on each row of ``X (p, n)``: the identity
    and Jacobi broadcast over the block, a user callable runs row by row."""
    if isinstance(precond, (IdentityPreconditioner, JacobiPreconditioner)):
        return precond.apply(X)
    return torch.stack([precond.apply(x) for x in X])


def _cycle_row_reads(j_stop: int, passes: int, extra_rows: int = 0) -> int:
    """Basis rows touched by one cycle of ``j_stop`` useful iterations.

    Per iteration j: 1 read_row + ``passes`` sweeps of dots+combine over the
    j+1 live rows; plus the solution-update combine over j_stop rows, plus
    the exact rows swept by conditional extra passes.
    """
    return j_stop * (2 + passes * (j_stop + 1)) + extra_rows


#: the device driver's host round trips, which the analysis gate
#: (``python -m repro_torch.analysis``) holds a warmed solve to exactly:
#: ``reads`` from the device (``||b||`` once a solve; the restart residual
#: at each loop head; the cycle's least squares and the explicit residual
#: after the update in each cycle), ``copies`` to it (the update's
#: coefficients, from the back substitution on the host, in each cycle).
#: A replayed cycle adds none.
HOST_TRAFFIC = dict(reads=dict(solve=1, restart=1, cycle=2),
                    copies=dict(solve=0, restart=0, cycle=1))


def _restart_loop(matvec, accs, policy, b, m, max_iters, target_rrn, ortho,
                  precond, cycle_for, x0=None, dist=LOCAL,
                  residual_matvec=None) -> GmresResult:
    """Restart until converged, stagnated or out of iterations.

    ``cycle_for(lvl)`` returns ``(store, run)`` for a policy level:
    ``run(r, beta, b_norm, b_norm_f)`` runs one cycle (``beta``, ``b_norm``
    0-d tensors, ``b_norm_f`` the same as a float) and returns ``(R, g,
    est, extra_rows, fired)`` on the host (``fired``: the cycle's steps
    where MGS re-orthogonalized, (m,) bool).  The explicit residuals apply
    ``residual_matvec`` (default: ``matvec``, which serves the cycles).
    Every value read on the host here is reduced by ``dist``, so the ranks
    of a sharded solve take the same decisions.
    """
    if residual_matvec is not None:
        matvec = residual_matvec
    arith_dtype = accs[0].arith_dtype
    b = b.to(arith_dtype)
    # a zero right-hand side divides by a floor, as the block method's
    # ``bn_safe`` does: its residual 0 converges at the first restart
    b_norm_t = torch.clamp(dist.norm(b), min=_norm_floor(arith_dtype))
    b_norm = b_norm_t.item()
    x = torch.zeros_like(b) if x0 is None else x0.to(arith_dtype)

    history: list[np.ndarray] = []
    restart_rrns: list[float] = []
    fired_steps: list[np.ndarray] = []
    total_iters = 0
    converged = False
    stagnated = False
    bytes_read = 0.0
    # operator passes: 1.0 up front for parity with the reference's device
    # driver (its eager rrn0); +1 per loop-head residual; +j_stop modelled
    # Arnoldi matvecs and +1 explicit post-update residual per cycle.
    op_reads = 1.0
    rrn = None

    while total_iters < max_iters and not converged:
        r = b - matvec(x).to(arith_dtype)
        beta_t = dist.norm(r)
        beta = beta_t.item()
        restart_rrns.append(beta / b_norm)
        op_reads += 1.0
        rrn = restart_rrns[-1]
        if rrn <= target_rrn:
            converged = True
            break
        lvl = int(policy.level(restart_rrns[-1], len(restart_rrns) - 1))
        acc = accs[lvl]
        store, run = cycle_for(lvl)
        R, g, est, extra_rows, fired = run(r, beta_t, b_norm_t, b_norm)
        fired_steps.append(fired)
        # first inner iteration that met the target (1-based count)
        hit = np.nonzero(est <= target_rrn)[0]
        j_stop = int(hit[0]) + 1 if hit.size else m
        x = _solve_and_update(acc, store, R, g, j_stop, x, precond)
        history.append(est[:j_stop])
        total_iters += j_stop
        bytes_read += _cycle_row_reads(j_stop, ortho.passes, extra_rows) * (
            acc.nbytes() / acc.m)
        op_reads += float(j_stop) + 1.0
        rrn = (dist.norm(b - matvec(x).to(arith_dtype)) / b_norm).item()
        if rrn <= target_rrn:
            converged = True
        elif hit.size:
            # implicit estimate said converged but explicit says no:
            # continue restarting (classic CB-GMRES behaviour — the
            # compressed basis made the estimate optimistic).
            if j_stop >= m and len(history) > 4 and np.allclose(
                history[-1][-1], history[-2][-1], rtol=1e-2
            ):
                stagnated = True
                break  # stagnation guard

    if rrn is None:        # max_iters < 1: loop never entered
        rrn = (dist.norm(b - matvec(x).to(arith_dtype)) / b_norm).item()

    return GmresResult(
        x=x,
        rrn=rrn,
        iterations=total_iters,
        converged=converged,
        rrn_history=(np.concatenate(history) if history
                     else np.zeros((0,), np.float64)),
        restart_rrns=np.asarray(restart_rrns),
        restarts=len(restart_rrns),
        bytes_read=bytes_read,
        stagnated=stagnated,
        op_reads=op_reads,
        fired=(np.stack(fired_steps) if fired_steps
               else np.zeros((0, m), bool)),
    )


def _gmres_host(matvec, accs, policy, b, m, max_iters, target_rrn, eta,
                ortho, precond, x0=None, dist=LOCAL) -> GmresResult:
    stores: dict[int, Any] = {}         # one store per policy level, on use

    def cycle_for(lvl):
        acc = accs[lvl]
        if lvl not in stores:
            stores[lvl] = acc.empty()
        store = stores[lvl]

        def run(r, beta, b_norm, b_norm_f):
            return _cycle(matvec, acc, b_norm_f, store, r, beta, eta,
                          target_rrn, ortho, precond, dist)
        return store, run

    return _restart_loop(matvec, accs, policy, b, m, max_iters, target_rrn,
                         ortho, precond, cycle_for, x0=x0, dist=dist)


def _gmres_device(A, user_matvec, matvec, accs, policy, b, m, max_iters,
                  target_rrn, eta, ortho, precond, x0=None, plan=None,
                  dist=LOCAL, residual_matvec=None) -> GmresResult:
    """The device driver.  A sharded ``dist`` runs each rank's chunk:
    ``matvec`` is the rank's partitioned matvec, ``residual_matvec`` its
    lossless twin for the explicit residuals, and each level's store is
    zeroed before its first cycle of the solve (after a capture's warm-up),
    as the reference starts every solve from empty stores: the coded dots'
    wire blocks span the stale rows too."""
    fused = (user_matvec is None
             and isinstance(precond, IdentityPreconditioner))
    cycles: dict[int, _DeviceCycle] = {}

    def cycle_for(lvl):
        cyc = cycles.get(lvl)
        if cyc is None:
            cyc = cycles[lvl] = _device_cycle_for(
                A, user_matvec, matvec, accs[lvl], eta, target_rrn, ortho,
                precond, fused, plan, dist)
            cyc.fresh = dist.sharded
        return cyc.store, lambda r, beta, b_norm, _: cyc(r, beta, b_norm)

    return _restart_loop(matvec, accs, policy, b, m, max_iters, target_rrn,
                         ortho, precond, cycle_for, x0=x0, dist=dist,
                         residual_matvec=residual_matvec)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _plan_unsharded(A, reorder: str, user_matvec):
    """Resolve ``reorder`` for a single-device solve; a plan or ``None``.

    ``"auto"`` is a no-op off the sharded path (the permutation only buys
    wire bytes, and an unsharded solve has no wire).  ``"rcm"`` forces the
    permutation: the solve then runs on ``plan.operator`` in permuted
    coordinates, and callers map ``b``/``x0`` in and ``x`` back out through
    the plan.  Plans are content-cached, so repeated solves of the same
    problem reuse the permutation and the permuted operator.
    """
    from repro_torch.sparse.plan import REORDERS, plan_operator

    if reorder not in REORDERS:
        raise ValueError(f"unknown reorder mode {reorder!r}; "
                         f"expected one of {REORDERS}")
    if reorder != "rcm":
        return None
    if user_matvec is not None or A is None:
        raise ValueError(
            "reorder='rcm' needs an operator with an inspectable sparsity "
            "pattern (CSR/ELL); a bare matvec callable cannot be reordered")
    return plan_operator(A, 1, reorder="rcm")


def _permuted_precond(precond, plan):
    """Map a user-supplied preconditioner into the plan's coordinates."""
    from repro_torch.solver.pipeline import Preconditioner

    if plan is None or plan.perm is None or precond is None:
        return precond
    if isinstance(precond, Preconditioner):
        return precond.permuted(plan.perm)
    if callable(precond):
        raise ValueError(
            "cannot reorder with a bare callable preconditioner hook: its "
            "coordinate convention is unknown; wrap it in a Preconditioner "
            "with permuted() or pass reorder='none'")
    return precond               # names resolve against plan.operator


def _apply_plan(plan, A, precond, vectors):
    """The operator, preconditioner and ``vectors`` (each a tensor or
    ``None``) in the plan's coordinates; unchanged without a plan."""
    if plan is None:
        return A, precond, vectors
    return (plan.operator, _permuted_precond(precond, plan),
            [None if v is None else plan.permute(v) for v in vectors])


def gmres(
    A: Any,
    b: torch.Tensor,
    *,
    x0: torch.Tensor | None = None,
    storage: Any = None,
    policy: Any = None,
    precond: Any = None,
    ortho: Any = "mgs",
    m: int = 100,
    max_iters: int = 20000,
    target_rrn: float = 1e-14,
    arith_dtype: Any = None,
    eta: float = 0.7071067811865475,
    matvec: Callable | None = None,
    driver: str = "device",
    shard: int | None = None,
    shard_transport: str = "plain",
    shard_matvec: str = "auto",
    shard_grid: Any = None,
    reorder: str = "auto",
) -> GmresResult:
    """Solve A x = b with restarted (CB-)GMRES on the device of ``b``.

    ``A`` is anything with ``.matvec`` (CSR/ELL) unless ``matvec`` is given.
    ``storage`` is a storage format object or name ('float64', 'float32',
    'frsz2_32', 'mixed:2:frsz2_32', ...; default: the arithmetic dtype).
    ``policy`` selects the format per restart cycle ('adaptive',
    'adaptive:auto', 'adaptive:<f0>,<f1>@<t1>,...', 'static:<fmt>') and
    overrides ``storage``.  ``precond`` is 'jacobi', a callable or a
    :class:`~repro_torch.solver.pipeline.Preconditioner`; ``ortho`` is
    'mgs' or 'cgs2'.

    ``driver`` is ``"device"`` (default: each restart cycle runs on the
    device with no host read, replayed as one CUDA graph per policy level on
    the card, one host read per restart) or ``"host"`` (the host-looped
    parity oracle, one host read per Arnoldi step).  Both give the same
    iterations, ``bytes_read`` and ``op_reads``.

    ``shard=P`` runs the device driver on P ranks of a live
    ``torch.distributed`` process group of P ranks (one process per GPU;
    :mod:`repro_torch.solver.sharded`): every rank calls ``gmres`` with the
    whole ``A`` and ``b``, keeps its chunk of every vector and of the basis,
    and returns the whole result.  ``shard_transport`` is the wire format
    of the reductions: ``"plain"`` (all-reduce), ``"compressed"`` (the
    basis' partial dots as FRSZ2 codes) or ``"compressed+norms"`` (the
    norms too).  ``shard_matvec`` picks the partitioned SpMV (``"auto"``,
    ``"halo"``, ``"rows"``, ``"replicated"``, ``"block3d"``;
    :func:`repro_torch.sparse.shard.partition_matvec`), ``shard_grid`` the
    block partition's ``(Px, Py, Pz)``.

    ``reorder`` applies an RCM bandwidth-reduction permutation at setup
    (:mod:`repro_torch.sparse.plan`): ``"rcm"`` forces it (the solve runs
    in permuted coordinates; ``b``/``x0`` are mapped in and ``x`` back out
    transparently), ``"auto"`` (default) permutes only where it unlocks
    the sharded halo matvec, ``"none"`` never.
    """
    if driver not in ("device", "host"):
        raise ValueError(f"unknown driver {driver!r}; "
                         "expected one of ('device', 'host')")
    if shard is not None:
        if driver != "device":
            raise ValueError("shard= requires the device driver")
        from repro_torch.solver.sharded import sharded_gmres

        return sharded_gmres(
            A, b, x0=x0, storage=storage, policy=policy, precond=precond,
            ortho=ortho, m=m, max_iters=max_iters, target_rrn=target_rrn,
            arith_dtype=arith_dtype, eta=eta, matvec=matvec, shard=shard,
            transport=shard_transport, partition_mode=shard_matvec,
            reorder=reorder, pgrid=shard_grid)
    user_matvec = matvec
    plan = _plan_unsharded(A, reorder, user_matvec)
    A, precond, (b, x0) = _apply_plan(plan, A, precond, (b, x0))
    if arith_dtype is None:
        arith_dtype = b.dtype
    if matvec is None:
        matvec = A.matvec
    policy = resolve_policy(policy, storage, arith_dtype, target_rrn, m)
    accs = tuple(
        BasisAccessor(fmt=f, m=m + 1, n=b.shape[0], arith_dtype=arith_dtype,
                      device=b.device)
        for f in policy.formats())
    precond = resolve_preconditioner(precond, A)
    ortho = orthogonalizer_by_name(ortho)
    b = b.to(arith_dtype)
    if driver == "host":
        res = _gmres_host(matvec, accs, policy, b, m, max_iters, target_rrn,
                          eta, ortho, precond, x0=x0)
    else:
        res = _gmres_device(A, user_matvec, matvec, accs, policy, b, m,
                            max_iters, target_rrn, eta, ortho, precond,
                            x0=x0, plan=plan)
    if plan is not None:
        res.x = plan.unpermute(res.x)
    return res


def gmres_batched(
    A: Any,
    B: torch.Tensor,
    *,
    X0: torch.Tensor | None = None,
    storage: Any = None,
    policy: Any = None,
    precond: Any = None,
    ortho: Any = "mgs",
    m: int = 100,
    max_iters: int = 20000,
    target_rrn: float = 1e-14,
    arith_dtype: Any = None,
    eta: float = 0.7071067811865475,
    matvec: Callable | None = None,
    method: str = "vmap",
    driver: str = "device",
    shard: int | None = None,
    shard_transport: str = "plain",
    shard_matvec: str = "auto",
    shard_grid: Any = None,
    reorder: str = "auto",
) -> list[GmresResult]:
    """Solve A X[i] = B[i] for a batch of right-hand sides ``B (k, n)``.

    ``method="vmap"`` (default) solves the k systems one after another in
    k independent Krylov spaces through :func:`gmres` with the ``driver``
    asked for (the device driver's captured cycle is reused from one system
    to the next): each system gets the bits of its own solve, and the
    results' ``bytes_read``/``op_reads`` sum over the batch as the JAX
    package's vmapped solve does.  ``method="block"`` shares one block
    Krylov space (:func:`repro_torch.solver.block.gmres_block`): every
    Arnoldi sweep reads the operator and the shared basis once for the
    whole batch.  Returns one :class:`GmresResult` per right-hand side.
    ``shard`` and its options are :func:`gmres`'s: every rank solves its
    chunks of all k systems (one exchange a block matvec for ``block``).
    """
    if B.ndim != 2:
        raise ValueError(f"B must be (batch, n), got {tuple(B.shape)}")
    if method not in ("vmap", "block"):
        raise ValueError(f"unknown batched method {method!r}; "
                         "expected one of ('vmap', 'block')")
    if driver not in ("device", "host"):
        raise ValueError(f"unknown driver {driver!r}; "
                         "expected one of ('device', 'host')")
    if shard is not None:
        if driver != "device":
            raise ValueError("shard= requires the device driver")
        from repro_torch.solver.sharded import sharded_gmres

        return sharded_gmres(
            A, B, batched=True, x0=X0, storage=storage, policy=policy,
            precond=precond, ortho=ortho, m=m, max_iters=max_iters,
            target_rrn=target_rrn, arith_dtype=arith_dtype, eta=eta,
            matvec=matvec, shard=shard, transport=shard_transport,
            partition_mode=shard_matvec, reorder=reorder, method=method,
            pgrid=shard_grid)
    kw = dict(storage=storage, policy=policy, precond=precond, ortho=ortho,
              m=m, max_iters=max_iters, target_rrn=target_rrn,
              arith_dtype=arith_dtype, eta=eta, matvec=matvec, driver=driver,
              reorder=reorder)
    if method == "block":
        from repro_torch.solver.block import gmres_block

        return gmres_block(A, B, X0=X0, **kw)
    return [gmres(A, B[i], x0=None if X0 is None else X0[i], **kw)
            for i in range(B.shape[0])]


def cb_gmres(A, b, storage="frsz2_32", **kw) -> GmresResult:
    """Compressed-Basis GMRES: GMRES with a non-native storage format."""
    return gmres(A, b, storage=storage, **kw)
