"""Block-GMRES: one shared Krylov basis for a whole batch of right-hand sides.

The port of ``repro/solver/block.py``.  ``gmres_batched(method="vmap")``
solves p systems in p independent Krylov spaces, reading the operator and p
separate bases p times per sweep.  The block cycle here carries one basis of
block vectors ``V (m+1, p, n)``: every Arnoldi sweep applies the operator to
a block (one batched ELL launch) and reads the shared basis once for all p
right-hand sides, through the fused FRSZ2 block kernels when the basis is
compressed (:class:`~repro_torch.core.accessor.BlockBasisAccessor`).

Per restart cycle (:func:`_block_cycle`), as the reference:

  1. rank-revealing QR of the residual block
     (:func:`~repro_torch.solver.pipeline.block_qr`): converged right-hand
     sides enter as zero columns and deflate, as do dependent residuals;
  2. block Arnoldi: ``W = A M^{-1} V_j``, block MGS/CGS-2 against the live
     block rows, QR of the orthogonalized block with deflation;
  3. the banded least squares, p pivot-paired Givens rotations per column,
     one kernel per block step (``ops.block_givens_step``), giving each
     column's implicit residual estimate;
  4. all m block steps run, with an ``alive`` flag, as the reference's
     ``fori_loop`` runs them.

Two drivers share the restart loop (:func:`_block_restart_loop`: explicit
block residual, per-column convergence, the shared stagnation guard, the
host back substitution, ``bytes_read``/``op_reads``) and the cycle:

  * ``driver="device"``: on CUDA the cycle of each policy level is captured
    once as a CUDA graph (cached by the identity of the operator and
    preconditioner tensors, which it pins) and replayed per restart, with
    one host read per restart; on the CPU it runs eagerly;
  * ``driver="host"``: the same cycle run eagerly with the orthogonalizer's
    eager form (MGS reads its ``fired`` flag on the host).

Both give the same bits.  Each result carries its ``1/p`` share of the
batch's shared ``bytes_read`` and ``op_reads``, so sums over the batch are
comparable with the vmap method's.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.core.accessor import BlockBasisAccessor
from repro_torch.dist.context import LOCAL
from repro_torch.kernels import ops, ref
from repro_torch.solver.gmres import (
    GmresResult,
    _apply_rows,
    _block_solve_and_update,
    _cached_graph,
    _capture,
    _check_unported,
    _cycle_row_reads,
    _norm_floor,
    _operator_key,
    _precond_key,
    _replay,
)
from repro_torch.solver.pipeline import (
    block_orthogonalizer_by_name,
    block_qr,
    resolve_policy,
    resolve_preconditioner,
)
from repro_torch.sparse.csr import CSR, ELL

__all__ = ["gmres_block"]


def _block_cycle(bmv: Callable, acc: BlockBasisAccessor, store, state, init,
                 W0, bn_safe, eta: float, target: float, ortho,
                 branch_free: bool, dist=LOCAL) -> None:
    """One block-GMRES(m) cycle from the residual block ``W0 (p, n)``
    (converged columns already zeroed: they deflate in the first QR and
    stay dead for the cycle).

    Writes the basis into ``store`` and the least squares into ``state``
    (f64, :func:`repro_torch.kernels.ref.block_givens_layout`: the rotated
    stacked Hessenberg ``R``, the rotated rhs ``G``, the per-step
    per-column estimates ``est (m, p)``, the extra swept block rows), in
    place and with no host read if ``branch_free``.
    """
    mb = acc.m - 1
    p = acc.p
    L = ref.block_givens_layout(mb, p)
    Q0, S, _ = block_qr(W0, dist)
    acc.write_block(store, 0, Q0)
    state.copy_(init)
    state[L["G"]:L["G"] + p * p].copy_(S.reshape(-1))
    orth = ortho.branch_free if branch_free else ortho
    for j in range(mb):
        W = bmv(acc.read_block(store, j)).to(acc.arith_dtype)
        w_pre = dist.col_norms(W)
        Q, H, T, fired = orth(acc, store, W, j + 1, eta, dist, w_pre)
        acc.write_block(store, j + 1, Q)
        if not torch.is_tensor(fired):
            fired = torch.tensor(bool(fired), device=state.device)
        ops.block_givens_step(state, H, T, fired, bn_safe, j, mb, p, target)


class _BlockCycle:
    """The block cycle of one policy level, with its own basis store,
    least-squares state and static inputs ``W0``/``bn_safe``.

    ``branch_free`` (the device driver) on CUDA: captured on the first call
    and replayed on every call (launch counts as :func:`_capture` keeps
    them).  Otherwise the cycle runs eagerly on every call."""

    def __init__(self, bmv, acc: BlockBasisAccessor, eta: float,
                 target: float, ortho, branch_free: bool, pins=()):
        self.acc = acc
        self.store = acc.empty()
        self.init = ref.block_givens_init_ref(acc.m - 1, acc.p, acc.device)
        self.state = torch.empty_like(self.init)
        dev = self.init.device
        self.W0 = torch.empty((acc.p, acc.n), dtype=acc.arith_dtype,
                              device=dev)
        self.bn = torch.empty((acc.p,), dtype=acc.arith_dtype, device=dev)
        self._args = (bmv, eta, target, ortho, branch_free)
        self.capture = branch_free and self.state.is_cuda
        self.pins = pins            # keeps the tensors the graph reads alive
        self.graph = None
        self.launches: dict[str, int] = {}

    def _run(self) -> None:
        bmv, eta, target, ortho, branch_free = self._args
        _block_cycle(bmv, self.acc, self.store, self.state, self.init,
                     self.W0, self.bn, eta, target, ortho, branch_free)

    def __call__(self, W0, bn_safe):
        self.W0.copy_(W0)
        self.bn.copy_(bn_safe)
        if self.capture:
            if self.graph is None:
                self.graph, self.launches = _capture(self._run)
            _replay(self.graph, self.launches)
        else:
            self._run()
        mb, p = self.acc.m - 1, self.acc.p
        mp = mb * p
        L = ref.block_givens_layout(mb, p)
        # one host read per restart (a copy: the next cycle overwrites it)
        out = self.state[:L["cs"]].cpu().numpy().copy()
        return (out[:L["G"]].reshape(mp + p, mp),
                out[L["G"]:L["est"]].reshape(mp + p, p),
                out[L["est"]:L["extra"]].reshape(mb, p),
                int(out[L["extra"]]))


def _cycle_stops(col_hit: np.ndarray, mb: int):
    """Shared and per-column stopping points from ``col_hit (m, p)``.

    The cycle is truncated at ``j_stop``, the first block step where every
    column's estimate met the target (else m); each column's own iteration
    count stops at its first hit, or at the shared stop.  Deflated columns
    have zero estimates: they hit at once and never hold the block back."""
    all_hit = col_hit.all(axis=1)
    hit = np.nonzero(all_hit)[0]
    j_stop = int(hit[0]) + 1 if hit.size else mb
    hit_b = col_hit.any(axis=0)
    first_b = np.where(hit_b, col_hit.argmax(axis=0) + 1, j_stop)
    return bool(hit.size), j_stop, np.minimum(first_b, j_stop)


def _block_results(X, rrn, total, converged, history, restart_rrns,
                   nbytes: float, op_reads: float,
                   stagnated: bool) -> list[GmresResult]:
    """One :class:`GmresResult` per right-hand side, each with its ``1/p``
    share of the batch's shared ``bytes_read``/``op_reads``; rows of
    ``rrn_history`` are block steps."""
    p = X.shape[0]
    hist = (np.concatenate(history, axis=0) if history
            else np.zeros((0, p)))
    rsts = np.stack(restart_rrns) if restart_rrns else np.zeros((0, p))
    return [
        GmresResult(x=X[b], rrn=float(rrn[b]), iterations=int(total[b]),
                    converged=bool(converged[b]),
                    rrn_history=hist[:, b].copy(),
                    restart_rrns=rsts[:, b].copy(),
                    restarts=len(restart_rrns), bytes_read=nbytes / p,
                    stagnated=stagnated, op_reads=op_reads / p)
        for b in range(p)
    ]


def _block_restart_loop(bmv_r, accs, policy, B, m, max_iters, target_rrn,
                        ortho, precond, cycle_for, X0=None,
                        dist=LOCAL) -> list[GmresResult]:
    """Restart until every column converged, the guard fired or the block
    steps ran out (``repro/solver/block.py::_gmres_block_host``, decision for
    decision).  ``cycle_for(lvl)`` returns ``(store, run)``; ``run(W0,
    bn_safe)`` runs one cycle and returns ``(R, G, est, extra_rows)`` on
    the host."""
    ad = accs[0].arith_dtype
    p = accs[0].p
    B = B.to(ad)
    bn_safe = torch.clamp(dist.col_norms(B), min=_norm_floor(ad))
    X = torch.zeros_like(B) if X0 is None else X0.to(ad)

    def rel_res(X):
        return (dist.col_norms(B - bmv_r(X).to(ad)) / bn_safe).cpu().numpy()

    history: list[np.ndarray] = []
    restart_rrns: list[np.ndarray] = []
    total = np.zeros((p,), np.int64)
    blocks = 0
    cycles = 0
    converged = np.zeros((p,), bool)
    stagnated = False
    nbytes = 0.0
    op_reads = 1.0               # parity with the reference's rrn0 residual
    prev_last = np.inf
    rrn = None

    while blocks < max_iters and not converged.all() and not stagnated:
        R0v = B - bmv_r(X).to(ad)
        rr = (dist.col_norms(R0v) / bn_safe).cpu().numpy()
        restart_rrns.append(rr)
        op_reads += 1.0
        rrn = rr
        active = rr > target_rrn
        if not active.any():
            converged = rr <= target_rrn
            break
        lvl = int(policy.level(float(np.max(np.where(active, rr, 0.0))),
                               cycles))
        acc = accs[lvl]
        store, run = cycle_for(lvl)
        live = torch.as_tensor(active, device=B.device)[:, None]
        R, G, est, extra_rows = run(torch.where(live, R0v, 0.0), bn_safe)
        hit_any, j_stop, j_stop_b = _cycle_stops(est <= target_rrn, m)
        X = _block_solve_and_update(acc, store, R, G, j_stop, X, precond)
        history.append(est[:j_stop])
        blocks += j_stop
        total += np.where(active, j_stop_b, 0)
        cycles += 1
        nbytes += _cycle_row_reads(j_stop, ortho.passes, extra_rows) * (
            acc.nbytes() / acc.m)
        op_reads += float(j_stop) + 1.0
        rrn = rel_res(X)
        converged = rrn <= target_rrn
        last = float(np.max(np.where(active, est[max(j_stop - 1, 0)], 0.0)))
        if (not converged.all() and hit_any and j_stop >= m and cycles > 4
                and abs(last - prev_last) <= 1e-8 + 1e-2 * abs(prev_last)):
            stagnated = True
        prev_last = last

    if rrn is None:              # max_iters < 1: loop never entered
        rrn = rel_res(X)
    return _block_results(X, rrn, total, converged, history, restart_rrns,
                          nbytes, op_reads, stagnated)


def _block_matvec(A, user_matvec, precond=None) -> Callable:
    """``X (p, n) -> A M^{-1} X`` row by row: a CSR/ELL operator takes the
    block in one launch, a user matvec runs per row."""
    if user_matvec is None and isinstance(A, (CSR, ELL)):
        mv = A.matvec
    else:
        one = A.matvec if user_matvec is None else user_matvec

        def mv(X):
            return torch.stack([one(x) for x in X])
    if precond is None:
        return mv
    return lambda X: mv(_apply_rows(precond, X))


def gmres_block(
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
    driver: str = "device",
    shard: int | None = None,
    reorder: str = "auto",
) -> list[GmresResult]:
    """Solve A X[b] = B[b] for all p right-hand sides with block-GMRES, on
    the device of ``B``.

    The front door is ``gmres_batched(..., method="block")``; the pipeline
    arguments are those of :func:`repro_torch.solver.gmres.gmres`
    (``ortho`` names a block orthogonalizer: ``"mgs"`` or ``"cgs2"``).
    ``max_iters`` bounds the block steps, hence each column's iterations.
    """
    if B.ndim != 2:
        raise ValueError(f"B must be (batch, n), got {tuple(B.shape)}")
    if driver not in ("device", "host"):
        raise ValueError(f"unknown driver {driver!r}; "
                         "expected one of ('device', 'host')")
    _check_unported(shard, reorder)
    if arith_dtype is None:
        arith_dtype = B.dtype
    policy = resolve_policy(policy, storage, arith_dtype, target_rrn, m)
    p, n = B.shape
    accs = tuple(
        BlockBasisAccessor(fmt=f, m=m + 1, p=p, n=n, arith_dtype=arith_dtype,
                           device=B.device)
        for f in policy.formats())
    precond = resolve_preconditioner(precond, A)
    ortho = block_orthogonalizer_by_name(ortho)
    bmv = _block_matvec(A, matvec, precond)
    branch_free = driver == "device"
    cycles: dict[int, _BlockCycle] = {}

    def build(lvl, pins=()):
        return _BlockCycle(bmv, accs[lvl], eta, target_rrn, ortho,
                           branch_free, pins)

    def cycle_for(lvl):
        cyc = cycles.get(lvl)
        if cyc is None:
            acc = accs[lvl]
            if branch_free and torch.device(acc.device).type == "cuda":
                op_key, op_pins = _operator_key(A, matvec)
                pc_key, pc_pins = _precond_key(precond)
                key = ("block", op_key, pc_key, acc.fmt, acc.m, acc.p, acc.n,
                       acc.arith_dtype, str(torch.device(acc.device)),
                       type(ortho), ortho.name, float(eta), float(target_rrn))
                cyc = _cached_graph(key, lambda: build(lvl, op_pins + pc_pins))
            else:
                cyc = build(lvl)
            cycles[lvl] = cyc
        return cyc.store, cyc

    return _block_restart_loop(_block_matvec(A, matvec), accs, policy, B, m,
                               max_iters, target_rrn, ortho, precond,
                               cycle_for, X0=X0)
