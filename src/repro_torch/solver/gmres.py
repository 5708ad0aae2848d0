"""Restarted GMRES(m) with a compressed Krylov basis (CB-GMRES, paper Fig. 1).

The port of ``repro/solver/gmres.py``'s host-looped driver, decision for
decision:

  * Arnoldi with the orthogonalization expressed as the two Accessor hot
    loops ``h = V_j w`` (dots) and ``w -= V_j^T h`` (combine);
  * conditional re-orthogonalization when ``h_{j+1,j} < eta * ||w_pre||``;
  * Givens-rotation least squares on the Hessenberg matrix, giving the
    implicit residual estimate ``|g_{j+1}|`` per inner iteration;
  * restart after ``m`` vectors with the explicit residual recomputed;
  * the basis behind a :class:`~repro_torch.core.accessor.BasisAccessor` in
    any storage format: float64/float32/float16, FRSZ2 (the Hopper kernels
    on the card), or mixed.

Vectors live on the device of ``b``; the small Hessenberg least-squares
problem (at most ``(m+1) x m``) lives on the host in f64, so each Arnoldi
step reads its Hessenberg column once.  Every result carries ``bytes_read``
(the modelled basis read traffic) and ``op_reads`` (modelled operator
passes), computed exactly as the reference's host driver computes them.

The reference's device-resident driver (one ``lax.while_loop``) has no
counterpart yet: it needs a CUDA-graph capture of one cycle.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.core.accessor import BasisAccessor
from repro_torch.dist.context import LOCAL
from repro_torch.solver.pipeline import (
    orthogonalizer_by_name,
    resolve_policy,
    resolve_preconditioner,
)

__all__ = ["GmresResult", "gmres", "gmres_batched", "cb_gmres"]

_TINY = 1e-300

_DEVICE_DRIVER = ("driver='device' (the device-resident restart loop) is not "
                  "ported yet: it needs a CUDA-graph capture of one cycle "
                  "(ROADMAP.md, open item 1, queue 7); use driver='host'")


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


def _givens(a: float, b: float) -> tuple[float, float]:
    """Stable Givens rotation: (c, s) with [c s; -s c]ᵀ [a;b] = [r;0]."""
    denom = math.sqrt(a * a + b * b)
    if denom > 0:
        return a / denom, b / denom
    return 1.0, 0.0


def _cycle(matvec: Callable, acc: BasisAccessor, b_norm: float, store, w0,
           beta: float, eta: float, target: float, ortho, precond,
           dist=LOCAL):
    """One GMRES(m) cycle.  w0 = r0 (unnormalized); beta = ||r0||.

    Writes the basis into ``store`` in place and returns ``(R, g, est,
    extra_rows)``: the rotated Hessenberg ``R`` (m+1, m), the rotated rhs
    ``g`` (m+1,), the implicit residual estimate per inner iteration, and
    the count of basis rows swept by extra (conditional) orthogonalization
    passes of live iterations.

    In the reference every one of the ``m`` iterations runs and an
    ``alive`` flag masks those after the estimate met the target (or the
    Arnoldi process broke down): their Hessenberg columns are not taken,
    their ``est`` entries repeat the last live one, and they add nothing to
    ``extra_rows``.  Here the loop stops once ``alive`` drops and fills
    ``est`` the same way, which gives the same results.
    """
    m = acc.m - 1
    acc.write_row(store, 0, w0 / max(beta, _TINY))

    R = np.zeros((m + 1, m))
    g = np.zeros(m + 1)
    g[0] = beta
    cs = np.zeros(m)
    sn = np.zeros(m)
    est = np.full(m, np.inf)
    extra_rows = 0

    for j in range(m):
        v = acc.read_row(store, j)
        w = matvec(precond.apply(v)).to(acc.arith_dtype)
        w_pre = dist.norm(w)
        w, h, hj1, fired = ortho(acc, store, w, j + 1, eta, dist, w_pre)
        extra_rows += fired * (j + 1)

        *col, hj1, w_pre = torch.cat(
            [h, torch.stack([hj1, w_pre])]).tolist()  # one host read per step
        breakdown = hj1 <= 1e-30 * w_pre + _TINY
        acc.write_row(store, j + 1, w / max(hj1, _TINY))

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
    return R, g, est, extra_rows


def _solve_and_update(acc: BasisAccessor, store, R, g, j_stop: int, x0,
                      precond):
    """y = argmin ||beta e1 - H y|| (truncated at j_stop), x = x0 + M^{-1}V y."""
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


def _cycle_row_reads(j_stop: int, passes: int, extra_rows: int = 0) -> int:
    """Basis rows touched by one cycle of ``j_stop`` useful iterations.

    Per iteration j: 1 read_row + ``passes`` sweeps of dots+combine over the
    j+1 live rows; plus the solution-update combine over j_stop rows, plus
    the exact rows swept by conditional extra passes.
    """
    return j_stop * (2 + passes * (j_stop + 1)) + extra_rows


def _gmres_host(matvec, accs, policy, b, m, max_iters, target_rrn, eta,
                ortho, precond, x0=None, dist=LOCAL) -> GmresResult:
    arith_dtype = accs[0].arith_dtype
    b = b.to(arith_dtype)
    b_norm = dist.norm(b).item()
    x = torch.zeros_like(b) if x0 is None else x0.to(arith_dtype)

    stores: dict[int, Any] = {}         # one store per policy level, on use
    history: list[np.ndarray] = []
    restart_rrns: list[float] = []
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
        beta = dist.norm(r).item()
        restart_rrns.append(beta / b_norm)
        op_reads += 1.0
        rrn = restart_rrns[-1]
        if rrn <= target_rrn:
            converged = True
            break
        lvl = int(policy.level(restart_rrns[-1], len(restart_rrns) - 1))
        acc = accs[lvl]
        if lvl not in stores:
            stores[lvl] = acc.empty()
        R, g, est, extra_rows = _cycle(matvec, acc, b_norm, stores[lvl], r,
                                       beta, eta, target_rrn, ortho, precond,
                                       dist)
        # first inner iteration that met the target (1-based count)
        hit = np.nonzero(est <= target_rrn)[0]
        j_stop = int(hit[0]) + 1 if hit.size else m
        x = _solve_and_update(acc, stores[lvl], R, g, j_stop, x, precond)
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
    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_REORDERS = ("auto", "rcm", "none")


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
    driver: str = "host",
    shard: int | None = None,
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

    ``driver`` is ``"host"`` (the host-looped driver, one host read per
    Arnoldi step); ``"device"`` is not ported yet and raises.  ``shard`` and
    ``reorder="rcm"`` are not ported yet either; ``reorder="auto"`` is a
    no-op off the sharded path, as in the reference.
    """
    if driver == "device":
        raise NotImplementedError(_DEVICE_DRIVER)
    if driver != "host":
        raise ValueError(f"unknown driver {driver!r}")
    if shard is not None:
        raise NotImplementedError(
            "shard= (the multi-GPU solve) is not ported yet "
            "(ROADMAP.md, open item 1, queue 11)")
    if reorder not in _REORDERS:
        raise ValueError(f"unknown reorder mode {reorder!r}; "
                         f"expected one of {_REORDERS}")
    if reorder == "rcm":
        raise NotImplementedError(
            "reorder='rcm' (operator planning) is not ported yet "
            "(ROADMAP.md, open item 1, queue 10)")
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
    return _gmres_host(matvec, accs, policy, b.to(arith_dtype), m, max_iters,
                       target_rrn, eta, ortho, precond, x0=x0)


def gmres_batched(A, B, **kw):
    """Several right-hand sides at once: not ported yet."""
    raise NotImplementedError(
        "gmres_batched (vmap and block multi-RHS) is not ported yet "
        "(ROADMAP.md, open item 1, queues 7 and 9)")


def cb_gmres(A, b, storage="frsz2_32", **kw) -> GmresResult:
    """Compressed-Basis GMRES: GMRES with a non-native storage format."""
    return gmres(A, b, storage=storage, **kw)
