"""Composable GMRES cycle pipeline: the three pluggable stages.

The port of ``repro/solver/pipeline.py``:

  * :class:`Orthogonalizer` — how ``w`` is orthogonalized against the live
    basis rows each Arnoldi step.  ``mgs`` is the seed scheme (one-shot
    dots/combine plus the conditional "twice is enough" re-orthogonalization,
    paper Fig. 1 steps 6-10); ``cgs2`` always runs two passes.
    :class:`BlockOrthogonalizer` is the same for block-GMRES: a block
    ``W (p, n)`` against the shared block basis, then the rank-revealing
    :func:`block_qr` that deflates dependent and converged columns.
  * :class:`Preconditioner` — right preconditioning ``A M^{-1}``: identity,
    Jacobi (``M = diag(A)``), or a user-callable hook.
  * :class:`PrecisionPolicy` — which storage format holds the Krylov basis,
    chosen per restart cycle from the explicit restart residual.

Each orthogonalizer, scalar or block, has two forms.  ``__call__`` is the host driver's:
PyTorch runs eagerly, so MGS reads its ``fired`` flag on the host once per
iteration and runs the second pass only when it fires.  ``branch_free`` is
the device driver's, with no host read, so that a CUDA graph can hold it:
MGS runs the second pass under :func:`repro_torch.solver.graphs.device_if`
keyed on ``fired`` (a 0-d device tensor), as the reference runs it under
``lax.cond``.  In a captured cycle that is an IF node, which runs the pass
only where it fires; eagerly (a capture's warm-up, the CPU) the pass runs
and ``torch.where`` keeps the first pass's bits where it does not fire, as
it does at every step of a cycle sharded over more than one rank
(:func:`_second_pass`).  Both forms give the same bits.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core.accessor import NativeFormat, StorageFormat, format_by_name
from repro_torch.dist.context import LOCAL
from repro_torch.solver import graphs

__all__ = [
    "Orthogonalizer",
    "MGSOrthogonalizer",
    "CGS2Orthogonalizer",
    "orthogonalizer_by_name",
    "DEFLATE_RTOL",
    "block_qr",
    "BlockOrthogonalizer",
    "BlockMGSOrthogonalizer",
    "BlockCGS2Orthogonalizer",
    "block_orthogonalizer_by_name",
    "Preconditioner",
    "IdentityPreconditioner",
    "JacobiPreconditioner",
    "CallablePreconditioner",
    "resolve_preconditioner",
    "PrecisionPolicy",
    "StaticPolicy",
    "AdaptivePolicy",
    "policy_by_name",
    "resolve_policy",
]


# ---------------------------------------------------------------------------
# Orthogonalizers
# ---------------------------------------------------------------------------


def _second_pass(fired: torch.Tensor, dist):
    """Where MGS's second pass runs in a branch-free cycle: inside an IF
    node (:func:`~repro_torch.solver.graphs.device_if`), except in a cycle
    sharded over more than one rank, whose NCCL collectives CUDA does not
    take inside a conditional node: there the pass runs at every step and
    ``torch.where`` keeps the first pass's bits where it does not fire
    (:func:`~repro_torch.solver.graphs.select`).  Decided by ``dist`` when
    the cycle is built, so a capture never falls back."""
    if dist.sharded and torch.distributed.get_world_size(dist.group) > 1:
        return graphs.select(fired)
    return graphs.device_if(fired)


class Orthogonalizer:
    """Orthogonalize ``w`` against the first ``rows`` rows of the basis.

    ``__call__(acc, store, w, rows, eta, dist, w_norm) -> (w_orth, h, hj1,
    fired)``: ``h`` (``rows``,) is the Hessenberg column, ``hj1 =
    ||w_orth||`` (a 0-d tensor), and ``fired`` (a Python int) counts an
    *extra* basis sweep beyond the nominal ``passes`` (MGS's conditional
    re-orthogonalization) — the driver folds it into ``bytes_read``.
    ``w_norm`` is the caller's already-computed ``||w||``.
    """

    name: str = "base"
    passes: int = 1

    def __call__(self, acc, store, w, rows, eta, dist=LOCAL,
                 w_norm=None):  # pragma: no cover
        raise NotImplementedError

    def branch_free(self, acc, store, w, rows, eta, dist=LOCAL,
                    w_norm=None):  # pragma: no cover
        """As ``__call__`` with no host read: ``fired`` is a 0-d bool tensor
        on the device of ``w``."""
        raise NotImplementedError


class MGSOrthogonalizer(Orthogonalizer):
    """Seed scheme: one-shot dots/combine + conditional re-orthogonalization
    iff ``||w_orth|| < eta * ||w||`` (the "twice is enough" criterion)."""

    name = "mgs"
    passes = 1

    def __call__(self, acc, store, w, rows, eta, dist=LOCAL, w_norm=None):
        w_pre = dist.norm(w) if w_norm is None else w_norm
        h = acc.dots(store, w, rows)
        w = w - acc.combine(store, h)
        hj1 = dist.norm(w)
        fired = bool(hj1 < eta * w_pre)          # one host read per iteration
        if fired:
            u = acc.dots(store, w, rows)
            w = w - acc.combine(store, u)
            h = h + u
            hj1 = dist.norm(w)
        return w, h, hj1, int(fired)

    def branch_free(self, acc, store, w, rows, eta, dist=LOCAL, w_norm=None):
        w_pre = dist.norm(w) if w_norm is None else w_norm
        h = acc.dots(store, w, rows)
        w = w - acc.combine(store, h)
        hj1 = dist.norm(w)
        fired = hj1 < eta * w_pre
        # the second pass where it fires, in place (an IF node in a captured
        # cycle; eagerly, torch.where keeps the first pass's bits where it
        # does not: a zero coefficient would not, 0 * inf is nan once a
        # breakdown has put non-finite rows in the basis)
        with _second_pass(fired, dist) as put:
            u = acc.dots(store, w, rows)
            w2 = w - acc.combine(store, u)
            put(h, h + u)
            put(hj1, dist.norm(w2))
            put(w, w2)
        return w, h, hj1, fired


class CGS2Orthogonalizer(Orthogonalizer):
    """Classical Gram-Schmidt, applied twice unconditionally (CGS-2)."""

    name = "cgs2"
    passes = 2

    def __call__(self, acc, store, w, rows, eta, dist=LOCAL, w_norm=None):
        h = acc.dots(store, w, rows)
        w = w - acc.combine(store, h)
        u = acc.dots(store, w, rows)
        w = w - acc.combine(store, u)
        # both sweeps are already in the nominal `passes`: no extras
        return w, h + u, dist.norm(w), 0

    def branch_free(self, acc, store, w, rows, eta, dist=LOCAL, w_norm=None):
        w, h, hj1, _ = self(acc, store, w, rows, eta, dist, w_norm)
        return w, h, hj1, torch.zeros((), dtype=torch.bool, device=w.device)


_ORTHOGONALIZERS = {"mgs": MGSOrthogonalizer, "cgs2": CGS2Orthogonalizer}


def orthogonalizer_by_name(name) -> Orthogonalizer:
    if isinstance(name, Orthogonalizer):
        return name
    try:
        return _ORTHOGONALIZERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown orthogonalizer {name!r}; "
            f"have {sorted(_ORTHOGONALIZERS)}") from None


# ---------------------------------------------------------------------------
# Block orthogonalizers (block-GMRES: one basis sweep serves all p RHS)
# ---------------------------------------------------------------------------

_TINY = 1e-300
#: relative threshold below which a new block direction is linearly
#: dependent and deflates (zero ``Q`` row, zero ``T`` diagonal), relative to
#: the largest column scale of the incoming block, so converged columns
#: (exactly zero residuals) always deflate
DEFLATE_RTOL = 1e-13


def block_qr(W: torch.Tensor, dist=LOCAL, scale=None):
    """Rank-revealing QR of a block ``W (p, n)`` of row-stacked vectors.

    Returns ``(Q, T, dep)`` with ``W[b] = sum_{a<=b} T[a, b] Q[a]``: ``Q``
    has orthonormal rows except where ``dep`` marks a column as linearly
    dependent (or zero): those rows are exact zeros and their ``T``
    diagonal is 0.  Gram-Schmidt with a second projection pass, columns in
    order; no host read, so a CUDA graph can hold it.
    """
    p = W.shape[0]
    if scale is None:
        scale = dist.col_norms(W)
    block_scale = scale.max()
    Q = torch.zeros_like(W)
    T = torch.zeros((p, p), dtype=W.dtype, device=W.device)
    dep = torch.zeros((p,), dtype=torch.bool, device=W.device)
    for k in range(p):
        wk = W[k]
        if k:
            r = dist.sum(Q[:k] @ wk)
            wk = wk - r @ Q[:k]
            r2 = dist.sum(Q[:k] @ wk)
            wk = wk - r2 @ Q[:k]
            T[:k, k] = r + r2
        nrm = dist.norm(wk)
        dep_k = nrm <= DEFLATE_RTOL * block_scale + _TINY
        Q[k] = torch.where(dep_k, 0.0, wk / torch.clamp(nrm, min=_TINY))
        T[k, k] = torch.where(dep_k, 0.0, nrm)
        dep[k] = dep_k
    return Q, T, dep


class BlockOrthogonalizer:
    """Orthogonalize a block ``W (p, n)`` against the live block rows.

    ``__call__(acc, store, W, rows, eta, dist, w_norms) -> (Q, H, T,
    fired)``: ``acc`` is a
    :class:`~repro_torch.core.accessor.BlockBasisAccessor`, ``H (rows, p,
    p)`` the block Hessenberg couplings (one basis sweep serves all p
    columns), ``(Q, T)`` the rank-revealing :func:`block_qr` of the
    orthogonalized block.  ``fired`` counts an extra conditional sweep, as
    in the scalar protocol; ``w_norms`` are the caller's ``||W[b]||``.
    ``branch_free`` is the same with no host read (``fired`` a 0-d bool
    tensor), for the captured cycle.
    """

    name: str = "base"
    passes: int = 1

    def __call__(self, acc, store, W, rows, eta, dist=LOCAL,
                 w_norms=None):  # pragma: no cover
        raise NotImplementedError

    def branch_free(self, acc, store, W, rows, eta, dist=LOCAL,
                    w_norms=None):  # pragma: no cover
        raise NotImplementedError


class BlockMGSOrthogonalizer(BlockOrthogonalizer):
    """One block sweep plus the conditional re-orthogonalization, which
    fires when *any* column lost more than the ``eta`` fraction of its norm
    (the block shares one sweep, so the second pass is all or nothing)."""

    name = "mgs"
    passes = 1

    def __call__(self, acc, store, W, rows, eta, dist=LOCAL, w_norms=None):
        w_pre = dist.col_norms(W) if w_norms is None else w_norms
        H = acc.block_dots(store, W, rows)
        W = W - acc.block_combine(store, H)
        fired = bool((dist.col_norms(W) < eta * w_pre).any())  # host read
        if fired:
            U = acc.block_dots(store, W, rows)
            W = W - acc.block_combine(store, U)
            H = H + U
        Q, T, _ = block_qr(W, dist, scale=w_pre)
        return Q, H, T, int(fired)

    def branch_free(self, acc, store, W, rows, eta, dist=LOCAL, w_norms=None):
        w_pre = dist.col_norms(W) if w_norms is None else w_norms
        H = acc.block_dots(store, W, rows)
        W = W - acc.block_combine(store, H)
        fired = (dist.col_norms(W) < eta * w_pre).any()
        # the second pass where it fires, in place, as the scalar form
        with _second_pass(fired, dist) as put:
            U = acc.block_dots(store, W, rows)
            W2 = W - acc.block_combine(store, U)
            put(H, H + U)
            put(W, W2)
        Q, T, _ = block_qr(W, dist, scale=w_pre)
        return Q, H, T, fired


class BlockCGS2Orthogonalizer(BlockOrthogonalizer):
    """Two unconditional block sweeps (CGS-2)."""

    name = "cgs2"
    passes = 2

    def __call__(self, acc, store, W, rows, eta, dist=LOCAL, w_norms=None):
        w_pre = dist.col_norms(W) if w_norms is None else w_norms
        H = acc.block_dots(store, W, rows)
        W = W - acc.block_combine(store, H)
        U = acc.block_dots(store, W, rows)
        W = W - acc.block_combine(store, U)
        Q, T, _ = block_qr(W, dist, scale=w_pre)
        return Q, H + U, T, 0

    def branch_free(self, acc, store, W, rows, eta, dist=LOCAL, w_norms=None):
        Q, H, T, _ = self(acc, store, W, rows, eta, dist, w_norms)
        return Q, H, T, torch.zeros((), dtype=torch.bool, device=W.device)


_BLOCK_ORTHOGONALIZERS = {"mgs": BlockMGSOrthogonalizer,
                          "cgs2": BlockCGS2Orthogonalizer}


def block_orthogonalizer_by_name(name) -> BlockOrthogonalizer:
    if isinstance(name, BlockOrthogonalizer):
        return name
    if isinstance(name, Orthogonalizer):
        name = name.name                 # a scalar choice carries over by name
    try:
        return _BLOCK_ORTHOGONALIZERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown block orthogonalizer {name!r}; "
            f"have {sorted(_BLOCK_ORTHOGONALIZERS)}") from None


# ---------------------------------------------------------------------------
# Preconditioners (right preconditioning: A M^{-1})
# ---------------------------------------------------------------------------


class Preconditioner:
    """``apply(x) -> M^{-1} x``."""

    def apply(self, x):  # pragma: no cover - overridden
        raise NotImplementedError

    def permuted(self, perm) -> Preconditioner:
        """Equivalent preconditioner in RCM-permuted coordinates.

        When an :class:`~repro_torch.sparse.plan.OperatorPlan` reorders the
        operator (``P A Pᵀ``), a preconditioner built for the *original*
        coordinates must be conjugated the same way (``P M⁻¹ Pᵀ``).
        Name-resolved preconditioners never hit this (they are built from
        the already-reordered operator); only user-passed instances with
        positional state do.  ``perm`` maps new indices to old
        (``perm[new] = old``).
        """
        raise NotImplementedError(
            f"{type(self).__name__} cannot be permuted into reordered "
            "coordinates; build it for the reordered operator (see "
            "repro_torch.sparse.plan) or pass reorder='none'")

    def shard_local(self, rank: int, n_local: int,
                    n_pad: int | None = None) -> Preconditioner:
        """Equivalent preconditioner over rank ``rank``'s vector chunk.

        Called once by the sharded driver: ``apply`` then receives
        ``(n_local,)`` chunks of the row-partitioned vectors (or ``(p,
        n_local)`` blocks).  Preconditioners holding full-length state
        (Jacobi's diagonal) return one that holds the rank's slice;
        elementwise-stateless ones return ``self``.  ``n_pad`` is the
        zero-padded vector length when the problem dim does not divide the
        group: state is identity-extended so that padded entries stay
        exact zeros.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support sharded application; "
            "implement shard_local() to run it under gmres(..., shard=...)")


class IdentityPreconditioner(Preconditioner):
    """No-op: ``apply`` returns its input unchanged."""

    def apply(self, x):
        return x

    def permuted(self, perm):
        return self

    def shard_local(self, rank, n_local, n_pad=None):
        return self


class JacobiPreconditioner(Preconditioner):
    """Diagonal scaling ``M = diag(A)`` (zero diagonal entries scale by 1)."""

    def __init__(self, diag: torch.Tensor):
        d = torch.as_tensor(diag)
        one = torch.ones((), dtype=d.dtype, device=d.device)
        self.inv_diag = torch.where(d != 0, 1.0 / torch.where(d != 0, d, one),
                                    one)

    @classmethod
    def from_operator(cls, A) -> JacobiPreconditioner:
        """Built once per operator object and kept on it, so that repeated
        solves hand the device driver the same tensor (its captured cycle
        reads ``inv_diag`` by address)."""
        p = getattr(A, "_jacobi", None)
        if p is not None:
            return p
        diag_fn = getattr(A, "diag", None)
        if diag_fn is None:
            raise ValueError(
                "precond='jacobi' needs an operator with .diag() "
                f"(got {type(A).__name__}); pass a Preconditioner instead")
        p = A._jacobi = cls(diag_fn())
        return p

    def apply(self, x):
        return x * self.inv_diag.to(x.dtype)

    def permuted(self, perm) -> JacobiPreconditioner:
        """``inv_diag`` gathered by ``perm``; a padded-space permutation
        (longer than the diagonal: pad slots map to ids >= n) sees the
        diagonal identity-extended, so padded entries stay exact zeros.

        Memoized per permutation object, so that repeated solves under one
        plan hand the device driver the same ``inv_diag`` tensor (its
        captured cycle reads it by address)."""
        memo = self.__dict__.setdefault("_permuted", {})
        hit = memo.get(id(perm))
        if hit is not None and hit[0] is perm:
            return hit[1]
        idx = torch.as_tensor(np.asarray(perm), dtype=torch.int64)
        inv_diag = self.inv_diag
        if idx.shape[0] > inv_diag.shape[0]:
            inv_diag = torch.nn.functional.pad(
                inv_diag, (0, idx.shape[0] - inv_diag.shape[0]), value=1.0)
        new = object.__new__(JacobiPreconditioner)
        new.inv_diag = inv_diag[idx.to(inv_diag.device)]
        memo[id(perm)] = (perm, new)
        return new

    def shard_local(self, rank, n_local, n_pad=None):
        """Rank ``rank``'s slice of ``inv_diag`` (identity-extended past the
        diagonal when padded: 1.0 * 0 keeps a padded entry zero, a zero
        scale would make it 0/0).  Memoized per chunk, so that repeated
        solves hand the captured cycle the same tensor."""
        key = (int(rank), int(n_local), n_pad)
        memo = self.__dict__.setdefault("_local", {})
        hit = memo.get(key)
        if hit is None:
            inv_diag = self.inv_diag
            if n_pad is not None and n_pad > inv_diag.shape[0]:
                inv_diag = torch.nn.functional.pad(
                    inv_diag, (0, n_pad - inv_diag.shape[0]), value=1.0)
            chunk = inv_diag[rank * n_local:(rank + 1) * n_local].clone()
            hit = memo[key] = _LocalJacobiPreconditioner(chunk, rank,
                                                         n_local)
        return hit


class _LocalJacobiPreconditioner(JacobiPreconditioner):
    """Jacobi over one rank's chunk: ``inv_diag`` holds the rank's slice
    (the reference keeps the whole diagonal and slices it by
    ``axis_index`` inside ``shard_map``)."""

    def __init__(self, inv_diag: torch.Tensor, rank: int, n_local: int):
        self.inv_diag = inv_diag
        self.rank = rank
        self.n_local = n_local

    def permuted(self, perm):
        raise NotImplementedError(
            "a sharded Jacobi preconditioner cannot be permuted; permute the "
            "full one, then shard it")

    def shard_local(self, rank, n_local, n_pad=None):
        if rank != self.rank or n_local != self.n_local:
            raise ValueError("preconditioner already sharded differently")
        return self


class CallablePreconditioner(Preconditioner):
    """User hook: any ``fn(x) -> M^{-1} x`` on tensors."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name

    def apply(self, x):
        return self.fn(x)

    def shard_local(self, rank, n_local, n_pad=None):
        # the hook will see (n_local,) chunks: an elementwise hook is right
        # as it is only when its state is chunk-shaped; anything holding
        # full-length arrays must be written shard-aware by the caller
        return self


def resolve_preconditioner(precond, A) -> Preconditioner:
    """None | 'identity' | 'jacobi' | callable | Preconditioner -> object."""
    if precond is None or precond == "identity":
        return IdentityPreconditioner()
    if isinstance(precond, Preconditioner):
        return precond
    if precond == "jacobi":
        return JacobiPreconditioner.from_operator(A)
    if callable(precond):
        return CallablePreconditioner(precond)
    raise ValueError(f"unknown preconditioner {precond!r}")


# ---------------------------------------------------------------------------
# Precision policies
# ---------------------------------------------------------------------------


class PrecisionPolicy:
    """Selects the basis storage format per restart cycle: ``formats()`` is
    the static tuple of candidates, ``level(rr, cycle)`` maps the explicit
    restart residual (a float) to an index into it."""

    def formats(self) -> tuple:  # pragma: no cover - overridden
        raise NotImplementedError

    def level(self, rr: float, cycle: int) -> int:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticPolicy(PrecisionPolicy):
    """One format for the whole solve (the seed behaviour)."""

    fmt: StorageFormat

    def formats(self) -> tuple:
        return (self.fmt,)

    def level(self, rr: float, cycle: int) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy(PrecisionPolicy):
    """Drop precision as the residual falls (inexact-Krylov schedule).

    ``levels[i]`` is active while ``thresholds[i-1] >= rr > thresholds[i]``
    (``thresholds`` strictly decreasing, one fewer than ``levels``).
    """

    levels: tuple
    thresholds: tuple

    def __post_init__(self):
        if len(self.thresholds) != len(self.levels) - 1:
            raise ValueError("need len(thresholds) == len(levels) - 1")
        if not all(a > b for a, b in zip(self.thresholds,
                                         self.thresholds[1:])):
            raise ValueError("thresholds must be strictly decreasing")

    def formats(self) -> tuple:
        return tuple(self.levels)

    def level(self, rr: float, cycle: int) -> int:
        return sum(int(rr < t) for t in self.thresholds)

    @classmethod
    def from_target(cls, levels, target_rrn: float,
                    safety: float = 0.5) -> AdaptivePolicy:
        """Switch points from the target RRN and the format epsilons: level
        ``i`` is admissible below ``safety * target_rrn / eps_i``, clipped
        into ``(0, 1]`` and kept strictly decreasing."""
        if target_rrn <= 0:
            raise ValueError(f"target_rrn must be positive, "
                             f"got {target_rrn}")
        thresholds = []
        ceiling = 1.0
        for fmt in levels[1:]:
            t = min(safety * float(target_rrn) / fmt.eps(), ceiling)
            # a later (cheaper) level must activate strictly later
            if thresholds and t >= thresholds[-1]:
                t = thresholds[-1] / 2.0
            thresholds.append(t)
            ceiling = t
        return cls(levels=tuple(levels), thresholds=tuple(thresholds))


#: default adaptive ladder: full precision until the residual clears 1e-2,
#: frsz2_32 to 1e-6, frsz2_16 for the long tail.
_ADAPTIVE_DEFAULT = (("float64", None), ("frsz2_32", 1e-2), ("frsz2_16", 1e-6))


def policy_by_name(name: str, *, arith_dtype=torch.float64,
                   target_rrn: float | None = None,
                   m: int | None = None, **ctx) -> PrecisionPolicy:
    """Resolve a policy from a name: ``static:<fmt>``, ``adaptive``,
    ``adaptive:auto`` (switch points from ``target_rrn``), or
    ``adaptive:<f0>,<f1>@<t1>,<f2>@<t2>,...``."""
    ctx = dict(ctx, target_rrn=target_rrn, m=m)
    kind, _, rest = name.partition(":")
    if kind == "static":
        if not rest:
            raise ValueError("static policy needs a format: 'static:<fmt>'")
        return StaticPolicy(format_by_name(rest, arith_dtype=arith_dtype,
                                           **ctx))
    if kind != "adaptive":
        raise ValueError(
            f"unknown policy {name!r}; expected one of 'static:<fmt>', "
            f"'adaptive', 'adaptive:auto', or "
            f"'adaptive:<f0>,<f1>@<t1>,...'")
    if rest == "auto":
        if target_rrn is not None:
            levels = tuple(
                format_by_name(f, arith_dtype=arith_dtype, **ctx)
                for f, _ in _ADAPTIVE_DEFAULT)
            return AdaptivePolicy.from_target(levels, target_rrn)
        ladder = _ADAPTIVE_DEFAULT       # no target: the fixed defaults
    elif not rest:
        ladder = _ADAPTIVE_DEFAULT
    else:
        ladder = []
        for i, part in enumerate(rest.split(",")):
            fmt_name, _, thr = part.partition("@")
            if i == 0 and not thr:
                ladder.append((fmt_name, None))
            elif not thr:
                raise ValueError(
                    f"adaptive level {part!r} needs a threshold 'fmt@thr'")
            else:
                ladder.append((fmt_name, float(thr)))
    levels = tuple(format_by_name(f, arith_dtype=arith_dtype, **ctx)
                   for f, _ in ladder)
    thresholds = tuple(t for _, t in ladder[1:])
    return AdaptivePolicy(levels=levels, thresholds=thresholds)


def resolve_policy(policy, storage, arith_dtype,
                   target_rrn: float | None = None,
                   m: int | None = None) -> PrecisionPolicy:
    """Combine the ``policy`` / ``storage`` arguments into one policy:
    ``policy`` wins when given; otherwise the storage format (object, name,
    or None -> native arith dtype) becomes a :class:`StaticPolicy`."""
    if policy is not None:
        if isinstance(policy, PrecisionPolicy):
            return policy
        if isinstance(policy, str):
            return policy_by_name(policy, arith_dtype=arith_dtype,
                                  target_rrn=target_rrn, m=m)
        raise ValueError(
            f"unknown policy {policy!r}; expected a PrecisionPolicy or a "
            f"name ('static:<fmt>', 'adaptive', 'adaptive:auto', "
            f"'adaptive:<f0>,<f1>@<t1>,...')")
    if storage is None:
        return StaticPolicy(NativeFormat(dtype=arith_dtype))
    if isinstance(storage, str):
        return StaticPolicy(format_by_name(storage, arith_dtype=arith_dtype,
                                           target_rrn=target_rrn, m=m))
    if isinstance(storage, PrecisionPolicy):
        return storage
    return StaticPolicy(storage)
