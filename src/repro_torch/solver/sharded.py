"""The device-resident GMRES driver, sharded over a torch.distributed group.

The port of ``repro/solver/sharded.py``.  The reference runs its
device-resident solve as one SPMD program inside ``jax.shard_map``; the
port keeps that contract with one process per rank (one per GPU, NCCL on
the card, gloo on the CPU):

  * every rank calls ``gmres(A, b, shard=P)`` with the whole ``A`` and
    ``b``, as the reference's caller passes global arrays, and builds the
    same content-cached :class:`~repro_torch.sparse.plan.OperatorPlan`
    (optional RCM, zero padding, probing, the matvec mode);
  * each rank keeps its chunk of every vector: ``b``, ``x``, the residual
    and the Krylov basis, in ``sharded:<fmt>`` storage
    (:class:`~repro_torch.core.accessor.ShardedFormat`), whose dots sum the
    local partials over the group, plain or as FRSZ2 codes;
  * norms are all-reduced sums of local squares (the sharded
    :class:`~repro_torch.dist.context.DistContext`);
  * the matvec is the rank's share of the plan's partition
    (:func:`repro_torch.sparse.shard.partition_matvec`); the explicit
    residuals ride its lossless twin, so a coded halo perturbs only the
    Arnoldi steps;
  * every rank returns the whole :class:`~repro_torch.solver.gmres.GmresResult`,
    ``x`` all-gathered and mapped back through the plan.

The reference's partition specs (``repro/dist/sharding.py``) have no
counterpart here: there is no global array to annotate, each rank simply
holds its chunk.  Every value the driver reads on the host (norms, the
Hessenberg column after its reduction, restart residuals) is bitwise the
same on every rank after its collective, so all ranks take the same
restart and convergence decisions and issue the same collectives in the
same order; a rank-local value is never read to decide anything.  On the
card each restart cycle is one captured CUDA graph with its collectives
inside, as in the unsharded device driver.  MGS's second pass sits in the
graph's IF node and reduces over the peer gather
(``kernels/peer_gather.py``) where every pair of the group's cards can
reach each other's memory; elsewhere it runs at every step, branch-free
(:func:`second_pass_route`, ``GmresResult.second_pass``).

Vector lengths that do not divide the group are zero-padded through
``plan.embed``/``plan.extract`` (the block3d layout puts pad slots inside
the chunks, so vectors are embedded rather than tail-padded); padded rows
of the operator are zero, so padded entries stay exact zeros.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.distributed as dist

from repro_torch.core import frsz2 as F
from repro_torch.core.accessor import (
    BasisAccessor,
    BlockBasisAccessor,
    ShardedFormat,
    format_by_name,
)
from repro_torch.dist.collectives import (
    WIRE_SPEC,
    gather_operand,
    reduce_bytes,
)
from repro_torch.dist.context import DistContext
from repro_torch.kernels import peer_gather
from repro_torch.solver.block import _block_drive
from repro_torch.solver.gmres import (
    _apply_rows,
    _cycle_row_reads,
    _gmres_device,
    _permuted_precond,
    _precond_key,
)
from repro_torch.solver.pipeline import (
    AdaptivePolicy,
    StaticPolicy,
    block_orthogonalizer_by_name,
    orthogonalizer_by_name,
    resolve_policy,
    resolve_preconditioner,
)
from repro_torch.sparse.plan import plan_operator
from repro_torch.sparse.shard import partition_matvec

__all__ = ["TRANSPORTS", "cycle_wire_bytes", "second_pass_bytes",
           "second_pass_route", "sharded_gmres", "wire_bytes"]

TRANSPORTS = ("plain", "compressed", "compressed+norms")


def _wrap_policy(policy, group, compressed_dots: bool):
    """Every policy level in :class:`ShardedFormat` on the solve's
    transport: ``shard_transport`` is the one authority on the wire format,
    so a level that arrives already sharded is rebuilt onto it."""

    def wrap(fmt):
        if isinstance(fmt, ShardedFormat):
            fmt = fmt.inner
        return ShardedFormat(inner=fmt, group=group,
                             compressed_transport=compressed_dots)

    fmts = tuple(wrap(f) for f in policy.formats())
    if isinstance(policy, StaticPolicy):
        return StaticPolicy(fmts[0])
    if isinstance(policy, AdaptivePolicy):
        return AdaptivePolicy(levels=fmts, thresholds=policy.thresholds)
    raise ValueError(
        f"cannot shard custom policy {type(policy).__name__}: give it "
        "ShardedFormat levels explicitly")


def _plan_and_precond(A, p_dev: int, reorder: str, partition_mode: str,
                      precond, pgrid=None):
    """Plan the operator and carry the preconditioner through the plan's
    permutation.

    ``reorder="auto"`` declines a permutation the preconditioner cannot
    follow (a bare callable, or a Preconditioner without ``permuted``):
    auto only buys wire bytes, so the solve proceeds unreordered.  The same
    declines an *auto-picked* block3d layout.  An explicit ``"rcm"`` or
    ``partition_mode="block3d"`` raises instead.
    """
    plan = plan_operator(A, p_dev, reorder=reorder,
                         matvec_mode=partition_mode, pgrid=pgrid)
    try:
        return plan, _permuted_precond(precond, plan)
    except (ValueError, NotImplementedError):
        auto_block = (plan.matvec_mode == "block3d"
                      and partition_mode != "block3d")
        if reorder != "auto" and not auto_block:
            raise
        plan = plan_operator(A, p_dev,
                             reorder="none" if reorder == "auto" else reorder,
                             matvec_mode=partition_mode, pgrid=pgrid,
                             allow_block3d=False)
        return plan, _permuted_precond(precond, plan)


#: the ranks' partitioned matvecs, least recently used first: a captured
#: cycle reads the partition's tensors by address, so a repeated solve of
#: the same plan must get the same matvec back (the entry pins the plan)
_PARTITIONS: OrderedDict = OrderedDict()
_PARTITIONS_SIZE = 8


def _partition_for(plan, rank: int, group, device, compressed: bool):
    key = (id(plan), rank, "world" if group is None else id(group),
           str(torch.device(device)), compressed)
    hit = _PARTITIONS.get(key)
    if hit is not None and hit[0] is plan:
        _PARTITIONS.move_to_end(key)
        return hit[1]
    mv = partition_matvec(plan=plan, rank=rank, group=group,
                          compressed_halo=compressed, device=device)
    _PARTITIONS[key] = (plan, mv)
    while len(_PARTITIONS) > _PARTITIONS_SIZE:
        _PARTITIONS.popitem(last=False)
    return mv


def second_pass_bytes(m: int, p: int = 1) -> int:
    """The largest buffer one of MGS's second-pass reductions gathers: the
    ``(m + 1) p^2`` dots plain (8 bytes a value) or as :data:`WIRE_SPEC`
    codes, or a coded norm (a whole 128-value block)."""
    n = (m + 1) * p * p
    return max(8 * n, F.storage_nbytes(n, WIRE_SPEC),
               F.storage_nbytes(1, WIRE_SPEC))


#: whether each group reaches its peers' memory, by group and device
_REACHABLE: dict = {}


def second_pass_route(group, device, nbytes: int):
    """The route of MGS's second-pass reductions on ``group``: a
    :class:`~repro_torch.kernels.peer_gather.Route` for buffers of up to
    ``nbytes`` where the group's cards reach each other's memory
    (:func:`~repro_torch.kernels.peer_gather.reachable`, asked once a group
    and device; never on the CPU, whose eager cycles hold no IF node), else
    ``None`` (the pass stays branch-free).  Every rank calls it
    together."""
    key = ("world" if group is None else id(group), str(torch.device(device)),
           dist.get_world_size(group))
    hit = _REACHABLE.get(key)
    if hit is None or hit[0] is not group:
        hit = _REACHABLE[key] = (group, peer_gather.reachable(group, device))
    return peer_gather.Route(group, device, nbytes) if hit[1] else None


def _check_group(p_dev: int, group) -> int:
    """This process's rank in a live group of ``p_dev`` ranks, or raise."""
    if p_dev < 1:
        raise ValueError(f"shard={p_dev} must be a positive rank count")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"shard={p_dev} needs a live torch.distributed process group of "
            f"{p_dev} ranks, one process per GPU (init_process_group, "
            "torchrun, or repro_torch.dist.spawn); none is initialized")
    size = dist.get_world_size(group)
    if size != p_dev:
        raise ValueError(f"shard={p_dev} but the process group has {size} "
                         "ranks")
    return dist.get_rank(group)


def sharded_gmres(A, b, *, batched: bool = False, x0=None, storage=None,
                  policy=None, precond=None, ortho="mgs", m: int = 100,
                  max_iters: int = 20000, target_rrn: float = 1e-14,
                  arith_dtype=None, eta: float = 0.7071067811865475,
                  matvec=None, shard: int = 1, transport: str = "plain",
                  partition_mode: str = "auto", reorder: str = "auto",
                  method: str = "vmap", pgrid=None, group=None):
    """``gmres``/``gmres_batched`` on this rank of ``group``.

    Called through ``gmres(..., shard=P)`` and ``gmres_batched(...,
    shard=P)``; see :func:`repro_torch.solver.gmres.gmres`.  ``b`` is
    ``(n,)``, or ``(k, n)`` with ``batched=True``, whole and the same on
    every rank; returns the matching result (or list of them), whole and
    the same on every rank.  ``method="block"`` (batched only) runs the
    block cycle on the ranks' chunks of the block basis: one exchange a
    block matvec serves all right-hand sides.  ``pgrid`` forces the block
    partition's ``(Px, Py, Pz)``.
    """
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown shard transport {transport!r}; "
                         f"expected one of {TRANSPORTS}")
    if method not in ("vmap", "block"):
        raise ValueError(f"unknown batched method {method!r}; "
                         f"expected one of ('vmap', 'block')")
    block = method == "block"
    if block and not batched:
        raise ValueError("method='block' needs batched=True (B is (p, n))")
    if matvec is not None:
        raise ValueError(
            "shard= needs an operator with partitionable rows (CSR/ELL); "
            "a bare matvec callable cannot be row-partitioned")
    p_dev = int(shard)
    rank = _check_group(p_dev, group)

    n = b.shape[-1]
    plan, precond = _plan_and_precond(A, p_dev, reorder, partition_mode,
                                      precond, pgrid)
    if plan.n != n:
        raise ValueError(f"b has trailing dim {n} but the operator "
                         f"is {plan.n}x{plan.n}")
    n_pad, n_local = plan.n_pad, plan.n_local
    if arith_dtype is None:
        arith_dtype = b.dtype
    dev = b.device

    compressed = transport in ("compressed", "compressed+norms")
    policy = _wrap_policy(
        resolve_policy(policy, storage, arith_dtype, target_rrn, m),
        group, compressed)
    precond = resolve_preconditioner(precond, plan.operator).shard_local(
        rank, n_local, n_pad)
    ctx = DistContext(group=group, sharded=True,
                      compressed_norms=transport == "compressed+norms",
                      peer=second_pass_route(group, dev, second_pass_bytes(
                          m, b.shape[0] if block else 1)))
    mv = _partition_for(plan, rank, group, dev, compressed)

    if x0 is None:
        x0 = torch.zeros_like(b)
    elif x0.shape != b.shape:
        raise ValueError(f"x0 shape {tuple(x0.shape)} != b shape "
                         f"{tuple(b.shape)}")
    lo = rank * n_local
    b_loc, x0_loc = (plan.embed(v).to(arith_dtype)[..., lo:lo + n_local]
                     .contiguous() for v in (b, x0))

    if block:
        accs = tuple(
            BlockBasisAccessor(fmt=f, m=m + 1, p=b.shape[0], n=n_local,
                               arith_dtype=arith_dtype, device=dev)
            for f in policy.formats())
        pc_key, pc_pins = _precond_key(precond)
        results = _block_drive(
            lambda X: mv(_apply_rows(precond, X)), mv.exact, accs, policy,
            b_loc, m, max_iters, target_rrn, eta,
            block_orthogonalizer_by_name(ortho), precond, x0_loc, True,
            (("matvec", id(mv)), pc_key), (mv,) + pc_pins, ctx)
    else:
        accs = tuple(
            BasisAccessor(fmt=f, m=m + 1, n=n_local, arith_dtype=arith_dtype,
                          device=dev)
            for f in policy.formats())
        ortho_obj = orthogonalizer_by_name(ortho)

        def one(bb, xx):
            return _gmres_device(None, mv, mv, accs, policy, bb, m,
                                 max_iters, target_rrn, eta, ortho_obj,
                                 precond, x0=xx, dist=ctx,
                                 residual_matvec=mv.exact)

        if batched:
            results = [one(b_loc[i], x0_loc[i]) for i in range(b.shape[0])]
        else:
            results = [one(b_loc, x0_loc)]
    for r in results:
        r.x = plan.extract(gather_operand(r.x, group))
        r.second_pass = ctx.second_pass
    return results if batched else results[0]


# ---------------------------------------------------------------------------
# Wire-byte model (the reference's, ``benchmarks/shard_wire.py``)
# ---------------------------------------------------------------------------


def cycle_wire_bytes(m: int, j_stop: int, reorth: int, *, passes: int,
                     dots_compressed: bool, norms_compressed: bool,
                     inner_mv_bytes: int, residual_mv_bytes: int) -> dict:
    """Modelled per-rank wire bytes of one restart cycle.

    Per inner iteration: ``passes`` (+1 per fired re-orthogonalization)
    reductions of the ``m + 1`` partial dots, 2 (+1 on a re-orthogonalization)
    scalar norm reductions and one operand movement (``inner_mv_bytes``);
    per cycle: 2 scalar reductions (the restart residual and the explicit
    RRN) and 2 residual matvecs (``residual_mv_bytes``, the exact
    transport).
    """
    dots = (j_stop * passes + reorth) * reduce_bytes(
        m + 1, compressed=dots_compressed)
    norms = (j_stop * 2 + reorth + 2) * reduce_bytes(
        1, compressed=norms_compressed)
    matvec = j_stop * inner_mv_bytes + 2 * residual_mv_bytes
    return dict(dots=dots, norms=norms, matvec=matvec,
                total=dots + norms + matvec)


def wire_bytes(res, plan, *, storage: str, m: int, transport: str) -> dict:
    """The modelled per-rank wire bytes of one cycle of the MGS solve that
    gave ``res`` on ``plan``: the reference's accounting, which takes the
    cycle count from the restarts, the mean useful steps of a cycle from the
    iterations, and the re-orthogonalizations from the ``bytes_read`` beyond
    the one-pass rows (a row is ``storage``'s bytes for ``plan.n_local``
    values)."""
    row_bytes = format_by_name(storage).nbytes(1, plan.n_local)
    cycles = max(res.restarts, 1)
    j_avg = min(max(res.iterations // cycles, 1), m)
    nominal_rows = cycles * _cycle_row_reads(j_avg, 1)
    extra_rows = max(res.bytes_read / row_bytes - nominal_rows, 0.0)
    reorth = int(round(extra_rows / (j_avg + 1) / cycles))
    compressed = transport != "plain"
    return cycle_wire_bytes(
        m, j_avg, reorth, passes=1, dots_compressed=compressed,
        norms_compressed=transport == "compressed+norms",
        inner_mv_bytes=plan.matvec_wire_bytes(compressed=compressed),
        residual_mv_bytes=plan.matvec_wire_bytes())
