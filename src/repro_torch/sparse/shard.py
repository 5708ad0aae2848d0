"""Row-partitioned SpMV for the sharded GMRES driver, one rank's share.

The port of ``repro/sparse/shard.py``.  The sharded solver keeps every
vector row-partitioned over the ranks of a process group: rank ``r`` owns
the ``(n_local,)`` chunk ``[r * n_local, (r + 1) * n_local)`` of the
(padded, possibly permuted) solve-side vector.  The Arnoldi matvec maps
``x_local`` to ``(A x)_local``.  Four partitions, all built from one
:class:`~repro_torch.sparse.plan.OperatorPlan`:

* ``"halo"`` (banded operators) — each rank exchanges its boundary strips
  with its neighbours (:func:`repro_torch.dist.collectives.halo_exchange`,
  multi-hop when the bandwidth spans several chunks) and contracts its rows
  against ``[left halo | chunk | right halo]``: ``O(bandwidth)`` values on
  the wire a matvec instead of ``O(n)``;
* ``"rows"`` — the operand is all-gathered to full length and the rank's
  rows contract against it (the fallback for unstructured operators);
* ``"replicated"`` — every rank holds the whole operator, computes the
  whole ``A x`` and keeps its rows (any operator with ``.matvec``);
* ``"block3d"`` — the plan's 3-D block layout: each rank owns a box of
  grid cells, and only the referenced faces, edges and corners travel
  (:func:`repro_torch.dist.collectives.halo_exchange_3d_start`).  The
  exchange is started, the interior rows (the first ``n_local -
  n_boundary`` of the chunk, which reference only local columns) are
  contracted while it is in flight, and only the boundary rows wait for it.

The local contraction of ``halo``, ``rows`` and ``block3d`` is an ELL SpMV
on the rank's rows with localized columns: ``kernels/ops.ell_spmv``, which
is kernel 5 on the card and takes an operand longer than the rows.  A
``(p, n_local)`` block of right-hand sides takes one exchange and one
batched launch.  Padded rows carry value 0, so a padded solve embeds the
unpadded one exactly.

:func:`partition_matvec` returns the rank's matvec, which carries ``.mode``
(the executed partition), ``.probe``, ``.plan`` and ``.exact``: the same
partition with lossless transport (the matvec itself unless a compressed
halo was asked for), which the driver's explicit residuals use.
"""
from __future__ import annotations

import torch

from repro_torch.dist.collectives import (
    gather_operand,
    halo_exchange,
    halo_exchange_3d_start,
)
from repro_torch.kernels import ops
from repro_torch.sparse.csr import CSR, ELL
from repro_torch.sparse.halo_probe import (  # noqa: F401  (re-exported)
    MAX_HALO_FRAC,
    BlockPartition,
    HaloProbe,
    block_partition,
    halo_probe,
)

__all__ = ["BlockPartition", "HaloProbe", "block_partition", "halo_probe",
           "partition_matvec"]


class _Partition:
    """One rank's operator material and the contraction of each mode."""

    def __init__(self, plan, rank: int, group, device):
        self.plan = plan
        self.mode = plan.matvec_mode
        self.group = group
        nl = plan.n_local
        rows = slice(rank * nl, (rank + 1) * nl)
        self.rank, self.n_local = rank, nl

        def dev(a, dtype=None):
            return torch.as_tensor(a[rows] if dtype is None else
                                   a[rows].astype("int32"),
                                   device=device).contiguous()

        if self.mode == "halo":
            lcols, vals = plan.ell_halo_localized()
            self.cols, self.vals = dev(lcols, "int32"), dev(vals)
        elif self.mode == "rows":
            cols, vals = plan.ell_padded()
            self.cols, self.vals = dev(cols, "int32"), dev(vals)
        elif self.mode == "block3d":
            blk = plan.block
            cols, vals = dev(blk.lcols, "int32"), dev(blk.vals)
            ni = nl - blk.n_boundary
            self.cols_int, self.vals_int = (cols[:ni].contiguous(),
                                            vals[:ni].contiguous())
            self.cols_bnd, self.vals_bnd = (cols[ni:].contiguous(),
                                            vals[ni:].contiguous())
            self.send_idx = tuple(
                torch.as_tensor(ix[rank], dtype=torch.int64, device=device)
                for ix in blk.send_idx)
        else:                                       # replicated
            self.operator = plan.operator

    def apply(self, x: torch.Tensor, compressed: bool) -> torch.Tensor:
        plan, group = self.plan, self.group
        if self.mode == "halo":
            x_ext = halo_exchange(x, plan.probe.strips, plan.n_shards, group,
                                  compressed=compressed)
            return ops.ell_spmv(self.vals, self.cols, x_ext)
        if self.mode == "block3d":
            # start the faces, contract the interior rows (purely local by
            # layout) while they travel; only boundary rows read x_ext
            pending = halo_exchange_3d_start(x, self.send_idx,
                                             plan.block.rounds, group,
                                             compressed=compressed)
            y_int = ops.ell_spmv(self.vals_int, self.cols_int, x)
            y_bnd = ops.ell_spmv(self.vals_bnd, self.cols_bnd, pending.wait())
            return torch.cat([y_int, y_bnd], dim=-1)
        if self.mode == "rows":
            return ops.ell_spmv(self.vals, self.cols,
                                gather_operand(x, group))
        x_full = gather_operand(x, group)[..., :plan.n]
        A = self.operator
        if isinstance(A, (CSR, ELL)) or x.ndim == 1:
            y = A.matvec(x_full)
        else:
            y = torch.stack([A.matvec(v) for v in x_full])
        pad = plan.n_pad - plan.n
        if pad:
            y = torch.nn.functional.pad(y, (0, pad))
        return y[..., self.rank * self.n_local:(self.rank + 1) * self.n_local]


def partition_matvec(A=None, n_shards: int | None = None,
                     mode: str = "auto", *, rank: int | None = None,
                     group=None, compressed_halo: bool = False, plan=None,
                     device=None):
    """The row-partitioned SpMV of rank ``rank`` (default: this process's
    rank in ``group``).

    Returns ``local_matvec(x_local) -> y_local`` for ``(n_local,)`` chunks
    or ``(p, n_local)`` blocks of them.  Pass a plan as ``plan=`` (the
    sharded driver does: it may have RCM-reordered the operator), or ``(A,
    n_shards, mode)`` and a reorder-free plan is built here.  ``mode``:
    ``"auto"`` follows the probe; ``"halo"``/``"rows"``/``"replicated"``/
    ``"block3d"`` force a path, except that ``"halo"`` still falls back to
    the gathered rows when the two-sided halo would be at least
    :data:`MAX_HALO_FRAC` of the vector.  ``"block3d"`` needs the vectors
    to enter through :meth:`~repro_torch.sparse.plan.OperatorPlan.embed`
    (its layout puts pad slots inside chunks).  ``compressed_halo`` ships
    the exchanged values as FRSZ2 codes.  ``device``: where the rank's
    operator material lives (default: the operator's).
    """
    if plan is None:
        from repro_torch.sparse.plan import plan_operator

        if A is None or n_shards is None:
            raise ValueError(
                "partition_matvec needs either plan= or (A, n_shards)")
        plan = plan_operator(A, n_shards, reorder="none", matvec_mode=mode)
    elif n_shards is not None and n_shards != plan.n_shards:
        raise ValueError(
            f"n_shards={n_shards} conflicts with the plan's "
            f"{plan.n_shards}; pass one or the other")
    elif mode != "auto" and mode != plan.requested_matvec:
        raise ValueError(
            f"mode={mode!r} conflicts with the plan's requested "
            f"{plan.requested_matvec!r}; build the plan with this mode")
    if rank is None:
        import torch.distributed as dist

        rank = dist.get_rank(group)
    if not 0 <= rank < plan.n_shards:
        raise ValueError(f"rank {rank} outside the plan's {plan.n_shards} "
                         "shards")
    if device is None:
        from repro_torch.sparse.reorder import _device_of

        device = _device_of(plan.operator)
    part = _Partition(plan, int(rank), group, device)

    def local_matvec(x_local):
        return part.apply(x_local, compressed_halo)

    exact = local_matvec
    if compressed_halo and part.mode in ("halo", "block3d"):
        def exact(x_local):
            return part.apply(x_local, False)

    for f in {local_matvec, exact}:
        f.mode = part.mode
        f.probe = plan.probe
        f.plan = plan
        f.partition = part
    local_matvec.exact = exact
    return local_matvec
