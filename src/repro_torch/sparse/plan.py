"""Operator planning: one object owns all host-side solve preparation.

The port of ``repro/sparse/plan.py``.  An :class:`OperatorPlan` is computed
**once per (operator content, shard configuration)**:

1. **Reordering** (:mod:`repro_torch.sparse.reorder`) — optional RCM
   bandwidth reduction.  ``reorder="auto"`` applies it only when it changes
   the sharded matvec decision; ``"rcm"`` always.  The permutation is
   applied to the operator once here; vectors map through
   :meth:`OperatorPlan.permute` / :meth:`OperatorPlan.unpermute`.
2. **Padding geometry** — ``n_pad``/``n_local`` for ``n % P != 0``.
3. **Bandwidth/halo probing** (:func:`~repro_torch.sparse.halo_probe.
   halo_probe`) on the *reordered* operator.
4. **Matvec-mode selection** — the ``auto``/forced-mode arbitration.
5. **Partition material** — the padded (and halo-localized) ELL arrays,
   memoized on the plan.
6. **Cache-key material** — :attr:`OperatorPlan.key` combines the content
   fingerprint with the executed reorder and matvec mode.

Plans are cached (bounded LRU) by content fingerprint, so rebuilding the
same problem and solving again returns the *same* plan, whose ``operator``
is the same object: the device driver's captured CUDA graphs read the
operator's tensors by address, so a repeated reordered solve replays them.

Single-process solves use the plan for its permutation (``gmres(...,
reorder="rcm")``); the sharded matvec modes are probed and priced here,
field for field as in the reference, and run with slice 6 of the port.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.dist.collectives import exchange_bytes, gather_bytes
from repro_torch.sparse.halo_probe import (
    MAX_HALO_FRAC,
    BlockPartition,
    HaloProbe,
    _ell_arrays,
    block_partition,
    grid_of,
    halo_probe,
)
from repro_torch.sparse.reorder import (
    _device_of,
    _host,
    inverse_permutation,
    pattern_of,
    permute_csr,
    rcm_permutation,
)

__all__ = ["REORDERS", "OperatorPlan", "plan_operator"]

REORDERS = ("auto", "rcm", "none")

_MODES = ("auto", "halo", "rows", "replicated", "block3d")


@dataclasses.dataclass(frozen=True)
class OperatorPlan:
    """Host-side prep of one operator for one shard configuration.

    ``operator`` is the solve-side operator: the RCM-permuted matrix when
    ``reorder == "rcm"`` executed, the original otherwise.  ``perm`` maps
    new row indices to old (``perm[new] = old``; ``None`` when no
    reordering was applied), as a host numpy array; right-hand sides enter
    the solve through :meth:`permute` and solutions leave through
    :meth:`unpermute`, which gather by an index tensor kept per device
    (one host-to-device copy of the permutation per plan and device).

    ``matvec_mode`` is the *resolved* partition mode ("halo" / "rows" /
    "replicated" / "block3d") after probing the (reordered) operator;
    ``probe`` is the halo geometry of the reordered operator;
    ``raw_bandwidth`` records the bandwidth before reordering.  When
    ``matvec_mode == "block3d"``, ``block`` holds the 3-D layout, the
    operator is rebuilt in it, and ``perm`` spans the padded index space:
    vectors enter through :meth:`embed` and leave through :meth:`extract`.

    ``key`` is hashable cache-key material: (content fingerprint or None,
    shard count, executed reorder, resolved mode[, cell grid, process
    grid]).
    """

    operator: Any
    n: int
    n_shards: int
    n_pad: int
    n_local: int
    requested_reorder: str
    requested_matvec: str
    reorder: str                 # executed: "rcm" | "none"
    perm: np.ndarray | None
    iperm: np.ndarray | None
    raw_bandwidth: int
    probe: HaloProbe
    matvec_mode: str
    key: tuple
    pgrid: tuple | None = None   # (Px, Py, Pz) when matvec_mode == block3d
    block: BlockPartition | None = None

    # -- vector mapping -----------------------------------------------------
    def _index(self, which: str, device) -> torch.Tensor:
        """``perm`` or ``iperm`` as an int64 tensor on ``device``, copied
        there once per plan."""
        cache = self.__dict__.setdefault("_indices", {})
        key = (which, str(torch.device(device)))
        idx = cache.get(key)
        if idx is None:
            idx = cache[key] = torch.as_tensor(
                getattr(self, which), dtype=torch.int64).to(device)
        return idx

    def permute(self, v: torch.Tensor) -> torch.Tensor:
        """Map a vector (trailing dim n) into reordered coordinates."""
        if self.perm is None:
            return v
        return v[..., self._index("perm", v.device)]

    def unpermute(self, x: torch.Tensor) -> torch.Tensor:
        """Map a solve-side vector back to original coordinates."""
        if self.iperm is None:
            return x
        return x[..., self._index("iperm", x.device)]

    def embed(self, v: torch.Tensor) -> torch.Tensor:
        """Map a length-``n`` vector into solve coordinates, zero-padded
        to ``n_pad`` — the one entry point for every matvec mode (block3d
        pads first: its padded-space permutation places pad slots inside
        the chunks)."""
        pad = self.n_pad - v.shape[-1]
        if self.matvec_mode == "block3d":
            if pad:
                v = torch.nn.functional.pad(v, (0, pad))
            return self.permute(v)
        v = self.permute(v)
        return torch.nn.functional.pad(v, (0, pad)) if pad else v

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        """Map a length-``n_pad`` solve-side vector back to the original
        length-``n`` coordinates (inverse of :meth:`embed`)."""
        if self.matvec_mode == "block3d":
            return self.unpermute(x)[..., : self.n]
        return self.unpermute(x[..., : self.n])

    # -- partition material (memoized: the O(nnz) host work) ---------------
    def ell_padded(self):
        """Zero-padded ``(cols, vals)`` ELL arrays of ``operator``: numpy,
        ``(n_pad, w)`` each; padding rows carry col 0 / val 0.  Computed
        once per plan."""
        cached = self.__dict__.get("_ell_padded")
        if cached is None:
            ell = _ell_arrays(self.operator)
            cols, vals = _host(ell[0]), _host(ell[1])
            pad = self.n_pad - self.operator.shape[0]
            if pad:
                cols = np.pad(cols, ((0, pad), (0, 0)))
                vals = np.pad(vals, ((0, pad), (0, 0)))
            cached = (cols, vals)
            object.__setattr__(self, "_ell_padded", cached)
        return cached

    def ell_halo_localized(self):
        """``(lcols, vals)`` with columns relative to the halo-extended
        chunk ``[left halo | local chunk | right halo]``: row ``r`` of shard
        ``p = r // n_local`` sees global column ``c`` at ``c - p * n_local
        + bandwidth``; padding entries are pinned to 0.  Memoized."""
        cached = self.__dict__.get("_ell_halo")
        if cached is None:
            cols, vals = self.ell_padded()
            shard_of_row = np.arange(self.n_pad) // self.n_local
            lcols = (cols - shard_of_row[:, None] * self.n_local
                     + self.probe.bandwidth)
            lcols = np.where(vals == 0, 0, lcols)
            cached = (lcols, vals)
            object.__setattr__(self, "_ell_halo", cached)
        return cached

    # -- wire accounting ------------------------------------------------------
    def matvec_wire_sizes(self) -> tuple | None:
        """Per-collective operand lengths of one matvec's exchange: the
        1-D halo's strips twice (one per direction), the 3-D exchange's
        round lengths; ``None`` when the mode moves no neighbour traffic."""
        if self.matvec_mode == "halo":
            return tuple(self.probe.strips) * 2
        if self.matvec_mode == "block3d":
            return self.block.wire_sizes
        return None

    def matvec_wire_bytes(self, *, compressed: bool = False,
                          plain_itemsize: int = 8,
                          dtype=torch.float64) -> int:
        """Modelled per-device wire bytes of one partitioned matvec, priced
        through :mod:`repro_torch.dist.collectives`."""
        sizes = self.matvec_wire_sizes()
        if sizes is not None:
            return exchange_bytes(sizes, compressed=compressed,
                                  plain_itemsize=plain_itemsize, dtype=dtype)
        if self.matvec_mode == "rows":
            return gather_bytes(self.n_local, self.n_shards,
                                plain_itemsize=plain_itemsize)
        return 0

    def describe(self, second_pass: str | None = None) -> str:
        """One-line human summary (the solve CLI prints it); with
        ``second_pass``, the route of MGS's second pass on the group
        (``GmresResult.second_pass``) at its end."""
        re_part = (f"rcm (bw {self.raw_bandwidth} -> "
                   f"{self.probe.bandwidth})" if self.reorder == "rcm"
                   else f"none (bw {self.raw_bandwidth})")
        mv = self.matvec_mode
        if mv == "block3d" and self.block is not None:
            mv = (f"block3d pgrid={'x'.join(map(str, self.block.pgrid))} "
                  f"wire={sum(self.block.wire_sizes)}")
        route = "" if second_pass is None else f" second_pass={second_pass}"
        return (f"plan: n={self.n} pad={self.n_pad} shards={self.n_shards} "
                f"reorder={re_part} matvec={mv}{route}")


def _fingerprint(A) -> str | None:
    fp = getattr(A, "fingerprint", None)
    return fp() if fp is not None else None


def _resolve_mode(requested: str, probe: HaloProbe, A) -> str:
    """The auto/forced-mode arbitration: ``auto`` follows the probe;
    ``halo`` still falls back to the gathered rows when the two-sided halo
    would be ≥ :data:`~repro_torch.sparse.halo_probe.MAX_HALO_FRAC` of the
    vector; ``rows`` and ``halo`` reject operators that cannot be
    row-partitioned at all."""
    if requested == "auto":
        return probe.mode
    if requested == "halo":
        if probe.mode == "replicated":
            raise ValueError(
                f"mode='halo' needs an ELL-convertible operator "
                f"(got {type(A).__name__}); use mode='replicated'")
        return probe.mode        # may fall back to "rows" (halo too wide)
    if requested == "rows" and probe.mode == "replicated":
        raise ValueError(
            f"mode='rows' needs an ELL-convertible operator "
            f"(got {type(A).__name__}); use mode='replicated'")
    return requested


_PLAN_CACHE: OrderedDict = OrderedDict()
_PLAN_CACHE_SIZE = 16


def plan_operator(A, n_shards: int = 1, *, reorder: str = "auto",
                  matvec_mode: str = "auto", pgrid=None,
                  allow_block3d: bool = True,
                  max_halo_frac: float = MAX_HALO_FRAC) -> OperatorPlan:
    """Build (or fetch) the :class:`OperatorPlan` for one solve setup.

    ``reorder``: ``"none"`` leaves the operator untouched; ``"rcm"`` always
    applies the Reverse Cuthill-McKee permutation (raising for operators
    without an inspectable pattern); ``"auto"`` applies it only when it
    flips the sharded matvec from the gathered fallback to the
    neighbour-exchange halo path.  ``matvec_mode`` is the requested
    partition mode, resolved against the post-reorder probe; ``"auto"``
    also considers the 3-D block partition (``allow_block3d``) when the
    operator carries cell geometry (``A.grid``) or ``pgrid`` is forced.

    Plans are cached (bounded LRU) by ``(content fingerprint, n_shards,
    reorder, matvec_mode, max_halo_frac, pgrid, allow_block3d, cell grid,
    device)``; operators without a content fingerprint are planned
    uncached.  Each call counts in ``tracing.COUNTERS``: a hit, or a miss
    (a plan built, cached or not).
    """
    if reorder not in REORDERS:
        raise ValueError(f"unknown reorder mode {reorder!r}; "
                         f"expected one of {REORDERS}")
    if matvec_mode not in _MODES:
        raise ValueError(f"unknown partition mode {matvec_mode!r}; "
                         f"expected one of {_MODES}")
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"operator planning needs a square operator, "
                         f"got shape {A.shape}")
    pgrid_t = None if pgrid is None else tuple(int(p) for p in pgrid)

    fp = _fingerprint(A)
    cache_key = None
    if fp is not None:
        # the device too: the plan's operator lives on the input's device
        cache_key = (fp, int(n_shards), reorder, matvec_mode,
                     float(max_halo_frac), pgrid_t, bool(allow_block3d),
                     grid_of(A), str(_device_of(A)))
        hit = _PLAN_CACHE.get(cache_key)
        if hit is not None:
            tracing.COUNTERS["plan_cache_hits"] += 1
            _PLAN_CACHE.move_to_end(cache_key)
            return hit

    tracing.COUNTERS["plan_cache_misses"] += 1
    plan = _build_plan(A, int(n_shards), reorder, matvec_mode,
                       max_halo_frac, fp, pgrid_t, bool(allow_block3d))
    if cache_key is not None:
        _PLAN_CACHE[cache_key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_SIZE:
            _PLAN_CACHE.popitem(last=False)
    return plan


def _build_plan(A, n_shards: int, reorder: str, matvec_mode: str,
                max_halo_frac: float, fp: str | None, pgrid: tuple | None,
                allow_block3d: bool) -> OperatorPlan:
    raw_probe = halo_probe(A, n_shards, max_halo_frac=max_halo_frac)
    raw_bw = raw_probe.bandwidth

    op, perm, probe, executed = A, None, raw_probe, "none"
    want_halo = matvec_mode in ("auto", "halo", "block3d")
    if reorder == "rcm" or (
        reorder == "auto" and want_halo and n_shards > 1
        and raw_probe.mode == "rows"
    ):
        if pattern_of(A) is None:
            if reorder == "rcm":
                raise ValueError(
                    f"reorder='rcm' needs an operator with an inspectable "
                    f"sparsity pattern (CSR/ELL); got {type(A).__name__}")
            # auto: bare-matvec operators simply cannot be reordered
        else:
            perm_try = rcm_permutation(A)
            op_try = permute_csr(A, perm_try)
            probe_try = halo_probe(op_try, n_shards,
                                   max_halo_frac=max_halo_frac)
            # auto adopts the permutation only when it unlocks the halo
            # path; forced rcm keeps it regardless
            if reorder == "rcm" or probe_try.mode == "halo":
                op, perm, probe, executed = (op_try, perm_try, probe_try,
                                             "rcm")

    block = None
    if matvec_mode == "block3d":
        block = block_partition(op, n_shards, pgrid=pgrid)
        mode = "block3d"
    else:
        mode = _resolve_mode(matvec_mode, probe, op)
        # auto considers the 3-D block partition when the operator knows
        # its cell geometry (or a process grid is forced), adopting it only
        # when its modelled face wire beats the 1-D alternative
        if (matvec_mode == "auto" and allow_block3d and n_shards > 1
                and mode in ("halo", "rows")
                and (pgrid is not None or grid_of(op) is not None)):
            try:
                cand = block_partition(op, n_shards, pgrid=pgrid)
            except ValueError:
                cand = None
            if cand is not None:
                w3 = sum(cand.wire_sizes)
                w1 = (2 * probe.bandwidth if mode == "halo"
                      else (n_shards - 1) * probe.n_local)
                if w3 < w1:
                    mode, block = "block3d", cand

    op_fp = _fingerprint(op) if executed == "rcm" else fp
    n = A.shape[0]
    if block is not None:
        n_pad, n_local = block.n_pad, block.n_local
        # compose (optional RCM over logical rows) with the padded-space
        # block layout: perm_full[new chunk slot] = original row (or pad
        # id >= n) — what embed()/extract() apply
        perm_ext = (np.arange(n_pad) if perm is None
                    else np.concatenate([perm, np.arange(n, n_pad)]))
        full = perm_ext[block.perm]
        trivial = n_pad == n and np.array_equal(full, np.arange(n))
        perm_v = None if trivial else full
        op = block.operator
        key = (op_fp, int(n_shards), executed, mode, block.grid,
               block.pgrid)
    else:
        n_pad, n_local = probe.n_pad, probe.n_local
        perm_v = perm
        key = (op_fp, int(n_shards), executed, mode)
    return OperatorPlan(
        operator=op,
        n=n,
        n_shards=n_shards,
        n_pad=n_pad,
        n_local=n_local,
        requested_reorder=reorder,
        requested_matvec=matvec_mode,
        reorder=executed,
        perm=perm_v,
        iperm=None if perm_v is None else inverse_permutation(perm_v),
        raw_bandwidth=raw_bw,
        probe=probe,
        matvec_mode=mode,
        key=key,
        pgrid=None if block is None else block.pgrid,
        block=block,
    )
