"""Three-term roofline of one step, counted as it runs (no card needed).

Terms (per step, seconds) for an NVIDIA H100 SXM:

  compute    = FLOPs_per_device            / peak_FLOPs   (989 TF dense bf16)
  memory     = bytes_per_device            / HBM rate     (3.35 TB/s)
  collective = collective_operand_bytes    / link rate    (450 GB/s NVLink)

The port of ``repro/roofline/analysis.py``.  Where the reference reads
XLA's ``cost_analysis()`` of a compiled SPMD module, :func:`analyze_step`
runs the step once under :class:`CostMode`, a ``TorchDispatchMode`` that
lets DTensor desugar every op first and so sees each rank's *local* ops
and the functional collectives (``torch.ops._c10d_functional.*``) that
DTensor issues: its counts are per device, as XLA's are.

* FLOPs: ``torch.utils.flop_counter``'s formulas on the local shapes.
* Bytes: every op's tensor operands and results (an in-place op's
  written operand once; views and ``empty`` move nothing): an unfused
  upper bound, the counterpart of XLA:CPU's ``bytes accessed``;
  ``roofline.analytic.bytes_model`` is the floor.  A region that a Hopper
  kernel computes on the card counts that kernel's reads and writes
  (:func:`kernel_cost`), not the ops of the plain version that the meta
  device runs in its place.
* Collectives: the operand bytes of each, by kind.
* Memory: the peak of the bytes that the step's results hold live (a
  storage counted from the op that made it until its last tensor is
  freed), beside the arguments' bytes.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["HW_H100", "RooflineReport", "CostMode", "analyze_step",
           "collective_bytes", "model_flops_for", "COLLECTIVE_KINDS"]


HW_H100 = dict(
    name="h100-sxm",
    # dense bf16 tensor-core peak (NVIDIA H100 Tensor Core GPU data sheet,
    # SXM5: 1,979 TFLOP/s with sparsity, half of it dense)
    peak_flops=989e12,
    # HBM3 bandwidth (same data sheet, H100 SXM5 80 GB: 3.35 TB/s)
    hbm_bw=3.35e12,
    # NVLink 4: 900 GB/s a GPU in both directions (same data sheet), 450 GB/s
    # one way
    link_bw=450e9,
)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "permute", "broadcast")

#: functional-collective op name -> kind (the ``_c10d_functional`` ops that
#: DTensor's redistributions issue, and DTensor's own all-to-all)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "permute_tensor": "permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str | None:
    ns = getattr(func, "namespace", "")
    if ns not in ("_c10d_functional", "_dtensor", "c10d_functional"):
        return None
    return _COLLECTIVE_OPS.get(func._overloadpacket.__name__)


def _aliasing(func) -> str | None:
    """``"view"`` for an op whose results alias an input without writing
    it, ``"write"`` for an in-place or ``out=`` op (its results are its
    written inputs), None for an op whose results are new tensors."""
    if func in (torch.ops.aten.detach.default, torch.ops.aten.alias.default):
        return "view"
    rets = func._schema.returns
    if not rets or any(r.alias_info is None for r in rets):
        return None
    return ("write" if any(r.alias_info.is_write for r in rets)
            else "view")


_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "wait_tensor", "_local_scalar_dense",
             "lift_fresh", "lift_fresh_copy"}


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live bytes of the ops it sees.

    Entered around a step whose arguments are DTensors, it hands every op on
    DTensors back to DTensor (``NotImplemented``), so what it counts are the
    local ops and collectives each rank runs.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.records: list[tuple[str, int]] = []
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list] = {}
        self._in_kernel = 0

    def __enter__(self):
        from repro_torch.dist import act_sharding

        act_sharding.KERNEL_LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.dist import act_sharding

        act_sharding.KERNEL_LISTENERS.remove(self)
        return super().__exit__(*exc)

    def enter_kernel(self) -> None:
        self._in_kernel += 1

    def exit_kernel(self, name: str, args, out) -> None:
        """A kernel region's local call ended: count what its kernel reads
        and writes (:func:`kernel_cost`) and hold its results live, in place
        of the plain version's ops that ran on the meta device."""
        self._in_kernel -= 1
        flops, nbytes = kernel_cost(name, args, out)
        self.flops += flops
        self.bytes += nbytes
        self.ops += 1
        for t in _tensors(out):
            self._track(t, new=True)

    def _track(self, t: torch.Tensor, new: bool) -> None:
        """Count ``t``'s storage live until its last tracked tensor dies:
        a ``new`` storage from now, a view's only if its storage was made
        by a tracked op (the step's arguments are not counted here)."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            if not new:
                return
            entry = self._storages[key] = [st.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (self._in_kernel or any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(m, FakeTensorMode)
                       for m in _get_current_dispatch_mode_stack())):
            # a kernel's plain version, or DTensor's own shape inference
            # (fake tensors over global shapes, run as meta kernels)
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        self.ops += 1
        kind = _collective_kind(func)
        alias = _aliasing(func)
        if kind is not None:
            self.records.append((kind, sum(_nbytes(t) for t in
                                           _tensors((args, kwargs)))))
        else:
            packet = func._overloadpacket
            formula = self._flop_registry.get(packet)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if alias != "view" and packet.__name__ not in _NO_BYTES:
                self.bytes += sum(_nbytes(t) for t in
                                  _tensors((args, kwargs)))
                if alias is None:
                    self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if alias != "write":
            for t in _tensors(out):
                self._track(t, new=alias is None)
        return out


def kernel_cost(name: str, args, out) -> tuple[int, int]:
    """(FLOPs, bytes) of one kernel launch on its local tensors, as the
    Hopper kernel moves them: ``decode_attn`` reads q and every cached
    position's codes and exponents (the cell's cache is full) and writes
    the output, 4 B H S D FLOPs (q K^T and P V); ``frsz2_cache_write``
    reads the new K and V (and lengths) and writes their codes and
    exponents, no FLOPs."""
    if name == "decode_attn":
        q, k_codes = args[0], args[1]
        B, H, D = q.shape
        S = k_codes.shape[2]
        nbytes = sum(_nbytes(t) for t in _tensors(args)) + sum(
            _nbytes(t) for t in _tensors(out))
        return 4 * B * H * S * D, nbytes
    if name == "frsz2_cache_write":
        k, v, *rest = args
        codes = [t for t in rest if t is not None and t.ndim == 4]
        B, T, Hkv, D = k.shape
        per_row = (codes[0].element_size() * D + 1) if codes else 0
        read = _nbytes(k) + _nbytes(v) + sum(
            _nbytes(t) for t in rest if t is not None and t.ndim == 1)
        return 0, read + 2 * B * T * Hkv * per_row
    raise ValueError(f"no cost model for kernel {name!r}")


def collective_bytes(records) -> dict:
    """Operand bytes by kind over recorded ``(kind, bytes)`` collectives
    (per device, per step); every kind present, 0 where none ran."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, nbytes in records:
        out[kind] += nbytes
    return out


@dataclasses.dataclass
class RooflineReport:
    flops: float               # per device per step
    bytes_hbm: float           # per device per step (unfused upper bound)
    bytes_coll: float          # per device per step (operand sum)
    coll_by_op: dict
    t_compute: float
    t_memory: float            # from bytes_hbm (upper bound)
    t_collective: float
    model_flops: float         # useful-work flops per device per step
    bytes_model: float = 0.0   # analytic well-fused floor (roofline/analytic)
    memory_stats: Any = None
    hw: dict = dataclasses.field(default_factory=lambda: HW_H100)

    @property
    def t_memory_floor(self) -> float:
        return self.bytes_model / self.hw["hbm_bw"]

    @property
    def dominant(self) -> str:
        """Dominant term, judged on the fused-execution (floor) memory
        model; t_memory (counted) is the upper."""
        t_mem = self.t_memory_floor if self.bytes_model else self.t_memory
        terms = {"compute": self.t_compute, "memory": t_mem,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        t_mem = self.t_memory_floor if self.bytes_model else self.t_memory
        return max(self.t_compute, t_mem, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ideal-work roofline achieved: time for the pure
        model math at the compute peak vs the achieved bound time."""
        ideal = max(self.model_flops / self.hw["peak_flops"], 1e-30)
        return min(ideal / self.t_bound, 1.0) if self.t_bound else 0.0

    @property
    def step_roofline_fraction(self) -> float:
        """max(terms') / achieved-bound where terms' are the *irreducible*
        resources for this step: useful flops at peak AND floor bytes at
        bandwidth.  This is the score a memory-bound step can actually
        reach 100% on (a decode step can never beat the cache stream)."""
        ideal = max(self.model_flops / self.hw["peak_flops"],
                    self.bytes_model / self.hw["hbm_bw"]
                    if self.bytes_model else 0.0, 1e-30)
        return min(ideal / self.t_bound, 1.0) if self.t_bound else 0.0

    def row(self) -> dict:
        return dict(
            flops=self.flops, bytes=self.bytes_hbm, coll=self.bytes_coll,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, dominant=self.dominant,
            useful=self.useful_ratio,
        )


def _local_bytes(tree) -> int:
    """Bytes of the tensors of a tree on this rank (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        total += _nbytes(t)
    return total


def count_step(step, args) -> tuple[CostMode, Any, float]:
    """Run ``step(*args)`` once under a :class:`CostMode` -> (the mode with
    its counts, the step's outputs, the seconds it took)."""
    mode = CostMode()
    t0 = time.perf_counter()
    with mode:
        out = step(*args)
    return mode, out, time.perf_counter() - t0


def analyze_step(cell, *, model_flops_global: float, chips: int,
                 hw: dict = HW_H100, bytes_model: float = 0.0
                 ) -> RooflineReport:
    """Run ``cell.step(*cell.args)`` once and count it per device.

    ``memory_stats``: ``arg_bytes`` (the arguments' local shards),
    ``temp_bytes`` (the counted peak of live bytes the step made),
    ``out_bytes`` (its outputs' local shards), ``trace_s`` and ``ops``.
    """
    mode, out, secs = count_step(cell.step, cell.args)
    coll = collective_bytes(mode.records)
    coll_total = float(sum(coll.values()))
    mem = dict(arg_bytes=_local_bytes(cell.args), temp_bytes=mode.peak,
               out_bytes=_local_bytes(out), trace_s=secs, ops=mode.ops)
    del out
    return RooflineReport(
        flops=float(mode.flops),
        bytes_hbm=float(mode.bytes),
        bytes_coll=coll_total,
        coll_by_op={k: v for k, v in coll.items() if v},
        t_compute=mode.flops / hw["peak_flops"],
        t_memory=mode.bytes / hw["hbm_bw"],
        t_collective=coll_total / hw["link_bw"],
        model_flops=model_flops_global / chips,
        bytes_model=bytes_model,
        memory_stats=mem,
        hw=hw,
    )


def model_flops_for(cfg, shape) -> float:
    """Useful-work FLOPs per step (global): 6·N·D train, 2·N·D inference,
    with N = active params (MoE) and D = tokens processed this step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token per seq
