"""Stage 2: audits of what the drivers run.

Where the lint reads source, these audits run the port's device drivers
(``gmres(..., driver="device")``, ``gmres_block``, the sharded solve) on
small problems and check what only a run shows:

* **retrace** (``audit_recapture``) -- a second same-shape solve must
  capture no new graph: no entry added to ``solver/gmres.py::_GRAPHS`` and
  no further capture (``tracing.COUNTERS["graph_captures"]``).  Only CUDA
  captures, so the graph legs run on the card; the sharded leg
  (``audit_sharded_recapture``, inside a process group) also holds the
  partition cache (``solver/sharded.py::_PARTITIONS``) to one entry, on
  either device.
* **f64-leak** (``audit_f64_leak``) -- one ``_device_cycle`` of an
  ``frsz2_16`` basis at f32 arithmetic, fused (the coded-operand SpMV) and
  not, runs under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
  that records every op whose output is f64.  The least-squares state is
  f64 at every arithmetic dtype in the port (``kernels/ref.py``'s layout,
  ``csrc/gmres_step.cu``), where the JAX package keeps it in the arithmetic
  dtype: writes into the state and the ops of the Givens step are allowed
  by name (:data:`F64_ALLOWED`).  Anything else is a finding.
* **transfer** (``audit_host_reads``) -- a warmed fixed-trajectory solve
  runs under ``torch.cuda.set_sync_debug_mode("warn")`` with the warnings
  recorded, and under a dispatch mode that records host-to-device copies;
  the counts must equal what the driver documents (``HOST_TRAFFIC`` in
  ``solver/gmres.py`` and ``solver/block.py``) exactly.  On the card only.

An audit that cannot run raises; the CLI turns that into a finding for the
leg (``repro_torch.analysis.__main__``), never into a clean report.
"""
from __future__ import annotations

import importlib
import sys
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.analysis.report import Finding

__all__ = [
    "F64_ALLOWED",
    "audit_f64_leak",
    "audit_host_reads",
    "audit_recapture",
    "audit_sharded_recapture",
    "block_rhs",
    "fixed_trajectory",
    "problem",
    "run_local_audits",
]


def _finding(audit: str, rule: str, message: str) -> Finding:
    return Finding(path=f"trace:{audit}", line=0, rule=rule, message=message)


def problem(n: int = 180, device="cuda", dtype=None):
    """``synth:atmosmod`` at ``n`` on ``device``: ``(A, b, target)``, ``b``
    the paper's right-hand side (``A`` and ``b`` in ``dtype``, default the
    problem's float64)."""
    import numpy as np

    from repro_torch.sparse import make_problem, rhs_for

    A, target = make_problem("synth:atmosmod", n,
                             dtype=np.float64 if dtype is None else dtype,
                             device=device)
    b, _ = rhs_for(A, device=device)
    return A, b, float(target)


def block_rhs(b: torch.Tensor, p: int) -> torch.Tensor:
    """``p`` right-hand sides from ``b``: seeded normals, each scaled to
    ``||b||`` (a fixed trajectory needs none of them to converge early)."""
    import numpy as np

    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.standard_normal((p, b.shape[0])),
                        dtype=b.dtype, device=b.device)
    return B / torch.linalg.vector_norm(B, dim=1, keepdim=True) * \
        torch.linalg.vector_norm(b)


def fixed_trajectory(m: int, k: int) -> dict:
    """The solve options that pin a trajectory: ``target_rrn=0`` never
    converges (no early stop, no stagnation: that needs an estimate at the
    target), CGS2 fires no conditional pass, ``max_iters = k*m`` runs
    exactly ``k`` cycles of ``m`` steps."""
    return dict(ortho="cgs2", m=m, max_iters=k * m, target_rrn=0.0)


# ---------------------------------------------------------------------------
# retrace: a second same-shape solve captures no new graph
# ---------------------------------------------------------------------------


def _two_solves(label, solve, info) -> list[Finding]:
    """Run ``solve()`` twice; the second must add no graph and no capture."""
    G = importlib.import_module("repro_torch.solver.gmres")

    findings = []
    start = tracing.COUNTERS["graph_captures"]
    r1 = solve()
    graphs1 = len(G._GRAPHS)
    caps1 = tracing.COUNTERS["graph_captures"] - start
    r2 = solve()
    graphs2 = len(G._GRAPHS)
    caps2 = tracing.COUNTERS["graph_captures"] - start
    info[label] = dict(graphs=[graphs1, graphs2], captures=[caps1, caps2])
    if caps1 == 0 or graphs1 == 0:
        findings.append(_finding(label, "retrace", (
            f"the first solve captured {caps1} graphs into {graphs1} cache "
            "entries: the audit problem did not reach the captured cycle")))
    if graphs2 != graphs1 or caps2 != caps1:
        findings.append(_finding(label, "retrace", (
            f"a second same-shape solve captured again: _GRAPHS {graphs1} -> "
            f"{graphs2} entries, _capture called {caps1} -> {caps2} times; "
            "the graph cache key is unstable for repeated solves")))
    its = ([r.iterations for r in r1], [r.iterations for r in r2])
    if its[0] != its[1]:
        findings.append(_finding(label, "retrace", (
            f"the repeated solve diverged from its first run ({its[0]} vs "
            f"{its[1]} iterations): the replayed graph is not the captured "
            "one")))
    return findings


def audit_recapture(A, b, *, m: int = 8, k: int = 2, p: int = 3,
                    info: dict | None = None) -> list[Finding]:
    """The device driver and ``gmres_block`` (``p`` right-hand sides), each
    solved twice on the fixed trajectory with the graph cache cleared
    first.  CUDA only (the CPU captures nothing): on a CPU ``b`` it checks
    nothing and says so in ``info``."""
    from repro_torch.solver import clear_graph_cache, gmres
    from repro_torch.solver.block import gmres_block

    info = {} if info is None else info
    if not b.is_cuda:
        info["skipped"] = "the CPU captures no graph"
        return []
    kw = dict(storage="frsz2_32", **fixed_trajectory(m, k))
    B = block_rhs(b, p)
    findings = []
    clear_graph_cache()
    findings += _two_solves("recapture[device]",
                            lambda: [gmres(A, b, **kw)], info)
    clear_graph_cache()
    findings += _two_solves("recapture[block]",
                            lambda: gmres_block(A, B, **kw), info)
    clear_graph_cache()
    return findings


def audit_sharded_recapture(A, b, *, shard: int, m: int = 8, k: int = 2,
                            info: dict | None = None) -> list[Finding]:
    """The sharded solve on this rank of a live group of ``shard`` ranks,
    twice: one partition-cache entry, and on the card no new graph."""
    from repro_torch.solver import clear_graph_cache, gmres
    from repro_torch.solver import sharded as S

    info = {} if info is None else info
    kw = dict(storage="frsz2_32", shard=shard, shard_transport="plain",
              **fixed_trajectory(m, k))
    label = "recapture[sharded]"
    clear_graph_cache()
    S._PARTITIONS.clear()
    findings = []
    if b.is_cuda:
        findings += _two_solves(label, lambda: [gmres(A, b, **kw)], info)
    else:
        r1 = gmres(A, b, **kw)
        r2 = gmres(A, b, **kw)
        info[label] = dict(iterations=[r1.iterations, r2.iterations])
        if r1.iterations != r2.iterations:
            findings.append(_finding(label, "retrace", (
                f"the repeated sharded solve diverged ({r1.iterations} vs "
                f"{r2.iterations} iterations)")))
    info[label]["partitions"] = len(S._PARTITIONS)
    if len(S._PARTITIONS) != 1:
        findings.append(_finding(label, "retrace", (
            f"two identical sharded solves left {len(S._PARTITIONS)} "
            "_PARTITIONS entries (expected 1): each solve partitions the "
            "operator again, and on the card captures a new graph")))
    clear_graph_cache()
    S._PARTITIONS.clear()
    return findings


# ---------------------------------------------------------------------------
# f64-leak: no f64 tensor made by an frsz2_16 cycle at f32 arithmetic
# ---------------------------------------------------------------------------

#: what may make f64 tensors inside an f32 cycle, and why
F64_ALLOWED = {
    "the least-squares state": (
        "the port keeps the Givens least squares in f64 at every "
        "arithmetic dtype (kernels/ref.py givens_layout, "
        "csrc/gmres_step.cu): writes into the state tensor"),
    "kernels/ops.py::givens_step": (
        "the Givens step of that state, on the card and its plain version"),
    "kernels/ref.py::givens_step_ref": (
        "the Givens step's plain version, the CPU route"),
}
_F64_FRAMES = {tuple(k.split("::")) for k in F64_ALLOWED if "::" in k}


def _in_allowed_frame() -> bool:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_name
        fn = f.f_code.co_filename.replace("\\", "/")
        if any(name == n and fn.endswith(p) for p, n in _F64_FRAMES):
            return True
        f = f.f_back
    return False


def _caller_site(depth: int = 2) -> str:
    """Where an op was made: the innermost frame outside torch's and this
    module's Python (a port module, or a caller's cycle), with torch's
    innermost frame before it when the op came through torch's Python."""
    f = sys._getframe(depth)
    via = None
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        where = (f"{'/'.join(fn.split('/')[-2:])}:{f.f_lineno} "
                 f"({f.f_code.co_name})")
        if "/torch/" in fn:
            via = via or where
        elif not fn.endswith(("analysis/traceaudit.py", "/warnings.py")):
            return where if via is None else f"{via} <- {where}"
        f = f.f_back
    return via or "?"


class _F64Recorder(TorchDispatchMode):
    """Records every op whose output is an f64 tensor, but writes into
    ``state`` and ops inside the allowed functions."""

    def __init__(self, state: torch.Tensor):
        super().__init__()
        self.state_ptr = state.untyped_storage().data_ptr()
        self.hits: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if not (isinstance(t, torch.Tensor) and t.dtype == torch.float64):
                continue
            if t.untyped_storage().data_ptr() == self.state_ptr:
                continue
            if _in_allowed_frame():
                continue
            key = f"{func.__name__} at {_caller_site()}"
            self.hits[key] = self.hits.get(key, 0) + 1
        return out


def audit_f64_leak(A32, b32, *, m: int = 6, cycle=None,
                   info: dict | None = None) -> list[Finding]:
    """One ``_device_cycle`` (or ``cycle``, with its signature) of an
    ``frsz2_16`` basis at f32 arithmetic on ``A32``/``b32`` (f32, on one
    device), fused and unfused, under the f64 recorder."""
    from repro_torch.core.accessor import BasisAccessor, format_by_name
    from repro_torch.kernels import ref
    G = importlib.import_module("repro_torch.solver.gmres")
    from repro_torch.solver.pipeline import (
        IdentityPreconditioner,
        orthogonalizer_by_name,
    )

    if A32.dtype != torch.float32 or b32.dtype != torch.float32:
        raise ValueError("the f64 audit needs an f32 operator and vector")
    cycle = G._device_cycle if cycle is None else cycle
    info = {} if info is None else info
    ad = torch.float32
    acc = BasisAccessor(fmt=format_by_name("frsz2_16", arith_dtype=ad),
                        m=m + 1, n=b32.shape[0], arith_dtype=ad,
                        device=b32.device)
    findings = []
    for fused in (True, False):
        label = f"f64[frsz2_16, f32, {'fused' if fused else 'unfused'}]"
        store = acc.empty()
        init = ref.givens_init_ref(m, acc.device)
        state = torch.empty_like(init)
        beta = torch.linalg.vector_norm(b32)
        rec = _F64Recorder(state)
        with rec:
            cycle(A32.matvec, acc, store, state, init, b32, beta, beta,
                  0.7071067811865475, 0.0, orthogonalizer_by_name("cgs2"),
                  IdentityPreconditioner(), fused)
        if b32.is_cuda:
            torch.cuda.synchronize()
        info[label] = dict(rec.hits)
        for what, count in sorted(rec.hits.items()):
            findings.append(_finding(label, "f64-leak", (
                f"{count}x {what} made a float64 tensor inside the "
                "frsz2_16/f32 cycle, outside the least-squares state: "
                "precision escaped the StorageFormat")))
    return findings


# ---------------------------------------------------------------------------
# transfer: host reads and host-to-device copies of a warmed solve
# ---------------------------------------------------------------------------


class _H2DRecorder(TorchDispatchMode):
    """Records copies whose source is on the host and result on the card."""

    _COPIES = ("_to_copy", "copy_", "copy", "to", "_copy_from",
               "lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.sites: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if name in self._COPIES:
            srcs = [a for a in list(args) + list((kwargs or {}).values())
                    if isinstance(a, torch.Tensor)]
            dst = out if isinstance(out, torch.Tensor) else None
            if name == "copy_" and srcs:
                dst, srcs = srcs[0], srcs[1:]
            if (dst is not None and dst.is_cuda
                    and any(not s.is_cuda for s in srcs)):
                self.sites.append(f"{func.__name__} at {_caller_site()}")
        return out


def _expected(traffic: dict, restarts: int, cycles: int) -> int:
    return (traffic["solve"] + traffic["restart"] * restarts
            + traffic["cycle"] * cycles)


def _watched(label, solve, traffic, k, m, info) -> list[Finding]:
    """Run the warmed fixed-trajectory ``solve()`` (``k`` cycles of ``m``)
    with syncs and host-to-device copies recorded, against the driver's
    documented ``traffic``."""
    solve()                                      # warm: capture the graph
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    rec = _H2DRecorder()
    syncs: list[str] = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append(_caller_site(1))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        syncs.clear()              # the first switch of a process syncs
        try:
            with rec:
                res = solve()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    r = res[0]
    if r.restarts != k or r.iterations != k * m:
        return [_finding(label, "transfer", (
            f"fixed-trajectory assumption broke: {r.restarts} restarts / "
            f"{r.iterations} iterations, expected {k} / {k * m} -- the "
            "audit's premises no longer hold, fix the audit"))]
    copies = _expected(traffic["copies"], k, k)  # a cycle each restart
    reads = _expected(traffic["reads"], k, k)
    info[label] = dict(restarts=r.restarts, syncs=len(syncs),
                       h2d_copies=len(rec.sites), reads=len(syncs)
                       - len(rec.sites), expected_reads=reads,
                       expected_copies=copies, sync_sites=syncs,
                       copy_sites=rec.sites)
    findings = []
    if len(rec.sites) != copies:
        findings.append(_finding(label, "transfer", (
            f"{len(rec.sites)} host-to-device copies where the driver "
            f"documents {copies} ({r.restarts} restarts): "
            + "; ".join(rec.sites))))
    if len(syncs) != reads + copies:
        findings.append(_finding(label, "transfer", (
            f"{len(syncs)} synchronizations ({len(syncs) - len(rec.sites)} "
            f"reads) where the driver documents {reads} reads and {copies} "
            f"copies ({r.restarts} restarts): " + "; ".join(syncs))))
    return findings


def audit_host_reads(A, b, *, m: int = 8, k: int = 2, p: int = 3,
                     info: dict | None = None) -> list[Finding]:
    """Warmed fixed-trajectory solves of the device driver and of
    ``gmres_block`` against their ``HOST_TRAFFIC``.  CUDA only."""
    from repro_torch.solver import block as BL
    from repro_torch.solver import clear_graph_cache, gmres
    G = importlib.import_module("repro_torch.solver.gmres")

    info = {} if info is None else info
    if not b.is_cuda:
        info["skipped"] = "host reads are a card's"
        return []
    kw = dict(storage="frsz2_32", **fixed_trajectory(m, k))
    B = block_rhs(b, p)
    clear_graph_cache()
    findings = _watched("host-reads[device]", lambda: [gmres(A, b, **kw)],
                        G.HOST_TRAFFIC, k, m, info)
    findings += _watched("host-reads[block]",
                         lambda: BL.gmres_block(A, B, **kw),
                         BL.HOST_TRAFFIC, k, m, info)
    clear_graph_cache()
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_local_audits(device="cuda", info: dict | None = None
                     ) -> list[Finding]:
    """Every stage-2 audit that needs no process group, on ``device``."""
    import numpy as np

    info = {} if info is None else info
    A, b, _ = problem(180, device)
    A32, b32, _ = problem(180, device, dtype=np.float32)
    findings = audit_recapture(A, b, info=info)
    findings += audit_f64_leak(A32, b32, info=info)
    findings += audit_host_reads(A, b, info=info)
    return findings
