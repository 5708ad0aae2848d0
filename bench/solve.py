"""Closed-loop solves: the one generator of the traffic mixes.

One client solves one request after another, as a CFD time stepper or a
Newton loop does: it cannot build the next right-hand side before the last
solve returned.  A request is ``rhs_per_request`` fresh right-hand sides
from the paper's family (Sec. V-B: ``x_true[i] = sin(i)``, normalised):
``x_true[i] = sin(i + phi)`` with the phase ``phi`` drawn uniformly from
``[0, 2 pi)`` by the run's seed, one a right-hand side, normalised; ``b = A
x_true`` on the harness's own copy of the operator.  One right-hand side
goes to ``repro_torch.solver.gmres``, several to ``gmres_batched(method=
"block")``, with the configuration's solver settings and the traffic's
storage format (``storage``), its ``reorder`` (default ``"none"``) and its
restart length (``m``, default the configuration's).  The operator is the
configuration's, built by :mod:`bench.operators`, and fixed.

Set-up: the operator (host arrays, the harness's device copy, the
program's CSR), the program's kernel libraries, one warm-up solve of the
cell's shape (which plans the operator and captures the cycle's CUDA
graph).  The window then runs requests
back to back until ``seconds`` have passed; each request's latency runs
from handing ``b`` over to ``x`` back and synchronised.  A seeded sample of
the requests (``check_rhs`` right-hand sides, whole requests) keeps its
``b`` and ``x`` in buffers that set-up allocated, and the plain reference
judges them after the window (:mod:`bench.reference`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import random
import time

import numpy as np
import torch

from bench import counts, operators, reference
from bench.trace import Trace, read_profile


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    device: str                  # the card's name, or "cpu"
    n: int
    nnz: int
    fmt: str
    block: bool
    m: int
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: list = dataclasses.field(default_factory=list)
    program_peak_bytes: int | None = None
    process_peak_bytes: int | None = None
    trace: Trace | None = None
    traced: list = dataclasses.field(default_factory=list)
    checks: dict = dataclasses.field(default_factory=dict)
    checked: int = 0             # right-hand sides the reference judged
    rrn_max: float = math.nan    # their largest true RRN
    correct: bool = False

    @property
    def attempted(self) -> int:
        return sum(r.p for r in self.requests)

    @property
    def failed(self) -> int:
        return sum(not c for r in self.requests for c in r.converged)


def _seeds(seed: int) -> list[int]:
    """Independent 63-bit seeds for the window's, the warm-up's and the
    sample's draws."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(
        3, np.uint64) >> np.uint64(1)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _record(results, m: int, target: float,
            latency: float) -> counts.Request:
    fired = np.asarray(results[0].fired, bool)
    history = np.stack([np.asarray(r.rrn_history) for r in results], axis=1)
    live = counts.live_steps(history.tolist(), m, target)
    if len(live) != fired.shape[0]:
        raise RuntimeError(f"{len(live)} cycles in the estimate history, "
                           f"{fired.shape[0]} in fired")
    return counts.Request(
        p=len(results), m=m, live=live,
        fired=[fired[c, :j].tolist() for c, j in enumerate(live)],
        iterations=[int(r.iterations) for r in results],
        converged=[bool(r.converged) for r in results], latency_s=latency)


def run_cell(cell: dict, config: dict, traffic: dict, *, seed: int,
             seconds: float, trace: bool, device: str, t0: float,
             spans) -> Run:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    p = int(traffic["rhs_per_request"])
    m = int(traffic.get("m", config["m"]))
    target = float(config["target_rrn"])
    fmt = traffic["storage"]

    with spans("imports"):
        solver = importlib.import_module("repro_torch.solver")
        from repro_torch.sparse.csr import CSR
    if cuda:
        with spans("cuda_init"):
            torch.empty(1, device=dev)
            torch.cuda.synchronize()
    with spans("operator"):
        indptr, indices, data = operators.load(config)
        n = indptr.size - 1
        # the harness's own device memory first: its operator and the
        # sample's buffers; the program's peak is counted above it
        make_b = reference.PlainEll(indptr, indices, data, dev)
        slots = max(1, math.ceil(int(traffic["check_rhs"]) / p))
        keep_b = torch.zeros((slots, p, n), dtype=torch.float64, device=dev)
        keep_x = torch.zeros_like(keep_b)
        i_n = torch.arange(n, dtype=torch.float64, device=dev)
        gen_seed, warm_seed, pick_seed = _seeds(seed)
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        warm = torch.Generator(device=dev).manual_seed(warm_seed)
        _sync(dev)
        harness_bytes = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        A = CSR(torch.as_tensor(indptr), torch.as_tensor(indices),
                torch.as_tensor(data), (n, n)).to(dev)
        _sync(dev)
    run = Run(cell=cell, config=config, traffic=traffic,
              device=torch.cuda.get_device_name(0) if cuda else "cpu",
              n=n, nnz=int(indices.size), fmt=fmt, block=p > 1, m=m)

    if cuda:
        with spans("library"):
            from repro_torch.kernels import build
            build.build_all()

    kw = dict(storage=fmt, m=m, max_iters=int(config["max_iters"]),
              target_rrn=target, eta=float(config["eta"]),
              ortho=config["ortho"], driver="device",
              reorder=traffic.get("reorder", "none"))

    def draw(g):
        phi = 2 * math.pi * torch.rand((p, 1), generator=g, device=dev,
                                       dtype=torch.float64)
        X = torch.sin(i_n + phi)
        X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
        return make_b(X)

    def solve(B):
        if p == 1:
            return [solver.gmres(A, B[0], **kw)]
        return solver.gmres_batched(A, B, method="block", **kw)

    with spans("warmup"):
        solve(draw(warm))
        _sync(dev)

    prof = None
    trace_s = min(float(traffic.get("trace_seconds", seconds)), seconds)
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
    pick = random.Random(pick_seed)
    run.setup_s = time.perf_counter() - t0
    if prof is not None:
        prof.start()
    t_ns = [time.time_ns(), None]
    start = time.perf_counter()
    i = 0
    while True:
        tracing = prof is not None and t_ns[1] is None
        with spans("request", index=i), (
                record_function("bench.request") if tracing
                else contextlib.nullcontext()):
            with spans("rhs"):
                B = draw(gen)
                _sync(dev)
            a = time.perf_counter()
            with spans("solve"):
                results = solve(B)
                _sync(dev)
            b = time.perf_counter()
            slot = i if i < slots else pick.randrange(i + 1)
            if slot < slots:
                keep_b[slot].copy_(B)
                keep_x[slot].copy_(torch.stack([r.x for r in results]))
        run.requests.append(_record(results, m, target, b - a))
        i += 1
        if tracing and b - start >= trace_s:
            _sync(dev)
            t_ns[1] = time.time_ns()
            prof.stop()
            run.traced = list(run.requests)
        if b - start >= seconds:
            break
    run.window_s = b - start
    del results, B
    if cuda:
        run.process_peak_bytes = torch.cuda.max_memory_allocated()
        run.program_peak_bytes = run.process_peak_bytes - harness_bytes
    if prof is not None:
        with spans("read_trace"):
            run.trace = read_profile(prof, t_ns[0], t_ns[1])
    del A, make_b
    solver.clear_graph_cache()

    with spans("check"):
        kept = min(i, slots)
        Bh = keep_b[:kept].reshape(kept * p, n).cpu().numpy()
        Xh = keep_x[:kept].reshape(kept * p, n).cpu().numpy()
        del keep_b, keep_x
        op = reference.Operator(indptr, indices, data)
        got = reference.residual_ratios(op, Bh, Xh, target)
    ratio = float(max((r for _, r in got), default=math.nan))
    run.checked = len(got)
    run.checks = {
        "rrn_ratio": dict(value=ratio if math.isfinite(ratio) else str(ratio),
                          limit=1.0),
        "unconverged": dict(value=run.failed, limit=0),
    }
    run.correct = (run.checked > 0 and math.isfinite(ratio) and ratio <= 1.0
                   and run.failed == 0)
    run.rrn_max = float(max((r for r, _ in got), default=math.nan))
    return run
