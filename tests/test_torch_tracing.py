"""The port's tracer (``repro_torch.tracing``) on the CPU: spans record only
under a profiler, with their parents, one solve id and a start that
matches the profiler's own event; the counters (steps, plan cache, graph
captures as the recapture audit reads them); and the benchmark's three
readers of the tracer's rows.

On the card, ``device_ms`` (CUDA events around each graph replay) is
timed as well; the CPU times none.
"""
import importlib
import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.sparse import make_problem, rhs_for
from repro_torch.sparse import plan as PL
from repro_torch.solver import gmres, gmres_batched

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import counts  # noqa: E402

torch.set_num_threads(2)

M = 20
CYCLE_SPANS = {"gmres.restart_residual", "gmres.replay", "gmres.cycle_read",
               "gmres.lstsq", "gmres.update", "gmres.explicit_residual"}


def _problem(n=512):
    A, target = make_problem("synth:atmosmod", n, device="cpu")
    b, _ = rhs_for(A, device="cpu")
    return A, b, float(target)


def _block(b, p=3):
    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.standard_normal((p, b.shape[0])))
    B = B / torch.linalg.vector_norm(B, dim=1, keepdim=True)
    B[0] = b / torch.linalg.vector_norm(b)
    return B


def _solve(kind, A, b, target, **kw):
    """One solve of ``kind``: ``(results, p)``."""
    kw = dict(storage="frsz2_32", m=M, target_rrn=target, **kw)
    if kind == "scalar":
        return [gmres(A, b, **kw)], 1
    return gmres_batched(A, _block(b), method="block", **kw), 3


def _history(results):
    """The solve's estimate history as ``bench.solve`` stacks it: one row a
    step, one column a right-hand side."""
    return np.stack([np.asarray(r.rrn_history) for r in results],
                    axis=1).tolist()


def test_nothing_is_recorded_without_a_profiler():
    A, b, target = _problem()
    tracing.reset()
    assert tracing.span("gmres.solve") is tracing.span("gmres.replay")
    for kind in ("scalar", "block"):
        _solve(kind, A, b, target)
    assert tracing.rows() == []
    assert tracing.counters()["steps_run"] > 0    # counters are always on


@pytest.mark.parametrize("kind", ["scalar", "block"])
def test_spans_under_a_profiler_nest_in_one_solve(kind):
    A, b, target = _problem()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results, p = _solve(kind, A, b, target)
    rows = tracing.rows()
    assert rows and all(r["end_ns"] is not None for r in rows)
    root = rows[0]
    assert root["name"] == "gmres.solve" and root["parent"] is None
    assert root["attrs"]["p"] == p and root["attrs"]["storage"] == "frsz2_32"
    assert isinstance(root["attrs"]["launches"], int)
    assert {r["solve"] for r in rows} == {root["solve"]}
    assert all(r["parent"] == 0 for r in rows[1:])
    assert all(root["start_ns"] <= r["start_ns"] <= r["end_ns"]
               <= root["end_ns"] for r in rows)
    names = [r["name"] for r in rows[1:]]
    assert CYCLE_SPANS <= set(names)
    assert ("gmres.b_norm" in names) == (kind == "scalar")
    replays = [r for r in rows if r["name"] == "gmres.replay"]
    assert len(replays) == len(results[0].fired) >= 1
    for r in replays:
        a = r["attrs"]
        assert a["steps_run"] == M and 1 <= a["steps_live"] <= M
        assert a["level"] == 0 and 0 <= a["fired"] <= M
        assert "device_ms" not in a                   # the CPU times none
    # each row is a range among the profiler's events, on the same clock:
    # the row is stamped just inside its range (a loaded host may preempt
    # the process between the two stamps, so the row's start is held to
    # its range, not to a fixed distance from the range's start)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gmres."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in set(names) | {"gmres.solve"}:
        spans = sorted((r["start_ns"], r["end_ns"]) for r in rows
                       if r["name"] == name)
        assert len(spans) == len(events[name]), name
        for (s, t), (a, b) in zip(spans, sorted(events[name])):
            assert a - 1_000_000 < s <= t < b + 1_000_000, (name, s - a)


@pytest.mark.parametrize("kind", ["scalar", "block"])
def test_steps_live_a_cycle_is_the_benchmarks_split(kind):
    A, b, target = _problem()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        results, _ = _solve(kind, A, b, target)
    live = [r["attrs"]["steps_live"] for r in tracing.rows()
            if r["name"] == "gmres.replay"]
    assert live == counts.live_steps(_history(results), M, target)
    c = tracing.counters()
    assert c["steps_live"] == sum(live)
    assert c["steps_run"] == M * len(live)


def test_host_driver_counts_the_steps_it_ran():
    A, b, target = _problem()
    tracing.reset()
    r = gmres(A, b, storage="frsz2_32", m=M, target_rrn=target,
              driver="host")
    c = tracing.counters()
    assert c["steps_run"] == c["steps_live"] == r.iterations


def test_plan_cache_counts_a_hit_on_a_second_rcm_plan():
    A, b, target = _problem(216)
    PL._PLAN_CACHE.clear()
    tracing.reset()
    PL.plan_operator(A, 1, reorder="rcm")
    assert (tracing.COUNTERS["plan_cache_misses"],
            tracing.COUNTERS["plan_cache_hits"]) == (1, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        gmres(A, b, storage="float64", m=M, target_rrn=target,
              reorder="rcm")
    assert (tracing.COUNTERS["plan_cache_misses"],
            tracing.COUNTERS["plan_cache_hits"]) == (1, 1)
    plan = [r for r in tracing.rows() if r["name"] == "gmres.plan"]
    assert len(plan) == 1 and plan[0]["parent"] == 0


def test_counters_snapshot_reads_launches_in_place():
    from repro_torch.kernels import ops

    snap = tracing.counters()
    assert {f"launches.{k}" for k in ops.LAUNCHES} <= set(snap)
    assert all(snap[f"launches.{k}"] == v for k, v in ops.LAUNCHES.items())
    snap["steps_run"] += 1                      # a copy, not the counters
    assert snap["steps_run"] != tracing.COUNTERS["steps_run"]


def test_summary_sums_self_time_without_children():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("gmres.solve"):
            with tracing.span("gmres.lstsq"):
                pass
            with tracing.span("gmres.lstsq"):
                pass
    rows = tracing.rows()
    got = tracing.summary(rows)
    assert got["gmres.lstsq"]["count"] == 2
    kids = sum(r["end_ns"] - r["start_ns"] for r in rows[1:]) * 1e-6
    root = (rows[0]["end_ns"] - rows[0]["start_ns"]) * 1e-6
    assert got["gmres.solve"]["self_ms"] == pytest.approx(root - kids)
    assert list(got)[0] == "gmres.solve"


def test_annotate_reaches_only_the_open_solve():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("gmres.solve"):
            with tracing.span("gmres.replay"):
                pass
            tracing.annotate("gmres.replay", steps_live=3)
        tracing.annotate("gmres.replay", steps_live=5)   # no open solve
        with tracing.span("gmres.solve"):
            tracing.annotate("gmres.replay", steps_live=7)  # none yet
    rows = tracing.rows()
    assert rows[1]["attrs"] == {"steps_live": 3}
    assert [r["solve"] for r in rows] == [rows[0]["solve"]] * 2 + [
        rows[2]["solve"]]
    assert rows[2]["solve"] != rows[0]["solve"]


# ---------------------------------------------------------------------------
# the recapture audit's capture count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recaptures", [False, True])
def test_recapture_audit_counts_captures_by_the_counter(recaptures):
    from repro_torch.analysis import traceaudit
    from repro_torch.solver import clear_graph_cache

    G = importlib.import_module("repro_torch.solver.gmres")
    clear_graph_cache()
    calls = []

    def solve():
        """A stand-in solve that captures on its first call (or every
        call) into the graph cache, as the device drivers count it."""
        if recaptures or not calls:
            tracing.COUNTERS["graph_captures"] += 1
            G._GRAPHS[len(calls)] = object()
        calls.append(1)
        return [types.SimpleNamespace(iterations=5)]

    info = {}
    try:
        got = traceaudit._two_solves("recapture[device]", solve, info)
    finally:
        clear_graph_cache()
    if recaptures:
        assert info["recapture[device]"]["captures"] == [1, 2]
        assert {f.rule for f in got} == {"retrace"}
    else:
        assert info["recapture[device]"] == dict(graphs=[1, 1],
                                                 captures=[1, 1])
        assert got == []


# ---------------------------------------------------------------------------
# the benchmark's readers of the rows
# ---------------------------------------------------------------------------

READERS = ("cycle_ms_per_rhs", "between_cycles_ms_per_rhs",
           "launches_per_rhs")


def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_test_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _synthetic(device_ms=(80.0, 12.5, 90.0)):
    """Two solves: one right-hand side in 100 ms (cycles 80 + 12.5 ms, 1600
    launches), then a block of 8 in 200 ms (one cycle of 90 ms, 400
    launches)."""
    tracing.reset()
    rows = tracing.rows()
    ms = iter(device_ms)

    def add(name, parent, solve, start, end, **attrs):
        rows.append(dict(name=name, start_ns=int(start * 1e6),
                         end_ns=int(end * 1e6), parent=parent, solve=solve,
                         attrs=attrs))

    add("gmres.solve", None, 0, 0, 100, p=1, storage="frsz2_32",
        launches=1600)
    for k in range(2):
        d = next(ms)
        add("gmres.replay", 0, 0, 1 + 50 * k, 45 + 50 * k, steps_run=100,
            **({} if d is None else dict(device_ms=d)))
    add("gmres.solve", None, 1, 200, 400, p=8, storage="frsz2_32",
        launches=400)
    d = next(ms)
    add("gmres.replay", 3, 1, 210, 300,
        **({} if d is None else dict(device_ms=d)))
    return [counts.Request(p=1, m=100, live=[100, 2], fired=[], iterations=[],
                           converged=[True]),
            counts.Request(p=8, m=100, live=[90], fired=[], iterations=[],
                           converged=[True] * 8)]


def test_readers_read_a_synthetic_run():
    run = types.SimpleNamespace(traced=_synthetic())
    got = {name: _reader(name)(run) for name in READERS}
    assert got["cycle_ms_per_rhs"] == pytest.approx((80 + 12.5 + 90) / 9)
    assert got["between_cycles_ms_per_rhs"] == pytest.approx(
        (300 - 182.5) / 9)
    assert got["launches_per_rhs"] == pytest.approx(2000 / 9)
    assert got["cycle_ms_per_rhs"] + got["between_cycles_ms_per_rhs"] == \
        pytest.approx(300 / 9)
    tracing.reset()


@pytest.mark.parametrize("case", ["fewer_requests", "other_p", "dropped",
                                  "no_rows"])
def test_readers_return_none_where_rows_do_not_match_the_run(case):
    traced = _synthetic()
    if case == "fewer_requests":
        traced = traced[:1]
    elif case == "other_p":
        traced[1].p = 4
    elif case == "dropped":
        tracing.COUNTERS["rows_dropped"] = 1
    else:
        tracing.reset()
    run = types.SimpleNamespace(traced=traced)
    assert all(_reader(name)(run) is None for name in READERS)
    tracing.reset()


def test_time_readers_need_every_replays_device_time():
    run = types.SimpleNamespace(traced=_synthetic((80.0, None, 90.0)))
    assert _reader("cycle_ms_per_rhs")(run) is None
    assert _reader("between_cycles_ms_per_rhs")(run) is None
    assert _reader("launches_per_rhs")(run) == pytest.approx(2000 / 9)
    tracing.reset()
