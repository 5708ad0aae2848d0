"""``bench/metrics/steps_run_per_rhs.py`` on hand-made tracer rows, on the
CPU: the steps the traced requests' cycles ran, a right-hand side, and
``None`` wherever the rows do not hold one root ``gmres.solve`` a traced
request."""
import importlib.util
import pathlib
import types

import pytest

from repro_torch import tracing

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _read():
    path = ROOT / "bench" / "metrics" / "steps_run_per_rhs.py"
    spec = importlib.util.spec_from_file_location("bench_steps_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rows(steps=((91, 100), (200,))):
    """One solve a tuple of ``steps``: the first of one right-hand side
    (its replays' ``steps_run``), the second a block of 8; the traced
    requests as the harness keeps them (``p`` each)."""
    tracing.reset()
    rows = tracing.rows()
    ps = (1, 8)
    t = 0
    for solve, (p, replays) in enumerate(zip(ps, steps)):
        root = len(rows)
        rows.append(dict(name="gmres.solve", start_ns=t, end_ns=t + 100,
                         parent=None, solve=solve,
                         attrs=dict(p=p, storage="frsz2_32", launches=1)))
        for k, n in enumerate(replays):
            attrs = {} if n is None else dict(steps_run=n,
                                              steps_skipped=100 - n)
            rows.append(dict(name="gmres.replay", start_ns=t + 10 * k + 1,
                             end_ns=t + 10 * k + 9, parent=root, solve=solve,
                             attrs=attrs))
        t += 200
    return [types.SimpleNamespace(p=p) for p in ps]


def test_steps_run_a_right_hand_side():
    run = types.SimpleNamespace(traced=_rows())
    assert _read()(run) == pytest.approx((91 + 100 + 200) / 9)
    tracing.reset()


def test_a_replay_without_steps_run_reads_none():
    run = types.SimpleNamespace(traced=_rows(((91, None), (200,))))
    assert _read()(run) is None
    tracing.reset()


@pytest.mark.parametrize("case", ["fewer_requests", "other_p", "dropped",
                                  "no_rows", "untraced"])
def test_none_where_the_rows_do_not_match_the_run(case):
    traced = _rows()
    if case == "fewer_requests":
        traced = traced[:1]
    elif case == "other_p":
        traced[1].p = 4
    elif case == "dropped":
        tracing.COUNTERS["rows_dropped"] = 1
    elif case == "no_rows":
        tracing.reset()
    else:
        traced = []
    assert _read()(types.SimpleNamespace(traced=traced)) is None
    tracing.reset()
