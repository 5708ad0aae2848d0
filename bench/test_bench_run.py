"""The harness end to end on the CPU at a tiny size, and its contract:
names, files, the result line, the exits without a card and without the
program, and that nothing of JAX or the JAX package is loaded."""
import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: the cells at a size the CPU runs in seconds
TINY = {
    "atmosmodd": {"operator_args": {"grid": [6, 6, 14],
                                    "wind": [0.4, 0.2, 0.1], "diff": 1.0},
                  "m": 10},
}


def _spec():
    return json.loads(BENCH.read_text())


def _cpu_run(workload, seed, trace, cwd=ROOT, env=None):
    cell = next(w for w in _spec()["workloads"] if w["name"] == workload)
    code = ("import sys; sys.path[:0] = ['src', '.']; "
            "from bench import run as R; "
            f"sys.exit(R.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '1.0', '--trace', '{trace}'], "
            f"device='cpu', overrides={TINY[cell['config']]!r}))")
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_benchmark_json_follows_the_contract():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and len(c["source"]) <= 200
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert any(c["name"] == w["config"] for c in b["configs"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("workload", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(workload):
    sys.path.insert(0, str(ROOT))
    from bench import run as R

    e2e = [m["name"] for m in R.cell_metrics(_spec(), workload, False)]
    layers = R.cell_metrics(_spec(), workload, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers


@pytest.mark.parametrize("workload,trace", [
    ("atmosmodd.frsz2_32", 0), ("atmosmodd.float64", 1)])
def test_a_tiny_cpu_run_prints_one_well_formed_last_line(workload, trace):
    """The run exits 0, which it does only when no module of JAX or the
    JAX package is loaded in its process once the window has closed."""
    out = _cpu_run(workload, 2 ** 31 + 12345, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {"ms_per_rhs", "solve_p95_ms", "setup_s"} if not trace else {
        "iters_per_rhs", "live_step_share", "mgs_fired_share"}
    assert want <= set(line["metrics"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_a_card_the_run_prints_no_result():
    """No card is visible to the run, also on a machine that has one."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "atmosmodd.frsz2_32",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


def test_without_the_program_the_run_prints_no_result(tmp_path):
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cpu_run("atmosmodd.frsz2_32", 5, 0, cwd=tmp_path, env=env)
    assert out.returncode != 0 and not out.stdout.strip()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", ["reference", "operators", "counts"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    tops = {n.split(".")[0] for n in _imports(ROOT / "bench"
                                              / f"{module}.py")}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         f"import bench.{module}; print(sorted(sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    loaded = {k.split(".")[0] for k in eval(out.stdout)}
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, path
