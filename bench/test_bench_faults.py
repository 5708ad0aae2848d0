"""``correct`` comes out false when the timed path is broken underneath:
the control (the plain reference in float32 in the program's place) and
each fault a cell can have, planted in a whole run of the harness (its
look for a card skipped) at a tiny size on the CPU; and true when nothing
is broken."""
import pytest

from bench import control
from bench import run as R
from bench.test_bench_run import TINY

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny block solve makes many small ops,
    which the thread pool slows by orders of magnitude on shared cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(workload, fault=None):
    cell = next(w for w in R.spec()["workloads"] if w["name"] == workload)
    config = {**R._json(R.BENCH / "configs" / f"{cell['config']}.json"),
              **TINY[cell["config"]]}
    if fault is None:
        line, _, _ = R.run(workload, SEED, 0.2, False, device="cpu",
                           overrides=TINY[cell["config"]])
        return line
    with control.patched(fault, config):
        line, _, _ = R.run(workload, SEED, 0.2, False, device="cpu",
                           overrides=TINY[cell["config"]])
    return line


@pytest.mark.parametrize("workload", [
    "atmosmodd.frsz2_32", "atmosmodd.float64", "atmosmodd.block8.frsz2_32"])
def test_sound_runs_are_correct(workload):
    line = _run(workload)
    assert line["correct"] is True
    assert line["checks"]["rrn_ratio"]["value"] <= 1.0


@pytest.mark.parametrize("workload,fault", [
    ("atmosmodd.frsz2_32", "control"),
    ("atmosmodd.frsz2_32", "unchanged"),
    ("atmosmodd.frsz2_32", "altered"),
    ("atmosmodd.float64", "control"),
    ("atmosmodd.float64", "unchanged"),
    ("atmosmodd.float64", "altered"),
    ("atmosmodd.block8.frsz2_32", "half"),
    ("atmosmodd.block8.frsz2_32", "altered"),
])
def test_the_control_and_each_fault_fail(workload, fault):
    line = _run(workload, fault)
    assert line["correct"] is False
    assert not line["checks"]["rrn_ratio"]["value"] <= 1.0
