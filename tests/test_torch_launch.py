"""``python -m repro_torch.launch.solve`` runs and writes the JAX CLI's rows.

Tolerance: the row keys must be exactly those of ``repro.launch.solve``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import solve as jsolve
from repro_torch.launch import solve as tsolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_runs_on_cpu_with_reference_row_keys(tmp_path):
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
         "--n", "512", "--m", "20", "--formats", "float64,frsz2_32",
         "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(out.read_text())
    ref = jsolve.solve_suite("synth:atmosmod", 64, ["float64"], m=10,
                             driver="host", verbose=False)
    assert [r["format"] for r in rows] == ["float64", "frsz2_32"]
    for r in rows:
        assert list(r) == list(ref[0])
        assert r["converged"] and r["driver"] == "device" and r["n"] == 512
        assert r["bytes_read"] > 0 and r["x_err"] < 1e-8


def test_cli_block_batch_on_cpu(tmp_path):
    """``--batch 4 --method block``: one row per format with the JAX CLI's
    keys, the summed iterations and bytes of the four right-hand sides."""
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu",
         "--n", "512", "--m", "20", "--formats", "frsz2_32", "--batch", "4",
         "--method", "block", "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(out.read_text())
    ref = jsolve.solve_suite("synth:atmosmod", 64, ["float64"], m=10,
                             batch=2, method="block", verbose=False)
    assert len(rows) == 1 and list(rows[0]) == list(ref[0])
    r = rows[0]
    assert (r["batch"], r["method"], r["format"]) == (4, "block", "frsz2_32")
    assert r["converged"] and r["x_err"] < 1e-8 and r["iters"] > 0
    assert r["wall_per_solve_s"] == r["wall_s"] / 4


def test_cli_defaults_to_cuda_and_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsolve.main(["--n", "64", "--formats", "float64"])
