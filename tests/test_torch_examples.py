"""The port's examples and the paper's grid against the JAX package.

* ``repro_torch.examples.quickstart`` prints the JAX ``examples/quickstart.py``'s
  lines, every one equal (the reference runs in a subprocess, as a user
  runs it).
* ``repro_torch.examples.solve_cfd.pipeline_demo`` against the reference's
  ``pipeline_demo``: equal lines, iterations, restarts and ``bytes_read``.
* The paper's grid (every problem of ``PROBLEMS`` x float64, float32,
  float16, frsz2_32, frsz2_16 at n = 512, m = 50): the port's ``gmres`` (the
  device driver, as a user calls it) against the JAX package's host driver
  on the same operator and right-hand side: equal converged and stagnated
  flags, iterations, restarts and ``bytes_read``.

Final RRNs agree within 1e-6 relative above an absolute floor of 1e-14, as
in ``tests/test_torch_solver.py``: a converged RRN sits near the f64
rounding of forming ``b - A x`` (observed up to 6.5e-16 apart, 1e-2 of an
RRN of 6e-14, with equal iterations).

``synth:varcoef`` (16-24 restarts of a row-scaled operator) is held to
iterations within 2 and restarts within 1 in the lossy formats: the two
packages sum the same products in another order, and the RRN histories,
equal to 1e-16 at the first steps, drift to a few percent of the restart
RRN by the last restart (float32: 806 / 17 in JAX, 804 / 17 in the port,
whose host and device drivers agree).  Its float64 solve agrees exactly.
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.solver
from repro.solver import gmres as jgmres
from repro.sparse import make_problem as jmake
from repro.sparse import rhs_for as jrhs
from repro_torch.convert import csr_from_numpy
from repro_torch.examples import quickstart, solve_cfd
from repro_torch.solver import gmres
from repro_torch.sparse.problems import PROBLEMS
from tests import _torch_jax_numerics as JN

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID_FORMATS = ("float64", "float32", "float16", "frsz2_32", "frsz2_16")
GRID_N = 512
#: iterations (and restarts, half of it) a problem's lossy formats may
#: drift from the reference's: see the module docstring
ITER_DRIFT = {"synth:varcoef": 2}


def _rrn_close(ours: float, theirs: float) -> None:
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-14)


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_reference_lines(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH")
                                          else [])))
    # the reference runs while the port runs here
    proc = subprocess.Popen([sys.executable, "examples/quickstart.py"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    quickstart.main(["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    theirs = out.splitlines()
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        assert a == b


def test_quickstart_functions_return_what_main_prints():
    lines = quickstart.codec_demo("cpu")
    assert lines == ["frsz2_16: 16.25 bits/value, max rel err 3.13e-05",
                     "frsz2_32(f64): 33 bits/value, max rel err 1.86e-09"]
    lines, results = quickstart.solve_demo("cpu", n=512)
    assert list(results) == list(quickstart.FORMATS) and len(lines) == 5
    for line, (fmt, res) in zip(lines[1:], results.items()):
        assert res.converged and res.x.device.type == "cpu"
        assert f"storage={fmt:9s} iterations={res.iterations:4d}" in line


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.codec_demo()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_cfd.pipeline_demo(64)


def test_pipeline_demo_matches_the_reference(capsys, monkeypatch):
    n = 512
    ref = _reference_example("solve_cfd")
    seen = []
    jax_gmres = repro.solver.gmres

    def recording(*a, **kw):
        res = jax_gmres(*a, **kw)
        seen.append(res)
        return res

    monkeypatch.setattr(repro.solver, "gmres", recording)
    ref.pipeline_demo(n)
    theirs = capsys.readouterr().out.splitlines()
    lines, ours = solve_cfd.pipeline_demo(n, "cpu")
    assert lines == theirs
    assert len(seen) == 4
    for res, (name, r) in zip(seen, ours.items()):
        assert r.converged == bool(res.converged), name
        assert r.iterations == int(res.iterations), name
        assert r.restarts == int(res.restarts), name
        assert r.bytes_read == float(res.bytes_read), name
        _rrn_close(r.rrn, float(res.rrn))
    assert ours["jacobi"].iterations < ours["identity"].iterations
    assert ours["adaptive"].bytes_read < ours["static"].bytes_read


@pytest.fixture(scope="module")
def grid_problems():
    out = {}
    for name in PROBLEMS:
        A, target = jmake(name, GRID_N)
        b, _ = jrhs(A)
        At = csr_from_numpy(np.asarray(A.indptr), np.asarray(A.indices),
                            np.asarray(A.data), A.shape, device="cpu")
        out[name] = (A, At, np.array(b), target)
    return out


@pytest.mark.parametrize("fmt", GRID_FORMATS)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_paper_grid_matches_jax(name, fmt, grid_problems, monkeypatch):
    # float16 rows are stored with the installed JAX's f64 -> f16 rounding
    # (once or through f32, by host: tests/_torch_jax_numerics.py)
    JN.install_f16_rounding(monkeypatch)
    A, At, b, target = grid_problems[name]
    kw = dict(storage=fmt, m=50, max_iters=6000, target_rrn=target)
    rj = jgmres(A, jnp.asarray(b), driver="host", **kw)
    rt = gmres(At, torch.from_numpy(b), **kw)
    assert rt.converged == bool(rj.converged)
    assert rt.stagnated == bool(rj.stagnated)
    if rt.converged:
        assert rt.rrn <= target
    drift = 0 if fmt == "float64" else ITER_DRIFT.get(name, 0)
    assert abs(rt.iterations - int(rj.iterations)) <= drift, (
        rt.iterations, int(rj.iterations))
    if rt.iterations != int(rj.iterations):
        assert abs(rt.restarts - int(rj.restarts)) <= drift // 2
        return
    assert rt.restarts == int(rj.restarts)
    assert rt.bytes_read == float(rj.bytes_read)
    _rrn_close(rt.rrn, float(rj.rrn))
