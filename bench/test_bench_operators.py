"""The frozen generators build the port's operators bit for bit."""
import numpy as np
import pytest

from bench import operators
from repro_torch.sparse import problems


def _arrays(A):
    return tuple(t.numpy() for t in (A.indptr, A.indices, A.data))


@pytest.mark.parametrize("n", [64, 512, 1000, 4913])
def test_stencil7_equals_the_ports_atmosmod(n):
    A = problems._problem_atmosmod(n)
    got = operators.generate(dict(operator="stencil7", operator_args=dict(
        grid=list(A.grid), wind=[0.4, 0.2, 0.1], diff=1.0)))
    for g, w in zip(got, _arrays(A)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("grid", [(3, 4, 5), (4, 4, 13), (7, 2, 3)])
def test_stencil7_equals_the_ports_stencil_on_any_grid(grid):
    """A grid that is no cube, as the configuration's, numbered alike."""
    from repro_torch.sparse.csr import csr_from_coo

    rows, cols, vals, n = problems._stencil3d(*grid)
    A = csr_from_coo(rows, cols, vals, (n, n))
    got = operators.generate(dict(operator="stencil7", operator_args=dict(
        grid=list(grid), wind=[0.4, 0.2, 0.1], diff=1.0)))
    for g, w in zip(got, _arrays(A)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_the_configurations_are_the_ports_problems_at_full_size():
    """The port's stencil (held equal above on any grid) at the source's
    row count, with the port's target for it."""
    import json
    import pathlib

    root = pathlib.Path(__file__).resolve().parent / "configs"
    atm = json.loads((root / "atmosmodd.json").read_text())
    nx, ny, nz = atm["operator_args"]["grid"]
    assert atm["rows"] == nx * ny * nz == 1270432      # SuiteSparse's n
    assert atm["reduced"] == []
    assert atm["target_rrn"] == problems.PROBLEMS["synth:atmosmod"][1]
    indptr, _, _ = operators.generate(dict(
        operator="stencil7", operator_args=dict(grid=[nx, ny, 4])))
    # 7 a row less the missing neighbours of the faces, per plane of nz
    assert indptr[-1] == 7 * nx * ny * 4 - 2 * (ny * 4 + nx * 4 + nx * ny)


def test_load_builds_once_then_reads_back(tmp_path, monkeypatch):
    monkeypatch.setattr(operators, "CACHE", tmp_path)
    cfg = dict(operator="stencil7", operator_args=dict(grid=[5, 6, 7]))
    first = operators.load(cfg)
    calls = []
    monkeypatch.setattr(operators, "generate",
                        lambda c: calls.append(c) or first)
    again = operators.load(cfg)
    assert not calls
    for a, b in zip(first, again):
        assert a.dtype == b.dtype and np.array_equal(a, b)
