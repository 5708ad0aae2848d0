"""The benchmark's byte counts against hand counts, and the split of a
solve's estimate history into its cycles."""
import numpy as np
import pytest
import torch

from bench import counts

N = 64


def test_row_bytes():
    assert counts.row_bytes("float64", N) == 8 * N
    assert counts.row_bytes("float32", N) == 4 * N
    # l = 32: 4 bytes a value, one int32 exponent a block of 32
    assert counts.row_bytes("frsz2_32", 100) == 400 + 4 * 4
    assert counts.row_bytes("frsz2_16", 64) == 128 + 2 * 4


def _toy(p=1):
    """Two cycles of m = 3: 3 live steps (MGS fired at steps 0 and 2),
    then 1 live step (not fired)."""
    return counts.Request(p=p, m=3, live=[3, 1], fired=[[1, 0, 1], [0]],
                          iterations=[4] * p, converged=[True] * p)


def test_basis_bytes_by_hand_native():
    R, v = 8 * N, 8 * N
    # cycle 1: steps 0, 1, 2 with 2, 1, 2 passes; update over 3 rows
    c1 = (2 * (2 * 1 * R + 2 * v) + 1 * (2 * 2 * R + 2 * v)
          + 2 * (2 * 3 * R + 2 * v) + (3 * R + v))
    c2 = (2 * 1 * R + 2 * v) + (1 * R + v)
    assert counts.basis_bytes(_toy(), N, "float64", block=False) == c1 + c2
    # writes: each cycle's first row and one row a live step
    assert counts.basis_bytes(_toy(), N, "float64", block=False,
                              writes=True) == c1 + c2 + 6 * (v + R)


def test_basis_bytes_by_hand_coded_block():
    p = 2
    R, v = p * counts.row_bytes("frsz2_32", N), p * 8 * N
    steps = [(0, 2), (1, 1), (2, 2), (0, 1)]      # (j, passes), 2 cycles
    total = sum(ps * (2 * (j + 1) * R + 2 * v) for j, ps in steps)
    total += 4 * (v + R)                          # rows written
    total += 4 * (R + v)                          # rows decoded for A
    total += 2 * (v + R)                          # first rows
    total += (3 * R + v) + (1 * R + v)            # updates
    assert counts.basis_bytes(_toy(p), N, "frsz2_32", block=True) == total


def test_spmv_and_vector_bytes_by_hand():
    nnz, v = 7 * N, 8 * N
    a = nnz * 12
    coded = counts.row_bytes("frsz2_32", N)
    assert counts.spmv_bytes(_toy(), N, nnz, "frsz2_32", block=False) == (
        4 * (a + coded + v) + 4 * (a + 2 * v))
    assert counts.spmv_bytes(_toy(2), N, nnz, "frsz2_32", block=True) == (
        4 * (a + 2 * (v + v)) + 4 * (a + 2 * 2 * v))
    passes = 2 + 1 + 2 + 1
    assert counts.vector_bytes(_toy(), N) == (
        passes * 4 * v + 4 * 3 * v + 2 * 11 * v)
    assert counts.live_work_bytes(_toy(), N, nnz, "float64", block=False) == (
        counts.basis_bytes(_toy(), N, "float64", block=False, writes=True)
        + counts.spmv_bytes(_toy(), N, nnz, "float64", block=False)
        + counts.vector_bytes(_toy(), N))


def test_hbm_rate_of_the_card():
    assert counts.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert counts.hbm_bytes_per_s("cpu") is None


@pytest.mark.parametrize("hist,m,want", [
    ([[1.0]] * 3 + [[0.5]] * 2, 3, [3, 2]),       # no hit: m, then the rest
    ([[1.0], [0.1], [1.0], [0.1]], 3, [2, 2]),    # hits end cycles
    ([[1.0, 0.1], [0.1, 0.1], [0.1, 1.0]], 5, [2, 1]),   # all columns
])
def test_live_steps(hist, m, want):
    assert counts.live_steps(hist, m, target=0.2) == want


@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_live_steps_of_a_real_two_cycle_solve(storage):
    """On the port's solve (CPU, m = 10, two or more cycles), the split of
    the history has one entry a cycle and sums to the iterations."""
    from repro_torch.solver import gmres
    from repro_torch.sparse import make_problem

    A, target = make_problem("synth:atmosmod", 512, device="cpu")
    b = A.matvec(torch.linspace(-1, 1, A.shape[0], dtype=torch.float64))
    res = gmres(A, b, storage=storage, m=10, target_rrn=target,
                max_iters=500)
    live = counts.live_steps(np.asarray(res.rrn_history)[:, None].tolist(),
                             10, target)
    assert res.converged and len(live) >= 2
    assert len(live) == res.fired.shape[0]
    assert sum(live) == res.iterations
