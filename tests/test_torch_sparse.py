"""The port's sparse operators and problem suite against the JAX package's.

Tolerances:
* problem arrays: exact (``np.array_equal``) — both build them with numpy;
* ``diag``, ``nbytes``, ``fingerprint``, padded ELL view: exact;
* ``matvec``: 1e-14 relative — the same f64 products summed per row in
  another order (a row gather-sum here, an XLA ``segment_sum`` there);
* ``rhs_for``: 1e-15 relative — ``torch.sin`` and XLA's ``sin`` may differ
  by an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import problems as JP
from repro_torch.convert import csr_from_numpy, csr_to_numpy
from repro_torch.sparse import problems as TP
from repro_torch.sparse.csr import csr_from_coo

torch.set_num_threads(2)

SIZES = {"synth:unstructured": 512}


@pytest.mark.parametrize("name", sorted(JP.PROBLEMS))
def test_problem_matches_reference(name, rng):
    n = SIZES.get(name, 300)
    Aj, tj = JP.make_problem(name, n)
    At, tt = TP.make_problem(name, n, device="cpu")
    assert tt == tj and At.shape == Aj.shape
    ip, ix, d, shape = csr_to_numpy(At)
    assert np.array_equal(ip, np.asarray(Aj.indptr))
    assert np.array_equal(ix, np.asarray(Aj.indices))
    assert np.array_equal(d, np.asarray(Aj.data))
    assert getattr(At, "grid", None) == getattr(Aj, "grid", None)
    assert At.fingerprint() == Aj.fingerprint()
    assert At.nbytes() == Aj.nbytes()
    assert At.bandwidth() == Aj.bandwidth()
    assert np.array_equal(At.diag().numpy(), np.asarray(Aj.diag()))
    x = rng.standard_normal(At.shape[0])
    yj = np.asarray(Aj.matvec(jnp.asarray(x)))
    yt = At.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-14,
                               atol=1e-14 * np.abs(yj).max())
    bj, xj = JP.rhs_for(Aj)
    bt, xt = TP.rhs_for(At, device="cpu")
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-15,
                               atol=1e-15)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-14,
                               atol=1e-14 * np.abs(np.asarray(bj)).max())


def test_ell_and_dense_views_match(rng):
    Aj, _ = JP.make_problem("synth:lung", 200)
    At = csr_from_numpy(np.asarray(Aj.indptr), np.asarray(Aj.indices),
                        np.asarray(Aj.data), Aj.shape, device="cpu")
    Ej, Et = Aj.to_ell(), At.to_ell()
    assert np.array_equal(Et.cols.numpy(), np.asarray(Ej.cols))
    assert np.array_equal(Et.vals.numpy(), np.asarray(Ej.vals))
    assert Et.nbytes() == Ej.nbytes()
    assert np.array_equal(Et.diag().numpy(), np.asarray(Ej.diag()))
    x = rng.standard_normal(200)
    np.testing.assert_allclose(
        Et.matvec(torch.from_numpy(x)).numpy(),
        np.asarray(Ej.matvec(jnp.asarray(x), kernel=False)), rtol=1e-14)
    assert np.array_equal(At.to_dense().numpy(), np.asarray(Aj.to_dense()))
    assert np.array_equal(At.row_ids().numpy(), np.asarray(Aj.row_ids()))


def test_csr_from_coo_unsorted_and_empty_rows():
    rows = np.array([3, 0, 3, 1])
    cols = np.array([1, 2, 0, 1])
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    from repro.sparse.csr import csr_from_coo as jcoo

    Aj = jcoo(rows, cols, vals, (5, 5))
    At = csr_from_coo(rows, cols, vals, (5, 5))
    for a, b in zip(csr_to_numpy(At)[:3], (Aj.indptr, Aj.indices, Aj.data)):
        assert np.array_equal(a, np.asarray(b))
    x = torch.arange(5, dtype=torch.float64)
    assert torch.equal(At.matvec(x), torch.tensor([4.0, 4.0, 0.0, 1.0, 0.0],
                                                  dtype=torch.float64))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.make_problem("synth:atmosmod", 64)
    A, _ = TP.make_problem("synth:atmosmod", 64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.rhs_for(A)
    with pytest.raises(ValueError, match="available problems"):
        TP.make_problem("synth:nope", 64, device="cpu")
