"""The port's SZ/ZFP error emulators against the JAX package's.

Tolerances:
* names, ``bits_per_value``, ``nbytes``, registry resolution and malformed
  names: exact;
* ``sz_abs`` and ``zfp_fr`` roundtrips: bit-equal, including rows whose
  block maxima sit exactly on powers of two and a few ulps either side
  (the reference's ``ceil(log2(max))`` edge).  ``zfp_fr`` reproduces the
  reference backend's inexact ``exp2``/``log2`` through tables.  XLA's
  CPU ``exp`` differs from host to host, so every test here first hands
  the port tables probed from the installed JAX
  (``tests/_torch_jax_numerics.py``): the roundtrips then check the port's
  algorithm against the reference's, whatever the host, for block maxima
  in ``[2^-200, 2^200]``: the range tested;
* ``sz_pwrel``: the reference's ``exp`` on the CPU is not PyTorch's (about
  one value in seven differs by an ulp), so entries may differ by one ulp;
  an entry that lands on another quantization level (``log`` and the step
  rounding on opposite sides of a boundary) is counted and must be at most
  one in 10^4.  Subnormal inputs are apart: the reference's CPU backend
  flushes them to zero (a test states the difference);
* solves through an emulated basis: equal convergence and iterations,
  ``bytes_read`` equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accessor as JA
from repro.core import emulators as JE
from repro.solver import gmres as jgmres
from repro.sparse import make_problem as jmake
from repro.sparse import rhs_for as jrhs
from repro_torch.convert import csr_from_numpy
from repro_torch.core import accessor as TA
from repro_torch.core import emulators as TE
from repro_torch.solver import gmres, gmres_batched
from tests import _torch_jax_numerics as JN

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reference_tables(monkeypatch):
    """The ZFP emulator's ``exp2``/``log2`` tables as the installed JAX
    computes them on this host."""
    JN.install_zfp_tables(monkeypatch)

NAMES = ["sz_abs:1e-10", "sz_abs:1e-6", "sz_abs:3e-4", "sz_pwrel:1e-6",
         "sz_pwrel:1e-4", "sz_pwrel:0.01", "zfp_fr:32", "zfp_fr:16",
         "zfp_fr:8", "zfp_fr:20"]
EXACT = [nm for nm in NAMES if not nm.startswith("sz_pwrel")]


def _rows(seed, shape):
    """Krylov-like rows: unit-norm Gaussian vectors."""
    x = np.random.default_rng(seed).standard_normal(shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both(name, x):
    rj = np.asarray(JE.emulator_by_name(name).roundtrip(jnp.asarray(x)))
    rt = TE.emulator_by_name(name).roundtrip(
        torch.from_numpy(np.array(x))).numpy()
    return rj, rt


@pytest.mark.parametrize("name", NAMES)
def test_emulator_metadata_matches_reference(name):
    fj = JE.emulator_by_name(name)
    ft = TE.emulator_by_name(name)
    assert ft.name == fj.name
    assert ft.bits_per_value() == fj.bits_per_value()
    for m, n in ((1, 1), (41, 513), (101, 1259712)):
        assert ft.nbytes(m, n) == fj.nbytes(m, n)
    # the registry resolves "emul:<kind>:<arg>" to the same format
    gj = JA.format_by_name("emul:" + name)
    gt = TA.format_by_name("emul:" + name)
    assert gt == ft and gt.name == gj.name
    assert gt.nbytes(101, 8000) == gj.nbytes(101, 8000)


@pytest.mark.parametrize("name", ["emul:bogus:1", "emul:sz_abs:x",
                                  "emul:zfp_fr:1.5"])
def test_malformed_emulator_names_raise_alike(name):
    with pytest.raises(ValueError) as ej:
        JA.format_by_name(name)
    with pytest.raises(ValueError) as et:
        TA.format_by_name(name)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", EXACT)
@pytest.mark.parametrize("shape", [(12, 1001), (3, 4096), (77,), (2, 5, 6)])
def test_exact_roundtrips_bit_equal(name, shape):
    x = _rows(sum(shape), shape) * np.float64(10.0) ** np.random.default_rng(
        1).uniform(-8, 3, shape[:-1] + (1,))
    rj, rt = _both(name, x)
    assert rt.shape == rj.shape
    np.testing.assert_array_equal(rt.view(np.int64), rj.view(np.int64))


@pytest.mark.parametrize("rate", [32, 16, 8])
@pytest.mark.parametrize("ulps", [-3, -1, 0, 1, 2, 5])
def test_zfp_block_maxima_on_powers_of_two(rate, ulps):
    """Blocks whose lifted maximum is 2^k (times 1 + ulps·2^-52) for every
    k in [-200, 200]: the reference's log2 is inexact at some powers of
    two (ceil lands on k + 1), and the port's tables follow it."""
    ks = np.arange(-200, 201)
    t = np.zeros((ks.size, 4))
    t[:, 0] = np.ldexp(1.0 + ulps * 2.0 ** -52, ks)
    t[:, 1] = np.ldexp(-0.3, ks)
    t[:, 3] = np.ldexp(0.7, ks)
    x = np.asarray(JE._zfp_inv_lift(jnp.asarray(t)))
    # the lifted maxima really are those values
    assert np.array_equal(np.max(np.abs(np.asarray(JE._zfp_fwd_lift(
        jnp.asarray(x)))), -1), t[:, 0])
    name = f"zfp_fr:{rate}"
    rj, rt = _both(name, x.reshape(1, -1))
    np.testing.assert_array_equal(rt.view(np.int64), rj.view(np.int64))
    # and row by row (a 4-value row: one block)
    rj, rt = _both(name, x)
    np.testing.assert_array_equal(rt.view(np.int64), rj.view(np.int64))


def test_zfp_tables_follow_reference_exp2_and_log2():
    """The tables the roundtrips read, built from the installed JAX's
    primitives, against ``jnp.exp2`` and ``jnp.ceil(jnp.log2(x))`` near
    every power of two in range: the table's indexing, and the port's
    threshold search and ``_ceil_log2`` on the reference's ``log2``."""
    exp2, lo = TE._tables("cpu")
    assert exp2 is JN.zfp_tables()[0] and lo is JN.zfp_tables()[1]
    c = np.arange(-200, 201)
    np.testing.assert_array_equal(
        exp2[c + TE._EMAX].numpy().view(np.int64),
        np.asarray(jnp.exp2(jnp.asarray(c, jnp.float64))).view(np.int64))
    ks = np.arange(-200, 201)
    xs = np.concatenate([np.ldexp(1.0 + d * 2.0 ** -52, ks)
                         for d in range(-16, 17)]
                        + [np.ldexp(1.0 - d * 2.0 ** -53, ks)
                           for d in range(1, 17)])
    want = np.asarray(jnp.ceil(jnp.log2(jnp.asarray(xs)))).astype(np.int64)
    got = TE._ceil_log2(torch.from_numpy(xs), lo).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sz_pwrel:1e-6", "sz_pwrel:1e-4",
                                  "sz_pwrel:0.01"])
def test_pwrel_roundtrip_within_an_ulp(name):
    x = _rows(7, (20, 1001))
    x[0, :8] = [0.0, -0.0, 1e-300, -1e-300, 1.0, -1.0, 2.0 ** -20, 3e-17]
    rj, rt = _both(name, x)
    ulps = np.abs(rj.view(np.int64) - rt.view(np.int64))
    flips = int((ulps > 1).sum())
    assert flips <= x.size // 10_000, (flips, int((ulps == 1).sum()))
    # a flip lands on the next quantization level, nowhere else
    eb = float(name.split(":")[1])
    far = ulps > 1
    ratio = np.abs(rt[far] / rj[far])
    assert np.all(np.abs(np.log(ratio) / np.log1p(eb)) < 1.0 + 1e-6)
    # zeros stay zeros, signs are kept, the bound holds
    assert np.array_equal(rt == 0, x == 0)
    assert np.array_equal(np.signbit(rt[x != 0]), np.signbit(x[x != 0]))
    nz = np.abs(x) > 1e-300
    assert np.all(np.abs(rt[nz] - x[nz]) <= eb * np.abs(x[nz]) * (1 + 1e-9))


def test_pwrel_subnormal_input_kept_where_reference_flushes():
    """The reference's CPU backend flushes subnormals to zero, so its
    ``|x| > 0`` is false for them and it stores 0; the port (CPU and card
    alike) keeps the sign and stores the ``1e-300`` floor's level."""
    x = np.array([-1e-310, 5e-324, 1e-300])
    rj, rt = _both("sz_pwrel:1e-6", x)
    assert rj[0] == 0.0 and rj[1] == 0.0
    assert rt[0] < 0 < rt[1] and rt[0] == -rt[1] == -rt[2]
    assert abs(rt[2] - rj[2]) <= np.spacing(rj[2])


@pytest.mark.parametrize("name", EXACT + ["sz_pwrel:1e-6"])
def test_accessor_stores_the_roundtrip(name):
    """``write_row`` writes the roundtrip in place; reads, ``dots`` and
    ``combine`` agree with the reference accessor (1e-13 relative: the same
    f64 products summed in another order)."""
    m, n = 6, 1003
    V = _rows(3, (m, n))
    fj = JA.format_by_name("emul:" + name)
    ft = TA.format_by_name("emul:" + name)
    aj = JA.BasisAccessor(fmt=fj, m=m, n=n, arith_dtype=jnp.float64)
    at = TA.BasisAccessor(fmt=ft, m=m, n=n, arith_dtype=torch.float64,
                          device="cpu")
    sj, st = aj.empty(), at.empty()
    for j in range(m):
        sj = aj.write_row(sj, j, jnp.asarray(V[j]))
        at.write_row(st, j, torch.from_numpy(V[j]))
    assert st.dtype == torch.float64 and st.shape == (m, n)
    want = np.asarray(sj)
    if name.startswith("sz_pwrel"):
        assert np.max(np.abs(st.numpy() - want)) <= 1e-15
    else:
        np.testing.assert_array_equal(st.numpy(), want)
    np.testing.assert_array_equal(at.read_row(st, 2).numpy(), st[2].numpy())
    w = np.random.default_rng(4).standard_normal(n)
    np.testing.assert_allclose(
        at.dots(st, torch.from_numpy(w), rows=4).numpy(),
        np.asarray(aj.dots(sj, jnp.asarray(w), jnp.arange(m) < 4))[:4],
        rtol=1e-13, atol=1e-15)
    h = np.random.default_rng(5).standard_normal(m)
    np.testing.assert_allclose(
        at.combine(st, torch.from_numpy(h)).numpy(),
        np.asarray(aj.combine(sj, jnp.asarray(h))), rtol=1e-13, atol=1e-15)
    assert at.nbytes() == aj.nbytes()


SOLVES = ["emul:sz_abs:1e-10", "emul:sz_pwrel:1e-6", "emul:zfp_fr:32"]


def _problem(n=512):
    A, target = jmake("synth:atmosmod", n)
    b, _ = jrhs(A)
    At = csr_from_numpy(np.asarray(A.indptr), np.asarray(A.indices),
                        np.asarray(A.data), A.shape, device="cpu")
    return A, At, np.array(b), target


@pytest.mark.parametrize("name", SOLVES)
def test_emulated_solve_matches_reference(name):
    """``tests/test_solver.py::test_emulated_compressor_storage``'s solves
    through the port, on both drivers, against the JAX host driver."""
    A, At, b, target = _problem()
    rj = jgmres(A, jnp.asarray(b), storage=name, m=40, max_iters=4000,
                target_rrn=target, driver="host")
    assert bool(rj.converged)
    for driver in ("host", "device"):
        rt = gmres(At, torch.from_numpy(b), storage=name, m=40,
                   max_iters=4000, target_rrn=target, driver=driver)
        assert rt.converged
        assert rt.iterations == rj.iterations, (driver, rt.iterations,
                                                rj.iterations)
        assert rt.restarts == rj.restarts
        assert rt.bytes_read == float(rj.bytes_read)
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x),
                                   rtol=1e-9, atol=1e-12)


def test_emulated_block_solve_drivers_agree():
    """A block solve through an emulated basis: both drivers, same bits."""
    _, At, b, target = _problem(216)
    B = torch.stack([torch.from_numpy(b), 1.1 * torch.from_numpy(b)])
    kw = dict(storage="emul:zfp_fr:32", m=20, max_iters=2000,
              target_rrn=target, method="block")
    rd = gmres_batched(At, B, driver="device", **kw)
    rh = gmres_batched(At, B, driver="host", **kw)
    for a, c in zip(rd, rh):
        assert a.converged and a.iterations == c.iterations
        assert a.bytes_read == c.bytes_read
        assert torch.equal(a.x, c.x)
