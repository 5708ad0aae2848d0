"""The port's storage formats and accessor against the JAX package's.

Tolerances:
* names, bits per value, eps, nbytes, malformed-name errors: exact;
* ``write_row``/``read_row`` round trips: bit-identical for FRSZ2 (the codec
  is integer arithmetic) and for native casts (one IEEE rounding);
* ``dots``/``combine`` against the JAX jnp route: 1e-13 relative — the same
  f64 products summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accessor as JA
from repro_torch.convert import store_to_numpy
from repro_torch.core import accessor as TA
from tests import _torch_jax_numerics as JN

torch.set_num_threads(2)

NAMES = ["float64", "float32", "float16", "bfloat16", "frsz2_8", "frsz2_16",
         "frsz2_21", "frsz2_32", "mixed", "mixed:3", "mixed:2:frsz2_16",
         "mixed:auto:frsz2_16", "mixed:0:frsz2_32"]
BAD = ["frsz2", "frsz2_x", "frsz2_1_2", "frsz2_65", "mixed:x", "float8",
       "nope"]


@pytest.mark.parametrize("name", NAMES)
def test_registry_resolves_like_reference(name):
    fj = JA.format_by_name(name, target_rrn=1e-10, m=40)
    ft = TA.format_by_name(name, target_rrn=1e-10, m=40)
    assert ft.name == fj.name
    assert ft.bits_per_value() == fj.bits_per_value()
    assert ft.eps() == fj.eps()
    for m, n in ((1, 1), (41, 513), (101, 1259712)):
        assert ft.nbytes(m, n) == fj.nbytes(m, n)
    assert TA.auto_mixed_head(2.0 ** -14, 1e-10, 40) == JA.auto_mixed_head(
        2.0 ** -14, 1e-10, 40)


@pytest.mark.parametrize("name", BAD)
def test_malformed_names_raise_alike(name):
    with pytest.raises(ValueError) as ej:
        JA.format_by_name(name)
    with pytest.raises(ValueError) as et:
        TA.format_by_name(name)
    assert str(et.value) == str(ej.value)


def test_unported_families_say_so():
    """Every family of the reference resolves in the port now (the name is
    older than slice 6): ``sharded:`` wraps its inner format with the
    reference's default, the coded transport, and refuses what the
    reference refuses with the same message."""
    for name in ("sharded:float64", "sharded:frsz2_32",
                 "sharded:mixed:2:frsz2_32"):
        ft, fj = TA.format_by_name(name), JA.format_by_name(name)
        assert isinstance(ft, TA.ShardedFormat)
        assert ft.name == fj.name and ft.compressed_transport
        assert ft.nbytes(101, 64) == fj.nbytes(101, 64)
        assert ft.bits_per_value() == fj.bits_per_value()
    for name in ("sharded:", "sharded:sharded:float64"):
        with pytest.raises(ValueError) as ej:
            JA.format_by_name(name)
        with pytest.raises(ValueError) as et:
            TA.format_by_name(name)
        assert str(et.value) == str(ej.value)


def _pair(name, m, n):
    fj = JA.format_by_name(name)
    ft = TA.format_by_name(name)
    return (JA.BasisAccessor(fmt=fj, m=m, n=n, arith_dtype=jnp.float64),
            TA.BasisAccessor(fmt=ft, m=m, n=n, arith_dtype=torch.float64,
                             device="cpu"))


def _store_np(fmt, store):
    """A port store as numpy, in the reference's layout."""
    if isinstance(fmt, TA.FrszFormat):
        return store_to_numpy(store, fmt.spec)
    if isinstance(fmt, TA.MixedFormat):
        return {"head": _store_np(fmt.head, store["head"]),
                "tail": _store_np(fmt.tail, store["tail"])}
    return store.float().numpy() if store.dtype == torch.bfloat16 \
        else store.numpy()


def _assert_tree_equal(got, ref):
    if isinstance(got, dict):
        assert set(got) == set(ref)
        for k in got:
            _assert_tree_equal(got[k], ref[k])
    else:
        ref = np.asarray(ref)
        if ref.dtype.name == "bfloat16":
            ref = ref.astype(np.float32)
        assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("name", ["float64", "float32", "float16", "bfloat16",
                                  "frsz2_32", "frsz2_16", "frsz2_21",
                                  "mixed:2:frsz2_32"])
def test_rows_dots_combine_match_reference(name, rng, monkeypatch):
    # float16 rows: the installed JAX's f64 -> f16 rounding, which differs
    # from the port's (the card's) on some values by host (see
    # ``_torch_jax_numerics.install_f16_rounding``)
    JN.install_f16_rounding(monkeypatch)
    m, n, live = 6, 333, 4
    aj, at = _pair(name, m, n)
    sj, st = aj.empty(), at.empty()
    V = rng.standard_normal((m, n)) * np.exp2(rng.integers(-6, 6, (m, n)))
    write, read = jax.jit(aj.write_row), jax.jit(aj.read_row)
    for j in range(m):
        sj = write(sj, jnp.asarray(j), jnp.asarray(V[j]))
        assert at.write_row(st, j, torch.from_numpy(V[j])) is None
    _assert_tree_equal(_store_np(at.fmt, st), sj)
    for j in range(m):
        assert np.array_equal(at.read_row(st, j).numpy(),
                              np.asarray(read(sj, jnp.asarray(j))))
    assert np.array_equal(at.read_all(st).numpy(), np.asarray(aj.read_all(sj)))
    w = rng.standard_normal(n)
    h = rng.standard_normal(m)
    mask = jnp.arange(m) < live
    dj = np.asarray(aj.dots(sj, jnp.asarray(w), mask))
    dt = at.dots(st, torch.from_numpy(w), live).numpy()
    assert dt.shape == (live,) and not dj[live:].any()
    np.testing.assert_allclose(dt, dj[:live], rtol=1e-13,
                               atol=1e-13 * np.abs(dj).max())
    cj = np.asarray(aj.combine(sj, jnp.asarray(h), mask))
    ct = at.combine(st, torch.from_numpy(h[:live])).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-13,
                               atol=1e-13 * np.abs(cj).max())
    assert at.nbytes() == aj.nbytes()


def test_f64_to_f16_rounds_once_like_numpy(rng):
    """The port's store conversion rounds f64 -> f32 -> f16, as the JAX
    reference does, on normals of every scale, f16 ties with a tail below
    f32's precision, overflow, underflow, subnormals, signed zeros,
    infinities and NaN: it equals numpy's two-step cast everywhere, and
    numpy's single rounding except where the dropped bits break an f16 tie
    (the name is older than the rule, which follows the reference)."""
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    x = np.concatenate([
        rng.standard_normal(200_000),
        rng.standard_normal(20_000) * 1e-5,
        rng.standard_normal(20_000) * 6e4,
        ties, ties + 2.0 ** -40, ties - 2.0 ** -40, -(ties + 2.0 ** -40),
        [0.0, -0.0, np.inf, -np.inf, 1e300, -1e300, 1e-300, 5e-324,
         65504.0, 65519.99, 65520.0, 2.0 ** -25, 2.0 ** -25 * 1.0000001,
         1.5 * 2.0 ** -24, 3 * 2.0 ** -26]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float32).astype(np.float16)
        once = x.astype(np.float16)
    got = TA.f64_to_f16(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int16), want.view(np.int16))
    assert np.isnan(TA.f64_to_f16(torch.tensor([np.nan])).numpy()).all()
    # the single rounding differs where the f32 step decides an f16 tie
    assert (got.view(np.int16) != once.view(np.int16)).sum() > 0


def test_f64_to_f16_once_equals_numpy(rng):
    """The single rounding (round to odd through f32, then to nearest) is
    numpy's ``astype(float16)`` bit for bit on the same values as above:
    normals of every scale, ties with a tail below f32's precision,
    overflow, underflow, subnormals, signed zeros, infinities and NaN."""
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    x = np.concatenate([
        rng.standard_normal(200_000),
        rng.standard_normal(20_000) * 1e-5,
        rng.standard_normal(20_000) * 6e4,
        ties, ties + 2.0 ** -40, ties - 2.0 ** -40, -(ties + 2.0 ** -40),
        [0.0, -0.0, np.inf, -np.inf, 1e300, -1e300, 1e-300, 5e-324,
         65504.0, 65519.99, 65520.0, 2.0 ** -25, 2.0 ** -25 * 1.0000001,
         1.5 * 2.0 ** -24, 3 * 2.0 ** -26]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float16)
    got = JN.f64_to_f16_once(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int16), want.view(np.int16))
    assert np.isnan(JN.f64_to_f16_once(torch.tensor([np.nan])).numpy()).all()


def test_f64_to_f16_bit_equal_to_the_installed_jax():
    """The installed JAX's f64 -> f16, ``jnp.asarray(x).astype(
    jnp.float16)``, bit for bit against one of the port's two roundings
    on 100,000 seeded normals and the f16 ties of [1, 2) with a tail of
    2^-40 either way (102,046 values, of which 1,028 round differently
    once than through f32).  XLA rounds once on a host with AVX-512 FP16
    conversions and through f32 elsewhere; the solves that store float16
    rows are run with the rounding found here
    (``tests/_torch_jax_numerics.py``).  A JAX that rounds some third way
    fails here by name, not as a drifting float16 solve."""
    x = JN.f16_probe()
    assert x.size == 102_046
    want = np.asarray(jnp.asarray(x).astype(jnp.float16))
    name = JN.jax_f16_rounding()
    got = JN.F16_ROUNDINGS[name](torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int16), want.view(np.int16))
    once = JN.f64_to_f16_once(torch.from_numpy(x)).numpy().view(np.int16)
    assert np.array_equal(once, x.astype(np.float16).view(np.int16))
    assert (once != TA.f64_to_f16(torch.from_numpy(x)).numpy().view(
        np.int16)).sum() == 1_028


def test_mixed_routes_head_and_tail_rows(rng):
    fmt = TA.format_by_name("mixed:2:frsz2_16")
    acc = TA.BasisAccessor(fmt=fmt, m=5, n=64, device="cpu")
    st = acc.empty()
    assert fmt.rows(st) == 5 and st["head"].shape == (2, 64)
    assert st["tail"]["codes"].shape[0] == 3
    V = torch.from_numpy(rng.standard_normal((5, 64)))
    for j in range(5):
        acc.write_row(st, j, V[j])
    # head rows are exact f64, tail rows carry the frsz2_16 codec error
    assert torch.equal(acc.read_row(st, 1), V[1])
    assert torch.equal(st["head"][1], V[1])
    tail = acc.read_row(st, 3)
    assert not torch.equal(tail, V[3])
    assert torch.allclose(tail, V[3], atol=2.0 ** -12 * float(V[3].abs().max()))
    # dots over 1 live row touch only the head; over 4, both parts
    w = torch.from_numpy(rng.standard_normal(64))
    assert acc.dots(st, w, 1).shape == (1,)
    full = acc.dots(st, w, 4)
    assert torch.equal(full[:2], st["head"] @ w)
    assert torch.equal(full[2:], fmt.tail.dots(st["tail"], w, torch.float64,
                                               64, 2))


@pytest.mark.parametrize("name", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("chunk_rows", [1, 3, 7, 50])
def test_native_dots_and_combine_in_row_chunks_match_jax(name, chunk_rows,
                                                         monkeypatch):
    """A native basis of another dtype than the arithmetic's converts its
    rows in chunks of a fixed size (so a captured cycle's allocations do not
    grow a row a step): its dots and combine at every chunk size against
    the JAX jnp route on the same stored rows, 1e-13 relative; no rows
    gives an empty ``h`` and a zero combine."""
    rng = np.random.default_rng(5)
    m, n = 9, 257
    monkeypatch.setattr(TA, "NATIVE_CHUNK_VALUES", chunk_rows * n)
    V = rng.standard_normal((m, n))
    w = rng.standard_normal(n)
    fj = JA.format_by_name(name)
    ft = TA.format_by_name(name)
    sj = fj.empty(m, n)
    st = ft.empty(m, n, "cpu")
    for j in range(m):
        sj = fj.write_row(sj, j, jnp.asarray(V[j]))
        ft.write_row(st, j, torch.from_numpy(V[j]))
    for rows in (1, 4, m):
        hj = np.asarray(fj.dots(sj[:rows], jnp.asarray(w), jnp.float64, n))
        ht = ft.dots(st, torch.from_numpy(w), torch.float64, n, rows).numpy()
        np.testing.assert_allclose(ht, hj, rtol=1e-13,
                                   atol=1e-13 * np.abs(hj).max())
        yj = np.asarray(fj.combine(sj[:rows], jnp.asarray(hj), jnp.float64,
                                   n))
        yt = ft.combine(st, torch.from_numpy(hj), torch.float64, n).numpy()
        np.testing.assert_allclose(yt, yj, rtol=1e-13,
                                   atol=1e-13 * np.abs(yj).max())
    assert ft.dots(st, torch.from_numpy(w), torch.float64, n, 0).shape == (0,)
    assert torch.equal(ft.combine(st, torch.zeros(0, dtype=torch.float64),
                                  torch.float64, n),
                       torch.zeros(n, dtype=torch.float64))
