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
    for name in ("sharded:float64", "emul:sz_abs:1e-6"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TA.format_by_name(name)


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
def test_rows_dots_combine_match_reference(name, rng):
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
    """PyTorch's own f64 -> f16 rounds through f32 (twice); the port's store
    conversion equals numpy's single rounding on normals of every scale,
    f16 ties with a tail below f32's precision, overflow, underflow,
    subnormals, signed zeros, infinities and NaN."""
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
    got = TA.f64_to_f16(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int16), want.view(np.int16))
    assert np.isnan(TA.f64_to_f16(torch.tensor([np.nan])).numpy()).all()
    # the double rounding this replaces: some values land an ulp off
    plain = torch.from_numpy(x).to(torch.float16).numpy()
    assert (plain.view(np.int16) != want.view(np.int16)).sum() > 0


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
