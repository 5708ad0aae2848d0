"""The port's block contractions and batched ELL against the JAX package's,
on the CPU.

On the CPU ``ops.block_dots``/``ops.block_combine`` run their plain versions
(``kernels/ref.py``: decode, then contract the live rows in the spec's value
dtype); the Hopper kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  The same block store
(written by the JAX package, bit-identical in the port) and the same numpy
inputs go to both packages.

Tolerances, relative to the largest |result|:

* f64 values: 1e-13 against the JAX Pallas kernels in interpret mode
  (``repro.kernels.ops.block_dots``/``block_combine``, Kahan-compensated f64
  tiles) and against the JAX jnp route (decode, ``einsum``): all three sum
  the same f64 products in different orders;
* f32 values: 1e-5 (f32 sums in different orders);
* the batched ELL against ``jax.vmap`` of the JAX ELL matvec: 1e-12 (f64),
  as the single-vector ELL tests: both sum each row in slot order;
* ``ref.fma_ref`` (the plain fused multiply-add behind the combine kernel's
  row-order sum): exactly the rounding of the exact ``a * b + c``.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro.core.accessor import BlockBasisAccessor as JBlockAcc
from repro.core.accessor import FrszFormat as JFrsz
from repro.core.accessor import StorageFormat as JStorageFormat
from repro.kernels import ops as jops
from repro.sparse.csr import ELL as JELL
from repro_torch.convert import store_from_numpy
from repro_torch.core import frsz2 as TF
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

_J = {torch.float64: jnp.float64, torch.float32: jnp.float32}
_NP = {torch.float64: np.float64, torch.float32: np.float32}
_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _jax_block_store(rng, dtype, m, p, n, bs=32, l=32):
    """A JAX FRSZ2 block store of m block rows written through the JAX
    accessor (segment padding and all), its format and accessor."""
    jfmt = JFrsz(spec=JF.FrszSpec(bs=bs, l=l, dtype=_J[dtype]))
    jacc = JBlockAcc(fmt=jfmt, m=m, p=p, n=n, arith_dtype=_J[dtype])
    store = jacc.empty()
    for i in range(m):
        W = rng.standard_normal((p, n))
        W /= np.linalg.norm(W, axis=1, keepdims=True)
        W[:, ::11] *= 2.0 ** rng.integers(-6, 6, size=W[:, ::11].shape)
        store = jacc.write_block(store, i, jnp.asarray(W.astype(_NP[dtype])))
    return jfmt, jacc, store


def _port_bc(store, jfmt, dtype):
    spec = TF.FrszSpec(bs=jfmt.spec.bs, l=jfmt.spec.l, dtype=dtype)
    st = store_from_numpy({"codes": np.asarray(store["codes"]),
                           "exps": np.asarray(store["exps"])}, spec,
                          device="cpu")
    nb, bs = st["codes"].shape[1:]
    return TF.BlockCompressed(codes=st["codes"], exps=st["exps"], n=nb * bs,
                              spec=spec)


CASES = [(1, 96, torch.float64), (3, 200, torch.float64),
         (4, 256, torch.float64), (4, 1000, torch.float64),
         (3, 200, torch.float32), (4, 256, torch.float32)]


@pytest.mark.parametrize("p,n,dtype", CASES,
                         ids=[f"p{p}-n{n}-{str(d)[6:]}" for p, n, d in CASES])
def test_plain_block_contractions_match_jax_kernels_and_jnp(p, n, dtype,
                                                            rng):
    m, rows = 6, 4                              # live rows < m
    jfmt, jacc, store = _jax_block_store(rng, dtype, m, p, n)
    n_seg = jacc.n_seg
    jbc = jfmt._as_bc(store, p * n_seg)
    bc = _port_bc(store, jfmt, dtype)
    W = rng.standard_normal((p, n)).astype(_NP[dtype])
    Y = rng.standard_normal((m, p, p)).astype(_NP[dtype])
    Y[rows:] = 0.0                              # the JAX routes mask rows
    tol = _TOL[dtype]

    H = ops.block_dots(bc, torch.from_numpy(W), p=p, rows=rows)
    assert H.shape == (rows, p, p) and H.dtype == dtype
    jk = jops.block_dots(jbc, jnp.asarray(W), p=p, interpret=True)
    jj = JStorageFormat.block_dots(jfmt, store, jnp.asarray(W), _J[dtype], n,
                                   p, n_seg)
    _close(H, np.asarray(jk)[:rows], tol)
    _close(H, np.asarray(jj)[:rows], tol)

    out = ops.block_combine(bc, torch.from_numpy(Y[:rows]), p=p)
    assert out.shape == (p, n_seg) and out.dtype == dtype
    jk = jops.block_combine(jbc, jnp.asarray(Y), p=p, interpret=True)
    jj = JStorageFormat.block_combine(jfmt, store, jnp.asarray(Y), _J[dtype],
                                      n, p, n_seg)
    _close(out, jk, tol)
    _close(out, jj, tol)
    # the segment padding decodes to exact zeros
    assert not out.view(p, n_seg)[:, n:].any()


@pytest.mark.parametrize("bs,l", [(8, 32), (64, 16), (128, 8)])
def test_plain_block_contractions_other_specs(bs, l, rng):
    p, n, m = 3, 300, 5
    jfmt, jacc, store = _jax_block_store(rng, torch.float64, m, p, n, bs, l)
    jbc = jfmt._as_bc(store, p * jacc.n_seg)
    bc = _port_bc(store, jfmt, torch.float64)
    W = rng.standard_normal((p, n))
    Y = rng.standard_normal((m, p, p))
    _close(ops.block_dots(bc, torch.from_numpy(W), p=p, rows=m),
           jops.block_dots(jbc, jnp.asarray(W), p=p, interpret=True), 1e-13)
    _close(ops.block_combine(bc, torch.from_numpy(Y), p=p),
           jops.block_combine(jbc, jnp.asarray(Y), p=p, interpret=True),
           1e-13)


def test_block_wrappers_route_by_device():
    spec = TF.FrszSpec(bs=32, l=32, dtype=torch.float64)
    x = torch.randn((2 * 3, 128), dtype=torch.float64)
    b0 = ops.compress(x, spec)
    bc = TF.BlockCompressed(codes=b0.codes.reshape(2, 12, 32),
                            exps=b0.exps.reshape(2, 12), n=384, spec=spec)
    W = torch.randn((3, 100), dtype=torch.float64)
    Y = torch.randn((2, 3, 3), dtype=torch.float64)
    ops.reset_launches()
    a = ops.block_dots(bc, W, p=3, rows=2)
    b = ops.block_dots(bc, W, p=3, rows=2, kernel=False)
    assert torch.equal(a, b)
    assert torch.equal(ops.block_combine(bc, Y, p=3),
                       ops.block_combine(bc, Y, p=3, kernel=False))
    assert sum(ops.LAUNCHES.values()) == 0     # the CPU launches no kernel
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.block_dots(bc, W, p=3, rows=2, kernel=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.block_combine(bc, Y, p=3, kernel=True)
    with pytest.raises(ValueError, match="segments"):
        ops.block_dots(bc, W, p=5, rows=2)
    with pytest.raises(ValueError, match="rows"):
        ops.block_dots(bc, W, p=3, rows=3)
    # a spec outside the kernel contract decodes with the plain codec
    s21 = TF.FrszSpec(bs=32, l=21, dtype=torch.float64)
    c21 = TF.compress(x.reshape(2, 384), s21)
    y21 = ops.block_dots(c21, W, p=3, rows=2)
    V = TF.decompress(c21).reshape(2, 3, 128)[..., :100]
    torch.testing.assert_close(y21, torch.einsum("ian,bn->iab", V, W),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)], ids=str)
def test_batched_ell_matches_jax_vmap(dtype, tol, rng):
    nr, nc, w, q = 257, 300, 7, 5
    cols = rng.integers(0, nc, (nr, w)).astype(np.int32)
    vals = rng.standard_normal((nr, w)).astype(_NP[dtype])
    pad = rng.random((nr, w)) < 0.25
    cols[pad] = 0
    vals[pad] = 0.0
    X = rng.standard_normal((q, nc)).astype(_NP[dtype])
    E = JELL(jnp.asarray(cols), jnp.asarray(vals), (nr, nc))
    want = jax.vmap(E.matvec)(jnp.asarray(X))
    got = ops.ell_spmv(torch.from_numpy(vals), torch.from_numpy(cols),
                       torch.from_numpy(X))
    assert got.shape == (q, nr)
    _close(got, want, tol)
    # each column is the single-vector product
    for b in range(q):
        assert torch.equal(got[b], ops.ell_spmv(torch.from_numpy(vals),
                                                torch.from_numpy(cols),
                                                torch.from_numpy(X[b])))


def _round_exact(fr: Fraction, bits: int) -> float:
    """The exact rational ``fr`` rounded to ``bits`` significant bits, to
    nearest even (normal range)."""
    if fr == 0:
        return 0.0
    sign, fr = (-1 if fr < 0 else 1), abs(fr)
    e = fr.numerator.bit_length() - fr.denominator.bit_length()
    while Fraction(2) ** e > fr:
        e -= 1
    while Fraction(2) ** (e + 1) <= fr:
        e += 1
    ulp = Fraction(2) ** (e - bits + 1)
    scaled = fr / ulp
    q = scaled.numerator // scaled.denominator
    rem = scaled - q
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and q % 2):
        q += 1
    return sign * float(q * ulp)


@pytest.mark.parametrize("dtype,bits", [(torch.float64, 53),
                                        (torch.float32, 24)], ids=str)
def test_fma_ref_rounds_once(dtype, bits, rng):
    """a * b + c rounded once, on products of every scale, sums that
    cancel to a few bits, exact cancellation and zero addends (a plain
    multiply then add differs on thousands of these)."""
    n = 4000
    a = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    b = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    c = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    k = n // 4
    c[:k] = -(a[:k] * b[:k]) * (1 + rng.standard_normal(k)
                                * np.exp2(-rng.integers(1, bits + 8, k)))
    c[k:k + 50] = -(a[k:k + 50] * b[k:k + 50])
    c[k + 50:k + 100] = 0.0
    a, b, c = (v.astype(_NP[dtype]) for v in (a, b, c))
    got = ref.fma_ref(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_exact(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)), bits)
                     for x, y, z in zip(a, b, c)], _NP[dtype])
    assert np.array_equal(got, want)
    assert (a * b + c != want).sum() > 100       # the test has teeth


@pytest.mark.parametrize("p,n,dtype", CASES[:3] + CASES[4:5],
                         ids=[f"p{p}-n{n}-{str(d)[6:]}"
                              for p, n, d in CASES[:3] + CASES[4:5]])
def test_block_combine_rows_ref_matches_jax(p, n, dtype, rng):
    """The row-order plain combine (the kernel's bits) is the same function
    as the JAX Pallas block combine, to the same tolerance as the plain
    matrix-product version."""
    m = 5
    jfmt, jacc, store = _jax_block_store(rng, dtype, m, p, n)
    bc = _port_bc(store, jfmt, dtype)
    jbc = JF.BlockCompressed(codes=store["codes"], exps=store["exps"],
                             n=jacc.n_flat, spec=jfmt.spec)
    Y = rng.standard_normal((m, p, p)).astype(_NP[dtype])
    codes, exps, _ = ops._block_view(bc, p, m)
    got = ref.block_combine_rows_ref(codes, exps,
                                     torch.from_numpy(Y).reshape(m * p, p),
                                     bc.spec)
    _close(got, jops.block_combine(jbc, jnp.asarray(Y), p=p, interpret=True),
           _TOL[dtype])
    _close(got, ops.block_combine(bc, torch.from_numpy(Y), p=p), _TOL[dtype])
