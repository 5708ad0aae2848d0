"""The port's FRSZ2 codec against the JAX package's, bit for bit.

Tolerance: none.  Codes, exponents and decompressed values must be
bit-identical: the codec is integer arithmetic on IEEE fields, so any
difference is a bug.  Inputs are made with numpy from a seed, converted to
the value dtype once (by JAX), and handed to both packages as the same bit
patterns.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro_torch.convert import store_to_numpy
from repro_torch.core import frsz2 as TF

torch.set_num_threads(2)

_DT = {  # name -> (jax dtype, torch dtype, unsigned view, subnormal sample)
    "float64": (jnp.float64, torch.float64, np.uint64, 1e-310),
    "float32": (jnp.float32, torch.float32, np.uint32, 1e-40),
    "float16": (jnp.float16, torch.float16, np.uint16, 1e-6),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, 1e-40),
}
_TORCH_INT = {np.uint64: torch.int64, np.uint32: torch.int32,
              np.uint16: torch.int16}
_NP_INT = {np.uint64: np.int64, np.uint32: np.int32, np.uint16: np.int16}

_BS = (1, 8, 32, 128)
# every (l, bs) pair for the solver's f64 values; for the other value types
# each code length meets two block sizes and each block size two lengths
CODEC_CASES = (
    [("float64", l, bs) for l in (8, 16, 21, 32, 64) for bs in _BS]
    + [("float32", l, _BS[(i + k) % 4]) for i, l in enumerate((8, 16, 21, 32))
       for k in (0, 2)]
    + [(d, l, _BS[(i + k + j) % 4]) for j, d in enumerate(("float16",
                                                           "bfloat16"))
       for i, l in enumerate((8, 16)) for k in (0, 2)]
)
CASES = sorted({(d, l) for d, l, _ in CODEC_CASES})


def _inputs(dtype_name, seed=0, shape=(3, 517)):
    """Odd n, zeros, signs, subnormals and in-block exponent spreads wider
    than any code field, as the same bits for both packages."""
    jdt, tdt, udt, sub = _DT[dtype_name]
    rng = np.random.default_rng(seed)
    span = 60 if dtype_name in ("float64", "float32", "bfloat16") else 12
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-span, span, shape))
    x[0, ::5] = 0.0
    x[1, ::7] = sub * rng.choice([-1.0, 1.0], x[1, ::7].shape)
    x[2, :40] = -np.abs(x[2, :40])
    xj = jnp.asarray(x, jdt)
    bits = np.asarray(jax.lax.bitcast_convert_type(xj, jnp.dtype(udt)))
    xt = torch.from_numpy(bits.view(_NP_INT[udt]).copy()).view(tdt)
    return xj, xt, udt


def _ubits(t: torch.Tensor, udt):
    return t.contiguous().view(_TORCH_INT[udt]).numpy().view(udt)


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
@pytest.mark.parametrize("dtype_name,l,bs", CODEC_CASES, ids=lambda v: str(v))
def test_codec_bit_identical(dtype_name, l, bs, rounding):
    jdt, tdt, udt, _ = _DT[dtype_name]
    xj, xt, udt = _inputs(dtype_name, seed=l * 131 + bs)
    js = JF.FrszSpec(bs=bs, l=l, dtype=jdt, rounding=rounding)
    ts = TF.FrszSpec(bs=bs, l=l, dtype=tdt, rounding=rounding)
    jb = jax.jit(JF.compress, static_argnums=1)(xj, js)
    tb = TF.compress(xt, ts)
    got = store_to_numpy({"codes": tb.codes, "exps": tb.exps}, ts)
    assert got["codes"].dtype == np.asarray(jb.codes).dtype
    assert np.array_equal(got["codes"], np.asarray(jb.codes))
    assert np.array_equal(got["exps"], np.asarray(jb.exps))
    yj = np.asarray(jax.lax.bitcast_convert_type(jax.jit(JF.decompress)(jb),
                                                 jnp.dtype(udt)))
    yt = _ubits(TF.decompress(tb), udt)
    assert yt.shape == yj.shape == xj.shape
    assert np.array_equal(yt, yj)


@pytest.mark.parametrize("dtype_name,l", CASES, ids=lambda v: str(v))
def test_storage_accounting_equal(dtype_name, l):
    jdt, tdt, _, _ = _DT[dtype_name]
    for bs in (1, 8, 32, 128, 256):
        js = JF.FrszSpec(bs=bs, l=l, dtype=jdt)
        ts = TF.FrszSpec(bs=bs, l=l, dtype=tdt)
        assert ts.aligned == js.aligned
        assert ts.words_per_block == js.words_per_block
        assert ts.name == js.name
        assert TF.bits_per_value(ts) == JF.bits_per_value(js)
        for n in (1, 31, 517, 1259712):
            assert TF.storage_nbytes(n, ts) == JF.storage_nbytes(n, js)


def test_spec_validation_matches():
    for kw in (dict(l=2), dict(l=40), dict(l=33), dict(bs=0),
               dict(rounding="up")):
        with pytest.raises(ValueError):
            JF.FrszSpec(**kw)
        with pytest.raises(ValueError):
            TF.FrszSpec(**kw)
    with pytest.raises(ValueError):
        TF.FrszSpec(l=32, dtype=torch.float16)


@pytest.mark.parametrize("dtype_name,l,bs", [("float32", 16, 128),
                                             ("float32", 8, 64),
                                             ("float32", 21, 32),
                                             ("bfloat16", 8, 32),
                                             ("float16", 16, 8)],
                         ids=lambda v: str(v))
def test_uint8_exponent_spec_bit_identical(dtype_name, l, bs):
    """``exp_dtype=uint8`` (the KV cache's spec): codes, exponents (uint8 on
    both sides) and decompressed values equal the JAX package's, and the
    int32 spec gives the same codes and exponent values."""
    jdt, tdt, udt, _ = _DT[dtype_name]
    xj, xt, udt = _inputs(dtype_name, seed=l * 7 + bs)
    js = JF.FrszSpec(bs=bs, l=l, dtype=jdt, rounding="nearest",
                     exp_dtype=jnp.uint8)
    ts = TF.FrszSpec(bs=bs, l=l, dtype=tdt, rounding="nearest",
                     exp_dtype=torch.uint8)
    jb = jax.jit(JF.compress, static_argnums=1)(xj, js)
    tb = TF.compress(xt, ts)
    assert tb.exps.dtype == torch.uint8 and np.asarray(jb.exps).dtype == np.uint8
    assert np.array_equal(tb.exps.numpy(), np.asarray(jb.exps))
    codes = store_to_numpy({"codes": tb.codes, "exps": tb.exps}, ts)["codes"]
    assert np.array_equal(codes, np.asarray(jb.codes))
    yj = np.asarray(jax.lax.bitcast_convert_type(jax.jit(JF.decompress)(jb),
                                                 jnp.dtype(udt)))
    assert np.array_equal(_ubits(TF.decompress(tb), udt), yj)
    t32 = TF.compress(xt, dataclasses.replace(ts, exp_dtype=torch.int32))
    assert t32.exps.dtype == torch.int32
    assert torch.equal(t32.codes, tb.codes)
    assert torch.equal(t32.exps, tb.exps.to(torch.int32))


def test_exponent_dtype_validation():
    TF.FrszSpec(exp_dtype=torch.uint8)                    # f32 values: fits
    for kw in (dict(exp_dtype=torch.int16), dict(exp_dtype=torch.int64),
               dict(exp_dtype=torch.uint8, dtype=torch.float64)):
        with pytest.raises(ValueError):
            TF.FrszSpec(**kw)
