"""The port's kernel wrappers and plain versions against the JAX package.

On the CPU the wrappers run the plain PyTorch versions (``kernels/ref.py``);
the Hopper kernels themselves are held against those on the card by
``chip_smoke.py`` and by the ``cuda``-marked tests of ``test_torch_cuda.py``.

Tolerances:
* codec: bit-identical (integer arithmetic on IEEE fields);
* plain contractions vs JAX ``ref.matvec_ref``/``rmatvec_ref`` (f64 specs):
  1e-13 relative — both sum the same f64 products, in another order;
* plain contractions vs JAX's Pallas ``ops.matvec``/``rmatvec`` in interpret
  mode: only 2e-5.  The Pallas kernels round every tile's dot to f32
  (``preferred_element_type=jnp.float32`` at ``frsz2_dot.py:66``/``:99``)
  even for f64 specs; the port accumulates in the spec dtype, as
  ``kernels/ref.py`` defines the contraction.  The test also checks that
  the gap is larger than f64 rounding, which documents that fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import store_from_numpy, store_to_numpy
from repro_torch.core import frsz2 as TF
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

_T = {jnp.float32: torch.float32, jnp.float64: torch.float64}

KSPECS = [(jnp.float32, 32, 128), (jnp.float32, 16, 32), (jnp.float32, 8, 64),
          (jnp.float64, 32, 32), (jnp.float64, 16, 128)]


def _specs(jdt, l, bs):
    return (JF.FrszSpec(bs=bs, l=l, dtype=jdt),
            TF.FrszSpec(bs=bs, l=l, dtype=_T[jdt]))


def _basis(rng, m, n, jdt):
    x = rng.standard_normal((m, n)) * np.exp2(rng.integers(-4, 4, (m, n)))
    return x.astype(np.dtype(jnp.dtype(jdt).name))


@pytest.mark.parametrize("jdt,l,bs", KSPECS, ids=str)
def test_plain_codec_matches_pallas_interpret(jdt, l, bs, rng):
    js, ts = _specs(jdt, l, bs)
    x = _basis(rng, 4, 1024, jdt)
    jb = jops.compress(jnp.asarray(x), js, interpret=True)
    codes, exps = ref.compress_ref(torch.from_numpy(x), ts)
    got = store_to_numpy({"codes": codes, "exps": exps}, ts)
    assert np.array_equal(got["codes"], np.asarray(jb.codes))
    assert np.array_equal(got["exps"], np.asarray(jb.exps))
    yj = np.asarray(jops.decompress(jb, interpret=True))
    yt = ref.decompress_ref(codes, exps, ts).numpy()
    assert np.array_equal(yt.view(np.uint8), yj.view(np.uint8))


@pytest.mark.parametrize("l,bs,m", [(32, 32, 1), (32, 32, 7), (16, 128, 7),
                                    (8, 1, 7)])
def test_plain_contractions_match_jax_ref_f64(l, bs, m, rng):
    js, ts = _specs(jnp.float64, l, bs)
    V = _basis(rng, m, 999, jnp.float64)
    jb = JF.compress(jnp.asarray(V), js)
    st = store_from_numpy({"codes": np.asarray(jb.codes),
                           "exps": np.asarray(jb.exps)}, ts, device="cpu")
    npad = st["codes"].shape[1] * bs
    x = np.zeros(npad)
    x[:999] = rng.standard_normal(999)
    h = rng.standard_normal(m)
    yj = np.asarray(jref.matvec_ref(jb.codes, jb.exps, jnp.asarray(x), js))
    yt = ref.matvec_ref(st["codes"], st["exps"], torch.from_numpy(x), ts)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-13,
                               atol=1e-13 * np.abs(yj).max())
    zj = np.asarray(jref.rmatvec_ref(jb.codes, jb.exps, jnp.asarray(h), js))
    zt = ref.rmatvec_ref(st["codes"], st["exps"], torch.from_numpy(h), ts)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-13,
                               atol=1e-13 * np.abs(zj).max())
    # the wrappers (plain route on CPU tensors) agree with the plain versions
    bc = TF.BlockCompressed(codes=st["codes"], exps=st["exps"], n=999, spec=ts)
    assert torch.equal(ops.matvec(bc, torch.from_numpy(x[:999])), yt)
    assert torch.equal(ops.rmatvec(bc, torch.from_numpy(h)), zt[:999])


def test_pallas_dots_are_f32_rounded_for_f64_specs(rng):
    """The f32 fault of ``frsz2_dot.py:66``/``:99``: within 2e-5 only."""
    js, ts = _specs(jnp.float64, 32, 32)
    V = rng.standard_normal((8, 4096)) * 30.0
    x = rng.standard_normal(4096)
    h = rng.standard_normal(8)
    jb = jops.compress(jnp.asarray(V), js, interpret=True)
    st = store_from_numpy({"codes": np.asarray(jb.codes),
                           "exps": np.asarray(jb.exps)}, ts, device="cpu")
    bc = TF.BlockCompressed(codes=st["codes"], exps=st["exps"], n=4096,
                            spec=ts)
    for yj, yt in (
            (jops.matvec(jb, jnp.asarray(x), interpret=True),
             ops.matvec(bc, torch.from_numpy(x))),
            (jops.rmatvec(jb, jnp.asarray(h), interpret=True),
             ops.rmatvec(bc, torch.from_numpy(h)))):
        yj, yt = np.asarray(yj), yt.numpy()
        np.testing.assert_allclose(yt, yj, rtol=2e-5, atol=2e-5)
        rel = np.abs(yt - yj).max() / np.abs(yt).max()
        assert rel > 1e-12, "Pallas dots no longer f32-rounded"


def test_kernel_supported_agrees():
    for jdt in (jnp.float32, jnp.float64, jnp.float16, jnp.bfloat16):
        tdt = {jnp.float32: torch.float32, jnp.float64: torch.float64,
               jnp.float16: torch.float16, jnp.bfloat16: torch.bfloat16}[jdt]
        for l in (3, 8, 12, 16, 21, 32, 64):
            for bs in (1, 2, 8, 24, 32, 64, 96, 128, 256):
                try:
                    js = JF.FrszSpec(bs=bs, l=l, dtype=jdt)
                except ValueError:
                    continue
                ts = TF.FrszSpec(bs=bs, l=l, dtype=tdt)
                assert ops.kernel_supported(ts) == jops.kernel_supported(js)


def test_cpu_tensors_never_launch(rng):
    ops.reset_launches()
    ts = TF.FrszSpec(bs=32, l=32, dtype=torch.float64)
    x = torch.from_numpy(rng.standard_normal((3, 200)))
    bc = ops.compress(x, ts)
    y = ops.decompress(bc)
    ops.matvec(bc, x[0])
    ops.rmatvec(bc, torch.ones(3, dtype=torch.float64))
    codes = torch.empty_like(bc.codes[0])
    exps = torch.empty_like(bc.exps[0])
    ops.compress(x[1], ts, out=(codes, exps))
    assert torch.equal(codes, bc.codes[1]) and torch.equal(exps, bc.exps[1])
    assert y.shape == x.shape
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.compress(x, ts, kernel=True)
    with pytest.raises(ValueError):
        ops.matvec(bc, x[0, :10])
