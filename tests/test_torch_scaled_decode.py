"""The scaled FRSZ2 decode against the bit decode, bit for bit.

``ref.decode_scaled_ref`` is the plain version of the kernels' scaled
decode (``csrc/frsz2_common.cuh::decode_scaled``): ``±csig * 2^(emax - bias -
(l-2))`` where the block exponent is in ``[l-1, 2*bias]``, the bit decode
elsewhere.  Tolerance: none.  It must give the same bits as the JAX
package's ``decompress`` and the port's ``F.decompress`` for every code of
l = 8 and l = 16, for 2^16 seeded codes and the edge codes of l = 32, in f32
and f64 values, at exponents 0..l+8 (the flush zone and the guard's lower
edge), a seeded spread, 2*bias (the top of the guard) and 2*bias+1 (Inf/NaN
patterns).  Values are compared as integer bits, so signed zeros and NaN
payloads count.  ``ref.decode_fma_ref``, the f64 one-FMA decode of the
redesigned matvec and block combine (``decode_fma``), is held to the same
bits, with its narrower guard's top edge 2*bias + l - 54 in the exponents.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro_torch.core import frsz2 as TF
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

_UINT = {8: np.uint8, 16: np.uint16, 32: np.uint32}
_SINT = {8: np.uint8, 16: np.int16, 32: np.int32}
_JDT = {"float32": jnp.float32, "float64": jnp.float64}
_TDT = {"float32": torch.float32, "float64": torch.float64}
_BITS = {"float32": (np.int32, torch.int32), "float64": (np.int64, torch.int64)}
_BIAS = {"float32": 127, "float64": 1023}


def _codes(l: int, seed: int) -> np.ndarray:
    """Every code for l <= 16; for l = 32, 2^16 seeded codes plus the edges:
    0, the sign alone, 1, all ones, the largest and smallest nonzero
    fields of either sign."""
    if l <= 16:
        return np.arange(1 << l, dtype=np.uint64).astype(_UINT[l])
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
    edges = np.array([0, 1 << 31, 1, (1 << 32) - 1, (1 << 31) - 1,
                      (1 << 31) + 1, 1 << 30, (1 << 31) | (1 << 30)],
                     dtype=np.uint64)
    return np.concatenate([edges, rand]).astype(np.uint32)


def _exponents(l: int, dtype: str, seed: int) -> np.ndarray:
    bias = _BIAS[dtype]
    rng = np.random.default_rng(seed + 1)
    spread = rng.integers(0, 2 * bias + 2, 16)
    return np.unique(np.concatenate([np.arange(l + 9), spread,
                                     [2 * bias - 1, 2 * bias, 2 * bias + 1]])
                     ).astype(np.int32)


def _decoders(codes: np.ndarray, exps: np.ndarray, dtype: str, l: int):
    """(scaled ref, port bit decode, JAX bit decode) as integer bits, every
    code under every exponent: one block of all codes per exponent."""
    n = codes.size
    c2 = np.broadcast_to(codes, (exps.size, n)).copy()
    tspec = TF.FrszSpec(bs=n, l=l, dtype=_TDT[dtype])
    jspec = JF.FrszSpec(bs=n, l=l, dtype=_JDT[dtype])
    tcodes = torch.from_numpy(c2.view(_SINT[l])).reshape(exps.size, 1, n)
    texps = torch.from_numpy(exps).reshape(exps.size, 1)
    npi, ti = _BITS[dtype]
    scaled = ref.decode_scaled_ref(tcodes, texps, tspec).reshape(exps.size, n)
    bit = TF.decompress(TF.BlockCompressed(codes=tcodes, exps=texps, n=n,
                                           spec=tspec))
    jax_v = JF.decompress(JF.BlockCompressed(
        codes=jnp.asarray(c2.reshape(exps.size, 1, n)),
        exps=jnp.asarray(exps.reshape(exps.size, 1)), n=n, spec=jspec))
    return (scaled.view(ti).numpy(), bit.view(ti).numpy(),
            np.asarray(jax_v).view(npi))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("l", [8, 16, 32])
def test_scaled_decode_matches_bit_decode(dtype, l):
    codes = _codes(l, seed=l)
    exps = _exponents(l, dtype, seed=l)
    scaled, bit, jax_bits = _decoders(codes, exps, dtype, l)
    np.testing.assert_array_equal(bit, jax_bits)
    bad = np.argwhere(scaled != bit)
    assert bad.size == 0, (
        f"{bad.shape[0]} mismatches, first: exponent {exps[bad[0][0]]}, code "
        f"{int(codes[bad[0][1]]):#x}")
    # both sides of the guard were exercised
    bias = _BIAS[dtype]
    inside = (exps >= l - 1) & (exps <= 2 * bias)
    assert inside.any() and (~inside).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scaled_decode_keeps_signed_zeros_and_nan_payloads(dtype):
    l = 16
    bias = _BIAS[dtype]
    npi, _ = _BITS[dtype]
    codes = np.array([0, 1 << 15, 1, (1 << 16) - 1, (1 << 15) - 1],
                     dtype=np.uint16)
    exps = np.array([l - 1, 2 * bias, 2 * bias + 1, 0], dtype=np.int32)
    scaled, bit, _ = _decoders(codes, exps, dtype, l)
    np.testing.assert_array_equal(scaled, bit)
    sign = np.array(1, dtype=npi) << (np.dtype(npi).itemsize * 8 - 1)
    assert scaled[0, 0] == 0 and scaled[0, 1] == sign      # +0 and -0
    vals = scaled.view(np.float32 if dtype == "float32" else np.float64)
    assert np.isnan(vals[2, 4]) or np.isinf(vals[2, 4])    # 2*bias+1: no finite value


def test_f32_scaled_decode_truncates_toward_zero():
    """l = 32 codes with more than 24 significant bits round toward zero in
    f32, as the bit decode's cut does."""
    spec = TF.FrszSpec(bs=1, l=32, dtype=torch.float32)
    c = torch.tensor([[[0x7FFFFFFF]], [[(1 << 30) | 0xFF]]], dtype=torch.int32)
    e = torch.tensor([[127], [127]], dtype=torch.int32)
    v = ref.decode_scaled_ref(c, e, spec).reshape(-1)
    want = torch.tensor([2 ** 31 - 2 ** 7, 2 ** 30 + 2 ** 7],
                        dtype=torch.float64) * 2.0 ** -30
    assert torch.equal(v.double(), want)
    assert torch.equal(v, ops.decompress(TF.BlockCompressed(
        codes=c, exps=e, n=1, spec=spec)).reshape(-1))


@pytest.mark.parametrize("dtype,l", [(torch.float64, 32), (torch.float32, 16),
                                     (torch.float64, 8)])
def test_identity_ell_decodes_a_coded_vector(dtype, l):
    """The card check of the scaled decode through the ELL kernel, run on
    the CPU route: an identity operator on a coded vector built from codes
    and exponents directly is its decompression, bit for bit."""
    bs = 32
    rng = np.random.default_rng(3)
    nb = 64
    bits = rng.integers(0, 1 << l, (nb, bs), dtype=np.uint64)
    codes = torch.from_numpy(bits.astype(_UINT[l]).view(_SINT[l]))
    bias = 1023 if dtype == torch.float64 else 127
    exps = torch.from_numpy(np.concatenate([
        np.arange(l + 8), [2 * bias, 2 * bias + 1],
        rng.integers(0, 2 * bias + 2, nb - l - 10)]).astype(np.int32))
    spec = TF.FrszSpec(bs=bs, l=l, dtype=dtype)
    bc = TF.BlockCompressed(codes=codes, exps=exps, n=nb * bs, spec=spec)
    n = nb * bs
    vals = torch.ones((n, 1), dtype=dtype)
    cols = torch.arange(n, dtype=torch.int32)[:, None]
    got = ops.ell_spmv(vals, cols, bc) + 0.0
    want = ops.decompress(bc) + 0.0
    ibits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(ibits), want.view(ibits))
    scaled = ref.decode_scaled_ref(codes, exps, spec).reshape(-1) + 0.0
    assert torch.equal(scaled.view(ibits), want.view(ibits))


@pytest.mark.parametrize("l", [8, 16, 32])
def test_fma_decode_matches_bit_decode(l):
    """fma(2^52 + csig, s, -2^52 s) is csig * s exactly wherever -2^52 s is
    finite; above that edge the guard sends the block to the bit decode."""
    codes = _codes(l, seed=l + 100)
    bias = _BIAS["float64"]
    top = 2 * bias + l - 54
    exps = np.unique(np.concatenate([_exponents(l, "float64", seed=l + 100),
                                     [top - 1, top, top + 1]])).astype(np.int32)
    _, bit, _ = _decoders(codes, exps, "float64", l)
    n = codes.size
    spec = TF.FrszSpec(bs=n, l=l, dtype=torch.float64)
    tcodes = torch.from_numpy(np.broadcast_to(codes, (exps.size, n)).copy()
                              .view(_SINT[l])).reshape(exps.size, 1, n)
    got = ref.decode_fma_ref(tcodes, torch.from_numpy(exps).reshape(-1, 1),
                             spec).reshape(exps.size, n)
    np.testing.assert_array_equal(got.view(torch.int64).numpy(), bit)
    inside = (exps >= l - 1) & (exps <= top)
    assert inside.any() and (exps == top + 1).any()
