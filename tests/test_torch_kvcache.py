"""The port's KV cache (``repro_torch.models.kvcache``) against the JAX
package's (``repro.models.kvcache``), on the same seeded numpy inputs.

Tolerances:
* codes, exponents and every cache buffer: bit-identical (the codec is
  integer arithmetic; raw buffers are the same casts);
* ``attend``: 2e-5 against JAX's ``attend`` for the raw formats and the
  windowed/ring cases (the same masked softmax in f32, summed in another
  order); 2e-5 for an FRSZ2 cache too, which ``attend`` hands to
  ``ops.decode_attention``, on the CPU the plain version of the
  decode-attention kernel, which scales the logits rather than q (equal
  up to rounding, never bit for bit);
* the ported cases of ``tests/test_kvcache.py`` keep that file's
  tolerances (2e-4 and 1e-4 against naive attention, 2^-10 compression
  error for 16-bit codes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as jkv
from repro_torch.convert import kv_cache_to_numpy
from repro_torch.models import kvcache as kv

torch.set_num_threads(2)

FORMATS = ["none", "bf16", "frsz2_16", "frsz2_8"]
TOL = 2e-5


def _np(x):
    """A JAX array as numpy, bf16 as its uint16 bit patterns (the port's
    ``kv_cache_to_numpy`` convention)."""
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_cache(port: dict, ref: dict):
    got = kv_cache_to_numpy(port)
    assert set(got) == set(ref)
    for k in ref:
        want = _np(ref[k])
        assert got[k].dtype == want.dtype, (k, got[k].dtype, want.dtype)
        assert np.array_equal(got[k], want), k


def _kv(rng, B, S, Hkv, D):
    return (rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("D", [64, 128])
def test_encode_heads_bit_identical(l, D, rng):
    x = (rng.standard_normal((2, 3, 17, D))
         * np.exp2(rng.integers(-20, 20, (2, 3, 17, 1)))).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # an all-zero block
    jf, tf = jkv.cache_format(f"frsz2_{l}"), kv.cache_format(f"frsz2_{l}")
    jc, je = jkv.encode_heads(jnp.asarray(x), jf, D)
    tc, te = kv.encode_heads(torch.from_numpy(x), tf, D)
    got = kv_cache_to_numpy({"c": tc, "e": te})
    assert np.array_equal(got["c"], np.asarray(jc))
    assert got["e"].dtype == np.uint8 and np.array_equal(got["e"],
                                                         np.asarray(je))
    back = kv.decode_heads(tc, te, tf, D)
    assert np.array_equal(back.numpy(), np.asarray(jkv.decode_heads(
        jc, je, jf, D)))


@pytest.mark.parametrize("fmt_name", FORMATS)
@pytest.mark.parametrize("cache_len,ring", [(0, 0), (40, 0), (0, 16)])
def test_build_cache_equal(fmt_name, cache_len, ring, rng):
    """Prefill's bulk build, padded to ``cache_len`` or as a ring."""
    B, S, Hkv, D = 2, 24, 2, 64
    k, v = _kv(rng, B, S, Hkv, D)
    want = jkv.build_cache(jnp.asarray(k), jnp.asarray(v),
                           jkv.cache_format(fmt_name), cache_len=cache_len,
                           ring=ring)
    got = kv.build_cache(torch.from_numpy(k), torch.from_numpy(v),
                         kv.cache_format(fmt_name), cache_len=cache_len,
                         ring=ring)
    _assert_same_cache(got, want)


@pytest.mark.parametrize("fmt_name", FORMATS)
def test_append_then_attend_matches_jax(fmt_name, rng):
    """A built cache, three decode appends, then attend: the buffers are
    bit-identical and the outputs agree within 2e-5."""
    B, S, Hkv, G, D, cap = 2, 20, 2, 3, 64, 32
    jf, tf = jkv.cache_format(fmt_name), kv.cache_format(fmt_name)
    k, v = _kv(rng, B, S, Hkv, D)
    jc = jkv.build_cache(jnp.asarray(k), jnp.asarray(v), jf, cache_len=cap)
    tc = kv.build_cache(torch.from_numpy(k), torch.from_numpy(v), tf,
                        cache_len=cap)
    lengths = np.full((B,), S, np.int32)
    for _ in range(3):
        kn, vn = _kv(rng, B, 1, Hkv, D)
        jc = jkv.append(jc, jnp.asarray(kn), jnp.asarray(vn),
                        jnp.asarray(lengths), jf)
        kv.append(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                  torch.from_numpy(lengths), tf)
        lengths = lengths + 1
    _assert_same_cache(tc, jc)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    for lens in (lengths, np.array([5, S + 3], np.int32)):
        want = jkv.attend(jnp.asarray(q), jc, jnp.asarray(lens), jf)
        got = kv.attend(torch.from_numpy(q), tc, torch.from_numpy(lens), tf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("fmt_name", ["none", "frsz2_16"])
def test_window_and_ring_attend_match_jax(fmt_name, rng):
    B, Hkv, G, D, ring, total = 2, 2, 2, 64, 16, 40
    jf, tf = jkv.cache_format(fmt_name), kv.cache_format(fmt_name)
    k, v = _kv(rng, B, total, Hkv, D)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    lens = np.array([total, 29], np.int32)
    # sliding window over a full cache
    jc = jkv.build_cache(jnp.asarray(k), jnp.asarray(v), jf)
    tc = kv.build_cache(torch.from_numpy(k), torch.from_numpy(v), tf)
    want = jkv.attend(jnp.asarray(q), jc, jnp.asarray(lens), jf, window=8)
    got = kv.attend(torch.from_numpy(q), tc, torch.from_numpy(lens), tf,
                    window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # ring buffer of the last 16 positions
    jc = jkv.build_cache(jnp.asarray(k), jnp.asarray(v), jf, ring=ring)
    tc = kv.build_cache(torch.from_numpy(k), torch.from_numpy(v), tf,
                        ring=ring)
    full = np.full((B,), total, np.int32)
    want = jkv.attend(jnp.asarray(q), jc, jnp.asarray(full), jf, ring=ring)
    got = kv.attend(torch.from_numpy(q), tc, torch.from_numpy(full), tf,
                    ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("fmt_name", FORMATS)
def test_sizes_equal(fmt_name):
    jf, tf = jkv.cache_format(fmt_name), kv.cache_format(fmt_name)
    for D in (64, 112, 128):
        assert tf.bits_per_value(D) == jf.bits_per_value(D)
    for shape in ((1, 1, 1, 1, 64), (48, 8, 4, 2120, 128), (4, 2, 2, 32, 64)):
        assert kv.cache_nbytes(tf, *shape) == jkv.cache_nbytes(jf, *shape)
    cache = kv.init_cache(tf, 2, 2, 2, 8, 64)
    nbytes = sum(t.numel() * t.element_size() for t in cache.values())
    assert nbytes == kv.cache_nbytes(tf, 2, 2, 2, 8, 64)


# ---------------------------------------------------------------------------
# the cases of tests/test_kvcache.py, on the port
# ---------------------------------------------------------------------------


def _naive_attn(q, k, v, lengths, window=0):
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float() * D ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float())
    pos = torch.arange(S)
    valid = pos[None, :] < lengths[:, None]
    if window:
        valid &= pos[None, :] >= lengths[:, None] - window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    return torch.einsum("bhgk,bhkd->bhgd", p, v.float()).reshape(B, H, D)


@pytest.mark.parametrize("fmt_name", FORMATS)
def test_attend_matches_naive(fmt_name, rng):
    B, Hkv, G, S, D = 2, 2, 4, 256, 64
    fmt = kv.cache_format(fmt_name)
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, D)).astype(np.float32))
    lengths = torch.tensor([100, 256], dtype=torch.int32)
    lc = kv.build_cache(k, v, fmt)
    out = kv.attend(q, lc, lengths, fmt)
    if fmt.kind == "frsz2":
        k_rt = kv.decode_heads(*kv.encode_heads(k.transpose(1, 2), fmt, D),
                               fmt, D)
        v_rt = kv.decode_heads(*kv.encode_heads(v.transpose(1, 2), fmt, D),
                               fmt, D)
    else:
        dt = fmt.raw_torch_dtype()
        k_rt = k.transpose(1, 2).to(dt).float()
        v_rt = v.transpose(1, 2).to(dt).float()
    want = _naive_attn(q, k_rt, v_rt, lengths)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_compression_error_small(rng):
    B, Hkv, S, D = 2, 2, 128, 128
    fmt16 = kv.cache_format("frsz2_16")
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    kc, ke = kv.encode_heads(k.transpose(1, 2), fmt16, D)
    k_rt = kv.decode_heads(kc, ke, fmt16, D)
    rel = (k_rt - k.transpose(1, 2)).abs().max() / k.abs().max()
    assert float(rel) < 2 ** -10


def _single_layer(fmt, B, Hkv, S, D):
    return {n: t[0] for n, t in kv.init_cache(fmt, 1, B, Hkv, S, D).items()}


def test_append_then_attend_equals_build(rng):
    """Sequential appends == bulk build (whole-block write discipline)."""
    B, Hkv, S, D = 2, 2, 32, 64
    fmt = kv.cache_format("frsz2_16")
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    bulk = kv.build_cache(k, v, fmt)
    lc = _single_layer(fmt, B, Hkv, S, D)
    for t in range(S):
        kv.append(lc, k[:, t:t + 1], v[:, t:t + 1],
                  torch.full((B,), t, dtype=torch.int32), fmt)
    for key in bulk:
        assert torch.equal(bulk[key], lc[key]), key


def test_ring_buffer_window(rng):
    """Sliding-window ring cache: only the last `ring` positions attend."""
    B, Hkv, D, ring, total = 1, 1, 64, 16, 40
    fmt = kv.cache_format("none")
    k = torch.from_numpy(rng.standard_normal((B, total, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, total, Hkv, D)).astype(np.float32))
    lc = _single_layer(fmt, B, Hkv, ring, D)
    for t in range(total):
        kv.append(lc, k[:, t:t + 1], v[:, t:t + 1],
                  torch.full((B,), t, dtype=torch.int32), fmt, ring=ring)
    q = torch.from_numpy(rng.standard_normal((B, Hkv, D)).astype(np.float32))
    out = kv.attend(q, lc, torch.full((B,), total, dtype=torch.int32), fmt,
                    ring=ring)
    ks = k[:, total - ring:].transpose(1, 2)
    vs = v[:, total - ring:].transpose(1, 2)
    want = _naive_attn(q, ks, vs, torch.full((B,), ring, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_build_cache_ring_matches_appends(rng):
    B, Hkv, D, ring, S = 1, 2, 64, 16, 40
    fmt = kv.cache_format("frsz2_16")
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, D)).astype(np.float32))
    bulk = kv.build_cache(k, v, fmt, ring=ring)
    lc = _single_layer(fmt, B, Hkv, ring, D)
    for t in range(S):
        kv.append(lc, k[:, t:t + 1], v[:, t:t + 1],
                  torch.full((B,), t, dtype=torch.int32), fmt, ring=ring)
    for key in bulk:
        assert torch.equal(bulk[key], lc[key]), key


def test_bits_per_value():
    assert kv.cache_format("frsz2_16").bits_per_value(128) == pytest.approx(
        (128 * 16 + 8) / 128)
    assert kv.cache_format("bf16").bits_per_value(128) == 16
