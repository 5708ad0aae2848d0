"""The port's fused KV-cache write (``ops.cache_write``; on the CPU its plain
version ``ref.cache_write_ref``) against the JAX package's ``append`` and
``build_cache`` (``repro.models.kvcache``), on the same seeded numpy inputs.

Tolerance: every cache buffer bit-identical (the codec is integer
arithmetic on the values cast to f32, which is exact from bf16 and f16).
Cases: l 16 and 8; f32, bf16 and f16 K/V; D 64 and 128; decode appends at
per-row lengths 0, 5 and S - 1, then again, so that the row at S - 1 moves
past the cache and is dropped by both packages; a bulk write (T = S) at
lengths 0, 3 and S - 1, whose positions past the cache are dropped; ring
appends past the ring's length; a ring prefill of S > ring positions; a
padded prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as jkv
from repro_torch.convert import kv_cache_to_numpy
from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops, ref
from repro_torch.models import kvcache as kv

torch.set_num_threads(2)

B, HKV, S, RING = 3, 2, 12, 8
SCENARIOS = ["decode", "bulk", "ring_decode", "ring_build", "build_pad"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _values(rng, shape, dtype):
    """The same K/V in both packages: f32 values spread over 2^+-20 (and
    zeros), given to the narrow types as bit patterns."""
    x = (rng.standard_normal(shape) * np.exp2(rng.integers(-20, 20, shape[:-1]
                                                           + (1,))))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                                   # an all-zero block
    tdt, jdt = DTYPES[dtype]
    if dtype == "float32":
        return torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        bits = (x.view(np.uint32) >> 16).astype(np.uint16)
    else:                              # inside f16's range
        bits = np.clip(x * 2.0 ** -6, -6e4, 6e4).astype(np.float16).view(
            np.uint16)
    t = torch.from_numpy(bits.view(np.int16)).view(tdt)
    j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jdt)
    return t, j


def _layer(fmt_name, D, S_cache):
    jc = {n: a[0] for n, a in jkv.init_cache(jkv.cache_format(fmt_name), 1, B,
                                             HKV, S_cache, D).items()}
    tc = {n: t[0] for n, t in kv.init_cache(kv.cache_format(fmt_name), 1, B,
                                            HKV, S_cache, D).items()}
    return jc, tc


def _same(port: dict, want: dict):
    got = kv_cache_to_numpy(port)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def _appends(scenario, rng, D, dtype, jf, tf, jc, tc):
    """(lengths, T, ring) of each append of a scenario, written to both."""
    ring = RING if scenario == "ring_decode" else 0
    if scenario == "decode":
        steps = [([0, 5, S - 1], 1), ([1, 6, S], 1)]
    elif scenario == "bulk":
        steps = [([0, 3, S - 1], S)]
    else:                                               # ring_decode
        steps = [([0, 7, 13], 1), ([1, 8, 14], 1)]
    for lens, T in steps:
        (tk, jk), (tv, jv) = (_values(rng, (B, T, HKV, D), dtype)
                              for _ in range(2))
        lengths = np.asarray(lens, np.int32)
        jc = jkv.append(jc, jk, jv, jnp.asarray(lengths), jf, ring=ring)
        kv.append(tc, tk, tv, torch.from_numpy(lengths), tf, ring=ring)
    return jc


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,D", [(16, 128), (8, 64), (16, 64), (8, 128)])
def test_cache_write_bit_equal_to_jax(scenario, dtype, l, D, rng):
    fmt = f"frsz2_{l}"
    jf, tf = jkv.cache_format(fmt), kv.cache_format(fmt)
    if scenario in ("ring_build", "build_pad"):
        T = 20                          # ring_build: S > ring
        (tk, jk), (tv, jv) = (_values(rng, (B, T, HKV, D), dtype)
                              for _ in range(2))
        kw = dict(ring=RING) if scenario == "ring_build" else dict(
            cache_len=T + 4)
        want = jkv.build_cache(jk, jv, jf, **kw)
        got = kv.build_cache(tk, tv, tf, **kw)
    else:
        jc, got = _layer(fmt, D, RING if scenario == "ring_decode" else S)
        want = _appends(scenario, rng, D, dtype, jf, tf, jc, got)
    _same(got, want)


@pytest.mark.parametrize("lengths,T,ring", [
    ([0, 5, 11], 1, 0), ([0, 3, 11], 12, 0), ([0, 7, 13], 1, 8),
    (None, 20, 8), (None, 5, 8), ([2, 0, 40], 3, 0)])
def test_cache_write_slots(lengths, T, ring):
    """Positions ``lengths[b] + t`` (mod ring); dropped outside [0, S) and,
    in a ring, where a later row of the same write lands on the slot."""
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    pos, keep = ref.cache_write_slots(B, T, S, lens, ring, "cpu")
    for b in range(B):
        for t in range(T):
            p = (0 if lengths is None else lengths[b]) + t
            last = not ring or t >= T - ring
            p = p % ring if ring else p
            assert int(pos[b, t]) == p
            assert bool(keep[b, t]) == (last and 0 <= p < S)
    # no slot is written twice by one write
    slots = [(b, int(pos[b, t])) for b in range(B) for t in range(T)
             if keep[b, t]]
    assert len(slots) == len(set(slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_write_strided_view_equals_contiguous(dtype):
    """A K/V view sliced from a wider tensor writes the same cache as its
    contiguous copy, and the plain route counts no launch."""
    D, T = 64, 4
    gen = torch.Generator().manual_seed(3)
    wide = torch.randn((B, T, HKV, 2 * D + 3), generator=gen).to(dtype)
    k, v = wide[..., 1:D + 1], wide[..., D + 2:2 * D + 2]
    spec = kv.cache_format("frsz2_16").spec(D)
    lengths = torch.tensor([0, 4, 9], dtype=torch.int32)
    caches = []
    ops.reset_launches()
    for kk, vv in ((k, v), (k.contiguous(), v.contiguous())):
        c = {n: t[0] for n, t in kv.init_cache(kv.cache_format("frsz2_16"), 1,
                                               B, HKV, S, D).items()}
        ops.cache_write(kk, vv, lengths, c["k_codes"], c["k_exps"],
                        c["v_codes"], c["v_exps"], spec)
        caches.append(c)
    assert ops.LAUNCHES["frsz2_cache_write"] == 0
    for n in caches[0]:
        assert torch.equal(caches[0][n], caches[1][n]), n
    # the written rows hold the plain compress of the K/V cast to f32
    want = F.compress(k[1].float().transpose(0, 1), spec)   # (HKV, T, 1, D)
    got = caches[0]["k_codes"][1, :, 4:4 + T]
    assert torch.equal(got, want.codes.reshape(HKV, T, D))


def test_cache_write_refuses_kernel_on_cpu():
    D = 64
    c = {n: t[0] for n, t in kv.init_cache(kv.cache_format("frsz2_8"), 1, B,
                                           HKV, S, D).items()}
    x = torch.zeros((B, 1, HKV, D))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.cache_write(x, x, None, c["k_codes"], c["k_exps"], c["v_codes"],
                        c["v_exps"], kv.cache_format("frsz2_8").spec(D),
                        kernel=True)



def _forced(monkeypatch, D, fmt="frsz2_16"):
    """A zeroed layer cache, bf16 K/V and the kernel route forced on them."""
    c = {n: t[0] for n, t in kv.init_cache(kv.cache_format(fmt), 1, B, HKV,
                                           S, D).items()}
    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    ops.reset_launches()
    return c, torch.zeros((B, 1, HKV, D), dtype=torch.bfloat16)


@pytest.mark.parametrize("D,spec_kw", [
    (256, {}), (64, dict(rounding="truncate")),
    (64, dict(exp_dtype=torch.int32))])
def test_cache_write_kernel_route_raises_outside_kernel(monkeypatch, D,
                                                        spec_kw):
    """On the kernel route (forced here on CPU tensors) a write the kernel
    does not take raises before anything is built or launched: D = 256
    (over the kernel's 128), truncating rounding, int32 exponents.  None of
    them runs its plain version on the card."""
    base = kv.cache_format("frsz2_16").spec(D)
    spec = F.FrszSpec(bs=base.bs, l=base.l, dtype=base.dtype,
                      rounding=spec_kw.get("rounding", base.rounding),
                      exp_dtype=spec_kw.get("exp_dtype", base.exp_dtype))
    c, x = _forced(monkeypatch, D)
    with pytest.raises(NotImplementedError, match="no kernel"):
        ops.cache_write(x, x, None, c["k_codes"], c["k_exps"], c["v_codes"],
                        c["v_exps"], spec)
    assert ops.LAUNCHES["frsz2_cache_write"] == 0
    assert not c["k_codes"].any() and not c["v_exps"].any()


def test_cache_write_kernel_route_ignores_codec_contract(monkeypatch):
    """bs = D = 112 (zamba2-7b's head_dim) does not divide 128, so it lies
    outside ``kernel_supported``; only the device routes the cache write, so
    a CUDA write of it goes to the kernel (which takes any D <= 128) and is
    counted, rather than running the plain version on the card."""
    from repro_torch.kernels import frsz2_kernel as K

    D = 112
    spec = kv.cache_format("frsz2_16").spec(D)
    assert not ops.kernel_supported(spec)
    c, x = _forced(monkeypatch, D)
    calls = []
    monkeypatch.setattr(K, "cache_write", lambda *a: calls.append(a))
    ops.cache_write(x, x, None, c["k_codes"], c["k_exps"], c["v_codes"],
                    c["v_exps"], spec)
    assert len(calls) == 1 and calls[0][-1] == spec
    assert ops.LAUNCHES["frsz2_cache_write"] == 1
