"""The port's decode attention over an FRSZ2-coded KV cache against the JAX
package's (``repro.kernels.ops.decode_attention``, Pallas in interpret mode,
and ``repro.kernels.ref.decode_attn_ref``).

On the CPU ``repro_torch.kernels.ops.decode_attention`` runs its plain
version; the Hopper kernel is held against that on the card
(``chip_smoke.py`` phase 8, ``tests/test_torch_cuda.py``).

Tolerances: 2e-3 absolute and relative against the Pallas kernel, the
reference's own tolerance for it (``tests/test_kernels.py``); 2e-5 against
the jnp reference, which decodes the same codes and sums the same f32
products in another order.  The codes themselves are the JAX package's,
carried across bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import kvcache as jkv
from repro_torch.convert import kv_cache_from_numpy, store_from_numpy
from repro_torch.core import frsz2 as TF
from repro_torch.kernels import cardcheck, ops
from repro_torch.kernels import decode_attn as KA

torch.set_num_threads(2)

PALLAS_TOL = 2e-3
REF_TOL = 2e-5


def _case(rng, B, Hkv, G, S, D, l):
    """Seeded q/K/V, JAX-compressed K/V (int32 exps), lengths in [1, S]."""
    spec = JF.FrszSpec(bs=D, l=l, dtype=jnp.float32)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    kbc = jops.compress(jnp.asarray(k), spec, interpret=True)
    vbc = jops.compress(jnp.asarray(v), spec, interpret=True)
    return spec, q, lengths, kbc, vbc


def _port_bc(jbc, l, D):
    spec = TF.FrszSpec(bs=D, l=l, dtype=torch.float32)
    st = store_from_numpy({"codes": np.asarray(jbc.codes),
                           "exps": np.asarray(jbc.exps)}, spec, device="cpu")
    return TF.BlockCompressed(codes=st["codes"], exps=st["exps"], n=D,
                              spec=spec)


def _check(q, lengths, kbc, vbc, spec, l, D, *, pallas=True):
    B, H, _ = q.shape
    Hkv, S = kbc.exps.shape[1], kbc.exps.shape[2]
    got = ops.decode_attention(torch.from_numpy(q), _port_bc(kbc, l, D),
                               _port_bc(vbc, l, D), torch.from_numpy(lengths))
    want = jref.decode_attn_ref(
        jnp.asarray(q), kbc.codes.reshape(B, Hkv, S, -1), kbc.exps,
        vbc.codes.reshape(B, Hkv, S, -1), vbc.exps, jnp.asarray(lengths),
        spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REF_TOL,
                               atol=REF_TOL)
    if pallas:
        pk = jops.decode_attention(jnp.asarray(q), kbc, vbc,
                                   jnp.asarray(lengths), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pk),
                                   rtol=PALLAS_TOL, atol=PALLAS_TOL)
    return got


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("BHkvG", [(2, 2, 8), (1, 1, 4), (2, 4, 4)])
def test_plain_matches_pallas_and_ref(l, BHkvG, rng):
    """The reference's own grid (``tests/test_kernels.py``): D=128, S=512."""
    B, Hkv, G = BHkvG
    D, S = 128, 512
    spec, q, lengths, kbc, vbc = _case(rng, B, Hkv, G, S, D, l)
    _check(q, lengths, kbc, vbc, spec, l, D)


@pytest.mark.parametrize("l", [8, 16])
def test_head_width_64(l, rng):
    """D = 64 (the reduced configs' head width), G = 2."""
    spec, q, lengths, kbc, vbc = _case(rng, 2, 2, 2, 256, 64, l)
    _check(q, lengths, kbc, vbc, spec, l, 64)


def test_ragged_length_and_single_position(rng):
    """S = 200 (no tile divides it into 512s) and a row of length 1."""
    D, S = 128, 200
    spec, q, _, kbc, vbc = _case(rng, 3, 2, 3, S, D, 16)
    lengths = np.array([1, 137, S], np.int32)
    got = _check(q, lengths, kbc, vbc, spec, 16, D)
    # a length-1 row is the first position's V, decoded
    v0 = JF.decompress(JF.BlockCompressed(
        codes=vbc.codes[0, :, 0], exps=vbc.exps[0, :, 0], n=D, spec=spec))
    want = np.repeat(np.asarray(v0), 3, axis=0)              # (Hkv*G, D)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=REF_TOL,
                               atol=REF_TOL)


@pytest.mark.parametrize("l", [8, 16])
def test_uint8_exponents_as_the_kv_cache_holds_them(l, rng):
    """Codes and uint8 exponents from the JAX KV cache's ``encode_heads``
    (nearest rounding): the port's uint8 spec gives the int32 spec's
    result, and both match the JAX kernel on the same codes."""
    B, Hkv, G, S, D = 2, 2, 4, 96, 64
    fmt = jkv.cache_format(f"frsz2_{l}")
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    lengths = np.array([S, 41], np.int32)
    jc = {n: jkv.encode_heads(jnp.asarray(x), fmt, D)
          for n, x in (("k", k), ("v", v))}
    jspec = fmt.spec(D)
    jbc = {n: JF.BlockCompressed(codes=c, exps=e, n=D, spec=jspec)
           for n, (c, e) in jc.items()}
    want = jops.decode_attention(jnp.asarray(q), jbc["k"], jbc["v"],
                                 jnp.asarray(lengths), interpret=True)
    t = kv_cache_from_numpy({n: {"c": np.asarray(c), "e": np.asarray(e)}
                             for n, (c, e) in jc.items()}, device="cpu")
    assert t["k"]["e"].dtype == torch.uint8
    spec8 = TF.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest",
                        exp_dtype=torch.uint8)
    spec32 = TF.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest")
    outs = []
    for spec, conv in ((spec8, lambda e: e), (spec32, lambda e: e.int())):
        bcs = [TF.BlockCompressed(codes=t[n]["c"].reshape(B, Hkv, S, 1, D),
                                  exps=conv(t[n]["e"]), n=D, spec=spec)
               for n in "kv"]
        outs.append(ops.decode_attention(torch.from_numpy(q), *bcs,
                                         torch.from_numpy(lengths)))
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want),
                               rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_bf16_queries_return_bf16(rng):
    spec, q, lengths, kbc, vbc = _case(rng, 1, 2, 2, 64, 64, 16)
    q16 = torch.from_numpy(q).to(torch.bfloat16)
    got = ops.decode_attention(q16, _port_bc(kbc, 16, 64), _port_bc(vbc, 16, 64),
                               torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    want = jref.decode_attn_ref(
        jnp.asarray(q16.float().numpy()), kbc.codes.reshape(1, 2, 64, -1),
        kbc.exps, vbc.codes.reshape(1, 2, 64, -1), vbc.exps,
        jnp.asarray(lengths), spec)
    # the f32 result rounded once to bf16: within one bf16 ulp (2^-8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=2 ** -8, atol=2 ** -8)


def test_wrapper_validates_and_never_launches_on_cpu(rng):
    spec, q, lengths, kbc, vbc = _case(rng, 1, 2, 2, 32, 64, 16)
    qt, lt = torch.from_numpy(q), torch.from_numpy(lengths)
    kb, vb = _port_bc(kbc, 16, 64), _port_bc(vbc, 16, 64)
    ops.reset_launches()
    ops.decode_attention(qt, kb, vb, lt)
    assert ops.LAUNCHES["decode_attn"] == 0
    with pytest.raises(RuntimeError):
        ops.decode_attention(qt, kb, vb, lt, kernel=True)
    with pytest.raises(ValueError):
        ops.decode_attention(qt[:, :3], kb, vb, lt)          # H % Hkv
    with pytest.raises(ValueError):
        ops.decode_attention(qt[..., :32], kb, vb, lt)       # D != nbd * bs


@pytest.mark.parametrize("resident", [3 * 132, 8 * 132])
@pytest.mark.parametrize("B,Hkv,G,S", [(8, 4, 8, 2120), (8, 4, 8, 32768),
                                       (3, 2, 12, 1000), (1, 1, 1, 1),
                                       (8, 2, 3, 319), (64, 8, 4, 131072)])
def test_splits_cover_the_cache_in_whole_tiles(B, Hkv, G, S, resident):
    """The kernel's splits come from the shapes alone (no lengths, so the
    launch reads nothing back from the card): a chunk of whole 64-position
    tiles, two to eight, the smallest that fits the grid into one wave of
    ``resident`` blocks (the card's occupancy of the instantiation: three or
    eight blocks on each of 132 SMs here), and splits that cover S with none
    wholly past it."""
    chunk, nsplit = KA.splits(B, Hkv, G, S, resident)
    assert chunk % KA.TILE == 0 and KA.MIN_CHUNK <= chunk <= KA.MAX_CHUNK
    assert (nsplit - 1) * chunk < S <= nsplit * chunk
    tiles = B * Hkv * -(-G // KA.GROUP_TILE)
    if chunk > KA.MIN_CHUNK and chunk < KA.MAX_CHUNK:
        # one wave of resident blocks, which one tile less would overfill
        assert tiles * nsplit <= resident
        assert tiles * -(-S // (chunk - KA.TILE)) > resident
    assert nsplit <= 8192                  # the entry point's limit
    assert KA.splits(B, Hkv, G, S, resident) == (chunk, nsplit)


def test_card_edge_lengths_cross_the_tiles_and_a_split():
    """The card checks' lengths (``cardcheck.ATTN_EDGE_LENGTHS``) sit on and
    beside the kernel's tile and cross a split of the cache they use."""
    T = KA.TILE
    lens = cardcheck.ATTN_EDGE_LENGTHS
    assert {0, 1, T - 1, T, T + 1} <= set(lens)
    S = max(lens) + 2
    assert S % T
    # whatever the card's occupancy (1 to 16 blocks on each of 132 SMs)
    for resident in range(132, 16 * 132 + 1, 132):
        chunk, nsplit = KA.splits(len(lens), 2, 1, S, resident)
        assert nsplit > 1 and any(chunk < n < S for n in lens)
        assert any(n % chunk == 0 and n for n in lens)


@pytest.mark.parametrize("D,l", [(128, 16), (64, 8)])
def test_wrapper_rejects_caches_not_16_byte_aligned(rng, monkeypatch, D, l):
    """The kernel stages K/V codes by 16-byte cp.async, so the wrapper's
    kernel route refuses codes that start elsewhere (one code into a larger
    buffer) before anything is built or launched; the route is forced here
    on CPU tensors, which the check reads no further than their address."""
    spec, q, lengths, kbc, vbc = _case(rng, 2, 2, 2, 40, D, l)
    qt, lt = torch.from_numpy(q), torch.from_numpy(lengths)
    kb, vb = _port_bc(kbc, l, D), _port_bc(vbc, l, D)

    def shifted(bc):
        buf = torch.empty(bc.codes.numel() + 1, dtype=bc.codes.dtype)
        codes = buf[1:].view(bc.codes.shape)
        codes.copy_(bc.codes)
        return TF.BlockCompressed(codes=codes, exps=bc.exps, n=D,
                                  spec=bc.spec)

    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    ops.reset_launches()
    for name, k, v in (("k", shifted(kb), vb), ("v", kb, shifted(vb))):
        with pytest.raises(ValueError, match=f"{name} codes must start "
                                             "16-byte aligned"):
            ops.decode_attention(qt, k, v, lt)
    assert ops.LAUNCHES["decode_attn"] == 0
