"""The port's dense LM serving path (``repro_torch.models``) against the JAX
package's, on yi-9b ``reduced()`` (f32, 4 layers, d 256, 4 heads over 2 kv
heads, hd 64), with the JAX package's weights carried across.

Tolerances (errors relative to the largest reference logit):
* prefill logits: 1e-4 — the same f32 forward, products summed in another
  order;
* decode-step logits: 1e-4 with an f32 cache; 1e-3 with a bf16 or
  frsz2_16 cache and 1e-2 with frsz2_8, because K/V that differ in their
  last f32 bits can round to neighbouring cache codes (one code step is
  2^-8 of a bf16 value, 2^-14 / 2^-6 of a head's largest value at l = 16 /
  8);
* prefill caches: f32 within 1e-5; bf16 and FRSZ2 within two code steps of
  the decoded values, and the same exponents;
* the port's own teacher-forcing check keeps ``tests/test_models.py``'s
  5e-3 (``none``) and 5e-2 (``frsz2_16``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import kvcache as jkv
from repro.models import prefill as jprefill
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import (kv_cache_from_numpy, kv_cache_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.models import decode_step, init_params, prefill, trunk
from repro_torch.models.lm import FAMILIES
from repro_torch.models.layers import rms_norm

torch.set_num_threads(2)

B, S, CAP = 2, 24, 32
LOGIT_TOL = {"none": 1e-4, "bf16": 1e-3, "frsz2_16": 1e-3, "frsz2_8": 1e-2}
STEP = {"bf16": 2.0 ** -8, "frsz2_16": 2.0 ** -14, "frsz2_8": 2.0 ** -6}


def _cfgs(kv_format):
    return (dataclasses.replace(jget("yi-9b").reduced(), kv_format=kv_format),
            dataclasses.replace(get_arch("yi-9b").reduced(),
                                kv_format=kv_format))


@pytest.fixture(scope="module")
def weights():
    """The JAX package's reduced yi-9b weights, as numpy and on the port."""
    cj, _ = _cfgs("none")
    pj = jinit(cj, jax.random.PRNGKey(0))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _decoded(cache_np, fmt):
    """Decoded K/V of a JAX-layout cache (numpy) -> {k, v} f32."""
    if fmt.kind == "raw":
        return {n: np.asarray(jnp.asarray(cache_np[n].view(jnp.bfloat16)
                                          if cache_np[n].dtype == np.uint16
                                          else cache_np[n]), np.float32)
                for n in "kv"}
    return {n: np.asarray(jkv.decode_heads(cache_np[f"{n}_codes"],
                                           cache_np[f"{n}_exps"], fmt, 64))
            for n in "kv"}


def test_params_round_trip(weights):
    pj, pt = weights
    back = params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, pj)),
                    jax.tree.leaves(back)):
        assert np.array_equal(a, b)
    # bf16 weights keep their bits both ways
    w = np.asarray(jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16))
    t = params_from_numpy({"w": w}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(params_to_numpy({"w": t})["w"],
                          w.view(np.uint16))


@pytest.mark.parametrize("kv_format", ["none", "bf16", "frsz2_16", "frsz2_8"])
def test_prefill_and_decode_match_jax(kv_format, weights, rng):
    pj, pt = weights
    cj, ct = _cfgs(kv_format)
    toks = rng.integers(0, ct.vocab_size, (B, S + 2))
    lj, cache_j = jprefill(pj, cj, jnp.asarray(toks[:, :S]), cache_len=CAP)
    lt, cache_t = prefill(pt, ct, torch.from_numpy(toks[:, :S]),
                          cache_len=CAP)
    assert _rel(lt.numpy(), lj) < 1e-4
    got, want = kv_cache_to_numpy(cache_t), jax.tree.map(np.asarray, cache_j)
    assert np.array_equal(got["lengths"], want["lengths"])
    fmt = jkv.cache_format(kv_format)
    assert set(got["self"]) == set(want["self"])
    for n in want["self"]:
        assert got["self"][n].shape == want["self"][n].shape, n
        if n.endswith("_exps"):
            assert np.array_equal(got["self"][n], want["self"][n]), n
    dg, dw = _decoded(got["self"], fmt), _decoded(want["self"], fmt)
    for n in "kv":
        scale = np.abs(dw[n]).max()
        tol = 1e-5 if fmt.kind == "raw" and kv_format == "none" else (
            2 * STEP[kv_format] * scale)
        assert np.abs(dg[n] - dw[n]).max() <= tol, (kv_format, n)
    # two decode steps from the JAX package's cache, carried across
    ct_cache = kv_cache_from_numpy(want, device="cpu")
    for t in (S, S + 1):
        lj, cache_j = jdecode(pj, cj, cache_j, jnp.asarray(toks[:, t]))
        lt, ct_cache = decode_step(pt, ct, ct_cache,
                                   torch.from_numpy(toks[:, t]))
        assert _rel(lt.numpy(), lj) < LOGIT_TOL[kv_format], (kv_format, t)
    assert np.array_equal(ct_cache["lengths"].numpy(),
                          np.asarray(cache_j["lengths"]))


@pytest.mark.parametrize("kv_format,tol", [("none", 5e-3), ("frsz2_16", 5e-2)])
def test_decode_matches_teacher_forcing(kv_format, tol):
    """prefill(S) + decode(token S) logits == the parallel forward over S+1
    tokens (``tests/test_models.py``), with the port's own weights."""
    _, cfg = _cfgs(kv_format)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    n = 32
    tokens = torch.randint(0, cfg.vocab_size, (B, n + 1),
                           generator=torch.Generator().manual_seed(1))
    h, aux = trunk(params, cfg, tokens)
    assert float(aux) == 0.0
    want = rms_norm(h[:, n - 1], params["final_ln"]) @ params["unembed"]
    got, cache = prefill(params, cfg, tokens[:, :n], cache_len=n + 4)
    assert _rel(got.numpy(), want.numpy()) < tol
    want2 = rms_norm(h[:, n], params["final_ln"]) @ params["unembed"]
    got2, cache = decode_step(params, cfg, cache, tokens[:, n])
    assert _rel(got2.numpy(), want2.numpy()) < tol
    assert cache["lengths"].tolist() == [n + 1] * B


def test_init_params_shapes_and_scales():
    cfg = get_arch("yi-9b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: jinit(
        jget("yi-9b").reduced(), jax.random.PRNGKey(0)))
    got = {k: tuple(v.shape) for k, v in
           jax.tree_util.tree_flatten_with_path(
               jax.tree.map(lambda t: np.empty(t.shape), params_to_numpy(p))
           )[0]}
    want = {k: tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert got == want
    n = sum(a.size for a in jax.tree.leaves(params_to_numpy(p)))
    assert n == sum(int(np.prod(s)) for s in want.values())
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5


def test_unknown_family_raises():
    """Every family of the registry runs; an unknown one raises
    ``ValueError`` where it would run, as the reference's ``init_params``
    does."""
    assert {c.family for c in ARCHS.values()} == set(FAMILIES)
    cj, ct = (dataclasses.replace(c, family="bogus") for c in _cfgs("none"))
    with pytest.raises(ValueError):
        jinit(cj, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="unknown family 'bogus'"):
        init_params(ct, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: prefill({}, ct, tokens),
                 lambda: decode_step({}, ct, {}, tokens[:, 0]),
                 lambda: trunk({}, ct, tokens)):
        with pytest.raises(ValueError, match="unknown family 'bogus'"):
            call()
