"""The port's MoE family (``repro_torch.models`` with ``family="moe"``)
against the JAX package's, on mixtral-8x22b and llama4-scout-17b-a16e
``reduced()`` (f32, 4 layers, d 256, 4 experts, hd 64; mixtral top-2 with
a window of 64, llama4 top-1), with the JAX package's weights carried
across.

Tolerances:
* ``_top_k_dispatch``: the dispatch and combine masks bit-equal to the
  reference's (bf16 patterns), k = 1 and 2, with a capacity small enough
  to drop choices and with gates tied on purpose (ties go to the lower
  expert index, as ``jax.lax.top_k`` breaks them);
* ``xin``, the tokens gathered into their expert slots: equal (a 0/1
  mask times h summed with zeros is exact; a zero compares equal to
  either sign);
* ``moe_block`` output within 1e-6 of the largest entry, the aux loss
  within 1e-6 relative (the same f32 products; the combine sums a token's
  k weighted slots in another order);
* ``trunk`` hidden states within 1e-5 of the largest entry, the summed
  aux loss within 1e-6 relative;
* prefill and decode logits: the limits of ``tests/test_torch_models.py``
  (1e-4 of the largest logit; 1e-3 with a bf16 or frsz2_16 cache);
* the ring route (an FRSZ2 ring cache through the flash-decode kernel's
  plain version at lengths clamped to the cache) against the reference's
  masked softmax (``attend(..., ring=...)``): 1e-5, as
  ``tests/test_torch_kvcache.py``;
* ``serve``: the same completions, token for token.

The JAX decode step rotates every row by row 0's position and appends B
positions a row (ROADMAP.md §3).  Without a ring the extra positions are
overwritten before any step reads them; in a ring they wrap onto the
oldest positions of the window, so the reference's windowed decode is
compared here at B = 1, and at B = 2 only before the ring wraps (the serve
test).  The port's own teacher-forcing check runs at B = 2 past the
window.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.launch.serve import ServeConfig as JServeConfig
from repro.launch.serve import serve as jserve
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import kvcache as jkv
from repro.models import prefill as jprefill
from repro.models import trunk as jtrunk
from repro.models.layers import _top_k_dispatch as jdispatch
from repro.models.layers import moe_block as jmoe_block
from repro.models.layers import rms_norm as jrms_norm
from repro_torch.configs import get_arch
from repro_torch.convert import (kv_cache_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models import decode_step, init_params, prefill, trunk
from repro_torch.models import kvcache as kv
from repro_torch.models import layers as TL
from repro_torch.models.layers import rms_norm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHES = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
LOGIT_TOL = {"none": 1e-4, "bf16": 1e-3, "frsz2_16": 1e-3}


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


@pytest.fixture(scope="module", params=ARCHES)
def model(request):
    """(arch, the JAX package's reduced weights, the same on the port)."""
    cj, _ = _cfgs(request.param)
    pj = jinit(cj, jax.random.PRNGKey(0))
    return (request.param, pj,
            params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu"))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _bits(a):
    """bf16 patterns of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _masks(gidx, slot, keep, weight, E, capacity):
    """The reference's (G, T, E, C) ``dispatch`` and ``combine`` tensors
    from the port's slots (``layers._top_k_dispatch``)."""
    G, T, k = gidx.shape
    flat = gidx * capacity + slot.clamp(max=capacity - 1)
    one = keep.to(weight.dtype)
    out = []
    for val in (one, weight * one):
        m = torch.zeros((G, T, E * capacity), dtype=weight.dtype)
        out.append(m.scatter_(-1, flat, val).reshape(G, T, E, capacity))
    return out


def _layer0(tree_j, tree_t):
    return (jax.tree.map(lambda a: a[0], tree_j),
            {k: v[0] for k, v in tree_t.items()})


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [8, 16, 64])
@pytest.mark.parametrize("tied", [False, True])
def test_top_k_dispatch_bit_equal(k, capacity, tied):
    """Three groups of 64 tokens over 8 experts: a capacity at most the
    mean load (64 k / 8) drops choices, 64 keeps all; tied gates take
    three values only."""
    rng = np.random.default_rng(10 * k + capacity + tied)
    if tied:
        gates = rng.choice(np.array([0.125, 0.25, 0.375], np.float32),
                           size=(3, 64, 8))
    else:
        gates = np.array(jax.nn.softmax(jnp.asarray(
            rng.standard_normal((3, 64, 8)).astype(np.float32)), -1))
    dj, cj = jax.vmap(lambda g: jdispatch(g, k=k, capacity=capacity))(
        jnp.asarray(gates))
    slots = TL._top_k_dispatch(torch.from_numpy(gates), k, capacity)
    dt, ct = _masks(*slots, 8, capacity)
    assert dt.dtype == ct.dtype == torch.bfloat16
    assert np.array_equal(_bits(dt), _bits(dj))
    assert np.array_equal(_bits(ct), _bits(cj))
    kept = int(slots[2].sum())
    assert kept == int(np.asarray(dj, np.float32).sum())
    if capacity <= 8 * k:                 # at most the mean load: drops
        assert kept < 3 * 64 * k
    elif capacity == 64:
        assert kept == 3 * 64 * k


def test_top_k_breaks_ties_to_the_lower_index():
    g = torch.tensor([[0.2, 0.4, 0.4, 0.0], [0.3, 0.3, 0.3, 0.1]])
    val, idx = TL._top_k(g, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    jv, ji = jax.lax.top_k(jnp.asarray(g.numpy()), 2)
    assert np.array_equal(np.asarray(ji), idx.numpy())
    assert np.array_equal(np.asarray(jv), val.numpy())


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_xin_and_moe_block_match_jax(arch, capacity_factor):
    """``xin`` equal to the reference's ``einsum(h, dispatch)``; the block's
    output and aux loss within tolerance; capacity factor 0.5 drops
    tokens."""
    cj, ct = _cfgs(arch, capacity_factor=capacity_factor)
    pj = jinit(cj, jax.random.PRNGKey(3))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    lj, lt = _layer0(pj["layers"]["moe"], pt["layers"]["moe"])
    x = np.random.default_rng(4).standard_normal(
        (2, 96, cj.d_model)).astype(np.float32)
    # the reference's dispatch, step by step (``layers.moe_block``), and
    # the port's gather of the same h into the slots of the same gates
    g, capacity = TL.moe_capacity(ct, 2 * 96)
    assert g == 64 and capacity >= 8
    h = jrms_norm(jnp.asarray(x), lj["ln"]).reshape(-1, g, cj.d_model)
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", h, lj["router"]), -1)
    dispatch, _ = jax.vmap(lambda gg: jdispatch(
        gg, k=cj.top_k, capacity=capacity))(gates)
    xin_j = jnp.einsum("gtd,gtec->gecd", h, dispatch.astype(h.dtype))
    gidx, slot, keep, _ = TL._top_k_dispatch(
        torch.from_numpy(np.array(gates)), cj.top_k, capacity)
    xin_t, _ = TL.expert_inputs(torch.from_numpy(np.array(h)), gidx, slot,
                                keep, cj.num_experts, capacity)
    np.testing.assert_array_equal(xin_t.numpy(), np.asarray(xin_j))
    if capacity_factor < 1:
        assert int(keep.sum()) < keep.numel()
    oj, aj = jmoe_block(jnp.asarray(x), lj, cj)
    ot, at = TL.moe_block(torch.from_numpy(x), lt, ct)
    assert _rel(ot.numpy(), oj) < 1e-6
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_carry_the_moe_tree(model):
    """The moe tree crosses both ways with its dtypes, the f32 router and
    the stacked expert axes; the port's own init has the same tree."""
    arch, pj, pt = model
    cj, ct = _cfgs(arch)
    L, d, E, ff = ct.num_layers, ct.d_model, ct.num_experts, ct.d_ff
    moe = pt["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["router"].shape) == (L, d, E)
    assert tuple(moe["wg"].shape) == tuple(moe["wi"].shape) == (L, E, d, ff)
    assert tuple(moe["wo"].shape) == (L, E, ff, d)
    back = params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, pj)),
                    jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # bf16 experts keep their bits both ways
    pb = jax.tree.map(np.asarray, jinit(dataclasses.replace(
        cj, dtype="bfloat16"), jax.random.PRNGKey(1)))
    tb = params_from_numpy(pb, device="cpu")
    assert tb["layers"]["moe"]["wg"].dtype == torch.bfloat16
    assert tb["layers"]["moe"]["router"].dtype == torch.float32
    assert np.array_equal(params_to_numpy(tb)["layers"]["moe"]["wo"],
                          pb["layers"]["moe"]["wo"].view(np.uint16))
    own = init_params(ct, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), back)
    mine = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        params_to_numpy(own))
    assert mine == shapes


def test_trunk_matches_jax(model):
    arch, pj, pt = model
    cj, ct = _cfgs(arch)
    toks = np.random.default_rng(5).integers(0, ct.vocab_size, (2, 96))
    hj, aj = jtrunk(pj, cj, jnp.asarray(toks))
    ht, at = trunk(pt, ct, torch.from_numpy(toks))
    assert _rel(ht.numpy(), hj) < 1e-5
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    assert float(at) > 0


@pytest.mark.parametrize("kv_format", ["bf16", "frsz2_16"])
def test_prefill_and_decode_match_jax(model, kv_format):
    """mixtral: B = 1, S = 80 past its window of 64, so the prefill rolls
    the ring and every decode step wraps; llama4 (no window): B = 2,
    equal lengths.  Three decode steps each."""
    arch, pj, pt = model
    cj, ct = _cfgs(arch, kv_format=kv_format)
    windowed = ct.window > 0
    B, S = (1, 80) if windowed else (2, 24)
    cap = 0 if windowed else S + 8
    toks = np.random.default_rng(6).integers(0, ct.vocab_size, (B, S + 3))
    lj, cache_j = jprefill(pj, cj, jnp.asarray(toks[:, :S]), cache_len=cap)
    lt, cache_t = prefill(pt, ct, torch.from_numpy(toks[:, :S]),
                          cache_len=cap)
    assert _rel(lt.numpy(), lj) < 1e-4
    got = kv_cache_to_numpy(cache_t)["self"]
    want = jax.tree.map(np.asarray, cache_j["self"])
    for n in want:
        assert got[n].shape == want[n].shape, n
    if windowed:
        assert got["k_codes" if kv_format != "bf16" else "k"].shape[3] == 64
    for t in range(S, S + 3):
        lj, cache_j = jdecode(pj, cj, cache_j, jnp.asarray(toks[:, t]))
        lt, cache_t = decode_step(pt, ct, cache_t,
                                  torch.from_numpy(toks[:, t]))
        assert _rel(lt.numpy(), lj) < LOGIT_TOL[kv_format], (arch, t)
    assert cache_t["lengths"].tolist() == [S + 3] * B


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("kv_format,tol", [("none", 5e-3), ("frsz2_16", 5e-2)])
def test_decode_matches_teacher_forcing(arch, kv_format, tol):
    """The port's own prefill(S) + one decode step against its parallel
    forward over S + 1 tokens at B = 2 (``tests/test_models.py``), past
    the window for mixtral (S = 80).  The capacity factor is E / k, so no
    token is dropped whatever the grouping (the forward over S + 1 tokens
    groups them otherwise than the prefill and the step)."""
    base = get_arch(arch).reduced()
    cfg = dataclasses.replace(
        base, kv_format=kv_format,
        capacity_factor=base.num_experts / base.top_k)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    n = 80 if cfg.window else 32
    tokens = torch.randint(0, cfg.vocab_size, (2, n + 1),
                           generator=torch.Generator().manual_seed(1))
    h, _ = trunk(params, cfg, tokens)
    want = rms_norm(h[:, n - 1], params["final_ln"]) @ params["unembed"]
    got, cache = prefill(params, cfg, tokens[:, :n], cache_len=n + 4)
    assert _rel(got.numpy(), want.numpy()) < tol
    want2 = rms_norm(h[:, n], params["final_ln"]) @ params["unembed"]
    got2, cache = decode_step(params, cfg, cache, tokens[:, n])
    assert _rel(got2.numpy(), want2.numpy()) < tol
    assert cache["lengths"].tolist() == [n + 1] * 2


def test_ring_cache_is_sized_to_the_window():
    """A sliding-window prefill allocates at most ``window`` slots whatever
    ``cache_len`` asks for (the ring decode writes), and its decode gives
    the same logits as the prefill without padding."""
    cfg = dataclasses.replace(get_arch("mixtral-8x22b").reduced(),
                              kv_format="frsz2_16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for cap in (41, 64, 200):
        _, cache = prefill(params, cfg, toks[:, :40], cache_len=cap)
        assert cache["self"]["k_codes"].shape[3] == min(cap, 64)
        out[cap], _ = decode_step(params, cfg, cache, toks[:, 40])
    assert torch.equal(out[64], out[200])
    assert _rel(out[41].numpy(), out[64].numpy()) < 1e-6


# ---------------------------------------------------------------------------
# the ring route through the flash-decode kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt_name", ["frsz2_16", "frsz2_8"])
@pytest.mark.parametrize("G", [1, 3])
def test_ring_route_matches_jax_attend(fmt_name, G, monkeypatch):
    """An FRSZ2 ring cache of ``ring`` slots attended at lengths below, at
    and past the ring (and past twice the ring) goes to
    ``ops.decode_attention`` at lengths clamped to the cache, and matches
    the reference's masked softmax with ``ring``."""
    from repro_torch.kernels import ops

    ring, B, Hkv, D = 16, 5, 2, 64
    rng = np.random.default_rng(7 + G)
    jf, tf = jkv.cache_format(fmt_name), kv.cache_format(fmt_name)
    k = rng.standard_normal((B, 40, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, 40, Hkv, D)).astype(np.float32)
    jc = jkv.build_cache(jnp.asarray(k), jnp.asarray(v), jf, ring=ring)
    tc = kv.build_cache(torch.from_numpy(k), torch.from_numpy(v), tf,
                        ring=ring)
    for n in ("k_codes", "k_exps", "v_codes", "v_exps"):
        assert np.array_equal(kv_cache_to_numpy({n: tc[n]})[n],
                              np.asarray(jc[n])), n
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    lens = np.array([3, ring - 1, ring, ring + 5, 2 * ring + 7], np.int32)
    seen = []
    attend = ops.decode_attention

    def spy(q_, k_bc, v_bc, lengths, **kw):
        seen.append(lengths.clone())
        return attend(q_, k_bc, v_bc, lengths, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    want = jkv.attend(jnp.asarray(q), jc, jnp.asarray(lens), jf,
                      window=ring, ring=ring)
    got = kv.attend(torch.from_numpy(q), tc, torch.from_numpy(lens), tf,
                    window=ring, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert len(seen) == 1
    assert seen[0].tolist() == np.minimum(lens, ring).tolist()


def test_ring_route_refuses_slots_past_the_ring():
    tf = kv.cache_format("frsz2_16")
    cache = {n: t[0] for n, t in kv.init_cache(tf, 1, 1, 1, 24, 64).items()}
    with pytest.raises(ValueError, match="never written"):
        kv.attend(torch.zeros((1, 1, 64)), cache,
                  torch.tensor([20], dtype=torch.int32), tf, ring=16)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHES)
def test_completions_equal_jax_serve(arch):
    """``tests/test_torch_serve.py``'s sizes (6 requests, 3 slots, prompt
    16, max_new 8, max_ctx 32: the cache stays inside mixtral's window)."""
    cj, ct = _cfgs(arch, kv_format="frsz2_16")
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, ct.vocab_size, 16).astype(np.int32)
            for _ in range(6)]
    want = jserve(cj, JServeConfig(slots=3, prompt_len=16, max_new=8,
                                   max_ctx=32), reqs, verbose=False)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jinit(cj, jax.random.PRNGKey(0))),
        device="cpu")
    stats = {}
    got = serve(ct, ServeConfig(slots=3, prompt_len=16, max_new=8,
                                max_ctx=32), reqs, params=params,
                device="cpu", verbose=False, stats=stats)
    assert got == want
    assert stats["nonfinite_logits"] == 0


@pytest.mark.parametrize("arch", ARCHES)
def test_serve_cli_runs_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--reduced", "--requests", "4", "--prompt-len",
         "70", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "4 decode steps, kv=frsz2_16, cpu" in proc.stdout
    assert "sample completion:" in proc.stdout
