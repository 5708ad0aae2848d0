"""The port's encoder-decoder and VLM families (the ``encdec`` and ``vlm``
branches of ``repro_torch.models.lm``) against the JAX package's, on
whisper-medium ``reduced()`` (f32, 4 decoder layers with cross-attention in
each, a 2-layer bidirectional encoder over 64 stub frames, d 256, 4 heads
over 2 kv heads, hd 64) and llama-3.2-vision-11b ``reduced()`` (f32, 4 self
layers, a cross block with its own MLP after every 2nd, 32 stub image
tokens), with the JAX package's weights carried across.

Tolerances, relative to the largest reference value:
* ``trunk`` hidden states and prefill logits: 1e-4 (the same f32 forward,
  products summed in another order);
* decode-step logits from the reference's cache: ``LOGIT_TOL``, as in
  ``tests/test_torch_models.py`` (1e-4 with an f32 cache, 1e-3 with bf16 or
  frsz2_16, 1e-2 with frsz2_8: K/V that differ in their last f32 bits can
  round to neighbouring codes);
* prefill caches (self and cross): the same exponents, the decoded values
  within two code steps (f32 within 1e-5);
* the port's own teacher forcing: ``tests/test_models.py``'s 5e-3
  (``none``) and 5e-2 (``frsz2_16``);
* ``serve``: the same completions, token for token.

All rows have one length, where the reference's decode RoPE broadcast
(``ROADMAP.md`` §3) gives the visible values of per-row positions.
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
from repro.launch.serve import _aux_for as jaux_for
from repro.launch.serve import serve as jserve
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import kvcache as jkv
from repro.models import prefill as jprefill
from repro.models.lm import init_decode_cache as jinit_decode_cache
from repro.models.lm import trunk as jtrunk
from repro_torch.convert import (kv_cache_from_numpy, kv_cache_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch.profile import decode_step_bytes
from repro_torch.launch.serve import ServeConfig, aux_for, serve
from repro_torch.models import decode_step, init_params, prefill, trunk
from repro_torch.models import kvcache as kv
from repro_torch.models import lm
from repro_torch.models.layers import rms_norm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("whisper-medium", "llama-3.2-vision-11b")
FORMATS = ("none", "bf16", "frsz2_16", "frsz2_8")
B, S, CAP = 2, 24, 32
LOGIT_TOL = {"none": 1e-4, "bf16": 1e-3, "frsz2_16": 1e-3, "frsz2_8": 1e-2}
STEP = {"bf16": 2.0 ** -8, "frsz2_16": 2.0 ** -14, "frsz2_8": 2.0 ** -6}
#: the trees a family adds to the dense one
CROSS_TREES = {"whisper-medium": (("encoder",), ("layers", "cross")),
               "llama-3.2-vision-11b": (("cross_layers",),)}


def _cfgs(model, **kw):
    return (dataclasses.replace(jget(model).reduced(), **kw),
            dataclasses.replace(get_arch(model).reduced(), **kw))


@pytest.fixture(scope="module")
def weights():
    """model -> the JAX package's reduced weights and the same on the port,
    each drawn once for the module."""
    drawn = {}

    def get(model):
        if model not in drawn:
            cj, _ = _cfgs(model)
            pj = jinit(cj, jax.random.PRNGKey(0))
            drawn[model] = (pj, params_from_numpy(
                jax.tree.map(np.asarray, pj), device="cpu"))
        return drawn[model]

    return get


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _key(cfg):
    return "frames" if cfg.family == "encdec" else "image_embeds"


def _src(cfg, seed=0, batch=B):
    """Seeded numpy frames or image embeddings, (batch, cross_len, d)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, lm.cross_len(cfg), cfg.d_model))
            * 0.02).astype(np.float32)


def _aux(cfg, src):
    return ({_key(cfg): jnp.asarray(src)},
            {_key(cfg): torch.from_numpy(src)})


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _decoded(c, fmt, hd):
    """A JAX-layout layer-stacked cache (numpy) decoded -> {k, v} f32."""
    if fmt.kind == "raw":
        return {n: np.asarray(jnp.asarray(c[n].view(jnp.bfloat16)
                                          if c[n].dtype == np.uint16
                                          else c[n]), np.float32)
                for n in "kv"}
    return {n: np.asarray(jkv.decode_heads(c[f"{n}_codes"], c[f"{n}_exps"],
                                           fmt, hd)) for n in "kv"}


def _assert_cache_close(got, want, kv_format, hd):
    """Shapes equal, exponents bit-equal, decoded values within two code
    steps (f32: 1e-5 of the largest)."""
    assert set(got) == set(want)
    for n in want:
        assert got[n].shape == want[n].shape, n
        if n.endswith("_exps"):
            assert np.array_equal(got[n], want[n]), n
    fmt = jkv.cache_format(kv_format)
    dg, dw = _decoded(got, fmt, hd), _decoded(want, fmt, hd)
    for n in "kv":
        scale = np.abs(dw[n]).max()
        tol = (1e-5 if kv_format == "none" else 2 * STEP[kv_format]) * scale
        assert np.abs(dg[n] - dw[n]).max() <= tol, (kv_format, n)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_init_params_carry_the_jax_tree(model):
    """The port's random weights have the reference's names, shapes and
    dtypes: the encoder and each decoder layer's cross block (whisper), the
    cross blocks with their own MLPs (the VLM)."""
    cj, ct = _cfgs(model, dtype="bfloat16")
    want = _flat(jax.eval_shape(lambda: jinit(cj, jax.random.PRNGKey(0))))
    p = init_params(ct, torch.Generator().manual_seed(0))
    got = _flat(jax.tree.map(lambda t: np.empty(t.shape, t.dtype),
                             params_to_numpy(p)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, k
        assert (a.dtype == np.float32) == (b.dtype == jnp.float32), k
    for path in CROSS_TREES[model]:
        sub = p
        for k in path:
            sub = sub[k]
        assert sub, path


@pytest.mark.parametrize("model", MODELS)
def test_cross_weights_carry_across(model, weights):
    """The reference's ``encoder``, ``layers.cross`` and ``cross_layers``
    trees carry across with the same names, shapes and bits, in f32 and in
    bf16."""
    pj, pt = weights(model)
    for path in CROSS_TREES[model]:
        sub_j, sub_t = pj, pt
        for k in path:
            sub_j, sub_t = sub_j[k], sub_t[k]
        want = _flat(jax.tree.map(np.asarray, sub_j))
        got = _flat(params_to_numpy(sub_t))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            assert a.shape == b.shape and np.array_equal(a, b), (path, k)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == np.float32 else a,
                      jax.tree.map(np.asarray, pj))
    back = params_to_numpy(params_from_numpy(pb, device="cpu"))
    for (k, a), (_, b) in zip(_flat(pb), _flat(back)):
        assert np.array_equal(a.view(np.uint16) if a.dtype != b.dtype else a,
                              b), k


# ---------------------------------------------------------------------------
# the forward, the prefill and the decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_trunk_matches_jax(model, weights):
    pj, pt = weights(model)
    cj, ct = _cfgs(model)
    toks = np.random.default_rng(1).integers(0, ct.vocab_size, (B, S))
    aj, at = _aux(ct, _src(ct))
    hj, auxj = jtrunk(pj, cj, jnp.asarray(toks), aj)
    ht, auxt = trunk(pt, ct, torch.from_numpy(toks), at)
    assert _rel(ht.numpy(), hj) <= 1e-4
    assert float(auxt) == float(auxj) == 0.0


@pytest.fixture(scope="module")
def ref_prefill(weights):
    """(model, kv_format) -> the tokens (B, S + 2), the source, and the
    reference's prefill of the first S tokens (logits, cache), each run
    once for the module."""
    done = {}

    def get(model, kv_format):
        if (model, kv_format) not in done:
            pj, _ = weights(model)
            cj, ct = _cfgs(model, kv_format=kv_format)
            toks = np.random.default_rng(2).integers(0, ct.vocab_size,
                                                     (B, S + 2))
            src = _src(ct)
            done[model, kv_format] = (toks, src, jprefill(
                pj, cj, jnp.asarray(toks[:, :S]), _aux(ct, src)[0],
                cache_len=CAP))
        return done[model, kv_format]

    return get


@pytest.mark.parametrize("kv_format", FORMATS)
@pytest.mark.parametrize("model", MODELS)
def test_prefill_matches_jax(model, kv_format, weights, ref_prefill):
    """Logits, and the self and cross caches as the reference's prefill
    builds them: the cross cache unpadded (cross_len positions)."""
    _, pt = weights(model)
    _, ct = _cfgs(model, kv_format=kv_format)
    toks, src, (lj, cache_j) = ref_prefill(model, kv_format)
    lt, cache_t = prefill(pt, ct, torch.from_numpy(toks[:, :S]),
                          _aux(ct, src)[1], cache_len=CAP)
    assert _rel(lt.numpy(), lj) < 1e-4
    got, want = kv_cache_to_numpy(cache_t), jax.tree.map(np.asarray, cache_j)
    assert set(got) == set(want) == {"lengths", "self", "cross"}
    assert np.array_equal(got["lengths"], want["lengths"])
    for part in ("self", "cross"):
        _assert_cache_close(got[part], want[part], kv_format, ct.hd)
    n = "k" if kv_format in ("none", "bf16") else "k_codes"
    assert got["cross"][n].shape[:4] == (lm.cross_layers(ct), B,
                                         ct.num_kv_heads, lm.cross_len(ct))


@pytest.mark.parametrize("kv_format", FORMATS)
@pytest.mark.parametrize("model", MODELS)
def test_decode_steps_match_jax(model, kv_format, weights, ref_prefill):
    """Two decode steps from the reference's prefill cache, carried
    across: logits within ``LOGIT_TOL``; the cross caches only read.  (The
    self caches are not compared: the reference's decode writes B
    positions a row, ``repro_torch.models.layers.apply_rope``.)"""
    pj, pt = weights(model)
    cj, ct = _cfgs(model, kv_format=kv_format)
    toks, _, (_, cache_j) = ref_prefill(model, kv_format)
    cache_t = kv_cache_from_numpy(jax.tree.map(np.asarray, cache_j),
                                  device="cpu")
    for t in (S, S + 1):
        lj, cache_j = jdecode(pj, cj, cache_j, jnp.asarray(toks[:, t]))
        lt, cache_t = decode_step(pt, ct, cache_t,
                                  torch.from_numpy(toks[:, t]))
        assert _rel(lt.numpy(), lj) < LOGIT_TOL[kv_format], (kv_format, t)
    got, want = kv_cache_to_numpy(cache_t), jax.tree.map(np.asarray, cache_j)
    assert np.array_equal(got["lengths"], want["lengths"])
    for n, w in want["cross"].items():         # carried across, only read
        if w.dtype == jnp.bfloat16:
            w = w.view(np.uint16)
        assert np.array_equal(got["cross"][n], w), n


@pytest.mark.parametrize("model", MODELS)
def test_decode_from_padded_cache_matches_jax(model, weights, ref_prefill):
    """``init_decode_cache`` allocates the reference's layout: the cross
    cache padded to a multiple of 128 positions; a step reads cross_len of
    them, so a prefill's cache copied into it decodes to the same logits
    as the reference's step from its own padded cache."""
    pj, pt = weights(model)
    cj, ct = _cfgs(model, kv_format="frsz2_16")
    want = jax.tree.map(np.array, jinit_decode_cache(cj, B, CAP))
    got = kv_cache_to_numpy(lm.init_decode_cache(ct, B, CAP))
    for part in ("self", "cross"):
        assert {n: (a.shape, a.dtype) for n, a in got[part].items()} == \
            {n: (a.shape, a.dtype) for n, a in want[part].items()}, part
    assert got["lengths"].shape == want["lengths"].shape
    assert got["cross"]["k_codes"].shape[3] == 128 > lm.cross_len(ct)
    toks, _, (_, filled) = ref_prefill(model, "frsz2_16")
    filled = jax.tree.map(np.asarray, filled)
    Ss = lm.cross_len(ct)
    for n in want["cross"]:
        want["cross"][n][:, :, :, :Ss] = filled["cross"][n]
    want["self"], want["lengths"] = filled["self"], filled["lengths"]
    lj, _ = jdecode(pj, cj, jax.tree.map(jnp.asarray, want),
                    jnp.asarray(toks[:, S]))
    lt, _ = decode_step(pt, ct, kv_cache_from_numpy(want, device="cpu"),
                        torch.from_numpy(toks[:, S]))
    assert _rel(lt.numpy(), lj) < LOGIT_TOL["frsz2_16"]


@pytest.mark.parametrize("model", MODELS)
def test_prefill_cross_cache_round_trips(model, weights):
    """A prefill's ``cache["cross"]`` through ``kv_cache_to_numpy`` and
    ``kv_cache_from_numpy``: the same tensors, bit for bit."""
    _, pt = weights(model)
    _, ct = _cfgs(model, kv_format="frsz2_8")
    toks = torch.randint(0, ct.vocab_size, (B, 8),
                         generator=torch.Generator().manual_seed(0))
    _, cache = prefill(pt, ct, toks, _aux(ct, _src(ct))[1], cache_len=12)
    back = kv_cache_from_numpy(kv_cache_to_numpy(cache), device="cpu")
    assert set(back["cross"]) == set(cache["cross"])
    for n, t in cache["cross"].items():
        assert back["cross"][n].dtype == t.dtype
        assert torch.equal(back["cross"][n], t), n


@pytest.mark.parametrize("kv_format,tol", [("none", 5e-3), ("frsz2_16", 5e-2)])
@pytest.mark.parametrize("model", MODELS)
def test_decode_matches_teacher_forcing(model, kv_format, tol):
    """prefill(S) + decode(token S) logits == the parallel forward over S+1
    tokens with the same source, with the port's own weights."""
    _, cfg = _cfgs(model, kv_format=kv_format)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    n = 32
    tokens = torch.randint(0, cfg.vocab_size, (B, n + 1),
                           generator=torch.Generator().manual_seed(1))
    aux = aux_for(cfg, B, torch.Generator().manual_seed(2))
    h, _ = trunk(params, cfg, tokens, aux)

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).numpy()

    got, cache = prefill(params, cfg, tokens[:, :n], aux, cache_len=n + 4)
    assert _rel(got.numpy(), head(h[:, n - 1])) < tol
    got2, cache = decode_step(params, cfg, cache, tokens[:, n])
    assert _rel(got2.numpy(), head(h[:, n])) < tol
    assert cache["lengths"].tolist() == [n + 1] * B


@pytest.mark.parametrize("model", MODELS)
def test_decode_never_writes_the_cross_cache(model, weights):
    """Decode steps write the self cache in place and leave every cross
    cache as the prefill wrote it, bit for bit."""
    _, pt = weights(model)
    _, ct = _cfgs(model, kv_format="frsz2_16")
    toks = torch.randint(0, ct.vocab_size, (B, S + 3),
                         generator=torch.Generator().manual_seed(3))
    _, cache = prefill(pt, ct, toks[:, :S], _aux(ct, _src(ct))[1],
                       cache_len=CAP)
    cross = {n: t.clone() for n, t in cache["cross"].items()}
    self_ = {n: t.clone() for n, t in cache["self"].items()}
    for t in range(S, S + 3):
        _, cache = decode_step(pt, ct, cache, toks[:, t])
    for n, t in cross.items():
        assert torch.equal(cache["cross"][n], t), n
    assert not torch.equal(cache["self"]["k_codes"], self_["k_codes"])


@pytest.mark.parametrize("model", MODELS)
def test_missing_or_misshapen_source_raises(model, weights):
    """Without its frames / image embeddings, or with another source
    length than the steps read (``cross_len``), the model raises."""
    _, pt = weights(model)
    _, ct = _cfgs(model)
    toks = torch.zeros((B, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match=_key(ct)):
        prefill(pt, ct, toks)
    with pytest.raises(ValueError, match=_key(ct)):
        trunk(pt, ct, toks, {})
    short = {_key(ct): torch.zeros((B, lm.cross_len(ct) - 1, ct.d_model))}
    with pytest.raises(ValueError, match="cross_len"):
        prefill(pt, ct, toks, short)


@pytest.mark.parametrize("model", MODELS)
def test_aux_for_draws_the_reference_layout(model):
    """``serve.aux_for``: the reference's ``_aux_for`` shape and dtype,
    normal x 0.02, the same draw for the same seed."""
    for dtype in ("float32", "bfloat16"):
        cj, ct = _cfgs(model, dtype=dtype)
        want = jaux_for(cj, 3, jax.random.PRNGKey(0))
        got = aux_for(ct, 3, torch.Generator().manual_seed(0))
        assert set(got) == set(want) == {_key(ct)}
        x, w = got[_key(ct)], want[_key(ct)]
        assert tuple(x.shape) == w.shape
        assert str(x.dtype).split(".")[1] == str(w.dtype)
        assert abs(float(x.float().std()) - 0.02) < 0.002
        assert torch.equal(x, aux_for(ct, 3, torch.Generator()
                                      .manual_seed(0))[_key(ct)])
    assert aux_for(get_arch("yi-9b"), 3, torch.Generator()) == {}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


#: ``tests/test_torch_serve.py``'s sizes: whisper keeps 2 decoder layers
#: and 1 encoder layer, the VLM 4 self layers and 2 cross blocks
TINY = {"whisper-medium": dict(num_layers=2, encoder_layers=1, d_model=128,
                               d_ff=256, vocab_size=256, num_heads=2,
                               num_kv_heads=1, head_dim=0),
        "llama-3.2-vision-11b": dict(num_layers=4, d_model=128, d_ff=256,
                                     vocab_size=256, num_heads=2,
                                     num_kv_heads=1, head_dim=0)}
SC = dict(slots=3, prompt_len=16, max_new=8, max_ctx=32)


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 16).astype(np.int32) for _ in range(6)]


def _tiny(model, kv_format):
    return (dataclasses.replace(jget(model).reduced(), kv_format=kv_format,
                                **TINY[model]),
            dataclasses.replace(get_arch(model).reduced(),
                                kv_format=kv_format, **TINY[model]))


@pytest.mark.parametrize("kv_format", ["frsz2_16"])
@pytest.mark.parametrize("model", MODELS)
def test_completions_equal_jax_serve(model, kv_format):
    """The reference's ``serve`` draws its weights and its frames or image
    embeddings from ``PRNGKey(seed)``; the same weights and the same
    ``_aux_for`` arrays are carried across to the port's ``serve``."""
    cj, ct = _tiny(model, kv_format)
    reqs = _requests(ct.vocab_size)
    want = jserve(cj, JServeConfig(**SC), reqs, verbose=False)
    key = jax.random.PRNGKey(0)
    params = params_from_numpy(jax.tree.map(np.asarray, jinit(cj, key)),
                               device="cpu")
    aux = params_from_numpy(jax.tree.map(np.asarray, jaux_for(
        cj, SC["slots"], key)), device="cpu")
    stats = {}
    got = serve(ct, ServeConfig(**SC), reqs, params=params, aux_inputs=aux,
                device="cpu", verbose=False, stats=stats)
    assert got == want
    assert stats["nonfinite_logits"] == 0 and len(stats["step_s"]) == 16


@pytest.mark.parametrize("model", MODELS)
def test_serve_counts_launches_by_phase(model, monkeypatch):
    """With every cache write and decode attention counted as a launch (on
    the CPU the wrappers launch nothing): the prefill writes every self
    layer's cache and every cross cache once and attends nothing; each
    decode step writes the self layers only (``kv_layers``) and attends
    once a self layer and once a cross block (``kv_layers`` +
    ``cross_layers``); no row compress."""
    _, cfg = _tiny(model, "frsz2_16")
    for name, key in (("cache_write", "frsz2_cache_write"),
                      ("decode_attention", "decode_attn")):
        def counted(*args, _f=getattr(ops, name), _k=key, **kw):
            ops.LAUNCHES[_k] += 1
            return _f(*args, **kw)

        monkeypatch.setattr(ops, name, counted)
    stats = {}
    ops.reset_launches()
    serve(cfg, ServeConfig(**SC), _requests(cfg.vocab_size), device="cpu",
          verbose=False, stats=stats)
    R, X, steps = lm.kv_layers(cfg), lm.cross_layers(cfg), len(
        stats["step_s"])
    assert (R, X) == ((2, 2) if cfg.family == "encdec" else (4, 2))
    assert stats["prefill_launches"]["frsz2_cache_write"] == R + X
    assert not stats["prefill_launches"]["decode_attn"]
    assert stats["step_launches"]["frsz2_cache_write"] == R * steps
    assert stats["step_launches"]["decode_attn"] == (R + X) * steps
    assert ops.LAUNCHES["frsz2_compress"] == 0


@pytest.mark.parametrize("model", MODELS)
def test_serve_cli_runs_on_cpu(model):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", model, "--reduced", "--requests", "4", "--prompt-len",
         "8", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "4 decode steps" in proc.stdout and ", cpu)" in proc.stdout
    cfg = get_arch(model).reduced()
    assert (f"kv=frsz2_16, cross kv=frsz2_16 ({lm.cross_layers(cfg)} layers "
            f"x {lm.cross_len(cfg)} positions)") in proc.stdout
    assert "sample completion:" in proc.stdout


@pytest.mark.parametrize("model", MODELS)
def test_decode_step_bytes(model):
    """A step's byte bound: the weights it reads (not the embedding table,
    the encoder or the cross blocks' wk / wv), the self K/V attended and
    every cross cache whole."""
    _, cfg = _cfgs(model, kv_format="frsz2_16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    slots, mean_len = 8, 100.0
    got = decode_step_bytes(cfg, params, slots, mean_len)

    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict)
                   else v.numel() * v.element_size() for v in tree.values())

    cross = (params["layers"]["cross"] if cfg.family == "encdec"
             else params["cross_layers"]["attn"])
    weights = (nbytes(params) - nbytes({"e": params["embed"]})
               - nbytes(params.get("encoder", {}))
               - nbytes({k: cross[k] for k in ("wk", "wv")}))
    fmt = kv.cache_format(cfg.kv_format)
    per_pos = (slots * cfg.num_kv_heads * 2 * cfg.hd
               * fmt.bits_per_value(cfg.hd) / 8)
    assert got["weight_bytes"] == weights
    assert got["state_bytes"] == 0
    assert got["cache_bytes"] == pytest.approx(
        lm.kv_layers(cfg) * mean_len * per_pos)
    assert got["cross_bytes"] == pytest.approx(
        lm.cross_layers(cfg) * lm.cross_len(cfg) * per_pos)
    assert got["bound_ms"] == pytest.approx(
        (weights + got["cache_bytes"] + got["cross_bytes"]) / 3.35e12 * 1e3)
