"""The port's SSM and hybrid families (``repro_torch.models.ssm`` and the
``ssm``/``hybrid`` branches of ``repro_torch.models.lm``) against the JAX
package's, on falcon-mamba-7b ``reduced()`` (f32, 4 Mamba1 layers, d 256,
d_inner 512, N 8) and zamba2-7b ``reduced()`` (f32, 13 Mamba2 layers, d
256, N 8, P 32, the shared attention block after layers 6 and 12 over 2
of 4 heads, hd 64), plus zamba2 at its own head_dim of 112 (2 heads, d
224), with the JAX package's weights carried across.

Tolerances, relative to the largest reference value:
* ``causal_conv``: 1e-6 (the same f32 taps in the same order);
* ``mamba1_seq`` / ``mamba2_seq`` outputs and carried states: 1e-5, at L
  = 32 (two chunks of 16) and at the prime L = 31 (one position a chunk,
  the reference's chunk rule), from zeros and from a carried state; the
  one-step decodes alike.  The port runs the Mamba1 recurrence position
  by position where the reference runs an associative scan, and sums its
  products in another order: f32 roundings apart;
* prefill and decode logits: ``tests/test_torch_models.py``'s limits
  (1e-4 of the largest logit; decode 1e-3 with a frsz2_16 cache, 1e-2 with
  frsz2_8); ``ssm_h`` and ``ssm_conv`` within 1e-5; the hybrid's KV cache
  within two code steps of the decoded values, the same exponents;
* the port's own teacher forcing: ``tests/test_models.py``'s 5e-3
  (``none``) and 5e-2 (``frsz2_16``);
* ``serve``: the same completions, token for token.

The JAX functions run as ``tests/test_models.py`` runs them, on the CPU.
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
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.convert import (kv_cache_from_numpy, kv_cache_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core import frsz2 as F
from repro_torch.kernels import decode_attn as KA
from repro_torch.kernels import ops, ref
from repro_torch.launch.profile import decode_step_bytes
from repro_torch.launch.serve import ServeConfig, serve
from repro_torch.models import decode_step, init_params, prefill, trunk
from repro_torch.models import kvcache as kv
from repro_torch.models import lm, ssm
from repro_torch.models.layers import rms_norm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the models of the file: (arch, config overrides of ``reduced()``)
MODELS = {"falcon-mamba-7b": ("falcon-mamba-7b", {}),
          "zamba2-7b": ("zamba2-7b", {}),
          "zamba2-hd112": ("zamba2-7b", dict(head_dim=112, num_heads=2,
                                             num_kv_heads=2, d_model=224))}
B, S, CAP = 2, 24, 32
LOGIT_TOL = {"none": 1e-4, "bf16": 1e-3, "frsz2_16": 1e-3, "frsz2_8": 1e-2}
STEP = {"bf16": 2.0 ** -8, "frsz2_16": 2.0 ** -14, "frsz2_8": 2.0 ** -6}


def _cfgs(model, **kw):
    arch, over = MODELS[model]
    return (dataclasses.replace(jget(arch).reduced(), **over, **kw),
            dataclasses.replace(get_arch(arch).reduced(), **over, **kw))


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


def _layer0(pj, pt):
    return (jax.tree.map(lambda a: a[0], pj["layers"]),
            {k: v[0] for k, v in pt["layers"].items()})


def _state(cfg, rng):
    """A seeded carried state (h0, conv state) of a layer of ``cfg``."""
    if cfg.family == "ssm":
        hshape = (B, cfg.d_inner, cfg.ssm_state)
    else:
        P = cfg.ssm_head_dim
        hshape = (B, cfg.d_inner // P, P, cfg.ssm_state)
    return (rng.standard_normal(hshape).astype(np.float32),
            rng.standard_normal((B, cfg.ssm_conv - 1, cfg.d_inner))
            .astype(np.float32))


def _seqs(cfg):
    if cfg.family == "ssm":
        return jssm.mamba1_seq, ssm.mamba1_seq
    return jssm.mamba2_seq, ssm.mamba2_seq


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state, rng):
    L, C, W = 9, 48, 4
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    st = (rng.standard_normal((B, W - 1, C)).astype(np.float32)
          if with_state else None)
    oj, sj = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              state=None if st is None else jnp.asarray(st))
    ot, s_t = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b),
                              state=None if st is None else
                              torch.from_numpy(st))
    assert _rel(ot.numpy(), oj) <= 1e-6
    assert np.array_equal(s_t.numpy(), np.asarray(sj))


@pytest.mark.parametrize("L,c", [(32, 16), (31, 1), (1023, 93), (1024, 128),
                                 (2049, 3), (5, 5), (1, 1)])
def test_chunk_rule(L, c):
    """``min(ssm_chunk, L)`` lowered until it divides L: no padding."""
    chunk = 16 if L <= 32 else 128
    assert ssm._chunk(L, chunk) == c


def test_segsum_matches_jax(rng):
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(ssm._segsum(torch.from_numpy(x)).numpy(),
                               np.asarray(jssm._segsum(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L,carried", [(32, False), (32, True), (31, True)])
@pytest.mark.parametrize("model", ["falcon-mamba-7b", "zamba2-7b"])
def test_seq_matches_jax(model, L, carried, weights, rng):
    """One layer over L positions, from zeros or from a carried state; at L
    = 31 each chunk is one position."""
    cj, ct = _cfgs(model)
    lj, lt = _layer0(*weights(model))
    jseq, tseq = _seqs(ct)
    x = rng.standard_normal((B, L, ct.d_model)).astype(np.float32)
    h0, cs = _state(ct, rng) if carried else (None, None)

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(a)

    oj, (hj, cj_) = jseq(jnp.asarray(x), lj, cj, h0=jx(h0),
                         conv_state=jx(cs), return_state=True)
    ot, (ht, c_t) = tseq(torch.from_numpy(x), lt, ct, h0=tx(h0),
                         conv_state=tx(cs), return_state=True)
    assert _rel(ot.numpy(), oj) <= 1e-5
    assert _rel(ht.numpy(), hj) <= 1e-5
    assert _rel(c_t.numpy(), cj_) <= 1e-5
    assert ht.dtype == torch.float32 and c_t.shape == cj_.shape


@pytest.mark.parametrize("model", ["falcon-mamba-7b", "zamba2-7b"])
def test_one_step_decode_matches_jax(model, weights, rng):
    cj, ct = _cfgs(model)
    lj, lt = _layer0(*weights(model))
    x = rng.standard_normal((B, 1, ct.d_model)).astype(np.float32)
    h0, cs = _state(ct, rng)
    if ct.family == "ssm":
        jstep, tstep = jssm.mamba1_decode, ssm.mamba1_decode
    else:
        jstep, tstep = jssm.mamba2_decode, ssm.mamba2_decode
    oj, (hj, cj_) = jstep(jnp.asarray(x), lj, cj,
                          (jnp.asarray(h0), jnp.asarray(cs)))
    ot, (ht, c_t) = tstep(torch.from_numpy(x), lt, ct,
                          (torch.from_numpy(h0), torch.from_numpy(cs)))
    assert _rel(ot.numpy(), oj) <= 1e-5
    assert _rel(ht.numpy(), hj) <= 1e-5
    assert _rel(c_t.numpy(), cj_) <= 1e-5


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_params_carry_the_jax_tree(model, weights):
    """The port's random weights have the reference's names, shapes and
    dtypes (f32 ``dt_bias``, ``A_log`` and ``D``), and its ``A_log`` and
    ``D`` values; the hybrid's shared block is one unstacked block."""
    cj, ct = _cfgs(model, dtype="bfloat16")
    p = init_params(ct, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jinit(cj, jax.random.PRNGKey(0)))
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.empty(t.shape, t.dtype),
                     params_to_numpy(p)))[0]
    wanted = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in got] == [k for k, _ in wanted]
    for (k, a), (_, b) in zip(got, wanted):
        assert a.shape == b.shape, k
        assert (a.dtype == np.float32) == (b.dtype == jnp.float32), k
    pj, _ = weights(model)                # A_log and D are f32 in any model
    for n in ("A_log", "D"):              # log(1..N): the two libraries' log
        np.testing.assert_allclose(p["layers"][n].numpy(),
                                   np.asarray(pj["layers"][n]), rtol=1e-6)
    if ct.family == "hybrid":
        assert p["shared_attn"]["wq"].ndim == 2


@pytest.mark.parametrize("model,kv_format", [
    ("falcon-mamba-7b", "none"), ("zamba2-7b", "none"),
    ("zamba2-7b", "frsz2_16"), ("zamba2-hd112", "frsz2_16"),
    ("zamba2-hd112", "frsz2_8")])
def test_prefill_and_decode_match_jax(model, kv_format, weights, rng):
    """Prefill of S tokens, then two decode steps from the JAX package's
    cache carried across: logits, SSM states and (hybrid) the KV cache."""
    pj, pt = weights(model)
    cj, ct = _cfgs(model, kv_format=kv_format)
    toks = rng.integers(0, ct.vocab_size, (B, S + 2))
    lj, cache_j = jprefill(pj, cj, jnp.asarray(toks[:, :S]), cache_len=CAP)
    lt, cache_t = prefill(pt, ct, torch.from_numpy(toks[:, :S]),
                          cache_len=CAP)
    assert _rel(lt.numpy(), lj) < 1e-4
    got, want = kv_cache_to_numpy(cache_t), jax.tree.map(np.asarray, cache_j)
    assert set(got) == set(want)
    assert np.array_equal(got["lengths"], want["lengths"])
    for n in ("ssm_h", "ssm_conv"):
        assert got[n].shape == want[n].shape and got[n].dtype == want[n].dtype
        assert _rel(got[n], want[n]) <= 1e-5, n
    if ct.family == "hybrid":
        fmt = jkv.cache_format(kv_format)
        for n in want["self"]:
            assert got["self"][n].shape == want["self"][n].shape, n
            if n.endswith("_exps"):
                assert np.array_equal(got["self"][n], want["self"][n]), n
            elif fmt.kind == "raw":
                assert _rel(got["self"][n], want["self"][n]) <= 1e-5, n
        if fmt.kind == "frsz2":
            for n in "kv":
                dg, dw = (np.asarray(jkv.decode_heads(
                    c[f"{n}_codes"], c[f"{n}_exps"], fmt, ct.hd))
                    for c in (got["self"], want["self"]))
                assert (np.abs(dg - dw).max()
                        <= 2 * STEP[kv_format] * np.abs(dw).max()), n
    ct_cache = kv_cache_from_numpy(want, device="cpu")
    for t in (S, S + 1):
        lj, cache_j = jdecode(pj, cj, cache_j, jnp.asarray(toks[:, t]))
        lt, ct_cache = decode_step(pt, ct, ct_cache,
                                   torch.from_numpy(toks[:, t]))
        assert _rel(lt.numpy(), lj) < LOGIT_TOL[kv_format], (kv_format, t)
        for n in ("ssm_h", "ssm_conv"):
            assert _rel(ct_cache[n].numpy(), cache_j[n]) <= 1e-5, (n, t)
    assert np.array_equal(ct_cache["lengths"].numpy(),
                          np.asarray(cache_j["lengths"]))


@pytest.mark.parametrize("kv_format,tol", [("none", 5e-3), ("frsz2_16", 5e-2)])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_decode_matches_teacher_forcing(model, kv_format, tol):
    """prefill(S) + decode(token S) logits == the parallel forward over S+1
    tokens, with the port's own weights; the decode step updates the SSM
    states in place (the tensors of the cache it was given)."""
    _, cfg = _cfgs(model, kv_format=kv_format)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    n = 32
    tokens = torch.randint(0, cfg.vocab_size, (B, n + 1),
                           generator=torch.Generator().manual_seed(1))
    h, aux = trunk(params, cfg, tokens)
    assert float(aux) == 0.0

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).numpy()

    got, cache = prefill(params, cfg, tokens[:, :n], cache_len=n + 4)
    assert _rel(got.numpy(), head(h[:, n - 1])) < tol
    states = {k: cache[k] for k in ("ssm_h", "ssm_conv")}
    before = {k: v.clone() for k, v in states.items()}
    got2, cache2 = decode_step(params, cfg, cache, tokens[:, n])
    assert _rel(got2.numpy(), head(h[:, n])) < tol
    assert cache2["lengths"].tolist() == [n + 1] * B
    for k, t in states.items():
        assert cache2[k] is t and not torch.equal(t, before[k]), k


@pytest.mark.parametrize("model", sorted(MODELS))
def test_decode_cache_layout(model):
    """``init_decode_cache`` holds what ``prefill`` fills: the SSM states
    for every layer, and (hybrid) one KV layer an application of the shared
    block."""
    _, cfg = _cfgs(model)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((B, 8), dtype=torch.int64)
    _, filled = prefill(params, cfg, tokens, cache_len=12)
    empty = lm.init_decode_cache(cfg, B, 12)
    assert set(empty) == set(filled)
    for k, v in empty.items():
        if isinstance(v, dict):
            assert {n: t.shape for n, t in v.items()} == {
                n: t.shape for n, t in filled[k].items()}
            assert v["k_codes"].shape[0] == lm.kv_layers(cfg) == 2
        else:
            assert v.shape == filled[k].shape and v.dtype == filled[k].dtype
    assert lm.kv_layers(cfg) == (0 if cfg.family == "ssm" else 2)


#: ``tests/test_torch_serve.py``'s sizes; zamba2 keeps one application of
#: its shared block (7 layers: 6 and a tail of 1)
TINY = {"falcon-mamba-7b": dict(num_layers=2, d_model=128, vocab_size=256),
        "zamba2-7b": dict(num_layers=7, d_model=128, d_ff=256,
                          vocab_size=256, num_heads=2, num_kv_heads=1,
                          head_dim=0)}


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 16).astype(np.int32) for _ in range(6)]


@pytest.mark.parametrize("arch,kv_format", [("falcon-mamba-7b", "none"),
                                            ("zamba2-7b", "frsz2_16")])
def test_completions_equal_jax_serve(arch, kv_format):
    cj = dataclasses.replace(jget(arch).reduced(), kv_format=kv_format,
                             **TINY[arch])
    ct = dataclasses.replace(get_arch(arch).reduced(), kv_format=kv_format,
                             **TINY[arch])
    reqs = _requests(ct.vocab_size)
    sc = dict(slots=3, prompt_len=16, max_new=8, max_ctx=32)
    want = jserve(cj, JServeConfig(**sc), reqs, verbose=False)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jinit(cj, jax.random.PRNGKey(0))),
        device="cpu")
    stats = {}
    got = serve(ct, ServeConfig(**sc), reqs, params=params, device="cpu",
                verbose=False, stats=stats)
    assert got == want
    assert stats["nonfinite_logits"] == 0 and len(stats["step_s"]) == 16


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_serve_counts_launches_by_phase(arch, monkeypatch):
    """With every cache write and decode attention counted as a launch (on
    the CPU the wrappers launch nothing): zamba2 writes its cache once an
    application of the shared block in the prefill and in each decode
    step, and attends once an application a step; falcon-mamba has no
    stream for the codec and counts nothing."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), kv_format="frsz2_16",
                              **TINY[arch])
    for name, key in (("cache_write", "frsz2_cache_write"),
                      ("decode_attention", "decode_attn")):
        def counted(*args, _f=getattr(ops, name), _k=key, **kw):
            ops.LAUNCHES[_k] += 1
            return _f(*args, **kw)

        monkeypatch.setattr(ops, name, counted)
    stats = {}
    ops.reset_launches()
    serve(cfg, ServeConfig(slots=3, prompt_len=16, max_new=8, max_ctx=32),
          _requests(cfg.vocab_size), device="cpu", verbose=False,
          stats=stats)
    R, steps = lm.kv_layers(cfg), len(stats["step_s"])
    assert R == (1 if cfg.family == "hybrid" else 0)
    assert stats["prefill_launches"]["frsz2_cache_write"] == R
    assert stats["step_launches"]["frsz2_cache_write"] == R * steps
    assert stats["step_launches"]["decode_attn"] == R * steps
    assert not stats["prefill_launches"]["decode_attn"]
    assert ops.LAUNCHES["frsz2_compress"] == 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_serve_cli_runs_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--reduced", "--requests", "4", "--prompt-len",
         "8", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "4 decode steps" in proc.stdout and ", cpu)" in proc.stdout
    assert ("kv=no cache" in proc.stdout) == (arch == "falcon-mamba-7b")
    assert "sample completion:" in proc.stdout


# ---------------------------------------------------------------------------
# kernel 9 at zamba2's head_dim, and the step's byte bound
# ---------------------------------------------------------------------------


def _coded(rng, Bq, Hkv, G, S_, D, l):
    spec = F.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest",
                      exp_dtype=torch.uint8)
    k, v = (F.compress(torch.from_numpy(rng.standard_normal(
        (Bq, Hkv, S_, D)).astype(np.float32)), spec) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((Bq, Hkv * G, D))
                         .astype(np.float32))
    return q, k, v, torch.tensor([3, S_], dtype=torch.int32)


def test_decode_attention_kernel_route_at_head_dim_112(monkeypatch, rng):
    """bs = D = 112 does not divide 128, so it lies outside
    ``kernel_supported``; decode attention routes by device alone, so a
    CUDA call (the route forced here on CPU tensors) goes to the kernel,
    with the one exponent a row mapped to every column, and is counted;
    the plain version does not run."""
    q, k, v, lengths = _coded(rng, 2, 2, 2, 70, 112, 16)
    assert not ops.kernel_supported(k.spec)
    calls = []
    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(KA, "resident_blocks", lambda *a: 3 * 132)
    monkeypatch.setattr(KA, "build", type("B", (), {
        "bind": staticmethod(lambda *a: lambda *args: calls.append(args)
                             or 0),
        "check": staticmethod(lambda rc, what: None),
        "stream": staticmethod(lambda: 0)}))
    monkeypatch.setattr(ref, "decode_attn_ref", None)
    ops.reset_launches()
    out = ops.decode_attention(q, k, v, lengths)
    assert out.shape == q.shape and ops.LAUNCHES["decode_attn"] == 1
    (args,) = calls
    D, nbd, shift = args[13], args[14], args[15]
    assert (D, nbd) == (112, 1) and KA.exp_shift(112) == shift == 7
    assert all(d >> shift == 0 for d in range(D))
    assert KA.exp_shift(128) == 7 and KA.exp_shift(64) == 6


@pytest.mark.parametrize("D,bs", [(96, 96), (224, 112), (112, 56)])
def test_decode_attention_kernel_route_raises_outside_kernel(monkeypatch, rng,
                                                             D, bs):
    """A shape the kernel lacks raises on the kernel route before anything
    is built or launched: D = 96, D = 224, and a block size that is no power
    of two with several blocks a row.  The plain version never runs in its
    place."""
    q, k, v, lengths = _coded(rng, 2, 1, 1, 20, D, 16)
    if bs != D:
        spec = F.FrszSpec(bs=bs, l=16, dtype=torch.float32,
                          rounding="nearest", exp_dtype=torch.uint8)
        k, v = (F.compress(ops.decompress(x), spec) for x in (k, v))
    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(ref, "decode_attn_ref", None)
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="no kernel"):
        ops.decode_attention(q, k, v, lengths)
    assert ops.LAUNCHES["decode_attn"] == 0


@pytest.mark.parametrize("model", sorted(MODELS))
def test_decode_step_bytes(model):
    """A step's byte bound counts every weight but the embedding table
    once, the hybrid's shared block once an application, the SSM states
    read and written, and the K/V positions attended."""
    _, cfg = _cfgs(model, kv_format="frsz2_16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    slots, mean_len = 8, 100.0
    got = decode_step_bytes(cfg, params, slots, mean_len)

    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict)
                   else v.numel() * v.element_size() for v in tree.values())

    R = lm.kv_layers(cfg)
    shared = nbytes({k: params[k] for k in ("shared_attn", "shared_mlp")
                     if k in params})
    weights = (nbytes(params) - nbytes({"e": params["embed"]})
               + max(R - 1, 0) * shared)
    state = lm.init_decode_cache(cfg, slots, 1)
    sbytes = 2 * sum(state[k].numel() * state[k].element_size()
                     for k in ("ssm_h", "ssm_conv"))
    fmt = kv.cache_format(cfg.kv_format)
    cache = (R * slots * cfg.num_kv_heads * mean_len * 2 * cfg.hd
             * fmt.bits_per_value(cfg.hd) / 8)
    assert got["weight_bytes"] == weights
    assert got["state_bytes"] == sbytes
    assert got["cache_bytes"] == pytest.approx(cache)
    assert got["bound_ms"] == pytest.approx(
        (weights + sbytes + cache) / 3.35e12 * 1e3)
