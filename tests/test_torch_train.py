"""The port's training path against the JAX package's: ``lm.loss_fn`` and
its gradients for every family, ``launch.train`` and its CLI (the
reference runs with x64 off, as its training does; its microbatched step
does not run with x64 on: its scan's f32 loss carry meets an f64 loss).

Tolerances:
* loss: 1e-5 relative; every gradient leaf: max |diff| <= 1e-4 x max
  |reference gradient| (the same f32 forward and backward, products and
  sums in another order), at ``reduced()`` with the reference's weights,
  the loss in chunks of 8 positions (4 a sequence, as at S 4,096 with the
  default 1,024), remat on and remat off; the port's two runs bit-equal to
  each other (recomputation repeats the forward's bits);
* the serving path unchanged by the autograd repairs: prefill and decode
  steps of the SSM families bit-equal to the scans as they were before
  (kept here as ``_mamba1_seq_serving`` and ``_mamba2_seq_serving``);
* ``train``: 4 steps of yi-9b ``reduced()`` with coded moments, microbatch
  1 and 2, the losses within 1e-4 relative of the reference's ``train``;
* the CLI on the CPU: a run to step 4 with a checkpoint every 2, then a
  run to step 6 that resumes at 4, its steps equal to an uninterrupted
  run's (the same arithmetic on the same restored bits).
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from repro.configs import get_arch as jget
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import train as jtrain
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.optim import AdamWConfig as JAdamW
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import decode_step, lm, prefill
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import rms_norm
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCHS = ("yi-9b", "mixtral-8x22b", "falcon-mamba-7b", "zamba2-7b",
         "whisper-medium", "llama-3.2-vision-11b")
B, S = 2, 32
#: the loss's sequence chunk in the gradient checks: several chunks a row
VOCAB_CHUNK = 8


def _aux(cfg, rng, batch):
    if cfg.family not in ("encdec", "vlm"):
        return {}
    n = cfg.encoder_seq if cfg.family == "encdec" else cfg.num_image_tokens
    key = "frames" if cfg.family == "encdec" else "image_embeds"
    return {key: (rng.standard_normal((batch, n, cfg.d_model)) * 0.02)
            .astype(np.float32)}


def _family(arch):
    """The reduced configs (reference, port), the reference's weights and
    one batch of the family."""
    cj, ct = jget(arch).reduced(), get_arch(arch).reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cj.vocab_size, (B, S + 1))
             .astype(np.int32), **_aux(cj, rng, B)}
    with jax.enable_x64(False):
        pj = jinit(cj, jax.random.PRNGKey(0))
    return cj, ct, pj, batch


def _jax_loss_and_grads(pj, cj, batch):
    with jax.enable_x64(False):
        lj, gj = jax.jit(jax.value_and_grad(
            lambda p, b: jloss(p, cj, b, vocab_chunk=VOCAB_CHUNK)))(
                pj, jax.tree.map(jnp.asarray, batch))
        return float(lj), jax.tree.map(np.asarray, gj)


def _port_loss_and_grads(pt, ct, tb):
    # ``value_and_grad``'s steps, with the loss's chunk set
    live = tree_map(lambda p: p.detach().requires_grad_(), pt)
    lt = lm.loss_fn(live, ct, tb, vocab_chunk=VOCAB_CHUNK)
    leaves = tree_leaves(live)
    gs = dict(zip(map(id, leaves), torch.autograd.grad(lt, leaves)))
    return float(lt.detach()), params_to_numpy(
        tree_map(lambda p: gs[id(p)], live))


@pytest.fixture(scope="module")
def grads():
    """Per family and remat setting (on, off, and on under ``"dots"``):
    the reference's loss and gradients, and the port's, from the
    reference's weights on one batch."""
    out = {}

    def get(arch, settings=(True, False)):
        key = (arch, settings)
        if key in out:
            return out[key]
        cj, ct, pj, batch = _family(arch)
        pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        ref, port = {}, {}
        for remat in settings:
            over = (dict(remat=True, remat_policy="dots") if remat == "dots"
                    else dict(remat=remat))
            ref[remat] = _jax_loss_and_grads(
                pj, dataclasses.replace(cj, **over), batch)
            port[remat] = _port_loss_and_grads(
                pt, dataclasses.replace(ct, **over), tb)
        out[key] = (ref, port)
        return out[key]

    return get


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(grads, arch, remat):
    ref, port = grads(arch)
    lj, gj = ref[remat]
    lt, gt = port[remat]
    assert abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    flat_t = jax.tree.leaves(gt)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_repeats_the_forward_bits(grads, arch):
    _, port = grads(arch)
    assert port[True][0] == port[False][0]
    for a, b in zip(jax.tree.leaves(port[True][1]),
                    jax.tree.leaves(port[False][1])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_remat_loss_and_grads_match_jax(grads, arch):
    """``remat_policy="dots"`` on both sides: the reference checkpoints with
    ``dots_with_no_batch_dims_saveable``, the port with
    ``layers.dots_saveable``; the same tolerances as full remat."""
    ref, port = grads(arch, ("dots",))
    lj, gj = ref["dots"]
    lt, gt = port["dots"]
    assert abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    flat_t = jax.tree.leaves(gt)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        assert a.shape == b.shape, path
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_remat_repeats_the_forward_bits(grads, arch):
    """A kept product is the forward's own output and a recomputed one
    repeats the forward's bits: "dots" gives no remat's loss and
    gradients bit for bit."""
    _, plain = grads(arch)
    _, dots = grads(arch, ("dots",))
    assert dots["dots"][0] == plain[False][0]
    for a, b in zip(jax.tree.leaves(dots["dots"][1]),
                    jax.tree.leaves(plain[False][1])):
        assert np.array_equal(a, b)


def _jax_saved_products(cj, pj, x):
    """The non-argument residuals ``jax.ad_checkpoint.print_saved_residuals``
    reports for one layer of the reference's stack under ``"dots"``, as
    (dtype, size, last dim)."""
    import contextlib
    import io
    import re

    import jax.ad_checkpoint

    from repro.models import lm as jlm

    pos = jnp.arange(x.shape[1])
    body = (jlm._moe_body if cj.family == "moe" else jlm._dense_body)(
        cj, pos, cj.window)
    f = jax.checkpoint(
        body, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    lp = jax.tree.map(lambda a: a[0], pj["layers"])
    buf = io.StringIO()
    with jax.enable_x64(False), contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(f, jnp.asarray(x), lp)
    out = []
    for line in buf.getvalue().splitlines():
        if "from the argument" in line or "from a constant" in line:
            continue
        dt, dims = re.match(r"(\w+)\[([\d,]*)\]", line).groups()
        shape = [int(d) for d in dims.split(",") if d]
        out.append((dt, math.prod(shape), shape[-1]))
    return out


def _port_saved(monkeypatch, ct, pt, x, policy):
    """One layer of the port's stack under ``remat_policy=policy`` (or
    none): the outputs ``layers.dots_saveable`` keeps, in forward order,
    as (dtype, size, last dim), and the bytes that autograd saves outside
    the remat regions apart from the layer's arguments (read through
    ``torch.autograd.graph.saved_tensors_hooks``) plus the kept outputs."""
    from repro_torch.models import layers

    kept = []
    orig = layers.dots_saveable

    def recording(ctx, op, *args, **kwargs):
        got = orig(ctx, op, *args, **kwargs)
        if got.name == "MUST_SAVE" and not ctx.is_recompute:
            o = ctx.op_output
            kept.append((str(o.dtype).replace("torch.", "")
                         .replace("float32", "f32"), o.numel(), o.shape[-1],
                         o.numel() * o.element_size()))
        return got

    monkeypatch.setattr(layers, "dots_saveable", recording)
    lp = lm._layer(pt["layers"], 0)
    args = {t.untyped_storage().data_ptr()
            for t in tree_leaves(lp) + [x]}
    saved = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in args:
            saved[ptr] = t.untyped_storage().nbytes()
        return t

    cfg = (dataclasses.replace(ct, remat=False) if policy is None else
           dataclasses.replace(ct, remat=True, remat_policy=policy))
    pos = torch.arange(x.shape[1])

    def body(h):
        h = layers.attention_block(h, lp["attn"], cfg, positions=pos,
                                   window=cfg.window)
        return lm._ffn(h, lp, cfg)

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, aux = layers.remat(cfg, body, x)
    (out.square().sum() + (0 if aux is None else aux)).backward()
    return kept, sum(saved.values()) + sum(k[3] for k in kept)


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b"])
def test_dots_saves_the_products_the_reference_saves(monkeypatch, arch):
    """The products kept under ``"dots"`` for one layer: the reference's
    non-argument residuals (the q/k/v and output projections, the gate and
    up projections or the router), by dtype and size.  One more in the
    dense layer: the MLP's down projection, the region's last product,
    whose output only the residual add reads.  torch's selective
    checkpoint decides at the op, before any later op reads the output;
    JAX keeps only what the backward reads."""
    cj, ct, pj, _ = _family(arch)
    x = (np.random.default_rng(1).standard_normal((B, S, cj.d_model))
         * 0.1).astype(np.float32)
    want = _jax_saved_products(cj, pj, x)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    kept, _ = _port_saved(monkeypatch, ct, pt, xt, "dots")
    got = [k[:3] for k in kept]
    if cj.family == "dense":
        assert got[-1] == ("f32", B * S * cj.d_model, cj.d_model)
        got = got[:-1]
    assert sorted(got) == sorted(want) and len(want) >= 5


def test_saved_bytes_full_below_dots_below_no_remat(monkeypatch):
    """One dense layer's saved activations: full remat keeps none, "dots"
    the products, no remat every saved tensor."""
    cj, ct, pj, _ = _family("yi-9b")
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    x = (np.random.default_rng(1).standard_normal((B, S, cj.d_model))
         * 0.1).astype(np.float32)
    got = {}
    for policy in ("full", "dots", None):
        xt = torch.from_numpy(x).requires_grad_()
        got[policy] = _port_saved(monkeypatch, ct, pt, xt, policy)[1]
    assert got["full"] < got["dots"] < got[None], got


def test_layers_unbinds_each_stack_once():
    """``lm._layers`` hands out views of the stacked weights, one ``unbind``
    a leaf (one ``stack`` in the backward), and the gradient through them
    equals the gradient through per-layer selects."""
    w = torch.randn((4, 3, 5), requires_grad=True)
    stacked = {"a": {"w": w}, "b": w * 2}
    layers = lm._layers(stacked)
    assert len(layers) == 4
    assert layers[2]["a"]["w"].data_ptr() == w[2].data_ptr()
    loss = sum((lp["a"]["w"] * (i + 1)).sum() + lp["b"].square().sum()
               for i, lp in enumerate(layers))
    (g,) = torch.autograd.grad(loss, w)
    loss2 = sum((w[i] * (i + 1)).sum() + (w * 2)[i].square().sum()
                for i in range(4))
    (g2,) = torch.autograd.grad(loss2, w)
    assert torch.equal(g, g2)
    assert layers[0]["a"]["w"].grad_fn.name().startswith("Unbind")


# ---------------------------------------------------------------------------
# the serving scans as they were before the autograd repair (in-place
# recurrence, chunk loop inline), held bit for bit against the new ones
# ---------------------------------------------------------------------------


def _mamba1_seq_serving(x, p, cfg, *, h0=None, conv_state=None,
                        return_state=False):
    B_, L, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, d // 16)
    h = rms_norm(x, p["ln"])
    xi, z = (h @ p["in_proj"]).chunk(2, dim=-1)
    xi, conv_state = ssm_mod.causal_conv(xi, p["conv_w"], p["conv_b"],
                                         state=conv_state)
    xi = Fn.silu(xi)
    dt_r, Bm, Cm = (xi @ p["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = ssm_mod._softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    c = ssm_mod._chunk(L, cfg.ssm_chunk)
    hprev = (torch.zeros((B_, di, N), dtype=torch.float32) if h0 is None
             else h0)
    ys = []
    for s in range(0, L, c):
        dtc = dt[:, s:s + c].to(torch.float32)
        a = torch.exp(dtc[..., None] * A)
        hs = ((dtc * xi[:, s:s + c].to(torch.float32))[..., None]
              * Bm[:, s:s + c, None, :].to(torch.float32))
        for t in range(c):
            hs[:, t].addcmul_(a[:, t], hprev)
            hprev = hs[:, t]
        ys.append(torch.einsum("bcdn,bcn->bcd", hs,
                               Cm[:, s:s + c].to(torch.float32)))
    hlast = hprev.clone()
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xi.to(torch.float32) * p["D"].to(torch.float32)
    y = y * Fn.silu(z.to(torch.float32))
    out = x + (y.to(x.dtype) @ p["out_proj"])
    if return_state:
        return out, (hlast, conv_state)
    return out


def _mamba2_seq_serving(x, p, cfg, *, h0=None, conv_state=None,
                        return_state=False):
    f32 = torch.float32
    B_, L, d = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    Hs = di // P
    h = rms_norm(x, p["ln"])
    z, xi, Bm, Cm, dt_r = (h @ p["in_proj"]).split([di, di, N, N, Hs],
                                                   dim=-1)
    xi, conv_state = ssm_mod.causal_conv(xi, p["conv_w"], p["conv_b"],
                                         state=conv_state)
    xi = Fn.silu(xi)
    dt = ssm_mod._softplus(dt_r.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))
    loga = dt * A
    c = ssm_mod._chunk(L, cfg.ssm_chunk)
    hprev = torch.zeros((B_, Hs, P, N), dtype=f32) if h0 is None else h0
    ys = []
    for s in range(0, L, c):
        xk = xi[:, s:s + c].reshape(B_, c, Hs, P)
        dk, lak = dt[:, s:s + c], loga[:, s:s + c]
        Bk, Ck = Bm[:, s:s + c].to(f32), Cm[:, s:s + c].to(f32)
        Lmat = torch.exp(ssm_mod._segsum(lak.transpose(1, 2)))
        scores = torch.einsum("bin,bjn->bij", Ck, Bk)
        M = scores[:, None] * Lmat
        xdt = xk.to(f32) * dk[..., None]
        y_intra = torch.einsum("bhij,bjhp->bihp", M, xdt)
        pref = torch.exp(torch.cumsum(lak, dim=1))
        y_inter = (torch.einsum("bin,bhpn->bihp", Ck, hprev)
                   * pref[..., None])
        total = pref[:, -1]
        suff = total[:, None] / torch.clamp(pref, min=1e-37)
        hprev = (total[..., None, None] * hprev
                 + torch.einsum("bin,bihp->bhpn", Bk,
                                xdt * suff[..., None]))
        ys.append(y_intra + y_inter)
    y = (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]).reshape(B_, L, di)
    y = y + xi.to(f32) * p["D"].to(f32).repeat_interleave(P)
    y = rms_norm(y.to(x.dtype), p["out_ln"]) * Fn.silu(z)
    out = x + y.to(x.dtype) @ p["out_proj"]
    if return_state:
        return out, (hprev, conv_state)
    return out


def _serve_run(params, cfg, tokens, S0):
    logits, cache = prefill(params, cfg, tokens[:, :S0],
                            cache_len=tokens.shape[1])
    outs = [logits]
    for t in range(S0, tokens.shape[1]):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t])
        outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("S0", [31, 48])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_serving_bit_equal_to_the_scans_before_the_repair(monkeypatch,
                                                              arch, S0):
    """31: one position a chunk (a prime length); 48: three chunks of 16."""
    cfg = get_arch(arch).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, S0 + 2),
                           generator=torch.Generator().manual_seed(1))
    new, cache_new = _serve_run(params, cfg, tokens, S0)
    monkeypatch.setattr(ssm_mod, "mamba1_seq", _mamba1_seq_serving)
    monkeypatch.setattr(ssm_mod, "mamba2_seq", _mamba2_seq_serving)
    old, cache_old = _serve_run(params, cfg, tokens, S0)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    for k in ("ssm_h", "ssm_conv"):
        assert torch.equal(cache_new[k], cache_old[k]), k


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_matches_reference_train(tmp_path, microbatch):
    kw = dict(peak_lr=3e-4, warmup_steps=5, decay_steps=4,
              compress_state=True)
    tkw = dict(steps=4, global_batch=2, seq_len=64, ckpt_every=0,
               microbatch=microbatch)
    cj = jget("yi-9b").reduced()
    with jax.enable_x64(False):
        pj = jinit(cj, jax.random.PRNGKey(0))
        _, hj = jtrain(cj, JAdamW(**kw), JTrainConfig(
            **tkw, ckpt_dir=str(tmp_path / "ref")), verbose=False)
    _, ht = train(get_arch("yi-9b").reduced(), AdamWConfig(**kw),
                  TrainConfig(**tkw, ckpt_dir=str(tmp_path / "port")),
                  params=params_from_numpy(jax.tree.map(np.asarray, pj),
                                           device="cpu"),
                  device="cpu", verbose=False)
    assert [h["step"] for h in ht] == [h["step"] for h in hj] == [0, 1, 2, 3]
    for a, b in zip(ht, hj):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), (a, b)
        assert abs(a["lr"] - b["lr"]) <= 1e-7 * b["lr"]
        assert np.isfinite(a["grad_norm"])


def test_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    common = ["--arch", "yi-9b", "--reduced", "--device", "cpu", "--batch",
              "2", "--seq", "64", "--ckpt-every", "2", "--compress-opt-state"]
    ck = str(tmp_path / "ck")
    train_mod.main(common + ["--steps", "4", "--ckpt-dir", ck,
                             "--history-json", str(tmp_path / "a.json")])
    assert latest_step(ck) == 4
    train_mod.main(common + ["--steps", "6", "--ckpt-dir", ck,
                             "--history-json", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert latest_step(ck) == 6
    a, b = (json.load(open(tmp_path / f)) for f in ("a.json", "b.json"))
    assert [h["step"] for h in a] == [0, 1, 2, 3]
    assert [h["step"] for h in b] == [4, 5]
    # an uninterrupted run to step 6 (the schedule of --steps 6)
    train_mod.main(common + ["--steps", "6", "--ckpt-dir",
                             str(tmp_path / "whole"), "--history-json",
                             str(tmp_path / "w.json")])
    w = json.load(open(tmp_path / "w.json"))
    # steps 0-4 share one learning rate in both schedules (warmup), so the
    # resumed steps repeat the uninterrupted run's bits
    assert [h["loss"] for h in a] == [h["loss"] for h in w[:4]]
    assert [h["loss"] for h in b] == [h["loss"] for h in w[4:]]
    cfg = get_arch("yi-9b").reduced()
    like = {"params": lm.init_params(cfg, torch.Generator().manual_seed(1)),
            "opt": train_mod.adamw_init(
                lm.init_params(cfg, torch.Generator().manual_seed(1)),
                AdamWConfig(compress_state=True))}
    _, got = restore(ck, like)
    _, whole = restore(str(tmp_path / "whole"), like)
    for x, y in zip(tree_leaves(got), tree_leaves(whole)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert torch.equal(x.codes, y.codes)
            assert torch.equal(x.exps, y.exps)
