"""The port's AdamW (``repro_torch.optim``) against the JAX package's, plain
and with FRSZ2-coded moments, on the same numpy weights, gradients and
state (the reference runs with x64 off, as its training does).

Tolerances (max |diff| over max |reference|, a leaf at a time):
* plain: params, m and v within 1e-6 after one and after three updates
  (f32 arithmetic in the same order; the global norm's sum runs in another
  order, so where the clip acts its scale differs in the last bits);
* coded: the port's coded step is its plain step's f32 moments coded by
  the plain codec, bit for bit; against the reference, codes differ only
  in blocks where the two packages' f32 moments differ, by at most one
  code step, in fewer than 1 % of the codes (the count is asserted and
  printed), and decode within one quantum of the block;
* ``lr_at``: 1e-7 relative at step 0, the end of warmup and the end of
  decay.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro.optim import AdamWConfig as JConfig
from repro.optim import adamw_init as jinit
from repro.optim import adamw_update as jupdate
from repro.optim import lr_at as jlr
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core import frsz2 as F
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, lr_at

torch.set_num_threads(2)

#: a stacked (L, d) norm scale, a vector, a ragged matrix and a stacked
#: (L, d, ff) weight: leaf sizes that are and are not multiples of 128
SHAPES = {"embed": (64, 48), "ln": (3, 48), "b": (48,), "w": (3, 48, 70)}
KW = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)


def _tree(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(rng, n, clip_active):
    """n gradient trees: global norm ~ 4.6 (the clip acts) or ~ 0.46 (it
    does not, so the scale is exactly 1 in both packages)."""
    scale = 4e-2 if clip_active else 4e-3
    return [_tree(rng, scale) for _ in range(n)]


def _jax_run(params, grads, cfg):
    with jax.enable_x64(False):
        p = jax.tree.map(jnp.asarray, params)
        st = jinit(p, cfg)
        stats = None
        for g in grads:
            p, st, stats = jupdate(jax.tree.map(jnp.asarray, g), st, p, cfg)
        return (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, st),
                stats)


def _port_run(params, grads, cfg):
    p = params_from_numpy(params, device="cpu")
    st = adamw_init(p, cfg)
    stats = None
    for g in grads:
        p, st, stats = adamw_update(params_from_numpy(g, device="cpu"), st, p,
                                    cfg)
    return p, st, stats


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("clip_active", [False, True])
@pytest.mark.parametrize("updates", [1, 3])
def test_plain_adamw_matches_jax(updates, clip_active):
    rng = np.random.default_rng(updates)
    params, grads = _tree(rng, 1.0), _grads(rng, updates, clip_active)
    pj, sj, stj = _jax_run(params, grads, JConfig(**KW))
    pt, st, stt = _port_run(params, grads, AdamWConfig(**KW))
    got = params_to_numpy(pt)
    for k in SHAPES:
        assert _rel(got[k], pj[k]) <= 1e-6, k
        assert _rel(st["m"][k].numpy(), sj["m"][k]) <= 1e-6, k
        assert _rel(st["v"][k].numpy(), sj["v"][k]) <= 1e-6, k
        if not clip_active:
            assert np.array_equal(st["m"][k].numpy(), sj["m"][k]), k
    assert int(st["step"]) == int(sj["step"]) == updates
    assert st["step"].device.type == "cpu"
    assert abs(float(stt["grad_norm"]) - float(stj["grad_norm"])) <= \
        1e-6 * float(stj["grad_norm"])
    assert float(stt["lr"]) == float(stj["lr"])


def _one_step_from(state_j, params, g, comp):
    """One update of each package from the same coded state (carried
    across bit for bit) and the same weights and gradients."""
    with jax.enable_x64(False):
        pj, sj, _ = jupdate(jax.tree.map(jnp.asarray, g),
                            jax.tree.map(jnp.asarray, state_j),
                            jax.tree.map(jnp.asarray, params),
                            JConfig(**KW, compress_state=comp))
    st = opt_state_from_numpy(state_j, device="cpu")
    pt, st, _ = adamw_update(params_from_numpy(g, device="cpu"), st,
                             params_from_numpy(params, device="cpu"),
                             AdamWConfig(**KW, compress_state=comp))
    return jax.tree.map(np.asarray, sj), st


@pytest.mark.parametrize("updates", [1, 3])
def test_coded_adamw_matches_jax(updates):
    rng = np.random.default_rng(10 + updates)
    params, grads = _tree(rng, 1.0), _grads(rng, updates, True)
    cj = JConfig(**KW, compress_state=True)
    ct = AdamWConfig(**KW, compress_state=True)
    # the whole run of each package: weights within 1e-6, moments within
    # a few quanta (a code a step off feeds the next step)
    pj_all, sj_all, _ = _jax_run(params, grads, cj)
    pt_all, st_all, _ = _port_run(params, grads, ct)
    for k in SHAPES:
        assert _rel(pt_all[k].numpy(), pj_all[k]) <= 1e-6, k
        for part in "mv":
            want = np.asarray(JF.decompress(jax.tree.map(
                jnp.asarray, sj_all[part][k])))
            got = F.decompress(st_all[part][k]).numpy()
            assert _rel(got, want) <= 4 * 2.0 ** -14, (part, k)
    # the last update from the reference's state after updates - 1
    pj, sj, _ = _jax_run(params, grads[:-1], cj)
    # the last update from the reference's state, in both packages, coded
    # and plain (on the decoded moments): the f32 moments each package codes
    dec = {part: {k: np.asarray(JF.decompress(jax.tree.map(jnp.asarray,
                                                           sj[part][k])))
                  .reshape(SHAPES[k]) for k in SHAPES} for part in "mv"}
    plain_j = dict(sj, m=dec["m"], v=dec["v"])
    last = grads[-1]
    state_params = params if updates == 1 else jax.tree.map(np.asarray, pj)
    cj_state, ct_state = _one_step_from(sj, state_params, last, True)
    fj, ft = _one_step_from(plain_j, state_params, last, False)
    diffs = total = 0
    for part in "mv":
        for k in SHAPES:
            bt, bj = ct_state[part][k], cj_state[part][k]
            # the port's coded step = its plain step's moments, coded
            want = F.compress(ft[part][k].reshape(-1), ct.state_spec)
            assert torch.equal(bt.codes, want.codes), (part, k)
            assert torch.equal(bt.exps, want.exps), (part, k)
            codes_t = bt.codes.numpy().view(np.uint16).astype(np.int64)
            codes_j = np.asarray(bj.codes).astype(np.int64)
            assert np.array_equal(bt.exps.numpy(), np.asarray(bj.exps))
            differ = codes_t != codes_j
            # a code differs only where the two f32 moments differ
            f32_t = ft[part][k].numpy().reshape(-1)
            f32_j = np.asarray(fj[part][k]).reshape(-1)
            pad = np.zeros(codes_t.size - f32_t.size, np.float32)
            moved = np.concatenate([f32_t != f32_j, pad != 0])
            assert not (differ.reshape(-1) & ~moved).any(), (part, k)
            # by one code step, same sign
            step_t, step_j = codes_t & 0x7FFF, codes_j & 0x7FFF
            assert (np.abs(step_t - step_j)[differ] <= 1).all(), (part, k)
            assert ((codes_t >> 15) == (codes_j >> 15))[differ].all()
            # decoded within one quantum of the block: 2^(emax - 127 - 14)
            quantum = np.exp2(np.asarray(bj.exps, np.float64) - 127 - 14)
            vj = np.asarray(JF.decompress(bj), np.float64)
            err = np.abs(F.decompress(bt).numpy() - vj)
            assert (err <= np.repeat(quantum, 128)[:vj.size]).all(), (part, k)
            diffs += int(differ.sum())
            total += differ.size
    print(f"coded AdamW after {updates} updates: {diffs} of {total} codes "
          "differ from the reference's (each by one code step)")
    assert diffs <= 0.01 * total


def test_coded_state_layout_and_size():
    p = params_from_numpy(_tree(np.random.default_rng(0), 1.0), device="cpu")
    st = adamw_init(p, AdamWConfig(compress_state=True))
    m = st["m"]["w"]
    assert isinstance(m, F.BlockCompressed)
    assert m.codes.dtype == torch.int16 and m.exps.dtype == torch.int32
    n = 3 * 48 * 70
    assert m.n == n and m.codes.shape == (-(-n // 128), 128)
    assert m.nbytes() < n * 4 * 0.6
    assert st["step"].dtype == torch.int32 and st["step"].device.type == "cpu"
    # the reference's state carries across and back, bit for bit
    with jax.enable_x64(False):
        sj = jax.tree.map(np.asarray, jinit(
            jax.tree.map(jnp.asarray, _tree(np.random.default_rng(0), 1.0)),
            JConfig(compress_state=True)))
    back = opt_state_to_numpy(opt_state_from_numpy(sj, device="cpu"),
                              like=sj)
    for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert type(back["m"]["w"]) is type(sj["m"]["w"])


def test_weight_decay_follows_the_stacked_leaf():
    """The reference's quirk: decay applies where the leaf as held has
    ndim >= 2, so a stacked (L, d) norm scale decays and a (d,) one does
    not (zero gradients: only the decay moves a weight)."""
    params = {"ln_stacked": np.ones((3, 8), np.float32),
              "ln": np.ones((8,), np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, weight_decay=0.5)
    pt = params_from_numpy(params, device="cpu")
    new, _, _ = adamw_update(params_from_numpy(zeros, device="cpu"),
                             adamw_init(pt, cfg), pt, cfg)
    assert bool((new["ln_stacked"] < 1).all())
    assert bool((new["ln"] == 1).all())
    with jax.enable_x64(False):
        pj = jax.tree.map(jnp.asarray, params)
        cj = JConfig(peak_lr=1e-2, warmup_steps=0, weight_decay=0.5)
        nj, _, _ = jupdate(jax.tree.map(jnp.asarray, zeros), jinit(pj, cj),
                           pj, cj)
    for k in params:
        assert np.array_equal(new[k].numpy(), np.asarray(nj[k])), k


@pytest.mark.parametrize("step", [0, 1, 99, 100, 5000, 10000, 20000])
def test_lr_schedule_matches_jax(step):
    cfg, cj = AdamWConfig(), JConfig()
    with jax.enable_x64(False):
        want = float(jlr(cj, jnp.int32(step)))
    got = float(lr_at(cfg, torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= 1e-7 * want


def test_square_root_is_correctly_rounded():
    """The update's f32 root equals numpy's (IEEE, correctly rounded) bit
    for bit, as the reference's does, across the moments' whole range."""
    from repro_torch.optim.adamw import _sqrt

    rng = np.random.default_rng(5)
    x = (rng.random(1 << 20, dtype=np.float32)
         * np.exp2(rng.integers(-120, 120, 1 << 20)).astype(np.float32))
    got = _sqrt(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), np.sqrt(x).view(np.uint32))


@pytest.mark.parametrize("spec", [
    F.FrszSpec(bs=128, l=21, dtype=torch.float32, rounding="nearest"),
    F.FrszSpec(bs=96, l=16, dtype=torch.float32, rounding="nearest")],
    ids=["l21", "bs96"])
def test_coded_state_outside_the_kernels_runs_plain_on_cpu(spec):
    """A spec that kernels 1 and 2 do not take (the paper's l = 21; a block
    that does not divide 128) codes the moments on the CPU through the
    plain codec; on the card it raises (``test_torch_cuda.py``)."""
    from repro_torch.kernels import ops

    p = params_from_numpy(_tree(np.random.default_rng(0), 1.0), device="cpu")
    g = params_from_numpy(_tree(np.random.default_rng(1), 1e-3),
                          device="cpu")
    cfg = AdamWConfig(compress_state=True, state_spec=spec)
    assert not ops.kernel_supported(spec)
    ops.reset_launches()
    new, st, _ = adamw_update(g, adamw_init(p, cfg), p, cfg)
    assert not any(ops.LAUNCHES.values())
    assert st["m"]["w"].spec == spec and int(st["step"]) == 1
    assert all(bool(torch.isfinite(v).all()) for v in new.values())
