"""The port's token pipeline (``repro_torch.data``) and checkpoint store
(``repro_torch.checkpoint``) against the JAX package's.

* Tokens: bit-equal to the reference's for whole batches, every
  ``local_batch`` shard and single examples.
* Checkpoints: the reference's contract (round trip, keep-k, no ``.tmp``
  left, one outstanding async save, an async error raised on ``wait()``),
  and the reference's on-disk format both ways: a reference save restores
  in the port and a port save restores in the reference, bit for bit, with
  bf16 weights and FRSZ2-coded moments, and the two saves hold the same
  keys, shapes, dtypes and bytes.  The reference's own ``restore`` cannot
  cast the raw two-byte records its npz holds for bf16 back to
  ``bfloat16`` (numpy has no such cast): it is handed stand-ins of that
  raw type for its bf16 leaves here, and the bits are compared.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.data import GlobalBatchSpec as JSpec
from repro.data import synthetic_tokens as jtokens
from repro.optim import AdamWConfig as JConfig
from repro.optim import adamw_init as jinit
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core import frsz2 as F
from repro_torch.data import GlobalBatchSpec, synthetic_tokens
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import leaves_with_paths


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (1234, 99)])
def test_tokens_bit_equal_to_reference(seed, step):
    spec, jspec = (cls(seed=seed, seq_len=48, global_batch=8, vocab=1000)
                   for cls in (GlobalBatchSpec, JSpec))
    assert np.array_equal(spec.global_batch_at(step),
                          jspec.global_batch_at(step))
    for count in (1, 2, 4, 8):
        for i in range(count):
            got = spec.local_batch(step, i, count)
            assert got.dtype == np.int32
            assert np.array_equal(got, jspec.local_batch(step, i, count))
    assert np.array_equal(synthetic_tokens(seed, step, 3, 32, 500),
                          jtokens(seed, step, 3, 32, 500))


def _train_state(compress: bool):
    """Reference weights (bf16 and f32 leaves) and its AdamW state, as
    numpy, and the same on the port."""
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(0)
        pj = {"w": jax.random.normal(key, (3, 200), jnp.bfloat16),
              "nested": {"b": jnp.arange(10, dtype=jnp.float32)}}
        sj = jinit(pj, JConfig(compress_state=compress))
    tree_j = jax.tree.map(np.array, {"params": pj, "opt": sj})
    # moments that are not zero
    rng = np.random.default_rng(1)
    m = tree_j["opt"]["m"]["w"]
    if compress:
        m.codes[...] = rng.integers(0, 2 ** 16, m.codes.shape, np.uint16)
        m.exps[...] = rng.integers(100, 130, m.exps.shape, np.int32)
    else:
        m[...] = rng.standard_normal(m.shape)
    tree_t = {"params": params_from_numpy(tree_j["params"], device="cpu"),
              "opt": opt_state_from_numpy(tree_j["opt"], device="cpu")}
    return tree_j, tree_t


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _same(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert _bits(x) == _bits(y), k


def _raw_bf16(tree):
    """The reference's ``like`` with every bf16 leaf as a stand-in of the
    raw two-byte type its npz holds."""
    return jax.tree.map(lambda x: x.view("V2") if x.dtype.name == "bfloat16"
                        else x, tree)


@pytest.mark.parametrize("compress", [False, True])
def test_reference_save_restores_in_the_port(tmp_path, compress):
    tree_j, tree_t = _train_state(compress)
    jsave(str(tmp_path), 7, tree_j)
    like = {"params": params_from_numpy(
                jax.tree.map(np.zeros_like, tree_j["params"]), device="cpu"),
            "opt": adamw_init(tree_t["params"],
                              AdamWConfig(compress_state=compress))}
    step, got = restore(str(tmp_path), like)
    assert step == 7
    _same(got, tree_t)
    if compress:
        assert isinstance(got["opt"]["m"]["w"], F.BlockCompressed)


@pytest.mark.parametrize("compress", [False, True])
def test_port_save_restores_in_the_reference(tmp_path, compress):
    tree_j, tree_t = _train_state(compress)
    save(str(tmp_path / "port"), 7, tree_t)
    jsave(str(tmp_path / "ref"), 7, tree_j)
    # the same files: keys, shapes, dtypes and bytes
    zp = np.load(tmp_path / "port" / "step_00000007" / "leaves.npz")
    zr = np.load(tmp_path / "ref" / "step_00000007" / "leaves.npz")
    assert zp.files == zr.files
    for k in zr.files:
        assert zp[k].dtype == zr[k].dtype and zp[k].shape == zr[k].shape, k
        assert zp[k].tobytes() == zr[k].tobytes(), k
    mp, mr = (json.load(open(tmp_path / d / "step_00000007" /
                             "manifest.json")) for d in ("port", "ref"))
    assert mp["leaves"] == mr["leaves"]
    step, back = jrestore(str(tmp_path / "port"), _raw_bf16(tree_j))
    assert step == 7
    for a, b in zip(jax.tree.leaves(tree_j), jax.tree.leaves(back)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((32, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32)},
            "scalar": torch.tensor(3.5),
            "h": torch.randn((5, 7), generator=g).to(torch.bfloat16)}


def test_round_trip(tmp_path):
    t = _tree()
    save(str(tmp_path), 10, t)
    step, back = restore(str(tmp_path), t)
    assert step == 10
    _same(back, t)
    assert back["scalar"].shape == ()


def test_keep_k_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, t, keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "missing"), t)


def test_atomic_no_tmp_left_and_only_process_zero_writes(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a crash mid-save leaves a .tmp that is not a checkpoint
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 7
    save(str(tmp_path), 9, t)
    assert sorted(os.listdir(tmp_path)) == ["step_00000007", "step_00000009"]
    save(str(tmp_path), 11, t, process_index=1)
    assert latest_step(str(tmp_path)) == 9


def test_restore_checks_shapes(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    bad = dict(t, a=torch.zeros((16, 32)))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), bad)


def test_async_checkpointer(tmp_path):
    t = _tree(1)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(1, t)
    ck.save(2, t)         # waits for the first
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    _, back = restore(str(tmp_path), t)
    _same(back, t)


def test_async_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker / "ckpt"))
    ck.save(1, _tree())                   # fails on the writer thread
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                             # raised once, then cleared
