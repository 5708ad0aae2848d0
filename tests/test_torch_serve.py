"""``repro_torch.launch.serve`` against ``repro.launch.serve``.

The JAX package's serve draws its weights from ``PRNGKey(seed)`` inside the
call; the same weights (``init_params(cfg, PRNGKey(0))``) are carried across
to the port's ``serve(params=...)``.  At ``tests/test_system.py``'s sizes (6
requests, 3 slots, prompt 16, max_new 8, max_ctx 32) the greedy completions
must be equal, token for token, with an f32 cache and with frsz2_16.
Tolerance: none (equal token ids).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.launch.serve import ServeConfig as JServeConfig
from repro.launch.serve import serve as jserve
from repro.models import init_params as jinit
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import ServeConfig, decode_steps, serve

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=256, num_heads=2,
            num_kv_heads=1, head_dim=0)


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 16).astype(np.int32) for _ in range(6)]


@pytest.mark.parametrize("kv_format", ["none", "frsz2_16"])
def test_completions_equal_jax_serve(kv_format):
    cj = dataclasses.replace(jget("yi-9b").reduced(), kv_format=kv_format,
                             **TINY)
    ct = dataclasses.replace(get_arch("yi-9b").reduced(), kv_format=kv_format,
                             **TINY)
    reqs = _requests(ct.vocab_size)
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
    assert len(stats["prefill_s"]) == 1 and stats["nonfinite_logits"] == 0
    assert len(stats["step_s"]) == decode_steps(6, ServeConfig(
        slots=3, max_new=8)) == 16


def test_serve_counts_launches_by_phase(monkeypatch):
    """``stats`` splits the kernel launches between the prefill and the
    decode steps: with every cache write counted as a launch of the fused
    cache-write kernel (on the CPU the wrapper launches nothing), one a
    layer (K and V together) for the prefill and one a layer for each
    decode step, and no row compress."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_arch("yi-9b").reduced(),
                              kv_format="frsz2_16", **TINY)
    write = ops.cache_write

    def counted(*args, **kw):
        ops.LAUNCHES["frsz2_cache_write"] += 1
        return write(*args, **kw)

    monkeypatch.setattr(ops, "cache_write", counted)
    sc = ServeConfig(slots=3, prompt_len=16, max_new=8, max_ctx=32)
    stats = {}
    ops.reset_launches()
    serve(cfg, sc, _requests(cfg.vocab_size), device="cpu", verbose=False,
          stats=stats)
    steps = len(stats["step_s"])
    L = cfg.num_layers
    assert stats["prefill_launches"]["frsz2_cache_write"] == L
    assert stats["step_launches"]["frsz2_cache_write"] == L * steps
    assert ops.LAUNCHES["frsz2_cache_write"] == L * (1 + steps)
    assert ops.LAUNCHES["frsz2_compress"] == 0
    assert not stats["step_launches"]["decode_attn"]


def test_serve_refuses_a_cache_too_short():
    cfg = dataclasses.replace(get_arch("yi-9b").reduced(), **TINY)
    reqs = _requests(cfg.vocab_size)
    with pytest.raises(ValueError, match="cannot hold"):
        serve(cfg, ServeConfig(slots=3, prompt_len=16, max_new=8,
                               max_ctx=31), reqs, device="cpu",
              verbose=False)


def test_serve_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = dataclasses.replace(get_arch("yi-9b").reduced(), **TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(cfg, ServeConfig(), _requests(cfg.vocab_size), verbose=False)


def test_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "yi-9b", "--reduced", "--requests", "6", "--prompt-len",
         "8", "--max-new", "4", "--kv-format", "frsz2_8"],
        capture_output=True, text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "8 decode steps, kv=frsz2_8, cpu" in proc.stdout
    assert "sample completion:" in proc.stdout
