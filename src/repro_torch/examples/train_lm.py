"""Train a ~100M-parameter yi-family model for a few hundred steps, with
checkpoint and restart and (optionally) FRSZ2-coded optimizer state.

  python -m repro_torch.examples.train_lm --steps 300
  python -m repro_torch.examples.train_lm --steps 300 --compress-opt
  python -m repro_torch.examples.train_lm --steps 30 --device cpu

The ~100M config is the yi-9b topology at width 512 (the same GQA layout,
RoPE and SwiGLU): 16 layers x d512 x ff1408, vocab 16k, f32, no remat, as
the JAX package's ``examples/train_lm.py``.  On the card the coded state is
decoded and coded by kernels 2 and 1 every step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves


def hundred_m():
    base = get_arch("yi-9b")
    return dataclasses.replace(
        base, num_layers=16, d_model=512, num_heads=8, num_kv_heads=2,
        head_dim=64, d_ff=1408, vocab_size=16384, dtype="float32",
        microbatch=1, attn_chunk=256, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--compress-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    cfg = hundred_m()
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    nparams = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {nparams / 1e6:.1f}M params "
          f"({cfg.num_layers}L x d{cfg.d_model})")

    opt = AdamWConfig(peak_lr=6e-4, warmup_steps=20,
                      decay_steps=args.steps, weight_decay=0.05,
                      compress_state=args.compress_opt)
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=50, log_every=10)
    params, history = train(cfg, opt, tc, params=params, device=dev)
    if not history:
        print(f"nothing to train: {args.ckpt_dir} holds step {args.steps}")
        return
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss: {first:.3f} -> {last:.3f} over {len(history)} steps "
          f"(compressed opt state: {args.compress_opt})")
    if last >= first:
        raise SystemExit("training must reduce loss")


if __name__ == "__main__":
    main()
