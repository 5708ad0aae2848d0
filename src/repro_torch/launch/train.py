"""Training driver: a fault-tolerant loop with checkpoint and restart and a
straggler watchdog.

  python -m repro_torch.launch.train --arch yi-9b --reduced --device cpu \\
      --steps 4 --batch 2 --seq 64 --ckpt-dir DIR [--compress-opt-state]

The port of ``repro.launch.train``, for one process.  Every interface is
process-indexed as the reference's (the data shard by process, the
checkpoint writer only on process 0, the rank of a live
``torch.distributed`` group):

* auto-resume from the latest checkpoint (the atomic keep-k store);
* async checkpoint writes off the critical path, every ``ckpt_every``
  steps;
* a per-step wall-clock watchdog that logs a step slower than
  ``straggler_factor`` times the median of the last 20;
* microbatches (``microbatch``, the reference's gradient accumulation)
  summed in f32.

Runs on CUDA by default, where the FRSZ2-coded optimizer state
(``--compress-opt-state``) is decoded and coded by kernels 2 and 1 every
step; ``--device cpu`` runs their plain versions.  Weights are random,
drawn from ``seed`` on the device.  ``compress_pod_grads`` is kept as the
reference's field: its collective acts only over a "pod" mesh axis, which
the reference's ``train`` never builds.  Nor does this one: the LM mesh
(``launch/mesh.py``, with the multi-pod fold) serves the dry run, and
``train`` runs one process on one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch
from repro_torch.data import GlobalBatchSpec
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ArchConfig, torch_dtype
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TrainConfig", "make_step", "train", "value_and_grad"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 256
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 20
    keep: int = 3
    seed: int = 0
    straggler_factor: float = 3.0   # watchdog: step > factor * median
    log_every: int = 10
    microbatch: int = 1
    compress_pod_grads: bool = False


def value_and_grad(params: dict, cfg: ArchConfig, batch: dict):
    """(loss, gradients): :func:`loss_fn` and its gradient with respect to
    every weight, a tree like ``params`` (each leaf in its weight's
    dtype)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(live, cfg, batch)
    leaves = tree_leaves(live)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda p: grads[id(p)], live)


def make_step(cfg: ArchConfig, opt: AdamWConfig, tc: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, stats)."""

    def step(params, opt_state, batch):
        mbs = tc.microbatch
        if mbs > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(mbs):
                mb = {k: v.reshape(mbs, v.shape[0] // mbs, *v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, g = value_and_grad(params, cfg, mb)
                tree_map(lambda a, x: a.add_(x), acc, g)
                loss = loss + mb_loss
                del g
            grads = tree_map(lambda a: a / mbs, acc)
            loss = loss / mbs
        else:
            loss, grads = value_and_grad(params, cfg, batch)
        params2, opt_state2, stats = adamw_update(grads, opt_state, params,
                                                  opt)
        stats["loss"] = loss
        return params2, opt_state2, stats

    return step


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: ArchConfig, opt: AdamWConfig, tc: TrainConfig, *,
          params: dict | None = None, device="cuda", verbose: bool = True,
          state_out: dict | None = None):
    """Run the loop; returns (params, history).  Resumes automatically.

    ``params`` (any device) replaces the random weights drawn from
    ``tc.seed``; a checkpoint in ``tc.ckpt_dir`` replaces both.
    ``state_out``, if given, receives the final ``params`` and optimizer
    state under ``"params"`` and ``"opt"``, as a checkpoint holds them.
    """
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(tc.seed))
    else:
        params = tree_map(lambda p: p.to(dev), params)
    opt_state = adamw_init(params, opt)
    start = 0
    if latest_step(tc.ckpt_dir) is not None:
        start, state = restore(tc.ckpt_dir, {"params": params,
                                             "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        if verbose:
            print(f"[train] resumed from step {start}")

    data = GlobalBatchSpec(seed=tc.seed, seq_len=tc.seq_len,
                           global_batch=tc.global_batch,
                           vocab=cfg.vocab_size)
    step_fn = make_step(cfg, opt, tc)
    ckpt = AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep,
                             process_index=_process_index())
    history = []
    durations = []
    stragglers = []
    for step in range(start, tc.steps):
        t0 = time.time()
        batch = {"tokens": torch.from_numpy(data.global_batch_at(step))
                 .to(dev)}
        if cfg.family == "encdec":
            batch["frames"] = _stub_embeds(cfg, tc, step, cfg.encoder_seq,
                                           dev)
        if cfg.family == "vlm":
            batch["image_embeds"] = _stub_embeds(cfg, tc, step,
                                                 cfg.num_image_tokens, dev)
        params, opt_state, stats = step_fn(params, opt_state, batch)
        loss = float(stats["loss"])
        _sync(dev)                 # the update is done, not only the loss
        dt = time.time() - t0
        durations.append(dt)
        med = float(np.median(durations[-20:]))
        if len(durations) > 5 and dt > tc.straggler_factor * med:
            stragglers.append(dict(step=step, dt=dt, median=med))
            if verbose:
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s) — straggler logged")
        history.append(dict(step=step, loss=loss, dt=dt,
                            grad_norm=float(stats["grad_norm"]),
                            lr=float(stats["lr"])))
        if verbose and (step % tc.log_every == 0 or step == tc.steps - 1):
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(stats['grad_norm']):.3f} {dt:.2f}s")
        if tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    ckpt.wait()
    if stragglers and verbose:
        print(f"[watchdog] {len(stragglers)} straggler steps logged")
    if state_out is not None:
        state_out.update(params=params, opt=opt_state)
    return params, history


def _stub_embeds(cfg: ArchConfig, tc: TrainConfig, step: int, n: int,
                 device) -> torch.Tensor:
    """Stub frames / image embeddings of a step, (global_batch, n,
    d_model): normal x 0.02 in the model's dtype, as ``serve.aux_for``
    draws them, from a generator seeded by (seed, step)."""
    gen = torch.Generator(device=device).manual_seed(
        ((tc.seed + 7) << 32) + step)
    x = torch.randn((tc.global_batch, n, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=device)
    return x.to(torch_dtype(cfg.dtype)) * 0.02


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the architecture")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=_default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--compress-opt-state", action="store_true",
                    help="FRSZ2-compress Adam m/v (the paper's format)")
    ap.add_argument("--history-json", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (cuda: the Hopper kernels)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      decay_steps=args.steps,
                      compress_state=args.compress_opt_state)
    tc = TrainConfig(steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every)
    params, history = train(cfg, opt, tc, device=args.device)
    if args.history_json:
        with open(args.history_json, "w") as f:
            json.dump(history, f)
    if history:
        print(f"final loss: {history[-1]['loss']:.4f} "
              f"(first: {history[0]['loss']:.4f})")
    else:
        print(f"[train] nothing to do: the checkpoint is at step "
              f"{latest_step(tc.ckpt_dir)} of {tc.steps}")


if __name__ == "__main__":
    main()
