"""Serving driver: batched prefill + decode against a compressed KV cache.

  python -m repro_torch.launch.serve --arch yi-9b
  python -m repro_torch.launch.serve --arch yi-9b --reduced --device cpu
  python -m repro_torch.launch.serve --arch zamba2-7b  (or falcon-mamba-7b)
  python -m repro_torch.launch.serve --arch whisper-medium
      (or llama-3.2-vision-11b)

A fixed pool of decode slots, the JAX package's loop (``repro.launch.serve``)
step for step: the first wave of requests is prefilled into a fresh cache;
a slot whose request has its ``max_new`` tokens takes the next queued
request and decodes on from the slot's cache (that request's prompt is not
prefilled: the reference's re-prefill branch runs only when every slot is
free while requests wait, which its loop never reaches).  Greedy decoding.

Runs on CUDA by default: an FRSZ2 cache (``--kv-format frsz2_16``, the
config's default) is written by the cache-write kernel and read by the
flash-decode attention kernel (in the hybrid family, by its shared
attention block; the SSM family has no KV cache and carries its state from
step to step).  The encoder-decoder and VLM families also take stub frame
or image embeddings (``serve(aux_inputs=...)``, drawn by :func:`aux_for`
when not given, the same for every wave, as the reference's): the prefill
writes each cross-attention block's cache whole from them, and every
decode step reads those caches whole through the same attention kernel.
``--device cpu`` runs the plain PyTorch versions.  Weights are random,
drawn from seed 0 on the device, layer by layer.  The flags are the
reference's, plus ``--device``; the cache holds
every position the run writes (the reference CLI's ``prompt + max_new +
8`` overflows as soon as requests outnumber slots, and the JAX package then
drops the writes past its end).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.models.config import torch_dtype
from repro_torch.models.lm import cross_layers, cross_len, kv_layers


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4                 # concurrent decode slots (batch)
    prompt_len: int = 32
    max_new: int = 32
    max_ctx: int = 128
    seed: int = 0
    greedy: bool = True


def decode_steps(n_requests: int, sc: ServeConfig) -> int:
    """Decode steps the loop runs: each slot serves every ``slots``-th
    request, ``max_new`` steps each."""
    return -(-n_requests // sc.slots) * sc.max_new if n_requests else 0


def aux_for(cfg: ArchConfig, B: int, gen: torch.Generator) -> dict:
    """The reference's ``_aux_for``: stub frame embeddings (encdec) or image
    embeddings (VLM), normal x 0.02 in the model's dtype, ``(B,
    cross_len, d_model)``, on ``gen``'s device; empty for the other
    families."""
    key = {"encdec": "frames", "vlm": "image_embeds"}.get(cfg.family)
    if key is None:
        return {}
    dt = torch_dtype(cfg.dtype)
    x = torch.randn((B, cross_len(cfg), cfg.d_model), generator=gen,
                    dtype=torch.float32, device=gen.device).to(dt)
    return {key: x * 0.02}


def _kv_line(cfg: ArchConfig) -> str:
    """The cache formats of the closing line: the self cache's and the
    cross caches' (the same format, ``cfg.kv_format``)."""
    if not kv_layers(cfg):
        return "kv=no cache"
    line = f"kv={cfg.kv_format}"
    if cross_layers(cfg):
        line += (f", cross kv={cfg.kv_format} ({cross_layers(cfg)} layers x "
                 f"{cross_len(cfg)} positions)")
    return line


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ArchConfig, sc: ServeConfig, requests: list[np.ndarray], *,
          params: dict | None = None, aux_inputs: dict | None = None,
          device="cuda", verbose: bool = True,
          stats: dict | None = None) -> dict:
    """Generate ``max_new`` tokens for every request; returns completions.

    ``params`` (the weights, on ``device``) defaults to random ones drawn
    from ``sc.seed``; ``aux_inputs`` (the encdec family's ``"frames"``, the
    VLM's ``"image_embeds"``, ``(slots, cross_len, d_model)``), handed to
    every wave's prefill, to :func:`aux_for` drawn from ``sc.seed`` on the
    device.  ``stats``, if given, receives the wall of each
    prefill (``prefill_s``) and of each decode step including its host
    read of the new tokens (``step_s``), in seconds, the kernel launches
    (``ops.LAUNCHES``) of the prefills (``prefill_launches``) and of the
    decode steps (``step_launches``), and the count of logits that were
    not finite (``nonfinite_logits``).
    """
    dev = resolve_device(device)
    need = sc.prompt_len + decode_steps(len(requests), sc)
    if need > sc.max_ctx:
        raise ValueError(f"max_ctx={sc.max_ctx} cannot hold the {need} "
                         "positions this run writes")
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(sc.seed))
    B = sc.slots
    if aux_inputs is None:
        aux_inputs = aux_for(cfg, B, torch.Generator(device=dev)
                             .manual_seed(sc.seed))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    if stats is not None:
        stats.update(prefill_s=[], step_s=[],
                     prefill_launches=collections.Counter(),
                     step_launches=collections.Counter())

    def count(key, before):
        if stats is not None:
            stats[key].update({k: v - before.get(k, 0)
                               for k, v in ops.LAUNCHES.items()})

    queue = list(enumerate(requests))
    active = [None] * B            # request id per slot
    out = {i: [] for i in range(len(requests))}
    t0 = time.perf_counter()
    steps = 0

    def admit_wave():
        wave = [queue.pop(0) for _ in range(min(B, len(queue)))]
        prompt = np.zeros((B, sc.prompt_len), np.int64)
        for slot, (rid, toks) in enumerate(wave):
            prompt[slot, :] = toks[:sc.prompt_len]
            active[slot] = rid
        t = time.perf_counter()
        before = dict(ops.LAUNCHES)
        logits, cache = prefill(params, cfg, torch.from_numpy(prompt).to(dev),
                                aux_inputs, cache_len=sc.max_ctx)
        count("prefill_launches", before)
        tokens = logits.argmax(-1)
        if stats is not None:
            bad.add_((~torch.isfinite(logits)).sum())
            _sync(dev)
            stats["prefill_s"].append(time.perf_counter() - t)
        return tokens, cache

    tokens, cache = admit_wave()
    while any(a is not None for a in active):
        t = time.perf_counter()
        host = tokens.tolist()
        for slot, rid in enumerate(active):
            if rid is not None:
                out[rid].append(host[slot])
        before = dict(ops.LAUNCHES)
        logits, cache = decode_step(params, cfg, cache, tokens)
        count("step_launches", before)
        tokens = logits.argmax(-1)
        steps += 1
        for slot, rid in enumerate(active):
            if rid is not None and len(out[rid]) >= sc.max_new:
                # slot finished: the next request takes the slot and decodes
                # on from its cache, as in the reference
                active[slot] = None
                if queue:
                    nrid, _ = queue.pop(0)
                    active[slot] = nrid
        if all(a is None for a in active) and queue:
            tokens, cache = admit_wave()
        if stats is not None:
            bad.add_((~torch.isfinite(logits)).sum())
            _sync(dev)
            stats["step_s"].append(time.perf_counter() - t)
    if stats is not None:
        stats["nonfinite_logits"] = int(bad)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[serve] {len(requests)} requests x {sc.max_new} tokens in "
              f"{dt:.1f}s ({steps} decode steps, {_kv_line(cfg)}, "
              f"{dev.type})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--kv-format", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (cuda: the Hopper kernels)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_format:
        cfg = dataclasses.replace(cfg, kv_format=args.kv_format)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
            .astype(np.int32) for _ in range(args.requests)]
    sc = ServeConfig(prompt_len=args.prompt_len, max_new=args.max_new)
    sc.max_ctx = sc.prompt_len + decode_steps(len(reqs), sc) + 8
    out = serve(cfg, sc, reqs, device=args.device)
    print("sample completion:", out[0][:16])


if __name__ == "__main__":
    main()
