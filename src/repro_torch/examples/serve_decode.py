"""Serve a small model with batched requests over a compressed KV cache,
comparing KV formats (the paper's technique on the serving path).

  python -m repro_torch.examples.serve_decode --requests 8
  python -m repro_torch.examples.serve_decode --device cpu

yi-9b ``reduced()`` with the JAX package's ``examples/serve_decode.py``
traffic: 4 slots, prompts of 32, exact (``none``), ``bf16`` and
``frsz2_16`` caches; on the card the FRSZ2 cache is written by the
cache-write kernel and read by the decode-attention kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.launch.serve import ServeConfig, decode_steps, serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    base = get_arch("yi-9b").reduced()
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, base.vocab_size, 32).astype(np.int32)
            for _ in range(args.requests)]
    sc = ServeConfig(slots=4, prompt_len=32, max_new=args.max_new)
    # every position the run writes (the reference's fixed 96 overflows
    # once the requests outnumber the slots twice over)
    sc.max_ctx = max(96, sc.prompt_len + decode_steps(len(reqs), sc))

    outs = {}
    for fmt in ("none", "bf16", "frsz2_16"):
        cfg = dataclasses.replace(base, kv_format=fmt)
        t0 = time.time()
        outs[fmt] = serve(cfg, sc, reqs, device=args.device, verbose=False)
        print(f"kv={fmt:9s} {time.time() - t0:6.1f}s "
              f"first completion: {outs[fmt][0][:8]}")

    # compressed-cache generations agree with the exact cache for a while
    # (greedy decoding; divergence after many steps is expected and fine)
    agree16 = sum(a == b for a, b in zip(outs["none"][0],
                                         outs["frsz2_16"][0]))
    print(f"\nfrsz2_16 matches exact-cache greedy tokens for "
          f"{agree16}/{len(outs['none'][0])} steps of request 0")


if __name__ == "__main__":
    main()
