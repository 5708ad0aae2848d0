"""Where a solve's time goes on the card: device busy share and kernel times.

  python -m repro_torch.launch.profile --problem synth:atmosmod \
      --n 1270432 --formats float64,frsz2_32 --driver device

For each format: one warm-up solve (with ``--driver device`` it captures the
cycle's CUDA graph), then one solve under ``torch.profiler``
(CPU + CUDA activities).  Prints the wall time (host clock around work that
ends in a synchronize), the summed device time of all kernels, their ratio
(the device busy share; the rest is the card waiting on the host), and the
kernels that took the most device time, as JSON lines.  ``--batch k``
profiles a solve of k right-hand sides (``_batch_rhs``) through
``gmres_batched`` with ``--method block`` or ``vmap``.

``--arch yi-9b`` profiles LM decode steps instead, at ``chip_smoke.py``'s
serving shape (8 slots, prompt 2048, random weights from seed 0), once per
KV format in ``--formats`` (e.g. ``frsz2_16,bf16``): a prefill, two warm-up
steps, then four steps under the profiler, each starting with the host read
of the previous step's tokens, as in ``serve``.  Besides the busy share it reports the
kernel launches per step.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.solve import _batch_rhs
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.solver import gmres, gmres_batched
from repro_torch.sparse import make_problem, rhs_for

#: the serving shape of ``chip_smoke.py`` phase 9
SERVE_SLOTS, SERVE_PROMPT, SERVE_STEPS = 8, 2048, 4


def profile_solve(A, b, fmt: str, *, m: int, max_iters: int, target: float,
                  driver: str = "device", batch: int = 1,
                  method: str = "vmap", top: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    kw = dict(storage=fmt, m=m, max_iters=max_iters, target_rrn=target,
              driver=driver)
    if batch > 1:
        B = _batch_rhs(b, batch)

        def solve():
            return gmres_batched(A, B, method=method, **kw)
    else:
        def solve():
            return [gmres(A, b, **kw)]
    solve()                                         # warm-up: builds, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    iters = sum(r.iterations for r in results)
    return dict(format=fmt, driver=driver, batch=batch,
                method=method if batch > 1 else None, n=A.shape[0],
                iters=iters, wall_s=wall, device_s=device_us * 1e-6,
                device_busy_share=device_us * 1e-6 / wall,
                wall_per_iter_ms=wall * 1e3 / max(iters, 1),
                top=[dict(name=e.key[:100], calls=e.count,
                          device_ms=e.self_device_time_total * 1e-3)
                     for e in kernels])


def _device_kernels(prof):
    """The events that ran on the card (the host ops that launched them
    report the same device time again, so they are left out)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_decode(cfg, params, *, top: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_PROMPT),
                           generator=gen, device="cuda")
    logits, cache = prefill(params, cfg, prompt,
                            cache_len=SERVE_PROMPT + SERVE_STEPS + 2)

    def step(tokens, cache):                        # as serve's loop
        tokens.tolist()
        logits, cache = decode_step(params, cfg, cache, tokens)
        return logits.argmax(-1), cache

    tokens = logits.argmax(-1)
    for _ in range(2):
        tokens, cache = step(tokens, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_STEPS):
            tokens, cache = step(tokens, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    n = SERVE_STEPS
    return dict(arch=cfg.name, kv_format=cfg.kv_format, slots=SERVE_SLOTS,
                prompt=SERVE_PROMPT, steps=n, wall_per_step_ms=wall * 1e3 / n,
                device_per_step_ms=device_us * 1e-3 / n,
                device_busy_share=device_us * 1e-6 / wall,
                launches_per_step=sum(e.count for e in _device_kernels(prof))
                / n,
                top=[dict(name=e.key[:100], calls_per_step=e.count / n,
                          device_ms_per_step=e.self_device_time_total
                          * 1e-3 / n) for e in kernels])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="synth:atmosmod")
    ap.add_argument("--n", type=int, default=1270432)
    ap.add_argument("--formats", default="float64,frsz2_32")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--driver", default="device",
                    help="restart loop(s), comma-separated: device, host")
    ap.add_argument("--batch", type=int, default=1,
                    help="right-hand sides per solve")
    ap.add_argument("--method", default="vmap",
                    help="batched method(s), comma-separated: vmap, block")
    ap.add_argument("--arch", default=None,
                    help="profile this model's decode steps instead of a "
                         "solve; --formats then names KV formats")
    ap.add_argument("--top", type=int, default=10,
                    help="kernels listed, the most device time first")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.arch:
        import dataclasses

        cfg = get_arch(args.arch)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        for fmt in args.formats.split(","):
            print(json.dumps(profile_decode(
                dataclasses.replace(cfg, kv_format=fmt), params,
                top=args.top)), flush=True)
        return
    A, target = make_problem(args.problem, args.n, device=dev)
    b, _ = rhs_for(A, device=dev)
    methods = args.method.split(",") if args.batch > 1 else ["vmap"]
    for method in methods:
        for driver in args.driver.split(","):
            for fmt in args.formats.split(","):
                print(json.dumps(profile_solve(
                    A, b, fmt, m=args.m, max_iters=args.max_iters,
                    target=target, driver=driver, batch=args.batch,
                    method=method, top=args.top)), flush=True)


if __name__ == "__main__":
    main()
