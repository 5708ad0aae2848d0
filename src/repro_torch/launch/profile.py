"""Where a solve's time goes on the card: device busy share and kernel times.

  python -m repro_torch.launch.profile --problem synth:atmosmod \
      --n 1270432 --formats float64,frsz2_32 --driver device

For each format: one warm-up solve (with ``--driver device`` it captures the
cycle's CUDA graph), then one solve under ``torch.profiler``
(CPU + CUDA activities).  Prints the wall time (host clock around work that
ends in a synchronize), the summed device time of all kernels, their ratio
(the device busy share; the rest is the card waiting on the host), and the
kernels that took the most device time, as JSON lines.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.solver import gmres
from repro_torch.sparse import make_problem, rhs_for


def profile_solve(A, b, fmt: str, *, m: int, max_iters: int, target: float,
                  driver: str = "device", top: int = 10) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = dict(storage=fmt, m=m, max_iters=max_iters, target_rrn=target,
              driver=driver)
    gmres(A, b, **kw)                               # warm-up: builds, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = gmres(A, b, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels are the events that ran on the card; the host ops that
    # launched them report the same device time again, so they are left out
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return dict(format=fmt, driver=driver, n=A.shape[0], iters=res.iterations,
                wall_s=wall, device_s=device_us * 1e-6,
                device_busy_share=device_us * 1e-6 / wall,
                wall_per_iter_ms=wall * 1e3 / max(res.iterations, 1),
                top=[dict(name=e.key[:100], calls=e.count,
                          device_ms=e.self_device_time_total * 1e-3)
                     for e in kernels])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="synth:atmosmod")
    ap.add_argument("--n", type=int, default=1270432)
    ap.add_argument("--formats", default="float64,frsz2_32")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--driver", default="device",
                    help="restart loop(s), comma-separated: device, host")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    A, target = make_problem(args.problem, args.n, device=dev)
    b, _ = rhs_for(A, device=dev)
    for driver in args.driver.split(","):
        for fmt in args.formats.split(","):
            print(json.dumps(profile_solve(A, b, fmt, m=args.m,
                                           max_iters=args.max_iters,
                                           target=target, driver=driver)),
                  flush=True)


if __name__ == "__main__":
    main()
