"""Solver driver: the paper's experiment — CB-GMRES with FRSZ2 storage.

  python -m repro_torch.launch.solve --problem synth:atmosmod --n 1270432 \
      --formats float64,frsz2_32

Runs on CUDA by default (FRSZ2 stores then go through the Hopper kernels);
``--device cpu`` runs the plain PyTorch versions on the CPU.  The flags and
the JSON rows are those of ``python -m repro.launch.solve`` for what this
port has so far.  ``--driver`` defaults to ``device``, as in the reference:
each restart cycle runs on the device with no host read (one CUDA graph
replay per restart on the card); ``--driver host`` runs the host-looped
parity oracle, one host read per Arnoldi step.  Pipeline flags:
``--precond jacobi``, ``--ortho cgs2``, ``--policy
adaptive[:auto|:<ladder>]`` (appends one run whose storage format is
chosen per restart cycle; its row names the policy).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.solver import gmres
from repro_torch.sparse import make_problem, rhs_for


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve_suite(problem: str, n: int, formats: list[str], *, m: int = 100,
                max_iters: int = 20000, target_rrn: float | None = None,
                driver: str = "device", precond: str | None = None,
                ortho: str = "mgs", policy: str | None = None,
                device: str = "cuda", verbose: bool = True):
    dev = resolve_device(device)
    A, rrn = make_problem(problem, n, device=dev)
    if target_rrn is not None:
        rrn = target_rrn
    b, x_sol = rhs_for(A, device=dev)
    rows = []
    runs = [dict(label=fmt, storage=fmt, policy=None) for fmt in formats]
    if policy:
        runs.append(dict(label=policy, storage=None, policy=policy))
    for run in runs:
        _sync(dev)
        t0 = time.perf_counter()
        res = gmres(A, b, storage=run["storage"], policy=run["policy"],
                    precond=precond, ortho=ortho, m=m, max_iters=max_iters,
                    target_rrn=rrn, driver=driver)
        _sync(dev)
        wall = time.perf_counter() - t0
        err = float(torch.linalg.vector_norm(res.x - x_sol)
                    / torch.linalg.vector_norm(x_sol))
        rows.append(dict(problem=problem, n=A.shape[0], format=run["label"],
                         driver=driver, batch=1, method=None,
                         precond=precond or "identity", ortho=ortho, shard=1,
                         shard_transport=None, shard_matvec=None,
                         shard_grid=None, reorder="auto",
                         iters=res.iterations, rrn=res.rrn,
                         converged=bool(res.converged), x_err=err,
                         restarts=res.restarts, wall_s=wall,
                         bytes_read=res.bytes_read, wall_per_solve_s=wall))
        if verbose:
            r = rows[-1]
            print(f"{problem:18s} {r['format']:10s} iters={r['iters']:6d} "
                  f"rrn={r['rrn']:.3e} conv={r['converged']} "
                  f"t={r['wall_s']:.1f}s")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="synth:atmosmod")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--formats", default="float64,float32,frsz2_32,float16")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--target-rrn", type=float, default=None)
    ap.add_argument("--driver", choices=["device", "host"], default="device",
                    help="restart loop: 'device' (one CUDA graph replay per "
                         "restart cycle) or 'host' (one host read per "
                         "Arnoldi step)")
    ap.add_argument("--precond", default=None,
                    help="right preconditioner: jacobi (default: none)")
    ap.add_argument("--ortho", choices=["mgs", "cgs2"], default="mgs",
                    help="orthogonalization scheme")
    ap.add_argument("--policy", default=None,
                    help="per-cycle precision policy run to append, e.g. "
                         "'adaptive', 'adaptive:auto' or "
                         "'adaptive:float64,frsz2_32@1e-2,frsz2_16@1e-6'")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the solve runs (cuda: the Hopper kernels)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = solve_suite(args.problem, args.n, args.formats.split(","),
                       m=args.m, target_rrn=args.target_rrn,
                       driver=args.driver, precond=args.precond,
                       ortho=args.ortho, policy=args.policy,
                       device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
