"""Solver driver: the paper's experiment — CB-GMRES with FRSZ2 storage.

  python -m repro_torch.launch.solve --problem synth:atmosmod --n 1270432 \
      --formats float64,frsz2_32

Runs on CUDA by default (FRSZ2 stores then go through the Hopper kernels);
``--device cpu`` runs the plain PyTorch versions on the CPU.  The flags and
the JSON rows are those of ``python -m repro.launch.solve`` for what this
port has so far.  ``--driver`` defaults to ``device``, as in the reference:
each restart cycle runs on the device with no host read (one CUDA graph
replay per restart on the card); ``--driver host`` runs the host-looped
parity oracle, one host read per Arnoldi step.

``--batch k`` solves k right-hand sides per format through
``gmres_batched`` and reports the wall per solve as well; ``--method
block`` solves them in one shared block Krylov space (block-GMRES), the
default ``vmap`` one after another.  Pipeline flags:
``--precond jacobi``, ``--ortho cgs2``, ``--policy
adaptive[:auto|:<ladder>]`` (appends one run whose storage format is
chosen per restart cycle; its row names the policy), ``--reorder rcm``
(solve in RCM-permuted coordinates; the plan's summary is printed first:
drive it on ``--problem synth:unstructured``, where the iterations must
equal ``--reorder none``'s).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.solver import gmres, gmres_batched
from repro_torch.sparse import make_problem, plan_operator, rhs_for


def _batch_rhs(b: torch.Tensor, k: int) -> torch.Tensor:
    """k deterministic right-hand sides: the reference b plus k-1 variants
    (``repro/launch/solve.py:_batch_rhs``)."""
    t = torch.arange(b.shape[0], dtype=b.dtype, device=b.device)
    cols = [b] + [b * (1.0 + 0.1 * i) + 0.05 * i * torch.sin(t * (i + 1))
                  for i in range(1, k)]
    return torch.stack(cols)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve_suite(problem: str, n: int, formats: list[str], *, m: int = 100,
                max_iters: int = 20000, target_rrn: float | None = None,
                driver: str = "device", batch: int = 1,
                method: str = "vmap", precond: str | None = None,
                ortho: str = "mgs", policy: str | None = None,
                reorder: str = "auto", device: str = "cuda",
                verbose: bool = True):
    dev = resolve_device(device)
    A, rrn = make_problem(problem, n, device=dev)
    if target_rrn is not None:
        rrn = target_rrn
    b, x_sol = rhs_for(A, device=dev)
    if reorder == "rcm" and verbose:
        # the solves below fetch this plan from the plan cache
        print(plan_operator(A, 1, reorder=reorder).describe())
    rows = []
    runs = [dict(label=fmt, storage=fmt, policy=None) for fmt in formats]
    if policy:
        runs.append(dict(label=policy, storage=None, policy=policy))
    for run in runs:
        kw = dict(storage=run["storage"], policy=run["policy"],
                  precond=precond, ortho=ortho, m=m, max_iters=max_iters,
                  target_rrn=rrn, driver=driver, reorder=reorder)
        _sync(dev)
        t0 = time.perf_counter()
        if batch > 1:
            results = gmres_batched(A, _batch_rhs(b, batch), method=method,
                                    **kw)
        else:
            results = [gmres(A, b, **kw)]
        _sync(dev)
        wall = time.perf_counter() - t0
        res = results[0]                   # reference rhs: accuracy metrics
        err = float(torch.linalg.vector_norm(res.x - x_sol)
                    / torch.linalg.vector_norm(x_sol))
        rows.append(dict(problem=problem, n=A.shape[0], format=run["label"],
                         driver=driver, batch=batch,
                         method=method if batch > 1 else None,
                         precond=precond or "identity", ortho=ortho, shard=1,
                         shard_transport=None, shard_matvec=None,
                         shard_grid=None, reorder=reorder,
                         iters=sum(r.iterations for r in results),
                         rrn=res.rrn,
                         converged=all(r.converged for r in results),
                         x_err=err, restarts=res.restarts, wall_s=wall,
                         bytes_read=sum(r.bytes_read for r in results),
                         wall_per_solve_s=wall / max(batch, 1)))
        if verbose:
            r = rows[-1]
            extra = (f" batch={batch} t/solve={r['wall_per_solve_s']:.2f}s"
                     if batch > 1 else "")
            print(f"{problem:18s} {r['format']:10s} iters={r['iters']:6d} "
                  f"rrn={r['rrn']:.3e} conv={r['converged']} "
                  f"t={r['wall_s']:.1f}s{extra}")
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
    ap.add_argument("--batch", type=int, default=1,
                    help="solve this many right-hand sides per format")
    ap.add_argument("--method", choices=["vmap", "block"], default="vmap",
                    help="batched solve: independent per-RHS solves (vmap) "
                         "or one shared block Krylov basis (block); only "
                         "with --batch > 1")
    ap.add_argument("--precond", default=None,
                    help="right preconditioner: jacobi (default: none)")
    ap.add_argument("--ortho", choices=["mgs", "cgs2"], default="mgs",
                    help="orthogonalization scheme")
    ap.add_argument("--policy", default=None,
                    help="per-cycle precision policy run to append, e.g. "
                         "'adaptive', 'adaptive:auto' or "
                         "'adaptive:float64,frsz2_32@1e-2,frsz2_16@1e-6'")
    ap.add_argument("--reorder", default="auto",
                    choices=["auto", "rcm", "none"],
                    help="RCM bandwidth-reduction reordering at setup: "
                         "auto permutes only when it unlocks the sharded "
                         "halo matvec for an unstructured operator "
                         "(repro_torch.sparse.plan)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the solve runs (cuda: the Hopper kernels)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = solve_suite(args.problem, args.n, args.formats.split(","),
                       m=args.m, target_rrn=args.target_rrn,
                       driver=args.driver, batch=args.batch,
                       method=args.method, precond=args.precond,
                       ortho=args.ortho, policy=args.policy,
                       reorder=args.reorder, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
