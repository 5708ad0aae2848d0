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

``--shard P`` runs every solve on P ranks of a ``torch.distributed``
group, one process per GPU (``repro_torch.solver.sharded``): under
``torchrun --nproc-per-node P -m repro_torch.launch.solve --shard P`` each
process joins the group torchrun describes; run plainly, the CLI spawns
the P ranks itself (NCCL on ``cuda:0..P-1``, gloo with ``--device cpu``)
and prints rank 0's rows.  ``--shard-transport`` picks plain or
FRSZ2-coded reductions, ``--shard-matvec`` the partitioned SpMV (``auto``
probes the bandwidth: the neighbour halo exchange for banded operators,
the gathered operand otherwise, the 3-D block partition when the problem
carries its cell grid and the faces cost less), ``--shard-grid 2x2x2``
the block partition's process grid.  The plan's summary is printed first.
"""
from __future__ import annotations

import argparse
import json
import os
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
                shard: int | None = None, shard_transport: str = "plain",
                shard_matvec: str = "auto", shard_grid=None,
                reorder: str = "auto", device: str = "cuda",
                verbose: bool = True):
    dev = resolve_device(device)
    A, rrn = make_problem(problem, n, device=dev)
    if target_rrn is not None:
        rrn = target_rrn
    b, x_sol = rhs_for(A, device=dev)
    if (reorder == "rcm" or shard) and verbose:
        # the solves below fetch this plan from the plan cache (the sharded
        # solve re-plans without a permutation that its preconditioner
        # cannot follow)
        print(plan_operator(A, shard or 1, reorder=reorder,
                            matvec_mode=shard_matvec if shard else "auto",
                            pgrid=shard_grid).describe())
    rows = []
    runs = [dict(label=fmt, storage=fmt, policy=None) for fmt in formats]
    if policy:
        runs.append(dict(label=policy, storage=None, policy=policy))
    for run in runs:
        kw = dict(storage=run["storage"], policy=run["policy"],
                  precond=precond, ortho=ortho, m=m, max_iters=max_iters,
                  target_rrn=rrn, driver=driver, shard=shard,
                  shard_transport=shard_transport,
                  shard_matvec=shard_matvec, shard_grid=shard_grid,
                  reorder=reorder)
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
                         precond=precond or "identity", ortho=ortho,
                         shard=shard or 1,
                         shard_transport=shard_transport if shard else None,
                         shard_matvec=shard_matvec if shard else None,
                         shard_grid=("x".join(map(str, shard_grid))
                                     if shard and shard_grid else None),
                         reorder=reorder,
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


def _rank_suite(rank, device, suite_kw):
    """One rank of a spawned sharded run: its rows (rank 0 prints them)."""
    return solve_suite(device=str(device), verbose=rank == 0, **suite_kw)


def _run_sharded(suite_kw: dict, shard: int, device: str):
    """The suite on ``shard`` ranks: in the group torchrun describes, or on
    ranks spawned here; rank 0's rows (``None`` on other torchrun ranks)."""
    import torch.distributed as dist

    from repro_torch.device import rank_device
    from repro_torch.dist import init_rank, spawn

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        dev = (rank_device(device) if dist.is_initialized()
               else init_rank(device=device))
        try:
            rank = dist.get_rank()
            rows = solve_suite(device=str(dev), verbose=rank == 0,
                               **suite_kw)
        finally:
            dist.destroy_process_group()
        return rows if rank == 0 else None
    return spawn(_rank_suite, shard, suite_kw, device=device, timeout_s=None)


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
    ap.add_argument("--shard", type=int, default=None,
                    help="run every solve on this many ranks of a "
                         "torch.distributed group, one process per GPU "
                         "(spawned here unless run under torchrun)")
    ap.add_argument("--shard-transport", default="plain",
                    choices=["plain", "compressed", "compressed+norms"],
                    help="wire format for the sharded solve's reductions")
    ap.add_argument("--shard-matvec", default="auto",
                    choices=["auto", "halo", "rows", "replicated",
                             "block3d"],
                    help="row-partitioned SpMV: auto probes the operator "
                         "bandwidth (neighbour halo exchange for banded "
                         "operators, gathered operand otherwise; 3-D block "
                         "partition when the problem carries cell geometry "
                         "and its face wire wins)")
    ap.add_argument("--shard-grid", default=None,
                    help="force the block partition's (Px,Py,Pz) process "
                         "grid, e.g. '2x2x2' ('auto'/omitted: factor the "
                         "group to minimize modelled face wire)")
    ap.add_argument("--reorder", default="auto",
                    choices=["auto", "rcm", "none"],
                    help="RCM bandwidth-reduction reordering at setup: "
                         "auto permutes only when it unlocks the sharded "
                         "halo matvec for an unstructured operator "
                         "(repro_torch.sparse.plan)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the solve runs (cuda: the Hopper kernels; "
                         "with --shard, cuda:<rank> under NCCL, cpu under "
                         "gloo)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    shard_grid = None
    if args.shard_grid and args.shard_grid != "auto":
        try:
            shard_grid = tuple(int(p) for p in args.shard_grid.split("x"))
            if len(shard_grid) != 3:
                raise ValueError
        except ValueError:
            ap.error(f"--shard-grid must be 'PxPyPz' (e.g. 2x2x2) or "
                     f"'auto', got {args.shard_grid!r}")
    suite_kw = dict(problem=args.problem, n=args.n,
                    formats=args.formats.split(","), m=args.m,
                    target_rrn=args.target_rrn, driver=args.driver,
                    batch=args.batch, method=args.method,
                    precond=args.precond, ortho=args.ortho,
                    policy=args.policy, shard=args.shard,
                    shard_transport=args.shard_transport,
                    shard_matvec=args.shard_matvec, shard_grid=shard_grid,
                    reorder=args.reorder)
    if args.shard:
        rows = _run_sharded(suite_kw, args.shard, args.device)
    else:
        rows = solve_suite(device=args.device, **suite_kw)
    if args.json and rows is not None:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
