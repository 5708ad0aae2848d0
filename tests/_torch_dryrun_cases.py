"""The fake-world halves of ``tests/test_torch_dryrun.py``: each world is
one process with PyTorch's ``fake`` process group (process-global, so one
world a subprocess), every case inside it, results as JSON.

  python tests/_torch_dryrun_cases.py hand|flat|pod|probes|remat OUT.json

with ``src`` on ``PYTHONPATH``.  ``hand``: a hand-built program with known
counts on a fake 2x2 mesh; ``flat`` / ``pod``: the ``reduced()`` config of
every family on 2x2 and on 2x2x2 with a ``pod`` dim, for train, prefill
and decode; ``probes``: the probe-extrapolated FLOPs of the dense, MoE and
SSM families at 4 layers against their full-depth counts; ``remat``:
the reference ladder's ``remat_policy="dots"`` rung beside full remat.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

#: the cells' shape: batch 8 (no family's reduced depth is 8, so the cache
#: rule's "first leading dim of size B" finds the batch dim), 32 positions
B, S = 8, 32
KINDS = ("train", "prefill", "decode")


def _world(n: int):
    from repro_torch.launch.mesh import init_fake_world

    init_fake_world(n)


def _shape(kind: str):
    from repro_torch.models.config import ShapeConfig

    return ShapeConfig(f"test_{kind}", S, B, kind)


def _local_bytes_of(tree) -> int:
    """The arguments' bytes on rank 0, from DTensor's own shard layout."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    total = 0

    def visit(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, DTensor):
            shape, _ = compute_local_shape_and_global_offset(
                x.shape, x.device_mesh, x.placements)
            total += math.prod(shape) * x.dtype.itemsize
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()

    visit(tree)
    return total


def hand() -> dict:
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.roofline.analysis import collective_bytes, count_step

    _world(4)
    mesh = make_test_mesh(2, 2)
    M, K, N = 64, 32, 48

    def dt(shape, pl):
        from repro_torch.launch.specs import to_dtensor

        return to_dtensor(torch.empty(shape, device="meta"), mesh, pl)

    out = {}
    x = dt((M, K), (Replicate(), Replicate()))
    w = dt((K, N), (Replicate(), Shard(1)))
    mode, y, _ = count_step(lambda a, b: a @ b, (x, w))
    out["sharded_mm"] = dict(flops=mode.flops, want=2 * M * K * N // 2,
                             placements=str(y.placements))
    wr = dt((K, N), (Replicate(), Replicate()))
    mode, _, _ = count_step(lambda a, b: a @ b, (x, wr))
    out["replicated_mm"] = dict(flops=mode.flops, want=2 * M * K * N)
    xs = dt((M, K), (Shard(0), Replicate()))
    mode, r, _ = count_step(
        lambda a: a.redistribute(mesh, (Replicate(), Replicate())), (xs,))
    coll = collective_bytes(mode.records)
    out["all_gather"] = dict(coll={k: v for k, v in coll.items() if v},
                             want=(M // 2) * K * 4,
                             local=list(r.to_local().shape))
    assert isinstance(r, DTensor)
    return out


def cells(pod: int) -> dict:
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.roofline.analysis import analyze_step, model_flops_for

    _world(4 * (pod or 1))
    mesh = make_test_mesh(2, 2, pod=pod)
    out = {}
    for arch in sorted(ARCHS):
        cfg = get_arch(arch).reduced()
        for kind in KINDS:
            t0 = time.time()
            shape = _shape(kind)
            cell = build_cell(cfg, shape, mesh)
            want_args = _local_bytes_of(cell.args)
            rep = analyze_step(cell,
                               model_flops_global=model_flops_for(cfg, shape),
                               chips=mesh.size())
            out[f"{arch}/{kind}"] = dict(
                arg_bytes=rep.memory_stats["arg_bytes"], want_args=want_args,
                flops=rep.flops, bytes=rep.bytes_hbm,
                temp=rep.memory_stats["temp_bytes"],
                coll=rep.coll_by_op, wall=time.time() - t0)
    return out


def probes() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import run_cell, run_probes
    from repro_torch.launch.mesh import make_test_mesh

    _world(4)
    mesh = make_test_mesh(2, 2)
    out = {}
    for arch in ("yi-9b", "mixtral-8x22b", "falcon-mamba-7b"):
        assert get_arch(arch).reduced().num_layers == 4
        for kind in KINDS:
            shape = _shape(kind)
            over = dataclasses.asdict(get_arch(arch).reduced())
            del over["name"]
            full = run_cell(arch, shape.name, mesh=mesh, shape=shape,
                            cfg_overrides=over, verbose=False)
            pr = run_probes(arch, shape.name, mesh=mesh, shape=shape,
                            cfg_overrides=over, verbose=False)
            out[f"{arch}/{kind}"] = dict(full=full["flops_per_dev"],
                                         probe=pr["flops_per_dev"])
    return out


def remat() -> dict:
    """The reference ladder's last rung (``benchmarks/perf_hillclimb.py``,
    "dots_remat_64x4"): internlm2-20b x train_4k on the 64x4 mesh at one
    layer, under full remat and under ``remat_policy="dots"``."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_mesh

    _world(256)
    mesh = make_mesh((64, 4), ("data", "model"))
    out = {}
    for policy in ("full", "dots"):
        t0 = time.time()
        row = run_cell("internlm2-20b", "train_4k", mesh=mesh, verbose=False,
                       cfg_overrides=dict(num_layers=1,
                                          remat_policy=policy))
        out[policy] = dict(status=row["status"], temp=row["temp_gib"],
                           flops=row["flops_per_dev"],
                           microbatch=row["microbatch"],
                           wall=time.time() - t0)
    return out


def main() -> None:
    which, path = sys.argv[1], sys.argv[2]
    t0 = time.time()
    res = {"hand": hand, "flat": lambda: cells(0), "pod": lambda: cells(2),
           "probes": probes, "remat": remat}[which]()
    res["_wall"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
