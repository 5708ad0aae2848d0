"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta DTensors.

Proves the distribution config is coherent without hardware: for each cell
the step (``launch.specs.build_cell``) runs once on DTensors whose local
shards live on the ``meta`` device, over a ``DeviceMesh`` of PyTorch's
``fake`` process group, on the 16x16 single-pod mesh and the 2x16x16
multi-pod one, and is counted per device (``roofline.analysis``): the
memory a rank holds (arguments, the counted peak of live bytes, outputs)
and the three roofline terms under the H100's constants.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-20b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]
  python -m repro_torch.launch.dryrun --all --probes
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \
      --mesh 1x1 --batch 4 --layers 8 --microbatch 1   (one card's cell)

The reference ladder's last rung (``benchmarks/perf_hillclimb.py``,
"dots_remat_64x4") is ``run_probes("internlm2-20b", "train_4k",
mesh_spec="64x4", cfg_overrides=dict(remat_policy="dots"))`` (or
``run_cell``): selective checkpointing runs on the meta DTensors.

The fake group of 256 (or 512, or ``--mesh``'s) ranks, this process rank
0, exists ONLY here: :func:`main` starts it as its first act (the
reference sets its ``XLA_FLAGS`` for 512 host devices there), and tests
start their own in a subprocess of their own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch.mesh import (init_fake_world, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import build_cell
from repro_torch.roofline.analysis import (analyze_step, collective_bytes,
                                           count_step, model_flops_for)
from repro_torch.roofline.analytic import bytes_model

GiB = 1 << 30

__all__ = ["run_cell", "run_probes", "main"]


def _skip(arch: str, shape_name: str) -> dict:
    return dict(arch=arch, shape=shape_name, status="skip",
                reason="full-attention arch: long_500k unsupported")


def _cfg(arch: str, kv_format: str | None, overrides: dict | None = None):
    cfg = get_arch(arch)
    if kv_format:
        cfg = dataclasses.replace(cfg, kv_format=kv_format)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, kv_format: str | None = None,
             extra_tags: str = "", mesh=None,
             cfg_overrides: dict | None = None, shape=None) -> dict:
    """One cell at full depth on the production mesh (or ``mesh``);
    ``shape`` (a ``ShapeConfig``) replaces ``SHAPES[shape_name]``."""
    cfg = _cfg(arch, kv_format, cfg_overrides)
    shape = shape or SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return _skip(arch, shape_name)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    chips = mesh.size()
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh)
    t_build = time.time() - t0
    rep = analyze_step(cell, model_flops_global=model_flops_for(cfg, shape),
                       chips=chips,
                       bytes_model=bytes_model(
                           cfg, shape, chips=chips,
                           tp=dict(zip(mesh.mesh_dim_names,
                                       tuple(mesh.shape))).get("model", 1),
                           mb=cell.meta.get("microbatch", 0)))
    mem = rep.memory_stats
    per_dev = mem["arg_bytes"] + mem["temp_bytes"]
    row = dict(
        arch=arch, shape=shape_name, status="ok", mesh=_mesh_name(mesh),
        chips=chips, kind=cell.meta["kind"],
        kv_format=kv_format or cfg.kv_format,
        build_s=round(t_build, 2), trace_s=round(mem["trace_s"], 2),
        ops=mem["ops"],
        arg_gib=round(mem["arg_bytes"] / GiB, 3),
        temp_gib=round(mem["temp_bytes"] / GiB, 3),
        out_gib=round(mem["out_bytes"] / GiB, 3),
        per_dev_gib=round(per_dev / GiB, 3),
        flops_per_dev=rep.flops,
        bytes_per_dev=rep.bytes_hbm,
        bytes_model_per_dev=rep.bytes_model,
        coll_bytes_per_dev=rep.bytes_coll,
        coll_by_op=rep.coll_by_op,
        t_compute=rep.t_compute, t_memory=rep.t_memory,
        t_memory_floor=rep.t_memory_floor,
        t_collective=rep.t_collective,
        dominant=rep.dominant, useful_flops_ratio=round(rep.useful_ratio, 4),
        model_flops_per_dev=rep.model_flops,
        step_roofline_fraction=round(rep.step_roofline_fraction, 4),
        microbatch=cell.meta.get("microbatch", 0),
        tags=extra_tags,
    )
    if verbose:
        print(f"[{arch} x {shape_name} @ {row['mesh']}] {row['kind']} "
              f"build={t_build:.1f}s trace={mem['trace_s']:.1f}s "
              f"({mem['ops']} local ops)")
        print(f"  memory/device: args={row['arg_gib']}GiB "
              f"temp={row['temp_gib']}GiB (counted peak) "
              f"out={row['out_gib']}GiB -> {row['per_dev_gib']}GiB")
        print(f"  flops/dev={rep.flops:.3e} bytes/dev={rep.bytes_hbm:.3e} "
              f"(floor {rep.bytes_model:.3e}) coll/dev={rep.bytes_coll:.3e} "
              f"{rep.coll_by_op}")
        print(f"  roofline: compute={rep.t_compute*1e3:.2f}ms "
              f"memory={rep.t_memory_floor*1e3:.2f}ms "
              f"(counted {rep.t_memory*1e3:.2f}ms) "
              f"collective={rep.t_collective*1e3:.2f}ms "
              f"-> dominant={rep.dominant} useful={rep.useful_ratio:.2%}")
    return row


def _mesh_from(spec: str | None, multi_pod: bool = False):
    if not spec:
        return make_production_mesh(multi_pod=multi_pod)
    dims = tuple(int(x) for x in spec.split("x"))
    return make_mesh(dims, ("pod", "data", "model")[-len(dims):])


def run_probes(arch: str, shape_name: str, *, kv_format: str | None = None,
               verbose: bool = True, mesh_spec: str | None = None,
               cfg_overrides: dict | None = None, mesh=None,
               shape=None) -> dict:
    """The full cell's costs extrapolated from 1- and 2-unit probe cells
    (``roofline.probe``), on the single-pod production mesh (or
    ``mesh_spec`` / ``mesh``); ``shape`` as for :func:`run_cell`."""
    from repro_torch.roofline.probe import extrapolate, probe_plan

    cfg = _cfg(arch, kv_format, cfg_overrides)
    shape = shape or SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return _skip(arch, shape_name)
    mesh = mesh if mesh is not None else _mesh_from(mesh_spec)
    probes = {}
    mb_real = 0
    t_all = time.time()
    for tag, pcfg in probe_plan(cfg, shape):
        t0 = time.time()
        cell = build_cell(pcfg, shape, mesh)
        mode, out, _ = count_step(cell.step, cell.args)
        del out
        coll = collective_bytes(mode.records)
        probes[tag] = dict(
            flops=float(mode.flops),
            bytes=float(mode.bytes),
            coll=float(sum(coll.values())),
            coll_by_op={k: float(v) for k, v in coll.items() if v},
        )
        if verbose:
            print(f"  probe {tag:7s} ({time.time()-t0:5.1f}s): "
                  f"flops={probes[tag]['flops']:.3e} "
                  f"bytes={probes[tag]['bytes']:.3e} "
                  f"coll={probes[tag]['coll']:.3e}")
        if tag == "u1_m1" and shape.kind == "train":
            # real microbatch factor chosen the same way build_cell does
            mb_real = build_cell(cfg, shape, mesh).meta["microbatch"]
    tp = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get("model", 1)
    rep = extrapolate(cfg, shape, probes, chips=mesh.size(),
                      mb_real=mb_real, tp=tp)
    row = dict(
        arch=arch, shape=shape_name, status="ok", kind=shape.kind,
        mesh=_mesh_name(mesh), chips=mesh.size(), probe=True,
        kv_format=kv_format or cfg.kv_format,
        trace_s=round(time.time() - t_all, 2),
        flops_per_dev=rep.flops, bytes_per_dev=rep.bytes_hbm,
        bytes_model_per_dev=rep.bytes_model,
        coll_bytes_per_dev=rep.bytes_coll, coll_by_op=rep.coll_by_op,
        t_compute=rep.t_compute, t_memory=rep.t_memory,
        t_memory_floor=rep.t_memory_floor,
        t_collective=rep.t_collective, dominant=rep.dominant,
        useful_flops_ratio=round(rep.useful_ratio, 4),
        model_flops_per_dev=rep.model_flops,
        roofline_fraction=round(rep.roofline_fraction, 4),
        step_roofline_fraction=round(rep.step_roofline_fraction, 4),
        mb_real=mb_real,
    )
    if verbose:
        print(f"[probe {arch} x {shape_name}] flops/dev={rep.flops:.3e} "
              f"bytes/dev={rep.bytes_hbm:.3e} (floor {rep.bytes_model:.3e}) "
              f"coll/dev={rep.bytes_coll:.3e}")
        print(f"  roofline: compute={rep.t_compute*1e3:.3f}ms "
              f"memory={rep.t_memory_floor*1e3:.3f}ms"
              f" (counted {rep.t_memory*1e3:.3f}ms) "
              f"collective={rep.t_collective*1e3:.3f}ms -> "
              f"dominant={rep.dominant} useful={rep.useful_ratio:.2%} "
              f"step_frac={rep.step_roofline_fraction:.2%}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kv-format", default=None,
                    help="override cfg.kv_format (e.g. bf16 vs frsz2_16)")
    ap.add_argument("--json", default=None, help="append JSONL rows here")
    ap.add_argument("--probes", action="store_true",
                    help="count 1- and 2-unit probe cells and extrapolate "
                    "instead of the full-depth cells")
    ap.add_argument("--mesh", default=None,
                    help="another mesh than the production one, e.g. 1x1 "
                    "or 2x4 (data x model) or 2x2x2 (pod x data x model)")
    ap.add_argument("--batch", type=int, default=0,
                    help="the shape's global batch instead of its own")
    ap.add_argument("--seq", type=int, default=0,
                    help="the shape's sequence (decode: cache) length")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the architecture to this many layers")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="the architecture's gradient-accumulation steps")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all) required")
    # the fake group first, before any mesh: 512 ranks when a multi-pod
    # mesh is asked for (a mesh may cover fewer ranks than the group)
    dims = [int(x) for x in args.mesh.split("x")] if args.mesh else []
    init_fake_world(math.prod(dims) if dims else
                    512 if (args.multi_pod or args.both_meshes) else 256)
    mesh = _mesh_from(args.mesh) if args.mesh else None
    overrides = {k: v for k, v in (("num_layers", args.layers),
                                   ("microbatch", args.microbatch)) if v}

    def shape_of(name):
        s = SHAPES[name]
        if not (args.batch or args.seq):
            return None
        return dataclasses.replace(s, global_batch=args.batch or
                                   s.global_batch,
                                   seq_len=args.seq or s.seq_len)

    cells = ([(a, s) for a in sorted(ARCHS) for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    rows, failed = [], []
    for arch, shp in cells:
        for mp in meshes:
            if args.probes and mp:
                continue                    # the roofline is single-pod
            try:
                kw = dict(kv_format=args.kv_format, mesh=mesh,
                          shape=shape_of(shp), cfg_overrides=overrides)
                if args.probes:
                    row = run_probes(arch, shp, **kw)
                else:
                    row = run_cell(arch, shp, multi_pod=mp, **kw)
            except Exception as e:          # a failed cell is a row
                traceback.print_exc()
                row = dict(arch=arch, shape=shp, status="fail",
                           multi_pod=mp, probe=args.probes,
                           error=f"{type(e).__name__}: {e}")
                failed.append(row)
            rows.append(row)
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps(row) + "\n")
    ok = sum(r["status"] == "ok" for r in rows)
    skip = sum(r["status"] == "skip" for r in rows)
    print(f"\n== dry-run: {ok} ok, {skip} documented-skip, "
          f"{len(failed)} failed ==")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
