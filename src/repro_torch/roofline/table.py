"""LM-cell roofline table from the dry run's JSONL rows, and the decode
cells' FRSZ2 win on the memory floor.

The port of ``benchmarks/lm_roofline.py``: ``load_rows`` reads the rows
that ``python -m repro_torch.launch.dryrun --json PATH`` appended (full
cells and ``--probes`` rows), and ``decode_format_deltas`` computes the
decode-cell memory floor (``roofline.analytic.bytes_model``) with bf16
against FRSZ2-coded KV caches: the paper's bandwidth saving carried over to
serving.

  python -m repro_torch.roofline --rows dryrun.jsonl [--rows more.jsonl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import ARCHS
from repro_torch.models.config import SHAPES
from repro_torch.roofline.analytic import bytes_model

__all__ = ["load_rows", "decode_format_deltas", "run", "main"]


def load_rows(paths) -> dict:
    """(arch, shape, mesh, probe, kv_format) -> the row; an ``ok`` row wins
    over a failed or skipped one of the same key."""
    rows = {}
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                r = json.loads(line)
                key = (r.get("arch"), r.get("shape"), r.get("mesh", ""),
                       bool(r.get("probe")), r.get("kv_format", ""))
                if r.get("status") == "ok":
                    rows[key] = r
                elif key not in rows:
                    rows[key] = r
    return rows


def decode_format_deltas(verbose=True):
    """Analytic decode memory floor, bf16 vs frsz2 caches, per device of
    the 16x16 mesh (256 chips, tp 16)."""
    out = []
    for aname, cfg in sorted(ARCHS.items()):
        shape = SHAPES["decode_32k"]
        if cfg.family == "ssm":
            continue
        row = dict(arch=aname)
        for fmt in ("bf16", "frsz2_16", "frsz2_8"):
            c = dataclasses.replace(cfg, kv_format=fmt)
            row[fmt] = bytes_model(c, shape, chips=256, tp=16)
        row["win_16"] = row["bf16"] / row["frsz2_16"]
        row["win_8"] = row["bf16"] / row["frsz2_8"]
        out.append(row)
        if verbose:
            print(f"{aname:24s} bf16={row['bf16']/1e9:6.2f}GB/dev "
                  f"frsz2_16={row['frsz2_16']/1e9:6.2f} "
                  f"(x{row['win_16']:.2f})  "
                  f"frsz2_8={row['frsz2_8']/1e9:6.2f} (x{row['win_8']:.2f})")
    return out


def run(paths=(), verbose=True):
    rows = load_rows(paths)
    full = [r for (a, s, mesh, probe, kv), r in rows.items()
            if not probe and r.get("status") == "ok"]
    probes = [r for (a, s, mesh, probe, kv), r in rows.items()
              if probe and r.get("status") == "ok"]
    skips = [r for r in rows.values() if r.get("status") == "skip"]
    fails = [r for r in rows.values() if r.get("status") == "fail"]
    if verbose:
        print(f"dry-run rows: {len(full)} traced ok, {len(skips)} "
              f"documented skips, {len(fails)} failures, "
              f"{len(probes)} probe rows")
        if full:
            print(f"\n{'arch':24s}{'shape':13s}{'mesh':9s}{'args GiB':>9s}"
                  f"{'temp GiB':>9s}{'dom':>11s}")
            for r in sorted(full, key=lambda r: (r["arch"], r["shape"],
                                                 r["mesh"])):
                print(f"{r['arch']:24s}{r['shape']:13s}{r['mesh']:9s}"
                      f"{r['arg_gib']:9.3f}{r['temp_gib']:9.3f}"
                      f"{r['dominant']:>11s}")
        if probes:
            print(f"\n{'arch':24s}{'shape':13s}{'dom':11s}"
                  f"{'t_cmp(ms)':>10s}{'t_mem(ms)':>10s}{'t_coll(ms)':>11s}"
                  f"{'step_frac':>10s}")
            for r in sorted(probes, key=lambda r: (r["arch"], r["shape"])):
                print(f"{r['arch']:24s}{r['shape']:13s}{r['dominant']:11s}"
                      f"{r['t_compute']*1e3:10.2f}"
                      f"{r.get('t_memory_floor', 0)*1e3:10.2f}"
                      f"{r['t_collective']*1e3:11.2f}"
                      f"{r.get('step_roofline_fraction', 0):10.2%}")
        print("\n== decode-cache FRSZ2 memory-floor win (paper technique) ==")
    decode_format_deltas(verbose=verbose)
    return dict(full=len(full), probes=len(probes), skips=len(skips),
                fails=len(fails))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", action="append", default=[],
                    help="a dry-run JSONL file (repeatable)")
    args = ap.parse_args(argv)
    run(args.rows)
    return 0
