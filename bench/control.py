"""The control and the planted faults: runs that the comparison must fail.

    python3 bench/control.py --workload atmosmodd.frsz2_32 \\
        --seeds 11,12,13 --seconds 5 --fault control

drives the harness's whole run of a cell (set-up, window, check) on the
card, once a seed, with the timed path replaced or broken underneath, and
prints each run's checks as one JSON line.  The benchmark's own runs never
do this.  ``--fault``:

* ``control``: the plain reference (:func:`bench.reference.plain_gmres`)
  in float32, the precision below the configuration's float64, in the
  program's place;
* ``unchanged``: the program's solve, its solution state returned
  unchanged (``x`` left at its initial zero);
* ``altered``: the program's solve, one entry of each answer altered by a
  millionth of the answer's largest entry where it is produced;
* ``half``: the program's block solve with half of the batch's
  right-hand sides left out (returned unsolved).

:func:`patched` plants the same faults in the CPU tests at small sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys

FAULTS = ("control", "unchanged", "altered", "half")


@dataclasses.dataclass
class _Result:
    """What the harness reads of a solve."""

    x: object
    iterations: int
    converged: bool
    fired: object
    rrn_history: object


@contextlib.contextmanager
def patched(fault: str, config: dict):
    """``repro_torch.solver.gmres`` and ``gmres_batched`` replaced or
    broken by ``fault`` for the duration."""
    import numpy as np
    import torch

    import repro_torch.solver as solver
    from bench import operators, reference

    real_one, real_many = solver.gmres, solver.gmres_batched
    ops = {}

    def control_one(A, b, **kw):
        if "ell" not in ops:
            ops["ell"] = reference.PlainEll(*operators.load(config),
                                            b.device, torch.float32)
        m, cap = kw["m"], kw["max_iters"]
        x = reference.plain_gmres(ops["ell"], b.float(), m=m,
                                  target=kw["target_rrn"], max_iters=cap)
        cycles = -(-cap // m)
        return _Result(x=x.double(), iterations=cap, converged=True,
                       fired=np.zeros((cycles, m), bool),
                       rrn_history=np.ones(cycles * m))

    def one(A, b, **kw):
        if fault == "control":
            return control_one(A, b, **kw)
        r = real_one(A, b, **kw)
        return _broken([r])[0]

    def many(A, B, **kw):
        if fault == "control":
            return [control_one(A, b, **kw) for b in B]
        return _broken(real_many(A, B, **kw))

    def _broken(results):
        if fault == "unchanged":
            for r in results:
                r.x = torch.zeros_like(r.x)
        elif fault == "altered":
            for r in results:
                r.x = r.x.clone()
                r.x[r.x.shape[0] // 2] += 1e-6 * float(r.x.abs().max())
        elif fault == "half":
            for r in results[len(results) // 2:]:
                r.x = torch.zeros_like(r.x)
        return results

    solver.gmres, solver.gmres_batched = one, many
    try:
        yield
    finally:
        solver.gmres, solver.gmres_batched = real_one, real_many


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != root / "bench"]
    sys.path[:0] = [str(root / "src"), str(root)]
    from bench import run as bench_run

    bench_run._paths()
    cell = next(w for w in bench_run.spec()["workloads"]
                if w["name"] == args.workload)
    config = json.loads((root / "bench" / "configs"
                         / f"{cell['config']}.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        with patched(args.fault, config):
            line, r, _ = bench_run.run(args.workload, seed, args.seconds,
                                       False)
        print(json.dumps(dict(workload=args.workload, fault=args.fault,
                              seed=seed, correct=line["correct"],
                              requests=len(r.requests), checked=r.checked,
                              rrn_max=r.rrn_max, checks=line["checks"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
