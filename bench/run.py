"""Run one cell of the port's benchmark once, and print its result line.

    python3 bench/run.py --workload atmosmodd.frsz2_32 --seed 12345 \\
        --seconds 30 --trace 0

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell (``workloads``) names its configuration
(``bench/configs/<config>.json``) and its traffic mix
(``bench/traffic/<traffic>.json``, the parameters of the one generator,
``bench/solve.py``); each metric is read by a file of its own,
``bench/metrics/<name>.py`` (``read(run)``: a number, or ``None`` where it
finds nothing to read).  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, from a run under
``torch.profiler``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the last lines of standard error repeat the checks.  Exit codes: 0 a
result; 2 no CUDA card or too few for the cell; 3 JAX or the JAX package
was loaded in this process.  The measured program is the PyTorch port
``repro_torch`` under ``src/``; a checkout without it fails to import it.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()                 # the run's set-up starts here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: the top-level modules that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    # run as a script, this file's folder heads the path; its modules are
    # imported as ``bench.*`` instead (``bench/trace.py`` would shadow the
    # standard library's ``trace``)
    sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve()
                   != BENCH]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def _module(path: pathlib.Path):
    name = "bench_" + path.stem.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer metrics (those that list it, and those
    without a list that move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules() -> list[str]:
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", overrides: dict | None = None, spans=None):
    """One run of ``workload``: ``(result line as a dict, the run, its
    spans)``.  ``overrides`` replaces keys of the configuration (the CPU
    tests' small sizes)."""
    import torch

    from bench import solve
    from bench.trace import Spans

    bench = spec()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = _json(BENCH / "configs" / f"{cell['config']}.json")
    config.update(overrides or {})
    traffic = _json(BENCH / "traffic" / f"{cell['traffic']}.json")
    spans = Spans(T0) if spans is None else spans
    r = solve.run_cell(cell, config, traffic, seed=seed, seconds=seconds,
                      trace=trace, device=device, t0=T0, spans=spans)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = _module(BENCH / "metrics" / f"{m['name']}.py").read(r)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    cuda = torch.device(device).type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu", kind=r.device,
               count=int(cell["chips"]) if cuda else 0,
               memory_peak_bytes=r.process_peak_bytes or 0)
    line = dict(correct=bool(r.correct), attempted=r.attempted,
                failed=r.failed, metrics=metrics, device=dev)
    if trace and r.trace is not None:
        dev.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
        line["breakdown"] = r.trace.breakdown()
    if trace:
        out = ROOT / "build" / "bench" / "trace"
        spans.write(out / f"{workload}.seed{seed}.spans.json")
        if r.trace is not None:
            (out / f"{workload}.seed{seed}.kernels.json").write_text(
                json.dumps(r.trace.kernels()))
    line["checks"] = r.checks
    return line, r, spans


def main(argv=None, *, device: str = "cuda", overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from bench.trace import Spans

    spans = Spans(T0)
    with spans("torch_import"):
        import torch
    if device == "cuda":
        cell = next(w for w in spec()["workloads"]
                    if w["name"] == args.workload)
        with spans("cuda_query"):
            have = (torch.cuda.device_count() if torch.cuda.is_available()
                    else 0)
        if have < int(cell["chips"]):
            print(f"[bench] {args.workload} needs {cell['chips']} CUDA "
                  f"card(s); this machine has {have}", file=sys.stderr)
            return 2
    line, r, spans = run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device=device, overrides=overrides,
                         spans=spans)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    setup = {k: round(spans.seconds(k), 4) for k in
             ("torch_import", "cuda_query", "imports", "cuda_init",
              "operator", "library", "warmup") if spans.seconds(k)}
    lat = [q.latency_s for q in r.requests]
    its = sorted(i for q in r.requests for i in q.iterations)
    cyc = sorted(len(q.live) for q in r.requests)
    print(f"[bench] {args.workload} seed {args.seed}: set-up "
          f"{r.setup_s:.3f} s {setup}; {len(lat)} requests, "
          f"{r.attempted} right-hand sides in {r.window_s:.3f} s; latency "
          f"samples {len(lat)}; iterations a right-hand side "
          f"{its[0]}..{its[-1]} (median {its[len(its) // 2]}); cycles "
          f"{cyc[0]}..{cyc[-1]}; program peak "
          f"{r.program_peak_bytes} B of {r.process_peak_bytes} B",
          file=sys.stderr)
    if args.trace:
        print(f"[bench] card: {_power_limit()}", file=sys.stderr)
    print(f"[bench] checked {r.checked} right-hand sides; largest true "
          f"rrn {r.rrn_max!r} (target {r.config['target_rrn']})",
          file=sys.stderr)
    for name, c in r.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
