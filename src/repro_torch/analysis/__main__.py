"""CLI for the gate: ``python -m repro_torch.analysis --check``.

Modes
-----

``--check`` (default)
    Stage 1 lint over the port (``src/repro_torch``,
    ``tests/test_torch_*.py``, ``chip_smoke.py``), the stage 2 audits, then
    the stage 3 census and reads audit.  The sharded legs (the sharded
    recapture audit, the census) run in one spawned world
    (``repro_torch.dist.spawn``): 8 gloo ranks with ``--device cpu``, one
    NCCL rank a card with ``--device cuda`` (the default; without a card
    it raises).  A leg that fails is a finding.  Exit 0 iff no findings.
``--lint-only`` / ``--audit-only`` / ``--spmd-only``
    Run one stage.  ``--paths`` restricts the lint to specific files or
    directories; ``--no-sharded`` skips the world.
``--list-rules``
    Print the rule table with each rule's rationale, and the JAX package's
    rules that have no counterpart here.
``--format {text,json,github}``
    ``json`` emits the findings as a JSON array (``[]`` when clean);
    ``github`` appends ``::error`` workflow annotations after the text
    report so violations land inline on a pull request's diff.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import textwrap
from pathlib import Path

from repro_torch.analysis.astlint import lint_paths
from repro_torch.analysis.report import Finding, format_findings
from repro_torch.analysis.rules import NO_COUNTERPART, RULES

#: the tool's name in the report's summary line and the annotations' titles
TOOL = "graphlint"
#: ranks of the CPU world (the JAX package's audits emulate 8 devices)
CPU_WORLD = 8
#: seconds the world may take
WORLD_DEADLINE_S = 600.0


def _repo_root() -> Path:
    # src/repro_torch/analysis/__main__.py -> three levels above src
    return Path(__file__).resolve().parents[3]


def _default_lint_paths() -> list[str]:
    root = _repo_root()
    paths = [root / "src" / "repro_torch", root / "chip_smoke.py",
             *sorted((root / "tests").glob("test_torch_*.py"))]
    return [str(p) for p in paths if p.exists()]


def _leg(fn, path: str, rule: str, what: str) -> list[Finding]:
    """Run one leg; a leg that raises is a finding, never a clean one."""
    try:
        return fn()
    except Exception as e:                      # reported as a finding
        return [Finding(path=path, line=0, rule=rule, message=(
            f"{what} did not run to its end: {type(e).__name__}: "
            + " | ".join(str(e).splitlines()[-3:])))]


def _run_world(device: str, stages: tuple) -> list[Finding]:
    import torch

    from repro_torch.analysis.traffic import world_rank
    from repro_torch.dist import spawn

    P = CPU_WORLD if device == "cpu" else torch.cuda.device_count()
    return spawn(world_rank, P, stages, device=device,
                 timeout_s=WORLD_DEADLINE_S)


def _list_rules() -> int:
    for rule in RULES.values():
        print(f"{rule.id}: {rule.summary}")
        print(textwrap.indent(textwrap.fill(rule.rationale, width=72), "    "))
        print()
    print("no counterpart in the port:")
    for rid, why in NO_COUNTERPART.items():
        print(f"{rid}:")
        print(textwrap.indent(textwrap.fill(why, width=72), "    "))
    return 0


def _annotation_escape(text: str) -> str:
    return text.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


def _annotation(f: Finding, tool: str = TOOL) -> str:
    """One GitHub Actions ``::error`` workflow command per finding."""
    title = _annotation_escape(f"{tool}[{f.rule}]")
    msg = _annotation_escape(f.message)
    if f.line:  # a real file location -> annotate the diff line
        return (f"::error file={f.path},line={f.line},col={f.col + 1},"
                f"title={title}::{msg}")
    # symbolic locations (trace:/traffic:) carry the path in the text
    return f"::error title={title}::{_annotation_escape(f.path)}: {msg}"


def _report(findings: list[Finding], fmt: str, stages: list[str],
            tool: str = TOOL) -> int:
    if fmt == "json":
        ordered = sorted(findings, key=lambda f: (f.path, f.line, f.col,
                                                  f.rule))
        print(json.dumps([dataclasses.asdict(f) for f in ordered], indent=2))
        return 1 if findings else 0
    if findings:
        print(format_findings(findings))
        if fmt == "github":
            for f in sorted(findings, key=lambda f: (f.path, f.line)):
                print(_annotation(f, tool))
        print(f"{tool}: {len(findings)} finding(s)")
        return 1
    print(f"{tool}: clean ({', '.join(stages)})")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Graph-capture lint, audits and collective census.",
    )
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="lint + audits + census (the gate; default)")
    mode.add_argument("--lint-only", action="store_true",
                      help="stage 1 AST lint only")
    mode.add_argument("--audit-only", action="store_true",
                      help="stage 2 audits only")
    mode.add_argument("--spmd-only", action="store_true",
                      help="stage 3 census and reads audit only")
    mode.add_argument("--list-rules", action="store_true",
                      help="print the rule table and exit")
    ap.add_argument("--paths", nargs="*", default=None, metavar="PATH",
                    help="restrict the lint to these files/directories")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the spawned world's legs")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text", dest="fmt",
                    help="report format (default: text)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the audits run (default: cuda)")
    args = ap.parse_args(argv)

    if args.list_rules:
        return _list_rules()

    one_stage = args.lint_only or args.audit_only or args.spmd_only
    do_lint = args.lint_only or not one_stage
    do_audit = args.audit_only or not one_stage
    do_spmd = args.spmd_only or not one_stage
    if do_audit or do_spmd:
        from repro_torch.device import resolve_device

        resolve_device(args.device)              # no card: raise

    findings: list[Finding] = []
    stages: list[str] = []
    if do_lint:
        paths = args.paths if args.paths else _default_lint_paths()
        findings += lint_paths(paths)
        stages.append("lint")
    if do_audit:
        from repro_torch.analysis.traceaudit import run_local_audits

        findings += _leg(lambda: run_local_audits(args.device),
                         "trace:local", "retrace", "the local audits")
    if do_spmd:
        from repro_torch.analysis.traffic import run_local_traffic

        findings += _leg(lambda: run_local_traffic(args.device),
                         "traffic:reads", "reads-model", "the reads audit")
    world = tuple(s for s, on in (("audit", do_audit), ("spmd", do_spmd))
                  if on)
    if world and not args.no_sharded:
        rule = "retrace" if do_audit else "wire-model"
        findings += _leg(lambda: _run_world(args.device, world),
                         "trace:sharded", rule, "the sharded world")
    if do_audit:
        stages.append("audit" + ("" if args.no_sharded else "+sharded"))
    if do_spmd:
        stages.append("spmd" + ("" if args.no_sharded else "+sharded"))
    return _report(findings, args.fmt, stages)


if __name__ == "__main__":
    sys.exit(main())
