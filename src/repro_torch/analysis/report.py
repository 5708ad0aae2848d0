"""Findings: the one currency every stage of the gate trades in.

A :class:`Finding` pins a violation to a location (``path:line`` for the
AST lint, a symbolic ``trace:<audit>`` or ``traffic:<audit>`` location for
the audits and the census), names the rule that fired, and carries a
one-line human message.  ``format_findings`` renders the CLI report; CI
parses nothing: the exit status is the contract.  The rendering is the
JAX package's, byte for byte.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Finding", "format_findings"]


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str                 # file path, or "trace:<audit>" for stage 2
    line: int                 # 1-based source line; 0 for trace findings
    rule: str                 # rule id (see repro_torch.analysis.rules.RULES)
    message: str              # one line, human-readable
    col: int = 0              # 0-based column of the offending node

    def location(self) -> str:
        if self.line:
            return f"{self.path}:{self.line}:{self.col + 1}"
        return self.path

    def render(self) -> str:
        return f"{self.location()}: [{self.rule}] {self.message}"


def format_findings(findings: list[Finding]) -> str:
    """Stable, grep-friendly report: one line per finding, sorted."""
    lines = [
        f.render()
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.col,
                                                 f.rule))
    ]
    return "\n".join(lines)
