"""repro_torch.analysis -- the port's gate: graph-capture lint, audits of
what the drivers run, and a recorded collective census.

Three stages (``python -m repro_torch.analysis --check``):

* **Stage 1 -- AST lint** (:mod:`repro_torch.analysis.astlint`): taint
  tracks the tensors of the functions a CUDA graph captures and flags host
  reads and Python branches on them and hard-coded f64 there, and
  ``torch.distributed`` calls outside their homes (aliases and
  ``functools.partial`` included).

* **Stage 2 -- audits** (:mod:`repro_torch.analysis.traceaudit`): a second
  same-shape solve captures no new graph, an frsz2_16 cycle at f32
  arithmetic makes no f64 tensor outside its least-squares state, a warmed
  solve makes exactly the host reads and copies its driver documents.

* **Stage 3 -- census** (:mod:`repro_torch.analysis.traffic`): records
  every collective the sharded matvecs and solve issue
  (:mod:`repro_torch.dist.census`), checks that every rank issued the same
  sequence, that exchanges pair up along well-formed permutations and run
  on the solve's group, and holds the wire model and the basis-read model
  (``bytes_read``/``op_reads`` on a fixed trajectory) to exact equality.

The port of the JAX package's ``repro/analysis``; rules, pragmas and the
rule ids it keeps live in :mod:`repro_torch.analysis.rules`.
"""
from repro_torch.analysis.astlint import lint_file, lint_paths, lint_source
from repro_torch.analysis.report import Finding, format_findings
from repro_torch.analysis.rules import NO_COUNTERPART, RULES, Rule

__all__ = [
    "NO_COUNTERPART",
    "RULES",
    "Finding",
    "Rule",
    "format_findings",
    "lint_file",
    "lint_paths",
    "lint_source",
]
