"""The port's analysis gate (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

* **Parity.**  ``format_findings``, ``--format json`` and ``--format
  github`` render the same findings byte for byte (the github titles with
  the tool named as the reference names it: the port's CLI calls itself
  ``graphlint``); the rule ids plus ``NO_COUNTERPART`` are the reference's
  ``RULES``; ``halo_bytes``, ``pmean_bytes`` and ``registry.cells`` are
  ``==`` the reference's.
* **Lint pairs.**  Each lint case of ``tests/test_analysis.py`` that has a
  counterpart, as a JAX snippet and its torch twin (``@jax.jit`` becomes the
  ``# graphlint: captured`` pragma, ``lax.psum`` a ``torch.distributed``
  call): the same rules fire on the same lines.  The whole port tree lints
  clean.
* **Audits are not vacuous.**  Each audit, with a violation planted, gives
  its finding: a ``.double()`` in a copy of the cycle (``f64-leak``), a
  drift between the format's byte model and its buffers (``reads-model``);
  in the 8-rank gloo world of ``tests/_torch_dist_cases.py`` (the
  collectives module's world, shared through its ``done`` mark): an extra
  ``psum`` (``wire-model``), a call on one rank only
  (``nonuniform-collective``), a bypassed partition cache (``retrace``);
  planted into the world's recorded calls: a malformed permutation
  (``bad-permutation``), a call on another group (``axis-mismatch``).
  The card's audits (recapture, host reads, the NCCL census) are in
  ``tests/test_torch_cuda.py``.
* **The fixed trajectory.**  ``bytes_read`` and ``op_reads`` ``==`` the JAX
  device driver's (``synth:atmosmod`` n 180, m 6, k 3; block p 3, m 4,
  k 2).
* **f32 arithmetic.**  An f32-arithmetic ``frsz2_16`` device solve matches
  the reference in iterations and restarts, its RRN within rtol 5e-3 (the
  port's least squares is f64 at every arithmetic dtype, the reference's
  in the arithmetic dtype).
"""
import dataclasses
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from repro.analysis import __main__ as JM
from repro.analysis import astlint as JL
from repro.analysis import report as JR
from repro.analysis.rules import RULES as JRULES
from repro_torch.analysis import __main__ as TM
from repro_torch.analysis import astlint as TL
from repro_torch.analysis import report as TR
from repro_torch.analysis import traceaudit, traffic
from repro_torch.analysis.rules import NO_COUNTERPART, RULES
from repro_torch.solver import gmres as tgmres

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# report and CLI formats: byte-equal
# ---------------------------------------------------------------------------

_FINDINGS = [
    dict(path="src/b.py", line=4, rule="host-sync", message="float() x",
         col=7),
    dict(path="src/a.py", line=12, rule="raw-collective", message="psum",
         col=0),
    dict(path="trace:device", line=0, rule="retrace",
         message="100% of it\nby 8 bytes"),
    dict(path="src/a.py", line=12, rule="f64-literal", message="f64",
         col=0),
]


def _both(rows):
    return ([JR.Finding(**r) for r in rows], [TR.Finding(**r) for r in rows])


def test_format_findings_byte_equal():
    jf, tf = _both(_FINDINGS)
    assert TR.format_findings(tf) == JR.format_findings(jf)
    assert [f.render() for f in tf] == [f.render() for f in jf]


@pytest.mark.parametrize("fmt", ["json", "github", "text"])
@pytest.mark.parametrize("rows", [_FINDINGS, []], ids=["findings", "clean"])
def test_report_byte_equal(capsys, fmt, rows):
    jf, tf = _both(rows)
    rc_j = JM._report(jf, fmt, ["lint", "audit"])
    out_j = capsys.readouterr().out
    rc_t = TM._report(tf, fmt, ["lint", "audit"], tool="jaxlint")
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j)
    if fmt == "json":                  # the port's own name changes nothing
        TM._report(tf, fmt, ["lint", "audit"])
        assert capsys.readouterr().out == out_j


def test_rule_ids_are_the_references():
    assert set(RULES) | set(NO_COUNTERPART) == set(JRULES)
    assert not set(RULES) & set(NO_COUNTERPART)
    assert set(NO_COUNTERPART) == {"carry-drop", "spec-mismatch"}
    for r in RULES.values():
        text = (r.summary + r.rationale).lower()
        assert "jaxpr" not in text and "tpu" not in text, r.id


def test_list_rules_prints_every_ported_rule(capsys):
    assert TM.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULES:
        assert f"{rid}: {RULES[rid].summary}" in out
    for rid in NO_COUNTERPART:
        assert f"{rid}:" in out


# ---------------------------------------------------------------------------
# the three leftover functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strips", [(5,), (64, 17)])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_halo_bytes_equal_to_reference(strips, compressed, dt):
    from repro.dist import collectives as J
    from repro_torch.dist import collectives as T

    assert T.halo_bytes(strips, compressed=compressed,
                        dtype=getattr(torch, dt)) == J.halo_bytes(
        strips, compressed=compressed, dtype=getattr(jnp, dt))
    assert T.halo_bytes(strips, plain_itemsize=4) == J.halo_bytes(
        strips, plain_itemsize=4)


@pytest.mark.parametrize("compressed", [False, True])
def test_pmean_bytes_equal_to_reference(compressed):
    from repro.dist import collectives as J
    from repro_torch.dist import collectives as T

    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((5, 7)),
            "b": rng.standard_normal(300).astype(np.float32),
            "s": np.float64(2.0) * np.ones(()),
            "n": {"g": rng.standard_normal((2, 65)).astype(np.float32)}}
    jt = {k: (jnp.asarray(v) if not isinstance(v, dict)
              else {kk: jnp.asarray(vv) for kk, vv in v.items()})
          for k, v in tree.items()}
    tt = {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
              else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in tree.items()}
    assert T.pmean_bytes(tt, compressed=compressed) == J.pmean_bytes(
        jt, compressed=compressed)


def test_cells_equal_to_reference():
    from repro.configs.registry import cells as jcells
    from repro_torch.configs.registry import cells

    got = list(cells())
    assert got == list(jcells())
    assert len(got) > 0 and len(set(got)) == len(got)


# ---------------------------------------------------------------------------
# lint pairs: a JAX snippet and its torch twin fire the same rules on the
# same lines
# ---------------------------------------------------------------------------

_PAIRS = {
    "host_sync_if_on_traced_arg": (
        "import jax\n@jax.jit\ndef f(x):\n    if x > 0:\n        return x\n"
        "    return -x\n",
        "import torch\n\ndef f(x):  # graphlint: captured\n    if x > 0:\n"
        "        return x\n    return -x\n", ["host-sync"]),
    "host_sync_float_cast_and_item": (
        "import jax\n@jax.jit\ndef f(x):\n    a = float(x)\n"
        "    b = x.item()\n    return a + b\n",
        "import torch\n\ndef f(x):  # graphlint: captured\n    a = float(x)\n"
        "    b = x.item()\n    return a + b\n", ["host-sync"]),
    "host_sync_numpy_call_on_traced_value": (
        "import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n"
        "    return np.linalg.norm(x)\n",
        "import torch\nimport numpy as np\n\n"
        "def f(x):  # graphlint: captured\n    return np.linalg.norm(x)\n",
        ["host-sync"]),
    "host_sync_loop_body_is_traced": (
        "import jax\ndef solve(b):\n    def body(s):\n        if s > 0:\n"
        "            return s - 1\n        return s\n"
        "    return jax.lax.while_loop(lambda s: s > 0, body, b)\n",
        "import torch\ndef solve(b):\n    def body(s):\n        if s > 0:\n"
        "            return s - 1\n        return s\n"
        "    return _capture(body)\n", ["host-sync"]),
    "host_sync_static_attrs_ok": (
        "import jax\n@jax.jit\ndef f(x):\n    if x.ndim > 1:\n"
        "        x = x.sum(axis=0)\n    n = len(x.shape)\n    return x * n\n",
        "import torch\n\ndef f(x):  # graphlint: captured\n"
        "    if x.ndim > 1:\n        x = x.sum(0)\n    n = len(x.shape)\n"
        "    return x * n\n", []),
    "host_sync_untraced_function_ok": (
        "def prep(x):\n    if x > 0:\n        return float(x)\n"
        "    return 0.0\n",
        "def prep(x):\n    if x > 0:\n        return float(x)\n"
        "    return 0.0\n", []),
    "host_sync_nested_builder_params_not_tainted": (
        "import jax\n@jax.jit\ndef f(x):\n    def at(k):\n        if k == 0:\n"
        "            return x\n        return x * k\n"
        "    return at(0) + at(1)\n",
        "import torch\n\ndef f(x):  # graphlint: captured\n    def at(k):\n"
        "        if k == 0:\n            return x\n        return x * k\n"
        "    return at(0) + at(1)\n", []),
    "f64_astype_in_jit": (
        "import jax\n@jax.jit\ndef f(x):\n    return x.astype('float64')\n",
        "import torch\n\ndef f(x):  # graphlint: captured\n"
        "    return x.to(torch.float64)\n", ["f64-literal"]),
    "f64_dtype_kwarg_and_jnp_float64": (
        "import jax\nimport jax.numpy as jnp\n@jax.jit\ndef f(x):\n"
        "    z = jnp.zeros(3, dtype=jnp.float64)\n"
        "    return z + jnp.float64(x)\n",
        "import torch\n\n\ndef f(x):  # graphlint: captured\n"
        "    z = torch.zeros(3, dtype=torch.double)\n"
        "    return z + x.double()\n", ["f64-literal"]),
    "f64_outside_traced_code_ok": (
        "import numpy as np\ndef prep(a):\n"
        "    return np.asarray(a, dtype='float64')\n",
        "import torch\ndef prep(a):\n"
        "    return torch.as_tensor(a, dtype=torch.float64)\n", []),
    "raw_collective_attribute_call": (
        "import jax\ndef reduce(x, axis):\n    return jax.lax.psum(x, axis)\n",
        "import torch\ndef reduce(x, group):\n"
        "    return torch.distributed.all_reduce(x, group=group)\n",
        ["raw-collective"]),
    "raw_collective_from_import": (
        "from jax.lax import ppermute\ndef shift(x, axis, perm):\n"
        "    return ppermute(x, axis, perm)\n",
        "from torch.distributed import batch_isend_irecv\n"
        "def shift(ops):\n    return batch_isend_irecv(ops)\n",
        ["raw-collective"]),
    "raw_collective_lax_module_alias": (
        "from jax import lax as L\ndef reduce(x, axis):\n"
        "    return L.psum(x, axis)\n",
        "from torch import distributed as D\ndef reduce(x, group):\n"
        "    return D.all_reduce(x, group=group)\n", ["raw-collective"]),
    "raw_collective_import_jax_lax_as": (
        "import jax.lax as jl\ndef shift(x, axis, perm):\n"
        "    return jl.ppermute(x, axis, perm)\n",
        "import torch.distributed as td\ndef gather(out, x):\n"
        "    return td.all_gather_into_tensor(out, x)\n", ["raw-collective"]),
    "raw_collective_renamed_from_import": (
        "from jax.lax import psum as p\ndef reduce(x, axis):\n"
        "    return p(x, axis)\n",
        "from torch.distributed import all_reduce as p\ndef reduce(x, g):\n"
        "    return p(x, group=g)\n", ["raw-collective"]),
    "raw_collective_via_functools_partial": (
        "import functools\nfrom jax import lax\n"
        "shift = functools.partial(lax.ppermute, axis_name='basis')\n",
        "import functools\nimport torch.distributed as dist\n"
        "reduce = functools.partial(dist.all_reduce, group=None)\n",
        ["raw-collective"]),
    "partial_of_noncollective_ok": (
        "import functools\nfrom jax import lax\n"
        "clip = functools.partial(lax.clamp, 0.0)\n",
        "import functools\nimport torch.distributed as dist\n"
        "rank = functools.partial(dist.get_rank, None)\n", []),
    "axis_index_is_not_a_collective": (
        "import jax\ndef who(axis):\n    return jax.lax.axis_index(axis)\n",
        "import torch\ndef who(group):\n"
        "    return torch.distributed.get_rank(group)\n", []),
    "pragma_ok_suppresses_named_rule": (
        "import jax\n@jax.jit\ndef f(x, steps=3):\n"
        "    n = int(steps)  # jaxlint: ok[host-sync] static config\n"
        "    return x * n\n",
        "import torch\n\ndef f(x, steps=3):  # graphlint: captured\n"
        "    n = int(steps)  # graphlint: ok[host-sync] static config\n"
        "    return x * n\n", []),
    "pragma_ok_wrong_rule_does_not_suppress": (
        "import jax\n@jax.jit\ndef f(x):\n"
        "    return float(x)  # jaxlint: ok[f64-literal]\n",
        "import torch\n\ndef f(x):  # graphlint: captured\n"
        "    return float(x)  # graphlint: ok[f64-literal]\n", ["host-sync"]),
}

_OUTSIDE = {"jax": "src/repro/solver/somewhere.py",
            "torch": "src/repro_torch/solver/somewhere.py"}


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_lint_pair_fires_the_same_rule_on_the_same_line(name):
    jsrc, tsrc, rules = _PAIRS[name]
    jf = JL.lint_source(jsrc, _OUTSIDE["jax"])
    tf = TL.lint_source(tsrc, _OUTSIDE["torch"])
    assert sorted({f.rule for f in tf}) == rules
    assert [(f.rule, f.line) for f in tf] == [(f.rule, f.line) for f in jf]


def test_lint_raw_collective_allowed_in_its_homes():
    src = ("import torch.distributed as dist\ndef psum(x, g):\n"
           "    return dist.all_reduce(x, group=g)\n")
    for home in ("dist/collectives.py", "dist/census.py", "dist/launch.py",
                 "dist/act_sharding.py", "launch/mesh.py",
                 "roofline/analysis.py"):
        assert TL.lint_source(src, f"src/repro_torch/{home}") == []
    assert [f.rule for f in TL.lint_source(
        src, "src/repro_torch/solver/gmres.py")] == ["raw-collective"]


def test_lint_sees_aliases_partials_and_functional_collectives():
    src = ("import functools\nimport torch.distributed as dist\n"
           "import torch.distributed._functional_collectives as funcol\n"
           "ar = dist.all_reduce\n"
           "def f(x):\n    ar(x)\n"
           "    g = functools.partial(dist.all_gather_object, [])\n"
           "    return funcol.all_reduce(x, 'sum', None)\n")
    f = TL.lint_source(src, "src/repro_torch/x.py")
    assert [(x.rule, x.line) for x in f] == [("raw-collective", 6),
                                             ("raw-collective", 7),
                                             ("raw-collective", 8)]
    assert "functools.partial" in f[1].message


def test_lint_pragma_captured_marks_a_function():
    src = ("def solve(b, x0):{pragma}\n    if b > 0:\n        return b\n"
           "    return x0\n")
    assert TL.lint_source(src.format(pragma="")) == []
    got = TL.lint_source(src.format(pragma="  # graphlint: captured"))
    assert [f.rule for f in got] == ["host-sync"]


def test_lint_roots_and_static_parameters():
    """The drivers' cycles are roots by name; a parameter annotated with a
    non-tensor type is fixed at capture, a method passed to ``_capture`` is
    captured, ``torch.is_tensor`` and ``.numel()`` are static."""
    src = ("import torch\n"
           "def _device_cycle(acc: object, r, fused: bool, m: int):\n"
           "    if fused and torch.is_tensor(r) and r.numel() > m:\n"
           "        pass\n"
           "    for j in range(m):\n"
           "        r = r * 2\n"
           "    return bool(r)\n"
           "class Cyc:\n"
           "    def _run(self):\n"
           "        torch.cuda.synchronize()\n"
           "    def __call__(self):\n"
           "        return _capture(self._run)\n")
    got = TL.lint_source(src, "src/repro_torch/solver/gmres.py")
    assert [(f.rule, f.line) for f in got] == [("host-sync", 7),
                                               ("host-sync", 10)]
    other = TL.lint_source(src, "src/repro_torch/solver/other.py")
    assert [(f.rule, f.line) for f in other] == [("host-sync", 10)]


def test_lint_device_if_branch_is_clean_and_named_in_the_message():
    """MGS's branch on the card, ``with device_if(fired) as put:``, lints
    clean in a captured root with no pragma; the Python ``if`` it replaces
    fires ``host-sync`` with a message that names the helper."""
    body = ("import torch\n"
            "from repro_torch.solver.graphs import device_if\n"
            "def _device_cycle(acc: object, w, h, eta: float, m: int):\n"
            "    for j in range(m):\n"
            "        hj1 = torch.linalg.vector_norm(w)\n"
            "        fired = hj1 < eta * w.abs().sum()\n"
            "{branch}"
            "    return w, h\n")
    clean = body.format(branch=(
        "        with device_if(fired) as put:\n"
        "            u = acc.dots(w)\n"
        "            put(h, h + u)\n"
        "            put(w, w - acc.combine(u))\n"))
    assert TL.lint_source(clean, "src/repro_torch/solver/gmres.py") == []
    bare = body.format(branch=(
        "        if fired:\n"
        "            u = acc.dots(w)\n"
        "            h = h + u\n"))
    got = TL.lint_source(bare, "src/repro_torch/solver/gmres.py")
    assert [(f.rule, f.line) for f in got] == [("host-sync", 7)]
    assert "device_if" in got[0].message and "torch.where" in got[0].message


def test_lint_roots_exist_and_the_block_pragma_is_needed():
    """Each of ``CAPTURED_ROOTS`` is a module-level function of its file;
    ``solver/block.py``'s ``bool(fired)`` is allowed by its pragma only:
    without it the captured root fires."""
    import ast
    import pathlib

    from repro_torch.analysis.rules import CAPTURED_ROOTS

    src_root = pathlib.Path(TL.__file__).parents[2]
    for suffix, name in CAPTURED_ROOTS:
        tree = ast.parse((src_root / suffix).read_text())
        assert name in {n.name for n in tree.body
                        if isinstance(n, ast.FunctionDef)}, (suffix, name)
    path = src_root / "repro_torch" / "solver" / "block.py"
    src = path.read_text()
    assert TL.lint_source(src, str(path)) == []
    bare = src.replace("  # graphlint: ok[host-sync] host route only", "")
    assert [f.rule for f in TL.lint_source(bare, str(path))] == ["host-sync"]


def test_full_port_tree_is_clean():
    findings = TL.lint_paths(TM._default_lint_paths())
    assert findings == [], "\n".join(f.render() for f in findings)
    names = {p.split("/")[-1] for p in TM._default_lint_paths()}
    assert {"repro_torch", "chip_smoke.py", "test_torch_analysis.py"} <= names


def test_cli_lint_json_and_github(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef f(x):  # graphlint: captured\n"
                   "    return float(x)\n")
    assert TM.main(["--lint-only", "--paths", str(bad), "--format",
                    "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert [(f["rule"], f["line"], f["path"]) for f in payload] == [
        ("host-sync", 4, str(bad))]
    assert TM.main(["--lint-only", "--paths", str(bad), "--format",
                    "github"]) == 1
    out = capsys.readouterr().out
    assert f"::error file={bad},line=4," in out
    assert "title=graphlint[host-sync]::" in out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert TM.main(["--lint-only", "--paths", str(good), "--format",
                    "json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


# ---------------------------------------------------------------------------
# stage 2 on the CPU: f64 leak and the recapture audit's CPU behaviour
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem32():
    return traceaudit.problem(180, "cpu", dtype=np.float32)[:2]


def test_f64_audit_clean_and_allows_only_the_state(problem32):
    info = {}
    assert traceaudit.audit_f64_leak(*problem32, info=info) == []
    assert set(info) == {"f64[frsz2_16, f32, fused]",
                         "f64[frsz2_16, f32, unfused]"}


def test_f64_audit_finds_a_planted_double(problem32):
    import importlib

    G = importlib.import_module("repro_torch.solver.gmres")

    def planted(matvec, acc, store, state, init, r, beta, b_norm, *rest):
        G._device_cycle(matvec, acc, store, state, init, r, beta, b_norm,
                        *rest)
        return r.double()

    got = traceaudit.audit_f64_leak(*problem32, cycle=planted)
    assert {f.rule for f in got} == {"f64-leak"} and len(got) == 2
    assert all("_to_copy" in f.message and "planted" in f.message
               for f in got)


def test_recapture_and_host_reads_need_the_card():
    A, b, _ = traceaudit.problem(180, "cpu")
    info = {}
    assert traceaudit.audit_recapture(A, b, info=info) == []
    assert traceaudit.audit_host_reads(A, b, info=info) == []
    assert "skipped" in info


# ---------------------------------------------------------------------------
# the fixed trajectory: the reads model, and parity with the JAX driver
# ---------------------------------------------------------------------------


def _jax_problem(n=180):
    from repro.sparse import make_problem, rhs_for

    A, _ = make_problem("synth:atmosmod", n)
    b, _ = rhs_for(A)
    return A, b


@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_fixed_trajectory_reads_equal_the_jax_device_driver(storage):
    from repro.solver import gmres as jgmres

    A, b, _ = traceaudit.problem(180, "cpu")
    info = {}
    assert traffic.audit_reads(A, b, storage=storage, m=6, k=3,
                               info=info) == []
    JA, jb = _jax_problem()
    rj = jgmres(JA, jb, storage=storage, driver="device",
                **traceaudit.fixed_trajectory(6, 3))
    row = info[f"reads[{storage}]"]
    assert (row["bytes_read"], row["op_reads"]) == (
        float(rj.bytes_read), float(rj.op_reads))
    assert row["iterations"] == [int(rj.iterations)] == [18]


@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_fixed_trajectory_block_reads_equal_the_jax_block_driver(storage):
    from repro.solver.block import gmres_block as jblock

    A, b, _ = traceaudit.problem(180, "cpu")
    info = {}
    assert traffic.audit_reads(A, b, storage=storage, m=4, k=2, p=3,
                               info=info) == []
    JA, jb = _jax_problem()
    B = traceaudit.block_rhs(torch.from_numpy(np.array(jb)), 3).numpy()
    rj = jblock(JA, jnp.asarray(B), storage=storage,
                **traceaudit.fixed_trajectory(4, 2))
    row = info[f"block-reads[{storage}, p=3]"]
    assert row["bytes_read"] == sum(float(r.bytes_read) for r in rj)
    assert row["op_reads"] == sum(float(r.op_reads) for r in rj)
    assert row["iterations"] == [int(r.iterations) for r in rj] == [8] * 3


@pytest.mark.parametrize("route", ["scalar", "block"])
@pytest.mark.parametrize("storage", ["float64", "frsz2_32"])
def test_mgs_fixed_trajectory_reads_follow_the_fired_slots(storage, route):
    """The reads audit's MGS case: each cycle reads ``_cycle_row_reads(m,
    1, extra)`` rows, ``extra`` from the cycle's fired slots; the JAX
    device driver's MGS solve on the same trajectory reports the same
    ``bytes_read`` and ``op_reads``."""
    from repro.solver import gmres as jgmres
    from repro.solver.block import gmres_block as jblock

    A, b, _ = traceaudit.problem(180, "cpu")
    JA, jb = _jax_problem()
    info = {}
    fixed = dict(traceaudit.fixed_trajectory(6 if route == "scalar" else 4,
                                             3 if route == "scalar" else 2),
                 ortho="mgs")
    if route == "scalar":
        assert traffic.audit_reads(A, b, storage=storage, m=6, k=3,
                                   info=info, ortho="mgs") == []
        row = info[f"reads[{storage}, mgs]"]
        rj = [jgmres(JA, jb, storage=storage, driver="device", **fixed)]
    else:
        assert traffic.audit_reads(A, b, storage=storage, m=4, k=2, p=3,
                                   info=info, ortho="mgs") == []
        row = info[f"block-reads[{storage}, p=3, mgs]"]
        B = traceaudit.block_rhs(torch.from_numpy(np.array(jb)), 3).numpy()
        rj = jblock(JA, jnp.asarray(B), storage=storage, **fixed)
    assert row["bytes_read"] == sum(float(r.bytes_read) for r in rj)
    assert row["op_reads"] == sum(float(r.op_reads) for r in rj)
    assert row["iterations"] == [int(r.iterations) for r in rj]
    assert len(row["fired_steps"]) == (3 if route == "scalar" else 2)


def test_reads_audit_finds_a_planted_drift(monkeypatch):
    """A format whose byte model drifts from its buffers (``nbytes`` one
    byte a row high) is a ``reads-model`` finding."""
    from repro_torch.core.accessor import BasisAccessor

    A, b, _ = traceaudit.problem(180, "cpu")
    nbytes = BasisAccessor.nbytes
    monkeypatch.setattr(BasisAccessor, "nbytes",
                        lambda self: nbytes(self) + self.m)
    got = traffic.audit_reads(A, b, storage="frsz2_32", m=6, k=3)
    assert [f.rule for f in got] == ["reads-model"]
    assert "store tensors hold" in got[0].message


def test_f32_arithmetic_frsz2_16_solve_matches_the_reference():
    """The probe of an f32-arithmetic solve: iterations and restarts equal,
    the RRN within rtol 5e-3 (the least squares' precision differs)."""
    from repro.solver import gmres as jgmres

    for n in (180, 512):
        A, b, target = traceaudit.problem(n, "cpu")
        JA, jb = _jax_problem(n)
        kw = dict(storage="frsz2_16", m=20, max_iters=400, target_rrn=1e-5,
                  driver="device")
        rt = tgmres(A, b, arith_dtype=torch.float32, **kw)
        rj = jgmres(JA, jb, arith_dtype=jnp.float32, **kw)
        assert (rt.iterations, rt.restarts) == (int(rj.iterations),
                                                int(rj.restarts)), n
        assert rt.rrn == pytest.approx(float(rj.rrn), rel=5e-3), n


# ---------------------------------------------------------------------------
# stage 3: the census in the 8-rank gloo world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The collectives module's world (its analysis step); whichever
    module takes the run's world lock first runs it."""
    import test_torch_collectives as TCOL

    d = C.worlds_dir(tmp_path_factory, "collectives")
    port_pkl = d / "port.pkl"
    C.run_worlds(d, TCOL.world_steps(d), once=True)
    with open(port_pkl, "rb") as f:
        return pickle.load(f)["analysis"]


def test_census_clean_and_equal_to_the_models(world):
    assert world["census"] == []
    info = world["info"]
    for label in ("rows", "halo", "halo+frsz2", "block3d", "block3d+frsz2"):
        row = info[f"matvec[{label}]"]
        assert row["priced"]["solve"] == row["model"]["solve"], label
        assert row["priced"]["solve"]["matvec"] > 0, label
    solve = info["census[rows]"]
    for bucket in ("solve", "cycle"):
        assert solve["priced"][bucket] == solve["model"][bucket]
    assert solve["priced"]["cycle"]["dots"] > 0


def test_census_finds_a_planted_extra_all_reduce(world):
    got = world["census_extra"]
    assert {f["rule"] for f in got} == {"wire-model"}
    assert all(f["path"] == "traffic:matvec[rows]" for f in got)


def test_census_finds_a_rank_dependent_call(world):
    got = world["census_rank"]
    assert [f["rule"] for f in got] == ["nonuniform-collective"]
    assert "rank 7" in got[0]["message"]


def test_sharded_recapture_clean_and_finds_a_bypassed_cache(world):
    assert world["recapture"] == []
    assert world["info"]["recapture[sharded]"]["partitions"] == 1
    got = world["recapture_planted"]
    assert [f["rule"] for f in got] == ["retrace"]


def test_census_checks_find_planted_permutations_and_groups(world):
    """The world's recorded halo calls, with a duplicated destination
    planted into one exchange, and a call moved to another group."""
    calls = world["calls"]["halo"]
    P = len(calls)
    group = tuple(range(P))
    i = next(i for i, c in enumerate(calls[0]) if c.perm)
    bad = tuple(calls[0][i].perm) + ((0, calls[0][i].perm[0][1]),)
    planted = [[dataclasses.replace(c, perm=bad) if j == i else c
                for j, c in enumerate(r)] for r in calls]
    want = {"solve": {"matvec": world["info"]["matvec[halo]"]["model"][
        "solve"]["matvec"]}}
    got, _ = traffic.check_census("t", planted, group, want, "planted")
    assert "bad-permutation" in {f.rule for f in got}
    moved = [[dataclasses.replace(c, group=group[:-1]) if j == 0 else c
              for j, c in enumerate(r)] for r in calls]
    got, _ = traffic.check_census("t", moved, group, want, "planted")
    assert "axis-mismatch" in {f.rule for f in got}
    assert traffic.check_census("t", calls, group, want, "real")[0] == []


def test_mgs_census_model_prices_the_fired_steps():
    """The census model of an MGS solve: one all-reduce of the dots and two
    norms a step, plus one of each a fired step; so no fired step is half
    CGS2's dots at CGS2's norms, every step fired is CGS2's dots plus a
    norm a step."""
    from repro_torch.dist.collectives import reduce_bytes
    from repro_torch.sparse import make_problem
    from repro_torch.sparse.plan import plan_operator

    A, _ = make_problem("synth:atmosmod", 256, device="cpu")
    plan = plan_operator(A, 4, reorder="none", matvec_mode="rows")
    m, k = 8, 2
    cgs2 = traffic.solve_census_model(plan, m, k)
    none = traffic.solve_census_model(plan, m, k, fired=[0, 0])
    every = traffic.solve_census_model(plan, m, k, fired=[m, m])
    some = traffic.solve_census_model(plan, m, k, fired=[3, 5])
    assert none["cycle"]["dots"] * 2 == cgs2["cycle"]["dots"]
    assert none["cycle"]["norms"] == cgs2["cycle"]["norms"]
    assert every["cycle"]["dots"] == cgs2["cycle"]["dots"]
    r1 = reduce_bytes(1, compressed=False)
    assert every["cycle"]["norms"] == cgs2["cycle"]["norms"] + k * m * r1
    dots1 = reduce_bytes(m + 1, compressed=False)
    assert some["cycle"]["dots"] == none["cycle"]["dots"] + 8 * dots1
    assert some["solve"] == cgs2["solve"] == none["solve"]
