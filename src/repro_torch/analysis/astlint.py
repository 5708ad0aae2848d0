"""Stage 1: a graph-capture-aware AST lint over the port.

The pass is *scope-aware*: the rules about captured code fire only inside
functions whose bodies a CUDA graph captures --

  * the cycles the drivers capture (:data:`~repro_torch.analysis.rules.
    CAPTURED_ROOTS`: ``solver/gmres.py::_device_cycle`` and
    ``solver/block.py::_block_cycle``);
  * a function passed to a capturing call (``_capture(run)``, a name, an
    inline lambda or ``self.<method>``, resolved lexically);
  * a function defined inside a captured one (it runs during the capture);
  * a function carrying a ``# graphlint: captured`` pragma on its ``def``
    line.

Inside a captured function, *taint* starts at the parameters that hold
tensors and propagates through assignments.  A parameter annotated with
anything but a tensor (``eta: float``, ``acc: BasisAccessor``, ``matvec:
Callable``), and ``self``/``cls``, is static: it is fixed when the graph is
captured.  Reads that are static under capture -- ``.shape``, ``.ndim``,
``.dtype``, ``.device``, ``.is_cuda``, ``.numel()``, ``.size()``,
``len()``, ``isinstance()``, ``torch.is_tensor()`` -- scrub taint, so
configuration branches on shapes and flags never fire the rules.  Nested
defs inherit the taint of enclosing captured scopes only.

The module-wide ``raw-collective`` rule needs no capture context: a
``torch.distributed`` call that moves bytes (``all_reduce``,
``batch_isend_irecv``, the functional collectives, ...) is flagged anywhere
outside its homes (``rules.COLLECTIVE_HOMES``).  The rule resolves the
module's import bindings -- ``import torch.distributed as d``, ``from torch
import distributed as D``, ``from torch.distributed import all_reduce as
p`` -- a module-level alias ``f = dist.all_reduce``, and a collective
smuggled through ``functools.partial(dist.all_reduce, ...)``.

Deliberately shallow: calls *out* of a captured function are not followed
(mark the callee if it matters), and value flow beyond plain assignment is
not tracked.  The lint is a tripwire for the bug classes the drivers can
ship, not a proof system.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize

from repro_torch.analysis.report import Finding
from repro_torch.analysis.rules import (
    CAPTURE_CONSUMERS,
    CAPTURED_ROOTS,
    COLLECTIVE_HOMES,
    COLLECTIVE_MODULES,
    COLLECTIVE_PRIMITIVES,
    F64_DTYPE_NAMES,
    HOST_CAST_BUILTINS,
    HOST_SYNC_CALLS,
    HOST_SYNC_METHODS,
    NUMPY_MODULE_NAMES,
)

__all__ = ["lint_file", "lint_paths", "lint_source"]

_PRAGMA = re.compile(
    r"#\s*graphlint:\s*(ok|captured)\s*(?:\[\s*([a-zA-Z0-9_,\- ]*?)\s*\])?")

#: attribute reads that are static under capture (scrub taint)
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                           "itemsize", "layout"})
#: method calls that are static under capture, whatever the receiver
_STATIC_METHODS = frozenset({"numel", "dim", "size", "element_size",
                             "stride", "is_contiguous"})
#: calls that yield static values regardless of their arguments
_STATIC_CALLS = frozenset({"len", "isinstance", "type", "getattr",
                           "hasattr", "id", "repr", "str", "is_tensor"})
#: annotations that still name a tensor (a parameter so annotated is traced)
_TENSOR_ANNOTATIONS = ("Tensor",)

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _last_name(node) -> str | None:
    """Trailing identifier of a Name/Attribute chain (``a.b.c`` -> "c")."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_root(node) -> str | None:
    """Leading identifier of a Name/Attribute chain (``a.b.c`` -> "a")."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _static_param(arg: ast.arg) -> bool:
    """A parameter fixed at capture: annotated with a non-tensor type."""
    if arg.annotation is None:
        return False
    text = ast.unparse(arg.annotation)
    return not any(t in text for t in _TENSOR_ANNOTATIONS)


def _param_names(fn) -> set[str]:
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    names = [p.arg for p in params
             if p.arg not in ("self", "cls") and not _static_param(p)]
    for extra in (a.vararg, a.kwarg):
        if extra is not None and not _static_param(extra):
            names.append(extra.arg)
    return set(names)


def _assigned_names(target) -> set[str]:
    """Names bound by an assignment target (tuples/lists/stars unpacked)."""
    out: set[str] = set()
    for node in ast.walk(target):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


class _Pragmas:
    """Per-line ``# graphlint:`` pragmas, from the token stream."""

    def __init__(self, source: str):
        self.ok: dict[int, set[str] | None] = {}   # None = all rules
        self.captured: set[int] = set()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA.search(tok.string)
                if not m:
                    continue
                kind, rule_list = m.group(1), m.group(2)
                line = tok.start[0]
                if kind == "captured":
                    self.captured.add(line)
                elif rule_list:
                    rset = {r.strip() for r in rule_list.split(",")
                            if r.strip()}
                    prev = self.ok.get(line)
                    self.ok[line] = (None if prev is None and line in self.ok
                                     else (prev or set()) | rset)
                else:
                    self.ok[line] = None
        except tokenize.TokenError:      # a broken source: no pragmas
            pass

    def allows(self, line: int, rule: str) -> bool:
        if line not in self.ok:
            return False
        rules = self.ok[line]
        return rules is None or rule in rules


class _Scope:
    """One function (or module, or class) scope: local defs + parent."""

    def __init__(self, node, parent: _Scope | None):
        self.node = node
        self.parent = parent
        self.defs: dict[str, ast.AST] = {}     # local def name -> node
        self.children: list[_Scope] = []
        self.captured = False          # body runs during some capture
        self.captured_direct = False   # *this* function's params are traced

    def resolve(self, name: str):
        scope: _Scope | None = self
        while scope is not None:
            if name in scope.defs and not isinstance(scope.node,
                                                     ast.ClassDef):
                return scope.defs[name]
            scope = scope.parent
        return None


def _build_scopes(tree) -> tuple[_Scope, dict[ast.AST, _Scope]]:
    """Scope tree + node->scope map for every function/lambda/class def.

    A class body is a scope of its own, so that ``self.<method>`` resolves
    to the method, but it never resolves a bare name (Python's rule)."""
    root = _Scope(tree, None)
    by_node: dict[ast.AST, _Scope] = {tree: root}

    def visit(node, scope: _Scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*_FuncNode, ast.ClassDef)):
                sub = _Scope(child, scope)
                by_node[child] = sub
                scope.children.append(sub)
                if not isinstance(child, ast.Lambda):
                    scope.defs[child.name] = child
                visit(child, sub)
            else:
                visit(child, scope)

    visit(tree, root)
    return root, by_node


def _containing_scope(tree, by_node) -> dict[ast.AST, _Scope]:
    """Map every AST node to the innermost scope that owns it."""
    owner: dict[ast.AST, _Scope] = {}

    def visit(node, scope):
        owner[node] = scope
        for child in ast.iter_child_nodes(node):
            visit(child, by_node.get(child, scope))

    visit(tree, by_node[tree])
    return owner


def _enclosing_class(scope: _Scope | None):
    while scope is not None:
        if isinstance(scope.node, ast.ClassDef):
            return scope
        scope = scope.parent
    return None


def _mark_captured(tree, root, by_node, owner, pragmas, path) -> None:
    """Flip ``captured``/``captured_direct`` for provably-captured defs."""
    norm = path.replace(os.sep, "/")
    roots = {name for suffix, name in CAPTURED_ROOTS if norm.endswith(suffix)}
    # 1. the drivers' cycles, and the pragma
    for node, scope in by_node.items():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            top = scope.parent is root
            if (top and node.name in roots) or node.lineno in pragmas.captured:
                scope.captured_direct = True

    # 2. names/lambdas/self-methods passed to a capturing call
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _last_name(node.func) not in CAPTURE_CONSUMERS:
            continue
        scope = owner[node]
        candidates: list[ast.AST] = []
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Lambda):
                candidates.append(arg)
            elif isinstance(arg, ast.Name):
                resolved = scope.resolve(arg.id)
                if resolved is not None:
                    candidates.append(resolved)
            elif (isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id == "self"):
                cls = _enclosing_class(scope)
                if cls is not None and arg.attr in cls.defs:
                    candidates.append(cls.defs[arg.attr])
        for fn in candidates:
            if fn in by_node:
                by_node[fn].captured_direct = True

    # 3. everything nested inside a captured function runs during that
    # capture -- but only the evidenced functions get their *parameters*
    # tainted (a nested helper is called with static values)
    def flood(scope, inside):
        scope.captured = scope.captured_direct or (
            inside and scope.node is not root.node
            and not isinstance(scope.node, ast.ClassDef))
        for child in scope.children:
            flood(child, scope.captured)

    flood(root, False)


# ---------------------------------------------------------------------------
# taint
# ---------------------------------------------------------------------------


def _expr_tainted(node, tainted: set[str]) -> bool:
    """True if evaluating ``node`` can yield a tensor read on the device."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False                      # x.shape is fixed at capture
        return _expr_tainted(node.value, tainted)
    if isinstance(node, ast.Call):
        fname = _last_name(node.func)
        if fname in _STATIC_CALLS:
            return False                      # len(x)/isinstance(x, T)
        if isinstance(node.func, ast.Attribute) and fname in _STATIC_METHODS:
            return False                      # x.numel()/x.size()
        args = list(node.args) + [kw.value for kw in node.keywords]
        return (_expr_tainted(node.func, tainted)
                or any(_expr_tainted(a, tainted) for a in args))
    if isinstance(node, _FuncNode):
        return False                          # defining != evaluating
    return any(_expr_tainted(c, tainted) for c in ast.iter_child_nodes(node))


def _own_statements(fn):
    """Child nodes of ``fn`` excluding nested function/lambda bodies."""

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FuncNode):
                continue
            yield child
            yield from walk(child)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        if isinstance(stmt, _FuncNode):
            continue
        yield stmt
        yield from walk(stmt)


def _compute_taint(fn, inherited: set[str],
                   seed_params: bool = True) -> set[str]:
    tainted = set(inherited) | (_param_names(fn) if seed_params else set())
    for _ in range(10):                       # fixpoint; loops converge fast
        changed = False
        for node in _own_statements(fn):
            targets: list = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.NamedExpr):
                targets, value = [node.target], node.value
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets, value = [node.target], node.iter
            elif isinstance(node, ast.comprehension):
                targets, value = [node.target], node.iter
            elif isinstance(node, ast.withitem) and node.optional_vars:
                targets, value = [node.optional_vars], node.context_expr
            if value is None or not targets:
                continue
            if _expr_tainted(value, tainted):
                for t in targets:
                    names = _assigned_names(t)
                    if not names <= tainted:
                        tainted |= names
                        changed = True
        if not changed:
            break
    return tainted


# ---------------------------------------------------------------------------
# per-rule checks
# ---------------------------------------------------------------------------


def _is_f64_spelling(node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in F64_DTYPE_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in F64_DTYPE_NAMES
    return False


def _check_captured_fn(fn, tainted, path, findings) -> None:
    """host-sync + f64-literal inside one captured function."""

    def flag(node, rule, msg):
        findings.append(Finding(path=path, line=node.lineno, rule=rule,
                                message=msg, col=node.col_offset))

    for node in _own_statements(fn):
        if isinstance(node, (ast.If, ast.While)):
            if _expr_tainted(node.test, tainted):
                kind = "if" if isinstance(node, ast.If) else "while"
                flag(node, "host-sync",
                     f"Python `{kind}` on a tensor reads it on the host "
                     "inside captured code; use torch.where, or "
                     "`with solver.graphs.device_if(pred) as put:` for a "
                     "branch on the card")
        elif isinstance(node, ast.IfExp):
            if _expr_tainted(node.test, tainted):
                flag(node, "host-sync",
                     "conditional expression on a tensor reads it on the "
                     "host; use torch.where, or solver.graphs.device_if")
        elif isinstance(node, ast.Assert):
            if _expr_tainted(node.test, tainted):
                flag(node, "host-sync",
                     "assert on a tensor reads it on the host; move the "
                     "check out of the captured code")
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if _expr_tainted(node.iter, tainted):
                flag(node, "host-sync",
                     "Python loop over a tensor reads it on the host; loop "
                     "over a static count")
        elif isinstance(node, ast.Call):
            fname = _last_name(node.func)
            args = list(node.args) + [kw.value for kw in node.keywords]
            args_tainted = any(_expr_tainted(a, tainted) for a in args)
            if (isinstance(node.func, ast.Name)
                    and fname in HOST_CAST_BUILTINS and args_tainted):
                flag(node, "host-sync",
                     f"`{fname}()` on a tensor reads it on the host; keep "
                     "it a tensor (torch casts)")
            elif (isinstance(node.func, ast.Attribute)
                    and fname in HOST_SYNC_METHODS
                    and _expr_tainted(node.func.value, tainted)):
                flag(node, "host-sync",
                     f"`.{fname}()` on a tensor reads it on the host inside "
                     "captured code")
            elif fname in HOST_SYNC_CALLS:
                flag(node, "host-sync",
                     f"`{fname}()` waits for the card inside captured code")
            elif (isinstance(node.func, ast.Attribute)
                    and _attr_root(node.func) in NUMPY_MODULE_NAMES
                    and args_tainted):
                flag(node, "host-sync",
                     f"`np.{fname}()` on a tensor reads it on the host; use "
                     "the torch equivalent")
            # f64-literal: hard-coded double width in captured code
            if fname in F64_DTYPE_NAMES:
                flag(node, "f64-literal",
                     "float64 conversion inside captured code; precision "
                     "belongs to the StorageFormat/arith_dtype plumbing")
            for a in args:
                if _is_f64_spelling(a):
                    flag(a, "f64-literal",
                         "hard-coded float64 dtype inside captured code; "
                         "thread arith_dtype/StorageFormat instead")


# ---------------------------------------------------------------------------
# raw-collective: torch.distributed calls outside their homes
# ---------------------------------------------------------------------------


def _collective_bindings(tree) -> tuple[set[str], dict[str, str]]:
    """Bindings that reach torch.distributed collectives in this module.

    Returns ``(module aliases, local name -> primitive name)``: ``import
    torch.distributed as d``, ``from torch import distributed as D``,
    ``from torch.distributed import _functional_collectives as fc``,
    ``from torch.distributed import all_reduce as p``, and a module-level
    ``f = dist.all_reduce``."""
    modules = set(COLLECTIVE_MODULES)
    prims: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in COLLECTIVE_MODULES and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                full = f"{node.module}.{a.name}"
                if full in COLLECTIVE_MODULES:
                    modules.add(a.asname or a.name)
                elif (node.module in COLLECTIVE_MODULES
                        and a.name in COLLECTIVE_PRIMITIVES):
                    prims[a.asname or a.name] = a.name
    for node in tree.body:                   # module-level aliases
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            hit = _collective_ref(node.value, modules, prims)
            if hit:
                prims[node.targets[0].id] = hit
    return modules, prims


def _collective_ref(node, modules, prims) -> str | None:
    """Primitive name if ``node`` references a torch.distributed
    collective, else None."""
    if (isinstance(node, ast.Attribute)
            and node.attr in COLLECTIVE_PRIMITIVES
            and _dotted(node.value) in modules):
        return node.attr
    if isinstance(node, ast.Name):
        return prims.get(node.id)
    return None


def _check_raw_collectives(tree, path, findings) -> None:
    norm = path.replace(os.sep, "/")
    if any(norm.endswith(home) for home in COLLECTIVE_HOMES):
        return
    modules, prims = _collective_bindings(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        hit = _collective_ref(node.func, modules, prims)
        spelled = f"direct dist.{hit}"
        if hit is None and _last_name(node.func) == "partial" and node.args:
            hit = _collective_ref(node.args[0], modules, prims)
            spelled = f"dist.{hit} bound via functools.partial"
        if hit:
            findings.append(Finding(
                path=path, line=node.lineno, rule="raw-collective",
                col=node.col_offset,
                message=f"{spelled} outside repro_torch.dist.collectives "
                        "-- its bytes are invisible to the census and to "
                        "exchange_bytes/gather_bytes/reduce_bytes; use the "
                        "audited wrapper"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str = "<string>") -> list[Finding]:
    """Lint one module's source; returns the surviving findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path=path, line=e.lineno or 0, rule="parse-error",
                        message=str(e.msg))]
    pragmas = _Pragmas(source)
    root, by_node = _build_scopes(tree)
    owner = _containing_scope(tree, by_node)
    _mark_captured(tree, root, by_node, owner, pragmas, path)

    findings: list[Finding] = []

    def descend(scope: _Scope, inherited: set[str]):
        for child in scope.children:
            if child.captured:
                taint = _compute_taint(child.node, inherited,
                                       seed_params=child.captured_direct)
                _check_captured_fn(child.node, taint, path, findings)
                descend(child, taint)
            else:
                descend(child, set())

    descend(root, set())
    _check_raw_collectives(tree, path, findings)

    return [f for f in findings if not pragmas.allows(f.line, f.rule)]


def lint_file(path: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_paths(paths) -> list[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    findings: list[Finding] = []
    for p in paths:
        if os.path.isfile(p):
            findings.extend(lint_file(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, name)))
    return findings
