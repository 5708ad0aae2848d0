"""Spans and counters of the port's solver drivers.

**Spans** record exactly while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``); otherwise :func:`span` hands back
one shared no-op context, and a solve pays one flag check a span.  There is
no other switch: any profiler session turns them on.  While on, a span

* opens a profiler range under its name (``_RecordFunctionFast``, the
  C++ form of ``torch.profiler.record_function``, about a microsecond where
  the Python form takes eight), so that it lies in the profiler's host event
  stream on the clock of the device operations (an idle gap of the card is
  then named by the solver driver's phase the host was in), and
* appends a row to a bounded buffer (:func:`rows`): ``name``, ``start_ns``
  and ``end_ns`` on ``time.time_ns()`` (the profiler's clock), ``parent``
  (the enclosing span's row index; ``None`` for a root, ``-1`` where that
  row was dropped), ``solve`` (the id of the enclosing root ``gmres.solve``)
  and ``attrs``.

One call of ``gmres`` or ``gmres_block`` (``gmres_batched(method="block")``)
is one solve.  Its spans, the block driver's under the same names:

* ``gmres.solve``, the root: ``p`` (right-hand sides), ``storage``,
  ``launches`` (the port's kernel launches over the call, ``ops.LAUNCHES``);
* ``gmres.plan`` (the RCM plan, ``reorder="rcm"``), ``gmres.capture`` (a
  cycle's CUDA graph captured), ``gmres.b_norm`` (the read of ``||b||``);
* per restart: ``gmres.restart_residual`` (the loop head's residual and its
  read), ``gmres.replay`` (the cycle: a graph replay on the card, the eager
  cycle on the CPU; ``level``, ``steps_run``, ``steps_skipped`` (a replay
  of an unsharded scalar cycle runs no step after its last live one),
  ``steps_live``, ``fired``, and on the card ``device_ms``, two CUDA events
  around the replay read after the cycle's own synchronising read), ``gmres.cycle_read`` (the cycle's
  least squares to the host), ``gmres.lstsq`` (the back substitution on the
  host), ``gmres.update`` (the coefficients to the device and the combine),
  ``gmres.explicit_residual`` (the residual after the update and its read).

**Counters** are always on: plain ints in :data:`COUNTERS`
(``graph_captures``, ``graph_cache_hits`` / ``_misses``, ``plan_cache_hits``
/ ``_misses``, ``steps_run`` (steps the cycles ran), ``steps_skipped``
(steps the replayed cycles skipped: their ``m`` less ``steps_run``),
``steps_live`` (the steps the restart loops took), ``rows_dropped``).  :func:`counters`
snapshots them with the kernel launches of ``ops.LAUNCHES`` as
``launches.<kernel>``, which stay where they are counted.

Read them with any profiler session::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        gmres(A, b, storage="frsz2_32")
    tracing.summary(tracing.rows())     # count, total and self ms by name
    tracing.counters()
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import time

import torch

__all__ = ["COUNTERS", "MAX_ROWS", "ROOT", "annotate", "counters", "reset",
           "rows", "solve_span", "span", "summary"]

#: the root span: one solve
ROOT = "gmres.solve"
#: rows kept at most; later spans still open their profiler ranges, and
#: count in ``COUNTERS["rows_dropped"]``
MAX_ROWS = 200_000

COUNTERS = dict.fromkeys(
    ("graph_captures", "graph_cache_hits", "graph_cache_misses",
     "plan_cache_hits", "plan_cache_misses", "steps_run", "steps_skipped",
     "steps_live", "rows_dropped"), 0)

_ROWS: list[dict] = []
_OPEN: list[int] = []            # row indices of the open spans, innermost last
_LATEST: dict[str, dict] = {}    # this solve's latest row of each name
_SOLVE_IDS = itertools.count()
_solve: int | None = None
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "row", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> dict:
        global _solve
        if not _OPEN:
            _LATEST.clear()
            _solve = next(_SOLVE_IDS) if self.name == ROOT else None
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self.row = row = dict(name=self.name, start_ns=time.time_ns(),
                              end_ns=None,
                              parent=_OPEN[-1] if _OPEN else None,
                              solve=_solve, attrs=self.attrs)
        if len(_ROWS) < MAX_ROWS:
            _OPEN.append(len(_ROWS))
            _ROWS.append(row)
        else:
            _OPEN.append(-1)
            COUNTERS["rows_dropped"] += 1
        _LATEST[self.name] = row
        return self.attrs

    def __exit__(self, *exc):
        self.row["end_ns"] = time.time_ns()
        _OPEN.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A span named ``name`` while a profiler records (``with`` gives its
    ``attrs``, which the caller may add to), else a shared no-op context
    (``with`` gives ``None``)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the open solve's latest span named ``name``, if it
    recorded one."""
    row = _LATEST.get(name) if _OPEN else None
    if row is not None:
        row["attrs"].update(attrs)


def _launches() -> int:
    from repro_torch.kernels import ops

    return sum(ops.LAUNCHES.values())


def solve_span(fn):
    """Make each call of the solver ``fn(A, b, ...)`` a root ``gmres.solve``
    span while a profiler records: ``p`` from ``b`` (1 a vector, else its
    rows), ``storage`` (``policy`` or ``storage`` as given, else ``b``'s
    dtype), ``launches``."""
    @functools.wraps(fn)
    def traced(A, b, *args, **kw):
        if not torch.autograd._profiler_enabled():
            return fn(A, b, *args, **kw)
        storage = kw.get("policy") or kw.get("storage") or str(
            b.dtype).removeprefix("torch.")
        with span(ROOT, p=1 if b.ndim == 1 else int(b.shape[0]),
                  storage=str(storage)) as attrs:
            before = _launches()
            out = fn(A, b, *args, **kw)
            attrs["launches"] = _launches() - before
        return out
    return traced


def rows() -> list[dict]:
    """The recorded rows, oldest first (the list itself: copy to keep)."""
    return _ROWS


def counters() -> dict:
    """A snapshot of :data:`COUNTERS` and of ``ops.LAUNCHES`` (as
    ``launches.<kernel>``)."""
    from repro_torch.kernels import ops

    out = dict(COUNTERS)
    out.update((f"launches.{k}", v) for k, v in ops.LAUNCHES.items())
    return out


def reset() -> None:
    """Drop every row and zero :data:`COUNTERS` (``ops.LAUNCHES`` has its
    own ``reset_launches``)."""
    _ROWS.clear()
    _LATEST.clear()
    for k in COUNTERS:
        COUNTERS[k] = 0


def summary(rs: list[dict]) -> dict:
    """``{name: {count, total_ms, self_ms}}`` of the closed spans among
    ``rs`` (rows as :func:`rows` gives them; a row's children are the rows
    whose ``parent`` is its index in :func:`rows`), most total time first;
    self time is the span's less that of its children."""
    index = {id(r): i for i, r in enumerate(_ROWS)}
    child_ns: dict[int, int] = {}
    for r in rs:
        if r["end_ns"] is not None and r["parent"] is not None:
            child_ns[r["parent"]] = (child_ns.get(r["parent"], 0)
                                     + r["end_ns"] - r["start_ns"])
    out: dict[str, dict] = {}
    for r in rs:
        if r["end_ns"] is None:
            continue
        ns = r["end_ns"] - r["start_ns"]
        s = out.setdefault(r["name"], dict(count=0, total_ms=0.0,
                                           self_ms=0.0))
        s["count"] += 1
        s["total_ms"] += ns * 1e-6
        s["self_ms"] += (ns - child_ns.get(index.get(id(r)), 0)) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))
