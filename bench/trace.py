"""Spans of the harness, and the reading of the device trace.

:class:`Spans` records the harness's own spans on the host clock around
its calls into each layer of the program (the import of torch, the CUDA
query, operator build, library load, warm-up with its plan and capture,
each request) and writes them out at the end.

:func:`read_profile` turns a ``torch.profiler`` run (CPU and CUDA
activities) into :class:`Trace`: the device operations with their start
and length, the seconds in which the device ran any (the union of their
intervals), and the idle gaps between them, each named by the innermost
host event (a span of the harness, an op of PyTorch, a CUDA runtime call)
under way when the gap opened.  The arithmetic of the busy share is that
of the program's ``launch/profile.py::profile_solve`` (device time over
the traced wall), copied here so that the yardstick stays with the
benchmark; it takes the union of the intervals instead of their sum, so
that operations overlapping on two streams count once.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import pathlib
import time


class Spans:
    """Named host spans: ``with spans("warmup"): ...``; nested spans record
    their parent."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.rows: list[dict] = []
        self._open: list[int] = []

    def __call__(self, name: str, **attrs):
        return _Span(self, name, attrs)

    def seconds(self, name: str) -> float:
        return sum(r["end"] - r["start"] for r in self.rows
                   if r["name"] == name)

    def write(self, path: pathlib.Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.rows))


class _Span:
    def __init__(self, spans: Spans, name: str, attrs: dict):
        self.spans, self.name, self.attrs = spans, name, attrs

    def __enter__(self):
        s = self.spans
        self.row = dict(name=self.name, start=time.perf_counter() - s.t0,
                        end=None,
                        parent=s._open[-1] if s._open else None, **self.attrs)
        s._open.append(len(s.rows))
        s.rows.append(self.row)
        return self.row

    def __exit__(self, *exc):
        self.spans._open.pop()
        self.row["end"] = time.perf_counter() - self.spans.t0
        return False


@dataclasses.dataclass
class Trace:
    ops: list            # (name, start_s, dur_s) of each device operation
    window_s: float      # the traced window's wall
    busy_s: float        # union of the device operations' intervals
    gaps: list           # (host activity, seconds) of each idle gap

    def seconds_matching(self, patterns) -> float:
        """Summed device time of the operations whose name matches any of
        ``patterns`` (compiled regular expressions)."""
        return sum(d for name, _, d in self.ops
                   if any(p.search(name) for p in patterns))

    def kernels(self) -> list:
        """``[name, launches, seconds]`` of every device operation name,
        most time first."""
        rows = collections.defaultdict(lambda: [0, 0.0])
        for name, _, d in self.ops:
            rows[name][0] += 1
            rows[name][1] += d
        return sorted(([k, c, s] for k, (c, s) in rows.items()),
                      key=lambda r: -r[2])

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for name, _, d in self.ops:
            by_op[short(name)] += d
        by_host = collections.Counter()
        for name, d in self.gaps:
            by_host[name] += d
        return dict(device_ops=[[k, v] for k, v in by_op.most_common(top)],
                    idle_gaps=[[k, v] for k, v in by_host.most_common(top)])


def short(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 100
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:100]


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def read_profile(prof, t_start_ns: int, t_end_ns: int) -> Trace:
    """The device operations and host events of ``prof`` inside the window
    ``[t_start_ns, t_end_ns]`` (the profiler's clock, as
    ``time.time_ns``)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        if start + dur < t_start_ns or start > t_end_ns:
            continue
        if e.device_type() == DeviceType.CPU:
            host.append((start, start + dur, e.name()))
        elif not _annotation(e):     # a span's range on the device: no work
            dev.append((start, dur, e.name()))
    dev.sort()
    busy = 0
    gaps_at = []                                  # (start, end) of idle
    cursor = t_start_ns
    for start, dur, _ in dev:
        s, t = max(start, cursor), min(start + dur, t_end_ns)
        if s > cursor:
            gaps_at.append((cursor, s))
        if t > s:
            busy += t - s
        cursor = max(cursor, t)
    if cursor < t_end_ns:
        gaps_at.append((cursor, t_end_ns))
    host.sort()
    starts = [h[0] for h in host]
    long = [h for h in host if h[1] - h[0] >= 1_000_000]
    return Trace(ops=[(name, (s - t_start_ns) * 1e-9, d * 1e-9)
                      for s, d, name in dev],
                 window_s=(t_end_ns - t_start_ns) * 1e-9, busy_s=busy * 1e-9,
                 gaps=[(_host_at(host, starts, long, a), (b - a) * 1e-9)
                       for a, b in gaps_at])


def _annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device (the harness's
    are named ``bench.*``)."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f is not None and f()) or e.name().startswith("bench.")


def _host_at(host: list, starts: list, long: list, t: int) -> str:
    """The innermost host event under way at ``t``: of those that began at
    or before ``t`` and end after it, the last to begin.  ``host`` is
    sorted, ``starts`` its start times, ``long`` its events of a
    millisecond or more (the outer spans)."""
    i = bisect.bisect_right(starts, t)
    for start, end, name in reversed(host[max(0, i - 4096):i]):
        if end > t:
            return name
    for start, end, name in reversed(long):
        if start <= t < end:
            return name
    return "host: no recorded event"
