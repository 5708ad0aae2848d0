"""Branches on the card inside a captured GMRES cycle: :func:`device_if`.

The JAX package runs MGS's re-orthogonalization under ``jax.lax.cond``
(``repro/solver/pipeline.py:124-132``, ``:271-276``): a step where it does
not fire sweeps the basis once.  A captured cycle holds the same branch as a
CUDA graph conditional node::

    fired = hj1 < eta * w_pre                    # a 0-d bool on the card
    with device_if(fired) as put:
        u = acc.dots(store, w, rows)
        w2 = w - acc.combine(store, u)
        put(w, w2)                               # w <- w2 where fired

An unsharded cycle also holds each Arnoldi step in such a node, keyed on
the least-squares state's f64 ``alive`` slot (nonzero: the step is live),
with MGS's node nested inside it, so that a replay runs no step after the
last live one.

* While the current stream captures a CUDA graph (inside :func:`capturing`),
  the block's work goes into an IF node keyed on ``pred``
  (``csrc/graph_if.cu``): a replay runs it only where ``pred`` is nonzero
  at that point of the replay.  ``put(dst, value)`` copies ``value`` into
  ``dst`` inside the node.  A capture that cannot build the node raises.
* Otherwise the block runs, and ``put(dst, value)`` writes
  ``torch.where(pred, value, dst)`` into ``dst``: the same bits as the node
  gives.  This is the warm-up run before a capture (it launches every
  kernel of the body once, so that their libraries are built and loaded
  before the capture) and every eager cycle, on the CPU too.  The CPU runs
  the body and selects rather than branching in Python: no host read.

The bodies' allocations go to a memory pool of their own, on one side
stream a capture, which lives as long as the graph; a node inside a body
is captured on the same stream.  :func:`capturing` records each body's
kernel launches (``ops.LAUNCHES``) and collectives (the census) apart from
the rest of the graph and from the bodies nested in it, with the body's
``tag``, so that a replay can add them once per node that ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from repro_torch.dist import census

__all__ = ["Body", "Capture", "capturing", "device_if", "select"]


@dataclasses.dataclass
class Body:
    """What one IF node's body holds, those of the nodes nested in it left
    out: its kernel launches by name, its collectives
    (:class:`repro_torch.dist.census.Call`) and its ``tag``
    (:func:`device_if`'s: what a replay counts the node by)."""

    launches: dict
    calls: list
    tag: str = "fired"


@dataclasses.dataclass
class Capture:
    """A capture in progress: the bodies' stream, their pool, and the
    bodies in the order the capture met them."""

    stream: torch.cuda.Stream
    pool: tuple
    bodies: list = dataclasses.field(default_factory=list)
    #: the launches of the bodies nested in each open body, innermost last
    nested: list = dataclasses.field(default_factory=list)


#: the captures in progress, innermost last
_CAPTURES: list[Capture] = []


@contextlib.contextmanager
def capturing(graph: torch.cuda.CUDAGraph, device=None):
    """Around the capture of ``graph``: the IF nodes' bodies are captured on
    one side stream, whose allocations go to a pool that is released when
    ``graph`` is.  Yields the :class:`Capture`, whose ``bodies`` the capture
    fills."""
    from repro_torch.kernels import graph_if

    graph_if.load()
    idx = torch.device("cuda" if device is None else device).index
    idx = torch.cuda.current_device() if idx is None else idx
    # PyTorch hands out streams round-robin from a pool a priority; the
    # graph captures on one of the default priority's, and a body stream of
    # that pool would come back as that very stream after a few dozen
    # captures, whose body capture then fails ("illegal state"): the bodies
    # take the high priority's pool
    cap = Capture(torch.cuda.Stream(idx, priority=-1),
                  torch.cuda.graph_pool_handle())
    with torch.cuda.stream(cap.stream):
        torch._C._cuda_beginAllocateCurrentStreamToPool(idx, cap.pool)
    weakref.finalize(graph, torch._C._cuda_releasePool, idx, cap.pool)
    _CAPTURES.append(cap)
    try:
        yield cap
    finally:
        _CAPTURES.pop()
        torch._C._cuda_endAllocateToPool(idx, cap.pool)


def _selector(pred: torch.Tensor):
    def put(dst: torch.Tensor, value: torch.Tensor) -> None:
        dst.copy_(torch.where(pred, value, dst))
    return put


def _copy(dst: torch.Tensor, value: torch.Tensor) -> None:
    dst.copy_(value)


@contextlib.contextmanager
def select(pred: torch.Tensor):
    """:func:`device_if`'s route outside a capture, everywhere: the block
    runs and ``put(dst, value)`` writes ``torch.where(pred, value, dst)``
    into ``dst``.  For a block whose work a conditional node cannot hold."""
    yield _selector(pred)


@contextlib.contextmanager
def device_if(pred: torch.Tensor, *, tag: str = "fired"):
    """Run the block where the 0-d ``pred`` (a bool, or an f64 read as
    nonzero) holds; yields ``put(dst, value)``, which writes ``value`` into
    ``dst`` where it does (see the module's docstring).  ``tag`` names what
    a replay counts the node by: ``"fired"`` (MGS's second pass: the step's
    ``fired`` slot) or ``"step"`` (an Arnoldi step: the steps that ran)."""
    if pred.ndim != 0 or pred.dtype not in (torch.bool, torch.float64):
        raise ValueError(f"device_if needs a 0-d bool (or f64), got "
                         f"{pred.dtype} {tuple(pred.shape)}")
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        yield _selector(pred if pred.dtype == torch.bool else pred != 0)
        return
    if not _CAPTURES:
        raise RuntimeError("device_if inside a capture needs "
                           "graphs.capturing() around the capture")
    from repro_torch.kernels import graph_if, ops

    cap = _CAPTURES[-1]
    graph_if.begin(torch.cuda.current_stream().cuda_stream, pred.data_ptr(),
                   pred.dtype == torch.float64, cap.stream.cuda_stream)
    ops.LAUNCHES["graph_if"] += 1
    before = dict(ops.LAUNCHES)
    cap.nested.append(dict.fromkeys(before, 0))
    with census.capturing() as calls, torch.cuda.stream(cap.stream):
        try:
            yield _copy
        finally:
            graph_if.end(cap.stream.cuda_stream)
    inner = cap.nested.pop()
    spent = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if cap.nested:                  # this body's launches, in its outer's
        for k, v in spent.items():
            cap.nested[-1][k] += v
    cap.bodies.append(Body({k: v - inner[k] for k, v in spent.items()},
                           calls, tag))
