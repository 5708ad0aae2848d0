"""Conditional nodes of a captured CUDA graph on Hopper: bindings of
``csrc/graph_if.cu``.

Not a port of a TPU kernel: with :func:`repro_torch.solver.graphs.device_if`
it takes the place of ``jax.lax.cond`` in the JAX package's cycles
(``repro/solver/pipeline.py:124-132``, ``:271-276``), and of the ``alive``
mask of their ``fori_loop`` cycle.  ``begin`` captures a one-thread kernel
that sets the node's condition from a 0-d value on the card (a bool, or an
f64 read as nonzero), adds an IF node to the graph that ``stream``
captures and starts capturing ``body_stream`` into the node's body; ``end``
ends that capture.  Where ``stream`` is ``body_stream`` (a node inside an
IF node's body) the outer body's capture is suspended meanwhile and
resumed by ``end``.  The torch the card runs (2.11) has no Python hook for
this.

These functions call the library and nothing else:
:mod:`repro_torch.solver.graphs` validates and counts.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
# (stream, pred, pred_f64, body_stream)
_BEGIN = [_P, _P, _I, _P]


def load() -> None:
    """Build and load the library ahead of a capture (loading it registers
    its kernel with the runtime, which is no call to make while a stream
    captures)."""
    build.bind("graph_if", "graph_if_begin", _BEGIN)
    build.bind("graph_if", "graph_if_end", [_P])


def begin(stream: int, pred_ptr: int, pred_f64: bool,
          body_stream: int) -> None:
    f = build.bind("graph_if", "graph_if_begin", _BEGIN)
    rc = f(stream, pred_ptr, int(pred_f64), body_stream)
    if rc == 1001:
        raise RuntimeError("graph_if_begin: the stream is not capturing")
    build.check(rc, "graph_if_begin")


def end(body_stream: int) -> None:
    f = build.bind("graph_if", "graph_if_end", [_P])
    build.check(f(body_stream), "graph_if_end")
