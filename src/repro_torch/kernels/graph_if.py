"""Conditional nodes of a captured CUDA graph on Hopper: bindings of
``csrc/graph_if.cu``.

Not a port of a TPU kernel: with :func:`repro_torch.solver.graphs.device_if`
it takes the place of ``jax.lax.cond`` in the JAX package's cycles
(``repro/solver/pipeline.py:124-132``, ``:271-276``).  ``begin`` captures a
one-thread kernel that sets the node's condition from a 0-d bool on the
card, adds an IF node to the graph that ``stream`` captures and starts
capturing ``body_stream`` into the node's body; ``end`` ends that capture.
The torch the card runs (2.11) has no Python hook for this.

These functions call the library and nothing else:
:mod:`repro_torch.solver.graphs` validates and counts.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p


def load() -> None:
    """Build and load the library ahead of a capture (loading it registers
    its kernel with the runtime, which is no call to make while a stream
    captures)."""
    build.bind("graph_if", "graph_if_begin", [_P, _P, _P])
    build.bind("graph_if", "graph_if_end", [_P])


def begin(stream: int, pred_ptr: int, body_stream: int) -> None:
    f = build.bind("graph_if", "graph_if_begin", [_P, _P, _P])
    rc = f(stream, pred_ptr, body_stream)
    if rc == 1001:
        raise RuntimeError("graph_if_begin: the stream is not capturing")
    build.check(rc, "graph_if_begin")


def end(body_stream: int) -> None:
    f = build.bind("graph_if", "graph_if_end", [_P])
    build.check(f(body_stream), "graph_if_end")
