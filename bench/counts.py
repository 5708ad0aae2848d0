"""The benchmark's own count of the bytes a solve's live work must move.

The yardstick of the roofline metrics.  It counts from what a request did
(its cycles, the live steps of each, the steps where MGS fired) and from
the shapes, never from the program's byte model.  Each input byte is read
once and each output byte written once, at the format's bytes a row.  Dead
steps (a captured cycle runs all ``m``; the steps after the estimate met
the target are dead) need nothing, so a share reads low where the live
step share is low.

Per live step ``j`` (0-based) of a request of ``p`` right-hand sides, with
``R`` the bytes of one stored row and ``v = 8 n`` those of an f64 vector:

* basis: each MGS pass (the first always, the second where it fired) reads
  rows ``0..j`` and ``w`` for the dots and rows ``0..j`` again for the
  combine, which writes one vector: ``2 (j + 1) p R + 2 p v``.  Coded
  formats write the new row through the codec (``p (v + R)``), and a block
  step decodes row ``j`` for the operator (``p (R + v)``).  Per cycle the
  first row is written (coded formats) and the update combines the live
  rows once: ``j_stop p R + p v``;
* operator: values and column indices once (``nnz (8 + 4)``), the operand
  once (a coded row where the operator decodes it in registers, else a
  vector) and ``y`` written, per live step; and two residuals a cycle
  (before it and after the update), each ``nnz (8 + 4) + 2 p v``;
* vectors: each pass's subtraction and norm (``4 p v``), the step's norm
  and normalisation (``3 p v``); per cycle the two residuals' subtractions
  and norms and the update's add (``11 p v``).

A native basis's row write is a plain copy whose kernel the trace cannot
tell from other copies, so :func:`basis_bytes` leaves it out where the
basis metric divides by the basis kernels' time (``writes=False``).
"""
from __future__ import annotations

import dataclasses

#: bytes of one value of an index of the operator (int32 columns)
INDEX_BYTES = 4
F64 = 8


@dataclasses.dataclass
class Request:
    """What one request did, read from the program's results."""

    p: int                       # right-hand sides
    m: int                       # steps a captured cycle runs
    live: list                   # live steps of each cycle run
    fired: list                  # per cycle, MGS's flag at each live step
    iterations: list             # per right-hand side
    converged: list              # per right-hand side
    latency_s: float = 0.0


#: each card's published memory rate (NVIDIA H100 SXM data sheet: 80 GB
#: of HBM3 at 3.35 TB/s, at the full power limit of 700 W)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(card: str) -> float | None:
    """The card's memory rate (its name as ``torch.cuda.get_device_name``
    gives it), or ``None`` for another card and the CPU."""
    return HBM_BYTES_PER_S.get(card)


def coded(fmt: str) -> bool:
    return fmt.startswith("frsz2")


def row_bytes(fmt: str, n: int) -> float:
    """Bytes of one stored basis row of ``n`` values: a native dtype's
    size, or FRSZ2's ``l`` bits a value and one 32-bit exponent a block of
    32 values."""
    native = {"float64": 8, "float32": 4, "float16": 2}
    if fmt in native:
        return native[fmt] * n
    if coded(fmt):
        l_bits = int(fmt.split("_")[1])
        return n * l_bits / 8 + -(-n // 32) * 4
    raise ValueError(f"no row size for the format {fmt!r}")


def basis_bytes(r: Request, n: int, fmt: str, *, block: bool,
                writes: bool | None = None) -> float:
    R, v, p = row_bytes(fmt, n), F64 * n, r.p
    writes = coded(fmt) if writes is None else writes
    total = 0.0
    for j_stop, fired in zip(r.live, r.fired):
        if writes:
            total += p * (v + R)                 # the cycle's first row
        for j in range(j_stop):
            passes = 1 + int(bool(fired[j]))
            total += passes * (2 * (j + 1) * p * R + 2 * p * v)
            if writes:
                total += p * (v + R)             # the new row
            if block and coded(fmt):
                total += p * (R + v)             # row j decoded for A
        total += j_stop * p * R + p * v          # the update's combine
    return total


def spmv_bytes(r: Request, n: int, nnz: int, fmt: str, *,
               block: bool) -> float:
    v, p = F64 * n, r.p
    a = nnz * (F64 + INDEX_BYTES)
    operand = row_bytes(fmt, n) if coded(fmt) and not block else v
    total = 0.0
    for j_stop in r.live:
        total += j_stop * (a + p * (operand + v))
        total += 2 * (a + 2 * p * v)             # the cycle's two residuals
    return total


def vector_bytes(r: Request, n: int) -> float:
    v, p = F64 * n, r.p
    total = 0.0
    for j_stop, fired in zip(r.live, r.fired):
        for j in range(j_stop):
            total += (1 + int(bool(fired[j]))) * 4 * p * v + 3 * p * v
        total += 11 * p * v
    return total


def live_work_bytes(r: Request, n: int, nnz: int, fmt: str, *,
                    block: bool) -> float:
    """Every byte the request's live work must move (``hbm_roofline``)."""
    return (basis_bytes(r, n, fmt, block=block, writes=True)
            + spmv_bytes(r, n, nnz, fmt, block=block) + vector_bytes(r, n))


def live_steps(history, m: int, target: float) -> list:
    """The live steps of each cycle, from a solve's implicit-estimate
    history (``rows (steps, p)``: one column a right-hand side).

    A cycle's history holds its live steps: up to the first step where
    every column's estimate met the target (included), else all ``m``.  So
    the history splits into cycles without any other record."""
    out, i = [], 0
    while i < len(history):
        seg = history[i:i + m]
        hit = [k for k, row in enumerate(seg)
               if all(e <= target for e in row)]
        j = hit[0] + 1 if hit else len(seg)
        out.append(j)
        i += j
    return out
