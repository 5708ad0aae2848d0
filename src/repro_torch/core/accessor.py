"""Accessor: storage format ⊥ arithmetic format (Ginkgo's interface, in PyTorch).

The paper integrates FRSZ2 into CB-GMRES through Ginkgo's *Accessor*: all
arithmetic happens in a high-precision "arithmetic format" while the Krylov
basis is persisted in a "storage format" (f64/f32/f16 cast, or FRSZ2 codes).
Reads decompress on the fly; writes compress whole blocks.

A :class:`BasisAccessor` manages a *row basis* ``V`` of fixed capacity
``(m, n)`` — the Krylov buffer — and exposes the operations CB-GMRES needs
(paper Fig. 1):

  * ``write_row(store, j, v)``   — overwrite basis vector j (compress)
  * ``read_row(store, j)``       — random access decompress of one row
  * ``dots(store, w, rows)``     — ``V[:rows] @ w``   (orthogonalization)
  * ``combine(store, h)``        — ``h @ V[:len(h)]`` (update / solution)
  * ``operand(store, j)``        — row j as an SpMV operand: FRSZ2 rows stay
    coded (the ELL kernel decodes each gathered entry), others are read

A :class:`BlockBasisAccessor` holds block-GMRES's shared basis of block
vectors ``V (m, p, n)`` through the same formats: each block row is one
flat storage row of ``p`` segments, each zero-padded to the format's
``block_align()``, and ``block_dots``/``block_combine`` contract the live
block rows (the FRSZ2 ones through the fused block kernels).

Unlike the JAX package, whose stores are immutable pytrees, the port updates
in place: ``write_row`` writes into the store's row ``j`` and returns
nothing (FRSZ2 compresses straight into ``store["codes"][j]`` /
``store["exps"][j]``).  ``dots``/``combine`` take the number of live leading
rows instead of a row mask: the Arnoldi masks are always a prefix, and rows
past it would only contribute exact zeros.

Every storage format is a frozen dataclass implementing
:class:`StorageFormat`; the accessor does no dispatch on concrete classes.
``FrszFormat`` routes its codec and both contractions through
:mod:`repro_torch.kernels.ops`: the Hopper kernels for CUDA tensors, the
plain PyTorch versions for CPU tensors.  ``format_by_name`` resolves names
through the :data:`FORMATS` table (same names and errors as the JAX
package).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops

#: lane width the JAX package aligns FRSZ2 block-basis segments to
#: (``repro/core/accessor.py:_KERNEL_LANES``); kept so that block stores and
#: ``nbytes`` match the reference byte for byte
_KERNEL_LANES = 128

__all__ = [
    "StorageFormat",
    "NativeFormat",
    "FrszFormat",
    "MixedFormat",
    "ShardedFormat",
    "BasisAccessor",
    "BlockBasisAccessor",
    "auto_mixed_head",
    "f64_to_f16",
    "register_format",
    "format_by_name",
    "FORMATS",
]


# ---------------------------------------------------------------------------
# Storage-format protocol
# ---------------------------------------------------------------------------


class StorageFormat:
    """Protocol + generic defaults for Krylov-basis storage formats.

    A format stores an ``(m, n)`` row basis in its own representation (its
    *store*: a tensor or a dict of them) and answers the Accessor
    operations.  ``read_row``/``read_all`` take the arithmetic dtype and the
    logical row length ``n`` (stores may be block-padded beyond ``n``).
    ``dots(..., rows)`` contracts the first ``rows`` rows; ``combine`` the
    first ``len(h)`` rows.  The defaults materialize the basis through
    ``read_all``; formats with a fused path override them.
    """

    @property
    def name(self) -> str:  # pragma: no cover - overridden
        raise NotImplementedError

    def bits_per_value(self) -> float:  # pragma: no cover - overridden
        raise NotImplementedError

    def eps(self) -> float:
        """Relative storage error bound of one round-trip through the format
        (machine epsilon for native dtypes, the per-block max for FRSZ2)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not report a storage epsilon; "
            "implement eps() to use it with auto-threshold policies")

    def nbytes(self, m: int, n: int) -> int:  # pragma: no cover
        raise NotImplementedError

    def empty(self, m: int, n: int, device):  # pragma: no cover - overridden
        raise NotImplementedError

    def rows(self, store) -> int:  # pragma: no cover - overridden
        raise NotImplementedError

    def take(self, store, rows: int):  # pragma: no cover - overridden
        """The store's first ``rows`` rows (a view, no copy)."""
        raise NotImplementedError

    def write_row(self, store, j: int, v) -> None:  # pragma: no cover
        raise NotImplementedError

    def read_row(self, store, j: int, arith_dtype, n: int):  # pragma: no cover
        raise NotImplementedError

    def read_all(self, store, arith_dtype, n: int):  # pragma: no cover
        raise NotImplementedError

    def operand(self, store, j: int, arith_dtype, n: int):
        """Row ``j`` in the form an operator's matvec takes it: by default
        the row read in the arithmetic dtype."""
        return self.read_row(store, j, arith_dtype, n)

    def dots(self, store, w, arith_dtype, n: int, rows: int):
        """h = V[:rows] @ w."""
        V = self.read_all(self.take(store, rows), arith_dtype, n)
        return V @ w.to(arith_dtype)

    def combine(self, store, h, arith_dtype, n: int):
        """y = h @ V[:len(h)]."""
        V = self.read_all(self.take(store, h.shape[0]), arith_dtype, n)
        return h.to(arith_dtype) @ V

    # -- block-basis contract -----------------------------------------------
    def block_align(self) -> int:
        """Per-RHS segment alignment of flattened block rows (``1``: pack the
        segments tightly)."""
        return 1

    def block_dots(self, store, W, arith_dtype, n: int, p: int, n_seg: int,
                   rows: int):
        """``H[i, a, b] = <V[i, a], W[b]>`` over the first ``rows`` flat
        block rows of ``p`` segments of ``n_seg`` values (the trailing
        ``n_seg - n`` of each are zero padding): ``(rows, p, q)``.

        The reference's ``einsum`` over ``V[..., :n]``, written as one
        matrix product on the contiguous ``(rows * p, n_seg)`` view with
        ``W`` zero-padded: a slice of the basis would be copied on every
        call (inside a CUDA graph, one growing copy per step)."""
        V = self.read_all(self.take(store, rows), arith_dtype, p * n_seg)
        Wp = torch.nn.functional.pad(W.to(arith_dtype), (0, n_seg - n))
        return (V.reshape(rows * p, n_seg) @ Wp.T).reshape(rows, p, -1)

    def block_combine(self, store, Y, arith_dtype, n: int, p: int,
                      n_seg: int):
        """``out[b] = sum_{i,a} Y[i, a, b] V[i, a]`` over the ``len(Y)``
        leading block rows, in the padded segment layout ``(q, n_seg)``
        (one matrix product on the contiguous view, as ``block_dots``)."""
        rows = Y.shape[0]
        V = self.read_all(self.take(store, rows), arith_dtype, p * n_seg)
        Y2 = Y.to(arith_dtype).reshape(rows * p, -1)
        return Y2.T @ V.reshape(rows * p, n_seg)


#: values a native basis of another dtype than the arithmetic's converts
#: at a time in its contractions, scalar and block (128 MiB of f64): a
#: chunk of rows
NATIVE_CHUNK_VALUES = 1 << 24


def f64_to_f16(v: torch.Tensor) -> torch.Tensor:
    """f64 -> f16 through f32, rounding to nearest even at each step: what
    PyTorch's own conversion does on the CPU and on the card, and what the
    JAX reference does on a host whose XLA narrows f64 to f32 first.

    The two roundings differ from a single one (numpy's, and the reference's
    on a host whose XLA converts directly) where the bits that the first
    rounding drops would have broken an f16 tie.  Spelled out as two casts so that the card and the CPU give the
    same bits whatever a direct conversion does there; tensor ops only, so
    it runs inside a captured CUDA graph.  ``NativeFormat`` stores float16
    rows through this module-level name.
    """
    return v.to(torch.float32).to(torch.float16)


# ---------------------------------------------------------------------------
# Concrete formats
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NativeFormat(StorageFormat):
    """Plain cast-to-dtype storage (CB-GMRES float64/float32/float16 modes)."""

    dtype: Any = torch.float32

    @property
    def name(self) -> str:
        return F.dtype_name(self.dtype)

    def bits_per_value(self) -> float:
        return self.dtype.itemsize * 8

    def eps(self) -> float:
        return float(torch.finfo(self.dtype).eps)

    def empty(self, m: int, n: int, device):
        return torch.zeros((m, n), dtype=self.dtype, device=device)

    def rows(self, store) -> int:
        return store.shape[0]

    def take(self, store, rows: int):
        return store[:rows]

    def write_row(self, store, j: int, v) -> None:
        if self.dtype == torch.float16 and v.dtype == torch.float64:
            v = f64_to_f16(v)
        store[j].copy_(v)

    def read_row(self, store, j: int, arith_dtype, n: int):
        return store[j].to(arith_dtype)

    def read_all(self, store, arith_dtype, n: int):
        return store.to(arith_dtype)

    def _chunks(self, store, rows: int, arith_dtype):
        """The first ``rows`` rows converted to ``arith_dtype``: ``(i,
        V[i:i + k])`` in chunks of a fixed number of rows, written into one
        buffer whose size does not depend on ``rows``.  A copy of the first
        ``rows`` rows would grow by a row at every step of a cycle, and a
        captured cycle keeps each step's allocation in its graph's pool (and
        each IF node's in its own), which at full width passes the card's
        memory.  Up to ``NATIVE_CHUNK_VALUES`` values a chunk; a store that
        fits is one chunk, the same product as converting it whole."""
        n = store.shape[1]
        k = max(1, min(store.shape[0], NATIVE_CHUNK_VALUES // max(n, 1)))
        buf = torch.empty((k, n), dtype=arith_dtype, device=store.device)
        for i in range(0, max(rows, 1), k):      # rows = 0: one empty
            kk = min(k, rows - i)
            yield i, buf[:kk].copy_(store[i:i + kk])

    def dots(self, store, w, arith_dtype, n: int, rows: int):
        if self.dtype == arith_dtype:
            return super().dots(store, w, arith_dtype, n, rows)
        w = w.to(arith_dtype)
        return torch.cat([V @ w for _, V in
                          self._chunks(store, rows, arith_dtype)])

    def combine(self, store, h, arith_dtype, n: int):
        if self.dtype == arith_dtype:
            return super().combine(store, h, arith_dtype, n)
        h = h.to(arith_dtype)
        y = None
        for i, V in self._chunks(store, h.shape[0], arith_dtype):
            part = h[i:i + V.shape[0]] @ V
            y = part if y is None else y + part
        return y

    # the block contract over the same chunks of block rows: a copy of the
    # live block rows would grow by p segments at every block step
    def block_dots(self, store, W, arith_dtype, n: int, p: int, n_seg: int,
                   rows: int):
        if self.dtype == arith_dtype:
            return super().block_dots(store, W, arith_dtype, n, p, n_seg,
                                      rows)
        q = W.shape[0]
        Wp = torch.nn.functional.pad(W.to(arith_dtype), (0, n_seg - n))
        return torch.cat([(V.reshape(len(V) * p, n_seg) @ Wp.T).reshape(
            len(V), p, q) for _, V in self._chunks(store, rows, arith_dtype)])

    def block_combine(self, store, Y, arith_dtype, n: int, p: int,
                      n_seg: int):
        if self.dtype == arith_dtype:
            return super().block_combine(store, Y, arith_dtype, n, p, n_seg)
        Y = Y.to(arith_dtype)
        q = Y.shape[2]
        out = None
        for i, V in self._chunks(store, Y.shape[0], arith_dtype):
            k = len(V) * p
            part = Y[i:i + len(V)].reshape(k, q).T @ V.reshape(k, n_seg)
            out = part if out is None else out + part
        return out

    def nbytes(self, m: int, n: int) -> int:
        return m * n * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class FrszFormat(StorageFormat):
    """FRSZ2 block-compressed storage (the paper's contribution).

    ``use_kernels`` keeps the JAX package's name with another default:
    ``None`` runs the Hopper kernels on CUDA tensors and the plain PyTorch
    versions on CPU tensors; ``False`` forces the plain versions on the card
    too (a comparison route for ``chip_smoke.py``; no entry point sets it).
    """

    spec: F.FrszSpec = F.FRSZ2_32
    use_kernels: bool | None = None

    @property
    def name(self) -> str:
        return f"frsz2_{self.spec.l}"

    def bits_per_value(self) -> float:
        return F.bits_per_value(self.spec)

    def eps(self) -> float:
        # l-bit code = sign + (l-1) bits of the value normalized to the
        # block max exponent: truncation error <= 2^-(l-2) of the block max
        return 2.0 ** (2 - self.spec.l)

    def empty(self, m: int, n: int, device):
        spec = self.spec
        nb = -(-n // spec.bs)
        if spec.aligned:
            codes = torch.zeros((m, nb, spec.bs), dtype=F.code_dtype(spec.l),
                                device=device)
        else:
            codes = torch.zeros((m, nb, spec.words_per_block),
                                dtype=torch.int32, device=device)
        exps = torch.zeros((m, nb), dtype=torch.int32, device=device)
        return {"codes": codes, "exps": exps}

    def rows(self, store) -> int:
        return store["codes"].shape[0]

    def take(self, store, rows: int):
        return {"codes": store["codes"][:rows], "exps": store["exps"][:rows]}

    def _as_bc(self, store, n: int) -> F.BlockCompressed:
        return F.BlockCompressed(codes=store["codes"], exps=store["exps"], n=n,
                                 spec=self.spec)

    def write_row(self, store, j: int, v) -> None:
        ops.compress(v.to(self.spec.dtype), self.spec,
                     out=(store["codes"][j], store["exps"][j]),
                     kernel=self.use_kernels)

    def read_row(self, store, j: int, arith_dtype, n: int):
        bc = F.BlockCompressed(codes=store["codes"][j], exps=store["exps"][j],
                               n=n, spec=self.spec)
        return ops.decompress(bc, kernel=self.use_kernels).to(arith_dtype)

    def read_all(self, store, arith_dtype, n: int):
        return ops.decompress(self._as_bc(store, n),
                              kernel=self.use_kernels).to(arith_dtype)

    def operand(self, store, j: int, arith_dtype, n: int):
        """The coded row itself, where the ELL kernel can decode it (the
        spec holds the arithmetic dtype and is inside the kernel contract,
        and the plain route is not forced); else the row read."""
        if (self.use_kernels is False or self.spec.dtype != arith_dtype
                or not ops.kernel_supported(self.spec)):
            return self.read_row(store, j, arith_dtype, n)
        return F.BlockCompressed(codes=store["codes"][j],
                                 exps=store["exps"][j], n=n, spec=self.spec)

    def dots(self, store, w, arith_dtype, n: int, rows: int):
        bc = self._as_bc(self.take(store, rows), n)
        return ops.matvec(bc, w.to(self.spec.dtype),
                          kernel=self.use_kernels).to(arith_dtype)

    def combine(self, store, h, arith_dtype, n: int):
        bc = self._as_bc(self.take(store, h.shape[0]), n)
        return ops.rmatvec(bc, h.to(self.spec.dtype),
                           kernel=self.use_kernels).to(arith_dtype)

    def block_align(self) -> int:
        # segments start on a codec-block boundary (the block kernels view
        # the flat row as (p, n_seg) with no block straddling a segment
        # edge) and on the reference's lane boundary (same stores, same
        # nbytes as the JAX package)
        return math.lcm(self.spec.bs, _KERNEL_LANES)

    def block_dots(self, store, W, arith_dtype, n: int, p: int, n_seg: int,
                   rows: int):
        bc = self._as_bc(store, p * n_seg)
        return ops.block_dots(bc, W, p=p, rows=rows,
                              kernel=self.use_kernels).to(arith_dtype)

    def block_combine(self, store, Y, arith_dtype, n: int, p: int,
                      n_seg: int):
        bc = self._as_bc(store, p * n_seg)
        return ops.block_combine(bc, Y, p=p,
                                 kernel=self.use_kernels).to(arith_dtype)

    def nbytes(self, m: int, n: int) -> int:
        return m * F.storage_nbytes(n, self.spec)


@dataclasses.dataclass(frozen=True)
class MixedFormat(StorageFormat):
    """Mixed-precision basis: first ``k`` rows in ``head``, rest in ``tail``.

    The classic CB-GMRES accuracy hedge: early Krylov vectors carry most of
    the solution's signal, so keeping the first few in full precision while
    compressing the later ones recovers nearly-f64 convergence at
    nearly-compressed bandwidth.  The store is ``{"head": k rows, "tail":
    m-k rows}``; row ``j`` routes to the head iff ``j < k``.
    """

    k: int = 2
    head: StorageFormat = NativeFormat(torch.float64)
    tail: StorageFormat = FrszFormat(F.FRSZ2_32)

    @property
    def name(self) -> str:
        return f"mixed:{self.k}:{self.tail.name}"

    def bits_per_value(self) -> float:
        # amortized over a large basis the tail dominates; nbytes() is exact
        return self.tail.bits_per_value()

    def eps(self) -> float:
        return max(self.head.eps(), self.tail.eps())

    def _split(self, m: int) -> tuple[int, int]:
        kh = min(self.k, m)
        return kh, m - kh

    def empty(self, m: int, n: int, device):
        kh, kt = self._split(m)
        return {"head": self.head.empty(kh, n, device),
                "tail": self.tail.empty(kt, n, device)}

    def rows(self, store) -> int:
        return (self.head.rows(store["head"])
                + self.tail.rows(store["tail"]))

    def take(self, store, rows: int):
        kh = self.head.rows(store["head"])
        rh = min(rows, kh)
        return {"head": self.head.take(store["head"], rh),
                "tail": self.tail.take(store["tail"], rows - rh)}

    def _locate(self, store, j: int):
        """(format, sub-store, row) of basis row ``j``, clamped like the
        reference's ``clip`` into the sub-store that holds it."""
        kh = self.head.rows(store["head"])
        kt = self.tail.rows(store["tail"])
        if kt == 0 or (kh > 0 and j < kh):
            return self.head, store["head"], min(max(j, 0), max(kh - 1, 0))
        return self.tail, store["tail"], min(max(j - kh, 0), max(kt - 1, 0))

    def write_row(self, store, j: int, v) -> None:
        fmt, sub, jj = self._locate(store, j)
        fmt.write_row(sub, jj, v)

    def read_row(self, store, j: int, arith_dtype, n: int):
        fmt, sub, jj = self._locate(store, j)
        return fmt.read_row(sub, jj, arith_dtype, n)

    def operand(self, store, j: int, arith_dtype, n: int):
        fmt, sub, jj = self._locate(store, j)
        return fmt.operand(sub, jj, arith_dtype, n)

    def read_all(self, store, arith_dtype, n: int):
        return torch.cat(
            [self.head.read_all(store["head"], arith_dtype, n),
             self.tail.read_all(store["tail"], arith_dtype, n)], dim=0)

    def dots(self, store, w, arith_dtype, n: int, rows: int):
        kh = self.head.rows(store["head"])
        rh = min(rows, kh)
        parts = [self.head.dots(store["head"], w, arith_dtype, n, rh)]
        if rows > rh:
            parts.append(self.tail.dots(store["tail"], w, arith_dtype, n,
                                        rows - rh))
        return torch.cat(parts)

    def combine(self, store, h, arith_dtype, n: int):
        kh = self.head.rows(store["head"])
        rh = min(h.shape[0], kh)
        y = self.head.combine(store["head"], h[:rh], arith_dtype, n)
        if h.shape[0] > rh:
            y = y + self.tail.combine(store["tail"], h[rh:], arith_dtype, n)
        return y

    def block_align(self) -> int:
        # one alignment for both sub-stores: head and tail rows of the same
        # basis must agree on the segment layout
        return math.lcm(self.head.block_align(), self.tail.block_align())

    def block_dots(self, store, W, arith_dtype, n: int, p: int, n_seg: int,
                   rows: int):
        kh = self.head.rows(store["head"])
        rh = min(rows, kh)
        parts = [self.head.block_dots(store["head"], W, arith_dtype, n, p,
                                      n_seg, rh)]
        if rows > rh:
            parts.append(self.tail.block_dots(store["tail"], W, arith_dtype,
                                              n, p, n_seg, rows - rh))
        return torch.cat(parts)

    def block_combine(self, store, Y, arith_dtype, n: int, p: int,
                      n_seg: int):
        kh = self.head.rows(store["head"])
        rh = min(Y.shape[0], kh)
        out = self.head.block_combine(store["head"], Y[:rh], arith_dtype, n,
                                      p, n_seg)
        if Y.shape[0] > rh:
            out = out + self.tail.block_combine(store["tail"], Y[rh:],
                                                arith_dtype, n, p, n_seg)
        return out

    def nbytes(self, m: int, n: int) -> int:
        kh, kt = self._split(m)
        return self.head.nbytes(kh, n) + self.tail.nbytes(kt, n)


@dataclasses.dataclass(frozen=True)
class ShardedFormat(StorageFormat):
    """Basis rows split across the ranks of a process group along the
    vector (n) dimension.

    Each rank holds its chunk of every Krylov vector in ``inner`` storage;
    the accessor's ``n`` is the *local* chunk length.  Every rank of
    ``group`` (``None``: the default group) runs the same operations:

      * ``dots`` — each rank contracts its chunk, then the partials are
        summed over the group.  With ``compressed_transport`` (default)
        they travel as FRSZ2 codes
        (:func:`repro_torch.dist.collectives.compressed_psum`, bit-equal to
        the reference's): the partials of *every* stored row are coded,
        the stale rows of an earlier cycle included, because the wire
        block's exponent is the largest of its 128 values, as the
        reference's unmasked dots give it.  With the plain transport only
        the live rows are contracted, and their partials are all-reduced
        padded with zeros to every stored row, as the reference's (m + 1,)
        reduction ships them (the wire model prices that length);
      * ``combine``, ``write_row``, ``read_row`` — local, on the chunk;
      * ``operand`` — the row read: the sharded matvec exchanges decoded
        values, so the coded-operand ELL kernel is not on this path.

    ``nbytes`` is per rank.
    """

    inner: StorageFormat = NativeFormat(torch.float32)
    group: Any = None
    compressed_transport: bool = True

    @property
    def name(self) -> str:
        return f"sharded:{self.inner.name}"

    def bits_per_value(self) -> float:
        return self.inner.bits_per_value()

    def eps(self) -> float:
        return self.inner.eps()

    def empty(self, m: int, n: int, device):
        return self.inner.empty(m, n, device)

    def rows(self, store) -> int:
        return self.inner.rows(store)

    def take(self, store, rows: int):
        return self.inner.take(store, rows)

    def write_row(self, store, j: int, v) -> None:
        self.inner.write_row(store, j, v)

    def read_row(self, store, j: int, arith_dtype, n: int):
        return self.inner.read_row(store, j, arith_dtype, n)

    def read_all(self, store, arith_dtype, n: int):
        return self.inner.read_all(store, arith_dtype, n)

    def reduce_partials(self, x: torch.Tensor) -> torch.Tensor:
        """Sum locally computed partials over the group, on the transport
        of :attr:`compressed_transport`."""
        from repro_torch.dist import collectives

        if self.compressed_transport:
            return collectives.compressed_psum(x, self.group)
        return collectives.psum(x, self.group)

    def _wire_rows(self, store, rows: int) -> int:
        return self.inner.rows(store) if self.compressed_transport else rows

    def _reduce_rows(self, store, local: torch.Tensor) -> torch.Tensor:
        """:meth:`reduce_partials` of one partial a stored row: the live
        rows' partials padded with zeros to every row of ``store``."""
        pad = self.inner.rows(store) - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad,)
                                                      + local.shape[1:])])
        return self.reduce_partials(local)

    def dots(self, store, w, arith_dtype, n: int, rows: int):
        local = self.inner.dots(store, w, arith_dtype, n,
                                self._wire_rows(store, rows))
        return self._reduce_rows(store, local)[:rows].to(arith_dtype)

    def combine(self, store, h, arith_dtype, n: int):
        return self.inner.combine(store, h, arith_dtype, n)

    def block_align(self) -> int:
        return self.inner.block_align()

    def block_dots(self, store, W, arith_dtype, n: int, p: int, n_seg: int,
                   rows: int):
        local = self.inner.block_dots(store, W, arith_dtype, n, p, n_seg,
                                      self._wire_rows(store, rows))
        return self._reduce_rows(store, local)[:rows].to(arith_dtype)

    def block_combine(self, store, Y, arith_dtype, n: int, p: int,
                      n_seg: int):
        # local, like the scalar combine: the result is this rank's chunk
        return self.inner.block_combine(store, Y, arith_dtype, n, p, n_seg)

    def nbytes(self, m: int, n: int) -> int:
        return self.inner.nbytes(m, n)


# ---------------------------------------------------------------------------
# Basis accessor: the Krylov-buffer contract
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BasisAccessor:
    """Fixed-capacity row basis V (m, n) in an arbitrary storage format.

    ``dots``/``combine`` work on the live leading rows (``rows`` for dots,
    ``len(h)`` for combine): a growing Krylov basis lives in a fixed buffer.
    """

    fmt: Any
    m: int
    n: int
    arith_dtype: Any = torch.float64
    device: Any = "cpu"

    def empty(self):
        return self.fmt.empty(self.m, self.n, self.device)

    def write_row(self, store, j: int, v) -> None:
        self.fmt.write_row(store, j, v)

    def read_row(self, store, j: int):
        return self.fmt.read_row(store, j, self.arith_dtype, self.n)

    def read_all(self, store):
        return self.fmt.read_all(store, self.arith_dtype, self.n)

    def operand(self, store, j: int):
        """Row j as an operator's matvec takes it (coded for FRSZ2)."""
        return self.fmt.operand(store, j, self.arith_dtype, self.n)

    def dots(self, store, w, rows: int | None = None):
        """h = V[:rows] @ w (orthogonalization dot products)."""
        rows = self.m if rows is None else rows
        return self.fmt.dots(store, w, self.arith_dtype, self.n, rows)

    def combine(self, store, h):
        """y = h @ V[:len(h)] (basis update / solution build)."""
        return self.fmt.combine(store, h, self.arith_dtype, self.n)

    def nbytes(self) -> int:
        return self.fmt.nbytes(self.m, self.n)


@dataclasses.dataclass(frozen=True)
class BlockBasisAccessor:
    """Fixed-capacity basis of block vectors ``V (m, p, n)``: block-GMRES's
    shared Krylov buffer, in any storage format.

    Each block row (the ``p`` Krylov directions of one block step) is one
    flat storage row of ``p`` segments, one per right-hand side, each
    zero-padded to the format's ``block_align()`` (``n_seg``): native
    formats pack tightly, FRSZ2 aligns segments so that the fused block
    kernels view the row as ``(p, n_seg)``.  Pad values decode to exact
    zeros.  ``nbytes`` prices the shared basis once: one stored row serves
    all ``p`` right-hand sides.  As the scalar accessor, the port writes in
    place and ``block_dots``/``block_combine`` take the live block rows
    (``rows``, ``len(Y)``) instead of a row mask.
    """

    fmt: Any
    m: int                      # block-row capacity (the solver passes m+1)
    p: int                      # block width: right-hand sides
    n: int                      # vector length
    arith_dtype: Any = torch.float64
    device: Any = "cpu"

    @property
    def n_seg(self) -> int:
        """Aligned per-RHS segment length inside one flat row."""
        a = self.fmt.block_align()
        return -(-self.n // a) * a

    @property
    def n_flat(self) -> int:
        return self.p * self.n_seg

    def empty(self):
        return self.fmt.empty(self.m, self.n_flat, self.device)

    def write_block(self, store, j: int, W) -> None:
        """Store block row ``j`` from ``W (p, n)`` (compress), in place."""
        Wp = torch.nn.functional.pad(W, (0, self.n_seg - self.n))
        self.fmt.write_row(store, j, Wp.reshape(self.n_flat))

    def read_block(self, store, j: int):
        """Block row ``j`` read back as ``(p, n)``."""
        v = self.fmt.read_row(store, j, self.arith_dtype, self.n_flat)
        return v.reshape(self.p, self.n_seg)[:, :self.n]

    def read_all_blocks(self, store):
        V = self.fmt.read_all(store, self.arith_dtype, self.n_flat)
        return V.reshape(-1, self.p, self.n_seg)[..., :self.n]

    def block_dots(self, store, W, rows: int):
        """``H[i, a, b] = <V[i, a], W[b]>`` for the ``rows`` live block
        rows: ``(rows, p, q)``."""
        return self.fmt.block_dots(store, W, self.arith_dtype, self.n, self.p,
                                   self.n_seg, rows).to(self.arith_dtype)

    def block_combine(self, store, Y):
        """``out[b] = sum_{i,a} Y[i, a, b] V[i, a]`` over the ``len(Y)``
        leading block rows: ``(q, n)``."""
        out = self.fmt.block_combine(store, Y, self.arith_dtype, self.n,
                                     self.p, self.n_seg)
        return out.to(self.arith_dtype)[:, :self.n]

    def nbytes(self) -> int:
        return self.fmt.nbytes(self.m, self.n_flat)


# ---------------------------------------------------------------------------
# Registry (benchmarks / CLI select formats by name)
# ---------------------------------------------------------------------------

#: One table: exact names ("float64") and family prefixes ("frsz2", "mixed",
#: "sharded", "emul") map to builders ``(name, *, arith_dtype, bs, use_kernels, rounding) ->
#: StorageFormat``.  ``format_by_name`` consults nothing else.
FORMATS: dict[str, Callable[..., StorageFormat]] = {}


def register_format(key: str):
    """Register a format builder under an exact name or family prefix."""

    def deco(builder):
        FORMATS[key] = builder
        return builder

    return deco


def _native_builder(dtype):
    def build(name, **ctx):
        return NativeFormat(dtype=dtype)

    return build


for _dt in (torch.float64, torch.float32, torch.float16, torch.bfloat16):
    register_format(F.dtype_name(_dt))(_native_builder(_dt))


@register_format("frsz2")
def _build_frsz2(name, *, arith_dtype=torch.float64, bs=32, use_kernels=None,
                 rounding="truncate", **ctx):
    # "frsz2_<bits>", e.g. "frsz2_16" / "frsz2_21" / "frsz2_32"
    parts = name.split("_")
    if len(parts) != 2 or not parts[1].isdigit():
        raise ValueError(
            f"malformed frsz2 format name {name!r}: expected "
            "'frsz2_<bits>' (e.g. 'frsz2_16', 'frsz2_32')")
    l = int(parts[1])
    if not 1 <= l <= 64:
        raise ValueError(
            f"frsz2 code length must be in [1, 64], got {l} ({name!r})")
    spec = F.FrszSpec(bs=bs, l=l, dtype=arith_dtype, rounding=rounding)
    return FrszFormat(spec=spec, use_kernels=use_kernels)


def auto_mixed_head(tail_eps: float, target_rrn: float | None = None,
                    m: int | None = None) -> int:
    """Head size ``k`` for ``mixed:auto:<tail>`` from the solve's target.

    Inexact-Krylov coefficient-decay model (see the JAX package): the tail
    format is admissible for row ``j`` once ``target^(j/m) * eps_tail <=
    0.5 * target``, so ``k = ceil(m * log(0.5*target/eps_tail)/log(target))``
    clamped to ``[0, m]``.  Without a target/m: 1e-12 over m = 100.
    """
    tgt = 1e-12 if target_rrn is None else float(target_rrn)
    cap = 100 if m is None else int(m)
    if cap <= 0:
        return 0
    tgt = min(max(tgt, 1e-300), 0.5)      # log(tgt) < 0 needed below
    if float(tail_eps) <= 0.5 * tgt:
        return 0
    frac = math.log(0.5 * tgt / float(tail_eps)) / math.log(tgt)
    return max(0, min(cap, math.ceil(cap * min(frac, 1.0))))


@register_format("mixed")
def _build_mixed(name, *, arith_dtype=torch.float64, target_rrn=None, m=None,
                 **ctx):
    # "mixed" | "mixed:<k>" | "mixed:auto" | "mixed:<k|auto>:<tail-name>"
    parts = name.split(":", 2)
    head_spec = parts[1] if len(parts) > 1 and parts[1] else "2"
    if head_spec != "auto" and not head_spec.isdigit():
        raise ValueError(
            f"malformed mixed format name {name!r}: the head size must be "
            "an integer or 'auto' ('mixed:<k|auto>[:<tail>]', e.g. "
            "'mixed:2:frsz2_32', 'mixed:auto:frsz2_16')")
    tail_name = parts[2] if len(parts) > 2 else "frsz2_32"
    tail = format_by_name(tail_name, arith_dtype=arith_dtype,
                          target_rrn=target_rrn, m=m, **ctx)
    k = (auto_mixed_head(tail.eps(), target_rrn, m)
         if head_spec == "auto" else int(head_spec))
    return MixedFormat(k=k, head=NativeFormat(arith_dtype), tail=tail)


@register_format("sharded")
def _build_sharded(name, *, group=None, compressed_transport=True, **ctx):
    # "sharded:<inner-format-name>"
    inner_name = name.partition(":")[2]
    if not inner_name:
        raise ValueError("sharded format needs an inner format: "
                         "'sharded:<fmt>'")
    if inner_name.split(":", 1)[0] == "sharded":
        raise ValueError(
            f"nested sharded format {name!r} is not supported: the basis "
            "splits over exactly one mesh axis ('sharded:<fmt>')")
    inner = format_by_name(inner_name, **ctx)
    return ShardedFormat(inner=inner, group=group,
                         compressed_transport=compressed_transport)


@register_format("emul")
def _build_emul(name, **ctx):
    # "emul:sz_abs:<eb>" | "emul:sz_pwrel:<eb>" | "emul:zfp_fr:<rate>"
    from repro_torch.core.emulators import emulator_by_name

    return emulator_by_name(name.partition(":")[2])


def format_by_name(name: str, *, arith_dtype=torch.float64, bs: int = 32,
                   use_kernels: bool | None = None, rounding: str = "truncate",
                   target_rrn: float | None = None, m: int | None = None):
    """Resolve a storage format from the :data:`FORMATS` table.

    Exact names first ('float64', …), then family prefixes: 'frsz2_XX',
    'mixed[:k|auto[:tail]]', 'emul:…'.  ``target_rrn``/``m`` size
    ``mixed:auto``.
    """
    ctx = dict(arith_dtype=arith_dtype, bs=bs, use_kernels=use_kernels,
               rounding=rounding, target_rrn=target_rrn, m=m)
    if name in FORMATS:
        return FORMATS[name](name, **ctx)
    for sep in (":", "_"):
        family = name.split(sep)[0]
        if family != name and family in FORMATS:
            return FORMATS[family](name, **ctx)
    raise ValueError(f"unknown storage format {name!r}")
