"""Sparse matrix formats and SpMV.

Two formats, as in the JAX package:

* :class:`CSR` — the assembly format.  Its matvec runs over a padded
  ``(n, w)`` row view (an :class:`ELL` built once, vectorised, on the
  operator's device, and cached on the CSR).
* :class:`ELL` — fixed row width.  Padding slots hold value 0 and column 0.
  Its matvec goes through :func:`repro_torch.kernels.ops.ell_spmv`: the
  hand-written ELL kernel for CUDA tensors, the plain gather-and-sum for CPU
  tensors.  Both sum each row in slot order with no float atomics, so a
  matvec gives the same bits on every run (``index_add_`` and
  ``scatter_add_`` would not), and the same bits as the JAX package's.

Index arrays are ``int32`` and values keep their dtype, as in the reference,
so :meth:`CSR.fingerprint` hashes the same bytes as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops

__all__ = ["CSR", "ELL", "csr_from_coo"]


@dataclasses.dataclass
class ELL:
    """ELLPACK: ``cols``/``vals`` (n, width); padding has val 0, col 0."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def matvec(self, x: torch.Tensor | F.BlockCompressed, *,
               kernel: bool | None = None) -> torch.Tensor:
        """y = A @ x: gather, multiply, sum each row (deterministic).

        ``x`` may be an FRSZ2 ``BlockCompressed`` vector: the kernel decodes
        each gathered entry in registers.  ``kernel=False`` forces the plain
        version on the card too; the default routes by device.
        """
        return ops.ell_spmv(self.vals, self.cols, x, kernel=kernel)

    def diag(self) -> torch.Tensor:
        """(n,) main diagonal (padding slots carry val 0, so they drop out)."""
        n = self.shape[0]
        rows = torch.arange(n, device=self.cols.device)[:, None]
        return torch.where(self.cols == rows, self.vals,
                           torch.zeros((), dtype=self.vals.dtype,
                                       device=self.vals.device)).sum(dim=1)

    def fingerprint(self) -> str:
        """Content hash of (shape, columns, values) — the same string as the
        JAX package's ``ELL.fingerprint`` for the same arrays."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            h = hashlib.sha1(repr(self.shape).encode())
            for a in (self.cols, self.vals):
                h.update(np.ascontiguousarray(a.cpu().numpy()).tobytes())
            fp = self._fingerprint = h.hexdigest()
        return fp

    def bandwidth(self) -> int:
        """max |col - row| over nonzero entries (host-side, cached).

        Padding slots carry val 0 / col 0, so masking on the values keeps a
        high row's padding from faking an (n-ish) bandwidth.
        """
        bw = getattr(self, "_bandwidth", None)
        if bw is None:
            live = self.vals.cpu().numpy() != 0
            rows = np.arange(self.shape[0])[:, None]
            off = np.abs(self.cols.cpu().numpy().astype(np.int64)
                         - rows)[live]
            bw = self._bandwidth = int(off.max()) if off.size else 0
        return bw

    def nbytes(self) -> int:
        """Bytes one full SpMV streams: padded values + column indices."""
        return int(self.vals.numel() * self.vals.element_size()
                   + self.cols.numel() * self.cols.element_size())

    def __matmul__(self, x):
        return self.matvec(x)


@dataclasses.dataclass
class CSR:
    """Compressed sparse row.  ``indptr`` (n+1,), ``indices``/``data`` (nnz,)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def to(self, device) -> CSR:
        """The same matrix on ``device`` (``self`` if it is already there)."""
        device = torch.device(device)
        if self.data.device == device:
            return self
        A = CSR(self.indptr.to(device), self.indices.to(device),
                self.data.to(device), self.shape)
        if hasattr(self, "grid"):
            A.grid = self.grid
        return A

    def row_ids(self) -> torch.Tensor:
        """(nnz,) row index per entry."""
        counts = (self.indptr[1:] - self.indptr[:-1]).to(torch.int64)
        return torch.repeat_interleave(
            torch.arange(self.shape[0], dtype=torch.int32,
                         device=self.indptr.device), counts)

    def to_ell(self, width: int | None = None) -> ELL:
        """Padded row view, built vectorised on the operator's device."""
        n = self.shape[0]
        counts = (self.indptr[1:] - self.indptr[:-1]).to(torch.int64)
        if width is None:
            width = int(counts.max()) if n else 0
        rows = self.row_ids().to(torch.int64)
        pos = (torch.arange(self.nnz, device=rows.device)
               - self.indptr[:-1].to(torch.int64)[rows])
        cols = torch.zeros((n, width), dtype=torch.int32, device=rows.device)
        vals = torch.zeros((n, width), dtype=self.data.dtype,
                           device=rows.device)
        cols[rows, pos] = self.indices
        vals[rows, pos] = self.data
        return ELL(cols, vals, self.shape)

    def _ell(self) -> ELL:
        ell = getattr(self, "_padded", None)
        if ell is None:
            ell = self._padded = self.to_ell()
        return ell

    def matvec(self, x: torch.Tensor | F.BlockCompressed, *,
               kernel: bool | None = None) -> torch.Tensor:
        """y = A @ x through the cached ELL view (see :meth:`ELL.matvec`)."""
        return self._ell().matvec(x, kernel=kernel)

    def diag(self) -> torch.Tensor:
        """(n,) main diagonal (zeros where a row has no diagonal entry)."""
        return self._ell().diag()

    def fingerprint(self) -> str:
        """Content hash of (shape, structure, values) — the same string as
        the JAX package's ``CSR.fingerprint`` for the same matrix."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            h = hashlib.sha1(repr(self.shape).encode())
            for a in (self.indptr, self.indices, self.data):
                h.update(np.ascontiguousarray(a.cpu().numpy()).tobytes())
            fp = self._fingerprint = h.hexdigest()
        return fp

    def bandwidth(self) -> int:
        """max |col - row| over nonzero entries (host-side, cached).

        Explicitly-stored zeros are excluded: they contribute nothing to a
        matvec.
        """
        bw = getattr(self, "_bandwidth", None)
        if bw is None:
            indptr = self.indptr.cpu().numpy()
            rows = np.repeat(np.arange(self.shape[0]), np.diff(indptr))
            live = self.data.cpu().numpy() != 0
            off = np.abs(self.indices.cpu().numpy()[live] - rows[live])
            bw = self._bandwidth = int(off.max()) if off.size else 0
        return bw

    def nbytes(self) -> int:
        """Bytes one full SpMV streams from the operator: values, column
        indices and the row pointer — the A-traffic term of the paper's
        bandwidth model."""
        return int(self.data.numel() * self.data.element_size()
                   + self.indices.numel() * self.indices.element_size()
                   + self.indptr.numel() * self.indptr.element_size())

    def __matmul__(self, x):
        return self.matvec(x)

    def to_dense(self) -> torch.Tensor:
        d = torch.zeros(self.shape, dtype=self.data.dtype,
                        device=self.data.device)
        return d.index_put_((self.row_ids().to(torch.int64),
                             self.indices.to(torch.int64)), self.data,
                            accumulate=True)


def csr_from_coo(rows, cols, vals, shape, device="cpu") -> CSR:
    """Build CSR from (unsorted, duplicate-free) COO triplets on the host."""
    rows = np.asarray(rows)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
    indptr = np.zeros(shape[0] + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=shape[0]))
    return CSR(
        indptr=torch.as_tensor(indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(cols.astype(np.int32), device=device),
        data=torch.as_tensor(vals, device=device),
        shape=tuple(shape),
    )
