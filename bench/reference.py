"""The plain reference: what decides ``correct``, and the control.

Plain numpy and PyTorch; it imports nothing of the program (a test holds
it to that) and takes nothing the program made.  The operator comes from
:mod:`bench.operators` (the same arrays the harness hands the program),
the right-hand sides from the harness.

:func:`residual_ratios` judges returned solutions: the true relative
residual ``||b - A x|| / ||b||`` in extended precision, over the limit that
the configuration states (its target RRN) plus the rounding that a float64
evaluation of that residual may make.  The program stops on a float64
residual, so a sound solve reads at most 1; a solve that missed its target
reads more.

:func:`plain_gmres` is restarted GMRES(m) with classical Gram-Schmidt
applied twice, in any dtype, on plain tensor ops: the reference put in the
program's place.  Run in float32 (the precision below the configuration's
float64) it is the control, which the comparison must fail.
"""
from __future__ import annotations

import numpy as np
import torch

U64 = 2.0 ** -53


def _gamma(k: int) -> float:
    return k * U64 / (1 - k * U64)


class Operator:
    """The configuration's CSR arrays on the host, for the check."""

    def __init__(self, indptr, indices, data):
        self.n = indptr.size - 1
        self.indices = indices
        self.data = data
        self.starts = indptr[:-1].astype(np.int64)
        counts = np.diff(indptr)
        if not (counts > 0).all():
            raise ValueError("every row needs an entry (reduceat)")
        self.width = int(counts.max())
        self._ld = None

    def residual_ratio(self, b: np.ndarray, x: np.ndarray,
                       target: float) -> tuple[float, float]:
        """``(rrn, rrn / (target + e))`` of one solution: ``rrn`` in
        extended precision, ``e`` the most by which a float64 evaluation of
        the residual (a row of ``width`` products summed in any order, the
        subtraction, the norms) can understate it."""
        if np.finfo(np.longdouble).eps > 1e-18:
            raise RuntimeError("numpy's longdouble is no wider than float64 "
                               "here; the check needs extended precision")
        if self._ld is None:
            self._ld = self.data.astype(np.longdouble)
        xg = x[self.indices]
        ax = np.add.reduceat(self._ld * xg.astype(np.longdouble),
                             self.starts)
        r = b.astype(np.longdouble) - ax
        bn = np.sqrt(np.sum(np.square(b.astype(np.longdouble))))
        rrn = float(np.sqrt(np.sum(r * r)) / bn)
        abs_ax = np.add.reduceat(np.abs(self.data) * np.abs(xg), self.starts)
        e = (_gamma(self.width + 2) * (np.linalg.norm(abs_ax) + float(bn))
             / float(bn) + 2 * self.n * U64 * target)
        return rrn, rrn / (target + e)


def residual_ratios(op: Operator, B: np.ndarray, X: np.ndarray,
                    target: float) -> list[tuple[float, float]]:
    """:meth:`Operator.residual_ratio` of each row of ``B`` and ``X``."""
    return [op.residual_ratio(b, x, target) for b, x in zip(B, X)]


class PlainEll:
    """``y = A x`` as a sum over the ``w`` slots of each row, slot by slot
    (a gather and a product of whole vectors; the temporaries are vectors):
    the harness's own operator on the device."""

    def __init__(self, indptr, indices, data, device, dtype=torch.float64):
        n = indptr.size - 1
        counts = np.diff(indptr).astype(np.int64)
        w = int(counts.max())
        rows = np.repeat(np.arange(n), counts)
        pos = np.arange(indices.size) - np.repeat(indptr[:-1], counts)
        cols = np.zeros((w, n), np.int32)
        vals = np.zeros((w, n), np.float64)
        cols[pos, rows] = indices
        vals[pos, rows] = data
        self.n, self.w = n, w
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, device=device).to(dtype)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        """``X (n,)`` or ``(p, n)``."""
        X = X.to(self.vals.dtype)
        Y = torch.zeros_like(X)
        for k in range(self.w):
            Y += self.vals[k] * X.index_select(-1, self.cols[k])
        return Y


def plain_gmres(matvec, b: torch.Tensor, *, m: int, target: float,
                max_iters: int) -> torch.Tensor:
    """Restarted GMRES(m), CGS applied twice, in ``b``'s dtype; the least
    squares of each cycle on the host.  Returns ``x``."""
    n = b.shape[0]
    x = torch.zeros_like(b)
    bn = float(torch.linalg.vector_norm(b))
    done = 0
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
    while done < max_iters:
        r = b - matvec(x)
        beta = float(torch.linalg.vector_norm(r))
        if beta / bn <= target:
            break
        V[0] = r / beta
        H = np.zeros((m + 1, m))
        k = 0
        for j in range(min(m, max_iters - done)):
            w = matvec(V[j])
            h = torch.zeros(j + 1, dtype=b.dtype, device=b.device)
            for _ in range(2):
                u = V[:j + 1] @ w
                w = w - u @ V[:j + 1]
                h = h + u
            H[:j + 1, j] = h.double().cpu().numpy()
            H[j + 1, j] = float(torch.linalg.vector_norm(w))
            k = j + 1
            if H[j + 1, j] == 0:
                break
            V[j + 1] = w / H[j + 1, j]
        g = np.zeros(k + 1)
        g[0] = beta
        y = np.linalg.lstsq(H[:k + 1, :k], g, rcond=None)[0]
        x = x + torch.as_tensor(y, dtype=b.dtype, device=b.device) @ V[:k]
        done += k
    return x
