"""Synthetic CFD-like test problems (offline stand-ins for SuiteSparse).

The port's own copy of the JAX package's problem suite: every generator
builds its arrays with numpy exactly as the reference does (the arrays are
``np.array_equal`` to the reference's), then :func:`make_problem` places the
:class:`~repro_torch.sparse.csr.CSR` on the requested device.

* ``synth:atmosmod``    — 3-D convection-diffusion 7-point stencil
  (nonsymmetric, like atmosmodd/j/l/m: atmospheric modelling).
* ``synth:aniso2d``     — 2-D anisotropic diffusion 5-point stencil.
* ``synth:lung``        — 1-D-coupled transport chain, strongly nonsymmetric.
* ``synth:widerange``   — similarity-scaled convection-diffusion with a huge
  in-block exponent spread (the paper's PR02R pathology, Fig. 10).
* ``synth:varcoef``     — row-scaled convection-diffusion (Jacobi showcase).
* ``synth:stretched``   — mildly stretched-grid convection-diffusion.
* ``synth:stencil27``   — 27-point stencil on a cube.
* ``synth:unstructured``— randomly permuted 27-point stencil on an elongated
  grid (raw bandwidth ~n).

The right-hand side follows the paper (Sec. V-B): ``x_sol = s/||s||`` with
``s[i] = sin(i)``, ``b = A x_sol``, ``x0 = 0``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.csr import CSR, csr_from_coo
from repro_torch.sparse.reorder import permute_csr

__all__ = ["make_problem", "rhs_for", "PROBLEMS", "problem_suite"]


def _stencil3d(nx, ny, nz, wind=(0.4, 0.2, 0.1), diff=1.0, dtype=np.float64):
    """7-point convection-diffusion stencil on an nx×ny×nz grid (central
    differences for diffusion + upwind convection: a nonsymmetric M-matrix)."""
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype))

    diag = 6.0 * diff + sum(abs(w) for w in wind)
    add(idx, idx, diag)
    for axis, w in zip(range(3), wind):
        for sgn in (+1, -1):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if sgn > 0:
                src[axis], dst[axis] = slice(0, -1), slice(1, None)
            else:
                src[axis], dst[axis] = slice(1, None), slice(0, -1)
            r = idx[tuple(src)]
            c = idx[tuple(dst)]
            off = -diff + (-w if sgn > 0 else 0.0) + (w if sgn < 0 else 0.0)
            # upwind: the coefficient against the wind is strengthened
            add(r, c, off - 0.05 * sgn * w)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return rows, cols, vals, n


def _problem_atmosmod(n_target: int, dtype=np.float64) -> CSR:
    s = max(4, round(n_target ** (1 / 3)))
    rows, cols, vals, n = _stencil3d(s, s, s, dtype=dtype)
    A = csr_from_coo(rows, cols, vals, (n, n))
    A.grid = (s, s, s)
    return A


def _problem_aniso2d(n_target: int, dtype=np.float64) -> CSR:
    s = max(4, round(n_target ** 0.5))
    n = s * s
    idx = np.arange(n).reshape(s, s)
    eps = 1e-3  # anisotropy ratio
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype))

    add(idx, idx, 2.0 + 2.0 * eps)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -eps)
    add(idx[:, :-1], idx[:, 1:], -eps)
    A = csr_from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)
    )
    A.grid = (s, s, 1)
    return A


def _problem_lung(n_target: int, dtype=np.float64) -> CSR:
    n = max(16, n_target)
    i = np.arange(n)
    rows = np.concatenate([i, i[1:], i[:-1], i[: n - 7]])
    cols = np.concatenate([i, i[:-1], i[1:], i[7:] if n > 7 else i[:0]])
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        np.full(n, 4.0, dtype),
        np.full(n - 1, -1.7, dtype),          # strong lower coupling
        np.full(n - 1, -0.3, dtype),          # weak upper coupling
        rng.uniform(-0.2, 0.2, max(n - 7, 0)).astype(dtype),
    ])
    return csr_from_coo(rows, cols, vals, (n, n))


def _rescaled(base: CSR, data: np.ndarray) -> CSR:
    A = CSR(base.indptr, base.indices, torch.as_tensor(data), base.shape)
    A.grid = base.grid
    return A


def _problem_widerange(n_target: int, dtype=np.float64,
                       orders: int = 14) -> CSR:
    """PR02R-like (paper Fig. 9b/10): similarity scaling D·A0·D^-1 with
    D = 2^U(-orders, orders)."""
    base = _problem_atmosmod(n_target, dtype)
    n = base.shape[0]
    rng = np.random.default_rng(42)
    d = np.exp2(rng.uniform(-orders, orders, n)).astype(dtype)
    indptr = base.indptr.numpy()
    idx = base.indices.numpy()
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    return _rescaled(base, base.data.numpy() * d[row_ids] / d[idx])


def _problem_varcoef(n_target: int, dtype=np.float64, orders: int = 6) -> CSR:
    """Variable-coefficient convection-diffusion: row scaling D·A0 with
    D = 2^U(-orders, orders) (Jacobi preconditioning is decisive)."""
    base = _problem_atmosmod(n_target, dtype)
    n = base.shape[0]
    rng = np.random.default_rng(11)
    d = np.exp2(rng.uniform(-orders, orders, n)).astype(dtype)
    indptr = base.indptr.numpy()
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    return _rescaled(base, base.data.numpy() * d[row_ids])


def _stencil27_box(nx: int, ny: int, nz: int, dtype=np.float64) -> CSR:
    """27-point convection-diffusion stencil on an nx×ny×nz grid (face/edge/
    corner weights 1 / 0.5 / 0.25, upwind-perturbed, dominant diagonal)."""
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    wind = (0.4, 0.2, 0.1)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, dtype))

    total_off = 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                dist = abs(dx) + abs(dy) + abs(dz)
                base = {1: 1.0, 2: 0.5, 3: 0.25}[dist]
                coeff = -base - 0.1 * (dx * wind[0] + dy * wind[1]
                                       + dz * wind[2])
                total_off += abs(coeff)
                sl_src, sl_dst = [], []
                for d in (dx, dy, dz):
                    if d > 0:
                        sl_src.append(slice(0, -1))
                        sl_dst.append(slice(1, None))
                    elif d < 0:
                        sl_src.append(slice(1, None))
                        sl_dst.append(slice(0, -1))
                    else:
                        sl_src.append(slice(None))
                        sl_dst.append(slice(None))
                add(idx[tuple(sl_src)], idx[tuple(sl_dst)], coeff)
    add(idx, idx, 1.05 * total_off)
    return csr_from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (n, n),
    )


def _problem_stencil27(n_target: int, dtype=np.float64) -> CSR:
    s = max(4, round(n_target ** (1 / 3)))
    A = _stencil27_box(s, s, s, dtype=dtype)
    A.grid = (s, s, s)
    return A


def _problem_unstructured(n_target: int, dtype=np.float64) -> CSR:
    """Randomly row/col-permuted 27-point stencil on an (8s)×s×s grid: same
    spectrum as the banded original, raw column bandwidth ~n."""
    s = max(4, round((n_target / 8) ** (1 / 3)))
    base = _stencil27_box(8 * s, s, s, dtype=dtype)
    scramble = np.random.default_rng(5).permutation(base.shape[0])
    return permute_csr(base, scramble)


def _problem_stretched(n_target: int, dtype=np.float64) -> CSR:
    s = max(4, round(n_target ** (1 / 3)))
    rows, cols, vals, n = _stencil3d(s, s, s, wind=(1.5, 0.0, 0.0), diff=0.3,
                                     dtype=dtype)
    A = csr_from_coo(rows, cols, vals, (n, n))
    A.grid = (s, s, s)
    return A


PROBLEMS = {
    "synth:atmosmod": (_problem_atmosmod, 4.0e-14),
    "synth:aniso2d": (_problem_aniso2d, 1.0e-12),
    "synth:lung": (_problem_lung, 1.0e-10),
    "synth:widerange": (_problem_widerange, 4.0e-03),
    "synth:varcoef": (_problem_varcoef, 1.0e-11),
    "synth:stretched": (_problem_stretched, 4.0e-06),
    "synth:stencil27": (_problem_stencil27, 1.0e-13),
    "synth:unstructured": (_problem_unstructured, 1.0e-13),
}


def make_problem(name: str, n: int = 8000, dtype=np.float64, device="cuda"):
    """Returns (A: CSR on ``device``, target_rrn: float).  Target RRNs mirror
    Table I's per-problem calibration (achievable accuracy + wiggle room)."""
    dev = resolve_device(device)
    try:
        gen, rrn = PROBLEMS[name]
    except KeyError:
        raise ValueError(
            f"unknown problem {name!r}; available problems: "
            f"{', '.join(sorted(PROBLEMS))}") from None
    return gen(n, dtype=dtype).to(dev), rrn


def rhs_for(A: CSR, device="cuda"):
    """Paper Sec. V-B: x_sol = s/||s||, s[i] = sin(i); b = A @ x_sol.

    Computed on ``device`` (``A`` moves there if it is elsewhere)."""
    A = A.to(resolve_device(device))
    s = torch.sin(torch.arange(A.shape[0], dtype=A.dtype, device=A.device))
    x_sol = s / torch.linalg.vector_norm(s)
    return A.matvec(x_sol), x_sol


def problem_suite(n: int = 8000, device="cuda"):
    for name in PROBLEMS:
        A, rrn = make_problem(name, n, device=device)
        b, x_sol = rhs_for(A, device=device)
        yield name, A, b, x_sol, rrn
