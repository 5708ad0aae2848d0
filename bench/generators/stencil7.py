"""3-D convection-diffusion 7-point stencil (central diffusion, upwind
convection, a nonsymmetric M-matrix): a frozen copy of the port's
``synth:atmosmod`` generator, bit for bit."""
import numpy as np

from bench.operators import csr_from_coo


def generate(grid, wind=(0.4, 0.2, 0.1), diff=1.0):
    nx, ny, nz = grid
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v, np.float64))

    add(idx, idx, 6.0 * diff + sum(abs(w) for w in wind))
    for axis, w in zip(range(3), wind):
        for sgn in (+1, -1):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if sgn > 0:
                src[axis], dst[axis] = slice(0, -1), slice(1, None)
            else:
                src[axis], dst[axis] = slice(1, None), slice(0, -1)
            off = -diff + (-w if sgn > 0 else 0.0) + (w if sgn < 0 else 0.0)
            add(idx[tuple(src)], idx[tuple(dst)], off - 0.05 * sgn * w)
    return csr_from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), n)
