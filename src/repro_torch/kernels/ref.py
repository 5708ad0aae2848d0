"""Plain PyTorch versions of the Hopper kernels: what each kernel computes.

The kernels in ``frsz2_kernel.py`` / ``frsz2_dot.py`` / ``ell_spmv.py`` /
``gmres_step.py`` must match these: bit for bit on the codec, the ELL SpMV
and the Givens step, to float tolerance on the basis contractions.  The
contractions accumulate in the value dtype of the spec (f64 for the solver's
formats).  On the CPU the wrappers in ``ops.py`` run these; on the card
``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import frsz2 as F


def compress_ref(x: torch.Tensor, spec: F.FrszSpec):
    """Returns (codes, exps) with codes shaped ``batch + (nb, bs)``."""
    bc = F.compress(x, spec)
    return bc.codes, bc.exps


def decompress_ref(codes: torch.Tensor, exps: torch.Tensor, spec: F.FrszSpec,
                   n: int | None = None) -> torch.Tensor:
    nb, bs = codes.shape[-2], codes.shape[-1]
    if n is None:
        n = nb * bs
    return F.decompress(F.BlockCompressed(codes=codes, exps=exps, n=n,
                                          spec=spec))


def matvec_ref(codes, exps, x, spec: F.FrszSpec) -> torch.Tensor:
    """y[i] = sum_j decompress(V)[i, j] * x[j].

    codes: (m, nb, bs); exps: (m, nb); x: (nb*bs,)  ->  y: (m,)
    """
    V = decompress_ref(codes, exps, spec)
    return V @ x.to(V.dtype)


def rmatvec_ref(codes, exps, h, spec: F.FrszSpec) -> torch.Tensor:
    """y[j] = sum_i h[i] * decompress(V)[i, j].

    codes: (m, nb, bs); exps: (m, nb); h: (m,)  ->  y: (nb*bs,)
    """
    V = decompress_ref(codes, exps, spec)
    return h.to(V.dtype) @ V


# ---------------------------------------------------------------------------
# ELL SpMV (csrc/ell_spmv.cu)
# ---------------------------------------------------------------------------


def ell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y (nr,) = ELL(vals, cols) @ x: gather, multiply, sum each row.

    vals (nr, w) f32/f64; cols (nr, w) int32 (padding slots: val 0, col 0);
    x (nc,), taken in the dtype of ``vals``.  Each row sums its w products
    in slot order, starting from 0: the order of the JAX package's gather
    sum and of the kernel, so all three give the same bits.
    """
    xv = x.to(vals.dtype)
    y = torch.zeros(vals.shape[0], dtype=vals.dtype, device=vals.device)
    for k in range(vals.shape[1]):
        y = y + vals[:, k] * xv[cols[:, k]]
    return y


def ell_spmv_frsz2_ref(vals: torch.Tensor, cols: torch.Tensor,
                       bc: F.BlockCompressed) -> torch.Tensor:
    """As :func:`ell_spmv_ref`, the operand given FRSZ2-coded: decompress,
    then the same."""
    return ell_spmv_ref(vals, cols, F.decompress(bc))


# ---------------------------------------------------------------------------
# One Givens step of the GMRES cycle (csrc/gmres_step.cu)
# ---------------------------------------------------------------------------

_TINY = 1e-300


def givens_layout(m: int) -> dict:
    """Offsets of the cycle's f64 state vector for restart length ``m``:
    ``R`` ((m+1) x m, row-major), ``g`` (m+1), ``est`` (m), ``extra`` (1),
    ``cs`` (m), ``sn`` (m), ``alive`` (1).  ``R``, ``g``, ``est`` and
    ``extra`` come first, so the driver's one read per restart is a
    prefix of it."""
    off = {"R": 0, "g": (m + 1) * m}
    off["est"] = off["g"] + m + 1
    off["extra"] = off["est"] + m
    off["cs"] = off["extra"] + 1
    off["sn"] = off["cs"] + m
    off["alive"] = off["sn"] + m
    off["size"] = off["alive"] + 1
    return off


def givens_init_ref(m: int, device) -> torch.Tensor:
    """The state at the start of a cycle, ``g[0]`` still 0: R, g, cs, sn
    zero, est +inf, extra 0, alive 1."""
    L = givens_layout(m)
    s = torch.zeros(L["size"], dtype=torch.float64, device=device)
    s[L["est"]:L["est"] + m] = math.inf
    s[L["alive"]] = 1.0
    return s


def givens_step_ref(state: torch.Tensor, h: torch.Tensor, hj1: torch.Tensor,
                    w_pre: torch.Tensor, fired: torch.Tensor,
                    b_norm: torch.Tensor, j: int, m: int,
                    target: float) -> None:
    """Step ``j`` of the cycle's least squares, in place on ``state``.

    ``h`` (j+1,) is the new Hessenberg column above the diagonal, ``hj1``
    its subdiagonal ``||w||``, ``w_pre`` the norm before orthogonalization,
    ``fired`` whether MGS re-orthogonalized.  While ``alive``: apply the j
    earlier rotations to the column, form rotation j, update ``g``, write
    column j of ``R``, ``cs[j]``, ``sn[j]`` and ``est[j] = |g[j+1]| /
    b_norm``, add ``fired * (j+1)`` to ``extra``, and drop ``alive`` on a
    breakdown or once ``est[j]`` meets ``target``.  Once dead, ``est[j]``
    repeats ``est[j-1]`` and nothing else changes.  The arithmetic is the
    host driver's, in Python floats, operation for operation.
    """
    L = givens_layout(m)
    s = state
    if not float(s[L["alive"]]):
        if j > 0:
            s[L["est"] + j] = s[L["est"] + j - 1]
        return
    hj1, w_pre = float(hj1), float(w_pre)
    breakdown = hj1 <= 1e-30 * w_pre + _TINY
    col = [float(v) for v in h.tolist()] + [hj1]
    cs = s[L["cs"]:L["cs"] + j].tolist()
    sn = s[L["sn"]:L["sn"] + j].tolist()
    for i in range(j):
        a, bb = col[i], col[i + 1]
        col[i] = cs[i] * a + sn[i] * bb
        col[i + 1] = -sn[i] * a + cs[i] * bb
    a, bb = col[j], col[j + 1]
    denom = math.sqrt(a * a + bb * bb)
    c, sj = (a / denom, bb / denom) if denom > 0 else (1.0, 0.0)
    col[j] = c * a + sj * bb
    col[j + 1] = 0.0
    gj = float(s[L["g"] + j])
    g1 = -sj * gj
    s[L["g"] + j] = c * gj
    s[L["g"] + j + 1] = g1
    R = s[:L["g"]].view(m + 1, m)
    R[:j + 2, j] = torch.tensor(col, dtype=torch.float64)
    s[L["cs"] + j] = c
    s[L["sn"] + j] = sj
    resid = abs(g1) / float(b_norm)
    s[L["est"] + j] = resid
    s[L["extra"]] += float(bool(fired)) * (j + 1)
    s[L["alive"]] = float(not breakdown and resid > target)
