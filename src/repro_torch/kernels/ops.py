"""Public wrappers of the Hopper kernels: route, validate, allocate, count.

Routing follows the JAX package's kernel contract (``kernel_supported``,
the same answer as ``repro/kernels/ops.py:60``):

* inside the contract, a CUDA tensor goes to the hand-written Hopper kernel,
  or the wrapper raises: there is no fallback that hides a failed launch;
* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`;
* outside the contract (unaligned ``l`` such as 21, ``bs`` not dividing
  128) the plain codec runs on whatever device the tensor is, exactly where
  the JAX package runs its jnp codec.

``kernel=False`` forces the plain version on the card too, so that
``chip_smoke.py`` can compare the two routes there; ``kernel=True`` on a CPU
tensor raises.  The ELL SpMV and the Givens step of the GMRES cycle route
the same way, by the device of their tensors.  Each wrapper adds one to
``LAUNCHES[<kernel>]`` where it launches its kernel, and nowhere else, so a
run can show which kernels its main path went through.

Outputs are allocated with ``torch.empty`` and launched on the current
stream.  ``compress`` can write into caller-given code/exponent rows (a basis
write compresses straight into its row of the store).
"""
from __future__ import annotations

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ref

__all__ = ["LAUNCHES", "reset_launches", "kernel_supported", "compress",
           "decompress", "matvec", "rmatvec", "ell_spmv", "givens_step"]

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"frsz2_compress": 0, "frsz2_decompress": 0, "frsz2_matvec": 0,
            "frsz2_rmatvec": 0, "ell_spmv": 0, "ell_spmv_frsz2": 0,
            "gmres_givens": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_supported(spec: F.FrszSpec) -> bool:
    """The kernel contract: aligned ``l <= 32`` and ``bs`` dividing 128."""
    return spec.aligned and spec.l <= 32 and 128 % spec.bs == 0


def _use_kernel(t: torch.Tensor, spec: F.FrszSpec | None,
                kernel: bool | None) -> bool:
    """``spec=None``: a kernel with no codec contract (ELL, Givens step)."""
    if kernel is False or (spec is not None and not kernel_supported(spec)):
        return False
    if t.is_cuda:
        return True
    if kernel:
        raise RuntimeError(f"kernel=True needs CUDA tensors, got {t.device}")
    return False


def _expect(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_FLOATS = (torch.float32, torch.float64)


def _check_value_dtype(spec: F.FrszSpec, what: str) -> None:
    if spec.dtype not in _FLOATS:
        raise NotImplementedError(
            f"fused {F.dtype_name(spec.dtype)} {what} have no kernel: the "
            "solver builds f32/f64 specs only")


def _check_basis(bc: F.BlockCompressed):
    spec = bc.spec
    if bc.codes.ndim != 3:
        raise ValueError(f"basis codes must be (m, nb, bs), got "
                         f"{tuple(bc.codes.shape)}")
    m, nb, _ = bc.codes.shape
    dev = bc.codes.device
    _expect(bc.codes, "codes", (m, nb, spec.bs), F.code_dtype(spec.l), dev)
    _expect(bc.exps, "exps", (m, nb), torch.int32, dev)
    _check_value_dtype(spec, "contractions")
    return m, nb


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def compress(x: torch.Tensor, spec: F.FrszSpec, *, out=None,
             kernel: bool | None = None) -> F.BlockCompressed:
    """FRSZ2-compress ``x (..., n)`` along its last axis.

    ``out=(codes, exps)`` (shaped ``(..., nb, bs)`` and ``(..., nb)``) is
    written in place and returned inside the result.
    """
    *batch, n = x.shape
    if not _use_kernel(x, spec, kernel):
        bc = F.compress(x, spec)
        if out is None:
            return bc
        out[0].copy_(bc.codes)
        out[1].copy_(bc.exps)
        return F.BlockCompressed(codes=out[0], exps=out[1], n=n, spec=spec)
    nb = -(-n // spec.bs)
    dev = x.device
    if out is None:
        codes = torch.empty((*batch, nb, spec.bs), dtype=F.code_dtype(spec.l),
                            device=dev)
        exps = torch.empty((*batch, nb), dtype=torch.int32, device=dev)
    else:
        codes, exps = out
        _expect(codes, "codes", (*batch, nb, spec.bs), F.code_dtype(spec.l),
                dev)
        _expect(exps, "exps", (*batch, nb), torch.int32, dev)
    rows = codes.numel() // (nb * spec.bs) if nb else 0
    if rows and n:
        from repro_torch.kernels import frsz2_kernel as K

        x2 = x.to(spec.dtype).contiguous().reshape(rows, n)
        K.compress_2d(x2, codes.view(rows, nb * spec.bs), exps.view(rows, nb),
                      spec)
        LAUNCHES["frsz2_compress"] += 1
    return F.BlockCompressed(codes=codes, exps=exps, n=n, spec=spec)


def decompress(bc: F.BlockCompressed, *, kernel: bool | None = None
               ) -> torch.Tensor:
    """Inverse of :func:`compress`: the logical ``(..., n)`` values."""
    spec = bc.spec
    if not _use_kernel(bc.codes, spec, kernel):
        return F.decompress(bc)
    *batch, nb, bs = bc.codes.shape
    dev = bc.codes.device
    _expect(bc.codes, "codes", (*batch, nb, spec.bs), F.code_dtype(spec.l),
            dev)
    _expect(bc.exps, "exps", (*batch, nb), torch.int32, dev)
    if bc.n > nb * bs:
        raise ValueError(f"n={bc.n} exceeds the {nb * bs} coded values")
    out = torch.empty((*batch, bc.n), dtype=spec.dtype, device=dev)
    rows = out.numel() // bc.n if bc.n else 0
    if rows:
        from repro_torch.kernels import frsz2_kernel as K

        K.decompress_2d(bc.codes.view(rows, nb * bs), bc.exps.view(rows, nb),
                        out.view(rows, bc.n), spec)
        LAUNCHES["frsz2_decompress"] += 1
    return out


# ---------------------------------------------------------------------------
# fused decode + contraction over a compressed row basis V (m, n)
# ---------------------------------------------------------------------------


def matvec(bc: F.BlockCompressed, x: torch.Tensor, *,
           kernel: bool | None = None) -> torch.Tensor:
    """``y (m,) = decompress(V) @ x`` for V ``(m, n)`` compressed row-wise."""
    spec = bc.spec
    n = bc.n
    if x.shape != (n,):
        raise ValueError(f"x must be ({n},), got {tuple(x.shape)}")
    if not _use_kernel(bc.codes, spec, kernel):
        if not kernel_supported(spec):
            V = F.decompress(bc)
            return V @ x.to(V.dtype)
        npad = bc.codes.shape[-2] * spec.bs
        return ref.matvec_ref(bc.codes, bc.exps,
                              torch.nn.functional.pad(x, (0, npad - n)), spec)
    m, nb = _check_basis(bc)
    xs = x.to(spec.dtype).contiguous()
    _expect(xs, "x", (n,), spec.dtype, bc.codes.device)
    y = torch.empty((m,), dtype=spec.dtype, device=x.device)
    if m == 0 or n == 0:
        return y.zero_()
    from repro_torch.kernels import frsz2_dot as KD

    partial = torch.empty((m, -(-n // KD.chunk())), dtype=spec.dtype,
                          device=x.device)
    KD.matvec_2d(bc.codes.view(m, nb * spec.bs), bc.exps, xs, partial, y,
                 spec)
    LAUNCHES["frsz2_matvec"] += 1
    return y


def rmatvec(bc: F.BlockCompressed, h: torch.Tensor, *,
            kernel: bool | None = None) -> torch.Tensor:
    """``y (n,) = h @ decompress(V)`` for V ``(m, n)`` compressed row-wise."""
    spec = bc.spec
    n = bc.n
    m = bc.codes.shape[0]
    if h.shape != (m,):
        raise ValueError(f"h must be ({m},), got {tuple(h.shape)}")
    if not _use_kernel(bc.codes, spec, kernel):
        if not kernel_supported(spec):
            V = F.decompress(bc)
            return h.to(V.dtype) @ V
        return ref.rmatvec_ref(bc.codes, bc.exps, h, spec)[:n]
    m, nb = _check_basis(bc)
    hs = h.to(spec.dtype).contiguous()
    _expect(hs, "h", (m,), spec.dtype, bc.codes.device)
    y = torch.empty((n,), dtype=spec.dtype, device=h.device)
    if m == 0 or n == 0:
        return y.zero_()
    from repro_torch.kernels import frsz2_dot as KD

    KD.rmatvec_2d(bc.codes.view(m, nb * spec.bs), bc.exps, hs, y, spec)
    LAUNCHES["frsz2_rmatvec"] += 1
    return y


# ---------------------------------------------------------------------------
# ELL SpMV, dense or FRSZ2-coded operand
# ---------------------------------------------------------------------------


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x, *,
             kernel: bool | None = None) -> torch.Tensor:
    """``y (nr,) = ELL(vals, cols) @ x``; ``x`` is a dense ``(nc,)`` vector or
    an FRSZ2 :class:`~repro_torch.core.frsz2.BlockCompressed` one, decoded
    entry by entry inside the kernel.  ``vals`` (nr, w) f32/f64, ``cols``
    (nr, w) int32 with every entry in ``[0, nc)``.
    """
    coded = isinstance(x, F.BlockCompressed)
    if vals.ndim != 2:
        raise ValueError(f"vals must be (nr, w), got {tuple(vals.shape)}")
    if coded and (x.codes.ndim != 2 or x.exps.ndim != 1):
        raise ValueError("a coded operand must be one vector: codes (nb, bs), "
                         f"exps (nb,); got {tuple(x.codes.shape)}, "
                         f"{tuple(x.exps.shape)}")
    if not coded and x.ndim != 1:
        raise ValueError(f"x must be a vector, got {tuple(x.shape)}")
    if not _use_kernel(vals, x.spec if coded else None, kernel):
        if coded:
            return ref.ell_spmv_frsz2_ref(vals, cols, x)
        return ref.ell_spmv_ref(vals, cols, x)
    nr, w = vals.shape
    dev = vals.device
    if vals.dtype not in _FLOATS:
        raise NotImplementedError(f"ELL values of {vals.dtype} have no kernel")
    _expect(vals, "vals", (nr, w), vals.dtype, dev)
    _expect(cols, "cols", (nr, w), torch.int32, dev)
    y = torch.empty((nr,), dtype=vals.dtype, device=dev)
    if nr == 0 or w == 0:
        return y.zero_()
    from repro_torch.kernels import ell_spmv as KE

    if coded:
        spec = x.spec
        _check_value_dtype(spec, "operands")
        nb = x.exps.shape[0]
        _expect(x.codes, "codes", (nb, spec.bs), F.code_dtype(spec.l), dev)
        _expect(x.exps, "exps", (nb,), torch.int32, dev)
        KE.ell_spmv_frsz2_2d(vals, cols, x.codes, x.exps, y, spec)
        LAUNCHES["ell_spmv_frsz2"] += 1
    else:
        xs = x.to(vals.dtype).contiguous()
        if xs.device != dev:
            raise ValueError(f"x is on {xs.device}, expected {dev}")
        KE.ell_spmv_2d(vals, cols, xs, y)
        LAUNCHES["ell_spmv"] += 1
    return y


# ---------------------------------------------------------------------------
# One Givens step of the GMRES cycle (the device driver's bookkeeping)
# ---------------------------------------------------------------------------


def givens_step(state: torch.Tensor, h: torch.Tensor, hj1: torch.Tensor,
                w_pre: torch.Tensor, fired: torch.Tensor, b_norm: torch.Tensor,
                j: int, m: int, target: float, *,
                kernel: bool | None = None) -> None:
    """Step ``j`` of the cycle's Givens least squares, in place on the f64
    ``state`` (layout: :func:`repro_torch.kernels.ref.givens_layout`).  See
    :func:`repro_torch.kernels.ref.givens_step_ref` for what it computes."""
    if not 0 <= j < m:
        raise ValueError(f"step j={j} outside a cycle of m={m}")
    if not _use_kernel(state, None, kernel):
        ref.givens_step_ref(state, h, hj1, w_pre, fired, b_norm, j, m, target)
        return
    dev = state.device
    dt = h.dtype
    if dt not in _FLOATS:
        raise NotImplementedError(f"a Givens step in {dt} has no kernel")
    _expect(state, "state", (ref.givens_layout(m)["size"],), torch.float64,
            dev)
    _expect(h, "h", (j + 1,), dt, dev)
    for name, t in (("hj1", hj1), ("w_pre", w_pre), ("b_norm", b_norm)):
        _expect(t, name, (), dt, dev)
    _expect(fired, "fired", (), torch.bool, dev)
    from repro_torch.kernels import gmres_step as KG

    KG.givens_step(state, h, hj1, w_pre, fired, b_norm, j, m, target)
    LAUNCHES["gmres_givens"] += 1
