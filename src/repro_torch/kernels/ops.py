"""Public wrappers of the Hopper kernels: route, validate, allocate, count.

Routing follows the JAX package's kernel contract (``kernel_supported``,
the same answer as ``repro/kernels/ops.py:60``):

* inside the contract, a CUDA tensor goes to the hand-written Hopper kernel,
  or the wrapper raises: there is no fallback that hides a failed launch;
* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`;
* outside the contract (unaligned ``l`` such as 21, ``bs`` not dividing
  128) the plain codec runs on whatever device the tensor is, exactly where
  the JAX package runs its jnp codec.  The KV cache's write and its decode
  attention are the exceptions: they route by device alone, and a CUDA call
  that the kernel does not take raises (zamba2-7b's head_dim of 112 is no
  divisor of 128, and both kernels take it).

``kernel=False`` forces the plain version on the card too, so that
``chip_smoke.py`` can compare the two routes there; ``kernel=True`` on a CPU
tensor raises.  The ELL SpMV and the Givens step of the GMRES cycle route
the same way, by the device of their tensors, and so do the block
contractions and the block Givens step of block-GMRES, and the decode
attention over an FRSZ2-coded KV cache and the cache's write.  Each
wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches its kernel,
and nowhere else, so a run can show which kernels its main path went
through.

Outputs are allocated with ``torch.empty`` and launched on the current
stream.  ``compress`` can write into caller-given code/exponent rows (a basis
write compresses straight into its row of the store).
"""
from __future__ import annotations

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ref

__all__ = ["LAUNCHES", "reset_launches", "kernel_supported", "compress",
           "decompress", "cache_write", "matvec", "rmatvec", "block_dots",
           "block_combine", "ell_spmv", "givens_step", "block_givens_step",
           "decode_attention"]

#: launches per kernel since the last :func:`reset_launches`
#: (``graph_if``: an IF node's condition, counted by
#: :func:`repro_torch.solver.graphs.device_if`; ``peer_gather``: counted by
#: :func:`repro_torch.kernels.peer_gather.reduce`)
LAUNCHES = {"frsz2_compress": 0, "frsz2_decompress": 0,
            "frsz2_cache_write": 0, "frsz2_matvec": 0,
            "frsz2_rmatvec": 0, "frsz2_block_dots": 0,
            "frsz2_block_combine": 0, "ell_spmv": 0, "ell_spmv_frsz2": 0,
            "gmres_givens": 0, "gmres_block_givens": 0, "decode_attn": 0,
            "graph_if": 0, "peer_gather": 0}

#: the widest block (right-hand sides per block row) the block kernels take
_MAX_BLOCK_P = 16


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
        exps = torch.empty((*batch, nb), dtype=spec.exp_dtype, device=dev)
    else:
        codes, exps = out
        _expect(codes, "codes", (*batch, nb, spec.bs), F.code_dtype(spec.l),
                dev)
        _expect(exps, "exps", (*batch, nb), spec.exp_dtype, dev)
    rows = codes.numel() // (nb * spec.bs) if nb else 0
    if rows and n:
        from repro_torch.kernels import frsz2_kernel as K

        # the kernel writes int32 exponents; a uint8 spec's are narrowed
        # after it (the biased exponents of its value types fit in 8 bits)
        e32 = (exps if spec.exp_dtype == torch.int32 else
               torch.empty(exps.shape, dtype=torch.int32, device=dev))
        x2 = x.to(spec.dtype).contiguous().reshape(rows, n)
        K.compress_2d(x2, codes.view(rows, nb * spec.bs), e32.view(rows, nb),
                      spec)
        LAUNCHES["frsz2_compress"] += 1
        if e32 is not exps:
            exps.copy_(e32)
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
    _expect(bc.exps, "exps", (*batch, nb), spec.exp_dtype, dev)
    if bc.n > nb * bs:
        raise ValueError(f"n={bc.n} exceeds the {nb * bs} coded values")
    out = torch.empty((*batch, bc.n), dtype=spec.dtype, device=dev)
    rows = out.numel() // bc.n if bc.n else 0
    if rows:
        from repro_torch.kernels import frsz2_kernel as K

        K.decompress_2d(bc.codes.view(rows, nb * bs),
                        bc.exps.to(torch.int32).view(rows, nb),
                        out.view(rows, bc.n), spec)
        LAUNCHES["frsz2_decompress"] += 1
    return out


#: value types of the K/V that the cache-write kernel reads
_CACHE_IN = (torch.float32, torch.float16, torch.bfloat16)


def cache_write(k: torch.Tensor, v: torch.Tensor, lengths, k_codes, k_exps,
                v_codes, v_exps, spec: F.FrszSpec, *, ring: int = 0,
                clear_from: int | None = None,
                kernel: bool | None = None) -> None:
    """Write K and V ``(B, T, Hkv, D)`` of one layer into its coded cache,
    in place: codes ``(B, Hkv, S, D)`` and uint8 exponents ``(B, Hkv, S,
    1)``, one block of ``bs = D`` a row, at positions ``lengths[b] + t``
    (``lengths`` ``(B,)``, or None for 0), modulo ``ring`` when it is
    positive.  Positions outside the cache are dropped, as are rows that a
    later row of the same write overwrites in the ring
    (:func:`repro_torch.kernels.ref.cache_write_slots`).  The codes are
    those of the plain compress of the K/V cast to the spec's f32.
    ``clear_from`` zeroes positions ``[clear_from, S)`` of both caches (the
    prefill's padding).  One launch for K and V; K/V may be any strided
    view (f32, f16 or bf16).  Only the device routes: a CUDA write that the
    kernel does not take raises, whatever ``kernel_supported`` says."""
    B, T, Hkv, D = k.shape
    S = k_codes.shape[2]
    if clear_from is not None and not 0 <= clear_from <= S:
        raise ValueError(f"clear_from={clear_from} outside [0, {S}]")
    if not _use_kernel(k, None, kernel):
        ref.cache_write_ref(k, v, lengths, k_codes, k_exps, v_codes, v_exps,
                            spec, ring, clear_from)
        return
    dev = k.device
    if (spec.dtype != torch.float32 or spec.exp_dtype != torch.uint8
            or spec.bs != D or not 0 < D <= 128 or spec.l not in (8, 16, 32)
            or spec.rounding != "nearest" or k.dtype not in _CACHE_IN):
        raise NotImplementedError(
            f"the cache write has no kernel for {spec.name} "
            f"({spec.rounding}, {spec.exp_dtype} exponents) over {k.dtype} "
            f"K/V of D = {D}: it takes f32 specs with bs = D <= 128, l 8, 16 "
            "or 32, nearest rounding and uint8 exponents, over f32/f16/bf16 "
            "K/V")
    if v.shape != k.shape or v.dtype != k.dtype or v.device != dev:
        raise ValueError(f"v {tuple(v.shape)} {v.dtype} on {v.device} does "
                         f"not match k {tuple(k.shape)} {k.dtype} on {dev}")
    cd = F.code_dtype(spec.l)
    for name, t in (("k codes", k_codes), ("v codes", v_codes)):
        _expect(t, name, (B, Hkv, S, D), cd, dev)
    for name, t in (("k exps", k_exps), ("v exps", v_exps)):
        _expect(t, name, (B, Hkv, S, 1), torch.uint8, dev)
    if lengths is not None:
        if lengths.dtype != torch.int32:
            lengths = lengths.to(torch.int32)
        _expect(lengths, "lengths", (B,), torch.int32, dev)
    if ring < 0:
        raise ValueError(f"ring={ring} must be >= 0")
    if B * Hkv == 0 or S == 0 or (T == 0 and clear_from in (None, S)):
        return
    from repro_torch.kernels import frsz2_kernel as K

    K.cache_write(k, v, lengths, k_codes, k_exps, v_codes, v_exps, ring,
                  S if clear_from is None else clear_from, spec)
    LAUNCHES["frsz2_cache_write"] += 1


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

    # the route: whole words of codes a row where the rows start on one (a
    # codes view at another offset, or a row length that is no multiple of
    # the codes a word, reads the codes one by one inside the kernel)
    word = KD.word_bytes()
    npad = nb * spec.bs
    vec = (npad % (word // bc.codes.element_size()) == 0
           and bc.codes.data_ptr() % word == 0)
    KD.rmatvec_2d(bc.codes.view(m, npad), bc.exps, hs, y, spec, vec)
    LAUNCHES["frsz2_rmatvec"] += 1
    return y


# ---------------------------------------------------------------------------
# fused decode + block contraction over a flattened block basis
# ---------------------------------------------------------------------------


def _block_view(bc: F.BlockCompressed, p: int, rows: int):
    """The first ``rows`` flat block rows of ``p`` segments viewed as
    ``rows * p`` segment rows: (codes (M, nbs, bs), exps (M, nbs), n_seg).

    The layout of ``repro/kernels/ops.py:_block_layout``: every segment is
    a whole number of codec blocks (``BlockBasisAccessor`` aligns it to
    ``block_align()``), so no block straddles a segment edge."""
    m, nb = bc.exps.shape
    if p <= 0 or nb % p:
        raise ValueError(f"{nb} codec blocks per row do not split into "
                         f"p={p} segments")
    if not 0 <= rows <= m:
        raise ValueError(f"rows={rows} outside a store of {m} block rows")
    nbs = nb // p
    words = bc.codes.shape[-1]           # bs codes, or packed words
    return (bc.codes[:rows].reshape(rows * p, nbs, words),
            bc.exps[:rows].reshape(rows * p, nbs), nbs * bc.spec.bs)


def _check_block_p(q: int) -> None:
    if not 1 <= q <= _MAX_BLOCK_P:
        raise NotImplementedError(
            f"a block of {q} right-hand sides has no kernel "
            f"(1..{_MAX_BLOCK_P})")


def _dots_chunk(M: int, n_seg: int) -> int:
    """Columns one block-dots block reduces: about 4096 (row group, chunk)
    blocks, some fifteen waves of the two blocks each SM holds (so the last
    wave's tail is a few per cent), at most 8192 columns each, a multiple
    of the kernel's 256-column chunk granule.  A function of the shape
    only, so a contraction gives the same bits on every call."""
    from repro_torch.kernels import frsz2_block as KB

    groups = -(-M // KB.ROWS_PER_BLOCK)
    want = max(1, -(-4096 // groups))
    cols = -(-n_seg // want)
    cols = -(-cols // KB.SUB_COLS) * KB.SUB_COLS
    return min(max(cols, KB.SUB_COLS), 32 * KB.SUB_COLS)


def block_dots(bc: F.BlockCompressed, W: torch.Tensor, *, p: int,
               rows: int, kernel: bool | None = None) -> torch.Tensor:
    """``H (rows, p, q) = einsum('ian,bn->iab', decompress(V)[:rows], W)``.

    ``bc`` holds flat block rows of ``p`` segment-aligned per-RHS segments
    of ``n_seg`` values; only the first ``rows`` (the live block rows) are
    read.  ``W (q, n)`` with ``n <= n_seg`` is zero-padded to the segment
    length (the store's pad values decode to exact zeros).  Contracted in
    the spec's value dtype.
    """
    spec = bc.spec
    codes, exps, n_seg = _block_view(bc, p, rows)
    q, n = W.shape
    if n > n_seg:
        raise ValueError(f"W has {n} columns, segments hold {n_seg}")
    Wp = torch.nn.functional.pad(W.to(spec.dtype), (0, n_seg - n))
    if not _use_kernel(bc.codes, spec, kernel):
        if not kernel_supported(spec):
            V = F.decompress(F.BlockCompressed(codes=codes, exps=exps,
                                               n=n_seg, spec=spec))
            return (V @ Wp.T).reshape(rows, p, q)
        return ref.block_dots_ref(codes, exps, Wp, spec).reshape(rows, p, q)
    _check_block_p(q)
    _check_basis(bc)
    if bc.codes.data_ptr() % 16:
        raise ValueError("block dots read codes in 16-byte words: the "
                         "store must start 16-byte aligned")
    dev = bc.codes.device
    Wp = Wp.contiguous()
    if Wp.data_ptr() % 16:              # the kernel copies W in 16 bytes
        Wp = Wp.clone()
    _expect(Wp, "W", (q, n_seg), spec.dtype, dev)
    M = rows * p
    Y = torch.empty((M, q), dtype=spec.dtype, device=dev)
    if M == 0:
        return Y.reshape(rows, p, q)
    from repro_torch.kernels import frsz2_block as KB

    cols = _dots_chunk(M, n_seg)
    partial = torch.empty((M, -(-n_seg // cols), q), dtype=spec.dtype,
                          device=dev)
    KB.block_dots_2d(codes.view(M, n_seg), exps, Wp, partial, Y, cols, spec)
    LAUNCHES["frsz2_block_dots"] += 1
    return Y.reshape(rows, p, q)


def block_combine(bc: F.BlockCompressed, Y: torch.Tensor, *, p: int,
                  kernel: bool | None = None) -> torch.Tensor:
    """``out (q, n_seg) = einsum('iab,ian->bn', Y, decompress(V)[:rows])``
    for the ``rows = len(Y)`` leading block rows; ``Y (rows, p, q)``.  The
    caller trims the segment padding back to the logical length."""
    spec = bc.spec
    rows, pY, q = Y.shape
    if pY != p:
        raise ValueError(f"Y must be (rows, {p}, q), got {tuple(Y.shape)}")
    codes, exps, n_seg = _block_view(bc, p, rows)
    M = rows * p
    Y2 = Y.to(spec.dtype).reshape(M, q)
    if not _use_kernel(bc.codes, spec, kernel):
        if not kernel_supported(spec):
            V = F.decompress(F.BlockCompressed(codes=codes, exps=exps,
                                               n=n_seg, spec=spec))
            return Y2.T @ V
        return ref.block_combine_ref(codes, exps, Y2, spec)
    _check_block_p(q)
    _check_basis(bc)
    if bc.codes.data_ptr() % (spec.l // 2):
        raise ValueError("the block combine reads codes four at a time: "
                         "the store must start aligned to four codes")
    dev = bc.codes.device
    Y2 = Y2.contiguous()
    _expect(Y2, "Y", (M, q), spec.dtype, dev)
    out = torch.empty((q, n_seg), dtype=spec.dtype, device=dev)
    if M == 0:
        return out.zero_()
    from repro_torch.kernels import frsz2_block as KB

    KB.block_combine_2d(codes.view(M, n_seg), exps, Y2, out, spec)
    LAUNCHES["frsz2_block_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# ELL SpMV, dense or FRSZ2-coded operand
# ---------------------------------------------------------------------------


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x, *,
             kernel: bool | None = None) -> torch.Tensor:
    """``y (nr,) = ELL(vals, cols) @ x``; ``x`` is a dense ``(nc,)`` vector or
    an FRSZ2 :class:`~repro_torch.core.frsz2.BlockCompressed` one, decoded
    entry by entry inside the kernel.  ``vals`` (nr, w) f32/f64, ``cols``
    (nr, w) int32 with every entry in ``[0, nc)``.  A dense block ``x (q,
    nc)`` gives ``y (q, nr)`` in one launch (counted as one ``ell_spmv``).
    """
    coded = isinstance(x, F.BlockCompressed)
    if vals.ndim != 2:
        raise ValueError(f"vals must be (nr, w), got {tuple(vals.shape)}")
    if coded and (x.codes.ndim != 2 or x.exps.ndim != 1):
        raise ValueError("a coded operand must be one vector: codes (nb, bs), "
                         f"exps (nb,); got {tuple(x.codes.shape)}, "
                         f"{tuple(x.exps.shape)}")
    if not coded and x.ndim not in (1, 2):
        raise ValueError(f"x must be (nc,) or (q, nc), got {tuple(x.shape)}")
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
    y = torch.empty((*(() if coded else x.shape[:-1]), nr), dtype=vals.dtype,
                    device=dev)
    if y.numel() == 0 or w == 0:
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
        KE.ell_spmv_2d(vals, cols, xs.view(-1, xs.shape[-1]),
                       y.view(-1, nr))
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


def block_givens_step(state: torch.Tensor, H: torch.Tensor, T: torch.Tensor,
                      fired: torch.Tensor, bn_safe: torch.Tensor, j: int,
                      m: int, p: int, target: float, *,
                      kernel: bool | None = None) -> None:
    """Block step ``j`` of the block cycle's banded least squares, in place
    on the f64 ``state`` (layout:
    :func:`repro_torch.kernels.ref.block_givens_layout`).  See
    :func:`repro_torch.kernels.ref.block_givens_step_ref` for what it
    computes."""
    if not 0 <= j < m:
        raise ValueError(f"step j={j} outside a cycle of m={m}")
    if not _use_kernel(state, None, kernel):
        ref.block_givens_step_ref(state, H, T, fired, bn_safe, j, m, p,
                                  target)
        return
    _check_block_p(p)
    dev = state.device
    _expect(state, "state", (ref.block_givens_layout(m, p)["size"],),
            torch.float64, dev)
    H = H.to(torch.float64).contiguous()
    T = T.to(torch.float64).contiguous()
    bn_safe = bn_safe.to(torch.float64).contiguous()
    _expect(H.view(-1, p), "H", ((j + 1) * p, p), torch.float64, dev)
    _expect(T, "T", (p, p), torch.float64, dev)
    _expect(bn_safe, "bn_safe", (p,), torch.float64, dev)
    _expect(fired, "fired", (), torch.bool, dev)
    from repro_torch.kernels import gmres_step as KG

    KG.block_givens_step(state, H, T, fired, bn_safe, j, m, p, target)
    LAUNCHES["gmres_block_givens"] += 1


# ---------------------------------------------------------------------------
# Flash-decode attention over an FRSZ2-coded KV cache
# ---------------------------------------------------------------------------

#: head widths and code lengths the decode-attention kernel takes
_ATTN_D = (64, 112, 128)
_ATTN_L = (8, 16)
_ATTN_Q = (torch.float32, torch.bfloat16)


def decode_attention(q: torch.Tensor, k_bc: F.BlockCompressed,
                     v_bc: F.BlockCompressed, lengths: torch.Tensor, *,
                     sm_scale: float | None = None,
                     kernel: bool | None = None) -> torch.Tensor:
    """One new token's GQA attention over a coded K/V cache.

    ``q (B, H, D)``; ``k_bc``/``v_bc`` hold codes ``(B, Hkv, S, nbd, bs)``
    and exponents ``(B, Hkv, S, nbd)`` with ``D = nbd * bs`` (the KV cache
    uses ``bs = D``); ``lengths (B,)`` or ``(B, 1)``: positions at or past
    ``lengths[b]`` are masked.  Returns ``(B, H, D)`` in q's dtype,
    computed in f32 (``sm_scale`` defaults to ``D ** -0.5``).  The kernel
    takes f32 values coded with ``l`` 8 or 16, ``D`` 64, 112 or 128 (a
    block size that is no power of two only as one block a row, ``bs =
    D``), f32 or bf16 q, any ``S`` and any ``G = H / Hkv``; it reads uint8
    exponents (the KV cache's), and int32 ones are narrowed for it first.
    Only the device routes, as for :func:`cache_write`: a CPU tensor runs
    the plain version, and a CUDA call the kernel does not take raises
    before any launch (it never runs the plain version on the card, unless
    ``kernel=False`` asks for it).
    """
    spec = k_bc.spec
    B, H, D = q.shape
    _, Hkv, S, nbd = k_bc.exps.shape
    if H % Hkv or nbd * spec.bs != D or v_bc.exps.shape != k_bc.exps.shape:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches of exps "
                         f"{tuple(k_bc.exps.shape)} / "
                         f"{tuple(v_bc.exps.shape)} at bs={spec.bs}")
    G = H // Hkv
    kcodes = k_bc.codes.reshape(B, Hkv, S, D)
    vcodes = v_bc.codes.reshape(B, Hkv, S, D)
    if sm_scale is None:
        sm_scale = D ** -0.5
    if not _use_kernel(q, None, kernel):
        return ref.decode_attn_ref(q, kcodes, k_bc.exps, vcodes, v_bc.exps,
                                   lengths.reshape(B), spec,
                                   sm_scale=sm_scale)
    if (D not in _ATTN_D or spec.l not in _ATTN_L or q.dtype not in _ATTN_Q
            or spec.dtype != torch.float32
            or (nbd > 1 and spec.bs & (spec.bs - 1))):
        raise NotImplementedError(
            f"decode attention has no kernel for D={D}, bs={spec.bs}, "
            f"l={spec.l}, {F.dtype_name(spec.dtype)} values, {q.dtype} "
            f"queries (D in {_ATTN_D}, bs = D or a power of two, l in "
            f"{_ATTN_L}, f32 values, f32/bf16 q)")
    dev = q.device
    q = q.contiguous()
    cd = F.code_dtype(spec.l)
    for name, t in (("k codes", kcodes), ("v codes", vcodes)):
        _expect(t, name, (B, Hkv, S, D), cd, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             "kernel stages them by 16-byte cp.async)")
    exps = []
    for name, t in (("k exps", k_bc.exps), ("v exps", v_bc.exps)):
        _expect(t, name, (B, Hkv, S, nbd), spec.exp_dtype, dev)
        exps.append(t.to(torch.uint8))     # f32 biased exponents: 8 bits
    lens = lengths.reshape(B).to(torch.int32).contiguous()
    if lens.device != dev:
        raise ValueError(f"lengths are on {lens.device}, expected {dev}")
    from repro_torch.kernels import decode_attn as KA

    chunk, nsplit = KA.splits(
        B, Hkv, G, S, KA.resident_blocks(G, D, nbd, spec.l, q.dtype, dev.index))
    part_acc = torch.empty((B, Hkv, G, nsplit, D), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B, Hkv, G, nsplit, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    if B and S:
        KA.decode_attn(q.view(B, Hkv, G, D), kcodes, exps[0], vcodes,
                       exps[1], lens, part_acc, part_ml,
                       out.view(B, Hkv, G, D), chunk, spec, float(sm_scale))
        LAUNCHES["decode_attn"] += 1
    else:
        out.zero_()
    return out
