"""Plain PyTorch versions of the Hopper kernels: what each kernel computes.

The kernels in ``frsz2_kernel.py`` (the codec and the KV-cache write) /
``frsz2_dot.py`` / ``frsz2_block.py`` /
``ell_spmv.py`` / ``gmres_step.py`` / ``decode_attn.py`` must match these:
bit for bit on the codec, the ELL SpMV and the two Givens steps, to float
tolerance on the basis contractions and the decode attention.  The
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


def decode_scaled_ref(codes: torch.Tensor, exps: torch.Tensor,
                      spec: F.FrszSpec) -> torch.Tensor:
    """The scaled decode of ``csrc/frsz2_common.cuh::decode_scaled``: the
    same values as :func:`decompress_ref`, bit for bit, computed as

        (-1)^s * csig * 2^(emax - bias - (l-2))

    for a block whose exponent lies in ``[l-1, 2*bias]``, and by the bit
    decode everywhere else (the flush zone below, Inf/NaN patterns above).
    ``csig`` converts exactly to f64; to f32 it is first cut to 24
    significant bits (round toward zero, the kernel's ``__uint2float_rz``).
    The sign is applied last by negation, so a zero field keeps its sign.

    codes: int ``batch + (nb, bs)`` holding l-bit patterns; exps: ``batch +
    (nb,)``; f32/f64 specs (the kernels' value types).  Used by the tests.
    """
    if spec.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError("the scaled decode serves f32/f64 values")
    ieee, l = spec.ieee, spec.l
    mant, bias = ieee["mant"], ieee["bias"]
    c = codes.to(torch.int64) & ((1 << l) - 1)
    e = exps.to(torch.int64)[..., None]
    sign = ((c >> (l - 1)) & 1).bool()
    csig = c & ((1 << (l - 1)) - 1)
    ok = (e >= l - 1) & (e <= 2 * bias)
    # the scale's biased exponent, clamped to a normal one outside the guard
    sbits = ((e - (l - 2)).clamp(1, 2 * bias) << mant).expand_as(c)
    if spec.dtype == torch.float64:
        x = csig.to(torch.float64)
        scale = sbits.contiguous().view(torch.float64)
    else:
        cut = (F._bit_length(csig) - (mant + 1)).clamp(min=0)
        x = ((csig >> cut) << cut).to(torch.float32)
        scale = sbits.to(torch.int32).view(torch.float32)
    v = x * scale
    v = torch.where(sign, -v, v)
    return torch.where(ok, v, F._decode_block(c, exps, spec))


def decode_fma_ref(codes: torch.Tensor, exps: torch.Tensor,
                   spec: F.FrszSpec) -> torch.Tensor:
    """The f64 one-FMA decode of ``csrc/frsz2_common.cuh::decode_fma`` (the
    matvec's and the block combine's): ``fma(2^52 + csig, s, -2^52 s)``,
    sign applied after, for a block exponent in ``[l-1, 2*bias + l - 54]``
    (where ``-2^52 s`` is finite), the bit decode elsewhere.  The same
    values as :func:`decompress_ref`, bit for bit; used by the tests."""
    if spec.dtype != torch.float64:
        raise NotImplementedError("the one-FMA decode serves f64 values")
    l, mant, bias = spec.l, spec.ieee["mant"], spec.ieee["bias"]
    c = codes.to(torch.int64) & ((1 << l) - 1)
    e = exps.to(torch.int64)[..., None]
    sign = ((c >> (l - 1)) & 1).bool()
    csig = c & ((1 << (l - 1)) - 1)
    ok = (e >= l - 1) & (e <= 2 * bias + l - 54)
    es = (e - (l - 2)).clamp(1, 2 * bias - 52).expand_as(c).contiguous()
    s = (es << mant).view(torch.float64)
    v = fma_ref(csig.to(torch.float64) + 2.0 ** 52, s,
                -((es + 52) << mant).view(torch.float64))
    v = torch.where(sign, -v, v)
    return torch.where(ok, v, F._decode_block(c, exps, spec))


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
# Block contractions over a flattened block basis (csrc/frsz2_block.cu)
# ---------------------------------------------------------------------------


#: segment rows the plain block contractions decode at once (the codec's
#: int64 temporaries of a whole full-width block basis would not fit)
_REF_ROWS = 128


def block_dots_ref(codes, exps, W, spec: F.FrszSpec) -> torch.Tensor:
    """Y[r, b] = sum_c decompress(V)[r, c] * W[b, c].

    codes: (M, nb, bs) element codes of M segment rows; exps: (M, nb);
    W: (q, nb*bs)  ->  Y: (M, q), contracted in the spec's value dtype.
    """
    Wt = W.to(spec.dtype).T
    parts = [decompress_ref(c, e, spec) @ Wt
             for c, e in zip(codes.split(_REF_ROWS), exps.split(_REF_ROWS))]
    return torch.cat(parts) if parts else Wt.new_zeros((0, W.shape[0]))


def block_combine_ref(codes, exps, Y, spec: F.FrszSpec) -> torch.Tensor:
    """out[b, c] = sum_r Y[r, b] * decompress(V)[r, c].

    codes: (M, nb, bs); exps: (M, nb); Y: (M, q)  ->  out: (q, nb*bs).
    """
    Y = Y.to(spec.dtype)
    nb, bs = codes.shape[-2:]
    out = Y.new_zeros((Y.shape[1], nb * bs))
    for r0 in range(0, codes.shape[0], _REF_ROWS):
        r1 = r0 + _REF_ROWS
        out = out + Y[r0:r1].T @ decompress_ref(codes[r0:r1], exps[r0:r1],
                                                spec)
    return out


def _two_sum(a, b):
    """(s, t) with s = a + b rounded and s + t = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, t) with p = a * b rounded and p + t = a * b exactly (Dekker, f64;
    |a|, |b| below 2^995 so that the Veltkamp split cannot overflow)."""
    def split(x):
        t = x * 134217729.0                     # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_round_odd(a, b):
    """a + b rounded to odd: exact sums as they are, inexact ones to the
    neighbour with an odd last bit (a sticky bit for a later rounding)."""
    s, t = _two_sum(a, b)
    bits = s.view(torch.int64)
    # one step from the nearest toward the exact sum: away from zero where
    # the error has the sum's sign (sign-magnitude bits)
    step = torch.where((t > 0) == (s > 0), 1, -1)
    bits = torch.where((t != 0) & (bits & 1 == 0), bits + step, bits)
    return bits.view(torch.float64)


def fma_ref(a, b, c):
    """``fma(a, b, c)``: a * b + c rounded once, as the card's DFMA/FFMA, in
    plain tensor ops (PyTorch has no fused multiply-add of its own).

    f64: a * b = p + e exactly, p + c = s1 + s2 exactly, then s1 + RO(s2 +
    e) rounded to nearest (RO: rounding to odd).  Either |s2 + e| is a few
    ulps of s1 at most, so RO keeps some 50 bits below s1's last one and
    the final rounding sees the exact sum's round and sticky bits; or p and
    c cancel (within a factor 4), p + c is exact (Sterbenz), s2 = 0 and the
    last sum adds two doubles.  f32: a * b is exact in f64; the f64 sum
    rounded to odd, then to f32, rounds once (53 >= 24 + 2 bits; Boldo and
    Melquiond).  Broadcasts like ``a * b + c``."""
    if c.dtype == torch.float32:
        p = a.to(torch.float64) * b.to(torch.float64)
        return _add_round_odd(p, c.to(torch.float64)).to(torch.float32)
    p, e = _two_prod(a, b)
    s1, s2 = _two_sum(p, c)
    return s1 + _add_round_odd(s2, e)


def block_combine_rows_ref(codes, exps, Y, spec: F.FrszSpec) -> torch.Tensor:
    """:func:`block_combine_ref` summed as the combine kernel sums: each
    output starts at +0 and takes one fma a segment row, rows in order
    (``out = fma(Y[r, b], V[r, c], out)``).  Bit for bit what the kernel
    gives; the tests and ``chip_smoke.py`` hold it to that.

    codes: (M, nb, bs); exps: (M, nb); Y: (M, q)  ->  out: (q, nb*bs).
    """
    Y = Y.to(spec.dtype)
    nb, bs = codes.shape[-2:]
    out = Y.new_zeros((Y.shape[1], nb * bs))
    for r0 in range(0, codes.shape[0], _REF_ROWS):
        V = decompress_ref(codes[r0:r0 + _REF_ROWS], exps[r0:r0 + _REF_ROWS],
                           spec)
        for i, v in enumerate(V):
            out = fma_ref(Y[r0 + i][:, None], v[None, :], out)
    return out


def rmatvec_rows_ref(codes, exps, h, spec: F.FrszSpec) -> torch.Tensor:
    """:func:`rmatvec_ref` summed as the rmatvec kernel sums: each output
    starts at +0 and takes one fma a row, rows in order (``y = fma(h[r],
    V[r], y)``), the block combine's sum at p = q = 1.  Bit for bit what
    the kernel gives; the tests and ``chip_smoke.py`` hold it to that.

    codes: (m, nb, bs); exps: (m, nb); h: (m,)  ->  y: (nb*bs,)
    """
    h = h.to(spec.dtype)
    nb, bs = codes.shape[-2:]
    y = h.new_zeros((nb * bs,))
    for r0 in range(0, codes.shape[0], _REF_ROWS):
        V = decompress_ref(codes[r0:r0 + _REF_ROWS], exps[r0:r0 + _REF_ROWS],
                           spec)
        for i, v in enumerate(V):
            y = fma_ref(h[r0 + i], v, y)
    return y


# ---------------------------------------------------------------------------
# ELL SpMV (csrc/ell_spmv.cu)
# ---------------------------------------------------------------------------


def ell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y (nr,) = ELL(vals, cols) @ x: gather, multiply, sum each row.

    vals (nr, w) f32/f64; cols (nr, w) int32 (padding slots: val 0, col 0);
    x (nc,), taken in the dtype of ``vals``.  Each row sums its w products
    in slot order, starting from 0: the order of the JAX package's gather
    sum and of the kernel, so all three give the same bits.  A block ``x
    (q, nc)`` gives ``y (q, nr)``, each column on its own, as ``jax.vmap``
    of the single-vector product.
    """
    xv = x.to(vals.dtype)
    y = torch.zeros((*x.shape[:-1], vals.shape[0]), dtype=vals.dtype,
                    device=vals.device)
    for k in range(vals.shape[1]):
        y = y + vals[:, k] * xv[..., cols[:, k]]
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
    ``cs`` (m), ``sn`` (m), ``alive`` (1), ``fired`` (m: 1 at each step
    where MGS re-orthogonalized).  The Givens step (``csrc/gmres_step.cu``)
    keeps all of it, ``fired`` at the live steps; a cycle that runs its
    dead steps too writes ``fired`` at every step (a sharded cycle), and
    the driver's one read per restart reads it all."""
    off = {"R": 0, "g": (m + 1) * m}
    off["est"] = off["g"] + m + 1
    off["extra"] = off["est"] + m
    off["cs"] = off["extra"] + 1
    off["sn"] = off["cs"] + m
    off["alive"] = off["sn"] + m
    off["fired"] = off["alive"] + 1
    off["size"] = off["fired"] + m
    return off


def givens_init_ref(m: int, device) -> torch.Tensor:
    """The state at the start of a cycle, ``g[0]`` still 0: R, g, cs, sn
    zero, est +inf, extra 0, alive 1, fired 0."""
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
    b_norm``, ``fired[j]``, add ``fired * (j+1)`` to ``extra``, and drop
    ``alive`` on a breakdown or once ``est[j]`` meets ``target``; the step
    that drops it writes its ``est`` into ``est[j+1:m]`` too, the values
    the dead steps would repeat, so that a captured cycle may skip them.
    Once dead, ``est[j]`` repeats ``est[j-1]`` and nothing else changes.
    The arithmetic is the host driver's, in Python floats, operation for
    operation.
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
    s[L["fired"] + j] = float(bool(fired))
    s[L["extra"]] += float(bool(fired)) * (j + 1)
    alive = not breakdown and resid > target
    s[L["alive"]] = float(alive)
    if not alive:
        s[L["est"] + j + 1:L["est"] + m] = resid


# ---------------------------------------------------------------------------
# One block Givens step of the block-GMRES cycle (csrc/gmres_step.cu)
# ---------------------------------------------------------------------------


def block_givens_layout(m: int, p: int) -> dict:
    """Offsets of the block cycle's f64 state vector for ``m`` block steps
    of ``p`` columns: ``R`` ((m+1)p x mp, row-major), ``G`` ((m+1)p x p),
    ``est`` (m x p), ``extra`` (1), ``cs`` (mp x p), ``sn`` (mp x p),
    ``alive`` (1), ``fired`` (m: 1 at each block step where MGS
    re-orthogonalized, live or not).  The block Givens step
    (``csrc/gmres_step.cu``) keeps everything before ``fired``; the cycle
    writes ``fired``, and the driver's one read per restart reads it all."""
    mp = m * p
    off = {"R": 0, "G": (mp + p) * mp}
    off["est"] = off["G"] + (mp + p) * p
    off["extra"] = off["est"] + mp
    off["cs"] = off["extra"] + 1
    off["sn"] = off["cs"] + mp * p
    off["alive"] = off["sn"] + mp * p
    off["fired"] = off["alive"] + 1
    off["size"] = off["fired"] + m
    return off


def block_givens_init_ref(m: int, p: int, device) -> torch.Tensor:
    """The state at the start of a cycle, ``G`` still 0: ``R``, ``G``, ``sn``
    zero, ``cs`` one (identity rotations), ``est`` +inf, ``extra`` 0,
    ``alive`` 1, ``fired`` 0."""
    L = block_givens_layout(m, p)
    s = torch.zeros(L["size"], dtype=torch.float64, device=device)
    s[L["est"]:L["extra"]] = math.inf
    s[L["cs"]:L["sn"]] = 1.0
    s[L["alive"]] = 1.0
    return s


def _rotate(u: list, v: list, c: float, s: float) -> None:
    """Rows ``u, v <- c u + s v, -s u + c v``, in place, each operation
    rounded on its own (no fused multiply-add)."""
    for t, (a, b) in enumerate(zip(u, v)):
        u[t] = c * a + s * b
        v[t] = -s * a + c * b


def block_apply_prior(slab: list, cs: list, sn: list, jp: int, p: int
                      ) -> None:
    """Apply the stored rotations of columns ``< jp`` to a column slab (a
    list of rows), in place: rotation ``[c, k]`` acts on rows ``(c,
    c+p-k)``, in k order (``repro/solver/gmres.py::_block_apply_prior``)."""
    for c in range(jp):
        for k in range(p):
            _rotate(slab[c], slab[c + p - k], cs[c][k], sn[c][k])


def block_triangularize(W: list, G2: list, p: int):
    """Annihilate the band of a step's ``2p`` window rows ``W``, in place,
    and rotate the rhs rows ``G2`` alike: rotation ``(k, k+i)``, i = p..1,
    pairs each subdiagonal entry with the pivot row (zero-safe Givens),
    then zeros below the diagonal exactly
    (``repro/solver/gmres.py::_block_triangularize``).  Returns the new
    rotations ``(cs, sn)``, ``[k][p-i]`` acting on rows ``(k, k+i)``."""
    csn = [[1.0] * p for _ in range(p)]
    snn = [[0.0] * p for _ in range(p)]
    for k in range(p):
        for i in range(p, 0, -1):
            r1 = k + i
            a, b = W[k][k], W[r1][k]
            denom = math.sqrt(a * a + b * b)
            c, sv = (a / denom, b / denom) if denom > 0 else (1.0, 0.0)
            _rotate(W[k], W[r1], c, sv)
            _rotate(G2[k], G2[r1], c, sv)
            csn[k][p - i] = c
            snn[k][p - i] = sv
        for r in range(k + 1, 2 * p):
            W[r][k] = 0.0
    return csn, snn


def block_givens_step_ref(state: torch.Tensor, H: torch.Tensor,
                          T: torch.Tensor, fired: torch.Tensor,
                          bn_safe: torch.Tensor, j: int, m: int, p: int,
                          target: float) -> None:
    """Block step ``j`` of the cycle's banded least squares, in place on
    ``state`` (layout: :func:`block_givens_layout`).

    ``H`` ((j+1)p, p) are the couplings of the new block with the live
    basis rows, ``T`` (p, p) the triangular factor of its QR, ``fired``
    whether MGS re-orthogonalized, ``bn_safe`` (p,) the columns' right-hand
    side norms.  While ``alive``: build the step's column slab (``H`` over
    ``T`` over zeros), :func:`block_apply_prior`, then
    :func:`block_triangularize` its rows ``jp..jp+2p-1`` with ``G``'s; write
    the slab into columns ``jp..jp+p-1`` of ``R``, the new rotations into
    ``cs``/``sn``, and ``est[j, b] = ||G[jp+p:jp+2p, b]|| / bn_safe[b]``
    (squares summed in row order), add ``fired * (j+1)`` to ``extra``, and
    drop ``alive`` on a total breakdown (every diagonal entry of ``T``
    zero) or once every column meets ``target``.  Once dead, ``est[j]``
    repeats ``est[max(j-1, 0)]`` and nothing else changes.  Python floats,
    operation for operation as the kernel rounds them.
    """
    L = block_givens_layout(m, p)
    mp = m * p
    s = state
    e0 = L["est"]
    if not float(s[L["alive"]]):
        jj = max(j - 1, 0)
        s[e0 + j * p:e0 + (j + 1) * p] = s[e0 + jj * p:e0 + (jj + 1) * p]
        return
    jp = j * p
    slab = H.double().reshape(-1, p).tolist() + T.double().tolist()
    cs = s[L["cs"]:L["cs"] + jp * p].view(-1, p).tolist() if jp else []
    sn = s[L["sn"]:L["sn"] + jp * p].view(-1, p).tolist() if jp else []
    block_apply_prior(slab, cs, sn, jp, p)
    Gv = s[L["G"]:L["est"]].view(mp + p, p)
    G2 = Gv[jp:jp + 2 * p].tolist()
    csn, snn = block_triangularize(slab[jp:jp + 2 * p], G2, p)
    R = s[:L["G"]].view(mp + p, mp)
    R[:(j + 2) * p, jp:jp + p] = torch.tensor(slab, dtype=torch.float64)
    Gv[jp:jp + 2 * p] = torch.tensor(G2, dtype=torch.float64)
    s[L["cs"] + jp * p:L["cs"] + (jp + p) * p] = torch.tensor(
        csn, dtype=torch.float64).ravel()
    s[L["sn"] + jp * p:L["sn"] + (jp + p) * p] = torch.tensor(
        snn, dtype=torch.float64).ravel()
    bn = bn_safe.double().tolist()
    est = []
    for b in range(p):
        acc = 0.0
        for r in range(p, 2 * p):
            acc = acc + G2[r][b] * G2[r][b]
        est.append(math.sqrt(acc) / bn[b])
    s[e0 + j * p:e0 + (j + 1) * p] = torch.tensor(est, dtype=torch.float64)
    s[L["extra"]] += float(bool(fired)) * (j + 1)
    dead = all(abs(v) <= _TINY for v in T.double().diagonal().tolist())
    s[L["alive"]] = float(not dead and any(e > target for e in est))


# ---------------------------------------------------------------------------
# Flash-decode attention over an FRSZ2-coded KV cache (csrc/decode_attn.cu)
# ---------------------------------------------------------------------------


def decode_attn_ref(q, kcodes, kexps, vcodes, vexps, lengths,
                    spec: F.FrszSpec, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """Single-token decode attention, GQA, over a coded K/V cache.

    q: (B, H, D) new-token queries; kcodes/vcodes: (B, Hkv, S, D) codes,
    coded along D in blocks of ``spec.bs``; kexps/vexps: (B, Hkv, S, nb);
    lengths: (B,) valid cache length per sequence.  Returns (B, H, D) in
    q's dtype, computed in f32: ``softmax(q k^T * sm_scale) v`` over the
    first ``lengths[b]`` positions.  A row with no valid position gives
    zeros (its softmax sum is divided by 1, as the kernel does).  Decoded
    one sequence at a time, so the codec's int64 temporaries stay small.
    """
    B, H, D = q.shape
    Hkv, S = kcodes.shape[1], kcodes.shape[2]
    G = H // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = []
    for b in range(B):
        k = decompress_ref(kcodes[b].reshape(Hkv, S, -1, spec.bs), kexps[b],
                           spec)[..., :D].float()          # (Hkv, S, D)
        v = decompress_ref(vcodes[b].reshape(Hkv, S, -1, spec.bs), vexps[b],
                           spec)[..., :D].float()
        qg = q[b].reshape(Hkv, G, D).float()
        s = torch.einsum("hgd,hsd->hgs", qg, k) * sm_scale
        valid = torch.arange(S, device=q.device) < lengths[b]
        s = torch.where(valid, s, -math.inf)
        m = s.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - torch.where(
            torch.isfinite(m), m, 0.0)), 0.0)
        den = p.sum(-1, keepdim=True)
        o = torch.einsum("hgs,hsd->hgd", p, v)
        out.append(o / torch.where(den > 0, den, 1.0))
    if not out:
        return q.new_zeros((0, H, D))
    return torch.stack(out).reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# The KV-cache write (csrc/frsz2_codec.cu, frsz2_cache_write)
# ---------------------------------------------------------------------------


def cache_write_slots(B: int, T: int, S: int, lengths, ring: int, device):
    """``(pos (B, T) int64, keep (B, T) bool)``: the cache position of row
    ``(b, t)`` of a write, ``lengths[b] + t`` (0 + t for ``lengths=None``),
    taken modulo ``ring`` when ``ring > 0``, and whether it is written.  A
    position outside ``[0, S)`` is dropped, as the JAX package's scatter
    drops it; with a ring, so is a row that a later row of the same write
    overwrites (``t < T - ring``), which leaves the last ``ring`` positions
    at their modular slots, as the prefill's roll does."""
    t = torch.arange(T, device=device)
    start = (torch.zeros((B, 1), dtype=torch.int64, device=device)
             if lengths is None else lengths.reshape(B, 1).to(torch.int64))
    pos = start + t
    keep = torch.ones((B, T), dtype=torch.bool, device=device)
    if ring:
        keep &= t >= T - ring
        pos = pos % ring
    return pos, keep & (pos >= 0) & (pos < S)


def cache_write_ref(k: torch.Tensor, v: torch.Tensor, lengths, k_codes,
                    k_exps, v_codes, v_exps, spec: F.FrszSpec, ring: int = 0,
                    clear_from: int | None = None) -> None:
    """What ``frsz2_cache_write`` computes: K/V ``(B, T, Hkv, D)`` cast to
    the spec's value type (f32), coded in blocks of ``bs = D``, and written
    in place into codes ``(B, Hkv, S, D)`` and exponents ``(B, Hkv, S, 1)``
    at the slots of :func:`cache_write_slots`; positions ``[clear_from,
    S)`` of both caches are zeroed (the prefill's padding)."""
    B, T, Hkv, D = k.shape
    S = k_codes.shape[2]
    if clear_from is not None:
        for t in (k_codes, k_exps, v_codes, v_exps):
            t[:, :, clear_from:] = 0
    pos, keep = cache_write_slots(B, T, S, lengths, ring, k.device)
    bi, ti = keep.nonzero(as_tuple=True)
    pi = pos[bi, ti]
    for x, codes, exps in ((k, k_codes, k_exps), (v, v_codes, v_exps)):
        bc = F.compress(x[bi, ti].to(spec.dtype), spec)     # (N, Hkv, 1, D)
        codes[bi, :, pi] = bc.codes.reshape(-1, Hkv, D).to(codes.dtype)
        exps[bi, :, pi] = bc.exps.reshape(-1, Hkv, 1).to(exps.dtype)
