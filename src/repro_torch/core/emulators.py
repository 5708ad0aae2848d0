"""Error-characteristic emulators for SZ / SZ3 / ZFP (paper Sec. V-D).

The port of ``repro/core/emulators.py``.  The paper studies how *other*
lossy compressors affect CB-GMRES convergence by compressing and at once
decompressing the Krylov vectors; the emulators reproduce those
compressors' **error characteristics**, which is all the convergence study
needs, since the data never stays compressed:

* ``emul:sz_abs(eb)``    — absolute error bound: uniform scalar
  quantization with step 2·eb.
* ``emul:sz_pwrel(eb)``  — pointwise relative bound: logarithmic
  quantization (log|x| quantized with step log(1+eb)).
* ``emul:zfp_fr(rate)``  — ZFP fixed-rate: 1-D blocks of 4, ZFP's forward
  lifting transform, a block-common exponent, truncation to ``rate - 3``
  fraction bits.

Each emulator is a :class:`~repro_torch.core.accessor.StorageFormat`: the
store is the roundtripped f64 basis ``(m, n)`` on the accessor's device
(the footprint is *accounted* by ``nbytes``, not realized, as in the
paper's LibPressio methodology), and ``write_row`` writes it in place.  A
roundtrip is tensor operations only, with no host read and no Python
branch on a value, so the device driver's CUDA graph captures it.

The roundtrips give the JAX package's bits on the CPU, and the same bits on
the card (``emul:sz_pwrel`` aside, whose ``log``/``exp`` are the device's):

* ``sz_abs`` is IEEE division, rounding and multiplication; the division
  is by a tensor, since CUDA divides by a Python scalar through its
  reciprocal.
* ``zfp_fr`` scales each block by ``exp2(-ceil(log2(max)))``, which the
  reference's CPU backend evaluates as ``exp(c · ln 2)`` and ``log(x) ·
  (1 / ln 2)``: neither is exact (``exp2(-3)`` is not 1/8, and at some
  powers of two ``ceil`` lands one above the exponent).  Both are reduced
  here to tables built once on the host with PyTorch's CPU ``log`` and
  ``exp``, which agree with the reference's for block maxima in
  ``[2^-200, 2^200]``: ``exp(c · ln 2)`` per integer ``c``, and per
  power of two the least ``x`` whose ``log(x) · (1 / ln 2)`` exceeds it.
  On the device the block exponent then comes from ``frexp`` and two
  comparisons, so the card computes the CPU's bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.accessor import StorageFormat

__all__ = ["AbsQuantFormat", "PwRelQuantFormat", "ZfpFixedRateFormat",
           "emulator_by_name"]


@dataclasses.dataclass(frozen=True)
class _RoundtripFormat(StorageFormat):
    """Base: stores ``roundtrip(x)`` at f64 (LibPressio style); ``dots`` and
    ``combine`` come from the protocol's ``read_all`` defaults."""

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def empty(self, m: int, n: int, device):
        return torch.zeros((m, n), dtype=torch.float64, device=device)

    def rows(self, store) -> int:
        return store.shape[0]

    def take(self, store, rows: int):
        return store[:rows]

    def write_row(self, store, j: int, v) -> None:
        store[j].copy_(self.roundtrip(v.to(torch.float64)))

    def read_row(self, store, j: int, arith_dtype, n: int):
        return store[j].to(arith_dtype)

    def read_all(self, store, arith_dtype, n: int):
        return store.to(arith_dtype)

    def nbytes(self, m: int, n: int) -> int:
        return int(m * n * self.bits_per_value() / 8)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f64 tensor on ``like``'s device (a fill kernel on
    the card, so a CUDA graph can hold it): dividing by it is IEEE
    division on every device."""
    return torch.full((), value, dtype=torch.float64, device=like.device)


@dataclasses.dataclass(frozen=True)
class AbsQuantFormat(_RoundtripFormat):
    """|x - x̃| <= eb via midtread uniform quantization, step 2·eb."""

    eb: float = 1e-7

    @property
    def name(self):
        return f"emul:sz_abs_{self.eb:g}"

    def roundtrip(self, x):
        step = 2.0 * self.eb
        return torch.round(x / _scalar(step, x)) * step

    def bits_per_value(self) -> float:
        # entropy-less accounting: log2(range/step) bits + overhead for
        # normalized Krylov data (range ~2)
        return float(np.log2(1.0 / self.eb)) + 2.0


@dataclasses.dataclass(frozen=True)
class PwRelQuantFormat(_RoundtripFormat):
    """x̃ ∈ x·[1-eb, 1+eb] via log-domain quantization."""

    eb: float = 1e-4

    @property
    def name(self):
        return f"emul:sz_pwrel_{self.eb:g}"

    def roundtrip(self, x):
        step = math.log1p(self.eb)
        mag = torch.abs(x)
        safe = torch.clamp(mag, min=1e-300)
        q = torch.exp(torch.round(torch.log(safe) / _scalar(step, x)) * step)
        return torch.where(mag > 0, torch.sign(x) * q,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def bits_per_value(self) -> float:
        # log-range of normalized Krylov data ~ [1e-16, 1]
        return float(np.log2(np.log(1e16) / np.log1p(self.eb))) + 2.0


def _zfp_fwd_lift(v):
    """ZFP's 1-D forward decorrelating transform on a length-4 block."""
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + w; x = x * 0.5; w = w - x  # noqa: E702
    z = z + y; z = z * 0.5; y = y - z  # noqa: E702
    x = x + z; x = x * 0.5; z = z - x  # noqa: E702
    w = w + y; w = w * 0.5; y = y - w  # noqa: E702
    w = w + y * 0.5; y = y - w * 0.5   # noqa: E702
    return torch.stack([x, y, z, w], dim=-1)


def _zfp_inv_lift(v):
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    y = y + w * 0.5; w = w - y * 0.5   # noqa: E702
    y = y + w; w = w * 2.0; w = w - y  # noqa: E702
    z = z + x; x = x * 2.0; x = x - z  # noqa: E702
    y = y + z; z = z * 2.0; z = z - y  # noqa: E702
    w = w + x; x = x * 2.0; x = x - w  # noqa: E702
    return torch.stack([x, y, z, w], dim=-1)


# -- the reference backend's exp2 / ceil(log2), as tables --------------------

_LN2 = math.log(2.0)
_INV_LN2 = 1.0 / _LN2
#: integer exponents covered: every finite double's and a little beyond
_EMAX = 1100
#: half-width, in ulps, of the search for each power of two's threshold:
#: ``log(x) / ln 2`` is off by at most a few ulps of ~745 · 1.44, which is
#: a few hundred ulps of x
_WINDOW = 1 << 13
_TABLES: dict = {}


def _exp2_ref(c: torch.Tensor) -> torch.Tensor:
    """The reference backend's ``exp2`` on the CPU: ``exp(c · ln 2)``."""
    return torch.exp(c * _LN2)


def _log2_ref(x: torch.Tensor) -> torch.Tensor:
    """The reference backend's ``log2`` on the CPU: ``log(x) · (1/ln 2)``."""
    return torch.log(x) * _INV_LN2


def _log2_thresholds(log2=_log2_ref, kmin: int = -_EMAX,
                     kmax: int = _EMAX) -> torch.Tensor:
    """``lo[k - kmin]``: the least double ``x > 0`` with ``log2(x) > k``,
    for ``k`` in ``[kmin, kmax]`` (``inf`` where none is finite).

    A binary search over the doubles within ``_WINDOW`` ulps of ``2^k``,
    for all ``k`` at once, on their bit patterns; ``log2`` (a function of
    a float64 tensor) is monotone, which is checked on 64 doubles either
    side of every threshold found."""
    ks = torch.arange(kmin, kmax + 1, dtype=torch.int64)
    inf_bits = 0x7FF << 52
    # the bits of 2^k: normal, subnormal, past the largest double, below 0
    base = torch.where(
        ks >= -1022, (ks + 1023).clamp(max=2047) << 52,
        torch.where(ks >= -1074, 1 << (ks + 1074).clamp(0, 51),
                    torch.zeros_like(ks)))

    def above(bits, k):
        # "x > 0 and log2(x) > k"; patterns past +inf read as +inf
        x = bits.clamp(1, inf_bits).view(torch.float64)
        return (log2(x) > k.to(torch.float64)) & (bits > 0)

    lo = base - _WINDOW
    hi = (base + _WINDOW).clamp(max=inf_bits)
    if bool(above(lo, ks).any()) or not bool(above(hi, ks).all()):
        raise AssertionError("emulators: a log2 threshold is outside its "
                             "search window")
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        up = above(mid, ks)
        hi = torch.where(up, mid, hi)
        lo = torch.where(up, lo, mid)
    d = torch.arange(-64, 64, dtype=torch.int64)
    near = hi[:, None] + d
    got = above(near, ks[:, None])
    if not bool(((got == (d >= 0)) | (near <= 0) | (near >= inf_bits)).all()):
        raise AssertionError("emulators: log2 is not monotone near a "
                             "threshold")
    return hi.view(torch.float64)


def _tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(exp2, lo)`` on ``device``: ``exp2[c + _EMAX] = _exp2_ref(c)``
    as the reference computes ``exp2(c)``, and the ``log2`` thresholds.
    Built once on the CPU, then copied to each device on first use.

    XLA's CPU ``exp`` is its own approximation: it agrees with
    ``torch.exp`` on some x86 hosts, and on others it differs by an ulp
    (14 of the 401 integers in [-200, 200] on an AVX-512 host).  A caller
    that knows the reference's values (a test that can run it) puts its
    own tables under ``_TABLES["cpu"]`` before the first use."""
    device = torch.device(device)
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        cpu = _TABLES.get("cpu")
        if cpu is None:
            c = torch.arange(-_EMAX, _EMAX + 1, dtype=torch.float64)
            cpu = _TABLES["cpu"] = (_exp2_ref(c), _log2_thresholds())
        t = _TABLES[key] = tuple(a.to(device) for a in cpu)
    return t


def _ceil_log2(safe: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``ceil(_log2_ref(safe))`` for positive ``safe`` from the thresholds:
    ``safe`` in ``[2^k, 2^(k+1))`` gives ``k``, plus one past each of the
    thresholds of ``k`` and ``k + 1`` (int64)."""
    _, e = torch.frexp(safe)
    k = e.to(torch.int64) - 1
    i = (k + _EMAX).clamp(0, 2 * _EMAX - 1)
    return (k + (safe >= lo[i]).to(torch.int64)
            + (safe >= lo[i + 1]).to(torch.int64))


@dataclasses.dataclass(frozen=True)
class ZfpFixedRateFormat(_RoundtripFormat):
    """Simplified zfp fixed-rate: lift -> block exponent -> truncate planes."""

    rate: int = 32  # bits per value

    @property
    def name(self):
        return f"emul:zfp_fr_{self.rate}"

    def roundtrip(self, x):
        n = x.shape[-1]
        pad = (-n) % 4
        xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
        blocks = xp.reshape(*xp.shape[:-1], -1, 4)
        t = _zfp_fwd_lift(blocks)
        emax = torch.amax(torch.abs(t), dim=-1, keepdim=True)
        one = torch.ones((), dtype=t.dtype, device=t.device)
        safe = torch.where(emax > 0, emax, one)
        frac_bits = 4 * self.rate // 4 - 3  # budget/value minus header share
        exp2, lo = _tables(t.device)
        c = _ceil_log2(safe, lo)
        scale = exp2[(_EMAX - c).clamp(0, 2 * _EMAX)] * (2.0 ** frac_bits)
        # log2(inf) = inf, exp2(-inf) = 0: a block holding inf scales by 0
        scale = torch.where(torch.isinf(safe), torch.zeros_like(scale), scale)
        q = torch.trunc(t * scale) / scale
        q = torch.where(emax > 0, q, torch.zeros((), dtype=q.dtype,
                                                 device=q.device))
        y = _zfp_inv_lift(q).reshape(*xp.shape)
        return y[..., :n] if pad else y

    def bits_per_value(self) -> float:
        return float(self.rate)


def emulator_by_name(name: str):
    """'sz_abs:1e-7' | 'sz_pwrel:1e-4' | 'zfp_fr:16' -> format object."""
    kind, _, arg = name.partition(":")
    if kind == "sz_abs":
        return AbsQuantFormat(eb=float(arg))
    if kind == "sz_pwrel":
        return PwRelQuantFormat(eb=float(arg))
    if kind == "zfp_fr":
        return ZfpFixedRateFormat(rate=int(arg))
    raise ValueError(f"unknown emulator {name!r}")
