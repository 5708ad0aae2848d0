"""The installed JAX's host-dependent primitives, probed where the tests
run, for the port to be held to bit for bit.

XLA's CPU backend computes some primitives differently from one x86 host
to the next (it uses the host's instructions when it may):
* ``jnp.exp2`` is XLA's own ``exp(c · ln 2)``, which differs from
  ``torch.exp`` by an ulp on some hosts (14 of the integers in
  [-200, 200] on an AVX-512 host) and not on others;
* ``jnp.log2`` is ``log(x) · (1/ln 2)`` with XLA's ``log``: the same
  caveat, for the thresholds of ``ceil(log2(x))`` near powers of two;
* f64 -> f16 rounds once on a host with AVX-512 FP16 conversions and
  through f32 (twice) elsewhere.

The port cannot import JAX, so these helpers learn the primitives from
the installed JAX and hand them to the port through its seams:
``emulators._TABLES["cpu"]`` and ``accessor.f64_to_f16`` (with
:func:`f64_to_f16_once` where XLA rounds once).  The port's
algorithms (the ZFP emulator's block scaling, the float16 basis store, a
solve through either) are then compared with the reference's bit for bit,
whatever the host.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import accessor as TA
from repro_torch.core import emulators as TE

jax.config.update("jax_enable_x64", True)

#: the lowest power of two whose threshold is probed: below 2^-1022 the
#: search window holds subnormals, which XLA's CPU ``log2`` flushes to
#: -inf; the port's own thresholds stand there
LOG2_KMIN = -1022


def _jax_log2(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.log2(jnp.asarray(x.numpy()))))


@functools.lru_cache(maxsize=None)
def zfp_tables() -> tuple[torch.Tensor, torch.Tensor]:
    """``(exp2, lo)`` laid out as ``emulators._tables`` lays them out, from
    ``jnp.exp2`` on every integer of the table and the thresholds of
    ``jnp.log2`` (the port's binary search, run on the reference's
    ``log2``)."""
    c = np.arange(-TE._EMAX, TE._EMAX + 1, dtype=np.float64)
    exp2 = torch.from_numpy(np.array(jnp.exp2(jnp.asarray(c))))
    lo = TE._log2_thresholds().clone()
    lo[LOG2_KMIN + TE._EMAX:] = TE._log2_thresholds(_jax_log2, LOG2_KMIN,
                                                    TE._EMAX)
    return exp2, lo


def install_zfp_tables(monkeypatch) -> tuple[torch.Tensor, torch.Tensor]:
    """Put :func:`zfp_tables` where the port's ZFP emulator reads its
    tables, for one test (``monkeypatch`` restores the port's own)."""
    t = zfp_tables()
    monkeypatch.setattr(TE, "_TABLES", {"cpu": t})
    return t


def f16_probe() -> np.ndarray:
    """100,000 seeded normals and the f16 ties of [1, 2) with a tail of
    2^-40 either way: 102,046 values, of which 1,028 round differently
    once than through f32, so the probe tells the two roundings apart."""
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    return np.concatenate([np.random.default_rng(0).standard_normal(100_000),
                           ties + 2.0 ** -40, ties - 2.0 ** -40])


def f64_to_f16_once(v: torch.Tensor) -> torch.Tensor:
    """f64 -> f16 rounded once to nearest even, as numpy rounds, and as the
    JAX reference does on a host whose XLA converts directly (x86 with
    AVX-512 FP16 instructions).

    Rounding to f32 *to odd* first keeps a sticky bit that the second
    rounding reads, and f32's 24 bits are more than f16's 11 + 2, so the
    two roundings give the single one (Boldo and Melquiond's
    round-to-odd).  Tensor ops only, as ``accessor.f64_to_f16``.
    """
    x32 = v.to(torch.float32)                   # to nearest
    back = x32.to(torch.float64)
    # the truncation of v: one step toward zero where nearest rounded away
    # (sign-magnitude bits: minus one moves toward zero for either sign);
    # inexact: set the last bit, the odd neighbour of the interval
    away = (back.abs() > v.abs()).to(torch.int32)
    bits = (x32.view(torch.int32) - away) | (back != v)
    return bits.view(torch.float32).to(torch.float16)


#: the two f64 -> f16 roundings: the port's own, and the single one
F16_ROUNDINGS = {"through_f32": TA.f64_to_f16, "once": f64_to_f16_once}


@functools.lru_cache(maxsize=None)
def jax_f16_rounding() -> str:
    """The name of the port's rounding in :data:`F16_ROUNDINGS` that gives
    ``jnp.asarray(x).astype(jnp.float16)`` bit for bit on :func:`f16_probe`;
    raises if neither does."""
    x = f16_probe()
    want = np.asarray(jnp.asarray(x).astype(jnp.float16)).view(np.int16)
    for name, f in F16_ROUNDINGS.items():
        if np.array_equal(f(torch.from_numpy(x)).numpy().view(np.int16),
                          want):
            return name
    raise AssertionError("the installed JAX's f64 -> f16 rounding is "
                         "neither of the port's")


def install_f16_rounding(monkeypatch):
    """Store float16 basis rows with the installed JAX's rounding, for one
    test."""
    f = F16_ROUNDINGS[jax_f16_rounding()]
    monkeypatch.setattr(TA, "f64_to_f16", f)
    return f
