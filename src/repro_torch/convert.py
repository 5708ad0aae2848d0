"""Carry state across: the JAX package's arrays (as numpy) <-> the port's.

The two packages hand operators and basis stores to each other through
numpy.  Bit patterns are kept: the port holds unsigned codes in signed
containers of the same width (``uint32`` codes become an ``int32`` view,
``uint16`` an ``int16`` view; ``uint8`` stays), and the inverse views them
back.  A store is given with its format: an FRSZ2 spec (or
``FrszFormat``) for ``{"codes", "exps"}``, a ``NativeFormat`` for a plain
array, a ``MixedFormat`` for ``{"head", "tail"}``.  A block-GMRES store is
one of these over flat rows of ``p * n_seg`` values, so it carries across
the same way.

Model weights and KV caches are nested dicts of arrays.  bf16 arrays from
JAX are numpy arrays of the ``bfloat16`` extension type; they are carried
through their ``uint16`` bit patterns (an ``int16`` tensor viewed as
``torch.bfloat16``), and come back as ``uint16`` bit patterns, which
``arr.view(jnp.bfloat16)`` turns into JAX's type.  KV codes keep their bit
patterns as the basis codes do.

An AdamW state (``{"m", "v", "step"}``) carries across with its moments
plain (f32 arrays) or FRSZ2-coded: a coded leaf of the JAX package is a
``BlockCompressed`` of numpy arrays (``jax.tree.map(np.asarray, state)``),
read by its fields, never by its type, and rebuilt as the port's
``BlockCompressed`` with the same codes and exponents.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frsz2 as F
from repro_torch.core.accessor import FrszFormat, MixedFormat, NativeFormat
from repro_torch.device import resolve_device
from repro_torch.sparse.csr import CSR
from repro_torch.tree import tree_map

__all__ = ["csr_from_numpy", "csr_to_numpy", "store_from_numpy",
           "store_to_numpy", "params_from_numpy", "params_to_numpy",
           "kv_cache_from_numpy", "kv_cache_to_numpy", "opt_state_from_numpy",
           "opt_state_to_numpy"]

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}
_UNSIGNED = {torch.int16: np.uint16, torch.int32: np.uint32,
             torch.int64: np.uint64}


def csr_from_numpy(indptr, indices, data, shape, device="cuda") -> CSR:
    dev = resolve_device(device)
    return CSR(indptr=torch.tensor(np.asarray(indptr, np.int32), device=dev),
               indices=torch.tensor(np.asarray(indices, np.int32), device=dev),
               data=torch.tensor(np.asarray(data), device=dev),
               shape=tuple(int(s) for s in shape))


def csr_to_numpy(A: CSR):
    """-> (indptr, indices, data, shape) as numpy arrays."""
    return (A.indptr.cpu().numpy(), A.indices.cpu().numpy(),
            A.data.cpu().numpy(), tuple(A.shape))


def _codes_to_torch(codes: np.ndarray, device) -> torch.Tensor:
    codes = np.ascontiguousarray(codes)
    signed = _SIGNED.get(codes.dtype)
    return torch.tensor(codes if signed is None else codes.view(signed),
                        device=device)


def store_from_numpy(store, fmt, device="cuda"):
    """A JAX package store (numpy arrays) -> the port's store, same bits.
    ``fmt``: a :class:`~repro_torch.core.frsz2.FrszSpec` or a storage
    format (native, FRSZ2 or mixed)."""
    dev = resolve_device(device)
    if isinstance(fmt, MixedFormat):
        return {"head": store_from_numpy(store["head"], fmt.head, dev),
                "tail": store_from_numpy(store["tail"], fmt.tail, dev)}
    if isinstance(fmt, NativeFormat):
        return torch.tensor(np.asarray(store), dtype=fmt.dtype, device=dev)
    spec = fmt.spec if isinstance(fmt, FrszFormat) else fmt
    codes = _codes_to_torch(store["codes"], dev)
    want = F.code_dtype(spec.l) if spec.aligned else torch.int32
    if codes.dtype != want:
        raise ValueError(f"codes of {spec.name} must hold {want} patterns, "
                         f"got {store['codes'].dtype}")
    exps = torch.tensor(np.asarray(store["exps"], np.int32), device=dev)
    return {"codes": codes, "exps": exps}


def store_to_numpy(store, fmt):
    """The port's store -> the JAX package's layout: numpy arrays, unsigned
    code arrays as the JAX package holds them.  ``fmt`` as for
    :func:`store_from_numpy`."""
    if isinstance(fmt, MixedFormat):
        return {"head": store_to_numpy(store["head"], fmt.head),
                "tail": store_to_numpy(store["tail"], fmt.tail)}
    if isinstance(fmt, NativeFormat):
        return store.cpu().numpy()
    codes = store["codes"].cpu().numpy()
    unsigned = _UNSIGNED.get(store["codes"].dtype)
    if unsigned is not None:
        codes = codes.view(unsigned)
    return {"codes": codes, "exps": store["exps"].cpu().numpy()}


def _array_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)                 # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    signed = _SIGNED.get(a.dtype)
    return torch.from_numpy(a if signed is None else a.view(signed)).to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    unsigned = _UNSIGNED.get(t.dtype)
    return a if unsigned is None else a.view(unsigned)


def params_from_numpy(params, device="cuda"):
    """A nested dict of numpy arrays (e.g. the JAX package's weights) ->
    the same dict of tensors, same bits (bf16 included)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _array_to_torch(a, dev), params)


def params_to_numpy(params):
    """Inverse of :func:`params_from_numpy`; bf16 as uint16 patterns."""
    return tree_map(_tensor_to_numpy, params)


#: a decode cache (``{"lengths", "self": {...}}``) carries across as the
#: weights do; its codes keep the JAX package's bit patterns (uint16 there
#: for l = 16, int16 here)
kv_cache_from_numpy = params_from_numpy
kv_cache_to_numpy = params_to_numpy


def _spec_from(spec) -> F.FrszSpec:
    """The port's spec of a JAX package ``FrszSpec`` (read by its fields)."""
    dt = getattr(torch, np.dtype(spec.dtype).name)
    ed = getattr(spec, "exp_dtype", np.int32)
    return F.FrszSpec(bs=spec.bs, l=spec.l, dtype=dt, rounding=spec.rounding,
                      exp_dtype=getattr(torch, np.dtype(ed).name))


def _is_coded(x) -> bool:
    return all(hasattr(x, a) for a in ("codes", "exps", "n", "spec"))


def opt_state_from_numpy(state, device="cuda"):
    """A JAX package AdamW state, its arrays as numpy -> the port's, same
    bits: plain moments as tensors on ``device``, coded ones as
    ``BlockCompressed``, the step count on the CPU."""
    dev = resolve_device(device)

    def leaf(x):
        if _is_coded(x):
            return F.BlockCompressed(codes=_codes_to_torch(x.codes, dev),
                                     exps=_array_to_torch(x.exps, dev),
                                     n=int(x.n), spec=_spec_from(x.spec))
        return _array_to_torch(x, dev)

    # the step count stays on the host (``optim.adamw``)
    return {"m": tree_map(leaf, state["m"]), "v": tree_map(leaf, state["v"]),
            "step": _array_to_torch(state["step"], "cpu")}


def opt_state_to_numpy(state, like):
    """The port's AdamW state -> the JAX package's, its arrays as numpy.
    ``like`` is a JAX package state of the same tree: a coded leaf becomes
    an instance of its coded leaf's own type, with unsigned codes as the
    JAX package holds them and its ``n`` and spec."""
    def walk(x, ref):
        if isinstance(x, dict):
            return {k: walk(v, ref[k]) for k, v in x.items()}
        if not isinstance(x, F.BlockCompressed):
            return _tensor_to_numpy(x)
        return type(ref)(codes=_tensor_to_numpy(x.codes),
                         exps=x.exps.cpu().numpy(), n=ref.n, spec=ref.spec)

    return {"m": walk(state["m"], like["m"]), "v": walk(state["v"], like["v"]),
            "step": state["step"].cpu().numpy()}
