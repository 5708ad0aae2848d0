"""Scoped activation-sharding constraints over *logical* axis names.

Model code annotates activations with logical names:

    q = constrain(q, "batch", None, "heads", None)

Outside a policy scope this is the identity (the model runs on one device,
on the CPU or on the card, with plain tensors), and so it is for a tensor
that is no ``DTensor``.  Inside ``use(mesh, rules)`` -- entered by the cell
builders of ``repro_torch.launch.specs`` -- each logical name is resolved
through ``rules`` (a dict ``logical-name -> mesh dim name | tuple of names |
None``) to one placement a mesh dim (``Shard(i)`` on every mesh dim that
dim ``i``'s name resolves to, ``Replicate()`` elsewhere), and the DTensor is
``redistribute``d to it.  Unknown names resolve to None (replicated), so
model code never has to know which axes a mesh has.  A pending reduction
(``Partial``) is reduced by the redistribution, which is where its
collective shows.

:func:`placements` and :func:`local_region` serve the regions of the model
that DTensor has no sharding rule for (the KV cache's write and its decode
attention, the MoE dispatch, the SSM scans): each runs on every rank's
local shard through ``torch.distributed.tensor.experimental.local_map``,
its inputs redistributed to declared placements first.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

__all__ = ["constrain", "use", "current_policy", "placements",
           "local_region", "sharded", "full", "zeros"]

_state = threading.local()


def current_policy():
    """(mesh, rules) of the innermost active scope, or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use(mesh, rules: dict):
    """Activate an activation-sharding policy for the enclosed step."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append((mesh, dict(rules)))
    try:
        yield
    finally:
        stack.pop()


def placements(mesh, rules: dict, names) -> tuple:
    """Logical names, one a tensor dim, -> one placement a mesh dim."""
    from repro_torch.dist.sharding import spec_placements

    return spec_placements(tuple(rules.get(n) if n is not None else None
                                 for n in names), mesh.mesh_dim_names)


def sharded(shape, mesh, pl, make):
    """A DTensor of global ``shape`` laid out by placements ``pl``, its
    local shard ``make(rank 0's shard shape)`` (``torch.chunk``'s split:
    the first chunk the largest)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    local = list(shape)
    for size, p in zip(mesh.shape, pl):
        if p.is_shard():
            local[p.dim] = -(-local[p.dim] // size)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(make(tuple(local)), mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def full(shape, value, names, *, dtype, device=None):
    """``torch.full``; under a policy a DTensor of that global shape laid
    out by ``names`` (a name whose mesh dims do not divide its dim is
    replicated), each rank's shard allocated."""
    pol = current_policy()
    if pol is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    mesh, rules = pol
    pl = placements(mesh, _dividing(mesh, rules, (shape,), (names,)), names)
    return sharded(shape, mesh, pl, lambda s: torch.full(
        s, value, dtype=dtype, device=device))


def zeros(shape, names, *, dtype, device=None):
    """``torch.zeros``, laid out as :func:`full` lays it out."""
    return full(shape, 0, names, dtype=dtype, device=device)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, *names):
    """Constrain ``x``'s sharding by logical axis names (one per dim).

    The identity without an active :func:`use` scope or for a plain tensor.
    ``names`` may be shorter than ``x.ndim`` (trailing dims replicated).  A
    name whose mesh dims do not divide its dim is replicated (DTensor's
    uneven shards break the views of a decode step's one MoE group).
    """
    pol = current_policy()
    if pol is None or not _is_dtensor(x):
        return x
    mesh, rules = pol
    names = tuple(names[: x.ndim]) + (None,) * (x.ndim - len(names))
    want = placements(mesh, _dividing(mesh, rules, (x.shape,), (names,)),
                      names)
    if tuple(x.placements) == want:
        return x
    if any(_is_masked_partial(p) for p in x.placements):
        return _ReduceMasked.apply(x, mesh, want)
    return x.redistribute(mesh, want)


def _is_masked_partial(p) -> bool:
    from torch.distributed.tensor.placement_types import _MaskPartial

    return isinstance(p, _MaskPartial)


class _ReduceMasked(torch.autograd.Function):
    """The redistribution of a masked partial (the result of a lookup in a
    vocab-sharded table), its gradient handed back as it comes: DTensor's
    own redistribution would turn that gradient into a masked partial
    again, which it cannot do from a pending sum."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


#: objects told of each kernel region's local call under a policy
#: (``enter_kernel()``, then ``exit_kernel(name, args, out)``): the dry
#: run's op counter, which counts a kernel's reads and writes instead of its
#: plain version's ops
KERNEL_LISTENERS: list = []


def _kernel_call(name: str, fn, args):
    for lis in KERNEL_LISTENERS:
        lis.enter_kernel()
    out = None
    try:
        out = fn(*args)
        return out
    finally:
        for lis in KERNEL_LISTENERS:
            lis.exit_kernel(name, args, out)


def local_region(fn, out_names, in_names, *, kernel: str | None = None):
    """``fn`` run on each rank's local shards under the active policy.

    ``fn`` takes tensors (or None) positionally.  ``in_names``: one tuple of
    logical names an argument (None for an argument that is None);
    ``out_names``: one tuple of names for a single tensor result, a list of
    such tuples for a tuple of results, or ``[]`` for a function that
    returns None (an in-place write, whose targets must already lie as
    declared: a redistributed copy would take the write).  A name whose
    mesh dims do not divide an argument's dim it names is replicated in
    the whole region (a decode step's one MoE group): the outputs' shards
    must be even.  Without a policy, or when no argument is a DTensor,
    ``fn`` itself runs.  A tensor argument that is no DTensor is taken as
    replicated.  ``kernel`` names a region that a Hopper kernel computes on
    the card: under a policy :data:`KERNEL_LISTENERS` hear of its calls.
    """

    def run(*args):
        pol = current_policy()
        if pol is None or not any(_is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import local_map

        mesh, rules = pol
        rules = _dividing(mesh, rules, [None if a is None else a.shape
                                        for a in args], in_names)

        def pl(names):
            return placements(mesh, rules, names)

        args = tuple(
            DTensor.from_local(a, mesh, pl(()), run_check=False)
            if isinstance(a, torch.Tensor) and not _is_dtensor(a) else a
            for a in args)
        in_pl = tuple(None if nm is None else pl(nm) for nm in in_names)
        out_pl = (tuple(pl(nm) for nm in out_names) or (None,)
                  if isinstance(out_names, list) else (pl(out_names),))
        local = fn if kernel is None else (
            lambda *a: _kernel_call(kernel, fn, a))
        return local_map(local, out_placements=out_pl, in_placements=in_pl,
                         device_mesh=mesh, redistribute_inputs=True)(*args)

    return run


def _dividing(mesh, rules: dict, shapes, names_each) -> dict:
    """``rules`` without the names that do not divide a dim they name (one
    tuple of names a shape)."""
    size = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    out = dict(rules)
    for shape, names in zip(shapes, names_each):
        for n, nm in zip(shape if names else (), names or ()):
            ax = out.get(nm) if nm is not None else None
            if ax is not None and n % math.prod(
                    size[x] for x in (ax if isinstance(ax, tuple) else (ax,))):
                out[nm] = None
    return out
