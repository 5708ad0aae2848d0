"""The sharded solve's collectives, plain or FRSZ2-coded, on torch.distributed.

The port of ``repro/dist/collectives.py``.  The reference runs one SPMD
program over a mesh axis; here every rank is a process of a
``torch.distributed`` group (NCCL on the card, gloo on the CPU) and each
collective of the reference has one counterpart:

* ``psum`` -> ``all_reduce`` (the backend's summation order, which may
  differ from XLA's in the last bit);
* ``gather_operand`` -> one all-gather into a tensor;
* ``ppermute`` -> one ``batch_isend_irecv`` over the pairs that name this
  rank; a rank that receives nothing gets zeros, the open boundary the
  halo exchanges rely on.

Inside :func:`over_peers` (MGS's second pass in a CUDA graph IF node, whose
body CUDA does not let NCCL into), ``psum`` and ``compressed_psum`` go
through the route's peer kernel instead (``kernels/peer_gather.py``), which
gathers every rank's buffer and sums in rank order: the coded sum keeps
its bits, the plain one may differ from NCCL's all-reduce in the last
bit.

The compressed reductions are the reference's bit for bit: each rank
compresses its values with :data:`WIRE_SPEC` (kernel 1 on the card), the
codes and exponents are all-gathered, every rank decodes all shards
(kernel 2) and sums them in rank order.  Coded buffers travel as one
``int32`` buffer (codes viewed as 32-bit words, then the exponents):
gloo's all-gather refuses 16-bit integers, and a receive whose dtype
differs from the send's gives garbage silently, so both ends build the
buffer the same way and check its dtype and length.  The wire bytes priced
here (:func:`reduce_bytes`, :func:`exchange_bytes`, :func:`gather_bytes`)
are the reference's model, whatever the packing.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops, peer_gather
from repro_torch.tree import tree_leaves

__all__ = [
    "WIRE_SPEC",
    "compressed_pmean",
    "compressed_psum",
    "exchange_bytes",
    "gather_bytes",
    "gather_objects",
    "gather_operand",
    "halo_bytes",
    "halo_exchange",
    "halo_exchange_3d",
    "halo_exchange_3d_start",
    "halo_wire_spec",
    "over_peers",
    "perm_defect",
    "pmean_bytes",
    "psum",
    "reduce_bytes",
    "rounds_defect",
]

#: wire codec: frsz2_16 over 128-value blocks (2 B codes + 4 B/128 exps)
WIRE_SPEC = F.FrszSpec(bs=128, l=16, dtype=torch.float32)


def halo_wire_spec(dtype) -> F.FrszSpec:
    """Wire codec for halo strips: frsz2 at *half* the operand width.

    Halo values feed the operator, so they ride a higher-fidelity codec than
    the dots' partial sums: frsz2_32 for f64 operands, frsz2_16 for f32.
    """
    if dtype == torch.float64:
        return F.FrszSpec(bs=128, l=32, dtype=torch.float64)
    return WIRE_SPEC


# ---------------------------------------------------------------------------
# Group plumbing
# ---------------------------------------------------------------------------


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _peer(group, r: int) -> int:
    """The global rank of group rank ``r`` (P2P ops address global ranks)."""
    return r if group is None else dist.get_global_rank(group, r)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(P, *t.shape)``: every rank's ``t`` in rank order."""
    shape = t.shape
    t = t.contiguous().reshape(-1)
    size = _size(group)
    out = torch.empty((size * t.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.view(size, *shape)


def _pack(bc: F.BlockCompressed) -> torch.Tensor:
    """Codes as 32-bit words, then the int32 exponents: one flat buffer."""
    words = bc.codes.contiguous().reshape(-1).view(torch.int32)
    return torch.cat([words, bc.exps.reshape(-1).to(torch.int32)])


def _unpack(buf: torch.Tensor, like: F.BlockCompressed,
            lead=()) -> F.BlockCompressed:
    """Inverse of :func:`_pack` for buffers shaped as ``like`` (with extra
    leading dims ``lead`` when several were gathered)."""
    nw = like.codes.numel() * like.codes.element_size() // 4
    if buf.dtype != torch.int32 or buf.shape[-1] != nw + like.exps.numel():
        raise RuntimeError(
            f"coded wire buffer {tuple(buf.shape)} {buf.dtype} does not fit "
            f"codes {tuple(like.codes.shape)} and exponents "
            f"{tuple(like.exps.shape)}")
    codes = buf[..., :nw].contiguous().view(like.codes.dtype)
    exps = buf[..., nw:].contiguous()
    return F.BlockCompressed(
        codes=codes.reshape(*lead, *like.codes.shape),
        exps=exps.reshape(*lead, *like.exps.shape).to(like.exps.dtype),
        n=like.n, spec=like.spec)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


#: the peer routes of the reductions being issued, innermost last
#: (:func:`over_peers`)
_ROUTES: list = []


@contextlib.contextmanager
def over_peers(route):
    """Inside, every reduction (:func:`psum`, :func:`compressed_psum`) goes
    through ``route``'s peer gather (a
    :class:`~repro_torch.kernels.peer_gather.Route`, or ``None``: NCCL
    stays): MGS's second pass enters it inside its IF node, so that the
    rest of the cycle stays on NCCL.  A reduction on another group than the
    route's raises."""
    if route is None:
        yield
        return
    _ROUTES.append(route)
    try:
        yield
    finally:
        _ROUTES.pop()


def _route(group):
    if not _ROUTES:
        return None
    route = _ROUTES[-1]
    if route.group is not group:
        raise RuntimeError("a reduction inside over_peers() on another group "
                           "than its route's")
    return route


def _peer_reduce(x: torch.Tensor, route, compressed: bool) -> torch.Tensor:
    """One reduction of ``x`` over ``route``'s group through its peer
    kernel, which sums in rank order: coded, ``x``'s :data:`WIRE_SPEC`
    codes, decoded before the sum (:func:`compressed_psum`'s bits); plain,
    ``x`` itself.  Priced by :func:`reduce_bytes` of ``x``'s values (the
    census records it so)."""
    if compressed:
        bc = ops.compress(x.reshape(-1).to(WIRE_SPEC.dtype), WIRE_SPEC)
        total = peer_gather.reduce(_pack(bc), route, coded=bc,
                                   out_dtype=x.dtype)
        return total.reshape(x.shape)
    return peer_gather.reduce(x, route)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group (``all_reduce``), as a new tensor: the
    one spelling of a plain reduction, priced by :func:`reduce_bytes` with
    ``compressed=False``.  Inside :func:`over_peers`, the peer kernel's sum
    in rank order."""
    route = _route(group)
    if route is not None:
        return _peer_reduce(x, route, compressed=False)
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def gather_operand(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Tiled all-gather of a row-partitioned chunk ``(..., n_local)`` into
    ``(..., P * n_local)``: the transport of the ``rows`` and
    ``replicated`` matvecs, priced by :func:`gather_bytes`."""
    out = _all_gather(x_local, group)                  # (P, ..., n_local)
    return out.movedim(0, -2).reshape(*x_local.shape[:-1], -1)


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank: the
    host-side exchange of reports (timelines, recorded collectives), never
    of a solve's data, and priced by no wire model."""
    out = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _gathered_shards(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather one tensor's FRSZ2 wire codes; the decoded ``(P,
    n_flat)`` shards, in rank order."""
    bc = ops.compress(x.reshape(-1).to(WIRE_SPEC.dtype), WIRE_SPEC)
    gathered = _all_gather(_pack(bc), group)
    return ops.decompress(_unpack(gathered, bc, lead=(gathered.shape[0],)))


def _sum_in_rank_order(shards: torch.Tensor) -> torch.Tensor:
    """``0 + s_0 + s_1 + ...``: the reference's sum over the gathered axis."""
    total = torch.zeros_like(shards[0])
    for s in shards:
        total = total + s
    return total


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def compressed_psum(tree, group=None):
    """Sum of each tensor of ``tree`` over the group, its values shipped as
    :data:`WIRE_SPEC` codes: the transport of the sharded basis' partial
    dot products.  Bit-equal to the reference's ``compressed_psum``, also
    inside :func:`over_peers`."""
    route = _route(group)

    def leaf(x):
        if route is not None:
            return _peer_reduce(x, route, compressed=True)
        total = _sum_in_rank_order(_gathered_shards(x, group))
        return total[:x.numel()].reshape(x.shape).to(x.dtype)

    return _tree_map(leaf, tree)


def compressed_pmean(tree, group=None):
    """Mean of each tensor of ``tree`` over the group with the coded
    transport of :func:`compressed_psum` (the sum divided by the group
    size, in the wire dtype, as the reference's ``jnp.mean``)."""

    def leaf(x):
        shards = _gathered_shards(x, group)
        mean = _sum_in_rank_order(shards) / shards.shape[0]
        return mean[:x.numel()].reshape(x.shape).to(x.dtype)

    return _tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# Permutation/round structure (one definition of "well-formed" for every
# neighbour exchange)
# ---------------------------------------------------------------------------


def perm_defect(perm, axis_size: int | None = None) -> str | None:
    """Why ``perm`` is not a partial injection on ``[0, axis_size)``.

    A permutation is well-formed iff every source appears at most once (a
    rank cannot send two payloads in one exchange) and every destination at
    most once (two senders to one receiver would clobber); ranks that no
    pair names send nothing and receive zeros.  ``None`` when well-formed,
    else a short reason naming the offending index.
    """
    seen_src: set[int] = set()
    seen_dst: set[int] = set()
    for pair in perm:
        try:
            src, dst = (int(pair[0]), int(pair[1]))
        except (TypeError, ValueError, IndexError):
            return f"pair {pair!r} is not an (src, dst) index pair"
        if axis_size is not None and not (
                0 <= src < axis_size and 0 <= dst < axis_size):
            return (f"pair ({src}, {dst}) outside the axis range "
                    f"[0, {axis_size})")
        if src in seen_src:
            return f"source {src} appears twice"
        if dst in seen_dst:
            return f"destination {dst} appears twice"
        seen_src.add(src)
        seen_dst.add(dst)
    return None


def rounds_defect(rounds, axis_size: int | None = None) -> str | None:
    """Why a round schedule is not a set of pairwise-disjoint partial
    injections: each round must pass :func:`perm_defect`, and no directed
    ``(src, dst)`` channel may appear in two rounds.  ``None`` when
    well-formed."""
    seen_pairs: set[tuple[int, int]] = set()
    for k, perm in enumerate(rounds):
        defect = perm_defect(perm, axis_size)
        if defect is not None:
            return f"round {k}: {defect}"
        for src, dst in perm:
            channel = (int(src), int(dst))
            if channel in seen_pairs:
                return (f"round {k}: channel {channel} already used by an "
                        "earlier round")
            seen_pairs.add(channel)
    return None


# ---------------------------------------------------------------------------
# Neighbour exchanges
# ---------------------------------------------------------------------------


class _Pending:
    """An exchange in flight: ``wait()`` waits for its transfers and returns
    what was received (zeros where nothing was)."""

    def __init__(self, works, finish):
        self._works = works
        self._finish = finish

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._finish()


def _ppermute_start(x: torch.Tensor, group, perm, compressed: bool
                    ) -> _Pending:
    """Start one permutation exchange of ``x``: this rank sends ``x`` to the
    destination its pair names and receives its source's ``x``
    (:func:`_exchange`).  With ``compressed`` the payload is ``x``'s
    :func:`halo_wire_spec` codes, compressed and decoded on every rank
    whether it sends or receives (zero codes decode to exact zeros), as
    the reference's dataflow runs."""
    if compressed:
        bc = ops.compress(x, halo_wire_spec(x.dtype))
        payload = _pack(bc)
    else:
        payload = x.contiguous()
    works, recv = _exchange(payload, group, perm)

    def finish():
        if not compressed:
            return recv
        return ops.decompress(_unpack(recv, bc)).to(x.dtype)

    return _Pending(works, finish)


def _exchange(payload: torch.Tensor, group, perm):
    """One exchange of ``payload`` along ``perm``, called on every rank of
    the group (the census records it there, named or not): one
    ``batch_isend_irecv`` of this rank's send and receive, if a pair names
    it.  Returns ``(works, recv)``, ``recv`` zeros where nothing arrives."""
    rank = _rank(group)
    dst = next((int(d) for s, d in perm if int(s) == rank), None)
    src = next((int(s) for s, d in perm if int(d) == rank), None)
    recv = torch.zeros_like(payload)
    p2p = []
    if dst is not None:
        p2p.append(dist.P2POp(dist.isend, payload, _peer(group, dst),
                              group))
    if src is not None:
        p2p.append(dist.P2POp(dist.irecv, recv, _peer(group, src), group))
    works = dist.batch_isend_irecv(p2p) if p2p else []
    return works, recv


def _pshift_start(x, k: int, n_shards: int, group, compressed: bool):
    """Receive the rank at distance ``k``'s ``x`` (``0 < |k| < n_shards``):
    rank ``p`` gets rank ``p - k``'s, edge ranks get zeros."""
    perm = [(i, i + k) for i in range(n_shards) if 0 <= i + k < n_shards]
    return _ppermute_start(x, group, perm, compressed)


def halo_exchange(x_local: torch.Tensor, strips, n_shards: int, group=None,
                  *, compressed: bool = False) -> torch.Tensor:
    """Extend this rank's chunk with its neighbours' boundary strips.

    ``x_local`` is the ``(..., n_local)`` chunk of a row-partitioned vector
    (a leading batch dim carries the block method's right-hand sides);
    ``strips`` the per-hop strip lengths from the halo probe (hop 1 first).
    Returns ``[left halo | x_local | right halo]`` with ``halo =
    sum(strips)`` along the last axis: only ``2 * halo`` values a rank
    cross the wire (two sends a strip, :func:`exchange_bytes`).  ``compressed`` ships the strips
    as :func:`halo_wire_spec` codes, each row of a batch its own blocks.
    Every shift is started before the first is waited on.
    """
    n_local = x_local.shape[-1]
    left, right = [], []
    for k, s in enumerate(strips, start=1):
        if not 0 < s <= n_local:
            raise ValueError(f"strip {k} of {strips} not in (0, {n_local}]")
        # left halo: the trailing s values of the k-hop left neighbour;
        # right halo: the leading s values of the k-hop right neighbour
        left.append(_pshift_start(x_local[..., n_local - s:], +k, n_shards,
                                  group, compressed))
        right.append(_pshift_start(x_local[..., :s], -k, n_shards, group,
                                   compressed))
    left = [p.wait() for p in left]
    right = [p.wait() for p in right]
    # farthest-first on the left, nearest-first on the right: global order
    return torch.cat(left[::-1] + [x_local] + right, dim=-1)


def halo_exchange_3d_start(x_local: torch.Tensor, send_idx, rounds,
                           group=None, *, compressed: bool = False
                           ) -> _Pending:
    """Start the 3-D face exchange; ``wait()`` returns ``[x_local | recv_0 |
    recv_1 | ...]`` along the last axis.

    Each round gathers this rank's ghost values ``x_local[..., send_idx[k]]``
    (``send_idx[k]``: this rank's index tensor of the plan's round ``k``)
    and ships them along the round's disjoint ``(src, dst)`` pairs; ranks
    that no pair of a round names send nothing and receive zeros, which the
    localized ELL columns never reference.  The rounds are all started
    before any is waited on, so a caller can contract its interior rows
    while the faces are in flight (the block3d matvec does).
    """
    defect = rounds_defect(rounds)
    if defect is not None:
        raise ValueError(f"malformed exchange rounds: {defect}")
    pending = [_ppermute_start(x_local[..., idx], group, list(pairs),
                               compressed)
               for idx, pairs in zip(send_idx, rounds)]

    def finish():
        bufs = [p.wait() for p in pending]
        return torch.cat([x_local, *bufs], dim=-1) if bufs else x_local

    return _Pending([], finish)


def halo_exchange_3d(x_local: torch.Tensor, send_idx, rounds, group=None, *,
                     compressed: bool = False) -> torch.Tensor:
    """:func:`halo_exchange_3d_start`, waited on at once."""
    return halo_exchange_3d_start(x_local, send_idx, rounds, group,
                                  compressed=compressed).wait()


# ---------------------------------------------------------------------------
# Wire-byte accounting (the reference's model)
# ---------------------------------------------------------------------------


def exchange_bytes(sizes, *, compressed: bool = False,
                   plain_itemsize: int = 8, dtype=torch.float64) -> int:
    """Per-device wire payload of one exchange shipping ``sizes`` buffers.

    ``sizes`` is the per-collective operand length, the values one device
    *sends* in each: per-hop strips twice (once per direction) for the 1-D
    halo, per-round buffer lengths for the 3-D face exchange.  Compressed
    buffers ride :func:`halo_wire_spec` for ``dtype`` and pay FRSZ2's
    whole-block granularity per buffer (a 1-value corner still ships a
    128-code block).
    """
    if compressed:
        spec = halo_wire_spec(dtype)
        return sum(F.storage_nbytes(int(s), spec) for s in sizes)
    return int(sum(int(s) for s in sizes)) * plain_itemsize


def halo_bytes(strips, *, compressed: bool = False, plain_itemsize: int = 8,
               dtype=torch.float64) -> int:
    """Per-device wire payload of one :func:`halo_exchange`: each strip is
    both sent and received on each side, so a device moves ``2 *
    sum(strips)`` values, priced through :func:`exchange_bytes` as two
    sends a strip."""
    return exchange_bytes(tuple(strips) * 2, compressed=compressed,
                          plain_itemsize=plain_itemsize, dtype=dtype)


def gather_bytes(n_local: int, n_shards: int, *,
                 plain_itemsize: int = 8) -> int:
    """Per-device wire payload of one tiled ring all-gather: each device
    transmits (and receives) ``n_shards - 1`` chunks, not just its own."""
    return (n_shards - 1) * n_local * plain_itemsize


def reduce_bytes(n_values: int, *, compressed: bool,
                 plain_itemsize: int = 8) -> int:
    """Per-device wire payload of one reduction of ``n_values`` values:
    the arithmetic width plain, or :data:`WIRE_SPEC` codes plus the
    exponent stream compressed (a payload under one 128-value block still
    pays for a whole block, so a coded scalar costs more than a plain
    one)."""
    if compressed:
        return F.storage_nbytes(n_values, WIRE_SPEC)
    return n_values * plain_itemsize


def pmean_bytes(tree, *, compressed: bool) -> int:
    """Per-device wire payload of one pmean of ``tree`` (nested dicts of
    tensors, :mod:`repro_torch.tree`): each plain leaf at its own itemsize,
    or, coded, the :data:`WIRE_SPEC` codes and exponents of its values
    (whatever the leaf's dtype: the codec casts to its wire dtype)."""
    total = 0
    for leaf in tree_leaves(tree):
        n = leaf.numel()
        if compressed:
            total += F.storage_nbytes(n, WIRE_SPEC)
        else:
            total += n * leaf.element_size()
    return total
