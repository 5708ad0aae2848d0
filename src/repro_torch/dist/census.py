"""A record of the collectives this process issues: the analysis gate's census.

:class:`Census` wraps the ``torch.distributed`` entry points that
:mod:`repro_torch.dist.collectives` calls (``all_reduce``,
``all_gather_into_tensor`` and ``batch_isend_irecv`` with its ``P2POp``\\ s,
and the peer gather's reductions)
while it is entered, and keeps one :class:`Call` for each: the entry point,
the group's ranks, the operand's shape and dtype, its bytes, the exchange's
permutation and the bucket.  The bucket is ``"cycle"`` when the call is
made inside a GMRES cycle (a function marked with :func:`cycle`) and
``"solve"`` elsewhere.

A neighbour exchange (``collectives._exchange``, called on every rank of
the group) is recorded as one ``batch_isend_irecv`` call carrying its
payload and the whole permutation, also on a rank that no pair names (it
sends and receives nothing, and issues no call): every rank then holds one
entry an exchange, and the entry's ``ops`` say what the rank really put on
the wire.

A reduction over the peer gather (``collectives._peer_reduce``, MGS's
second pass inside an IF node) is recorded as one ``peer_gather`` call
carrying the values summed and priced as the reference prices their
reduction (:func:`~repro_torch.dist.collectives.reduce_bytes`, plain or
coded); the all-gather its plain version issues on the CPU is part of it
and not recorded apart.

A captured CUDA graph runs no Python when it replays.  The capture records
the calls it holds (:func:`capturing`, used by
``repro_torch.solver.gmres._capture``); each replay hands them to every
census then entered (:func:`replayed`), as the launch counts of
``ops.LAUNCHES`` are kept.  The calls inside an IF node's body (MGS's
second pass, ``repro_torch.solver.graphs.device_if``) are recorded apart,
by a nested :func:`capturing`, and a replay hands them on only for the
steps where the node ran; an eager cycle (the CPU) issues and records them
at every step, as it runs them.  Nothing is recorded while no census is
entered and no graph is being captured: the wrappers are installed only
then.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import torch
import torch.distributed as dist

__all__ = ["Call", "Census", "capturing", "cycle", "replayed"]

#: code objects of the functions whose calls go to the "cycle" bucket
_CYCLE_CODES: set = set()


def cycle(fn):
    """Mark ``fn`` as a GMRES cycle: the collectives issued inside it are
    the census's ``"cycle"`` bucket.  Returns ``fn`` unchanged."""
    _CYCLE_CODES.add(fn.__code__)
    return fn


@dataclasses.dataclass(frozen=True)
class Call:
    """One collective as this rank issued it.

    ``shape``/``dtype``/``nbytes`` describe the operand this rank
    contributes: the reduced tensor, the gathered chunk, or an exchange's
    payload (which a rank that no pair names holds too).
    ``ops`` lists an exchange's point-to-point operations as ``(kind,
    peer, shape, dtype, nbytes)``, ``kind`` ``"send"`` or ``"recv"``,
    ``peer`` the peer's rank in ``group``; ``perm`` is the exchange's
    ``(src, dst)`` pairs in group ranks, the same on every rank.
    """

    name: str
    group: tuple
    shape: tuple | None
    dtype: str | None
    nbytes: int
    bucket: str
    perm: tuple | None = None
    ops: tuple = ()

    def signature(self) -> tuple:
        """What every rank of the group must agree on: the entry point,
        the group, the operand and the permutation, in one bucket."""
        return (self.name, self.group, self.shape, self.dtype, self.perm,
                self.bucket)


def _group_ranks(group) -> tuple:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _bucket() -> str:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in _CYCLE_CODES:
            return "cycle"
        f = f.f_back
    return "solve"


def _operand(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype).replace("torch.", ""), \
        t.numel() * t.element_size()


#: the lists of the entered censuses, and of the captures in progress
#: (innermost last: a capture's calls go to it alone)
_SINKS: list[list] = []
_CAPTURES: list[list] = []
#: the exchange being issued (innermost last), and the point-to-point
#: operations its ``batch_isend_irecv`` put on the wire
_EXCHANGES: list[dict] = []
#: the peer reductions being issued: what they call is part of them
_PEER: list = []
#: the wrapped entry points while the wrappers are installed
_saved: dict = {}


def _emit(call: Call) -> None:
    if _PEER:
        return
    for sink in (_CAPTURES[-1:] if _CAPTURES else _SINKS):
        sink.append(call)


def _arg(args, kw, name, pos, default=None):
    if name in kw:
        return kw[name]
    return args[pos] if len(args) > pos else default


def _all_reduce(tensor, *args, **kw):
    shape, dtype, nbytes = _operand(tensor)
    _emit(Call("all_reduce", _group_ranks(_arg(args, kw, "group", 1)),
               shape, dtype, nbytes, _bucket()))
    return _saved["all_reduce"](tensor, *args, **kw)


def _all_gather_into_tensor(output_tensor, input_tensor, *args, **kw):
    shape, dtype, nbytes = _operand(input_tensor)
    _emit(Call("all_gather_into_tensor",
               _group_ranks(_arg(args, kw, "group", 0)), shape, dtype,
               nbytes, _bucket()))
    return _saved["all_gather_into_tensor"](output_tensor, input_tensor,
                                            *args, **kw)


def _batch_isend_irecv(p2p_op_list):
    ranks = _group_ranks(p2p_op_list[0].group if p2p_op_list else None)
    ops = []
    for p in p2p_op_list:
        kind = "send" if p.op is _saved["isend"] else "recv"
        ops.append((kind, ranks.index(p.peer), *_operand(p.tensor)))
    if _EXCHANGES:                       # part of an exchange: its entry
        _EXCHANGES[-1]["ops"] = tuple(ops)
    else:
        shape, dtype, nbytes = (ops[0][2:] if ops else (None, None, 0))
        _emit(Call("batch_isend_irecv", ranks, shape, dtype, nbytes,
                   _bucket(), ops=tuple(ops)))
    return _saved["batch_isend_irecv"](p2p_op_list)


def _exchange(payload, group, perm):
    ex = dict(ops=())
    _EXCHANGES.append(ex)
    try:
        out = _saved["_exchange"](payload, group, perm)
    finally:
        _EXCHANGES.pop()
    shape, dtype, nbytes = _operand(payload)
    _emit(Call("batch_isend_irecv", _group_ranks(group), shape, dtype,
               nbytes, _bucket(),
               perm=tuple((int(s), int(d)) for s, d in perm), ops=ex["ops"]))
    return out


def _peer_reduce(x, route, compressed):
    from repro_torch.dist.collectives import reduce_bytes

    _PEER.append(route)
    try:
        out = _saved["_peer_reduce"](x, route, compressed)
    finally:
        _PEER.pop()
    shape, dtype, _ = _operand(x)
    _emit(Call("peer_gather", _group_ranks(route.group), shape, dtype,
               reduce_bytes(x.numel(), compressed=compressed,
                            plain_itemsize=x.element_size()), _bucket()))
    return out


_WRAPPERS = dict(all_reduce=_all_reduce,
                 all_gather_into_tensor=_all_gather_into_tensor,
                 batch_isend_irecv=_batch_isend_irecv)


def _sync() -> None:
    """Install the wrappers while anything records, and only then."""
    from repro_torch.dist import collectives

    want = bool(_SINKS or _CAPTURES)
    if want and not _saved:
        _saved.update({k: getattr(dist, k) for k in _WRAPPERS},
                      isend=dist.isend,
                      _exchange=collectives._exchange,
                      _peer_reduce=collectives._peer_reduce)
        for k, f in _WRAPPERS.items():
            setattr(dist, k, f)
        collectives._exchange = _exchange
        collectives._peer_reduce = _peer_reduce
    elif not want and _saved:
        for k in _WRAPPERS:
            setattr(dist, k, _saved[k])
        collectives._exchange = _saved["_exchange"]
        collectives._peer_reduce = _saved["_peer_reduce"]
        _saved.clear()


def _drop(stack: list, calls: list) -> None:
    """Take ``calls`` (by identity: two empty lists are equal) off
    ``stack``."""
    for i, s in enumerate(stack):
        if s is calls:
            del stack[i]
            return


class Census:
    """``with Census() as c: ...`` records every collective issued inside
    the block into ``c.calls``, the calls of graph replays included."""

    def __init__(self):
        self.calls: list[Call] = []

    def __enter__(self) -> Census:
        _SINKS.append(self.calls)
        _sync()
        return self

    def __exit__(self, *exc) -> None:
        _drop(_SINKS, self.calls)
        _sync()


@contextlib.contextmanager
def capturing():
    """Record the calls of a CUDA graph capture into the yielded list, and
    into no census: a capture puts nothing on the wire."""
    calls: list[Call] = []
    _CAPTURES.append(calls)
    _sync()
    try:
        yield calls
    finally:
        _drop(_CAPTURES, calls)
        _sync()


def replayed(calls) -> None:
    """A replay of a graph whose capture recorded ``calls``."""
    for sink in _SINKS:
        sink.extend(calls)
