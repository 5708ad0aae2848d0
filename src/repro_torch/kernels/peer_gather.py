"""A reduction through peer memory over NVLink: bindings of
``csrc/peer_gather.cu``, its plain version and its symmetric regions.

Not a port of a TPU kernel.  CUDA does not take NCCL's collectives inside
a CUDA graph conditional node, so MGS's second pass, which the captured
cycle runs in an IF node (``solver/graphs.py::device_if``), reduces its dots
and norm through this kernel instead
(``repro_torch.dist.collectives.over_peers``); the rest of the cycle stays
on NCCL.  The kernel gathers every rank's buffer into every rank's memory
and sums it there in rank order, ``0 + v_0 + v_1 + ...``: plain values, or
``collectives.compressed_psum``'s wire codes, decoded before the sum (its
bits).

* :func:`reachable` says whether a group's cards can all reach each
  other's memory (``cudaDeviceCanAccessPeer`` for every pair, every rank on
  one host), the same answer on every rank; a gloo group on the CPU cannot
  (its ranks are processes that share no memory, and its cycles run
  eagerly: there is no IF node to keep NCCL out of).  The sharded solve
  takes the peer route only where they can (``solver/sharded.py``): a
  decision made from capability, never from a failure.  The CPU tests
  force the route (through this function) to run the plain version.
* :class:`Route` is the route of one group: on the card it holds a
  :class:`Region` (one ``cudaMalloc`` a rank, made outside any capture,
  the ``cudaIpcMemHandle_t``\\ s swapped through
  ``collectives.gather_objects`` and opened with ``cudaIpcOpenMemHandle``).
  Regions are shared by the solves of a group that fit in them and freed by
  :func:`free_regions` (``solver.clear_graph_cache``), on every rank of the
  group together.
* :func:`reduce` launches the kernel on a CUDA tensor (or raises) and adds
  one to ``ops.LAUNCHES["peer_gather"]``; on a CPU tensor it runs the plain
  version, :func:`reduce_ref`: ``dist.all_gather_into_tensor`` into ``(P,
  ...)`` in rank order (:func:`gather_ref`), the codes decoded, summed in
  rank order.

Traps, each handled in the kernel's source: a graph replays fixed
arguments, so the call's sequence number is a counter on the card that the
kernel advances; the slots are double-buffered by its parity; flags are
published with system-scope release and read with acquire; the wait is
bounded and traps past :data:`SPIN_TIMEOUT_S` (a rank whose peers took the
other branch gets a CUDA error, not a hang).  All ranks take the same
branch only because ``fired`` comes from reductions bit-identical on every
rank.
"""
from __future__ import annotations

import ctypes
import socket

import torch

from repro_torch.kernels import build, ops

__all__ = ["Region", "Route", "SPIN_TIMEOUT_S", "free_regions",
           "gather_ref", "reachable", "reduce", "reduce_ref"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
# (peers, rank, P, chunks, src, nbytes, slot_bytes, kind, n, words, out_f64,
#  out, counters, timeout_ns, stream)
_RUN = [_P, _I, _I, _I, _P, _L, _L, _I, _L, _L, _I, _P, _P, _L, _P]
#: the kernel's kinds of values
_KINDS = {torch.float32: 0, torch.float64: 1}
_CODED = 2

#: seconds a block of the kernel waits for a peer's flag before it traps
SPIN_TIMEOUT_S = 60.0
#: slots are whole multiples of this many bytes (so each starts aligned)
SLOT_ALIGN = 256
#: a region's buffers travel in chunks of about this many bytes, one block
#: a chunk and peer, at most :data:`MAX_CHUNKS` of them (and 256 blocks)
CHUNK_BYTES = 4096
MAX_CHUNKS = 16


def _call(fn: str, argtypes, *args) -> None:
    build.check(build.bind("peer_gather", fn, argtypes)(*args), fn)


def _slot_bytes(nbytes: int) -> int:
    return -(-int(nbytes) // SLOT_ALIGN) * SLOT_ALIGN


def _chunks(P: int, slot_bytes: int) -> int:
    """The chunks a buffer of a region travels in: fixed when the region is
    made, so that every call runs the same blocks (each advances its own
    call counter)."""
    return max(1, min(MAX_CHUNKS, 256 // P, slot_bytes // CHUNK_BYTES))


def _bus_id(index: int) -> str:
    buf = ctypes.create_string_buffer(64)
    _call("peer_gather_bus_id", [_I, ctypes.c_char_p, _I], index, buf, 64)
    return buf.value.decode()


def _can_access(index: int, bus: str) -> bool:
    ok = ctypes.c_int(0)
    _call("peer_gather_can_access", [_I, ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int)],
          index, bus.encode(), ctypes.byref(ok))
    return bool(ok.value)


def _index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def reachable(group, device) -> bool:
    """Whether every rank of ``group`` can reach every other's memory: on
    the card when every rank runs on one host and every rank's card can
    write to every other's; on the CPU never.  Every rank must call it (two
    host exchanges on the card); the answer is the same on all."""
    from repro_torch.dist.collectives import gather_objects

    if torch.device(device).type != "cuda":
        return False
    idx = _index(device)
    everyone = gather_objects((socket.gethostname(), _bus_id(idx)), group)
    mine = (len({host for host, _ in everyone}) == 1
            and all(_can_access(idx, bus) for _, bus in everyone))
    return all(gather_objects(mine, group))


class Region:
    """This rank's symmetric region on ``device`` and its peers', mapped:
    ``peers`` (int64, P) the regions' addresses in this process, its own
    at ``rank``; ``chunks`` the pieces a buffer travels in; ``counters``
    (int64, P x chunks) the kernel's call numbers, one a block.  Made by
    every rank of ``group`` together, outside any capture."""

    def __init__(self, group, device, slot_bytes: int):
        import torch.distributed as dist

        from repro_torch.dist.collectives import gather_objects

        self.group = group
        self.device = torch.device("cuda", _index(device))
        self.P = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.slot_bytes = _slot_bytes(slot_bytes)
        self.chunks = _chunks(self.P, self.slot_bytes)
        total = ctypes.c_longlong(0)
        _call("peer_gather_region_bytes", [_I, _I, _L, ctypes.POINTER(_L)],
              self.P, self.chunks, self.slot_bytes, ctypes.byref(total))
        hsize = build.bind("peer_gather", "peer_gather_handle_bytes", [])()
        handle = ctypes.create_string_buffer(hsize)
        base = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            _call("peer_gather_alloc", [_L, _PP, _P], total.value,
                  ctypes.byref(base), handle)
            self.base = base.value
            self._opened: list[int] = []
            addrs = []
            for q, h in enumerate(gather_objects(handle.raw, group)):
                if q == self.rank:
                    addrs.append(self.base)
                    continue
                ptr = ctypes.c_void_p()
                _call("peer_gather_open", [_P, _PP],
                      ctypes.create_string_buffer(h, len(h)),
                      ctypes.byref(ptr))
                self._opened.append(ptr.value)
                addrs.append(ptr.value)
            self.peers = torch.tensor(addrs, dtype=torch.int64,
                                      device=self.device)
            self.counters = torch.zeros((self.P * self.chunks,),
                                        dtype=torch.int64, device=self.device)
        self.freed = False

    def free(self) -> None:
        """Unmap the peers' regions, wait for every rank to have done so
        (an exporter must not free a region a peer still maps), free this
        one.  Every rank of the group calls it; once the group is gone the
        memory is left to the process's end."""
        import torch.distributed as dist

        if self.freed:
            return
        self.freed = True
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            for ptr in self._opened:
                _call("peer_gather_close", [_P], ptr)
            if dist.is_initialized():
                dist.barrier(group=self.group)
                _call("peer_gather_free", [_P], self.base)


#: the regions made so far, oldest first
_REGIONS: list[Region] = []


def _group_key(group):
    import torch.distributed as dist

    return dist.group.WORLD if group is None else group


def _region_for(group, device, nbytes: int) -> Region:
    """The newest live region of ``group`` on ``device`` whose slots hold
    ``nbytes``, or a new one (every rank reaches here with the same
    history, so all make it together)."""
    key, dev = _group_key(group), torch.device("cuda", _index(device))
    for r in reversed(_REGIONS):
        if (not r.freed and _group_key(r.group) is key and r.device == dev
                and r.slot_bytes >= nbytes):
            return r
    region = Region(group, dev, nbytes)
    _REGIONS.append(region)
    return region


def free_regions() -> None:
    """Free every region (after the graphs that read them are gone)."""
    while _REGIONS:
        _REGIONS.pop().free()


class Route:
    """The peer gather over ``group`` for buffers of up to ``nbytes``: the
    transport of MGS's second-pass reductions inside an IF node.  On the
    card it holds a :class:`Region`; on the CPU none (the plain version
    needs none)."""

    def __init__(self, group, device, nbytes: int):
        self.group = group
        self.nbytes = int(nbytes)
        self.region = (_region_for(group, device, self.nbytes)
                       if torch.device(device).type == "cuda" else None)


def gather_ref(t: torch.Tensor, group) -> torch.Tensor:
    """``(P, *t.shape)``, every rank's ``t`` in rank order, by
    ``dist.all_gather_into_tensor`` (gloo on the CPU)."""
    import torch.distributed as dist

    flat = t.contiguous().reshape(-1)
    size = dist.get_world_size(group)
    out = torch.empty((size * flat.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(size, *t.shape)


def reduce_ref(t: torch.Tensor, group, coded=None,
               out_dtype=None) -> torch.Tensor:
    """The plain version: :func:`gather_ref`, each row decoded where
    ``coded`` (the :class:`~repro_torch.core.frsz2.BlockCompressed` whose
    packed buffer ``t`` is), then ``0 + v_0 + v_1 + ...``
    (``collectives._sum_in_rank_order``), in ``out_dtype`` if given."""
    from repro_torch.dist.collectives import _sum_in_rank_order, _unpack

    rows = gather_ref(t, group)
    if coded is not None:
        rows = ops.decompress(_unpack(rows, coded, lead=(rows.shape[0],)))
    total = _sum_in_rank_order(rows)
    return total if out_dtype is None else total.to(out_dtype)


def _coded_words(coded) -> int:
    """The 32-bit words of the codes of ``coded``, which the kernel decodes
    as the wire's spec only (l 16, 128 to a block, f32, int32 exponents on
    the wire), or raise."""
    from repro_torch.dist.collectives import WIRE_SPEC

    if coded.spec != WIRE_SPEC:
        raise ValueError(f"the peer reduction decodes {WIRE_SPEC} only, not "
                         f"{coded.spec}")
    return coded.codes.numel() * coded.codes.element_size() // 4


def reduce(t: torch.Tensor, route: Route, *, coded=None, out_dtype=None,
           kernel: bool | None = None) -> torch.Tensor:
    """``0 + v_0 + v_1 + ...`` over ``route``'s group in rank order, ``v_q``
    rank ``q``'s ``t``: f32 or f64 values, summed in their type; or with
    ``coded`` (the wire's :class:`~repro_torch.core.frsz2.BlockCompressed`
    that ``t``, an int32 buffer, packs: ``collectives._pack``) its ``n``
    values decoded and summed in f32, returned flat in ``out_dtype`` (f32
    or f64; the values' type by default).  A CUDA tensor goes to the kernel
    (``kernel=False`` forces the plain version there, for a comparison); a
    CPU tensor to the plain version, :func:`reduce_ref` (``kernel=True``
    raises)."""
    if kernel is False or (kernel is None and not t.is_cuda):
        return reduce_ref(t, route.group, coded, out_dtype)
    if not t.is_cuda:
        raise RuntimeError(f"kernel=True needs a CUDA tensor, got {t.device}")
    region = route.region
    if region is None or region.freed:
        raise RuntimeError("the peer reduction's route has no live region on "
                           "the card (made on the CPU, or freed)")
    nbytes = t.numel() * t.element_size()
    if coded is None:
        kind, words, n, shape = _KINDS.get(t.dtype), 0, t.numel(), t.shape
        out_dtype = t.dtype if out_dtype is None else out_dtype
        ok = kind is not None and out_dtype == t.dtype
    else:
        kind, words, n, shape = _CODED, _coded_words(coded), coded.n, (
            coded.n,)
        out_dtype = coded.spec.dtype if out_dtype is None else out_dtype
        ok = t.dtype == torch.int32 and out_dtype in _KINDS
    if (not ok or t.device != region.device or nbytes % 4
            or nbytes > region.slot_bytes):
        raise ValueError(
            f"peer reduction of {tuple(t.shape)} {t.dtype} into {out_dtype} "
            f"on {t.device}: the kernel takes f32 or f64 values into their "
            "type, or the wire's int32 codes into f32 or f64, and the region "
            f"on {region.device} up to {region.slot_bytes} bytes")
    src = t.contiguous()
    out = torch.empty(shape, dtype=out_dtype, device=t.device)
    _call("peer_gather_run", _RUN, region.peers.data_ptr(), region.rank,
          region.P, region.chunks, src.data_ptr(), nbytes, region.slot_bytes,
          kind, n, words, int(out_dtype == torch.float64), out.data_ptr(),
          region.counters.data_ptr(), int(SPIN_TIMEOUT_S * 1e9),
          build.stream())
    ops.LAUNCHES["peer_gather"] += 1
    return out
