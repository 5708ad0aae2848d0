"""The route of MGS's second pass and its peer kernel, on the CPU without a
process group (the 8-rank worlds of ``tests/test_torch_sharded.py`` and
``tests/test_torch_collectives.py`` run the kernel's plain version and the
routed solves; ``tests/test_torch_cuda.py`` the kernel).

* ``DistContext.second_pass`` and ``pipeline._second_pass`` follow the
  route the context carries, never the group's size: a sharded context
  with a peer route runs the pass's reductions over the route's gather
  inside the IF node; without one the pass is branch-free and its
  reductions stay on the all-reduce.
* The plain version sums the gathered rows in rank order, ``0 + v_0 + v_1
  + ...``, the coded rows decoded first; the kernel takes only the wire's
  codes.
* ``over_peers`` routes ``psum`` and ``compressed_psum`` and nothing after
  it; a reduction on another group than the route's raises.
* The census records a routed reduction as one ``peer_gather`` call,
  priced as the reduction of its values, and not the gather inside its
  plain version.
* ``second_pass_bytes`` holds every message the pass gathers.
* The wrapper takes a CPU tensor only to its plain version; a CPU group
  reaches no peer's memory (the tests force the route).
"""
import types

import pytest
import torch
import torch.distributed as dist

from repro_torch.core import frsz2 as F
from repro_torch.dist import census, collectives
from repro_torch.dist.context import LOCAL, DistContext
from repro_torch.kernels import peer_gather
from repro_torch.solver import pipeline as PL
from repro_torch.solver.sharded import second_pass_bytes

P = 3


class _Group:
    """A stand-in process group: nothing here may ask it anything."""


@pytest.fixture
def fake_world(monkeypatch):
    """Three ranks' worth of collectives with no process group: the peer
    kernel's plain gather stacks P copies (each rank's buffer in rank
    order, were every rank to hold the same), the all-reduce multiplies by
    P; both count their calls.  Asking the group its size raises."""
    seen = {"gather": 0, "all_reduce": 0}

    def gather(t, group):
        seen["gather"] += 1
        return torch.stack([t] * P)

    def all_reduce(t, group=None):
        seen["all_reduce"] += 1
        t.mul_(P)

    def no_size(group=None):
        raise AssertionError("the route was decided by the group's size")

    monkeypatch.setattr(peer_gather, "gather_ref", gather)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "get_world_size", no_size)
    return seen


def _route(group):
    return types.SimpleNamespace(group=group, region=None)


def test_dist_context_second_pass_and_its_key():
    g = _Group()
    routed = DistContext(group=g, sharded=True, peer=_route(g))
    plain = DistContext(group=g, sharded=True)
    assert LOCAL.second_pass == "if"
    assert routed.second_pass == "if+peer_gather"
    assert plain.second_pass == "select"
    # the route object is no part of a context's identity, its kind is of
    # the captured cycle's key
    assert routed == DistContext(group=g, sharded=True, peer=_route(g))
    assert routed.spec() != plain.spec()


@pytest.mark.parametrize("routed", [True, False])
def test_second_pass_follows_the_route_not_the_group_size(fake_world,
                                                          routed):
    g = _Group()
    ctx = DistContext(group=g, sharded=True,
                      peer=_route(g) if routed else None)
    fired = torch.tensor(True)
    x = torch.arange(4, dtype=torch.float64)
    with PL._second_pass(fired, ctx) as put:
        y = collectives.psum(x, g)
        dst = torch.zeros(4, dtype=torch.float64)
        put(dst, y)
    assert torch.equal(dst, P * x)
    assert fake_world == ({"gather": 1, "all_reduce": 0} if routed
                          else {"gather": 0, "all_reduce": 1})
    # after the pass the cycle's reductions are the all-reduce again
    collectives.psum(x, g)
    assert fake_world["all_reduce"] == (1 if routed else 2)


def test_select_route_keeps_the_first_pass_where_it_does_not_fire():
    ctx = DistContext(group=_Group(), sharded=True)
    dst = torch.ones(3)
    with PL._second_pass(torch.tensor(False), ctx) as put:
        put(dst, torch.full((3,), 7.0))
    assert torch.equal(dst, torch.ones(3))


def test_over_peers_routes_both_transports_on_its_group_only(fake_world):
    g = _Group()
    x = torch.linspace(-3.0, 5.0, 7, dtype=torch.float64)
    with collectives.over_peers(_route(g)):
        plain = collectives.psum(x, g)
        coded = collectives.compressed_psum({"a": x}, g)["a"]
        with pytest.raises(RuntimeError, match="another group"):
            collectives.psum(x, _Group())
    assert fake_world == {"gather": 2, "all_reduce": 0}
    # P copies summed in rank order
    assert torch.equal(plain, x + x + x)
    want = collectives._sum_in_rank_order(torch.stack([
        collectives.ops.decompress(collectives.ops.compress(
            x.to(torch.float32), collectives.WIRE_SPEC))] * P))
    assert torch.equal(coded, want[:7].to(torch.float64))
    with collectives.over_peers(None):
        collectives.psum(x, g)
    assert fake_world["all_reduce"] == 1


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("shape", [(), (9,), (4, 2, 2)])
def test_census_records_a_routed_reduction_as_one_priced_call(
        fake_world, monkeypatch, compressed, shape):
    g = _Group()
    monkeypatch.setattr(census, "_group_ranks", lambda group: (0, 1, 2))
    x = torch.ones(shape, dtype=torch.float64)
    with census.Census() as c, collectives.over_peers(_route(g)):
        if compressed:
            collectives.compressed_psum(x, g)
        else:
            collectives.psum(x, g)
    assert [call.name for call in c.calls] == ["peer_gather"]
    call = c.calls[0]
    assert call.shape == shape and call.group == (0, 1, 2)
    assert call.nbytes == collectives.reduce_bytes(x.numel(),
                                                   compressed=compressed)
    assert collectives._peer_reduce is not census._peer_reduce


@pytest.mark.parametrize("m,p", [(1, 1), (8, 1), (20, 1), (100, 1),
                                 (4, 3), (100, 8)])
def test_second_pass_bytes_hold_every_message(m, p):
    n = (m + 1) * p * p
    cap = second_pass_bytes(m, p)
    msgs = [n * 8]
    for k in (n, 1):                  # the coded dots, a coded norm
        bc = collectives.ops.compress(torch.zeros(k), collectives.WIRE_SPEC)
        buf = collectives._pack(bc)
        msgs.append(buf.numel() * buf.element_size())
        assert msgs[-1] == F.storage_nbytes(k, collectives.WIRE_SPEC)
    assert cap == max(msgs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_sums_in_rank_order(fake_world, monkeypatch, dtype):
    """``0 + v_0 + v_1 + v_2`` of distinct rows, in their type; coded, the
    rows' wire codes decoded first, as ``compressed_psum`` sums them."""
    rows = torch.tensor([[1e16, -0.0, 3.0], [1.0, -0.0, -3.0],
                         [-1e16, -0.0, 1e-3]], dtype=dtype)
    monkeypatch.setattr(peer_gather, "gather_ref", lambda t, group: rows)
    route = types.SimpleNamespace(group=_Group(), region=None)
    got = peer_gather.reduce(rows[0], route)  # graphlint: ok[raw-collective] the plain version
    want = torch.zeros(3, dtype=dtype)
    for r in rows:
        want = want + r
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    bcs = [collectives.ops.compress(r.to(torch.float32),
                                    collectives.WIRE_SPEC) for r in rows]
    packed = torch.stack([collectives._pack(bc) for bc in bcs])
    monkeypatch.setattr(peer_gather, "gather_ref", lambda t, group: packed)
    coded = peer_gather.reduce(packed[0], route, coded=bcs[0],  # graphlint: ok[raw-collective] the plain version
                               out_dtype=torch.float64)
    want = torch.zeros(3)
    for bc in bcs:
        want = want + collectives.ops.decompress(bc)
    assert coded.dtype == torch.float64
    assert torch.equal(coded, want.to(torch.float64))


def test_wrapper_takes_a_cpu_tensor_only_to_its_plain_version():
    route = peer_gather.Route(None, "cpu", 64)
    assert route.region is None
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        peer_gather.reduce(torch.zeros(4), route, kernel=True)  # graphlint: ok[raw-collective] the wrapper's refusal
    bc = collectives.ops.compress(torch.zeros(4), F.FrszSpec(bs=32, l=16))
    with pytest.raises(ValueError, match="decodes"):
        peer_gather._coded_words(bc)
    # gloo ranks share no memory: the CPU's route is the branch-free pass,
    # and a test forces the peer route to run the plain version
    assert not peer_gather.reachable(None, "cpu")
    assert peer_gather.SPIN_TIMEOUT_S > 0


@pytest.mark.parametrize("P,slot,want", [(1, 1024, 1), (4, 1024, 1),
                                         (4, 51712, 12), (8, 4096, 1),
                                         (2, 1 << 20, 16), (32, 1 << 20, 8)])
def test_a_region_splits_its_buffers_into_chunks(P, slot, want):
    """A buffer travels in about 4 KiB chunks, one block a chunk and peer,
    at most 16 chunks and 256 blocks; fixed for the region's life, since
    every block keeps its own call counter."""
    assert peer_gather._chunks(P, slot) == want
    assert P * want <= 256
