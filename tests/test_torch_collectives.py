"""The port's collectives and row-partitioned SpMV against the JAX
package's, on 8 gloo ranks on the CPU.

One world a module, as in ``tests/test_torch_sharded.py``: a subprocess
spawns 8 ranks that run every case of ``_torch_dist_cases.collectives_rank``
(groups of 2, 4 and 8 ranks made with ``new_group``), another runs the
same cases through the JAX package under ``shard_map`` on 2, 4 and 8 of 8
emulated devices, both on the same seeded numpy inputs
(``_torch_dist_cases.collective_inputs``), one after the other under
deadlines of their own and under the run's world lock
(``_torch_dist_cases.run_worlds``).  Tolerances:

* ``halo_exchange`` (one and two hops, a batch of 3 right-hand sides),
  ``halo_exchange_3d`` (the plan's block layout), plain and FRSZ2-coded,
  ``compressed_psum`` (a tensor and a dict of them), ``compressed_pmean``
  and ``gather_operand``: bit-equal, on every rank;
* ``psum``: within 8 ulps of the sum of magnitudes (gloo's all-reduce sums
  in its own order, XLA's ``psum`` in its own);
* the peer gather (``kernels/peer_gather.py``, its plain version on the
  CPU): each rank's buffer in rank order, bit for bit; inside
  ``over_peers`` (MGS's second pass) ``compressed_psum`` bit-equal to the
  reference's, ``psum`` bit-equal to the sum in rank order and within the
  reference's by the rule above;
* ``partition_matvec`` in all four modes, plain and coded halo: within
  1e-13 of the largest entry (the ELL kernel sums each row in slot order,
  XLA in its own), and the same executed mode;
* ``perm_defect``/``rounds_defect`` and the wire-byte helpers: the same
  messages and numbers (no world needed).
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from repro.dist import collectives as JC
from repro_torch.dist import collectives as TC

_JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as Ps
jax.config.update("jax_enable_x64", True)

import _torch_dist_cases as C
from repro.dist import collectives as J
from repro.sparse import make_problem, partition_matvec, plan_operator

A, _ = make_problem("synth:atmosmod", 512)
out = {}
for P in C.GROUPS:
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("ax",))

    def sm(f, ins, outs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=ins,
                                     out_specs=outs, axis_names={"ax"},
                                     check_vma=False))

    blk = plan_operator(A, P, matvec_mode="block3d").block
    inp = C.collective_inputs(P, blk.n_pad)
    for strips in C.STRIPS:
        for comp in (False, True):
            f = sm(lambda v: J.halo_exchange(v, strips, P, "ax",
                                             compressed=comp),
                   Ps("ax"), Ps("ax"))
            out[("halo", P, strips, comp)] = np.asarray(
                f(jnp.asarray(inp["x"]))).reshape(P, -1)
        f = sm(lambda V: jax.vmap(lambda v: J.halo_exchange(
            v, strips, P, "ax", compressed=True))(V),
            Ps(None, "ax"), Ps(None, "ax"))
        Y = np.asarray(f(jnp.asarray(inp["X"])))
        out[("halo_batched", P, strips)] = Y.reshape(3, P, -1).transpose(
            1, 0, 2)
    send = tuple(jnp.asarray(ix) for ix in blk.send_idx)
    for comp in (False, True):
        f = sm(lambda v, *s: J.halo_exchange_3d(
            v, tuple(i[0] for i in s), blk.rounds, "ax", compressed=comp),
            (Ps("ax"),) + tuple(Ps("ax", None) for _ in send), Ps("ax"))
        out[("halo3d", P, comp)] = np.asarray(
            f(jnp.asarray(inp["x3"]), *send)).reshape(P, -1)
    for k in C.PSUM_SIZES:
        v = jnp.asarray(inp[("v", k)])
        for name, fn in (("cpsum", J.compressed_psum),
                         ("cpmean", J.compressed_pmean), ("psum", J.psum)):
            f = sm(lambda x: fn(x, "ax"), Ps("ax", None), Ps("ax", None))
            out[(name, P, k)] = np.asarray(f(v))
    tree = {k: jnp.asarray(v) for k, v in inp["tree"].items()}
    specs = {"a": Ps("ax", None), "b": Ps("ax", None, None)}
    f = sm(lambda t: J.compressed_psum(t, "ax"), (specs,), specs)
    out[("cpsum_tree", P)] = {k: np.asarray(v) for k, v in f(tree).items()}
    f = sm(lambda v: J.gather_operand(v, "ax"), Ps("ax"), Ps("ax"))
    out[("gather", P)] = np.asarray(f(jnp.asarray(inp["x"]))).reshape(P, -1)
    for mode in C.MATVEC_MODES:
        plan = plan_operator(A, P, reorder="none", matvec_mode=mode)
        for comp in (False, True):
            operand, specs, mv = partition_matvec(
                plan=plan, axis_name="ax", mesh=mesh, compressed_halo=comp)
            f = sm(lambda op, v: mv(op, v), (specs, Ps("ax")), Ps("ax"))
            y = f(operand, plan.embed(jnp.asarray(inp["xm"])))
            out[("matvec", P, mode, comp)] = (np.asarray(plan.extract(y)),
                                              mv.mode)
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


def world_steps(d):
    """The module's two runs: the port's 8-rank world (which also runs the
    analysis gate's step, read by ``tests/test_torch_analysis.py``) and
    the JAX package's 8-device run."""
    return [
        ("the port's 8-rank world",
         ["-c", "import _torch_dist_cases as c; c.main()", "collectives",
          str(d / "port.pkl")], None),
        ("the JAX package's 8-device run",
         ["-c", _JAX_SCRIPT, str(d / "jax.pkl")], {"JAX_PLATFORMS": "cpu"}),
    ]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = C.worlds_dir(tmp_path_factory, "collectives")
    jax_pkl, port_pkl = d / "jax.pkl", d / "port.pkl"
    if not (d / "done").exists():
        C.run_worlds(d, world_steps(d), once=True)
    with open(jax_pkl, "rb") as f:
        ref = pickle.load(f)
    with open(port_pkl, "rb") as f:
        port = pickle.load(f)
    return port, ref


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                        a.dtype, b.dtype)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


HALO = [(P, s, c) for P in C.GROUPS for s in C.STRIPS for c in (False, True)]


@pytest.mark.parametrize("P,strips,comp", HALO,
                         ids=[f"P{P}-{'_'.join(map(str, s))}-{'coded' if c else 'plain'}"
                              for P, s, c in HALO])
def test_halo_exchange_bit_equal(worlds, P, strips, comp):
    port, ref = worlds
    _bits_equal(port[("halo", P, strips, comp)], ref[("halo", P, strips, comp)])


@pytest.mark.parametrize("P,strips", [(P, s) for P in C.GROUPS
                                      for s in C.STRIPS])
def test_halo_exchange_batched_coded_bit_equal(worlds, P, strips):
    """A block of 3 right-hand sides in one exchange, each row coded in its
    own wire blocks, as the reference's exchange under ``jax.vmap``."""
    port, ref = worlds
    _bits_equal(port[("halo_batched", P, strips)],
                ref[("halo_batched", P, strips)])


@pytest.mark.parametrize("P,comp", [(P, c) for P in C.GROUPS
                                    for c in (False, True)])
def test_halo_exchange_3d_bit_equal(worlds, P, comp):
    port, ref = worlds
    _bits_equal(port[("halo3d", P, comp)], ref[("halo3d", P, comp)])


@pytest.mark.parametrize("P,k", [(P, k) for P in C.GROUPS
                                 for k in C.PSUM_SIZES])
def test_compressed_psum_and_pmean_bit_equal(worlds, P, k):
    port, ref = worlds
    for name in ("cpsum", "cpmean"):
        _bits_equal(port[(name, P, k)], ref[(name, P, k)])
    # every rank holds the same bits (ranks decide in lockstep on them)
    got = port[("cpsum", P, k)]
    assert (got == got[0]).all()


@pytest.mark.parametrize("P", C.GROUPS)
def test_compressed_psum_of_a_tree_and_gather_bit_equal(worlds, P):
    port, ref = worlds
    for key in ("a", "b"):
        _bits_equal(port[("cpsum_tree", P)][key], ref[("cpsum_tree", P)][key])
    _bits_equal(port[("gather", P)], ref[("gather", P)])


@pytest.mark.parametrize("P,k", [(P, k) for P in C.GROUPS
                                 for k in C.PSUM_SIZES])
def test_plain_psum_within_the_summation_order(worlds, P, k):
    port, ref = worlds
    inp = C.collective_inputs(P, 1)[("v", k)]
    got, want = port[("psum", P, k)], ref[("psum", P, k)]
    slack = 8 * np.finfo(np.float64).eps * np.abs(inp).sum(axis=0)
    assert (np.abs(got - want) <= slack).all()
    assert (got == got[0]).all()


@pytest.mark.parametrize("P,k", [(P, k) for P in C.GROUPS
                                 for k in C.PSUM_SIZES])
def test_peer_gather_is_every_rank_in_rank_order(worlds, P, k):
    port, _ = worlds
    inp = C.collective_inputs(P, 1)[("v", k)]
    got = port[("peer_gather", P, k)]          # (rank, P, k): every rank's
    assert got.shape == (P,) + inp.shape
    for r in range(P):
        _bits_equal(got[r], inp)


@pytest.mark.parametrize("P,k", [(P, k) for P in C.GROUPS
                                 for k in C.PSUM_SIZES])
def test_second_pass_reductions_over_peers(worlds, P, k):
    """MGS's second-pass reductions inside ``over_peers``: the coded sum
    bit-equal to the reference's ``compressed_psum``; the plain one the sum
    in rank order, bit for bit (``0 + s_0 + s_1 + ...``), and within the
    reference's ``psum`` by the summation-order rule; the same on every
    rank."""
    port, ref = worlds
    _bits_equal(port[("peer_cpsum", P, k)], ref[("cpsum", P, k)])
    inp = C.collective_inputs(P, 1)[("v", k)]
    total = np.zeros(k)
    for row in inp:
        total = total + row
    got = port[("peer_psum", P, k)]
    for r in range(P):
        _bits_equal(got[r], total)
    slack = 8 * np.finfo(np.float64).eps * np.abs(inp).sum(axis=0)
    assert (np.abs(got - ref[("psum", P, k)]) <= slack).all()


MV = [(P, mode, c) for P in C.GROUPS for mode in C.MATVEC_MODES
      for c in (False, True)]


@pytest.mark.parametrize("P,mode,comp", MV,
                         ids=[f"P{P}-{m}-{'coded' if c else 'plain'}"
                              for P, m, c in MV])
def test_partition_matvec_matches_jax(worlds, P, mode, comp):
    port, ref = worlds
    (yt, mt), (yj, mj) = port[("matvec", P, mode, comp)], ref[
        ("matvec", P, mode, comp)]
    assert mt == mj
    assert yt.shape == yj.shape
    assert np.max(np.abs(yt - yj)) <= 1e-13 * np.max(np.abs(yj))


PERMS = [
    [(0, 1), (1, 2)], [(0, 1), (0, 2)], [(0, 2), (1, 2)], [(0, 8)],
    [(-1, 0)], [(0,)], [("a", 1)], [], [(3, 3)], [[1, 0], [0, 1]],
]


@pytest.mark.parametrize("perm", PERMS, ids=[str(p) for p in PERMS])
@pytest.mark.parametrize("size", [None, 4])
def test_perm_defect_same_message(perm, size):
    assert TC.perm_defect(perm, size) == JC.perm_defect(perm, size)


ROUNDS = [
    [[(0, 1)], [(1, 0)]], [[(0, 1)], [(0, 1)]], [[(0, 1), (0, 2)]],
    [[(0, 1), (2, 3)], [(1, 2)], [(0, 5)]], [],
]


@pytest.mark.parametrize("rounds", ROUNDS, ids=[str(r) for r in ROUNDS])
def test_rounds_defect_same_message(rounds):
    for size in (None, 4):
        assert TC.rounds_defect(rounds, size) == JC.rounds_defect(rounds,
                                                                  size)


def test_wire_byte_helpers_match_reference():
    """The reductions' and a halo exchange's modelled bytes (two sends a
    strip) and the wire specs, as the reference prices them."""
    for n in (1, 101, 128, 129, 4096):
        for comp in (False, True):
            assert TC.reduce_bytes(n, compressed=comp) == JC.reduce_bytes(
                n, compressed=comp)
    for strips in ((5,), (64, 17), (11664,)):
        for comp in (False, True):
            for dt_t, dt_j in ((torch.float64, jnp.float64),
                               (torch.float32, jnp.float32)):
                assert TC.exchange_bytes(tuple(strips) * 2, compressed=comp,
                                         dtype=dt_t) == JC.halo_bytes(
                    strips, compressed=comp, dtype=dt_j)
    assert TC.halo_wire_spec(torch.float64).l == JC.halo_wire_spec(
        jnp.float64).l == 32
    assert (TC.WIRE_SPEC.bs, TC.WIRE_SPEC.l) == (JC.WIRE_SPEC.bs,
                                                 JC.WIRE_SPEC.l)
