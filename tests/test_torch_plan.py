"""The port's halo probe, 3-D block partition and operator plan against the
JAX package's.

All host arithmetic over the same index arrays, so every comparison is
exact: each field of ``HaloProbe``, ``BlockPartition`` (its layout, rounds,
send indices, localized ELL arrays and block-layout operator) and
``OperatorPlan`` (``key``, ``perm``/``iperm``, the probe, the resolved
mode, ``describe()``, the memoized ELL material, the wire sizes and bytes,
plain and compressed, f64 and f32), and the vectors ``permute`` /
``unpermute`` / ``embed`` / ``extract`` produce, for shard counts 1–8.
Errors are compared by message.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as JC
from repro.sparse import make_problem as jmake
from repro.sparse import plan as JPL
from repro_torch.convert import csr_from_numpy
from repro_torch.dist import collectives as TC
from repro_torch.sparse import plan as TPL
from repro_torch.sparse.csr import ELL

# the packages export the function ``halo_probe`` under the module's name
JH = importlib.import_module("repro.sparse.halo_probe")
TH = importlib.import_module("repro_torch.sparse.halo_probe")

torch.set_num_threads(2)

_OPS = {}


def _ops(name, n):
    """(reference CSR, port CSR on the CPU) of one problem, built once."""
    key = (name, n)
    if key not in _OPS:
        Aj, _ = jmake(name, n)
        At = csr_from_numpy(np.asarray(Aj.indptr), np.asarray(Aj.indices),
                            np.asarray(Aj.data), Aj.shape, device="cpu")
        if hasattr(Aj, "grid"):
            At.grid = Aj.grid
        _OPS[key] = (Aj, At)
    return _OPS[key]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _assert_probe_equal(pt, pj):
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)


def _assert_block_equal(bt, bj):
    for f in ("n", "n_pad", "n_local", "grid", "pgrid", "order",
              "n_boundary", "rounds", "wire_sizes"):
        assert getattr(bt, f) == getattr(bj, f), f
    for f in ("perm", "lcols", "vals"):
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert len(bt.send_idx) == len(bj.send_idx)
    for a, b in zip(bt.send_idx, bj.send_idx):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(_np(getattr(bt.operator, f)),
                                      _np(getattr(bj.operator, f)))


SHAPE_PROBLEMS = [("synth:stencil27", 512), ("synth:unstructured", 512),
                  ("synth:atmosmod", 1000)]


@pytest.mark.parametrize("name,n", SHAPE_PROBLEMS)
@pytest.mark.parametrize("shards", range(1, 9))
def test_halo_probe_block_partition_factor_pgrid(name, n, shards):
    Aj, At = _ops(name, n)
    _assert_probe_equal(TH.halo_probe(At, shards), JH.halo_probe(Aj, shards))
    _assert_probe_equal(TH.halo_probe(At, shards, max_halo_frac=0.05),
                        JH.halo_probe(Aj, shards, max_halo_frac=0.05))
    assert TH.grid_of(At) == JH.grid_of(Aj)
    grid = TH.grid_of(At) or (n, 1, 1)
    try:
        want = JH.candidate_pgrids(shards, grid)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:40]):
            TH.candidate_pgrids(shards, grid)
    else:
        assert TH.candidate_pgrids(shards, grid) == want
        assert TH.factor_pgrid(shards, grid) == JH.factor_pgrid(shards, grid)
        assert (TH.factor_pgrid(shards, grid, A=At)
                == JH.factor_pgrid(shards, grid, A=Aj))
    _assert_block_equal(TH.block_partition(At, shards),
                        JH.block_partition(Aj, shards))


def test_probe_of_ell_and_bare_operators():
    Aj, At = _ops("synth:unstructured", 512)
    Ej = Aj.to_ell()
    Et = ELL(torch.from_numpy(np.array(Ej.cols)),
             torch.from_numpy(np.array(Ej.vals)), tuple(Ej.shape))
    _assert_probe_equal(TH.halo_probe(Et, 4), JH.halo_probe(Ej, 4))

    class MatvecOnly:
        shape = (64, 64)

        def matvec(self, x):
            return x

    _assert_probe_equal(TH.halo_probe(MatvecOnly(), 4),
                        JH.halo_probe(MatvecOnly(), 4))
    with pytest.raises(ValueError) as ej:
        JH.block_partition(MatvecOnly(), 4)
    with pytest.raises(ValueError) as et:
        TH.block_partition(MatvecOnly(), 4)
    assert str(et.value) == str(ej.value)
    for bad in ((2, 2, 2), (1, 1, 3), (3, 3, 3)):
        with pytest.raises(ValueError) as ej:
            JH.block_partition(_ops("synth:stencil27", 512)[0], 4, pgrid=bad)
        with pytest.raises(ValueError) as et:
            TH.block_partition(_ops("synth:stencil27", 512)[1], 4, pgrid=bad)
        assert str(et.value) == str(ej.value)


def test_wire_byte_helpers_match_reference():
    for sizes in ((), (1,), (37, 37), (128, 129, 5000), (1259712,)):
        for compressed in (False, True):
            for dt, jt in ((torch.float64, jnp.float64),
                           (torch.float32, jnp.float32)):
                assert TC.exchange_bytes(sizes, compressed=compressed,
                                         dtype=dt) == JC.exchange_bytes(
                    sizes, compressed=compressed, dtype=jt)
    assert TC.halo_wire_spec(torch.float64).l == JC.halo_wire_spec(
        jnp.float64).l == 32
    assert TC.halo_wire_spec(torch.float32) == TC.WIRE_SPEC
    assert (TC.WIRE_SPEC.bs, TC.WIRE_SPEC.l) == (JC.WIRE_SPEC.bs,
                                                 JC.WIRE_SPEC.l)
    for n_local, shards in ((1, 1), (64, 8), (157464, 8)):
        assert TC.gather_bytes(n_local, shards) == JC.gather_bytes(
            n_local, shards)


def _plan_pair(name, n, shards, reorder, mode):
    Aj, At = _ops(name, n)
    try:
        pj = JPL.plan_operator(Aj, shards, reorder=reorder, matvec_mode=mode)
    except ValueError as e:
        with pytest.raises(ValueError) as et:
            TPL.plan_operator(At, shards, reorder=reorder, matvec_mode=mode)
        assert str(et.value) == str(e)
        return None, None
    return TPL.plan_operator(At, shards, reorder=reorder,
                             matvec_mode=mode), pj


@pytest.mark.parametrize("name,n", [("synth:unstructured", 512),
                                    ("synth:stencil27", 512)])
@pytest.mark.parametrize("reorder", ["auto", "rcm", "none"])
@pytest.mark.parametrize("mode", ["auto", "halo", "rows", "replicated",
                                  "block3d"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_plan_matches_reference(name, n, reorder, mode, shards):
    pt, pj = _plan_pair(name, n, shards, reorder, mode)
    if pt is None:
        return
    for f in ("n", "n_shards", "n_pad", "n_local", "requested_reorder",
              "requested_matvec", "reorder", "raw_bandwidth", "matvec_mode",
              "key", "pgrid"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("perm", "iperm"):
        a, b = getattr(pt, f), getattr(pj, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    _assert_probe_equal(pt.probe, pj.probe)
    assert (pt.block is None) == (pj.block is None)
    if pt.block is not None:
        _assert_block_equal(pt.block, pj.block)
    assert pt.describe() == pj.describe()
    assert pt.matvec_wire_sizes() == pj.matvec_wire_sizes()
    for compressed in (False, True):
        for dt, jt in ((torch.float64, jnp.float64),
                       (torch.float32, jnp.float32)):
            assert pt.matvec_wire_bytes(compressed=compressed, dtype=dt) == \
                pj.matvec_wire_bytes(compressed=compressed, dtype=jt)
    if pt.matvec_mode != "replicated":
        for a, b in zip(pt.ell_padded() + pt.ell_halo_localized(),
                        pj.ell_padded() + pj.ell_halo_localized()):
            np.testing.assert_array_equal(a, b)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(_np(getattr(pt.operator, f)),
                                      _np(getattr(pj.operator, f)))
    v = np.random.default_rng(shards).standard_normal((2, n))
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    et, ej = pt.embed(vt), pj.embed(vj)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(pt.extract(et).numpy(), v)
    np.testing.assert_array_equal(pt.permute(vt).numpy(),
                                  np.asarray(pj.permute(vj)))
    np.testing.assert_array_equal(pt.unpermute(pt.permute(vt)).numpy(), v)


def test_plan_validation_matches_reference():
    Aj, At = _ops("synth:atmosmod", 1000)
    for kw in (dict(reorder="bogus"), dict(matvec_mode="bogus")):
        with pytest.raises(ValueError) as ej:
            JPL.plan_operator(Aj, 2, **kw)
        with pytest.raises(ValueError) as et:
            TPL.plan_operator(At, 2, **kw)
        assert str(et.value) == str(ej.value)

    class MatvecOnly:
        shape = (64, 64)

        def matvec(self, x):
            return x

    with pytest.raises(ValueError) as ej:
        JPL.plan_operator(MatvecOnly(), 2, reorder="rcm")
    with pytest.raises(ValueError) as et:
        TPL.plan_operator(MatvecOnly(), 2, reorder="rcm")
    assert str(et.value) == str(ej.value)
    p = TPL.plan_operator(MatvecOnly(), 2, reorder="auto")
    assert p.matvec_mode == "replicated" and p.key[0] is None


def test_plan_cache_content_hit():
    """Rebuilding the same problem and planning again returns the same plan
    and the same operator object (the device driver's captured graphs read
    it by address); another shard count is another plan."""
    from repro_torch.sparse import make_problem

    A1, _ = make_problem("synth:unstructured", 512, device="cpu")
    p1 = TPL.plan_operator(A1, 1, reorder="rcm")
    A2, _ = make_problem("synth:unstructured", 512, device="cpu")
    assert A2 is not A1
    p2 = TPL.plan_operator(A2, 1, reorder="rcm")
    assert p2 is p1 and p2.operator is p1.operator
    assert TPL.plan_operator(A1, 4, reorder="rcm") is not p1
    assert p1.reorder == "rcm" and p1.probe.bandwidth < p1.raw_bandwidth
    # the permutation's index tensor is made once per device
    v = torch.ones(A1.shape[0], dtype=torch.float64)
    p1.permute(v)
    idx = p1._index("perm", "cpu")
    p1.permute(v)
    assert p1._index("perm", "cpu") is idx
    # unsharded auto leaves the operator alone
    p3 = TPL.plan_operator(A1, 1, reorder="auto")
    assert p3.reorder == "none" and p3.operator is A1 and p3.perm is None
