"""The port's roofline arithmetic and LM sharding rules against the JAX
package's, on the same configurations (no fake group: these are pure).

* ``bytes_model`` and ``model_flops_for`` equal the reference's (``==``)
  for every registry architecture x every ``SHAPES`` entry x (chips, tp) x
  KV format; ``decode_format_deltas`` equals ``benchmarks/lm_roofline.py``'s.
* ``probe_plan``'s tags and probe configs, and ``extrapolate`` on the same
  seeded probe dicts (the reference's ``HW_V5E`` values handed to both as a
  test-local dict), and ``RooflineReport``'s properties.
* ``logical_axes``, ``mesh_rules`` (16x16, 2x16x16, 2x2, 1x1),
  ``batch_axes`` and the placements of ``param_shardings`` /
  ``cache_shardings`` equal the reference's ``PartitionSpec``s (a spec
  entry ``a`` at dim ``i`` is ``Shard(i)`` on mesh dim ``a``; a tuple is
  ``Shard(i)`` on each of its dims), for every architecture.  The
  reference's rules read only ``mesh.shape``: its trees are built over a
  ``jax.sharding.AbstractMesh``, which needs no devices.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.dist import sharding as ref_sharding
from repro.launch.specs import abstract_cache as ref_abstract_cache
from repro.launch.specs import abstract_params as ref_abstract_params
from repro.models.config import SHAPES as REF_SHAPES
from repro.roofline import analysis as ref_analysis
from repro.roofline import analytic as ref_analytic
from repro.roofline import probe as ref_probe
from repro_torch.configs import ARCHS
from repro_torch.dist import sharding
from repro_torch.launch.specs import abstract_cache, abstract_params
from repro_torch.models.config import SHAPES
from repro_torch.roofline import analysis, analytic, probe, table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIPS_TP = [(256, 16), (512, 16), (4, 2), (1, 1)]
KV = ("bf16", "frsz2_16", "frsz2_8")
#: the reference's TPU v5e constants, as a test-local dict for both sides
#: (the port's collective term reads ``link_bw``, the reference's
#: ``ici_bw``)
HW_TEST = dict(name="test", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
               link_bw=50e9)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x1": {"data": 1, "model": 1}}


def _pair(name, kv=None):
    ref, port = REF_ARCHS[name], ARCHS[name]
    if kv:
        ref = dataclasses.replace(ref, kv_format=kv)
        port = dataclasses.replace(port, kv_format=kv)
    return ref, port


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_bytes_model_and_model_flops_equal_the_reference(name, shape):
    for kv in KV:
        ref, port = _pair(name, kv)
        rs, ps = REF_SHAPES[shape], SHAPES[shape]
        assert analysis.model_flops_for(port, ps) == \
            ref_analysis.model_flops_for(ref, rs)
        for chips, tp in CHIPS_TP:
            for mb in (0, 1, 3):
                assert analytic.bytes_model(port, ps, chips=chips, tp=tp,
                                            mb=mb) == \
                    ref_analytic.bytes_model(ref, rs, chips=chips, tp=tp,
                                             mb=mb), (kv, chips, tp, mb)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_methods_equal_the_reference(name):
    ref, port = _pair(name)
    assert port.active_param_count() == ref.active_param_count()
    assert port.param_count() == ref.param_count()
    assert port.sub_quadratic == ref.sub_quadratic
    assert port.is_attention_free == ref.is_attention_free
    for s in SHAPES:
        assert port.supports_shape(SHAPES[s]) == \
            ref.supports_shape(REF_SHAPES[s])


def _lm_roofline():
    spec = importlib.util.spec_from_file_location(
        "lm_roofline", os.path.join(ROOT, "benchmarks", "lm_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_format_deltas_equal_the_reference():
    ref = _lm_roofline().decode_format_deltas(verbose=False)
    assert table.decode_format_deltas(verbose=False) == ref


def test_table_reads_dry_run_rows(tmp_path, capsys):
    import json

    rows = [dict(arch="yi-9b", shape="decode_32k", status="fail",
                 mesh="16x16"),
            dict(arch="yi-9b", shape="decode_32k", status="ok", mesh="16x16",
                 arg_gib=1.0, temp_gib=2.0, dominant="memory"),
            dict(arch="yi-9b", shape="train_4k", status="ok", mesh="16x16",
                 probe=True, kv_format="frsz2_16", dominant="compute",
                 t_compute=1e-3, t_memory_floor=2e-4, t_collective=1e-4,
                 step_roofline_fraction=0.5),
            dict(arch="yi-9b", shape="long_500k", status="skip")]
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    got = table.run([str(path)], verbose=True)
    assert got == dict(full=1, probes=1, skips=1, fails=0)
    assert "yi-9b" in capsys.readouterr().out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_probe_plan_equals_the_reference(name, shape):
    ref, port = _pair(name)
    rp = ref_probe.probe_plan(ref, REF_SHAPES[shape])
    pp = probe.probe_plan(port, SHAPES[shape])
    assert [t for t, _ in pp] == [t for t, _ in rp]
    for (_, pc), (_, rc) in zip(pp, rp):
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert probe.units_of(port) == ref_probe.units_of(ref)


def _probes(plan, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for tag, _ in plan:
        coll = {"all-gather": float(rng.integers(1, 10**9)),
                "all-reduce": float(rng.integers(1, 10**9))}
        out[tag] = dict(flops=float(rng.integers(10**9, 10**13)),
                        bytes=float(rng.integers(10**8, 10**12)),
                        coll=sum(coll.values()), coll_by_op=coll)
    return out


def _report_fields(rep):
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
            if f.name not in ("hw", "memory_stats")}


_PROPS = ("t_memory_floor", "dominant", "t_bound", "useful_ratio",
          "roofline_fraction", "step_roofline_fraction")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_extrapolate_equals_the_reference(name, shape):
    ref, port = _pair(name)
    plan = ref_probe.probe_plan(ref, REF_SHAPES[shape])
    for seed in range(3):
        probes = _probes(plan, seed)
        for chips, tp in CHIPS_TP[:2]:
            kw = dict(chips=chips, tp=tp, mb_real=seed, hw=HW_TEST)
            r = ref_probe.extrapolate(ref, REF_SHAPES[shape], probes, **kw)
            p = probe.extrapolate(port, SHAPES[shape], probes, **kw)
            assert _report_fields(p) == _report_fields(r)
            for prop in _PROPS:
                assert getattr(p, prop) == getattr(r, prop), prop
            assert p.row() == r.row()


@pytest.mark.parametrize("seed", range(8))
def test_roofline_report_properties_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    f = dict(flops=float(rng.integers(0, 10**14)),
             bytes_hbm=float(rng.integers(0, 10**12)),
             bytes_coll=float(rng.integers(0, 10**10)),
             coll_by_op={"all-reduce": 1.0},
             t_compute=float(rng.random()), t_memory=float(rng.random()),
             t_collective=float(rng.random()),
             model_flops=float(rng.integers(0, 10**14)),
             bytes_model=float(rng.integers(0, 10**11)) if seed % 2 else 0.0)
    if seed == 0:
        f.update(flops=0.0, t_compute=0.0, t_memory=0.0, t_collective=0.0)
    r = ref_analysis.RooflineReport(**f, hw=HW_TEST)
    p = analysis.RooflineReport(**f, hw=HW_TEST)
    for prop in _PROPS:
        assert getattr(p, prop) == getattr(r, prop), prop
    assert p.row() == r.row()


def test_hw_h100_constants():
    hw = analysis.HW_H100
    assert (hw["peak_flops"], hw["hbm_bw"], hw["link_bw"]) == \
        (989e12, 3.35e12, 450e9)
    from repro_torch.launch import profile

    assert profile.HBM_BYTES_PER_S == 3.35e12
    assert profile.BF16_FLOPS == 989e12


def test_collective_bytes_sums_by_kind():
    got = analysis.collective_bytes([("all-gather", 8), ("all-reduce", 4),
                                     ("all-gather", 2)])
    assert got["all-gather"] == 10 and got["all-reduce"] == 4
    assert set(got) == set(analysis.COLLECTIVE_KINDS)
    assert sum(got.values()) == 14


# ---------------------------------------------------------------------------
# LM sharding rules
# ---------------------------------------------------------------------------


class _Stub:
    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_tree_specs(tree):
    """NamedSharding tree -> the same dicts of spec tuples."""
    if isinstance(tree, dict):
        return {k: _ref_tree_specs(v) for k, v in tree.items()}
    return tuple(tree.spec)


def _pad(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _placements_tree(specs, shapes, names):
    if isinstance(specs, dict):
        return {k: _placements_tree(specs[k], shapes[k], names)
                for k in specs}
    return sharding.spec_placements(_pad(specs, len(shapes.shape)), names)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_logical_axes_equal_the_reference(name):
    ref, port = _pair(name)
    ra = ref_sharding.logical_axes(ref_abstract_params(ref))
    pa = sharding.logical_axes(abstract_params(port))
    assert pa == ra
    # every big 2-D weight sharded on at least one dim
    params = abstract_params(port)

    def visit(p, a):
        if isinstance(p, dict):
            for k in p:
                visit(p[k], a[k])
        elif p.ndim >= 2 and p.numel() > 1e6:
            assert any(x is not None for x in a)
    visit(params, pa)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_rules_equal_the_reference(mesh):
    stub = _Stub(MESHES[mesh])
    for name in sorted(ARCHS):
        ref, port = _pair(name)
        assert sharding.mesh_rules(port, stub) == \
            ref_sharding.mesh_rules(ref, stub)
    r = sharding.mesh_rules(ARCHS["mixtral-8x22b"], _Stub(MESHES["16x16"]))
    assert r["experts"] is None and r["mlp"] == "model"
    r = sharding.mesh_rules(ARCHS["llama4-scout-17b-a16e"],
                            _Stub(MESHES["16x16"]))
    assert r["experts"] == "model" and r["mlp"] is None
    assert sharding.mesh_rules(ARCHS["granite-20b"],
                               _Stub(MESHES["16x16"]))["kv_heads"] is None


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_batch_axes_equal_the_reference(dp):
    stub = _Stub({"pod": 2, "data": dp, "model": 2})
    for B in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 256):
        got = sharding.batch_axes(stub, B)
        assert got == ref_sharding.batch_axes(stub, B)
        size = 1
        for a in got:
            size *= stub.shape[a]
        assert B % size == 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_and_cache_placements_equal_the_reference(name, mesh):
    ref, port = _pair(name)
    names = tuple(MESHES[mesh])
    am = AbstractMesh(tuple(MESHES[mesh].values()), names)
    stub = _Stub(MESHES[mesh])
    ref_p = ref_abstract_params(ref)
    want = _placements_tree(
        _ref_tree_specs(ref_sharding.param_shardings(ref, ref_p, am)),
        ref_p, names)
    assert sharding.param_shardings(port, abstract_params(port), stub) == \
        want
    for B, S in ((128, 4096), (1, 4096), (32, 2048)):
        ref_c = ref_abstract_cache(ref, B, S)
        want = _placements_tree(
            _ref_tree_specs(ref_sharding.cache_shardings(ref, ref_c, am, B)),
            ref_c, names)
        got = sharding.cache_shardings(port, abstract_cache(port, B, S),
                                       stub, B)
        assert got == want
