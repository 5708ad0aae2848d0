"""The dry run on the CPU: steps traced on meta DTensors over PyTorch's fake
process group, counted per device (``repro_torch.roofline.analysis``).

The fake group is process-global, so each world is a subprocess of its own
(``tests/_torch_dryrun_cases.py``), all four started together when the
module's first test asks for them:

* ``hand``: a hand-built program with known counts on a fake 2x2 mesh;
* ``flat`` / ``pod``: the ``reduced()`` config of every family, for train,
  prefill and decode, on 2x2 and on 2x2x2 with a ``pod`` dim: each cell
  builds and runs, and its argument bytes on a rank are the sum of its
  local shards;
* ``probes``: the probe-extrapolated FLOPs of the dense, MoE and SSM
  families at 4 layers equal their full-depth counts exactly;
* ``remat``: the reference ladder's last rung (internlm2-20b x train_4k on
  64x4, ``remat_policy="dots"``) at one layer, beside full remat.

The constrain call sites and the local regions (``dist.act_sharding``) are
identities outside a policy: serving and training give the same bits with
them as with plain calls (in this process, no fake group).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, get_arch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = ("hand", "flat", "pod", "probes", "remat")
#: seconds a world may take (each takes ~5-50 s alone on an 8-core host)
WORLD_S = 420
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_worlds")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = {w: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_cases.py"), w,
         str(out / f"{w}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for w in WORLDS}
    res = {}
    try:
        for w, p in procs.items():
            log, _ = p.communicate(timeout=WORLD_S)
            if p.returncode:
                res[w] = RuntimeError(f"world {w} exited {p.returncode}:\n"
                                      + log[-4000:])
            else:
                with open(out / f"{w}.json") as f:
                    res[w] = json.load(f)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _world(worlds, w):
    r = worlds[w]
    if isinstance(r, Exception):
        raise r
    return r


def test_sharded_matmul_counts_its_shard(worlds):
    r = _world(worlds, "hand")["sharded_mm"]
    assert r["flops"] == r["want"]          # global FLOPs / |model|
    assert "Shard(dim=1)" in r["placements"]


def test_replicated_matmul_counts_in_full(worlds):
    r = _world(worlds, "hand")["replicated_mm"]
    assert r["flops"] == r["want"]


def test_all_gather_records_its_local_shard(worlds):
    r = _world(worlds, "hand")["all_gather"]
    assert r["coll"] == {"all-gather": r["want"]}
    assert r["local"] == [64, 32]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", ["flat", "pod"])
def test_cell_runs_with_its_shards_as_arguments(worlds, mesh, arch, kind):
    r = _world(worlds, mesh)[f"{arch}/{kind}"]
    assert r["arg_bytes"] == r["want_args"]
    assert r["flops"] > 0 and r["bytes"] > 0 and r["temp"] > 0
    if kind == "train":
        # the gradients' reductions over the data-parallel dims
        assert r["coll"].get("all-reduce", 0) + r["coll"].get(
            "reduce-scatter", 0) > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b",
                                  "falcon-mamba-7b"])
def test_probe_flops_equal_the_full_depth_count(worlds, arch, kind):
    r = _world(worlds, "probes")[f"{arch}/{kind}"]
    assert r["probe"] == r["full"]


# ---------------------------------------------------------------------------
# the constrain call sites and local regions change no bit outside a policy
# ---------------------------------------------------------------------------


def _plain_sites(monkeypatch):
    """Every module's ``constrain`` and ``local_region`` as plain calls."""
    from repro_torch.models import kvcache, layers, lm, ssm

    for mod in (layers, lm, kvcache, ssm):
        if hasattr(mod, "constrain"):
            monkeypatch.setattr(mod, "constrain", lambda x, *names: x)
        if hasattr(mod, "local_region"):
            monkeypatch.setattr(mod, "local_region",
                                lambda fn, *a, **k: fn)


def _run(cfg):
    """Prefill, a decode step, and the loss and every gradient leaf."""
    from repro_torch.launch.serve import aux_for
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen)
    B, S = 2, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    aux = aux_for(cfg, B, gen)
    logits, cache = lm.prefill(params, cfg, tokens[:, :S], aux,
                               cache_len=S + 2)
    step, cache = lm.decode_step(params, cfg, cache, tokens[:, S])
    loss, grads = value_and_grad(params, cfg, {"tokens": tokens, **aux})
    return [logits, step, loss] + tree_leaves(cache) + tree_leaves(grads)


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "zamba2-7b",
                                  "whisper-medium"])
def test_sites_change_no_bit_outside_a_policy(arch, monkeypatch):
    cfg = get_arch(arch).reduced()
    with_sites = _run(cfg)
    _plain_sites(monkeypatch)
    plain = _run(cfg)
    assert len(with_sites) == len(plain)
    for a, b in zip(with_sites, plain):
        assert torch.equal(a, b)


def test_dots_remat_rung_keeps_more_and_recomputes_less(worlds):
    """The ladder's "dots_remat_64x4" rung on meta DTensors: selective
    checkpointing runs there, its counted peak a device is at or above
    full remat's (it keeps the products) and its FLOPs at or below (it
    recomputes none of them)."""
    r = _world(worlds, "remat")
    full, dots = r["full"], r["dots"]
    assert full["status"] == dots["status"] == "ok"
    assert full["microbatch"] == dots["microbatch"]
    assert dots["temp"] >= full["temp"]
    assert 0 < dots["flops"] < full["flops"]
