"""Meta-device stand-ins of a cell's inputs, and its sharded step.

The port of ``repro/launch/specs.py``.  ``abstract_params``,
``abstract_opt_state`` and ``abstract_cache`` build the tensors each step
consumes on the ``meta`` device (shapes and dtypes, nothing allocated), and
:func:`build_cell` turns them into DTensors over a ``DeviceMesh`` (each
rank's local shard, on ``meta``), so running the step traces the whole
(architecture x input shape x mesh) cell in one process without a single
weight in memory: a 141B-parameter mixtral cell runs on a laptop.

``build_cell`` returns a :class:`CellSpec` for the three step kinds:
  train   -- loss and gradients over the microbatched global batch, then
             the AdamW update (``launch.train.make_step``'s step)
  prefill -- bulk prompt processing producing the compressed KV cache
  decode  -- one-token serve step against a full (compressed) cache

The step runs under the activation-sharding policy
(``dist.act_sharding.use``) and DTensor's implicit replication (the
model's constants -- positions, masks, accumulators -- are plain tensors,
the same on every rank), and redistributes its outputs to the cell's out
placements before it returns: DTensor keeps a reduction ``Partial`` until
asked, so without that a cell would count none of its pending all-reduces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist import act_sharding
from repro_torch.dist.sharding import (
    batch_axes,
    cache_shardings,
    mesh_rules,
    param_shardings,
    spec_placements,
)
from repro_torch.launch.mesh import fold_pod
from repro_torch.launch.train import value_and_grad
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig, ShapeConfig, torch_dtype
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_map

__all__ = ["build_cell", "abstract_params", "abstract_opt_state",
           "abstract_cache", "make_train_step", "to_dtensor", "CellSpec"]

META = torch.device("meta")


def abstract_params(cfg: ArchConfig) -> dict:
    """The weights' shapes and dtypes on the meta device."""
    return lm.init_params(cfg, lm.META)


def abstract_opt_state(cfg: ArchConfig, opt: AdamWConfig) -> dict:
    return adamw_init(abstract_params(cfg), opt)


def abstract_cache(cfg: ArchConfig, B: int, S: int) -> dict:
    return lm.init_decode_cache(cfg, B, S, device=META)


def _aux(cfg: ArchConfig, B: int) -> dict:
    dt = torch_dtype(cfg.dtype)
    aux = {}
    if cfg.family == "encdec":
        aux["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=dt, device=META)
    if cfg.family == "vlm":
        aux["image_embeds"] = torch.empty(
            (B, cfg.num_image_tokens, cfg.d_model), dtype=dt, device=META)
    return aux


def to_dtensor(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t``'s global shape and dtype, its local shard (rank
    0's) on the meta device."""
    return act_sharding.sharded(t.shape, mesh, placements, lambda s:
                                torch.empty(s, dtype=t.dtype, device=META))


def _dtensors(tree, shardings, mesh):
    return tree_map(lambda t, pl: to_dtensor(t, mesh, pl), tree, shardings)


@dataclasses.dataclass
class CellSpec:
    step: Any                    # python callable over ``args``; its
                                 # outputs land on the cell's placements
    args: tuple                  # DTensors (meta local shards), positional
    meta: dict = dataclasses.field(default_factory=dict)


def _microbatch(x, mbs: int, i: int, dp: int):
    """Microbatch ``i`` of ``mbs`` of a batch-sharded tensor, as a slice of
    every data-parallel rank's rows: rank r's rows ``[i n, (i + 1) n)`` of
    its B / dp (n = B / (dp mbs)), so that each rank slices its own shard
    (the reference's contiguous slices would move rows between ranks).
    With ``dp`` = 1 the reference's rows."""
    B, *rest = x.shape
    return x.reshape(dp, mbs, B // (dp * mbs), *rest)[:, i].reshape(
        B // mbs, *rest)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig, microbatch: int,
                    dp: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, stats): the loss
    and its gradients (``launch.train.value_and_grad``) summed in f32 over
    ``microbatch`` slices of the batch (:func:`_microbatch`), then one AdamW
    update, as ``launch.train.make_step``."""

    def step(params, opt_state, batch):
        if microbatch == 1:
            loss, grads = value_and_grad(params, cfg, batch)
        else:
            grads = loss = None
            for i in range(microbatch):
                mb_loss, g = value_and_grad(
                    params, cfg, {k: _microbatch(v, microbatch, i, dp)
                                  for k, v in batch.items()})
                g = tree_map(lambda x: x.to(torch.float32), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = mb_loss if loss is None else loss + mb_loss
            grads = tree_map(lambda a: a / microbatch, grads)
            loss = loss / microbatch
        params2, opt_state2, stats = adamw_update(grads, opt_state, params,
                                                  opt)
        stats["loss"] = loss
        return params2, opt_state2, stats

    return step


def _redistribute(out, placements, mesh):
    """Each DTensor of ``out`` moved to its placements (``None``: as it
    is); the tree of ``placements`` follows ``out``'s dicts and tuples."""
    from torch.distributed.tensor import DTensor

    if placements is None:
        return out
    if isinstance(out, dict):
        return {k: _redistribute(v, placements.get(k), mesh)
                for k, v in out.items()}
    if isinstance(out, (tuple, list)) and not _is_placements(placements):
        return type(out)(_redistribute(o, p, mesh)
                         for o, p in zip(out, placements))
    if isinstance(out, DTensor) and tuple(out.placements) != placements:
        return out.redistribute(mesh, placements)
    return out


def _is_placements(p) -> bool:
    from torch.distributed.tensor.placement_types import Placement

    return isinstance(p, tuple) and all(isinstance(x, Placement) for x in p)


def _with_policy(fn, mesh, rules, out_placements):
    """The step under the activation-sharding policy and implicit
    replication, its outputs redistributed to ``out_placements``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.fx.experimental import _config as fx_config

    def wrapped(*args):
        # a masked partial (a vocab-sharded embedding or gather) zeroes its
        # masked rows by a boolean index, whose count of rows the meta
        # device cannot know: it is taken as all of them
        with act_sharding.use(mesh, rules), implicit_replication(), \
                fx_config.patch(meta_nonzero_assume_all_nonzero=True):
            out = fn(*args)
            return _redistribute(out, out_placements, mesh)

    return wrapped


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               opt: AdamWConfig | None = None) -> CellSpec:
    """The cell's step and its DTensor arguments on ``mesh`` (a multi-pod
    mesh runs folded: ``launch.mesh.fold_pod``)."""
    mesh = fold_pod(mesh)
    B, S = shape.global_batch, shape.seq_len
    b_axes = batch_axes(mesh, B)
    bspec = tuple(b_axes) if b_axes else None
    dims = tuple(mesh.mesh_dim_names)
    shape_of = dict(zip(dims, tuple(mesh.shape)))
    dp = math.prod(shape_of[a] for a in b_axes)
    repl = spec_placements((), dims)
    act_rules = dict(mesh_rules(cfg, mesh))
    act_rules["batch"] = bspec

    def batch_pl(t):
        return spec_placements((bspec,) + (None,) * (t.ndim - 1), dims)

    params_m = abstract_params(cfg)
    p_sh = param_shardings(cfg, params_m, mesh)
    params = _dtensors(params_m, p_sh, mesh)
    logits_sh = spec_placements((bspec, act_rules["vocab"]), dims)

    if shape.kind == "train":
        opt = opt or AdamWConfig()
        # microbatch count: keep per-device microbatch tokens bounded
        mb = min(cfg.microbatch, max(B // dp, 1))
        while B % mb or (B // mb) % dp:
            mb -= 1
        opt_m = abstract_opt_state(cfg, opt)
        o_sh = {"m": param_shardings(cfg, opt_m["m"], mesh),
                "v": param_shardings(cfg, opt_m["v"], mesh)}
        opt_state = {"m": _dtensors(opt_m["m"], o_sh["m"], mesh),
                     "v": _dtensors(opt_m["v"], o_sh["v"], mesh),
                     "step": opt_m["step"]}
        batch = {"tokens": torch.empty((B, S + 1), dtype=torch.int32,
                                       device=META)}
        batch.update(_aux(cfg, B))
        batch = {k: to_dtensor(v, mesh, batch_pl(v))
                 for k, v in batch.items()}
        out_pl = (p_sh, {"m": o_sh["m"], "v": o_sh["v"]},
                  {"grad_norm": repl, "lr": repl, "loss": repl})
        step = _with_policy(make_train_step(cfg, opt, mb, dp), mesh,
                            act_rules, out_pl)
        return CellSpec(step=step, args=(params, opt_state, batch),
                        meta=dict(kind="train", microbatch=mb, tokens=B * S))

    if shape.kind == "prefill":
        tokens = to_dtensor(torch.empty((B, S), dtype=torch.int32,
                                        device=META), mesh,
                            spec_placements((bspec, None), dims))
        aux = {k: to_dtensor(v, mesh, batch_pl(v))
               for k, v in _aux(cfg, B).items()}
        c_sh = cache_shardings(cfg, abstract_cache(cfg, B, S), mesh, B)
        out_pl = (logits_sh, c_sh)

        def step(params, tokens, aux_in):
            return lm.prefill(params, cfg, tokens, aux_in)

        return CellSpec(step=_with_policy(step, mesh, act_rules, out_pl),
                        args=(params, tokens, aux),
                        meta=dict(kind="prefill", tokens=B * S))

    # decode / long_decode: one new token against an S-token cache
    cache_m = abstract_cache(cfg, B, S)
    c_sh = cache_shardings(cfg, cache_m, mesh, B)
    cache = _dtensors(cache_m, c_sh, mesh)
    tokens = to_dtensor(torch.empty((B,), dtype=torch.int32, device=META),
                        mesh, spec_placements((bspec,), dims))
    out_pl = (logits_sh, c_sh)

    def step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens)

    return CellSpec(step=_with_policy(step, mesh, act_rules, out_pl),
                    args=(params, cache, tokens),
                    meta=dict(kind=shape.kind, tokens=B))
