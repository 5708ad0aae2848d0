"""Roofline costs of a full cell from small probe cells + linear
extrapolation.

The port of ``repro/roofline/probe.py``.  The port's layers are Python
loops, so a full-depth count (``launch.dryrun.run_cell``) is already exact;
the probes earn their keep as cost: each traced op on a DTensor costs host
time, and counting 1 and 2 units keeps a 56-layer mixtral train cell at 512
fake ranks to seconds.  The extrapolation is linear in the loop trip
counts, which is exact for homogeneous stacks:

  inference:  cost(U)      = s + u·U
  training:   cost(U, mb)  = s + u·U + mb·(f + g·U)

U = structural units (layers / rounds), mb = gradient-accumulation factor.
Families with two structural axes (whisper's encoder/decoder, zamba2's
mamba-vs-shared-attention) get one extra probe to separate the marginals.

The full-depth run (``run_cell``) still provides the counted memory peak
and the multi-pod shardability proof; probes provide the cost terms.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.roofline.analysis import (HW_H100, RooflineReport,
                                           model_flops_for)

__all__ = ["probe_plan", "extrapolate", "units_of"]


def units_of(cfg: ArchConfig) -> int:
    """Structural unit count of the full config."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every   # rounds; tail via 3rd probe
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_every
    return cfg.num_layers


def _with_units(cfg: ArchConfig, units: int, mb: int,
                shape: ShapeConfig) -> ArchConfig:
    repl: dict[str, Any] = dict(unroll=True, microbatch=mb)
    if cfg.family == "hybrid":
        repl["num_layers"] = cfg.attn_every * units
    elif cfg.family == "vlm":
        repl["num_layers"] = cfg.cross_attn_every * units
    elif cfg.family == "encdec":
        repl["num_layers"] = units
        repl["encoder_layers"] = 1
    else:
        repl["num_layers"] = units
    if shape.seq_len > 8192 and not shape.is_decode:
        # bound the attention-block count for 32k prefill probes; attention
        # FLOPs are tile-size-independent, bytes shift slightly (coarser
        # logit materialization).
        repl["attn_chunk"] = 4096
        if cfg.family == "ssm":
            # mamba1 flops are chunk-size invariant: larger probe chunks
            # only bound the chunk count (256 -> 16 per layer)
            repl["ssm_chunk"] = 2048
        if cfg.family == "hybrid":
            # mamba2 SSD intra-chunk flops scale ~linearly with the chunk;
            # c=512 keeps probes tractable and overstates the intra term
            # by <= 4x of its (small) share.
            repl["ssm_chunk"] = 512
    return dataclasses.replace(cfg, **repl)


def probe_plan(cfg: ArchConfig, shape: ShapeConfig):
    """List of (tag, probe_cfg) to count.  Tags feed :func:`extrapolate`."""
    train = shape.kind == "train"
    plan = [("u1_m1", _with_units(cfg, 1, 1, shape)),
            ("u2_m1", _with_units(cfg, 2, 1, shape))]
    if train:
        plan += [("u1_m2", _with_units(cfg, 1, 2, shape)),
                 ("u2_m2", _with_units(cfg, 2, 2, shape))]
    if cfg.family == "encdec":
        # encoder marginal: (enc=2, dec=1) - (enc=1, dec=1)
        plan.append(("enc2", dataclasses.replace(
            _with_units(cfg, 1, 1, shape), encoder_layers=2)))
    if cfg.family == "hybrid":
        # shared-attention marginal: attn_every=3, L=6 -> 6 mamba + 2 attn
        plan.append(("attn2", dataclasses.replace(
            _with_units(cfg, 1, 1, shape), attn_every=cfg.attn_every // 2)))
    return plan


def _series(cfg: ArchConfig, shape: ShapeConfig, get, mb_real: int):
    """Extrapolate one scalar metric from the probe values ``get(tag)``."""
    U = units_of(cfg)
    c11, c21 = get("u1_m1"), get("u2_m1")
    if shape.kind == "train":
        c12, c22 = get("u1_m2"), get("u2_m2")
        f = c12 - c11                  # per-extra-microbatch @ U=1
        g = (c22 - c21) - f            # its per-unit slope
        u = (c21 - c11) - g            # per-unit @ "mb=1" baseline
        s = c11 - u - f - g
        val = s + u * U + mb_real * (f + g * U)
    else:
        u = c21 - c11
        val = (c11 - u) + u * U
    if cfg.family == "encdec":
        val += (get("enc2") - c11) * (cfg.encoder_layers - 1)
    if cfg.family == "hybrid":
        attn_marg = get("attn2") - c11
        round_marg = c21 - c11
        mamba_marg = (round_marg - attn_marg) / cfg.attn_every
        tail = cfg.num_layers - U * cfg.attn_every
        val += mamba_marg * tail
    return max(float(val), 0.0)


def extrapolate(cfg: ArchConfig, shape: ShapeConfig, probes: dict,
                *, chips: int, mb_real: int = 0, tp: int = 16,
                hw: dict = HW_H100) -> RooflineReport:
    """probes: tag -> dict(flops, bytes, coll, coll_by_op); see probe_plan."""
    from repro_torch.roofline.analytic import bytes_model as _bm

    mb_real = mb_real or cfg.microbatch
    flops = _series(cfg, shape, lambda t: probes[t]["flops"], mb_real)
    nbytes = _series(cfg, shape, lambda t: probes[t]["bytes"], mb_real)
    all_ops = sorted({op for p in probes.values()
                      for op in p.get("coll_by_op", {})})
    coll_ops = {
        op: _series(cfg, shape,
                    lambda t, op=op: float(
                        probes[t]["coll_by_op"].get(op, 0.0)),
                    mb_real)
        for op in all_ops
    }
    coll = float(sum(coll_ops.values()))
    return RooflineReport(
        flops=flops,
        bytes_hbm=nbytes,
        bytes_coll=coll,
        coll_by_op=coll_ops,
        t_compute=flops / hw["peak_flops"],
        t_memory=nbytes / hw["hbm_bw"],
        t_collective=coll / hw["link_bw"],
        model_flops=model_flops_for(cfg, shape) / chips,
        bytes_model=_bm(cfg, shape, chips=chips, tp=tp, mb=mb_real),
        hw=hw,
    )
