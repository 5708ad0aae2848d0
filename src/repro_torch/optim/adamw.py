"""AdamW with optional FRSZ2 block-compressed first and second moments.

The port of ``repro/optim/adamw.py``.  The optimizer state is the third
large write-once, read-once-a-step stream (after the Krylov basis and the
KV cache) that the paper's block format fits: with ``compress_state`` the
moments ``m`` and ``v`` of each leaf are held as FRSZ2 codes of the
flattened leaf (``bs`` 128, ``l`` 16, f32 values, nearest rounding), and
every update decodes each leaf whole, does the Adam arithmetic in f32 and
codes it whole again: a block is always written in full.  On the card the
decode and the code are kernels 2 and 1 (``kernels.ops.decompress`` and
``ops.compress``), two launches of each a leaf a step; on the CPU their
plain versions.  l = 16 codes halve the state against f32 (8 bytes a
parameter to a little over 4).

The arithmetic is the reference's, operation for operation in f32: global
norm clipping, bias correction, and decoupled weight decay on every leaf of
two or more dimensions as the weights hold it, so the layer-stacked (L, d)
norm scales decay too (the reference's rule, judged on the stacked leaf).
The step count stays on the host (a 0-d int32 tensor on the CPU), and the
learning rate and the bias corrections are computed there in f32 and
handed to the card's element-wise kernels as scalars, and the square root
is the correctly rounded one on both devices: a step on the card then
rounds every element as the same step on the CPU does (where the global
norm's sum leaves the clip's scale at 1), and reading the count never
waits for the card.  The coded path has no fallback: on the card a
``state_spec`` that kernels 1 and 2 do not take raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_state: bool = False        # FRSZ2-code m and v
    state_spec: F.FrszSpec = F.FrszSpec(bs=128, l=16, dtype=torch.float32,
                                        rounding="nearest")


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``decay_steps``; f32, on ``step``'s device."""
    step = torch.as_tensor(step)
    warm = cfg.peak_lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.minimum(warm, cfg.peak_lr * cos)


def _check_route(params: dict, cfg: AdamWConfig) -> None:
    """Coded moments on the card go through kernels 1 and 2 or not at all."""
    if (cfg.compress_state and not ops.kernel_supported(cfg.state_spec)
            and any(p.is_cuda for p in tree_leaves(params))):
        raise NotImplementedError(
            f"coded AdamW state {cfg.state_spec} has no kernel on the card "
            "(kernels 1 and 2 take aligned l <= 32 and bs dividing 128)")


def _compress_leaf(x: torch.Tensor, spec: F.FrszSpec) -> F.BlockCompressed:
    return ops.compress(x.reshape(-1), spec)


def _decompress_leaf(bc: F.BlockCompressed, shape) -> torch.Tensor:
    return ops.decompress(bc).reshape(shape)


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """``{"m", "v", "step"}``: zero moments in f32 (coded with
    ``compress_state``) over the params' tree, and step 0 (int32)."""
    _check_route(params, cfg)

    def zeros():
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                           device=p.device), params)
        if cfg.compress_state:
            z = tree_map(lambda x: _compress_leaf(x, cfg.state_spec), z)
        return z

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as the reference's (XLA's).
    CUDA's f32 ``sqrt`` is; PyTorch's vectorised CPU one is off by an ulp
    in about 0.6 % of values, so there the root goes through f64 (exact
    enough that its rounding to f32 is the root's)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(f32)


def _global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                          for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig):
    """One AdamW step -> (new params, new state, ``{"grad_norm", "lr"}``).

    Functional, as the reference: ``params`` and ``state`` are left as they
    were.  New params keep each leaf's dtype; the arithmetic is f32.
    """
    _check_route(params, cfg)
    step = state["step"].cpu()
    lr_t = lr_at(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    # f32 scalars from the host: a factor goes to the kernels as a Python
    # float (exact in f32); a divisor as a 0-d tensor on the card, filled
    # there, since CUDA divides by a host scalar as a product with its
    # reciprocal, which rounds otherwise
    t = (step + 1).to(f32)
    lr = float(lr_t)
    dev = gnorm.device
    bc1, bc2 = (torch.full((), float(1 - torch.tensor(b, dtype=f32) ** t),
                           dtype=f32, device=dev) for b in (cfg.b1, cfg.b2))

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        if cfg.compress_state:
            m = _decompress_leaf(m, g.shape)
            v = _decompress_leaf(v, g.shape)
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        del m, v
        delta = (m_new / bc1) / (_sqrt(v_new / bc2) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        pf = p.to(f32)
        p_new = (pf - lr * (delta + wd * pf)).to(p.dtype)
        if cfg.compress_state:
            m_new = _compress_leaf(m_new, cfg.state_spec)
            v_new = _compress_leaf(v_new, cfg.state_spec)
        return p_new, m_new, v_new

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    new_state = {"m": pick(1), "v": pick(2), "step": step + 1}
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr_t}
