"""Building blocks: norms, RoPE, blocked attention, SwiGLU MLP, MoE.

Plain PyTorch: none of these is a TPU kernel in the JAX package, and the
matrix products stay ``torch.matmul``.  The MoE block is the reference's
grouped top-k dispatch with capacity (MaxText-style), its one-hot einsums
written as the exact gather and scatter they compute.  Attention for a
prompt is *blocked* (an online softmax over key chunks, in f32), so no
O(S²) logits buffer exists; the one new token of a decode step attends
through :func:`repro_torch.models.kvcache.attend` instead.  The layer loop is a
Python loop (``repro_torch.models.lm``), so the JAX package's
``scan_or_unroll`` has no counterpart.  Its activation-sharding constraints
do (``repro_torch.dist.act_sharding.constrain``, at the same places): the
identity outside the dry run's policy, and on plain tensors.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.dist.act_sharding import constrain, local_region

f32 = torch.float32

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "blocked_attention",
           "attention_block", "attention_qkv", "swiglu_block", "moe_block",
           "remat", "dots_saveable"]


def remat(cfg, fn, *args, policy: str | None = None):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (the reference's ``jax.checkpoint`` of a scan body) when
    ``cfg.remat`` and autograd records; a plain call otherwise (serving).

    ``policy`` (default ``cfg.remat_policy``) is the reference's: ``"dots"``
    keeps the outputs of the matrix products with no batch dimension
    (:func:`dots_saveable`, ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``) and recomputes everything else; any
    other value is full remat, which keeps nothing, as the reference
    treats it.  A full region inside a ``"dots"`` one (an SSM chunk, the
    reference's policy-less ``jax.checkpoint`` nested in the layer's)
    keeps nothing either: the outer policy saves none of its products."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    import torch.utils.checkpoint as ckpt

    if (policy or cfg.remat_policy) != "dots":
        return ckpt.checkpoint(_unsaved(fn), *args, use_reentrant=False)
    return ckpt.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     dots_saveable))


#: depth of the full-remat regions being run: none of their products is
#: kept by an enclosing ``"dots"`` region
_FULL_DEPTH = [0]


def _unsaved(fn):
    def run(*args):
        _FULL_DEPTH[0] += 1
        try:
            return fn(*args)
        finally:
            _FULL_DEPTH[0] -= 1
    return run


_aten = torch.ops.aten
#: matrix products as autograd hands them to the dispatcher: the operands'
#: position, and whether the product carries a leading batch dimension
_PRODUCTS = {_aten.mm.default: (0, False), _aten.addmm.default: (1, False),
             _aten.bmm.default: (0, True), _aten.baddbmm.default: (1, True)}


def dots_saveable(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy of :func:`remat`, for
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``: keep a
    matrix product's output where it has no batch dimension, recompute
    every other op (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``).

    The test is the product's batch size, not the op's name: ``x @ W``
    reaches the dispatcher as ``aten.mm`` and ``torch.einsum("bsd,df->bsf",
    x, W)`` as an ``aten.bmm`` of batch 1 (torch folds ``b`` and ``s``
    together), and both are the reference's dot_general with no batch
    dimension; an ``aten.bmm`` of batch ``b > 1`` (the attention tiles,
    the experts, the SSM chunks) has one."""
    from torch.utils.checkpoint import CheckpointPolicy

    spec = _PRODUCTS.get(op)
    if spec is None or _FULL_DEPTH[0]:
        return CheckpointPolicy.PREFER_RECOMPUTE
    pos, batched = spec
    if batched and args[pos].shape[0] != 1:
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(f32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(f32)).to(x.dtype)


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=64)
def _freqs_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` copied to ``device`` once: a copy from pageable
    host memory per call would wait for the card at every layer."""
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, hd) with positions broadcastable to x's (..., S): (S,)
    in prefill, (B, 1) in decode, where each row gets its own position.

    The JAX package's ``apply_rope`` broadcasts decode's (B, 1) positions
    against (B, 1, H, hd) to (B, B, H, hd), so its decode step rotates
    every row by row 0's position and appends B positions per row; the
    visible values are the same whenever all rows have one length, as in
    its ``serve`` and in every test that compares the two.
    """
    hd = x.shape[-1]
    freqs = _freqs_on(hd, theta, x.device)
    ang = positions[..., None].to(f32) * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_NEG = -1e30


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk_q: int = 1024, chunk_k: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention without an O(S²) buffer.

    q: (B, Sq, H, hd);  k, v: (B, Sk, Hkv, hd);  H = G * Hkv.
    Returns (B, Sq, H, hd) in q.dtype.  ``window`` > 0 masks keys older
    than ``window`` positions (sliding-window attention).  K and V are
    repeated over the group and the softmax runs in f32, as the JAX
    package's.
    """
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    v = constrain(v, "batch", None, "heads", None)
    # the tiles run per rank on its batch rows and heads under the dry
    # run's policy (DTensor's rule search over the tile products takes
    # minutes on a 3-d mesh); a plain call otherwise
    names = ("batch", None, "heads", None)
    return local_region(
        lambda q, k, v: _attention_tiles(q, k, v, causal, window, chunk_q,
                                         chunk_k, q_offset),
        names, (names, names, names))(q, k, v)


def _attention_tiles(q, k, v, causal: bool, window: int, chunk_q: int,
                     chunk_k: int, q_offset: int) -> torch.Tensor:
    """:func:`blocked_attention`'s online softmax over (query, key) tiles,
    K and V already repeated to q's heads."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    while Sq % cq:
        cq //= 2
    while Sk % ck:
        ck //= 2
    nq, nk = Sq // cq, Sk // ck
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for iq in range(nq):
        qi = q[:, iq * cq:(iq + 1) * cq].to(f32) * scale       # (B,cq,H,hd)
        qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
        o = torch.zeros((B, H, cq, hd), dtype=f32, device=dev)
        m = torch.full((B, H, cq), _NEG, dtype=f32, device=dev)
        l = torch.zeros((B, H, cq), dtype=f32, device=dev)
        for ik in range(nk):
            ki = k[:, ik * ck:(ik + 1) * ck].to(f32)          # (B,ck,H,hd)
            vi = v[:, ik * ck:(ik + 1) * ck].to(f32)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki)       # (B,H,cq,ck)
            kpos = ik * ck + torch.arange(ck, device=dev)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))              # (B,H,cq)
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vi)
            m = m_new
        o = o / l[..., None].clamp(min=1e-30)
        outs.append(o.transpose(1, 2))                        # (B,cq,H,hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_block(x: torch.Tensor, p: dict, cfg, *, positions,
                    kv_src=None, causal: bool = True, window: int = 0
                    ) -> torch.Tensor:
    """Pre-norm attention block.  ``kv_src`` switches to cross-attention."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    x = constrain(x, "batch", None, None)
    h = rms_norm(x, p["ln"])
    src = h if kv_src is None else kv_src
    B, S, _ = h.shape
    Sk = src.shape[1]
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (src @ p["wk"]).reshape(B, Sk, Hkv, hd)
    v = (src @ p["wv"]).reshape(B, Sk, Hkv, hd)
    if kv_src is None:                                        # self-attn: RoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=causal and kv_src is None,
                          window=window, chunk_q=cfg.attn_chunk,
                          chunk_k=cfg.attn_chunk)
    return x + o.reshape(B, S, H * hd) @ p["wo"]


def attention_qkv(h: torch.Tensor, p: dict, cfg, *, positions):
    """Projection-only path used by the decode cache (returns q, k, v)."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B = h.shape[0]
    q = (h @ p["wq"]).reshape(B, -1, H, hd)
    k = (h @ p["wk"]).reshape(B, -1, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, -1, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def swiglu_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    x = constrain(x, "batch", None, None)
    h = rms_norm(x, p["ln"])
    act = Fn.silu(h @ p["wg"]) * (h @ p["wi"])
    act = constrain(act, "batch", None, "mlp")
    return x + act @ p["wo"]


# ---------------------------------------------------------------------------
# MoE: grouped top-k dispatch with capacity
# ---------------------------------------------------------------------------


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    val, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int,
                    mask_dtype=torch.bfloat16):
    """gates (G, T, E) f32 -> the reference's dispatch and combine masks as
    the slots they fill: ``(expert, slot, keep, weight)``, each (G, T, k).

    The reference (``repro/models/layers.py::_top_k_dispatch``, vmapped over
    groups) builds one-hot (T, E, C) masks: choice ``s`` of token ``t`` goes
    to expert ``e = gidx[t, s]`` at slot ``c`` = the count of earlier
    choices of ``e`` (all tokens' first choices before any second choice:
    a cumsum over token order per choice), and is dropped where ``c >=
    capacity``; ``dispatch[t, e, c] = 1`` and ``combine[t, e, c]`` is the
    gate renormalized over the k chosen experts, rounded to ``mask_dtype``
    (bf16 even in an f32 model).  A token's k experts differ, so no two of
    its choices share an (e, c) entry, and each (e, c) holds at most one
    token: the masks are exactly ``(e, c, keep, weight)``."""
    G, T, E = gates.shape
    gval, gidx = _top_k(gates, k)                             # (G, T, k)
    gval = gval / gval.sum(-1, keepdim=True).clamp(min=1e-9)
    counts = torch.zeros((G, E), dtype=torch.int64, device=gates.device)
    slots, keeps = [], []
    for s in range(k):                                        # k <= 2
        m = Fn.one_hot(gidx[..., s], E)                       # (G, T, E)
        pos = torch.cumsum(m, dim=1) - m + counts[:, None, :]
        c = pos.gather(-1, gidx[..., s:s + 1])[..., 0]        # (G, T)
        slots.append(c)
        keeps.append(c < capacity)
        counts = counts + m.sum(1)
    slot = torch.stack(slots, -1)
    keep = torch.stack(keeps, -1)
    weight = gval.to(mask_dtype)
    return gidx, slot, keep, weight


def moe_capacity(cfg, T: int) -> tuple[int, int]:
    """(group size g, capacity) for T tokens, as the reference sizes them:
    g = ``min(moe_group, T)`` lowered until it divides T, capacity =
    ``ceil(g * k / E * capacity_factor)`` rounded up to 8, at least 8."""
    g = min(cfg.moe_group, T)
    while T % g:
        g -= 1
    capacity = int(math.ceil(g * cfg.top_k / cfg.num_experts
                             * cfg.capacity_factor))
    return g, max(8, -(-capacity // 8) * 8)


def expert_inputs(h: torch.Tensor, gidx, slot, keep, E: int,
                  capacity: int):
    """h (G, g, d) and :func:`_top_k_dispatch`'s slots -> (xin (G, E, C,
    d), row (G, g, k)).

    ``xin[g, e, c]`` is the hidden state of the token in slot (e, c), or
    zeros: what the reference's ``einsum("gtd,gtec->gecd", h, dispatch)``
    gives, a 0/1 mask times h summed with zeros, here a scatter of the
    kept tokens' rows.  ``row`` is each choice's row in the flat (G * E *
    C) slot space, the spare row past the end for a dropped choice."""
    ngroup, g, d = h.shape
    k = gidx.shape[-1]
    n_slots = ngroup * E * capacity
    grp = torch.arange(ngroup, device=h.device)[:, None, None]
    row = torch.where(keep, (grp * E + gidx) * capacity + slot, n_slots)
    xin = h.new_zeros((n_slots + 1, d))
    xin.index_copy_(0, row.reshape(-1),
                    h[:, :, None, :].expand(ngroup, g, k, d).reshape(-1, d))
    return xin[:n_slots].reshape(ngroup, E, capacity, d), row


# logical names of the MoE's per-group tensors: the groups batch-sharded
_G3 = ("batch", None, None)
_G4 = ("batch", None, None, None)


def moe_block(x: torch.Tensor, p: dict, cfg):
    """Grouped top-k MoE with SwiGLU experts.  Returns (out, aux_loss).

    x (B, S, d); ``p``: ``ln`` (d,), ``router`` (d, E) f32, ``wg``/``wi``
    (E, d, ff), ``wo`` (E, ff, d).  The expert products are batched
    matrix products over all (E, C) slots, as the reference's einsums;
    the combine gathers each token's k slot outputs and weights them in
    f32 (two products of a bf16 weight, so the order of the sum is moot),
    then rounds to the model's dtype.  The aux loss is the Switch
    load-balancing loss: mean gate times the fraction of tokens routed
    (kept) to each expert, summed over experts, times E.
    """
    x = constrain(x, "batch", None, None)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    g, capacity = moe_capacity(cfg, B * S)
    ngroup = B * S // g
    h = rms_norm(x, p["ln"]).reshape(ngroup, g, d)
    gates = torch.softmax(h.to(f32) @ p["router"].to(f32), dim=-1)

    def dispatch(h, gates):
        gidx, slot, keep, weight = _top_k_dispatch(gates, k, capacity)
        xin, row = expert_inputs(h, gidx, slot, keep, E, capacity)
        return xin, row, gidx, keep, weight

    # the dispatch and the combine index within each group: run per rank
    # on its groups under the dry run's policy (DTensor has no rule)
    xin, row, gidx, keep, weight = local_region(
        dispatch, [_G4, _G3, _G3, _G3, _G3], (_G3, _G3))(h, gates)
    xin = constrain(xin, "batch", "experts", None, None)
    act = (Fn.silu(torch.einsum("gecd,edf->gecf", xin, p["wg"]))
           * torch.einsum("gecd,edf->gecf", xin, p["wi"]))
    act = constrain(act, "batch", "experts", None, "mlp")
    hout = torch.einsum("gecf,efd->gecd", act, p["wo"])       # (G,E,C,d)

    def combine(hout, row, keep, weight, gidx):
        flat = hout.reshape(-1, d)
        picked = flat[row.clamp(max=flat.shape[0] - 1)]      # (G, g, k, d)
        w = torch.where(keep, weight.to(f32), 0.0)            # dropped: 0
        out = (picked.to(f32) * w[..., None]).sum(2).to(hout.dtype)
        G = gidx.shape[0]
        routed = torch.zeros((G, E), dtype=f32, device=hout.device)
        routed.scatter_add_(1, gidx.reshape(G, -1),
                            keep.reshape(G, -1).to(f32))
        return out, routed

    out, routed = local_region(combine, [_G3, ("batch", None)],
                               (_G4, _G3, _G3, _G3, _G3))(
        hout, row, keep, weight, gidx)
    me = gates.mean(dim=1)                                    # (G, E)
    aux = (me * (routed / g)).sum(-1).mean() * E
    return x + out.reshape(B, S, d), aux
