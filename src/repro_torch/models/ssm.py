"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

The port of ``repro/models/ssm.py``.  None of these is a TPU kernel in the
JAX package (it computes them with ``lax.scan`` and ``associative_scan``),
so they are plain PyTorch ops on tensors, as ``layers.py``:

* **Mamba1** runs the selective scan chunk by chunk, a chunk of ``c``
  positions at a time (the reference's chunk rule: ``c = min(ssm_chunk,
  L)``, lowered until it divides L, so a prime length runs one position a
  chunk).  Inside a chunk the recurrence ``h_t = exp(dt_t A) h_{t-1} +
  dt_t x_t B_t`` runs position by position, one fused multiply-add over
  the (B, d_inner, N) state each, out of place (autograd keeps each
  position's state for the gradient of the next), then the chunk's states
  are stacked; the reference's associative scan gives the same values up
  to the order of its f32 roundings.
* **Mamba2** is the SSD block-matrix form, as the reference: the masked,
  decay-weighted ``C Bᵀ`` product inside a chunk, the carried state's
  contribution, and the decay-to-end weighted state update, with the
  reference's ``1e-37`` clamp on the prefix decay.

Each chunk, and the causal conv, runs per rank on its local shards under
the dry run's sharding policy (``dist.act_sharding.local_region``), a
plain call otherwise.  Under autograd with ``cfg.remat`` (the default) each chunk of
either
block is recomputed in the backward (``layers.remat``), the reference's
chunk-level ``jax.checkpoint``: the backward holds one chunk's states at a
time, not every chunk's.  The chunk's remat is full under every
``remat_policy``, as the reference's carries no policy.

A decode step is the same function at L = 1, with the carried state ``h0``
and the conv state as left context, which the caller writes back in place.
There is no KV cache: the paper's compression has no written-once,
re-read-many stream to act on in a pure SSM (``repro/models/ssm.py``'s
note).
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.dist.act_sharding import local_region
from repro_torch.models.layers import remat, rms_norm

f32 = torch.float32

# logical names of the scan chunks' and the conv's tensors, which run per
# rank on their local shards under the dry run's policy (DTensor's rule
# search over the chunk's products takes minutes on a 3-d mesh; some
# versions' DTensor cannot pad a sharded tensor): the batch sharded, and
# Mamba1's inner dim (the conv's channels) over the tensor-parallel dim
# where it divides
_BDN = ("batch", "mlp", None)
_BLD = ("batch", None, "mlp")
_BLN = ("batch", None, None)
_B4 = ("batch", None, None, None)

__all__ = ["causal_conv", "mamba1_seq", "mamba1_decode", "mamba2_seq",
           "mamba2_decode"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _chunk(L: int, chunk: int) -> int:
    """The reference's chunk length: ``min(chunk, L)``, lowered until it
    divides L."""
    c = min(chunk, L)
    while L % c:
        c -= 1
    return c


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                state: torch.Tensor | None = None):
    """Depthwise causal conv along axis 1.  x (B, L, C); w (W, C); b (C).

    With ``state`` (B, W-1, C) as left context (a decode step; works for L
    == 1), else zeros.  Returns (out in x's dtype, the new state: the last
    W-1 rows of the context and x).  Summed in f32 tap by tap, as the
    reference.
    """
    names = None if state is None else _BLD
    return local_region(_causal_conv, [_BLD, _BLD],
                        (_BLD, (None, "mlp"), ("mlp",),
                         names))(x, w, b, state)


def _causal_conv(x, w, b, state):
    """:func:`causal_conv` on a rank's channels (all of them outside the
    dry run's policy)."""
    B, L, C = x.shape
    W = w.shape[0]
    xp = (Fn.pad(x, (0, 0, W - 1, 0)) if state is None
          else torch.cat([state.to(x.dtype), x], dim=1))
    out = torch.zeros((B, L, C), dtype=f32, device=x.device)
    for i in range(W):                                        # W ~ 4
        out = out + xp[:, i:i + L].to(f32) * w[i].to(f32)
    out = out + b.to(f32)
    new_state = xp[:, L:] if W > 1 else x.new_zeros((B, 0, C))
    return out.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def _mamba1_chunk(hprev, dt, xi, Bm, Cm, A):
    """One chunk of the selective scan: ``h_t = exp(dt_t A) h_{t-1} + dt_t
    x_t B_t`` position by position from ``hprev`` (B, di, N), then ``y_t =
    h_t C_t``.  -> (the last state, y (B, c, di) f32)."""
    dtc = dt.to(f32)                                          # (B, c, di)
    a = torch.exp(dtc[..., None] * A)                         # (B,c,di,N)
    bx = ((dtc * xi.to(f32))[..., None]
          * Bm[:, :, None, :].to(f32))                        # (B,c,di,N)
    hs = []
    for t in range(dtc.shape[1]):
        hprev = torch.addcmul(bx[:, t], a[:, t], hprev)
        hs.append(hprev)
    y = torch.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1), Cm.to(f32))
    return hprev, y


def mamba1_seq(x: torch.Tensor, p: dict, cfg, *, h0=None, conv_state=None,
               return_state: bool = False):
    """Mamba1 over a sequence.  x (B, L, d) -> (B, L, d).

    ``h0`` (B, di, N) f32 and ``conv_state`` (B, W-1, di) carry decode
    state; with ``return_state`` also returns (h at the last position,
    the new conv state).
    """
    B, L, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, d // 16)
    h = rms_norm(x, p["ln"])
    xi, z = (h @ p["in_proj"]).chunk(2, dim=-1)               # (B, L, di)
    xi, conv_state = causal_conv(xi, p["conv_w"], p["conv_b"],
                                 state=conv_state)
    xi = Fn.silu(xi)
    dt_r, Bm, Cm = (xi @ p["x_proj"]).split([dt_rank, N, N], dim=-1)
    # a bf16 product plus the f32 bias: f32, as JAX promotes it
    dt = _softplus(dt_r @ p["dt_proj"] + p["dt_bias"])        # (B, L, di)
    A = -torch.exp(p["A_log"].to(f32))                        # (di, N)

    c = _chunk(L, cfg.ssm_chunk)
    hprev = (torch.zeros((B, di, N), dtype=f32, device=x.device)
             if h0 is None else h0)
    chunk = local_region(_mamba1_chunk, [_BDN, _BLD],
                         (_BDN, _BLD, _BLD, _BLN, _BLN, ("mlp", None)))
    ys = []
    for s in range(0, L, c):
        hprev, y = remat(cfg, chunk, hprev, dt[:, s:s + c],
                         xi[:, s:s + c], Bm[:, s:s + c], Cm[:, s:s + c], A,
                         policy="full")
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]        # (B, L, di)
    y = y + xi.to(f32) * p["D"].to(f32)
    y = y * Fn.silu(z.to(f32))
    out = x + (y.to(x.dtype) @ p["out_proj"])
    if return_state:
        return out, (hprev, conv_state)
    return out


def mamba1_decode(x: torch.Tensor, p: dict, cfg, state):
    """Single-token step.  x (B, 1, d); state = (h (B, di, N), conv (B,
    W-1, di)) -> (out, (h, conv))."""
    h0, conv_state = state
    return mamba1_seq(x, p, cfg, h0=h0, conv_state=conv_state,
                      return_state=True)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def _segsum(loga: torch.Tensor) -> torch.Tensor:
    """loga (..., c) -> (..., c, c) with out[i, j] = sum_{j<k<=i} loga[k],
    -inf above the diagonal."""
    c = loga.shape[-1]
    cum = torch.cumsum(loga, dim=-1)
    dif = cum[..., :, None] - cum[..., None, :]               # sum_(j,i]
    tri = torch.ones((c, c), dtype=torch.bool, device=loga.device).tril()
    return dif.masked_fill(~tri, float("-inf"))


def _mamba2_chunk(hprev, xk, dk, lak, Bm, Cm):
    """One SSD chunk from the carried state ``hprev`` (B, Hs, P, N): xk (B,
    c, Hs, P), dt and log-decay (B, c, Hs), B and C (B, c, N).  -> (the
    state after the chunk, y (B, c, Hs, P) f32)."""
    Bk, Ck = Bm.to(f32), Cm.to(f32)
    # intra-chunk: masked decay-weighted "attention"
    Lmat = torch.exp(_segsum(lak.transpose(1, 2)))            # (B,Hs,c,c)
    scores = torch.einsum("bin,bjn->bij", Ck, Bk)             # (B, c, c)
    M = scores[:, None] * Lmat
    xdt = xk.to(f32) * dk[..., None]                          # (B,c,Hs,P)
    y_intra = torch.einsum("bhij,bjhp->bihp", M, xdt)
    # inter-chunk: the carried state, decayed to each position
    pref = torch.exp(torch.cumsum(lak, dim=1))                # (B, c, Hs)
    y_inter = torch.einsum("bin,bhpn->bihp", Ck, hprev) * pref[..., None]
    # state update: decay-to-end weighted outer products
    total = pref[:, -1]                                       # (B, Hs)
    suff = total[:, None] / torch.clamp(pref, min=1e-37)
    hnew = (total[..., None, None] * hprev
            + torch.einsum("bin,bihp->bhpn", Bk, xdt * suff[..., None]))
    return hnew, y_intra + y_inter


def mamba2_seq(x: torch.Tensor, p: dict, cfg, *, h0=None, conv_state=None,
               return_state: bool = False):
    """Mamba2 SSD over a sequence.  x (B, L, d) -> (B, L, d).

    ``h0`` (B, Hs, P, N) f32 and ``conv_state`` (B, W-1, di) carry decode
    state, as for :func:`mamba1_seq`.
    """
    B, L, d = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    Hs = di // P
    h = rms_norm(x, p["ln"])
    z, xi, Bm, Cm, dt_r = (h @ p["in_proj"]).split([di, di, N, N, Hs],
                                                   dim=-1)
    xi, conv_state = causal_conv(xi, p["conv_w"], p["conv_b"],
                                 state=conv_state)
    xi = Fn.silu(xi)
    dt = _softplus(dt_r.to(f32) + p["dt_bias"])               # (B, L, Hs)
    A = -torch.exp(p["A_log"].to(f32))                        # (Hs,)
    loga = dt * A

    c = _chunk(L, cfg.ssm_chunk)
    hprev = (torch.zeros((B, Hs, P, N), dtype=f32, device=x.device)
             if h0 is None else h0)
    chunk = local_region(_mamba2_chunk, [_B4, _B4],
                         (_B4, _B4, _BLN, _BLN, _BLN, _BLN))
    ys = []
    for s in range(0, L, c):
        hprev, y = remat(cfg, chunk, hprev,
                         xi[:, s:s + c].reshape(B, c, Hs, P), dt[:, s:s + c],
                         loga[:, s:s + c], Bm[:, s:s + c], Cm[:, s:s + c],
                         policy="full")
        ys.append(y)
    y = (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]).reshape(B, L, di)
    y = y + xi.to(f32) * p["D"].to(f32).repeat_interleave(P)
    y = rms_norm(y.to(x.dtype), p["out_ln"]) * Fn.silu(z)
    out = x + y.to(x.dtype) @ p["out_proj"]
    if return_state:
        return out, (hprev, conv_state)
    return out


def mamba2_decode(x: torch.Tensor, p: dict, cfg, state):
    """Single-token step.  x (B, 1, d); state = (h (B, Hs, P, N), conv (B,
    W-1, di)) -> (out, (h, conv))."""
    h0, conv_state = state
    return mamba2_seq(x, p, cfg, h0=h0, conv_state=conv_state,
                      return_state=True)
