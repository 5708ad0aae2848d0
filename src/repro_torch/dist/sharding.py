"""Logical-axis sharding of the LM: per-parameter axes, per-arch mesh rules,
batch axes, and the DTensor placements they give.

The port of the LM half of ``repro/dist/sharding.py``:

  * :func:`logical_axes` walks a parameter tree (nested dicts) and names
    each dim with a *logical* axis ("vocab", "heads", "kv_heads", "mlp",
    "experts") or ``None`` -- purely structural, mesh-independent;
  * :func:`mesh_rules` maps logical names to *mesh* dims for one
    (architecture, mesh) pair, arbitrating expert-parallel vs
    tensor-parallel and dropping axes that do not divide (MQA's single KV
    head never shards; 8 experts never shard over a 16-way model axis);
  * :func:`param_shardings` / :func:`cache_shardings` combine the two into
    trees of DTensor placement tuples, one placement a mesh dim: a spec
    entry ``a`` at tensor dim ``i`` is ``Shard(i)`` on mesh dim ``a``, a
    tuple ``("pod", "data")`` is ``Shard(i)`` on both;
  * :func:`batch_axes` picks the data-parallel mesh dims ("pod", "data")
    whose product divides the global batch.

Every decision is a divisibility check on the mesh's dim sizes, so the
rules take a ``DeviceMesh`` or anything with a ``shape`` mapping of dim name
to size.  The solver's partition specs of the reference have no
counterpart: the sharded solve keeps each rank's chunk of its own
(``repro_torch.solver.sharded``).
"""
from __future__ import annotations

from typing import Any

__all__ = ["logical_axes", "mesh_rules", "batch_axes", "param_shardings",
           "cache_shardings", "spec_placements"]


def _mesh_shape(mesh) -> dict:
    """Dim name -> size, of a ``DeviceMesh`` or of a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# logical axes per parameter
# ---------------------------------------------------------------------------

# parent container names that distinguish the two meanings of wg/wi/wo
_ATTN_PARENTS = {"attn", "cross", "shared_attn"}
_MOE_PARENTS = {"moe"}


def _axes_for(path: tuple[str, ...], ndim: int) -> tuple:
    """Logical axis names for one parameter, aligned to its shape.

    Positions are assigned from the *trailing* dims so the leading
    layer-stack axis (and MoE's expert axis) fall out naturally.
    """
    key = path[-1]
    parents = set(path[:-1])
    ax: list = [None] * ndim

    def put(offset_from_end: int, name: str):
        i = ndim - offset_from_end
        if 0 <= i < ndim:
            ax[i] = name

    if key == "embed":
        put(2, "vocab")
    elif key == "unembed":
        put(1, "vocab")
    elif key == "router":
        put(1, "experts")
    elif key == "wq":
        put(1, "heads")
    elif key in ("wk", "wv"):
        put(1, "kv_heads")
    elif key in ("wg", "wi", "wo") and parents & _MOE_PARENTS:
        put(3, "experts")
        put(1 if key != "wo" else 2, "mlp")
    elif key == "wo" and parents & _ATTN_PARENTS:
        put(2, "heads")
    elif key in ("wg", "wi"):
        put(1, "mlp")
    elif key == "wo":
        put(2, "mlp")
    elif key in ("in_proj", "dt_proj", "conv_w"):
        put(1, "mlp")                       # SSM inner dim reuses the TP axis
    elif key in ("x_proj", "out_proj"):
        put(2, "mlp")
    elif key == "A_log" and ndim >= 3:
        put(2, "mlp")                       # mamba1: (L, d_inner, N)
    # everything else (norms, biases, gates, small state) stays replicated
    return tuple(ax)


def logical_axes(params, _path: tuple = ()) -> Any:
    """Tree of per-dim logical axis tuples, matching ``params``' dicts."""
    if isinstance(params, dict):
        return {k: logical_axes(v, _path + (k,)) for k, v in params.items()}
    return _axes_for(_path, len(params.shape))


# ---------------------------------------------------------------------------
# mesh rules per architecture
# ---------------------------------------------------------------------------


def _divides(n: int, size: int) -> bool:
    return n > 0 and size > 0 and n % size == 0


def mesh_rules(cfg, mesh) -> dict:
    """logical-name -> mesh dim (or None) for one (arch, mesh) pair.

    Arbitration: expert parallelism wins the "model" dim when the expert
    count divides it (llama4's 16 experts on a 16-way dim); otherwise the
    FFN inner dim shards as tensor parallelism (mixtral's 8 experts do not
    divide 16, so its wide d_ff shards instead).  Heads/KV-heads/vocab each
    shard iff they divide -- MQA (1 KV head) always replicates KV.
    """
    msz = _mesh_shape(mesh).get("model", 1)
    E = getattr(cfg, "num_experts", 0)
    ep = _divides(E, msz)
    inner = cfg.d_ff if cfg.d_ff else getattr(cfg, "d_inner", 0)
    return {
        "experts": "model" if ep else None,
        "mlp": "model" if (not ep and _divides(inner, msz)) else None,
        "heads": "model" if _divides(cfg.num_heads, msz) else None,
        "kv_heads": "model" if _divides(cfg.num_kv_heads, msz) else None,
        "vocab": "model" if _divides(cfg.vocab_size, msz) else None,
    }


def batch_axes(mesh, B: int) -> tuple:
    """Data-parallel mesh dims whose combined size divides ``B`` (greedy)."""
    shape = _mesh_shape(mesh)
    axes = []
    size = 1
    for a in ("pod", "data"):
        s = shape.get(a, 1)
        if s > 1 and B % (size * s) == 0:
            axes.append(a)
            size *= s
    return tuple(axes)


# ---------------------------------------------------------------------------
# partition specs and their placements
# ---------------------------------------------------------------------------


def spec_placements(spec: tuple, dim_names) -> tuple:
    """A partition spec (one entry a tensor dim: a mesh dim name, a tuple
    of names, or None) -> one placement a mesh dim: ``Shard(i)`` on every
    mesh dim that entry ``i`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dims = list(dim_names)
    out = [Replicate()] * len(dims)
    for i, a in enumerate(spec):
        for name in (a if isinstance(a, tuple) else (a,) if a else ()):
            out[dims.index(name)] = Shard(i)
    return tuple(out)


def _dim_names(mesh) -> tuple:
    return tuple(_mesh_shape(mesh))


def _partition_specs(cfg, params, mesh):
    """Tree of partition specs (tuples, one entry a dim) for a parameter
    tree: the reference's ``PartitionSpec`` entries of ``param_shardings``."""
    rules = mesh_rules(cfg, mesh)
    return _map_axes(lambda ax: tuple(rules.get(a) if a else None
                                      for a in ax), logical_axes(params))


def param_shardings(cfg, params, mesh):
    """Tree of DTensor placement tuples for a parameter tree (meta or
    concrete tensors)."""
    names = _dim_names(mesh)
    return _map_axes(lambda sp: spec_placements(sp, names),
                     _partition_specs(cfg, params, mesh))


def _map_axes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cache_specs(cache, mesh, B: int):
    """Tree of partition specs for a decode cache: the batch dim only.

    Cache leaves are ``(B,)`` (lengths) or ``(L, B, ...)`` stacked per
    layer; the batch dim is the first dim of size ``B`` among the leading
    two.  Everything else is replicated -- KV heads may not divide (MQA)
    and coded layouts must stay contiguous.
    """
    b_axes = batch_axes(mesh, B)
    bspec = tuple(b_axes) if b_axes else None

    def visit(leaf):
        spec = [None] * len(leaf.shape)
        for i in range(min(2, len(leaf.shape))):
            if leaf.shape[i] == B:
                spec[i] = bspec
                break
        return tuple(spec)

    return _map_axes(visit, cache)


def cache_shardings(cfg, cache, mesh, B: int):
    """Tree of DTensor placement tuples for a decode cache
    (:func:`_cache_specs`)."""
    names = _dim_names(mesh)
    return _map_axes(lambda sp: spec_placements(sp, names),
                     _cache_specs(cache, mesh, B))
