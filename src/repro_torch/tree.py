"""Nested dicts of tensors (weights, gradients, optimizer state), walked as
the JAX package walks its pytrees: dict keys in sorted order, an FRSZ2
``BlockCompressed`` as one leaf, or, where paths are asked for, as its two
children ``0`` (codes) and ``1`` (exponents), the JAX package's checkpoint
keys of a coded leaf.
"""
from __future__ import annotations

from repro_torch.core.frsz2 import BlockCompressed

__all__ = ["tree_map", "tree_leaves", "leaves_with_paths"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    in the same nested dicts; a ``BlockCompressed`` is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (sorted keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, tensor)`` in the JAX package's order, paths joined by
    ``/``; a ``BlockCompressed`` gives ``path/0`` (codes) and ``path/1``
    (exponents)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, BlockCompressed):
        return [(prefix + "0", tree.codes), (prefix + "1", tree.exps)]
    return [(prefix[:-1], tree)]
