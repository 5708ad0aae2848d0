"""Bandwidth-reduction reordering: Reverse Cuthill-McKee over CSR/ELL.

The port of ``repro/sparse/reorder.py``: the same permutation, tie-break
for tie-break (``np.array_equal`` to the reference's).  A Reverse
Cuthill-McKee permutation of the adjacency graph pulls a sparse operator's
nonzeros toward the diagonal.  It is a pay-once-at-setup transform,
invisible to the iteration arithmetic (``P A Pᵀ (P x) = P b`` is the same
Krylov process in permuted coordinates), that changes what the SpMV
gathers: neighbouring rows then read neighbouring entries of ``x``.

Everything here is host numpy over the index arrays, read from the
operator's tensors with ``.cpu()``, so an operator already on the card
works; :func:`permute_csr` returns a port CSR on the input's device.

* :func:`rcm_permutation` — BFS-based RCM over the symmetrized sparsity
  pattern; returns ``perm`` with ``perm[new] = old``.
* :func:`permute_csr` — the symmetric permutation ``P A Pᵀ`` as a new
  :class:`~repro_torch.sparse.csr.CSR`.
* :func:`inverse_permutation` — ``iperm`` with ``iperm[old] = new``;
  vectors map in by ``v[perm]`` and back out by ``x[iperm]``.

The reference walks its breadth-first searches vertex by vertex in Python;
here each BFS level is one set of array operations, which visits the same
vertices in the same order: a level's vertices are claimed by the first
vertex of the previous level (in its order) adjacent to them, and each
claimer's vertices follow in ascending degree, ties in adjacency order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "inverse_permutation",
    "pattern_of",
    "permute_csr",
    "rcm_permutation",
]


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _device_of(A):
    for name in ("data", "vals", "indptr"):
        t = getattr(A, name, None)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def pattern_of(A):
    """Host-side ``(indptr, indices)`` of ``A``'s sparsity pattern.

    CSR exposes its index arrays directly; ELL contributes its live
    (``val != 0``) entries.  Returns ``None`` for operators without an
    inspectable pattern (bare-matvec objects): those cannot be reordered.
    """
    if hasattr(A, "indptr") and hasattr(A, "indices"):
        return _host(A.indptr).astype(np.int64), _host(A.indices)
    if hasattr(A, "cols") and hasattr(A, "vals"):
        cols = _host(A.cols)
        live = _host(A.vals) != 0
        indptr = np.zeros(A.shape[0] + 1, np.int64)
        np.cumsum(live.sum(axis=1), out=indptr[1:])
        return indptr, cols[live]
    return None


def _distinct(sorted_a: np.ndarray) -> np.ndarray:
    """Mask of the first of each run of equal values in a sorted array."""
    first = np.ones(sorted_a.size, bool)
    first[1:] = sorted_a[1:] != sorted_a[:-1]
    return first


def _unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by one sort (numpy 2.3's ``unique`` hashes first,
    which is an order of magnitude slower on tens of millions of keys)."""
    a = np.sort(a)
    return a[_distinct(a)]


def _first_occurrences(a: np.ndarray) -> np.ndarray:
    """``np.unique(a, return_index=True)[1]``: the index of the first
    occurrence of each distinct value, by value."""
    order = np.argsort(a, kind="stable")
    return order[_distinct(a[order])]


def _symmetric_adjacency(indptr, indices, n: int):
    """CSR adjacency of the symmetrized pattern ``A + Aᵀ`` (no self loops),
    each row's columns ascending: the reference's, from one sort of the
    pairs packed as ``row * n + col``."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, np.int64)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = _unique(r[keep] * n + c[keep])
    r, c = key // n, key % n
    adj_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=adj_indptr[1:])
    return adj_indptr, c


def _neighbors(adj_indptr, adj_indices, front):
    """The neighbour lists of ``front``'s vertices, concatenated in front
    order: ``(neighbours, position in front of each one's vertex)``."""
    starts = adj_indptr[front]
    counts = adj_indptr[front + 1] - starts
    first = np.cumsum(counts) - counts
    offs = np.arange(int(counts.sum())) - np.repeat(first, counts)
    return (adj_indices[np.repeat(starts, counts) + offs],
            np.repeat(np.arange(front.size), counts))


def _bfs_levels(adj_indptr, adj_indices, seed: int, component: np.ndarray):
    """Level sets of a BFS from ``seed`` restricted to ``component``.

    Returns ``(levels, last_level)`` where ``levels[v]`` is the BFS depth
    (-1 outside the component) and ``last_level`` the vertices at maximum
    depth, ascending — the candidates for a more peripheral seed.
    """
    n = adj_indptr.size - 1
    levels = np.full(n, -1, np.int64)
    levels[seed] = 0
    front = np.asarray([seed], np.int64)
    depth = 0
    while front.size:
        last = front
        nbrs, _ = _neighbors(adj_indptr, adj_indices, front)
        nxt = _unique(nbrs[(levels[nbrs] < 0) & component[nbrs]])
        depth += 1
        levels[nxt] = depth
        front = nxt
    return levels, last


def _pseudo_peripheral(adj_indptr, adj_indices, deg, seed: int,
                       component: np.ndarray) -> int:
    """George-Liu pseudo-peripheral vertex: walk to the far end of the graph.

    Repeated BFS from the current seed; if a minimum-degree vertex of the
    deepest level sits strictly farther out, move there and retry.
    """
    levels, last = _bfs_levels(adj_indptr, adj_indices, seed, component)
    ecc = int(levels.max())
    while True:
        cand = last[np.argsort(deg[last], kind="stable")[0]]
        levels, last = _bfs_levels(adj_indptr, adj_indices, int(cand),
                                   component)
        if int(levels.max()) <= ecc:
            return int(cand)
        ecc = int(levels.max())


def _cuthill_mckee_levels(adj_indptr, adj_indices, deg, seed: int,
                          visited: np.ndarray, order: np.ndarray,
                          pos: int) -> int:
    """Append the Cuthill-McKee order of ``seed``'s component to ``order``
    from ``pos``, marking it in ``visited``; returns the new ``pos``.

    One step per BFS level: a next-level vertex is claimed by the first
    vertex of the level adjacent to it (its first occurrence in the
    concatenated neighbour lists), and the claimed vertices are ordered by
    claimer, then degree, then adjacency position — the order in which the
    reference's queue appends them."""
    visited[seed] = True
    order[pos] = seed
    pos += 1
    front = np.asarray([seed], np.int64)
    while front.size:
        nbrs, parent = _neighbors(adj_indptr, adj_indices, front)
        idx = np.flatnonzero(~visited[nbrs])
        idx = idx[_first_occurrences(nbrs[idx])]
        nxt = nbrs[idx[np.lexsort((idx, deg[nbrs[idx]], parent[idx]))]]
        visited[nxt] = True
        order[pos:pos + nxt.size] = nxt
        pos += nxt.size
        front = nxt
    return pos


def rcm_permutation(A) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of ``A``'s symmetrized pattern.

    Seed each connected component at a George-Liu pseudo-peripheral vertex
    (found from a minimum-degree start), visit neighbours in
    ascending-degree order, and reverse the final visit order.

    Returns ``perm`` (dtype int64) with ``perm[new] = old``; apply it with
    :func:`permute_csr` / ``v[perm]``.  Raises ``ValueError`` for operators
    without an inspectable sparsity pattern.
    """
    pat = pattern_of(A)
    if pat is None:
        raise ValueError(
            f"RCM reordering needs an operator with an inspectable sparsity "
            f"pattern (CSR/ELL); got {type(A).__name__}")
    n = A.shape[0]
    adj_indptr, adj_indices = _symmetric_adjacency(*pat, n)
    deg = np.diff(adj_indptr)

    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    # global ascending-degree sweep yields the per-component starts
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        seed = _pseudo_peripheral(adj_indptr, adj_indices, deg, int(start),
                                  ~visited)
        pos = _cuthill_mckee_levels(adj_indptr, adj_indices, deg, seed,
                                    visited, order, pos)
        if pos == n:
            break
    return order[::-1].copy()


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """``iperm`` with ``iperm[perm[i]] = i`` — maps old indices to new."""
    perm = np.asarray(perm)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.size, dtype=perm.dtype)
    return iperm


def _csr_arrays(A):
    """Host ``(indptr, indices, data)`` of ``A`` — CSR directly, ELL via
    its live (``val != 0``) entries in row order."""
    if hasattr(A, "indptr"):
        return (_host(A.indptr).astype(np.int64), _host(A.indices),
                _host(A.data))
    cols = _host(A.cols)
    vals = _host(A.vals)
    live = vals != 0
    indptr = np.zeros(A.shape[0] + 1, np.int64)
    np.cumsum(live.sum(axis=1), out=indptr[1:])
    return indptr, cols[live], vals[live]


def permute_csr(A, perm):
    """Symmetric permutation ``P A Pᵀ`` of a CSR/ELL matrix (host-side).

    Row ``i`` of the result is row ``perm[i]`` of ``A`` with every column
    index ``c`` relabelled to ``iperm[c]``; columns are re-sorted within
    each row (stably: the reference's ``lexsort`` order), so the output is
    a normalized CSR on ``A``'s device (ELL inputs come back as CSR).
    Values keep their dtype: no arithmetic touches them.
    """
    from repro_torch.sparse.csr import CSR

    perm = np.asarray(perm, np.int64)
    n = A.shape[0]
    if perm.shape != (n,):
        raise ValueError(f"permutation length {perm.shape} != n {n}")
    iperm = inverse_permutation(perm)
    indptr, indices, data = _csr_arrays(A)

    counts = np.diff(indptr)[perm]
    new_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    # gather each permuted row's entry range in one vectorized index
    offs = np.arange(int(new_indptr[-1])) - np.repeat(new_indptr[:-1], counts)
    src = np.repeat(indptr[perm], counts) + offs
    new_indices = iperm[indices[src]]
    new_data = data[src]
    row_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
    order = np.argsort(row_ids * max(n, 1) + new_indices, kind="stable")
    dev = _device_of(A)
    return CSR(
        indptr=torch.as_tensor(new_indptr.astype(np.int32), device=dev),
        indices=torch.as_tensor(new_indices[order].astype(np.int32),
                                device=dev),
        data=torch.as_tensor(new_data[order], device=dev),
        shape=tuple(A.shape),
    )
