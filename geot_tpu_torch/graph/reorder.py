"""Node reordering for gather locality, host side.

Port of `geot_tpu/graph/reorder.py` (numpy only, copied so the port
imports nothing of the JAX package): the arrays equal the reference's.

  * `rcm_order`: reverse Cuthill-McKee over the symmetrized adjacency
    (bandwidth reduction: each window's sources cluster).
  * `degree_order`: hub-first degree sort (the hot rows in a contiguous
    prefix).
  * `apply_order` / `measure_window_dedup`: relabel a COO edge list, and
    the dedup ratio of sources per destination window, before or after
    (`graph.block_format.block_stats` reports the same ratio from the
    block format).

Reordering is a one-time host transform, like a plan: relabel the nodes,
build the Graph on the new ids, and permute the feature and label rows
with the returned order.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "rcm_order",
    "degree_order",
    "apply_order",
    "measure_window_dedup",
]


def _csr_sym(src: np.ndarray, dst: np.ndarray, n: int):
    """Symmetrized CSR adjacency (indptr, indices) without self loops."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keep = s != d
    s, d = s[keep], d[keep]
    order = np.lexsort((d, s))
    s, d = s[order], d[order]
    # dedup parallel edges
    if len(s):
        head = np.empty(len(s), bool)
        head[0] = True
        head[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        s, d = s[head], d[head]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, s + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, d


def rcm_order(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering. Returns `order` with
    order[new_id] = old_id (use `apply_order` to relabel).

    BFS from a minimum-degree node of each component, visiting neighbors
    in increasing-degree order, then reversed."""
    n = int(num_nodes)
    indptr, indices = _csr_sym(
        np.asarray(src, np.int64), np.asarray(dst, np.int64), n
    )
    deg = np.diff(indptr)
    visited = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    pos = 0
    # component seeds in min-degree order
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        q = deque([int(seed)])
        while q:
            u = q.popleft()
            out[pos] = u
            pos += 1
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                q.extend(int(v) for v in nbrs)
    assert pos == n
    return out[::-1].copy()


def degree_order(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, by: str = "src"
) -> np.ndarray:
    """Hub-first ordering by degree (src out-degree by default): hot
    source rows land in a contiguous prefix of the feature matrix."""
    deg = np.zeros(num_nodes, np.int64)
    np.add.at(deg, np.asarray(src if by == "src" else dst, np.int64), 1)
    return np.argsort(-deg, kind="stable")


def apply_order(
    order: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relabel a COO edge list under `order` (order[new] = old).

    Returns (new_src, new_dst, inv) with inv[old] = new — permute node
    features as `x_new = x[order]` and map external node ids through
    `inv`."""
    n = len(order)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return inv[np.asarray(src, np.int64)], inv[np.asarray(dst, np.int64)], inv


def measure_window_dedup(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    s_tile: int = 256,
    order: Optional[np.ndarray] = None,
) -> dict:
    """Dedup ratio of sources per destination window: edges / distinct
    (window, src) pairs. Above 1 a kernel that stages each window's source
    rows reads fewer rows than there are edges; near 1 the gather is
    already minimal."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if order is not None:
        src, dst, _ = apply_order(order, src, dst)
    win = dst // s_tile
    key = win * (int(num_nodes) + 1) + src
    uniq = len(np.unique(key))
    nnz = len(src)
    return dict(
        nnz=nnz,
        unique_pairs=uniq,
        dedup_ratio=nnz / max(uniq, 1),
        windows=int(win.max()) + 1 if nnz else 0,
    )
