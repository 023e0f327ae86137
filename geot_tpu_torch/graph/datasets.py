"""Synthetic graph generator and dataset shapes.

Port of `geot_tpu/graph/datasets.py:53-222` (`DATASET_SHAPES`,
`GraphData`, `synthetic_graph`, `synthetic_clustered_graph`): the same
numpy generator calls in the same order, so one seed gives the same arrays
as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["GraphData", "synthetic_graph", "synthetic_clustered_graph", "DATASET_SHAPES"]


@dataclasses.dataclass
class GraphData:
    """Host-side graph: COO edges (unsorted), features, labels, splits."""

    src: np.ndarray
    dst: np.ndarray
    num_nodes: int
    edge_weight: Optional[np.ndarray] = None
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


# (num_nodes, num_edges, feat_dim, num_classes) of the benchmark datasets,
# used to size synthetics.
DATASET_SHAPES: Dict[str, Tuple[int, int, int, int]] = {
    "cora": (2708, 10556, 1433, 7),
    "citeseer": (3327, 9104, 3703, 6),
    "pubmed": (19717, 88648, 500, 3),
    "amazon_photo": (7650, 238162, 745, 8),
    "ppi": (44906, 1226368, 50, 121),
    "flickr": (89250, 899756, 500, 7),
    "ogbn-arxiv": (169343, 1166243, 128, 40),
    "ogbl-collab": (235868, 1285465, 128, 2),
    "reddit2": (232965, 23213838, 602, 41),
    "ogbn-products": (2449029, 61859140, 100, 47),
    "rmat-s17": (131072, 2097152, 128, 0),
}


def synthetic_graph(
    num_nodes: int,
    num_edges: int,
    *,
    feat_dim: int = 0,
    num_classes: int = 0,
    power: float = 1.0,
    seed: int = 0,
    name: str = "synthetic",
) -> GraphData:
    """Power-law random graph: destination degrees follow ~Zipf(power),
    which gives the hub windows the nnz-balanced schedule must handle."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-power)
    cdf = np.cumsum(probs)
    cdf /= cdf[-1]
    # inverse-CDF sampling (rng.choice with p is slow at 10M+ draws)
    dst = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int32)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    x = y = None
    train = val = test = None
    if feat_dim:
        x = rng.standard_normal((num_nodes, feat_dim), dtype=np.float32)
    if num_classes:
        y, train, val, test = _splits(rng, num_nodes, num_classes)
    return GraphData(
        src=src, dst=dst, num_nodes=num_nodes, x=x, y=y,
        train_mask=train, val_mask=val, test_mask=test, name=name,
    )


def _splits(rng, num_nodes: int, num_classes: int):
    """Labels and the 60/20/20 train/val/test masks, drawn from `rng`."""
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    idx = rng.permutation(num_nodes)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    train = np.zeros(num_nodes, dtype=bool)
    val = np.zeros(num_nodes, dtype=bool)
    test = np.zeros(num_nodes, dtype=bool)
    train[idx[:n_tr]] = True
    val[idx[n_tr : n_tr + n_va]] = True
    test[idx[n_tr + n_va :]] = True
    return y, train, val, test


def synthetic_clustered_graph(
    num_nodes: int,
    num_edges: int,
    *,
    mixing: float = 0.3,
    mean_community: int = 2000,
    power: float = 1.0,
    feat_dim: int = 0,
    num_classes: int = 0,
    shuffle: bool = False,
    seed: int = 0,
    name: str = "synthetic-clustered",
) -> GraphData:
    """Degree-corrected planted-partition graph (community-structured), the
    graph family on which the stream census accepts streaming.

    Nodes fall into contiguous communities of lognormal sizes around
    `mean_community`; destination degrees follow Zipf(`power`) with the
    hubs spread over the communities; each edge's source is drawn from the
    destination's community with probability 1 - `mixing`, else uniformly.
    `shuffle` relabels the nodes at random. Labels are uniform at random,
    as in the reference."""
    rng = np.random.default_rng(seed)
    sizes = []
    total = 0
    while total < num_nodes:
        s = int(np.clip(rng.lognormal(np.log(mean_community), 0.8), 16, num_nodes))
        s = min(s, num_nodes - total)
        sizes.append(s)
        total += s
    sizes = np.asarray(sizes, np.int64)
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])

    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-power)
    cdf = np.cumsum(probs)
    cdf /= cdf[-1]
    # ranks permuted so hubs are spread across communities
    rank_of_node = rng.permutation(num_nodes)
    node_of_rank = np.argsort(rank_of_node)
    dst = node_of_rank[np.searchsorted(cdf, rng.random(num_edges))].astype(np.int32)

    comm = (np.searchsorted(offsets, dst, side="right") - 1).astype(np.int64)
    intra = rng.random(num_edges) >= mixing
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    lo = offsets[comm[intra]]
    span = sizes[comm[intra]]
    src[intra] = lo + (rng.random(int(intra.sum())) * span).astype(np.int64)
    src = src.astype(np.int32)

    if shuffle:
        perm = rng.permutation(num_nodes).astype(np.int32)
        src, dst = perm[src], perm[dst]

    x = y = None
    train = val = test = None
    if feat_dim:
        x = rng.standard_normal((num_nodes, feat_dim), dtype=np.float32)
    if num_classes:
        y, train, val, test = _splits(rng, num_nodes, num_classes)
    return GraphData(
        src=src, dst=dst, num_nodes=num_nodes, x=x, y=y,
        train_mask=train, val_mask=val, test_mask=test, name=name,
    )
