"""Dataset loaders and synthetic graph generators.

Port of `geot_tpu/graph/datasets.py` (`DATASET_SHAPES`, `GraphData`,
`load_npz`, `synthetic_graph`, `synthetic_clustered_graph`, `rmat_graph`,
`synthetic_classification_graph`, `get_dataset`): the same numpy
generator calls in the same order, so one seed gives the same arrays as
the JAX package. Nothing is downloaded: `get_dataset` reads a local
`.npz` or makes a synthetic graph of the dataset's shape.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["GraphData", "load_npz", "synthetic_graph", "synthetic_classification_graph",
           "synthetic_clustered_graph", "rmat_graph", "DATASET_SHAPES", "get_dataset"]


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
    # Graph500 RMAT scale 17, edge factor 16 (`rmat_graph`)
    "rmat-s17": (131072, 2097152, 128, 0),
}


def load_npz(path: str) -> GraphData:
    """A graph stored as an `.npz` of src, dst, num_nodes and optional
    edge_weight, x, y and the three split masks (no pickle)."""
    d = np.load(path, allow_pickle=False)
    return GraphData(
        src=d["src"].astype(np.int32),
        dst=d["dst"].astype(np.int32),
        num_nodes=int(d["num_nodes"]),
        edge_weight=d.get("edge_weight"),
        x=d.get("x"),
        y=d.get("y"),
        train_mask=d.get("train_mask"),
        val_mask=d.get("val_mask"),
        test_mask=d.get("test_mask"),
        name=os.path.splitext(os.path.basename(path))[0],
    )


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


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 1,
    name: Optional[str] = None,
) -> GraphData:
    """Graph500 RMAT graph (Kronecker generator) with the specification's
    (A, B, C, D) = (0.57, 0.19, 0.19, 0.05): 2**scale nodes and
    edge_factor * 2**scale directed edges, power-law degrees and
    self-similar community blocks. At each of `scale` levels every edge
    draws its row bit (0 with probability a + b) and then its column bit
    (0 with a / (a + b) in the top half, c / (c + d) in the bottom)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor << scale
    p_row = a + b
    d_ = 1.0 - a - b - c
    p_col_top = a / (a + b)
    p_col_bot = c / (c + d_)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        row = rng.random(m) >= p_row  # True: the lower half (bit 1)
        pc = np.where(row, p_col_bot, p_col_top)
        col = rng.random(m) >= pc
        dst = (dst << 1) | row
        src = (src << 1) | col
    return GraphData(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        num_nodes=n,
        name=name or f"rmat-s{scale}e{edge_factor}",
    )


def synthetic_classification_graph(
    num_nodes: int,
    num_edges: int,
    num_classes: int,
    *,
    feat_dim: Optional[int] = None,
    homophily: float = 0.9,
    feature_noise: float = 0.5,
    seed: int = 0,
    name: str = "synthetic-cls",
) -> GraphData:
    """Homophilous labeled graph for training-convergence tests: a share
    `homophily` of the edges join nodes of one class, and the features are
    a noisy one-hot of the class, so aggregating neighbours adds signal."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    by_class = [np.where(y == c)[0] for c in range(num_classes)]
    dst = rng.integers(0, num_nodes, size=num_edges).astype(np.int32)
    same = rng.random(num_edges) < homophily
    src = np.empty(num_edges, dtype=np.int32)
    rand_src = rng.integers(0, num_nodes, size=num_edges).astype(np.int32)
    for c in range(num_classes):
        sel = same & (y[dst] == c)
        pool = by_class[c]
        if len(pool):
            src[sel] = pool[rng.integers(0, len(pool), size=int(sel.sum()))]
        else:
            src[sel] = rand_src[sel]
    src[~same] = rand_src[~same]
    f = feat_dim or num_classes
    x = feature_noise * rng.standard_normal((num_nodes, f)).astype(np.float32)
    x[:, :num_classes] += np.eye(num_classes, dtype=np.float32)[y]
    idx = rng.permutation(num_nodes)
    n_tr, n_va = int(0.6 * num_nodes), int(0.2 * num_nodes)
    train = np.zeros(num_nodes, dtype=bool)
    val = np.zeros(num_nodes, dtype=bool)
    test = np.zeros(num_nodes, dtype=bool)
    train[idx[:n_tr]] = True
    val[idx[n_tr : n_tr + n_va]] = True
    test[idx[n_tr + n_va :]] = True
    return GraphData(
        src=src, dst=dst, num_nodes=num_nodes, x=x, y=y,
        train_mask=train, val_mask=val, test_mask=test, name=name,
    )


def get_dataset(name: str, data_dir: str = "data", seed: int = 0) -> GraphData:
    """`data_dir/{name}.npz` if it exists; else an RMAT graph for
    "rmat-s{scale}", or a synthetic graph of the dataset's shape (named
    "synthetic:{name}") for a name of DATASET_SHAPES. Raises KeyError for
    an unknown name."""
    path = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(path):
        return load_npz(path)
    if name.startswith("rmat-s"):
        return rmat_graph(int(name[len("rmat-s"):]))
    if name not in DATASET_SHAPES:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_SHAPES)}")
    n, e, f, c = DATASET_SHAPES[name]
    return synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=seed, name=f"synthetic:{name}")
