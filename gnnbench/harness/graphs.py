"""The benchmark's graphs: frozen copies of the synthetic generators, the
input processing both sides receive, and a cache of the edge arrays.

`synthetic_graph` and `synthetic_clustered_graph` copy the edge part of
`geot_tpu_torch.graph.datasets` as it stood when the benchmark was
written (the same numpy calls in the same order, so one seed gives the
same edges), so that an edit to the program's generators cannot move the
yardstick. Features, labels and splits are not drawn here: the harness
makes them on the card from the run's seed.

A configuration's `graph` entry names the generator and its arguments;
`bidirect` adds each edge's reverse and drops duplicates (the DGL
ogbn-arxiv example's `to_bidirected`). The result is what the program is
handed; self-loops and the GCN norm are the program's to add (and the
reference's to work out again).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Tuple

import numpy as np

__all__ = ["synthetic_graph", "synthetic_clustered_graph", "make_edges", "cached_edges",
           "graph_key"]


def synthetic_graph(num_nodes: int, num_edges: int, *, power: float = 1.0,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 of a power-law random graph: destination degrees
    ~Zipf(power), sources uniform."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-power)
    cdf = np.cumsum(probs)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int32)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    return src, dst


def synthetic_clustered_graph(num_nodes: int, num_edges: int, *, mixing: float = 0.3,
                              mean_community: int = 2000, power: float = 1.0,
                              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 of a degree-corrected planted-partition graph:
    contiguous communities of lognormal sizes around `mean_community`,
    destination degrees ~Zipf(power) with the hubs spread over the
    communities, each source drawn from the destination's community with
    probability 1 - mixing, else uniformly."""
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
    rank_of_node = rng.permutation(num_nodes)
    node_of_rank = np.argsort(rank_of_node)
    dst = node_of_rank[np.searchsorted(cdf, rng.random(num_edges))].astype(np.int32)

    comm = (np.searchsorted(offsets, dst, side="right") - 1).astype(np.int64)
    intra = rng.random(num_edges) >= mixing
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    lo = offsets[comm[intra]]
    span = sizes[comm[intra]]
    src[intra] = lo + (rng.random(int(intra.sum())) * span).astype(np.int64)
    return src.astype(np.int32), dst


GENERATORS = {"synthetic": synthetic_graph, "clustered": synthetic_clustered_graph}


def _bidirect(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each edge and its reverse, duplicates dropped, in (dst, src) order."""
    s = np.concatenate([src, dst]).astype(np.int64)
    d = np.concatenate([dst, src]).astype(np.int64)
    key = np.unique(d * n + s)
    return (key % n).astype(np.int32), (key // n).astype(np.int32)


def make_edges(spec: Dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """(src, dst, num_nodes) of a configuration's `graph` entry."""
    gen = GENERATORS[spec["generator"]]
    args = {k: v for k, v in spec.items()
            if k not in ("generator", "num_nodes", "num_edges", "bidirect")}
    n = int(spec["num_nodes"])
    src, dst = gen(n, int(spec["num_edges"]), **args)
    if spec.get("bidirect"):
        src, dst = _bidirect(src, dst, n)
    return src, dst, n


def graph_key(spec: Dict) -> str:
    """A short name for a graph entry: its generator and a hash of it."""
    blob = json.dumps(spec, sort_keys=True).encode()
    return f"{spec['generator']}-{hashlib.sha256(blob).hexdigest()[:12]}"


def cached_edges(spec: Dict, cache_dir: str) -> Tuple[np.ndarray, np.ndarray, int, bool]:
    """`make_edges(spec)`, kept in `cache_dir` for later runs. Returns
    (src, dst, num_nodes, hit)."""
    path = os.path.join(cache_dir, f"edges-{graph_key(spec)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                return z["src"], z["dst"], int(z["num_nodes"]), True
        except (OSError, ValueError, KeyError):
            pass  # a torn file: make the edges again
    src, dst, n = make_edges(spec)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, src=src, dst=dst, num_nodes=np.int64(n))
    os.replace(tmp, path)
    return src, dst, n, False
