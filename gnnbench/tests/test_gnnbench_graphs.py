"""The frozen generators give the program's generators' edges at a small
size, and the input processing is what the configurations say."""

import numpy as np

from geot_tpu_torch.graph import datasets
from gnnbench.harness.graphs import (_bidirect, cached_edges, make_edges, synthetic_clustered_graph,
                                     synthetic_graph)


def test_frozen_generators_equal_the_programs():
    src, dst = synthetic_graph(5000, 40000, power=1.0, seed=3)
    ref = datasets.synthetic_graph(5000, 40000, power=1.0, seed=3)
    assert np.array_equal(src, ref.src) and np.array_equal(dst, ref.dst)
    kw = dict(mixing=0.3, mean_community=200, power=1.0, seed=5)
    src, dst = synthetic_clustered_graph(20000, 100000, **kw)
    ref = datasets.synthetic_clustered_graph(20000, 100000, **kw)
    assert np.array_equal(src, ref.src) and np.array_equal(dst, ref.dst)
    assert src.dtype == dst.dtype == np.int32


def test_bidirect_dedups():
    src = np.array([0, 1, 1, 2, 2], np.int32)
    dst = np.array([1, 0, 0, 2, 0], np.int32)
    s, d = _bidirect(src, dst, 3)
    assert sorted(zip(s.tolist(), d.tolist())) == [(0, 1), (0, 2), (1, 0), (2, 0), (2, 2)]


def test_make_edges_and_its_cache(tmp_path):
    spec = {"generator": "synthetic", "num_nodes": 300, "num_edges": 2000, "power": 1.0,
            "seed": 0, "bidirect": True}
    src, dst, n = make_edges(spec)
    assert n == 300 and len(src) > 2000
    pairs = set(zip(src.tolist(), dst.tolist()))
    assert len(pairs) == len(src) and all((d, s) in pairs for s, d in pairs)
    a = cached_edges(spec, str(tmp_path))
    b = cached_edges(spec, str(tmp_path))
    assert not a[3] and b[3]
    assert np.array_equal(a[0], src) and np.array_equal(b[1], dst) and b[2] == n
