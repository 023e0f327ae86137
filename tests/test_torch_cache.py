"""The graph cache, the graph utilities, the datasets, the timing and
roofline helpers and the package's exports, against the JAX package.

- `save_graph` / `load_graph` round trips of a graph with every plan
  family (slot, BAT, bucketed, hybrid stream + remainder) and their
  schedules: every tensor and static equal, each schedule keyed to its
  loaded plan (none rebuilt), and `segment_spmm` over the loaded graph
  equal to the built graph's on every route. `cached_build` hits; a file
  of another version, of another layout or of the JAX package's format is
  a miss and is rebuilt. Files go under `tmp_path` with explicit knobs.
- `reorder` and `block_format` arrays equal to the reference's (and
  tests/test_block_format.py's checks, mirrored).
- `rmat_graph`, `synthetic_classification_graph` and `load_npz` (the
  karate and lesmis fixtures) bit-equal to the reference's; `get_dataset`.
- The `__all__` of the top level, graph, ops, models, native, tuning and
  compiler hold every name of the reference's.
- `cached_build` honours GEOT_GRAPH_CACHE_DIR ("off": no cache) and keys
  its files by the port's tuning-table fingerprint.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geot_tpu.graph as jgraph
import geot_tpu.ops as jops
from geot_tpu.graph import block_format as jbf
from geot_tpu.graph import cache as jcache
from geot_tpu.graph import datasets as jds
from geot_tpu.graph import reorder as jre
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.utils import roofline as jroof
import geot_tpu_torch.graph as tgraph
import geot_tpu_torch.ops as tops
from geot_tpu_torch.graph import block_format as tbf
from geot_tpu_torch.graph import cache as tcache
from geot_tpu_torch.graph import datasets as tds
from geot_tpu_torch.graph import reorder as tre
from geot_tpu_torch.graph.plan import _sched_key, row_schedule_of
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.tuning import heuristics as theur
from geot_tpu_torch.utils import roofline as troof
from geot_tpu_torch.utils.timing import timeit

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32)


def _full_graph(feature_hint=128):
    """A community-structured graph the census streams, with slot, BAT,
    bucketed and hybrid plans."""
    d = tds.synthetic_clustered_graph(1024, 24_000, mixing=0.1, mean_community=256, seed=0)
    w = np.random.default_rng(0).random(len(d.src)).astype(np.float32) + 0.1
    return tbuild_graph(d.src, d.dst, 1024, edge_weight=w, layouts=("bat", "slot", "stream"),
                        feature_hint=feature_hint, bucket_table_bytes=1, bucket_rows=300,
                        device="cpu", **TILES)


def _assert_same(a, b, path="g"):
    """Two graphs (or plans, schedules, values) equal field by field."""
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name == "key":
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple) and any(isinstance(x, torch.Tensor) or dataclasses.is_dataclass(x)
                                      for x in a):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}.{i}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
    else:
        assert a == b, path


def _schedules(g):
    plans = [g.plan, g.plan_t, g.bat, g.bat_t, g.bat_b, g.bat_b_t, g.hyb.rest, g.hyb_t.rest]
    return [p for p in plans if p is not None]


@pytest.fixture(scope="module")
def full_graph():
    return _full_graph()


def test_graph_roundtrip_every_family(full_graph, tmp_path):
    g = full_graph
    assert g.hyb is not None and g.bat_b is not None and g.plan is not None
    assert len({c[4] for c in g.bat_b.chunks}) > 1
    p = str(tmp_path / "g.npz")
    tcache.save_graph(g, p)
    g2 = tcache.load_graph(p, device="cpu")
    assert g2 is not None
    _assert_same(g, g2)
    assert g2.build_stats["row_schedule"].keys() == g.build_stats["row_schedule"].keys()
    assert {"bat_b", "bat_b_t", "hyb.rest", "plan", "bat"} <= set(g2.build_stats["row_schedule"])
    for p2 in _schedules(g2):  # keyed to the loaded plan's own tensors: none rebuilt
        assert p2.row_sched.matches(_sched_key(p2))
        assert row_schedule_of(p2) is p2.row_sched
    for sp, sp2 in zip(g.hyb.stream + g.hyb_t.stream, g2.hyb.stream + g2.hyb_t.stream):
        assert sp.fix_levels == sp2.fix_levels and torch.equal(sp.cols, sp2.cols)


def test_loaded_graph_runs_every_route_equal(full_graph, tmp_path):
    """segment_spmm (and its x gradient) over the loaded graph is equal to
    the built graph's on the hybrid, bucketed, bat_static, slot_static,
    bat_dyn and slot_dyn routes."""
    g = full_graph
    p = str(tmp_path / "g.npz")
    tcache.save_graph(g, p)
    g2 = tcache.load_graph(p, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1024, 24)).astype(np.float32))
    w = torch.from_numpy(rng.random(g.num_edges).astype(np.float32))
    seen = set()
    variants = [({}, {}), ({"hyb": None, "hyb_t": None}, {}),
                ({"hyb": None, "hyb_t": None, "bat_b": None, "bat_b_t": None}, {}),
                ({"hyb": None, "hyb_t": None, "bat_b": None, "bat_b_t": None, "prefer": "sr"},
                 {}), ({}, {"edge_weight": w}),
                ({"prefer_dyn": "sr"}, {"edge_weight": w})]
    for repl, kw in variants:
        outs = []
        for gg in (g, g2):
            gv = dataclasses.replace(gg, **repl)
            seen.add(tapi.dispatch_path(gv, dynamic_w="edge_weight" in kw))
            xx = x.clone().requires_grad_()
            out = tapi.segment_spmm(gv, xx, **kw)
            out.square().sum().backward()
            outs.append((out.detach(), xx.grad))
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert seen == {"hybrid", "bucketed", "bat_static", "slot_static", "bat_dyn", "slot_dyn"}


def test_cached_build_hits_and_misses(tmp_path):
    calls = []

    def build():
        calls.append(1)
        d = tds.synthetic_graph(300, 2500, seed=4)
        return tbuild_graph(d.src, d.dst, 300, layouts=("bat", "slot"), device="cpu", **TILES)

    g1 = tcache.cached_build("k1", build, cache_dir=str(tmp_path), device="cpu")
    g2 = tcache.cached_build("k1", build, cache_dir=str(tmp_path), device="cpu")
    assert len(calls) == 1
    assert g1.build_stats["cache"]["hit"] is False and g2.build_stats["cache"]["hit"] is True
    _assert_same(dataclasses.replace(g1, build_stats={}), dataclasses.replace(g2, build_stats={}))
    path = g2.build_stats["cache"]["path"]
    assert os.path.dirname(path) == str(tmp_path)

    # a file of another version, then one of another layout: each a miss,
    # rebuilt and written anew
    def rewrite(edit):
        with np.load(path, allow_pickle=False) as z:
            blobs = {k: z[k] for k in z.files}
        meta = json.loads(blobs["__meta__"].tobytes().decode())
        edit(meta)
        blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        with open(path, "wb") as fh:
            np.savez(fh, **blobs)

    def older(meta):
        meta["version"] = tcache.FORMAT_VERSION - 1

    def renamed(meta):
        f = meta["graph"]["fields"]["bat"]["fields"]
        f["old_name"] = f.pop("chunk_vblocks")

    for n_calls, edit in ((2, older), (3, renamed)):
        rewrite(edit)
        assert tcache.load_graph(path, device="cpu") is None
        g3 = tcache.cached_build("k1", build, cache_dir=str(tmp_path), device="cpu")
        assert len(calls) == n_calls and g3.build_stats["cache"]["hit"] is False
        assert tcache.load_graph(path, device="cpu") is not None


def _counting_build(calls):
    def build():
        calls.append(1)
        d = tds.synthetic_graph(300, 2500, seed=4)
        return tbuild_graph(d.src, d.dst, 300, layouts=("bat",), device="cpu", **TILES)
    return build


def test_cache_dir_variable_moves_the_cache(tmp_path, monkeypatch):
    """GEOT_GRAPH_CACHE_DIR moves the cache; an explicit cache_dir wins."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("GEOT_GRAPH_CACHE_DIR", str(tmp_path / "moved"))
    calls = []
    g1 = tcache.cached_build("kv", _counting_build(calls), device="cpu")
    g2 = tcache.cached_build("kv", _counting_build(calls), device="cpu")
    assert len(calls) == 1 and g2.build_stats["cache"]["hit"] is True
    assert os.path.dirname(g1.build_stats["cache"]["path"]) == str(tmp_path / "moved")
    g3 = tcache.cached_build("kv", _counting_build(calls), cache_dir=str(tmp_path / "given"),
                             device="cpu")
    assert len(calls) == 2 and os.path.dirname(g3.build_stats["cache"]["path"]) == str(
        tmp_path / "given")
    assert not (tmp_path / "home").exists()


@pytest.mark.parametrize("how", ["variable", "argument"])
def test_cache_off_builds_every_call_and_writes_nothing(tmp_path, monkeypatch, how):
    """"off" (the variable, or cache_dir) returns build_fn() each call and
    writes no file, the default directory included."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if how == "variable":
        monkeypatch.setenv("GEOT_GRAPH_CACHE_DIR", "off")
    else:
        monkeypatch.delenv("GEOT_GRAPH_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    calls = []
    for i in range(3):
        g = tcache.cached_build("koff", _counting_build(calls),
                                cache_dir="off" if how == "argument" else None, device="cpu")
        assert len(calls) == i + 1 and "cache" not in g.build_stats
    assert sorted(os.listdir(tmp_path)) == []


def test_cache_file_name_changes_with_the_table(tmp_path, monkeypatch):
    """The file name holds the port's table fingerprint: another table is
    another file, a miss; the same table again is a hit."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("GEOT_GRAPH_CACHE_DIR", raising=False)
    table = tmp_path / "table.json"
    calls, paths = [], []
    for content in ("{}", '{"spmm:0:0:0": {"mode": "bat", "e_tile": 64, "s_tile": 32, '
                    '"f_tile": 128}}', "{}"):
        table.write_text(content)
        monkeypatch.setenv(theur.TABLE_ENV, str(table))
        g = tcache.cached_build("kt", _counting_build(calls), cache_dir=str(tmp_path / "c"),
                                device="cpu")
        paths.append(g.build_stats["cache"]["path"])
    assert len(calls) == 2 and paths[0] == paths[2] != paths[1]
    assert theur.table_fingerprint() in paths[2]
    monkeypatch.setenv(theur.TABLE_ENV, str(tmp_path / "none.json"))
    assert theur.table_fingerprint() == "notable"


def test_jax_cache_file_is_a_miss(tmp_path):
    rng = np.random.default_rng(4)
    dst = np.sort(rng.integers(0, 300, 2500)).astype(np.int32)
    src = rng.integers(0, 300, 2500).astype(np.int32)
    jg = jbuild_graph(src, dst, 300, assume_sorted=True, layouts=("bat",), **TILES)
    p = str(tmp_path / "jax.npz")
    jcache.save_graph(jg, p)
    assert tcache.load_graph(p, device="cpu") is None


@pytest.mark.parametrize("seed", [0, 1])
def test_reorder_equal_jax(seed):
    d = jds.synthetic_clustered_graph(2000, 12_000, mixing=0.2, mean_community=64,
                                      shuffle=True, seed=seed)
    n = d.num_nodes
    for fn, kw in ((jre.rcm_order, {}), (jre.degree_order, {}),
                   (jre.degree_order, {"by": "dst"})):
        tfn = getattr(tre, fn.__name__)
        order = tfn(d.src, d.dst, n, **kw)
        np.testing.assert_array_equal(order, fn(d.src, d.dst, n, **kw))
        for a, b in zip(tre.apply_order(order, d.src, d.dst), jre.apply_order(order, d.src, d.dst)):
            np.testing.assert_array_equal(a, b)
        assert (tre.measure_window_dedup(d.src, d.dst, n, order=order, s_tile=64)
                == jre.measure_window_dedup(d.src, d.dst, n, order=order, s_tile=64))
    before = tre.measure_window_dedup(d.src, d.dst, n, s_tile=64)["dedup_ratio"]
    after = tre.measure_window_dedup(d.src, d.dst, n, s_tile=64,
                                     order=tre.rcm_order(d.src, d.dst, n))["dedup_ratio"]
    assert after > before


def _csr(rng, n_rows, n_cols, nnz):
    row = np.sort(rng.integers(0, n_rows, nnz).astype(np.int32))
    col = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    indptr = tgraph.coo_to_csr(torch.from_numpy(row), n_rows).numpy()
    return indptr, col, vals, row


@pytest.mark.parametrize("shape,window_rows,wide", [((37, 50, 300), 8, 16),
                                                    ((64, 100, 800), 16, 8),
                                                    ((30, 40, 0), 8, 16)])
def test_block_format_equal_jax(shape, window_rows, wide):
    """The arrays and stats equal the reference's; the blocks rebuild the
    dense matrix, widths are multiples of `wide`, and col_local points at
    each nonzero's column (tests/test_block_format.py's checks)."""
    rng = np.random.default_rng(shape[2])
    n_rows, n_cols, nnz = shape
    indptr, col, vals, row = _csr(rng, n_rows, n_cols, nnz)
    bf = tbf.csr_to_block_format(indptr, col, vals, window_rows=window_rows, wide=wide)
    jb = jbf.csr_to_block_format(indptr, col, vals, window_rows=window_rows, wide=wide)
    for f in dataclasses.fields(jb):
        a, b = getattr(bf, f.name), getattr(jb, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tbf.block_stats(bf, nnz) == jbf.block_stats(jb, nnz)
    widths = np.diff(bf.win_ptr)
    assert (widths % wide == 0).all() and (widths > 0).all()
    dense = np.zeros((n_rows, n_cols), np.float32)
    np.add.at(dense, (row, col), vals)
    for w in range(bf.n_windows):
        r0, r1 = w * window_rows, min((w + 1) * window_rows, n_rows)
        blk = bf.dense_block(w, indptr, col)
        cols_w = bf.col_ids[bf.win_ptr[w] : bf.win_ptr[w + 1]]
        real = len(np.unique(col[indptr[r0]:indptr[r1]]))
        rec = np.zeros((r1 - r0, n_cols), np.float32)
        for j, c in enumerate(cols_w[:real]):
            rec[:, c] += blk[:, j]
        np.testing.assert_allclose(rec, dense[r0:r1], atol=1e-6)
        for e in range(indptr[r0], indptr[r1]):
            assert bf.col_ids[bf.win_ptr[w] + bf.col_local[e]] == col[e]


def _same_data(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_rmat_and_classification_graphs_equal_jax():
    _same_data(tds.rmat_graph(13), jds.rmat_graph(13))
    _same_data(tds.rmat_graph(9, 8, seed=3, name="r"), jds.rmat_graph(9, 8, seed=3, name="r"))
    for kw in ({}, {"feat_dim": 12, "homophily": 0.7, "seed": 5}):
        _same_data(tds.synthetic_classification_graph(500, 4000, 5, **kw),
                   jds.synthetic_classification_graph(500, 4000, 5, **kw))


@pytest.mark.parametrize("name", ["karate", "lesmis"])
def test_load_npz_equal_jax(name):
    path = os.path.join(FIXTURES, f"{name}.npz")
    _same_data(tds.load_npz(path), jds.load_npz(path))


def test_get_dataset(tmp_path):
    for name in ("cora", "citeseer"):  # the two smallest: synthetic, no file
        _same_data(tds.get_dataset(name, data_dir=str(tmp_path)),
                   jds.get_dataset(name, data_dir=str(tmp_path)))
    _same_data(tds.get_dataset("karate", data_dir=FIXTURES), jds.get_dataset("karate",
                                                                              data_dir=FIXTURES))
    _same_data(tds.get_dataset("rmat-s10", data_dir=str(tmp_path)),
               jds.get_dataset("rmat-s10", data_dir=str(tmp_path)))
    with pytest.raises(KeyError):
        tds.get_dataset("no-such-graph", data_dir=str(tmp_path))


def test_roofline_and_timing():
    """The bytes models equal the reference's; the memory rate is the
    H100's by name and raises for a card not in the table (no TPU
    figure); timeit on the CPU."""
    for kw in ({}, {"weighted": False, "fused_gather": True}, {"dtype_bytes": 2}):
        assert troof.spmm_bytes(1000, 64, 300, 300, **kw) == jroof.spmm_bytes(
            1000, 64, 300, 300, **kw)
    assert troof.sddmm_bytes(1000, 48) == jroof.sddmm_bytes(1000, 48)
    assert troof.hbm_bandwidth_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    for card in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError):
            troof.hbm_bandwidth_gbps(card)
    frac = troof.roofline_fraction(1e-3, 3.35e9 / 2, device="NVIDIA H100 80GB HBM3")
    assert frac == pytest.approx(0.5)
    calls = []
    assert timeit(lambda: calls.append(1), warmup=2, iters=5, device="cpu") >= 0
    assert len(calls) == 7


def test_exports_cover_the_reference():
    """Every name of the reference's `__all__` is exported by the port's
    package of the same name: the top level, graph, ops, models, native,
    tuning (and its heuristics), compiler and parallel (and its
    dist_train)."""
    import geot_tpu
    import geot_tpu.compiler
    import geot_tpu.models
    import geot_tpu.native
    import geot_tpu.parallel
    import geot_tpu.parallel.dist_train
    import geot_tpu.tuning
    import geot_tpu.tuning.heuristics
    import geot_tpu_torch
    import geot_tpu_torch.compiler
    import geot_tpu_torch.models
    import geot_tpu_torch.native
    import geot_tpu_torch.parallel
    import geot_tpu_torch.parallel.dist_train
    import geot_tpu_torch.tuning
    import geot_tpu_torch.tuning.heuristics

    pairs = ((geot_tpu, geot_tpu_torch), (jgraph, tgraph), (jops, tops),
             (geot_tpu.models, geot_tpu_torch.models), (geot_tpu.native, geot_tpu_torch.native),
             (geot_tpu.tuning, geot_tpu_torch.tuning),
             (geot_tpu.tuning.heuristics, geot_tpu_torch.tuning.heuristics),
             (geot_tpu.compiler, geot_tpu_torch.compiler),
             (geot_tpu.parallel, geot_tpu_torch.parallel),
             (geot_tpu.parallel.dist_train, geot_tpu_torch.parallel.dist_train))
    for jmod, tmod in pairs:
        assert set(jmod.__all__) <= set(tmod.__all__), (tmod.__name__, sorted(
            set(jmod.__all__) - set(tmod.__all__)))
        for name in tmod.__all__:
            getattr(tmod, name)
    assert tops.reference.csr_spmm_ref is not None and jnp is not None
