"""The products GCN cell's program side and readers, on the CPU.

A small copy of `gnnbench/configs/ogbn-products-gcn.json` (its own small
clustered, bidirected Zipf(0.5) graph) runs through the benchmark's
harness against the plain reference (`gnnbench/reference/gcn.py`), train
and serve, within the configuration's own limits, every aggregation on the
hybrid route (streamed cells plus the BAT remainder), and the TF32 control
and the planted faults fail those limits. The counter record
holds each direction's split of a hybrid graph, built or loaded from a
file, and nothing of a graph without hybrid plans; the readers
`stream_ms`, `rest_ms` and `stream_edge_share` read a fake context and
None where their inputs are absent; the hybrid route's two spans are
recorded under the profiler, forward and backward, and never entered
without one. Over the plain versions of the kernels; imports no JAX."""

import json
import os
import shutil
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import geot_tpu_torch.ops.api as api  # noqa: E402
import geot_tpu_torch.utils.trace as trace  # noqa: E402
from geot_tpu_torch.graph.cache import load_graph, save_graph  # noqa: E402
from geot_tpu_torch.models import prepare_graph  # noqa: E402
from geot_tpu_torch.ops.api import dispatch_path, segment_spmm  # noqa: E402
from geot_tpu_torch.utils.trace import counter_record  # noqa: E402
from gnnbench.control import readings  # noqa: E402
from gnnbench.harness import correct as cmp  # noqa: E402
from gnnbench.harness import system  # noqa: E402
from gnnbench.harness.cell import run_cell  # noqa: E402
from gnnbench.harness.graphs import make_edges  # noqa: E402
from gnnbench.harness.manifest import load_cell, metric_reader  # noqa: E402

CONFIG = os.path.join(ROOT, "gnnbench", "configs", "ogbn-products-gcn.json")
# ~23% of the edges left to the BAT remainder, near the full graph's 31%
SMALL_GRAPH = {"generator": "clustered", "num_nodes": 3000, "num_edges": 15000, "mixing": 0.3,
               "mean_community": 300, "power": 0.5, "seed": 0, "bidirect": True}
SEED = 2**31 + 23
KEYS = ("stream.forward.streamed_edges", "stream.forward.edges",
        "stream.transpose.streamed_edges", "stream.transpose.edges")


def _checkout(tmp: str) -> str:
    """A checkout in `tmp`: BENCHMARK.json with a small copy of the
    products configuration and its cells `small-products-gcn.train` and
    `.serve` (the first serve mix of BENCHMARK.json)."""
    os.makedirs(os.path.join(tmp, "gnnbench"))
    for d in ("configs", "traffic"):
        shutil.copytree(os.path.join(ROOT, "gnnbench", d), os.path.join(tmp, "gnnbench", d))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    cfg.update(name="small-products-gcn", graph=SMALL_GRAPH, train_nodes=300)
    with open(os.path.join(tmp, "gnnbench", "configs", "small-products-gcn.json"), "w") as fh:
        json.dump(cfg, fh)
    bench["configs"].append({"name": "small-products-gcn", "source": "https://example.org/small",
                             "file": "gnnbench/configs/small-products-gcn.json", "reduced": [],
                             "why": "a small copy for the CPU tests"})
    serve = next(w["traffic"] for w in bench["workloads"] if w["traffic"] != "train")
    for loop, mix in (("train", "train"), ("serve", serve)):
        bench["workloads"].append({"name": f"small-products-gcn.{loop}",
                                   "config": "small-products-gcn", "traffic": mix, "chips": 1,
                                   "why": "a small copy for the CPU tests"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return tmp


def _small_graph(layouts=("bat", "stream")):
    src, dst, n = make_edges(SMALL_GRAPH)
    return prepare_graph(src, dst, n, add_self_loops=True, normalize="gcn", layouts=layouts,
                         device="cpu")


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def test_configuration_states_the_published_model():
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    assert cfg["model"] == {"in": 100, "hidden": 256, "layers": 3, "out": 47, "dropout": 0.5}
    assert cfg["program"]["model"]["args"] == [100, 256, 3, 47]
    assert cfg["optimizer"] == {"lr": 0.01, "weight_decay": 0.0}
    assert cfg["train_nodes"] == 196615 and cfg["graph_cache"] is False
    assert cfg["reduced"] == ["graph"] and "graph" in cfg["assumed"]
    g = cfg["graph"]
    assert g["num_nodes"] == 2449029 and g["power"] == 0.5 and g["bidirect"] is True
    assert cfg["program"]["prepare_graph"]["layouts"] == ["bat", "stream"]
    assert set(cfg["limits"]) == {"train", "serve"}


@pytest.mark.parametrize("loop", ["train", "serve"])
def test_small_copy_runs_the_hybrid_route_and_is_correct(tmp_path, monkeypatch, loop):
    """The harness's whole run on the CPU: correct within the
    configuration's limits, every aggregation on the hybrid route: forward
    over `hyb`; in training the backward over `hyb_t`, and the first
    layer's recomputed sum over `hyb`."""
    graphs, calls = [], []
    build, fwd = system.build_graph, api._spmm_fwd_hybrid

    def spy_build(*a, **kw):
        graphs.append(build(*a, **kw))
        return graphs[-1]

    def spy_fwd(hyb, x):
        calls.append(hyb)
        return fwd(hyb, x)

    monkeypatch.setattr(system, "build_graph", spy_build)
    monkeypatch.setattr(api, "_spmm_fwd_hybrid", spy_fwd)
    cell = load_cell(_checkout(str(tmp_path)), f"small-products-gcn.{loop}")
    r = run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(), None)
    assert r["correct"], r["checks"]
    limits = cell.config["limits"][loop]
    assert set(r["checks"]) == set(limits)
    for k, c in r["checks"].items():
        assert c["value"] <= limits[k], (k, c)
    (g,) = graphs
    assert dispatch_path(g) == "hybrid"
    assert g.hyb.rest is not None and g.hyb_t.rest is not None  # both halves carry edges
    if loop == "train":
        # three layers a step, forward over hyb; backward over hyb_t, but
        # the first layer (100 -> 256) sums first and sums over hyb again
        # in its backward: the three checked steps and the window's
        steps = 3 + r["attempted"]
        assert len(calls) == 6 * steps
        assert sum(h is g.hyb for h in calls) == 4 * steps
        assert sum(h is g.hyb_t for h in calls) == 2 * steps
    else:
        # three layers a request: the warm-up requests and the window's
        assert len(calls) == 3 * (cell.traffic["warmup_requests"] + r["attempted"])
        assert all(h is g.hyb for h in calls)


@pytest.mark.parametrize("loop", ["train", "serve"])
def test_small_copy_control_and_faults_fail_the_limits(tmp_path, loop):
    """The program passes the configuration's limits; the reference in TF32
    and each planted fault fail at least one of them."""
    cell = load_cell(_checkout(str(tmp_path)), f"small-products-gcn.{loop}")
    rows = []
    readings(cell, [SEED], {SEED}, torch.device("cpu"), None, rows.append)
    limits = cell.config["limits"][loop]
    by_side = {r["side"]: r for r in rows}
    assert len(by_side) == (4 if loop == "train" else 3)
    assert cmp.verdict({k: by_side["program"][k] for k in limits}, limits)[0]
    for side, r in by_side.items():
        if side != "program":
            ok, checks = cmp.verdict({k: r[k] for k in limits}, limits)
            assert not ok, (side, checks)


def test_counter_record_holds_each_directions_split(tmp_path):
    before = counter_record()
    g = _small_graph()
    rec = _delta(before, counter_record())
    assert set(rec) == set(KEYS)
    stats = g.build_stats["stream"]
    for direction, h in (("forward", g.hyb), ("transpose", g.hyb_t)):
        streamed = rec[f"stream.{direction}.streamed_edges"]
        rest = int(h.rest_src.numel())
        assert streamed == sum(sp.num_edges for sp in h.stream)
        assert rest == stats[direction]["rest_edges"] > 0
        assert streamed + rest == rec[f"stream.{direction}.edges"] == g.num_edges
        assert streamed / g.num_edges == pytest.approx(stats[direction]["stream_frac"])
    # a graph loaded from a file adds its split as a build does
    path = str(tmp_path / "g.npz")
    save_graph(g, path)
    before = counter_record()
    assert load_graph(path, device="cpu") is not None
    assert _delta(before, counter_record()) == rec


def test_counter_record_empty_without_hybrid_plans(tmp_path):
    before = counter_record()
    g = _small_graph(layouts=("bat",))
    assert g.hyb is None
    save_graph(g, str(tmp_path / "g.npz"))
    load_graph(str(tmp_path / "g.npz"), device="cpu")
    assert _delta(before, counter_record()) == {}
    rec = counter_record()
    rec["x"] = 1  # a copy
    assert "x" not in counter_record()


def _ctx(by_name, iters=4, mode="train"):
    return SimpleNamespace(mode=mode, iters=iters, trace=None if by_name is None else {
        "by_name": by_name, "by_class": {}, "busy_s": 1.0, "window_s": 1.0, "kernels": 1})


TRACE = {"void stream_row_kernel<float>(...)": 0.004, "void stream_fix_kernel<float>(...)": 0.002,
         "void (anonymous namespace)::edge_row_kernel<true, 64, 1>(...)": 0.010,
         "void (anonymous namespace)::edge_fix_kernel(...)": 0.002, "sgemm_128x128": 0.5}


@pytest.mark.parametrize("name,want", [("stream_ms.train", 1.5), ("rest_ms.train", 3.0)])
def test_kernel_time_readers(name, want):
    read = metric_reader(name)
    assert read(_ctx(TRACE), "train") == pytest.approx(want)
    assert read(_ctx(TRACE, mode="serve"), "train") is None  # the other loop's part
    assert read(_ctx(None), "train") is None  # untraced
    assert read(_ctx({"sgemm_128x128": 0.5}), "train") is None  # no such kernel ran


def test_stream_edge_share_reads_the_counter_record(monkeypatch):
    read = metric_reader("stream_edge_share")
    rec = {"stream.forward.streamed_edges": 60, "stream.forward.edges": 100,
           "stream.transpose.streamed_edges": 90, "stream.transpose.edges": 100}
    monkeypatch.setattr(trace, "_COUNTS", dict(rec))
    assert read(_ctx(None), None) == pytest.approx(75.0)
    monkeypatch.setattr(trace, "_COUNTS", {})
    assert read(_ctx(None), None) is None  # no hybrid plans built
    monkeypatch.delattr(trace, "counter_record")
    assert read(_ctx(None), None) is None  # a program that keeps no counter record


def _hybrid_spmm(g, x):
    out = segment_spmm(g, x)
    out.sum().backward()


def test_hybrid_spans_under_the_profiler_and_not_without(monkeypatch):
    g = _small_graph()
    assert dispatch_path(g) == "hybrid"
    x = torch.randn(g.num_nodes, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _hybrid_spmm(g, x)
    names = [ev.name for ev in prof.events() if ev.name.startswith("geot.spmm.hybrid.")]
    # the forward over hyb and the backward over hyb_t
    assert sorted(names) == ["geot.spmm.hybrid.rest"] * 2 + ["geot.spmm.hybrid.stream"] * 2

    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    x.grad = None
    _hybrid_spmm(g, x)
    assert np.isfinite(x.grad.numpy()).all()
