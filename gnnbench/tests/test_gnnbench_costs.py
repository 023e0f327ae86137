"""Each operation's flops and bytes against hand counts on small shapes,
and every configuration's op list evaluated."""

import json
import os

import pytest

from gnnbench.harness.costs import evaluate, least_time, load_peaks, op_cost
from gnnbench.tests.conftest import ROOT

H100 = "NVIDIA H100 80GB HBM3"


def test_expressions():
    dims = {"N": 10, "E": 7}
    assert evaluate("N*4 + (E - 1) // 2", dims) == 43
    assert evaluate(5, dims) == 5
    with pytest.raises(ValueError):
        evaluate("__import__('os')", dims)
    with pytest.raises(KeyError):
        evaluate("M", dims)


def test_hand_counts():
    d = {"N": 3, "E": 5}
    # [3, 2] @ [2, 4]: 2*3*2*4 flops; 6 + 8 + 12 floats
    assert op_cost({"kind": "gemm", "m": "N", "k": 2, "n": 4}, d) == (48.0, 4 * 26)
    # 5 edges into 3 rows of 4 columns, one weight an edge: x's 3 rows once, 5 src, 5
    # weights, 4 row offsets, the 3 output rows
    spmm = {"kind": "spmm", "rows": "N", "src_rows": "N", "edges": "E", "width": 4, "weights": 1}
    assert op_cost(spmm, d) == (40.0, 4 * (12 + 5 + 5 + 4 + 12))
    # per-head dots of 2 heads x 2 columns: both row sets once, src and row offsets, 5 x 2 out
    sddmm = {"kind": "sddmm", "rows_a": "N", "rows_b": "N", "edges": "E", "width": 4, "heads": 2}
    assert op_cost(sddmm, d) == (40.0, 4 * (24 + 5 + 4 + 10))
    soft = {"kind": "edge_softmax", "rows": "N", "edges": "E", "heads": 2}
    assert op_cost(soft, d) == (50.0, 4 * (12 + 5 + 4 + 10))
    ew = {"kind": "elementwise", "elems": "N*4", "reads": 2, "writes": 1}
    assert op_cost(ew, d) == (12, 4 * 36)


def test_least_time_takes_the_larger_bound():
    peaks = {"hbm_bytes_per_s": 1e3, "float32_flops": 1e3}
    ops = [{"in": "both", "kind": "gemm", "m": 10, "k": 10, "n": 10},       # 2000 flops, 1200 B
           {"in": "train", "kind": "elementwise", "elems": 10, "reads": 1, "writes": 1},
           {"in": "serve", "kind": "elementwise", "elems": 100, "reads": 1, "writes": 0}]
    assert least_time(ops, "train", {}, peaks, matmul_flops=1e3) == pytest.approx(2.0 + 0.08)
    assert least_time(ops, "train", {}, peaks, matmul_flops=4e3) == pytest.approx(1.2 + 0.08)
    assert least_time(ops, "serve", {}, peaks, 1e3, kinds=("elementwise",)) == pytest.approx(0.4)


def test_configurations_op_lists():
    peaks = load_peaks(H100)
    assert peaks["hbm_bytes_per_s"] == 3.35e12 and peaks["float32_flops"] == 67e12
    assert load_peaks("some other card") is None
    for path in (os.path.join(ROOT, "gnnbench", "configs", "ogbn-arxiv-gat.json"),
                 os.path.join(ROOT, "gnnbench", "tests", "configs", "gcn.json")):
        with open(path) as fh:
            cfg = json.load(fh)
        g = cfg["graph"]
        dims = {"N": g["num_nodes"], "E": 2 * g["num_edges"], "T": cfg["train_nodes"], "P": 10**6}
        serve = least_time(cfg["ops"], "serve", dims, peaks, peaks["float32_flops"])
        train = least_time(cfg["ops"], "train", dims, peaks, peaks["float32_flops"])
        assert 0 < serve < train
        spmm = least_time(cfg["ops"], "train", dims, peaks, 1.0, kinds=("spmm", "sddmm"))
        assert 0 < spmm < train
        # every GEMM of the forward has its weight gradient in the backward
        fwd = [o for o in cfg["ops"] if o["kind"] == "gemm" and o["in"] == "both"]
        dw = [o for o in cfg["ops"] if o["op"].endswith("_dw")]
        assert len(fwd) == len(dw) >= cfg["model"]["layers"]
