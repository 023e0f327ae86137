"""The metric arithmetic: intervals and their union, gaps, a percentile
over every request, a rate over the window, the trace reduction; and the
training comparison's leaves taken by the worst."""

import math

import pytest
import torch

from gnnbench.harness.correct import train_numbers

from gnnbench.harness.stats import gaps, merge, percentile, rate, union_length
from gnnbench.harness.trace import classify, load_classes, reduce_events


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert merge(iv) == [(0, 15), (20, 30)]
    assert union_length(iv) == 25
    assert sum(e - s for s, e in iv) == 31  # a sum of durations double-counts
    assert union_length(iv, 10, 22) == 7


def test_gaps_cover_the_window_outside_the_union():
    assert gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert gaps([], 0, 5) == [(0, 5)]
    assert gaps([(-5, 20)], 0, 10) == []


def test_p95_is_over_every_request():
    lat = [1.0] * 95 + [10.0] * 5
    assert percentile(lat, 95) == pytest.approx(1.45)  # numpy's linear rank
    assert percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_over_the_window():
    assert rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_classes_and_trace_reduction():
    classes = load_classes()
    assert classify("void edge_row_kernel<4, true>(Src, int)", classes) == "own"
    assert classify("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n", classes) == "gemm"
    assert classify("Memcpy DtoH (Device -> Pageable)", classes) == "copy"
    assert classify("void at::native::segment_reduce_forward_kernel", classes) == "glue"
    device = [("void edge_row_kernel<1>", 10, 30), ("ampere_sgemm_128x64_nn", 20, 40),
              ("void at::native::vectorized_elementwise_kernel", 60, 70),
              ("Memcpy DtoH (Device -> Pageable)", 70, 75)]
    host = [("aten::mm", 0, 45), ("cudaLaunchKernel", 41, 44), ("aten::argmax", 45, 100),
            ("cudaStreamSynchronize", 76, 99)]
    red = reduce_events(device, host, (0, 100), classes)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(45e-6)  # 10-40 and 60-75
    assert red["by_class"]["own"] == pytest.approx(20e-6)
    assert red["by_class"]["gemm"] == pytest.approx(20e-6)
    assert red["by_class"]["copy"] == pytest.approx(5e-6)
    assert red["kernels"] == 3
    idle = dict(red["idle_by_host_op"])
    # gaps 0-10, 40-60 and 75-100, named by the innermost host op at their middle
    assert idle == pytest.approx({"cudaStreamSynchronize": 25e-6, "aten::argmax": 20e-6,
                                  "aten::mm": 10e-6})


def test_one_leaf_off_is_the_training_comparisons_reading():
    leaves = {f"l{i}": torch.full((4,), float(i + 1)) for i in range(6)}
    ref = {"losses": [1.0, 0.9, 0.8], "grad": leaves, "change": leaves}
    prog = {"losses": [1.0, 0.9, 0.8], "grad": dict(leaves, l5=leaves["l5"] * 1.01),
            "change": dict(leaves, l0=leaves["l0"] * 0.5)}
    got = train_numbers(prog, ref)
    assert got["loss_gap"] == 0
    assert got["grad_gap"] == pytest.approx(0.01)  # one leaf of six, not the median
    # l0's change (norm 2) is off by 1, over the median leaf's norm (7)
    assert got["change_gap"] == pytest.approx(1 / 7)
    prog["grad"] = dict(leaves, l3=leaves["l3"] * float("nan"))
    assert math.isinf(train_numbers(prog, ref)["grad_gap"])
