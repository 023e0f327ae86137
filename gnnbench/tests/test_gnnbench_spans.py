"""Device time by the program's spans (`gnnbench/harness/spans.py`): the
attribution rule on synthetic events (forward; backward through a sequence
number on another thread; the train phase that holds a launch; no span),
on a real CPU profile of one GAT training step (backward ops land on the
span of the forward op that made their node); and `program_setup_s`, which
reads the program's set-up record and nothing where the program keeps
none."""

import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gnnbench.harness.manifest import metric_reader
from gnnbench.harness.spans import NO_SPAN, Attribution, format_spans, span_table
from gnnbench.harness.trace import load_classes

NODE = "autograd::engine::evaluate_function: "


def _ev(i, name, start, end, thread=1, parent=None, seq=-1, fwd_thread=0):
    """A host op; those with ids over 100 launch device work."""
    return SimpleNamespace(id=i, name=name, time_range=SimpleNamespace(start=start, end=end),
                           thread=thread, cpu_parent=parent, sequence_nr=seq,
                           fwd_thread=fwd_thread, kernels=["k"] if i > 100 else [])


def _synthetic():
    """A step on thread 1 (forward: a softmax span, a ReLU outside any op
    span; the optimizer), its backward on thread 2, and an op after the
    step; device events linked to each, one linked to nothing."""
    step = _ev(1, "geot.train.step", 0, 100)
    fwd = _ev(2, "geot.train.forward", 1, 40, parent=step)
    early = _ev(3, "aten::to", 3, 4, parent=fwd, seq=10)  # same sequence number, earlier
    smax = _ev(4, "geot.softmax", 5, 10, parent=fwd)
    exp = _ev(101, "aten::exp", 6, 7, parent=smax, seq=10)
    relu = _ev(102, "aten::relu", 20, 21, parent=fwd, seq=11)
    bwd = _ev(5, "geot.train.backward", 41, 80, parent=step)
    opt = _ev(6, "geot.train.optimizer", 81, 99, parent=step)
    foreach = _ev(103, "aten::_foreach_add_", 82, 83, parent=opt)
    node = _ev(201, NODE + "ExpBackward0", 50, 55, thread=2, seq=10, fwd_thread=1)
    mul = _ev(202, "aten::mul", 51, 52, thread=2, parent=node)
    acc = _ev(203, NODE + "torch::autograd::AccumulateGrad", 60, 62, thread=2)
    add = _ev(204, "aten::add_", 60.5, 61, thread=2, parent=acc)
    copy = _ev(205, "aten::copy_", 70, 71, thread=2)
    after = _ev(301, "aten::argmax", 120, 121)
    host = [step, fwd, early, smax, exp, relu, bwd, opt, foreach, node, mul, acc, add, copy,
            after]
    # a runtime call whose own id is a launching op's number holds no kernels
    host.append(_ev(3, "cudaLaunchKernel", 30, 31))
    device = [("k_exp", 6.1, 6.5, 101), ("k_relu", 20.1, 20.3, 102),
              ("k_mul", 51.1, 51.6, 202), ("k_acc", 60.6, 60.8, 204),
              ("Memcpy DtoD (Device -> Device)", 70.1, 70.2, 205),
              ("k_foreach", 82.1, 82.5, 103), ("k_lost", 90, 91, 999),
              ("k_after", 120.2, 120.4, 301), ("k_edge", 199, 201, 301), ("k_run", 2, 3, 3)]
    return host, device


def test_rule_on_synthetic_events():
    host, device = _synthetic()
    att = Attribution(host)
    by_id = {e.id: e for e in host}
    assert att.span_of(by_id[101]) == ("geot.softmax", "forward")
    assert att.span_of(by_id[102]) == ("geot.train.forward", "forward")
    # the node's sequence number on its forward thread: the op that made it
    assert att.forward_op(by_id[201]) is by_id[101]
    assert att.span_of(by_id[202]) == ("geot.softmax", "backward")
    # gradient accumulation and a bare op on the backward thread: the phase
    assert att.span_of(by_id[204]) == ("geot.train.backward", "backward")
    assert att.span_of(by_id[205]) == ("geot.train.backward", "forward")
    assert att.span_of(by_id[103]) == ("geot.train.optimizer", "forward")
    assert att.span_of(by_id[301]) == (NO_SPAN, "forward")

    t = span_table(device, host, (0.0, 200.0), load_classes())
    by = t["by_span"]
    assert by["geot.softmax"]["forward"] == [pytest.approx(0.4e-6), 1]
    assert by["geot.softmax"]["backward"] == [pytest.approx(0.5e-6), 1]
    assert by["geot.train.backward"]["backward"] == [pytest.approx(0.2e-6), 1]
    assert by["geot.train.backward"]["forward"] == [pytest.approx(0.1e-6), 0]  # a copy
    assert by["geot.train.optimizer"]["forward"][1] == 1
    # linked to nothing, or launched outside every span; clipped to the window
    assert by[NO_SPAN]["forward"] == [pytest.approx((1 + 0.2 + 1 + 1) * 1e-6), 4]
    total = sum(c[0] for v in by.values() for c in v.values())
    assert t["device_s"] == pytest.approx(total)
    assert t["device_s"] == pytest.approx(sum(min(e, 200) - s for _, s, e, _ in device) * 1e-6)
    line = format_spans(t, 2).split("; ")
    assert line[0].startswith(NO_SPAN)  # the longest first
    assert line[-1] == f"device {t['device_s'] / 2 * 1e3:.4f} ms"


def _gat_step_profile():
    from torch.profiler import ProfilerActivity, profile

    from geot_tpu_torch.models import GATConv, make_optimizer, make_train_step, prepare_graph
    from geot_tpu_torch.models.basic_gnn import FlaxBatchNorm, flax_dropout

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(0)
            self.c1 = GATConv(12, 8, heads=2, generator=gen, device="cpu")
            self.bn = FlaxBatchNorm(16)
            self.c2 = GATConv(16, 3, heads=2, concat=False, generator=gen, device="cpu")

        def forward(self, x, graph, generator=None):
            h = flax_dropout(torch.relu(self.bn(self.c1(x, graph))), 0.5, self.training,
                             generator)
            return self.c2(h, graph)

    rng = np.random.default_rng(1)
    n = 150
    src, dst = (rng.integers(0, n, 900).astype(np.int32) for _ in range(2))
    g = prepare_graph(src, dst, n, layouts=("slot",), e_tile=64, s_tile=64, device="cpu")
    model = Net()
    step = make_train_step(model, make_optimizer(model, 0.01, 0.0), has_dropout=True)
    x, y, mask = torch.randn(n, 12), torch.randint(0, 3, (n,)), torch.rand(n) < 0.5
    gen = torch.Generator().manual_seed(2)
    step(x, g, y, mask, gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(x, g, y, mask, gen)
    return prof


def test_backward_lands_on_its_forward_span():
    prof = _gat_step_profile()
    host = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CPU]
    att = Attribution(host)
    made_by = {"_MhSpmmBackward": "geot.mh_spmm", "LeakyReluBackward0": "geot.gat.logits",
               "_SegmentSumBackward": "geot.softmax", "ExpBackward0": "geot.softmax",
               "NativeBatchNormBackward0": "geot.norm.batch", "VarBackward0": "geot.norm.batch",
               "WhereBackward0": "geot.dropout"}
    seen = set()
    for ev in host:
        p = ev.cpu_parent
        while p is not None and not p.name.startswith(NODE):
            p = p.cpu_parent
        if not ev.name.startswith("aten::") or p is None:
            continue
        want = made_by.get(p.name[len(NODE):])
        if want is not None:
            assert att.span_of(ev) == (want, "backward"), (p.name, ev.name)
            seen.add(want)
    assert seen == {"geot.mh_spmm", "geot.gat.logits", "geot.softmax", "geot.norm.batch",
                    "geot.dropout"}

    # each top-level host op as a device event of its own: every span of the
    # model gets forward and backward work, and the total is kept
    ops = [ev for ev in host if ev.name.startswith("aten::")
           and not (ev.cpu_parent and ev.cpu_parent.name.startswith("aten::"))]
    device = []
    for ev in ops:
        ev.append_kernel(ev.name, 0, 1)
        device.append((ev.name, ev.time_range.start, ev.time_range.end, ev.id))
    t = span_table(device, host, (-math.inf, math.inf), load_classes())
    for name in ("geot.softmax", "geot.mh_spmm", "geot.gat.logits", "geot.norm.batch",
                 "geot.dropout"):
        assert t["by_span"][name]["forward"][1] > 0 and t["by_span"][name]["backward"][1] > 0
    assert t["by_span"]["geot.train.optimizer"]["forward"][1] > 0
    assert NO_SPAN not in t["by_span"]
    assert sum(c[1] for v in t["by_span"].values() for c in v.values()) == len(device)


def test_program_setup_s_reads_the_programs_record(monkeypatch):
    import geot_tpu_torch.utils.trace as program_trace

    read = metric_reader("program_setup_s")
    ctx = SimpleNamespace(mode="train", plan_s=0.5)
    monkeypatch.setattr(program_trace, "_SETUP",
                        {"kernels": 0.25, "optimizer": 1.5, "other": 9.0})
    assert read(ctx, None) == pytest.approx(2.25)
    monkeypatch.setattr(program_trace, "_SETUP", {"kernels": 0.25})
    assert read(SimpleNamespace(mode="serve", plan_s=0.5), None) == pytest.approx(0.75)
    # a program without a set-up record: the metric is left out
    monkeypatch.setitem(sys.modules, "geot_tpu_torch.utils.trace", None)
    assert read(ctx, None) is None
