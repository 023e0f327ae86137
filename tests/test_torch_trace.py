"""The port's spans and set-up record (`geot_tpu_torch.utils.trace`): with
no profiler a span is the shared no-op and never enters `record_function`;
under `torch.profiler` one training step of a two-layer GAT (BatchNorm and
dropout between the layers) records every span, nested as named; each
conv's span holds its SpMM route's; `setup_phase` adds host seconds and
nothing else, and the optimizer's construction and a kernel library's load
are phases.
On the CPU, over the plain versions of the kernels; imports no JAX."""

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

import geot_tpu_torch.ops._build as build
import geot_tpu_torch.utils.trace as trace
from geot_tpu_torch.models import (
    APPNPConv,
    GATConv,
    GCNConv,
    GINConv,
    SAGEConv,
    SGConv,
    make_optimizer,
    make_train_step,
    prepare_graph,
)
from geot_tpu_torch.models.basic_gnn import FlaxBatchNorm, flax_dropout
from geot_tpu_torch.ops.api import dispatch_path, segment_softmax
from geot_tpu_torch.utils.trace import setup_phase, setup_record, span

N, E, F_IN = 200, 1200, 16
PHASES = ["geot.train.zero_grad", "geot.train.forward", "geot.train.loss",
          "geot.train.backward", "geot.train.optimizer"]


class TwoLayerGAT(nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.conv1 = GATConv(F_IN, 8, heads=2, generator=gen, device="cpu")
        self.norm = FlaxBatchNorm(16)
        self.conv2 = GATConv(16, 4, heads=2, concat=False, generator=gen, device="cpu")

    def forward(self, x, graph, generator=None):
        h = torch.relu(self.norm(self.conv1(x, graph)))
        h = flax_dropout(h, 0.5, self.training, generator)
        return self.conv2(h, graph)


def _graph():
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    return prepare_graph(src, dst, N, layouts=("slot",), e_tile=64, s_tile=64, device="cpu")


def _step():
    torch.manual_seed(0)
    model = TwoLayerGAT()
    step = make_train_step(model, make_optimizer(model, 0.01, 0.0), has_dropout=True)
    x, y = torch.randn(N, F_IN), torch.randint(0, 4, (N,))
    mask = torch.rand(N) < 0.5
    gen = torch.Generator().manual_seed(1)
    g = _graph()
    return lambda: step(x, g, y, mask, gen)


def _geot_chains(prof):
    """[(span, the enclosing geot. spans, innermost first)] of a profile."""
    out = []
    for ev in prof.events():
        if not ev.name.startswith("geot."):
            continue
        chain, p = [], ev.cpu_parent
        while p is not None:
            if p.name.startswith("geot."):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((ev.name, chain))
    return out


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler session every span is one shared no-op, and a GAT
    training step runs with `record_function` made to raise."""
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler on")

    run = _step()
    # what `span` would enter (torch's own code enters its own spans, which
    # do nothing without a session)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert span("geot.a") is span("geot.b")
    loss = run()
    assert torch.isfinite(loss)


def test_gat_step_records_every_span_nested():
    run = _step()
    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    chains = _geot_chains(prof)
    names = [n for n, _ in chains]
    counts = {n: names.count(n) for n in set(names)}
    step = ["geot.train.step"]
    fwd = ["geot.train.forward"] + step
    conv = ["geot.conv.gat"] + fwd
    want = {"geot.train.step": (1, []), "geot.conv.gat": (2, fwd),
            "geot.gat.logits": (2, conv), "geot.softmax": (2, conv),
            "geot.mh_spmm": (2, conv), "geot.norm.batch": (1, fwd), "geot.dropout": (1, fwd),
            **{p: (1, step) for p in PHASES}}
    assert counts == {k: c for k, (c, _) in want.items()}
    for name, chain in chains:
        assert chain == want[name][1], (name, chain)


@pytest.mark.parametrize("conv,short", [
    (lambda gen: GCNConv(F_IN, 8, generator=gen, device="cpu"), "gcn"),
    (lambda gen: SAGEConv(F_IN, 8, generator=gen, device="cpu"), "sage"),
    (lambda gen: GINConv(F_IN, 8, generator=gen, device="cpu"), "gin"),
    (lambda gen: SGConv(F_IN, 8, k=2, generator=gen, device="cpu"), "sg"),
    (lambda gen: APPNPConv(k=3), "appnp"),
])
def test_conv_span_holds_its_route(conv, short):
    g = _graph()
    layer = conv(torch.Generator().manual_seed(0))
    x = torch.randn(N, F_IN)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        layer(x, g)
    chains = _geot_chains(prof)
    routes = [(n, c) for n, c in chains if n.startswith("geot.spmm.")]
    assert routes and all(c == [f"geot.conv.{short}"] for _, c in routes)
    dyn = short in ("gcn", "sg", "appnp")  # the GCN norm as per-call weights
    reduce = "mean" if short == "sage" else "sum"
    route = dispatch_path(g, dynamic_w=dyn, reduce=reduce)
    assert {n for n, _ in routes} == {f"geot.spmm.{route}"}
    assert [n for n, c in chains if not c] == [f"geot.conv.{short}"]


def test_segment_softmax_span():
    index = torch.sort(torch.randint(0, 10, (50,)))[0]
    logits = torch.randn(50, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = segment_softmax(logits, index, 10)
    assert [n for n, _ in _geot_chains(prof)] == ["geot.softmax"]
    for s in index.unique():
        m = index == s
        torch.testing.assert_close(out[m], torch.softmax(logits[m], 0))


class _Clock:
    """A host clock that advances one second a read: a phase reads it on
    entry and on exit, so each phase entered adds exactly 1.0."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def test_setup_phase_adds_seconds(monkeypatch):
    monkeypatch.setattr(trace, "time", _Clock())
    before = setup_record().get("test.phase", 0.0)
    with setup_phase("test.phase"):
        pass
    with pytest.raises(ValueError):
        with setup_phase("test.phase"):
            raise ValueError("a failed set-up step counts too")
    after = setup_record()["test.phase"]
    assert after == pytest.approx(before + 2.0)
    rec = setup_record()
    rec["test.phase"] = -1.0  # a copy
    assert setup_record()["test.phase"] == after


def test_optimizer_and_kernel_load_are_phases(monkeypatch):
    monkeypatch.setattr(trace, "time", _Clock())
    model = TwoLayerGAT()
    n0 = setup_record().get("optimizer", 0.0)
    make_optimizer(model, 0.01, 0.0)
    make_optimizer(model, 0.01, 0.0)
    assert setup_record()["optimizer"] == pytest.approx(n0 + 2.0)
    # a library's build and load is the phase "kernels", once per library
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_kernels", lambda names: {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    k0 = setup_record().get("kernels", 0.0)
    lib = build.load_kernel("edge_row_sum")
    assert build.load_kernel("edge_row_sum") is lib
    build.load_kernel("sddmm_bat")
    assert setup_record()["kernels"] == pytest.approx(k0 + 2.0)


def test_setup_phase_opens_no_span_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with setup_phase("test.traced"):
            pass
    assert _geot_chains(prof) == []
    assert setup_record()["test.traced"] >= 0.0
