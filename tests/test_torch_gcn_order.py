"""GCNConv's order of products, chosen from the widths it was built with.

A layer that widens (in < out) sums first, (A_hat x) W^T + b, through
`_AggregateFirst`, which saves only x and W and sums A_hat x again in the
backward; any other layer multiplies first, A_hat (x W^T) + b. The
multiply-first form is written out here as `F.linear` then `segment_spmm`,
and both are held against a float64 dense A_hat, over the BAT route and the
hybrid route (a community graph of 1,024 nodes with the GCN norm baked in),
with the graph's weights and with the norm per call. On the CPU, over the
plain versions of the kernels; imports no JAX.
"""

import functools

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from geot_tpu_torch.graph.datasets import synthetic_clustered_graph
from geot_tpu_torch.models import GCN, GCNConv, gcn_edge_weight, prepare_graph
from geot_tpu_torch.ops.api import dispatch_path, segment_spmm
from geot_tpu_torch.utils.trace import counter_record

N = 1024
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=128)
LAYOUTS = {"bat": ("bat",), "hybrid": ("bat", "stream")}
# the SpMM paths' float32 tolerance (ROADMAP: rtol / atol 2e-4)
TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _graph(route: str):
    d = synthetic_clustered_graph(N, 24_000, mixing=0.1, mean_community=256, seed=0)
    g = prepare_graph(d.src, d.dst, N, normalize="gcn", layouts=LAYOUTS[route],
                      device="cpu", **TILES)
    assert dispatch_path(g) == ("hybrid" if route == "hybrid" else "bat_static")
    return g


def _conv(fin, fout, normalize, seed=0, **kw):
    conv = GCNConv(fin, fout, normalize=normalize,
                   generator=torch.Generator().manual_seed(seed), device="cpu", **kw)
    with torch.no_grad():
        conv.bias.copy_(torch.randn(fout, generator=torch.Generator().manual_seed(seed + 1)))
    return conv


def _weights(g, normalize):
    """The per-call norm the conv computes, or None (the graph's own)."""
    return gcn_edge_weight(g) if normalize else None


def _dense(g, normalize) -> torch.Tensor:
    """A_hat as a float64 dense [N, N] matrix: A[d, s] += w_e."""
    w = _weights(g, normalize)
    w = g.edge_weight if w is None else w
    a = torch.zeros(N, N, dtype=torch.float64)
    a.index_put_((g.dst.long(), g.src.long()), w.double(), accumulate=True)
    return a


def _linear_first(g, normalize, x, weight, bias):
    return segment_spmm(g, F.linear(x, weight), edge_weight=_weights(g, normalize)) + bias


def _inputs(fin, fout, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(N, fin, generator=gen), torch.randn(N, fout, generator=gen)


def _run(conv, g, x, gout, x_grad):
    """(out, dx, dW, db) of one forward and backward of `conv`."""
    conv.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_(x_grad)
    out = conv(x, g)
    out.backward(gout)
    return out.detach(), x.grad, conv.lin.weight.grad, conv.bias.grad


@pytest.mark.parametrize("fin,fout,first", [(8, 24, True), (24, 24, False), (24, 8, False)])
def test_order_follows_widths(fin, fout, first):
    before = counter_record()
    conv = GCNConv(fin, fout, device="cpu")
    after = counter_record()
    assert conv.aggregate_first is first
    assert after.get("gcn.layers", 0) - before.get("gcn.layers", 0) == 1
    assert (after.get("gcn.aggregate_first", 0)
            - before.get("gcn.aggregate_first", 0)) == int(first)


def test_gcn_stack_widens_only_its_first_layer():
    """OGB products' shape, narrowed: 10 -> 32 -> 32 -> 7."""
    before = counter_record()
    m = GCN(10, 32, 3, 7, device="cpu")
    after = counter_record()
    assert [c.aggregate_first for c in m.convs] == [True, False, False]
    assert after["gcn.layers"] - before.get("gcn.layers", 0) == 3
    assert after["gcn.aggregate_first"] - before.get("gcn.aggregate_first", 0) == 1


@pytest.mark.parametrize("route", ["bat", "hybrid"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("x_grad", [False, True])
def test_aggregate_first_matches_linear_first_and_float64(route, normalize, x_grad):
    """Forward, dW, db and (a hidden layer: x asks for its gradient) dx
    against the multiply-first form and float64 dense A_hat."""
    g = _graph(route)
    fin, fout = 12, 40
    conv = _conv(fin, fout, normalize)
    assert conv.aggregate_first
    x, gout = _inputs(fin, fout, 3)
    out, dx, dw, db = _run(conv, g, x, gout, x_grad)
    assert (dx is not None) == x_grad

    xl = x.clone().requires_grad_(x_grad)
    wl = conv.lin.weight.detach().clone().requires_grad_()
    bl = conv.bias.detach().clone().requires_grad_()
    ref = _linear_first(g, normalize, xl, wl, bl)
    ref.backward(gout)
    torch.testing.assert_close(out, ref.detach(), **TOL)
    torch.testing.assert_close(dw, wl.grad, **TOL)
    torch.testing.assert_close(db, bl.grad, **TOL)
    if x_grad:
        torch.testing.assert_close(dx, xl.grad, **TOL)

    a = _dense(g, normalize)
    x64, g64 = x.double(), gout.double()
    w64 = conv.lin.weight.detach().double()
    ax = a @ x64
    torch.testing.assert_close(out.double(), ax @ w64.T + conv.bias.detach().double(), **TOL)
    torch.testing.assert_close(dw.double(), g64.T @ ax, **TOL)
    torch.testing.assert_close(db.double(), g64.sum(0), **TOL)
    if x_grad:
        torch.testing.assert_close(dx.double(), a.T @ (g64 @ w64), **TOL)


@pytest.mark.parametrize("route", ["bat", "hybrid"])
@pytest.mark.parametrize("fin,fout", [(24, 24), (40, 12)])
def test_linear_first_layers_unchanged(route, fin, fout):
    """A layer that does not widen is the multiply-first form, bit for bit."""
    g = _graph(route)
    conv = _conv(fin, fout, False)
    assert not conv.aggregate_first
    x, gout = _inputs(fin, fout, 4)
    out, dx, dw, db = _run(conv, g, x, gout, True)
    xl = x.clone().requires_grad_()
    wl = conv.lin.weight.detach().clone().requires_grad_()
    bl = conv.bias.detach().clone().requires_grad_()
    ref = _linear_first(g, False, xl, wl, bl)
    ref.backward(gout)
    for got, want in [(out, ref.detach()), (dx, xl.grad), (dw, wl.grad), (db, bl.grad)]:
        assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["bat", "hybrid"])
def test_aggregate_first_saves_only_x_and_weight(route):
    """The layer holds its input and weight from forward to backward, and
    no [N, in] or [N, out] intermediate."""
    g = _graph(route)
    conv = _conv(12, 40, False)
    x = torch.randn(N, 12)
    out = conv(x, g)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0].data_ptr() == x.data_ptr()
    assert saved[1].data_ptr() == conv.lin.weight.data_ptr()


@pytest.mark.parametrize("route", ["bat", "hybrid"])
def test_aggregate_first_reruns_bit_identical(route):
    g = _graph(route)
    conv = _conv(12, 40, False)
    x, gout = _inputs(12, 40, 5)
    first = _run(conv, g, x, gout, True)
    second = _run(conv, g, x, gout, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_recompute_span_holds_the_backward_sum():
    """Under a profiler the backward's sum is the span
    "geot.conv.gcn.recompute", and runs the forward's route."""
    g = _graph("hybrid")
    conv = _conv(12, 40, False)
    x = torch.randn(N, 12)
    out = conv(x, g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out.backward(torch.ones_like(out))
    names = [e.name for e in prof.events()]
    assert names.count("geot.conv.gcn.recompute") == 1
    assert names.count("geot.spmm.hybrid") == 1


@pytest.mark.parametrize("route", ["bat", "hybrid"])
def test_aggregate_first_bf16(route):
    """The compute dtype: x and W cast to bf16, the sum in float32 returned
    in bf16, the product in bf16; float32 parameters and their gradients.
    Within the bf16 budget of `test_gcn_bf16_matches_jax` (rtol 0.05, atol
    0.2) of the float32 multiply-first form."""
    g = _graph(route)
    conv = _conv(16, 32, False, dtype=torch.bfloat16)
    assert conv.aggregate_first
    x, gout = _inputs(16, 32, 6)
    out, _, dw, db = _run(conv, g, x, gout.bfloat16(), False)
    assert out.dtype == torch.bfloat16
    assert dw.dtype == db.dtype == torch.float32
    wl = conv.lin.weight.detach().clone().requires_grad_()
    bl = conv.bias.detach().clone().requires_grad_()
    ref = _linear_first(g, False, x, wl, bl)
    ref.backward(gout.bfloat16().float())
    bf16 = dict(rtol=0.05, atol=0.2)
    torch.testing.assert_close(out.float(), ref.detach(), **bf16)
    torch.testing.assert_close(db, bl.grad, **bf16)
    torch.testing.assert_close(dw, wl.grad, **bf16)
