"""GCN, GraphSAGE, GIN, GAT, SGC and APPNP layers over the fused SpMM.

Port of `geot_tpu/models/conv.py:47-357` (`prepare_graph`,
`gcn_edge_weight`, `GCNConv`, `SAGEConv`, `MLP`, `GINConv`, `GATConv`,
`SGConv`, `APPNPConv`). The aggregation is a direct call into
`segment_spmm` (GAT: `gat_attention_spmm`) over a prebuilt `Graph`.
Under a profiler each conv's forward is the span "geot.conv.<name>"
(gcn, sage, gat, gin, sg, appnp), GAT's per-node attention terms the
span "geot.gat.logits", and a widening GCN layer's backward sum
"geot.conv.gcn.recompute".
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.autograd.function import once_differentiable

from geot_tpu_torch.graph.stream_plan import StreamKnobs
from geot_tpu_torch.graph.structures import Graph, build_graph
from geot_tpu_torch.ops.api import gat_attention_spmm, segment_spmm
from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.utils.trace import count, span

__all__ = ["prepare_graph", "gcn_edge_weight", "GCNConv", "SAGEConv", "GATConv", "MLP",
           "GINConv", "SGConv", "APPNPConv", "glorot_uniform_", "lecun_normal_"]


def prepare_graph(
    src,
    dst,
    num_nodes: int,
    *,
    add_self_loops: bool = True,
    edge_weight=None,
    normalize: Optional[str] = None,
    improved: bool = False,
    e_tile: Optional[int] = None,
    s_tile: Optional[int] = None,
    bat_e_tile: Optional[int] = None,
    bat_s_tile: Optional[int] = None,
    feature_hint: int = 128,
    layouts=("bat", "slot"),
    max_chunk_bytes: int = 1 << 30,
    stream_knobs: StreamKnobs = StreamKnobs(),
    prefer: Optional[str] = None,
    prefer_dyn: Optional[str] = None,
    mode_hint: Optional[str] = None,
    max_chunk_slots: int = 4 << 20,
    bucket_table_bytes: Optional[int] = None,
    bucket_rows: int = 128 * 1024,
    device=None,
) -> Graph:
    """One-time host-side adjacency prep: optionally add self-loops (PyG
    `add_remaining_self_loops` semantics: existing diagonal edges are
    replaced by the full diagonal at fill 1, or 2 with `improved`),
    optionally bake the symmetric GCN normalization into the edge weights
    (`normalize='gcn'`), dst-sort and build the plans of `layouts` (the
    reference's default: BAT and slot).

    Tiles, `prefer`, `prefer_dyn` and `mode_hint` left unset come from the
    tuning table, else from `build_graph`'s defaults (the shipped table is
    empty); the bucketed BAT knobs (`bucket_table_bytes`, `bucket_rows`)
    are explicit (see `build_graph`). `layouts=("bat", "stream")` adds the hybrid plans
    where the cell census accepts them. With `normalize='gcn'` and a slot
    layout the norm lives in the graph's slot weights, and
    `GCNConv(normalize=True)` takes it as it is. On a graph without slot
    plans (`layouts=("bat",)`, or `("bat", "stream")`) `GCNConv` normalizes
    the baked weights a second time, as the reference does (ROADMAP C.1):
    there use `GCN(..., conv_kwargs={"normalize": False})`.
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if add_self_loops:
        fill = 2.0 if improved else 1.0
        keep = src != dst
        src, dst = src[keep], dst[keep]
        loop = np.arange(num_nodes, dtype=np.int32)
        if edge_weight is not None:
            edge_weight = np.concatenate(
                [np.asarray(edge_weight, np.float32)[keep],
                 np.full(num_nodes, fill, np.float32)]
            )
        elif improved:
            edge_weight = np.concatenate(
                [np.ones(len(src), np.float32), np.full(num_nodes, fill, np.float32)]
            )
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    if normalize == "gcn":
        base = (
            np.ones(len(src), np.float32)
            if edge_weight is None
            else np.asarray(edge_weight, np.float32)
        )
        deg = np.zeros(num_nodes, np.float32)
        np.add.at(deg, dst, base)
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        edge_weight = dinv[dst] * base * dinv[src]
    elif normalize is not None:
        raise ValueError(f"unknown normalize={normalize!r}")
    return build_graph(
        src, dst, num_nodes, edge_weight=edge_weight,
        e_tile=e_tile, s_tile=s_tile, bat_e_tile=bat_e_tile,
        bat_s_tile=bat_s_tile, feature_hint=feature_hint, layouts=layouts,
        max_chunk_bytes=max_chunk_bytes, stream_knobs=stream_knobs, prefer=prefer,
        prefer_dyn=prefer_dyn, mode_hint=mode_hint, max_chunk_slots=max_chunk_slots,
        bucket_table_bytes=bucket_table_bytes, bucket_rows=bucket_rows, device=device,
    )


def gcn_edge_weight(graph: Graph, dtype=torch.float32) -> torch.Tensor:
    """Symmetric GCN normalization over an already self-looped graph:
    w_e = d_dst^-1/2 * base_e * d_src^-1/2 (edge order kept, so the plans
    stay valid), returned in `dtype`.

    The degree is a float32 sum of each node's run of the dst-sorted edge
    list (`torch.segment_reduce` over the runs' offsets, found by binary
    search): a fixed order with no atomics, so reruns are bit-identical on
    the card, also under `torch.use_deterministic_algorithms(True)`. It is
    computed per forward, as in the reference."""
    base = (
        graph.edge_weight.to(dtype)
        if graph.edge_weight is not None
        else torch.ones(graph.num_edges, dtype=dtype, device=graph.device)
    )
    nodes = torch.arange(graph.num_nodes + 1, dtype=graph.dst.dtype, device=graph.device)
    offsets = torch.searchsorted(graph.dst, nodes)
    deg = torch.segment_reduce(base.float(), "sum", offsets=offsets, initial=0.0)
    dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                       torch.zeros_like(deg))
    dst, src = graph.dst.long(), graph.src.long()
    return (dinv[dst] * base.float() * dinv[src]).to(dtype)


def glorot_uniform_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax `glorot_uniform` (variance scaling 1.0, fan_avg, uniform):
    U(-a, a) with a = sqrt(6 / (fan_in + fan_out))."""
    fan_out, fan_in = weight.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-a, a, generator=generator)


def _glorot_uniform_heads_(param: torch.Tensor,
                           generator: Optional[torch.Generator]) -> None:
    """flax `glorot_uniform` on a [1, H, D] parameter (in_axis -2, out_axis
    -1, receptive field 1): U(-a, a) with a = sqrt(6 / (H + D))."""
    _, heads, dim = param.shape
    a = math.sqrt(6.0 / (heads + dim))
    with torch.no_grad():
        param.uniform_(-a, a, generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax `lecun_normal` (nn.Dense's default kernel init: variance
    scaling 1.0, fan_in, truncated normal): N(0, 1/fan_in) truncated at two
    standard deviations, its std corrected for the truncation."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)


def _dense(in_features: int, features: int, generator: Optional[torch.Generator],
           use_bias: bool = True) -> nn.Linear:
    """flax `nn.Dense` as an `nn.Linear` (weight [out, in] = the kernel
    transposed): lecun normal weight, zero bias, drawn from `generator` on
    the CPU."""
    lin = nn.Linear(in_features, features, bias=use_bias)
    lecun_normal_(lin.weight, generator)
    if use_bias:
        nn.init.zeros_(lin.bias)
    return lin


def _linear(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`lin(x)`, or with `dtype` the product in that compute dtype (flax
    `Dense(dtype=...)`: input and float32 parameters cast to it)."""
    if dtype is None:
        return lin(x)
    b = None if lin.bias is None else lin.bias.to(dtype)
    return torch.nn.functional.linear(x.to(dtype), lin.weight.to(dtype), b)


class GCNConv(nn.Module):
    """Graph convolution out = A_hat X W + b, A_hat = D^-1/2 (A+I) D^-1/2.

    The order of the two products follows the widths the layer was built
    with: a layer that widens (`in_features < features`) sums first,
    (A_hat X) W, so that the SpMM runs at the narrower input width
    (`_AggregateFirst`, which recomputes the sum in the backward instead of
    holding it); any other layer multiplies first, A_hat (X W). Both are
    the same mathematics; the sums differ only in rounding.

    `lin` is a bias-free `nn.Linear` (weight [out, in] = the flax kernel
    transposed) and `bias` a separate parameter, as in the reference's
    flax module. The graph must already hold self-loops (`prepare_graph`).
    With `normalize=True`: a graph with slot weights
    (`prepare_graph(..., normalize='gcn')` with a slot layout) carries the
    norm, and the SpMM takes the graph's own weights; otherwise the degree
    norm is computed per forward and the SpMM takes it as per-call
    weights. `normalize=False` aggregates with the graph's own weights (or
    unweighted), which is what reaches the hybrid path. `dtype` is the
    compute dtype (flax `dtype`): the input and the float32 parameters are
    cast to it for the product, and the SpMM returns it (summing in
    float32); None keeps the input's dtype. Parameters are drawn on the
    CPU from `generator` and moved to `device` (default: the CUDA card).
    Each layer built adds 1 to the counter `gcn.layers` of the process's
    counter record, and one that sums first 1 to `gcn.aggregate_first`.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        use_bias: bool = True,
        normalize: bool = True,
        backend: str = "auto",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.normalize = normalize
        self.backend = backend
        self.dtype = dtype
        self.lin = nn.Linear(in_features, features, bias=False)
        glorot_uniform_(self.lin.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.aggregate_first = in_features < features
        count("gcn.layers", 1)
        if self.aggregate_first:
            count("gcn.aggregate_first", 1)
        self.to(dev)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        with span("geot.conv.gcn"):
            weight = self.lin.weight
            if self.dtype is not None:
                x, weight = x.to(self.dtype), weight.to(self.dtype)
            w = (gcn_edge_weight(graph, x.dtype)
                 if self.normalize and graph.w_slots is None else None)

            def aggregate(h: torch.Tensor) -> torch.Tensor:
                return segment_spmm(graph, h, edge_weight=w, backend=self.backend)

            bias = None if self.bias is None else self.bias.to(x.dtype)
            if self.aggregate_first:
                return _AggregateFirst.apply(x, weight, bias, aggregate)
            out = aggregate(torch.nn.functional.linear(x, weight))
            return out if bias is None else out + bias


class _AggregateFirst(torch.autograd.Function):
    """out = (A_hat x) W^T + b, the SpMM at x's width, for a GCN layer that
    widens. Saves only x and W: the backward sums A_hat x again, once, at
    x's width over the forward's route and plan, under the span
    "geot.conv.gcn.recompute", for dW = g^T (A_hat x); db = g summed over
    rows; dx = A_hat^T (g W) through the SpMM's own backward. So the layer
    holds no [N, in] or [N, out] intermediate from its forward to its
    backward. `aggregate` is the layer's SpMM (graph, per-call weights and
    route fixed)."""

    @staticmethod
    def forward(ctx, x, weight, bias, aggregate):
        ctx.aggregate = aggregate
        ctx.save_for_backward(x, weight)
        return torch.nn.functional.linear(aggregate(x), weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x or need_w:
            with span("geot.conv.gcn.recompute"), torch.enable_grad():
                xd = x.detach().requires_grad_(need_x)
                agg = ctx.aggregate(xd)
            if need_w:
                dw = g.t().mm(agg.detach())
            if need_x:
                (dx,) = torch.autograd.grad(agg, xd, g.mm(weight))
        if need_b:
            db = g.sum(0)
        return dx, dw, db, None


class SAGEConv(nn.Module):
    """GraphSAGE: out = lin_l(reduce_{j->i} x_j) + lin_r(x_i).

    `lin_l` (the flax `Dense_0`, with bias) maps the aggregate, `lin_r`
    (`Dense_1`, no bias) the root; with `normalize` each output row is
    scaled to unit L2 norm. The aggregation is the unweighted fused SpMM
    with `aggr` ("mean" or "sum"); the graph should hold no self-loops.
    Weights are initialised as flax's `nn.Dense` does (lecun normal,
    zero bias) from `generator`, on the CPU, and moved to `device`
    (default: the CUDA card). `dtype` is the compute dtype, as in
    `GCNConv`.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        aggr: str = "mean",
        root_weight: bool = True,
        normalize: bool = False,
        use_bias: bool = True,
        backend: str = "auto",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.aggr = aggr
        self.normalize = normalize
        self.backend = backend
        self.dtype = dtype
        self.lin_l = _dense(in_features, features, generator, use_bias)
        self.lin_r = _dense(in_features, features, generator, False) if root_weight else None
        self.to(dev)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        with span("geot.conv.sage"):
            if self.dtype is not None:
                x = x.to(self.dtype)
            agg = segment_spmm(graph, x, reduce=self.aggr, backend=self.backend)
            out = _linear(self.lin_l, agg, self.dtype)
            if self.lin_r is not None:
                out = out + _linear(self.lin_r, x, self.dtype)
            if self.normalize:
                out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True),
                                        min=1e-12)
            return out


class GATConv(nn.Module):
    """Multi-head graph attention: per-edge logits LeakyReLU(a_src . x_src
    + a_dst . x_dst) per head, softmax over each destination's in-edges,
    then out[i, h] = sum_j alpha_ij,h x_j,h (`gat_attention_spmm`, over the
    graph's slot plans). `features` is the width of one head; the heads are
    concatenated (`concat`) or averaged. The graph should hold self-loops.

    `lin` is a bias-free `nn.Linear` to heads*features (the flax
    `Dense_0/kernel` transposed); `att_src` / `att_dst` [1, heads,
    features] and `bias` are the flax params of the same names, all
    initialised as flax does (glorot uniform, zero bias) from `generator`
    on the CPU, then moved to `device` (default: the CUDA card). `dtype`
    is the compute dtype, as in `GCNConv`. The route is
    `gat_attention_spmm`'s, with its default switches.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        heads: int = 1,
        concat: bool = True,
        negative_slope: float = 0.2,
        use_bias: bool = True,
        backend: str = "auto",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.heads, self.features, self.concat = heads, features, concat
        self.negative_slope = negative_slope
        self.backend = backend
        self.dtype = dtype
        self.lin = nn.Linear(in_features, heads * features, bias=False)
        glorot_uniform_(self.lin.weight, generator)
        self.att_src = nn.Parameter(torch.empty(1, heads, features))
        self.att_dst = nn.Parameter(torch.empty(1, heads, features))
        _glorot_uniform_heads_(self.att_src, generator)
        _glorot_uniform_heads_(self.att_dst, generator)
        dim = heads * features if concat else features
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None
        self.to(dev)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        H, D = self.heads, self.features
        with span("geot.conv.gat"):
            if self.dtype is None:
                xh = self.lin(x)
            else:
                xh = torch.nn.functional.linear(x.to(self.dtype),
                                                self.lin.weight.to(self.dtype))
            xh = xh.reshape(-1, H, D)
            with span("geot.gat.logits"):
                alpha_src = (xh * self.att_src.to(xh.dtype)).sum(dim=-1)  # [nodes, H]
                alpha_dst = (xh * self.att_dst.to(xh.dtype)).sum(dim=-1)
            out = gat_attention_spmm(graph, xh, alpha_src, alpha_dst,
                                     negative_slope=self.negative_slope, backend=self.backend)
            out = out.reshape(-1, H * D) if self.concat else out.mean(dim=1)
            if self.bias is not None:
                out = out + self.bias.to(out.dtype)
            return out


class MLP(nn.Module):
    """The MLP inside GIN (reference `MLP`, conv.py:218-234): Dense layers
    to the widths in `hidden`, ReLU between them. `lins[j]` is the flax
    `Dense_{j}`; `dtype` is the compute dtype."""

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int],
        *,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        widths = [in_features] + list(hidden)
        self.lins = nn.ModuleList(_dense(a, b, generator) for a, b in zip(widths[:-1],
                                                                             widths[1:]))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, lin in enumerate(self.lins):
            x = _linear(lin, x, self.dtype)
            if j + 1 < len(self.lins):
                x = torch.relu(x)
        return x


class GINConv(nn.Module):
    """GIN: out = MLP((1 + eps) * x_i + sum_{j->i} x_j) (reference
    conv.py:237-263), the MLP [hidden, features] wide (`hidden` defaults to
    `features`). The sum is the unweighted fused SpMM; the graph should
    hold no self-loops. With `train_eps` eps is a parameter (the flax
    `eps`, a scalar), else a constant. `dtype` is the compute dtype, as in
    `GCNConv`; the MLP's weights are drawn as flax's `nn.Dense` does from
    `generator` on the CPU and moved to `device` (default: the CUDA
    card)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        hidden: Optional[int] = None,
        eps: float = 0.0,
        train_eps: bool = False,
        backend: str = "auto",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.backend = backend
        self.dtype = dtype
        self.eps_value = float(eps)
        self.eps = nn.Parameter(torch.tensor(float(eps))) if train_eps else None
        self.mlp = MLP(in_features, [hidden or features, features], dtype=dtype,
                       generator=generator, device=dev)
        self.to(dev)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        with span("geot.conv.gin"):
            if self.dtype is not None:
                x = x.to(self.dtype)
            agg = segment_spmm(graph, x, reduce="sum", backend=self.backend)
            eps = (self.eps.to(x.dtype) if self.eps is not None
                   else torch.tensor(self.eps_value, dtype=x.dtype, device=x.device))
            return self.mlp((1.0 + eps) * x + agg)


class SGConv(nn.Module):
    """Simplified GCN: out = A_hat^k X W + b (reference conv.py:313-333).
    The graph must hold self-loops. A graph with slot weights carries the
    GCN norm and the SpMM takes it; otherwise the norm is computed per call
    (`gcn_edge_weight`) and taken as per-call weights, also where the
    graph's own weights already hold a baked norm (the reference's double
    normalization, ROADMAP C.1, reproduced). `dense` is the flax
    `Dense_0`, drawn as flax does from `generator`."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        k: int = 2,
        use_bias: bool = True,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.k = int(k)
        self.backend = backend
        self.dense = _dense(in_features, features, generator, use_bias)
        self.to(dev)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        with span("geot.conv.sg"):
            w = None if graph.w_slots is not None else gcn_edge_weight(graph, x.dtype)
            for _ in range(self.k):
                x = segment_spmm(graph, x, edge_weight=w, backend=self.backend)
            return self.dense(x)


class APPNPConv(nn.Module):
    """APPNP propagation: z_{k+1} = (1 - alpha) A_hat z_k + alpha h, k times
    from z_0 = h (reference conv.py:336-357), over already transformed
    features; no parameters. The graph must hold self-loops; the norm is
    taken as in `SGConv` (per call unless the graph has slot weights)."""

    def __init__(self, k: int = 10, alpha: float = 0.1, backend: str = "auto"):
        super().__init__()
        self.k, self.alpha, self.backend = int(k), float(alpha), backend

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        with span("geot.conv.appnp"):
            w = None if graph.w_slots is not None else gcn_edge_weight(graph, x.dtype)
            h = x
            for _ in range(self.k):
                x = (1.0 - self.alpha) * segment_spmm(graph, x, edge_weight=w,
                                                      backend=self.backend) + self.alpha * h
            return x
