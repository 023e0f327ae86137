"""Stacked-conv GNNs, SGC and APPNP.

Port of `geot_tpu/models/basic_gnn.py:32-184` (`BasicGNN`, `GCN`, `GIN`,
`GraphSAGE`, `GAT`, `SGC`, `APPNP`) and of `MODELS`, with ReLU: num_layers
convs, each but the last followed by the norm (`norm` "layer" or "batch";
after the activation with `act_first`), ReLU and dropout, the last
mapping to `out_features`; with jumping knowledge (`jk` "last", "cat" or
"max") the last conv keeps the hidden width and is followed by the same,
and a linear head maps the combined layers to `out_features`.
`conv_kwargs` and the compute `dtype` reach every conv, as in the
reference's `_make_conv`. Dropout is the identity in eval mode; in
training mode its masks come from the `torch.Generator` the caller passes
to `forward`, never from the global RNG.

The norms follow flax, whose defaults are not torch's: `FlaxLayerNorm`
takes epsilon 1e-6 (torch 1e-5), and `FlaxBatchNorm` keeps running
averages with momentum 0.99 (torch's 0.01) of the biased batch variance
(torch's `BatchNorm1d` keeps the unbiased one). A norm computes in
float32 at least (flax promotes the input to its float32 parameters).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from geot_tpu_torch.graph.structures import Graph
from geot_tpu_torch.models.conv import (
    APPNPConv,
    GATConv,
    GCNConv,
    GINConv,
    SAGEConv,
    SGConv,
    _dense,
)
from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.utils.trace import span

__all__ = ["BasicGNN", "GCN", "GIN", "GraphSAGE", "GAT", "SGC", "APPNP", "MODELS",
           "FlaxLayerNorm", "FlaxBatchNorm"]

NORMS = (None, "layer", "batch")
JKS = (None, "last", "cat", "max")


def flax_dropout(x: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the identity out of training or at rate 0. Under a
    profiler a drawn dropout is the span "geot.dropout"."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    if generator.device != x.device:
        raise ValueError(f"dropout generator is on {generator.device}, "
                         f"activations on {x.device}: pass a generator on "
                         f"the activations' device")
    with span("geot.dropout"):
        if rate >= 1.0:
            return torch.zeros_like(x)
        u = torch.rand(x.shape, generator=generator, device=x.device)
        keep = u >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _promoted(x: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """x in the dtype flax promotes it and a parameter to (float32 for a
    bfloat16 x and float32 parameters)."""
    return x.to(torch.promote_types(x.dtype, param.dtype))


class FlaxLayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the last axis: epsilon 1e-6, `weight`
    (flax `scale`) and `bias`."""

    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(_promoted(x, self.weight), self.weight.shape, self.weight,
                            self.bias, self.eps)


class FlaxBatchNorm(nn.Module):
    """flax `nn.BatchNorm(use_running_average=not training)` over axis 0:
    epsilon 1e-5, `weight` (flax `scale`), `bias`, and the running averages
    `running_mean` / `running_var` (flax's `batch_stats` mean / var, from 0
    and 1). In training mode it normalizes by the batch's mean and biased
    variance and moves the averages to momentum * average + (1 - momentum)
    * batch statistic (momentum 0.99); in eval mode it normalizes by the
    averages. Under a profiler its forward is the span "geot.norm.batch"."""

    def __init__(self, width: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("geot.norm.batch"):
            x = _promoted(x, self.weight)
            if self.training:
                mean = x.mean(dim=0)
                var = x.var(dim=0, unbiased=False)
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                    self.running_var.mul_(m).add_((1 - m) * var.detach())
            else:
                mean, var = self.running_mean, self.running_var
            return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias


class BasicGNN(nn.Module):
    """Conv stack. Layer i is `convs[i]` (the reference's `<Conv>_{i}`),
    its norm `norms[i]` (`LayerNorm_{i}` / `BatchNorm_{i}`), and the jk
    head `head` (the top-level `Dense_0`)."""

    conv_cls: type = GCNConv

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        num_layers: int,
        out_features: Optional[int] = None,
        *,
        dropout_rate: float = 0.0,
        norm: Optional[str] = None,
        jk: Optional[str] = None,
        act_first: bool = False,
        conv_kwargs: Optional[Dict[str, Any]] = None,
        dtype: Optional[torch.dtype] = None,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm={norm!r}: one of {NORMS}")
        if jk not in JKS:
            raise ValueError(f"jk={jk!r}: one of {JKS}")
        dev = resolve_device(device)
        self.dropout_rate = float(dropout_rate)
        self.jk, self.act_first = jk, bool(act_first)
        out_dim = out_features or hidden_features
        kw = dict(conv_kwargs or {})
        kw.setdefault("backend", backend)
        kw.setdefault("dtype", dtype)
        convs, widths = [], []
        width_in = in_features
        for i in range(num_layers):
            # under jk the last conv keeps the hidden width
            width = out_dim if (i == num_layers - 1 and jk is None) else hidden_features
            conv = self.conv_cls(width_in, width, generator=generator, device=dev, **kw)
            # a GATConv that concatenates its heads is heads times wider
            width_in = width * conv.heads if getattr(conv, "concat", False) else width
            convs.append(conv)
            widths.append(width_in)
        self.convs = nn.ModuleList(convs)
        n_norms = num_layers if jk is not None else num_layers - 1
        norm_cls = {"layer": FlaxLayerNorm, "batch": FlaxBatchNorm}.get(norm)
        self.norms = (None if norm_cls is None else
                      nn.ModuleList(norm_cls(w) for w in widths[:n_norms]).to(dev))
        self.head = None
        if jk is not None:
            width = sum(widths) if jk == "cat" else widths[-1]
            self.head = _dense(width, out_dim, generator).to(dev)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return flax_dropout(x, self.dropout_rate, self.training, generator)

    def forward(
        self, x: torch.Tensor, graph: Graph, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        xs = []
        for i, conv in enumerate(self.convs):
            x = conv(x, graph)
            if i == len(self.convs) - 1 and self.jk is None:
                break
            if self.act_first:
                x = torch.relu(x)
            if self.norms is not None:
                x = self.norms[i](x)
            if not self.act_first:
                x = torch.relu(x)
            x = self._dropout(x, generator)
            xs.append(x)
        if self.jk is None:
            return x
        if self.jk == "cat":
            x = torch.cat(xs, dim=-1)
        elif self.jk == "max":
            x = torch.stack(xs).amax(dim=0)
        return self.head(_promoted(x, self.head.weight))


class GCN(BasicGNN):
    """GCNConv stack. The graph must include self-loops
    (`prepare_graph(add_self_loops=True)`)."""

    conv_cls = GCNConv


class GIN(BasicGNN):
    """GINConv stack (each conv's MLP [width, width]; `conv_kwargs` may
    carry eps, train_eps and hidden); the graph holds no self-loops."""

    conv_cls = GINConv


class GraphSAGE(BasicGNN):
    """SAGEConv stack, mean aggregation; the graph holds no self-loops."""

    conv_cls = SAGEConv


class GAT(BasicGNN):
    """GATConv stack (`conv_kwargs` carries heads, concat, ...; each
    layer's width is its per-head width). The graph must include
    self-loops."""

    conv_cls = GATConv


class SGC(nn.Module):
    """One SGConv of k = num_layers propagations to `out_features` (or
    `hidden_features`, otherwise unused: the reference keeps it for MODELS'
    uniform signature). `convs[0]` is the flax `SGConv_0`. The graph must
    include self-loops."""

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        num_layers: int = 2,
        out_features: Optional[int] = None,
        *,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.convs = nn.ModuleList([SGConv(in_features, out_features or hidden_features,
                                           k=num_layers, backend=backend,
                                           generator=generator, device=dev)])

    def forward(self, x: torch.Tensor, graph: Graph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.convs[0](x, graph)


class APPNP(nn.Module):
    """An MLP of num_layers Dense layers (ReLU and dropout between them;
    `lins[i]` is the flax `Dense_{i}`), then `APPNPConv` (k propagations,
    teleport alpha; the flax `APPNPConv_0`, no parameters). The graph must
    include self-loops."""

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        num_layers: int = 2,
        out_features: Optional[int] = None,
        *,
        k: int = 10,
        alpha: float = 0.1,
        dropout_rate: float = 0.0,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate = float(dropout_rate)
        out_dim = out_features or hidden_features
        widths = [in_features] + [hidden_features] * (num_layers - 1) + [out_dim]
        self.lins = nn.ModuleList(_dense(a, b, generator) for a, b in zip(widths[:-1],
                                                                             widths[1:]))
        self.prop = APPNPConv(k=k, alpha=alpha, backend=backend)
        self.to(dev)

    def forward(self, x: torch.Tensor, graph: Graph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if i + 1 < len(self.lins):
                x = flax_dropout(torch.relu(x), self.dropout_rate, self.training, generator)
        return self.prop(x, graph)


# name -> (model class, needs_self_loops): the reference's MODELS
# (`geot_tpu/models/basic_gnn.py:176-184`, its testmodels matrix)
MODELS = {
    "gcn": (GCN, True),
    "gin": (GIN, False),
    "graphsage": (GraphSAGE, False),
    "gat": (GAT, True),
    "sgc": (SGC, True),
    "appnp": (APPNP, True),
}
