"""Stacked-conv GNNs, SGC and APPNP.

Port of `geot_tpu/models/basic_gnn.py:32-184` (`BasicGNN`, `GCN`, `GIN`,
`GraphSAGE`, `GAT`, `SGC`, `APPNP`) and of `MODELS`, for `jk=None`,
`norm=None`, ReLU and dropout: num_layers convs, each but the last
followed by ReLU and dropout, the last mapping to `out_features`.
`conv_kwargs` and the compute `dtype` reach every conv, as in the
reference's `_make_conv`. Other norm/jk options raise (`act_first` is not
ported either: ROADMAP A.7). Dropout is the identity in eval mode; in
training mode its masks come from the `torch.Generator` the caller passes
to `forward`, never from the global RNG.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
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

__all__ = ["BasicGNN", "GCN", "GIN", "GraphSAGE", "GAT", "SGC", "APPNP", "MODELS"]


def flax_dropout(x: torch.Tensor, rate: float, training: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the identity out of training or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    if generator.device != x.device:
        raise ValueError(f"dropout generator is on {generator.device}, "
                         f"activations on {x.device}: pass a generator on "
                         f"the activations' device")
    if rate >= 1.0:
        return torch.zeros_like(x)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    keep = u >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class BasicGNN(nn.Module):
    """Conv stack. Layer i is `convs[i]` (the reference's `<Conv>_{i}`)."""

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
        conv_kwargs: Optional[Dict[str, Any]] = None,
        dtype: Optional[torch.dtype] = None,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if norm is not None:
            raise NotImplementedError(f"norm={norm!r} is not ported (ROADMAP A.7)")
        if jk is not None:
            raise NotImplementedError(f"jk={jk!r} is not ported (ROADMAP A.7)")
        dev = resolve_device(device)
        self.dropout_rate = float(dropout_rate)
        out_dim = out_features or hidden_features
        kw = dict(conv_kwargs or {})
        kw.setdefault("backend", backend)
        kw.setdefault("dtype", dtype)
        convs = []
        width_in = in_features
        for i in range(num_layers):
            width = out_dim if i == num_layers - 1 else hidden_features
            convs.append(self.conv_cls(width_in, width, generator=generator,
                                       device=dev, **kw))
            width_in = width
        self.convs = nn.ModuleList(convs)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return flax_dropout(x, self.dropout_rate, self.training, generator)

    def forward(
        self, x: torch.Tensor, graph: Graph, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x, graph)
            if i == len(self.convs) - 1:
                break
            x = torch.relu(x)
            x = self._dropout(x, generator)
        return x


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
