"""Plain reference of the GCN the configurations state (Kipf and Welling;
the OGB products example's `GCN`): each layer x W^T, the weighted sum over
in-edges (the graph's baked norm), plus a bias; ReLU and dropout between
layers.

Parameter names are the state-dict names the program's `GCN` takes, so
that the weights the benchmark makes can be handed to both sides.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gnnbench.reference.common import RefGraph, dropout, edge_sum, linear


def widths(m: Dict):
    w = [m["in"]] + [m["hidden"]] * (m["layers"] - 1) + [m["out"]]
    return list(zip(w[:-1], w[1:]))


def param_shapes(m: Dict) -> Dict[str, tuple]:
    """name -> (shape, init kind)."""
    out = {}
    for i, (fi, fo) in enumerate(widths(m)):
        out[f"convs.{i}.lin.weight"] = ((fo, fi), "weight")
        out[f"convs.{i}.bias"] = ((fo,), "bias")
    return out


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, g: RefGraph, m: Dict, *,
            training: bool, generator: Optional[torch.Generator], precision: str) -> torch.Tensor:
    layers = widths(m)
    h = x
    for i in range(len(layers)):
        h = edge_sum(g, linear(h, p[f"convs.{i}.lin.weight"], precision)) + p[f"convs.{i}.bias"]
        if i + 1 < len(layers):
            h = torch.relu(h)
            if training and m.get("dropout", 0.0) > 0:
                h = dropout(h, m["dropout"], generator)
    return h
