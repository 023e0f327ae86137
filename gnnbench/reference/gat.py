"""Plain reference of DGL's ogbn-arxiv GAT (`examples/pytorch/ogb/
ogbn-arxiv/models.py`, class `GAT`, with `gat.py`'s defaults): input
dropout; each layer projects h to H heads of D columns, takes per-edge
logits LeakyReLU(a_src . x_src + a_dst . x_dst) per head, a softmax over
each destination's in-edges, the attention-weighted sum of the source rows
with the heads concatenated, plus a bias-free residual projection of h;
BatchNorm over H * D columns, ReLU and dropout between layers; the last
layer's heads averaged, plus one bias.

Parameter names are the state-dict names of the benchmark's stack
(`gnnbench/stacks/dgl_arxiv_gat.py`), so that the weights the benchmark
makes can be handed to both sides.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gnnbench.reference.common import RefGraph, batch_norm, dropout, edge_sum, linear


def widths(m: Dict):
    """(inputs, per-head outputs) of each layer."""
    h = m["heads"]
    fi = [m["in"]] + [h * m["hidden"]] * (m["layers"] - 1)
    fo = [m["hidden"]] * (m["layers"] - 1) + [m["out"]]
    return list(zip(fi, fo))


def param_shapes(m: Dict) -> Dict[str, tuple]:
    """name -> (shape, init kind)."""
    out = {}
    h = m["heads"]
    layers = widths(m)
    for i, (fi, fo) in enumerate(layers):
        out[f"convs.{i}.lin.weight"] = ((h * fo, fi), "weight")
        out[f"convs.{i}.att_src"] = ((1, h, fo), "att")
        out[f"convs.{i}.att_dst"] = ((1, h, fo), "att")
        out[f"res.{i}.weight"] = ((h * fo, fi), "weight")
    for i, (_, fo) in enumerate(layers[:-1]):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"norms.{i}.{k}"] = ((h * fo,), f"bn_{k}")
    out["bias_last"] = ((m["out"],), "bias")
    return out


def edge_softmax(logits: torch.Tensor, g: RefGraph) -> torch.Tensor:
    """Softmax of [E, H] logits over each destination's in-edges, in
    float64 (a hub's sum runs over ~10^5 edges), rounded once to float32."""
    z = logits.double()
    idx = g.dst.unsqueeze(-1).expand_as(z)
    mx = torch.full((g.num_nodes, z.shape[1]), float("-inf"), device=z.device,
                    dtype=z.dtype).scatter_reduce(0, idx, z.detach(), "amax")
    ex = torch.exp(z - mx[g.dst])
    den = torch.zeros_like(mx).index_add(0, g.dst, ex)
    return (ex / den[g.dst]).to(logits.dtype)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, g: RefGraph, m: Dict, *,
            training: bool, generator: Optional[torch.Generator], precision: str) -> torch.Tensor:
    layers = widths(m)
    heads, slope = m["heads"], m["negative_slope"]
    h = x
    if training and m["input_dropout"] > 0:
        h = dropout(h, m["input_dropout"], generator)
    for i, (_, fo) in enumerate(layers):
        xh = linear(h, p[f"convs.{i}.lin.weight"], precision).reshape(-1, heads, fo)
        a_src = (xh * p[f"convs.{i}.att_src"]).sum(-1)
        a_dst = (xh * p[f"convs.{i}.att_dst"]).sum(-1)
        e = torch.nn.functional.leaky_relu(a_src[g.src] + a_dst[g.dst], slope)
        agg = edge_sum(g, xh, edge_softmax(e, g)).reshape(-1, heads * fo)
        h = agg + linear(h, p[f"res.{i}.weight"], precision)
        if i + 1 < len(layers):
            h = torch.relu(batch_norm(h, p, f"norms.{i}.", training))
            if training and m["dropout"] > 0:
                h = dropout(h, m["dropout"], generator)
    return h.reshape(-1, heads, m["out"]).mean(1) + p["bias_last"]
