"""DGL's ogbn-arxiv GAT (`examples/pytorch/ogb/ogbn-arxiv/models.py`,
class `GAT`, with `gat.py`'s defaults) built from the program's layers:
the program's `GATConv` (bias-free, heads concatenated), its BatchNorm and
its dropout; the residual projection and the last bias are plain torch, as
the source's are.

    h = input_dropout(x)
    for layer i:  h = conv_i(h) + res_i(h)          (heads concatenated)
                  not the last: BatchNorm over heads * hidden, ReLU, dropout
    out = mean over the last layer's heads of h, plus bias_last

The program's `BasicGNN` gives every layer one `conv_kwargs` and has no
residual or input dropout, so it cannot state this model; the layers it is
made of are the program's own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

__all__ = ["build"]


class ArxivGAT(nn.Module):
    def __init__(self, m: Dict, conv_cls, norm_cls, dropout_fn, device):
        super().__init__()
        self.m, self.dropout_fn = m, dropout_fn
        heads, layers = m["heads"], m["layers"]
        convs, res, norms = [], [], []
        for i in range(layers):
            fi = m["in"] if i == 0 else heads * m["hidden"]
            fo = m["hidden"] if i < layers - 1 else m["out"]
            convs.append(conv_cls(fi, fo, heads=heads, concat=True,
                                  negative_slope=m["negative_slope"], use_bias=False,
                                  device=device))
            res.append(nn.Linear(fi, heads * fo, bias=False, device=device))
            if i < layers - 1:
                norms.append(norm_cls(heads * fo))
        self.convs, self.res = nn.ModuleList(convs), nn.ModuleList(res)
        self.norms = nn.ModuleList(norms).to(device)
        self.bias_last = nn.Parameter(torch.zeros(m["out"], device=device))

    def forward(self, x: torch.Tensor, graph, generator: Optional[torch.Generator] = None):
        m = self.m
        h = self.dropout_fn(x, m["input_dropout"], self.training, generator)
        for i, conv in enumerate(self.convs):
            h = conv(h, graph) + self.res[i](h)
            if i < len(self.norms):
                h = torch.relu(self.norms[i](h))
                h = self.dropout_fn(h, m["dropout"], self.training, generator)
        return h.view(h.shape[0], m["heads"], m["out"]).mean(dim=1) + self.bias_last


def build(config: Dict, device: torch.device) -> nn.Module:
    from geot_tpu_torch.models import GATConv
    from geot_tpu_torch.models.basic_gnn import FlaxBatchNorm, flax_dropout

    return ArxivGAT(config["model"], GATConv, FlaxBatchNorm, flax_dropout, device)
