"""Plain PyTorch pieces the references share: the graph's self-loops and
GCN norm, a blocked edge sum with its gradient, dropout drawn as the
program draws it, flax's BatchNorm, the masked loss and AdamW.

Nothing here imports the program (`geot_tpu_torch`), JAX or the JAX
package. The references run in float32 with TF32 off; `precision="tf32"`
is the control, the nearest precision below, which must come out as not
correct.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["RefGraph", "ref_graph", "edge_sum", "linear", "dropout", "batch_norm",
           "masked_nll", "adamw_step", "matmul_precision"]

# edges per block times columns: a block's float64 rows stay under 2 GiB
_BLOCK_ELEMS = 1 << 28


@dataclass
class RefGraph:
    src: torch.Tensor  # [E] int64
    dst: torch.Tensor  # [E] int64
    num_nodes: int
    weight: Optional[torch.Tensor]  # [E] float32 (the GCN norm) or None

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())


def ref_graph(src: np.ndarray, dst: np.ndarray, num_nodes: int, *, self_loops: bool,
              normalize: Optional[str], device) -> RefGraph:
    """The graph as the configuration states it, worked out from the
    edges: existing self-loops replaced by the full diagonal (PyG
    `add_remaining_self_loops`), and with `normalize="gcn"` each edge
    weighted by deg(dst)^-1/2 * deg(src)^-1/2 over in-degrees."""
    s = torch.as_tensor(np.asarray(src), device=device).long()
    d = torch.as_tensor(np.asarray(dst), device=device).long()
    if self_loops:
        keep = s != d
        loop = torch.arange(num_nodes, device=device)
        s = torch.cat([s[keep], loop])
        d = torch.cat([d[keep], loop])
    w = None
    if normalize == "gcn":
        deg = torch.zeros(num_nodes, dtype=torch.float64, device=device)
        deg.index_add_(0, d, torch.ones(d.numel(), dtype=torch.float64, device=device))
        dinv = torch.where(deg > 0, deg.clamp(min=1e-12).rsqrt(), torch.zeros_like(deg))
        w = (dinv[d] * dinv[s]).float()
    elif normalize is not None:
        raise ValueError(f"normalize={normalize!r}")
    return RefGraph(s, d, num_nodes, w)


def _blocks(n: int, cols: int) -> Iterator[slice]:
    step = max(1, _BLOCK_ELEMS // max(cols, 1))
    for lo in range(0, n, step):
        yield slice(lo, min(n, lo + step))


class _EdgeSum(torch.autograd.Function):
    """out[dst[e], h] += att[e, h] * x[src[e], h] over [N, H, D], in blocks
    of edges, each product and sum in float64 and the result rounded once
    to x's type: a float32 sum over a hub row of millions of edges would
    add the reference's own rounding to what is compared. The gradient of
    x is the same sum over the reversed edges, that of att the per-edge,
    per-head dot of the output gradient's dst row and x's src row."""

    @staticmethod
    def forward(ctx, att, x, src, dst, n_out):
        out = torch.zeros((n_out,) + tuple(x.shape[1:]), dtype=torch.float64, device=x.device)
        cols = x[0].numel() if x.shape[0] else 1
        for b in _blocks(src.numel(), cols):
            out.index_add_(0, dst[b], att[b].double().unsqueeze(-1)
                           * x.index_select(0, src[b]).double())
        ctx.save_for_backward(att, x, src, dst)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        att, x, src, dst = ctx.saved_tensors
        cols = x[0].numel() if x.shape[0] else 1
        dx = (torch.zeros(x.shape, dtype=torch.float64, device=x.device)
              if ctx.needs_input_grad[1] else None)
        datt = torch.empty_like(att) if ctx.needs_input_grad[0] else None
        for b in _blocks(src.numel(), cols):
            gd = g.index_select(0, dst[b]).double()
            if dx is not None:
                dx.index_add_(0, src[b], att[b].double().unsqueeze(-1) * gd)
            if datt is not None:
                datt[b] = (gd * x.index_select(0, src[b]).double()).sum(-1).to(att.dtype)
        return datt, None if dx is None else dx.to(x.dtype), None, None, None


def edge_sum(g: RefGraph, x: torch.Tensor, att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum over edges j -> i of w_e x_j: x [N, F] with the graph's weights
    (or none), or x [N, H, D] with per-edge, per-head `att` [E, H]."""
    if att is not None:
        return _EdgeSum.apply(att, x, g.src, g.dst, g.num_nodes)
    w = g.weight if g.weight is not None else x.new_ones(g.num_edges)
    out = _EdgeSum.apply(w.unsqueeze(-1), x.unsqueeze(1), g.src, g.dst, g.num_nodes)
    return out.squeeze(1)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, nearest even), as float32."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """float32 products with TF32 off ("fp32"), or on ("tf32") on the card."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision={precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w.T. In "tf32" on the CPU, which has no TF32 unit, the operands
    are rounded to TF32 first, which is what the card's TF32 products do."""
    if precision == "tf32" and not x.is_cuda:
        return _TF32Linear.apply(x, w)
    return x @ w.t()


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _tf32(x) @ _tf32(w).t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gt = _tf32(g)
        return gt @ _tf32(w), gt.t() @ _tf32(x)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Keep with probability 1 - rate (u >= rate for u ~ U[0, 1) drawn
    from `generator` in x's shape), kept values scaled by 1 / (1 - rate)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u >= rate, x / (1.0 - rate), torch.zeros_like(x))


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, training: bool,
               eps: float = 1e-5) -> torch.Tensor:
    """flax BatchNorm over axis 0: the batch's mean and biased variance in
    training, the running averages otherwise."""
    if training:
        mean, var = x.mean(0), x.var(0, unbiased=False)
    else:
        mean, var = p[prefix + "running_mean"], p[prefix + "running_var"]
    return (x - mean) * (p[prefix + "weight"] * torch.rsqrt(var + eps)) + p[prefix + "bias"]


def masked_nll(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the masked rows."""
    ls = torch.log_softmax(logits, dim=-1)
    nll = -ls.gather(1, y.long()[:, None])[:, 0]
    return nll[mask].sum() / mask.sum().clamp(min=1)


def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, list], t: int, lr: float, weight_decay: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW update in place (decoupled decay, bias-corrected moments);
    `state[name]` holds [m, v]."""
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m, v = state.setdefault(k, [torch.zeros_like(p), torch.zeros_like(p)])
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * weight_decay)
            denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
            p.addcdiv_(m / (1 - b1 ** t), denom, value=-lr)
