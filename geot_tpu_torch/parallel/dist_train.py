"""Full-graph GCN training over several processes.

Port of `geot_tpu/parallel/dist_train.py` (`init_gcn_params` :29,
`gcn_forward` :42, `shard_inputs` :62, `make_dist_train_step` :71). Node
features, labels and masks are split by destination range, one block per
rank; every aggregation is a `halo_spmm`; the dense transforms run on the
rank's own rows; the parameters are replicated. The reference lets
`jax.grad` of the globally sharded loss put in the gradients' psum; here
each rank's masked NLL is divided by the global mask count, its backward
gives the rank's share of the weight gradients (`halo_spmm`'s backward
returns the peers' parts of its rows' gradients), and one all-reduce sums
the shares.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from geot_tpu_torch.parallel.halo_spmm import block_nodes, halo_spmm, node_sharding
from geot_tpu_torch.parallel.partition import PartitionedGraph, PartView
from geot_tpu_torch.utils.device import resolve_device

__all__ = ["init_gcn_params", "params_from_jax", "gcn_forward", "make_dist_train_step",
           "shard_inputs"]


def init_gcn_params(dims: Sequence[int], *, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> dict:
    """Plain GCN parameters {"w{i}": [a, b], "b{i}": [b]} for dims = [in,
    hidden..., out]: weights normal times sqrt(2 / (a + b)), drawn from
    `generator` on its device, biases zero; leaves that require grad, on
    `device` (`resolve_device`: the card by default, the CPU only when
    asked for)."""
    dev = resolve_device(device)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(a, b, generator=generator, dtype=dtype,
                        device=generator.device) * math.sqrt(2.0 / (a + b))
        params[f"w{i}"] = w.to(dev).requires_grad_()
        params[f"b{i}"] = torch.zeros(b, dtype=dtype, device=dev).requires_grad_()
    return params


def params_from_jax(params: dict, device=None) -> dict:
    """The JAX package's `init_gcn_params` tree (the same names, arrays
    brought to numpy) as the port's parameters on `device`
    (`resolve_device`: the card by default)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev).requires_grad_()
            for k, v in params.items()}


def gcn_forward(params: dict, x_local: torch.Tensor, part: PartView, group=None, *,
                backend: str = "auto") -> torch.Tensor:
    """L-layer GCN on this rank's block: x <- A (x W_i) + b_i, ReLU between
    layers; the GCN norm is baked into the partition's edge weights. The
    blocked pad rows get the bias, as in the reference."""
    n_layers = len(params) // 2
    x = x_local
    for i in range(n_layers):
        x = halo_spmm(x @ params[f"w{i}"], part, group, backend=backend) + params[f"b{i}"]
        if i + 1 < n_layers:
            x = torch.relu(x)
    return x


def shard_inputs(x, y, mask, pg: PartitionedGraph, rank: int, device=None):
    """The rank's blocked rows of node features, labels and mask, on
    `device` (`resolve_device`: the card by default)."""
    dev = resolve_device(device)
    rows = node_sharding(pg, rank)

    def put(a):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return block_nodes(a, pg)[rows].to(dev)

    return put(x), put(y), put(mask)


def make_dist_train_step(optimizer: torch.optim.Optimizer, part: PartView, group=None, *,
                         backend: str = "auto"):
    """step(params, x, y, mask) -> the global loss (a 0-d float32 tensor,
    bit-identical on every rank), with the optimizer's update applied to
    `params` (the dict the optimizer was made over, replicated).

    The masked cross-entropy's mean runs over the global node axis: the
    mask count is all-reduced first, each rank divides its NLL sum by it,
    and after the backward the gradients and the loss are summed over the
    ranks in one all-reduce of a flat buffer (parameter order, then the
    loss), so every rank applies the same update."""

    def step(params: dict, x, y, mask):
        m = mask.float()
        count = m.sum().reshape(1)
        dist.all_reduce(count, group=group)
        optimizer.zero_grad(set_to_none=False)
        logits = gcn_forward(params, x, part, group, backend=backend)
        nll = F.cross_entropy(logits.float(), y.long(), reduction="none")
        loss = (nll * m).sum() / count.clamp(min=1.0)[0]
        loss.backward()
        grads = [p.grad.reshape(-1) for p in params.values()]
        flat = torch.cat(grads + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=group)
        off = 0
        for p in params.values():
            n = p.numel()
            p.grad.copy_(flat[off:off + n].view_as(p))
            off += n
        optimizer.step()
        return flat[off]

    return step
