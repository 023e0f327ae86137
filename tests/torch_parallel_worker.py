"""Rank workers of the parallel tests, run by `spawn_ranks` in spawned
processes. This module imports no JAX: each child imports it afresh.

Every worker builds the partition itself from the same numpy inputs (the
host build is deterministic) and returns numpy arrays.
"""

import numpy as np
import torch

from geot_tpu_torch.parallel import (
    block_nodes,
    gcn_forward,
    halo_spmm,
    make_dist_train_step,
    node_sharding,
    params_from_jax,
    partition_graph,
    shard_inputs,
)


def _blocked(a: np.ndarray, pg, rank: int, device) -> torch.Tensor:
    return block_nodes(torch.from_numpy(a), pg)[node_sharding(pg, rank)].to(device)


def halo_cases(rank, world, cases, device="cpu"):
    """{(case, backend): (this rank's output block, its x gradient)} of
    `halo_spmm` for each case: a dict of src, dst, num_nodes, w (or None),
    x, cot (the cotangent of the output, unblocked) and partition
    keywords, run on every backend in case["backends"]."""
    results = {}
    for c in cases:
        pg = partition_graph(c["src"], c["dst"], c["num_nodes"], world, edge_weight=c["w"],
                             **c["kw"])
        view = pg.part(rank, device)
        cot = _blocked(c["cot"], pg, rank, device)
        for backend in c["backends"]:
            xl = _blocked(c["x"], pg, rank, device).requires_grad_()
            out = halo_spmm(xl, view, backend=backend)
            (out * cot).sum().backward()
            results[(c["name"], backend)] = (out.detach().cpu().numpy(),
                                             xl.grad.cpu().numpy())
    return results


def exchange_order(rank, world, cases):
    """The order in which one forward and backward of `halo_spmm` start the
    exchange, run the interior and boundary reduces and wait, per case:
    {case: (forward events, backward events)}."""
    import importlib

    import torch.distributed as dist

    # the module (the package's `halo_spmm` is the function)
    hs = importlib.import_module("geot_tpu_torch.parallel.halo_spmm")

    events = []

    class Work:
        def __init__(self, work):
            self.work = work

        def wait(self):
            events.append("wait")
            return self.work.wait()

    def traced(name, fn):
        def run(*args, **kw):
            events.append(name)
            return fn(*args, **kw)
        return run

    a2a = dist.all_to_all_single
    hs.dist.all_to_all_single = lambda *a, **kw: (events.append("start"),
                                                  Work(a2a(*a, **kw)))[1]
    for name in ("_interior_reduce", "_boundary_reduce", "_boundary_reduce_t", "_send_back"):
        setattr(hs, name, traced(name, getattr(hs, name)))
    out = {}
    for c in cases:
        pg = partition_graph(c["src"], c["dst"], c["num_nodes"], world, edge_weight=c["w"],
                             **c["kw"])
        view = pg.part(rank, "cpu")
        xl = _blocked(c["x"], pg, rank, "cpu").requires_grad_()
        events.clear()
        y = hs.halo_spmm(xl, view)
        fwd = list(events)
        events.clear()
        y.sum().backward()
        out[c["name"]] = (fwd, list(events))
    return out


def mismatched_parts(rank, world, c):
    """halo_spmm over a 3-part partition in this `world`-rank group (it
    raises)."""
    pg = partition_graph(c["src"], c["dst"], c["num_nodes"], 3, edge_weight=c["w"], **c["kw"])
    return halo_spmm(torch.zeros(pg.nodes_per_part, 4), pg.part(rank, "cpu"))


def dist_train(rank, world, g, params_np, steps, device="cpu"):
    """`steps` Adam steps (lr 0.01) of the GCN over a `world`-part
    partition of g (src, dst, w, x, y, train_mask, num_nodes), from the
    carried-across parameters: (the first forward's output block, the
    losses, the final parameters)."""
    pg = partition_graph(g["src"], g["dst"], g["num_nodes"], world, edge_weight=g["w"],
                         e_tile=32, s_tile=32)
    view = pg.part(rank, device)
    x, y, m = shard_inputs(g["x"], g["y"], g["train_mask"], pg, rank, device)
    params = params_from_jax(params_np, device)
    with torch.no_grad():
        out0 = gcn_forward(params, x, view).cpu().numpy()
    step = make_dist_train_step(torch.optim.Adam(params.values(), lr=1e-2), view)
    losses = [step(params, x, y, m).item() for _ in range(steps)]
    return out0, losses, {k: v.detach().cpu().numpy() for k, v in params.items()}
