"""Distributed full-graph GCN training from the shell: the port of the
reference's `scripts/train_dist.py`.

    python -m geot_tpu_torch.scripts.train_dist --dataset pubmed --parts 2 --epochs 50
    python -m geot_tpu_torch.scripts.train_dist --dataset pubmed --parts 4 \
        --dist-backend gloo --device cpu

The dataset is partitioned into `--parts` dst ranges with a halo exchange
(`parallel.partition_graph`, the GCN norm of the whole self-looped graph
as edge weights); one spawned process a part trains the GCN with
replicated parameters (`parallel.make_dist_train_step`, Adam) and the
whole graph's accuracy is summed over the ranks. `--parts 0` takes one
part a card. NCCL (the default) puts one rank on each card and refuses
more parts than cards or the CPU; gloo lets ranks share the cards (rank r
on cuda:(r % cards)) or run on the CPU (`--device cpu`). Rank 0 prints
the reference's lines: the dataset, the partition, the loss every 10
epochs, the mean epoch time and the accuracies.
"""

from __future__ import annotations

import argparse
import importlib
import math
import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from geot_tpu_torch.ops import launch_counts
from geot_tpu_torch.ops.api import BACKENDS
from geot_tpu_torch.parallel import (
    block_nodes,
    gcn_forward,
    init_gcn_params,
    make_dist_train_step,
    node_sharding,
    params_from_jax,
    partition_graph,
    shard_inputs,
    spawn_ranks,
)
from geot_tpu_torch.scripts.train import device_name, load_data
from geot_tpu_torch.utils.device import resolve_device

__all__ = ["main", "run_rank"]

SPLITS = ("train", "val", "test")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m geot_tpu_torch.scripts.train_dist")
    p.add_argument("--dataset", default="pubmed")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--parts", type=int, default=0, help="0 = one part a card")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default="nccl",
                   help="nccl: one rank a card; gloo: ranks share the cards or the CPU")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the cards by default; cpu (with gloo) runs the plain versions")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before the ranks are stopped (default 300 + 10 an epoch)")
    return p.parse_args(argv)


def gcn_normed_edges(src, dst, num_nodes: int):
    """The self-looped graph's edges in dst order (each diagonal edge
    replaced by one loop a node, as `prepare_graph(add_self_loops=True)`
    adds them) and the symmetric GCN norm of `gcn_edge_weight` on them,
    1 / sqrt(deg(dst) * deg(src)): host arrays, for the partition."""
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    keep = src != dst
    loop = np.arange(num_nodes, dtype=np.int32)
    src, dst = np.concatenate([src[keep], loop]), np.concatenate([dst[keep], loop])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    dinv = 1.0 / np.sqrt(np.bincount(dst, minlength=num_nodes).astype(np.float32))
    return src, dst, dinv[dst] * dinv[src]


def _rank_device(rank: int, kind: str) -> torch.device:
    if kind == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def run_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of the run (`spawn_ranks` calls it in a process of its
    own): partition, `job["epochs"]` Adam steps of the GCN over this
    rank's part, then the whole graph's accuracies (each rank's correct
    and mask counts summed). Returns this rank's numbers and its kernels'
    launches during the training loop and during the evaluation."""
    dev = _rank_device(rank, job["device"])
    say = print if rank == 0 else (lambda *a, **k: None)
    n = job["num_nodes"]
    t0 = time.perf_counter()
    pg = partition_graph(job["src"], job["dst"], n, world, edge_weight=job["w"])
    view = pg.part(rank, dev)
    part_s = time.perf_counter() - t0
    say(f"partition: {part_s:.1f}s halo={pg.halo} rows/peer, "
        f"nodes/part={pg.nodes_per_part}", flush=True)

    if job["params"] is not None:
        params = params_from_jax(job["params"], dev)
    else:  # drawn on the CPU, so that every part count starts from the same parameters
        params = init_gcn_params(job["dims"], generator=torch.Generator().manual_seed(0),
                                 device=dev)
    opt = torch.optim.Adam(params.values(), lr=job["lr"])
    step = make_dist_train_step(opt, view, backend=job["backend"])
    x, y, m = shard_inputs(job["x"], job["y"], job["masks"]["train"], pg, rank, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    epochs, losses = job["epochs"], {}
    c0 = launch_counts()
    sync()
    t0 = time.perf_counter()
    for epoch in range(epochs):
        loss = step(params, x, y, m)
        if epoch == 0:  # the first epoch alone: it holds the rank's lazy set-up
            sync()
            first_s = time.perf_counter() - t0
        if epoch % 10 == 9:
            losses[epoch + 1] = float(loss)
            say(f"epoch {epoch + 1}: loss={losses[epoch + 1]:.4f}", flush=True)
    sync()
    dt = (time.perf_counter() - t0) / max(epochs, 1)
    c1 = launch_counts()
    n_layers = len(job["dims"]) - 1
    if epochs:
        say(f"mean epoch time: {dt * 1e3:.1f} ms "
            f"({job['num_edges'] * n_layers / dt / 1e6:.1f}M edge-aggs/s fwd)", flush=True)

    rows = node_sharding(pg, rank)
    with torch.no_grad():
        pred = gcn_forward(params, x, view, backend=job["backend"]).argmax(dim=-1)
        hit = pred == y.long()
        counts = torch.zeros(len(SPLITS), 2, dtype=torch.int64, device=dev)
        for i, name in enumerate(SPLITS):
            mask = job["masks"].get(name)
            if mask is not None:
                mb = block_nodes(torch.from_numpy(np.asarray(mask)), pg)[rows].to(dev)
                counts[i, 0] = (hit & mb).sum()
                counts[i, 1] = mb.sum()
        dist.all_reduce(counts)
    c2 = launch_counts()
    accs = {}
    for i, name in enumerate(SPLITS):
        if job["masks"].get(name) is not None:
            accs[f"{name}_acc"] = int(counts[i, 0]) / max(int(counts[i, 1]), 1)
            say(f"{name}_acc: {accs[f'{name}_acc']:.4f}", flush=True)

    def diff(a, b):
        return {k: b[k] - a[k] for k in a if b[k] != a[k]}

    return dict(rank=rank, device=str(dev), partition_s=part_s, halo=pg.halo,
                nodes_per_part=pg.nodes_per_part, layout=pg.layout, losses=losses,
                epoch_ms=dt * 1e3 if epochs else math.nan,
                first_epoch_ms=first_s * 1e3 if epochs else math.nan, **accs,
                launches={"train": diff(c0, c1), "eval": diff(c1, c2)})


def main(argv=None, *, params: Optional[Mapping] = None) -> dict:
    """Run the script on `argv` (default `sys.argv[1:]`) and return what
    rank 0 printed: P, the partition's seconds and halo, the losses at
    every 10th epoch, the mean epoch time (and, not printed, the first
    epoch's alone), the accuracies, and every
    rank's kernel launches. `params`, a GCN parameter dict ({"w{i}",
    "b{i}"}: arrays or tensors, e.g. `parallel.params_from_jax`), is the
    starting point in place of the seeded initialisation."""
    args = parse_args(argv)
    kind = args.device or "cuda"
    if args.dist_backend == "nccl" and kind == "cpu":
        raise ValueError("--dist-backend nccl runs on the cards; use --dist-backend gloo "
                         "with --device cpu")
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    P = args.parts or cards
    if P < 1:
        raise ValueError("--parts 0 takes one part a card and there is none; give --parts")
    if args.dist_backend == "nccl" and P > cards:
        raise ValueError(f"--dist-backend nccl puts one rank on each card: {P} parts, {cards} "
                         "card(s); use --dist-backend gloo to share the cards")
    dev = resolve_device(kind)

    d = load_data(args.dataset, args.data_dir)
    card = device_name(dev)
    print(f"{d.name}: {d.num_nodes} nodes, {d.num_edges} edges on {P} ranks "
          f"({args.dist_backend}, {card})", flush=True)
    # the GCN norm of the whole self-looped graph, baked into the partition
    src, dst, w = gcn_normed_edges(d.src, d.dst, d.num_nodes)
    n_cls = int(d.y.max()) + 1
    dims = [d.x.shape[1]] + [args.hidden] * (args.num_layers - 1) + [n_cls]
    job = dict(
        device=kind, num_nodes=d.num_nodes, num_edges=d.num_edges,
        src=src, dst=dst, w=w,
        x=d.x.astype(np.float32), y=d.y.astype(np.int64),
        masks={k: getattr(d, f"{k}_mask") for k in SPLITS},
        dims=dims, lr=args.lr, epochs=args.epochs, backend=args.backend,
        params=None if params is None else {
            k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in params.items()},
    )
    # by its module's name: under `python -m` this module is __main__, and a
    # spawned rank imports the function by name
    rank_fn = importlib.import_module("geot_tpu_torch.scripts.train_dist").run_rank
    timeout = args.timeout if args.timeout is not None else 300.0 + 10.0 * args.epochs
    per_rank = spawn_ranks(rank_fn, P, job, backend=args.dist_backend, timeout=timeout)
    out = {k: v for k, v in per_rank[0].items() if k not in ("rank", "device", "launches")}
    out.update(dataset=d.name, parts=P, device=card, dist_backend=args.dist_backend,
               launches=[r["launches"] for r in per_rank])
    return out


if __name__ == "__main__":
    main()
