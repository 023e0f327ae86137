"""Train or time one model of `MODELS` from the shell: the port of the
reference's `scripts/train.py`.

    python -m geot_tpu_torch.scripts.train --model gcn --dataset cora \
        --hidden 64 --num-layers 2 --epochs 200 --checkpoint ckpt/gcn_cora.npz
    python -m geot_tpu_torch.scripts.train --model gcn --dataset flickr --time-only

The reference's arguments, with the port's backends (`auto` runs the
kernels on the card, `reference` the plain path) and two more: `--device`
(the card by default; `cpu` runs every kernel wrapper's plain version)
and `--seed` (the torch.Generator that initialises the model, the
reference's PRNGKey(0)). Without `--time-only` it trains with
`train_node_classifier` (AdamW, the best validation accuracy's
parameters, a checkpoint in the reference's format); with it, it times
the forward pass in eval mode as the reference's model scripts do (`timeit`: 10
warm-up calls, then `--iters`). It prints one row, the reference's keys
and `device` (the card's name), and appends it to `--csv`.
"""

from __future__ import annotations

import argparse
import csv
import inspect
import os
from typing import Mapping, Optional

import numpy as np
import torch

from geot_tpu_torch.graph.datasets import (
    GraphData,
    get_dataset,
    synthetic_classification_graph,
)
from geot_tpu_torch.models import MODELS, prepare_graph, train_node_classifier
from geot_tpu_torch.ops.api import BACKENDS
from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.utils.timing import timeit

__all__ = ["main", "load_data", "build_graph_for", "build_model", "device_name"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m geot_tpu_torch.scripts.train")
    p.add_argument("--model", choices=sorted(MODELS), default="gcn")
    p.add_argument("--dataset", default="cora")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--hidden", dest="hidden_channels", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    p.add_argument("--time-only", action="store_true",
                   help="skip training; time forward like the reference's model scripts")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--csv", default="", help="append timing/metrics row")
    p.add_argument("--device", default=None,
                   help="the card by default; cpu runs the kernels' plain versions")
    p.add_argument("--seed", type=int, default=0, help="seeds the model's initialisation")
    return p.parse_args(argv)


def load_data(name: str, data_dir: str) -> GraphData:
    """`get_dataset`, and a labelled synthetic graph of the same size (8
    classes, 64 features) where the dataset has no features or labels."""
    d = get_dataset(name, data_dir)
    if d.x is None or d.y is None:
        d = synthetic_classification_graph(d.num_nodes, d.num_edges, 8, feat_dim=64,
                                           name=d.name)
    return d


def build_graph_for(model: str, d: GraphData, hidden: int, device):
    """The graph `main` trains `model` on: self-loops where the model
    needs them, the GCN norm baked in for gcn, sgc and appnp, plans for
    the hidden width, the default layouts."""
    return prepare_graph(
        d.src, d.dst, d.num_nodes,
        add_self_loops=MODELS[model][1],
        normalize="gcn" if model in ("gcn", "sgc", "appnp") else None,
        feature_hint=hidden, device=device,
    )


def build_model(model: str, in_features: int, hidden: int, num_layers: int, n_cls: int, *,
                backend: str = "auto", dropout: float = 0.0, seed: int = 0, device=None):
    """`MODELS[model]` with the script's widths, initialised from a CPU
    torch.Generator seeded with `seed`, on `device`; `dropout` goes to the
    models that have it."""
    cls = MODELS[model][0]
    kwargs = dict(hidden_features=hidden, num_layers=num_layers, out_features=n_cls,
                  backend=backend)
    if dropout and "dropout_rate" in inspect.signature(cls).parameters:
        kwargs["dropout_rate"] = dropout
    return cls(in_features, generator=torch.Generator().manual_seed(seed), device=device,
               **kwargs)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None, *, model: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """Run the script on `argv` (default `sys.argv[1:]`) and return the row
    it printed. `model`, a state dict (`load_checkpoint(path)[0]`), is the
    built model's starting point in place of its seeded initialisation."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    d = load_data(args.dataset, args.data_dir)
    graph = build_graph_for(args.model, d, args.hidden_channels, dev)
    n_cls = int(d.y.max()) + 1
    net = build_model(args.model, d.x.shape[1], args.hidden_channels, args.num_layers, n_cls,
                      backend=args.backend, dropout=args.dropout, seed=args.seed, device=dev)
    if model is not None:
        net.load_state_dict(model)
    x = torch.from_numpy(d.x.astype(np.float32)).to(dev)

    row = dict(model=args.model, dataset=d.name, hidden=args.hidden_channels,
               layers=args.num_layers, backend=args.backend)
    if args.time_only:
        net.eval()
        with torch.no_grad():
            t = timeit(lambda: net(x, graph), warmup=10, iters=args.iters, device=dev)
        row["fwd_ms"] = round(t * 1e3, 4)
    else:
        def on_dev(a):
            return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

        _, metrics = train_node_classifier(
            net, graph, x, on_dev(d.y.astype(np.int64)), on_dev(d.train_mask),
            on_dev(d.val_mask), on_dev(d.test_mask),
            epochs=args.epochs, lr=args.lr, weight_decay=args.weight_decay, seed=args.seed,
            log_every=50, checkpoint_path=args.checkpoint or None,
        )
        row.update({k: round(v, 4) for k, v in metrics.items()})
    row["device"] = device_name(dev)
    print(row, flush=True)
    if args.csv:
        hdr = not os.path.exists(args.csv)
        with open(args.csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if hdr:
                w.writeheader()
            w.writerow(row)
    return row


if __name__ == "__main__":
    main()
