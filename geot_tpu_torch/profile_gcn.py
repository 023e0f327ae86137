"""Where one inference request, or one training step, spends its time on
the card.

    python -m geot_tpu_torch.profile_gcn [--graph arxiv|products-clustered|flickr]
        [--model gcn|graphsage|gat|gcn-dyn|gin|appnp] [--feature-hint 64|128]
        [--mode serve|train|both] [--iters 3]

Builds a configuration `chip_smoke.py` drives, seed 0: `arxiv` is the
3-layer GCN (hidden 128, 40 classes) over BAT plans of the
ogbn-arxiv-shaped synthetic graph; `products-clustered` the 3-layer GCN
(100 features, hidden 128, 47 classes) over the hybrid stream+gather
plans of the ogbn-products-shaped clustered graph (GCN norm baked in,
`conv_kwargs={"normalize": False}`); `flickr` the 3-layer GCN or
GraphSAGE (500 features, hidden 64, 7 classes) over the slot plans of the
flickr-shaped graph (`FLICKR_SLOT`: the reference tuning table's picks;
GCN with self-loops and the norm baked into slot weights, GraphSAGE
without loops, mean aggregation). On flickr, `--model gat` is the 3-layer
GAT (hidden 64, `FLICKR_GAT`: 4 heads averaged) over the same graph with
self-loops and no norm (`plan_segment_sum_mh`, reading xh[src[e]] in the
edge-row kernel), and
`--model gcn-dyn` the 3-layer GCN over a slot-only graph with self-loops
and no baked norm, so each layer's norm is a per-call weight (`slot_dyn`,
`FLICKR_DYN`: an edge-order gather and the aligned-edge-block kernel):
`--feature-hint 64` gives pack-aligned plans, where the kernel launches as
`plan_segment_sum_packed2` (the reference's pick), 128 (the default)
unaligned ones, where it launches as `plan_segment_sum_sr2`. The narrow
BAT path: `--graph arxiv --model gin` is the 3-layer GIN (128 -> 64 -> 64
-> 40) over packed BAT plans of the arxiv graph without self-loops
(`ARXIV_GIN`: layers 2-3 aggregate 64 columns through
`bat_segment_sum_packed` at pack 2), `--graph flickr --model appnp` APPNP
(MLP 500 -> 64 -> 7, 10 propagations, alpha 0.1) over packed BAT plans of
the flickr graph with self-loops and no baked norm (`FLICKR_APPNP`: the
norm per call, pack 16). Models other than gcn and gin need `--graph
flickr`; gin needs `--graph arxiv`. Warms up, then traces `--iters` forward passes (`serve`) and/or
`make_train_step` steps (`train`: forward, backward over the transpose
plans, AdamW with lr 0.01 and weight decay 5e-4) with `torch.profiler`,
and prints the `key_averages()` table (device time by kernel, and by the
program's spans: the train step's phases, each conv, each SpMM route,
the softmax, mh and the GAT logits, `utils.trace`) and the device's busy
share of the traced wall time: the union of the kernels' intervals, so
kernels that overlap count once. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

# the flickr slot configuration: the reference tuning table's answer for
# its bucket (spmm:7:19:3 "sr" e_tile 512 s_tile 256; spmm_dyn:7:19:3
# "bat" 1024 x 256), TPU picks, not measured on the H100
FLICKR_SLOT = dict(e_tile=512, s_tile=256, bat_e_tile=1024, bat_s_tile=256, mode_hint="sr",
                   prefer="sr", prefer_dyn="bat", feature_hint=128, layouts=("bat", "slot"))
FLICKR_HIDDEN = 64
# GAT's conv kwargs on flickr: four heads averaged (the GAT paper's
# multi-head layers; bench_models.py runs one head)
FLICKR_GAT = dict(heads=4, concat=False)
# the per-call-weight GCN's graph: slot plans only, the slot layout
# preferred for per-call weights (the reference's slot_dyn route)
FLICKR_DYN = dict(e_tile=512, s_tile=256, mode_hint="sr", prefer="sr", prefer_dyn="sr",
                  layouts=("slot",))
# the narrow BAT path: packed BAT plans only (km_pack 128 // packed width
# of feature_hint), 512 x 256 tiles (the reference's packed pick, a TPU
# pick not measured on the H100). GIN aggregates its 64-wide hidden layers
# (no self-loops, unweighted: the `bat` route); APPNP propagates at the
# class width with the GCN norm per call (`bat_dyn`).
ARXIV_GIN = dict(add_self_loops=False, layouts=("bat",), feature_hint=64, bat_e_tile=512,
                 bat_s_tile=256)
GIN_HIDDEN = 64
FLICKR_APPNP = dict(add_self_loops=True, layouts=("bat",), feature_hint=7, bat_e_tile=512,
                    bat_s_tile=256)
APPNP_KW = dict(k=10, alpha=0.1)


def flickr_graph(data, model_name: str, dev: torch.device, feature_hint: int = 128):
    """The flickr graph of one model: GraphSAGE without self-loops; GCN
    with them and the norm baked into slot weights; GAT and gcn-dyn with
    them and no norm (gcn-dyn: `FLICKR_DYN` at `feature_hint`)."""
    from geot_tpu_torch.models import prepare_graph

    n = int(data.x.shape[0])
    if model_name == "gcn-dyn":
        return prepare_graph(data.src, data.dst, n, add_self_loops=True, normalize=None,
                             feature_hint=feature_hint, device=dev, **FLICKR_DYN)
    loops = model_name != "graphsage"
    return prepare_graph(data.src, data.dst, n, add_self_loops=loops,
                         normalize="gcn" if model_name == "gcn" else None, device=dev,
                         **FLICKR_SLOT)


def build(graph: str, model_name: str, seed: int, dev: torch.device,
          feature_hint: int = 128):
    """(model, graph, x, y, train_mask) of one configuration, on `dev`."""
    from geot_tpu_torch.graph.datasets import (
        DATASET_SHAPES,
        synthetic_clustered_graph,
        synthetic_graph,
    )
    from geot_tpu_torch.models import APPNP, GAT, GCN, GIN, MODELS, prepare_graph

    if model_name == "gin" and graph != "arxiv":
        raise SystemExit("profile_gcn: --model gin runs on --graph arxiv only")
    if model_name not in ("gcn", "gin") and graph != "flickr":
        raise SystemExit(f"profile_gcn: --model {model_name} runs on --graph flickr only")
    gen = torch.Generator().manual_seed(seed)
    if graph == "arxiv":
        n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
        data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=seed)
        if model_name == "gin":
            g = prepare_graph(data.src, data.dst, n, device=dev, **ARXIV_GIN)
            model = GIN(f, GIN_HIDDEN, 3, c, generator=gen, device=dev)
        else:
            g = prepare_graph(data.src, data.dst, n, layouts=("bat",), device=dev)
            model = GCN(f, 128, 3, c, generator=gen, device=dev)
    elif graph == "products-clustered":
        n, e, f, c = DATASET_SHAPES["ogbn-products"]
        data = synthetic_clustered_graph(n, e, mixing=0.3, mean_community=2000, power=1.0,
                                         feat_dim=f, num_classes=c, seed=seed)
        g = prepare_graph(data.src, data.dst, n, normalize="gcn",
                          layouts=("bat", "stream"), device=dev)
        model = GCN(f, 128, 3, c, conv_kwargs={"normalize": False}, generator=gen,
                    device=dev)
    else:
        n, e, f, c = DATASET_SHAPES["flickr"]
        data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=seed)
        if model_name == "appnp":
            g = prepare_graph(data.src, data.dst, n, device=dev, **FLICKR_APPNP)
        else:
            g = flickr_graph(data, model_name, dev, feature_hint)
        if model_name == "appnp":
            model = APPNP(f, FLICKR_HIDDEN, 2, c, generator=gen, device=dev, **APPNP_KW)
        elif model_name == "gat":
            model = GAT(f, FLICKR_HIDDEN, 3, c, conv_kwargs=FLICKR_GAT, generator=gen,
                        device=dev)
        else:
            cls = GCN if model_name == "gcn-dyn" else MODELS[model_name][0]
            model = cls(f, FLICKR_HIDDEN, 3, c, generator=gen, device=dev)
    x = torch.from_numpy(data.x).to(dev)
    y = torch.from_numpy(data.y.astype("int64")).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev)
    return model, g, x, y, mask


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace(run: Callable[[], object], iters: int, warmup: int = 3):
    """Warm up, then profile `iters` calls of `run`. Returns (profiler,
    traced wall us, device busy us (the union of the device events'
    intervals), device events). The device events leave out the spans'
    mirrors on the device's timeline (user annotations)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
              and not ev.is_user_annotation]
    busy = busy_us((ev.time_range.start, ev.time_range.end) for ev in events)
    return prof, wall_us, busy, events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", choices=("arxiv", "products-clustered", "flickr"),
                    default="arxiv")
    ap.add_argument("--model", choices=("gcn", "graphsage", "gat", "gcn-dyn", "gin", "appnp"),
                    default="gcn")
    ap.add_argument("--feature-hint", type=int, choices=(64, 128), default=128,
                    help="gcn-dyn's plans: 64 pack-aligned (named packed2), 128 not (sr2)")
    ap.add_argument("--mode", choices=("serve", "train", "both"), default="serve")
    ap.add_argument("--iters", type=int, default=3,
                    help="requests (serve) or training steps (train) to trace")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gcn: needs a CUDA card")
    from geot_tpu_torch.models import make_optimizer, make_train_step

    dev = torch.device("cuda")
    model, g, x, y, mask = build(args.graph, args.model, args.seed, dev, args.feature_hint)
    step = make_train_step(model, make_optimizer(model, 0.01, 5e-4), has_dropout=False)

    def serve():
        model.eval()
        with torch.inference_mode():
            model(x, g)

    def train():
        step(x, g, y, mask)

    modes = ("serve", "train") if args.mode == "both" else (args.mode,)
    for mode in modes:
        what = "requests" if mode == "serve" else "training steps"
        prof, wall_us, busy, events = trace(serve if mode == "serve" else train, args.iters)
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20),
              flush=True)
        print(f"{torch.cuda.get_device_name(0)}: {args.graph} {args.model}"
              + (f" (feature_hint {args.feature_hint})" if args.model == "gcn-dyn" else "")
              + f", {args.iters} "
              f"{what}, traced wall {wall_us / 1e3:.4f} ms, device busy "
              f"{busy / 1e3:.4f} ms, busy share {busy / max(wall_us, 1e-9):.4f} "
              f"({len(events)} device events)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
