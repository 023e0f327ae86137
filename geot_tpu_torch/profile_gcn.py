"""Where one GCN inference request spends its time on the card.

    python -m geot_tpu_torch.profile_gcn [--requests 3]

Builds the configuration `chip_smoke.py` serves (3-layer GCN, hidden 128,
40 classes, ogbn-arxiv-shaped synthetic graph, seed 0), warms up, then
traces `--requests` forward passes with `torch.profiler` and prints the
device time by kernel and the device's busy share of the traced wall time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gcn: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.models import GCN, prepare_graph

    dev = torch.device("cuda")
    n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
    data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=args.seed)
    g = prepare_graph(data.src, data.dst, n, device=dev)
    x = torch.from_numpy(data.x).to(dev)
    model = GCN(f, 128, 3, c, generator=torch.Generator().manual_seed(args.seed),
                device=dev).eval()
    with torch.inference_mode():
        for _ in range(3):
            model(x, g)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.requests):
                model(x, g)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.time_range.elapsed_us() for ev in events)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15), flush=True)
    print(f"{torch.cuda.get_device_name(0)}: {args.requests} requests, traced wall "
          f"{wall_us / 1e3:.4f} ms, device kernel time {busy_us / 1e3:.4f} ms, "
          f"busy share {busy_us / max(wall_us, 1e-9):.4f} "
          f"({len(events)} device events)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
