"""Two measurements on the card behind design choices of the slot path.

    python -m geot_tpu_torch.probe_slot gathers
    python -m geot_tpu_torch.probe_slot ab --other <slot_segment_sum.cu> [--other ...]

`gathers`: a gather of 1.09 M rows (Zipf-distributed indices, the flickr
slot plan's size) from [89,250, H] float32, H 4 and 256, as a row gather
(`index_select` along axis 0) and as 1-D gathers over the transpose (what
`ops.api._gather_rows` does), and the backward scatters: `index_add_`
along axis 0 and along the transpose's axis 1, and `index_put_` with
accumulation (advanced indexing's backward).

`ab`: the slot kernels sr (F 500), sr_packed (F 64, 7) and pr (8 rows) at
the flickr plans of `chip_smoke.py` phase 19, built from this checkout
and from each given source (same nvcc flags, same C interface; a source
includes its own directory's headers), timed in turns (the others, this,
this, the others in reverse) with CUDA events in one process, with their
outputs compared for equality, and the registers ptxas gave each build's
128-column sr tile kernel. `git show <commit>:geot_tpu_torch/ops/csrc/
slot_segment_sum.cu > parent.cu` gives a parent's source (with its
headers beside it, if it has any).

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gathers(dev: torch.device) -> None:
    n, rows = 89_250, 1_088_512
    gen = torch.Generator().manual_seed(0)
    p = 1.0 / torch.arange(1, n + 1, dtype=torch.float64)
    idx = torch.multinomial(p / p.sum(), rows, replacement=True, generator=gen).to(dev)
    for H in (4, 256):
        a = torch.randn(n, H, device=dev)
        at = a.t().contiguous()
        g = torch.randn(rows, H, device=dev)
        gt = g.t().contiguous()
        res = {
            "row gather (index_select, axis 0)": _ms(lambda: a.index_select(0, idx)),
            "1-D gathers over the transpose": _ms(lambda: at.index_select(1, idx)),
            "index_add_ along axis 0": _ms(
                lambda: torch.zeros(n, H, device=dev).index_add_(0, idx, g)),
            "index_add_ along the transpose's axis 1": _ms(
                lambda: torch.zeros(H, n, device=dev).index_add_(1, idx, gt)),
            "index_put_ (accumulate)": _ms(
                lambda: torch.zeros(n, H, device=dev).index_put_((idx,), g, accumulate=True),
                iters=3),
        }
        print(f"[{n}, {H}] float32, {rows} indices: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in res.items()), flush=True)


def _sr_registers(ptxas_report: str) -> str:
    """The registers of the G = 32 (128-column), row-vector sr tile kernel
    in an nvcc -Xptxas -v report."""
    regs, fn = [], None
    for line in ptxas_report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "slot_tile_kernel" in fn and "slot_tile_kernelILi32ELi0E" in fn:
            regs.append(m.group(1))
    return "/".join(regs) or "?"


def ab(dev: torch.device, sources: list) -> None:
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.ops import _build
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.profile_gcn import flickr_graph

    out_dir = Path(_build._BUILD_DIR) / "probe_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    labels = ["this"] + [str(s) for s in sources]
    files = [str(_build._CSRC / _build.SOURCES["slot_segment_sum"])] + [str(s) for s in sources]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out_dir / f"lib{i}.so"), f], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i, f in enumerate(files)]
    libs = {}
    for i, (label, p) in enumerate(zip(labels, procs)):
        report = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{report}")
        libs[label] = ctypes.CDLL(str(out_dir / f"lib{i}.so"))
        print(f"{label}: sr tile kernel (128 columns) registers {_sr_registers(report)}",
              flush=True)

    def bound_in(lib):
        def bound(name, lib_name=""):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = sk._ARGTYPES[name], ctypes.c_int
            return fn
        return bound

    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    gs, gg = flickr_graph(data, "graphsage", dev), flickr_graph(data, "gcn", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    others = labels[1:]
    turns = others + ["this", "this"] + others[::-1]
    own = sk._bound
    try:
        for name, g, w, F in (("sr", gs, gs.plan.mask, f), ("sr_packed", gg, gg.w_slots, 64),
                              ("sr_packed", gg, gg.w_slots, c), ("pr", gs, gs.plan.mask, 8)):
            plan = g.plan
            slots = plan.num_tiles * plan.e_tile
            fn = getattr(sk, "plan_segment_sum_" + name)
            vals = (torch.ones(F, slots, device=dev) if name == "pr"
                    else torch.randn(slots, F, generator=gen, device=dev))
            times = {label: [] for label in labels}
            outs = {}
            for turn in turns:
                sk._bound = bound_in(libs[turn])
                times[turn].append(_ms(lambda: fn(plan, vals, w)))
                outs[turn] = fn(plan, vals, w)
            same = all(torch.equal(outs[o], outs["this"]) for o in others)
            print(f"{name} F={F}: " + "; ".join(f"{k} {v} ms" for k, v in times.items())
                  + f"; outputs equal: {same}", flush=True)
    finally:
        sk._bound = own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("gathers")
    p_ab = sub.add_parser("ab")
    p_ab.add_argument("--other", action="append", required=True,
                      help="a slot_segment_sum.cu to compare with (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_slot: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.what == "gathers":
        gathers(dev)
    else:
        ab(dev, args.other)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
