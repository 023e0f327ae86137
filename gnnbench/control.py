"""Readings that set a cell's limits: the program over many seeds, and the
control and the planted faults over a few, in one process with one graph.

    python3 gnnbench/control.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--out chiprun_out/control-<cell>.jsonl]

For each seed of `--seeds` it makes the weights and inputs as a run does,
drives the program as the cell's window does (training: three steps of
its own step; serving: one request) and compares with the float32
reference: the program's readings. For each seed of `--control-seeds` it
also puts in the program's place
  - the reference in TF32 (the nearest precision below float32), and
  - training: the reference with the loss over half of the train rows,
    and a state left unchanged (the change of every leaf 0);
  - serving: the reference's answers with one node's class altered to its
    worst class,
and prints what each reads. The benchmark's own runs never run this. Needs
a CUDA card; the same code runs on the CPU at a small size in the tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds, control_seeds, device, cache_dir, emit) -> None:
    """Emit one JSON object per seed and side."""
    import torch

    from gnnbench.harness import correct as cmp
    from gnnbench.harness import system
    from gnnbench.harness.cell import (log, make_inputs, make_params, program_checks,
                                       reference_serve, reference_train, subseeds)
    from gnnbench.harness.graphs import cached_edges, make_edges
    from gnnbench.harness.manifest import reference_module
    from gnnbench.reference.common import ref_graph

    config = cell.config
    ref = reference_module(config)

    def edges():
        if cache_dir is None:
            return make_edges(config["graph"])
        return cached_edges(config["graph"], os.path.join(cache_dir, "edges"))[:3]

    g = system.build_graph(config, edges, device,
                           None if cache_dir is None else os.path.join(cache_dir, "graphs"), log)
    src, dst, n = edges()
    rc = config["reference"]
    rg = ref_graph(src, dst, n, self_loops=rc["self_loops"], normalize=rc["normalize"],
                   device=device)
    del src, dst
    for seed in seeds:
        s_weights, s_dropout, _ = subseeds(seed)
        model = system.build_model(config, device)
        gen = torch.Generator(device=device).manual_seed(s_weights)
        p0 = make_params(ref.param_shapes(config["model"]), gen, device)
        model.load_state_dict(p0, strict=True)
        leaves = [k for k, _ in model.named_parameters()]
        x, y, mask = make_inputs(config, n, gen, device)
        t0 = time.perf_counter()
        if cell.loop == "train":
            opt, step = system.build_train_step(config, model)
            gdrop = torch.Generator(device=device).manual_seed(s_dropout)
            prog = program_checks(model, opt, step, p0, (x, g, y, mask, gdrop))
            del opt, step
        else:
            model.eval()
            with torch.inference_mode():
                logits = model(x, g)
                pred = logits.argmax(dim=-1).cpu()
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if cell.loop == "train":
            base = reference_train(config, p0, leaves, x, y, mask, rg, s_dropout)
            emit({"seed": seed, "side": "program", **cmp.train_numbers(prog, base),
                  "leaves": cmp.leaf_gaps(prog, base)})
            del prog
        else:
            base = reference_serve(config, p0, x, rg)
            emit({"seed": seed, "side": "program", **cmp.serve_numbers(logits, [pred], base)})
            del logits
        if seed in control_seeds:
            if cell.loop == "train":
                tf = reference_train(config, p0, leaves, x, y, mask, rg, s_dropout,
                                     precision="tf32")
                emit({"seed": seed, "side": "control_tf32", **cmp.train_numbers(tf, base),
                      "leaves": cmp.leaf_gaps(tf, base)})
                half = mask.clone()
                rows = mask.nonzero()[:, 0]
                half[rows[rows.numel() // 2:]] = False
                hb = reference_train(config, p0, leaves, x, y, half, rg, s_dropout)
                emit({"seed": seed, "side": "fault_half_batch", **cmp.train_numbers(hb, base),
                      "leaves": cmp.leaf_gaps(hb, base)})
                still = dict(base, change={k: torch.zeros_like(v)
                                           for k, v in base["change"].items()})
                emit({"seed": seed, "side": "fault_state_unchanged",
                      **cmp.train_numbers(still, base)})
            else:
                tf = reference_serve(config, p0, x, rg, precision="tf32")
                emit({"seed": seed, "side": "control_tf32",
                      **cmp.serve_numbers(tf, [tf.argmax(dim=-1).cpu()], base)})
                bad = base.argmax(dim=-1).cpu()
                i = int(torch.randint(n, (1,), generator=torch.Generator().manual_seed(seed)))
                bad[i] = int(base[i].argmin())
                altered = base.clone()
                altered[i] = base[i].flip(0)
                emit({"seed": seed, "side": "fault_answer_altered",
                      **cmp.serve_numbers(altered, [bad], base)})
        log(f"seed {seed}: {time.perf_counter() - t0:.2f} s")
        del base, p0, x, y, mask
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from gnnbench.harness.manifest import load_cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = {"workload": args.workload, **row}
        line = json.dumps({k: (v if not isinstance(v, float) or v == v else repr(v))
                           for k, v in row.items()}, default=float)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, seeds + sorted(control - set(seeds)), control,
                 torch.device("cuda", 0), os.path.join(ROOT, ".gnnbench_cache"), emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
