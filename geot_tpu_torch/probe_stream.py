"""The stream kernels of this checkout, and optionally of other versions,
on the products-clustered graph of `chip_smoke.py` phases 10-14.

    python -m geot_tpu_torch.probe_stream [--other DIR] [--config SPEC ...]
        [--iters N] [--F 128 --F 47]

Builds the graph and the 3-layer GCN of `profile_gcn --graph
products-clustered` (seed 0), prints each stream family's kernel schedule
(live slots, units, rows cut into slices, fix-up levels, tasks, zero
runs, the schedule's bytes on the card) and then, for both directions
(the forward's plans and the transpose's), every family, each F (128 and
47 by default) and both modes (`stream_segment_sum`,
`stream_segment_acc`): each version's check against the plain version
(1e-4 * sum|terms| + 1e-5 per element), this checkout's bit-identical
rerun, each version's time with CUDA events in turns (the versions in
order, then in reverse), and the device time of this checkout's main
pass and fix-up pass (torch.profiler). Then the hybrid SpMM at F 128,
the GCN forward and a training step, timed in turns with each version in
place of `ops.api`'s stream kernels.

`--other DIR`: DIR holds another version of the port's stream kernel in
the port's layout, `DIR/geot_tpu_torch/ops/csrc/stream_segment.cu` and
`DIR/geot_tpu_torch/graph/stream_plan.py` (`git archive <commit>
geot_tpu_torch | tar -x -C DIR`), of the window-accumulator design (its
`kernel_schedule` makes items, heavy rows, merges and empty windows; its C
entry point takes 22 arguments), built with the same nvcc flags.

`--config "LABEL|FLAGS|KNOB=N,..."`: this checkout's kernel built with
extra nvcc flags (e.g. `-maxrregcount=64`) and/or its plans scheduled
with other `kernel_schedule` knobs (`slice_slots`, `fix_fanin`,
`task_cost`); either part may be empty.

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms_by_kernel(fn, iters: int) -> dict:
    """Device time per call of each kernel `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", ev.name)
            name = m.group(1) if m else ev.name[:40]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / iters
    return out


def _schedule_stats(sp) -> str:
    parts = sp.n_parts
    split_units = int((sp.unit_dest < 0).sum())
    nbytes = sum(t.numel() * t.element_size() for t in (
        sp.cols, sp.unit_dest, sp.tasks, sp.zero_runs, sp.fix)
        + (() if sp.vals is None else (sp.vals,)))
    final = sp.fix[sp.fix[:, 0] >= 0] if sp.fix.shape[0] else sp.fix
    return (f"{sp.cols.shape[0]} live slots of {sp.num_tiles * sp.e_tile}, "
            f"{sp.unit_dest.shape[0]} units ({split_units} slices of {final.shape[0]} rows "
            f"cut), {parts} partials, {len(sp.fix_levels) - 1} fix-up levels, "
            f"{sp.tasks.shape[0] - 1} tasks, {sp.zero_runs.shape[0]} zero runs, "
            f"schedule {nbytes / 1e6:.1f} MB")


def _abs_sum_err(k, p, a) -> float:
    err = (k - p).abs()
    bad = int((err > 1e-4 * a + 1e-5).sum())
    if bad or not torch.isfinite(k).all():
        raise AssertionError(f"kernel disagrees with its plain version ({bad} elements)")
    return float(err.max())


class _Other:
    """Another version's stream kernel (the window-accumulator design):
    its library, its schedule per plan, and a launcher with its C
    interface."""

    def __init__(self, root: Path, build_dir: Path):
        from geot_tpu_torch.ops import _build

        src = root / "geot_tpu_torch" / "ops" / "csrc" / "stream_segment.cu"
        spec = importlib.util.spec_from_file_location(
            "other_stream_plan", root / "geot_tpu_torch" / "graph" / "stream_plan.py")
        self.plan_mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = self.plan_mod  # its dataclasses look themselves up there
        spec.loader.exec_module(self.plan_mod)
        build_dir.mkdir(parents=True, exist_ok=True)
        lib = build_dir / "libother_stream_segment.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
        self.fn = ctypes.CDLL(str(lib)).geot_stream_segment
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.fn.argtypes = [p, i32, i64, i32, p, p, p, p, i32, i32, i32, p, p, i32, p, i32,
                            p, i32, p, p, i32, p]
        self.fn.restype = ctypes.c_int
        self.sched = {}

    def schedule(self, sp):
        key = id(sp)
        if key not in self.sched:
            s = self.plan_mod.kernel_schedule(
                sp.out_block.cpu().numpy(), sp.dst3.cpu().numpy(), sp.srcl3.cpu().numpy(),
                sp.s_tile, sp.x_rows, sp.n_blocks)
            dev = sp.out_block.device
            self.sched[key] = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                                   if isinstance(v, np.ndarray) else v) for k, v in s.items()}
        return self.sched[key]

    def launch(self, sp, x, out, accumulate):
        s = self.schedule(sp)
        n_merges = s["merges"].shape[0]
        f_pad = -(-x.shape[1] // 128) * 128
        part = torch.empty(max(s["n_parts"], 1) * sp.s_tile * f_pad if n_merges else 4,
                           dtype=torch.float32, device=x.device)
        rc = self.fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], x.shape[1],
            sp.dst3.data_ptr(), sp.srcl3.data_ptr(),
            None if sp.w3 is None else sp.w3.data_ptr(), sp.sblock.data_ptr(), sp.e_tile,
            sp.s_tile, sp.x_rows, s["items"].data_ptr(), s["heavy"].data_ptr(),
            s["items"].shape[0], s["merges"].data_ptr(), n_merges,
            s["empty_windows"].data_ptr(), 0 if accumulate else s["empty_windows"].shape[0],
            out.data_ptr(), part.data_ptr(), int(accumulate),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other stream kernel failed: cudaError {rc}")
        return out

    def sum(self, sp, x):
        out = torch.empty(sp.n_blocks * sp.s_tile, x.shape[1], device=x.device)
        return self.launch(sp, x, out, False)

    def acc(self, sp, x, carry):
        return self.launch(sp, x, carry, True)


class _Config:
    """This checkout's kernel built with extra nvcc flags and/or its plans
    given another schedule (`kernel_schedule`'s knobs)."""

    def __init__(self, spec: str, build_dir: Path):
        from geot_tpu_torch.ops import _build
        from geot_tpu_torch.ops import stream_kernels as sk

        self.label, flags, knobs = (spec.split("|") + ["", ""])[:3]
        self.knobs = {k: int(v) for k, v in (kv.split("=") for kv in knobs.split(",") if kv)}
        self.fn = None
        self.error = None
        if flags.strip():
            build_dir.mkdir(parents=True, exist_ok=True)
            lib = build_dir / f"lib_{self.label}.so"
            src = _build._CSRC / _build.SOURCES["stream_segment"]
            res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags.split(), "-o",
                                  str(lib), str(src)], capture_output=True, text=True)
            if res.returncode != 0:
                self.error = f"nvcc failed: {res.stdout[-2000:]}{res.stderr[-2000:]}"
                return
            regs = re.findall(r"Used (\d+) registers", res.stdout + res.stderr)
            print(f"config {self.label}: {flags} registers {'/'.join(regs[:8])}", flush=True)
            fn = ctypes.CDLL(str(lib)).geot_stream_segment
            own = sk._bound_fn()
            fn.argtypes, fn.restype = own.argtypes, own.restype
            self.fn = fn
        self.plans = {}

    def plan(self, sp):
        from geot_tpu_torch.graph import stream_plan as tsp

        if not self.knobs:
            return sp
        if id(sp) not in self.plans:
            s = tsp.kernel_schedule(
                sp.out_block.cpu().numpy(), sp.sblock.cpu().numpy(), sp.dst3.cpu().numpy(),
                sp.srcl3.cpu().numpy(), None if sp.w3 is None else sp.w3.cpu().numpy(),
                sp.s_tile, sp.x_rows, sp.n_blocks, **self.knobs)
            dev = sp.out_block.device
            t = {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(dev))
                 for k, v in s.items() if k not in ("fix_levels", "n_parts")}
            self.plans[id(sp)] = dataclasses.replace(sp, fix_levels=s["fix_levels"],
                                                     n_parts=s["n_parts"], **t)
        return self.plans[id(sp)]

    def kernels(self):
        """(sum, acc) calling this configuration's build on its plans."""
        from geot_tpu_torch.ops import stream_kernels as sk

        def run(name, sp, *args):
            own = sk._bound_fn
            if self.fn is not None:
                sk._bound_fn = lambda: self.fn
            try:
                return getattr(sk, name)(self.plan(sp), *args)
            finally:
                sk._bound_fn = own

        return (lambda sp, x: run("stream_segment_sum", sp, x),
                lambda sp, x, carry: run("stream_segment_acc", sp, x, carry))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="a directory holding another version's geot_tpu_torch/ stream kernel")
    ap.add_argument("--config", action="append", default=[],
                    help="LABEL|NVCC FLAGS|KNOB=N,...: this checkout's kernel built with "
                         "extra flags and/or scheduled with other knobs")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--F", type=int, action="append", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_stream: needs a CUDA card")
    from geot_tpu_torch.models import make_optimizer, make_train_step
    from geot_tpu_torch.ops import _build, api
    from geot_tpu_torch.ops import stream_kernels as sk
    from geot_tpu_torch.profile_gcn import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    _build.build_kernels(["stream_segment"])
    other = (_Other(args.other.resolve(), _build._BUILD_DIR / "probe_stream")
             if args.other else None)
    configs = [_Config(c, _build._BUILD_DIR / "probe_stream") for c in args.config]
    for cfg in configs:
        if cfg.error:
            print(f"config {cfg.label}: {cfg.error}", flush=True)
    configs = [cfg for cfg in configs if not cfg.error]
    kinds = {"this": (sk.stream_segment_sum, sk.stream_segment_acc)}
    if other is not None:
        kinds["other"] = (other.sum, other.acc)
    for cfg in configs:
        kinds[cfg.label] = cfg.kernels()
    order = list(kinds)
    turns = order + order[::-1]
    t0 = time.perf_counter()
    model, g, x, y, mask = build("products-clustered", "gcn", 0, dev)
    print(f"graph and plans built in {time.perf_counter() - t0:.1f}s; schedule seconds "
          f"{ {k: round(v, 2) for k, v in g.build_stats['seconds'].items()} }", flush=True)
    n = g.num_nodes
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = {F: torch.randn(n, F, generator=gen, device=dev) for F in (args.F or (128, 47))}
    for direction, hyb in (("forward", g.hyb), ("transpose", g.hyb_t)):
        for sp in hyb.stream:
            print(f"{direction} E={sp.e_tile}: {_schedule_stats(sp)}", flush=True)
            if other is not None:
                s = other.schedule(sp)
                print(f"  other: {s['items'].shape[0]} items, {s['merges'].shape[0]} split "
                      f"windows, {int((s['heavy'] >= 0).sum())} heavy rows", flush=True)
            for F, xf in xs.items():
                sp_abs = dataclasses.replace(sp, w3=sp.w3.abs())
                carry = torch.randn(sp.n_blocks * sp.s_tile, F, generator=gen, device=dev)
                for mode in ("sum", "acc"):
                    if mode == "sum":
                        p = sk.stream_segment_sum_plain(sp, xf)
                        a = sk.stream_segment_sum_plain(sp_abs, xf.abs())
                        runs = {k: (lambda f=f: f[0](sp, xf)) for k, f in kinds.items()}
                        timed = runs
                    else:
                        p = sk.stream_segment_acc_plain(sp, xf, carry.clone())
                        a = sk.stream_segment_acc_plain(sp_abs, xf.abs(), carry.abs())
                        runs = {k: (lambda f=f: f[1](sp, xf, carry.clone()))
                                for k, f in kinds.items()}
                        # timed without the carry's copy
                        timed = {k: (lambda f=f: f[1](sp, xf, carry)) for k, f in kinds.items()}
                    k = runs["this"]()
                    line = (f"  {mode} F={F}: max_abs_err {_abs_sum_err(k, p, a):.3e}, rerun "
                            f"bit-identical {torch.equal(runs['this'](), k)}")
                    for label in order[1:]:
                        line += (f"; {label} max_abs_err "
                                 f"{_abs_sum_err(runs[label](), p, a):.3e}")
                    del k, p, a
                    times = {label: [] for label in order}
                    for who in turns:
                        times[who].append(_ms(timed[who], args.iters))
                    split = _device_ms_by_kernel(timed["this"], 5)
                    line += "; ms " + "; ".join(
                        f"{label} " + ", ".join(f"{t:.4f}" for t in times[label])
                        for label in order)
                    line += "; this device ms by kernel: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in sorted(split.items()))
                    print(line, flush=True)
                del carry
    del xs

    # the main path with each kernel in place
    x128 = torch.randn(n, 128, generator=gen, device=dev)
    step = make_train_step(model, make_optimizer(model, 0.01, 5e-4), has_dropout=False)
    own = (api.stream_segment_sum, api.stream_segment_acc)
    res = {k: {"spmm": [], "forward": [], "step": []} for k in kinds}
    try:
        for who in turns:
            api.stream_segment_sum, api.stream_segment_acc = kinds[who]
            with torch.inference_mode():
                res[who]["spmm"].append(_ms(lambda: api.segment_spmm(g, x128), 5))
                res[who]["forward"].append(_ms(lambda: model(x, g), 3))
            res[who]["step"].append(_ms(lambda: step(x, g, y, mask), 3))
    finally:
        api.stream_segment_sum, api.stream_segment_acc = own
    for who, r in res.items():
        print(f"{smi} {who}: hybrid segment_spmm F 128 ms "
              + ", ".join(f"{t:.4f}" for t in r["spmm"]) + "; GCN forward ms "
              + ", ".join(f"{t:.4f}" for t in r["forward"]) + "; training step ms "
              + ", ".join(f"{t:.4f}" for t in r["step"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
