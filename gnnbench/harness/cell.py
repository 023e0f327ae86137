"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result.

Set-up builds the graph (through the program's cache), the model and, for
training, the optimizer and step, makes the weights and inputs on the
device from the seed, and drives the cell's own shapes once or more
(training: the three checked steps; serving: a few requests). The window
then runs the loop for `seconds`. With `trace`, a stretch after the window
is traced. Then the program's state is freed, the reference runs, and the
numbers that decide `correct` are compared with the configuration's
limits.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gnnbench.harness import correct as cmp
from gnnbench.harness import system
from gnnbench.harness.costs import load_peaks
from gnnbench.harness.graphs import cached_edges, make_edges
from gnnbench.harness.manifest import Cell, metric_reader, metrics_of, reference_module
from gnnbench.harness.stats import percentile, rate
from gnnbench.reference.common import adamw_step, masked_nll, matmul_precision, ref_graph

__all__ = ["run_cell", "subseeds", "make_params", "make_inputs", "program_checks",
           "reference_train",
           "reference_serve", "log"]

GIB = float(1 << 30)
# an open loop sleeps until this long before a request is due, then spins:
# a sleeping thread can wake milliseconds late on a shared host
_SPIN_S = 0.05


def log(msg: str) -> None:
    print(f"[gnnbench] {msg}", file=sys.stderr, flush=True)


def subseeds(seed: int) -> List[int]:
    """Independent 63-bit seeds for weights and inputs, dropout masks and
    the sample of requests, from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(3, dtype=np.uint64)
    return [int(s) & ((1 << 63) - 1) for s in state]


def make_params(shapes: Dict[str, tuple], gen: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Every weight drawn in one call on the device from `gen`, then scaled
    by its kind: glorot-uniform matrices and attention vectors, small
    biases, BatchNorm scales and running averages near 1 and 0."""
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    out, off = {}, 0
    for (name, (shape, kind)), k in zip(shapes.items(), sizes):
        u = flat[off:off + k].view(shape)
        off += k
        if kind == "weight":
            v = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif kind == "att":
            v = u * math.sqrt(6.0 / (shape[1] + shape[2]))
        elif kind in ("bias", "bn_bias", "bn_running_mean"):
            v = 0.1 * u
        elif kind == "bn_weight":
            v = 1.0 + 0.25 * u
        elif kind == "bn_running_var":
            v = 1.0 + 0.5 * u
        else:
            raise ValueError(f"{name}: unknown init kind {kind!r}")
        out[name] = v.clone()
    return out


def make_inputs(config: Dict, n: int, gen: torch.Generator, device: torch.device):
    """(x, y, train mask) drawn on the device from `gen`: standard-normal
    features, uniform labels, and a random train split of the stated size."""
    m = config["model"]
    x = torch.randn(n, m["in"], generator=gen, device=device)
    y = torch.randint(0, m["out"], (n,), generator=gen, device=device)
    perm = torch.randperm(n, generator=gen, device=device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[perm[: int(config["train_nodes"])]] = True
    return x, y, mask


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_checks(model, opt, step, p0: Dict, feed: tuple) -> Dict:
    """Three steps of the program's own step on its own feed: each loss (read
    to the host), the first gradient as the optimizer holds it (its first
    moment after one step over 1 - beta1) and each leaf's change after the
    three."""
    params = dict(model.named_parameters())
    out: Dict = {"losses": []}
    for t in range(1, 4):
        out["losses"].append(float(step(*feed)))
        if t == 1:
            # a leaf the optimizer never received a gradient for reads 0
            b1 = opt.param_groups[0]["betas"][0]
            out["grad"] = {k: opt.state[p]["exp_avg"].detach() / (1.0 - b1)
                           if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                           for k, p in params.items()}
    out["change"] = {k: p.detach() - p0[k] for k, p in params.items()}
    return out


def reference_train(config: Dict, p0: Dict, leaves: List[str], x, y, mask, rg, dropout_seed: int,
                    precision: str = "fp32", steps: int = 3) -> Dict:
    """The reference's first `steps` steps from the weights `p0`: each
    step's loss, the first gradient and each leaf's change."""
    ref = reference_module(config)
    m, opt = config["model"], config["optimizer"]
    params = {k: p0[k].clone().requires_grad_(True) for k in leaves}
    fixed = {k: v for k, v in p0.items() if k not in params}
    gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
    state: Dict = {}
    losses, first = [], None
    with matmul_precision(precision):
        for t in range(1, steps + 1):
            logits = ref.forward({**params, **fixed}, x, rg, m, training=True, generator=gen,
                                 precision=precision)
            loss = masked_nll(logits, y, mask)
            grads = torch.autograd.grad(loss, list(params.values()))
            del logits
            grads = dict(zip(params, grads))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adamw_step(params, grads, state, t, opt["lr"], opt["weight_decay"])
            losses.append(float(loss.detach()))
    return {"losses": losses, "grad": first,
            "change": {k: (params[k] - p0[k]).detach() for k in leaves}}


def reference_serve(config: Dict, p0: Dict, x, rg, precision: str = "fp32") -> torch.Tensor:
    ref = reference_module(config)
    with torch.no_grad(), matmul_precision(precision):
        return ref.forward(p0, x, rg, config["model"], training=False, generator=None,
                           precision=precision)


def _drive(iterate: Callable, interval: Optional[float], *, until_s: Optional[float] = None,
           count: Optional[int] = None, on_result: Optional[Callable] = None):
    """Call `iterate` back to back (`interval` None: a closed loop), or the
    i-th call at its due time t0 + i * interval (an open loop at a fixed
    rate: a late call starts at once, and its latency counts from when it
    was due). Stops at the first completion `until_s` seconds after t0, or
    after `count` calls. Returns (seconds from t0 to the last completion,
    each call's latency, and in an open loop how late each call was sent
    past the later of its due time and the previous call's completion: the
    generator's own lateness, apart from the queue's wait)."""
    lat: List[float] = []
    late: List[float] = []
    t0 = t1 = time.perf_counter()
    while True:
        start = time.perf_counter()
        if interval is not None:
            due = t0 + len(lat) * interval
            if due - start > _SPIN_S:
                time.sleep(due - start - _SPIN_S)
            while time.perf_counter() < due:
                pass
            late.append(time.perf_counter() - max(due, t1))
            start = due
        out = iterate()
        t1 = time.perf_counter()
        lat.append(t1 - start)
        if on_result is not None:
            on_result(len(lat) - 1, out)
        if (until_s is not None and t1 - t0 >= until_s) or (count is not None
                                                           and len(lat) >= count):
            return t1 - t0, lat, late


def _trace(run: Callable, device: torch.device):
    from torch.profiler import ProfilerActivity, profile, record_function

    from gnnbench.harness.trace import WINDOW, events_of, load_classes, reduce_events

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run()
            _sync(device)
    dev, host, window = events_of(prof)
    return reduce_events(dev, host, window, load_classes())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, cache_dir: Optional[str]) -> Dict:
    """One run. Returns the result line's object with the checks last."""
    config, traffic = cell.config, cell.traffic
    s_weights, s_dropout, s_sample = subseeds(seed)
    cuda = device.type == "cuda"
    ref_mod = reference_module(config)
    edge_cache = None if cache_dir is None else f"{cache_dir}/edges"

    def edges():
        if edge_cache is None:
            return make_edges(config["graph"])
        src, dst, n, hit = cached_edges(config["graph"], edge_cache)
        log(f"edges: {'cached' if hit else 'made'}, {len(src)} edges, {n} nodes")
        return src, dst, n

    graph_cache = None if cache_dir is None else f"{cache_dir}/graphs"
    g = system.build_graph(config, edges, device, graph_cache, log)
    n = int(config["graph"]["num_nodes"])
    plan_s = system.plan_seconds(g)
    model = system.build_model(config, device)
    gen = torch.Generator(device=device).manual_seed(s_weights)
    p0 = make_params(ref_mod.param_shapes(config["model"]), gen, device)
    model.load_state_dict(p0, strict=True)
    leaves = [k for k, _ in model.named_parameters()]
    x, y, mask = make_inputs(config, n, gen, device)

    e2e: Dict[str, float] = {}
    failed = 0
    sampled: List = []
    pick = random.Random(s_sample)
    if cell.loop == "train":
        opt, step = system.build_train_step(config, model)
        gdrop = torch.Generator(device=device).manual_seed(s_dropout)
        prog = program_checks(model, opt, step, p0, (x, g, y, mask, gdrop))

        def iterate():
            return float(step(x, g, y, mask, gdrop))
    else:
        model.eval()
        last = {}

        def iterate():
            with torch.inference_mode():
                logits = model(x, g)
                pred = logits.argmax(dim=-1).cpu()
            last["logits"], last["pred"] = logits, pred
            return pred

        for _ in range(int(traffic["warmup_requests"])):
            iterate()

    _sync(device)
    e2e["setup_s"] = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    log(f"set-up {e2e['setup_s']:.3f} s; window of {seconds} s")

    interval = 1.0 / float(traffic["rate_per_s"]) if cell.loop == "serve" else None
    k = int(traffic.get("sampled_requests", 0))

    def on_result(i, out):
        nonlocal failed
        if cell.loop == "train":
            failed += not math.isfinite(out)
        elif len(sampled) < k:
            sampled.append(out)
        else:
            j = pick.randrange(i + 1)
            if j < k:
                sampled[j] = out

    window_s, lat, late = _drive(iterate, interval, until_s=seconds, on_result=on_result)
    attempted = len(lat)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e["peak_mem_gib"] = window_peak / GIB
    late_ms = percentile(late, 99) * 1e3 if late else None
    if cell.loop == "train":
        e2e["train_step_ms"] = window_s / attempted * 1e3
        per_iter_s = window_s / attempted
    else:
        e2e["serve_p95_ms"] = percentile(lat, 95) * 1e3
        per_iter_s = percentile(lat, 50)
        log(f"offered {traffic['rate_per_s']} req/s, completed {rate(attempted, window_s):.3f}; "
            f"latency p50 {per_iter_s * 1e3:.3f} ms, p95 {e2e['serve_p95_ms']:.3f} ms; "
            f"sent late p99 {late_ms:.4f} ms, max {max(late) * 1e3:.4f} ms")
    matmul = torch.get_float32_matmul_precision()
    log(f"window {window_s:.3f} s, {attempted} {'steps' if cell.loop == 'train' else 'requests'}")

    red = iters = None
    if trace:
        span = per_iter_s if interval is None else interval
        iters = int(min(max(math.ceil(traffic["trace_seconds"] / span),
                            traffic["trace_min_iters"]), traffic["trace_max_iters"]))
        red = _trace(lambda: _drive(iterate, interval, count=iters), device)
        log(f"traced {iters} iterations: busy {red['busy_s']:.4f} of {red['window_s']:.4f} s")

    # the program's state goes before the reference runs
    if cell.loop == "serve":
        last_logits = last["logits"]
    del model, g, iterate
    if cell.loop == "train":
        del opt, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    src, dst, n_ref = edges()
    rc = config["reference"]
    rg = ref_graph(src, dst, n_ref, self_loops=rc["self_loops"], normalize=rc["normalize"],
                   device=device)
    del src, dst
    t_ref = time.perf_counter()
    if cell.loop == "train":
        ref = reference_train(config, p0, leaves, x, y, mask, rg, s_dropout)
        numbers = cmp.train_numbers(prog, ref)
    else:
        ref_logits = reference_serve(config, p0, x, rg)
        numbers = cmp.serve_numbers(last_logits, sampled, ref_logits)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    ok, checks = cmp.verdict(numbers, config.get("limits", {}).get(cell.loop, {}))

    names = metrics_of(cell, "per_layer" if trace else "end_to_end")
    metrics: Dict[str, Dict] = {}
    if trace:
        peaks = load_peaks(torch.cuda.get_device_name(device)) if cuda else None
        mm = None
        if peaks is not None:
            mm = peaks["float32_flops"] if matmul == "highest" else peaks["tf32_flops"]
        ctx = SimpleNamespace(
            mode=cell.loop, trace=red, iters=iters, per_iter_s=per_iter_s, plan_s=plan_s,
            late_ms=late_ms,
            ops=config["ops"], peaks=peaks, matmul_flops=mm,
            dims={"N": n_ref, "E": rg.num_edges, "T": int(config["train_nodes"]),
                  "P": sum(p0[k].numel() for k in leaves)})
        for m in names:
            part = m["name"].split(".", 1)[1] if "." in m["name"] else None
            v = metric_reader(m["name"])(ctx, part)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # `<metric>.<part>` names a metric of its own, with a bound of its own
        for m in names:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".", 1)[0]], "unit": m["unit"]}

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if trace:
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["window_s"]
        top = sorted(red["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[k[:200], v] for k, v in top],
            "idle_gaps": [[k[:200], v] for k, v in red["idle_by_host_op"][:10]]}
    result["checks"] = checks
    return result
