"""Measurements on the card behind design choices of the slot and narrow
BAT paths.

    python -m geot_tpu_torch.probe_slot gathers
    python -m geot_tpu_torch.probe_slot ab --other <file.cu> [--other ...]
    python -m geot_tpu_torch.probe_slot rowsum --config SPEC [--config ...]
    python -m geot_tpu_torch.probe_slot paths --parent <dir> [--model ...]

`gathers`: a gather of 1.09 M rows (Zipf-distributed indices, the flickr
slot plan's size) from [89,250, H] float32, H 4 and 256, as a row gather
(`index_select` along axis 0) and as 1-D gathers over the transpose (one
per column), and the backward scatters: `index_add_`
along axis 0 and along the transpose's axis 1, and `index_put_` with
accumulation (advanced indexing's backward).

`ab`: this checkout's kernels against other versions' sources, built with
the same nvcc flags (a source includes its own directory's headers: put
a version's `slot_common.cuh` beside its files), timed in turns (the
others, this, this, the others in reverse) with CUDA events in one
process, at the shapes of `chip_smoke.py`. Each `--other` names a file
by its kind:
  - `slot_segment_sum.cu` (with the sr tile and window kernels, before
    the edge-row kernel took sr): sr at the GraphSAGE plan of phase 19
    (F 500, and 128), the other's kernel over the [slots, F] gather
    against this checkout's edge-row kernel over the same slot-order
    values and reading x[src[e]] itself, with the gather's own time and
    torch.sparse.mm over the slot -> row and the node CSR (skipped for a
    version that holds pr only); and pr at [8, slots] and the mean's
    degree at [1, slots], with this checkout's gathered form and the old
    route's [slots, 8] gather and transpose;
  - `sddmm_bat.cu` (the tile kernel over an edge-order b block, before
    the kernel read b[src[e]] itself): the route at phase 9's shape
    (arxiv F 128; the other's with its padding and gather), this
    checkout's values form and the gather alone; and the GAT attention
    gradient's per-head dots at H*D 256 and 28, the plain dot (the
    parent's route) against `edge_dots`;
  - `bat_segment_sum.cu` (the wide BAT tile and window kernels before the
    edge-row kernel took the wide sum): at phase 5's and 9's shapes (the
    arxiv GCN's bat and bat_t at F 128 and 40; the other's kernel on the
    rows padded to 128) and, with `--products`, phase 14's remainder
    plans at F 128 and 47, the same three;
  - `slot_aeb.cu` (the AEB tile and window kernels behind sr2 / packed2
    before the edge-row kernel): at phase 24's shapes (flickr GCN with
    self-loops, per-call weights; F 64 and 7, the plans of feature_hint
    128 and 64), the other's kernel on an edge-order gathered block
    against this checkout's edge-row kernel on the same block and reading
    x[src[e]] itself, and the gather's own time;
  - `bat_segment_sum_packed.cu` (the packed BAT tile and window kernels
    before it): at phase 29's shapes (GIN on arxiv, F 64, bat and bat_t;
    APPNP on flickr, F 8, weighted), the same three;
  - `slot_mh.cu` (the mh tile and window kernels of `slot_common.cuh`,
    before the edge-row kernel took mh): at phase 24's H*D 256 and 28 over
    GAT's `plan` and `plan_t`, the other's kernel over the [slots, H*D]
    gather with slot-order weights against this checkout's over the same
    values and reading xh[src[e]] with edge-order weights itself, with the
    gather's own time and torch.sparse.mm over the head-expanded node CSR.
  `git show <commit>:geot_tpu_torch/ops/csrc/<file> > DIR/<file>` gives a
  parent's source, DIR git-ignored and in the chip copy (e.g. `_archive/`).

`rowsum`: the edge-row kernel (`ops/csrc/edge_row_sum.cu`) built from
this checkout with extra nvcc flags and run over schedules with other
knobs, `--config "LABEL|NVCC FLAGS|slice_slots=N,task_cost=N,fix_fanin=N"`
(e.g. `"t64||task_cost=64,slice_slots=64"`, `"b8|-DGEOT_EDGE_BATCH=8|"`),
timed in turns at the shapes of `ab`'s AEB and packed BAT comparisons, in
both forms; `--wide` adds the wide BAT and sr_packed shapes, `--products`
the products remainder's, `--slot` the sr (GraphSAGE, F 500) and mh (GAT,
H*D 256 and 28, `plan` and `plan_t`) shapes (e.g. with
`"col|-DGEOT_HEADS_LANE=0|"`: mh's weights looked up per column).

`paths`: each model's request (forward) and training step with CUDA
events, `--model` among `appnp` (flickr), `gin` (arxiv), `gcn-dyn`
(flickr, feature_hint 64 and 128), `gcn-arxiv`, `gcn-flickr`,
`graphsage-flickr`, `gat-flickr` and `gcn-products`, in a process of its own per run, with
`--parent`'s tree (an unpacked archive of another commit, e.g.
`git archive <commit> geot_tpu_torch | tar -x -C DIR`) and this one's in
turns (parent, this, this, parent): its kernels and its routes.

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
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


def _device_ms(fn, iters: int = 10) -> float:
    """Device time per call of fn's kernels (torch.profiler)."""
    from geot_tpu_torch.profile_gcn import trace

    _, _, busy_us, _ = trace(fn, iters, warmup=2)
    return busy_us / 1e3 / iters


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


def _build_all(files: list, tag: str):
    """nvcc each file (the same flags as `ops._build`), in parallel, into
    the build directory; returns [(library, ptxas report)]."""
    from geot_tpu_torch.ops import _build

    out_dir = Path(_build._BUILD_DIR) / "probe_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out_dir / f"lib{tag}{i}.so"), str(f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, f in enumerate(files)]
    out = []
    for i, (f, p) in enumerate(zip(files, procs)):
        report = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {f}:\n{report}")
        out.append((ctypes.CDLL(str(out_dir / f"lib{tag}{i}.so")), report))
    return out


def _in_turns(labels: list, run) -> dict:
    """{label: [ms, ms]}: run(label) timed in turns, the others, this,
    this, the others in reverse."""
    others = [x for x in labels if x != "this"]
    times = {x: [] for x in labels}
    for turn in others + ["this", "this"] + others[::-1]:
        times[turn].append(run(turn))
    return times


def _fmt(times: dict) -> str:
    return "; ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
                     for k, v in times.items())


def _ab_slot(dev: torch.device, sources: list) -> None:
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.profile_gcn import flickr_graph

    libs = {str(s): lib for s, (lib, _) in zip(sources, _build_all(sources, "sr"))}
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    g = flickr_graph(data, "graphsage", dev)
    plan, w = g.plan, g.plan.mask
    gen = torch.Generator(device=dev).manual_seed(0)
    scsr = _slot_csr(plan, w)
    ncsr = _node_csr(g.dst, g.src, None, n)
    # versions with the sr tile kernels (before the edge-row kernel took sr)
    sr_libs = {k: lib for k, lib in libs.items() if hasattr(lib, "geot_plan_segment_sum_sr")}
    labels = ["this"] + list(sr_libs)
    for F in ((f, 128) if sr_libs else ()):
        x = torch.randn(n, F, generator=gen, device=dev)
        vals = x.index_select(0, plan.src_slots.reshape(-1))

        def run(label):
            if label == "this":
                return _ms(lambda: sk.plan_segment_sum_sr(plan, vals, w))
            return _ms(lambda: _old_slot(libs[label], "sr", plan, vals, w))

        times = _in_turns(labels, run)
        mine = sk.plan_segment_sum_sr(plan, vals, w)
        a_abs = sk.plan_segment_sum_sr(plan, vals.abs(), w)
        same = all(_close(_old_slot(lib, "sr", plan, vals, w), mine, a_abs)
                   for lib in sr_libs.values())
        _report_forms(f"sr F={F} (flickr GraphSAGE, the plan's mask)", times,
                      _ms(lambda: sk.plan_segment_sum_sr(plan, x, w, src=g.src)),
                      _ms(lambda: x.index_select(0, plan.src_slots.reshape(-1))),
                      _ms(lambda: torch.sparse.mm(scsr, vals)), same,
                      _ms(lambda: torch.sparse.mm(ncsr, x)), "slot -> row")
        del x, vals
    # pr: the values form at [8, slots] and the mean's degree at [1, slots]
    # (the main path's), then this checkout's gathered form at F 8 and the
    # old route's [slots, 8] gather and transpose
    labels = ["this"] + list(libs)
    slots = plan.num_tiles * plan.e_tile
    for N in (8, 1):
        vt = (torch.randn(N, slots, generator=gen, device=dev) if N > 1
              else torch.ones(1, slots, device=dev))

        def other_pr(lib):
            if hasattr(lib, "geot_pr_max_rows"):  # this interface: over the row schedule
                return _sched_pr(lib, plan, vt, w)
            return _old_slot(lib, "pr", plan, vt, w)

        def run_pr(label):
            if label == "this":
                return _ms(lambda: sk.plan_segment_sum_pr(plan, vt, w))
            return _ms(lambda: other_pr(libs[label]))

        times = _in_turns(labels, run_pr)
        mine = sk.plan_segment_sum_pr(plan, vt, w)
        a_abs = sk.plan_segment_sum_pr(plan, vt.abs(), w)
        same = all(_close(other_pr(lib), mine, a_abs) for lib in libs.values())
        dev_ms = {"this": _device_ms(lambda: sk.plan_segment_sum_pr(plan, vt, w))}
        dev_ms.update({k: _device_ms(lambda: other_pr(lib)) for k, lib in libs.items()})
        print(f"pr [{N}, slots]: {_fmt(times)}; device ms (torch.profiler) "
              + "; ".join(f"{k} {v:.4f}" for k, v in dev_ms.items())
              + f"; outputs within the abs-sum rule: {same}", flush=True)
    x8 = torch.randn(n, 8, generator=gen, device=dev)
    print(f"pr F=8 gathered (x[src[e]] in the kernel): "
          f"{_ms(lambda: sk.plan_segment_sum_pr(plan, x8, w, src=g.src)):.4f} ms; the old "
          f"route's [slots, 8] gather and transpose "
          f"{_ms(lambda: x8.index_select(0, plan.src_slots.reshape(-1)).t().contiguous()):.4f}"
          " ms", flush=True)


def _sched_pr(lib, plan, vt, w):
    """Another build of this interface's pr kernel (over the plan's row
    schedule) on vt [N, T*E]: the same launch as `plan_segment_sum_pr`."""
    from geot_tpu_torch.graph.plan import row_schedule_of
    from geot_tpu_torch.ops.slot_kernels import _PR_ARGS

    fn = lib.geot_plan_segment_sum_pr
    fn.argtypes, fn.restype = _PR_ARGS, ctypes.c_int
    s = row_schedule_of(plan)
    N = vt.shape[0]
    out = torch.empty(N, s.n_out, device=vt.device)
    part = torch.empty(max(s.n_parts, 1) * N, device=vt.device)
    levels = (ctypes.c_int * len(s.fix_levels))(*s.fix_levels)
    rc = fn(vt.data_ptr(), vt.shape[1], N, N, None, 0, s.cols.data_ptr(), s.slot.data_ptr(),
            w.data_ptr(), s.unit_dest.data_ptr(), s.tasks.data_ptr(), s.tasks.shape[0] - 1,
            s.zero_runs.data_ptr(), s.fix.data_ptr(), levels, len(s.fix_levels) - 1,
            part.data_ptr(), out.data_ptr(), s.n_out, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other pr kernel: cudaError {rc}")
    return out


def _old_sddmm(lib, bp, a, b, src):
    """The parent's route into its tile kernel of `sddmm_bat.cu`: a padded
    to the plan's windows and to 128 columns, b gathered in edge order into
    whole value blocks, then its kernel; returns the [nnz] dots."""
    fn = lib.geot_sddmm_bat
    fn.argtypes = [_P, _I64, _P, _I64, _I32, _P, _I32, _P, _P, _I32, _I32, _I32, _P, _P]
    fn.restype = ctypes.c_int
    F, nnz = a.shape[1], src.shape[0]
    f_pad = -(-F // 128) * 128
    rows = (bp.n_blocks + (bp.chunk_blocks if bp.chunks else 0)) * bp.s_tile
    a_p = torch.nn.functional.pad(a, (0, f_pad - F, 0, rows - a.shape[0])).contiguous()
    src_pad = torch.nn.functional.pad(src.long(), (0, bp.n_vblocks * bp.e_tile - nnz))
    b_vals = torch.nn.functional.pad(b, (0, f_pad - F)).index_select(0, src_pad)
    out = torch.zeros((bp.n_vblocks + 1) * bp.e_tile, device=a.device)
    rc = fn(a_p.data_ptr(), a_p.shape[0], b_vals.data_ptr(), b_vals.shape[0], f_pad,
            bp.dst3.data_ptr(), bp.n_vblocks, bp.out_block.data_ptr(), bp.vblock.data_ptr(),
            bp.num_tiles, bp.e_tile, bp.s_tile, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old sddmm_bat kernel: cudaError {rc}")
    return out[:nnz]


def _ab_sddmm(dev, sources: list) -> None:
    """The parent's sddmm_bat route (pad, edge-order gather, tile kernel)
    against this checkout's kernel reading a[dst[e]] and b[src[e]] itself,
    at phase 9's arxiv F 128; and the parent's attention-gradient dots
    (the plain per-edge dot over gathered rows) against `edge_dots` at
    GAT's H*D 256 and 28 on the flickr graph with self-loops."""
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops.sddmm_kernels import edge_dots, edge_dots_plain, sddmm_bat
    from geot_tpu_torch.profile_gcn import flickr_graph

    libs = {str(s): lib for s, (lib, _) in zip(sources, _build_all(sources, "sddmm"))}
    labels = ["this"] + list(libs)
    gen = torch.Generator(device=dev).manual_seed(0)
    n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
    data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=0)
    g = prepare_graph(data.src, data.dst, n, layouts=("bat",), device=dev)
    bp, nnz = g.bat, g.num_edges
    a = torch.randn(n, 128, generator=gen, device=dev)
    b = torch.randn(n, 128, generator=gen, device=dev)

    def run(label):
        if label == "this":
            return _ms(lambda: sddmm_bat(bp, a, b, src=g.src))
        return _ms(lambda: _old_sddmm(libs[label], bp, a, b, g.src))

    times = _in_turns(labels, run)
    mine = sddmm_bat(bp, a, b, src=g.src)[:nnz]
    a_abs = sddmm_bat(bp, a.abs(), b.abs(), src=g.src)[:nnz]
    same = all(_close(_old_sddmm(lib, bp, a, b, g.src), mine, a_abs) for lib in libs.values())
    b_vals = b.index_select(0, g.src.long())
    print(f"sddmm_bat arxiv F 128 ({nnz} edges), the route (parent: pad, gather, kernel; this: "
          f"b[src[e]] in the kernel): {_fmt(times)}; this kernel's values form (b in edge "
          f"order) {_ms(lambda: sddmm_bat(bp, a, b_vals)):.4f} ms; the [E, F] gather alone "
          f"{_ms(lambda: b.index_select(0, g.src.long())):.4f} ms; outputs within the abs-sum "
          f"rule: {same}", flush=True)
    del a, b, b_vals, g, bp
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    gg = flickr_graph(data, "gat", dev)
    for H, D in ((4, 64), (4, c)):
        ga = torch.randn(n, H * D, generator=gen, device=dev)
        xb = torch.randn(n, H * D, generator=gen, device=dev)

        def run_dots(label):
            if label == "this":
                return _ms(lambda: edge_dots(ga, xb, gg.dst, gg.src, D))
            return _ms(lambda: edge_dots_plain(ga, xb, gg.dst, gg.src, D), iters=5)

        t = _in_turns(["this", "parent"], run_dots)
        ok = _close(edge_dots(ga, xb, gg.dst, gg.src, D),
                    edge_dots_plain(ga, xb, gg.dst, gg.src, D),
                    edge_dots_plain(ga.abs(), xb.abs(), gg.dst, gg.src, D))
        print(f"GAT attention-gradient dots (H, D) = ({H}, {D}), {gg.num_edges} edges: "
              f"{_fmt(t)} (parent: the plain dot over gathered rows); within the abs-sum rule: "
              f"{ok}", flush=True)


def _slot_csr(plan, w):
    """The plan's slot -> row matrix in CSR with the slot weights."""
    wf = w.reshape(-1)
    keep = torch.nonzero(wf != 0).reshape(-1)
    return torch.sparse_coo_tensor(
        torch.stack([plan.dst_slots.reshape(-1).long()[keep], keep]), wf[keep],
        (plan.n_blocks * plan.s_tile, wf.numel()),
        check_invariants=False).coalesce().to_sparse_csr()


def _node_csr(dst, src, w, n):
    """The node adjacency [n, n] in CSR (ones where w is None)."""
    vals = torch.ones(dst.shape[0], device=dst.device) if w is None else w
    return torch.sparse_coo_tensor(torch.stack([dst.long(), src.long()]), vals, (n, n),
                                   check_invariants=False).coalesce().to_sparse_csr()


def _edge_csr(dst, w, n_rows):
    """The edge -> row matrix [n_rows, nnz] in CSR (ones where w is None)."""
    nnz = dst.shape[0]
    vals = torch.ones(nnz, device=dst.device) if w is None else w
    return torch.sparse_coo_tensor(
        torch.stack([dst.long(), torch.arange(nnz, device=dst.device)]), vals,
        (n_rows, nnz), check_invariants=False).coalesce().to_sparse_csr()


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the C interfaces of the kernels before the edge-row kernel
_OLD_AEB = [_P, _I32, _I64, _I32, _I64, _P, _P, _P, _P, _I64, _P, _I32, _I32, _I32, _I32, _P,
            _P, _P, _P]
_OLD_BAT = [_P, _I32, _I64, _P, _P, _I64, _P, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P]
_OLD_WIDE = [_P, _I64, _I32, _P, _P, _I64, _P, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P]
# the slot tile + window kernels' tail: out_block, T, n_windows, E, s_tile,
# out, part_rows, part_vals, stream
_OLD_TAIL = [_P, _I32, _I32, _I32, _I32, _P, _P, _P, _P]
_OLD_SLOT = {"sr": [_P, _I32, _P, _P] + _OLD_TAIL,
             "pr": [_P, _I32, _I64, _P, _P] + _OLD_TAIL,
             "mh": [_P, _I32, _P, _P, _I32, _I32] + _OLD_TAIL}


def _old_slot(lib, kind, plan, vals, w, head_dim=0):
    """The slot tile + window kernels of `slot_segment_sum.cu` (sr over
    slot-order values [T*E, F]; pr over their transpose [F, T*E]) or of
    `slot_mh.cu` (mh, slot-order head weights w [T*E, H]) before the
    edge-row kernel took sr and mh; the plan ordered as a whole."""
    fn = getattr(lib, f"geot_plan_segment_sum_{kind}")
    fn.argtypes, fn.restype = _OLD_SLOT[kind], ctypes.c_int
    lib.geot_slot_scratch_width.argtypes = [_I32, _I32]
    T, dev = plan.num_tiles, vals.device
    F = vals.shape[0] if kind == "pr" else vals.shape[1]
    width = lib.geot_slot_scratch_width(F, int(kind != "sr"))
    rows = plan.n_blocks * plan.s_tile
    out = torch.empty((F, rows) if kind == "pr" else (rows, F), device=dev)
    pr = torch.empty(2 * T, dtype=torch.int32, device=dev)
    pv = torch.empty(2 * T, width, device=dev)
    head = {"sr": [vals.data_ptr(), F, plan.dst_slots.data_ptr(), w.data_ptr()],
            "pr": [vals.data_ptr(), F, vals.shape[1], plan.dst_slots.data_ptr(), w.data_ptr()],
            "mh": [vals.data_ptr(), F, plan.dst_slots.data_ptr(), w.data_ptr(), w.shape[1],
                   head_dim]}[kind]
    rc = fn(*head, plan.out_block.data_ptr(), T, plan.n_blocks, plan.e_tile, plan.s_tile,
            out.data_ptr(), pr.data_ptr(), pv.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old {kind} kernel: cudaError {rc}")
    return out


def _old_wide(lib, bp, vals, w):
    """The wide BAT tile + window kernels of `bat_segment_sum.cu` before
    the edge-row kernel took the wide sum, over edge-order values padded to
    128 columns, on a plan ordered as a whole."""
    fn = lib.geot_bat_segment_sum
    fn.argtypes, fn.restype = _OLD_WIDE, ctypes.c_int
    T, F = bp.num_tiles, vals.shape[1]
    out = torch.empty(bp.n_blocks * bp.s_tile, F, device=vals.device)
    pr = torch.empty(2 * T, dtype=torch.int32, device=vals.device)
    pv = torch.empty(2 * T, F, device=vals.device)
    rc = fn(vals.data_ptr(), vals.shape[0], F, bp.dst3.data_ptr(),
            None if w is None else w.data_ptr(), 0 if w is None else w.shape[0],
            bp.out_block.data_ptr(), bp.vblock.data_ptr(), T, bp.n_blocks, bp.e_tile,
            bp.s_tile, out.data_ptr(), pr.data_ptr(), pv.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old wide BAT kernel: cudaError {rc}")
    return out


def _old_aeb(lib, plan, vals, w_edge):
    """The AEB tile + window kernels of `slot_aeb.cu` before this design,
    over edge-order values with the plan's mask and per-call weights."""
    fn = lib.geot_plan_segment_sum_aeb
    fn.argtypes, fn.restype = _OLD_AEB, ctypes.c_int
    lib.geot_slot_scratch_width.argtypes = [_I32, _I32]
    T, E, F = plan.num_tiles, plan.e_tile, vals.shape[1]
    width = lib.geot_slot_scratch_width(F, 1)
    out = torch.empty(plan.n_blocks * plan.s_tile, F, device=vals.device)
    pr = torch.empty(2 * T, dtype=torch.int32, device=vals.device)
    pv = torch.empty(2 * T, width, device=vals.device)
    rc = fn(vals.data_ptr(), F, vals.shape[0], 1, 0, plan.dst_slots.data_ptr(),
            plan.mask.data_ptr(), plan.e0.data_ptr(), w_edge.data_ptr(), w_edge.shape[0],
            plan.out_block.data_ptr(), T, plan.n_blocks, E, plan.s_tile, out.data_ptr(),
            pr.data_ptr(), pv.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old AEB kernel: cudaError {rc}")
    return out


def _old_bat(lib, bp, vals, w):
    """The packed BAT tile + window kernels of `bat_segment_sum_packed.cu`
    before this design, over edge-order values."""
    fn = lib.geot_bat_segment_sum_packed
    fn.argtypes, fn.restype = _OLD_BAT, ctypes.c_int
    T, F = bp.num_tiles, vals.shape[1]
    out = torch.empty(bp.n_blocks * bp.s_tile, F, device=vals.device)
    pr = torch.empty(2 * T, dtype=torch.int32, device=vals.device)
    pv = torch.empty(2 * T, F, device=vals.device)
    rc = fn(vals.data_ptr(), F, vals.shape[0], bp.dst_km.data_ptr(),
            None if w is None else w.data_ptr(), 0 if w is None else w.shape[0],
            bp.out_block.data_ptr(), bp.vblock.data_ptr(), T, bp.n_blocks, bp.e_tile,
            bp.s_tile, out.data_ptr(), pr.data_ptr(), pv.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old packed BAT kernel: cudaError {rc}")
    return out


def _report_forms(what, times, gathered_ms, gather_ms, lib_ms, same, node_lib_ms=None,
                  lib_kind="edge -> row"):
    print(f"{what}: values form {_fmt(times)}; this kernel gathered (x[src[e]]) "
          f"{gathered_ms:.4f} ms; the [E, F] gather {gather_ms:.4f} ms; torch.sparse.mm "
          f"({lib_kind} CSR) {lib_ms:.4f} ms"
          + ("" if node_lib_ms is None else f", (node CSR) {node_lib_ms:.4f} ms")
          + f"; outputs within the abs-sum rule: {same}", flush=True)


def _close(a, b, a_abs) -> bool:
    return bool(((a - b).abs() <= 1e-4 * a_abs + 1e-5).all())


def _ab_aeb(dev, sources: list) -> None:
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.profile_gcn import FLICKR_HIDDEN, flickr_graph

    libs = {str(s): lib for s, (lib, _) in zip(sources, _build_all(sources, "aeb"))}
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for fh, name in ((128, "sr2"), (64, "packed2")):
        g = flickr_graph(data, "gcn-dyn", dev, fh)
        plan = g.plan
        we = torch.rand(g.num_edges, generator=gen, device=dev) + 0.1
        csr = torch.sparse_coo_tensor(
            torch.stack([g.dst.long(), torch.arange(g.num_edges, device=dev)]), we,
            (plan.n_blocks * plan.s_tile, g.num_edges)).coalesce().to_sparse_csr()
        fn = sk.plan_segment_sum_sr2 if name == "sr2" else sk.plan_segment_sum_packed2
        kw = {"vals_layout": "edge"} if name == "sr2" else {}
        for F in (FLICKR_HIDDEN, c):
            x = torch.randn(n, F, generator=gen, device=dev)
            vals = x.index_select(0, g.src.long())

            def run(label):
                if label == "this":
                    return _ms(lambda: fn(plan, vals, w_edge=we, **kw))
                return _ms(lambda: _old_aeb(libs[label], plan, vals, we))

            times = _in_turns(["this"] + list(libs), run)
            mine = fn(plan, vals, w_edge=we, **kw)
            a_abs = fn(plan, vals.abs(), w_edge=we, **kw)
            same = all(_close(_old_aeb(lib, plan, vals, we), mine, a_abs)
                       for lib in libs.values())
            _report_forms(f"{name} F={F} (flickr, per-call weights)", times,
                          _ms(lambda: fn(plan, x, w_edge=we, src=g.src, **kw)),
                          _ms(lambda: x.index_select(0, g.src.long())),
                          _ms(lambda: torch.sparse.mm(csr, vals)), same)


def _ab_bat(dev, sources: list) -> None:
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum_packed
    from geot_tpu_torch.profile_gcn import ARXIV_GIN, FLICKR_APPNP

    libs = {str(s): lib for s, (lib, _) in zip(sources, _build_all(sources, "bat"))}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, shape, kw, extra, weighted in (("gin", "ogbn-arxiv", ARXIV_GIN, {}, False),
                                             ("appnp", "flickr", FLICKR_APPNP,
                                              {"power": 1.0}, True)):
        n, e, f, c = DATASET_SHAPES[shape]
        data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=0, **extra)
        g = prepare_graph(data.src, data.dst, n, device=dev, **kw)
        for d in ("bat", "bat_t"):
            bp = getattr(g, d)
            F = 128 // bp.km_pack
            src_d = g.src if d == "bat" else g.dst_t
            dst_d = g.dst if d == "bat" else g.src.index_select(0, g.perm_t.long())
            w = (torch.rand(g.num_edges, generator=gen, device=dev) + 0.1) if weighted else None
            x = torch.randn(n, F, generator=gen, device=dev)
            vals = x.index_select(0, src_d.long())
            csr = torch.sparse_coo_tensor(
                torch.stack([dst_d.long(), torch.arange(g.num_edges, device=dev)]),
                torch.ones(g.num_edges, device=dev) if w is None else w,
                (bp.n_blocks * bp.s_tile, g.num_edges)).coalesce().to_sparse_csr()

            def run(label):
                if label == "this":
                    return _ms(lambda: bat_segment_sum_packed(bp, vals, w))
                return _ms(lambda: _old_bat(libs[label], bp, vals, w))

            times = _in_turns(["this"] + list(libs), run)
            mine = bat_segment_sum_packed(bp, vals, w)
            a_abs = bat_segment_sum_packed(bp, vals.abs(), w)
            same = all(_close(_old_bat(lib, bp, vals, w), mine, a_abs) for lib in libs.values())
            _report_forms(f"bat_segment_sum_packed {name}.{d} F={F}", times,
                          _ms(lambda: bat_segment_sum_packed(bp, x, w, src=src_d)),
                          _ms(lambda: x.index_select(0, src_d.long())),
                          _ms(lambda: torch.sparse.mm(csr, vals)), same)


def _wide_case(libs, what, bp, x, src_d, dst_d, w):
    """One wide BAT shape: the others' kernel over the edge-order rows
    padded to 128 columns (their contract) against this checkout's
    edge-row kernel over the rows at their width and reading x[src[e]]
    itself, with the gathers and the library calls beside them."""
    import torch.nn.functional as F_

    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum

    F = x.shape[1]
    vals = x.index_select(0, src_d.long())
    v128 = F_.pad(vals, (0, 128 - F)) if F % 128 else vals

    def run(label):
        if label == "this":
            return _ms(lambda: bat_segment_sum(bp, vals, w), iters=10)
        return _ms(lambda: _old_wide(libs[label], bp, v128, w), iters=10)

    times = _in_turns(["this"] + list(libs), run)
    mine = bat_segment_sum(bp, vals, w)
    a_abs = bat_segment_sum(bp, vals.abs(), None if w is None else w.abs())
    same = all(_close(_old_wide(lib, bp, v128, w)[:, :F], mine, a_abs) for lib in libs.values())
    x128 = F_.pad(x, (0, 128 - F)) if F % 128 else x
    gathered = _ms(lambda: bat_segment_sum(bp, x, w, src=src_d), iters=10)
    gather = _ms(lambda: x.index_select(0, src_d.long()), iters=10)
    gather128 = _ms(lambda: x128.index_select(0, src_d.long()), iters=10)
    del v128
    ecsr = _edge_csr(dst_d, w, bp.n_blocks * bp.s_tile)
    lib_ms = _ms(lambda: torch.sparse.mm(ecsr, vals), iters=10)
    del ecsr, vals
    ncsr = _node_csr(dst_d, src_d, w, x.shape[0])
    node_ms = _ms(lambda: torch.sparse.mm(ncsr, x), iters=10)
    del ncsr
    _report_forms(f"{what} F={F} (others at 128 columns; their route's gather at 128 "
                  f"{gather128:.4f} ms)", times, gathered, gather, lib_ms, same, node_ms)


def _ab_wide(dev, sources: list, products: bool) -> None:
    """The wide BAT sum at `chip_smoke.py`'s shapes: the arxiv GCN's bat
    and bat_t at F 128 and 40 (phases 5 and 9), and with `products` the
    hybrid GCN's remainder plans at F 128 and 47 (phase 14, ~100 s of host
    build). The others' kernel needs a plan ordered as a whole: the plans
    are built unchunked (the parent's route ran chunks of the same tiles
    one by one)."""
    from geot_tpu_torch.graph import plan as tplan
    from geot_tpu_torch.graph.datasets import (
        DATASET_SHAPES,
        synthetic_clustered_graph,
        synthetic_graph,
    )
    from geot_tpu_torch.models import gcn_edge_weight, prepare_graph

    libs = {str(s): lib for s, (lib, _) in zip(sources, _build_all(sources, "wide"))}
    gen = torch.Generator(device=dev).manual_seed(0)
    cap = tplan.MAX_PREFETCH_TILES

    def whole(dst_d, n, like):
        tplan.MAX_PREFETCH_TILES = 1 << 30  # one chunk: the others' kernel needs order
        try:
            bp = tplan.build_bat_plan(dst_d.cpu().numpy(), n, e_tile=like.e_tile,
                                      s_tile=like.s_tile, max_chunk_tiles=1 << 30, device=dev)
        finally:
            tplan.MAX_PREFETCH_TILES = cap
        assert not bp.chunks
        return bp

    n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
    data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=0)
    g = prepare_graph(data.src, data.dst, n, layouts=("bat",), device=dev)
    w = gcn_edge_weight(g)
    dst_t = g.src.index_select(0, g.perm_t.long())
    for d, src_d, dst_d, w_d in (("bat", g.src, g.dst, w),
                                 ("bat_t", g.dst_t, dst_t, w[g.perm_t.long()])):
        bp = whole(dst_d, n, g.bat)
        for F in (128, c):
            x = torch.randn(n, F, generator=gen, device=dev)
            _wide_case(libs, f"bat_segment_sum arxiv GCN {d}", bp, x, src_d, dst_d, w_d)
    del g, data
    if not products:
        return
    n, e, f, c = DATASET_SHAPES["ogbn-products"]
    data = synthetic_clustered_graph(n, e, mixing=0.3, mean_community=2000, power=1.0,
                                     feat_dim=f, num_classes=c, seed=0)
    g = prepare_graph(data.src, data.dst, n, normalize="gcn", layouts=("bat", "stream"),
                      device=dev)
    del data
    for d, h in (("forward", g.hyb), ("transpose", g.hyb_t)):
        dst_r = h.rest.dst3.reshape(-1)[: h.rest.num_edges]
        bp = whole(dst_r, n, h.rest)
        for F in (128, c):
            x = torch.randn(n, F, generator=gen, device=dev)
            _wide_case(libs, f"bat_segment_sum products remainder {d} ({h.rest.num_edges} "
                       "edges)", bp, x, h.rest_src, dst_r, h.rest_w)
            del x
        del bp


def _ab_mh(dev, sources: list) -> None:
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.profile_gcn import FLICKR_HIDDEN, flickr_graph

    libs = {str(s): lib for s, (lib, _) in zip(sources, _build_all(sources, "mh"))}
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    g = flickr_graph(data, "gat", dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for d, plan, src_d, dst_d in (("plan", g.plan, g.src, g.dst),
                                  ("plan_t", g.plan_t, g.dst_t,
                                   g.src.index_select(0, g.perm_t.long()))):
        for H, D in ((4, FLICKR_HIDDEN), (4, c)):
            x = torch.randn(n, H * D, generator=gen, device=dev)
            we = torch.rand(g.num_edges, H, generator=gen, device=dev) + 0.1
            ws = (we.index_select(0, plan.edge_pos.reshape(-1).long())
                  * plan.mask.reshape(-1, 1)).contiguous()
            vals = x.index_select(0, plan.src_slots.reshape(-1))

            def run(label):
                if label == "this":
                    return _ms(lambda: sk.plan_segment_sum_mh(plan, vals, ws, D))
                return _ms(lambda: _old_slot(libs[label], "mh", plan, vals, ws, D))

            times = _in_turns(["this"] + list(libs), run)
            mine = sk.plan_segment_sum_mh(plan, vals, ws, D)
            a_abs = sk.plan_segment_sum_mh(plan, vals.abs(), ws, D)
            same = all(_close(_old_slot(lib, "mh", plan, vals, ws, D), mine, a_abs)
                       for lib in libs.values())
            h = torch.arange(H, device=dev)
            ncsr = torch.sparse_coo_tensor(
                torch.stack([(dst_d.long()[:, None] * H + h).reshape(-1),
                             (src_d.long()[:, None] * H + h).reshape(-1)]),
                we.reshape(-1), (n * H, n * H)).coalesce().to_sparse_csr()
            x2 = x.view(n * H, D)
            _report_forms(f"mh H*D={H * D} gat.{d}", times,
                          _ms(lambda: sk.plan_segment_sum_mh(plan, x, we, D, src=src_d)),
                          _ms(lambda: x.index_select(0, plan.src_slots.reshape(-1))),
                          _ms(lambda: torch.sparse.mm(ncsr, x2)), same, None,
                          "head-expanded node")
            del x, vals, ncsr, x2


def ab(dev: torch.device, sources: list, products: bool = False) -> None:
    kinds = {"slot_segment_sum.cu": _ab_slot, "slot_aeb.cu": _ab_aeb, "sddmm_bat.cu": _ab_sddmm,
             "bat_segment_sum_packed.cu": _ab_bat, "slot_mh.cu": _ab_mh,
             "bat_segment_sum.cu": lambda dev, files: _ab_wide(dev, files, products)}
    for name, run in kinds.items():
        files = [Path(s) for s in sources if Path(s).name == name]
        if files:
            run(dev, files)
    unknown = [s for s in sources if Path(s).name not in kinds]
    if unknown:
        raise SystemExit(f"probe_slot ab: no comparison for {unknown}")


def _variant(flags: list, tag: str):
    """This checkout's edge_row_sum.cu built with extra nvcc flags; its
    bound entry point and the ptxas report."""
    from geot_tpu_torch.ops import _build

    out_dir = Path(_build._BUILD_DIR) / "probe_rowsum"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{tag}.so"
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib_path),
                        str(_build._CSRC / _build.SOURCES["edge_row_sum"])],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {flags}:\n{p.stdout}{p.stderr}")
    fn = ctypes.CDLL(str(lib_path)).geot_edge_row_sum
    return fn, p.stdout + p.stderr


def edge_row_registers(ptxas_report: str) -> list:
    """[(G, heads mode, registers)] of the 16-byte-row edge_row_kernel
    builds in an nvcc -Xptxas -v report (heads mode 0: one weight an entry,
    1: one head weight a lane, 2: one a column; edge_row_sum.cu)."""
    regs, key = [], None
    for line in ptxas_report.splitlines():
        m = re.search(r"Compiling entry function '\S*edge_row_kernelILb1ELi(\d+)ELi(\d+)E", line)
        key = (int(m.group(1)), int(m.group(2))) if m else (
            key if "Compiling entry" not in line else None)
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            regs.append((*key, int(m.group(1))))
            key = None
    return regs


def rowsum(dev: torch.device, configs: list, wide: bool = False,
           products: bool = False, slot: bool = False) -> None:
    """The edge-row kernel built with each configuration ("LABEL|NVCC
    FLAGS|slice_slots=N,task_cost=N,fix_fanin=N": extra nvcc flags and the
    schedule's knobs, each part may be empty), timed
    in turns (in order, then in reverse) at phase 24's and phase 29's
    shapes, in both forms: the flickr AEB sums (per-call weights, F 64 and
    7) and the packed BAT sums of GIN (arxiv, F 64) and APPNP (flickr, F 8),
    over `bat` and `bat_t`. With `wide`, also phase 5's and 9's wide BAT
    sums (the arxiv GCN, F 128 and 40, bat and bat_t) and phase 19's
    sr_packed (flickr GCN, F 64 and 7); with `products`, phase 14's
    remainder sums (F 128 and 47, both directions, gathered); with `slot`,
    phase 19's sr (GraphSAGE, F 500) and phase 24's mh (GAT, H*D 256 and
    28, over `plan` and `plan_t`). The lower times are summed per class
    (narrow, wide, products, slot)."""
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.graph.plan import with_row_schedule
    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops import edge_row_kernels as erk
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum_packed
    from geot_tpu_torch.profile_gcn import ARXIV_GIN, FLICKR_APPNP, FLICKR_HIDDEN, flickr_graph

    cfgs = []
    for i, spec in enumerate(configs):
        label, flags, knobs = (spec.split("|") + ["", ""])[:3]
        kn = {k: int(v) for k, v in (kv.split("=") for kv in knobs.split(",") if kv)}
        fn, report = _variant(flags.split(), f"v{i}")
        print(f"config {label}: flags {flags!r} knobs {kn}; registers (G, heads mode, regs) "
              f"{edge_row_registers(report)}", flush=True)
        cfgs.append((label, fn, kn))
    fn0 = erk._bound_fn()  # sets the C signature once; each variant takes the same
    for _, fn, _ in cfgs:
        fn.argtypes, fn.restype = fn0.argtypes, fn0.restype
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    for fh, name in ((128, "sr2"), (64, "packed2")):
        g = flickr_graph(data, "gcn-dyn", dev, fh)
        we = torch.rand(g.num_edges, generator=gen, device=dev) + 0.1
        fn = sk.plan_segment_sum_sr2 if name == "sr2" else sk.plan_segment_sum_packed2
        kw = {"vals_layout": "edge"} if name == "sr2" else {}
        for F in (FLICKR_HIDDEN, c):
            x = torch.randn(n, F, generator=gen, device=dev)
            vals = x.index_select(0, g.src.long())
            cases.append(("narrow", f"{name} F={F} values", g.plan,
                          lambda p, fn=fn, v=vals, w=we, kw=kw: fn(p, v, w_edge=w, **kw)))
            cases.append(("narrow", f"{name} F={F} gathered", g.plan,
                          lambda p, fn=fn, x=x, w=we, s=g.src, kw=kw: fn(p, x, w_edge=w, src=s,
                                                                          **kw)))
    for name, shape, kw, extra, weighted in (("gin", "ogbn-arxiv", ARXIV_GIN, {}, False),
                                             ("appnp", "flickr", FLICKR_APPNP,
                                              {"power": 1.0}, True)):
        n, e, f, c = DATASET_SHAPES[shape]
        data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=0, **extra)
        g = prepare_graph(data.src, data.dst, n, device=dev, **kw)
        for d in ("bat", "bat_t"):
            bp = getattr(g, d)
            F = 128 // bp.km_pack
            src_d = g.src if d == "bat" else g.dst_t
            w = (torch.rand(g.num_edges, generator=gen, device=dev) + 0.1) if weighted else None
            x = torch.randn(n, F, generator=gen, device=dev)
            vals = x.index_select(0, src_d.long())
            cases.append(("narrow", f"{name}.{d} F={F} values", bp,
                          lambda p, v=vals, w=w: bat_segment_sum_packed(p, v, w)))
            cases.append(("narrow", f"{name}.{d} F={F} gathered", bp,
                          lambda p, x=x, w=w, s=src_d: bat_segment_sum_packed(p, x, w, src=s)))
    if wide:
        cases += _wide_rowsum_cases(dev, gen, products)
    if slot:
        cases += _slot_rowsum_cases(dev, gen)
    own = erk._bound_fn
    sums = {}
    try:
        for cls, what, plan, call in cases:
            plans = {label: with_row_schedule(plan, **kn) if kn else plan
                     for label, _, kn in cfgs}
            times = {label: [] for label, _, _ in cfgs}
            outs = {}
            for label, fn, _ in cfgs + cfgs[::-1]:
                erk._bound_fn = lambda fn=fn: fn
                times[label].append(_ms(lambda: call(plans[label])))
                outs[label] = call(plans[label])
            ref = outs[cfgs[0][0]]
            scale = ref.abs().max().clamp(min=1.0)
            close = all(bool(((o - ref).abs() <= 1e-4 * scale).all()) for o in outs.values())
            for label, _, _ in cfgs:
                sums.setdefault(cls, {}).setdefault(label, 0.0)
                sums[cls][label] += min(times[label])
            print(f"{what}: {_fmt(times)}; outputs agree: {close}", flush=True)
    finally:
        erk._bound_fn = own
    for cls, by in sums.items():
        print(f"sum of the lower times ({cls}): "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in by.items()), flush=True)


def _wide_rowsum_cases(dev, gen, products: bool) -> list:
    """`rowsum`'s wide cases: (class, label, plan, call(plan))."""
    from geot_tpu_torch.graph.datasets import (
        DATASET_SHAPES,
        synthetic_clustered_graph,
        synthetic_graph,
    )
    from geot_tpu_torch.models import gcn_edge_weight, prepare_graph
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum
    from geot_tpu_torch.profile_gcn import FLICKR_HIDDEN, flickr_graph

    cases = []
    n, e, f, c = DATASET_SHAPES["ogbn-arxiv"]
    data = synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=0)
    g = prepare_graph(data.src, data.dst, n, layouts=("bat",), device=dev)
    w = gcn_edge_weight(g)
    for d, bp, src_d, w_d in (("bat", g.bat, g.src, w),
                              ("bat_t", g.bat_t, g.dst_t, w[g.perm_t.long()])):
        for F in (128, c):
            x = torch.randn(n, F, generator=gen, device=dev)
            vals = x.index_select(0, src_d.long())
            cases.append(("wide", f"bat_segment_sum arxiv {d} F={F} values", bp,
                          lambda p, v=vals, w=w_d: bat_segment_sum(p, v, w)))
            cases.append(("wide", f"bat_segment_sum arxiv {d} F={F} gathered", bp,
                          lambda p, x=x, w=w_d, s=src_d: bat_segment_sum(p, x, w, src=s)))
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    gg = flickr_graph(data, "gcn", dev)
    for F in (FLICKR_HIDDEN, c):
        x = torch.randn(n, F, generator=gen, device=dev)
        vals = x.index_select(0, gg.plan.src_slots.reshape(-1))
        ws = gg.w_slots
        cases.append(("wide", f"sr_packed flickr F={F} values", gg.plan,
                      lambda p, v=vals, w=ws: sk.plan_segment_sum_sr_packed(p, v, w)))
        cases.append(("wide", f"sr_packed flickr F={F} gathered", gg.plan,
                      lambda p, x=x, w=ws, s=gg.src: sk.plan_segment_sum_sr_packed(p, x, w,
                                                                                  src=s)))
    if products:
        n, e, f, c = DATASET_SHAPES["ogbn-products"]
        data = synthetic_clustered_graph(n, e, mixing=0.3, mean_community=2000, power=1.0,
                                         feat_dim=f, num_classes=c, seed=0)
        g = prepare_graph(data.src, data.dst, n, normalize="gcn", layouts=("bat", "stream"),
                          device=dev)
        for d, h in (("forward", g.hyb), ("transpose", g.hyb_t)):
            for F in (128, c):
                x = torch.randn(n, F, generator=gen, device=dev)
                cases.append(("products", f"bat_segment_sum products {d} F={F} gathered",
                              h.rest, lambda p, x=x, h=h: bat_segment_sum(p, x, h.rest_w,
                                                                          src=h.rest_src)))
    return cases


def _slot_rowsum_cases(dev, gen) -> list:
    """`rowsum`'s slot cases: (class, label, plan, call(plan))."""
    from geot_tpu_torch.graph.datasets import DATASET_SHAPES, synthetic_graph
    from geot_tpu_torch.ops import slot_kernels as sk
    from geot_tpu_torch.profile_gcn import FLICKR_HIDDEN, flickr_graph

    cases = []
    n, e, f, c = DATASET_SHAPES["flickr"]
    data = synthetic_graph(n, e, power=1.0, feat_dim=f, num_classes=c, seed=0)
    gs = flickr_graph(data, "graphsage", dev)
    x = torch.randn(n, f, generator=gen, device=dev)
    vals = x.index_select(0, gs.plan.src_slots.reshape(-1))
    w = gs.plan.mask
    cases.append(("slot", f"sr flickr F={f} values", gs.plan,
                  lambda p: sk.plan_segment_sum_sr(p, vals, w)))
    cases.append(("slot", f"sr flickr F={f} gathered", gs.plan,
                  lambda p: sk.plan_segment_sum_sr(p, x, w, src=gs.src)))
    gg = flickr_graph(data, "gat", dev)
    for d, plan, src_d in (("plan", gg.plan, gg.src), ("plan_t", gg.plan_t, gg.dst_t)):
        for H, D in ((4, FLICKR_HIDDEN), (4, c)):
            xh = torch.randn(n, H * D, generator=gen, device=dev)
            we = torch.rand(gg.num_edges, H, generator=gen, device=dev) + 0.1
            ws = (we.index_select(0, plan.edge_pos.reshape(-1).long())
                  * plan.mask.reshape(-1, 1)).contiguous()
            vh = xh.index_select(0, plan.src_slots.reshape(-1))
            cases.append(("slot", f"mh gat.{d} H*D={H * D} values", plan,
                          lambda p, v=vh, w=ws, D=D: sk.plan_segment_sum_mh(p, v, w, D)))
            cases.append(("slot", f"mh gat.{d} H*D={H * D} gathered", plan,
                          lambda p, x=xh, w=we, s=src_d, D=D: sk.plan_segment_sum_mh(
                              p, x, w, D, src=s)))
    return cases


# one model's request and training step, run in the tree named by the
# process's working directory (its own package on the path)
_PATH_TIMING = r"""
import json, sys, torch
from geot_tpu_torch.models import make_optimizer, make_train_step
from geot_tpu_torch.profile_gcn import build
graph, name, fh = sys.argv[1], sys.argv[2], int(sys.argv[3])
dev = torch.device("cuda")
model, g, x, y, mask = build(graph, name, 0, dev, fh)
step = make_train_step(model, make_optimizer(model, 0.01, 5e-4), has_dropout=False)
def ms(fn, iters):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(); a.record()
    for _ in range(iters):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
model.eval()
with torch.inference_mode():
    fwd = ms(lambda: model(x, g), 20)
stp = ms(lambda: step(x, g, y, mask), 10)
print("PATH " + json.dumps({"forward_ms": fwd, "train_step_ms": stp}))
"""

_PATHS = {"appnp": ("flickr", "appnp", 128), "gin": ("arxiv", "gin", 128),
          "gcn-dyn64": ("flickr", "gcn-dyn", 64), "gcn-dyn128": ("flickr", "gcn-dyn", 128),
          "gcn-arxiv": ("arxiv", "gcn", 128), "gcn-flickr": ("flickr", "gcn", 128),
          "graphsage-flickr": ("flickr", "graphsage", 128), "gat-flickr": ("flickr", "gat", 128),
          "gcn-products": ("products-clustered", "gcn", 128)}


def paths(parent: str, models: list) -> None:
    here = str(Path(__file__).resolve().parents[1])
    trees = {"parent": str(Path(parent).resolve()), "this": here}
    for m in models:
        graph, name, fh = _PATHS[m]
        res = {"parent": [], "this": []}
        for turn in ("parent", "this", "this", "parent"):
            env = dict(os.environ, PYTHONPATH=trees[turn])
            run = subprocess.run([sys.executable, "-c", _PATH_TIMING, graph, name, str(fh)],
                                 cwd=trees[turn], env=env, capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"paths {m} in {trees[turn]}:\n{run.stderr[-4000:]}")
            line = [ln for ln in run.stdout.splitlines() if ln.startswith("PATH ")][-1]
            res[turn].append(json.loads(line[5:]))
        print(f"{m}: " + "; ".join(
            f"{k} forward " + " / ".join(f"{r['forward_ms']:.4f}" for r in v) + " ms, step "
            + " / ".join(f"{r['train_step_ms']:.4f}" for r in v) + " ms"
            for k, v in res.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("gathers")
    p_ab = sub.add_parser("ab")
    p_ab.add_argument("--other", action="append", required=True,
                      help="a slot_segment_sum.cu, slot_aeb.cu, bat_segment_sum_packed.cu, "
                           "bat_segment_sum.cu, slot_mh.cu or sddmm_bat.cu to compare with "
                           "(repeatable)")
    p_ab.add_argument("--products", action="store_true",
                      help="bat_segment_sum.cu: the products remainder's shapes too")
    p_rs = sub.add_parser("rowsum")
    p_rs.add_argument("--config", action="append", required=True,
                      help='"LABEL|NVCC FLAGS|slice_slots=N,task_cost=N,fix_fanin=N"')
    p_rs.add_argument("--wide", action="store_true",
                      help="the wide BAT and sr_packed shapes too")
    p_rs.add_argument("--products", action="store_true",
                      help="with --wide: the products remainder's shapes too")
    p_rs.add_argument("--slot", action="store_true",
                      help="the sr (F 500) and mh (H*D 256, 28) shapes too")
    p_paths = sub.add_parser("paths")
    p_paths.add_argument("--parent", required=True, help="another commit's unpacked tree")
    p_paths.add_argument("--model", action="append", choices=tuple(_PATHS),
                         help="default: all but gcn-products (~100 s of host build a run)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_slot: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.what == "gathers":
        gathers(dev)
    elif args.what == "ab":
        ab(dev, args.other, args.products)
    elif args.what == "rowsum":
        rowsum(dev, args.config, args.wide, args.products, args.slot)
    else:
        paths(args.parent, args.model or [m for m in _PATHS if m != "gcn-products"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
