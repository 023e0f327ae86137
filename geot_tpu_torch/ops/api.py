"""Fused SpMM over BAT plans: the forward half of the reference op API.

Port of `geot_tpu/ops/api.py` (`_round_up` :67, `_pick_f_tile` :87,
`_chunk_plan` :107, `_plan_sum_chunked` :182,
`_bat_sum` :335 (wide branch), `_spmm_fwd_bat` :750, `dispatch_path`
:1298, `segment_spmm` :1367). Forward only: the transpose-plan backward
(`_make_gws_bat`, `_make_gs_bat` as `torch.autograd.Function`s with the
SDDMM weight gradient) is ROADMAP A.3 / A.6.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from geot_tpu_torch.graph.plan import BatPlan
from geot_tpu_torch.graph.structures import Graph
from geot_tpu_torch.ops import reference as ref
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum

__all__ = ["segment_spmm", "dispatch_path", "segment_counts"]

BACKENDS = ("auto", "reference")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_f_tile(n_features: int) -> int:
    return 256 if (n_features % 256 == 0 and n_features >= 256) else 128


def _chunk_plan(plan: BatPlan, c) -> BatPlan:
    """Slice chunk c = (t0, t1, w0, w1) out of a plan; its output rows
    start at window w0. With uniform chunks the output spans
    `chunk_blocks` windows and `num_segments` trims it to the real rows."""
    t0, t1, w0, w1 = c
    s = plan.s_tile
    nb = plan.chunk_blocks or (w1 - w0)
    return dataclasses.replace(
        plan,
        out_block=plan.out_block[t0:t1] - w0,
        vblock=plan.vblock[t0:t1],
        n_blocks=nb,
        num_segments=min(max(plan.num_segments - w0 * s, 0), (w1 - w0) * s),
        chunks=(),
        chunk_blocks=0,
        chunk_vbase=(),
    )


def _plan_sum_chunked(plan: BatPlan, run_one: Callable) -> torch.Tensor:
    """Chunked tiled segment sum: `run_one(chunk_plan, i, chunk)` returns
    one chunk's trimmed output [chunk_segments, n]. Consecutive chunks that
    split a hub window mid-window share that window, and their outputs are
    add-combined on the overlap."""
    if not plan.chunks:
        return run_one(plan, None, (0, plan.num_tiles, 0, plan.n_blocks))
    s = plan.s_tile
    pieces = []
    prev_w1 = None
    for i, c in enumerate(plan.chunks):
        o = run_one(_chunk_plan(plan, c), i, c)
        w0, w1 = c[2], c[3]
        if prev_w1 is not None and w0 < prev_w1:
            if w0 != prev_w1 - 1:
                raise ValueError("chunks may only overlap one window")
            last = pieces[-1]
            ov = min(s, o.shape[0], last.shape[0])
            last[-ov:] += o[:ov]  # in place: `last` is this function's own
            if o.shape[0] > ov:
                pieces.append(o[ov:])
        else:
            pieces.append(o)
        prev_w1 = w1
    return torch.cat(pieces, dim=0)[: plan.num_segments]


def _bat_sum(
    bp: BatPlan,
    vals_fn: Callable,
    n: int,
    w_edge: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tiled segment sum over EDGE-ordered values through the BAT kernel.
    `vals_fn(e_begin, size)` returns value rows for edges
    [e_begin, e_begin + size) ([<= size, n], n a multiple of the feature
    tile), or the whole edge list for e_begin None.

    The reference runs more than 2 chunks under `lax.scan` (`_bat_sum_scan`,
    api.py:415) to compile one chunk body. PyTorch runs eagerly, so every
    chunk count goes through this one Python loop; the sums are the same.
    Each chunk gathers min(chunk_vblocks, tiles + 1) value blocks, as the
    scan does (every real block of a chunk lies in that span).
    """
    E, s = bp.e_tile, bp.s_tile
    f_tile = _pick_f_tile(n)
    if bp.chunks and len(bp.chunk_vbase) != len(bp.chunks):
        raise ValueError("chunk_vbase out of step with chunks; use plan.with_chunks")

    def run_one(cp: BatPlan, i, c):
        t0, t1, w0, _ = c
        if i is None:
            cpp, v, we = cp, vals_fn(None, bp.num_edges), w_edge
        else:
            vbase = bp.chunk_vbase[i]
            nblk = min(bp.chunk_vblocks or (t1 - t0 + 1), t1 - t0 + 1)
            size = nblk * E
            # rebase: pad (sentinel) tiles point one past the chunk's blocks
            # at a forced -1 block; dst ids shift into the chunk's window-
            # local range (-1 entries shift too but stay below any window)
            vb_rel = torch.where(
                cp.vblock >= bp.n_vblocks,
                torch.full_like(cp.vblock, nblk),
                cp.vblock - vbase,
            )
            real = bp.dst3[vbase : min(vbase + nblk, bp.n_vblocks)]
            dst3 = torch.full(
                (nblk + 1, 1, E), -1, dtype=bp.dst3.dtype, device=bp.dst3.device
            )
            dst3[: real.shape[0]] = real
            dst3[: real.shape[0]] -= w0 * s
            cpp = dataclasses.replace(cp, vblock=vb_rel, dst3=dst3, n_vblocks=nblk)
            v = vals_fn(vbase * E, size)
            we = None
            if w_edge is not None:
                we = w_edge[vbase * E : vbase * E + size]
        out = bat_segment_sum(cpp, v, we, f_tile=f_tile)
        return out[: cpp.num_segments]

    return _plan_sum_chunked(bp, run_one)


def _spmm_fwd_bat(
    bp: BatPlan, x: torch.Tensor, src: torch.Tensor, w_edge: Optional[torch.Tensor]
) -> torch.Tensor:
    """sum_e w_e * x[src_e] by dst window via the BAT kernel: the gather
    emits rows in raw EDGE order and weights stream in edge order.

    x's columns are padded to the kernel's feature tile BEFORE the gather
    (so no chunk pays a pad copy of its gathered block). The reference does
    this only for n > 64 and pads narrow rows after the gather; the sums
    are the same."""
    n = x.shape[1]
    f_pad = _round_up(max(n, 1), _pick_f_tile(n))
    if f_pad != n:
        x = F.pad(x, (0, f_pad - n))
    E = bp.e_tile
    nnz = src.shape[0]
    # src padded to whole value blocks; the pad rows gather node 0 and meet
    # only -1 dst ids. A chunk's gather may run past the end: it then
    # returns fewer rows, and the kernel reads missing rows as zero.
    src_pad = F.pad(src.long(), (0, _round_up(max(nnz, E), E) - nnz))

    def vals_fn(e_begin, size):
        if e_begin is None:
            return x.index_select(0, src_pad)
        return x.index_select(0, src_pad[e_begin : e_begin + size])

    out = _bat_sum(bp, vals_fn, f_pad, w_edge=w_edge)
    return out[:, :n] if f_pad != n else out


def segment_counts(bp: BatPlan) -> torch.Tensor:
    """Edges per segment (in-degree), from the plan's dst blocks."""
    d = bp.dst3.reshape(-1).long()
    keep = (d >= 0) & (d < bp.num_segments)
    out = torch.zeros(bp.num_segments, dtype=torch.float32, device=d.device)
    return out.index_add_(0, d[keep], torch.ones_like(d[keep], dtype=torch.float32))


def dispatch_path(
    graph: Graph,
    *,
    dynamic_w: bool = False,
    reduce: str = "sum",
    backend: str = "auto",
) -> str:
    """Which implementation `segment_spmm` runs for this (graph, call):
    'bat_static' (graph's own weights), 'bat' (unweighted), 'bat_dyn'
    (per-call weights) or 'xla' (the plain reference; the name is the
    reference's). The reference's other routes — hybrid, bucketed, slot,
    slot_static, slot_dyn — raise NotImplementedError."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    in_sum = reduce in ("sum", "mean")
    if backend == "reference" or not in_sum:
        return "xla"
    if graph.bat is None:
        raise NotImplementedError(
            "graph has no BAT plan: the slot-layout routes are ROADMAP A.9"
        )
    if not dynamic_w and graph.edge_weight is not None:
        return "bat_static"
    if not dynamic_w:
        return "bat"
    return "bat_dyn"


def segment_spmm(
    graph: Graph,
    x: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    *,
    reduce: str = "sum",
    backend: str = "auto",
) -> torch.Tensor:
    """Model-facing fused SpMM over a prebuilt Graph:
    out[d] = reduce over edges (s -> d) of w_e * x[s] (w_e = 1 unweighted).
    `edge_weight` (per call, dst-sorted edge order) overrides the graph's
    static weights. Forward only."""
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "segment_spmm has no backward yet (transpose-plan autograd.Function "
            "is ROADMAP A.3); call it under torch.no_grad() or inference_mode()"
        )
    w = edge_weight if edge_weight is not None else graph.edge_weight
    path = dispatch_path(graph, dynamic_w=edge_weight is not None,
                         reduce=reduce, backend=backend)
    if path == "xla":
        if w is None:
            return ref.gather_scatter_ref(graph.src, graph.dst, x, graph.num_nodes, reduce)
        return ref.gather_weight_scatter_ref(
            graph.src, graph.dst, w, x, graph.num_nodes, reduce
        )
    out = _spmm_fwd_bat(graph.bat, x, graph.src, w)
    if reduce == "mean":
        deg = segment_counts(graph.bat)
        out = out / torch.clamp(deg, min=1.0)[:, None].to(out.dtype)
    return out
