"""Hybrid stream+gather SpMM plan (the gather-free path), host side.

Port of `geot_tpu/graph/stream_plan.py` (`StreamPlan` :98, `HybridPlan`
:145, `cell_census` :162, `_cell_stream_cost` :188,
`build_stream_split_host` :202-411, `_uniformize_stream_chunks` :414,
`stream_plan_from_host` :456). Given the same dst-sorted edges and the
same knobs, and `uniformize=True`, the host arrays and meta equal the JAX
package's exactly; the port's own plans leave out the reference's chunk
padding, which only its TPU scan needs.

Edges are grouped into (dst window, src block) cells: a window is `s_tile`
output rows, a block `x_rows` rows of x. A cell census (a cost model per
cell) decides which cells stream: their edges go into tiles of `e_tile`
slots, each tile holding edges of one cell only, so a tile reads one x
block instead of gathering rows from all of x. One plan family per tile
size; the families and the BAT remainder (the cells that do not stream)
add into one output.

The census's constants (`StreamKnobs`) are the reference package's
parameters, copied so that the split equals the reference's. They were
not measured on the H100 and describe no property of it; the port reads
no environment variable for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from geot_tpu_torch.graph.plan import MAX_PREFETCH_TILES, BatPlan, compute_chunks
from geot_tpu_torch.graph.row_schedule import (  # noqa: F401 (re-exported)
    LAST_SLOT,
    UNIT_COST,
    ZERO_COST,
    _fix_tree,
    row_schedule,
)

__all__ = [
    "StreamKnobs",
    "StreamPlan",
    "HybridPlan",
    "cell_census",
    "build_stream_split_host",
    "stream_plan_from_host",
    "SLICE_SLOTS",
    "FIX_FANIN",
    "kernel_schedule",
]


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class StreamKnobs:
    """The census's cost model and gates, all in one place.

    Defaults are the reference package's values (`stream_plan.py:78-82`,
    `:257`, `:261-263`, `:286`, `:314-319` and its `min_stream_frac`), so
    the split equals the reference's. They are copied parameters, not
    measurements of the H100.

    tile_ns: modeled cost (ns) of one streamed tile, per tile size.
    fixed_ns, marg_ns: affine cost fixed_ns + e_tile * marg_ns for a tile
      size outside `tile_ns`.
    e_choices: tile sizes a cell may take.
    gather_points, bat_edge_points, rest_edge_points: ((bytes, bytes),
      (ns, ns)) — the per-row gather cost (reported in stats only), the
      per-edge cost of an all-BAT SpMM and of the BAT remainder, each
      interpolated linearly in the table size (x rows * feature_hint * 4
      bytes) between its two points.
    margin: at `margin_min_edges` edges or more, the modeled hybrid time
      must beat margin * the modeled all-BAT time for the split to stand.
    min_stream_frac: the least share of edges that must stream.
    """

    tile_ns: Tuple[Tuple[int, float], ...] = (
        (256, 950.0), (512, 1500.0), (1024, 3400.0), (2048, 6400.0), (4096, 9100.0))
    fixed_ns: float = 650.0
    marg_ns: float = 2.1
    e_choices: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    gather_points: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (128e6, 1.25e9), (3.5, 12.0))
    bat_edge_points: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (87e6, 1.25e9), (4.5, 8.5))
    rest_edge_points: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (87e6, 1.25e9), (5.4, 7.9))
    margin: float = 0.75
    margin_min_edges: int = 200_000
    min_stream_frac: float = 0.25

    def tile_cost(self, e_tile: int) -> float:
        return dict(self.tile_ns).get(e_tile, self.fixed_ns + e_tile * self.marg_ns)


# The CUDA kernel's schedule (`kernel_schedule`), made on the host with the
# plan. A group of lanes sums one output row's live slots in registers;
# a row with more than SLICE_SLOTS live slots (a hub) is cut into near-equal
# slices of at most that many, each summed as a unit of its own into a
# partial, and a fix-up pass adds a row's partials in slice order, at most
# FIX_FANIN at a time (a row with more slices than that is reduced in a
# fixed tree, one launch per level).
# A task is a run of consecutive elements (units, each a row or a slice,
# and the empty rows between them, in row order) that one group takes.
# Tasks are cut at TASK_COST of work (`row_schedule`'s costs: a live slot
# costs 1, a unit UNIT_COST more, an empty row ZERO_COST). The row lists,
# slices, tasks and fix-up tree are `graph.row_schedule.row_schedule`'s,
# which the edge-row kernel's schedule shares.
# SLICE_SLOTS and TASK_COST were measured on an H100 over the
# products-clustered graph (`python -m geot_tpu_torch.probe_stream`): small
# tasks keep the rows that the resident groups work on, and so the x
# blocks they read, few enough to stay in L2, and short slices spread a
# hub row's reads over many groups. The first values, 512 and 1024, took
# up to 1.4x as long on the forward families (`PERF.md` §6).
SLICE_SLOTS = 128
FIX_FANIN = 32
TASK_COST = 128


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Cell-sorted streaming plan of ONE tile-size family (torch tensors on
    one device). T tiles, E = e_tile slots each.

    out_block: [T] int32 — output window per tile, non-decreasing over the
      whole family (checked when made; uniformization pads, when asked
      for, keep it so).
    sblock:    [T] int32 — x block read by tile t (rows
      [sblock*x_rows, (sblock+1)*x_rows)).
    dst3:      [T, 1, E] int32 — global dst ids, -1 on padding slots.
    srcl3:     [T, 1, E] int32 — block-local src ids, -1 on padding.
    w3:        [T, 1, E] float32 or None — static per-slot weights (0 pad).
    edge_pos:  [T, 1, E] int32 or None — slot -> dst-sorted edge index.

    The CUDA kernel's schedule, made on the host with the plan by
    `kernel_schedule` (the reference's TPU grid needs none). S live slots
    (those with 0 <= srcl < x_rows and dst inside the tile's window), in
    (output row, slot) order; U units (a row's live slots, or a slice of
    them); P partial sums:
    cols:      [S] int32 — global x row of each live slot
      (sblock * x_rows + srcl), bit 31 set on the last slot of its unit.
    vals:      [S] float32 or None — its weight (w3's).
    unit_dest: [U] int32 — the output row of a whole row's unit, or
      -(p + 1) for a slice that writes partial p.
    tasks:     [n_tasks + 1, 3] int32 — (first slot, first unit, first
      zero run) of each group's task; the last row holds the totals.
    zero_runs: [Z, 2] int32 — (first row, rows): the rows no slot adds
      to, cut at task bounds (zeros in `stream_segment_sum`, left alone by
      `stream_segment_acc`).
    fix:       [M, 3] int32 — (dest, p0, p1): partials p0..p1-1 added in
      that order into dest (an output row, or -(p + 1) for partial p of a
      later level); `fix_levels` bounds the levels, launched in order.
    n_parts: P.
    """

    out_block: torch.Tensor
    sblock: torch.Tensor
    dst3: torch.Tensor
    srcl3: torch.Tensor
    w3: Optional[torch.Tensor]
    edge_pos: Optional[torch.Tensor]
    cols: torch.Tensor
    vals: Optional[torch.Tensor]
    unit_dest: torch.Tensor
    tasks: torch.Tensor
    zero_runs: torch.Tensor
    fix: torch.Tensor
    e_tile: int
    s_tile: int
    x_rows: int
    num_segments: int
    n_blocks: int
    n_xblocks: int
    num_edges: int
    n_parts: int = 0
    fix_levels: tuple = (0,)
    chunks: tuple = ()
    chunk_blocks: int = 0

    @property
    def num_tiles(self) -> int:
        return int(self.out_block.shape[0])

    def to(self, device) -> "StreamPlan":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, out_block=mv(self.out_block), sblock=mv(self.sblock),
            dst3=mv(self.dst3), srcl3=mv(self.srcl3), w3=mv(self.w3),
            edge_pos=mv(self.edge_pos), cols=mv(self.cols), vals=mv(self.vals),
            unit_dest=mv(self.unit_dest), tasks=mv(self.tasks),
            zero_runs=mv(self.zero_runs), fix=mv(self.fix),
        )


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Streamed cells + gather remainder; the partial sums add.

    stream:   tuple of StreamPlans, one per tile-size family, sorted by
              e_tile.
    rest:     BatPlan over the remaining (dst-sorted) edges, or None when
              every edge streams.
    rest_src: [nnz_rest] int32 gather indices of the remainder.
    rest_w:   [nnz_rest] float32 static weights of the remainder, or None.
    """

    stream: tuple
    rest: Optional[BatPlan]
    rest_src: Optional[torch.Tensor]
    rest_w: Optional[torch.Tensor]

    def to(self, device) -> "HybridPlan":
        return HybridPlan(
            stream=tuple(sp.to(device) for sp in self.stream),
            rest=None if self.rest is None else self.rest.to(device),
            rest_src=None if self.rest_src is None else self.rest_src.to(device),
            rest_w=None if self.rest_w is None else self.rest_w.to(device),
        )


def cell_census(
    dst: np.ndarray,
    src: np.ndarray,
    *,
    s_tile: int = 256,
    x_rows: int = 256,
) -> dict:
    """Histogram of (dst window, src block) cell sizes: the locality
    statistic the streaming path keys on."""
    w = np.asarray(dst, np.int64) // s_tile
    b = np.asarray(src, np.int64) // x_rows
    key = w << 32 | b
    _, cnt = np.unique(key, return_counts=True)
    out = dict(
        n_cells=int(len(cnt)),
        mean=float(cnt.mean()) if len(cnt) else 0.0,
        median=float(np.median(cnt)) if len(cnt) else 0.0,
    )
    for tau in (64, 128, 256, 512):
        out[f"frac_ge_{tau}"] = float(cnt[cnt >= tau].sum()) / max(len(dst), 1)
    return out


def _cell_stream_cost(cnt: np.ndarray, knobs: StreamKnobs) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell modeled streamed cost (ns) and its cost-optimal e_tile:
    the least over `knobs.e_choices` of ceil(cnt/E) * tile_cost(E)."""
    best_cost = np.full(len(cnt), np.inf, np.float64)
    best_e = np.zeros(len(cnt), np.int32)
    for E in knobs.e_choices:
        cost = _cdiv(cnt, E).astype(np.float64) * knobs.tile_cost(E)
        sel = cost < best_cost
        best_cost[sel] = cost[sel]
        best_e[sel] = E
    return best_cost, best_e


def _interp(table_bytes: float, points) -> float:
    return float(np.interp(table_bytes, list(points[0]), list(points[1])))


def build_stream_split_host(
    dst: np.ndarray,
    src: np.ndarray,
    num_segments: int,
    num_src: int,
    *,
    s_tile: int = 256,
    x_rows: int = 256,
    e_tile: int = 0,
    gather_ns: float = 0.0,
    feature_hint: int = 128,
    edge_weight: Optional[np.ndarray] = None,
    max_chunk_tiles: int = MAX_PREFETCH_TILES,
    build_edge_pos: bool = False,
    knobs: StreamKnobs = StreamKnobs(),
    uniformize: bool = False,
) -> Tuple[Optional[list], np.ndarray, dict]:
    """Split a dst-sorted edge list into (stream families, gather rest).

    Returns (families, rest_mask, stats): `families` is a list of
    (arrays, meta) pairs, one per tile-size family, each feeding
    `stream_plan_from_host` (None if the census rejects streaming for this
    graph); `rest_mask` is a bool[nnz] marking the edges left to the BAT
    path, order-preserving, so the masked sub-list stays dst-sorted.

    A cell of cnt edges streamed with tile size E is modeled at
    ceil(cnt/E) * tile_cost(E), on the BAT path at cnt * rest_edge_ns; a
    cell streams when that is cheaper. The split stands when at least
    `knobs.min_stream_frac` of the edges stream and, at
    `knobs.margin_min_edges` edges or more, when the modeled hybrid time
    beats `knobs.margin` times the modeled all-BAT time. `e_tile` > 0
    forces one family; `gather_ns` > 0 overrides the statistic reported in
    `stats`.

    `uniformize` pads every chunk of a family to one tile count, as the
    reference always does (`_uniformize_stream_chunks`), so that the
    arrays equal the reference's. The CUDA kernel launches a whole family
    at once and ignores `chunks`, so the port's plans leave it off: pad
    tiles would only be scanned.
    """
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    nnz = len(dst)
    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    n_xb = max(_cdiv(max(num_src, 1), x_rows), 1)
    stats: dict = {}
    if nnz == 0:
        return None, np.zeros(0, bool), stats

    table_bytes = num_src * max(feature_hint or 128, 1) * 4
    if gather_ns <= 0:
        gather_ns = _interp(table_bytes, knobs.gather_points)
    bat_edge_ns = _interp(table_bytes, knobs.bat_edge_points)

    w = dst // s_tile
    b = src // x_rows
    key = w * n_xb + b
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    head = np.empty(nnz, bool)
    head[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=head[1:])
    cell_start = np.nonzero(head)[0]
    cell_cnt = np.diff(np.concatenate([cell_start, [nnz]]))

    if e_tile:
        tiles = _cdiv(cell_cnt, e_tile)
        stream_cost = tiles.astype(np.float64) * knobs.tile_cost(e_tile)
        cell_e = np.full(len(cell_cnt), e_tile, np.int32)
    else:
        stream_cost, cell_e = _cell_stream_cost(cell_cnt, knobs)
    rest_edge_ns = _interp(table_bytes, knobs.rest_edge_points)
    sel_cells = stream_cost < cell_cnt * rest_edge_ns
    streamed = int(cell_cnt[sel_cells].sum())
    stream_frac = streamed / nnz
    est_stream_ms = float(stream_cost[sel_cells].sum()) / 1e6
    est_bat_ms = (nnz - streamed) * rest_edge_ns / 1e6
    stats.update(
        stream_frac=stream_frac,
        n_cells=len(cell_cnt), n_stream_cells=int(sel_cells.sum()),
        gather_ns=gather_ns,
        est_stream_ms=est_stream_ms,
        est_bat_ms=est_bat_ms,
        est_all_bat_ms=nnz * bat_edge_ns / 1e6,
    )
    est_hybrid_ms = est_stream_ms + est_bat_ms
    eff_margin = knobs.margin if nnz >= knobs.margin_min_edges else 1.0
    stats["est_hybrid_ms"] = est_hybrid_ms
    stats["margin"] = eff_margin
    if (
        stream_frac < knobs.min_stream_frac
        or est_hybrid_ms > eff_margin * stats["est_all_bat_ms"]
    ):
        return None, np.ones(nnz, bool), stats

    edge_sel_sorted = np.repeat(sel_cells, cell_cnt)
    rest_mask = np.ones(nnz, bool)
    rest_mask[order[edge_sel_sorted]] = False

    families = []
    fam_stats = []
    w_sorted = None if edge_weight is None else np.asarray(edge_weight, np.float32)
    for E in sorted(set(cell_e[sel_cells].tolist())):
        fam_cells = sel_cells & (cell_e == E)
        edge_in_fam = np.repeat(fam_cells, cell_cnt)
        f_order = order[edge_in_fam]
        f_dst = dst[f_order]
        f_src = src[f_order]
        f_cnt = cell_cnt[fam_cells]
        f_start = np.zeros(len(f_cnt) + 1, np.int64)
        np.cumsum(f_cnt, out=f_start[1:])
        n_fe = int(f_start[-1])
        f_keys = key_s[cell_start[fam_cells]]
        cell_w = (f_keys // n_xb).astype(np.int32)
        cell_b = (f_keys % n_xb).astype(np.int32)
        tiles_per_cell = _cdiv(f_cnt, E)
        T = int(tiles_per_cell.sum())
        ob = np.repeat(cell_w, tiles_per_cell)
        sb = np.repeat(cell_b, tiles_per_cell)
        tile_of_cell = np.zeros(len(f_cnt) + 1, np.int64)
        np.cumsum(tiles_per_cell, out=tile_of_cell[1:])
        pos_in_cell = np.arange(n_fe) - np.repeat(f_start[:-1], f_cnt)
        tile_idx = np.repeat(tile_of_cell[:-1], f_cnt) + pos_in_cell // E
        slot = tile_idx * E + pos_in_cell % E
        dst_slots = np.full(T * E, -1, np.int32)
        srcl = np.full(T * E, -1, np.int32)
        dst_slots[slot] = f_dst
        srcl[slot] = (f_src % x_rows).astype(np.int32)
        arrays = dict(
            out_block=ob.astype(np.int32),
            sblock=sb.astype(np.int32),
            dst3=dst_slots.reshape(T, 1, E),
            srcl3=srcl.reshape(T, 1, E),
        )
        if w_sorted is not None:
            w3 = np.zeros(T * E, np.float32)
            w3[slot] = w_sorted[f_order]
            arrays["w3"] = w3.reshape(T, 1, E)
        if build_edge_pos:
            edge_pos = np.zeros(T * E, np.int32)
            edge_pos[slot] = f_order.astype(np.int32)
            arrays["edge_pos"] = edge_pos.reshape(T, 1, E)
        # per-chunk slot budget, as the reference scales it
        mct = max(min(max_chunk_tiles, (max_chunk_tiles * 512) // E), 1)
        meta = dict(
            e_tile=int(E),
            s_tile=int(s_tile),
            x_rows=int(x_rows),
            num_segments=int(num_segments),
            n_blocks=int(n_blocks),
            n_xblocks=int(n_xb),
            num_edges=int(n_fe),
            chunks=compute_chunks(arrays["out_block"], mct),
            chunk_blocks=0,
        )
        if uniformize:
            _uniformize_stream_chunks(arrays, meta)
        families.append((arrays, meta))
        fam_stats.append(
            dict(e_tile=int(E), n_tiles=int(arrays["out_block"].shape[0]),
                 edges=n_fe,
                 fill=n_fe / max(arrays["out_block"].shape[0] * E, 1))
        )
    stats["families"] = fam_stats
    stats["n_tiles"] = int(sum(f["n_tiles"] for f in fam_stats))
    stats["fill"] = streamed / max(
        sum(f["n_tiles"] * f["e_tile"] for f in fam_stats), 1
    )
    return families, rest_mask, stats


def _uniformize_stream_chunks(arrays: dict, meta: dict) -> None:
    """Pad every chunk to the same tile count, as the reference does (its
    scan executor compiles one chunk body; the port does this only when
    asked, so that its arrays equal the reference's). Pad tiles carry all
    -1 slots and point at the chunk's last real window and x block."""
    chunks = meta["chunks"]
    if not chunks:
        return
    E = meta["e_tile"]
    T_max = max(t1 - t0 for t0, t1, _, _ in chunks)
    W_max = max(w1 - w0 for _, _, w0, w1 in chunks)
    n_c = len(chunks)
    T_new = n_c * T_max
    new = {
        "out_block": np.zeros(T_new, np.int32),
        "sblock": np.zeros(T_new, np.int32),
        "dst3": np.full((T_new, 1, E), -1, np.int32),
        "srcl3": np.full((T_new, 1, E), -1, np.int32),
    }
    if "w3" in arrays:
        new["w3"] = np.zeros((T_new, 1, E), np.float32)
    if "edge_pos" in arrays:
        new["edge_pos"] = np.zeros((T_new, 1, E), np.int32)
    new_chunks = []
    for i, (t0, t1, w0, w1) in enumerate(chunks):
        nt = t1 - t0
        base = i * T_max
        for k in new:
            new[k][base : base + nt] = arrays[k][t0:t1]
        new["out_block"][base + nt : base + T_max] = w1 - 1
        if nt:
            new["sblock"][base + nt : base + T_max] = arrays["sblock"][t1 - 1]
        new_chunks.append((base, base + T_max, int(w0), int(w1)))
    arrays.update(new)
    meta["chunks"] = tuple(new_chunks)
    meta["chunk_blocks"] = int(W_max)


def kernel_schedule(out_block: np.ndarray, sblock: np.ndarray, dst3: np.ndarray,
                    srcl3: np.ndarray, w3: Optional[np.ndarray], s_tile: int, x_rows: int,
                    n_blocks: int, *, slice_slots: int = SLICE_SLOTS,
                    fix_fanin: int = FIX_FANIN, task_cost: int = TASK_COST) -> dict:
    """The CUDA kernel's work for one family, as `StreamPlan` describes it:
    {"cols", "vals", "unit_dest", "tasks", "zero_runs", "fix", "fix_levels",
    "n_parts"}.

    The live slots are put in (output row, slot) order by a stable sort, so
    each row's terms keep the slot order; pads, out-of-window slots and
    srcl >= x_rows are dropped here and never read on the card. A row of
    n > slice_slots live slots is cut into ceil(n / slice_slots) slices of
    near-equal length. Raises ValueError unless out_block is
    non-decreasing and inside [0, n_blocks), the family's contract."""
    ob = np.asarray(out_block, np.int64)
    T = len(ob)
    E = int(dst3.shape[-1]) if T else 1
    if T > 1 and not bool(np.all(ob[1:] >= ob[:-1])):
        raise ValueError("StreamPlan out_block must be non-decreasing over the whole family")
    if T and (int(ob[0]) < 0 or int(ob[-1]) >= n_blocks):
        raise ValueError(f"StreamPlan out_block outside [0, {n_blocks})")
    n_out = n_blocks * s_tile

    # live slots in (row, slot) order
    sl = np.asarray(srcl3, np.int64).reshape(-1)
    d = np.asarray(dst3, np.int64).reshape(-1) - np.repeat(ob * s_tile, E)
    q = np.flatnonzero((sl >= 0) & (sl < x_rows) & (d >= 0) & (d < s_tile))
    t_of = q // E
    row = ob[t_of] * s_tile + d[q]
    order = np.argsort(row, kind="stable")
    q, t_of, row = q[order], t_of[order], row[order]
    cols = np.asarray(sblock, np.int64)[t_of] * x_rows + sl[q]
    vals = None if w3 is None else np.asarray(w3, np.float32).reshape(-1)[q]
    sched = row_schedule(row, cols, n_out, slice_slots=slice_slots, fix_fanin=fix_fanin,
                         task_cost=task_cost)
    sched["vals"] = vals
    return sched


def stream_plan_from_host(arrays: dict, meta: dict, device=None, **schedule) -> StreamPlan:
    """A StreamPlan of one family's host arrays, on `device`, with the
    kernel's schedule (`schedule`: `kernel_schedule`'s knobs)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    sched = kernel_schedule(arrays["out_block"], arrays["sblock"], arrays["dst3"],
                            arrays["srcl3"], arrays.get("w3"), meta["s_tile"],
                            meta["x_rows"], meta["n_blocks"], **schedule)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return StreamPlan(
        out_block=t(arrays["out_block"]),
        sblock=t(arrays["sblock"]),
        dst3=t(arrays["dst3"]),
        srcl3=t(arrays["srcl3"]),
        w3=t(arrays.get("w3")),
        edge_pos=t(arrays.get("edge_pos")),
        cols=t(sched["cols"]),
        vals=t(sched["vals"]),
        unit_dest=t(sched["unit_dest"]),
        tasks=t(sched["tasks"]),
        zero_runs=t(sched["zero_runs"]),
        fix=t(sched["fix"]),
        n_parts=sched["n_parts"],
        fix_levels=sched["fix_levels"],
        **meta,
    )
