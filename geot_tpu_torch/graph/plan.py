"""Tiled execution plans, host side: the slot layout (`SegmentPlan`) and
block-aligned tiles (`BatPlan`).

Port of `geot_tpu/graph/plan.py`: `SegmentPlan` :56-141,
`compute_chunks` :147-179, `_uniformize_chunks` :182-229,
`plan_tile_bounds` :232, `build_segment_plan_host` :242-384,
`_k_major_host` :387, `plan_from_host` :397, `BatPlan` :419-463,
`build_bat_plan_host` :466-557, `_uniformize_bat_chunks` :560-598,
`bat_plan_from_host` (with the packed kernel's k-major `dst_km`; the
reference's always-None `mask_km` is left out), `build_bat_plan`,
`packed_width`, `build_segment_plan` :622, and `BucketedBatPlan` /
`build_bucketed_bat_plan` :655-835. As in the reference, the slot arrays
at pack_align 1, the BAT tiles and the bucket sort come from the native
runtime (`geot_tpu_torch.native`) where it is built, else from numpy: the
same arrays either way. Given the same dst-sorted edges and knobs, the
host arrays and meta equal the JAX package's exactly.

Slot layout: tile t holds e_tile slots of consecutive dst-sorted edges
whose dst all lie in window `out_block[t]`; a window's edges fill its
tiles in order, and pad slots (mask 0) point at the window's base row.

BAT: a tile t is an (output window, value block) incidence: value block
`vblock[t]` holds e_tile consecutive edges of the dst-sorted edge list, and
the tile reduces the ones whose dst lies in window `out_block[t]` (rows
[out_block[t]*s_tile, (out_block[t]+1)*s_tile)).

In both, tiles are ordered by window and every window has at least one
tile (coverage), so a kernel can write every output row.

Bucketed BAT: the edges re-sorted by (source bucket, dst), each bucket's
padded to whole value blocks, and BAT tiles per bucket. The reference
gathers each chunk from its bucket's row slice of x, which runs faster on
a TPU; the card needs no slicing, and the port sums the plan whole over
its row schedule, with a global source id per padded entry.

Port-only: a slot plan (with e0) and every BAT plan carry the edge-row
kernel's schedule (`row_sched`, `graph.row_schedule.RowSchedule`), made
from the plan's host arrays when the plan is made; `row_schedule_of`
makes one for a plan that lacks it (a chunk cut out of a plan).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from geot_tpu_torch import native
from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.graph.row_schedule import (
    RowSchedule,
    bat_plan_entries,
    build_row_schedule,
    slot_plan_entries,
)

__all__ = [
    "SegmentPlan",
    "build_segment_plan",
    "build_segment_plan_host",
    "plan_from_host",
    "plan_tile_bounds",
    "BatPlan",
    "BucketedBatPlan",
    "build_bucketed_bat_plan",
    "build_bucketed_bat_plan_host",
    "bucketed_plan_from_host",
    "MAX_PREFETCH_TILES",
    "compute_chunks",
    "build_bat_plan_host",
    "bat_plan_from_host",
    "build_bat_plan",
    "packed_width",
    "with_chunks",
    "row_schedule_of",
    "with_row_schedule",
]


def _cdiv(a, b):
    return -(-a // b)


# cap on tiles per chunk, kept equal to the JAX package's so plans match
# (there it bounds the kernel's scalar-prefetched out_block in TPU SMEM;
# the CUDA kernel has no such limit)
MAX_PREFETCH_TILES = 8192


@dataclasses.dataclass(frozen=True)
class BatPlan:
    """Block-aligned-tile plan (torch tensors on one device).

    out_block: [T] int32, non-decreasing within each chunk — output window
      of tile t.
    vblock:    [T] int32 — value block of tile t (n_vblocks = the all--1
      sentinel block that uniformization pad tiles point at).
    dst3:      [n_vblocks + 1, 1, e_tile] int32 — dst ids, -1 padded.
    dst_km:    [n_vblocks + 1, 1, e_tile] int32 or None — the same dst ids
      k-major per value block (`_k_major_host` with `km_pack`): lane
      k*rows + r holds edge r*km_pack + k of the block, rows = e_tile //
      km_pack. Set with km_pack > 1, for the packed kernel
      (`bat_segment_sum_packed`, features 128 // km_pack wide).
    chunks:    ((t0, t1, w0, w1), ...) tile ranges [t0, t1) covering windows
      [w0, w1); consecutive chunks may share one (hub) window. The TPU
      runs a plan chunk by chunk (its scalar-prefetch and VMEM limits); the
      port's sums take the plan whole, by its `row_sched`, and keep the
      chunks so that the plan equals the reference's.
    """

    out_block: torch.Tensor
    vblock: torch.Tensor
    dst3: torch.Tensor
    e_tile: int
    s_tile: int
    num_segments: int
    n_blocks: int
    num_edges: int
    n_vblocks: int
    km_pack: int = 0
    chunks: tuple = ()
    chunk_blocks: int = 0
    chunk_vblocks: int = 0
    dst_km: Optional[torch.Tensor] = None
    # the edge-row kernel's schedule (`bat_segment_sum`,
    # `bat_segment_sum_packed`), made with the plan (`bat_plan_from_host`)
    row_sched: Optional[RowSchedule] = dataclasses.field(default=None, compare=False,
                                                         repr=False)

    @property
    def num_tiles(self) -> int:
        return int(self.out_block.shape[0])

    @property
    def padded_segments(self) -> int:
        return self.n_blocks * self.s_tile

    @property
    def device(self) -> torch.device:
        return self.out_block.device

    def to(self, device) -> "BatPlan":
        moved = dataclasses.replace(
            self,
            out_block=self.out_block.to(device),
            vblock=self.vblock.to(device),
            dst3=self.dst3.to(device),
            dst_km=None if self.dst_km is None else self.dst_km.to(device),
            row_sched=None,
        )
        if self.row_sched is None or not self.row_sched.matches(_sched_key(self)):
            return moved
        return dataclasses.replace(moved, row_sched=self.row_sched.to(device,
                                                                    _sched_key(moved)))


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Slot-layout plan (torch tensors on one device), T tiles of E slots.

    src_slots: [T, E] int32 — source node per slot (0 on padding).
    dst_slots: [T, E] int32 — destination row per slot; pad slots hold the
      tile's window base (local row 0).
    edge_pos:  [T, E] int32 — position in the caller's dst-sorted edge list
      (0 on padding).
    mask:      [T, E] float32 — 1 for real edges, 0 for padding.
    out_block: [T] int32 — output window of tile t; non-decreasing within
      each chunk, every window in [0, n_blocks) present.
    e0:        [T] int32 — edge index of slot 0 of tile t (slot j holds
      edge e0[t] + j where it is real).
    chunks: ((t0, t1, w0, w1), ...) tile ranges covering windows [w0, w1);
      with `chunk_blocks` > 0 they are uniformized (every chunk spans
      chunk_blocks windows; pad tiles are all padding).
    """

    src_slots: torch.Tensor
    dst_slots: torch.Tensor
    edge_pos: torch.Tensor
    mask: torch.Tensor
    out_block: torch.Tensor
    e_tile: int
    s_tile: int
    num_segments: int
    n_blocks: int
    num_edges: int
    num_src_nodes: int
    mode_hint: str = "auto"
    chunks: tuple = ()
    chunk_blocks: int = 0
    e0: Optional[torch.Tensor] = None
    n_value_blocks: int = 0
    pack_align: int = 1
    # the edge-row kernel's schedule (`plan_segment_sum_sr2` / `_packed2`),
    # made with the plan (`plan_from_host`)
    row_sched: Optional[RowSchedule] = dataclasses.field(default=None, compare=False,
                                                         repr=False)

    @property
    def num_tiles(self) -> int:
        return int(self.src_slots.shape[0])

    @property
    def padding_ratio(self) -> float:
        total = self.num_tiles * self.e_tile
        return float(total - self.num_edges) / float(max(self.num_edges, 1))


def compute_chunks(out_block: np.ndarray, max_tiles_per_chunk: int) -> tuple:
    """Window-aligned chunk boundaries: greedy tile ranges of at most
    `max_tiles_per_chunk`, cut at the last window start within the limit.
    A window larger than the limit (a hub) is cut mid-window; consecutive
    chunks then share that window and the executor add-combines it."""
    max_tiles_per_chunk = min(max(max_tiles_per_chunk, 1), MAX_PREFETCH_TILES)
    T = len(out_block)
    if max_tiles_per_chunk <= 0 or T <= max_tiles_per_chunk:
        return ()
    first = np.concatenate([[0], np.nonzero(np.diff(out_block))[0] + 1])
    chunks = []
    t0 = 0
    while t0 < T:
        limit = t0 + max_tiles_per_chunk
        if limit >= T:
            t1 = T
        else:
            k = np.searchsorted(first, limit, side="right") - 1
            t1 = int(first[k])
            if t1 <= t0:
                t1 = limit  # hub window: cut mid-window
        w0, w1 = int(out_block[t0]), int(out_block[t1 - 1]) + 1
        chunks.append((int(t0), int(t1), w0, w1))
        t0 = t1
    return tuple(chunks) if len(chunks) > 1 else ()


def _uniformize_chunks(arrays: dict, meta: dict) -> None:
    """Pad every chunk of a slot plan to identical (tiles, windows), in
    place: the arrays become [n_chunks * T_max, E] with all-padding tiles
    that cover the extra windows once each, then repeat the last one;
    meta["chunks"] keeps the real window ranges and meta["chunk_blocks"] =
    W_max. (On the TPU this lets every chunk share one compiled kernel; the
    port keeps it so its plans equal the reference's.)"""
    chunks = meta["chunks"]
    if not chunks:
        return
    s_tile = meta["s_tile"]
    T_max = max(t1 - t0 for t0, t1, _, _ in chunks)
    W_max = max(w1 - w0 for _, _, w0, w1 in chunks)
    n_c = len(chunks)
    ob = arrays["out_block"]
    new = {k: np.zeros((n_c * T_max,) + v.shape[1:], v.dtype) for k, v in arrays.items()}
    new_chunks = []
    for i, (t0, t1, w0, w1) in enumerate(chunks):
        nt = t1 - t0
        base = i * T_max
        for k, v in arrays.items():
            new[k][base : base + nt] = v[t0:t1]
        pad_windows = list(range(w1, w0 + W_max))
        pad_ob = (pad_windows + [w0 + W_max - 1] * T_max)[: T_max - nt]
        new["out_block"][base + nt : base + T_max] = np.asarray(pad_ob, ob.dtype)
        new["dst_slots"][base + nt : base + T_max] = (
            np.asarray(pad_ob, np.int64)[:, None] * s_tile
        ).astype(new["dst_slots"].dtype)
        if "e0" in arrays and nt > 0:
            # pad tiles inherit the last real tile's e0
            new["e0"][base + nt : base + T_max] = arrays["e0"][t1 - 1]
        new_chunks.append((base, base + T_max, int(w0), int(w1)))
    arrays.update(new)
    meta["chunks"] = tuple(new_chunks)
    meta["chunk_blocks"] = int(W_max)


def plan_tile_bounds(num_edges: int, num_segments: int, e_tile: int, s_tile: int) -> int:
    """Upper bound on the tiles of a slot plan: one per full e_tile of
    edges plus at most one partial (or coverage) tile per window."""
    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    return _cdiv(num_edges, e_tile) + n_blocks


def build_segment_plan_host(
    dst: np.ndarray,
    src: Optional[np.ndarray],
    num_segments: int,
    *,
    e_tile: int = 256,
    s_tile: int = 256,
    num_src_nodes: Optional[int] = None,
    mode_hint: str = "auto",
    max_chunk_slots: int = 4 << 20,
    pack_align: int = 16,
):
    """Host arrays (dict of numpy) and meta of a slot plan over dst-sorted
    edges. `src` None gives index_scatter-style plans (src_slots 0).
    Window w's slots start at the pack-aligned edge index at or below its
    first edge: the first `lead` slots of its first tile are padding, so
    e0 is a multiple of `pack_align` (halved until it divides e_tile)."""
    dst = np.asarray(dst)
    nnz = int(dst.shape[0])
    if nnz > 1 and not bool(np.all(dst[1:] >= dst[:-1])):
        raise ValueError("dst must be sorted ascending; use sort_edges_by_dst first")
    if nnz and int(dst[-1]) >= num_segments:
        raise ValueError(
            f"dst contains id {int(dst[-1])} >= num_segments={num_segments}"
        )
    if src is None:
        src_arr = np.zeros(nnz, dtype=np.int32)
        n_src = 1
    else:
        src_arr = np.asarray(src, dtype=np.int32)
        n_src = int(num_src_nodes) if num_src_nodes is not None else (
            int(src_arr.max()) + 1 if nnz else 1
        )
    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    pack_align = max(int(pack_align), 1)
    while e_tile % pack_align:
        pack_align //= 2
    pack = max(pack_align, 1)
    meta = dict(
        e_tile=int(e_tile),
        s_tile=int(s_tile),
        num_segments=int(num_segments),
        n_blocks=n_blocks,
        num_edges=nnz,
        num_src_nodes=n_src,
        mode_hint=mode_hint,
        pack_align=int(pack),
    )

    # the native runtime builds the pack_align 1 layout: slot j of tile t
    # holds edge e0[t] + j and every tile of a window but its last is full,
    # so e0 is the exclusive cumsum of the tiles' real edges
    nat = native.build_plan_arrays(dst, src_arr if src is not None else None,
                                   num_segments, e_tile, s_tile) if pack == 1 else None
    if nat is not None:
        src_sl, dst_sl, ep, mk, ob = nat
        n_real = mk.sum(axis=1).astype(np.int64)
        e0 = np.concatenate([[0], np.cumsum(n_real)[:-1]]).astype(np.int32)
        meta["n_value_blocks"] = int(e0.max() if len(e0) else 0) // e_tile + 2
        meta["chunks"] = compute_chunks(ob, max_chunk_slots // e_tile)
        arrays = dict(src_slots=src_sl, dst_slots=dst_sl, edge_pos=ep, mask=mk, out_block=ob,
                      e0=e0)
        _uniformize_chunks(arrays, meta)
        return arrays, meta

    block_of_edge = dst // s_tile if nnz else np.zeros(0, dtype=np.int64)
    cnt = np.bincount(block_of_edge, minlength=n_blocks).astype(np.int64)
    edge_start_of_block = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(cnt, out=edge_start_of_block[1:])
    lead = (edge_start_of_block[:-1] % pack).astype(np.int64)
    # at least one tile per window: an empty window gets an all-pad tile
    tiles_per_block = np.maximum(_cdiv(cnt + lead, e_tile), 1)
    tile_start = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(tiles_per_block, out=tile_start[1:])
    num_tiles = int(tile_start[-1])

    out_block = np.repeat(np.arange(n_blocks, dtype=np.int32), tiles_per_block)
    seg_base = out_block.astype(np.int64) * s_tile
    ks = np.arange(num_tiles, dtype=np.int64) - tile_start[out_block]
    aligned_start = edge_start_of_block[:-1] - lead
    e0 = (aligned_start[out_block] + ks * e_tile).astype(np.int32)

    dst_slots = np.repeat(seg_base, e_tile).reshape(num_tiles, e_tile)
    src_slots = np.zeros((num_tiles, e_tile), dtype=np.int32)
    edge_pos = np.zeros((num_tiles, e_tile), dtype=np.int32)
    mask = np.zeros((num_tiles, e_tile), dtype=np.float32)
    if nnz:
        p = (np.arange(nnz, dtype=np.int64) - edge_start_of_block[block_of_edge]
             + lead[block_of_edge])
        slot = (tile_start[block_of_edge] + p // e_tile) * e_tile + p % e_tile
        dst_slots.reshape(-1)[slot] = dst
        src_slots.reshape(-1)[slot] = src_arr
        edge_pos.reshape(-1)[slot] = np.arange(nnz, dtype=np.int32)
        mask.reshape(-1)[slot] = 1.0

    meta["n_value_blocks"] = int(e0.max() if len(e0) else 0) // e_tile + 2
    meta["chunks"] = compute_chunks(out_block, max_chunk_slots // e_tile)
    arrays = dict(
        src_slots=src_slots.astype(np.int32),
        dst_slots=dst_slots.astype(np.int32),
        edge_pos=edge_pos.astype(np.int32),
        mask=mask.astype(np.float32),
        out_block=out_block.astype(np.int32),
        e0=e0,
    )
    _uniformize_chunks(arrays, meta)
    return arrays, meta


def _k_major_host(arr: np.ndarray, pack: int) -> np.ndarray:
    """[T, E] slot or edge array -> k-major [T, 1, E] (lane k*rows + r holds
    slot r*pack + k), the layout of the reference's packed TPU kernels.
    The packed BAT kernel reads it per value block (`BatPlan.dst_km`). No
    slot kernel of the port reads one, so `SegmentPlan` carries none (the
    reference's slot plans carry `dst_km` / `mask_km` for `feature_hint`
    <= 64, and only slice them)."""
    T, E = arr.shape
    rows = E // pack
    return np.ascontiguousarray(arr.reshape(T, rows, pack).transpose(0, 2, 1).reshape(T, 1, E))


def plan_from_host(arrays: dict, meta: dict, device=None) -> SegmentPlan:
    dev = torch.device("cpu") if device is None else torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    plan = SegmentPlan(
        src_slots=t(arrays["src_slots"]),
        dst_slots=t(arrays["dst_slots"]),
        edge_pos=t(arrays["edge_pos"]),
        mask=t(arrays["mask"]),
        out_block=t(arrays["out_block"]),
        e0=t(arrays["e0"]) if "e0" in arrays else None,
        **meta,
    )
    if plan.e0 is None:
        return plan
    return dataclasses.replace(plan, row_sched=_slot_schedule(
        plan, arrays["dst_slots"], arrays["mask"], arrays["e0"], dev))


def _bat_tiles(dst: np.ndarray, num_segments: int, e_tile: int, s_tile: int):
    """(out_block, vblock) int32 of a BAT plan over dst-sorted edges: the
    (window, value block) pairs that hold edges, in order, with one
    coverage tile for each empty window (it inherits the running block,
    so vblock stays non-decreasing). The native runtime's, else numpy's:
    the same arrays."""
    nnz = len(dst)
    nat = native.build_bat_tiles(dst, num_segments, e_tile, s_tile) if nnz else None
    if nat is not None:
        return nat
    dst = np.asarray(dst, np.int64)
    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    n_vblocks = max(_cdiv(nnz, e_tile), 1)
    win = dst // s_tile
    blk = np.arange(nnz, dtype=np.int64) // e_tile
    key = win * n_vblocks + blk  # lexicographic (win, blk); non-decreasing
    # key is already sorted: O(n) run-compaction
    if nnz:
        head = np.empty(nnz, bool)
        head[0] = True
        np.not_equal(key[1:], key[:-1], out=head[1:])
        uniq = key[head]
    else:
        uniq = key
    ob = (uniq // n_vblocks).astype(np.int32)
    vb = (uniq % n_vblocks).astype(np.int32)
    missing = np.setdiff1d(np.arange(n_blocks, dtype=np.int32), ob, assume_unique=False)
    if len(missing):
        ob = np.concatenate([ob, missing])
        vb = np.concatenate([vb, np.zeros(len(missing), np.int32)])
        order = np.argsort(ob, kind="stable")
        ob, vb = ob[order], vb[order]
        vb = np.maximum.accumulate(vb).astype(np.int32)
    return ob, vb


def build_bat_plan_host(
    dst: np.ndarray,
    num_segments: int,
    *,
    e_tile: int = 512,
    s_tile: int = 256,
    km_pack: int = 0,
    max_chunk_tiles: int = MAX_PREFETCH_TILES,
):
    """Host arrays + meta for a BatPlan over a dst-sorted edge list. With
    km_pack > 1 dividing e_tile the arrays add `dst_km`, the k-major dst
    ids of every value block and of the sentinel block; another km_pack
    is dropped (meta km_pack 0), as in the reference."""
    dst = np.asarray(dst, np.int64)
    nnz = int(dst.shape[0])
    if nnz > 1 and not bool(np.all(dst[1:] >= dst[:-1])):
        raise ValueError("dst must be sorted ascending; use sort_edges_by_dst first")
    if nnz and int(dst[-1]) >= num_segments:
        raise ValueError(
            f"dst contains id {int(dst[-1])} >= num_segments={num_segments}"
        )
    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    n_vblocks = max(_cdiv(nnz, e_tile), 1)

    ob, vb = _bat_tiles(dst, num_segments, e_tile, s_tile)

    # one extra all--1 dst block at index n_vblocks: the sentinel target
    # for pad tiles — matches no window, adds nothing
    dst_pad = np.full((n_vblocks + 1) * e_tile, -1, np.int32)
    dst_pad[:nnz] = dst
    dst3 = dst_pad.reshape(n_vblocks + 1, 1, e_tile)

    arrays = dict(out_block=ob, vblock=vb, dst3=dst3)
    packed = km_pack > 1 and e_tile % km_pack == 0
    if packed:
        # per value block, like dst3: the sentinel block stays all -1
        arrays["dst_km"] = _k_major_host(
            dst_pad.reshape(n_vblocks + 1, e_tile), km_pack).astype(np.int32)
    meta = dict(
        e_tile=int(e_tile),
        s_tile=int(s_tile),
        num_segments=int(num_segments),
        n_blocks=int(n_blocks),
        num_edges=nnz,
        n_vblocks=int(n_vblocks),
        km_pack=int(km_pack) if packed else 0,
        chunks=compute_chunks(ob, max_chunk_tiles),
        chunk_blocks=0,
        chunk_vblocks=0,
    )
    _uniformize_bat_chunks(arrays, meta)
    return arrays, meta


def _uniformize_bat_chunks(arrays: dict, meta: dict) -> None:
    """Pad every chunk to identical (tiles, windows). Pad tiles cover the
    extra windows once each and read the sentinel value block (whose dst3
    and dst_km are all -1, so `dst_km` needs no change). (On the TPU
    this lets every chunk share one compiled kernel; the port keeps it so
    its plans equal the reference's.)"""
    chunks = meta["chunks"]
    if not chunks:
        return
    ob, vb = arrays["out_block"], arrays["vblock"]
    T_max = max(t1 - t0 for t0, t1, _, _ in chunks)
    W_max = max(w1 - w0 for _, _, w0, w1 in chunks)
    n_c = len(chunks)
    new_ob = np.zeros(n_c * T_max, ob.dtype)
    new_vb = np.zeros(n_c * T_max, vb.dtype)
    new_chunks = []
    for i, (t0, t1, w0, w1) in enumerate(chunks):
        nt = t1 - t0
        base = i * T_max
        new_ob[base : base + nt] = ob[t0:t1]
        new_vb[base : base + nt] = vb[t0:t1]
        pad_windows = list(range(w1, w0 + W_max))
        pad_ob = (pad_windows + [w0 + W_max - 1] * T_max)[: T_max - nt]
        new_ob[base + nt : base + T_max] = np.asarray(pad_ob, ob.dtype)
        # pad tiles read the sentinel (-1) dst block
        new_vb[base + nt : base + T_max] = meta["n_vblocks"]
        new_chunks.append((base, base + T_max, int(w0), int(w1)))
    arrays["out_block"], arrays["vblock"] = new_ob, new_vb
    meta["chunks"] = tuple(new_chunks)
    meta["chunk_blocks"] = int(W_max)
    vspan = 1
    for t0, t1, _, _ in chunks:
        real = vb[t0:t1][vb[t0:t1] < meta["n_vblocks"]]
        if len(real):
            vspan = max(vspan, int(real[-1]) - int(real[0]) + 1)
    meta["chunk_vblocks"] = int(vspan)


def _check_window_order(
    ob: np.ndarray, vb: np.ndarray, n_vblocks: int, chunks: tuple = ()
) -> None:
    """The reference's plan order, and what the kernels rely on. Within
    each chunk (the whole plan when unchunked) out_block must be
    non-decreasing and a window's real tiles must have increasing vblock
    (the pad tiles of uniformized chunks may point past the next chunk's
    first window, so the order is checked per chunk). sddmm_bat gives
    each edge the dot its one owner tile takes, and the edge-row schedule
    lists each edge once: no (vblock, out_block) pair may occur twice
    among the real tiles. Plans from `build_bat_plan_host` always pass."""
    for t0, t1 in [(c[0], c[1]) for c in chunks] or [(0, len(ob))]:
        o, v = ob[t0:t1], vb[t0:t1]
        if len(o) > 1 and not bool(np.all(o[1:] >= o[:-1])):
            raise ValueError("BatPlan out_block must be non-decreasing within a chunk")
        real = v < n_vblocks
        o, v = o[real], v[real]
        if len(o) > 1 and not bool(np.all((o[1:] != o[:-1]) | (v[1:] > v[:-1]))):
            raise ValueError("BatPlan: a window's real tiles must have increasing vblock")
    real = vb < n_vblocks
    key = ob[real].astype(np.int64) * (n_vblocks + 1) + vb[real]
    if len(np.unique(key)) != len(key):
        raise ValueError("BatPlan repeats a (vblock, out_block) tile")


def bat_plan_from_host(arrays: dict, meta: dict, device=None) -> BatPlan:
    dev = torch.device("cpu") if device is None else torch.device(device)
    ob, vb = arrays["out_block"], arrays["vblock"]
    _check_window_order(ob, vb, meta["n_vblocks"], meta["chunks"])
    bp = BatPlan(
        out_block=torch.from_numpy(np.ascontiguousarray(arrays["out_block"])).to(dev),
        vblock=torch.from_numpy(np.ascontiguousarray(arrays["vblock"])).to(dev),
        dst3=torch.from_numpy(np.ascontiguousarray(arrays["dst3"])).to(dev),
        dst_km=(torch.from_numpy(np.ascontiguousarray(arrays["dst_km"])).to(dev)
                if "dst_km" in arrays else None),
        **meta,
    )
    return dataclasses.replace(bp, row_sched=_bat_schedule(
        bp, ob, vb, arrays.get("dst_km", arrays["dst3"]), dev))


def _sched_key(plan) -> tuple:
    """The tensors a plan's RowSchedule is made from: a plan holding
    others (a chunk cut out of a plan, rebased ids) needs its own."""
    if isinstance(plan, SegmentPlan):
        return (plan.out_block, plan.dst_slots, plan.mask, plan.e0)
    return (plan.out_block, plan.vblock, plan.dst3 if plan.dst_km is None else plan.dst_km)


def _slot_schedule(plan: SegmentPlan, dst_slots, mask, e0, device, **knobs) -> RowSchedule:
    t0 = time.perf_counter()
    row, edge, slot = slot_plan_entries(dst_slots, mask, e0, plan.n_blocks * plan.s_tile)
    return build_row_schedule(row, edge, slot, plan.n_blocks * plan.s_tile, device,
                              _sched_key(plan), seconds=time.perf_counter() - t0, **knobs)


def _bat_schedule(bp: BatPlan, out_block, vblock, dst_ids, device,
                  **knobs) -> RowSchedule:
    """A BAT plan's schedule, its dst ids read from `dst3` (an unpacked
    plan) or from the k-major `dst_km` (a packed plan: edge r*P + k of a
    block at lane k*(E // P) + r), as the plain versions read them; the
    wide sum over a packed plan (GIN's 128-wide layer) takes the same
    schedule."""
    t0 = time.perf_counter()
    E = bp.e_tile
    nb = dst_ids.size // E
    dst_blocks = np.asarray(dst_ids).reshape(nb, E)
    if bp.dst_km is not None:
        P = bp.km_pack
        dst_blocks = dst_blocks.reshape(nb, P, E // P).transpose(0, 2, 1).reshape(nb, E)
    row, edge = bat_plan_entries(out_block, vblock, dst_blocks, bp.s_tile,
                                 bp.n_blocks * bp.s_tile)
    return build_row_schedule(row, edge, None, bp.n_blocks * bp.s_tile, device,
                              _sched_key(bp), seconds=time.perf_counter() - t0, **knobs)


def _new_schedule(plan, **knobs) -> RowSchedule:
    """A schedule of `plan` from its own tensors, read back to the host."""
    dev = plan.out_block.device
    if isinstance(plan, SegmentPlan):
        if plan.e0 is None:
            raise ValueError("the slot plan carries no e0")
        return _slot_schedule(plan, plan.dst_slots.cpu().numpy(), plan.mask.cpu().numpy(),
                              plan.e0.cpu().numpy(), dev, **knobs)
    ids = plan.dst3 if plan.dst_km is None else plan.dst_km
    return _bat_schedule(plan, plan.out_block.cpu().numpy(), plan.vblock.cpu().numpy(),
                         ids.cpu().numpy(), dev, **knobs)


def row_schedule_of(plan) -> RowSchedule:
    """The edge-row kernel's schedule of a slot plan (with e0), a BAT
    plan or a bucketed BAT plan: the one made with the plan, or, for a plan without one or
    whose tensors are not those it was made from (a chunk cut out of a
    plan), one made now from the plan's tensors and kept on the plan."""
    s = plan.row_sched
    if s is not None and s.matches(_sched_key(plan)) and s.n_out == plan.n_blocks * plan.s_tile:
        return s
    s = _new_schedule(plan)
    object.__setattr__(plan, "row_sched", s)  # a cache on the frozen plan
    return s


def with_row_schedule(plan, **knobs):
    """`plan` with its edge-row schedule made anew with other knobs
    (`build_row_schedule`'s slice_slots, fix_fanin, task_cost)."""
    return dataclasses.replace(plan, row_sched=_new_schedule(plan, **knobs))


def build_bat_plan(dst, num_segments: int, *, device=None, **kwargs) -> BatPlan:
    """A BatPlan on `device` (`resolve_device`: the card by default; see
    `build_bat_plan_host`)."""
    dev = resolve_device(device)
    arrays, meta = build_bat_plan_host(dst, num_segments, **kwargs)
    return bat_plan_from_host(arrays, meta, device=dev)


def with_chunks(bp: BatPlan, chunks: tuple) -> BatPlan:
    """`bp` with its chunk schedule replaced by ragged chunks over its own
    tiles (e.g. `compute_chunks` at a smaller cap, to force a split hub
    window), dropping the uniform-chunk sizes (`dst_km`, per value block,
    and the schedule, over the same tiles, come along as they are). Reads
    the plan back to the host once, to check the new chunks as
    `bat_plan_from_host` checks its own."""
    _check_window_order(bp.out_block.cpu().numpy(), bp.vblock.cpu().numpy(), bp.n_vblocks,
                        tuple(chunks))
    return dataclasses.replace(bp, chunks=tuple(chunks), chunk_blocks=0, chunk_vblocks=0)


def packed_width(n: int) -> int:
    """Smallest divisor of 128 that fits n (packed lane width), or 0 if n
    needs the full-width path."""
    for d in (8, 16, 32, 64):
        if n <= d:
            return d
    return 0


def build_segment_plan(
    dst: np.ndarray,
    src: Optional[np.ndarray] = None,
    num_segments: int = 0,
    *,
    device=None,
    **kwargs,
) -> SegmentPlan:
    """A SegmentPlan over dst-sorted edges on `device` (`resolve_device`:
    the card by default; see `build_segment_plan_host`). The reference's
    `feature_hint` only adds the k-major copies, which the port does not
    carry (`_k_major_host`)."""
    dev = resolve_device(device)
    arrays, meta = build_segment_plan_host(dst, src, num_segments, **kwargs)
    return plan_from_host(arrays, meta, device=dev)


@dataclasses.dataclass(frozen=True)
class BucketedBatPlan:
    """BAT tiles over a (source bucket, dst)-sorted edge list whose buckets
    are each padded to whole value blocks (torch tensors on one device).
    Static weights are baked in, in that order.

    out_block: [T] int32 — output window of tile t, non-decreasing within
      each bucket's tiles (and each chunk).
    vblock:    [T] int32 — padded value block of tile t (n_vblocks: the
      all -1 sentinel block that the chunks' pad tiles read).
    dst3:      [n_vblocks + 1, 1, e_tile] int32 — dst ids, -1 padded.
    src_local: [(n_vblocks + 1) * e_tile] int32 — each padded entry's
      source id within its bucket (0 on pads).
    src:       [(n_vblocks + 1) * e_tile] int32 — the global source id,
      src_local + bucket * bucket_rows (port only: what the edge-row
      kernel reads x by).
    w_pad:     [(n_vblocks + 1) * e_tile] float32 or None — the weights
      (0 on pads).
    chunks:    ((t0, t1, w0, w1, row_off), ...) uniform tile ranges, each
      inside one bucket (row_off = bucket * bucket_rows, its first x row),
      spanning `chunk_blocks` windows; the reference runs them in order and
      adds their partials, the port sums the plan whole.
    row_sched: the edge-row kernel's schedule of the plan's live entries
      (payload the padded entry id), each row's in bucket order.
    """

    out_block: torch.Tensor
    vblock: torch.Tensor
    dst3: torch.Tensor
    src_local: torch.Tensor
    src: torch.Tensor
    w_pad: Optional[torch.Tensor]
    e_tile: int
    s_tile: int
    num_segments: int
    n_blocks: int
    num_edges: int
    n_vblocks: int
    bucket_rows: int
    chunks: tuple = ()
    chunk_blocks: int = 0
    row_sched: Optional[RowSchedule] = dataclasses.field(default=None, compare=False,
                                                         repr=False)

    @property
    def num_tiles(self) -> int:
        return int(self.out_block.shape[0])

    @property
    def padded_segments(self) -> int:
        return self.n_blocks * self.s_tile

    @property
    def dst_km(self) -> None:
        """Never packed: the schedule reads dst3, as an unpacked BatPlan's."""
        return None


def build_bucketed_bat_plan_host(
    gather_idx: np.ndarray,
    reduce_idx: np.ndarray,
    num_segments: int,
    num_gather_rows: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    e_tile: int = 1024,
    s_tile: int = 256,
    bucket_rows: int = 128 * 1024,
    max_chunk_tiles: int = 2048,
):
    """Host arrays + meta of a BucketedBatPlan. `reduce_idx` must be
    sorted ascending (a dst-sorted edge list); the edges are re-sorted
    stably by the bucket of `gather_idx` (so (bucket, reduce) order) and
    `edge_weight` is baked in that order. Each bucket's tiles are the BAT
    compaction of its edges, with coverage tiles for the empty windows
    inside its own window span; every chunk is padded to the same tiles
    and windows (pad tiles read the sentinel block)."""
    gi = np.asarray(gather_idx, np.int64)
    ri = np.asarray(reduce_idx, np.int64)
    nnz = len(gi)
    if nnz and int(ri.max()) >= num_segments:
        raise ValueError("reduce_idx out of range")
    bn = int(bucket_rows)
    n_buckets = max(_cdiv(max(num_gather_rows, 1), bn), 1)
    bucket = (gi // bn).astype(np.int32)
    perm = native.sort_by_key(bucket, n_buckets)
    if perm is None:
        perm = np.argsort(bucket, kind="stable")
    gi, ri, bucket = gi[perm], ri[perm], bucket[perm]
    w = None if edge_weight is None else np.asarray(edge_weight, np.float32)[perm]

    counts = np.bincount(bucket, minlength=n_buckets).astype(np.int64)
    pad_counts = _cdiv(np.maximum(counts, 0), e_tile) * e_tile
    pstart = np.zeros(n_buckets + 1, np.int64)
    np.cumsum(pad_counts, out=pstart[1:])
    estart = np.zeros(n_buckets + 1, np.int64)
    np.cumsum(counts, out=estart[1:])
    n_pad_rows = int(pstart[-1])
    n_vblocks = max(n_pad_rows // e_tile, 1)

    dst_pad = np.full(n_pad_rows + e_tile, -1, np.int32)  # + the sentinel block
    src_pad = np.zeros(n_pad_rows + e_tile, np.int32)
    src_glob = np.zeros(n_pad_rows + e_tile, np.int32)
    w_pad = None if w is None else np.zeros(n_pad_rows + e_tile, np.float32)
    obs, vbs, chunks = [], [], []
    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    for k in range(n_buckets):
        e0, e1 = int(estart[k]), int(estart[k + 1])
        if e0 == e1:
            continue
        p0 = int(pstart[k])
        dst_pad[p0 : p0 + (e1 - e0)] = ri[e0:e1]
        src_pad[p0 : p0 + (e1 - e0)] = (gi[e0:e1] - k * bn).astype(np.int32)
        src_glob[p0 : int(pstart[k + 1])] = k * bn
        src_glob[p0 : p0 + (e1 - e0)] = gi[e0:e1]
        if w_pad is not None:
            w_pad[p0 : p0 + (e1 - e0)] = w[e0:e1]
        # the bucket's tiles: build_bat_plan_host's compaction
        ob_k, vb_k = _bat_tiles(ri[e0:e1], num_segments, e_tile, s_tile)
        # coverage tiles outside the bucket's own window span go; the gaps
        # inside it stay
        w_lo = int(ri[e0]) // s_tile
        w_hi = int(ri[e1 - 1]) // s_tile
        keep = (ob_k >= w_lo) & (ob_k <= w_hi)
        ob_k, vb_k = ob_k[keep], vb_k[keep]
        vb_k = vb_k + p0 // e_tile
        base_t = sum(len(o) for o in obs)
        for t0, t1, w0, w1 in (compute_chunks(ob_k, max_chunk_tiles)
                               or ((0, len(ob_k), int(ob_k[0]), int(ob_k[-1]) + 1),)):
            chunks.append((base_t + t0, base_t + t1, w0, w1, k * bn))
        obs.append(ob_k)
        vbs.append(vb_k)

    ob = np.concatenate(obs) if obs else np.zeros(1, np.int32)
    vb = np.concatenate(vbs) if vbs else np.zeros(1, np.int32)
    if not obs:
        chunks = [(0, 1, 0, 1, 0)]
    T_max = max(t1 - t0 for t0, t1, _, _, _ in chunks)
    W_max = max(w1 - w0 for _, _, w0, w1, _ in chunks)
    n_c = len(chunks)
    new_ob = np.zeros(n_c * T_max, np.int32)
    new_vb = np.full(n_c * T_max, n_vblocks, np.int32)
    new_chunks = []
    for i, (t0, t1, w0, w1, roff) in enumerate(chunks):
        nt = t1 - t0
        base = i * T_max
        new_ob[base : base + nt] = ob[t0:t1]
        new_vb[base : base + nt] = vb[t0:t1]
        pad_windows = list(range(w1, w0 + W_max))
        pad_ob = (pad_windows + [w0 + W_max - 1] * T_max)[: T_max - nt]
        new_ob[base + nt : base + T_max] = np.asarray(pad_ob, np.int32)
        new_chunks.append((base, base + T_max, int(w0), int(w1), int(roff)))

    arrays = dict(out_block=new_ob, vblock=new_vb, dst3=dst_pad.reshape(-1, 1, e_tile),
                  src_local=src_pad, src=src_glob)
    if w_pad is not None:
        arrays["w_pad"] = w_pad
    meta = dict(e_tile=int(e_tile), s_tile=int(s_tile), num_segments=int(num_segments),
                n_blocks=int(n_blocks), num_edges=int(nnz), n_vblocks=int(n_vblocks),
                bucket_rows=bn, chunks=tuple(new_chunks), chunk_blocks=int(W_max))
    return arrays, meta


def bucketed_plan_from_host(arrays: dict, meta: dict, device=None) -> BucketedBatPlan:
    """The plan on `device`, with its edge-row schedule (made from the host
    arrays: the -1 pads, the sentinel block and the pad windows past
    n_blocks add no entry)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    ob, vb = arrays["out_block"], arrays["vblock"]
    _check_window_order(ob, vb, meta["n_vblocks"], meta["chunks"])

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bp = BucketedBatPlan(out_block=t(ob), vblock=t(vb), dst3=t(arrays["dst3"]),
                         src_local=t(arrays["src_local"]), src=t(arrays["src"]),
                         w_pad=t(arrays.get("w_pad")), **meta)
    return dataclasses.replace(bp, row_sched=_bat_schedule(bp, ob, vb, arrays["dst3"], dev))


def build_bucketed_bat_plan(gather_idx, reduce_idx, num_segments: int, num_gather_rows: int,
                            *, device=None, **kwargs) -> BucketedBatPlan:
    """A BucketedBatPlan on `device` (`resolve_device`: the card by
    default; see `build_bucketed_bat_plan_host`)."""
    dev = resolve_device(device)
    arrays, meta = build_bucketed_bat_plan_host(gather_idx, reduce_idx, num_segments,
                                                num_gather_rows, **kwargs)
    return bucketed_plan_from_host(arrays, meta, device=dev)
