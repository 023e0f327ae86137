"""Graph partitioning for execution over several processes, host side.

Port of `geot_tpu/parallel/partition.py` (`_stack_plans` :39,
`_pad_plan_tiles` :57, `PartitionedGraph` :98, `_balanced_bounds` :157,
`partition_graph` :171-460). Given the same edges and knobs, every array
equals the JAX package's: the part bounds, `part_start`, `nodes_per_part`,
`halo`, `send_idx` / `send_mask`, each layout's stacked plans and weights
(as CPU tensors with a leading part axis), and the BAT and stream families.

A dst-sorted edge list is cut into P parts, each owning a contiguous range
of destination rows with about the same number of edges:
  * part p owns global rows [part_start[p], part_start[p+1]), stored in a
    padded block of `nodes_per_part` local rows; its edges are a slice of
    the dst-sorted list, and its output rows need no combining;
  * edges whose source the part owns are INTERIOR (they read the local
    block); the others are BOUNDARY edges, which read a receive buffer of
    P*H rows: row q*H + i holds the i-th row part q sends here;
  * `send_idx[p, q, i]` is the local row part p sends to part q in slot i
    (`nodes_per_part` marks an empty slot), and the diagonal is empty.

The reference stacks the parts' plans because one `shard_map` program runs
on every chip. The port runs one process per part: `PartitionedGraph.part`
gives one part's unbatched plans, schedules and halo indices on a device,
moved once, for `halo_spmm`.

TPU picks, kept at the reference's values so that partitions match (none
was measured on the H100): `nodes_per_part` and `halo` rounded up to 8
(the TPU's sublanes); `layout="auto"` chooses BAT past MAX_PREFETCH_TILES
slot tiles of 4096 edges (the TPU's scalar-prefetch budget) or past a 1 GiB
gather of a part's source rows (its HBM transient); the slot layout
doubles `e_tile` until a part's tiles fit that budget; the BAT families'
`max_chunk_tiles` comes from the same 1 GiB budget; and the hybrid
layout's stream tiles are min(bat_e_tile, 512) (the TPU's tile-cost
model). On the card a plan is summed whole, in one launch, whatever its
chunks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from geot_tpu_torch.graph.plan import (
    MAX_PREFETCH_TILES,
    SegmentPlan,
    build_segment_plan_host,
    plan_from_host,
)
from geot_tpu_torch.utils.device import resolve_device

__all__ = ["PartitionedGraph", "PartView", "SlotPart", "partition_graph"]

# the reference's gather budget for one part (a TPU HBM transient; see the
# module docstring)
GATHER_BUDGET_BYTES = 1 << 30
# a part's slot tiles are counted at this many edges for `layout="auto"`
# (the reference's; a TPU pick)
AUTO_TILE_EDGES = 4096
# the slot layout stops doubling e_tile here (the reference's)
MAX_SLOT_E_TILE = 4096
# nodes_per_part and halo are rounded up to this (the TPU's sublanes)
ROW_ALIGN = 8
# the hybrid layout's stream tile cap (the TPU's tile-cost model)
STREAM_E_TILE_CAP = 512

_PLAN_ARRAYS = ("src_slots", "dst_slots", "edge_pos", "mask", "out_block", "e0")


def _cdiv(a, b):
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _stack_plans(parts: list, num_segments: int, n_blocks: int, num_src: int) -> SegmentPlan:
    """One SegmentPlan whose array fields carry a leading part axis, over
    per-part host plans already padded to equal tile counts (CPU
    tensors). `e0` is the port's (the edge-row kernel reads slot j of tile
    t as edge e0[t] + j); the reference stacks the other five arrays."""
    meta = parts[0][1]
    stacked = {k: torch.from_numpy(np.stack([a[k] for a, _ in parts])) for k in _PLAN_ARRAYS}
    return SegmentPlan(
        **stacked,
        e_tile=meta["e_tile"],
        s_tile=meta["s_tile"],
        num_segments=num_segments,
        n_blocks=n_blocks,
        num_edges=max(m["num_edges"] for _, m in parts),
        num_src_nodes=num_src,
        pack_align=meta["pack_align"],
    )


def _pad_plan_tiles(arrays: dict, meta: dict, num_tiles: int, n_blocks: int) -> dict:
    """Append all-padding tiles (targeting new empty windows first, then the
    last window) so every part reaches the same tile and window count. Pad
    tiles have mask 0 (they add nothing and the row schedule leaves them
    out) and e0 0."""
    t0 = len(arrays["out_block"])
    extra = num_tiles - t0
    if extra == 0 and meta["n_blocks"] == n_blocks:
        return arrays
    new_blocks = list(range(meta["n_blocks"], n_blocks))
    while len(new_blocks) < extra:
        new_blocks.append(n_blocks - 1 if n_blocks else 0)
    new_blocks = new_blocks[:extra]
    if len(new_blocks) != extra or sorted(new_blocks) != new_blocks:
        raise ValueError("pad tiles must cover the new windows in order")
    e_tile = meta["e_tile"]
    nb = np.asarray(new_blocks, np.int32)
    z = np.zeros((extra, e_tile), np.int32)
    return dict(
        src_slots=np.concatenate([arrays["src_slots"], z]),
        dst_slots=np.concatenate([arrays["dst_slots"],
                                  (nb[:, None] * meta["s_tile"]) * np.ones((1, e_tile), np.int32)]),
        edge_pos=np.concatenate([arrays["edge_pos"], z]),
        mask=np.concatenate([arrays["mask"], np.zeros((extra, e_tile), np.float32)]),
        out_block=np.concatenate([arrays["out_block"], nb]),
        e0=np.concatenate([arrays["e0"], np.zeros(extra, np.int32)]),
    )


def _weights_for(arrays: dict, ww: Optional[np.ndarray]) -> np.ndarray:
    """Slot weights of a plan: the edge weights at each slot's edge_pos
    times the mask, or the mask where there are none."""
    mask = arrays["mask"]
    if ww is None or len(ww) == 0:
        return mask
    ep = arrays["edge_pos"].reshape(-1)
    return ww[np.minimum(ep, len(ww) - 1)].reshape(mask.shape) * mask


def _stack_rows(rows: List[np.ndarray], dtype) -> torch.Tensor:
    """[P, max(len)] tensor of ragged per-part rows, 0 padded."""
    width = max([len(r) for r in rows] + [1])
    out = np.zeros((len(rows), width), dtype)
    for p, r in enumerate(rows):
        out[p, : len(r)] = r
    return torch.from_numpy(out)


@dataclasses.dataclass(frozen=True)
class SlotPart:
    """One part's slot-layout plan on a device: the segment sum of
    w * x[src[e]] by the plan's rows (`part_slot_reduce`).

    plan:   SegmentPlan with its edge-row schedule (`plan.row_sched`).
    src:    [>= nnz] int32 — the plan's edge-order source rows: slot j of
            tile t reads x[src[e0[t] + j]] (receive-buffer positions for a
            boundary plan, local rows for an interior one, the transposed
            plan's `d_loc[tperm]` for a transpose plan).
    w:      [T, e_tile] float32 slot weights (0 on pads).
    """

    plan: SegmentPlan
    src: torch.Tensor
    w: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PartView:
    """One part's local view of a `PartitionedGraph`, on one device.

    boundary / interior:     the forward reduces (SlotPart or
                             `bat_partition.PartBat`) over the receive
                             buffer [P*H, F] and the local block [npp, F].
    boundary_t / interior_t: the transposed reduces (the backward): the
                             boundary one into receive positions [P*H, F],
                             the interior one into local rows.
    stream / stream_t:       the hybrid layout's streamed interior cells
                             (`StreamPlan` of the part's live tiles, or
                             None), added into the interior BAT sum.
    send_gather: [P*H] int64 — the local row each send slot reads
                 (empty slots read row npp - 1 and are masked).
    send_mask:   [P*H, 1] float32 — 1 on real send slots.
    send_back:   ((rows, pos), ...) int64 — for each peer with real slots,
                 in peer order, the local rows it was sent and their
                 positions in the returned buffer: the backward adds the
                 peers' gradients peer by peer (each peer's rows unique).
    """

    rank: int
    num_parts: int
    nodes_per_part: int
    halo: int
    boundary: object
    interior: object
    boundary_t: object
    interior_t: object
    stream: Optional[object]
    stream_t: Optional[object]
    send_gather: torch.Tensor
    send_mask: torch.Tensor
    send_back: tuple

    @property
    def device(self) -> torch.device:
        return self.send_gather.device


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-part plans and halo schedule, array fields stacked over parts
    (CPU tensors, equal to the reference's arrays).

    plan:       boundary forward SegmentPlan; src_slots hold receive-buffer
                positions (q*H + i), dst_slots part-local rows.
    plan_t:     its transpose, grouped by receive-buffer position.
    plan_int:   interior forward plan; src_slots hold part-local rows.
    plan_int_t: the interior transpose plan (grouped by local source row).
    send_idx:   [P, P, H] int32 — local row sent to peer q in slot i
                (nodes_per_part = an empty slot); the diagonal is empty.
    send_mask:  [P, P, H] float32 — 1 where the slot is a real row.
    w_slots / w_slots_t / w_int / w_int_t: [P, T, e_tile] slot weights.
    src / src_t / src_int / src_int_t: [P, nnz_max] int32 — each slot
                plan's edge-order source rows per part (the port's: its
                kernel reads x[src[e]] itself), 0 padded.
    bat / bat_t / bat_int / bat_int_t: `PartBatFamily`s (layouts "bat"
                and "hybrid"; the slot fields are then None).
    stream_int / stream_int_t: `PartStreamFamily`s of the streamed
                interior cells (layout "hybrid"), or None.
    """

    plan: Optional[SegmentPlan]
    plan_t: Optional[SegmentPlan]
    plan_int: Optional[SegmentPlan]
    plan_int_t: Optional[SegmentPlan]
    send_idx: torch.Tensor
    send_mask: torch.Tensor
    w_slots: Optional[torch.Tensor]
    w_slots_t: Optional[torch.Tensor]
    w_int: Optional[torch.Tensor]
    w_int_t: Optional[torch.Tensor]
    num_parts: int
    nodes_per_part: int
    halo: int
    part_start: tuple = ()
    num_nodes: int = 0
    bat: Optional[object] = None
    bat_t: Optional[object] = None
    bat_int: Optional[object] = None
    bat_int_t: Optional[object] = None
    stream_int: Optional[object] = None
    stream_int_t: Optional[object] = None
    src: Optional[torch.Tensor] = None
    src_t: Optional[torch.Tensor] = None
    src_int: Optional[torch.Tensor] = None
    src_int_t: Optional[torch.Tensor] = None

    @property
    def padded_nodes(self) -> int:
        return self.num_parts * self.nodes_per_part

    @property
    def layout(self) -> str:
        if self.bat is None:
            return "slot"
        return "bat" if self.stream_int is None and self.stream_int_t is None else "hybrid"

    def part(self, rank: int, device=None) -> PartView:
        """Part `rank`'s local view on `device` (`resolve_device`: the card
        by default, the CPU only when asked for): its unbatched plans with
        their edge-row schedules (built here, once), its BAT and stream
        families, and its row of the halo schedule, each moved once. Keep
        the view for every call of `halo_spmm`."""
        P, H, npp = self.num_parts, self.halo, self.nodes_per_part
        if not 0 <= rank < P:
            raise ValueError(f"rank {rank} outside [0, {P})")
        dev = resolve_device(device)
        if self.bat is None:
            fams = [self._slot_part(p, s, w, rank, dev) for p, s, w in (
                (self.plan, self.src, self.w_slots), (self.plan_int, self.src_int, self.w_int),
                (self.plan_t, self.src_t, self.w_slots_t),
                (self.plan_int_t, self.src_int_t, self.w_int_t))]
            streams = (None, None)
        else:
            from geot_tpu_torch.parallel.stream_partition import part_stream_plan

            fams = [f.unbatch(rank, dev) for f in (self.bat, self.bat_int, self.bat_t,
                                                     self.bat_int_t)]
            streams = tuple(None if f is None else part_stream_plan(f, rank, dev)
                            for f in (self.stream_int, self.stream_int_t))
        idx = self.send_idx[rank].reshape(-1).long()
        back = []
        for q in range(P):
            real = torch.nonzero(self.send_idx[rank, q] < npp).reshape(-1)
            if len(real):
                back.append((self.send_idx[rank, q, real].long().to(dev), (q * H + real).to(dev)))
        return PartView(
            rank=rank, num_parts=P, nodes_per_part=npp, halo=H,
            boundary=fams[0], interior=fams[1], boundary_t=fams[2], interior_t=fams[3],
            stream=streams[0], stream_t=streams[1],
            send_gather=idx.clamp(max=npp - 1).to(dev),
            send_mask=self.send_mask[rank].reshape(-1, 1).to(dev),
            send_back=tuple(back),
        )

    @staticmethod
    def _slot_part(stacked: SegmentPlan, src: torch.Tensor, w: torch.Tensor, rank: int,
                   dev: torch.device) -> SlotPart:
        arrays = {k: getattr(stacked, k)[rank].numpy() for k in _PLAN_ARRAYS}
        meta = dict(e_tile=stacked.e_tile, s_tile=stacked.s_tile,
                    num_segments=stacked.num_segments, n_blocks=stacked.n_blocks,
                    num_edges=int((arrays["mask"] != 0).sum()),
                    num_src_nodes=stacked.num_src_nodes, pack_align=stacked.pack_align)
        return SlotPart(plan=plan_from_host(arrays, meta, device=dev), src=src[rank].to(dev),
                        w=w[rank].to(dev))


def _balanced_bounds(dst_sorted: np.ndarray, num_nodes: int, P: int) -> np.ndarray:
    """Contiguous node-range boundaries with about equal edges per part
    (equal node counts put most edges on one part for power-law graphs)."""
    nnz = len(dst_sorted)
    bounds = np.zeros(P + 1, np.int64)
    bounds[P] = num_nodes
    for p in range(1, P):
        pos = (p * nnz) // P
        b = int(dst_sorted[min(pos, nnz - 1)]) if nnz else (p * num_nodes) // P
        bounds[p] = min(max(b, bounds[p - 1] + 1), num_nodes - (P - p))
    return bounds


def _build_family(dst_parts, src_parts, w_parts, num_seg, num_src, e_tile, s_tile):
    """Per-part (forward, transpose) slot plans, their slot weights and
    edge-order sources for one edge family, padded to equal shapes across
    parts: (plan, plan_t, w, w_t, src, src_t)."""
    fwd, bwd, w_f, w_b, src_f, src_b = [], [], [], [], [], []
    for d_loc, s_loc, w_p in zip(dst_parts, src_parts, w_parts):
        f = build_segment_plan_host(d_loc, s_loc, num_seg, e_tile=e_tile, s_tile=s_tile,
                                    num_src_nodes=num_src)
        tperm = np.argsort(s_loc, kind="stable")
        b = build_segment_plan_host(s_loc[tperm], d_loc[tperm], num_src, e_tile=e_tile,
                                    s_tile=s_tile, num_src_nodes=num_seg)
        fwd.append(f)
        bwd.append(b)
        w_f.append(_weights_for(f[0], w_p))
        w_b.append(_weights_for(b[0], None if w_p is None else w_p[tperm]))
        src_f.append(s_loc)
        src_b.append(d_loc[tperm])
    T_f = max(len(a["out_block"]) for a, _ in fwd)
    T_b = max(len(a["out_block"]) for a, _ in bwd)
    nb_f = max(m["n_blocks"] for _, m in fwd)
    nb_b = max(m["n_blocks"] for _, m in bwd)
    fwd = [(_pad_plan_tiles(a, m, T_f, nb_f), m) for a, m in fwd]
    bwd = [(_pad_plan_tiles(a, m, T_b, nb_b), m) for a, m in bwd]
    w_f = [np.pad(ws, ((0, T_f - ws.shape[0]), (0, 0))) for ws in w_f]
    w_b = [np.pad(ws, ((0, T_b - ws.shape[0]), (0, 0))) for ws in w_b]
    return (
        _stack_plans(fwd, num_seg, nb_f, num_src),
        _stack_plans(bwd, num_src, nb_b, num_seg),
        torch.from_numpy(np.stack(w_f).astype(np.float32)),
        torch.from_numpy(np.stack(w_b).astype(np.float32)),
        _stack_rows(src_f, np.int32),
        _stack_rows(src_b, np.int32),
    )


def _sorted_by(key_parts, *arr_parts):
    """Each part's key and arrays stably sorted by the key."""
    perms = [np.argsort(k, kind="stable") for k in key_parts]
    outs = [[k[q] for k, q in zip(key_parts, perms)]]
    for arrs in arr_parts:
        outs.append([None if a is None else a[q] for a, q in zip(arrs, perms)])
    return outs


def _rest_of(parts: tuple, masks) -> tuple:
    """Each part's arrays cut to the edges its mask keeps."""
    return tuple([None if a is None else a[m] for a, m in zip(arrs, masks)] for arrs in parts)


def partition_graph(
    src,
    dst,
    num_nodes: int,
    num_parts: int,
    *,
    edge_weight=None,
    e_tile: int = 256,
    s_tile: int = 256,
    layout: str = "auto",
    feature_hint: int = 128,
    bat_e_tile: int = 1024,
    max_chunk_tiles: int = 0,
) -> PartitionedGraph:
    """Host-side partitioning of a COO edge list (any order) into
    `num_parts` dst-contiguous, edge-balanced parts with a halo exchange
    schedule. Part p owns global nodes [part_start[p], part_start[p+1]),
    stored in a padded block of `nodes_per_part` local rows
    (`halo_spmm.block_nodes` / `unblock_nodes` give the layout).

    Weights, if given, are baked into the plans: pass the final
    aggregation weights (the GCN norm computed on the whole graph first).
    `layout`: "slot", "bat", "hybrid" or "auto" (see the module docstring)."""
    if layout not in ("auto", "slot", "bat", "hybrid"):
        raise ValueError(f"layout={layout!r}: one of auto, slot, bat, hybrid")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = None if edge_weight is None else np.asarray(edge_weight, np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if w is not None:
        w = w[order]

    P = int(num_parts)
    if P < 1:
        raise ValueError(f"num_parts={num_parts}: at least 1")
    starts = _balanced_bounds(dst, num_nodes, P)
    npp = _round_up(int(max(np.diff(starts).max(), 1)), ROW_ALIGN)
    bounds = np.searchsorted(dst, starts)
    owner_of = np.searchsorted(starts, np.arange(num_nodes), side="right") - 1

    # the halo schedule: the unique remote sources each part needs from
    # each owner; interior edges (source owned locally) never ride it
    send_lists = [[np.zeros(0, np.int64)] * P for _ in range(P)]  # [owner][dest part]
    recv_pos_parts, bnd_dst_parts, w_bnd_parts = [], [], []
    int_src_parts, int_dst_parts, w_int_parts = [], [], []
    for p in range(P):
        lo, hi = bounds[p], bounds[p + 1]
        s_p, d_p = src[lo:hi], dst[lo:hi]
        w_p = None if w is None else w[lo:hi]
        is_int = owner_of[s_p] == p if len(s_p) else np.zeros(0, bool)
        int_src_parts.append(s_p[is_int] - starts[p])
        int_dst_parts.append(d_p[is_int] - starts[p])
        w_int_parts.append(None if w_p is None else w_p[is_int])
        s_b, d_b = s_p[~is_int], d_p[~is_int]
        uniq, inv = np.unique(s_b, return_inverse=True)
        uo = owner_of[uniq]
        slot_of_uniq = np.empty(len(uniq), np.int64)
        for q in range(P):
            sel = np.where(uo == q)[0]
            slot_of_uniq[sel] = np.arange(len(sel))
            send_lists[q][p] = (uniq[sel] - starts[q]).astype(np.int64)
        recv_pos_parts.append((uo[inv], slot_of_uniq[inv]))
        bnd_dst_parts.append(d_b - starts[p])
        w_bnd_parts.append(None if w_p is None else w_p[~is_int])

    H = max((len(send_lists[q][p]) for q in range(P) for p in range(P)), default=1)
    H = _round_up(max(H, 1), ROW_ALIGN)
    send_idx = np.full((P, P, H), npp, dtype=np.int32)
    send_mask = np.zeros((P, P, H), dtype=np.float32)
    for q in range(P):
        for p in range(P):
            lst = send_lists[q][p]
            send_idx[q, p, : len(lst)] = lst
            send_mask[q, p, : len(lst)] = 1.0

    max_edges = max((int(len(d)) for d in bnd_dst_parts + int_dst_parts), default=0)
    if layout == "auto":
        gather_bytes = max_edges * max(feature_hint, 1) * 4
        layout = ("bat" if _cdiv(max(max_edges, 1), AUTO_TILE_EDGES) > MAX_PREFETCH_TILES
                  or gather_bytes > GATHER_BUDGET_BYTES else "slot")
    if layout == "slot":
        while _cdiv(max(max_edges, 1), e_tile) > MAX_PREFETCH_TILES:
            if e_tile >= MAX_SLOT_E_TILE:
                raise ValueError(
                    f"part with {max_edges} edges exceeds {MAX_PREFETCH_TILES} slot tiles "
                    f"even at e_tile={e_tile}; use layout='bat' or more parts")
            e_tile *= 2

    halo_total = P * H
    recv_pos_arrs = [(uo * H + slot).astype(np.int64) for uo, slot in recv_pos_parts]
    common = dict(
        send_idx=torch.from_numpy(send_idx),
        send_mask=torch.from_numpy(send_mask),
        num_parts=P,
        nodes_per_part=int(npp),
        halo=int(H),
        part_start=tuple(int(b) for b in starts),
        num_nodes=int(num_nodes),
    )
    if layout in ("bat", "hybrid"):
        from geot_tpu_torch.parallel.bat_partition import build_part_bat_family

        mct = max_chunk_tiles or max(1, min(
            MAX_PREFETCH_TILES,
            GATHER_BUDGET_BYTES // (max(feature_hint, 1) * 4 * bat_e_tile)))
        kw = dict(e_tile=bat_e_tile, s_tile=s_tile, max_chunk_tiles=mct)
        bat = build_part_bat_family(bnd_dst_parts, recv_pos_arrs, w_bnd_parts, npp, **kw)
        pos_s, dst_s, w_s = _sorted_by(recv_pos_arrs, bnd_dst_parts, w_bnd_parts)
        bat_t = build_part_bat_family(pos_s, dst_s, w_s, halo_total, **kw)

        # hybrid: the interior dense cells stream from the local block; the
        # interior residue and every boundary edge stay on the BAT
        # families. Forward and backward split independently.
        stream_i = stream_i_t = None
        int_rest = (int_dst_parts, int_src_parts, w_int_parts)
        int_rest_t = tuple(_sorted_by(int_src_parts, int_dst_parts, w_int_parts))
        if layout == "hybrid":
            from geot_tpu_torch.parallel.stream_partition import build_part_stream_family

            # one forced tile size per family; the caller asked for hybrid,
            # so the census's scale margin is waived (margin 1.0)
            skw = dict(e_tile=min(bat_e_tile, STREAM_E_TILE_CAP), s_tile=s_tile,
                       feature_hint=feature_hint, margin=1.0)
            stream_i, masks, _ = build_part_stream_family(
                int_dst_parts, int_src_parts, w_int_parts, npp, npp, **skw)
            if stream_i is not None:
                int_rest = _rest_of(int_rest, masks)
            stream_i_t, masks_t, _ = build_part_stream_family(*int_rest_t, npp, npp, **skw)
            if stream_i_t is not None:
                int_rest_t = _rest_of(int_rest_t, masks_t)
        return PartitionedGraph(
            plan=None, plan_t=None, plan_int=None, plan_int_t=None,
            w_slots=None, w_slots_t=None, w_int=None, w_int_t=None,
            bat=bat, bat_t=bat_t,
            bat_int=build_part_bat_family(*int_rest, npp, **kw),
            bat_int_t=build_part_bat_family(*int_rest_t, npp, **kw),
            stream_int=stream_i, stream_int_t=stream_i_t,
            **common,
        )

    plan_b, plan_b_t, w_bnd, w_bnd_t, src_b, src_b_t = _build_family(
        bnd_dst_parts, recv_pos_arrs, w_bnd_parts, npp, halo_total, e_tile, s_tile)
    plan_i, plan_i_t, w_int, w_int_t, src_i, src_i_t = _build_family(
        int_dst_parts, int_src_parts, w_int_parts, npp, npp, e_tile, s_tile)
    return PartitionedGraph(
        plan=plan_b, plan_t=plan_b_t, plan_int=plan_i, plan_int_t=plan_i_t,
        w_slots=w_bnd, w_slots_t=w_bnd_t, w_int=w_int, w_int_t=w_int_t,
        src=src_b, src_t=src_b_t, src_int=src_i, src_int_t=src_i_t,
        **common,
    )
