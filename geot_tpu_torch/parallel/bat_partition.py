"""Per-part BAT plans with an equalized chunk grid, and their reduce.

Port of `geot_tpu/parallel/bat_partition.py` (`PartBatFamily` :49,
`build_part_bat_family` :93, `part_bat_reduce` :188). Given the same
edges and knobs, the stacked arrays equal the JAX package's.

The reference runs one `shard_map` program on every part, so it equalizes
the chunk grid across parts, (C, T_c, W_c, n_vblocks) padded to the
per-part maxima, ships each part's chunk windows as data and scans the
chunks, gathering one chunk's edges at a time. Pad tiles read the shared
all--1 sentinel value block `n_vblocks` (they add nothing); the all-pad
chunks of a part with fewer chunks point at window `n_blocks`, past the
plan.

The port runs one process per part and sums a part's plan whole, in one
launch of the edge-row kernel (`bat_segment_sum`, reading x[src[e]]
itself): `PartBatFamily.unbatch` turns one part's slice into a `BatPlan`
with its row schedule, whose chunks are the equalized ones, (i*T_c,
(i+1)*T_c, chunk_w0[i], chunk_w1[i]). The schedule lists only live edges:
the sentinel block's and the pad tiles' -1 ids add nothing, and no row at
or past `n_blocks * s_tile` is written.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from geot_tpu_torch.graph.plan import (
    MAX_PREFETCH_TILES,
    BatPlan,
    bat_plan_from_host,
    build_bat_plan_host,
)
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain
from geot_tpu_torch.utils.device import resolve_device

__all__ = ["PartBatFamily", "PartBat", "build_part_bat_family", "part_bat_reduce"]


@dataclasses.dataclass(frozen=True)
class PartBat:
    """One part's BAT plan on a device: the segment sum of w[e] * x[src[e]]
    by dst over the plan's live edges (`part_bat_reduce`).

    plan: BatPlan with its edge-row schedule; its `num_segments` rows.
    src:  [n_vblocks * e_tile] int32 — edge-order source rows (0 on pads).
    w:    [n_vblocks * e_tile] float32 edge weights (0 on pads), or None.
    """

    plan: BatPlan
    src: torch.Tensor
    w: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PartBatFamily:
    """Stacked per-part BAT plans with an equalized chunk grid (CPU
    tensors with a leading part axis P; `unbatch` gives one part's).

    out_block: [P, C*T_c] int32 — output window per tile.
    vblock:    [P, C*T_c] int32 — value block per tile; n_vblocks is the
               all--1 sentinel.
    dst3:      [P, n_vblocks+1, 1, E] int32 — dst ids per value block, -1
               padded; block n_vblocks is the sentinel.
    src:       [P, n_vblocks*E] int32 — edge-order source rows into the
               reduce input (receive buffer or local block), 0 pad.
    w:         [P, n_vblocks*E] float32 or None — edge weights, 0 pad.
    chunk_w0 / chunk_w1: [P, C] int32 — each chunk's window range.
    """

    out_block: torch.Tensor
    vblock: torch.Tensor
    dst3: torch.Tensor
    src: torch.Tensor
    w: Optional[torch.Tensor]
    chunk_w0: torch.Tensor
    chunk_w1: torch.Tensor
    e_tile: int
    s_tile: int
    num_segments: int
    n_blocks: int
    n_vblocks: int
    C: int
    T_c: int
    W_c: int

    def unbatch(self, rank: int, device=None) -> PartBat:
        """Part `rank`'s plan on `device` (`resolve_device`: the card by
        default, the CPU only when asked for): a BatPlan over its equalized
        tiles (checked by `bat_plan_from_host` chunk by chunk) with the
        edge-row schedule, its sources and weights."""
        w0, w1 = self.chunk_w0[rank].tolist(), self.chunk_w1[rank].tolist()
        arrays = dict(out_block=self.out_block[rank].numpy(), vblock=self.vblock[rank].numpy(),
                      dst3=self.dst3[rank].numpy())
        meta = dict(
            e_tile=self.e_tile, s_tile=self.s_tile, num_segments=self.num_segments,
            n_blocks=self.n_blocks, num_edges=self.n_vblocks * self.e_tile,
            n_vblocks=self.n_vblocks,
            chunks=tuple((i * self.T_c, (i + 1) * self.T_c, w0[i], w1[i]) for i in range(self.C)),
            chunk_blocks=self.W_c,
        )
        dev = resolve_device(device)
        return PartBat(plan=bat_plan_from_host(arrays, meta, device=dev),
                       src=self.src[rank].to(dev),
                       w=None if self.w is None else self.w[rank].to(dev))


def build_part_bat_family(
    dst_parts: List[np.ndarray],
    src_parts: List[np.ndarray],
    w_parts: List[Optional[np.ndarray]],
    num_segments: int,
    *,
    e_tile: int = 1024,
    s_tile: int = 256,
    max_chunk_tiles: int = MAX_PREFETCH_TILES,
) -> PartBatFamily:
    """One edge family's stacked plans. `dst_parts[p]` must be sorted
    ascending (each part's local dst ids); `src_parts[p]` are the matching
    source rows in the same edge order."""
    P = len(dst_parts)
    pieces = []
    for p in range(P):
        arrays, meta = build_bat_plan_host(np.asarray(dst_parts[p], np.int64), num_segments,
                                           e_tile=e_tile, s_tile=s_tile,
                                           max_chunk_tiles=max_chunk_tiles)
        if not meta["chunks"]:
            # the whole plan as one chunk
            T = int(len(arrays["out_block"]))
            meta["chunks"] = ((0, T, 0, int(meta["n_blocks"])),)
            meta["chunk_blocks"] = int(meta["n_blocks"])
        pieces.append((arrays, meta))

    n_blocks = pieces[0][1]["n_blocks"]
    nvb_max = max(m["n_vblocks"] for _, m in pieces)
    C = max(len(m["chunks"]) for _, m in pieces)
    T_c = max(m["chunks"][0][1] - m["chunks"][0][0] for _, m in pieces)
    W_c = max(m["chunk_blocks"] for _, m in pieces)
    E = int(e_tile)

    obs, vbs, d3s, srcs, ws, w0s, w1s = [], [], [], [], [], [], []
    weighted = any(w is not None for w in w_parts)
    for p, (arrays, meta) in enumerate(pieces):
        nvb_p = meta["n_vblocks"]
        chunks = meta["chunks"]
        ob = np.asarray(arrays["out_block"], np.int32)
        # the part's sentinel (nvb_p) -> the shared sentinel (nvb_max)
        vb = np.asarray(arrays["vblock"], np.int32)
        vb = np.where(vb >= nvb_p, nvb_max, vb).astype(np.int32)
        T_p = chunks[0][1] - chunks[0][0]
        ob_new = np.full((C, T_c), np.int32(n_blocks))
        vb_new = np.full((C, T_c), np.int32(nvb_max))
        cw0 = np.full(C, np.int32(n_blocks))
        cw1 = np.full(C, np.int32(n_blocks))
        for i, (t0, t1, w0, w1) in enumerate(chunks):
            ob_new[i, :T_p] = ob[t0:t1]
            vb_new[i, :T_p] = vb[t0:t1]
            # extension pads repeat the chunk's last window (out_block stays
            # non-decreasing within the chunk) on the sentinel block
            ob_new[i, T_p:] = ob[t1 - 1]
            cw0[i], cw1[i] = w0, w1
        obs.append(ob_new.reshape(-1))
        vbs.append(vb_new.reshape(-1))
        w0s.append(cw0)
        w1s.append(cw1)

        d3 = np.full((nvb_max + 1, 1, E), -1, np.int32)
        d3[:nvb_p] = np.asarray(arrays["dst3"], np.int32)[:nvb_p]
        d3s.append(d3)

        s_arr = np.zeros(nvb_max * E, np.int32)
        s_arr[: len(src_parts[p])] = np.asarray(src_parts[p], np.int32)
        srcs.append(s_arr)
        if weighted:
            w_arr = np.zeros(nvb_max * E, np.float32)
            wp = w_parts[p]
            if wp is not None and len(wp):
                w_arr[: len(wp)] = np.asarray(wp, np.float32)
            ws.append(w_arr)

    def t(arrs):
        return torch.from_numpy(np.stack(arrs))

    return PartBatFamily(
        out_block=t(obs), vblock=t(vbs), dst3=t(d3s), src=t(srcs),
        w=t(ws) if weighted else None, chunk_w0=t(w0s), chunk_w1=t(w1s),
        e_tile=E, s_tile=int(s_tile), num_segments=int(num_segments), n_blocks=int(n_blocks),
        n_vblocks=int(nvb_max), C=int(C), T_c=int(T_c), W_c=int(W_c),
    )


def part_bat_reduce(fam: PartBat, xr: torch.Tensor, backend: str = "auto", *,
                    all_rows: bool = False) -> torch.Tensor:
    """One part's segment sum: out[d] += w[e] * xr[src[e]] over the plan's
    edges, in float32. Returns [num_segments, F], or with `all_rows` the
    whole [n_blocks * s_tile, F] output (a carry the stream kernels add
    into).

    "auto": `bat_segment_sum` over the whole plan in one launch on CUDA
    (the reference scans chunk by chunk), its plain version on the CPU.
    "reference": `bat_segment_sum_plain`, the reference's
    `use_pallas=False` route."""
    bp = fam.plan
    if backend == "reference":
        out = bat_segment_sum_plain(bp, xr.float(), fam.w, src=fam.src)
        return out if all_rows else out[: bp.num_segments]
    if backend != "auto":
        raise ValueError(f"backend={backend!r}: expected 'auto' or 'reference'")
    out = bat_segment_sum(bp, xr.float().contiguous(), fam.w, src=fam.src)
    return out if all_rows else out[: bp.num_segments]
