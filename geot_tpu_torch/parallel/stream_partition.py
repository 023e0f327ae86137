"""Per-part streaming (gather-free) plans for the interior edges of the
hybrid layout, and their reduce.

Port of `geot_tpu/parallel/stream_partition.py` (`PartStreamFamily` :53,
`build_part_stream_family` :88, `part_stream_reduce` :214). Given the same
edges and knobs, the stacked arrays equal the JAX package's.

The interior edges of a clustered partition are the dense (dst window, src
block) cells the stream kernel wins on: their sources lie in the part's own
block, so each part streams them with no communication. The residue stays
on the BAT families (`parallel.bat_partition`), and so do all boundary
edges. The reference equalizes the parts' plans for its one `shard_map`
program: one forced tile size, a uniform (C, T_c) chunk grid, pad tiles of
all -1 slots; a part with fewer chunks than C, or with no stream family,
gets all-pad chunks at window 0 after its real chunks.

The port runs one process per part, and the CUDA kernel takes a family
whole, by a schedule that needs out_block non-decreasing over the whole
family (`graph.stream_plan.kernel_schedule`). So each part's `StreamPlan`
is made from its live tiles only (`part_stream_plan`), in the family's
order; the stacked arrays stay as the reference builds them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from geot_tpu_torch.graph.plan import MAX_PREFETCH_TILES
from geot_tpu_torch.graph.stream_plan import (
    StreamKnobs,
    StreamPlan,
    build_stream_split_host,
    stream_plan_from_host,
)
from geot_tpu_torch.ops.stream_kernels import (
    stream_segment_acc,
    stream_segment_acc_plain,
    stream_segment_sum,
    stream_segment_sum_plain,
)
from geot_tpu_torch.utils.device import resolve_device

__all__ = [
    "PartStreamFamily",
    "build_part_stream_family",
    "part_stream_plan",
    "part_stream_reduce",
]


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PartStreamFamily:
    """Stacked per-part stream plans of one tile size, equalized shapes
    (CPU tensors with a leading part axis P).

    ob:    [P, C*T_c] int32 — output window per tile (part-local,
           non-decreasing within each chunk; pad tiles repeat the chunk's
           last real window, all-pad chunks hold 0).
    sb:    [P, C*T_c] int32 — the x block tile t streams.
    dst3:  [P, C*T_c, 1, E] int32 — part-local dst ids, -1 pads.
    srcl3: [P, C*T_c, 1, E] int32 — block-local src ids, -1 pads.
    w3:    [P, C*T_c, 1, E] float32 or None — static slot weights.
    """

    ob: torch.Tensor
    sb: torch.Tensor
    dst3: torch.Tensor
    srcl3: torch.Tensor
    w3: Optional[torch.Tensor]
    e_tile: int
    s_tile: int
    x_rows: int
    num_segments: int
    n_blocks: int
    n_xblocks: int
    C: int
    T_c: int


def build_part_stream_family(
    dst_parts: List[np.ndarray],
    src_parts: List[np.ndarray],
    w_parts: List[Optional[np.ndarray]],
    num_segments: int,
    num_src: int,
    *,
    e_tile: int = 1024,
    s_tile: int = 256,
    x_rows: int = 256,
    feature_hint: int = 128,
    min_stream_frac: float = 0.0,
    margin: Optional[float] = None,
) -> Tuple[Optional[PartStreamFamily], List[np.ndarray], dict]:
    """Split each part's dst-sorted, part-local interior edges into a
    streamed family and a residue, by the port's census
    (`build_stream_split_host`) with the reference's arguments: `margin`
    (None: `StreamKnobs`'s) and `min_stream_frac` go in through the knobs,
    the chunks are uniformized as the reference's are.

    Returns (family, rest_masks, stats): `family` is None when no part's
    census accepts streaming; `rest_masks[p]` marks part p's residue edges
    (all True where the part does not stream)."""
    P = len(dst_parts)
    weighted = any(w is not None and len(w) for w in w_parts)
    knobs = dataclasses.replace(StreamKnobs(), min_stream_frac=min_stream_frac,
                                **({} if margin is None else {"margin": margin}))
    per_part, rest_masks = [], []
    stats: dict = {"parts": []}
    for p in range(P):
        d_p = np.asarray(dst_parts[p], np.int64)
        s_p = np.asarray(src_parts[p], np.int64)
        if len(d_p) == 0:
            per_part.append(None)
            rest_masks.append(np.zeros(0, bool))
            stats["parts"].append({"stream_frac": 0.0})
            continue
        families, rest_mask, st = build_stream_split_host(
            d_p, s_p, num_segments, num_src, s_tile=s_tile, x_rows=x_rows,
            e_tile=e_tile,  # one forced family
            edge_weight=w_parts[p] if weighted else None, feature_hint=feature_hint,
            max_chunk_tiles=MAX_PREFETCH_TILES, knobs=knobs, uniformize=True)
        if families is None or len(families) == 0:
            per_part.append(None)
        elif len(families) != 1:
            raise ValueError("a forced e_tile must give one stream family")
        else:
            per_part.append(families[0])
        rest_masks.append(rest_mask)
        stats["parts"].append({k: st.get(k) for k in ("stream_frac", "est_stream_ms")})
    if all(f is None for f in per_part):
        return None, rest_masks, stats

    n_blocks = max(_cdiv(max(num_segments, 1), s_tile), 1)
    n_xb = max(_cdiv(max(num_src, 1), x_rows), 1)
    E = int(e_tile)
    C = T_c = 1
    for fam in per_part:
        if fam is None:
            continue
        arrays, meta = fam
        chunks = meta["chunks"] or ((0, len(arrays["out_block"]), 0, 0),)
        C = max(C, len(chunks))
        T_c = max(T_c, max(t1 - t0 for t0, t1, _, _ in chunks))

    obs, sbs, d3s, sl3s, w3s = [], [], [], [], []
    for fam in per_part:
        ob_new = np.zeros((C, T_c), np.int32)
        sb_new = np.zeros((C, T_c), np.int32)
        d3_new = np.full((C, T_c, 1, E), -1, np.int32)
        sl_new = np.full((C, T_c, 1, E), -1, np.int32)
        w3_new = np.zeros((C, T_c, 1, E), np.float32) if weighted else None
        if fam is not None:
            arrays, meta = fam
            ob = np.asarray(arrays["out_block"], np.int32)
            sb = np.asarray(arrays["sblock"], np.int32)
            w3 = np.asarray(arrays["w3"], np.float32) if weighted and "w3" in arrays else None
            chunks = meta["chunks"] or ((0, len(ob), 0, 0),)
            for i, (t0, t1, _w0, _w1) in enumerate(chunks):
                nt = t1 - t0
                ob_new[i, :nt] = ob[t0:t1]
                sb_new[i, :nt] = sb[t0:t1]
                d3_new[i, :nt] = arrays["dst3"][t0:t1]
                sl_new[i, :nt] = arrays["srcl3"][t0:t1]
                if w3 is not None:
                    w3_new[i, :nt] = w3[t0:t1]
                # pad tiles repeat the last real (window, x block)
                if nt:
                    ob_new[i, nt:] = ob[t1 - 1]
                    sb_new[i, nt:] = sb[t1 - 1]
        obs.append(ob_new.reshape(-1))
        sbs.append(sb_new.reshape(-1))
        d3s.append(d3_new.reshape(C * T_c, 1, E))
        sl3s.append(sl_new.reshape(C * T_c, 1, E))
        if weighted:
            w3s.append(w3_new.reshape(C * T_c, 1, E))

    def t(arrs):
        return torch.from_numpy(np.stack(arrs))

    fam_out = PartStreamFamily(
        ob=t(obs), sb=t(sbs), dst3=t(d3s), srcl3=t(sl3s), w3=t(w3s) if weighted else None,
        e_tile=E, s_tile=int(s_tile), x_rows=int(x_rows), num_segments=int(num_segments),
        n_blocks=int(n_blocks), n_xblocks=int(n_xb), C=int(C), T_c=int(T_c),
    )
    stats["C"], stats["T_c"] = int(C), int(T_c)
    return fam_out, rest_masks, stats


def part_stream_plan(fam: PartStreamFamily, rank: int, device=None) -> Optional[StreamPlan]:
    """Part `rank`'s StreamPlan on `device` (`resolve_device`: the card by
    default, the CPU only when asked for), over its live tiles (those
    holding an edge) in the family's order, with the kernel's schedule;
    None where the part streams nothing. The pad tiles and all-pad chunks
    are left out: they add nothing, and the all-pad chunks' window 0 after
    higher windows would break the schedule's order."""
    dst3 = fam.dst3[rank].numpy()
    live = np.flatnonzero((dst3.reshape(dst3.shape[0], -1) >= 0).any(axis=1))
    if not len(live):
        return None
    arrays = dict(out_block=fam.ob[rank].numpy()[live], sblock=fam.sb[rank].numpy()[live],
                  dst3=dst3[live], srcl3=fam.srcl3[rank].numpy()[live])
    if fam.w3 is not None:
        arrays["w3"] = fam.w3[rank].numpy()[live]
    meta = dict(e_tile=fam.e_tile, s_tile=fam.s_tile, x_rows=fam.x_rows,
                num_segments=fam.num_segments, n_blocks=fam.n_blocks, n_xblocks=fam.n_xblocks,
                num_edges=int((dst3 >= 0).sum()))
    return stream_plan_from_host(arrays, meta, device=resolve_device(device))


def part_stream_reduce(sp: StreamPlan, x_local: torch.Tensor, backend: str = "auto",
                       carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One part's streamed segment sum, out[d] += w_e * x_local[src_e] over
    its streamed interior edges, in float32: into `carry` [n_blocks *
    s_tile, F] float32 in place where given (`stream_segment_acc`, what
    `halo_spmm` runs, adding into the BAT residue's sum), else a fresh
    [n_blocks * s_tile, F] (`stream_segment_sum`). The reference adds its
    chunks into a zero carry under `lax.scan`; the kernel takes the family
    whole.

    "auto": the kernel on CUDA, the plain version on the CPU;
    "reference": the plain version."""
    if backend not in ("auto", "reference"):
        raise ValueError(f"backend={backend!r}: expected 'auto' or 'reference'")
    x = x_local if x_local.dtype in (torch.float32, torch.bfloat16) else x_local.float()
    x = x.contiguous()
    if backend == "reference":
        return (stream_segment_sum_plain(sp, x) if carry is None
                else stream_segment_acc_plain(sp, x, carry))
    return stream_segment_sum(sp, x) if carry is None else stream_segment_acc(sp, x, carry)
