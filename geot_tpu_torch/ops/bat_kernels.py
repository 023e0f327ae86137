"""BAT segment sums: the CUDA kernel's wrappers, wide and packed.

Replace `bat_segment_sum` / `_bat_kernel` and `bat_segment_sum_packed` /
`_bat_packed_kernel` of the JAX package
(`geot_tpu/ops/pallas_segment.py:730-849`, `:852-1000`). On the card both
are the row-ordered edge sum of `ops/csrc/edge_row_sum.cu` over the
plan's `RowSchedule` (shared with the AEB slot functions and
`plan_segment_sum_sr_packed`), built by nvcc for sm_90a and called through
ctypes (see that file for its design and bound): the wide sum at any
width, the packed one at the widths its plan is packed for. Each takes
values in edge order (the TPU kernels' contract) or x with `src`, read as
x[src[e]] in the kernel, and sums a plan whole, chunked or not, in one
launch. For a tensor on the CPU a wrapper runs its plain version
(`bat_segment_sum_plain`, `ops.reference.bat_segment_sum_packed_plain`);
for a CUDA tensor it launches the kernel or raises.

`bucketed_sum` is the same kernel over a `BucketedBatPlan` (the
reference's `_bucketed_sum`, `geot_tpu/ops/api.py:530-616`, which calls
`bat_segment_sum` chunk by chunk over each source bucket's row slice of
x): one launch a plan, reading x[src[e]] by the plan's global source ids
and its baked weights, counted under `bat_segment_sum.launches`. Its plain
version, `bucketed_sum_plain`, follows the reference's chunk order.
"""

from __future__ import annotations

from typing import Optional

import torch

from geot_tpu_torch.graph.plan import BatPlan, BucketedBatPlan, row_schedule_of
from geot_tpu_torch.ops.edge_row_kernels import edge_row_sum
from geot_tpu_torch.ops.reference import bat_segment_sum_packed_plain, bat_tiles_plain

__all__ = ["bat_segment_sum", "bat_segment_sum_plain", "bat_segment_sum_packed",
           "bucketed_sum", "bucketed_sum_plain"]


def bat_segment_sum_plain(
    bp: BatPlan,
    vals: torch.Tensor,
    w_edge: Optional[torch.Tensor] = None,
    *,
    src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain-torch BAT segment sum, the same function as the kernel:
    for each tile t, sum w[e] * v(e) over the edges e of value block
    vblock[t] whose dst lies in window out_block[t], into row dst
    (`bat_tiles_plain` over dst3). v(e) = vals[e] (edge order), or
    vals[src[e]] with `src`; a row past the end of vals, an edge past
    src's and a weight past w_edge's read as zero. Returns
    [n_blocks*s_tile, F] float32 (every row written; empty rows 0)."""
    return bat_tiles_plain(bp, bp.dst3.reshape(bp.dst3.shape[0], bp.e_tile), vals, w_edge,
                           src=src)


def _row_sum(bp: BatPlan, vals, w_edge, src, what: str) -> torch.Tensor:
    """Checks the plan and launches the edge-row kernel over its schedule:
    every live edge, a weight-0 one adding 0 * v as the TPU kernels do."""
    if tuple(bp.dst3.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"{what}: dst3 shape {tuple(bp.dst3.shape)} does not match the plan")
    return edge_row_sum(row_schedule_of(bp), vals, what=what, src=src, w_edge=w_edge)


def bat_segment_sum(
    bp: BatPlan,
    vals: torch.Tensor,
    w_edge: Optional[torch.Tensor] = None,
    *,
    src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Wide BAT segment sum: vals [rows, F] in EDGE order (any F >= 1; the
    TPU kernel's F_pad of whole 128-lane tiles is not needed), or, with
    `src` [nnz] int32, node rows x that edge e reads as x[src[e]];
    optional per-edge weights [n_w]. Rows past the end of vals (or of
    src) and weights past n_w read as zero; a live edge of weight 0 adds
    0 * v. Returns [n_blocks*s_tile, F] float32. Any plan, packed or not,
    chunked or uniformized with pad tiles, is summed whole in one launch.

    CPU tensors run the plain version; CUDA tensors launch the edge-row
    kernel (`ops/csrc/edge_row_sum.cu`, over the plan's `row_sched`) and
    add one to `bat_segment_sum.launches`."""
    dev = vals.device
    if dev.type == "cpu":
        return bat_segment_sum_plain(bp, vals, w_edge, src=src)
    if dev.type != "cuda":
        raise ValueError(f"bat_segment_sum: unsupported device {dev}")
    out = _row_sum(bp, vals, w_edge, src, "bat_segment_sum")
    bat_segment_sum.launches += 1
    return out


bat_segment_sum.launches = 0


PACKED_WIDTHS = (8, 16, 32, 64)


def bat_segment_sum_packed(
    bp: BatPlan,
    vals: torch.Tensor,
    w_edge: Optional[torch.Tensor] = None,
    *,
    src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed BAT segment sum for narrow features: vals [rows, F] in EDGE
    order, or, with `src` [nnz] int32, node rows x that edge e reads as
    x[src[e]]; F in PACKED_WIDTHS and 128 // F == bp.km_pack (the plan's
    `dst_km` built for that pack); optional per-edge weights [n_w]. Rows
    past the end of vals (or of src) and weights past n_w read as zero; a
    live edge of weight 0 adds 0 * v. Returns [n_blocks*s_tile, F] float32.
    A plan cut into chunks is summed whole, in one launch.

    CPU tensors run the plain version; CUDA tensors launch the edge-row
    kernel (`ops/csrc/edge_row_sum.cu`, over the plan's `row_sched`) and
    add one to `bat_segment_sum_packed.launches`."""
    F = vals.shape[1] if vals.dim() == 2 else 0
    if F not in PACKED_WIDTHS or bp.km_pack != 128 // F or bp.dst_km is None:
        raise ValueError(f"bat_segment_sum_packed: width {F} with km_pack {bp.km_pack} "
                         f"(dst_km {'set' if bp.dst_km is not None else 'None'}); F must be "
                         f"one of {PACKED_WIDTHS} and km_pack 128 // F")
    dev = vals.device
    if dev.type == "cpu":
        return bat_segment_sum_packed_plain(bp, vals, w_edge, src=src)
    if dev.type != "cuda":
        raise ValueError(f"bat_segment_sum_packed: unsupported device {dev}")
    if bp.e_tile % bp.km_pack:
        raise ValueError(f"e_tile={bp.e_tile} is not a multiple of km_pack={bp.km_pack}")
    if tuple(bp.dst_km.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"dst_km shape {tuple(bp.dst_km.shape)} does not match the plan")
    out = _row_sum(bp, vals, w_edge, src, "bat_segment_sum_packed")
    bat_segment_sum_packed.launches += 1
    return out


bat_segment_sum_packed.launches = 0


def bucketed_sum_plain(bp: BucketedBatPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain-torch sum over a bucketed BAT plan in the reference's order:
    chunk by chunk, each chunk's tiles summed into its `chunk_blocks`
    windows in float32 with `index_add_` (edge e of value block vblock[t]
    adds w_pad[e] * x[src[e]] into its dst row where that lies in window
    out_block[t]), the windows past the chunk's own masked, and the
    partial added into the running sum. x [rows, F]; rows past its end read
    as zero. Returns [num_segments, F] float32."""
    E, s, W = bp.e_tile, bp.s_tile, max(bp.chunk_blocks, 1)
    dev = x.device
    dst = bp.dst3.reshape(-1).to(dev).long()
    src = bp.src.to(dev).long()
    w = None if bp.w_pad is None else bp.w_pad.to(dev).float()
    ob_all, vb_all = bp.out_block.to(dev).long(), bp.vblock.to(dev).long()
    out = torch.zeros((bp.n_blocks + W) * s, x.shape[1], dtype=torch.float32, device=dev)
    xf = x.float()
    chunks = bp.chunks or ((0, bp.num_tiles, 0, bp.n_blocks, 0),)
    for t0, t1, w0, w1, _ in chunks:
        ob, vb = ob_all[t0:t1], vb_all[t0:t1]
        edges = vb[:, None] * E + torch.arange(E, device=dev)
        d = dst[edges]
        local = d - ob[:, None] * s
        keep = (d >= 0) & (local >= 0) & (local < s)
        e_idx = edges[keep]
        rows = (ob[:, None] * s + local)[keep] - w0 * s
        v = torch.zeros(e_idx.shape[0], x.shape[1], dtype=torch.float32, device=dev)
        inside = src[e_idx] < x.shape[0]
        v[inside] = xf.index_select(0, src[e_idx][inside])
        if w is not None:
            v = v * w[e_idx][:, None]
        part = torch.zeros(W * s, x.shape[1], dtype=torch.float32, device=dev)
        part.index_add_(0, rows, v)
        part[(w1 - w0) * s:] = 0.0
        out[w0 * s : (w0 + W) * s] += part
    return out[: bp.num_segments]


def bucketed_sum(bp: BucketedBatPlan, x: torch.Tensor) -> torch.Tensor:
    """Segment sum over a bucketed BAT plan: out[d] = sum of w_pad[e] *
    x[src[e]] over the plan's live entries e with dst d (1 where the plan
    has no weights). x [rows, F] float32. Returns [num_segments, F]
    float32.

    CPU tensors run `bucketed_sum_plain`; CUDA tensors launch the
    edge-row kernel over the plan's `row_sched` (the whole plan, each
    row's entries in bucket order, a fixed order with no atomics) and add
    one to `bat_segment_sum.launches`."""
    dev = x.device
    if dev.type == "cpu":
        return bucketed_sum_plain(bp, x)
    if dev.type != "cuda":
        raise ValueError(f"bucketed_sum: unsupported device {dev}")
    if tuple(bp.dst3.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"bucketed_sum: dst3 shape {tuple(bp.dst3.shape)} does not match "
                         "the plan")
    out = edge_row_sum(row_schedule_of(bp), x, what="bucketed_sum", src=bp.src,
                       w_edge=bp.w_pad)
    bat_segment_sum.launches += 1
    return out[: bp.num_segments]
