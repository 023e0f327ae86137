"""BAT segment sums: the CUDA kernels' wrappers, wide and packed.

Replace `bat_segment_sum` / `_bat_kernel` and `bat_segment_sum_packed` /
`_bat_packed_kernel` of the JAX package
(`geot_tpu/ops/pallas_segment.py:730-849`, `:852-1000`). The kernels are
`ops/csrc/bat_segment_sum.cu` (F_pad a multiple of 128) and
`ops/csrc/edge_row_sum.cu` (F 8-64: the row-ordered edge sum over a packed
plan's `RowSchedule`, shared with the AEB slot functions), built by nvcc
for sm_90a and called through ctypes (see those files for their design
and bound). For a tensor
on the CPU a wrapper runs its plain version (`bat_segment_sum_plain`, and
`ops.reference.bat_segment_sum_packed_plain`); for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from geot_tpu_torch.graph.plan import BatPlan, row_schedule_of
from geot_tpu_torch.ops._build import load_kernel
from geot_tpu_torch.ops.edge_row_kernels import edge_row_sum
from geot_tpu_torch.ops.reference import bat_segment_sum_packed_plain, bat_tiles_plain

__all__ = ["bat_segment_sum", "bat_segment_sum_plain", "bat_segment_sum_packed"]

_KERNEL_COLS = 128  # columns one CUDA block covers (32 lanes x float4)


def _bound_fn():
    fn = load_kernel("bat_segment_sum").geot_bat_segment_sum
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, i64, i32, p, p, i64, p, p, i32, i32, i32, i32, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def bat_segment_sum_plain(
    bp: BatPlan,
    vals: torch.Tensor,
    w_edge: Optional[torch.Tensor] = None,
    f_tile: int = 128,
) -> torch.Tensor:
    """Plain-torch BAT segment sum, the same function as the kernel:
    for each tile t, sum w[e]*vals[e] over the edges e of value block
    vblock[t] whose dst lies in window out_block[t], into row dst
    (`bat_tiles_plain` over dst3). Rows e >= vals.shape[0] read as zero,
    weights e >= len(w_edge) as zero. Returns [n_blocks*s_tile, F] float32
    (every row written; empty rows 0). `f_tile` is accepted for the
    kernel's signature and does not change the result."""
    del f_tile
    return bat_tiles_plain(bp, bp.dst3.reshape(bp.dst3.shape[0], bp.e_tile), vals, w_edge)


def _check(t: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, vals on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bat_segment_sum(
    bp: BatPlan,
    vals: torch.Tensor,
    w_edge: Optional[torch.Tensor] = None,
    f_tile: int = 128,
) -> torch.Tensor:
    """Wide BAT segment sum over EDGE-ordered values [>= nnz rows, F_pad]
    (F_pad a multiple of f_tile, f_tile a multiple of 128) with optional
    per-edge weights [nnz]. Returns [n_blocks*s_tile, F_pad] float32.

    The kernel finds each window's tiles by a binary search over
    out_block, so the plan must be ordered as a whole (`bp.monotone`). A
    uniformized chunked plan whose pad tiles break that order is refused
    on every device; run it chunk by chunk, as `segment_spmm` does.

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    add one to `bat_segment_sum.launches`."""
    if not bp.monotone:
        raise ValueError("bat_segment_sum: out_block is not non-decreasing over "
                         "the whole plan; run its chunks one by one")
    dev = vals.device
    if dev.type == "cpu":
        return bat_segment_sum_plain(bp, vals, w_edge, f_tile)
    if dev.type != "cuda":
        raise ValueError(f"bat_segment_sum: unsupported device {dev}")
    _check(vals, "vals", torch.float32, 2, dev)
    _check(bp.dst3, "dst3", torch.int32, 3, dev)
    _check(bp.out_block, "out_block", torch.int32, 1, dev)
    _check(bp.vblock, "vblock", torch.int32, 1, dev)
    if w_edge is not None:
        _check(w_edge, "w_edge", torch.float32, 1, dev)
    F = vals.shape[1]
    if f_tile % _KERNEL_COLS or F % f_tile:
        raise ValueError(f"F_pad={F} must be a multiple of f_tile={f_tile}, "
                         f"itself a multiple of {_KERNEL_COLS}")
    if bp.e_tile % 32:
        raise ValueError(f"e_tile={bp.e_tile} must be a multiple of 32")
    if tuple(bp.dst3.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"dst3 shape {tuple(bp.dst3.shape)} does not match the plan")
    if bp.vblock.shape != bp.out_block.shape:
        raise ValueError("vblock and out_block differ in length")
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    out = torch.empty(bp.n_blocks * bp.s_tile, F, dtype=torch.float32, device=dev)
    # scratch: each tile's first and last row and their partial sums
    part_rows = torch.empty(2 * bp.num_tiles, dtype=torch.int32, device=dev)
    part_vals = torch.empty(2 * bp.num_tiles, F, dtype=torch.float32, device=dev)
    fn = _bound_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            vals.data_ptr(), vals.shape[0], F,
            bp.dst3.data_ptr(),
            None if w_edge is None else w_edge.data_ptr(),
            0 if w_edge is None else w_edge.shape[0],
            bp.out_block.data_ptr(), bp.vblock.data_ptr(), bp.num_tiles,
            bp.n_blocks, bp.e_tile, bp.s_tile, out.data_ptr(),
            part_rows.data_ptr(), part_vals.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bat_segment_sum kernel launch failed: cudaError {rc}")
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
    _check(bp.dst_km, "dst_km", torch.int32, 3, dev)
    if bp.e_tile % bp.km_pack:
        raise ValueError(f"e_tile={bp.e_tile} is not a multiple of km_pack={bp.km_pack}")
    if tuple(bp.dst_km.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"dst_km shape {tuple(bp.dst_km.shape)} does not match the plan")
    out = edge_row_sum(row_schedule_of(bp), vals, what="bat_segment_sum_packed", src=src,
                       w_edge=w_edge)
    bat_segment_sum_packed.launches += 1
    return out


bat_segment_sum_packed.launches = 0
