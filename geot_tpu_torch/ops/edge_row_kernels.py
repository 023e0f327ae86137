"""The row-ordered edge-sum kernel's launcher (`ops/csrc/edge_row_sum.cu`).

`plan_segment_sum_sr2`, `plan_segment_sum_packed2`,
`plan_segment_sum_sr_packed`, `plan_segment_sum_sr`, `plan_segment_sum_mh`
(`ops/slot_kernels.py`), `bat_segment_sum` and `bat_segment_sum_packed`
(`ops/bat_kernels.py`) launch it on CUDA tensors, each counting its
launches under its own name; their plain versions are in
`ops/reference.py`. It sums a plan's live edges by output row in edge
order, from the plan's `RowSchedule` (`graph.row_schedule`): values in edge
order, in a slot plan's slot order, or gathered in the kernel as
x[src[e]], with one weight per edge or one per edge and head (mh). Nothing
is built or loaded at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from geot_tpu_torch.graph.row_schedule import RowSchedule
from geot_tpu_torch.ops._build import load_kernel

__all__ = ["edge_row_sum", "part_stride"]


def _bound_fn():
    fn = load_kernel("edge_row_sum").geot_edge_row_sum
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        host_ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [p, i64, i32, p, i64, i64, p, p, i32, p, p, i64, i32, p, i64, i32, i32,
                       p, i32, p, i32, p, p, host_ints, i32, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def part_stride(F: int) -> int:
    """Floats of one partial sum's row: the kernel's lane groups hold 4
    columns a lane, 32 lanes per 128-column slab at F > 64, else 16, 8, 4
    or 2 lanes (F <= 64, 32, 16, 8)."""
    if F > 64:
        return -(-F // 128) * 128
    return 64 if F > 32 else 32 if F > 16 else 16 if F > 8 else 8


def _check(t: torch.Tensor, name: str, dtype, dev, what: str) -> None:
    if t.device != dev:
        raise ValueError(f"{what}: {name} is on {t.device}, the values on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous 1-D tensor, got shape "
                         f"{tuple(t.shape)}")


def edge_row_sum(sched: RowSchedule, vals: torch.Tensor, *, what: str,
                 src: Optional[torch.Tensor] = None, e_base: int = 0, by_slot: bool = False,
                 w_slots: Optional[torch.Tensor] = None, w_edge: Optional[torch.Tensor] = None,
                 skip_zero: bool = False, w_heads: Optional[torch.Tensor] = None,
                 head_dim: int = 0) -> torch.Tensor:
    """out [sched.n_out, F] float32 on the card: for each output row, the
    sum over its scheduled edges e, in edge order, of w(e) * v(e). v(e) is
    vals[src[e]] (src given), vals[slot(e)] (by_slot) or vals[e - e_base];
    a row outside vals, or an edge past src, reads as zero. w(e) is 1, times
    w_slots[slot(e)] (flat), times w_edge[e] (0 past its end) where given;
    with skip_zero an edge of weight 0 adds nothing. Or, with `w_heads`
    [rows, H] (neither w_slots nor w_edge), column c of v(e) is weighted by
    w_heads[id, c // head_dim], id the edge's slot (by_slot) or the edge
    (rows past w_heads' end weigh 0); columns past H heads are inert, and
    an edge whose H weights are all 0 adds nothing. Checks what the kernel
    relies on and raises on what it does not take (`what` names the
    caller); launches on the current stream."""
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {dev}")
    if vals.dtype != torch.float32 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"{what}: values must be a contiguous 2-D float32 tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if vals.shape[0] >= (1 << 31) - 1:
        raise ValueError(f"{what}: {vals.shape[0]} value rows, at most 2**31 - 2")
    for name in ("cols", "unit_dest", "tasks", "zero_runs", "fix"):
        t = getattr(sched, name)
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: the schedule's {name} must be contiguous int32 on {dev}")
    if sched.slot is not None:
        _check(sched.slot, "the schedule's slot", torch.int32, dev, what)
    if (by_slot or w_slots is not None) and sched.slot is None:
        raise ValueError(f"{what}: slot-order values or slot weights need a slot plan")
    if src is not None:
        _check(src, "src", torch.int32, dev, what)
        if by_slot or e_base:
            raise ValueError(f"{what}: gathered values take neither slot order nor e_base")
    if w_slots is not None:
        _check(w_slots, "w_slots", torch.float32, dev, what)
    if w_edge is not None:
        _check(w_edge, "w_edge", torch.float32, dev, what)
    H = 0
    if w_heads is not None:
        if w_slots is not None or w_edge is not None:
            raise ValueError(f"{what}: head weights take neither w_slots nor w_edge")
        if w_heads.device != dev or w_heads.dtype != torch.float32:
            raise ValueError(f"{what}: w_heads must be float32 on {dev}, got {w_heads.dtype} "
                             f"on {w_heads.device}")
        if w_heads.dim() != 2 or w_heads.shape[1] < 1 or not w_heads.is_contiguous():
            raise ValueError(f"{what}: w_heads must be a contiguous [rows, H] tensor, got shape "
                             f"{tuple(w_heads.shape)}")
        if head_dim < 1:
            raise ValueError(f"{what}: head_dim must be >= 1, got {head_dim}")
        H = w_heads.shape[1]
    n_tasks = sched.tasks.shape[0] - 1
    if sched.fix_levels[-1] != sched.fix.shape[0] or n_tasks < 0:
        raise ValueError(f"{what}: a malformed schedule")
    F = vals.shape[1]
    out = torch.empty(sched.n_out, F, dtype=torch.float32, device=dev)
    part = torch.empty(max(sched.n_parts, 1) * part_stride(F), dtype=torch.float32, device=dev)
    levels = (ctypes.c_int * len(sched.fix_levels))(*sched.fix_levels)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _bound_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(vals.data_ptr(), vals.shape[0], F, ptr(src),
                0 if src is None else src.shape[0], int(e_base), sched.cols.data_ptr(),
                ptr(sched.slot), int(by_slot), ptr(w_slots), ptr(w_edge),
                0 if w_edge is None else w_edge.shape[0], int(skip_zero), ptr(w_heads),
                0 if w_heads is None else w_heads.shape[0], H, int(head_dim),
                sched.unit_dest.data_ptr(), sched.unit_dest.shape[0], sched.tasks.data_ptr(),
                n_tasks, sched.zero_runs.data_ptr(), sched.fix.data_ptr(), levels,
                len(sched.fix_levels) - 1, part.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{what}: edge_row_sum kernel launch failed: cudaError {rc}")
    return out
