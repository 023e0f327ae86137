"""Slot-layout segment sums: the CUDA kernels' wrappers.

Replace `plan_segment_sum_sr`, `plan_segment_sum_sr_packed`,
`plan_segment_sum_pr`, `plan_segment_sum_sr2`, `plan_segment_sum_packed2`
and `plan_segment_sum_mh` of the JAX package
(`geot_tpu/ops/pallas_segment.py:1302`, `:233`, `:1348`, `:384`, `:581`,
`:1391`). The kernels are `ops/csrc/slot_segment_sum.cu` (pr: the
transposed sum over the plan's `RowSchedule`, lanes over its slots) and
`edge_row_sum.cu` (sr, sr_packed, sr2, packed2 and mh: one row-ordered
edge sum over the same schedule, values in edge or slot order or
gathered in the kernel as x[src[e]], with one weight per edge or, for mh,
one per edge and head), built by nvcc for sm_90a and called through ctypes
(see those files for their design and bound); their plain versions are in
`ops/reference.py`. For tensors on the CPU a wrapper runs its plain
version; for CUDA tensors it launches its kernel or raises. Each returns
float32 and reads F columns as they are (no lane padding).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from geot_tpu_torch.graph.plan import SegmentPlan, row_schedule_of
from geot_tpu_torch.ops._build import load_kernel
from geot_tpu_torch.ops.edge_row_kernels import edge_row_sum
from geot_tpu_torch.ops.reference import (
    plan_segment_sum_mh_plain,
    plan_segment_sum_packed2_plain,
    plan_segment_sum_pr_plain,
    plan_segment_sum_sr2_plain,
    plan_segment_sum_sr_packed_plain,
    plan_segment_sum_sr_plain,
)

__all__ = [
    "plan_segment_sum_sr",
    "plan_segment_sum_sr_packed",
    "plan_segment_sum_pr",
    "plan_segment_sum_sr2",
    "plan_segment_sum_packed2",
    "plan_segment_sum_mh",
]

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# pr's launch: vals, ld_in, n_rows, N, src, n_src, cols, slot, w, unit_dest,
# tasks, n_tasks, zero_runs, fix, fix_levels (host), n_levels, part, out_t,
# n_out, stream
_PR_ARGS = [_P, _I64, _I64, _I32, _P, _I64, _P, _P, _P, _P, _P, _I32, _P, _P,
            ctypes.POINTER(ctypes.c_int), _I32, _P, _P, _I64, _P]


def _bound(name: str):
    fn = getattr(load_kernel("slot_segment_sum"), name)
    if fn.argtypes is None:
        fn.argtypes = _PR_ARGS if name == "geot_plan_segment_sum_pr" else []
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _pr_max_rows() -> int:
    return _bound("geot_pr_max_rows")()


@functools.lru_cache(maxsize=64)
def _host_ints(values: tuple):
    """A schedule's fix-up level bounds as the C int array the launch takes
    (made once per schedule, not per call)."""
    return (ctypes.c_int * len(values))(*values)


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the values on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(vals: torch.Tensor, what: str) -> str:
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {vals.device}")
    return vals.device.type


def plan_segment_sum_sr(plan: SegmentPlan, vals: torch.Tensor, w_slots: torch.Tensor, *,
                        src=None) -> torch.Tensor:
    """Slot-layout segment sum at any width F: values in slot order (vals
    [>= T*E, F], the TPU kernel's contract), or, with `src` [nnz] int32
    (the plan's edge-order src: `Graph.src` for `plan`, `Graph.dst_t` for
    `plan_t`), node rows x that slot j of tile t reads as x[src[e0[t] +
    j]] (rows past x's end read as zero); weights w_slots [T, E] (0 on
    pads). A slot of weight 0 adds nothing. -> [n_blocks*s_tile, F]
    float32.

    CPU tensors run `plan_segment_sum_sr_plain`; CUDA tensors launch the
    edge-row kernel (`ops/csrc/edge_row_sum.cu`, over the plan's
    `row_sched`, the whole plan in one launch, chunked or not) and add one
    to `plan_segment_sum_sr.launches`."""
    if _device_of(vals, "plan_segment_sum_sr") == "cpu":
        return plan_segment_sum_sr_plain(plan, vals, w_slots, src=src)
    out = _row_sum("plan_segment_sum_sr", plan, vals, "slot" if src is None else "edge",
                   w_slots, None, 0, src)
    plan_segment_sum_sr.launches += 1
    return out


def plan_segment_sum_sr_packed(plan: SegmentPlan, vals: torch.Tensor, w_slots: torch.Tensor,
                               *, src=None) -> torch.Tensor:
    """`plan_segment_sum_sr` for narrow rows, 1 <= F <= 64: values in slot
    order (vals [>= T*E, F], the TPU kernel's contract), or, with `src`
    [nnz] int32 (the plan's edge-order src: `Graph.src` for `plan`,
    `Graph.dst_t` for `plan_t`), node rows x that slot j of tile t reads
    as x[src[e0[t] + j]]; weights w_slots [T, E] (0 on pads). A slot of
    weight 0 adds nothing. -> [n_blocks*s_tile, F] float32.

    CPU tensors run `plan_segment_sum_sr_packed_plain`; CUDA tensors
    launch the edge-row kernel (`ops/csrc/edge_row_sum.cu`, over the
    plan's `row_sched`, the whole plan in one launch) and add one to
    `plan_segment_sum_sr_packed.launches`."""
    if _device_of(vals, "plan_segment_sum_sr_packed") == "cpu":
        return plan_segment_sum_sr_packed_plain(plan, vals, w_slots, src=src)
    F = vals.shape[1]
    if not 1 <= F <= 64:
        raise ValueError(f"plan_segment_sum_sr_packed takes 1 <= F <= 64, got {F}")
    out = _row_sum("plan_segment_sum_sr_packed", plan, vals,
                   "slot" if src is None else "edge", w_slots, None, 0, src)
    plan_segment_sum_sr_packed.launches += 1
    return out


def plan_segment_sum_pr(plan: SegmentPlan, vals: torch.Tensor, w_slots: torch.Tensor, *,
                        src=None) -> torch.Tensor:
    """The transposed layout (a row's slots on the contiguous axis): values
    in slot order, vals_slots_t [N, T*E] (the TPU kernel's contract), or,
    with `src` [nnz] int32 (the plan's edge-order src: `Graph.src` for
    `plan`, `Graph.dst_t` for `plan_t`), node rows x [n, N] that slot j of
    tile t reads as x[src[e0[t] + j]] (rows past x's end read as zero);
    weights w_slots [T, E] (0 on pads). A slot of weight 0 adds nothing. ->
    out_t [N, n_blocks*s_tile] float32.

    CPU tensors run `plan_segment_sum_pr_plain`; CUDA tensors launch the
    kernel (`ops/csrc/slot_segment_sum.cu`, over the plan's `row_sched`,
    the whole plan in one launch, chunked or not) and add one to
    `plan_segment_sum_pr.launches`."""
    if _device_of(vals, "plan_segment_sum_pr") == "cpu":
        return plan_segment_sum_pr_plain(plan, vals, w_slots, src=src)
    dev = vals.device
    T, E = plan.num_tiles, plan.e_tile
    if vals.dtype != torch.float32 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("plan_segment_sum_pr: values must be a contiguous 2-D float32 "
                         f"tensor, got {vals.dtype} {tuple(vals.shape)}")
    if src is None:
        N, ld = vals.shape
        if ld != T * E:
            raise ValueError(f"vals_slots_t has {ld} columns, the plan {T * E} slots")
    else:
        _check(src, "src", torch.int32, (src.shape[0],), dev)
        N, ld = vals.shape[1], 0
    if not 1 <= N <= _pr_max_rows():
        raise ValueError(f"plan_segment_sum_pr: N={N} rows, 1 to {_pr_max_rows()}")
    _check(w_slots, "w_slots", torch.float32, (T, E), dev)
    if plan.e0 is None:
        raise ValueError("plan_segment_sum_pr: the plan carries no e0")
    sched = row_schedule_of(plan)
    if sched.cols.device != dev:
        raise ValueError(f"plan_segment_sum_pr: the plan is on {sched.cols.device}, the values "
                         f"on {dev}")
    if sched.slot is None or sched.fix_levels[-1] != sched.fix.shape[0]:
        raise ValueError("plan_segment_sum_pr: a malformed schedule")
    out = torch.empty(N, sched.n_out, dtype=torch.float32, device=dev)
    part = torch.empty(max(sched.n_parts, 1) * N, dtype=torch.float32, device=dev)
    levels = _host_ints(tuple(sched.fix_levels))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bound("geot_plan_segment_sum_pr")(
            vals.data_ptr(), ld, vals.shape[0], N, None if src is None else src.data_ptr(),
            0 if src is None else src.shape[0], sched.cols.data_ptr(), sched.slot.data_ptr(),
            w_slots.data_ptr(), sched.unit_dest.data_ptr(), sched.tasks.data_ptr(),
            sched.tasks.shape[0] - 1, sched.zero_runs.data_ptr(), sched.fix.data_ptr(), levels,
            len(sched.fix_levels) - 1, part.data_ptr(), out.data_ptr(), sched.n_out, stream)
    if rc != 0:
        raise RuntimeError(f"plan_segment_sum_pr kernel launch failed: cudaError {rc}")
    plan_segment_sum_pr.launches += 1
    return out


def _row_sum(name: str, plan: SegmentPlan, vals: torch.Tensor, vals_layout: str, w_slots,
             w_edge, e_base: int, src, w_heads=None, head_dim: int = 0) -> torch.Tensor:
    """Checks the arguments and launches the edge-row kernel over the
    plan's schedule (`row_schedule_of`): sr, sr_packed, sr2, packed2 and mh
    are one kernel on the card, and a chunked plan is one launch."""
    T, E = plan.num_tiles, plan.e_tile
    if vals_layout not in ("slot", "edge"):
        raise ValueError(f"{name}: vals_layout={vals_layout!r}, 'slot' or 'edge'")
    if src is not None and vals_layout != "edge":
        raise ValueError(f"{name}: gathered values (src) are read in edge order: "
                         "vals_layout='edge'")
    if vals_layout == "slot" and vals.shape[0] < T * E:
        raise ValueError(f"{name}: vals has {vals.shape[0]} rows, the plan {T * E} slots")
    if plan.e0 is None:
        raise ValueError(f"{name}: the plan carries no e0")
    if w_slots is not None:
        _check(w_slots, "w_slots", torch.float32, (T, E), vals.device)
        w_slots = w_slots.reshape(-1)
    return edge_row_sum(row_schedule_of(plan), vals, what=name, src=src, e_base=e_base,
                        by_slot=vals_layout == "slot", w_slots=w_slots, w_edge=w_edge,
                        skip_zero=True, w_heads=w_heads, head_dim=head_dim)


def plan_segment_sum_sr2(plan: SegmentPlan, vals: torch.Tensor, *, vals_layout: str = "slot",
                         w_slots=None, w_edge=None, e_base: int = 0,
                         src=None) -> torch.Tensor:
    """Aligned-edge-block slot sum: values in slot order (vals [>= T*E,
    F], `vals_layout="slot"`) or in edge order (slot j of tile t reads row
    e0[t] + j - e_base of vals; rows past its end read as zero), or, with
    `src` [nnz] int32 and `vals_layout="edge"`, gathered: edge e reads row
    src[e] of vals (node rows x; rows past x's end read as zero); weights
    `w_slots` [T, E] (default the plan's mask; 0 on pads) times the
    per-call edge-order `w_edge` [nnz] if given, indexed by the plan's own
    (global) e0. A slot of weight 0 adds nothing. -> [n_blocks*s_tile, F]
    float32.

    CPU tensors run `plan_segment_sum_sr2_plain`; CUDA tensors launch the
    edge-row kernel (`ops/csrc/edge_row_sum.cu`, over the plan's
    `row_sched`: its real slots, pads left out) and add one to
    `plan_segment_sum_sr2.launches`."""
    if _device_of(vals, "plan_segment_sum_sr2") == "cpu":
        return plan_segment_sum_sr2_plain(plan, vals, vals_layout=vals_layout, w_slots=w_slots,
                                          w_edge=w_edge, e_base=e_base, src=src)
    out = _row_sum("plan_segment_sum_sr2", plan, vals, vals_layout, w_slots, w_edge, e_base,
                   src)
    plan_segment_sum_sr2.launches += 1
    return out


def plan_segment_sum_packed2(plan: SegmentPlan, vals_edges: torch.Tensor, *, w_slots=None,
                             w_edge=None, e_base: int = 0, src=None) -> torch.Tensor:
    """`plan_segment_sum_sr2` over edge-order (or, with `src`, gathered)
    values for narrow rows, 1 <= F <= 64, and on the card the same kernel.
    The reference's precondition `plan.pack_align % (128 // F) == 0` (whole
    packed lane rows) is a TPU layout rule; this kernel reads each edge's
    row on its own and does not need it.

    CPU tensors run `plan_segment_sum_packed2_plain`; CUDA tensors launch
    the edge-row kernel and add one to `plan_segment_sum_packed2.launches`."""
    if _device_of(vals_edges, "plan_segment_sum_packed2") == "cpu":
        return plan_segment_sum_packed2_plain(plan, vals_edges, w_slots=w_slots,
                                              w_edge=w_edge, e_base=e_base, src=src)
    F = vals_edges.shape[1]
    if not 1 <= F <= 64:
        raise ValueError(f"plan_segment_sum_packed2 takes 1 <= F <= 64, got {F}")
    out = _row_sum("plan_segment_sum_packed2", plan, vals_edges, "edge", w_slots, w_edge,
                   e_base, src)
    plan_segment_sum_packed2.launches += 1
    return out


def plan_segment_sum_mh(plan: SegmentPlan, vals: torch.Tensor, w_heads: torch.Tensor,
                        head_dim: int, *, src=None) -> torch.Tensor:
    """Multi-head slot sum over flat lanes, column c weighted by head c //
    head_dim (F = H*head_dim or wider: columns past H heads are inert):
    values in slot order (vals [>= T*E, F]) with w_heads [T*E, H] in slot
    order (0 on pads: the TPU kernel's contract), or, with `src` [nnz]
    int32 (the plan's edge-order src), node rows x that slot j of tile t
    reads as x[src[e]], e = e0[t] + j, with w_heads [nnz, H] in the plan's
    edge order (rows past x's or w_heads' end read as zero, and weigh 0). A slot whose H
    weights are all 0 adds nothing; one zero on some heads only adds 0
    there. -> [n_blocks*s_tile, F] float32.

    CPU tensors run `plan_segment_sum_mh_plain`; CUDA tensors launch the
    edge-row kernel (over the plan's `row_sched`, the whole plan in one
    launch, chunked or not) and add one to `plan_segment_sum_mh.launches`."""
    if _device_of(vals, "plan_segment_sum_mh") == "cpu":
        return plan_segment_sum_mh_plain(plan, vals, w_heads, head_dim, src=src)
    if w_heads.dim() != 2 or head_dim < 1:
        raise ValueError(f"plan_segment_sum_mh: w_heads must be [rows, H] and head_dim >= 1, "
                         f"got {tuple(w_heads.shape)} and {head_dim}")
    if src is None:
        _check(w_heads, "w_heads", torch.float32,
               (plan.num_tiles * plan.e_tile, w_heads.shape[1]), vals.device)
    out = _row_sum("plan_segment_sum_mh", plan, vals, "slot" if src is None else "edge", None,
                   None, 0, src, w_heads=w_heads, head_dim=head_dim)
    plan_segment_sum_mh.launches += 1
    return out


plan_segment_sum_sr.launches = 0
plan_segment_sum_sr_packed.launches = 0
plan_segment_sum_pr.launches = 0
plan_segment_sum_sr2.launches = 0
plan_segment_sum_packed2.launches = 0
plan_segment_sum_mh.launches = 0
