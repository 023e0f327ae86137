"""Slot-layout segment sums: the CUDA kernels' wrappers.

Replace `plan_segment_sum_sr`, `plan_segment_sum_sr_packed` and
`plan_segment_sum_pr` of the JAX package
(`geot_tpu/ops/pallas_segment.py:1302`, `:233`, `:1348`). The kernels are
`ops/csrc/slot_segment_sum.cu`, built by nvcc for sm_90a and called
through ctypes (see that file for their design and bound); their plain
versions are in `ops/reference.py`. For tensors on the CPU a wrapper runs
its plain version; for CUDA tensors it launches its kernel or raises.
Each returns float32 and reads F columns as they are (no lane padding).
"""

from __future__ import annotations

import ctypes

import torch

from geot_tpu_torch.graph.plan import SegmentPlan
from geot_tpu_torch.ops._build import load_kernel
from geot_tpu_torch.ops.reference import (
    plan_segment_sum_pr_plain,
    plan_segment_sum_sr_packed_plain,
    plan_segment_sum_sr_plain,
)

__all__ = [
    "plan_segment_sum_sr",
    "plan_segment_sum_sr_packed",
    "plan_segment_sum_pr",
]

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "geot_plan_segment_sum_sr": [_P, _I32, _P, _P, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P],
    "geot_plan_segment_sum_sr_packed": [_P, _I32, _P, _P, _P, _I32, _I32, _I32, _I32, _P, _P,
                                        _P, _P],
    "geot_plan_segment_sum_pr": [_P, _I32, _I64, _P, _P, _P, _I32, _I32, _I32, _I32, _P, _P,
                                 _P, _P],
    "geot_slot_scratch_width": [_I32, _I32],
}


def _bound(name: str):
    fn = getattr(load_kernel("slot_segment_sum"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the values on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, plan: SegmentPlan, vals: torch.Tensor, w_slots: torch.Tensor,
            n_cols: int, out: torch.Tensor, ld_in: int, packed: bool) -> None:
    """Checks what the kernels rely on and launches kernel `name`."""
    dev = vals.device
    T, E = plan.num_tiles, plan.e_tile
    if not plan.monotone:
        raise ValueError(f"{name}: out_block is not non-decreasing over the whole plan; "
                         "run its chunks one by one")
    if vals.dtype != torch.float32 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"{name}: values must be a contiguous 2-D float32 tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    _check(w_slots, "w_slots", torch.float32, (T, E), dev)
    _check(plan.dst_slots, "dst_slots", torch.int32, (T, E), dev)
    _check(plan.out_block, "out_block", torch.int32, (T,), dev)
    if T == 0 or E < 1 or plan.s_tile < 1:
        raise ValueError(f"{name}: the plan has no tiles")
    width = _bound("geot_slot_scratch_width")(n_cols, int(packed))
    part_rows = torch.empty(2 * T, dtype=torch.int32, device=dev)
    part_vals = torch.empty(2 * T, width, dtype=torch.float32, device=dev)
    fn = _bound(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [vals.data_ptr(), n_cols]
        if name == "geot_plan_segment_sum_pr":
            args.append(ld_in)
        args += [plan.dst_slots.data_ptr(), w_slots.data_ptr(), plan.out_block.data_ptr(),
                 T, plan.n_blocks, E, plan.s_tile, out.data_ptr(), part_rows.data_ptr(),
                 part_vals.data_ptr(), stream]
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _device_of(vals: torch.Tensor, what: str) -> str:
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {vals.device}")
    return vals.device.type


def plan_segment_sum_sr(plan: SegmentPlan, vals_slots: torch.Tensor,
                        w_slots: torch.Tensor) -> torch.Tensor:
    """Slot-layout segment sum: vals_slots [>= T*E, F] (slot order, any F),
    w_slots [T, E] (0 on pads) -> [n_blocks*s_tile, F] float32.

    CPU tensors run `plan_segment_sum_sr_plain`; CUDA tensors launch the
    kernel and add one to `plan_segment_sum_sr.launches`."""
    if _device_of(vals_slots, "plan_segment_sum_sr") == "cpu":
        return plan_segment_sum_sr_plain(plan, vals_slots, w_slots)
    if vals_slots.shape[0] < plan.num_tiles * plan.e_tile:
        raise ValueError(f"vals_slots has {vals_slots.shape[0]} rows, the plan "
                         f"{plan.num_tiles * plan.e_tile} slots")
    F = vals_slots.shape[1]
    out = torch.empty(plan.n_blocks * plan.s_tile, F, dtype=torch.float32,
                      device=vals_slots.device)
    _launch("geot_plan_segment_sum_sr", plan, vals_slots, w_slots, F, out, 0, False)
    plan_segment_sum_sr.launches += 1
    return out


def plan_segment_sum_sr_packed(plan: SegmentPlan, vals_slots: torch.Tensor,
                               w_slots: torch.Tensor) -> torch.Tensor:
    """`plan_segment_sum_sr` for narrow rows, 1 <= F <= 64: a warp reads
    32 / (F_pad / 4) slots at once (F_pad = 8, 16, 32 or 64).

    CPU tensors run `plan_segment_sum_sr_packed_plain`; CUDA tensors
    launch the kernel and add one to
    `plan_segment_sum_sr_packed.launches`."""
    if _device_of(vals_slots, "plan_segment_sum_sr_packed") == "cpu":
        return plan_segment_sum_sr_packed_plain(plan, vals_slots, w_slots)
    F = vals_slots.shape[1]
    if not 1 <= F <= 64:
        raise ValueError(f"plan_segment_sum_sr_packed takes 1 <= F <= 64, got {F}")
    if vals_slots.shape[0] < plan.num_tiles * plan.e_tile:
        raise ValueError(f"vals_slots has {vals_slots.shape[0]} rows, the plan "
                         f"{plan.num_tiles * plan.e_tile} slots")
    out = torch.empty(plan.n_blocks * plan.s_tile, F, dtype=torch.float32,
                      device=vals_slots.device)
    _launch("geot_plan_segment_sum_sr_packed", plan, vals_slots, w_slots, F, out, 0, True)
    plan_segment_sum_sr_packed.launches += 1
    return out


def plan_segment_sum_pr(plan: SegmentPlan, vals_slots_t: torch.Tensor,
                        w_slots: torch.Tensor) -> torch.Tensor:
    """The transposed layout (edges on the contiguous axis): vals_slots_t
    [N, T*E] -> [N, n_blocks*s_tile] float32.

    CPU tensors run `plan_segment_sum_pr_plain`; CUDA tensors launch the
    kernel and add one to `plan_segment_sum_pr.launches`."""
    if _device_of(vals_slots_t, "plan_segment_sum_pr") == "cpu":
        return plan_segment_sum_pr_plain(plan, vals_slots_t, w_slots)
    N, ld = vals_slots_t.shape
    if ld != plan.num_tiles * plan.e_tile:
        raise ValueError(f"vals_slots_t has {ld} columns, the plan "
                         f"{plan.num_tiles * plan.e_tile} slots")
    out = torch.empty(N, plan.n_blocks * plan.s_tile, dtype=torch.float32,
                      device=vals_slots_t.device)
    _launch("geot_plan_segment_sum_pr", plan, vals_slots_t, w_slots, N, out, ld, True)
    plan_segment_sum_pr.launches += 1
    return out


plan_segment_sum_sr.launches = 0
plan_segment_sum_sr_packed.launches = 0
plan_segment_sum_pr.launches = 0
