"""Streamed cell-tile segment sums: the CUDA kernel's wrappers and their
plain versions.

Replaces `stream_segment_acc` and `stream_segment_sum` / `_stream_kernel`
of the JAX package (`geot_tpu/ops/pallas_segment.py:1103-1299`). Both
wrappers launch one kernel, `ops/csrc/stream_segment.cu`, built by nvcc
for sm_90a and called through ctypes (see that file for its design and
bound): `stream_segment_acc` adds one stream family into a float32 carry
in place, `stream_segment_sum` writes a fresh output. For tensors on the
CPU the wrappers run the plain versions; for CUDA tensors they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from geot_tpu_torch.graph.stream_plan import StreamPlan
from geot_tpu_torch.ops._build import load_kernel

__all__ = [
    "stream_segment_acc",
    "stream_segment_sum",
    "stream_segment_acc_plain",
    "stream_segment_sum_plain",
]

_PLAIN_SLOTS = 1 << 21  # slots the plain version gathers at a time


def _bound_fn():
    fn = load_kernel("stream_segment").geot_stream_segment
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        host_ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [p, i32, i64, i32, p, p, p, p, i32, p, i32, p, host_ints, i32, p, p,
                       i32, p]
        fn.restype = ctypes.c_int
    return fn


def _add_terms_plain(sp: StreamPlan, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out[win*s + d] += w * x[sblock*x_rows + s] over the plan's slots with
    0 <= s < x_rows and 0 <= d < s_tile, in float32 with `index_add_`;
    x rows past the end read as zero. A bounded number of slots at a time,
    tiles in order."""
    T, E, s_tile, x_rows = sp.num_tiles, sp.e_tile, sp.s_tile, sp.x_rows
    dev = x.device
    step = max(1, _PLAIN_SLOTS // max(E, 1))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        ob = sp.out_block[t0:t1].to(dev).long()[:, None]
        sl = sp.srcl3[t0:t1].to(dev).reshape(t1 - t0, E).long()
        local = sp.dst3[t0:t1].to(dev).reshape(t1 - t0, E).long() - ob * s_tile
        keep = (sl >= 0) & (sl < x_rows) & (local >= 0) & (local < s_tile)
        rows = (sp.sblock[t0:t1].to(dev).long()[:, None] * x_rows + sl)[keep]
        ok = rows < x.shape[0]
        v = torch.zeros(rows.shape[0], x.shape[1], dtype=torch.float32, device=dev)
        v[ok] = x[rows[ok]].float()
        if sp.w3 is not None:
            v = v * sp.w3[t0:t1].to(dev).reshape(t1 - t0, E)[keep].float()[:, None]
        out.index_add_(0, (ob * s_tile + local)[keep], v)
    return out


def stream_segment_sum_plain(sp: StreamPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain-torch `stream_segment_sum`: [n_blocks*s_tile, F] float32,
    zeros where no slot adds."""
    out = torch.zeros(sp.n_blocks * sp.s_tile, x.shape[1], dtype=torch.float32,
                      device=x.device)
    return _add_terms_plain(sp, x, out)


def stream_segment_acc_plain(sp: StreamPlan, x: torch.Tensor,
                             carry: torch.Tensor) -> torch.Tensor:
    """Plain-torch `stream_segment_acc`: adds the family's terms into
    `carry` [n_blocks*s_tile, F] float32 in place and returns it."""
    return _add_terms_plain(sp, x, carry)


def _check(t: torch.Tensor, name: str, dtypes, dim: int, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(sp: StreamPlan, x: torch.Tensor, out: torch.Tensor, accumulate: bool) -> None:
    dev = x.device
    i32 = (torch.int32,)
    _check(x, "x", (torch.float32, torch.bfloat16), 2, dev)
    _check(out, "out", (torch.float32,), 2, dev)
    for name, dim in (("cols", 1), ("unit_dest", 1), ("tasks", 2), ("zero_runs", 2),
                      ("fix", 2)):
        _check(getattr(sp, name), name, i32, dim, dev)
    if sp.vals is not None:
        _check(sp.vals, "vals", (torch.float32,), 1, dev)
        if sp.vals.shape != sp.cols.shape:
            raise ValueError("vals and cols differ in length")
    n_tasks = sp.tasks.shape[0] - 1
    if n_tasks < 0 or sp.tasks.shape[1] != 3 or sp.zero_runs.shape[1] != 2 \
            or sp.fix.shape[1] != 3:
        raise ValueError("tasks, zero_runs or fix has the wrong shape")
    if sp.fix_levels[-1] != sp.fix.shape[0]:
        raise ValueError("fix_levels does not cover fix")
    if tuple(out.shape) != (sp.n_blocks * sp.s_tile, x.shape[1]):
        raise ValueError(f"out shape {tuple(out.shape)}, expected "
                         f"({sp.n_blocks * sp.s_tile}, {x.shape[1]})")
    F = x.shape[1]
    part = torch.empty(max(sp.n_parts, 1) * _part_stride(F), dtype=torch.float32,
                       device=dev)
    levels = (ctypes.c_int * len(sp.fix_levels))(*sp.fix_levels)
    fn = _bound_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], F,
            sp.cols.data_ptr(), None if sp.vals is None else sp.vals.data_ptr(),
            sp.unit_dest.data_ptr(), sp.tasks.data_ptr(), n_tasks,
            sp.zero_runs.data_ptr(), sp.unit_dest.shape[0], sp.fix.data_ptr(), levels,
            len(sp.fix_levels) - 1, part.data_ptr(), out.data_ptr(), int(accumulate),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"stream_segment kernel launch failed: cudaError {rc}")


def _part_stride(F: int) -> int:
    """Floats of one partial sum's row: the kernel's lane groups hold 4
    columns a lane, 32 lanes per 128-column slab at F > 64, else 16, 8 or
    4 lanes (F <= 64, 32, 16)."""
    if F > 64:
        return -(-F // 128) * 128
    return 64 if F > 32 else 32 if F > 16 else 16


def stream_segment_acc(sp: StreamPlan, x: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """Add one stream family's sums into `carry` [n_blocks*s_tile, F]
    float32, in place (the reference's output aliases its carry), and
    return it. Windows no tile of the family visits are left as they were.
    x [rows, F] is float32 or bfloat16; rows past its end read as zero.

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    add one to `stream_segment_acc.launches`."""
    dev = x.device
    if dev.type == "cpu":
        return stream_segment_acc_plain(sp, x, carry)
    if dev.type != "cuda":
        raise ValueError(f"stream_segment_acc: unsupported device {dev}")
    _launch(sp, x, carry, accumulate=True)
    stream_segment_acc.launches += 1
    return carry


def stream_segment_sum(sp: StreamPlan, x: torch.Tensor) -> torch.Tensor:
    """One stream family's sums as a fresh [n_blocks*s_tile, F] float32
    output: every window is written, zeros where no tile visits. x
    [rows, F] is float32 or bfloat16; rows past its end read as zero.

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    add one to `stream_segment_sum.launches`."""
    dev = x.device
    if dev.type == "cpu":
        return stream_segment_sum_plain(sp, x)
    if dev.type != "cuda":
        raise ValueError(f"stream_segment_sum: unsupported device {dev}")
    out = torch.empty(sp.n_blocks * sp.s_tile, x.shape[1], dtype=torch.float32,
                      device=dev)
    _launch(sp, x, out, accumulate=False)
    stream_segment_sum.launches += 1
    return out


stream_segment_acc.launches = 0
stream_segment_sum.launches = 0
