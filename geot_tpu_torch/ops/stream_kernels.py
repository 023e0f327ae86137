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

_SMEM_LIMIT = 232448  # bytes of shared memory one block may take (H100)
_SMEM_STATIC = 16 * 32 * 16  # the kernel's own: the heavy row's 16 slice sums
_PLAIN_SLOTS = 1 << 21  # slots the plain version gathers at a time


def _bound_fn():
    fn = load_kernel("stream_segment").geot_stream_segment
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, i32, i64, i32, p, p, p, p, i32, i32, i32, p, p, i32, p, i32,
                       p, i32, p, p, i32, p]
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
    for name in ("out_block", "sblock", "items", "heavy", "merges", "empty_windows"):
        _check(getattr(sp, name), name, i32, {"items": 2, "merges": 2}.get(name, 1), dev)
    for name in ("dst3", "srcl3"):
        _check(getattr(sp, name), name, i32, 3, dev)
    if sp.w3 is not None:
        _check(sp.w3, "w3", (torch.float32,), 3, dev)
    T, E, s_tile = sp.num_tiles, sp.e_tile, sp.s_tile
    for name in ("dst3", "srcl3") + (("w3",) if sp.w3 is not None else ()):
        if tuple(getattr(sp, name).shape) != (T, 1, E):
            raise ValueError(f"{name} shape {tuple(getattr(sp, name).shape)} "
                             f"does not match the plan ({T}, 1, {E})")
    if sp.sblock.shape[0] != T:
        raise ValueError("sblock and out_block differ in length")
    if sp.heavy.shape[0] != sp.items.shape[0]:
        raise ValueError("heavy and items differ in length")
    if tuple(out.shape) != (sp.n_blocks * s_tile, x.shape[1]):
        raise ValueError(f"out shape {tuple(out.shape)}, expected "
                         f"({sp.n_blocks * s_tile}, {x.shape[1]})")
    if sp.items.data_ptr() % 16:
        raise ValueError("items must be 16-byte aligned")
    if s_tile < 1 or E < 1 or sp.x_rows < 1:
        raise ValueError("s_tile, e_tile and x_rows must be positive")
    if s_tile * 512 + _SMEM_STATIC > _SMEM_LIMIT:
        raise ValueError(f"s_tile={s_tile}: the window's sum needs {s_tile * 512} bytes "
                         f"of shared memory, more than {_SMEM_LIMIT - _SMEM_STATIC}")
    n_items, n_merges = sp.items.shape[0], sp.merges.shape[0]
    n_empty = 0 if accumulate else sp.empty_windows.shape[0]
    f_pad = -(-x.shape[1] // 128) * 128
    part = torch.empty(max(sp.n_parts, 1) * s_tile * f_pad if n_merges else 4,
                       dtype=torch.float32, device=dev)
    fn = _bound_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0], x.shape[1],
            sp.dst3.data_ptr(), sp.srcl3.data_ptr(),
            None if sp.w3 is None else sp.w3.data_ptr(), sp.sblock.data_ptr(),
            E, s_tile, sp.x_rows, sp.items.data_ptr(), sp.heavy.data_ptr(), n_items,
            sp.merges.data_ptr(), n_merges, sp.empty_windows.data_ptr(), n_empty,
            out.data_ptr(), part.data_ptr(), int(accumulate), stream,
        )
    if rc != 0:
        raise RuntimeError(f"stream_segment kernel launch failed: cudaError {rc}")


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
