"""BAT SDDMM: the CUDA kernel's wrapper and its plain version.

Replaces `sddmm_bat` / `_sddmm_bat_kernel` of the JAX package
(`geot_tpu/ops/pallas_segment.py:1010-1100`). The kernel is
`ops/csrc/sddmm_bat.cu`, built by nvcc for sm_90a and called through
ctypes (see that file for its design and bound). For a tensor on the CPU
the wrapper runs `sddmm_bat_plain`; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from geot_tpu_torch.graph.plan import BatPlan
from geot_tpu_torch.ops._build import load_kernel

__all__ = ["sddmm_bat", "sddmm_bat_plain"]

_KERNEL_COLS = 128  # columns one CUDA block covers (32 lanes x float4)


def _check(t: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, a on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bound_fn():
    fn = load_kernel("sddmm_bat").geot_sddmm_bat
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, i64, p, i64, i32, p, i32, p, p, i32, i32, i32, p, p]
        fn.restype = ctypes.c_int
    return fn


def sddmm_bat_plain(
    bp: BatPlan, a: torch.Tensor, b_vals: torch.Tensor, f_tile: int = 128
) -> torch.Tensor:
    """Plain-torch BAT SDDMM, computed as the TPU kernel does: for each
    tile t, the dots <a[dst_e], b_vals[e]> of the edges e of value block
    vblock[t] whose dst lies in window out_block[t] (0 for every other
    slot), then the per-tile partials summed per value block.
    Rows of `a` or `b_vals` past their ends read as zero.
    Returns [(n_vblocks+1)*e_tile] float32 in edge order. `f_tile` is
    accepted for the kernel's signature and does not change the result."""
    del f_tile
    E, s = bp.e_tile, bp.s_tile
    dev = a.device
    ob = bp.out_block.to(dev).long()
    vb = torch.clamp(bp.vblock.to(dev).long(), max=bp.n_vblocks)
    edges = vb[:, None] * E + torch.arange(E, device=dev)  # [T, E]
    local = bp.dst3.to(dev).reshape(-1)[edges].long() - ob[:, None] * s
    keep = (local >= 0) & (local < s)
    rows_a = (ob[:, None] * s + local)[keep]
    e_idx = edges[keep]
    okr = (rows_a < a.shape[0]) & (e_idx < b_vals.shape[0])
    dots = torch.zeros(e_idx.shape[0], dtype=torch.float32, device=dev)
    dots[okr] = (a[rows_a[okr]].float() * b_vals[e_idx[okr]].float()).sum(dim=1)
    parts = torch.zeros(bp.num_tiles, E, dtype=torch.float32, device=dev)
    parts[keep] = dots
    out = torch.zeros(bp.n_vblocks + 1, E, dtype=torch.float32, device=dev)
    return out.index_add_(0, vb, parts).reshape(-1)


def sddmm_bat(
    bp: BatPlan, a: torch.Tensor, b_vals: torch.Tensor, f_tile: int = 128
) -> torch.Tensor:
    """Per-edge dots over a BAT plan: a [rows_a, F_pad] dst-side rows (the
    plan's windows, padded), b_vals [>= nnz rows, F_pad] src-side rows in
    edge order (F_pad a multiple of f_tile, f_tile a multiple of 128).
    Returns [(n_vblocks+1)*e_tile] float32 in edge order, pads 0.

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    add one to `sddmm_bat.launches`."""
    dev = a.device
    if dev.type == "cpu":
        return sddmm_bat_plain(bp, a, b_vals, f_tile)
    if dev.type != "cuda":
        raise ValueError(f"sddmm_bat: unsupported device {dev}")
    _check(a, "a", torch.float32, 2, dev)
    _check(b_vals, "b_vals", torch.float32, 2, dev)
    _check(bp.dst3, "dst3", torch.int32, 3, dev)
    _check(bp.out_block, "out_block", torch.int32, 1, dev)
    _check(bp.vblock, "vblock", torch.int32, 1, dev)
    F = a.shape[1]
    if b_vals.shape[1] != F:
        raise ValueError(f"a has {F} columns, b_vals {b_vals.shape[1]}")
    if f_tile % _KERNEL_COLS or F % f_tile:
        raise ValueError(f"F_pad={F} must be a multiple of f_tile={f_tile}, "
                         f"itself a multiple of {_KERNEL_COLS}")
    if bp.e_tile % 32:
        raise ValueError(f"e_tile={bp.e_tile} must be a multiple of 32")
    if tuple(bp.dst3.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"dst3 shape {tuple(bp.dst3.shape)} does not match the plan")
    if bp.vblock.shape != bp.out_block.shape:
        raise ValueError("vblock and out_block differ in length")
    if a.data_ptr() % 16 or b_vals.data_ptr() % 16:
        raise ValueError("a and b_vals must be 16-byte aligned")
    out = torch.zeros((bp.n_vblocks + 1) * bp.e_tile, dtype=torch.float32, device=dev)
    fn = _bound_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            a.data_ptr(), a.shape[0], b_vals.data_ptr(), b_vals.shape[0], F,
            bp.dst3.data_ptr(), bp.n_vblocks,
            bp.out_block.data_ptr(), bp.vblock.data_ptr(), bp.num_tiles,
            bp.e_tile, bp.s_tile, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sddmm_bat kernel launch failed: cudaError {rc}")
    sddmm_bat.launches += 1
    return out


sddmm_bat.launches = 0
