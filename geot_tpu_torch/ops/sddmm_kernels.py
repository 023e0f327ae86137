"""Per-edge dots (the SDDMM): the CUDA kernel's wrappers and plain versions.

Replaces `sddmm_bat` / `_sddmm_bat_kernel` of the JAX package
(`geot_tpu/ops/pallas_segment.py:1010-1100`), and computes the per-edge,
per-head dots the reference takes in plain XLA (`sddmm_coo_ref`: the
attention gradient of its multi-head SpMM and slot_dyn's weight gradient).
The kernel is `ops/csrc/sddmm_bat.cu` (see that file for its design and
bound), built by nvcc for sm_90a and called through ctypes:

    out[e, h] = sum_d a[dst[e], h*D + d] * b[bidx(e), h*D + d]

with bidx(e) = src[e] (gathered: a and b node rows, both read in the
kernel) or e (b in edge order: the TPU kernel's contract). `sddmm_bat`
runs it over a BAT plan's dst ids and counts its launches under its name;
`edge_dots` takes any dst-sorted edge list and heads and counts under
`edge_dots`. For tensors on the CPU each runs its plain version; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from geot_tpu_torch.graph.plan import BatPlan
from geot_tpu_torch.ops._build import load_kernel
from geot_tpu_torch.ops.reference import REF_CHUNK_BYTES

__all__ = ["sddmm_bat", "sddmm_bat_plain", "edge_dots", "edge_dots_plain"]


def _bound_fn():
    fn = load_kernel("sddmm_bat").geot_edge_dots
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, i64, p, i64, i32, i32, p, i64, p, i64, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, dim: int, dev, what: str) -> None:
    if t.device != dev:
        raise ValueError(f"{what}: {name} is on {t.device}, a on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{what}: {name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _launch(a: torch.Tensor, b: torch.Tensor, dst: torch.Tensor, src: Optional[torch.Tensor],
            head_dim: int, what: str) -> torch.Tensor:
    """Checks what the kernel relies on, launches it on the current stream
    and returns out [len(dst), F // head_dim] float32."""
    dev = a.device
    _check(a, "a", torch.float32, 2, dev, what)
    _check(b, "b", torch.float32, 2, dev, what)
    _check(dst, "dst", torch.int32, 1, dev, what)
    if src is not None:
        _check(src, "src", torch.int32, 1, dev, what)
    F = a.shape[1]
    if b.shape[1] != F:
        raise ValueError(f"{what}: a has {F} columns, b {b.shape[1]}")
    if F < 1 or head_dim < 1 or F % head_dim:
        raise ValueError(f"{what}: {F} columns are not whole heads of {head_dim}")
    n_edges = dst.shape[0]
    out = torch.empty(n_edges, F // head_dim, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bound_fn()(a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0], F, head_dim,
                         dst.data_ptr(), n_edges, None if src is None else src.data_ptr(),
                         0 if src is None else src.shape[0], out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{what}: edge-dot kernel launch failed: cudaError {rc}")
    return out


def _rows_or_zero(t: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """t[row] in float32, zeros where row lies outside t."""
    inside = (row >= 0) & (row < t.shape[0])
    out = torch.zeros(row.shape[0], t.shape[1], dtype=torch.float32, device=t.device)
    out[inside] = t.index_select(0, row[inside]).float()
    return out


def edge_dots_plain(a: torch.Tensor, b: torch.Tensor, dst: torch.Tensor,
                    src: Optional[torch.Tensor] = None,
                    head_dim: Optional[int] = None) -> torch.Tensor:
    """Plain torch `edge_dots`, over edge chunks of at most REF_CHUNK_BYTES
    of gathered rows each: out[e, h] = sum over head h's columns of
    a[dst[e]] * b[bidx(e)] (bidx(e) = src[e], or e without src); 0 where
    dst < 0, and a row outside a or b (or an edge past src's end) reads as
    zero. Returns [len(dst), F // head_dim] float32."""
    F = a.shape[1]
    D = F if head_dim is None else head_dim
    n_edges = dst.shape[0]
    out = torch.empty(n_edges, F // D, dtype=torch.float32, device=a.device)
    step = max(1, REF_CHUNK_BYTES // max(F * 4, 1))
    d_l = dst.to(a.device).long()
    s_l = None if src is None else src.to(a.device).long()
    for e0 in range(0, n_edges, step):
        e1 = min(n_edges, e0 + step)
        d = d_l[e0:e1]
        if s_l is None:
            s = torch.arange(e0, e1, device=a.device)
        else:
            s = torch.full((e1 - e0,), -1, dtype=torch.long, device=a.device)
            k = max(min(s_l.shape[0], e1) - e0, 0)
            s[:k] = s_l[e0:e0 + k]
        va, vb = _rows_or_zero(a, d), _rows_or_zero(b, s)
        out[e0:e1] = (va * vb).reshape(e1 - e0, F // D, D).sum(dim=-1)
    return out


def edge_dots(a: torch.Tensor, b: torch.Tensor, dst: torch.Tensor,
              src: Optional[torch.Tensor] = None,
              head_dim: Optional[int] = None) -> torch.Tensor:
    """Per-edge, per-head dots over a dst-sorted edge list: a [rows_a, F]
    (read at dst[e]), b [rows_b, F] (read at src[e], or at e without src),
    F = H * head_dim (default one head of F) -> [len(dst), H] float32;
    dst < 0 gives 0, rows outside a or b read as zero.

    CPU tensors run `edge_dots_plain`; CUDA tensors launch the kernel
    (`ops/csrc/sddmm_bat.cu`) with dst and src int32 and add one to
    `edge_dots.launches`."""
    if a.device.type == "cpu":
        return edge_dots_plain(a, b, dst, src, head_dim)
    if a.device.type != "cuda":
        raise ValueError(f"edge_dots: unsupported device {a.device}")
    out = _launch(a, b, dst, src, a.shape[1] if head_dim is None else head_dim, "edge_dots")
    edge_dots.launches += 1
    return out


def sddmm_bat_plain(bp: BatPlan, a: torch.Tensor, b_vals: torch.Tensor, f_tile: int = 128,
                    *, src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain-torch BAT SDDMM, computed as the TPU kernel does: for each
    tile t, the dots <a[dst_e], b_vals[e]> of the edges e of value block
    vblock[t] whose dst lies in window out_block[t] (0 for every other
    slot), then the per-tile partials summed per value block. With `src`
    (the graph's edge-order src), b_vals are node rows read as
    b_vals[src[e]] (an edge past src's end reads zero). Rows of `a` or of
    the b side past their ends read as zero. Returns [(n_vblocks+1)*e_tile]
    float32 in edge order. `f_tile` is accepted for the TPU kernel's
    signature and does not change the result."""
    del f_tile
    E, s = bp.e_tile, bp.s_tile
    dev = a.device
    if src is not None:
        b_vals = _rows_or_zero(b_vals, src.to(dev).long())
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


def sddmm_bat(bp: BatPlan, a: torch.Tensor, b_vals: torch.Tensor, f_tile: int = 128, *,
              src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge dots over a BAT plan: a [rows_a, F] dst-side rows (read at
    the edge's dst), b_vals [>= nnz rows, F] src-side rows in edge order
    (the TPU kernel's contract), or, with `src` [nnz] int32 (the graph's
    edge-order src), node rows read as b_vals[src[e]] in the kernel: no
    edge-order gather. Any F; no padding to windows or to f_tile (accepted
    for the TPU kernel's signature). Returns [(n_vblocks+1)*e_tile] float32
    in edge order, pads 0.

    CPU tensors run the plain version; CUDA tensors launch the kernel over
    the plan's dst ids (`dst3`; an edge's dot is the one its tile would
    take, since a plan's real tiles cover each edge once) and add one to
    `sddmm_bat.launches`."""
    dev = a.device
    if dev.type == "cpu":
        return sddmm_bat_plain(bp, a, b_vals, f_tile, src=src)
    if dev.type != "cuda":
        raise ValueError(f"sddmm_bat: unsupported device {dev}")
    if tuple(bp.dst3.shape) != (bp.n_vblocks + 1, 1, bp.e_tile):
        raise ValueError(f"sddmm_bat: dst3 shape {tuple(bp.dst3.shape)} does not match the "
                         "plan")
    out = _launch(a, b_vals, bp.dst3.reshape(-1), src, a.shape[1], "sddmm_bat").reshape(-1)
    sddmm_bat.launches += 1
    return out


sddmm_bat.launches = 0
edge_dots.launches = 0
