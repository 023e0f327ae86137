"""Plain-torch oracles for the fused gather(-weight)-scatter ops, and the
plain versions of the slot-layout kernels.

Port of `geot_tpu/ops/reference.py:37-105` (`segment_reduce_ref` for sum
and mean, `gather_scatter_ref`, `gather_weight_scatter_ref`) and `:117-127`
(`sddmm_coo_ref`). They share no code with the tiled path, so tests hold
that path against them.

`plan_segment_sum_sr_plain`, `plan_segment_sum_sr_packed_plain` and
`plan_segment_sum_pr_plain` compute what the CUDA kernels of
`ops/slot_kernels.py` compute, with the same arguments: the CPU path runs
them, and the tests and `chip_smoke.py` hold the kernels against them.

The fused gathers run over edge chunks of at most REF_CHUNK_BYTES of
gathered rows, in edge order, so the plain path stays within memory at
ogbn-products size (64 M edges x 128 f32 would be a 33 GB gather).
Their backward is written out (chunked too), so autograd keeps no
gathered rows.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

__all__ = [
    "segment_reduce_ref",
    "gather_scatter_ref",
    "gather_weight_scatter_ref",
    "sddmm_coo_ref",
    "plan_segment_sum_sr_plain",
    "plan_segment_sum_sr_packed_plain",
    "plan_segment_sum_pr_plain",
]

VALID_REDUCE = ("sum", "mean")
REF_CHUNK_BYTES = 1 << 30


def segment_reduce_ref(
    src: torch.Tensor, index: torch.Tensor, num_segments: int, reduce: str = "sum"
) -> torch.Tensor:
    """out[index[i]] += src[i] along axis 0 (sum or mean). Indices outside
    [0, num_segments) are dropped."""
    if reduce not in VALID_REDUCE:
        raise NotImplementedError(
            f"reduce={reduce!r}: only sum and mean are ported (ROADMAP A.7)"
        )
    index = index.long()
    keep = (index >= 0) & (index < num_segments)
    idx, vals = index[keep], src[keep]
    out = torch.zeros((num_segments,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    out.index_add_(0, idx, vals)
    if reduce == "mean":
        cnt = torch.zeros(num_segments, dtype=src.dtype, device=src.device)
        cnt.index_add_(0, idx, torch.ones_like(idx, dtype=src.dtype))
        out = out / torch.clamp(cnt, min=1).reshape((-1,) + (1,) * (src.dim() - 1))
    return out


def _scatter_chunks(rows, gather_idx, scatter_idx, weight, num_out, valid):
    """out[scatter_idx[e]] += weight[e] * rows[gather_idx[e]] over the edges
    e with valid[e] (weight None: 1), REF_CHUNK_BYTES of gathered rows at a
    time, in edge order. rows is [N, D]."""
    nnz = gather_idx.shape[0]
    step = max(1, REF_CHUNK_BYTES // max(rows.shape[1] * rows.element_size(), 1))
    out = torch.zeros(num_out, rows.shape[1], dtype=rows.dtype, device=rows.device)
    for e0 in range(0, nnz, step):
        sl = slice(e0, min(nnz, e0 + step))
        ok = valid[sl]
        vals = rows.index_select(0, gather_idx[sl][ok].long())
        if weight is not None:
            vals = vals * weight[sl][ok].to(rows.dtype)[:, None]
        out.index_add_(0, scatter_idx[sl][ok].long(), vals)
    return out


class _GatherScatterRef(torch.autograd.Function):
    """out[dst[e]] += w[e] * src[src[e]] over edge chunks, with an explicit
    backward (also chunked) so that autograd keeps no gathered rows: dsrc
    is the same sum over the transposed edges, dw[e] = <g[dst[e]],
    src[src[e]]>. Edges whose dst lies outside [0, num_segments) add
    nothing. src is [N, D]."""

    @staticmethod
    def forward(ctx, src, weight, src_index, dst_index, num_segments):
        dst = dst_index.long()
        valid = (dst >= 0) & (dst < num_segments)
        want_dw = weight is not None and ctx.needs_input_grad[1]
        ctx.n_src = src.shape[0]
        ctx.save_for_backward(src if want_dw else None, weight, src_index, dst_index, valid)
        return _scatter_chunks(src, src_index, dst_index, weight, num_segments, valid)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        src, weight, src_index, dst_index, valid = ctx.saved_tensors
        dsrc = dw = None
        if ctx.needs_input_grad[0]:
            dsrc = _scatter_chunks(g, dst_index, src_index, weight, ctx.n_src, valid)
        if src is not None:
            dw = torch.zeros(src_index.shape[0], dtype=g.dtype, device=g.device)
            nnz = src_index.shape[0]
            step = max(1, REF_CHUNK_BYTES // max(g.shape[1] * g.element_size(), 1))
            for e0 in range(0, nnz, step):
                sl = slice(e0, min(nnz, e0 + step))
                ok = valid[sl]
                a = g.index_select(0, dst_index[sl][ok].long())
                b = src.index_select(0, src_index[sl][ok].long())
                dw[e0:sl.stop][ok] = (a * b).sum(dim=-1)
            dw = dw.to(weight.dtype)
        return dsrc, dw, None, None, None


def _gather_scatter_chunked(src_index, dst_index, weight, src, num_segments, reduce):
    """The fused gather(-weight)-scatter over edge chunks, then the mean's
    division."""
    if reduce not in VALID_REDUCE:
        raise NotImplementedError(
            f"reduce={reduce!r}: only sum and mean are ported (ROADMAP A.7)"
        )
    shape = src.shape
    out = _GatherScatterRef.apply(src.reshape(shape[0], -1), weight, src_index,
                                  dst_index, num_segments)
    out = out.reshape((num_segments,) + tuple(shape[1:]))
    if reduce == "mean":
        idx = dst_index.long()
        idx = idx[(idx >= 0) & (idx < num_segments)]
        cnt = torch.zeros(num_segments, dtype=src.dtype, device=src.device)
        cnt.index_add_(0, idx, torch.ones_like(idx, dtype=src.dtype))
        out = out / torch.clamp(cnt, min=1).reshape((-1,) + (1,) * (src.dim() - 1))
    return out


def gather_scatter_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """out[dst[e]] += src[src[e]] — unweighted fused SpMM."""
    return _gather_scatter_chunked(src_index, dst_index, None, src, num_segments, reduce)


def gather_weight_scatter_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """out[dst[e]] += weight[e] * src[src[e]]."""
    return _gather_scatter_chunked(src_index, dst_index, weight, src, num_segments, reduce)


def sddmm_coo_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Per-edge dot product: out[e] = <a[dst[e]], b[src[e]]> (the weight
    gradient of gather_weight_scatter)."""
    return (a[dst_index.long()] * b[src_index.long()]).sum(dim=-1)


def plan_segment_sum_sr_plain(plan, vals_slots: torch.Tensor,
                              w_slots: torch.Tensor) -> torch.Tensor:
    """out[dst_slots[s]] += w_slots[s] * vals_slots[s] over the slots s of a
    slot plan with w_slots[s] != 0 (pads have weight 0 and are not read),
    in float32 with `index_add_`. vals_slots [>= T*E, F]; returns
    [n_blocks*s_tile, F] float32, every row written."""
    n = plan.num_tiles * plan.e_tile
    dev = vals_slots.device
    w = w_slots.reshape(-1).to(dev).float()
    keep = torch.nonzero(w != 0).reshape(-1)
    v = vals_slots[:n].index_select(0, keep).float() * w[keep][:, None]
    out = torch.zeros(plan.n_blocks * plan.s_tile, vals_slots.shape[1], dtype=torch.float32,
                      device=dev)
    return out.index_add_(0, plan.dst_slots.reshape(-1).to(dev).long()[keep], v)


def plan_segment_sum_sr_packed_plain(plan, vals_slots: torch.Tensor,
                                     w_slots: torch.Tensor) -> torch.Tensor:
    """`plan_segment_sum_sr_plain` for narrow rows (F <= 64)."""
    if vals_slots.shape[1] > 64:
        raise ValueError(f"packed slot sum takes F <= 64, got {vals_slots.shape[1]}")
    return plan_segment_sum_sr_plain(plan, vals_slots, w_slots)


def plan_segment_sum_pr_plain(plan, vals_slots_t: torch.Tensor,
                              w_slots: torch.Tensor) -> torch.Tensor:
    """The transposed layout: vals_slots_t [N, >= T*E] -> [N, n_blocks*s_tile]
    float32, the transpose of `plan_segment_sum_sr_plain` over
    vals_slots_t.T."""
    return plan_segment_sum_sr_plain(plan, vals_slots_t.t(), w_slots).t().contiguous()
