"""Plain-torch oracles for the fused gather(-weight)-scatter ops, and the
plain versions of the slot-layout kernels.

Port of `geot_tpu/ops/reference.py:37-143` (`segment_reduce_ref`,
`gather_scatter_ref`, `gather_weight_scatter_ref`, `mh_spmm_ref`,
`sddmm_coo_ref`, `csr_spmm_ref`), and a plain `segment_softmax_ref`. They
share no code with the tiled path, so tests hold that path against them.

max, min and prod run `torch.segment_reduce` over the dst-sorted runs
(indices sorted stably first where they are not): a fixed order with no
atomics, so reruns on the card are bit-identical, where `scatter_reduce_`
would multiply a prod in any order. An empty segment gives 0 for max and
min and 1 for prod, as the reference (`jax.ops.segment_prod`'s identity).
Their gathers add each row's gradient in the same fixed order
(`_GatherRuns`), so a gradient reruns bit-identical too.

`plan_segment_sum_sr_plain`, `plan_segment_sum_sr_packed_plain`,
`plan_segment_sum_pr_plain`, `plan_segment_sum_sr2_plain`,
`plan_segment_sum_packed2_plain` and `plan_segment_sum_mh_plain` compute
what the CUDA kernels of `ops/slot_kernels.py` compute, with the same
arguments, and `bat_segment_sum_packed_plain` what the packed BAT kernel
of `ops/bat_kernels.py` computes (`bat_tiles_plain` is the tile schedule
it shares with the wide BAT kernel's plain version): the CPU path runs
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

from geot_tpu_torch.graph.preprocess import csr_to_coo

__all__ = [
    "segment_reduce_ref",
    "gather_scatter_ref",
    "gather_weight_scatter_ref",
    "mh_spmm_ref",
    "sddmm_coo_ref",
    "segment_softmax_ref",
    "csr_spmm_ref",
    "plan_segment_sum_sr_plain",
    "plan_segment_sum_sr_packed_plain",
    "plan_segment_sum_pr_plain",
    "plan_segment_sum_sr2_plain",
    "plan_segment_sum_packed2_plain",
    "plan_segment_sum_mh_plain",
    "bat_tiles_plain",
    "bat_segment_sum_packed_plain",
]

VALID_REDUCE = ("sum", "mean", "max", "min", "prod")
REF_CHUNK_BYTES = 1 << 30


def _check_reduce(reduce: str) -> None:
    if reduce not in VALID_REDUCE:
        raise ValueError(f"reduce={reduce!r}: one of {VALID_REDUCE}")


def _runs_reduce(vals: torch.Tensor, idx: torch.Tensor, num_segments: int,
                 reduce: str) -> torch.Tensor:
    """max / min / prod of `vals` by in-range int64 `idx` through
    `torch.segment_reduce` over the runs of the stably sorted index; empty
    segments 0 (max, min) or 1 (prod)."""
    if idx.shape[0] > 1 and not bool((idx[1:] >= idx[:-1]).all()):
        order = torch.sort(idx, stable=True).indices
        idx, vals = idx[order], vals[order]
    lengths = torch.bincount(idx, minlength=num_segments)
    out = torch.segment_reduce(vals, reduce, lengths=lengths, axis=0)
    if reduce == "prod":
        return out
    empty = (lengths == 0).reshape((-1,) + (1,) * (vals.dim() - 1))
    return torch.where(empty, torch.zeros_like(out), out)


class _GatherRuns(torch.autograd.Function):
    """rows[idx] along axis 0, whose backward sums each row's gradients
    over the stably sorted runs of idx with `torch.segment_reduce`: a fixed
    order, where index_select's backward adds them with atomics on the
    card."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = rows.shape[0]
        return rows.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        order = torch.sort(idx, stable=True).indices
        lengths = torch.bincount(idx, minlength=ctx.n_rows)
        return torch.segment_reduce(g.index_select(0, order), "sum", lengths=lengths, axis=0,
                                    initial=0.0), None


def segment_reduce_ref(
    src: torch.Tensor, index: torch.Tensor, num_segments: int, reduce: str = "sum"
) -> torch.Tensor:
    """out[index[i]] (+)= src[i] along axis 0, reduce one of VALID_REDUCE,
    the index in any order. Indices outside [0, num_segments) are
    dropped."""
    _check_reduce(reduce)
    index = index.long()
    keep = (index >= 0) & (index < num_segments)
    idx, vals = index[keep], src[keep]
    if reduce in ("max", "min", "prod"):
        return _runs_reduce(vals, idx, num_segments, reduce)
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
    division; max, min and prod gather every edge's row and reduce them by
    `segment_reduce_ref`, as the reference does."""
    _check_reduce(reduce)
    if reduce in ("max", "min", "prod"):
        vals = _GatherRuns.apply(src, src_index.long())
        if weight is not None:
            vals = vals * weight.to(src.dtype).reshape((-1,) + (1,) * (src.dim() - 1))
        return segment_reduce_ref(vals, dst_index, num_segments, reduce)
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


def mh_spmm_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """Multi-head SpMM: src [nodes, H, D], weight [nnz, H] ->
    out[dst[e], h] += weight[e, h] * src[src[e], h]."""
    vals = src.index_select(0, src_index.long()) * weight[:, :, None].to(src.dtype)
    return segment_reduce_ref(vals, dst_index, num_segments, reduce)


def segment_softmax_ref(logits: torch.Tensor, index: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Softmax of per-edge logits [nnz] or [nnz, H] within each segment of
    `index` (any order): the max by `scatter_reduce`, the sums by
    `index_add_`; an empty segment's max is 0."""
    idx = index.long()
    shape = (num_segments,) + tuple(logits.shape[1:])
    full = idx.reshape((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    m = torch.full(shape, float("-inf"), dtype=logits.dtype, device=logits.device)
    m = m.scatter_reduce(0, full, logits.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m.index_select(0, idx))
    s = torch.zeros(shape, dtype=logits.dtype, device=logits.device).index_add(0, idx, e)
    return e / torch.clamp(s, min=1e-16).index_select(0, idx)


def sddmm_coo_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Per-edge dot product: out[e] = <a[dst[e]], b[src[e]]> (the weight
    gradient of gather_weight_scatter)."""
    return (a[dst_index.long()] * b[src_index.long()]).sum(dim=-1)


def csr_spmm_ref(indptr: torch.Tensor, col: torch.Tensor, weight: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """CSR SpMM (`csr_gws` semantics): out[r] = sum over the nonzeros e of
    row r (from the row pointer) of weight[e] * src[col[e]]."""
    row = csr_to_coo(indptr, col.shape[0])
    return gather_weight_scatter_ref(col, row, weight, src, int(indptr.shape[0]) - 1)


def plan_segment_sum_sr_plain(plan, vals: torch.Tensor, w_slots: torch.Tensor, *,
                              src=None) -> torch.Tensor:
    """out[dst_slots[s]] += w_slots[s] * v(s) over the slots s of a slot
    plan with w_slots[s] != 0 (pads have weight 0 and are not read), in
    float32 with `index_add_`. v(s) = vals[s] (slot order, vals [>= T*E,
    F]), or, with `src` (the plan's edge-order src), node rows that slot j
    of tile t reads as vals[src[e0[t] + j]] (rows past the end of vals, and
    edges past src's, read as zero). Returns [n_blocks*s_tile, F] float32,
    every row written."""
    if src is not None:
        return plan_segment_sum_sr2_plain(plan, vals, vals_layout="edge", w_slots=w_slots,
                                          src=src)
    n = plan.num_tiles * plan.e_tile
    dev = vals.device
    w = w_slots.reshape(-1).to(dev).float()
    keep = torch.nonzero(w != 0).reshape(-1)
    v = vals[:n].index_select(0, keep).float() * w[keep][:, None]
    out = torch.zeros(plan.n_blocks * plan.s_tile, vals.shape[1], dtype=torch.float32,
                      device=dev)
    return out.index_add_(0, plan.dst_slots.reshape(-1).to(dev).long()[keep], v)


def plan_segment_sum_sr_packed_plain(plan, vals: torch.Tensor, w_slots: torch.Tensor,
                                     src=None) -> torch.Tensor:
    """`plan_segment_sum_sr_plain` for narrow rows (F <= 64)."""
    if vals.shape[1] > 64:
        raise ValueError(f"packed slot sum takes F <= 64, got {vals.shape[1]}")
    return plan_segment_sum_sr_plain(plan, vals, w_slots, src=src)


def plan_segment_sum_pr_plain(plan, vals: torch.Tensor, w_slots: torch.Tensor, *,
                              src=None) -> torch.Tensor:
    """The transposed layout: vals_slots_t [N, >= T*E] -> [N, n_blocks*s_tile]
    float32, the transpose of `plan_segment_sum_sr_plain` over
    vals_slots_t.T; or, with `src` (the plan's edge-order src), node rows x
    [n, N] read as x[src[e0[t] + j]] (rows past x's end read as zero)."""
    v = vals if src is not None else vals.t()
    return plan_segment_sum_sr_plain(plan, v, w_slots, src=src).t().contiguous()


def _edge_of_slots(plan, dev) -> torch.Tensor:
    """[T*E] int64: the edge slot j of tile t holds where it is real,
    e0[t] + j."""
    e0 = plan.e0.to(dev).long()
    return (e0[:, None] + torch.arange(plan.e_tile, device=dev)).reshape(-1)


def _rows_or_zero(vals: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """vals[row] in float32, zeros where row lies outside vals."""
    inside = (row >= 0) & (row < vals.shape[0])
    v = torch.zeros(row.shape[0], vals.shape[1], dtype=torch.float32, device=vals.device)
    v[inside] = vals.index_select(0, row[inside]).float()
    return v


def _gathered_rows(src: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
    """src[edge] (int64), -1 for an edge past src's end."""
    src = src.to(edge.device).long()
    inside = edge < src.shape[0]
    return torch.where(inside, src[torch.clamp(edge, max=max(src.shape[0] - 1, 0))],
                       torch.full_like(edge, -1))


def plan_segment_sum_sr2_plain(plan, vals: torch.Tensor, *, vals_layout: str = "slot",
                               w_slots=None, w_edge=None, e_base: int = 0,
                               src=None) -> torch.Tensor:
    """out[dst_slots[s]] += w(s) * v(s) over the slots s of a slot plan
    with w(s) != 0, in float32 with `index_add_`. v(s) = vals[s] (slot
    order, vals [>= T*E, F]) or vals[e0[t] + j - e_base] for slot j of
    tile t (edge order; rows past the end of vals read as zero), or, with
    `src` (edge order), vals[src[e0[t] + j]] (rows past the end of vals,
    and edges past the end of src, read as zero). w(s) = w_slots[s]
    (default the plan's mask; 0 on pads), times w_edge[e0[t] + j] where
    per-call edge-order weights are given (read only where w_slots is not
    0). Returns [n_blocks*s_tile, F] float32, every row written."""
    if vals_layout not in ("slot", "edge"):
        raise ValueError(f"vals_layout={vals_layout!r}: 'slot' or 'edge'")
    if src is not None and vals_layout != "edge":
        raise ValueError("gathered values (src) are read in edge order: vals_layout='edge'")
    dev = vals.device
    ws = plan.mask if w_slots is None else w_slots
    w = ws.reshape(-1).to(dev).float()
    keep = torch.nonzero(w != 0).reshape(-1)
    wk = w[keep]
    edge = None
    if w_edge is not None or vals_layout == "edge":
        edge = _edge_of_slots(plan, dev)[keep]
    if w_edge is not None:
        we = w_edge.to(dev).float()
        inside = edge < we.shape[0]
        wk = wk * torch.where(inside, we[torch.clamp(edge, max=max(we.shape[0] - 1, 0))],
                              torch.zeros_like(wk))
        live = wk != 0
        keep, wk, edge = keep[live], wk[live], edge[live]
    F = vals.shape[1]
    out = torch.zeros(plan.n_blocks * plan.s_tile, F, dtype=torch.float32, device=dev)
    if vals_layout == "slot":
        v = vals[: plan.num_tiles * plan.e_tile].index_select(0, keep).float()
    elif src is not None:
        v = _rows_or_zero(vals, _gathered_rows(src, edge))
    else:
        v = _rows_or_zero(vals, edge - int(e_base))
    return out.index_add_(0, plan.dst_slots.reshape(-1).to(dev).long()[keep], v * wk[:, None])


def plan_segment_sum_packed2_plain(plan, vals_edges: torch.Tensor, *, w_slots=None,
                                   w_edge=None, e_base: int = 0, src=None) -> torch.Tensor:
    """`plan_segment_sum_sr2_plain` over edge-order (or, with `src`,
    gathered) values for narrow rows (F <= 64)."""
    if vals_edges.shape[1] > 64:
        raise ValueError(f"packed2 takes F <= 64, got {vals_edges.shape[1]}")
    return plan_segment_sum_sr2_plain(plan, vals_edges, vals_layout="edge", w_slots=w_slots,
                                      w_edge=w_edge, e_base=e_base, src=src)


def plan_segment_sum_mh_plain(plan, vals: torch.Tensor, w_heads: torch.Tensor,
                              head_dim: int, *, src=None) -> torch.Tensor:
    """Multi-head slot sum over flat lanes: out[dst_slots[s], c] +=
    w(s, c // head_dim) * v(s, c) over the real slots s with any head's
    weight not 0; columns past H heads are inert, and pad slots weigh 0
    whatever they name. v(s) = vals[s] with w = w_heads [T*E, H] (slot
    order), or, with `src` (the plan's edge-order src), node rows that slot
    j of tile t reads as vals[src[e]], e = e0[t] + j, with w = w_heads[e]
    ([nnz, H], the plan's edge order; rows past the end of vals or of
    w_heads, and edges past src's, read as zero). Returns
    [n_blocks*s_tile, F] float32, every row written."""
    dev = vals.device
    n = plan.num_tiles * plan.e_tile
    real = plan.mask.reshape(-1).to(dev) != 0
    if src is None:
        wh = w_heads.reshape(n, -1).to(dev).float()
    else:
        edge = _edge_of_slots(plan, dev)
        whe = w_heads.to(dev).float()
        wh = torch.zeros(n, whe.shape[1], dtype=torch.float32, device=dev)
        inside = real & (edge < whe.shape[0])
        wh[inside] = whe[edge[inside]]
    H, F = wh.shape[1], vals.shape[1]
    keep = torch.nonzero(real & (wh != 0).any(dim=1)).reshape(-1)
    head = torch.arange(F, device=dev) // head_dim
    lane_w = torch.zeros(keep.shape[0], F, dtype=torch.float32, device=dev)
    in_heads = head < H
    lane_w[:, in_heads] = wh[keep][:, head[in_heads]]
    if src is None:
        v = vals[:n].index_select(0, keep).float()
    else:
        v = _rows_or_zero(vals, _gathered_rows(src, edge[keep]))
    out = torch.zeros(plan.n_blocks * plan.s_tile, F, dtype=torch.float32, device=dev)
    return out.index_add_(0, plan.dst_slots.reshape(-1).to(dev).long()[keep], v * lane_w)


def bat_tiles_plain(bp, dst_blocks: torch.Tensor, vals: torch.Tensor,
                    w_edge=None, src=None) -> torch.Tensor:
    """The BAT kernels' function over a plan's tiles, in float32 with
    `index_add_`: for each tile t, sum w[e] * v(e) over the edges e =
    vblock[t]*E + j of its value block whose dst `dst_blocks[vblock[t],
    j]` lies in window out_block[t], into that row. dst_blocks [n_vblocks
    + 1, E] holds each block's dst ids in edge order (-1 pads add
    nothing). v(e) = vals[e], or vals[src[e]] given `src` (gathered); a
    row past the end of vals, or an edge past src's, reads as zero, and
    weights e >= len(w_edge) as zero. Returns [n_blocks*s_tile, F]
    float32, every row written (empty rows 0)."""
    E, s = bp.e_tile, bp.s_tile
    dev = vals.device
    ob = bp.out_block.to(dev).long()
    vb = bp.vblock.to(dev).long()
    edges = vb[:, None] * E + torch.arange(E, device=dev)
    local = dst_blocks.to(dev)[vb].long() - ob[:, None] * s
    keep = (local >= 0) & (local < s)
    e_idx = edges[keep]
    rows = (ob[:, None] * s + local)[keep]
    v = _rows_or_zero(vals, e_idx if src is None else _gathered_rows(src, e_idx))
    if w_edge is not None:
        we = torch.zeros(e_idx.shape[0], dtype=torch.float32, device=dev)
        okw = e_idx < w_edge.shape[0]
        we[okw] = w_edge.to(dev).float()[e_idx[okw]]
        v = v * we[:, None]
    out = torch.zeros(bp.n_blocks * s, vals.shape[1], dtype=torch.float32, device=dev)
    return out.index_add_(0, rows, v)


def bat_segment_sum_packed_plain(bp, vals: torch.Tensor, w_edge=None, src=None) -> torch.Tensor:
    """The packed BAT kernel's function (`bat_segment_sum_packed`): the BAT
    tile sum of `bat_tiles_plain` with each block's dst ids read from the
    k-major `bp.dst_km`, edge r*P + k of a block at lane k*(E // P) + r (P
    = bp.km_pack). vals [rows, F] edge order (or node rows gathered through
    `src`), F = 128 // P (8, 16, 32 or 64); w_edge [n_w] or None. Returns
    [n_blocks*s_tile, F] float32."""
    P, E = bp.km_pack, bp.e_tile
    if bp.dst_km is None or P < 2:
        raise ValueError("bat_segment_sum_packed needs a packed plan (km_pack > 1, dst_km)")
    if vals.shape[1] * P != 128:
        raise ValueError(f"packed width {vals.shape[1]} does not match km_pack {P}")
    nb = bp.dst_km.shape[0]
    dst_blocks = bp.dst_km.reshape(nb, P, E // P).transpose(1, 2).reshape(nb, E)
    return bat_tiles_plain(bp, dst_blocks, vals, w_edge, src=src)
