"""Fused SpMM, multi-head SpMM, GAT attention and SDDMM over slot, BAT and
hybrid stream+gather plans, with their gradients.

Port of `geot_tpu/ops/api.py` (`_pick_mode` :71, `_chunk_plan` :107,
`_plan_sum_one` :155 and `_plan_sum_gather` :216 (in `_slot_spmm`),
`_aeb_packed_ok` :267, `_aeb_sum` :281, `_bat_sum` :335 (`_bat_row_sum`),
`_slot_spmm` :654,
`_make_gws_static` :675 and `_make_gs` :1008 (one Function), `_spmm_fwd`
:698 (its AEB branches), `_spmm_fwd_bat` :750, `_stream_accum` :778,
`_stream_sum` :825, `_spmm_fwd_hybrid` :845, `_make_spmm_hybrid` :855,
`_make_gs_bat` :875, `_make_gws_bat` :900, `_mh_fwd` :944,
`_bucketed_sum` :530 and `_make_spmm_bucketed` :619 (the bucketed route),
`segment_counts` :981, `_make_gws` :1028, `_make_mh` :1062, `_make_iscat`
:1092 (BatPlan and AEB branches), `_apply_reduce_post` :1159,
`index_scatter` :1170, `gather_scatter` :1217, `gather_weight_scatter`
:1256, `dispatch_path` :1298, `segment_spmm` :1367, `csr_gws` :1449,
`mh_spmm` :1486,
`mh_spmm_transposed` :1510, `gat_attention_spmm` :1562 (its fused route,
`_make_mh_slot` :1523, is the composed one here), `segment_softmax` :1650, `_sddmm_bat_fwd` :1678, `sddmm_coo`
:1704), the slot_static, slot, slot_dyn, BAT, bucketed and hybrid routes,
and the plain route of max, min and prod (`ops.reference`). The BAT
routes at every width (the hybrid remainder's too), the slot routes at
every width (sr, sr_packed, and pr where a plan's mode hint asks for it),
slot_dyn, the multi-head SpMM and both GAT routes hand their sums x and
src (`_bat_row_sum`, `_slot_spmm`, `_aeb_sum`, `_mh_fwd`): the kernels
read x[src[e]] themselves, with no edge-order or slot-order gather, one
launch a plan where the reference gathers (its gather pad,
`_fast_gather_fn`, answers a TPU emitter) and runs chunk by chunk. So do
the SDDMM's route and the per-edge dots of the weight and attention
gradients (`_sddmm_bat_fwd`, `_dots`): both rows read in the kernel.

Each `jax.custom_vjp` is a `torch.autograd.Function`. The backward of a
fused SpMM runs the same kernels over the transpose plan (`plan_t`,
`bat_t`, `hyb_t`); the gradient of per-call edge weights comes from the
SDDMM kernel: `sddmm_bat` over BAT plans, `edge_dots` (the same kernel)
over slot plans, where the reference takes a plain per-edge dot. A gradient is computed only for the inputs
that ask for one. Every op returns its input's dtype and sums in float32,
as the reference's kernels do.

Under a profiler (`utils.trace.span`) `segment_spmm` is the span
"geot.spmm.<route>" (the name `dispatch_path` gives), `mh_spmm`
"geot.mh_spmm", and a segment softmax or GAT's attention from its
per-node terms "geot.softmax" (`models.conv` names the per-node terms'
dots "geot.gat.logits"). Backward
work carries no span: the profiler ties each backward node to the
forward op that made it by its sequence number.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from geot_tpu_torch.graph.plan import BatPlan, BucketedBatPlan, SegmentPlan, packed_width
from geot_tpu_torch.graph.stream_plan import HybridPlan
from geot_tpu_torch.graph.structures import Graph
from geot_tpu_torch.ops import reference as ref
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_packed, bucketed_sum
from geot_tpu_torch.ops.sddmm_kernels import edge_dots, sddmm_bat
from geot_tpu_torch.ops.slot_kernels import (
    plan_segment_sum_mh,
    plan_segment_sum_packed2,
    plan_segment_sum_pr,
    plan_segment_sum_sr,
    plan_segment_sum_sr2,
    plan_segment_sum_sr_packed,
)
from geot_tpu_torch.ops.softmax_kernels import edge_softmax, edge_softmax_grad
from geot_tpu_torch.ops.stream_kernels import stream_segment_acc, stream_segment_sum
from geot_tpu_torch.tuning.heuristics import select_config
from geot_tpu_torch.utils.trace import span

__all__ = [
    "segment_spmm",
    "dispatch_path",
    "segment_counts",
    "gather_scatter",
    "gather_weight_scatter",
    "index_scatter",
    "csr_gws",
    "sddmm_coo",
    "mh_spmm",
    "mh_spmm_transposed",
    "segment_softmax",
    "gat_attention_spmm",
]

BACKENDS = ("auto", "reference")
# gat_attention_spmm's route switch, the reference's value
# (`GEOT_GAT_FUSED_MAX_EDGES`, api.py:1602-1606): a TPU figure, not
# measured on the H100; here both routes are one computation
GAT_FUSED_MAX_EDGES = 8_000_000


def _chunk_plan(plan: SegmentPlan, c) -> SegmentPlan:
    """Slice chunk c = (t0, t1, w0, w1) out of a slot plan; its output rows
    start at window w0. With uniform chunks the output spans
    `chunk_blocks` windows and `num_segments` trims it to the real rows."""
    t0, t1, w0, w1 = c
    s = plan.s_tile
    nb = plan.chunk_blocks or (w1 - w0)
    num_segments = min(max(plan.num_segments - w0 * s, 0), (w1 - w0) * s)

    def cut(t):
        return None if t is None else t[t0:t1]

    return dataclasses.replace(
        plan, src_slots=cut(plan.src_slots), dst_slots=cut(plan.dst_slots) - w0 * s,
        edge_pos=cut(plan.edge_pos), mask=cut(plan.mask),
        out_block=cut(plan.out_block) - w0, e0=cut(plan.e0),
        n_blocks=nb, num_segments=num_segments, chunks=(),
        chunk_blocks=0,
    )


def _pick_mode(n_features: int, plan: SegmentPlan) -> str:
    """"pr" (edges on the contiguous axis) only when the plan's mode hint
    asks for it and the width allows, else "sr" (the reference's rule)."""
    if plan.mode_hint == "pr" and plan.s_tile % 128 == 0 and n_features <= 128:
        return "pr"
    return "sr"


def _slot_spmm(plan: SegmentPlan, x: torch.Tensor, w_slots: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """out[dst_slot] += w_slot * x[src_slot] over the slots; `src` is the
    plan's edge-order src (`Graph.src` for `plan`, `Graph.dst_t` for
    `plan_t`: src_slots holds src[e0[t] + j] at slot j of tile t). With
    w_slots = plan.mask this is the unweighted sum (the reference's
    `_w_slots(plan, None)`). Returns [num_segments, n] float32.

    In mode "sr" the sum takes x and src and reads x[src[e]] in the
    kernel, over the whole plan in one launch, under the name the
    reference would launch: `plan_segment_sum_sr_packed` at n <= 64 (the
    reference's packed width, its lanes dividing e_tile), else
    `plan_segment_sum_sr`. In mode "pr" (where the plan's mode hint asks
    for it) the transposed sum `plan_segment_sum_pr` takes x and src the
    same way, the plan whole, and its [n, rows] result is transposed back
    (a view); the reference gathers [slots, n] and transposes it, chunk by
    chunk."""
    x = x.float().contiguous()
    n = x.shape[1]
    src = src.int().contiguous()
    if _pick_mode(n, plan) == "sr":
        nw = packed_width(n)
        packed = nw and plan.e_tile % (128 // nw) == 0
        fn = plan_segment_sum_sr_packed if packed else plan_segment_sum_sr
        return fn(plan, x, w_slots, src=src)[: plan.num_segments]
    return plan_segment_sum_pr(plan, x, w_slots, src=src)[:, : plan.num_segments].t()


def _aeb_packed_ok(plan: SegmentPlan, n: int) -> int:
    """The reference's choice between its two AEB kernels: the packed lane
    width where it runs `plan_segment_sum_packed2`, else 0 (sr2). n <= 64,
    and the plan's e_tile and pack_align whole multiples of 128 // width
    edges (the TPU's packed lane rows), at least 8 such rows per tile. On
    the card both are one kernel; the rule only names the launch."""
    nw = packed_width(n)
    if not nw or plan.e0 is None:
        return 0
    pack = 128 // nw
    if plan.e_tile % pack or plan.pack_align % pack or plan.e_tile // pack < 8:
        return 0
    return nw


def _aeb_sum(plan: SegmentPlan, vals: torch.Tensor, n: int,
             w_edge: Optional[torch.Tensor] = None,
             src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment sum over the slot plan's edges through the aligned-edge-
    block function, under the name the reference would launch
    (`plan_segment_sum_packed2` where `_aeb_packed_ok`, else
    `plan_segment_sum_sr2` with edge values): values in EDGE order (vals
    [nnz, n] float32, contiguous), or, with `src`, node rows that edge e
    reads as vals[src[e]], in the kernel: no [nnz, n] gather. No slot
    gather and no weight permutation. Weights: the plan's mask, times
    `w_edge` (per call, edge order, float32) if given. Returns
    [num_segments, n] float32.

    A chunked plan is summed whole, in one call: on the card the kernel's
    schedule lists the plan's rows, and its chunks (the TPU's scalar-
    prefetch and VMEM limits) do not apply; the reference runs it chunk
    by chunk and adds the split hub window's halves."""
    if _aeb_packed_ok(plan, n):
        out = plan_segment_sum_packed2(plan, vals, w_edge=w_edge, src=src)
    else:
        out = plan_segment_sum_sr2(plan, vals, vals_layout="edge", w_edge=w_edge, src=src)
    return out[: plan.num_segments]


def _spmm_fwd_slot_dyn(plan: SegmentPlan, x: torch.Tensor, w_edge: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """sum_e w_e * x[src_e] by dst over the slot plan with per-call
    edge-order weights, through the AEB function (`_aeb_sum`), which reads
    x[src[e]] itself. The reference gathers x (in slot order for sr2 where
    its packed lane rows do not fit the plan's pack_align, a TPU layout
    rule that is not carried over). Returns [num_segments, n] float32."""
    x = x.float().contiguous()
    return _aeb_sum(plan, x, x.shape[1], w_edge=w_edge.float().contiguous(),
                    src=src.int().contiguous())


def _bat_packed(bp: BatPlan, n: int) -> int:
    """The packed width where the plan is packed for n features (km_pack ==
    128 // packed_width(n) and `dst_km` set: the reference's test,
    api.py:347-348), for `bat_segment_sum_packed`; else 0, for the wide
    `bat_segment_sum`, which takes n columns as they are."""
    nw = packed_width(n)
    if nw and bp.km_pack == 128 // nw and bp.dst_km is not None:
        return nw
    return 0


def _bat_row_sum(bp: BatPlan, vals: torch.Tensor, w_edge: Optional[torch.Tensor] = None,
                 src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The BAT segment sum of n-column float32 values, in edge order or,
    with `src`, x read as x[src[e]] in the kernel: no edge-order gather,
    the whole plan (chunked or not) in one launch, where the reference
    gathers and runs chunk by chunk (`_bat_sum_scan`, api.py:415). On a
    plan packed for n the values' columns are padded to the packed width
    (`bat_segment_sum_packed`); otherwise the wide `bat_segment_sum` takes
    them as they are (the reference pads them to its 128-lane tile).
    Returns [num_segments, n] float32."""
    n = vals.shape[1]
    nw = _bat_packed(bp, n)
    if nw:
        v = F.pad(vals, (0, nw - n)) if nw != n else vals.contiguous()
        out = bat_segment_sum_packed(bp, v, w_edge, src=src)[:, :n]
    else:
        out = bat_segment_sum(bp, vals.contiguous(), w_edge, src=src)
    return out[: bp.num_segments]


def _spmm_fwd_bat(
    bp: BatPlan, x: torch.Tensor, src: torch.Tensor, w_edge: Optional[torch.Tensor]
) -> torch.Tensor:
    """sum_e w_e * x[src_e] by dst window via the BAT kernels, which read
    x[src[e]] themselves (`_bat_row_sum`). Returns [num_segments, n] float32
    whatever x's dtype (the kernels sum float32; callers cast back)."""
    return _bat_row_sum(bp, x.float(), None if w_edge is None else w_edge.float(),
                        src=src.int().contiguous())


def _stream_sum(plans: tuple, x: torch.Tensor) -> torch.Tensor:
    """Gather-free streaming segment sum over the stream families (weights
    baked into each family's w3). The first family writes a fresh output
    (`stream_segment_sum`, zeros where it visits no window) and the others
    add into it in e_tile order (`stream_segment_acc`); the reference
    starts from a zero carry and adds every family, which sums the same
    terms in the same order. The reference runs each family's uniform
    chunks under `lax.scan` (`_stream_accum`, for its scalar-prefetch
    limit); the CUDA kernel takes a whole family in one launch. x stays
    float32 or bfloat16 (other dtypes go through float32) and needs no
    padding: the kernel reads rows past its end as zero and bounds its
    columns. Returns [num_segments, n] float32."""
    if not plans:
        raise ValueError("_stream_sum: empty stream-family tuple (corrupt HybridPlan?)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    carry = stream_segment_sum(plans[0], x)
    for sp in plans[1:]:
        carry = stream_segment_acc(sp, x, carry)
    return carry[: plans[0].num_segments]


def _spmm_fwd_hybrid(hyb: HybridPlan, x: torch.Tensor) -> torch.Tensor:
    """Streamed cells + BAT+gather remainder; the partial sums add.
    Weights, if any, were baked into both parts when the graph was built.
    Returns [num_segments, n] float32. Spans `geot.spmm.hybrid.stream`
    and `geot.spmm.hybrid.rest` mark the two parts."""
    with span("geot.spmm.hybrid.stream"):
        out = _stream_sum(hyb.stream, x)
    if hyb.rest is not None:
        with span("geot.spmm.hybrid.rest"):
            out += _spmm_fwd_bat(hyb.rest, x, hyb.rest_src, hyb.rest_w)
    return out


def segment_counts(plan) -> torch.Tensor:
    """Edges per segment (in-degree) [num_segments] float32. Over a slot
    plan with s_tile % 128 == 0 (the reference's rule) the pr kernel sums
    ones [1, slots] with the mask as weights, the plan whole (the
    reference sums [8, slots], the TPU's sublanes, chunk by chunk, and
    reads row 0); otherwise, and over a BAT plan, a scatter of the plan's
    dst ids (integer counts, exact in float32)."""
    if isinstance(plan, SegmentPlan):
        if plan.s_tile % 128 == 0:
            ones = torch.ones(1, plan.num_tiles * plan.e_tile, dtype=torch.float32,
                              device=plan.mask.device)
            return plan_segment_sum_pr(plan, ones, plan.mask)[0, : plan.num_segments]
        d, wt = plan.dst_slots.reshape(-1).long(), plan.mask.reshape(-1)
    else:
        d = plan.dst3.reshape(-1).long()
        wt = (d >= 0).float()
    keep = (d >= 0) & (d < plan.num_segments)
    out = torch.zeros(plan.num_segments, dtype=torch.float32, device=d.device)
    return out.index_add_(0, d[keep], wt[keep])


def _sddmm_bat_fwd(
    bp: BatPlan, a: torch.Tensor, b: torch.Tensor, src: torch.Tensor
) -> torch.Tensor:
    """Per-edge dots <a[dst_e], b[src_e]> via `sddmm_bat`, which reads
    a[dst[e]] and b[src[e]] itself: no edge-order gather of b, no padding
    of a to the plan's windows or of either to a lane tile (the reference
    pads and gathers first). Returns [nnz] float32 in edge order."""
    nnz = src.shape[0]
    return sddmm_bat(bp, a.float().contiguous(), b.float().contiguous(),
                     src=src.int().contiguous())[:nnz]


def _dots(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          head_dim: int) -> torch.Tensor:
    """out[e, h] = <a[dst_e], b[src_e]> over head h's head_dim columns (a,
    b [n, F]) -> [nnz, F // head_dim] float32, through `edge_dots`: both
    rows read in the kernel on the card, the plain per-edge dot (the
    reference's `sddmm_coo_ref`) on the CPU."""
    return edge_dots(a.float().contiguous(), b.float().contiguous(), dst.int().contiguous(),
                     src.int().contiguous(), head_dim)


class _SlotSpmm(torch.autograd.Function):
    """Fused SpMM over the slot plans with slot-order weights: the graph's
    static weights (`slot_static`, `_make_gws_static`) or the masks
    (`slot`, unweighted, `_make_gs`). Backward = the same sum over
    `plan_t` with its weights (its edge-order src is dst_t); no weight
    gradient."""

    @staticmethod
    def forward(ctx, x, src, dst_t, plan, plan_t, w_slots, w_slots_t):
        ctx.save_for_backward(dst_t)
        ctx.plan_t, ctx.w_slots_t = plan_t, w_slots_t
        return _slot_spmm(plan, x, w_slots, src).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (dst_t,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _slot_spmm(ctx.plan_t, g, ctx.w_slots_t, dst_t).to(g.dtype)
        return dx, None, None, None, None, None, None


class _GatherScatterBat(torch.autograd.Function):
    """Unweighted fused SpMM over the BAT plan; backward = the same sum
    over the transpose plan (`_make_gs_bat`)."""

    @staticmethod
    def forward(ctx, x, src, dst_t, bat, bat_t):
        ctx.save_for_backward(dst_t)
        ctx.bat_t = bat_t
        return _spmm_fwd_bat(bat, x, src, None).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (dst_t,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _spmm_fwd_bat(ctx.bat_t, g.contiguous(), dst_t, None).to(g.dtype)
        return dx, None, None, None, None


class _SpmmHybrid(torch.autograd.Function):
    """Fused SpMM over the hybrid stream+gather plans, static or no weights
    (`_make_spmm_hybrid`); backward = the same sum over `hyb_t`, no weight
    gradient."""

    @staticmethod
    def forward(ctx, x, hyb, hyb_t):
        ctx.hyb_t = hyb_t
        return _spmm_fwd_hybrid(hyb, x).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _spmm_fwd_hybrid(ctx.hyb_t, g.contiguous()).to(g.dtype)
        return dx, None, None


def _spmm_fwd_bucketed(bb: BucketedBatPlan, x: torch.Tensor) -> torch.Tensor:
    """sum_e w_e * x[src_e] by dst over a bucketed BAT plan (weights baked
    in) through `bucketed_sum`: the edge-row kernel over the whole plan,
    reading x[src[e]] by global ids, where the reference runs chunk by
    chunk over each bucket's row slice of x. Returns [num_segments, n]
    float32."""
    return bucketed_sum(bb, x.float().contiguous())


class _SpmmBucketed(torch.autograd.Function):
    """Fused SpMM over the bucketed BAT plans, the graph's own (baked) or
    no weights (`_make_spmm_bucketed`); backward = the same sum over
    `bat_b_t`, no weight gradient."""

    @staticmethod
    def forward(ctx, x, bb, bb_t):
        ctx.bb_t = bb_t
        return _spmm_fwd_bucketed(bb, x).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _spmm_fwd_bucketed(ctx.bb_t, g).to(g.dtype)
        return dx, None, None


class _GatherWeightScatterBat(torch.autograd.Function):
    """Weighted fused SpMM over the BAT plan (`_make_gws_bat`).

    static_w=True: `w` is a graph constant and `w_t_or_perm` its
    transpose-order copy; no gradient for `w`. static_w=False: per-call
    weights, `w_t_or_perm` is perm_t (transpose weights are w[perm_t]) and
    dw comes from the SDDMM kernel. dx = the weighted sum over `bat_t`."""

    @staticmethod
    def forward(ctx, x, w, src, dst, dst_t, w_t_or_perm, bat, bat_t, static_w):
        ctx.static_w = static_w
        ctx.bat, ctx.bat_t = bat, bat_t
        want_dw = not static_w and ctx.needs_input_grad[1]
        ctx.save_for_backward(x if want_dw else None, w, src, dst, dst_t, w_t_or_perm)
        return _spmm_fwd_bat(bat, x, src, w).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, src, dst, dst_t, w_t_or_perm = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_t = w_t_or_perm if ctx.static_w else w[w_t_or_perm.long()]
            dx = _spmm_fwd_bat(ctx.bat_t, g, dst_t, w_t).to(g.dtype)
        if not ctx.static_w and ctx.needs_input_grad[1]:
            # dw[e] = <g[dst_e], x[src_e]>: the SDDMM kernel
            dw = _sddmm_bat_fwd(ctx.bat, g, x, src).to(w.dtype)
        return dx, dw, None, None, None, None, None, None, None


class _IndexScatterBat(torch.autograd.Function):
    """Sorted segment sum of edge-ordered rows through the BAT kernels (the
    `BatPlan` branch of `_make_iscat`: packed for narrow rows on a plan
    packed for them, else wide); backward dvals = g[index]."""

    @staticmethod
    def forward(ctx, vals, index, plan):
        ctx.save_for_backward(index)
        return _bat_row_sum(plan, vals.float()).to(vals.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        dvals = g.index_select(0, index.long()) if ctx.needs_input_grad[0] else None
        return dvals, None, None


class _SddmmBat(torch.autograd.Function):
    """out[e] = <a[dst_e], b[src_e]> through the SDDMM kernel. Backward:
    da = sum_e g_e b[src_e] by dst (the weighted sum over `bat`) and
    db = sum_e g_e a[dst_e] by src (over `bat_t`, weights g[perm_t])."""

    @staticmethod
    def forward(ctx, a, b, src, dst_t, perm_t, bat, bat_t):
        ctx.save_for_backward(a, b, src, dst_t, perm_t)
        ctx.bat, ctx.bat_t = bat, bat_t
        return _sddmm_bat_fwd(bat, a, b, src)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b, src, dst_t, perm_t = ctx.saved_tensors
        g = g.contiguous().float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _spmm_fwd_bat(ctx.bat, b, src, g).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _spmm_fwd_bat(ctx.bat_t, a, dst_t, g[perm_t.long()]).to(b.dtype)
        return da, db, None, None, None, None, None


class _GatherWeightScatterSlot(torch.autograd.Function):
    """Weighted fused SpMM over the slot plans with per-call edge-order
    weights (`slot_dyn`, `_make_gws`). dx = the weighted sum over `plan_t`
    with slot weights w[edge_pos_t] (sr / sr_packed, which reads
    g[dst_t[e]] itself); dw[e] = <g[dst_e], x[src_e]> by `edge_dots`,
    where the reference takes a plain per-edge dot."""

    @staticmethod
    def forward(ctx, x, w, src, dst, dst_t, plan, plan_t, edge_pos_t):
        ctx.plan_t = plan_t
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w, src, dst, dst_t,
                              edge_pos_t)
        return _spmm_fwd_slot_dyn(plan, x, w, src).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, src, dst, dst_t, edge_pos_t = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            pt = ctx.plan_t
            w_t = pt.mask * w.float().index_select(0, edge_pos_t.reshape(-1)).reshape(
                pt.mask.shape)
            dx = _slot_spmm(pt, g, w_t, dst_t).to(g.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dots(src, dst, g, x, x.shape[1]).reshape(-1).to(w.dtype)
        return dx, dw, None, None, None, None, None, None


class _IndexScatterSlot(torch.autograd.Function):
    """Sorted segment sum of edge-ordered rows through the AEB kernels (the
    `e0` branch of `_make_iscat` over a `SegmentPlan`): no slot gather;
    backward dvals = g[index]."""

    @staticmethod
    def forward(ctx, vals, index, plan):
        ctx.save_for_backward(index)
        v = vals.float().contiguous()
        return _aeb_sum(plan, v, v.shape[1]).to(vals.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        dvals = g.index_select(0, index.long()) if ctx.needs_input_grad[0] else None
        return dvals, None, None


def _apply_reduce_post(out_sum: torch.Tensor, plan, reduce: str,
                       dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean = sum / in-degree, outside the autograd Functions. The degree
    comes from the plan (slot or BAT; callers pass the slot plan when a
    graph has both), or from the dst-sorted edge list `dst` of a graph
    without one."""
    if reduce == "sum":
        return out_sum
    if reduce == "mean":
        if plan is not None:
            deg = segment_counts(plan)
        else:
            deg = torch.bincount(dst.long(), minlength=out_sum.shape[0]).float()
        shape = (-1,) + (1,) * (out_sum.dim() - 1)
        return out_sum / torch.clamp(deg, min=1.0).reshape(shape).to(out_sum.dtype)
    raise ValueError(f"unsupported fused reduce {reduce!r}")


def _plan_of(graph: Graph):
    """The plan a mean's degree comes from: the slot plan, else BAT."""
    return graph.plan if graph.plan is not None else graph.bat


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")


def _bat_of(graph: Graph) -> BatPlan:
    if graph.bat is None:
        raise NotImplementedError("graph has no BAT plan: build it with 'bat' in layouts")
    return graph.bat


def dispatch_path(
    graph: Graph,
    *,
    dynamic_w: bool = False,
    reduce: str = "sum",
    backend: str = "auto",
) -> str:
    """Which implementation `segment_spmm` runs for this (graph, call):
    'hybrid' (stream families + BAT remainder, the graph's own or no
    weights; first whenever the graph has hybrid plans), 'bucketed'
    (bucketed BAT plans, the graph's own or no weights, next where the
    graph has them), 'bat_static' (graph's own weights over BAT),
    'slot_static' (graph's own weights in slot order), 'bat' / 'slot'
    (unweighted), 'bat_dyn' (per-call weights) or 'xla' (the plain
    reference, and every max, min and prod; the name is the reference's).
    The graph's `prefer` (graph or no weights) and `prefer_dyn` (per-call
    weights) choose between BAT and slot where both exist, or the plain
    route ("xla", a tuning table's pick) after the hybrid route. 'slot_dyn'
    (per-call weights over the slot plans, `gather_weight_scatter`'s route
    there) is taken as the reference takes it. Per-call weights never take
    the bucketed route."""
    _check_backend(backend)
    in_sum = reduce in ("sum", "mean")
    if backend == "reference" or not in_sum:
        return "xla"
    if not dynamic_w and graph.hyb is not None:
        return "hybrid"
    if (graph.prefer_dyn if dynamic_w else graph.prefer) == "xla":
        return "xla"
    have_slot = graph.plan is not None
    use_bat = graph.bat is not None
    if not (have_slot or use_bat):
        raise NotImplementedError("graph has neither slot nor BAT plans")
    if not dynamic_w and graph.bat_b is not None:
        return "bucketed"
    if not dynamic_w and graph.edge_weight is not None and use_bat and (
        graph.prefer == "bat" or graph.w_slots is None
    ):
        return "bat_static"
    if not dynamic_w and graph.w_slots is not None:
        return "slot_static"
    if not dynamic_w:
        return "bat" if use_bat and (graph.prefer == "bat" or not have_slot) else "slot"
    if use_bat and (graph.prefer_dyn == "bat" or not have_slot):
        return "bat_dyn"
    return "slot_dyn"


def segment_spmm(
    graph: Graph,
    x: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    *,
    reduce: str = "sum",
    backend: str = "auto",
) -> torch.Tensor:
    """Model-facing fused SpMM over a prebuilt Graph:
    out[d] = reduce over edges (s -> d) of w_e * x[s] (w_e = 1 unweighted).
    `edge_weight` (per call, dst-sorted edge order) overrides the graph's
    static weights. Differentiable in `x` and in a per-call
    `edge_weight`: the backward runs the transpose plan, and dw the SDDMM
    kernel (over BAT) or the plain per-edge dot (over slot plans). reduce
    max, min and prod take the plain route (`dispatch_path` 'xla')."""
    w = edge_weight if edge_weight is not None else graph.edge_weight
    path = dispatch_path(graph, dynamic_w=edge_weight is not None,
                         reduce=reduce, backend=backend)
    with span(f"geot.spmm.{path}"):
        if path == "xla":
            if w is None:
                return ref.gather_scatter_ref(graph.src, graph.dst, x, graph.num_nodes, reduce)
            return ref.gather_weight_scatter_ref(
                graph.src, graph.dst, w, x, graph.num_nodes, reduce
            )
        if path == "hybrid":
            out = _SpmmHybrid.apply(x, graph.hyb, graph.hyb_t)
        elif path == "bucketed":
            out = _SpmmBucketed.apply(x, graph.bat_b, graph.bat_b_t)
        elif path == "slot_static":
            out = _SlotSpmm.apply(x, graph.src, graph.dst_t, graph.plan, graph.plan_t,
                                  graph.w_slots, graph.w_slots_t)
        elif path == "slot":
            out = _SlotSpmm.apply(x, graph.src, graph.dst_t, graph.plan, graph.plan_t,
                                  graph.plan.mask, graph.plan_t.mask)
        elif path == "bat_static":
            out = _GatherWeightScatterBat.apply(
                x, graph.edge_weight, graph.src, graph.dst, graph.dst_t,
                graph.edge_weight_t, graph.bat, graph.bat_t, True,
            )
        elif path == "bat":
            out = _GatherScatterBat.apply(x, graph.src, graph.dst_t, graph.bat, graph.bat_t)
        elif path == "slot_dyn":
            out = _GatherWeightScatterSlot.apply(x, w, graph.src, graph.dst, graph.dst_t,
                                                 graph.plan, graph.plan_t, graph.edge_pos_t)
        else:  # bat_dyn
            out = _GatherWeightScatterBat.apply(
                x, w, graph.src, graph.dst, graph.dst_t, graph.perm_t,
                graph.bat, graph.bat_t, False,
            )
        return _apply_reduce_post(out, _plan_of(graph), reduce, graph.dst)


def index_scatter(
    src: torch.Tensor,
    index: torch.Tensor,
    num_segments: int,
    *,
    reduce: str = "sum",
    sorted: bool = True,
    plan=None,
    backend: str = "auto",
    axis: int = 0,
) -> torch.Tensor:
    """Sorted segment reduction out[index[i]] (+)= src[i] along `axis`.
    With a `BatPlan` or a `SegmentPlan` over `index` (sum or mean) the rows
    stream in edge order through the BAT kernel or the aligned-edge-block
    slot kernels (packed2 for narrow rows on a pack-aligned plan, else
    sr2); otherwise the plain reference runs. As in the reference, a
    tuning table's "xla" pick for op "index_scatter" at this shape takes
    the plain route too (the port's table is its own, and empty until an
    H100 sweep fills it). `sorted` is the reference's hint and changes
    nothing."""
    del sorted
    _check_backend(backend)
    if axis != 0:
        src = src.movedim(axis, 0)
    use_plan = plan is not None and backend == "auto" and reduce in ("sum", "mean")
    if use_plan:
        use_plan = select_config(math.prod(src.shape[1:]), int(src.shape[0]), num_segments,
                                 op="index_scatter").mode != "xla"
    if use_plan:
        if not isinstance(plan, (BatPlan, SegmentPlan)):
            raise TypeError(f"plan must be a BatPlan or a SegmentPlan, got {type(plan)}")
        if num_segments != plan.num_segments:
            raise ValueError(f"num_segments={num_segments} but the plan has "
                             f"{plan.num_segments}")
        shape = src.shape
        fn = _IndexScatterBat if isinstance(plan, BatPlan) else _IndexScatterSlot
        out = fn.apply(src.reshape(shape[0], -1), index, plan)
        out = _apply_reduce_post(out, plan, reduce)
        out = out.reshape((out.shape[0],) + tuple(shape[1:]))
    else:
        out = ref.segment_reduce_ref(src, index, num_segments, reduce)
    if axis != 0:
        out = out.movedim(0, axis)
    return out


def gather_scatter(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    *,
    reduce: str = "sum",
    graph: Optional[Graph] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Unweighted fused SpMM over a dst-sorted COO edge list:
    out[dst[e]] (+)= src[src[e]]. With `graph` (a prebuilt Graph whose
    src/dst are these indices) it runs over the hybrid plans of an
    unweighted graph that has them, else over the BAT plan, else over the
    slot plans, with the transpose-plan backward; otherwise the plain
    reference."""
    _check_backend(backend)
    if (graph is not None and backend == "auto" and reduce in ("sum", "mean")
            and graph.prefer != "xla"):
        if graph.hyb is not None and graph.edge_weight is None:
            out = _SpmmHybrid.apply(src, graph.hyb, graph.hyb_t)
        elif graph.bat is not None or graph.plan is None:
            out = _GatherScatterBat.apply(src, graph.src, graph.dst_t, _bat_of(graph),
                                          graph.bat_t)
        else:
            out = _SlotSpmm.apply(src, graph.src, graph.dst_t, graph.plan, graph.plan_t,
                                  graph.plan.mask, graph.plan_t.mask)
        return _apply_reduce_post(out, _plan_of(graph), reduce, graph.dst)
    return ref.gather_scatter_ref(src_index, dst_index, src, num_segments, reduce)


def gather_weight_scatter(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    *,
    reduce: str = "sum",
    graph: Optional[Graph] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Edge-weighted fused SpMM: out[dst[e]] (+)= weight[e] * src[src[e]].
    With `graph` it runs the route `dispatch_path` picks for per-call
    weights: over the BAT plan (dweight through the SDDMM kernel) or over
    the slot plans (`slot_dyn`, dweight the plain per-edge dot); dsrc over
    the transpose plan."""
    _check_backend(backend)
    if (graph is not None and backend == "auto" and reduce in ("sum", "mean")
            and graph.prefer_dyn != "xla"):
        if dispatch_path(graph, dynamic_w=True) == "slot_dyn":
            out = _GatherWeightScatterSlot.apply(src, weight, graph.src, graph.dst,
                                                 graph.dst_t, graph.plan, graph.plan_t,
                                                 graph.edge_pos_t)
        else:
            out = _GatherWeightScatterBat.apply(
                src, weight, graph.src, graph.dst, graph.dst_t, graph.perm_t,
                _bat_of(graph), graph.bat_t, False,
            )
        return _apply_reduce_post(out, _plan_of(graph), reduce)
    return ref.gather_weight_scatter_ref(
        src_index, dst_index, weight, src, num_segments, reduce
    )


def csr_gws(
    csrptr: torch.Tensor,
    col: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    *,
    num_rows: Optional[int] = None,
    graph: Optional[Graph] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """CSR SpMM out[r] = sum over row r's nonzeros e of weight[e] *
    src[col[e]]. With a prebuilt `graph` (built from this matrix: its
    plans are the schedule) it is `gather_weight_scatter` over the graph's
    plans, and a matrix whose nnz differs from the graph's edges, or whose
    rows exceed its nodes, is refused; otherwise the rows come from the
    row pointer and `csr_spmm_ref` runs."""
    _check_backend(backend)
    if num_rows is None:
        num_rows = int(csrptr.shape[0]) - 1
    if graph is not None and backend == "auto":
        if int(col.shape[0]) != graph.num_edges or num_rows > graph.num_nodes:
            raise ValueError(
                f"csr_gws(graph=...): csr has nnz={int(col.shape[0])}, rows={num_rows} but "
                f"the graph's plan covers nnz={graph.num_edges}, nodes={graph.num_nodes}: "
                "pass the graph the matrix was built from")
        return gather_weight_scatter(col, graph.dst, weight, src, num_rows, graph=graph,
                                     backend=backend)
    return ref.csr_spmm_ref(csrptr, col, weight, src)


def sddmm_coo(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    graph: Optional[Graph] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Per-edge dot product out[e] = <a[dst[e]], b[src[e]]>. With a graph
    that has a BAT plan (and whose src/dst are these indices) the SDDMM
    kernel runs, reading a[dst[e]] and b[src[e]] itself; its gradients are the weighted sums over `bat` and `bat_t`. The
    reference's width gate (b.shape[1] >= 64) is a TPU measurement and is
    not carried over, nor is its bound on the edge-order gather
    (`GEOT_SDDMM_MAX_BYTES`): the kernel gathers nothing."""
    _check_backend(backend)
    if graph is not None and graph.bat is not None and backend == "auto":
        if src_index.shape[0] != graph.num_edges:
            raise ValueError("src_index does not match the graph's edges")
        return _SddmmBat.apply(a, b, graph.src, graph.dst_t, graph.perm_t,
                               graph.bat, graph.bat_t)
    return ref.sddmm_coo_ref(src_index, dst_index, a, b)


def _mh_fwd(plan: SegmentPlan, x: torch.Tensor, w_heads: torch.Tensor,
            src: torch.Tensor) -> torch.Tensor:
    """x [nodes, H, D], w_heads [nnz, H] in the plan's edge order, src the
    plan's edge-order src (`Graph.src` for `plan`, `Graph.dst_t` for
    `plan_t`) -> [num_segments, H, D] float32 through `plan_segment_sum_mh`,
    which reads x[src[e]] and w_heads[e] in the kernel: no slot gather and
    no weight placement, the whole plan in one launch where the reference
    runs it chunk by chunk over a [slots, H*D] gather. The reference pads
    H*D past 128 to its lane tile; the kernel reads H*D columns as they
    are."""
    n_nodes, H, D = x.shape
    out = plan_segment_sum_mh(plan, x.reshape(n_nodes, H * D).float().contiguous(),
                              w_heads.float().contiguous(), D, src=src.int().contiguous())
    return out[: plan.num_segments].reshape(plan.num_segments, H, D)


class _MhSpmm(torch.autograd.Function):
    """Multi-head SpMM over the slot plans (`_make_mh`). Backward: dx = the
    same sum over `plan_t` with weights w[perm_t]; dw[e, h] = <g[dst_e, h],
    x[src_e, h]>, the per-head dot in edge order (`edge_dots`, both rows
    read in the kernel). Both run in a fixed order with no atomics, so
    reruns are bit-identical."""

    @staticmethod
    def forward(ctx, x, w, src, dst, dst_t, plan, plan_t, perm_t):
        ctx.plan_t = plan_t
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w, src, dst, dst_t,
                              perm_t)
        return _mh_fwd(plan, x, w, src).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, src, dst, dst_t, perm_t = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mh_fwd(ctx.plan_t, g, w.index_select(0, perm_t.long()), dst_t).to(g.dtype)
        if ctx.needs_input_grad[1]:
            n, H, D = x.shape
            dw = _dots(src, dst, g.reshape(g.shape[0], H * D), x.reshape(n, H * D),
                       D).to(w.dtype)
        return dx, dw, None, None, None, None, None, None


def mh_spmm(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    *,
    reduce: str = "sum",
    graph: Optional[Graph] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Multi-head SpMM for GAT-style attention: src [nodes, H, D], weight
    [nnz, H] (edge-major, dst-sorted) -> out[dst[e], h] += weight[e, h] *
    src[src[e], h]. With `graph` (whose src/dst are these indices) it runs
    over the graph's slot plans through `plan_segment_sum_mh`, with the
    transpose-plan backward; otherwise the plain reference."""
    if reduce != "sum":
        raise ValueError("mh_spmm supports sum (matching the reference kernel)")
    _check_backend(backend)
    with span("geot.mh_spmm"):
        if graph is not None and backend == "auto":
            if graph.plan is None:
                raise NotImplementedError("mh_spmm over a graph runs on its slot plans: "
                                          "build it with 'slot' in layouts")
            return _MhSpmm.apply(src, weight, graph.src, graph.dst, graph.dst_t, graph.plan,
                                 graph.plan_t, graph.perm_t)
        return ref.mh_spmm_ref(src_index, dst_index, weight, src, num_segments)


def mh_spmm_transposed(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    weight_t: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    **kw,
) -> torch.Tensor:
    """Head-major weights [H, nnz]: `mh_spmm` of weight_t.T."""
    return mh_spmm(src_index, dst_index, weight_t.t(), src, num_segments, **kw)


class _EdgeSoftmax(torch.autograd.Function):
    """The edge softmax over a dst-sorted edge list (`edge_softmax`): of
    per-edge logits, or of GAT's per-node terms (the logits
    leaky_relu(alpha_src[src] + alpha_dst[dst]) made in the kernel).
    `rows` holds the list's index tensors: dst, dst_ptr and src, and for
    alpha_src's gradient perm_t and src_ptr (the backward gathers src_t =
    src[perm_t], the src-sorted keys, for its src pass). Backward: one
    `edge_softmax_grad` call, every sum in a fixed order with no atomics,
    so reruns are bit-identical. Returns float32 (float64 for float64
    inputs on the CPU: `_f32`)."""

    @staticmethod
    def forward(ctx, logits, alpha_src, alpha_dst, rows, slope):
        ctx.rows, ctx.slope = rows, slope
        dst, dst_ptr, src = rows[:3]
        if logits is not None:
            att = edge_softmax(dst, dst_ptr, _f32(logits))
            ctx.save_for_backward(att)
            ctx.dtypes = (logits.dtype,)
        else:
            a_s, a_d = _f32(alpha_src), _f32(alpha_dst)
            att = edge_softmax(dst, dst_ptr, alpha_src=a_s, alpha_dst=a_d, src=src,
                               negative_slope=slope)
            ctx.save_for_backward(att, a_s, a_d)
            ctx.dtypes = (alpha_src.dtype, alpha_dst.dtype)
        return att

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dst, dst_ptr, src, perm_t, src_ptr = ctx.rows
        g = _f32(g)
        if len(ctx.saved_tensors) == 1:  # per-edge logits
            (att,) = ctx.saved_tensors
            gl = edge_softmax_grad(dst, dst_ptr, att, g)
            return gl.to(ctx.dtypes[0]), None, None, None, None
        att, a_s, a_d = ctx.saved_tensors
        src_kw = {}
        if ctx.needs_input_grad[1]:
            src_kw = dict(perm_t=perm_t, src_t=src.index_select(0, perm_t.long()),
                          src_ptr=src_ptr)
        das, dad = edge_softmax_grad(dst, dst_ptr, att, g, alpha_src=a_s, alpha_dst=a_d,
                                     src=src, negative_slope=ctx.slope, **src_kw)
        return (None, None if das is None else das.to(ctx.dtypes[0]),
                dad.to(ctx.dtypes[1]) if ctx.needs_input_grad[2] else None, None, None)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as the edge softmax takes it, contiguous: float32, but float64 on
    the CPU (the plain versions' float64 path). On the card float64 runs
    in float32, as `mh_spmm`'s kernel does."""
    keep = t.dtype == torch.float64 and t.device.type == "cpu"
    return (t if keep else t.float()).contiguous()


def segment_softmax(
    logits: torch.Tensor,
    index: torch.Tensor,
    num_segments: int,
    *,
    indices_are_sorted: bool = True,
) -> torch.Tensor:
    """Softmax of per-edge logits [nnz] or [nnz, H] within each destination
    segment (index values in [0, num_segments)), stabilised by the segment
    max. Sorted indices run the edge softmax (`edge_softmax`: the kernel on
    the card, its plain version on the CPU) over their run boundaries, and
    so does the gradient: no atomics. Unsorted indices are sorted first
    (stably) and the result put back in their order. Returns the logits'
    dtype."""
    if not indices_are_sorted:
        order = torch.argsort(index, stable=True)
        out = torch.empty_like(logits)
        out[order] = segment_softmax(logits[order], index[order], num_segments)
        return out
    with span("geot.softmax"):
        nodes = torch.arange(num_segments + 1, dtype=index.dtype, device=index.device)
        rows = (index.int().contiguous(), torch.searchsorted(index, nodes, out_int32=True),
                None, None, None)
        lg = logits if logits.dim() == 2 else logits[:, None]
        att = _EdgeSoftmax.apply(lg, None, None, rows, 0.0)
        return att.reshape(logits.shape).to(logits.dtype)


def gat_attention_spmm(
    graph: Graph,
    xh: torch.Tensor,
    alpha_src: torch.Tensor,
    alpha_dst: torch.Tensor,
    *,
    negative_slope: float = 0.2,
    backend: str = "auto",
    fused_max_edges: int = GAT_FUSED_MAX_EDGES,
) -> torch.Tensor:
    """GAT attention + multi-head aggregation: out[i, h] = sum over edges
    j -> i of softmax_i(leaky_relu(alpha_src[j, h] + alpha_dst[i, h]))
    * xh[j, h]. xh [nodes, H, D]; alpha_src / alpha_dst [nodes, H].
    Differentiable in all three.

    The attention is taken in edge order by the edge softmax
    (`edge_softmax`: one kernel from the per-node terms to the attention,
    the logits made in it, over the graph's dst runs `dst_ptr`). It is then
    summed with xh by `mh_spmm` over the graph's slot plans: the mh kernel
    reads xh[src[e]] and att[e] itself, over `plan`, and over `plan_t` for
    the xh gradient; the attention's gradient is the per-edge, per-head
    dot <g[dst_e, h], xh[src_e, h]> in edge order. The reference has two
    routes, switched at `fused_max_edges` (its `GEOT_GAT_FUSED_MAX_EDGES`,
    a TPU figure, kept as the reference's keyword with its value): a fused
    one that places the attention into the slot layout and sums a
    [slots, H*D] gather of xh, and the composed one above. Here both are
    this one computation, and the argument only names the route; the
    reference's other switch, the plain aggregation below H*D 64 on its
    composed route, is a TPU measurement and is not carried over.
    backend="reference" runs the plain edge-space softmax and
    `mh_spmm_ref` (edge order, no plan).

    The softmax's backward (`edge_softmax_grad`) sums alpha_dst's gradient
    over the dst runs and alpha_src's over the src-sorted runs (`src_ptr`,
    through `perm_t`), and the sums and dots are in a fixed
    order with no atomics (the reference's fused route added slot
    terms with index_add_, ROADMAP C.12), so every gradient is
    bit-identical across reruns. Pad slots add nothing: the attention
    lives on real edges only (the reference multiplies its slot placement
    by the mask and gives NaN where a pad's logit overflows, C.11)."""
    _check_backend(backend)
    n = graph.num_nodes
    with span("geot.softmax"):
        if backend == "reference":
            logit = F.leaky_relu(alpha_src[graph.src.long()] + alpha_dst[graph.dst.long()],
                                 negative_slope)  # [nnz, H]
            att = ref.segment_softmax_ref(logit, graph.dst, n)
        else:
            rows = (graph.dst, graph.dst_ptr, graph.src, graph.perm_t, graph.src_ptr)
            att = _EdgeSoftmax.apply(None, alpha_src, alpha_dst, rows, negative_slope)
    # backend "reference": mh_spmm's plain route (`mh_spmm_ref`)
    return mh_spmm(graph.src, graph.dst, att.to(xh.dtype), xh, n, graph=graph, backend=backend)
