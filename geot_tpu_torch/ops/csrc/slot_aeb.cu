// Aligned-edge-block (AEB) slot segment sums for Hopper (sm_90a), plain C
// interface for ctypes. The kernels are in slot_common.cuh.
//
// Replaces two TPU kernels of geot_tpu/ops/pallas_segment.py:
//
//   plan_segment_sum_sr2      (:384, `_sr2_kernel` :323-382, `_aeb_load` :311)
//   plan_segment_sum_packed2  (:581, `_packed2_kernel` :512-579), F 8-64
//
//   out[dst[t*E + j], :] += w(t, j) * v(t, j, :),
//   v(t, j) = vals[t*E + j] (slot order) or vals[e0[t] + j - e_base] (edge
//   order), w(t, j) = w_slots[t*E + j] (static, or the plan's mask) times
//   w_edge[e0[t] + j] when per-call weights are given.
//
// The plan guarantees that slot j of tile t holds edge e0[t] + j wherever
// it is real (mask 1). The TPU kernels load the two e_tile-aligned blocks
// covering [e0[t], e0[t] + e_tile) and roll them into slot alignment in
// VMEM, clamping block indices at the array's end; here each live slot
// reads its edge's row and weight directly, and a slot that is not live
// (a pad, or a weight of 0) is never dereferenced, so nothing past the
// last edge is read. The TPU's k-major layout and strided weight selection
// of packed2 are Mosaic devices and are not carried over: packed2 is the
// same kernel as sr2 over edge-order values, so one entry point serves
// both, with G = F_pad / 4 lanes per slot for F <= 64 and 32 past it.
// Global e0 indexes the whole w_edge, so a chunk of a chunked plan needs no
// rebase; `e_base` places a chunk's slice of edge-order values.
//
// Bound on the H100: bytes. At the flickr GCN's shapes (989,006 edges,
// ~1.09 M slots) F 64 reads ~0.25 GB of values and writes ~23 MB; F 7
// ~0.03 GB: launch latency bounds it.

#include "slot_common.cuh"

// Scratch row width for F columns.
extern "C" int geot_slot_scratch_width(int F, int packed) {
  return slot_scratch_width(F, packed ? lanes_for(F) : 32);
}

// vals: slot order [>= T*E, F] (edge_vals 0) or edge order [n_rows, F]
// whose row 0 is edge e_base (edge_vals 1), f32 row-major, any F. dst int32
// [T*E], w_slots f32 [T*E] (0 on pads), e0 int32 [T], w_edge f32 [n_w] or
// null, out_block int32 [T] non-decreasing -> out [n_windows*s_tile, F]
// f32. Scratch as in slot_segment_sum.cu, of width
// geot_slot_scratch_width(F, 1). Both wrappers, sr2 and packed2, launch
// it: on the card they are one kernel. Returns cudaGetLastError().
extern "C" int geot_plan_segment_sum_aeb(const void* vals, int F, int64_t n_rows,
                                         int edge_vals, int64_t e_base, const void* dst,
                                         const void* w_slots, const void* e0,
                                         const void* w_edge, int64_t n_w,
                                         const void* out_block, int T, int n_windows, int E,
                                         int s_tile, void* out, void* part_rows,
                                         void* part_vals, void* stream) {
  if (e0 == nullptr) return (int)cudaErrorInvalidValue;
  SlotSrc src = slot_order_src(vals, w_slots);
  src.e0 = (const int*)e0;
  src.edge_vals = edge_vals;
  src.e_base = e_base;
  src.n_rows = n_rows;
  src.w_edge = (const float*)w_edge;
  src.n_w = n_w;
  return row_major<kAeb>(lanes_for(F), src,
                         row_major_launch(F, dst, out_block, T, n_windows, E, s_tile, out,
                                          part_rows, part_vals, stream));
}
