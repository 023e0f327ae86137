// Multi-head slot segment sum for Hopper (sm_90a), plain C interface for
// ctypes. The kernels are in slot_common.cuh.
//
// Replaces plan_segment_sum_mh of geot_tpu/ops/pallas_segment.py (:1391,
// `_mh_kernel` :147-187):
//
//   out[dst[t*E + j], c] += w_heads[t*E + j, c / head_dim] * vals[t*E + j, c]
//
// over flat H*head_dim columns; columns past H heads are inert (weight 0).
// The TPU kernel expands per-(slot, head) weights to lanes with a
// head-selector matmul; here each lane holds four columns and looks up
// each one's head once (`hc`), so a head may straddle lanes and slabs
// ((H, D) = (3, 96): head 1 spans columns 96-191, across the 128-column
// slab boundary). A slot is skipped only when all H of its weights are 0
// (a pad, or an edge of zero attention on every head): a slot zero on some
// heads only stays in its row's run and adds 0 there.
//
// Bound on the H100: bytes. At the flickr GAT's shapes (~1.09 M slots,
// 989,006 live) H*D 256 reads ~1.01 GB of values and ~17 MB of head
// weights and writes ~91 MB; H*D 28 ~0.13 GB.

#include "slot_common.cuh"

// Scratch row width for F columns.
extern "C" int geot_slot_scratch_width(int F, int packed) {
  return slot_scratch_width(F, packed ? lanes_for(F) : 32);
}

// vals [>= T*E, F] f32 row-major (slot order), w_heads f32 [T*E, H] (0 on
// pads), dst int32 [T*E], out_block int32 [T] non-decreasing -> out
// [n_windows*s_tile, F] f32. Scratch as in slot_segment_sum.cu, of width
// geot_slot_scratch_width(F, 1). Returns cudaGetLastError().
extern "C" int geot_plan_segment_sum_mh(const void* vals, int F, const void* dst,
                                        const void* w_heads, int H, int head_dim,
                                        const void* out_block, int T, int n_windows, int E,
                                        int s_tile, void* out, void* part_rows,
                                        void* part_vals, void* stream) {
  if (H < 1 || head_dim < 1) return (int)cudaErrorInvalidValue;
  SlotSrc src = slot_order_src(vals, w_heads);
  src.H = H;
  src.head_dim = head_dim;
  return row_major(lanes_for(F), src,
                         row_major_launch(F, dst, out_block, T, n_windows, E, s_tile, out,
                                          part_rows, part_vals, stream));
}
