// Packed BAT segment sum for narrow features on Hopper (sm_90a), plain C
// interface for ctypes. The kernels are the `kBat` kind of slot_common.cuh.
//
// Replaces the TPU kernel `bat_segment_sum_packed` / `_bat_packed_kernel`
// (geot_tpu/ops/pallas_segment.py:852-1000, `pallas_call` at :976). For a
// block-aligned-tile plan with k-major dst ids (out_block[T], vblock[T],
// dst_km[(n_vblocks+1)*E], km_pack = P = 128 / F) it computes
//
//   out[w*s_tile + r, :] = sum over tiles t with out_block[t] == w,
//                          over edges j of value block b = vblock[t]
//                          whose dst dst_km[b*E + (j % P)*(E / P) + j / P]
//                          - w*s_tile == r lies in [0, s_tile),
//                          of w_edge[b*E + j] * vals[b*E + j, :]
//
// for F in {8, 16, 32, 64} columns, read unpadded. Out-of-window edges, the
// -1 pads and the sentinel block add nothing; rows past the end of `vals`
// read as zero (the TPU kernel's clamped block and zero tail, :923-934), and
// weights past n_w as zero. Every row of every window is written exactly
// once (zeros included), in a fixed order and with no atomics, so reruns
// are bit-identical.
//
// The TPU packs P = 128 / F edges into one 128-lane row and reduces a tile
// with P one-hot matmuls, one per sub-position k, whose dst ids it reads
// k-major and whose weights it selects with a strided one-hot product. Here
// a warp takes G = F / 4 lanes per edge (float4 each) and so reads P
// consecutive edges at once, the same P; group g of a batch holds
// sub-position g, so it reads its dst id from lane row g of the k-major
// block. Equal dst ids among the P edges are added by a segmented suffix
// sum over shuffles that carries a run-end flag, so a skipped edge inside a
// run can never join two runs (the lesson of the slot kernels' zero-weight
// fault); a window's tiles are summed in tile order by the window kernel.
// The weights are read in edge order, with no selection product.
//
// Bound on the H100: bytes (each in-window edge's value row, its dst id and
// weight, and the output once); the flops (2 per value) are negligible.
// GIN's 64-column layers on the ogbn-arxiv-shaped graph (1,166,243 edges)
// move ~0.35 GB, ~0.10 ms at 3.35 TB/s; APPNP's 8-column propagation on
// the flickr-shaped graph (989,006 edges) ~0.042 GB, ~0.013 ms: launch
// latency bounds that one.

#include "slot_common.cuh"

namespace {

template <int MODE>
int launch_bat(int G, const SlotSrc& src, const SlotLaunch& a) {
  switch (G) {
    case 2: return launch<2, MODE, kBat>(src, a);
    case 4: return launch<4, MODE, kBat>(src, a);
    case 8: return launch<8, MODE, kBat>(src, a);
    case 16: return launch<16, MODE, kBat>(src, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vals f32 [rows, F] row-major, edge order (row 0 = edge 0 of the plan),
// F in {8, 16, 32, 64}; dst_km int32 [(n_vblocks+1)*E], k-major per block
// with km_pack = 128 / F (E % km_pack == 0); w f32 [n_w] or null
// (unweighted); out_block int32 [T] non-decreasing and vblock int32 [T];
// out f32 [n_windows*s_tile, F]; scratch part_rows int32 [2*T], part_vals
// f32 [2*T, F]. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a width or tile it does not take.
extern "C" int geot_bat_segment_sum_packed(const void* vals, int F, int64_t rows,
                                           const void* dst_km, const void* w, int64_t n_w,
                                           const void* out_block, const void* vblock, int T,
                                           int n_windows, int E, int s_tile, void* out,
                                           void* part_rows, void* part_vals, void* stream) {
  const int G = lanes_for(F);
  if (F != 4 * G || G > 16 || E % (32 / G) != 0) return (int)cudaErrorInvalidValue;
  if (n_windows <= 0) return (int)cudaSuccess;
  SlotSrc src = slot_order_src(vals, nullptr);
  src.e0 = (const int*)vblock;
  src.edge_vals = 1;
  src.e_base = 0;
  src.n_rows = rows;
  src.w_edge = (const float*)w;
  src.n_w = n_w;
  const SlotLaunch a = row_major_launch(F, dst_km, out_block, T, n_windows, E, s_tile, out,
                                        part_rows, part_vals, stream);
  const bool vec = ((uintptr_t)vals % 16 == 0) && ((uintptr_t)out % 16 == 0);
  return vec ? launch_bat<kRowVec>(G, src, a) : launch_bat<kRowScalar>(G, src, a);
}
