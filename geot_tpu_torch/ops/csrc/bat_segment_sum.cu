// BAT segment sum for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `bat_segment_sum` / `_bat_kernel`
// (geot_tpu/ops/pallas_segment.py:730-849). For a block-aligned-tile plan
// (out_block[T], vblock[T], dst3[(n_vblocks+1)*e_tile]) it computes
//
//   out[w*s_tile + r, :] = sum over tiles t with out_block[t] == w,
//                          over edges e in value block vblock[t]
//                          with dst3[e] - w*s_tile == r in [0, s_tile),
//                          of w[e] * vals[e, :]
//
// Out-of-window edges, the -1 padding and the sentinel block add nothing;
// rows e >= rows of `vals` (the ragged tail) read as zero and weights
// e >= n_w as zero. Every row of every window is written exactly once
// (zeros included), with no atomics, so the result is deterministic.
//
// Bound on the H100: bytes. At ogbn-arxiv widths (1.34 M edges, F_pad 128)
// it must read vals (~684 MB) plus dst and w (~11 MB) and write out
// (~87 MB): ~0.78 GB, ~0.23 ms at 3.35 TB/s; the FLOPs (2 per value) are
// negligible. So the design reads each value row once, with 16-byte
// coalesced loads (a warp reads a 512-byte row: lane l owns columns
// 4l..4l+3 of a 128-column slab), and spreads the rows over all SMs even
// when one window holds a large share of the edges (a power-law head).
//
// On the TPU the grid runs in order and carries a VMEM sum from tile to
// tile. Here blocks run in no order, so the sum is split in two kernels:
//
//  1. bat_tile_kernel, one block per (tile, slab). The tile's in-window
//     edges are dst-sorted, so every row it touches other than its first
//     and its last has all its edges inside this tile: such rows, and the
//     empty rows between them, are written directly. Each of the 8 warps
//     sums a contiguous eighth of the block in edge order, in registers,
//     flushing at each change of dst; the rows at warp boundaries are
//     combined in warp order through shared memory. The tile's first and
//     last rows go, as partial sums, to a scratch buffer.
//  2. bat_window_kernel, one warp per (window, slab), walks the window's
//     tiles in order (found by binary search over the non-decreasing
//     out_block), adds the boundary partials of consecutive tiles that
//     share a row (a hub row spans many tiles), and writes those rows and
//     the empty rows between tiles.
//
// A window's real tiles must have increasing vblock (checked when the plan
// is made), so rows are met in increasing order in both kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;   // columns per slab: 32 lanes x float4
constexpr int kBatch = 8;    // value rows in flight per warp
constexpr int kTileBatch = 8;  // tiles whose partials are in flight per warp

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x += s * b.x; a.y += s * b.y; a.z += s * b.z; a.w += s * b.w;
}

__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Row r of window `win`, this lane's four columns.
struct OutRows {
  float4* out;
  int64_t win_base;
  int F, col;
  __device__ __forceinline__ float4* at(int r) const {
    return out + (((win_base + r) * F + col) >> 2);
  }
  __device__ __forceinline__ void zeros(int lo, int hi) const {
    for (int r = lo; r < hi; ++r) *at(r) = zero4();
  }
};

__global__ void __launch_bounds__(kThreads)
bat_tile_kernel(const float* __restrict__ vals, int64_t rows, int F,
                const int* __restrict__ dst3, const float* __restrict__ w,
                int64_t n_w, const int* __restrict__ out_block,
                const int* __restrict__ vblock, int e_tile, int s_tile,
                float* __restrict__ out, int* __restrict__ part_rows,
                float* __restrict__ part_vals) {
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * kCols + 4 * lane;
  const int win = __ldg(out_block + t);
  const int64_t base = (int64_t)__ldg(vblock + t) * e_tile;
  const OutRows o{reinterpret_cast<float4*>(out), (int64_t)win * s_tile, F, col};
  const int seg = (e_tile + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int j_end = min((warp + 1) * seg, e_tile);

  __shared__ int s_row[2 * kWarps];             // [warp][first, last] row
  __shared__ float4 s_part[2 * kWarps][32];      // their partial sums

  // this warp's runs: the first is kept (it may continue the previous
  // warp's last row), the middle ones are complete and written, the last
  // is kept (it may continue into the next warp)
  float4 acc = zero4(), first_acc = zero4();
  int cur = -1, first_row = -1;
  for (int j = warp * seg; j < j_end; j += 32) {
    const int64_t e_lane = base + j + lane;
    const int local = __ldg(dst3 + e_lane) - (int)o.win_base;
    unsigned mask = __ballot_sync(0xffffffffu, local >= 0 && local < s_tile);
    const float w_lane = (w == nullptr) ? 1.f
                         : (e_lane < n_w ? __ldg(w + e_lane) : 0.f);
    while (mask) {
      int src_lane[kBatch];
      int n = 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        src_lane[k] = mask ? __ffs(mask) - 1 : 0;
        if (mask) { mask &= mask - 1; ++n; }
      }
      float4 v[kBatch];
      float wk[kBatch];
      int rk[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int sl = src_lane[k];
        rk[k] = __shfl_sync(0xffffffffu, local, sl);
        wk[k] = __shfl_sync(0xffffffffu, w_lane, sl);
        const int64_t e = base + j + sl;
        v[k] = (k < n && e < rows)
                   ? __ldg(reinterpret_cast<const float4*>(vals + e * F + col))
                   : zero4();
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k < n) {
          const int r = rk[k];
          if (r != cur) {
            if (cur >= 0) {
              if (first_row < 0) { first_row = cur; first_acc = acc; }
              else *o.at(cur) = acc;
              o.zeros(cur + 1, r);  // empty rows between two runs of this warp
            }
            cur = r;
            acc = zero4();
          }
          fma4(acc, wk[k], v[k]);
        }
      }
    }
  }
  if (first_row < 0) {  // zero or one run
    if (lane == 0) { s_row[2 * warp] = cur; s_row[2 * warp + 1] = -1; }
    s_part[2 * warp][lane] = acc;
  } else {
    if (lane == 0) { s_row[2 * warp] = first_row; s_row[2 * warp + 1] = cur; }
    s_part[2 * warp][lane] = first_acc;
    s_part[2 * warp + 1][lane] = acc;
  }
  __syncthreads();
  if (warp != 0) return;

  // merge the warps' boundary runs in warp order; the merged rows other
  // than the tile's first and last are complete
  int mrow = -1, last_i = -1;
  float4 macc = zero4();
  int tile_first = -1, pend = -1;
  float4 tile_first_acc = zero4(), pend_acc = zero4();
  auto emit = [&](int r, const float4& a) {
    if (tile_first < 0) { tile_first = r; tile_first_acc = a; return; }
    if (pend >= 0) *o.at(pend) = pend_acc;
    pend = r;
    pend_acc = a;
  };
  for (int i = 0; i < 2 * kWarps; ++i) {
    const int r = s_row[i];
    if (r < 0) continue;
    const float4 p = s_part[i][lane];
    if (r == mrow) { add4(macc, p); last_i = i; continue; }
    if (mrow >= 0) {
      emit(mrow, macc);
      // rows between a warp's first and last run were written by that warp
      const bool same_warp = (last_i % 2 == 0) && (i == last_i + 1);
      if (!same_warp) o.zeros(mrow + 1, r);
    }
    mrow = r;
    macc = p;
    last_i = i;
  }
  if (mrow >= 0) emit(mrow, macc);
  float4* pv = reinterpret_cast<float4*>(part_vals);
  const int64_t p0 = ((int64_t)(2 * t) * F + col) >> 2;
  const int64_t p1 = ((int64_t)(2 * t + 1) * F + col) >> 2;
  pv[p0] = tile_first_acc;
  pv[p1] = pend_acc;
  if (blockIdx.y == 0 && lane == 0) {
    part_rows[2 * t] = tile_first;
    part_rows[2 * t + 1] = pend;
  }
}

__global__ void __launch_bounds__(32)
bat_window_kernel(const int* __restrict__ part_rows,
                  const float* __restrict__ part_vals,
                  const int* __restrict__ out_block, int T, int F, int s_tile,
                  float* __restrict__ out) {
  const int win = blockIdx.x;
  const int lane = threadIdx.x;
  const int col = blockIdx.y * kCols + 4 * lane;
  const OutRows o{reinterpret_cast<float4*>(out), (int64_t)win * s_tile, F, col};
  const float4* pv = reinterpret_cast<const float4*>(part_vals);
  const int t_begin = lower_bound(out_block, T, win);
  const int t_end = lower_bound(out_block, T, win + 1);

  float4 acc = zero4();
  int cur = -1, next = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kTileBatch) {
    int a[kTileBatch], b[kTileBatch];
    float4 pa[kTileBatch], pb[kTileBatch];
#pragma unroll
    for (int k = 0; k < kTileBatch; ++k) {
      const int t = t0 + k;
      const bool in = t < t_end;
      a[k] = in ? __ldg(part_rows + 2 * t) : -1;
      b[k] = in ? __ldg(part_rows + 2 * t + 1) : -1;
      pa[k] = in ? __ldg(pv + (((int64_t)(2 * t) * F + col) >> 2)) : zero4();
      pb[k] = in ? __ldg(pv + (((int64_t)(2 * t + 1) * F + col) >> 2)) : zero4();
    }
#pragma unroll
    for (int k = 0; k < kTileBatch; ++k) {
      if (a[k] < 0) continue;  // a tile with no edge in this window
      if (a[k] != cur) {
        if (cur >= 0) { *o.at(cur) = acc; next = cur + 1; }
        o.zeros(next, a[k]);  // empty rows between tiles
        cur = a[k];
        acc = zero4();
      }
      add4(acc, pa[k]);
      if (b[k] >= 0) {  // rows strictly between a and b: written by the tile
        *o.at(cur) = acc;
        cur = b[k];
        acc = pb[k];
      }
    }
  }
  if (cur >= 0) { *o.at(cur) = acc; next = cur + 1; }
  o.zeros(next, s_tile);
}

}  // namespace

// vals [rows, F] f32 row-major (F % 128 == 0, 16-byte aligned); dst3 int32
// [(n_vblocks+1)*e_tile]; w f32 [n_w] or null (unweighted); out_block and
// vblock int32 [T]; out f32 [n_windows*s_tile, F]; scratch: part_rows int32
// [2*T], part_vals f32 [2*T, F]. e_tile % 32 == 0. Launches both kernels on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int geot_bat_segment_sum(const void* vals, int64_t rows, int F,
                                    const void* dst3, const void* w,
                                    int64_t n_w, const void* out_block,
                                    const void* vblock, int T, int n_windows,
                                    int e_tile, int s_tile, void* out,
                                    void* part_rows, void* part_vals,
                                    void* stream) {
  if (n_windows <= 0 || F <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0) {
    bat_tile_kernel<<<dim3(T, F / kCols), kThreads, 0, s>>>(
        (const float*)vals, rows, F, (const int*)dst3, (const float*)w, n_w,
        (const int*)out_block, (const int*)vblock, e_tile, s_tile,
        (float*)out, (int*)part_rows, (float*)part_vals);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bat_window_kernel<<<dim3(n_windows, F / kCols), 32, 0, s>>>(
      (const int*)part_rows, (const float*)part_vals, (const int*)out_block, T,
      F, s_tile, (float*)out);
  return (int)cudaGetLastError();
}
