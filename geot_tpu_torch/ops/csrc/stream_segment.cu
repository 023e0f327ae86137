// Streamed cell-tile segment sum for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernels `stream_segment_acc` and `stream_segment_sum`,
// which share one body, `_stream_kernel`
// (geot_tpu/ops/pallas_segment.py:1103-1299). One stream family holds T
// tiles of E slots; tile t reads x block sblock[t] and adds into output
// window out_block[t] (non-decreasing over t). For each slot e of tile t,
// with win = out_block[t], d = dst3[t][e] - win*s_tile, s = srcl3[t][e]:
//
//   if 0 <= s < x_rows and 0 <= d < s_tile:
//     out[win*s_tile + d, :] += w3[t][e] * x[sblock[t]*x_rows + s, :]
//
// (w3 = 1 when absent). x rows past the end of x read as zero, so x needs
// no padding to whole blocks, and the columns past F are never read or
// written, so x needs no padding to 128 columns either. With
// accumulate = 1 (`stream_segment_acc`) the sums add into `out` and the
// windows no tile visits keep their contents; with accumulate = 0
// (`stream_segment_sum`) every window of `out` is written, zeros where no
// tile visits. x is float32 or bfloat16; the sums are float32 either way.
//
// Bound on the H100: bytes. The kernel must read the slot metadata (12
// bytes a slot, 8 unweighted), each x block its tiles name, and read and
// write the visited windows of `out` (accumulate) or write all of `out`
// (sum). Each slot also re-reads a row of its tile's x block (256 rows):
// those re-reads hit L1/L2, which is what the cell layout buys over a
// gather from all of x.
//
// The TPU grid runs in order and carries the window's sum in VMEM from
// tile to tile; Hopper blocks run in no order. So:
//
//  1. stream_item_kernel: one block per (item, 128-column slab). An item
//     is a run of at most ITEM_SLOTS slots of one window's tiles (made on
//     the host, `stream_plan.kernel_schedule`). The block keeps the
//     window's [s_tile, 128] f32 sum in shared memory. Each of its 16
//     warps owns s_tile/16 rows and walks all of the item's slots in
//     order, taking only those whose row it owns: every element of the
//     sum is updated by one lane, in slot order. No atomics. A power-law
//     hub makes one row hold most of an item's slots, which would leave
//     one warp doing all the work: the host marks such an item's heavy
//     row (one with more than 1/16 of the item's slots), all 16 warps sum
//     its slots in 16 consecutive slices in registers, and the row's
//     owner adds the 16 slice sums in warp order. A window with one item
//     is written (or added) straight to `out`; otherwise the item writes
//     its partial window to scratch.
//  2. stream_merge_kernel: one block per (split window, slab, 32 rows)
//     adds the window's partials in item order into `out`; in sum mode it
//     also writes the zeros of the windows no tile visits.
//
// Reruns are bit-identical. The one-hot MXU select of the TPU kernel is
// not carried over: a lane reads its x row directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;    // columns per slab: 32 lanes x 4
constexpr int kBatch = 8;     // x rows in flight per warp
constexpr int kMergeThreads = 256;
constexpr int kMergeRows = 32;  // window rows per merge block

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x += s * b.x; a.y += s * b.y; a.z += s * b.z; a.w += s * b.w;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Columns col..col+3 of row `row` of x [rows, F]; zero past the end.
template <typename T, bool VEC>
__device__ __forceinline__ float4 load4(const T* __restrict__ x, int64_t row, int F, int col);

template <>
__device__ __forceinline__ float4 load4<float, true>(const float* __restrict__ x,
                                                     int64_t row, int F, int col) {
  if (col >= F) return zero4();
  return __ldg(reinterpret_cast<const float4*>(x + row * F + col));
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16, true>(
    const __nv_bfloat16* __restrict__ x, int64_t row, int F, int col) {
  if (col >= F) return zero4();
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(x + row * F + col));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float4 load4_scalar(const T* __restrict__ x, int64_t row,
                                               int F, int col) {
  const T* p = x + row * F;
  float4 v;
  v.x = col + 0 < F ? to_f(p[col + 0]) : 0.f;
  v.y = col + 1 < F ? to_f(p[col + 1]) : 0.f;
  v.z = col + 2 < F ? to_f(p[col + 2]) : 0.f;
  v.w = col + 3 < F ? to_f(p[col + 3]) : 0.f;
  return v;
}

template <>
__device__ __forceinline__ float4 load4<float, false>(const float* __restrict__ x,
                                                      int64_t row, int F, int col) {
  return load4_scalar(x, row, F, col);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16, false>(
    const __nv_bfloat16* __restrict__ x, int64_t row, int F, int col) {
  return load4_scalar(x, row, F, col);
}

// out[row, col..col+3] = v (accumulate = 0) or += v (accumulate = 1).
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ out, int64_t row, int F,
                                       int col, const float4& v, int accumulate) {
  if (col >= F) return;
  float* p = out + row * F + col;
  if (VEC) {
    float4* q = reinterpret_cast<float4*>(p);
    if (accumulate) { float4 o = *q; add4(o, v); *q = o; } else { *q = v; }
    return;
  }
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (col + c < F) p[c] = accumulate ? p[c] + vv[c] : vv[c];
  }
}

// Adds w * x[row] of the lanes in `mask` (each lane's own d, row and w)
// to `sink(d, w, x_row_cols)`, in lane order, kBatch rows in flight.
template <typename T, bool VEC, typename Sink>
__device__ __forceinline__ void consume(unsigned mask, int d, int64_t row, float wv,
                                        const T* __restrict__ x, int64_t n_rows, int F,
                                        int col, Sink sink) {
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
      rk[k] = __shfl_sync(0xffffffffu, d, sl);
      wk[k] = __shfl_sync(0xffffffffu, wv, sl);
      const int64_t r = __shfl_sync(0xffffffffu, row, sl);
      v[k] = (k < n && r < n_rows) ? load4<T, VEC>(x, r, F, col) : zero4();
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k < n) sink(rk[k], wk[k], v[k]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
stream_item_kernel(const T* __restrict__ x, int64_t n_rows, int F,
                   const int* __restrict__ dst3, const int* __restrict__ srcl3,
                   const float* __restrict__ w3, const int* __restrict__ sblock,
                   int E, int s_tile, int x_rows, const int4* __restrict__ items,
                   const int* __restrict__ heavy_rows, float* __restrict__ out,
                   float* __restrict__ part, int Fp, int accumulate) {
  extern __shared__ float4 acc[];  // [s_tile][32 lanes]
  __shared__ float4 hpart[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * kCols + 4 * lane;
  const int4 it = items[blockIdx.x];  // (t0, t1, window, part)
  const int heavy = heavy_rows[blockIdx.x];
  const int win = it.z;
  const int rpw = (s_tile + kWarps - 1) / kWarps;
  const int r0 = min(warp * rpw, s_tile);
  const int r1 = min(r0 + rpw, s_tile);
  const int win_base = win * s_tile;
  for (int r = r0; r < r1; ++r) acc[r * 32 + lane] = zero4();

  // the heavy row's slots: the warps split the item's slots into 16
  // consecutive slices and each sums its slice's in registers
  float4 hacc = zero4();
  if (heavy >= 0) {
    const int64_t q0 = (int64_t)it.x * E, q1 = (int64_t)it.y * E;
    const int64_t per = ((q1 - q0 + kWarps - 1) / kWarps + 31) / 32 * 32;
    const int64_t a = q0 + warp * per, b = min(q1, a + per);
    for (int64_t q = a; q < b; q += 32) {
      const int64_t ql = q + lane;
      int d = -1, s = -1;
      float wv = 0.f;
      int64_t row = 0;
      if (ql < b) {
        d = __ldg(dst3 + ql) - win_base;
        s = __ldg(srcl3 + ql);
        wv = w3 == nullptr ? 1.f : __ldg(w3 + ql);
        row = (int64_t)__ldg(sblock + ql / E) * x_rows + s;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, s >= 0 && s < x_rows && d == heavy);
      consume<T, VEC>(mask, d, row, wv, x, n_rows, F, col,
                      [&](int, float wk, const float4& v) { fma4(hacc, wk, v); });
    }
  }

  // every other slot: the owner warp of its row, in slot order
  for (int t = it.x; t < it.y; ++t) {
    const int64_t xbase = (int64_t)__ldg(sblock + t) * x_rows;
    const int* dt = dst3 + (int64_t)t * E;
    const int* st = srcl3 + (int64_t)t * E;
    const float* wt = w3 == nullptr ? nullptr : w3 + (int64_t)t * E;
    for (int j = 0; j < E; j += 32) {
      const int e = j + lane;
      int d = -1, s = -1;
      float wv = 0.f;
      if (e < E) {
        d = __ldg(dt + e) - win_base;
        s = __ldg(st + e);
        wv = wt == nullptr ? 1.f : __ldg(wt + e);
      }
      const unsigned mask = __ballot_sync(
          0xffffffffu, s >= 0 && s < x_rows && d >= r0 && d < r1 && d != heavy);
      consume<T, VEC>(mask, d, xbase + s, wv, x, n_rows, F, col,
                      [&](int r, float wk, const float4& v) { fma4(acc[r * 32 + lane], wk, v); });
    }
  }

  if (heavy >= 0) {  // the heavy row's slices, added in warp order by its owner
    hpart[warp][lane] = hacc;
    __syncthreads();
    if (heavy >= r0 && heavy < r1) {
      float4 sum = zero4();
      for (int w = 0; w < kWarps; ++w) add4(sum, hpart[w][lane]);
      acc[heavy * 32 + lane] = sum;
    }
  }

  if (it.w >= 0) {  // one of several items of this window: a partial
    float4* pv = reinterpret_cast<float4*>(part);
    for (int r = r0; r < r1; ++r)
      pv[(((int64_t)it.w * s_tile + r) * Fp + col) >> 2] = acc[r * 32 + lane];
    return;
  }
  for (int r = r0; r < r1; ++r)
    store4<VEC>(out, (int64_t)win_base + r, F, col, acc[r * 32 + lane], accumulate);
}

// Blocks x in [0, n_merges): a split window, its partials added in item
// order; x in [n_merges, n_merges + n_empty): a window no tile visits,
// zeros. Block z covers rows [z*kMergeRows, (z+1)*kMergeRows) of the window.
template <bool VEC>
__global__ void __launch_bounds__(kMergeThreads)
stream_merge_kernel(const int* __restrict__ merges, int n_merges,
                    const int* __restrict__ empties, const float* __restrict__ part,
                    int Fp, int F, int s_tile, float* __restrict__ out,
                    int accumulate) {
  int win, p0 = 0, p1 = 0;
  if ((int)blockIdx.x < n_merges) {
    win = merges[3 * blockIdx.x];
    p0 = merges[3 * blockIdx.x + 1];
    p1 = merges[3 * blockIdx.x + 2];
  } else {
    win = empties[blockIdx.x - n_merges];
  }
  const float4* pv = reinterpret_cast<const float4*>(part);
  const int r_begin = blockIdx.z * kMergeRows;
  const int r_end = min(s_tile, r_begin + kMergeRows);
  for (int idx = r_begin * 32 + threadIdx.x; idx < r_end * 32; idx += kMergeThreads) {
    const int r = idx >> 5;
    const int col = blockIdx.y * kCols + 4 * (idx & 31);
    float4 sum = zero4();
    for (int p = p0; p < p1; ++p)
      add4(sum, __ldg(pv + ((((int64_t)p * s_tile + r) * Fp + col) >> 2)));
    store4<VEC>(out, (int64_t)win * s_tile + r, F, col, sum, accumulate);
  }
}

template <typename T, bool VEC>
int launch(const void* x, int64_t n_rows, int F, const void* dst3,
           const void* srcl3, const void* w3, const void* sblock, int E,
           int s_tile, int x_rows, const void* items, const void* heavy,
           int n_items, const void* merges, int n_merges, const void* empties,
           int n_empty, void* out, void* part, int accumulate, cudaStream_t stream) {
  const int n_slabs = (F + kCols - 1) / kCols;
  const int Fp = n_slabs * kCols;
  if (n_items > 0) {
    const size_t smem = (size_t)s_tile * 32 * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        stream_item_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    stream_item_kernel<T, VEC><<<dim3(n_items, n_slabs), kThreads, smem, stream>>>(
        (const T*)x, n_rows, F, (const int*)dst3, (const int*)srcl3,
        (const float*)w3, (const int*)sblock, E, s_tile, x_rows,
        (const int4*)items, (const int*)heavy, (float*)out, (float*)part, Fp,
        accumulate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_merges + n_empty > 0) {
    const dim3 grid(n_merges + n_empty, n_slabs, (s_tile + kMergeRows - 1) / kMergeRows);
    stream_merge_kernel<VEC><<<grid, kMergeThreads, 0, stream>>>(
        (const int*)merges, n_merges, (const int*)empties, (const float*)part, Fp,
        F, s_tile, (float*)out, accumulate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [n_rows, F] row-major, float32 (x_is_bf16 = 0) or bfloat16 (1); dst3,
// srcl3 int32 [T*E]; w3 f32 [T*E] or null; sblock int32 [T]; items int32
// [n_items, 4] (16-byte aligned); heavy int32 [n_items] (each item's
// heavy row, window-local, or -1); merges int32 [n_merges, 3]; empties int32
// [n_empty] (0 in accumulate mode); out f32 [n_windows*s_tile, F];
// part f32 [n_parts, s_tile, ceil(F/128)*128] scratch (16-byte aligned).
// Needs s_tile * 512 bytes of shared memory. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int geot_stream_segment(const void* x, int x_is_bf16, int64_t n_rows,
                                   int F, const void* dst3, const void* srcl3,
                                   const void* w3, const void* sblock, int E,
                                   int s_tile, int x_rows, const void* items,
                                   const void* heavy, int n_items,
                                   const void* merges, int n_merges,
                                   const void* empties, int n_empty, void* out,
                                   void* part, int accumulate, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
  const bool vec = (F % 4 == 0) && (oa % 16 == 0) && (xa % (x_is_bf16 ? 8 : 16) == 0);
#define GEOT_STREAM_ARGS                                                        \
  x, n_rows, F, dst3, srcl3, w3, sblock, E, s_tile, x_rows, items, heavy,     \
      n_items, merges, n_merges, empties, n_empty, out, part, accumulate, s
  if (x_is_bf16) {
    return vec ? launch<__nv_bfloat16, true>(GEOT_STREAM_ARGS)
               : launch<__nv_bfloat16, false>(GEOT_STREAM_ARGS);
  }
  return vec ? launch<float, true>(GEOT_STREAM_ARGS)
             : launch<float, false>(GEOT_STREAM_ARGS);
#undef GEOT_STREAM_ARGS
}
