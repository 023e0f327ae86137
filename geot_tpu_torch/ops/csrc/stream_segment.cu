// Streamed cell-tile segment sum for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernels `stream_segment_acc` and `stream_segment_sum`,
// which share one body, `_stream_kernel`
// (geot_tpu/ops/pallas_segment.py:1103-1299). One stream family holds T
// tiles of E slots; tile t reads x block sblock[t] and adds into output
// window out_block[t]. For each slot e of tile t, with win = out_block[t],
// d = dst3[t][e] - win*s_tile, s = srcl3[t][e]:
//
//   if 0 <= s < x_rows and 0 <= d < s_tile:
//     out[win*s_tile + d, :] += w3[t][e] * x[sblock[t]*x_rows + s, :]
//
// (w3 = 1 when absent). x rows past the end of x read as zero, and the
// columns past F are never read or written, so x needs no padding. With
// accumulate = 1 (`stream_segment_acc`) the sums add into `out` and the
// rows no slot adds to keep their contents; with accumulate = 0
// (`stream_segment_sum`) every row of `out` is written, zeros where no slot
// adds. x is float32 or bfloat16; the sums are float32 either way.
//
// Bound on the H100: bytes. Each live slot reads one x row (512 bytes at
// F 128). The TPU kernel selects those rows with one-hot products into a
// window accumulator in VMEM, carried from tile to tile by its ordered
// grid. Here blocks run in no order, and a window-sized accumulator in
// shared memory (128 KB at F 128) leaves one block per SM with every warp
// scanning every slot, so the work is cut by output row instead, on the
// host (`stream_plan.kernel_schedule`):
//
//  - the live slots only (no pads, no out-of-window slots), in (row, slot)
//    order, one int32 each (the global x row, bit 31 marking the last slot
//    of its unit) and the weight beside it;
//  - a unit is one row's slots, or, for a row with more than SLICE_SLOTS
//    of them (a hub), one near-equal slice; a task is a run of units and
//    of the empty rows between them, cut at an even, small cost.
//
// What the card then waits on is the x rows' reads. A family whose cells
// share x blocks across neighbouring windows (a community's intra edges)
// re-reads them from L2 if the rows in flight are few: tasks are small
// (TASK_COST) and handed out in row order, so the resident groups work on
// a narrow band of rows. A family without such reuse runs at the DRAM
// rate of its row reads.
//
//  1. stream_row_kernel: a group of G lanes takes one task (G = 32 per
//     128-column slab; 16, 8 or 4 for F <= 64, 32, 16, so that narrow rows
//     leave no lane idle). It reads the task's slot entries G at a time,
//     coalesced, the next G in flight, broadcasts them by shuffle and keeps
//     kBatch x rows in flight per lane, adding them into registers in slot
//     order across unit bounds. At a unit's last slot it writes the row
//     once (accumulate: adds the row's old value, read when the unit
//     began), or the slice's sum to a partial. In sum mode it first writes
//     its task's empty rows as zeros. No shared memory; ~60 registers, so
//     an SM holds 32 warps. (Measured on the H100: 8 rows in flight at ~80
//     registers, or forced occupancy, were slower.)
//  2. stream_fix_kernel, one launch per level: one group per entry adds a
//     hub row's partials in slice order (at most FIX_FANIN of them; a row
//     with more is reduced in a fixed tree) into the row or into a partial
//     of the next level.
//
// No atomics: each output element has one fixed summation order (its
// slots in slot order, slices in order), and reruns are bit-identical.
// The one-hot MXU select of the TPU kernel is not carried over: a lane
// reads its x row directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kBatch = 4;      // x rows in flight per lane
constexpr int kCols = 128;     // columns per slab at G = 32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowMask = 0x7fffffff;  // cols entry -> x row (bit 31: last of unit)

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x += s * b.x; a.y += s * b.y; a.z += s * b.z; a.w += s * b.w;
}

__device__ __forceinline__ float4 sum4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 load_vec(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_vec(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Lane gl of a group of G lanes holds 4 columns of a row: with VEC the 4
// consecutive columns c0 + 4*gl (one 8- or 16-byte load), without it
// c0 + gl + G*m for m < 4 (each load coalesced over the group). Columns
// at or past F read as zero and are not written.
template <typename T, bool VEC, int G>
__device__ __forceinline__ float4 load_row(const T* __restrict__ x, int64_t row, int F,
                                           int c0, int gl) {
  const T* p = x + row * F;
  if (VEC) {
    const int c = c0 + 4 * gl;
    return c < F ? load_vec(p + c) : zero4();
  }
  const int c = c0 + gl;
  float4 v;
  v.x = c < F ? to_f(p[c]) : 0.f;
  v.y = c + G < F ? to_f(p[c + G]) : 0.f;
  v.z = c + 2 * G < F ? to_f(p[c + 2 * G]) : 0.f;
  v.w = c + 3 * G < F ? to_f(p[c + 3 * G]) : 0.f;
  return v;
}

template <bool VEC, int G>
__device__ __forceinline__ float4 load_out(const float* out, int64_t row, int F, int c0,
                                           int gl) {
  const float* p = out + row * F;
  if (VEC) {
    const int c = c0 + 4 * gl;
    return c < F ? *reinterpret_cast<const float4*>(p + c) : zero4();
  }
  const int c = c0 + gl;
  float4 v;
  v.x = c < F ? p[c] : 0.f;
  v.y = c + G < F ? p[c + G] : 0.f;
  v.z = c + 2 * G < F ? p[c + 2 * G] : 0.f;
  v.w = c + 3 * G < F ? p[c + 3 * G] : 0.f;
  return v;
}

template <bool VEC, int G>
__device__ __forceinline__ void store_out(float* out, int64_t row, int F, int c0, int gl,
                                          const float4& v) {
  float* p = out + row * F;
  if (VEC) {
    const int c = c0 + 4 * gl;
    if (c < F) *reinterpret_cast<float4*>(p + c) = v;
    return;
  }
  const int c = c0 + gl;
  if (c < F) p[c] = v.x;
  if (c + G < F) p[c + G] = v.y;
  if (c + 2 * G < F) p[c + 2 * G] = v.z;
  if (c + 3 * G < F) p[c + 3 * G] = v.w;
}

// A finished unit or fix-up entry: dest >= 0 is an output row (its old
// value `carry` added first in accumulate mode), dest < 0 partial -dest-1.
template <bool VEC, int G>
__device__ __forceinline__ void finish(float* out, float4* part, int dest, int F, int c0,
                                       int gl, int pofs, int pstride, const float4& acc,
                                       const float4& carry, int accumulate) {
  if (dest >= 0) {
    store_out<VEC, G>(out, dest, F, c0, gl, accumulate ? sum4(carry, acc) : acc);
  } else {
    part[(int64_t)(-dest - 1) * pstride + pofs] = acc;
  }
}

template <typename T, bool VEC, int G>
__global__ void __launch_bounds__(kThreads)
stream_row_kernel(const T* __restrict__ x, int64_t n_rows, int F,
                  const int* __restrict__ cols, const float* __restrict__ vals,
                  const int* __restrict__ unit_dest, int n_units,
                  const int* __restrict__ tasks, int n_tasks,
                  const int* __restrict__ zero_runs, float* out, float4* part,
                  int accumulate) {
  constexpr int kB = G < kBatch ? G : kBatch;
  const int gl = threadIdx.x % G;
  const int task = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) / G);
  const int c0 = blockIdx.y * kCols;
  const int pofs = blockIdx.y * G + gl, pstride = gridDim.y * G;  // in float4s
  int s = 0, s_end = 0, u = 0;
  if (task < n_tasks) {
    s = __ldg(tasks + 3 * task);
    u = __ldg(tasks + 3 * task + 1);
    s_end = __ldg(tasks + 3 * task + 3);
    if (!accumulate) {  // the task's rows no slot adds to: zeros
      const int z1 = __ldg(tasks + 3 * task + 5);
      for (int z = __ldg(tasks + 3 * task + 2); z < z1; ++z) {
        const int r0 = __ldg(zero_runs + 2 * z), r1 = r0 + __ldg(zero_runs + 2 * z + 1);
        for (int r = r0; r < r1; ++r) store_out<VEC, G>(out, r, F, c0, gl, zero4());
      }
    }
  }
  // the current unit's destination and old value; the next one's destination
  int dest = 0, dest_next = 0;
  float4 carry = zero4();
  if (s < s_end) {
    dest = __ldg(unit_dest + u);
    if (u + 1 < n_units) dest_next = __ldg(unit_dest + u + 1);
    if (accumulate && dest >= 0) carry = load_out<VEC, G>(out, dest, F, c0, gl);
  }
  float4 acc = zero4();
  // slot entries G at a time, one per lane, the next G in flight; every
  // group of the warp runs the warp's largest trip count, the shuffles
  // being warp-wide
  const int max_it = (int)__reduce_max_sync(kFull, (unsigned)((s_end - s + G - 1) / G));
  int cc = 0;
  float wc = 1.f;
  if (s + gl < s_end) {
    cc = __ldg(cols + s + gl);
    if (vals != nullptr) wc = __ldg(vals + s + gl);
  }
  for (int it = 0; it < max_it; ++it) {
    const int base = s + it * G;
    const int jn = base + G + gl;
    int cn = 0;
    float wn = 1.f;
    if (jn < s_end) {
      cn = __ldg(cols + jn);
      if (vals != nullptr) wn = __ldg(vals + jn);
    }
    const int n_valid = s_end - base;
#pragma unroll
    for (int kb = 0; kb < G; kb += kB) {
      float4 v[kB];
      float w[kB];
      int ck[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        ck[b] = __shfl_sync(kFull, cc, kb + b, G);
        w[b] = __shfl_sync(kFull, wc, kb + b, G);
        const int r = ck[b] & kRowMask;
        v[b] = (kb + b < n_valid && r < n_rows) ? load_row<T, VEC, G>(x, r, F, c0, gl)
                                                : zero4();
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (kb + b < n_valid) {
          fma4(acc, w[b], v[b]);
          if (ck[b] < 0) {  // the unit's last slot
            finish<VEC, G>(out, part, dest, F, c0, gl, pofs, pstride, acc, carry,
                           accumulate);
            acc = zero4();
            ++u;
            dest = dest_next;
            const bool more = kb + b + 1 < n_valid;
            if (more && u + 1 < n_units) dest_next = __ldg(unit_dest + u + 1);
            carry = (accumulate && more && dest >= 0) ? load_out<VEC, G>(out, dest, F, c0, gl)
                                                      : zero4();
          }
        }
      }
    }
    cc = cn;
    wc = wn;
  }
}

// One group per entry (dest, p0, p1) of one fix-up level.
template <bool VEC, int G>
__global__ void __launch_bounds__(kThreads)
stream_fix_kernel(const int* __restrict__ fix, int n_fix, float4* part, float* out, int F,
                  int accumulate) {
  const int e = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) / G);
  if (e >= n_fix) return;
  const int gl = threadIdx.x % G;
  const int c0 = blockIdx.y * kCols;
  const int pofs = blockIdx.y * G + gl, pstride = gridDim.y * G;
  const int dest = __ldg(fix + 3 * e), p0 = __ldg(fix + 3 * e + 1), p1 = __ldg(fix + 3 * e + 2);
  const float4 carry =
      (accumulate && dest >= 0) ? load_out<VEC, G>(out, dest, F, c0, gl) : zero4();
  float4 acc = zero4();
  for (int p = p0; p < p1; p += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      v[b] = p + b < p1 ? part[(int64_t)(p + b) * pstride + pofs] : zero4();
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (p + b < p1) acc = sum4(acc, v[b]);
  }
  finish<VEC, G>(out, part, dest, F, c0, gl, pofs, pstride, acc, carry, accumulate);
}

struct Args {
  const void* x;
  int64_t n_rows;
  int F;
  const int* cols;
  const float* vals;
  const int* unit_dest;
  const int* tasks;
  int n_tasks;
  const int* zero_runs;
  int n_units;
  const int* fix;
  const int* fix_levels;
  int n_levels;
  float4* part;
  float* out;
  int accumulate;
  cudaStream_t stream;
};

template <typename T, bool VEC, int G>
int launch(const Args& a) {
  const int n_slabs = G == 32 ? (a.F + kCols - 1) / kCols : 1;
  if (a.n_tasks > 0) {
    const dim3 grid((unsigned)(((int64_t)a.n_tasks * G + kThreads - 1) / kThreads), n_slabs);
    stream_row_kernel<T, VEC, G><<<grid, kThreads, 0, a.stream>>>(
        (const T*)a.x, a.n_rows, a.F, a.cols, a.vals, a.unit_dest, a.n_units, a.tasks,
        a.n_tasks, a.zero_runs, a.out, a.part, a.accumulate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = 0; l < a.n_levels; ++l) {
    const int n = a.fix_levels[l + 1] - a.fix_levels[l];
    if (n <= 0) continue;
    const dim3 grid((unsigned)(((int64_t)n * G + kThreads - 1) / kThreads), n_slabs);
    stream_fix_kernel<VEC, G><<<grid, kThreads, 0, a.stream>>>(
        a.fix + 3 * (int64_t)a.fix_levels[l], n, a.part, a.out, a.F, a.accumulate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T, bool VEC>
int launch_lanes(const Args& a) {
  if (a.F > 64) return launch<T, VEC, 32>(a);
  if (a.F > 32) return launch<T, VEC, 16>(a);
  if (a.F > 16) return launch<T, VEC, 8>(a);
  return launch<T, VEC, 4>(a);
}

}  // namespace

// x [n_rows, F] row-major, float32 (x_is_bf16 = 0) or bfloat16 (1); cols
// int32 [S] and vals f32 [S] or null; unit_dest int32 [n_units]; tasks
// int32 [n_tasks + 1, 3]; zero_runs int32 [Z, 2]; fix int32 [M, 3] with
// its level bounds fix_levels (host memory, n_levels + 1 ints); part f32
// scratch [n_parts, ceil(F/128)*128 at F > 64, else 4*G] (16-byte
// aligned); out f32 [n_windows*s_tile, F]. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int geot_stream_segment(const void* x, int x_is_bf16, int64_t n_rows, int F,
                                   const void* cols, const void* vals,
                                   const void* unit_dest, const void* tasks, int n_tasks,
                                   const void* zero_runs, int n_units, const void* fix,
                                   const int* fix_levels, int n_levels, void* part,
                                   void* out, int accumulate, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  const Args a{x, n_rows, F, (const int*)cols, (const float*)vals,
               (const int*)unit_dest, (const int*)tasks, n_tasks, (const int*)zero_runs,
               n_units, (const int*)fix, fix_levels, n_levels, (float4*)part,
               (float*)out, accumulate, (cudaStream_t)stream};
  const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
  const bool vec = (F % 4 == 0) && (oa % 16 == 0) && (xa % (x_is_bf16 ? 8 : 16) == 0);
  if (x_is_bf16) {
    return vec ? launch_lanes<__nv_bfloat16, true>(a) : launch_lanes<__nv_bfloat16, false>(a);
  }
  return vec ? launch_lanes<float, true>(a) : launch_lanes<float, false>(a);
}
