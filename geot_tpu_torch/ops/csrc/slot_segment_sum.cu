// Transposed slot-layout segment sum for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces plan_segment_sum_pr of geot_tpu/ops/pallas_segment.py (:1348,
// `_pr_kernel` :119-144): over a slot plan, with the rows' values on the
// contiguous axis,
//
//   out_t[f, d] = sum over the plan's live slots s with dst d, in edge
//                 order, of w[s] * v(s, f)        for f < N
//
//   v(s, f)  vals_t[f, s] (the values form, the TPU kernel's contract:
//            vals_t [N, ld_in] in slot order), or x[src[e], f] (the
//            gathered form: x [n_rows, N] node rows, e the slot's edge,
//            src the plan's edge-order src; a row past x's end reads as
//            zero)
//
// into out_t [N, n_out]. Every output row of the plan's windows is written
// once (zeros for a row no slot reaches), with no atomics, so reruns are
// bit-identical; the sums are float32. A slot of weight 0 adds nothing
// (ROADMAP C.9): pads always, and a real edge of weight 0 inside a row's
// run; its value may be loaded (inside the buffer) but is never added, so
// a NaN there does not reach the sum.
//
// Bound on the H100: bytes. At the flickr shape (981,504 slots) the mean's
// degree ([1, slots]) reads 11 MB and an 8-row sum 39 MB, so latency
// bounds them: the chains of dependent loads below, and the hub row's
// fix-up levels (its 75,189 slots make 2,350 slices, added in three
// launches). The flops (2 per value) are negligible.
//
// The TPU grid walks the tiles in order and carries a window's sum in
// VMEM; the first port of it ran a tile pass and a window pass over
// shared-memory partials, chunk by chunk, and refused a plan whose windows
// are not in order as a whole. Here the sum follows the plan's RowSchedule
// (`graph/row_schedule.py`, the edge-row kernel's: the live slots in row
// order, each row one unit, or a hub row near-equal slices of at most 32
// slots added by a fixed fix-up tree), the plan whole, chunked or not:
//
//  1. pr_row_kernel: a warp takes kTasks consecutive tasks (a run of units
//     and empty rows), their entries 32 at a time, one per lane, the next
//     32 entries' schedule loaded a round ahead: the transposed layout
//     puts a row's slots side by side, so the lanes' loads of vals_t[f, s]
//     are coalesced for each of the N rows, up to 8 rows' loads in flight
//     at once (one for the degree). Each f takes one segmented
//     scan over the lanes, keyed by unit (a fixed shuffle tree), and the
//     lane holding a unit's last entry writes its output, or its slice's
//     sum to a partial. A unit that runs on past the 32 entries carries its
//     N sums in shared memory to the next 32. The tasks' empty rows are
//     written as zeros, a run of them a lane.
//  2. pr_fix_kernel, one launch per fix-up level: one warp per (entry, f)
//     adds a hub row's partials (at most 32 a level), lane l the l-th, by
//     a fixed shuffle tree. (The first version, one thread per (entry, f)
//     adding them in order, was a chain of up to 32 loads a level.)
//
// An entry's loads form short chains: its cols and slot entries, then its
// weight and (gathered) its src row, then its values, each level issued
// for the 32 entries at once; a value is loaded whatever the weight and
// dropped where the weight is 0, so the weight does not lengthen the
// chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Schedule tasks a warp walks as one run. A task holds ~20 of flickr's
// slots, so one a warp left lanes idle and its loads' latency exposed: at
// [8, slots] over GraphSAGE's plan (four values a lane), 1, 2, 4 and 8
// tasks a warp took 0.0416, 0.0397, 0.0375 and 0.0369 ms of device time
// (`probe_slot ab`, NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).
constexpr int kTasks = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowMask = 0x7fffffff;  // cols entry -> edge (bit 31: last of unit)

struct Args {
  const float* vals;  // values form: vals_t [N, ld_in]; gathered: x [n_rows, N]
  int64_t ld_in, n_rows;
  int N;
  const int* src;     // [n_src]: the gathered form, or nullptr
  int64_t n_src;
  const int* cols;    // the schedule's entries (edge, bit 31: last of unit)
  const int* slot;    // their slots
  const float* w;     // [T*E] slot weights
  const int* unit_dest;
  const int* tasks;
  int n_tasks;
  const int* zero_runs;
  float* out;         // out_t [N, ld_out]
  int64_t ld_out;
  float* part;        // [n_parts, N]
};

// V: the values a lane holds at once (its loads in flight, one scan each):
// 1 for the mean's degree, else up to 8.
template <bool GATHER, int V>
__global__ void __launch_bounds__(kThreads)
pr_row_kernel(Args p) {
  extern __shared__ float s_carry[];  // [kWarps][N]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's tasks: kTasks consecutive ones, a contiguous run of entries,
  // units and empty rows
  const int t0 = (blockIdx.x * kWarps + warp) * kTasks;
  if (t0 >= p.n_tasks) return;  // the whole warp
  const int t1 = min(t0 + kTasks, p.n_tasks);
  float* carry = s_carry + warp * p.N;
  const int j_end = __ldg(p.tasks + 3 * t1);
  int u = __ldg(p.tasks + 3 * t0 + 1);
  // the empty rows: a run of them a lane (runs are short, and a loop over
  // them in turn would wait on each run's bounds)
  for (int z = __ldg(p.tasks + 3 * t0 + 2) + lane, z1 = __ldg(p.tasks + 3 * t1 + 2); z < z1;
       z += 32) {
    const int r0 = __ldg(p.zero_runs + 2 * z), len = __ldg(p.zero_runs + 2 * z + 1);
    for (int f = 0; f < p.N; ++f)
      for (int r = 0; r < len; ++r) p.out[f * p.ld_out + r0 + r] = 0.f;
  }
  const unsigned lt = (1u << lane) - 1;  // the lanes to this one's left
  bool carried = false;  // a unit runs on from the previous 32 entries
  int base = __ldg(p.tasks + 3 * t0);
  // each 32 entries' cols and slot entries are loaded one round ahead
  int c_next = 0, sl_next = 0;
  if (base + lane < j_end) {
    c_next = __ldg(p.cols + base + lane);
    sl_next = __ldg(p.slot + base + lane);
  }
  for (; base < j_end; base += 32) {
    const int j = base + lane;
    const bool in = j < j_end;
    const int c = c_next, sl = sl_next;
    if (j + 32 < j_end) {
      c_next = __ldg(p.cols + j + 32);
      sl_next = __ldg(p.slot + j + 32);
    }
    const bool last = in && c < 0;  // bit 31
    float w = 0.f;
    int64_t row = -1;
    if (in) {
      if (GATHER) {
        const int e = c & kRowMask;
        const int64_t r = e < p.n_src ? (int64_t)__ldg(p.src + e) : -1;
        row = r >= 0 && r < p.n_rows ? r : -1;
      } else {
        row = sl;
      }
      w = __ldg(p.w + sl);
    }
    const unsigned lasts = __ballot_sync(kFull, last);
    const unsigned before = lasts & lt;
    const int seg_start = before ? 32 - __clz(before) : 0;  // after the last unit end
    const bool first_seg = seg_start == 0;                  // lane 0's unit
    const int dest = last ? __ldg(p.unit_dest + u + __popc(before)) : 0;
    unsigned join = 0;  // bit s: lane - 2^s lies in this lane's unit
#pragma unroll
    for (int s = 0; s < 5; ++s)
      if (lane - (1 << s) >= seg_start) join |= 1u << s;
    for (int f0 = 0; f0 < p.N; f0 += V) {
      float v[V];
#pragma unroll
      for (int m = 0; m < V; ++m) {
        const int f = f0 + m;
        float x = 0.f;
        if (row >= 0 && f < p.N)
          x = GATHER ? __ldg(p.vals + row * p.N + f) : __ldg(p.vals + f * p.ld_in + row);
        v[m] = w != 0.f ? w * x : 0.f;
      }
#pragma unroll
      for (int s = 0; s < 5; ++s) {
#pragma unroll
        for (int m = 0; m < V; ++m) {
          const float left = __shfl_up_sync(kFull, v[m], 1 << s);
          if (join & (1u << s)) v[m] += left;
        }
      }
      if (carried && first_seg) {
#pragma unroll
        for (int m = 0; m < V; ++m)
          if (f0 + m < p.N) v[m] += carry[f0 + m];
      }
      __syncwarp();
      if (last) {
#pragma unroll
        for (int m = 0; m < V; ++m) {
          const int f = f0 + m;
          if (f >= p.N) break;
          if (dest >= 0) p.out[f * p.ld_out + dest] = v[m];
          else p.part[(int64_t)(-dest - 1) * p.N + f] = v[m];
        }
      } else if (lane == 31 && in) {  // the unit runs on: carry its sums
#pragma unroll
        for (int m = 0; m < V; ++m)
          if (f0 + m < p.N) carry[f0 + m] = v[m];
      }
      __syncwarp();
    }
    carried = __shfl_sync(kFull, in && !last, 31);
    u += __popc(lasts);
  }
}

// One warp per (entry, f) of one fix-up level (dest, p0, p1): lane l adds
// partials p0 + l, p0 + l + 32, ... in order, then a fixed shuffle tree
// adds the lanes' sums and lane 0 writes.
__global__ void __launch_bounds__(kThreads)
pr_fix_kernel(const int* __restrict__ fix, int n_fix, int N, float* part, float* out,
              int64_t ld_out) {
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;  // the warp's
  const int lane = threadIdx.x & 31;
  if (i >= (int64_t)n_fix * N) return;  // the whole warp
  const int e = (int)(i / N), f = (int)(i % N);
  const int dest = __ldg(fix + 3 * e), p0 = __ldg(fix + 3 * e + 1), p1 = __ldg(fix + 3 * e + 2);
  float acc = 0.f;
  for (int q = p0 + lane; q < p1; q += 32) acc += part[(int64_t)q * N + f];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  if (lane != 0) return;
  if (dest >= 0) out[f * ld_out + dest] = acc;
  else part[(int64_t)(-dest - 1) * N + f] = acc;
}

}  // namespace

// The largest N the kernel takes (its carries in shared memory).
extern "C" int geot_pr_max_rows() { return (48 << 10) / (kWarps * 4); }

// vals: vals_t f32 [N, ld_in] in slot order (src null), or x f32 [n_rows,
// N] row-major with src int32 [n_src] (the plan's edge-order src); cols,
// slot int32 [S] (the plan's RowSchedule); w f32 [T*E] slot weights;
// unit_dest int32 [n_units]; tasks int32 [n_tasks + 1, 3]; zero_runs int32
// [Z, 2]; fix int32 [M, 3] with its level bounds fix_levels (host memory,
// n_levels + 1 ints); part f32 scratch [n_parts, N]; out_t f32 [N, n_out],
// every element written. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int geot_plan_segment_sum_pr(const void* vals, int64_t ld_in, int64_t n_rows, int N,
                                        const void* src, int64_t n_src, const void* cols,
                                        const void* slot, const void* w, const void* unit_dest,
                                        const void* tasks, int n_tasks, const void* zero_runs,
                                        const void* fix, const int* fix_levels, int n_levels,
                                        void* part, void* out_t, int64_t n_out, void* stream) {
  if (N <= 0 || n_out <= 0) return (int)cudaSuccess;
  if (N > geot_pr_max_rows()) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)vals, ld_in, n_rows, N, (const int*)src, n_src, (const int*)cols,
               (const int*)slot, (const float*)w, (const int*)unit_dest, (const int*)tasks,
               n_tasks, (const int*)zero_runs, (float*)out_t, n_out, (float*)part};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_tasks > 0) {
    const unsigned blocks = (unsigned)((n_tasks + kWarps * kTasks - 1) / (kWarps * kTasks));
    const size_t smem = (size_t)kWarps * N * sizeof(float);
    if (src != nullptr) {
      if (N == 1) pr_row_kernel<true, 1><<<blocks, kThreads, smem, s>>>(a);
      else if (N <= 4) pr_row_kernel<true, 4><<<blocks, kThreads, smem, s>>>(a);
      else pr_row_kernel<true, 8><<<blocks, kThreads, smem, s>>>(a);
    } else {
      if (N == 1) pr_row_kernel<false, 1><<<blocks, kThreads, smem, s>>>(a);
      else if (N <= 4) pr_row_kernel<false, 4><<<blocks, kThreads, smem, s>>>(a);
      else pr_row_kernel<false, 8><<<blocks, kThreads, smem, s>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = 0; l < n_levels; ++l) {
    const int n = fix_levels[l + 1] - fix_levels[l];
    if (n <= 0) continue;
    const unsigned blocks = (unsigned)(((int64_t)n * N * 32 + kThreads - 1) / kThreads);
    pr_fix_kernel<<<blocks, kThreads, 0, s>>>((const int*)fix + 3 * (int64_t)fix_levels[l], n,
                                              N, (float*)part, (float*)out_t, n_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
