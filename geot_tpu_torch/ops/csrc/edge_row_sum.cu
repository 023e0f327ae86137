// Row-ordered edge sum for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces seven TPU kernels of geot_tpu/ops/pallas_segment.py, which on
// the card are one function:
//
//   plan_segment_sum_sr2        (:384, `_sr2_kernel` :323-382, `pallas_call` :496)
//   plan_segment_sum_packed2    (:581, `_packed2_kernel` :512-579, :688)
//   bat_segment_sum_packed      (:852-1000, `_bat_packed_kernel`, :906, :976)
//   bat_segment_sum             (:772, `_bat_kernel` :730, :837), any width
//   plan_segment_sum_sr_packed  (:233, `_sr_packed_kernel` :190, :274), F <= 64
//   plan_segment_sum_sr         (:1302, `_sr_kernel` :89-116, :1335), any width
//   plan_segment_sum_mh         (:1391, `_mh_kernel` :147-187, :1427), per-head
//
//   out[d, c] = sum over the plan's live edges e with dst d, in edge order,
//               of w(e, c) * v(e, c)
//
// for every output row d of the plan's windows, each written exactly once
// (zeros for a row no edge reaches). The plans (slot and BAT alike) are
// built over dst-sorted edges, so each row's edges are one run of the edge
// order; the host lists them once per plan (`graph.row_schedule`,
// `RowSchedule`): the live edges in row order, each entry an edge id with
// bit 31 marking the last entry of its unit. The -1 pads, the sentinel
// block, pad slots and out-of-window slots are not listed.
//
//   v(e)  vals[e - e_base] (edge order: the TPU kernels' contract), or
//         vals[slot(e)] (a slot plan's slot order: sr2, sr_packed, sr, mh), or
//         vals[src[e]] (the fused gather: vals is x, src the plan's
//         edge-order src); a row outside vals reads as zero
//   w(e)  1, times w_slots[slot(e)] (a slot plan's static weights or mask),
//         times w_edge[e] where per-call edge-order weights are given (0
//         past n_w; read only where the slot weight is not 0); the same for
//         every column. Or, with w_heads [*, H] (mh), column c's weight is
//         w_heads[id(e), c / head_dim], id(e) the entry's slot where the
//         values are in slot order, else its edge (0 past n_wh); columns
//         past H heads are inert. A lane's 4 columns may straddle heads
//         ((H, D) = (4, 7): columns 4-7 are heads 0 and 1) and a head may
//         straddle slabs ((3, 96)), so each lane looks up its columns'
//         heads once; where they are one head (16-byte rows, head_dim % 4
//         == 0) it loads one weight an entry, else one a column. An entry's
//         weight row (16-32 B) is read first by the lane that resolves the
//         entry, one step ahead, so the group's loads of it can hit L1.
//
// With skip_zero (sr2, packed2, sr_packed, sr) an entry of weight 0 adds
// nothing and its row is not read, as the slot kernels skip such slots
// (ROADMAP C.9); without it (the BAT sums) it adds 0 * v, as the TPU kernels
// do. With w_heads (mh) an entry whose H weights are all 0 is skipped so,
// always; one zero on some heads only stays in its row's run and adds 0
// there.
//
// Bound on the H100: bytes. Each live edge reads one value row (256 bytes
// at F 64), its entry and weight, and every output row is written once;
// in the fused form the value rows are x's, which the graph's edges read
// again and again: flickr's x at F 64 is 23 MB, inside the 50 MB L2;
// arxiv's at F 128 is 87 MB, flickr's at F 256 (GAT) 91 MB and at F 500
// (GraphSAGE) 179 MB, the products graph's 1.25 GB, so there the gathered
// rows come partly from DRAM, and rows in flight hide its latency.
// The
// TPU kernels walk tiles of E slots in a sequential grid and carry a
// window's sum in VMEM; the first port of them (a tile pass and a window
// pass over shared-memory partials) spent its time on dependent loads and
// block merges. Here, as in stream_segment.cu:
//
//  1. edge_row_kernel: a group of G lanes takes one task (a run of units
//     and empty rows; G = 32 per 128-column slab, 16, 8, 4 or 2 at F <= 64,
//     32, 16 or 8, so narrow rows leave no lane idle). It resolves G
//     entries at a time, one per lane (entry -> edge -> src row and
//     weights, the next G in flight), broadcasts them by shuffle and keeps
//     up to kBatch rows in flight per lane (and with w_heads, their head
//     weights), adding them into registers in edge order across unit
//     bounds. At a unit's last entry it writes the row once, or the slice's
//     sum to a partial. It writes its task's empty rows as zeros. No shared
//     memory; 40-48 registers without w_heads.
//     A task is a serial chain of dependent loads, so tasks are short (32
//     entries, `row_schedule.EDGE_TASK_COST`, and hub slices of 32): with
//     the stream kernel's 128 a narrow row's task took 64 dependent steps
//     and the F 7-8 sums ran slower than the first port's tile kernels.
//  2. edge_fix_kernel, one launch per level: one group per entry adds a
//     hub row's partials in slice order (at most 32 of them; a row with
//     more is reduced in a fixed tree).
//
// No atomics and no memset: each output element has one fixed summation
// order (its edges in edge order, slices in order), and reruns are
// bit-identical. The sums are float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Rows in flight per lane. A build flag for `probe_slot rowsum`'s sweep:
// over its narrow, wide and products sums 8 took 1.3941 / 1.9701 /
// 13.7884 ms, 4 1.4223 / 1.9102 / 12.9459, 2 1.6145 / 2.3889 / 15.5881
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), so 4 stays.
#ifndef GEOT_EDGE_BATCH
#define GEOT_EDGE_BATCH 4
#endif

// 0 sends every head-weighted sum through the per-column weights (the
// lane mode's A/B in `probe_slot rowsum --slot`).
#ifndef GEOT_HEADS_LANE
#define GEOT_HEADS_LANE 1
#endif

constexpr int kThreads = 128;             // 4 warps a block
constexpr int kBatch = GEOT_EDGE_BATCH;   // value rows in flight per lane
constexpr int kCols = 128;                // columns per slab at G = 32

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowMask = 0x7fffffff;  // cols entry -> edge (bit 31: last of unit)
constexpr int kNoRow = kRowMask;      // an entry that adds nothing

// How an entry's weight reaches a column (see the top): one weight for all
// columns, one head weight for the lane's 4 columns, or one for each column.
constexpr int kHeadsNone = 0, kHeadsLane = 1, kHeadsCol = 2;

// Where the values and weights come from (see the top).
struct Src {
  const float* vals;     // [n_rows, F]
  int64_t n_rows;
  const int* src;        // [n_src]: the fused gather, or nullptr
  int64_t n_src;
  int64_t e_base;        // edge of vals' row 0 (edge order)
  const int* slot;       // [S] the entries' slots (slot plans), or nullptr
  int by_slot;           // vals in slot order
  const float* w_slots;  // [T*E] slot weights, or nullptr (1)
  const float* w_edge;   // [n_w] per-call weights in edge order, or nullptr
  int64_t n_w;
  int skip_zero;
  const float* w_heads;  // [n_wh, H] head weights (slot order with by_slot), or nullptr
  int64_t n_wh;
  int H, head_dim;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x += s * b.x; a.y += s * b.y; a.z += s * b.z; a.w += s * b.w;
}

__device__ __forceinline__ void fma4v(float4& a, const float4& s, const float4& b) {
  a.x += s.x * b.x; a.y += s.y * b.y; a.z += s.z * b.z; a.w += s.w * b.w;
}

__device__ __forceinline__ float4 sum4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Entry j's value row (kNoRow: it adds nothing), with bit 31 copied from
// its cols entry, and its weight; with head weights (HM != kHeadsNone) its
// weight row `hid` instead, w being 1 where any of its H weights is not 0.
template <int HM>
__device__ __forceinline__ void resolve(const Src& s, const int* __restrict__ cols, int j,
                                        int& rc, float& w, int& hid) {
  const int c = __ldg(cols + j);
  const int e = c & kRowMask;
  w = 1.f;
  int sl = 0;
  if (s.slot != nullptr) sl = __ldg(s.slot + j);
  if (s.w_slots != nullptr) w = __ldg(s.w_slots + sl);
  if (s.w_edge != nullptr && w != 0.f) w *= e < s.n_w ? __ldg(s.w_edge + e) : 0.f;
  if (HM != kHeadsNone) {
    hid = s.by_slot ? sl : e;
    bool any = false;
    const float* p = s.w_heads + (int64_t)hid * s.H;
    for (int h = 0; h < s.H && !any && hid < s.n_wh; ++h) any = __ldg(p + h) != 0.f;
    w = any ? 1.f : 0.f;
  }
  int64_t r;
  if (s.src != nullptr) {
    r = e < s.n_src ? (int64_t)__ldg(s.src + e) : -1;
  } else if (s.by_slot) {
    r = sl;
  } else {
    r = (int64_t)e - s.e_base;
  }
  const bool live = r >= 0 && r < s.n_rows && !((s.skip_zero || HM != kHeadsNone) && w == 0.f);
  if (!live) w = 0.f;
  rc = (live ? (int)r : kNoRow) | (c & ~kRowMask);
}

// Lane gl of a group of G lanes holds 4 columns of a row: with VEC the 4
// consecutive columns c0 + 4*gl (one 16-byte load), without it
// c0 + gl + G*m for m < 4 (each load coalesced over the group). Columns
// at or past F read as zero and are not written.
template <bool VEC, int G>
__device__ __forceinline__ float4 load_row(const float* __restrict__ x, int64_t row, int F,
                                           int c0, int gl) {
  const float* p = x + row * F;
  if (VEC) {
    const int c = c0 + 4 * gl;
    return c < F ? __ldg(reinterpret_cast<const float4*>(p + c)) : zero4();
  }
  const int c = c0 + gl;
  float4 v;
  v.x = c < F ? __ldg(p + c) : 0.f;
  v.y = c + G < F ? __ldg(p + c + G) : 0.f;
  v.z = c + 2 * G < F ? __ldg(p + c + 2 * G) : 0.f;
  v.w = c + 3 * G < F ? __ldg(p + c + 3 * G) : 0.f;
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

// A finished unit or fix-up entry: dest >= 0 is an output row, dest < 0
// partial -dest-1.
template <bool VEC, int G>
__device__ __forceinline__ void finish(float* out, float4* part, int dest, int F, int c0,
                                       int gl, int pofs, int pstride, const float4& acc) {
  if (dest >= 0) {
    store_out<VEC, G>(out, dest, F, c0, gl, acc);
  } else {
    part[(int64_t)(-dest - 1) * pstride + pofs] = acc;
  }
}

// The head of each of the lane's 4 columns (load_row's order); H for a
// column past the H heads.
template <bool VEC, int G>
__device__ __forceinline__ void lane_heads(const Src& s, int c0, int gl, int (&hc)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = VEC ? c0 + 4 * gl + m : c0 + gl + G * m;
    hc[m] = min(c / s.head_dim, s.H);
  }
}

// Weight row `hid`'s weights of the lane's 4 columns (0 past H heads).
__device__ __forceinline__ float4 head_w4(const Src& s, int hid, const int (&hc)[4]) {
  const float* p = s.w_heads + (int64_t)hid * s.H;
  return make_float4(hc[0] < s.H ? __ldg(p + hc[0]) : 0.f, hc[1] < s.H ? __ldg(p + hc[1]) : 0.f,
                     hc[2] < s.H ? __ldg(p + hc[2]) : 0.f, hc[3] < s.H ? __ldg(p + hc[3]) : 0.f);
}

template <bool VEC, int G, int HM>
__global__ void __launch_bounds__(kThreads)
edge_row_kernel(Src s, int F, const int* __restrict__ cols,
                const int* __restrict__ unit_dest, int n_units,
                const int* __restrict__ tasks, int n_tasks,
                const int* __restrict__ zero_runs, float* out, float4* part) {
  constexpr int kB = G < kBatch ? G : kBatch;
  const int gl = threadIdx.x % G;
  const int task = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) / G);
  const int c0 = blockIdx.y * kCols;
  const int pofs = blockIdx.y * G + gl, pstride = gridDim.y * G;  // in float4s
  int j = 0, j_end = 0, u = 0;
  if (task < n_tasks) {
    j = __ldg(tasks + 3 * task);
    u = __ldg(tasks + 3 * task + 1);
    j_end = __ldg(tasks + 3 * task + 3);
    const int z1 = __ldg(tasks + 3 * task + 5);
    for (int z = __ldg(tasks + 3 * task + 2); z < z1; ++z) {  // the task's empty rows
      const int r0 = __ldg(zero_runs + 2 * z), r1 = r0 + __ldg(zero_runs + 2 * z + 1);
      for (int r = r0; r < r1; ++r) store_out<VEC, G>(out, r, F, c0, gl, zero4());
    }
  }
  // the current unit's destination and the next one's
  int dest = 0, dest_next = 0;
  if (j < j_end) {
    dest = __ldg(unit_dest + u);
    if (u + 1 < n_units) dest_next = __ldg(unit_dest + u + 1);
  }
  // the heads of the lane's columns (kHeadsLane: all four are hc[0])
  int hc[4] = {0, 0, 0, 0};
  if (HM != kHeadsNone) lane_heads<VEC, G>(s, c0, gl, hc);
  float4 acc = zero4();
  // entries G at a time, one per lane, the next G in flight; every group
  // of the warp runs the warp's largest trip count, the shuffles being
  // warp-wide
  const int max_it = (int)__reduce_max_sync(kFull, (unsigned)((j_end - j + G - 1) / G));
  int rc = kNoRow, ic = 0;
  float wc = 0.f;
  if (j + gl < j_end) resolve<HM>(s, cols, j + gl, rc, wc, ic);
  for (int it = 0; it < max_it; ++it) {
    const int base = j + it * G;
    int rn = kNoRow, idn = 0;
    float wn = 0.f;
    if (base + G + gl < j_end) resolve<HM>(s, cols, base + G + gl, rn, wn, idn);
    const int n_valid = j_end - base;
#pragma unroll
    for (int kb = 0; kb < G; kb += kB) {
      float4 v[kB];
      float w[kB];    // kHeadsNone: the entry's weight; kHeadsLane: the lane's head's
      float4 wv[kB];  // kHeadsCol: each column's head weight
      int ck[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        ck[b] = __shfl_sync(kFull, rc, kb + b, G);
        const int r = ck[b] & kRowMask;
        const bool live = kb + b < n_valid && r != kNoRow;
        if (HM == kHeadsNone) {
          w[b] = __shfl_sync(kFull, wc, kb + b, G);
        } else {
          const int hid = __shfl_sync(kFull, ic, kb + b, G);
          if (HM == kHeadsLane)
            w[b] = live && hc[0] < s.H ? __ldg(s.w_heads + (int64_t)hid * s.H + hc[0]) : 0.f;
          else
            wv[b] = live ? head_w4(s, hid, hc) : zero4();
        }
        v[b] = live ? load_row<VEC, G>(s.vals, r, F, c0, gl) : zero4();
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (kb + b < n_valid) {
          if (HM == kHeadsCol) fma4v(acc, wv[b], v[b]);
          else fma4(acc, w[b], v[b]);
          if (ck[b] < 0) {  // the unit's last entry
            finish<VEC, G>(out, part, dest, F, c0, gl, pofs, pstride, acc);
            acc = zero4();
            ++u;
            dest = dest_next;
            if (kb + b + 1 < n_valid && u + 1 < n_units) dest_next = __ldg(unit_dest + u + 1);
          }
        }
      }
    }
    rc = rn;
    wc = wn;
    ic = idn;
  }
}

// One group per entry (dest, p0, p1) of one fix-up level.
template <bool VEC, int G>
__global__ void __launch_bounds__(kThreads)
edge_fix_kernel(const int* __restrict__ fix, int n_fix, float4* part, float* out, int F) {
  const int e = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) / G);
  if (e >= n_fix) return;
  const int gl = threadIdx.x % G;
  const int c0 = blockIdx.y * kCols;
  const int pofs = blockIdx.y * G + gl, pstride = gridDim.y * G;
  const int dest = __ldg(fix + 3 * e), p0 = __ldg(fix + 3 * e + 1), p1 = __ldg(fix + 3 * e + 2);
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
  finish<VEC, G>(out, part, dest, F, c0, gl, pofs, pstride, acc);
}

struct Args {
  Src src;
  int F;
  const int* cols;
  const int* unit_dest;
  int n_units;
  const int* tasks;
  int n_tasks;
  const int* zero_runs;
  const int* fix;
  const int* fix_levels;
  int n_levels;
  float4* part;
  float* out;
  cudaStream_t stream;
};

template <bool VEC, int G, int HM>
int launch(const Args& a) {
  const int n_slabs = G == 32 ? (a.F + kCols - 1) / kCols : 1;
  if (a.n_tasks > 0) {
    const dim3 grid((unsigned)(((int64_t)a.n_tasks * G + kThreads - 1) / kThreads), n_slabs);
    edge_row_kernel<VEC, G, HM><<<grid, kThreads, 0, a.stream>>>(
        a.src, a.F, a.cols, a.unit_dest, a.n_units, a.tasks, a.n_tasks, a.zero_runs, a.out,
        a.part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = 0; l < a.n_levels; ++l) {
    const int n = a.fix_levels[l + 1] - a.fix_levels[l];
    if (n <= 0) continue;
    const dim3 grid((unsigned)(((int64_t)n * G + kThreads - 1) / kThreads), n_slabs);
    edge_fix_kernel<VEC, G><<<grid, kThreads, 0, a.stream>>>(
        a.fix + 3 * (int64_t)a.fix_levels[l], n, a.part, a.out, a.F);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <bool VEC, int HM>
int launch_lanes(const Args& a) {
  if (a.F > 64) return launch<VEC, 32, HM>(a);
  if (a.F > 32) return launch<VEC, 16, HM>(a);
  if (a.F > 16) return launch<VEC, 8, HM>(a);
  if (a.F > 8) return launch<VEC, 4, HM>(a);
  return launch<VEC, 2, HM>(a);
}

}  // namespace

// vals f32 [n_rows, F] row-major; src int32 [n_src] or null; cols int32
// [S]; slot int32 [S] or null (needed by by_slot and w_slots); w_slots f32
// [T*E] or null; w_edge f32 [n_w] or null; w_heads f32 [n_wh, H] or null
// (then w_slots and w_edge null, head_dim >= 1; its rows in slot order with
// by_slot, else in edge order); unit_dest int32 [n_units];
// tasks int32 [n_tasks + 1, 3]; zero_runs int32 [Z, 2]; fix int32 [M, 3]
// with its level bounds fix_levels (host memory, n_levels + 1 ints); part
// f32 scratch [n_parts, ceil(F/128)*128 at F > 64, else 4*G] (16-byte
// aligned); out f32 [n_out, F]. n_rows must stay below 2**31 - 1. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int geot_edge_row_sum(const void* vals, int64_t n_rows, int F, const void* src,
                                 int64_t n_src, int64_t e_base, const void* cols,
                                 const void* slot, int by_slot, const void* w_slots,
                                 const void* w_edge, int64_t n_w, int skip_zero,
                                 const void* w_heads, int64_t n_wh, int H, int head_dim,
                                 const void* unit_dest, int n_units, const void* tasks,
                                 int n_tasks, const void* zero_runs, const void* fix,
                                 const int* fix_levels, int n_levels, void* part, void* out,
                                 void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  // a schedule with no unit reads no slot: an empty slot array may be null
  if (n_rows >= kNoRow || (n_units > 0 && (by_slot || w_slots != nullptr) && slot == nullptr))
    return (int)cudaErrorInvalidValue;
  if (w_heads != nullptr && (H < 1 || head_dim < 1 || w_slots != nullptr || w_edge != nullptr))
    return (int)cudaErrorInvalidValue;
  const Src s{(const float*)vals, n_rows, (const int*)src, n_src, e_base, (const int*)slot,
              by_slot, (const float*)w_slots, (const float*)w_edge, n_w, skip_zero,
              (const float*)w_heads, n_wh, H, head_dim};
  const Args a{s, F, (const int*)cols, (const int*)unit_dest, n_units, (const int*)tasks,
               n_tasks, (const int*)zero_runs, (const int*)fix, fix_levels, n_levels,
               (float4*)part, (float*)out, (cudaStream_t)stream};
  const uintptr_t va = (uintptr_t)vals, oa = (uintptr_t)out;
  const bool vec = (F % 4 == 0) && (oa % 16 == 0) && (va % 16 == 0);
  if (w_heads == nullptr) return vec ? launch_lanes<true, kHeadsNone>(a)
                                     : launch_lanes<false, kHeadsNone>(a);
  if (GEOT_HEADS_LANE && vec && head_dim % 4 == 0) return launch_lanes<true, kHeadsLane>(a);
  return vec ? launch_lanes<true, kHeadsCol>(a) : launch_lanes<false, kHeadsCol>(a);
}
