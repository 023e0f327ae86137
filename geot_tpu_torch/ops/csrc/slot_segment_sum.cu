// Transposed slot-layout segment sum for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces plan_segment_sum_pr of geot_tpu/ops/pallas_segment.py (:1348,
// `_pr_kernel` :119-144) over a slot plan (SegmentPlan: T tiles of E slots,
// tile t in output window out_block[t], out_block non-decreasing), with the
// edges on the contiguous axis:
//
//   out_t[:, dst[t*E + j]] += w[t*E + j] * vals_t[:, t*E + j]   for each slot
//                                                              with w != 0
//
// with dst[t*E + j] in window out_block[t]. It reads vals_t [N, ld_in] and
// writes out_t [N, n_windows*s_tile]. Every row of every window is written
// exactly once (zeros included), with no atomics, so reruns are
// bit-identical. The sums are float32. The N rows are read in place: no
// padding to 128 lanes. (The row-major slot sums, sr at any width and
// sr_packed, are the row-ordered edge sum of edge_row_sum.cu, which reads
// x[src[e]] itself.)
//
// A slot of weight 0 is not read. A plan's pad slots have weight 0 and hold
// their window's base row, out of dst order (after a tile's real slots, and
// before them when the plan is pack-aligned); skipping them leaves every
// tile's slots in dst order. A real edge of weight 0 is skipped the same
// way, so a skipped slot may also sit inside one row's run of slots. The
// TPU kernel adds 0 * v there, which is the same sum wherever v is finite.
//
// Bound on the H100: bytes. At the flickr shape (981,504 slots) pr on
// [8, T*E] reads a few tens of MB, so launch latency bounds it. The flops
// (2 per value) are negligible.
//
// The TPU grid runs the tiles in order and carries a window's sum in VMEM;
// Hopper blocks run in no order. So:
//
//  1. slot_tile_kernel, one block of 8 warps per (tile, column slab). Each
//     warp sums a contiguous eighth of the tile's slots in order and writes
//     the rows whose slots all lie inside its eighth directly (and the empty
//     rows between them); warp 0 then merges the warps' first and last rows
//     in warp order. The tile's first and last rows go, as partial sums, to
//     a scratch buffer. A power-law hub row spanning many tiles is summed
//     tile by tile in parallel, never by one block.
//  2. slot_window_kernel, one block of 8 warps per (window, slab), finds the
//     window's tiles (binary search over out_block); each warp walks a
//     contiguous eighth of them in order, adds the partials of consecutive
//     tiles that share a row and writes the rows complete within its
//     eighth and the empty rows between them; warp 0 merges the warps'
//     first and last rows in warp order. (The first design, one warp per
//     window, walked the 900 tiles of a power-law head window in 113
//     dependent rounds.)
//
// A warp takes G lanes per slot, each lane 4 of the N rows: G = N_pad / 4
// for N_pad = 8, 16, 32 or 64 rows, G = 32 (a 128-row slab) past 64. With
// G < 32 a warp reads P = 32 / G consecutive slots at once (the TPU
// kernel's packing of 128 / N edges into one lane row), adds equal rows
// among them with a segmented suffix sum over shuffles, and then takes the
// runs in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;      // slot groups in flight per warp
constexpr int kTileBatch = 8;  // tiles whose partials are in flight per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

__device__ __forceinline__ float4 scale4(float s, const float4& v) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float4 shfl4(const float4& v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__device__ __forceinline__ float4 shfl_down4(const float4& v, int d) {
  return make_float4(__shfl_down_sync(kFull, v.x, d), __shfl_down_sync(kFull, v.y, d),
                     __shfl_down_sync(kFull, v.z, d), __shfl_down_sync(kFull, v.w, d));
}

__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Rows col..col+3 of slot `i` of v [F, ld] (element (c, i) at c*ld + i);
// zero past F.
__device__ __forceinline__ float4 load4(const float* __restrict__ v, int64_t i, int F,
                                        int64_t ld, int col) {
  float r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cc = col + c;
    r[c] = cc < F ? __ldg(v + (int64_t)cc * ld + i) : 0.f;
  }
  return make_float4(r[0], r[1], r[2], r[3]);
}

// Rows col..col+3 of output column `row` of o [F, ld] = a; nothing past F.
__device__ __forceinline__ void store4(float* __restrict__ o, int64_t row, int F,
                                       int64_t ld, int col, const float4& a) {
  const float r[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cc = col + c;
    if (cc < F) o[(int64_t)cc * ld + row] = r[c];
  }
}

// The rows of window `win` as one warp sees them: group g of P = 32/G
// groups, lane gl of G in its group, columns col..col+3. Group 0 writes a
// row; a range of zero rows is shared by the groups.
template <int G>
struct Rows {
  float* out;
  int64_t win_base, ld;
  int F, col, g;
  __device__ __forceinline__ void put(int r, const float4& a) const {
    if (g == 0) store4(out, win_base + r, F, ld, col, a);
  }
  __device__ __forceinline__ void zeros(int lo, int hi) const {
    for (int r = lo + g; r < hi; r += 32 / G) store4(out, win_base + r, F, ld, col, zero4());
  }
};

template <int G>
__global__ void __launch_bounds__(kThreads)
slot_tile_kernel(const float* __restrict__ vals, int F, int64_t ld_in,
                 const int* __restrict__ dst, const float* __restrict__ w,
                 const int* __restrict__ out_block, int E, int s_tile,
                 float* __restrict__ out, int64_t ld_out, int* __restrict__ part_rows,
                 float* __restrict__ part_vals, int Fp) {
  constexpr int P = 32 / G;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G, gl = lane % G;
  const int col = blockIdx.y * (4 * G) + 4 * gl;
  const int win = __ldg(out_block + t);
  const int base = win * s_tile;
  const Rows<G> o{out, (int64_t)base, ld_out, F, col, g};
  const int64_t slot0 = (int64_t)t * E;
  // this warp's slots: a contiguous run, a multiple of P long
  const int seg = ((E + kWarps - 1) / kWarps + P - 1) / P * P;
  const int j_begin = min(warp * seg, E), j_end = min(j_begin + seg, E);

  __shared__ int s_row[2 * kWarps];         // [warp][first, last] row
  __shared__ float4 s_part[2 * kWarps][32];  // their partial sums

  // this warp's runs: the first is kept (it may continue the previous
  // warp's last row), the middle ones are complete and written, the last is
  // kept (it may continue into the next warp). Every group holds the same
  // sums (for its own columns).
  float4 acc = zero4(), first_acc = zero4();
  int cur = -1, first_row = -1;
  for (int j0 = j_begin; j0 < j_end; j0 += kBatch * P) {
    int rk[kBatch];
    float wk[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * P + g;
      wk[k] = j < j_end ? __ldg(w + slot0 + j) : 0.f;
      rk[k] = wk[k] != 0.f ? __ldg(dst + slot0 + j) - base : -1;
    }
    float4 vk[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      vk[k] = rk[k] >= 0 ? scale4(wk[k], load4(vals, slot0 + j0 + k * P + g, F,
                                                     ld_in, col))
                         : zero4();
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int r = rk[k];
      float4 v = vk[k];
      if (P == 1) {
        if (r < 0) continue;  // warp-uniform: all lanes hold the one slot
        if (r != cur) {
          if (cur >= 0) {
            if (first_row < 0) { first_row = cur; first_acc = acc; }
            else o.put(cur, acc);
            o.zeros(cur + 1, r);  // empty rows between two runs of this warp
          }
          cur = r;
          acc = zero4();
        }
        add4(acc, v);
        continue;
      }
      // P slots in flight, one per group, real rows non-decreasing over the
      // groups; a skipped slot (a pad, or a real edge of weight 0) holds -1
      // and zeros and may sit between two slots of one row. A segmented
      // suffix sum over runs of equal adjacent groups: `end` marks a group
      // whose run stops there, and a group stops adding once its range
      // holds an end, so a run never reaches past a skipped slot. After
      // it, the first group of each run holds the run's sum.
      const int r_next = __shfl_down_sync(kFull, r, G);  // every lane shuffles
      int end = g == P - 1 || r_next != r;
#pragma unroll
      for (int off = 1; off < P; off <<= 1) {
        const float4 vo = shfl_down4(v, off * G);
        const int end_o = __shfl_down_sync(kFull, end, off * G);
        if (!end) add4(v, vo);  // !end: group g + off < P lies in the run
        end |= end_o;
      }
      const int r_prev = __shfl_up_sync(kFull, r, G);
      unsigned heads = __ballot_sync(kFull, gl == 0 && r >= 0 && (g == 0 || r_prev != r));
      while (heads) {
        const int h = __ffs(heads) - 1;
        heads &= heads - 1;
        const int rr = __shfl_sync(kFull, r, h);
        const float4 vv = shfl4(v, h + gl);
        if (rr != cur) {
          if (cur >= 0) {
            if (first_row < 0) { first_row = cur; first_acc = acc; }
            else o.put(cur, acc);
            o.zeros(cur + 1, rr);
          }
          cur = rr;
          acc = zero4();
        }
        add4(acc, vv);
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
  for (int i = 0; i < 2 * kWarps; ++i) {
    const int r = s_row[i];
    if (r < 0) continue;
    const float4 p = s_part[i][lane];
    if (r == mrow) { add4(macc, p); last_i = i; continue; }
    if (mrow >= 0) {
      if (tile_first < 0) { tile_first = mrow; tile_first_acc = macc; }
      else {
        if (pend >= 0) o.put(pend, pend_acc);
        pend = mrow;
        pend_acc = macc;
      }
      // rows between a warp's first and last run were written by that warp
      const bool same_warp = (last_i % 2 == 0) && (i == last_i + 1);
      if (!same_warp) o.zeros(mrow + 1, r);
    }
    mrow = r;
    macc = p;
    last_i = i;
  }
  if (mrow >= 0) {
    if (tile_first < 0) { tile_first = mrow; tile_first_acc = macc; }
    else {
      if (pend >= 0) o.put(pend, pend_acc);
      pend = mrow;
      pend_acc = macc;
    }
  }
  if (g == 0) {
    float4* pv = reinterpret_cast<float4*>(part_vals);
    pv[((int64_t)(2 * t) * Fp + col) >> 2] = tile_first_acc;
    pv[((int64_t)(2 * t + 1) * Fp + col) >> 2] = pend_acc;
  }
  if (blockIdx.y == 0 && lane == 0) {
    part_rows[2 * t] = tile_first;
    part_rows[2 * t + 1] = pend;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
slot_window_kernel(const int* __restrict__ part_rows, const float* __restrict__ part_vals,
                   int Fp, const int* __restrict__ out_block, int T, int F, int s_tile,
                   float* __restrict__ out, int64_t ld_out) {
  const int win = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / G, gl = lane % G;
  const int col = blockIdx.y * (4 * G) + 4 * gl;
  const Rows<G> o{out, (int64_t)win * s_tile, ld_out, F, col, g};
  const float4* pv = reinterpret_cast<const float4*>(part_vals);
  const int t_begin = lower_bound(out_block, T, win);
  const int t_end = lower_bound(out_block, T, win + 1);
  // this warp's tiles: a contiguous eighth of the window's
  const int per = (t_end - t_begin + kWarps - 1) / kWarps;
  const int w_begin = min(t_begin + warp * per, t_end), w_end = min(w_begin + per, t_end);

  __shared__ int s_row[2 * kWarps];
  __shared__ float4 s_part[2 * kWarps][32];

  // as in the tile kernel: the warp's first row is kept (it may continue
  // the previous warp's last), rows complete within the warp are written,
  // the last row is kept
  float4 acc = zero4(), first_acc = zero4();
  int cur = -1, first_row = -1;
  for (int t0 = w_begin; t0 < w_end; t0 += kTileBatch) {
    int a[kTileBatch], b[kTileBatch];
    float4 pa[kTileBatch], pb[kTileBatch];
#pragma unroll
    for (int k = 0; k < kTileBatch; ++k) {
      const int t = t0 + k;
      const bool in = t < w_end;
      a[k] = in ? __ldg(part_rows + 2 * t) : -1;
      b[k] = in ? __ldg(part_rows + 2 * t + 1) : -1;
      pa[k] = in ? __ldg(pv + (((int64_t)(2 * t) * Fp + col) >> 2)) : zero4();
      pb[k] = in ? __ldg(pv + (((int64_t)(2 * t + 1) * Fp + col) >> 2)) : zero4();
    }
#pragma unroll
    for (int k = 0; k < kTileBatch; ++k) {
      if (a[k] < 0) continue;  // a tile with no real slot
      if (a[k] != cur) {
        if (cur >= 0) {
          if (first_row < 0) { first_row = cur; first_acc = acc; }
          else o.put(cur, acc);
          o.zeros(cur + 1, a[k]);  // empty rows between tiles
        }
        cur = a[k];
        acc = zero4();
      }
      add4(acc, pa[k]);
      if (b[k] >= 0) {  // rows strictly between a and b: written by the tile
        if (first_row < 0) { first_row = cur; first_acc = acc; }
        else o.put(cur, acc);
        cur = b[k];
        acc = pb[k];
      }
    }
  }
  if (first_row < 0) {
    if (lane == 0) { s_row[2 * warp] = cur; s_row[2 * warp + 1] = -1; }
    s_part[2 * warp][lane] = acc;
  } else {
    if (lane == 0) { s_row[2 * warp] = first_row; s_row[2 * warp + 1] = cur; }
    s_part[2 * warp][lane] = first_acc;
    s_part[2 * warp + 1][lane] = acc;
  }
  __syncthreads();
  if (warp != 0) return;

  // merge the warps' boundary rows in warp order; every merged row is
  // complete, and the rows before, between and after them are zeros
  int mrow = -1, last_i = -1;
  float4 macc = zero4();
  for (int i = 0; i < 2 * kWarps; ++i) {
    const int r = s_row[i];
    if (r < 0) continue;
    const float4 p = s_part[i][lane];
    if (r == mrow) { add4(macc, p); last_i = i; continue; }
    if (mrow >= 0) {
      o.put(mrow, macc);
      // rows between a warp's first and last row were written by that warp
      const bool same_warp = (last_i % 2 == 0) && (i == last_i + 1);
      if (!same_warp) o.zeros(mrow + 1, r);
    } else {
      o.zeros(0, r);
    }
    mrow = r;
    macc = p;
    last_i = i;
  }
  if (mrow >= 0) o.put(mrow, macc);
  o.zeros(mrow + 1, s_tile);
}

template <int G>
int launch(const float* vals, int F, int64_t ld_in, const int* dst, const float* w,
           const int* out_block, int T, int n_windows, int E, int s_tile, float* out,
           int64_t ld_out, int* part_rows, float* part_vals, cudaStream_t s) {
  const int n_slabs = (F + 4 * G - 1) / (4 * G);
  const int Fp = n_slabs * 4 * G;
  if (T > 0) {
    slot_tile_kernel<G><<<dim3(T, n_slabs), kThreads, 0, s>>>(
        vals, F, ld_in, dst, w, out_block, E, s_tile, out, ld_out, part_rows, part_vals, Fp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slot_window_kernel<G><<<dim3(n_windows, n_slabs), kThreads, 0, s>>>(
      part_rows, part_vals, Fp, out_block, T, F, s_tile, out, ld_out);
  return (int)cudaGetLastError();
}

int launch_g(int G, const float* vals, int F, int64_t ld_in, const int* dst, const float* w,
             const int* out_block, int T, int n_windows, int E, int s_tile, float* out,
             int64_t ld_out, int* part_rows, float* part_vals, cudaStream_t s) {
#define GEOT_SLOT_ARGS vals, F, ld_in, dst, w, out_block, T, n_windows, E, s_tile, out, \
                       ld_out, part_rows, part_vals, s
  switch (G) {
    case 2: return launch<2>(GEOT_SLOT_ARGS);
    case 4: return launch<4>(GEOT_SLOT_ARGS);
    case 8: return launch<8>(GEOT_SLOT_ARGS);
    case 16: return launch<16>(GEOT_SLOT_ARGS);
    case 32: return launch<32>(GEOT_SLOT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GEOT_SLOT_ARGS
}

// lanes per slot for N rows: N_pad / 4 for N <= 64, else 32
int lanes_for(int F) {
  for (int d = 8; d <= 64; d *= 2)
    if (F <= d) return d / 4;
  return 32;
}

}  // namespace

// Scratch row width of the two kernels for N rows of vals_t.
extern "C" int geot_slot_scratch_width(int N) {
  const int G = lanes_for(N);
  return (N + 4 * G - 1) / (4 * G) * 4 * G;
}

// vals_t [N, ld_in] f32 (slot i of row c at c*ld_in + i, ld_in >= T*E), dst
// int32 [T*E] (the plan's dst_slots), w f32 [T*E] (the slot weights),
// out_block int32 [T] non-decreasing -> out_t [N, n_windows*s_tile] f32.
// Scratch part_rows int32 [2*T] and part_vals f32 [2*T,
// geot_slot_scratch_width(N)]. Launches two kernels on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int geot_plan_segment_sum_pr(const void* vals_t, int N, int64_t ld_in,
                                        const void* dst, const void* w,
                                        const void* out_block, int T, int n_windows, int E,
                                        int s_tile, void* out_t, void* part_rows,
                                        void* part_vals, void* stream) {
  if (n_windows <= 0 || N <= 0) return (int)cudaSuccess;
  return launch_g(lanes_for(N), (const float*)vals_t, N, ld_in, (const int*)dst,
                  (const float*)w, (const int*)out_block, T, n_windows, E, s_tile,
                  (float*)out_t, (int64_t)n_windows * s_tile, (int*)part_rows,
                  (float*)part_vals, (cudaStream_t)stream);
}
