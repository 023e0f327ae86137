// Per-edge, per-head dot products for Hopper (sm_90a), plain C interface for
// ctypes: the SDDMM.
//
// Replaces the TPU kernel `sddmm_bat` / `_sddmm_bat_kernel`
// (geot_tpu/ops/pallas_segment.py:1010-1100), and serves the per-edge dots
// the reference computes in plain XLA (`sddmm_coo_ref`, the attention
// gradient of `mh_spmm`, geot_tpu/ops/api.py:1083-1084, and slot_dyn's
// weight gradient, :1054):
//
//   out[e, h] = sum_{d < D} a[dst[e], h*D + d] * b[bidx(e), h*D + d]
//
// for the H = F / D heads of D columns of every edge e < n_edges, with
// bidx(e) = src[e] (the gathered form: a and b are node rows, both read in
// the kernel) or bidx(e) = e (the values form, the TPU kernel's contract:
// b in edge order). An edge with dst < 0 (the -1 pads of a BAT plan's dst3)
// gives 0, so does an edge past src's end; a row past a's or b's end reads
// as zero, and no load goes past either buffer. Every output is written
// once (zeros included): no atomics, no fix-up, and reruns are
// bit-identical. The dots are f32 FMAs: no tensor cores, no TF32.
//
// On the TPU each tile of a BAT plan selects its window's a rows with a
// one-hot matmul and reads b pre-gathered in edge order, and the port's
// first kernel kept that (a block per tile, b gathered into an [E, F] block
// first: 0.82 ms at ogbn-arxiv F 128 before a 0.38 ms kernel). Here the
// edges are walked in order (dst-sorted), each read straight from a and b:
//
//   - a group of G lanes takes kBatch consecutive edges (G = 32 per 128
//     columns at F > 64, else 16, 8, 4 or 2 at F <= 64, 32, 16, 8, so a
//     narrow row leaves no lane idle) and keeps their 2 * kBatch rows in
//     flight; consecutive groups take consecutive edges, so the a[dst] row
//     they share comes from L1 or L2;
//   - the columns are walked in sub-slabs in column order: with 16-byte
//     rows and head_dim % 4 == 0 a lane holds 4 consecutive columns of one
//     head (one 16-byte load of a and one of b, 4G columns a sub-slab), else
//     one column (G columns a sub-slab, each load coalesced over the
//     group), so heads may straddle a lane's 4 columns ((H, D) = (4, 7):
//     GAT's second layer) or a sub-slab ((3, 96));
//   - each lane's products are summed per head by a segmented scan over the
//     group's lanes (a fixed shuffle tree keyed by the lanes' heads); a
//     head that runs on into the next sub-slab carries its sum there, and
//     the lane holding a head's last column writes out[e, h].
//
// Bound on the H100: bytes. The gathered form reads each edge's a and b
// rows, which the graph's edges repeat: ogbn-arxiv's 87 MB of a and b at F
// 128 fit in the 50 MB L2 in part only, so rows come partly from DRAM, and
// the rows in flight hide its latency. The flops (2 per product) take a
// few microseconds at the f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kBatch = 4;      // edges in flight per group
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

struct Args {
  const float* a;
  int64_t a_rows;
  const float* b;
  int64_t b_rows;
  int F, D, H;
  const int* dst;
  int64_t n_edges;
  const int* src;  // nullptr: the values form, bidx(e) = e
  int64_t n_src;
  float* out;      // [n_edges, H]
};

// VEC: lane gl holds columns c0 + 4gl .. c0 + 4gl + 3 (one head: D % 4 ==
// 0), a sub-slab is 4G columns; else column c0 + gl, a sub-slab G columns.
template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_dot_kernel(Args p) {
  constexpr int W = VEC ? 4 * G : G;  // columns a sub-slab
  const int gl = threadIdx.x % G;
  const int64_t e0 = (((int64_t)blockIdx.x * kThreads + threadIdx.x) / G) * kBatch;
  // the group's edges: their a and b rows (-1: the edge adds nothing)
  int64_t ar[kBatch], br[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int64_t e = e0 + k;
    ar[k] = br[k] = -1;
    if (e < p.n_edges) {
      const int64_t d = __ldg(p.dst + e);
      const int64_t s = p.src == nullptr ? e : (e < p.n_src ? (int64_t)__ldg(p.src + e) : -1);
      if (d >= 0 && d < p.a_rows && s >= 0 && s < p.b_rows) {
        ar[k] = d;
        br[k] = s;
      }
    }
  }
  // a head running on from the previous sub-slab, and each edge's sum of it
  int carry_head = -1;
  float carry[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) carry[k] = 0.f;
  for (int c0 = 0; c0 < p.F; c0 += W) {
    const int col = VEC ? c0 + 4 * gl : c0 + gl;
    const int head = col < p.F ? col / p.D : p.H;  // H: a lane past the row
    // bit s: the lane 2^s to the left lies in this lane's head (the scan's
    // step s adds its value); the same for every edge of the group
    unsigned join = 0;
#pragma unroll
    for (int s = 0, off = 1; off < G; ++s, off <<= 1) {
      const int left = __shfl_up_sync(kFull, head, off, G);
      if (gl >= off && left == head) join |= 1u << s;
    }
    // this lane holds its head's last column
    const bool ends = head < p.H && col + (VEC ? 4 : 1) == (head + 1) * p.D;
    float v[kBatch];
    if (VEC) {
      float4 av[kBatch], bv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = ar[k] >= 0 && col < p.F;
        av[k] = ok ? __ldg(reinterpret_cast<const float4*>(p.a + ar[k] * p.F + col))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        bv[k] = ok ? __ldg(reinterpret_cast<const float4*>(p.b + br[k] * p.F + col))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) v[k] = dot4(av[k], bv[k]);
    } else {
      float av[kBatch], bv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool ok = ar[k] >= 0 && col < p.F;
        av[k] = ok ? __ldg(p.a + ar[k] * p.F + col) : 0.f;
        bv[k] = ok ? __ldg(p.b + br[k] * p.F + col) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) v[k] = av[k] * bv[k];
    }
    // the segmented inclusive scan over the group's lanes, per head
#pragma unroll
    for (int s = 0, off = 1; off < G; ++s, off <<= 1) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float left = __shfl_up_sync(kFull, v[k], off, G);
        if (join & (1u << s)) v[k] += left;
      }
    }
    const int next_head = __shfl_sync(kFull, ends ? -1 : (head < p.H ? head : -1), G - 1, G);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const float t = head == carry_head ? v[k] + carry[k] : v[k];
      if (ends && e0 + k < p.n_edges) p.out[(e0 + k) * p.H + head] = t;
      carry[k] = __shfl_sync(kFull, t, G - 1, G);
    }
    carry_head = next_head;
  }
}

template <int G>
int launch_g(const Args& p, bool vec, cudaStream_t stream) {
  const int64_t groups = (p.n_edges + kBatch - 1) / kBatch;
  const unsigned blocks = (unsigned)((groups * G + kThreads - 1) / kThreads);
  if (vec)
    edge_dot_kernel<G, true><<<blocks, kThreads, 0, stream>>>(p);
  else
    edge_dot_kernel<G, false><<<blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// a [a_rows, F] and b [b_rows, F] f32 row-major; dst int32 [n_edges]; src
// int32 [n_src] (the gathered form, bidx(e) = src[e]) or null (the values
// form, bidx(e) = e); F = H * head_dim; out f32 [n_edges, H], every element
// written. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int geot_edge_dots(const void* a, int64_t a_rows, const void* b, int64_t b_rows,
                              int F, int head_dim, const void* dst, int64_t n_edges,
                              const void* src, int64_t n_src, void* out, void* stream) {
  if (n_edges <= 0) return (int)cudaSuccess;
  if (F <= 0 || head_dim <= 0 || F % head_dim != 0) return (int)cudaErrorInvalidValue;
  const Args p{(const float*)a, a_rows, (const float*)b, b_rows, F, head_dim, F / head_dim,
               (const int*)dst, n_edges, (const int*)src, n_src, (float*)out};
  const bool vec = F % 4 == 0 && head_dim % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)b % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (F > 64) return launch_g<32>(p, vec, s);
  if (F > 32) return launch_g<16>(p, vec, s);
  if (F > 16) return launch_g<8>(p, vec, s);
  if (F > 8) return launch_g<4>(p, vec, s);
  return launch_g<2>(p, vec, s);
}
