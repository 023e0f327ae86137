// BAT SDDMM for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `sddmm_bat` / `_sddmm_bat_kernel`
// (geot_tpu/ops/pallas_segment.py:1010-1100). For a block-aligned-tile plan
// (out_block[T], vblock[T], dst3[(n_vblocks+1)*e_tile]) it computes the
// per-edge dot products, in edge order,
//
//   out[v*e_tile + i] = < a[dst3[v, i]], b_vals[v*e_tile + i] >
//
// for every real edge of value block v whose tile (the one with vblock = v
// and out_block = the edge's window) exists. Pad slots, -1 dst ids, the
// sentinel block n_vblocks and edges without a tile stay at the zero the
// caller filled `out` with. Rows of `a` past a_rows and rows of `b_vals`
// past b_rows (the ragged tail, window pad rows of chunk pad tiles) read as
// zero: no load goes past either buffer.
//
// On the TPU every tile writes a partial row of dots, selected on the MXU
// with a one-hot of the tile's dst window, and the partials are summed per
// value block afterwards. Here each real edge has exactly one owner tile
// (a plan never repeats a (vblock, out_block) pair among its real tiles:
// `bat_plan_from_host` checks it), so the owner writes the edge's dot
// once: no atomics, no second pass, and a rerun is bit-identical.
//
// Bound on the H100: bytes. At ogbn-arxiv widths (1.34 M edges, F_pad 128)
// it must read b_vals (~684 MB), the a rows of every dst node (~87 MB) and
// dst3, and write out (~5 MB): ~0.78 GB, ~0.23 ms at 3.35 TB/s; the FLOPs
// (2 per product, ~0.34 GFLOP) take ~5 us at the f32 rate. So the design
// reads each b_vals row once with 16-byte coalesced loads (lane l owns
// columns 4l..4l+3 of each 128-column slab, a warp reads a 512-byte row),
// keeps 8 edges' rows in flight per warp, and lets the a rows of a window,
// which the window's edges share, come from L2. One block of 8 warps per
// tile; each warp takes 32 of the tile's edge slots at a time, picks the
// in-window ones with a ballot, and finishes each dot with a warp shuffle
// reduction. The dots are f32 FMAs: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;  // columns per slab: 32 lanes x float4
constexpr int kBatch = 8;   // edges in flight per warp

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads)
sddmm_bat_kernel(const float* __restrict__ a, int64_t a_rows,
                 const float* __restrict__ b, int64_t b_rows, int F,
                 const int* __restrict__ dst3, int n_vblocks,
                 const int* __restrict__ out_block,
                 const int* __restrict__ vblock, int e_tile, int s_tile,
                 float* __restrict__ out) {
  const int t = blockIdx.x;
  const int vb = __ldg(vblock + t);
  if (vb < 0 || vb >= n_vblocks) return;  // pad tile: the sentinel block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t win_base = (int64_t)__ldg(out_block + t) * s_tile;
  const int64_t base = (int64_t)vb * e_tile;

  for (int j = warp * 32; j < e_tile; j += kThreads) {
    // this lane's edge slot, and its row in the window (-1: not this tile's)
    const int64_t d = __ldg(dst3 + base + j + lane);
    const int local = (d >= 0 && d - win_base >= 0 && d - win_base < s_tile)
                          ? (int)(d - win_base) : -1;
    unsigned mask = __ballot_sync(0xffffffffu, local >= 0);
    while (mask) {
      int n = 0;
      int64_t arow[kBatch], brow[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int sl = mask ? __ffs(mask) - 1 : 0;
        if (mask) { mask &= mask - 1; ++n; }
        arow[k] = win_base + __shfl_sync(0xffffffffu, local, sl);
        brow[k] = base + j + sl;
        ok[k] = k < n && arow[k] < a_rows && brow[k] < b_rows;
      }
      float acc[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) acc[k] = 0.f;
      for (int c = 4 * lane; c < F; c += kCols) {
        float4 av[kBatch], bv[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          av[k] = ok[k] ? __ldg(reinterpret_cast<const float4*>(a + arow[k] * F + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          bv[k] = ok[k] ? __ldg(reinterpret_cast<const float4*>(b + brow[k] * F + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) acc[k] = dot4(av[k], bv[k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
      // lane k writes edge k of the batch: every lane holds every total
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (lane == k && k < n) out[brow[k]] = acc[k];
    }
  }
}

}  // namespace

// a [a_rows, F] and b [b_rows, F] f32 row-major (F % 128 == 0, 16-byte
// aligned); dst3 int32 [(n_vblocks+1)*e_tile]; out_block and vblock int32
// [T]; out f32 [(n_vblocks+1)*e_tile], zero-filled by the caller.
// e_tile % 32 == 0. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int geot_sddmm_bat(const void* a, int64_t a_rows, const void* b,
                              int64_t b_rows, int F, const void* dst3,
                              int n_vblocks, const void* out_block,
                              const void* vblock, int T, int e_tile,
                              int s_tile, void* out, void* stream) {
  if (T <= 0 || F <= 0) return (int)cudaSuccess;
  sddmm_bat_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, a_rows, (const float*)b, b_rows, F, (const int*)dst3,
      n_vblocks, (const int*)out_block, (const int*)vblock, e_tile, s_tile,
      (float*)out);
  return (int)cudaGetLastError();
}
