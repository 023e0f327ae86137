// The edge softmax of a dst-sorted edge list for Hopper (sm_90a), forward
// and backward, plain C interface for ctypes: GAT's attention from its
// per-node terms, and `segment_softmax` of per-edge logits.
//
// Replaces no TPU kernel: the reference takes GAT's softmax in plain XLA
// (geot_tpu/ops/api.py:1589-1600 and `segment_softmax` :1650), and the
// port's first routes composed it from gathers, cub's segmented reductions
// (`torch.segment_reduce`, one segment per (row, head)) and elementwise
// passes: ~35 launches a layer forward, 1.7 ms, on ogbn-arxiv with 3 heads.
//
// Forward, for each destination row i (the edges e with dst[e] = i, a run
// of the sorted list) and head h:
//
//   l_e   = leaky_relu(alpha_src[src[e], h] + alpha_dst[i, h])   node terms
//           (or logits[e, h]: per-edge logits)
//   m     = max over the row of l_e;  s = sum over the row of exp(l_e - m)
//   att_e = exp(l_e - m) / max(s, 1e-16)
//
// Backward, from g = dL/datt: r = sum over the row of att_e g_e, gl_e =
// att_e (g_e - r) (per-edge logits: their gradient), gp_e = gl_e where the
// recomputed pre-activation is > 0, else gl_e * slope (torch's leaky_relu
// rule), dalpha_dst[i] = sum over the row of gp_e, and dalpha_src[j] = the
// sum of gp_e over j's out-edges, walked in src-sorted order through
// perm_t. All in f32 with expf and IEEE division.
//
// Bound on the H100: bytes, and the latency of the per-edge gathers. The
// least the forward moves is the row list, src, both node terms and att
// once: ~43.5 MB at ogbn-arxiv's 2.43 M edges and 3 heads, 0.013 ms at
// 3.35 TB/s. The rows are Zipf: median 9 edges, the largest 71,237, so no
// row may be walked by one warp.
//
// Schedule: the edge list is cut into chunks of kChunk = 32 * K consecutive
// edges, one warp a chunk, lane l holding edges l*K .. l*K + K - 1 of it
// (the index lists and the edge-order values staged through shared memory,
// so those loads and stores of the warp are coalesced; the node terms are
// gathered). A row's reductions over
// the chunk are a segmented scan keyed by the row: sequential over a lane's
// K edges, a shuffle scan over the lanes' tails, and a shuffle broadcast
// back of each piece's total, so every edge of a piece reads the same
// total. A row that lies inside its chunk is finished there. A row cut by a
// chunk boundary (a long row is cut into many) leaves one partial per
// piece: the piece's max and its sum of exp(l - piece max) forward, its sum
// of att*g backward. A fix-up kernel over the same chunks combines each cut
// row's partials in a fixed order (lanes over the pieces in order, then a
// fixed shuffle tree) and rewrites that piece's edges. Backward, each
// piece's sum of gp is one more partial, and dalpha_dst of a cut row is
// their fixed-order sum, taken by the src pass's fix-up. The src pass runs
// the same chunked sum over the src-sorted list, reading gp[perm_t[t]].
// Each output element is written by one lane, no sum uses atomics, and
// reruns are bit-identical.
//
// Every kernel is bound by the latency of its chains of dependent loads
// and shuffles, not by bytes: 4 edges a lane (K) keep the registers, and
// so the warps in flight, up. Measured on the H100 at ogbn-arxiv's shapes
// (3 heads, one call): K 4 took 0.082 ms forward and 0.166 ms backward, K 8
// 0.084 and 0.238; issuing a chunk's index loads together and the keys
// around it first, or cutting no row of at most a quarter of a chunk
// (windows that start at row ends), each made it slower.
//
// Heads: a warp takes HC <= 4 heads (blockIdx.y picks which), so any H
// runs; GAT's 1, 2, 3 or 4 heads take one pass.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;           // warps a block, one chunk each
constexpr int kThreads = 32 * kWarps;
constexpr int K = 4;                // edges a lane
constexpr int kChunk = 32 * K;      // edges a warp
constexpr int kPad = INT_MAX;       // the row of an edge past the chunk's end
constexpr unsigned kFull = 0xffffffffu;

struct OpMax {
  __device__ static float f(float a, float b) { return fmaxf(a, b); }
};
struct OpSum {
  __device__ static float f(float a, float b) { return a + b; }
};

struct Args {
  const int* keys;       // [E] each edge's row, ascending (dst)
  const int* ptr;        // [n_rows + 1] the rows' run boundaries
  int64_t E;
  int n_rows;
  int H;
  const float* logits;   // [E, H] per-edge logits, or null: the node terms
  const float* as;       // [n_src_rows, H] alpha_src
  const float* ad;       // [n_rows, H] alpha_dst
  const int* src;        // [E]
  int n_src_rows;
  float slope;
  float* att;            // [E, H]: written forward, read backward
  const float* g;        // [E, H] dL/datt
  float* gout;           // [E, H] gp (node terms) or dL/dlogits
  float* dad;            // [n_rows, H] dalpha_dst, zeroed by the caller
  float* pa;             // [n_chunks, 2, H] a piece's max / its sum of att*g
  float* pb;             // [n_chunks, 2, H] a piece's sum of exp / its sum of gp
  int64_t n_chunks;
  const int* perm;       // [E] perm_t, or null: no src pass
  const int* skeys;      // [E] src_t = src[perm_t], ascending
  const int* sptr;       // [n_src_rows + 1] src_t's run boundaries
  float* das;            // [n_src_rows, H] dalpha_src, zeroed by the caller
  float* ps;             // [n_chunks, 2, H] a src piece's sum of gp
};


// per warp: two staged index lists and one staged value block
template <int HC>
struct Smem {
  int ka[32 * (K + 1)];
  int kb[32 * (K + 1)];
  float f[32 * (K * HC + 1)];
};

// lane l's K edges sit at l * (K + 1) (ints) or l * (K * HC + 1) (values):
// odd strides, so the lanes' reads hit 32 banks
__device__ __forceinline__ void stage_ints(int (&v)[K], int* s, const int* g, int64_t c0,
                                           int64_t c1, int lane, int pad) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int i = lane + 32 * t;
    s[(i / K) * (K + 1) + i % K] = c0 + i < c1 ? __ldg(g + c0 + i) : pad;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = s[lane * (K + 1) + j];
  __syncwarp();
}

template <int HC>
__device__ __forceinline__ void stage_in(float (&v)[K][HC], float* s, const float* g,
                                         int64_t c0, int64_t c1, int H, int h0, int lane) {
#pragma unroll
  for (int t = 0; t < K * HC; ++t) {
    const int f = lane + 32 * t;
    const int i = f / HC, h = f - (f / HC) * HC;
    const bool ok = c0 + i < c1 && h0 + h < H;
    s[(i / K) * (K * HC + 1) + (i % K) * HC + h] = ok ? __ldg(g + (c0 + i) * H + h0 + h) : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h) v[j][h] = s[lane * (K * HC + 1) + j * HC + h];
  __syncwarp();
}

template <int HC>
__device__ __forceinline__ void stage_out(float* g, float* s, const float (&v)[K][HC],
                                          int64_t c0, int64_t c1, int H, int h0, int lane) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h) s[lane * (K * HC + 1) + j * HC + h] = v[j][h];
  __syncwarp();
#pragma unroll
  for (int t = 0; t < K * HC; ++t) {
    const int f = lane + 32 * t;
    const int i = f / HC, h = f - (f / HC) * HC;
    if (c0 + i < c1 && h0 + h < H)
      g[(c0 + i) * H + h0 + h] = s[(i / K) * (K * HC + 1) + (i % K) * HC + h];
  }
  __syncwarp();
}

// tot[j] = Op over the piece of key[j]'s row inside this warp's chunk, the
// same value for every edge of the piece. Keys ascend over (lane, j).
template <class Op, int HC>
__device__ __forceinline__ void seg_reduce(const float (&v)[K][HC], const int (&key)[K],
                                           int lane, float (&tot)[K][HC]) {
  float P[K][HC];  // inclusive prefix within the lane, then with its carry
#pragma unroll
  for (int h = 0; h < HC; ++h) P[0][h] = v[0][h];
#pragma unroll
  for (int j = 1; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h)
      P[j][h] = key[j] == key[j - 1] ? Op::f(P[j - 1][h], v[j][h]) : v[j][h];
  const int hk = key[0], tk = key[K - 1];
  // the lanes' tails, scanned: a lane's tail joins the one before iff their
  // keys are equal (sorted keys: then every lane between holds that key)
  float T[HC];
#pragma unroll
  for (int h = 0; h < HC; ++h) T[h] = P[K - 1][h];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ku = __shfl_up_sync(kFull, tk, off);
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      const float tu = __shfl_up_sync(kFull, T[h], off);
      if (lane >= off && ku == tk) T[h] = Op::f(tu, T[h]);
    }
  }
  // the carry into the lane's head piece: the scanned tail of the lane before
  {
    const int kc = __shfl_up_sync(kFull, tk, 1);
    float C[HC];
#pragma unroll
    for (int h = 0; h < HC; ++h) C[h] = __shfl_up_sync(kFull, T[h], 1);
    if (lane > 0 && kc == hk) {
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int h = 0; h < HC; ++h)
          if (key[j] == hk) P[j][h] = Op::f(C[h], P[j][h]);
    }
  }
  // Eh: the total of the piece holding the lane's head, taken where that
  // piece ends (the last lane with this head key), copied back leftwards
  float Eh[HC];
#pragma unroll
  for (int h = 0; h < HC; ++h) Eh[h] = P[0][h];
#pragma unroll
  for (int j = 1; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h)
      if (key[j] == hk) Eh[h] = P[j][h];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int kd = __shfl_down_sync(kFull, hk, off);
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      const float ed = __shfl_down_sync(kFull, Eh[h], off);
      if (lane + off < 32 && kd == hk) Eh[h] = ed;
    }
  }
  // the tail piece's total: the head's (one key in the lane), the next
  // lane's head total (the piece runs on), or the lane's own last prefix
  const int kn = __shfl_down_sync(kFull, hk, 1);
#pragma unroll
  for (int h = 0; h < HC; ++h) {
    const float en = __shfl_down_sync(kFull, Eh[h], 1);
    tot[K - 1][h] = hk == tk ? Eh[h] : (lane < 31 && kn == tk ? en : P[K - 1][h]);
  }
#pragma unroll
  for (int j = K - 2; j >= 0; --j)
#pragma unroll
    for (int h = 0; h < HC; ++h) tot[j][h] = key[j] == key[j + 1] ? tot[j + 1][h] : P[j][h];
}

// end[j]: edge j of the lane is the last of its piece in the chunk
__device__ __forceinline__ void piece_ends(bool (&end)[K], const int (&key)[K], int lane) {
  const int kn = __shfl_down_sync(kFull, key[0], 1);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) end[j] = key[j + 1] != key[j];
  end[K - 1] = lane == 31 || kn != key[K - 1];
}

__device__ __forceinline__ float leaky(float x, float slope) { return x > 0.f ? x : x * slope; }

// a fixed shuffle tree to lane 0, then lane 0's value to every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

struct Warp {
  int lane, wid, h0;
  int64_t c, c0, c1;
};

// this warp's chunk [c0, c1); false past the last chunk
__device__ __forceinline__ bool warp_chunk(const Args& p, Warp& w, int HC) {
  w.lane = threadIdx.x & 31;
  w.wid = threadIdx.x >> 5;
  w.c = (int64_t)blockIdx.x * kWarps + w.wid;
  w.h0 = blockIdx.y * HC;
  w.c0 = w.c * kChunk;
  w.c1 = w.c0 + kChunk < p.E ? w.c0 + kChunk : p.E;
  return w.c < p.n_chunks;
}

// The row of the piece of chunk [c0, c1) that is cut by a chunk boundary:
// side 0 the piece at the chunk's start (its row began before c0), side 1
// the piece at its end (its row began inside and runs past c1). -1: none.
__device__ __forceinline__ int cut_row(const int* keys, int64_t c0, int64_t c1, int64_t E,
                                       int n_rows, int side) {
  const int prev = c0 > 0 ? __ldg(keys + c0 - 1) : -1;
  int r;
  if (side == 0) {
    r = __ldg(keys + c0);
    if (r != prev) return -1;
  } else {
    r = __ldg(keys + c1 - 1);
    if (c1 >= E || r != __ldg(keys + c1) || r == prev) return -1;
  }
  return (unsigned)r < (unsigned)n_rows ? r : -1;
}

// slot of chunk q's piece of the row whose run starts at rb
__device__ __forceinline__ int64_t slot(int64_t q, int64_t rb, int H) {
  return (q * 2 + (rb < q * kChunk ? 0 : 1)) * H;
}

// sum over the row's pieces [rb, re) of part[slot] (fixed order), per head
template <int HC>
__device__ __forceinline__ void sum_pieces(float (&S)[HC], const float* part, int64_t rb,
                                           int64_t re, int H, int h0, int lane) {
#pragma unroll
  for (int h = 0; h < HC; ++h) S[h] = 0.f;
  for (int64_t q = rb / kChunk + lane; q <= (re - 1) / kChunk; q += 32) {
    const float* pq = part + slot(q, rb, H) + h0;
#pragma unroll
    for (int h = 0; h < HC; ++h)
      if (h0 + h < H) S[h] += __ldg(pq + h);
  }
#pragma unroll
  for (int h = 0; h < HC; ++h) S[h] = warp_sum(S[h]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int HC, bool NODE>
__global__ void __launch_bounds__(kThreads) softmax_fwd_main(Args p) {
  __shared__ Smem<HC> smem[kWarps];
  Warp w;
  if (!warp_chunk(p, w, HC)) return;
  Smem<HC>& s = smem[w.wid];
  const int lane = w.lane, H = p.H, h0 = w.h0;
  int key[K];
  stage_ints(key, s.ka, p.keys, w.c0, w.c1, lane, kPad);
  float l[K][HC];
  if (NODE) {
    int sv[K];
    stage_ints(sv, s.kb, p.src, w.c0, w.c1, lane, -1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool ok = (unsigned)key[j] < (unsigned)p.n_rows &&
                      (unsigned)sv[j] < (unsigned)p.n_src_rows;
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        const bool okh = ok && h0 + h < H;
        l[j][h] = okh ? leaky(__ldg(p.as + (int64_t)sv[j] * H + h0 + h) +
                                  __ldg(p.ad + (int64_t)key[j] * H + h0 + h), p.slope)
                      : 0.f;
      }
    }
  } else {
    stage_in<HC>(l, s.f, p.logits, w.c0, w.c1, H, h0, lane);
  }
  float m[K][HC], ex[K][HC], sum[K][HC];
  seg_reduce<OpMax, HC>(l, key, lane, m);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h) ex[j][h] = expf(l[j][h] - m[j][h]);
  seg_reduce<OpSum, HC>(ex, key, lane, sum);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h) l[j][h] = ex[j][h] / fmaxf(sum[j][h], 1e-16f);
  // every edge's att; a cut row's are rewritten by the fix-up
  stage_out<HC>(p.att, s.f, l, w.c0, w.c1, H, h0, lane);
  const int prev = w.c0 > 0 ? __ldg(p.keys + w.c0 - 1) : -1;
  const int next = w.c1 < p.E ? __ldg(p.keys + w.c1) : -1;
  bool end[K];
  piece_ends(end, key, lane);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!end[j] || w.c0 + lane * K + j >= w.c1 || (key[j] != prev && key[j] != next)) continue;
    const int64_t at = (w.c * 2 + (key[j] == prev ? 0 : 1)) * H + h0;
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      if (h0 + h < H) {
        p.pa[at + h] = m[j][h];
        p.pb[at + h] = sum[j][h];
      }
    }
  }
}

template <int HC, bool NODE>
__global__ void __launch_bounds__(kThreads) softmax_fwd_fix(Args p) {
  Warp w;
  if (!warp_chunk(p, w, HC)) return;
  const int lane = w.lane, H = p.H, h0 = w.h0;
  for (int side = 0; side < 2; ++side) {
    const int r = cut_row(p.keys, w.c0, w.c1, p.E, p.n_rows, side);
    if (r < 0) continue;
    const int64_t rb = __ldg(p.ptr + r), re = __ldg(p.ptr + r + 1);
    // the row's max, then its sum of exp(l - max) from the pieces' partials
    float M[HC], S[HC];
#pragma unroll
    for (int h = 0; h < HC; ++h) M[h] = -INFINITY;
    for (int64_t q = rb / kChunk + lane; q <= (re - 1) / kChunk; q += 32) {
      const int64_t at = slot(q, rb, H) + h0;
#pragma unroll
      for (int h = 0; h < HC; ++h)
        if (h0 + h < H) M[h] = fmaxf(M[h], __ldg(p.pa + at + h));
    }
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      M[h] = warp_max(M[h]);
      S[h] = 0.f;
    }
    for (int64_t q = rb / kChunk + lane; q <= (re - 1) / kChunk; q += 32) {
      const int64_t at = slot(q, rb, H) + h0;
#pragma unroll
      for (int h = 0; h < HC; ++h)
        if (h0 + h < H) S[h] += __ldg(p.pb + at + h) * expf(__ldg(p.pa + at + h) - M[h]);
    }
#pragma unroll
    for (int h = 0; h < HC; ++h) S[h] = fmaxf(warp_sum(S[h]), 1e-16f);
    const int64_t b = rb > w.c0 ? rb : w.c0, e = re < w.c1 ? re : w.c1;
    for (int64_t i = b + lane; i < e; i += 32) {
      const int sj = NODE ? __ldg(p.src + i) : 0;
      const bool ok = !NODE || (unsigned)sj < (unsigned)p.n_src_rows;
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        if (h0 + h >= H) continue;
        const float x = !ok ? 0.f
                        : NODE ? leaky(__ldg(p.as + (int64_t)sj * H + h0 + h) +
                                           __ldg(p.ad + (int64_t)r * H + h0 + h), p.slope)
                               : __ldg(p.logits + i * H + h0 + h);
        p.att[i * H + h0 + h] = expf(x - M[h]) / S[h];
      }
    }
  }
}

template <int HC, bool NODE>
__global__ void __launch_bounds__(kThreads) softmax_bwd_main(Args p) {
  __shared__ Smem<HC> smem[kWarps];
  Warp w;
  if (!warp_chunk(p, w, HC)) return;
  Smem<HC>& s = smem[w.wid];
  const int lane = w.lane, H = p.H, h0 = w.h0;
  int key[K];
  stage_ints(key, s.ka, p.keys, w.c0, w.c1, lane, kPad);
  float a[K][HC], gg[K][HC], r[K][HC];
  stage_in<HC>(a, s.f, p.att, w.c0, w.c1, H, h0, lane);
  stage_in<HC>(gg, s.f, p.g, w.c0, w.c1, H, h0, lane);
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h) r[j][h] = a[j][h] * gg[j][h];
  {
    float t[K][HC];
    seg_reduce<OpSum, HC>(r, key, lane, t);
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        r[j][h] = t[j][h];
        a[j][h] = a[j][h] * (gg[j][h] - t[j][h]);  // gl
      }
  }
  if (NODE) {
    int sv[K];
    stage_ints(sv, s.kb, p.src, w.c0, w.c1, lane, -1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool ok = (unsigned)key[j] < (unsigned)p.n_rows &&
                      (unsigned)sv[j] < (unsigned)p.n_src_rows;
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        const float x = ok && h0 + h < H ? __ldg(p.as + (int64_t)sv[j] * H + h0 + h) +
                                               __ldg(p.ad + (int64_t)key[j] * H + h0 + h)
                                         : 0.f;
        a[j][h] = x > 0.f ? a[j][h] : a[j][h] * p.slope;  // gp
      }
    }
  }
  // every edge's gp (or dlogits); a cut row's are rewritten by the fix-up
  stage_out<HC>(p.gout, s.f, a, w.c0, w.c1, H, h0, lane);
  if (NODE) seg_reduce<OpSum, HC>(a, key, lane, gg);  // the rows' sums of gp
  const int prev = w.c0 > 0 ? __ldg(p.keys + w.c0 - 1) : -1;
  const int next = w.c1 < p.E ? __ldg(p.keys + w.c1) : -1;
  bool end[K];
  piece_ends(end, key, lane);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!end[j] || w.c0 + lane * K + j >= w.c1) continue;
    if (key[j] == prev || key[j] == next) {
      const int64_t at = (w.c * 2 + (key[j] == prev ? 0 : 1)) * H + h0;
#pragma unroll
      for (int h = 0; h < HC; ++h)
        if (h0 + h < H) p.pa[at + h] = r[j][h];
    } else if (NODE && (unsigned)key[j] < (unsigned)p.n_rows) {
#pragma unroll
      for (int h = 0; h < HC; ++h)
        if (h0 + h < H) p.dad[(int64_t)key[j] * H + h0 + h] = gg[j][h];
    }
  }
}

template <int HC, bool NODE>
__global__ void __launch_bounds__(kThreads) softmax_bwd_fix(Args p) {
  Warp w;
  if (!warp_chunk(p, w, HC)) return;
  const int lane = w.lane, H = p.H, h0 = w.h0;
  for (int side = 0; side < 2; ++side) {
    const int r = cut_row(p.keys, w.c0, w.c1, p.E, p.n_rows, side);
    if (r < 0) continue;
    const int64_t rb = __ldg(p.ptr + r), re = __ldg(p.ptr + r + 1);
    float R[HC], D[HC];
    sum_pieces<HC>(R, p.pa, rb, re, H, h0, lane);
#pragma unroll
    for (int h = 0; h < HC; ++h) D[h] = 0.f;
    const int64_t b = rb > w.c0 ? rb : w.c0, e = re < w.c1 ? re : w.c1;
    for (int64_t i = b + lane; i < e; i += 32) {
      const int sj = NODE ? __ldg(p.src + i) : 0;
      const bool ok = !NODE || (unsigned)sj < (unsigned)p.n_src_rows;
#pragma unroll
      for (int h = 0; h < HC; ++h) {
        if (h0 + h >= H) continue;
        const float at = __ldg(p.att + i * H + h0 + h);
        float gp = at * (__ldg(p.g + i * H + h0 + h) - R[h]);
        if (NODE) {
          const float x = ok ? __ldg(p.as + (int64_t)sj * H + h0 + h) +
                                   __ldg(p.ad + (int64_t)r * H + h0 + h)
                             : 0.f;
          gp = x > 0.f ? gp : gp * p.slope;
          D[h] += gp;
        }
        p.gout[i * H + h0 + h] = gp;
      }
    }
    if (NODE) {
#pragma unroll
      for (int h = 0; h < HC; ++h) D[h] = warp_sum(D[h]);
      if (lane == 0) {
        const int64_t at = (w.c * 2 + side) * H + h0;
#pragma unroll
        for (int h = 0; h < HC; ++h)
          if (h0 + h < H) p.pb[at + h] = D[h];
      }
    }
  }
}

// dalpha_src: the sum of gp[perm_t[t]] over each src run of src_t
template <int HC>
__global__ void __launch_bounds__(kThreads) softmax_src_main(Args p) {
  __shared__ Smem<HC> smem[kWarps];
  Warp w;
  if (!warp_chunk(p, w, HC)) return;
  Smem<HC>& s = smem[w.wid];
  const int lane = w.lane, H = p.H, h0 = w.h0;
  int key[K], pv[K];
  stage_ints(key, s.ka, p.skeys, w.c0, w.c1, lane, kPad);
  stage_ints(pv, s.kb, p.perm, w.c0, w.c1, lane, -1);
  float v[K][HC], tot[K][HC];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int h = 0; h < HC; ++h)
      v[j][h] = (unsigned)pv[j] < (unsigned)p.E && h0 + h < H
                    ? __ldg(p.gout + (int64_t)pv[j] * H + h0 + h) : 0.f;
  seg_reduce<OpSum, HC>(v, key, lane, tot);
  const int prev = w.c0 > 0 ? __ldg(p.skeys + w.c0 - 1) : -1;
  const int next = w.c1 < p.E ? __ldg(p.skeys + w.c1) : -1;
  bool end[K];
  piece_ends(end, key, lane);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!end[j] || w.c0 + lane * K + j >= w.c1) continue;
    float* out;
    if (key[j] == prev || key[j] == next)
      out = p.ps + (w.c * 2 + (key[j] == prev ? 0 : 1)) * H + h0;
    else if ((unsigned)key[j] < (unsigned)p.n_src_rows)
      out = p.das + (int64_t)key[j] * H + h0;
    else
      continue;
#pragma unroll
    for (int h = 0; h < HC; ++h)
      if (h0 + h < H) out[h] = tot[j][h];
  }
}

// the cut rows' sums: dalpha_src over the src pieces (the src pass), and
// dalpha_dst over the dst pieces' sums of gp (the dst fix-up's), each taken
// by the chunk that holds the row's last piece (a side-0 piece ending in it)
template <int HC>
__global__ void __launch_bounds__(kThreads) softmax_cut_sums(Args p) {
  for (int pass = 0; pass < 2; ++pass) {
    const bool by_src = pass == 0;
    if (by_src && p.perm == nullptr) continue;
    const int* keys = by_src ? p.skeys : p.keys;
    const int n_rows = by_src ? p.n_src_rows : p.n_rows;
    const int* ptr = by_src ? p.sptr : p.ptr;
    Warp w;
    if (!warp_chunk(p, w, HC)) return;
    const int r = cut_row(keys, w.c0, w.c1, p.E, n_rows, 0);
    if (r < 0) continue;
    const int64_t rb = __ldg(ptr + r), re = __ldg(ptr + r + 1);
    if (re > w.c1) continue;  // not the row's last piece
    float S[HC];
    sum_pieces<HC>(S, by_src ? p.ps : p.pb, rb, re, p.H, w.h0, w.lane);
    if (w.lane == 0) {
      float* out = (by_src ? p.das : p.dad) + (int64_t)r * p.H + w.h0;
#pragma unroll
      for (int h = 0; h < HC; ++h)
        if (w.h0 + h < p.H) out[h] = S[h];
    }
  }
}

dim3 grid_of(const Args& p, int HC) {
  return dim3((unsigned)((p.n_chunks + kWarps - 1) / kWarps), (unsigned)((p.H + HC - 1) / HC));
}

template <int HC, bool NODE>
int run_fwd(const Args& p, cudaStream_t st) {
  const dim3 grid = grid_of(p, HC);
  softmax_fwd_main<HC, NODE><<<grid, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  softmax_fwd_fix<HC, NODE><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int HC, bool NODE>
int run_bwd(const Args& p, cudaStream_t st) {
  const dim3 grid = grid_of(p, HC);
  softmax_bwd_main<HC, NODE><<<grid, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  softmax_bwd_fix<HC, NODE><<<grid, kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !NODE) return (int)err;
  if (p.perm != nullptr) {
    softmax_src_main<HC><<<grid, kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  softmax_cut_sums<HC><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool NODE>
int run(const Args& p, cudaStream_t st, bool fwd) {
  switch (p.H) {
    case 1: return fwd ? run_fwd<1, NODE>(p, st) : run_bwd<1, NODE>(p, st);
    case 2: return fwd ? run_fwd<2, NODE>(p, st) : run_bwd<2, NODE>(p, st);
    case 3: return fwd ? run_fwd<3, NODE>(p, st) : run_bwd<3, NODE>(p, st);
    default: return fwd ? run_fwd<4, NODE>(p, st) : run_bwd<4, NODE>(p, st);
  }
}

bool bad_shape(int64_t E, int n_rows, int H, int64_t n_chunks) {
  return E >= kPad || H < 1 || n_rows < 0 || n_rows >= kPad ||
         n_chunks != (E + kChunk - 1) / kChunk;
}

}  // namespace

// Edges a chunk: the partial buffers hold [ceil(E / chunk), 2, H] floats.
extern "C" int geot_edge_softmax_chunk() { return kChunk; }

// keys int32 [E] ascending (each edge's row), ptr int32 [n_rows + 1] their
// run boundaries; logits f32 [E, H] (per-edge logits) or null, then as f32
// [n_src_rows, H], ad f32 [n_rows, H] and src int32 [E] (the node terms);
// att f32 [E, H] out; pa, pb f32 [n_chunks, 2, H] scratch. Launches on
// `stream` (2 kernels) and returns cudaGetLastError() (0 on success).
extern "C" int geot_edge_softmax_fwd(const void* keys, const void* ptr, int64_t E, int n_rows,
                                     int H, const void* logits, const void* as, const void* ad,
                                     const void* src, int n_src_rows, float slope, void* att,
                                     void* pa, void* pb, int64_t n_chunks, void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  if (bad_shape(E, n_rows, H, n_chunks) || (logits == nullptr && (as == nullptr ||
                                                                  ad == nullptr || src == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.keys = (const int*)keys;
  p.ptr = (const int*)ptr;
  p.E = E;
  p.n_rows = n_rows;
  p.H = H;
  p.logits = (const float*)logits;
  p.as = (const float*)as;
  p.ad = (const float*)ad;
  p.src = (const int*)src;
  p.n_src_rows = n_src_rows;
  p.slope = slope;
  p.att = (float*)att;
  p.pa = (float*)pa;
  p.pb = (float*)pb;
  p.n_chunks = n_chunks;
  const cudaStream_t st = (cudaStream_t)stream;
  return logits == nullptr ? run<true>(p, st, true) : run<false>(p, st, true);
}

// The backward, over the forward's keys and ptr: att and g f32 [E, H] in;
// gout f32 [E, H] out (gp with the node terms, else dL/dlogits). With the
// node terms (as, ad, src as forward): dad f32 [n_rows, H] and, where perm
// (int32 [E], perm_t), skeys (int32 [E], src_t ascending) and sptr (int32
// [n_src_rows + 1]) are given, das f32 [n_src_rows, H], both zeroed by the
// caller; pa, pb, ps f32 [n_chunks, 2, H] scratch. Launches on `stream`
// (2 kernels with per-edge logits, 3 or 4 with the node terms) and returns
// cudaGetLastError().
extern "C" int geot_edge_softmax_bwd(const void* keys, const void* ptr, int64_t E, int n_rows,
                                     int H, const void* as, const void* ad, const void* src,
                                     int n_src_rows, float slope, const void* att, const void* g,
                                     void* gout, void* dad, void* pa, void* pb, int64_t n_chunks,
                                     const void* perm, const void* skeys, const void* sptr,
                                     void* das, void* ps, void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  const bool node = as != nullptr;
  if (bad_shape(E, n_rows, H, n_chunks) ||
      (node && (ad == nullptr || src == nullptr || dad == nullptr)) ||
      (perm != nullptr && (skeys == nullptr || sptr == nullptr || das == nullptr ||
                           ps == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.keys = (const int*)keys;
  p.ptr = (const int*)ptr;
  p.E = E;
  p.n_rows = n_rows;
  p.H = H;
  p.as = (const float*)as;
  p.ad = (const float*)ad;
  p.src = (const int*)src;
  p.n_src_rows = n_src_rows;
  p.slope = slope;
  p.att = (float*)att;
  p.g = (const float*)g;
  p.gout = (float*)gout;
  p.dad = (float*)dad;
  p.pa = (float*)pa;
  p.pb = (float*)pb;
  p.n_chunks = n_chunks;
  p.perm = node ? (const int*)perm : nullptr;
  p.skeys = (const int*)skeys;
  p.sptr = (const int*)sptr;
  p.das = (float*)das;
  p.ps = (float*)ps;
  const cudaStream_t st = (cudaStream_t)stream;
  return node ? run<true>(p, st, false) : run<false>(p, st, false);
}
