// geot_tpu_torch native runtime: host-side graph preprocessing in C++ (a copy
// of geot_tpu/native/src/geot_native.cc; the port builds its own).
//
// TPU-native counterpart of the reference's native host layer: the
// MatrixMarket dataloader (`csrc/dataloader/dataloader.hpp:66-367`,
// `csrc/dataloader/mmio.hpp`) and the CPU-side scheduling work its CUDA
// wrappers do at launch time. Here the hot host path is SegmentPlan
// construction (the tile schedule that replaces GeoT's launch rules) plus
// edge sorting — O(nnz) passes that dominate preprocessing for
// ogbn-products-scale graphs, so they are implemented natively and
// multithreaded, exposed to Python via a plain C ABI (ctypes; no pybind11
// in this environment).
//
// Build: python -m geot_tpu_torch.native (g++ -O3 -shared -fPIC -std=c++17
// -pthread into build/geot_tpu_torch/).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// Run fn(t, lo, hi) over [0, n) split across threads. `min_items` guards
// against spawning threads for trivial work — callers with heavy per-item
// work pass a small value.
template <typename F>
void parallel_for(int64_t n, F fn, int64_t min_items = (1 << 14)) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(n, 1));
  if (nt <= 1 || n < min_items) {
    fn(0, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = cdiv(n, nt);
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(t, lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Counting sort of edges by destination (stable): the preprocessing step
// every fused op assumes (dst-sorted COO). O(nnz + num_nodes), parallel
// histogram. Returns the permutation `perm` such that dst[perm] is sorted.
// ---------------------------------------------------------------------------
int geot_sort_by_key(const int32_t* key, int64_t nnz, int32_t num_keys,
                     int32_t* perm_out) {
  if (nnz < 0 || num_keys <= 0) return -1;
  std::vector<int64_t> count(static_cast<int64_t>(num_keys) + 1, 0);
  // parallel histogram with per-thread counts; a separate atomic flags
  // out-of-range keys (an empty local[t] is NOT an error sentinel — thread
  // slots past the last spawned thread legitimately stay empty when
  // nnz < nt * chunk)
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(nnz, 1));
  std::vector<std::vector<int64_t>> local(nt);
  for (int t = 0; t < nt; ++t) local[t].assign(static_cast<int64_t>(num_keys), 0);
  std::atomic<int> bad_key{0};
  {
    std::vector<std::thread> ts;
    int64_t chunk = cdiv(nnz, nt);
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(nnz, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back([&, t, lo, hi] {
        auto& c = local[t];
        for (int64_t i = lo; i < hi; ++i) {
          int32_t k = key[i];
          if (k < 0 || k >= num_keys) { bad_key.store(1); return; }
          c[k]++;
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  if (bad_key.load()) return -2;  // out-of-range key
  for (int t = 0; t < nt; ++t)
    for (int64_t k = 0; k < num_keys; ++k) count[k + 1] += local[t][k];
  for (int64_t k = 0; k < num_keys; ++k) count[k + 1] += count[k];
  // parallel stable fill: thread t's starting cursor for key k is the global
  // prefix plus all lower-threads' counts of k, so threads fill their own
  // input ranges independently and stability is preserved.
  {
    std::vector<std::thread> ts;
    int64_t chunk = cdiv(std::max<int64_t>(nnz, 1), nt);
    // turn local[t] into per-thread cursors (exclusive prefix over threads)
    std::vector<std::vector<int64_t>> cursor(nt);
    for (int t = 0; t < nt; ++t) {
      cursor[t].assign(static_cast<int64_t>(num_keys), 0);
      for (int64_t k = 0; k < num_keys; ++k) {
        int64_t base = count[k];
        for (int tp = 0; tp < t; ++tp) base += local[tp][k];
        cursor[t][k] = base;
      }
    }
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min<int64_t>(nnz, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back([&, t, lo, hi] {
        auto& cur = cursor[t];
        for (int64_t i = lo; i < hi; ++i)
          perm_out[cur[key[i]]++] = static_cast<int32_t>(i);
      });
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// SegmentPlan construction (mirrors geot_tpu.graph.plan.build_segment_plan;
// see that module for the schedule invariants). Phase 1 returns sizes;
// phase 2 fills the slot arrays in parallel over output windows.
// ---------------------------------------------------------------------------
int64_t geot_plan_num_tiles(const int32_t* dst_sorted, int64_t nnz,
                            int32_t num_segments, int32_t e_tile,
                            int32_t s_tile) {
  if (e_tile <= 0 || s_tile <= 0 || num_segments <= 0) return -1;
  int64_t n_blocks = std::max<int64_t>(cdiv(num_segments, s_tile), 1);
  std::vector<int64_t> cnt(n_blocks, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t d = dst_sorted[i];
    if (d < 0 || d >= num_segments) return -2;
    if (i && d < dst_sorted[i - 1]) return -3;  // not sorted
    cnt[d / s_tile]++;
  }
  int64_t tiles = 0;
  for (int64_t b = 0; b < n_blocks; ++b)
    tiles += std::max<int64_t>(cdiv(cnt[b], e_tile), 1);
  return tiles;
}

int geot_build_plan(const int32_t* dst_sorted, const int32_t* src,
                    int64_t nnz, int32_t num_segments, int32_t e_tile,
                    int32_t s_tile,
                    // outputs, caller-allocated with num_tiles from phase 1:
                    int32_t* src_slots,   // [T*e_tile]
                    int32_t* dst_slots,   // [T*e_tile]
                    int32_t* edge_pos,    // [T*e_tile]
                    float* mask,          // [T*e_tile]
                    int32_t* out_block) { // [T]
  int64_t n_blocks = std::max<int64_t>(cdiv(num_segments, s_tile), 1);
  std::vector<int64_t> cnt(n_blocks, 0), edge_start(n_blocks + 1, 0),
      tile_start(n_blocks + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) cnt[dst_sorted[i] / s_tile]++;
  for (int64_t b = 0; b < n_blocks; ++b) {
    edge_start[b + 1] = edge_start[b] + cnt[b];
    tile_start[b + 1] =
        tile_start[b] + std::max<int64_t>(cdiv(cnt[b], e_tile), 1);
  }
  int64_t num_tiles = tile_start[n_blocks];

  // split blocks across threads by EDGE count (power-law graphs put most
  // edges in the first blocks; equal-block splits would serialize on one
  // thread)
  int nt_fill = hw_threads();
  std::vector<int64_t> bsplit;
  bsplit.push_back(0);
  for (int t = 1; t < nt_fill; ++t) {
    int64_t target = (nnz * t) / nt_fill;
    int64_t b = std::lower_bound(edge_start.begin(), edge_start.end(), target) -
                edge_start.begin();
    b = std::min<int64_t>(std::max<int64_t>(b, bsplit.back()), n_blocks);
    bsplit.push_back(b);
  }
  bsplit.push_back(n_blocks);
  auto fill_blocks = [&](int64_t blo, int64_t bhi) {
        for (int64_t b = blo; b < bhi; ++b) {
          int64_t t0 = tile_start[b], t1 = tile_start[b + 1];
          int32_t base = static_cast<int32_t>(b * s_tile);
          int64_t s0 = t0 * e_tile, s1 = t1 * e_tile;
          int64_t e0 = edge_start[b], e1 = edge_start[b + 1];
          int64_t n_e = e1 - e0;
          // real-edge prefix of the block's slot range, then padding tail —
          // each array filled contiguously (vectorizable), no per-slot
          // div/mod: within a block, slot == s0 + (e - e0).
          for (int64_t t = t0; t < t1; ++t) out_block[t] = static_cast<int32_t>(b);
          if (src) {
            std::memcpy(src_slots + s0, src + e0, n_e * sizeof(int32_t));
          } else {
            std::fill(src_slots + s0, src_slots + s0 + n_e, 0);
          }
          std::memcpy(dst_slots + s0, dst_sorted + e0, n_e * sizeof(int32_t));
          for (int64_t e = 0; e < n_e; ++e)
            edge_pos[s0 + e] = static_cast<int32_t>(e0 + e);
          std::fill(mask + s0, mask + s0 + n_e, 1.0f);
          std::fill(src_slots + s0 + n_e, src_slots + s1, 0);
          std::fill(dst_slots + s0 + n_e, dst_slots + s1, base);
          std::fill(edge_pos + s0 + n_e, edge_pos + s1, 0);
          std::fill(mask + s0 + n_e, mask + s1, 0.0f);
        }
  };
  {
    std::vector<std::thread> ts;
    for (size_t t = 0; t + 1 < bsplit.size(); ++t) {
      int64_t blo = bsplit[t], bhi = bsplit[t + 1];
      if (blo >= bhi) continue;
      ts.emplace_back([&, blo, bhi] { fill_blocks(blo, bhi); });
    }
    for (auto& th : ts) th.join();
  }
  (void)num_tiles;
  return 0;
}

// ---------------------------------------------------------------------------
// MatrixMarket loader (coordinate real/pattern/integer, general/symmetric)
// — parity with `read_mtx_file` (`csrc/dataloader/dataloader.hpp:66-150`).
// Phase 1 returns nnz (after symmetric expansion); phase 2 fills arrays.
// ---------------------------------------------------------------------------
struct MtxInfo {
  int64_t rows, cols, nnz_out;
  int symmetric, pattern;
};

static int mtx_parse_header(FILE* f, MtxInfo* info) {
  char line[1024];
  if (!fgets(line, sizeof line, f)) return -1;
  if (strncmp(line, "%%MatrixMarket", 14) != 0) return -2;
  info->symmetric = strstr(line, "symmetric") != nullptr;
  info->pattern = strstr(line, "pattern") != nullptr;
  if (strstr(line, "coordinate") == nullptr) return -3;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '%') continue;
    long long r, c, n;
    if (sscanf(line, "%lld %lld %lld", &r, &c, &n) != 3) return -4;
    info->rows = r;
    info->cols = c;
    info->nnz_out = n;
    return 0;
  }
  return -5;
}

int64_t geot_mtx_open(const char* path, int64_t* rows, int64_t* cols,
                      int* symmetric) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  MtxInfo info{};
  int rc = mtx_parse_header(f, &info);
  fclose(f);
  if (rc) return rc - 10;
  *rows = info.rows;
  *cols = info.cols;
  *symmetric = info.symmetric;
  // upper bound on output nnz (symmetric: off-diagonals duplicated)
  return info.symmetric ? 2 * info.nnz_out : info.nnz_out;
}

int64_t geot_mtx_read(const char* path, int32_t* row_out, int32_t* col_out,
                      float* val_out, int64_t cap) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  MtxInfo info{};
  if (mtx_parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  int64_t n = 0;
  char line[1024];
  for (int64_t i = 0; i < info.nnz_out; ++i) {
    if (!fgets(line, sizeof line, f)) break;
    long long r, c;
    double v = 1.0;
    int got = info.pattern ? sscanf(line, "%lld %lld", &r, &c)
                           : sscanf(line, "%lld %lld %lf", &r, &c, &v);
    if (got < 2) {
      fclose(f);
      return -3;
    }
    if (n >= cap) {
      fclose(f);
      return -4;
    }
    row_out[n] = static_cast<int32_t>(r - 1);
    col_out[n] = static_cast<int32_t>(c - 1);
    if (val_out) val_out[n] = static_cast<float>(v);
    ++n;
    if (info.symmetric && r != c) {
      if (n >= cap) {
        fclose(f);
        return -4;
      }
      row_out[n] = static_cast<int32_t>(c - 1);
      col_out[n] = static_cast<int32_t>(r - 1);
      if (val_out) val_out[n] = static_cast<float>(v);
      ++n;
    }
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// BAT (block-aligned-tile) incidence builder — mirrors
// geot_tpu.graph.plan.build_bat_plan_host's (window, value-block) run
// compaction + empty-window coverage tiles. Parallel over window ranges
// split by edge count (same load-balance trick as geot_build_plan).
// Phase 1 returns the tile count; phase 2 fills ob/vb.
// ---------------------------------------------------------------------------
static void bat_window_bounds(const int32_t* dst_sorted, int64_t nnz,
                              int64_t n_blocks, int32_t s_tile,
                              std::vector<int64_t>& edge_start) {
  // edge_start[w] = first edge of window w (dst sorted ascending)
  edge_start.assign(n_blocks + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) edge_start[dst_sorted[i] / s_tile + 1]++;
  for (int64_t w = 0; w < n_blocks; ++w) edge_start[w + 1] += edge_start[w];
}

int64_t geot_bat_num_tiles(const int32_t* dst_sorted, int64_t nnz,
                           int32_t num_segments, int32_t e_tile,
                           int32_t s_tile) {
  if (e_tile <= 0 || s_tile <= 0 || num_segments <= 0) return -1;
  int64_t n_blocks = std::max<int64_t>(cdiv(num_segments, s_tile), 1);
  for (int64_t i = 1; i < nnz; ++i)
    if (dst_sorted[i] < dst_sorted[i - 1]) return -3;
  if (nnz && (dst_sorted[0] < 0 || dst_sorted[nnz - 1] >= num_segments))
    return -2;
  std::vector<int64_t> edge_start;
  bat_window_bounds(dst_sorted, nnz, n_blocks, s_tile, edge_start);
  // per window: number of distinct value blocks among its edges (runs of
  // e/e_tile over a contiguous ascending range = last_blk - first_blk + 1),
  // or 1 coverage tile if empty
  int64_t tiles = 0;
  for (int64_t w = 0; w < n_blocks; ++w) {
    int64_t e0 = edge_start[w], e1 = edge_start[w + 1];
    tiles += (e0 == e1) ? 1 : ((e1 - 1) / e_tile - e0 / e_tile + 1);
  }
  return tiles;
}

int geot_build_bat_tiles(const int32_t* dst_sorted, int64_t nnz,
                         int32_t num_segments, int32_t e_tile, int32_t s_tile,
                         int32_t* ob_out, int32_t* vb_out) {
  int64_t n_blocks = std::max<int64_t>(cdiv(num_segments, s_tile), 1);
  std::vector<int64_t> edge_start;
  bat_window_bounds(dst_sorted, nnz, n_blocks, s_tile, edge_start);
  std::vector<int64_t> tile_start(n_blocks + 1, 0);
  for (int64_t w = 0; w < n_blocks; ++w) {
    int64_t e0 = edge_start[w], e1 = edge_start[w + 1];
    int64_t t = (e0 == e1) ? 1 : ((e1 - 1) / e_tile - e0 / e_tile + 1);
    tile_start[w + 1] = tile_start[w] + t;
  }
  int nt = hw_threads();
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    int64_t wlo = (n_blocks * t) / nt, whi = (n_blocks * (t + 1)) / nt;
    if (wlo >= whi) continue;
    ts.emplace_back([&, wlo, whi] {
      for (int64_t w = wlo; w < whi; ++w) {
        int64_t e0 = edge_start[w], e1 = edge_start[w + 1];
        int64_t p = tile_start[w];
        if (e0 == e1) {
          // coverage tile: vblock inherits the running block (the last
          // value block touched before this window) so vb stays
          // non-decreasing — matches np.maximum.accumulate in the
          // python builder
          ob_out[p] = static_cast<int32_t>(w);
          vb_out[p] = static_cast<int32_t>(e0 ? (e0 - 1) / e_tile : 0);
          continue;
        }
        int64_t b0 = e0 / e_tile, b1 = (e1 - 1) / e_tile;
        for (int64_t b = b0; b <= b1; ++b) {
          ob_out[p] = static_cast<int32_t>(w);
          vb_out[p] = static_cast<int32_t>(b);
          ++p;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// CSR row pointer from dst-sorted destinations (coo_to_csr parity,
// `geot/match_replace/format_transform.py:5-18`).
int geot_coo_to_csr(const int32_t* dst_sorted, int64_t nnz, int32_t num_rows,
                    int32_t* indptr_out /* [num_rows+1] */) {
  std::vector<int64_t> cnt(num_rows, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t d = dst_sorted[i];
    if (d < 0 || d >= num_rows) return -1;
    cnt[d]++;
  }
  indptr_out[0] = 0;
  for (int32_t r = 0; r < num_rows; ++r)
    indptr_out[r + 1] = indptr_out[r] + static_cast<int32_t>(cnt[r]);
  return 0;
}

}  // extern "C"
