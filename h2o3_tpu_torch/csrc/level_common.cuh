// Pieces the histogram kernels share (hist_binned.cu, hist_adaptive.cu,
// hist_global.cu): the block shape, the shared-memory budget of a block's
// partial histogram, how a level's [planes, N, F, W] partial is cut into
// node x feature tiles that fit it, the masses a level kernel adds (float
// (g, h, w), or int8 fixed-point terms summed in int32), the merge of a
// block's partial into the output, the int8 levels' float32 flush, and
// the row grouping of the node-grouped kernels (global_hist and the
// grouped levels of level_grouped.cuh) with the fixed-order merge of their
// blocks' partials, and the keyed fixed-order walk of the float scatter
// bodies (level_wide.cuh, level_column.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace h2o3 {

constexpr int kThreads = 512;  // threads per block == rows per chunk
// Shared-memory budget for one block's partial histogram (with the
// adaptive kernel's ranges): two blocks, each with it, its 8 KB of row
// staging and the 1 KB the SM reserves per block, fill the SM's 228 KB.
constexpr int64_t kHistBudget = 105 * 1024;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ------------------------------------------------------------ knock-outs
//
// The phase knock-outs of the level bodies: a compile-time parameter of
// level_grouped_kernel, level_wide_kernel and the tiled
// adaptive_level_kernel. kNone, the default, is the production body; only
// the probe tools (h2o3_tpu_torch/tools/csrc/probes.cu) instantiate the
// others, and no form rule or launcher of the training path can reach
// them. Each replaces one phase with a cheaper one and still computes a
// defined function, whose plain version is in h2o3_tpu_torch/tools/
// kern_ablate.py:
// - kRoute: every parent sends every row left, without reading x;
// - kRanges: the child's (lo, inv) are the constants -4 and (W - 2) / 8;
// - kBins: the bin of (row, feature f) is (row + f) mod (W - 1), without
//   loading the value for it and without the re-bin;
// - kAdds: the mass products or shared adds are skipped: the histogram is
//   zero, nid_out exact;
// - kWalk (the wide float body): the consumers add with shared float
//   atomics, a thread a record, in place of the keyed fixed-order walk;
// - kGather (the wide body): producer p reads the values of row p of the
//   frame in place of its record's row.
// What a knock-out leaves unread (the operands of the skipped products or
// adds) is folded into one word a thread and stored to ablate_sink on a
// value no input is likely to give, so that the compiler keeps the work
// upstream of the removed phase.
enum class Ablate : int {
  kNone = 0,
  kRoute = 1,
  kRanges = 2,
  kBins = 3,
  kAdds = 4,
  kWalk = 5,
  kGather = 6,
};

__device__ unsigned ablate_sink;

__device__ __forceinline__ void sink_fold(unsigned fold) {
  if (fold == 0x5EEDF00Du) ablate_sink = fold;
}

// The bin of a (row, feature) under kBins.
__device__ __forceinline__ int ablate_bin(int row, int f, int W) {
  return (row + f) % (W - 1);
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The node x feature tiling of one level: each tile's partial, at
// `per_cell` bytes per (node, feature), fits kHistBudget. Blocks along
// the grid's second dimension take one tile each.
struct LevelTiles {
  int node_tile, feat_tile, n_feat_tiles, n_tiles;
};

// n_tiles is -1 when no tiling fits: one cell past the budget, or more
// than 65535 tiles (the grid's second dimension); the launcher refuses.
inline LevelTiles level_tiles(int n_nodes, int F, int64_t per_cell) {
  LevelTiles t;
  if (per_cell > kHistBudget) {
    t.node_tile = t.feat_tile = t.n_feat_tiles = 1;
    t.n_tiles = -1;
    return t;
  }
  if (n_nodes * F * per_cell <= kHistBudget) {
    t.node_tile = n_nodes;
    t.feat_tile = F;
  } else if (n_nodes * per_cell <= kHistBudget) {
    t.node_tile = n_nodes;
    t.feat_tile = static_cast<int>(kHistBudget / (n_nodes * per_cell));
  } else {
    t.feat_tile = 1;
    t.node_tile = static_cast<int>(kHistBudget / per_cell);
  }
  t.n_feat_tiles = (F + t.feat_tile - 1) / t.feat_tile;
  const int n_node_tiles = (n_nodes + t.node_tile - 1) / t.node_tile;
  const int64_t tiles = static_cast<int64_t>(t.n_feat_tiles) * n_node_tiles;
  t.n_tiles = tiles > 65535 ? -1 : static_cast<int>(tiles);
  return t;
}

// Blocks along the grid's first dimension: enough to fill every SM at
// the kernel's occupancy across all tiles, at most one per chunk.
inline int64_t level_grid_x(int per_sm, int n_tiles, int64_t rows) {
  const int64_t chunks = (rows + kThreads - 1) / kThreads;
  int64_t gx = (static_cast<int64_t>(sm_count()) * (per_sm < 1 ? 1 : per_sm)
                + n_tiles - 1) / n_tiles;
  if (gx > chunks) gx = chunks;
  return gx < 1 ? 1 : gx;
}

// What a level kernel adds per row, by the number of int8 terms per
// component. kTerms = 0: float (g, h, w) from ghw [3, rows], rounded to
// bfloat16 when asked, three float planes; each shared add is a
// compare-and-swap loop on Hopper (ATOMS.CAST.SPIN). kTerms = 1 or 2: the
// int8 fixed-point q [3 * kTerms, rows] of quantize_ghw_i8, 3 * kTerms
// int32 planes; each shared add is a native integer atomic (ATOMS.ADD),
// and integer sums give the same bits in any order.
template <int kTerms>
struct LevelMass {
  static constexpr int kPlanes = 3 * kTerms;
  using In = int8_t;
  using Acc = int;
  using Stage = int8_t;  // staged per row in shared memory
  static __device__ __forceinline__ Stage load(const In* __restrict__ m,
                                               int64_t rows, int64_t r, int p,
                                               int /*bf16*/) {
    return m[p * rows + r];
  }
  static __device__ __forceinline__ void add(Acc* cell, Stage v) {
    if (v != 0) atomicAdd(cell, static_cast<int>(v));
  }
};

template <>
struct LevelMass<0> {
  static constexpr int kPlanes = 3;
  using In = float;
  using Acc = float;
  using Stage = float;
  static __device__ __forceinline__ Stage load(const In* __restrict__ m,
                                               int64_t rows, int64_t r, int p,
                                               int bf16) {
    const float v = m[p * rows + r];
    return bf16 ? round_bf16(v) : v;
  }
  static __device__ __forceinline__ void add(Acc* cell, Stage v) {
    atomicAdd(cell, v);
  }
};

// Add a block's nonzero partial cells ([planes][node_tile][feat_tile]
// [stride] in shared memory, `width` bins used of each `stride`) into out
// [planes, n_nodes, F, width] with global atomics (float, or int32 for the
// int8 levels). The level kernels pass a compile-time W and W + 1; the
// global-sketch kernel its run-time B1.
template <typename Acc>
__device__ __forceinline__ void merge_partial(const Acc* s_hist, int planes,
                                              int cells, int stride, int width,
                                              int node_tile, int feat_tile,
                                              int n0, int f0, int nt, int ft,
                                              int n_nodes, int F,
                                              Acc* __restrict__ hist) {
  for (int i = threadIdx.x; i < planes * cells; i += blockDim.x) {
    const Acc v = s_hist[i];
    if (v == 0) continue;
    const int k = i / cells;
    const int rem = i - k * cells;
    const int b = rem % stride;
    const int t = rem / stride;
    if (b >= width) continue;
    const int fl = t % feat_tile;
    const int ln = t / feat_tile;
    if (ln >= nt || fl >= ft) continue;
    const int64_t o =
        ((static_cast<int64_t>(k) * n_nodes + (n0 + ln)) * F + (f0 + fl)) *
            width + b;
    atomicAdd(hist + o, v);
  }
}

// The int8 levels' flush, as the TPU kernels' (_kernel_bt_i8,
// _kernel_t_i8): acc [3 * terms, per_plane] int32 to hist [3, per_plane]
// float32. One term: s_c * f32(sum q_c); two: s_c * (256 * f32(sum a_c) +
// f32(sum b_c)), the high and low sums converted apart. 256 * f32(a) is
// exact, so the IEEE-rounded add and multiply leave one answer.
__global__ void __launch_bounds__(kThreads)
flush_i8_kernel(const int* __restrict__ acc, const float* __restrict__ scales,
                int terms, int64_t per_plane, float* __restrict__ hist) {
  const int64_t n = 3 * per_plane;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    const int c = static_cast<int>(i / per_plane);
    const int64_t j = i - c * per_plane;
    float v;
    if (terms == 1) {
      v = __int2float_rn(acc[i]);
    } else {
      const float hi = __int2float_rn(acc[2 * c * per_plane + j]);
      const float lo = __int2float_rn(acc[(2 * c + 1) * per_plane + j]);
      v = __fadd_rn(__fmul_rn(256.f, hi), lo);
    }
    hist[i] = __fmul_rn(__ldg(scales + c), v);
  }
}

// Bytes of the tiled int8 level's int32 sums, [3 * terms, n_nodes, F, W].
inline size_t tiled_i8_bytes(int terms, int n_nodes, int F, int W) {
  return sizeof(int) * 3 * static_cast<size_t>(terms) * n_nodes * F * W;
}

inline int launch_flush_i8(const int* acc, const float* scales, int terms,
                           int64_t per_plane, float* hist,
                           cudaStream_t stream) {
  const int64_t blocks64 = (3 * per_plane + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  flush_i8_kernel<<<blocks, kThreads, 0, stream>>>(acc, scales, terms,
                                                   per_plane, hist);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ row grouping
//
// Rows grouped by a key, the row partition of XGBoost's gpu_hist: for a
// key in [0, G) per row (any other value: the row is left out), a stable
// counting sort writes one record per kept row into rec, the rows of key 0
// first, each key's rows in ascending row order, and offsets[k] ..
// offsets[k + 1] bound key k's records. A record is the row id (a key may
// put another int there, see tag) and the row's masses, by a record
// policy: GhwRec, {row id (int bits), g, h, w} as a float4 from float ghw
// (zeros without ghw); QRec<kTerms>, the int8 fixed-point q of the int8
// levels packed after the row id (8 bytes a record at one term, 16 at
// two). Three kernels, none of which waits on the host:
//
// 1. group_count: blocks take contiguous row ranges (block b the b-th);
//    each counts its rows per key in shared memory (one warp-aggregated
//    integer add per key present in a warp) into counts [G][nb].
// 2. group_scan (one block): the exclusive scan of counts in key-major
//    order, in place, so counts[k][b] becomes where block b's rows of key
//    k start; offsets; and bstart [G + 1], the first span of each key when
//    a key's records are cut into spans of `span` rows (the histogram
//    kernels' blocks: bstart[G] of them).
// 3. group_scatter: the same row ranges, 256 rows at a time in row order;
//    a row's place is its block's running start for its key, plus the
//    rows of that key in earlier warps of the tile and in earlier lanes of
//    its warp. Integer arithmetic throughout: the order never depends on
//    scheduling.
//
// What bounds it: memory, keys (or what they are computed from) read
// twice, the masses once, rec written once: about 36 bytes a row with
// float ghw, 19 with one int8 term.

constexpr int kGroupThreads = 256;
constexpr int kGroupWarps = kGroupThreads / 32;
// keys a grouping takes: the scatter keeps (1 + warps) x G counters in
// shared memory (144 KB at 4096)
constexpr int kMaxGroups = 4096;

// row-range blocks of the count and scatter passes: at least 2048 rows
// each, at most four per SM
inline int group_blocks(int64_t rows) {
  int64_t nb = (rows + 2047) / 2048;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 4;
  if (nb > cap) nb = cap;
  return nb < 1 ? 1 : static_cast<int>(nb);
}

// spans of a grouping: at most rows / span + G (each key's last span may
// be partial)
inline int64_t span_blocks(int64_t rows, int G, int64_t span) {
  return (rows + span - 1) / span + G;
}

// The buffers of one grouping, carved from a caller's workspace.
struct Grouping {
  int nb;        // row-range blocks of the count and scatter passes
  int* counts;   // [G][nb]
  int* offsets;  // [G + 1]
  int* bstart;   // [G + 1]
  void* rec;     // [rows] records of rec_bytes each
};

inline size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

inline size_t counts_bytes(int64_t rows, int G) {
  return align256(sizeof(int) * static_cast<size_t>(G) * group_blocks(rows));
}

inline size_t grouping_bytes(int64_t rows, int G,
                             size_t rec_bytes = sizeof(float4)) {
  return counts_bytes(rows, G) +
         2 * align256(sizeof(int) * (static_cast<size_t>(G) + 1)) +
         align256(rec_bytes * static_cast<size_t>(rows > 0 ? rows : 1));
}

// Carve a grouping from ws (256-byte aligned); returns the first byte
// after it.
inline char* carve_grouping(char* ws, int64_t rows, int G, Grouping* g,
                            size_t rec_bytes = sizeof(float4)) {
  g->nb = group_blocks(rows);
  g->counts = reinterpret_cast<int*>(ws);
  ws += counts_bytes(rows, G);
  g->offsets = reinterpret_cast<int*>(ws);
  ws += align256(sizeof(int) * (static_cast<size_t>(G) + 1));
  g->bstart = reinterpret_cast<int*>(ws);
  ws += align256(sizeof(int) * (static_cast<size_t>(G) + 1));
  g->rec = ws;
  return ws + align256(rec_bytes * static_cast<size_t>(rows > 0 ? rows : 1));
}

// The float record: {row id (int bits), g, h, w} from ghw [3, rows]
// float32, zeros without ghw.
struct GhwRec {
  using T = float4;
  const float* __restrict__ ghw;
  int64_t rows;
  __device__ __forceinline__ T load(int64_t r) const {
    return ghw != nullptr
               ? make_float4(0.f, ghw[r], ghw[rows + r], ghw[2 * rows + r])
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void set_row(T& v, int row) {
    v.x = __int_as_float(row);
  }
};

// The int8 record of q [3 * kTerms, rows] (quantize_ghw_i8's rows, one
// term: g, h, w; two: a_g, b_g, a_h, b_h, a_w, b_w): the row id, then
// byte p of the words after it is q[p, row] (two's complement). One term
// fits 8 bytes (uint2 {row, q0 | q1 << 8 | q2 << 16}); the six bytes of two
// terms do not fit beside the row id, so 16 (uint4 {row, q0..q3, q4 | q5
// << 8, 0}).
template <int kTerms> struct QRecWords;
template <> struct QRecWords<1> { using T = uint2; };
template <> struct QRecWords<2> { using T = uint4; };

template <int kTerms>
struct QRec {
  using T = typename QRecWords<kTerms>::T;
  const int8_t* __restrict__ q;
  int64_t rows;
  __device__ __forceinline__ T load(int64_t r) const {
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int p = 0; p < 3 * kTerms; ++p)
      w[p >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(q[p * rows + r]))
                   << (8 * (p & 3));
    T v = zero();
    v.y = w[0];
    if constexpr (kTerms == 2) v.z = w[1];
    return v;
  }
  static __device__ __forceinline__ T zero() { return T{}; }
  static __device__ __forceinline__ void set_row(T& v, int row) {
    v.x = static_cast<unsigned>(row);
  }
  static __device__ __forceinline__ int row(const T& v) {
    return static_cast<int>(v.x);
  }
  // q[p] of the record's row
  static __device__ __forceinline__ int mass(const T& v, int p) {
    unsigned w = v.y;
    if constexpr (kTerms == 2) w = p < 4 ? v.y : v.z;
    return static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * (p & 3))));
  }
};

// The key of a row read from an int32 array: in [0, G) or left out.
struct SegKey {
  const int* __restrict__ seg;
  int G;
  __device__ __forceinline__ int operator()(int64_t r) const {
    const int k = seg[r];
    return static_cast<unsigned>(k) < static_cast<unsigned>(G) ? k : -1;
  }
  // what a kept row's record carries in its first field: its id
  __device__ __forceinline__ int tag(int64_t r, int) const {
    return static_cast<int>(r);
  }
};

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void row_range(int64_t rows, int nb, int b,
                                          int64_t* r0, int64_t* r1) {
  const int64_t per = (rows + nb - 1) / nb;
  *r0 = per * b;
  *r1 = *r0 + per < rows ? *r0 + per : rows;
}

template <class Key>
__global__ void __launch_bounds__(kGroupThreads)
group_count_kernel(Key key, int64_t rows, int G, int* __restrict__ counts) {
  extern __shared__ int s_cnt[];  // [G]
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int64_t r0, r1;
  row_range(rows, gridDim.x, blockIdx.x, &r0, &r1);
  // the bound is the same for every lane of a warp: full-warp matches
  for (int64_t w0 = r0 + (threadIdx.x - lane); w0 < r1; w0 += blockDim.x) {
    const int64_t r = w0 + lane;
    const int k = r < r1 ? key(r) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && lane == __ffs(peers) - 1) atomicAdd(s_cnt + k, __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    counts[static_cast<int64_t>(i) * gridDim.x + blockIdx.x] = s_cnt[i];
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the sum. s_warp: 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  __syncthreads();  // s_warp free from any earlier use
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < nw) s_warp[lane] = w;  // inclusive warp sums
  }
  __syncthreads();
  *total = s_warp[nw - 1];
  return incl - v + (warp > 0 ? s_warp[warp - 1] : 0);
}

// One block of 1024 threads, each over a contiguous run of the n = G *
// nseg counts (nseg row ranges): sums, one block scan, then the runs in
// place.
__global__ void __launch_bounds__(1024)
group_scan_kernel(int* __restrict__ counts, int G, int nseg, int64_t span,
                  int* __restrict__ offsets, int* __restrict__ bstart) {
  __shared__ int s_warp[32];
  const int64_t n = static_cast<int64_t>(G) * nseg;
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t i0 = imin64(n, per * threadIdx.x);
  const int64_t i1 = imin64(n, i0 + per);
  int s = 0;
  for (int64_t i = i0; i < i1; ++i) s += counts[i];
  int total;
  int run = block_exclusive_scan(s, s_warp, &total);
  for (int64_t i = i0; i < i1; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  __syncthreads();  // the bases are visible to the whole block
  // spans per key, scanned the same way over the G keys
  const int gper = (G + blockDim.x - 1) / blockDim.x;
  const int k0 = min(G, gper * static_cast<int>(threadIdx.x));
  const int k1 = min(G, k0 + gper);
  int sp = 0;
  for (int k = k0; k < k1; ++k) {
    const int lo = counts[static_cast<int64_t>(k) * nseg];
    const int hi = k + 1 < G ? counts[static_cast<int64_t>(k + 1) * nseg]
                             : total;
    sp += static_cast<int>((hi - lo + span - 1) / span);
  }
  int n_spans;
  int b = block_exclusive_scan(sp, s_warp, &n_spans);
  for (int k = k0; k < k1; ++k) {
    const int lo = counts[static_cast<int64_t>(k) * nseg];
    const int hi = k + 1 < G ? counts[static_cast<int64_t>(k + 1) * nseg]
                             : total;
    offsets[k] = lo;
    bstart[k] = b;
    b += static_cast<int>((hi - lo + span - 1) / span);
  }
  if (threadIdx.x == 0) {
    offsets[G] = total;
    bstart[G] = n_spans;
  }
}

template <class Key, class Rec>
__global__ void __launch_bounds__(kGroupThreads)
group_scatter_kernel(Key key, Rec masses, int64_t rows, int G,
                     const int* __restrict__ base,
                     typename Rec::T* __restrict__ rec) {
  using T = typename Rec::T;
  extern __shared__ int s_grp[];
  int* s_run = s_grp;      // [G]: where this block's next row of a key goes
  int* s_wcnt = s_grp + G;  // [warps][G]: a tile's rows per key and warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    s_run[i] = base[static_cast<int64_t>(i) * gridDim.x + blockIdx.x];
  for (int i = threadIdx.x; i < kGroupWarps * G; i += blockDim.x)
    s_wcnt[i] = 0;
  __syncthreads();
  int64_t r0, r1;
  row_range(rows, gridDim.x, blockIdx.x, &r0, &r1);
  // a row's key and masses, loaded a tile ahead of their use
  auto fetch = [&](int64_t r, int* k, T* v) {
    *k = -1;
    *v = Rec::zero();
    if (r < r1) {
      *k = key(r);
      *v = masses.load(r);
    }
  };
  int k_next;
  T v_next;
  fetch(r0 + threadIdx.x, &k_next, &v_next);
  for (int64_t t0 = r0; t0 < r1; t0 += blockDim.x) {
    const int64_t r = t0 + threadIdx.x;
    const int k = k_next;
    T v = v_next;
    if (r < r1) Rec::set_row(v, key.tag(r, k));  // every row: tag may write
    fetch(r + blockDim.x, &k_next, &v_next);
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (k >= 0 && rank == 0) s_wcnt[warp * G + k] = __popc(peers);
    __syncthreads();
    if (k >= 0) {
      int pos = s_run[k] + rank;
      for (int w = 0; w < warp; ++w) pos += s_wcnt[w * G + k];
      rec[pos] = v;
    }
    __syncthreads();
    if (k >= 0 && rank == 0) {
      atomicAdd(s_run + k, s_wcnt[warp * G + k]);
      s_wcnt[warp * G + k] = 0;
    }
    __syncthreads();
  }
}

// Launch the three passes. G in [1, kMaxGroups]; span >= 1. Returns a
// cudaError_t value.
template <class Key, class Rec>
int launch_grouping(Key key, Rec masses, int64_t rows, int G,
                    int64_t span, const Grouping& g, cudaStream_t stream) {
  if (G < 1 || G > kMaxGroups || span < 1 || rows >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_count = sizeof(int) * static_cast<size_t>(G);
  const size_t smem_scatter = sizeof(int) * (1 + kGroupWarps) *
                              static_cast<size_t>(G);
  cudaError_t err = cudaFuncSetAttribute(
      group_count_kernel<Key>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_count));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(group_scatter_kernel<Key, Rec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_scatter));
  if (err != cudaSuccess) return static_cast<int>(err);
  group_count_kernel<Key><<<g.nb, kGroupThreads, smem_count, stream>>>(
      key, rows, G, g.counts);
  group_scan_kernel<<<1, 1024, 0, stream>>>(g.counts, G, g.nb, span,
                                            g.offsets, g.bstart);
  group_scatter_kernel<Key, Rec><<<g.nb, kGroupThreads, smem_scatter,
                                   stream>>>(
      key, masses, rows, G, g.counts, static_cast<typename Rec::T*>(g.rec));
  return static_cast<int>(cudaGetLastError());
}

// The merge of the blocks' partials: for each output cell i, for each of
// the epilogue's kSums partial cells of i (Epi::cell), the sum over the
// cell's sources (g, o), in order, and over g's blocks b, in block order,
// of part[b * bstride + o]; then Epi::store(i, sums). A CTA takes 32
// consecutive cells; warp w of 8 adds blocks w, w + 8, ... of each source,
// and lane i's eight sums are added in warp order: one fixed order
// whatever the schedule. Src gives a partial cell's sources: int
// operator()(int64_t i, int* g, int64_t* o) (at most two).
constexpr int kMergeWarps = 8;

// The float epilogue: out[i] += the cell's sum (float adds, in the merge's
// fixed order); the caller zeroes out.
struct MergeAdd {
  using T = float;
  static constexpr int kSums = 1;
  float* __restrict__ out;
  __device__ __forceinline__ int64_t cell(int64_t i, int) const { return i; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ void store(int64_t i, const float (&t)[1]) const {
    out[i] = __fadd_rn(out[i], t[0]);
  }
};

// The int8 levels' epilogue, flush_i8_kernel's arithmetic: output cell i
// of hist [3, per_plane] float32 from the int32 partial cells of its
// component's kTerms planes ([3 * kTerms, per_plane]); written, not added.
// Integer sums: the same bits in any order.
template <int kTerms>
struct MergeFlushI8 {
  using T = int;
  static constexpr int kSums = kTerms;
  const float* __restrict__ scales;
  int64_t per_plane;
  float* __restrict__ hist;
  __device__ __forceinline__ int64_t cell(int64_t i, int k) const {
    const int64_t c = i / per_plane;
    return (c * kTerms + k) * per_plane + (i - c * per_plane);
  }
  static __device__ __forceinline__ int add(int a, int b) { return a + b; }
  __device__ __forceinline__ void store(int64_t i,
                                        const int (&t)[kTerms]) const {
    const int c = static_cast<int>(i / per_plane);
    float v = __int2float_rn(t[0]);
    if constexpr (kTerms == 2)
      v = __fadd_rn(__fmul_rn(256.f, v), __int2float_rn(t[1]));
    hist[i] = __fmul_rn(__ldg(scales + c), v);
  }
};

// The blocks whose slots hold group g's partials: bstart[g] to
// bstart[g + 1]; a source whose one group is every block of the launch
// before it says so with kAllBlocks and its block count nb, and needs no
// bstart (the leaf totals: a store of bstart inside their kernel made its
// lane form markedly slower on an H100, for no reason the SASS shows).
template <class S, class = void>
struct AllBlocks {
  static constexpr bool value = false;
};
template <class S>
struct AllBlocks<S, decltype(void(S::kAllBlocks))> {
  static constexpr bool value = S::kAllBlocks;
};

template <class Src>
__device__ __forceinline__ void source_blocks(const Src& src,
                                              const int* __restrict__ bstart,
                                              int g, int* b0, int* b1) {
  if constexpr (AllBlocks<Src>::value) {
    *b0 = 0;
    *b1 = src.nb;
  } else {
    *b0 = __ldg(bstart + g);
    *b1 = __ldg(bstart + g + 1);
  }
}

template <class Src, class Epi>
__global__ void __launch_bounds__(32 * kMergeWarps)
merge_slots_kernel(Src src, const typename Epi::T* __restrict__ part,
                   int64_t bstride, const int* __restrict__ bstart,
                   int64_t n, Epi epi) {
  using T = typename Epi::T;
  constexpr int S = Epi::kSums;
  __shared__ T s_p[S][kMergeWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * 32; i0 < n;
       i0 += static_cast<int64_t>(gridDim.x) * 32) {
    const int64_t i = i0 + lane;
    T s[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      s[k] = T(0);
      if (i < n) {
        int g[2];
        int64_t o[2];
        const int ns = src(epi.cell(i, k), g, o);
        for (int q = 0; q < ns; ++q) {
          int b0, b1;
          source_blocks(src, bstart, g[q], &b0, &b1);
          for (int b = b0 + warp; b < b1; b += kMergeWarps)
            s[k] = Epi::add(s[k], part[b * bstride + o[q]]);
        }
      }
      s_p[k][warp][lane] = s[k];
    }
    __syncthreads();
    if (warp == 0 && i < n) {
      T t[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        t[k] = T(0);
#pragma unroll
        for (int w = 0; w < kMergeWarps; ++w)
          t[k] = Epi::add(t[k], s_p[k][w][lane]);
      }
      epi.store(i, t);
    }
    __syncthreads();
  }
}

template <class Src, class Epi>
int launch_merge(Src src, const typename Epi::T* part, int64_t bstride,
                 const int* bstart, int64_t n, Epi epi, cudaStream_t stream) {
  int64_t ctas = (n + 31) / 32;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  if (ctas > cap) ctas = cap;
  merge_slots_kernel<Src, Epi><<<static_cast<unsigned>(ctas < 1 ? 1 : ctas),
                                 32 * kMergeWarps, 0, stream>>>(
      src, part, bstride, bstart, n, epi);
  return static_cast<int>(cudaGetLastError());
}

// The one source of output cell i when every block of the launch wrote a
// whole slot of the output's shape: each block's slot, at i, in block
// order (the leaf totals, the column body of level_column.cuh).
struct AllSlots {
  static constexpr bool kAllBlocks = true;
  int nb;
  __device__ __forceinline__ int operator()(int64_t i, int* g,
                                            int64_t* o) const {
    g[0] = 0;
    o[0] = i;
    return 1;
  }
};

// ------------------------------------------------------------- the walk
//
// The keyed fixed-order walk of the float scatter bodies (the wide body,
// level_wide.cuh, and the column body, level_column.cuh): one warp adds
// the n staged records of a chunk (n a multiple of 32) into one feature's
// cells, 32 records at a time. sk: the records' keys for the feature (a
// key >= nkeys adds nothing); sm: their staged masses (mass policy Mass:
// WideFloat); cell: the feature's cells, `plane` apart from one mass
// plane to the next; tag: the warp's nkeys bytes. The lanes whose records
// share a key are found through the tags and five ballots: each live lane
// writes its id into its key's tag, and the lanes that read back the same
// id (whichever lane's store landed) are matched with one ballot a bit of
// the id; only the membership matters, and it does not depend on which
// store landed. The lowest of them sums their masses in lane order and
// adds the sums into the cell with a plain add. No other warp touches the
// feature's cells, so every add comes in one fixed order.
template <class Mass>
__device__ __forceinline__ void walk_keys(const uint16_t* sk,
                                          const typename Mass::Stage* sm,
                                          int n, int nkeys, uint8_t* tag,
                                          typename Mass::Part* cell,
                                          int plane, int lane) {
  using Acc = typename Mass::Part;
  constexpr int P = Mass::kPlanes;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int key = sk[j0 + lane];
    const bool live = key < nkeys;
    if (live) tag[key] = static_cast<uint8_t>(lane);
    __syncwarp();
    const int id = live ? tag[key] : lane;
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int bit = 0; bit < 5; ++bit) {
      const bool on = (id >> bit) & 1;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      peers &= on ? m : ~m;
    }
    if (live && lane == __ffs(peers) - 1) {
      Acc s[P];
#pragma unroll
      for (int c = 0; c < P; ++c) s[c] = Acc(0);
      for (unsigned m = peers; m != 0u; m &= m - 1u) {
        const typename Mass::Stage v = sm[j0 + __ffs(m) - 1];
#pragma unroll
        for (int c = 0; c < P; ++c) s[c] = Mass::add(s[c], Mass::mass(v, c));
      }
      Acc* at = cell + key;
#pragma unroll
      for (int c = 0; c < P; ++c)
        at[c * plane] = Mass::add(at[c * plane], s[c]);
    }
  }
}

// The key whose span holds histogram block b: the last k with bstart[k]
// <= b (b < bstart[G]).
__device__ __forceinline__ int span_group(const int* __restrict__ bstart,
                                          int G, int b) {
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(bstart + mid) <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

}  // namespace h2o3
