// Adaptive-bin GBM level kernels for Hopper (sm_90a), plain C interface:
// H2O's UniformAdaptive histogram, re-binned per (node, feature) at every
// level over raw float32 features (NaN = NA).
//
// adaptive_level replaces h2o3_tpu/ops/hist_adaptive.py:_kernel (K8, the
// [rows, F] layout, the one the training path uses) and _kernel_t (K5,
// [F, rows]). One level: each row steps through the previous level's split
// tables by a raw-threshold compare, writes its new node id, and, when
// that node lies in the level's window, bins every feature under the
// node's range, b = floor(clip((x - lo) * inv, 0, W-2)) with NaN in lane
// W-1, and adds its (g, h, w) into the (node, feature, bin) cell.
//
// K8 with float masses is node-grouped, on the bodies it shares with the
// packed-code level, picked per level by h2o3::level_form: below W = 64
// the tensor-core body (level_grouped.cuh): rows grouped by parent, a block
// per span of one parent's rows with both children and all F features,
// one-hot products on the tensor cores (mma.sync m16n8k16 bf16 -> f32;
// three bf16 terms at float32), the blocks' partials merged in slot order;
// at W = 64, 128, 256 (nbins 31-254, XGBoost's tree_method="auto" at
// max_bins 256: W = 64) the wide body (level_wide.cuh): the same grouping,
// a block per (span, slice of features) and one warp per feature adding
// the records into a shared partial in record order, the same merge. Here
// the bin source re-bins raw x under the child's range (AdaptiveBins). No
// float atomics in either: the same inputs give the same bits.
// This replaced (an earlier port of K8) a scatter into per-block shared
// partials with shared float atomics, a compare-and-swap loop on Hopper,
// three a (row, feature), over node x feature tiles that each re-read
// every row: 2.03-3.78 ms a level at 10M x 28, W = 32, on an H100.
// adaptive_level_atomics runs the grouped kernel with shared float atomics
// in place of the products, the ablation it was measured against. K5 (no
// path trains in [F, rows]) and levels past kMaxGroups groups keep the
// tiled body, adaptive_level_kernel.
//
// adaptive_level_i8 replaces _kernel_t_i8 (K7): the same level with the
// int8 fixed-point masses of quantize_ghw_i8 (H2O3_HIST_I8), in both
// layouts (the TPU kernel exists only in [F, rows]; the port trains in
// [rows, F]). Three forms, as binned_level_i8's (hist_binned.cu), picked
// per level by h2o3::i8_level_form (level_wide.cuh): in [rows, F] the
// integer-mass instances of the grouped bodies (I8Mass: int8 records; the
// tensor-core body's m16n8k32 s8 products at W <= 32, the wide body's
// shared integer atomics at W = 64, 128, 256; one pass merging the
// blocks' int32 partials and flushing to float32); otherwise, and always
// in [F, rows], the integer-mass instance (kTerms = 1 or 2) of the tiled
// body: int32 shared partial with native integer atomics, int32 merge and
// a float32 flush. Integer sums: the histogram is bit-equal to the plain
// version in every form.
//
// adaptive_route_only replaces _route_kernel_t (K6) and _route_kernel
// (K9): the deepest level's route, one thread per row, no histogram.
//
// leaf_totals replaces _totals_kernel (K10): route one level of x
// [rows, F] (none when n_prev is 0), then sum float32 (g, h, w) per node
// of the window into totals [3, n_nodes]. As in the JAX package, no grower
// calls it with a route; its n_prev = 0 instance, segment_totals, sums the
// deepest level of the packed and global-sketch growers (their
// _segment_totals). What bounds it: memory, rows * 24 bytes (nid in and
// out, ghw, one x value a row; rows * 16 without the route); 3 adds a row.
// Design: one thread per row; each warp sums the lanes of each node with
// 32 shuffles (the same lane order for every key), and the node's lowest
// lane adds the sums into the warp's own shared totals; the block adds
// its warps' totals in warp order into its own slot, and a second pass
// adds the slots in block order. No float atomics: the same inputs give
// the same bits. Float sums in another order than the plain version's:
// held within 1e-4 + 1e-5 x |mass| of a float64 plain version, as the
// other float checks are.
//
// Routing rule (both kernels, and the plain versions in
// ops/hist_adaptive.py): tables are float32 [4, n_prev] (feat, thr,
// na_left, can). A row in the previous level's window whose node has
// can > 0.5 reads x = x[row, feat]; NaN goes right unless na_left > 0.5,
// any other value goes right when x >= thr; the child is 2*nid + 1 + right.
//
// Numerics held to the plain version bit for bit: (x - lo) * inv is two
// IEEE-rounded operations (__fsub_rn, __fmul_rn), never a contracted or
// approximate form; fminf/fmaxf return the non-NaN operand, so NaN x is
// tested before the clip. On a zero-span node inv is 0 and an infinite x
// gives (±inf - lo) * 0 = NaN: that row takes bin 0, as the JAX package's
// CPU reference does (its astype(int32) of NaN; the TPU kernel's one-hot
// drops such a row instead).
//
// What bounds them on an H100: memory, on paper. adaptive_level reads
// rows * (F * 4 + 16) bytes and writes rows * 4 plus the histogram; its
// float work (a subtract, a multiply and 3 adds per row and feature) is
// far below the 67 TFLOP/s f32 rate, and the grouped form's one-hot
// products (2 * 16 * W * 8 per 16 rows and feature, 2 * W * F * 16 per
// row at bf16, three times that at float32) far below the 989 TFLOP/s
// bf16 rate. What bounds the grouped form in practice is instruction
// issue (level_grouped.cuh).
// adaptive_route_only moves rows * 12 bytes; adaptive_level_i8 reads
// 3 * terms in place of 12 bytes of mass a row. The tiled body (K5, and
// K7 where i8_level_form keeps it), as binned_level's in
// hist_binned.cu: a block
// takes 512 rows at a time; phase 1 routes them (one thread per row) and
// stages node id and masses in shared memory; phase 2 walks the chunk's
// features in the layout's own order (consecutive threads on consecutive
// addresses: along a row in [rows, F], along a feature in [F, rows]),
// bins each value under the (node, feature) range staged in shared memory
// for the block's tile, and adds into a per-block histogram in shared
// memory at a stride of W + 1 words per feature. Blocks merge their
// partials with global atomics; node x feature tiles keep a partial within
// the shared budget (level_common.cuh). Its shared-memory float atomic
// adds are compare-and-swap loops on Hopper (ATOMS.CAST.SPIN); the int8
// instances' integer adds are native.

#include <math.h>

#include "level_wide.cuh"

namespace {

using h2o3::kThreads;

// x[r, f] in [rows, F] (kFeatMajor false) or [F, rows] (true).
template <bool kFeatMajor>
__device__ __forceinline__ float load_x(const float* __restrict__ x,
                                        int64_t r, int f, int64_t rows,
                                        int F) {
  return kFeatMajor ? x[static_cast<int64_t>(f) * rows + r] : x[r * F + f];
}

template <bool kFeatMajor>
__device__ __forceinline__ int route_row(const float* __restrict__ x,
                                         int64_t r, int64_t rows, int F,
                                         int nid,
                                         const float* __restrict__ tables,
                                         int n_prev, int prev_base) {
  const int lp = nid - prev_base;
  if (lp < 0 || lp >= n_prev) return nid;
  if (!(__ldg(tables + 3 * n_prev + lp) > 0.5f)) return nid;
  int f = static_cast<int>(__ldg(tables + lp));
  f = f < 0 ? 0 : (f >= F ? F - 1 : f);
  const float v = load_x<kFeatMajor>(x, r, f, rows, F);
  const int right = isnan(v) ? (__ldg(tables + 2 * n_prev + lp) < 0.5f)
                             : (v >= __ldg(tables + n_prev + lp));
  return 2 * nid + 1 + right;
}

template <int W>
__device__ __forceinline__ int adaptive_bin(float v, float lo, float inv) {
  if (isnan(v)) return W - 1;  // NA lane
  const float t = __fmul_rn(__fsub_rn(v, lo), inv);
  if (isnan(t)) return 0;      // infinite x on a zero-span node
  return static_cast<int>(
      floorf(fminf(fmaxf(t, 0.f), static_cast<float>(W - 2))));
}

template <int W, bool kFeatMajor, int kTerms>
__global__ void __launch_bounds__(kThreads)
adaptive_level_kernel(const float* __restrict__ x,
                      const int* __restrict__ nid_in,
                      const typename h2o3::LevelMass<kTerms>::In* mass,
                      const float* __restrict__ tables,
                      const float* __restrict__ lo,
                      const float* __restrict__ inv, int64_t rows, int F,
                      int n_prev, int n_nodes, int level_base, int node_tile,
                      int feat_tile, int n_feat_tiles, int bf16,
                      int* __restrict__ nid_out,
                      typename h2o3::LevelMass<kTerms>::Acc* __restrict__
                          hist) {
  using M = h2o3::LevelMass<kTerms>;
  using Acc = typename M::Acc;
  using Stage = typename M::Stage;
  constexpr int P = M::kPlanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.y;
  const int n0 = (tile / n_feat_tiles) * node_tile;
  const int f0 = (tile % n_feat_tiles) * feat_tile;
  const int nt = min(node_tile, n_nodes - n0);
  const int ft = min(feat_tile, F - f0);
  constexpr int WP = W + 1;
  const int cells = node_tile * feat_tile * WP;  // per plane
  const int ranges = node_tile * feat_tile;
  // [P][node_tile][feat_tile][WP]
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);
  float* s_lo = reinterpret_cast<float*>(s_hist + P * cells);
  float* s_inv = s_lo + ranges;                  // [node_tile][feat_tile]
  int* s_lid = reinterpret_cast<int*>(s_inv + ranges);
  Stage* s_m = reinterpret_cast<Stage*>(s_lid + kThreads);  // [P][kThreads]

  for (int i = threadIdx.x; i < P * cells; i += blockDim.x) s_hist[i] = 0;
  for (int i = threadIdx.x; i < ranges; i += blockDim.x) {
    const int ln = i / feat_tile;
    const int fl = i - ln * feat_tile;
    float l = 0.f, v = 0.f;
    if (ln < nt && fl < ft) {
      const int64_t o = static_cast<int64_t>(n0 + ln) * F + (f0 + fl);
      l = lo[o];
      v = inv[o];
    }
    s_lo[i] = l;
    s_inv[i] = v;
  }

  const int prev_base = level_base - n_prev;
  const int64_t n_chunks = (rows + kThreads - 1) / kThreads;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * kThreads;
    const int nr = (rows - r0) < kThreads ? static_cast<int>(rows - r0)
                                          : kThreads;
    __syncthreads();  // staging done / previous chunk's phase 2 done
    if (threadIdx.x < nr) {
      const int64_t r = r0 + threadIdx.x;
      int nid = nid_in[r];
      if (n_prev > 0)
        nid = route_row<kFeatMajor>(x, r, rows, F, nid, tables, n_prev,
                                    prev_base);
      if (tile == 0) nid_out[r] = nid;
      const int ln = nid - level_base;
      s_lid[threadIdx.x] = (ln >= n0 && ln < n0 + nt) ? ln - n0 : -1;
#pragma unroll
      for (int p = 0; p < P; ++p)
        s_m[p * kThreads + threadIdx.x] = M::load(mass, rows, r, p, bf16);
    }
    __syncthreads();
    const int work = nr * ft;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      int rr, fl;
      if (kFeatMajor) {
        fl = i / nr;
        rr = i - fl * nr;
      } else {
        rr = i / ft;
        fl = i - rr * ft;
      }
      const int ln = s_lid[rr];
      if (ln < 0) continue;
      const int k = ln * feat_tile + fl;
      const float v = load_x<kFeatMajor>(x, r0 + rr, f0 + fl, rows, F);
      const int cell = k * WP + adaptive_bin<W>(v, s_lo[k], s_inv[k]);
#pragma unroll
      for (int p = 0; p < P; ++p)
        M::add(s_hist + p * cells + cell, s_m[p * kThreads + rr]);
    }
  }
  __syncthreads();
  h2o3::merge_partial(s_hist, P, cells, WP, W, node_tile, feat_tile, n0, f0,
                      nt, ft, n_nodes, F, hist);
}

// ------------------------------------------- the node-grouped float level
//
// The float [rows, F] level (K8) on the grouped body of level_grouped.cuh,
// its bins from raw x under the child's range.

// K8's bin source: raw float32 x [rows, F] (NaN = NA), re-binned under the
// child's (lo, inv); float32 split tables (feat, thr, na_left, can).
template <int W>
struct AdaptiveBins {
  static constexpr int kW = W;
  static constexpr bool kRanges = true;
  static constexpr int kBytes = sizeof(float);
  static constexpr bool kByteCodes = false;
  using Val = float;
  const float* __restrict__ x;
  const float* __restrict__ tables;
  const float* __restrict__ lo;
  const float* __restrict__ inv;
  __device__ __forceinline__ float load(int64_t r, int f, int F) const {
    return x[r * F + f];
  }
  __device__ __forceinline__ const unsigned char* rows() const {
    return reinterpret_cast<const unsigned char*>(x);
  }
  static __device__ __forceinline__ float at(const unsigned char* row,
                                             int f) {
    return reinterpret_cast<const float*>(row)[f];
  }
  __device__ __forceinline__ bool can(int lp, int n_prev) const {
    return __ldg(tables + 3 * n_prev + lp) > 0.5f;
  }
  __device__ __forceinline__ void split(int k, int n_prev, int F, int* feat,
                                        float* thr, int* na_right) const {
    const int f = static_cast<int>(__ldg(tables + k));
    *feat = f < 0 ? 0 : (f >= F ? F - 1 : f);
    *thr = __ldg(tables + n_prev + k);
    *na_right = __ldg(tables + 2 * n_prev + k) < 0.5f;
  }
  __device__ __forceinline__ int right(float v, float thr,
                                       int na_right) const {
    return isnan(v) ? na_right : (v >= thr);
  }
  __device__ __forceinline__ int bin(float v, float lo, float inv) const {
    return adaptive_bin<W>(v, lo, inv);
  }
};

// The grouped level's instance: W (W <= 32: the wide body takes the wider
// levels), then the terms of the mass split (one at bf16, three at
// float32) for the tensor-core form; kMma false is the shared-atomics
// ablation. plan: only the workspace bytes (ws unused).
template <bool kMma>
int grouped_w(int W, bool plan_only, size_t* bytes, const float* x,
              const int* nid, const float* ghw, const float* tables,
              const float* lo, const float* inv, int64_t rows, int F,
              int n_prev, int n_nodes, int level_base, int bf16,
              int* nid_out, float* hist, void* ws, cudaStream_t s) {
#define H2O3_GROUPED(WW, NT)                                                 \
  do {                                                                       \
    using Src = AdaptiveBins<WW>;                                            \
    using Mass = h2o3::FloatMass<NT, kMma>;                                  \
    if (plan_only) {                                                         \
      h2o3::GroupedPlan p;                                                   \
      const int rc = h2o3::plan_grouped<Src, Mass>(rows, F, n_prev, n_nodes, \
                                                   &p);                      \
      *bytes = rc == 0 ? p.bytes : 0;                                        \
      return rc;                                                             \
    }                                                                        \
    return h2o3::launch_grouped<Src, Mass>(                                  \
        Src{x, tables, lo, inv}, nid, h2o3::GhwRec{ghw, rows}, rows, F,      \
        n_prev, n_nodes, level_base, bf16, nid_out, h2o3::MergeAdd{hist},    \
        ws, s);                                                              \
  } while (0)
#define H2O3_GROUPED_W(WW)              \
  case WW:                              \
    if (!kMma || bf16) H2O3_GROUPED(WW, 1); \
    if constexpr (kMma) H2O3_GROUPED(WW, 3); \
    return static_cast<int>(cudaErrorInvalidValue);
  switch (W) {
    H2O3_GROUPED_W(16)
    H2O3_GROUPED_W(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef H2O3_GROUPED_W
#undef H2O3_GROUPED
}

// The wide body's instance (level_wide.cuh) by W (the wide widths, and
// W = 32, where level_form weighs it). plan_only: the workspace bytes
// alone.
int wide_w(int W, bool plan_only, size_t* bytes, const float* x,
           const int* nid, const float* ghw, const float* tables,
           const float* lo, const float* inv, int64_t rows, int F,
           int n_prev, int n_nodes, int level_base, int bf16, int* nid_out,
           float* hist, void* ws, cudaStream_t s) {
#define H2O3_WIDE(WW)                                                        \
  case WW:                                                                   \
    return h2o3::launch_wide<AdaptiveBins<WW>, h2o3::WideFloat>(            \
        AdaptiveBins<WW>{x, tables, lo, inv}, plan_only, bytes, nid,         \
        h2o3::GhwRec{ghw, rows}, rows, F, n_prev, n_nodes, level_base, bf16, \
        nid_out, h2o3::MergeAdd{hist}, ws, s);
  switch (W) {
    H2O3_WIDE(32)
    H2O3_WIDE(64)
    H2O3_WIDE(128)
    H2O3_WIDE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef H2O3_WIDE
}

// The int8 level (K7) on the tensor-core grouped body (W <= 32): int8
// records, m16n8k32 s8 products, the merge flushing to float32.
// plan_only: the workspace bytes alone.
int grouped_i8_w(int W, int terms, bool plan_only, size_t* bytes,
                 const float* x, const int* nid, const int8_t* q,
                 const float* scales, const float* tables, const float* lo,
                 const float* inv, int64_t rows, int F, int n_prev,
                 int n_nodes, int level_base, int* nid_out, float* hist,
                 void* ws, cudaStream_t s) {
#define H2O3_GROUPED_I8(WW, T)                                               \
  do {                                                                       \
    using Src = AdaptiveBins<WW>;                                            \
    using Mass = h2o3::I8Mass<T>;                                            \
    if (plan_only) {                                                         \
      h2o3::GroupedPlan p;                                                   \
      const int rc = h2o3::plan_grouped<Src, Mass>(rows, F, n_prev, n_nodes, \
                                                   &p);                      \
      *bytes = rc == 0 ? p.bytes : 0;                                        \
      return rc;                                                             \
    }                                                                        \
    return h2o3::launch_grouped<Src, Mass>(                                  \
        Src{x, tables, lo, inv}, nid, h2o3::QRec<T>{q, rows}, rows, F,       \
        n_prev, n_nodes, level_base, 0, nid_out,                             \
        h2o3::MergeFlushI8<T>{scales, static_cast<int64_t>(n_nodes) * F * WW,\
                              hist},                                         \
        ws, s);                                                              \
  } while (0)
#define H2O3_GROUPED_I8_W(WW)              \
  case WW:                                 \
    if (terms == 1) H2O3_GROUPED_I8(WW, 1); \
    H2O3_GROUPED_I8(WW, 2);
  switch (W) {
    H2O3_GROUPED_I8_W(16)
    H2O3_GROUPED_I8_W(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef H2O3_GROUPED_I8_W
#undef H2O3_GROUPED_I8
}

// The int8 level (K7) on the wide body (W = 64, 128, 256): int8 records,
// the masses added into int32 partials, the merge flushing to float32.
// plan_only: the workspace bytes alone.
int wide_i8_w(int W, int terms, bool plan_only, size_t* bytes,
              const float* x, const int* nid, const int8_t* q,
              const float* scales, const float* tables, const float* lo,
              const float* inv, int64_t rows, int F, int n_prev, int n_nodes,
              int level_base, int* nid_out, float* hist, void* ws,
              cudaStream_t s) {
#define H2O3_WIDE_I8(WW, T)                                                  \
  return h2o3::launch_wide<AdaptiveBins<WW>, h2o3::I8Mass<T>>(              \
      AdaptiveBins<WW>{x, tables, lo, inv}, plan_only, bytes, nid,           \
      h2o3::QRec<T>{q, rows}, rows, F, n_prev, n_nodes, level_base, 0,       \
      nid_out,                                                               \
      h2o3::MergeFlushI8<T>{scales, static_cast<int64_t>(n_nodes) * F * WW,  \
                            hist},                                           \
      ws, s)
#define H2O3_WIDE_I8_W(WW)              \
  case WW:                              \
    if (terms == 1) H2O3_WIDE_I8(WW, 1); \
    H2O3_WIDE_I8(WW, 2);
  switch (W) {
    H2O3_WIDE_I8_W(64)
    H2O3_WIDE_I8_W(128)
    H2O3_WIDE_I8_W(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef H2O3_WIDE_I8_W
#undef H2O3_WIDE_I8
}

template <bool kFeatMajor>
__global__ void __launch_bounds__(kThreads)
adaptive_route_only_kernel(const float* __restrict__ x,
                           const int* __restrict__ nid_in,
                           const float* __restrict__ tables, int64_t rows,
                           int F, int n_prev, int level_base,
                           int* __restrict__ nid_out) {
  const int prev_base = level_base - n_prev;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += step) {
    nid_out[r] = route_row<kFeatMajor>(x, r, rows, F, nid_in[r], tables,
                                       n_prev, prev_base);
  }
}

// The leaf totals: block b sums a contiguous range of rows (row_range),
// warp w of it rows r0 + 32 w, + 512, ... in row order. In each step of
// 32 rows every lane sums the lanes of its node in lane order (shuffles),
// and the node's lowest lane adds the sums into the warp's own [3][n_nodes]
// shared slot with a plain add; then the block adds its warps' slots in
// warp order into its slot of part, and merge_slots_kernel adds the
// blocks' slots in block order. No float atomics: one fixed order. kRoute
// false: no route (n_prev 0, no x, no nid_out), the segment totals.
template <bool kRoute>
__global__ void __launch_bounds__(kThreads)
leaf_totals_kernel(const float* __restrict__ x,
                   const int* __restrict__ nid_in,
                   const float* __restrict__ ghw,
                   const float* __restrict__ tables, int64_t rows, int F,
                   int n_prev, int n_nodes, int level_base,
                   int* __restrict__ nid_out, float* __restrict__ part,
                   int* __restrict__ bstart) {
  extern __shared__ float s_tot[];  // [warps][3][n_nodes]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int per = 3 * n_nodes;
  for (int i = threadIdx.x; i < nw * per; i += blockDim.x) s_tot[i] = 0.f;
  __syncthreads();
  float* mine = s_tot + warp * per;
  const int prev_base = level_base - n_prev;
  int64_t r0, r1;
  h2o3::row_range(rows, gridDim.x, blockIdx.x, &r0, &r1);
  // the loop bound is the same for every lane of a warp, so the shuffles
  // below always run on the full warp
  for (int64_t w0 = r0 + 32 * warp; w0 < r1; w0 += blockDim.x) {
    const int64_t r = w0 + lane;
    int key = -1;
    float g = 0.f, h = 0.f, w = 0.f;
    if (r < r1) {
      int nid = nid_in[r];
      if constexpr (kRoute) {
        if (n_prev > 0)
          nid = route_row<false>(x, r, rows, F, nid, tables, n_prev,
                                 prev_base);
        nid_out[r] = nid;
      }
      const int ln = nid - level_base;
      if (ln >= 0 && ln < n_nodes) {
        key = ln;
        g = ghw[r];
        h = ghw[rows + r];
        w = ghw[2 * rows + r];
      }
    }
    // each lane sums the lanes of its node in lane order
    float sg = 0.f, sh = 0.f, sw = 0.f;
    bool lowest = true;
    for (int src = 0; src < 32; ++src) {
      const int k = __shfl_sync(0xffffffffu, key, src);
      const float vg = __shfl_sync(0xffffffffu, g, src);
      const float vh = __shfl_sync(0xffffffffu, h, src);
      const float vw = __shfl_sync(0xffffffffu, w, src);
      if (k == key) {
        if (src < lane) lowest = false;
        sg = __fadd_rn(sg, vg);
        sh = __fadd_rn(sh, vh);
        sw = __fadd_rn(sw, vw);
      }
    }
    if (key >= 0 && lowest) {  // the node's lowest lane, alone in the warp
      mine[key] = __fadd_rn(mine[key], sg);
      mine[n_nodes + key] = __fadd_rn(mine[n_nodes + key], sh);
      mine[2 * n_nodes + key] = __fadd_rn(mine[2 * n_nodes + key], sw);
    }
    __syncwarp();
  }
  __syncthreads();
  float* pb = part + static_cast<int64_t>(blockIdx.x) * per;
  for (int i = threadIdx.x; i < per; i += blockDim.x) {
    float t = 0.f;
    for (int v = 0; v < nw; ++v) t = __fadd_rn(t, s_tot[v * per + i]);
    pb[i] = t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    bstart[0] = 0;
    bstart[1] = gridDim.x;
  }
}

// The one source of totals cell i: every block's slot, at i.
struct TotalsSrc {
  __device__ __forceinline__ int operator()(int64_t i, int* g,
                                            int64_t* o) const {
    g[0] = 0;
    o[0] = i;
    return 1;
  }
};

// How a leaf-totals launch runs: blocks (contiguous row ranges, at most
// four an SM), warps a block (as many [3][n_nodes] warp slots as the
// shared budget holds, at most 16), shared and workspace bytes.
struct TotalsPlan {
  int blocks, warps;
  size_t smem, bytes;
};

// Refused (-1 blocks): fewer than one node, or one warp slot past the
// budget (n_nodes above 8960).
inline TotalsPlan plan_totals(int64_t rows, int n_nodes) {
  TotalsPlan p{-1, 0, 0, 0};
  const int64_t slot = 3 * static_cast<int64_t>(n_nodes) * sizeof(float);
  if (n_nodes < 1 || rows < 0 || slot > h2o3::kHistBudget) return p;
  const int64_t fit = h2o3::kHistBudget / slot;
  p.warps = static_cast<int>(fit < kThreads / 32 ? fit : kThreads / 32);
  p.smem = static_cast<size_t>(slot) * p.warps;
  int64_t nb = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 4;
  if (nb > cap) nb = cap;
  p.blocks = nb < 1 ? 1 : static_cast<int>(nb);
  p.bytes = h2o3::align256(static_cast<size_t>(slot) * p.blocks) +
            h2o3::align256(2 * sizeof(int));
  return p;
}

template <bool kRoute>
int launch_totals(const float* x, const int* nid, const float* ghw,
                  const float* tables, int64_t rows, int F, int n_prev,
                  int n_nodes, int level_base, int* nid_out, float* totals,
                  void* ws, cudaStream_t s) {
  const TotalsPlan p = plan_totals(rows, n_nodes);
  if (p.blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = leaf_totals_kernel<kRoute>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = 3 * n_nodes;
  float* part = static_cast<float*>(ws);
  int* bstart = reinterpret_cast<int*>(
      static_cast<char*>(ws) +
      h2o3::align256(sizeof(float) * static_cast<size_t>(per) * p.blocks));
  kern<<<p.blocks, 32 * p.warps, p.smem, s>>>(x, nid, ghw, tables, rows, F,
                                              n_prev, n_nodes, level_base,
                                              nid_out, part, bstart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return h2o3::launch_merge(TotalsSrc{}, part, per, bstart, per,
                            h2o3::MergeAdd{totals}, s);
}

template <int W, bool kFeatMajor, int kTerms>
int launch_level(const float* x, const int* nid, const void* mass,
                 const float* tables, const float* lo, const float* inv,
                 int64_t rows, int F, int n_prev, int n_nodes,
                 int level_base, int bf16, int* nid_out, void* hist,
                 cudaStream_t stream) {
  using M = h2o3::LevelMass<kTerms>;
  // a (node, feature) holds P x (W + 1) partial bins and its lo/inv pair
  const int64_t per_cell =
      static_cast<int64_t>(M::kPlanes) * (W + 1) *
          static_cast<int64_t>(sizeof(typename M::Acc)) +
      2 * static_cast<int64_t>(sizeof(float));
  const h2o3::LevelTiles t = h2o3::level_tiles(n_nodes, F, per_cell);
  if (t.n_tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      static_cast<size_t>(per_cell) * t.node_tile * t.feat_tile +
      kThreads * (sizeof(int) + M::kPlanes * sizeof(typename M::Stage));
  auto kern = adaptive_level_kernel<W, kFeatMajor, kTerms>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(h2o3::level_grid_x(per_sm, t.n_tiles,
                                                     rows)),
            static_cast<unsigned>(t.n_tiles));
  kern<<<grid, kThreads, smem, stream>>>(
      x, nid, static_cast<const typename M::In*>(mass), tables, lo, inv, rows,
      F, n_prev, n_nodes, level_base, t.node_tile, t.feat_tile,
      t.n_feat_tiles, bf16, nid_out, static_cast<typename M::Acc*>(hist));
  return static_cast<int>(cudaGetLastError());
}

template <bool kFeatMajor, int kTerms>
int launch_level_w(int W, const float* x, const int* nid, const void* mass,
                   const float* tables, const float* lo, const float* inv,
                   int64_t rows, int F, int n_prev, int n_nodes,
                   int level_base, int bf16, int* nid_out, void* hist,
                   cudaStream_t s) {
  switch (W) {
    case 16:
      return launch_level<16, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 32:
      return launch_level<32, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 64:
      return launch_level<64, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 128:
      return launch_level<128, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 256:
      return launch_level<256, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The level's instance by layout.
template <int kTerms>
int launch_level_lw(int feat_major, int W, const float* x, const int* nid,
                    const void* mass, const float* tables, const float* lo,
                    const float* inv, int64_t rows, int F, int n_prev,
                    int n_nodes, int level_base, int bf16, int* nid_out,
                    void* hist, cudaStream_t s) {
  if (feat_major)
    return launch_level_w<true, kTerms>(W, x, nid, mass, tables, lo, inv,
                                        rows, F, n_prev, n_nodes, level_base,
                                        bf16, nid_out, hist, s);
  return launch_level_w<false, kTerms>(W, x, nid, mass, tables, lo, inv, rows,
                                       F, n_prev, n_nodes, level_base, bf16,
                                       nid_out, hist, s);
}

// The float level in form `form` (after h2o3::level_form; the grouped
// forms read [rows, F] only). plan_only: the workspace bytes alone (0 for
// the tiled body).
int float_level(int form, bool plan_only, size_t* bytes, const float* x,
                int feat_major, const int* nid, const float* ghw,
                const float* tables, const float* lo, const float* inv,
                int64_t rows, int F, int W, int n_prev, int n_nodes,
                int level_base, int bf16, int* nid_out, float* hist, void* ws,
                cudaStream_t s) {
  if (form == h2o3::kTiledForm) {
    if (plan_only) {
      *bytes = 0;
      return 0;
    }
    return launch_level_lw<0>(feat_major, W, x, nid, ghw, tables, lo, inv,
                              rows, F, n_prev, n_nodes, level_base, bf16,
                              nid_out, hist, s);
  }
  if (feat_major) return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case h2o3::kTensorForm:
      return grouped_w<true>(W, plan_only, bytes, x, nid, ghw, tables, lo,
                             inv, rows, F, n_prev, n_nodes, level_base, bf16,
                             nid_out, hist, ws, s);
    case h2o3::kWideForm:
      return wide_w(W, plan_only, bytes, x, nid, ghw, tables, lo, inv, rows,
                    F, n_prev, n_nodes, level_base, bf16, nid_out, hist, ws,
                    s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8 level in form `form` (after h2o3::i8_level_form; the grouped
// forms read [rows, F] only). The tiled body zeroes its int32 sums (in
// ws) and flushes them after its launch. plan_only: the workspace bytes
// alone.
int i8_level(int form, bool plan_only, size_t* bytes, const float* x,
             int feat_major, const int* nid, const int8_t* q, int terms,
             const float* scales, const float* tables, const float* lo,
             const float* inv, int64_t rows, int F, int W, int n_prev,
             int n_nodes, int level_base, int* nid_out, float* hist,
             void* ws, cudaStream_t s) {
  if (form == h2o3::kTiledForm) {
    const size_t nbytes = h2o3::tiled_i8_bytes(terms, n_nodes, F, W);
    if (plan_only) {
      *bytes = nbytes;
      return 0;
    }
    int* acc = static_cast<int*>(ws);
    const cudaError_t err = cudaMemsetAsync(acc, 0, nbytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rc =
        terms == 1
            ? launch_level_lw<1>(feat_major, W, x, nid, q, tables, lo, inv,
                                 rows, F, n_prev, n_nodes, level_base, 0,
                                 nid_out, acc, s)
            : launch_level_lw<2>(feat_major, W, x, nid, q, tables, lo, inv,
                                 rows, F, n_prev, n_nodes, level_base, 0,
                                 nid_out, acc, s);
    if (rc != 0) return rc;
    return h2o3::launch_flush_i8(acc, scales, terms,
                                 static_cast<int64_t>(n_nodes) * F * W, hist,
                                 s);
  }
  if (feat_major) return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case h2o3::kTensorForm:
      return grouped_i8_w(W, terms, plan_only, bytes, x, nid, q, scales,
                          tables, lo, inv, rows, F, n_prev, n_nodes,
                          level_base, nid_out, hist, ws, s);
    case h2o3::kWideForm:
      return wide_i8_w(W, terms, plan_only, bytes, x, nid, q, scales, tables,
                       lo, inv, rows, F, n_prev, n_nodes, level_base, nid_out,
                       hist, ws, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The form of adaptive_level_i8 at these shapes (h2o3::i8_level_form).
inline int i8_form(int form, int feat_major, int64_t rows, int F, int W,
                   int terms, int n_prev, int n_nodes) {
  return h2o3::i8_level_form(form, feat_major, rows, F, W, terms,
                             sizeof(float), true, n_prev, n_nodes);
}

}  // namespace

extern "C" {

// x float32 [rows, F] (feat_major 0) or [F, rows] (feat_major 1), NaN =
// NA; nid [rows] int32; ghw [3, rows] float32; tables [4, max(n_prev, 1)]
// float32; lo, inv [n_nodes, F] float32; form -1 (picked from the shapes,
// h2o3::level_form) or forced: 0 (tiled body), 1 (tensor-core grouped
// body), 2 (wide body); a grouped form forced in [F, rows] or where it
// does not fit is an error; ws,
// h2o3_adaptive_level_workspace bytes for the same form. Writes nid_out
// [rows] int32 and ADDS into hist [3, n_nodes, F, W] float32, which the
// caller zeroes. Returns a cudaError_t value.
int h2o3_adaptive_level(const float* x, int feat_major, const int* nid,
                        const float* ghw, const float* tables,
                        const float* lo, const float* inv, long long rows,
                        int F, int W, int n_prev, int n_nodes, int level_base,
                        int bf16, int form, int* nid_out, float* hist,
                        void* ws, void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t unused = 0;
  return float_level(
      h2o3::level_form(form, feat_major, rows, F, W, n_prev, n_nodes), false,
      &unused, x, feat_major, nid, ghw, tables, lo, inv, rows, F, W, n_prev,
      n_nodes, level_base, bf16, nid_out, hist, ws,
      static_cast<cudaStream_t>(stream));
}

// The form h2o3_adaptive_level picks at these shapes (h2o3::level_form;
// a LevelForm code).
int h2o3_adaptive_level_picks(int feat_major, long long rows, int F, int W,
                              int n_prev, int n_nodes) {
  return h2o3::level_form(h2o3::kPickForm, feat_major, rows, F, W, n_prev,
                          n_nodes);
}

// The workspace bytes h2o3_adaptive_level (atomics 0, in form `form`) or
// h2o3_adaptive_level_atomics (atomics 1) needs at these shapes: the
// grouping and the blocks' partials of a grouped form, 0 for the tiled
// body. Returns -1 where the shapes are refused.
long long h2o3_adaptive_level_workspace(int feat_major, long long rows, int F,
                                        int W, int n_prev, int n_nodes,
                                        int bf16, int atomics, int form) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0) return -1;
  size_t bytes = 0;
  int rc;
  if (atomics) {
    if (feat_major || !h2o3::grouped_fits(rows, F, n_prev, n_nodes))
      return -1;
    rc = grouped_w<false>(W, true, &bytes, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, rows, F, n_prev, n_nodes,
                          0, bf16, nullptr, nullptr, nullptr, nullptr);
  } else {
    rc = float_level(
        h2o3::level_form(form, feat_major, rows, F, W, n_prev, n_nodes),
        true, &bytes, nullptr, feat_major, nullptr, nullptr, nullptr,
        nullptr, nullptr, rows, F, W, n_prev, n_nodes, 0, bf16, nullptr,
        nullptr, nullptr, nullptr);
  }
  return rc == 0 ? static_cast<long long>(bytes) : -1;
}

// The grouped [rows, F] float level with shared float atomics in place of
// the tensor-core products: the ablation the design was measured against,
// for chip_smoke.py and the tests only. Operands as h2o3_adaptive_level
// (feat_major 0). Returns a cudaError_t value.
int h2o3_adaptive_level_atomics(const float* x, const int* nid,
                                const float* ghw, const float* tables,
                                const float* lo, const float* inv,
                                long long rows, int F, int W, int n_prev,
                                int n_nodes, int level_base, int bf16,
                                int* nid_out, float* hist, void* ws,
                                void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      !h2o3::grouped_fits(rows, F, n_prev, n_nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t unused = 0;
  return grouped_w<false>(W, false, &unused, x, nid, ghw, tables, lo, inv,
                          rows, F, n_prev, n_nodes, level_base, bf16,
                          nid_out, hist, ws, static_cast<cudaStream_t>(stream));
}

// Rows grouped by key (level_common.cuh), alone, for the tests and
// chip_smoke.py: keys [rows] int32 (a key outside [0, G) leaves its row
// out); the masses: ghw [3, rows] float32 or null (q null), or the int8 q
// [3 * terms, rows] (terms 1 or 2). Writes offsets [G + 1] int32 and rec
// (past offsets[G] unwritten): [rows, 4] float32 ({row id bits, g, h, w} a
// row), or with q the int8 records, [rows, 2] int32 at one term, [rows, 4]
// at two (QRec); ws holds h2o3_group_rows_workspace bytes (the counts and
// span starts). Returns a cudaError_t value.
long long h2o3_group_rows_workspace(long long rows, int G) {
  if (rows < 0 || G < 1 || G > h2o3::kMaxGroups) return -1;
  return static_cast<long long>(
      h2o3::counts_bytes(rows, G) +
      h2o3::align256(sizeof(int) * (static_cast<size_t>(G) + 1)));
}

int h2o3_group_rows(const int* keys, const float* ghw, const int8_t* q,
                    int terms, long long rows, int G, int* offsets,
                    void* rec, void* ws, void* stream) {
  if (h2o3_group_rows_workspace(rows, G) < 0 ||
      (q != nullptr && terms != 1 && terms != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  h2o3::Grouping g;
  g.nb = h2o3::group_blocks(rows);
  g.counts = static_cast<int*>(ws);
  g.bstart = reinterpret_cast<int*>(static_cast<char*>(ws) +
                                    h2o3::counts_bytes(rows, G));
  g.offsets = offsets;
  g.rec = rec;
  const h2o3::SegKey key{keys, G};
  const int64_t span = rows > 0 ? rows : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q == nullptr)
    return h2o3::launch_grouping(key, h2o3::GhwRec{ghw, rows}, rows, G, span,
                                 g, s);
  if (terms == 1)
    return h2o3::launch_grouping(key, h2o3::QRec<1>{q, rows}, rows, G, span,
                                 g, s);
  return h2o3::launch_grouping(key, h2o3::QRec<2>{q, rows}, rows, G, span, g,
                               s);
}

// The workspace bytes of h2o3_adaptive_level_i8 at these shapes and
// form (-1 picked, or a LevelForm forced): a grouped form's grouping and
// block partials, or the tiled body's int32 sums; -1 where the shapes are
// refused (a forced grouped form in [F, rows], or one that does not fit
// or has no instance at W).
long long h2o3_adaptive_level_i8_workspace(int feat_major, long long rows,
                                           int F, int W, int n_prev,
                                           int n_nodes, int terms, int form) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      (terms != 1 && terms != 2))
    return -1;
  size_t bytes = 0;
  const int rc = i8_level(
      i8_form(form, feat_major, rows, F, W, terms, n_prev, n_nodes), true,
      &bytes, nullptr, feat_major, nullptr, nullptr, terms, nullptr, nullptr,
      nullptr, nullptr, rows, F, W, n_prev, n_nodes, 0, nullptr, nullptr,
      nullptr, nullptr);
  return rc == 0 ? static_cast<long long>(bytes) : -1;
}

// The form h2o3_adaptive_level_i8 picks at these shapes
// (h2o3::i8_level_form; a LevelForm code).
int h2o3_adaptive_level_i8_picks(int feat_major, long long rows, int F,
                                 int W, int n_prev, int n_nodes, int terms) {
  return i8_form(h2o3::kPickForm, feat_major, rows, F, W, terms, n_prev,
                 n_nodes);
}

// The int8 level: q [3 * terms, rows] int8 (terms 1 or 2), scales [3]
// float32 in place of ghw; form -1 (picked from the shapes,
// h2o3::i8_level_form) or forced: 0 (tiled body, its int32 sums zeroed
// here, then flush_i8_kernel), 1 (tensor-core grouped body, W <= 32), 2
// (wide body, W = 64, 128, 256), the grouped ones merging and flushing in
// one pass; a grouped form forced in [F, rows], or where it does not fit
// or has no instance at W, is an error; ws,
// h2o3_adaptive_level_i8_workspace bytes for the same form. Writes
// nid_out [rows] int32 and hist [3, n_nodes, F, W] float32 (all of it).
// Returns a cudaError_t value.
int h2o3_adaptive_level_i8(const float* x, int feat_major, const int* nid,
                           const int8_t* q, int terms, const float* scales,
                           const float* tables, const float* lo,
                           const float* inv, long long rows, int F, int W,
                           int n_prev, int n_nodes, int level_base, int form,
                           int* nid_out, float* hist, void* ws,
                           void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      (terms != 1 && terms != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t unused = 0;
  return i8_level(
      i8_form(form, feat_major, rows, F, W, terms, n_prev, n_nodes), false,
      &unused, x, feat_major, nid, q, terms, scales, tables, lo, inv, rows,
      F, W, n_prev, n_nodes, level_base, nid_out, hist, ws,
      static_cast<cudaStream_t>(stream));
}

// The deepest level's route: same operands as h2o3_adaptive_level without
// ghw, lo, inv and hist. Returns a cudaError_t value.
int h2o3_adaptive_route_only(const float* x, int feat_major, const int* nid,
                             const float* tables, long long rows, int F,
                             int n_prev, int level_base, int* nid_out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_prev < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks64 = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 32;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  if (feat_major)
    adaptive_route_only_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, nid, tables, rows, F, n_prev, level_base, nid_out);
  else
    adaptive_route_only_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, nid, tables, rows, F, n_prev, level_base, nid_out);
  return static_cast<int>(cudaGetLastError());
}

// The workspace bytes of h2o3_leaf_totals and h2o3_segment_totals at
// these shapes (the blocks' slots); -1 where they are refused.
long long h2o3_leaf_totals_workspace(long long rows, int n_nodes) {
  const TotalsPlan p = plan_totals(rows, n_nodes);
  return p.blocks < 0 ? -1 : static_cast<long long>(p.bytes);
}

// Route one level of x [rows, F] float32 (none when n_prev is 0) and ADD
// each node's (g, h, w) sums into totals [3, n_nodes] float32, which the
// caller zeroes; writes nid_out [rows] int32. tables [4, max(n_prev, 1)]
// float32 as h2o3_adaptive_level's; ws, h2o3_leaf_totals_workspace bytes.
// Returns a cudaError_t value.
int h2o3_leaf_totals(const float* x, const int* nid, const float* ghw,
                     const float* tables, long long rows, int F, int n_prev,
                     int n_nodes, int level_base, int* nid_out,
                     float* totals, void* ws, void* stream) {
  if (F < 1 || n_prev < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_totals<true>(x, nid, ghw, tables, rows, F, n_prev, n_nodes,
                             level_base, nid_out, totals, ws,
                             static_cast<cudaStream_t>(stream));
}

// The segment totals: the n_prev = 0 instance of h2o3_leaf_totals, which
// routes nothing and reads no x. ADDS each node's (g, h, w) sums over the
// rows with nid in [level_base, level_base + n_nodes) into totals
// [3, n_nodes] float32, which the caller zeroes. Returns a cudaError_t
// value.
int h2o3_segment_totals(const int* nid, const float* ghw, long long rows,
                        int n_nodes, int level_base, float* totals, void* ws,
                        void* stream) {
  return launch_totals<false>(nullptr, nid, ghw, nullptr, rows, 1, 0,
                              n_nodes, level_base, nullptr, totals, ws,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
