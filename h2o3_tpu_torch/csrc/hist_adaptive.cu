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
// adaptive_route_only replaces _route_kernel (K9, [rows, F], the layout
// the adaptive paths train in) and _route_kernel_t (K6, [F, rows]): the
// deepest level's route, one thread per row, no histogram. What bounds K9
// on an H100: bytes, an nid read and written and one x value a row, which
// in [rows, F] moves the 32-byte sector that holds it (chip_smoke.py
// route_bound_ms: 0.1194 ms at 10M rows). Each thread runs a chain of
// dependent loads (nid, the node's table entries, x, then the store), so
// a loads-only instance (kLoadsOnly: the same loads and store, no
// compare) is its floor. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (device time, chip_smoke.py phase 6): 0.2164 ms at [10M, 28] against a
// floor of 0.2159, 0.1347 ms at [10M, 8] against 0.1342. K9 sits on the
// floor of its access pattern: 89% of the bound at 8 features; at 28,
// 10M x 72 bytes in 0.216 ms is the card's 3.3 TB/s, as if each gather
// in a 112-byte row fetched 64 bytes from DRAM, not one sector.
// A redesign (tables in shared memory, four rows a thread, every gather
// issued before the compares) measured no faster and was not kept.
//
// leaf_totals replaces _totals_kernel (K10): route one level of x
// [rows, F] (none when n_prev is 0), then sum float32 (g, h, w) per node
// of the window into totals [3, n_nodes]. As in the JAX package, no grower
// calls it with a route; its n_prev = 0 instance, segment_totals, sums the
// deepest level of the packed and global-sketch growers and of XGBoost
// (their _segment_totals). What bounds it on an H100: bytes, rows * 16
// (nid, ghw; rows * 24 with the route's nid out and x value); 3 adds a
// row. The first port took one row a lane and, for every 32 rows, had
// each lane sum the lanes of its node with 32 steps of 4 shuffles: 128
// warp shuffles a 32 rows whatever the keys, one row of loads in flight a
// lane. The redesign: a lane takes eight rows a step (two quads of four,
// 16-byte loads where nid and ghw are aligned and rows % 4 == 0, one load
// a row otherwise), issues the next step's loads before this step's sums,
// and folds its own rows with equal keys in row order; then, at up to 133
// nodes, each lane adds into its own column of the warp's [3][n_nodes][32]
// shared slot (no shuffles, no bank conflicts), or, past that,
// __match_any_sync finds a key's lanes and its lowest lane adds their
// values in lane order (max(peers) trips of 3 shuffles; one key on every
// lane: a fixed xor butterfly). The block sums its warps' slots in warp
// order and merge_slots_kernel the blocks' in block order. No atomics:
// the same inputs give the same bits. With the route, a lane routes its
// eight rows at once (route_rows). Measured with chip_smoke.py phase 6 on
// an NVIDIA H100 80GB HBM3 at 700 W, 10M rows, N = 64: 0.080 ms device
// time (60% of the 0.0478 ms bound; the matched-key form 0.147); one call
// between two events, the wrapper's host time included, 0.116-0.158 ms
// against the first port's 0.283-0.308 in the same run. Float sums in
// another order than the plain version's: held within 1e-4 + 1e-5 x
// |mass| of a float64 plain version, as the other float checks are.
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

#include "adaptive_bins.cuh"
#include "level_wide.cuh"

namespace {

using h2o3::AdaptiveBins;
using h2o3::kThreads;
using h2o3::route_row;

// ------------------------------------------- the node-grouped float level
//
// The float [rows, F] level (K8) on the grouped body of level_grouped.cuh,
// its bins from raw x under the child's range (AdaptiveBins,
// adaptive_bins.cuh).

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

// K9 ([rows, F]) and K6 ([F, rows]): the deepest level's route, one
// thread per row. kLoadsOnly (K9's loads-only floor, for chip_smoke.py):
// the same nid, table and x loads and nid_out store with no compare, all
// four table entries read (the route reads three: thr or na_left by x);
// nid_out = nid, the loaded values folded into ablate_sink.
template <bool kFeatMajor>
__device__ __forceinline__ unsigned route_row_loads(
    const float* __restrict__ x, int64_t r, int64_t rows, int F, int nid,
    const float* __restrict__ tables, int n_prev, int prev_base) {
  const int lp = nid - prev_base;
  if (lp < 0 || lp >= n_prev) return 0u;
  if (!(__ldg(tables + 3 * n_prev + lp) > 0.5f)) return 0u;
  int f = static_cast<int>(__ldg(tables + lp));
  f = f < 0 ? 0 : (f >= F ? F - 1 : f);
  const float v = h2o3::load_x<kFeatMajor>(x, r, f, rows, F);
  return __float_as_uint(v) ^ __float_as_uint(__ldg(tables + n_prev + lp)) ^
         __float_as_uint(__ldg(tables + 2 * n_prev + lp));
}

template <bool kFeatMajor, bool kLoadsOnly = false>
__global__ void __launch_bounds__(kThreads)
adaptive_route_only_kernel(const float* __restrict__ x,
                           const int* __restrict__ nid_in,
                           const float* __restrict__ tables, int64_t rows,
                           int F, int n_prev, int level_base,
                           int* __restrict__ nid_out) {
  const int prev_base = level_base - n_prev;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned fold = 0;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += step) {
    if constexpr (kLoadsOnly) {
      const int nid = nid_in[r];
      fold ^= route_row_loads<kFeatMajor>(x, r, rows, F, nid, tables,
                                          n_prev, prev_base);
      nid_out[r] = nid;
    } else {
      nid_out[r] = route_row<kFeatMajor>(x, r, rows, F, nid_in[r], tables,
                                         n_prev, prev_base);
    }
  }
  if constexpr (kLoadsOnly) h2o3::sink_fold(fold);
}

template <bool kFeatMajor, bool kLoadsOnly>
int launch_route_only(const float* x, const int* nid, const float* tables,
                      int64_t rows, int F, int n_prev, int level_base,
                      int* nid_out, cudaStream_t s) {
  const int64_t blocks64 = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 32;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  adaptive_route_only_kernel<kFeatMajor, kLoadsOnly>
      <<<blocks, kThreads, 0, s>>>(x, nid, tables, rows, F, n_prev,
                                   level_base, nid_out);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The nid of a row past the end: outside every window, so it neither
// routes nor adds.
constexpr int kOffRow = -(1 << 30);

// route_row's rule on R rows of x [rows, F] at once (row r[i]; an nid
// outside the previous level's window, such as kOffRow's, stays): every
// table read first, then every x load, then the compares, so that a lane
// of the leaf totals has R gathers in flight, not one.
template <int R>
__device__ __forceinline__ void route_rows(const float* __restrict__ x,
                                           const int64_t (&r)[R], int F,
                                           const float* __restrict__ tables,
                                           int n_prev, int prev_base,
                                           int (&nid)[R]) {
  bool go[R];
  int f[R];
  float thr[R], na_left[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int lp = nid[i] - prev_base;
    go[i] = lp >= 0 && lp < n_prev && __ldg(tables + 3 * n_prev + lp) > 0.5f;
    int fi = 0;
    thr[i] = na_left[i] = 0.f;
    if (go[i]) {
      fi = static_cast<int>(__ldg(tables + lp));
      thr[i] = __ldg(tables + n_prev + lp);
      na_left[i] = __ldg(tables + 2 * n_prev + lp);
    }
    f[i] = fi < 0 ? 0 : (fi >= F ? F - 1 : fi);
  }
  float v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = go[i] ? __ldg(x + r[i] * F + f[i]) : 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!go[i]) continue;
    const int right = isnan(v[i]) ? (na_left[i] < 0.5f) : (v[i] >= thr[i]);
    nid[i] = 2 * nid[i] + 1 + right;
  }
}

// --------------------------------------------------- K10: the leaf totals
//
// Block b sums a contiguous range of quads, four consecutive rows each
// (row_range over quads, so a block's rows start on a multiple of 4); warp
// w of it takes kTotalsQuads x 32 consecutive quads a step (lane l quads
// l and l + 32), each quad's nid, g, h and w in one 16-byte load apiece
// where aligned (h and w rows start aligned only when rows % 4 == 0), and
// issues the next step's loads before this step's sums. Each lane first
// folds its own rows with equal keys in row order (a row off the window
// passes the run on). Then, by form:
// - lanes (kLanes): lane l adds each run into its own column of the
//   warp's [3][n_nodes][32] shared slot, no exchange between lanes; at the
//   end each cell is the sum over warps in warp order, then over lanes by
//   a fixed xor butterfly;
// - match: per row slot, __match_any_sync finds the lanes of a key; one
//   key on all 32 lanes adds by the xor butterfly, otherwise the key's
//   lowest lane adds its peers' values in lane order, max(peers) trips of
//   3 shuffles for the warp, and adds them into the warp's [3][n_nodes]
//   slot; the block adds its warps' slots in warp order.
// Each block writes its slot of part; merge_slots_kernel adds the blocks'
// slots in block order. No atomics: one fixed order. kRoute false: no
// route (n_prev 0, no x, no nid_out), the segment totals.
constexpr int kTotalsQuads = 2;  // 8 rows a lane a step
constexpr int kTotalsRows = 4 * kTotalsQuads;
// lane columns: up to 8 warps a block in up to 200 KB of shared memory
constexpr int kLaneWarps = 8;
constexpr int64_t kLaneBudget = 200 * 1024;
// forms: picked from n_nodes, lane columns, matched keys
constexpr int kPickTotals = -1, kLaneTotals = 0, kMatchTotals = 1;

// Lane `lane`'s rows of the step at quad q: nid (kOffRow past lim) and
// (g, h, w) (0 past lim). kVec (nid, ghw and nid_out 16-byte aligned and
// rows % 4 == 0, so that the h and w rows are too, and every quad before
// lim is whole): one 16-byte load of each; otherwise one load a row.
template <bool kVec>
__device__ __forceinline__ void load_totals_rows(
    const int* __restrict__ nid_in, const float* __restrict__ ghw,
    int64_t rows, int64_t lim, int64_t q, int (&nid)[kTotalsRows],
    float (&g)[kTotalsRows], float (&h)[kTotalsRows],
    float (&w)[kTotalsRows]) {
#pragma unroll
  for (int u = 0; u < kTotalsQuads; ++u) {
    const int64_t r0 = 4 * (q + 32 * u);
    const int at = 4 * u;
    if constexpr (kVec) {
      if (r0 < lim) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(nid_in + r0));
        const float4 b = __ldg(reinterpret_cast<const float4*>(ghw + r0));
        const float4 c =
            __ldg(reinterpret_cast<const float4*>(ghw + rows + r0));
        const float4 d =
            __ldg(reinterpret_cast<const float4*>(ghw + 2 * rows + r0));
        nid[at] = a.x, nid[at + 1] = a.y, nid[at + 2] = a.z;
        nid[at + 3] = a.w;
        g[at] = b.x, g[at + 1] = b.y, g[at + 2] = b.z, g[at + 3] = b.w;
        h[at] = c.x, h[at + 1] = c.y, h[at + 2] = c.z, h[at + 3] = c.w;
        w[at] = d.x, w[at + 1] = d.y, w[at + 2] = d.z, w[at + 3] = d.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          nid[at + j] = kOffRow;
          g[at + j] = h[at + j] = w[at + j] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t r = r0 + j;
        const bool in = r < lim;
        nid[at + j] = in ? __ldg(nid_in + r) : kOffRow;
        g[at + j] = in ? __ldg(ghw + r) : 0.f;
        h[at + j] = in ? __ldg(ghw + rows + r) : 0.f;
        w[at + j] = in ? __ldg(ghw + 2 * rows + r) : 0.f;
      }
    }
  }
}

template <bool kRoute, bool kLanes, bool kVec>
__global__ void __launch_bounds__(kLanes ? 32 * kLaneWarps : kThreads)
leaf_totals_kernel(const float* __restrict__ x,
                   const int* __restrict__ nid_in,
                   const float* __restrict__ ghw,
                   const float* __restrict__ tables, int64_t rows, int F,
                   int n_prev, int n_nodes, int level_base,
                   int* __restrict__ nid_out, float* __restrict__ part) {
  constexpr int R = kTotalsRows;
  constexpr unsigned kFull = 0xffffffffu;
  // kLanes: [warps][3][n_nodes][32]; else [warps][3][n_nodes]
  extern __shared__ float s_tot[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int per = 3 * n_nodes;
  const int slot = kLanes ? 32 * per : per;
  for (int i = threadIdx.x; i < nw * slot; i += blockDim.x) s_tot[i] = 0.f;
  __syncthreads();
  float* mine = s_tot + warp * slot;
  const int prev_base = level_base - n_prev;
  int64_t q0, q1;
  h2o3::row_range((rows + 3) >> 2, gridDim.x, blockIdx.x, &q0, &q1);
  const int64_t lim = h2o3::imin64(4 * q1, rows);  // the block's rows end
  const int64_t step = static_cast<int64_t>(nw) * 32 * kTotalsQuads;
  int64_t qb = q0 + static_cast<int64_t>(warp) * 32 * kTotalsQuads;
  int nid[R];
  float g[R], h[R], w[R];
  load_totals_rows<kVec>(nid_in, ghw, rows, lim, qb + lane, nid, g, h, w);
  // the bound is the same for every lane of a warp, so the warp
  // collectives below always run on the full warp
  for (; qb < q1; qb += step) {
    int nid2[R];
    float g2[R], h2[R], w2[R];
    load_totals_rows<kVec>(nid_in, ghw, rows, lim, qb + step + lane, nid2,
                           g2, h2, w2);
    if constexpr (kRoute) {
      int64_t r[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        r[i] = 4 * (qb + lane + 32 * (i / 4)) + (i % 4);
      if (n_prev > 0)
        route_rows<R>(x, r, F, tables, n_prev, prev_base, nid);
#pragma unroll
      for (int u = 0; u < kTotalsQuads; ++u) {
        const int64_t r0 = r[4 * u];
        if constexpr (kVec) {
          if (r0 < lim)
            *reinterpret_cast<int4*>(nid_out + r0) = make_int4(
                nid[4 * u], nid[4 * u + 1], nid[4 * u + 2], nid[4 * u + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (r0 + j < lim) nid_out[r0 + j] = nid[4 * u + j];
        }
      }
    }
    int key[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int ln = nid[i] - level_base;
      key[i] = ln >= 0 && ln < n_nodes ? ln : -1;
    }
    // the lane's own runs, in row order: row i takes over row i - 1's sums
    // when it is off the window or has the same key
#pragma unroll
    for (int i = 1; i < R; ++i) {
      if (key[i] < 0 || key[i] == key[i - 1]) {
        const bool add = key[i] >= 0;
        g[i] = add ? __fadd_rn(g[i - 1], g[i]) : g[i - 1];
        h[i] = add ? __fadd_rn(h[i - 1], h[i]) : h[i - 1];
        w[i] = add ? __fadd_rn(w[i - 1], w[i]) : w[i - 1];
        key[i] = key[i - 1];
        key[i - 1] = -1;
      }
    }
    if constexpr (kLanes) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (key[i] < 0) continue;
        float* c = mine + key[i] * 32 + lane;
        c[0] = __fadd_rn(c[0], g[i]);
        c[32 * n_nodes] = __fadd_rn(c[32 * n_nodes], h[i]);
        c[64 * n_nodes] = __fadd_rn(c[64 * n_nodes], w[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = key[i];
        if (!__any_sync(kFull, k >= 0)) continue;
        const unsigned peers = __match_any_sync(kFull, k);
        float sg = g[i], sh = h[i], sw = w[i];
        int leader = 0;
        if (peers == kFull) {  // one key on every lane: a fixed butterfly
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            sg = __fadd_rn(sg, __shfl_xor_sync(kFull, sg, off));
            sh = __fadd_rn(sh, __shfl_xor_sync(kFull, sh, off));
            sw = __fadd_rn(sw, __shfl_xor_sync(kFull, sw, off));
          }
        } else {  // the key's lanes in lane order
          const int cnt = __popc(peers);
          const int trips = __reduce_max_sync(kFull, k >= 0 ? cnt : 0);
          unsigned m = peers;
          sg = sh = sw = 0.f;
          for (int t = 0; t < trips; ++t) {
            const int src = m ? __ffs(m) - 1 : lane;
            m &= m - 1;
            const float vg = __shfl_sync(kFull, g[i], src);
            const float vh = __shfl_sync(kFull, h[i], src);
            const float vw = __shfl_sync(kFull, w[i], src);
            if (t < cnt) {
              sg = __fadd_rn(sg, vg);
              sh = __fadd_rn(sh, vh);
              sw = __fadd_rn(sw, vw);
            }
          }
          leader = __ffs(peers) - 1;
        }
        if (k >= 0 && lane == leader) {
          mine[k] = __fadd_rn(mine[k], sg);
          mine[n_nodes + k] = __fadd_rn(mine[n_nodes + k], sh);
          mine[2 * n_nodes + k] = __fadd_rn(mine[2 * n_nodes + k], sw);
        }
        __syncwarp();  // the next slot's leader may add into the same cell
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      nid[i] = nid2[i];
      g[i] = g2[i];
      h[i] = h2[i];
      w[i] = w2[i];
    }
  }
  __syncthreads();
  float* pb = part + static_cast<int64_t>(blockIdx.x) * per;
  if constexpr (kLanes) {
    for (int i = warp; i < per; i += nw) {
      float t = 0.f;
      for (int v = 0; v < nw; ++v)
        t = __fadd_rn(t, s_tot[(v * per + i) * 32 + lane]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t = __fadd_rn(t, __shfl_xor_sync(kFull, t, off));
      if (lane == 0) pb[i] = t;
    }
  } else {
    for (int i = threadIdx.x; i < per; i += blockDim.x) {
      float t = 0.f;
      for (int v = 0; v < nw; ++v) t = __fadd_rn(t, s_tot[v * per + i]);
      pb[i] = t;
    }
  }
}

// The one source of totals cell i: every block's slot, at i.
struct TotalsSrc {
  static constexpr bool kAllBlocks = true;
  int nb;
  __device__ __forceinline__ int operator()(int64_t i, int* g,
                                            int64_t* o) const {
    g[0] = 0;
    o[0] = i;
    return 1;
  }
};

// How a leaf-totals launch runs: the form (lane columns or matched keys),
// blocks (contiguous quad ranges, as many as are resident at once, at most
// four an SM), warps a block (slots that fit the shared budget: at most
// kLaneWarps lane-column slots in kLaneBudget, 16 matched-key slots in
// kHistBudget), shared and workspace bytes.
struct TotalsPlan {
  int blocks, warps;
  bool lanes;
  size_t smem, bytes;
};

// The picked form takes lane columns where four warps' of them fit
// kLaneBudget (n_nodes <= 133). Refused (-1 blocks): fewer than one node,
// one matched-key slot past kHistBudget (n_nodes above 8960), a forced
// lane form whose one slot does not fit (n_nodes above 533), an unknown
// form.
inline TotalsPlan plan_totals(int64_t rows, int n_nodes, int form) {
  TotalsPlan p{-1, 0, false, 0, 0};
  const int64_t slot = 3 * static_cast<int64_t>(n_nodes) * sizeof(float);
  if (n_nodes < 1 || rows < 0 || slot > h2o3::kHistBudget ||
      form < kPickTotals || form > kMatchTotals)
    return p;
  const int64_t lane_fit = kLaneBudget / (32 * slot);
  p.lanes = form == kLaneTotals || (form == kPickTotals && lane_fit >= 4);
  if (p.lanes && lane_fit < 1) return p;
  const int64_t fit = p.lanes ? lane_fit : h2o3::kHistBudget / slot;
  const int64_t most = p.lanes ? kLaneWarps : kThreads / 32;
  p.warps = static_cast<int>(fit < most ? fit : most);
  p.smem = static_cast<size_t>(p.lanes ? 32 * slot : slot) * p.warps;
  // the SM's 228 KB of shared memory, 1 KB of it reserved per block
  int64_t per_sm = (228 * 1024) / static_cast<int64_t>(p.smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  const int64_t per_block = static_cast<int64_t>(p.warps) * 32 * kTotalsQuads;
  int64_t nb = ((rows + 3) / 4 + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * per_sm;
  nb = nb < 1 ? 1 : (nb > cap ? cap : nb);
  p.blocks = static_cast<int>(nb);
  p.bytes = h2o3::align256(static_cast<size_t>(slot) * p.blocks);
  return p;
}

template <bool kRoute, bool kLanes, bool kVec>
int launch_totals_form(const TotalsPlan& p, const float* x, const int* nid,
                       const float* ghw, const float* tables, int64_t rows,
                       int F, int n_prev, int n_nodes, int level_base,
                       int* nid_out, float* part, cudaStream_t s) {
  auto kern = leaf_totals_kernel<kRoute, kLanes, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<p.blocks, 32 * p.warps, p.smem, s>>>(x, nid, ghw, tables, rows, F,
                                              n_prev, n_nodes, level_base,
                                              nid_out, part);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRoute>
int launch_totals(const float* x, const int* nid, const float* ghw,
                  const float* tables, int64_t rows, int F, int n_prev,
                  int n_nodes, int level_base, int form, int* nid_out,
                  float* totals, void* ws, cudaStream_t s) {
  const TotalsPlan p = plan_totals(rows, n_nodes, form);
  if (p.blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(nid) && aligned16(ghw) && rows % 4 == 0 &&
                   (!kRoute || aligned16(nid_out));
  const int per = 3 * n_nodes;
  float* part = static_cast<float*>(ws);
#define H2O3_TOTALS(LANES, VEC)                                            \
  launch_totals_form<kRoute, LANES, VEC>(p, x, nid, ghw, tables, rows, F, \
                                         n_prev, n_nodes, level_base,     \
                                         nid_out, part, s)
  const int rc = p.lanes ? (vec ? H2O3_TOTALS(true, true)
                                : H2O3_TOTALS(true, false))
                         : (vec ? H2O3_TOTALS(false, true)
                                : H2O3_TOTALS(false, false));
#undef H2O3_TOTALS
  if (rc != 0) return rc;
  return h2o3::launch_merge(TotalsSrc{p.blocks}, part, per, nullptr, per,
                            h2o3::MergeAdd{totals}, s);
}


template <bool kFeatMajor, int kTerms>
int launch_level_w(int W, const float* x, const int* nid, const void* mass,
                   const float* tables, const float* lo, const float* inv,
                   int64_t rows, int F, int n_prev, int n_nodes,
                   int level_base, int bf16, int* nid_out, void* hist,
                   cudaStream_t s) {
  switch (W) {
    case 16:
      return h2o3::launch_adaptive_tiled<16, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 32:
      return h2o3::launch_adaptive_tiled<32, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 64:
      return h2o3::launch_adaptive_tiled<64, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 128:
      return h2o3::launch_adaptive_tiled<128, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 256:
      return h2o3::launch_adaptive_tiled<256, kFeatMajor, kTerms>(
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
  return feat_major
             ? launch_route_only<true, false>(x, nid, tables, rows, F, n_prev,
                                              level_base, nid_out, s)
             : launch_route_only<false, false>(x, nid, tables, rows, F,
                                               n_prev, level_base, nid_out, s);
}

// K9's loads-only floor in [rows, F]: the route's nid, table and x loads
// and nid_out store, no compare, nid_out = nid. For chip_smoke.py and the
// tests only; operands as h2o3_adaptive_route_only's in [rows, F].
// Returns a cudaError_t value.
int h2o3_adaptive_route_floor(const float* x, const int* nid,
                              const float* tables, long long rows, int F,
                              int n_prev, int level_base, int* nid_out,
                              void* stream) {
  if (F < 1 || n_prev < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_route_only<false, true>(x, nid, tables, rows, F, n_prev,
                                        level_base, nid_out,
                                        static_cast<cudaStream_t>(stream));
}

// The workspace bytes of h2o3_leaf_totals, h2o3_segment_totals and
// h2o3_segment_totals_form at these shapes, in any form (the blocks'
// slots); -1 where every form is refused.
long long h2o3_leaf_totals_workspace(long long rows, int n_nodes) {
  long long most = -1;
  const int forms[2] = {kLaneTotals, kMatchTotals};
  for (int form : forms) {
    const TotalsPlan p = plan_totals(rows, n_nodes, form);
    if (p.blocks >= 0 && static_cast<long long>(p.bytes) > most)
      most = static_cast<long long>(p.bytes);
  }
  return most;
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
                             level_base, kPickTotals, nid_out, totals, ws,
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
                              n_nodes, level_base, kPickTotals, nullptr,
                              totals, ws, static_cast<cudaStream_t>(stream));
}

// h2o3_segment_totals with its form forced: 0 lane columns (refused past
// 533 nodes), 1 matched keys, -1 picked. For chip_smoke.py and the tests.
int h2o3_segment_totals_form(const int* nid, const float* ghw,
                             long long rows, int n_nodes, int level_base,
                             int form, float* totals, void* ws,
                             void* stream) {
  return launch_totals<false>(nullptr, nid, ghw, nullptr, rows, 1, 0,
                              n_nodes, level_base, form, nullptr, totals, ws,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
