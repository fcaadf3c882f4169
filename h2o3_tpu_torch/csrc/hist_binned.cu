// Packed-code GBM level kernels for Hopper (sm_90a), plain C interface.
//
// binned_level (replaces h2o3_tpu/ops/hist_adaptive.py:_kernel_bt, K1, and
// its W=16 stripe form _kernel_bt_stripe, K3): one pass per tree level.
// Each row steps through the previous level's split tables, writes its new
// node id, and, when that node lies in the level's window, adds its
// (g, h, w) into the (node, feature, code) bin of every feature. Three
// forms, picked per level by h2o3::level_form (level_wide.cuh):
//
// - Tensor-core node-grouped (float masses at W <= 32, the packed path's
//   W = 16 among them): the body it shares with the float adaptive level
//   (level_grouped.cuh). Rows are grouped by parent (a row whose node lies
//   in the previous window and can split, by that parent; a row of the
//   level's window without a route, the root, by its node; any other row
//   keeps its node id and adds nothing), then one 512-thread block per
//   span of a group's records routes them (the code of the split feature
//   against split_bin) and adds both children's (g, h, w) for all F
//   features as one-hot products on the tensor cores (mma.sync m16n8k16
//   bf16 -> f32; the code is the bin, so there is no re-bin; three bf16
//   terms at float32), and the blocks' [3][2][F][W] partials are added in
//   slot order. Its work grows with W: a one-hot operand per 16 lanes.
// - Wide node-grouped (float masses at W = 64, 128, 256: nbins 31-254
//   with packed codes, XGBoost's max_bins = 256 at W = 256): the same
//   grouping, then a block per (span, slice of features) stages 256
//   records at a time (route, keys child * W + code) and one warp per
//   feature adds them into a shared [3][fs][2W + 1] partial in record
//   order, a key's lanes summed in lane order (level_wide.cuh); the same
//   slot-ordered merge. Its work is per (record, feature) whatever W.
// - Tiled (levels past kMaxGroups groups and frames past 512 features;
//   the int8 instances below where i8_level_form keeps them): a block
//   takes 512 rows at a time;
//   phase 1 routes them (one thread per row) and stages node id and
//   (g, h, w) in shared memory; phase 2 walks the chunk's codes
//   contiguously (coalesced byte loads) and adds into a per-block
//   histogram in shared memory. Each feature's W bins sit at a stride of
//   W + 1 words, so the bins of neighbouring features start on different
//   banks. At the end each block adds its nonzero partial cells into the
//   output with global atomics. When the level's [planes, N, F, W]
//   partial does not fit the shared budget (six int32 planes at
//   terms = 2 take twice the float level's three), the grid's second
//   dimension splits it into node x feature tiles; each tile re-reads the
//   rows it needs (level_common.cuh). Its shared float adds are
//   compare-and-swap loops on Hopper (ATOMS.CAST.SPIN) and its merge adds
//   floats with global atomics, so float sums vary in the last bits from
//   run to run.
//
// The two grouped forms add no float atomics: the same inputs give the
// same bits. h2o3_binned_level's form argument forces any form, for the
// tests and chip_smoke.py.
//
// binned_level_i8 (replaces _kernel_bt_i8, K4): the same level with the
// int8 fixed-point masses of quantize_ghw_i8 (H2O3_HIST_I8), in three
// forms picked per level by h2o3::i8_level_form (level_wide.cuh):
// - Tensor-core node-grouped (W <= 32): the integer-mass instance of the
//   grouped body (level_grouped.cuh, I8Mass): the grouping pass writes
//   int8 records ({row, q bytes}, 8 bytes at one term, 16 at two), the
//   one-hot products run as mma.sync m16n8k32 s8 -> s32 (the TPU kernel's
//   int8 x int8 -> int32 contraction), each block writes an int32 partial
//   into its slot, and one pass merges the slots and flushes to float32.
// - Wide node-grouped (W = 64, 128, 256): the integer-mass instance of
//   the wide body (level_wide.cuh): the same int8 records, a block per
//   (span, slice of features), each record's q bytes added into an int32
//   shared partial with native integer atomics (no walk: integer sums
//   need no order), the same merge and flush in one pass.
// - Tiled: the integer-mass instance (kTerms = 1 or 2) of the tiled body.
//   It stages q (3 or 6 bytes a row in place of 12), adds into an int32
//   shared partial with native integer atomics (ATOMS.ADD), merges blocks
//   into a zeroed int32 buffer with integer atomics, and a flush pass
//   writes the float32 histogram (level_common.cuh).
// Sums of integers leave no room for order: in either form the histogram
// is bit-equal to the plain version and to the TPU kernel.
//
// binned_route_only (replaces _route_kernel_bt, K2): the deepest level's
// route, one thread per row, no histogram.
//
// Routing rule (all of them, and the plain versions in
// ops/hist_adaptive.py): a row in the previous level's window whose node
// can split reads code = codes[row, feat]; NA (code == W-1) goes right
// unless na_left, any other code goes right when code >= split_bin; the
// child is 2*nid + 1 + right. Tables are int32 [4, n_prev]: feat,
// split_bin, na_left, can.
//
// What bounds them on an H100: memory, on paper. binned_level reads
// rows * (F * itemsize + 16) bytes and writes rows * 4 (about
// rows * (F * itemsize + 20) per level); its 3 * rows * F float adds are
// far below the 67 TFLOP/s f32 rate, and the grouped form's one-hot
// products (2 * 16 * W * 8 per 16 rows and feature) far below the 989
// TFLOP/s bf16 rate; binned_level_i8 reads 3 * terms in place of 12 bytes
// of mass a row; binned_route_only moves about rows * 9 bytes. In practice
// the tensor-core form is bound by instruction issue (level_grouped.cuh),
// the wide form by its consumers' walk (level_wide.cuh), the tiled body by
// its shared-memory atomics.

#include "level_wide.cuh"

namespace {

using h2o3::kThreads;

template <typename CodeT>
__device__ __forceinline__ int route_row(const CodeT* __restrict__ codes,
                                         int64_t r, int F, int W, int nid,
                                         const int* __restrict__ tables,
                                         int n_prev, int prev_base) {
  const int lp = nid - prev_base;
  if (lp < 0 || lp >= n_prev) return nid;
  if (__ldg(tables + 3 * n_prev + lp) == 0) return nid;
  int f = __ldg(tables + lp);
  f = f < 0 ? 0 : (f >= F ? F - 1 : f);
  const int c = static_cast<int>(codes[r * F + f]);
  const int right = (c == W - 1) ? (__ldg(tables + 2 * n_prev + lp) == 0)
                                 : (c >= __ldg(tables + n_prev + lp));
  return 2 * nid + 1 + right;
}

template <typename CodeT, int W, int kTerms>
__global__ void __launch_bounds__(kThreads)
binned_level_kernel(const CodeT* __restrict__ codes,
                    const int* __restrict__ nid_in,
                    const typename h2o3::LevelMass<kTerms>::In* mass,
                    const int* __restrict__ tables, int64_t rows, int F,
                    int n_prev, int n_nodes, int level_base, int node_tile,
                    int feat_tile, int n_feat_tiles, int bf16,
                    int* __restrict__ nid_out,
                    typename h2o3::LevelMass<kTerms>::Acc* __restrict__ hist) {
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
  // [P][node_tile][feat_tile][WP]
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);
  int* s_lid = reinterpret_cast<int*>(s_hist + P * cells);
  Stage* s_m = reinterpret_cast<Stage*>(s_lid + kThreads);  // [P][kThreads]

  for (int i = threadIdx.x; i < P * cells; i += blockDim.x) s_hist[i] = 0;

  const int prev_base = level_base - n_prev;
  const int64_t n_chunks = (rows + kThreads - 1) / kThreads;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * kThreads;
    const int nr = (rows - r0) < kThreads ? static_cast<int>(rows - r0)
                                          : kThreads;
    __syncthreads();  // zeroing done / previous chunk's phase 2 done
    if (threadIdx.x < nr) {
      const int64_t r = r0 + threadIdx.x;
      int nid = nid_in[r];
      if (n_prev > 0)
        nid = route_row<CodeT>(codes, r, F, W, nid, tables, n_prev,
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
    const CodeT* base = codes + r0 * F + f0;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int rr = i / ft;
      const int fl = i - rr * ft;
      const int ln = s_lid[rr];
      if (ln < 0) continue;
      const int c = static_cast<int>(base[static_cast<int64_t>(rr) * F + fl]);
      if (static_cast<unsigned>(c) >= static_cast<unsigned>(W)) continue;
      const int cell = (ln * feat_tile + fl) * WP + c;
#pragma unroll
      for (int p = 0; p < P; ++p)
        M::add(s_hist + p * cells + cell, s_m[p * kThreads + rr]);
    }
  }
  __syncthreads();
  h2o3::merge_partial(s_hist, P, cells, WP, W, node_tile, feat_tile, n0, f0,
                      nt, ft, n_nodes, F, hist);
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
binned_route_only_kernel(const CodeT* __restrict__ codes,
                         const int* __restrict__ nid_in,
                         const int* __restrict__ tables, int64_t rows, int F,
                         int W, int n_prev, int level_base,
                         int* __restrict__ nid_out) {
  const int prev_base = level_base - n_prev;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += step) {
    nid_out[r] = route_row<CodeT>(codes, r, F, W, nid_in[r], tables, n_prev,
                                  prev_base);
  }
}

// Shared bytes of one block: the partial, the staged node ids and masses.
template <int kTerms>
size_t level_smem(int node_tile, int feat_tile, int W) {
  using M = h2o3::LevelMass<kTerms>;
  return static_cast<size_t>(M::kPlanes) * node_tile * feat_tile * (W + 1) *
             sizeof(typename M::Acc) +
         kThreads * (sizeof(int) + M::kPlanes * sizeof(typename M::Stage));
}

template <typename CodeT, int W, int kTerms>
int launch_level(const void* codes, const int* nid, const void* mass,
                 const int* tables, int64_t rows, int F, int n_prev,
                 int n_nodes, int level_base, int bf16, int* nid_out,
                 void* hist, cudaStream_t stream) {
  using M = h2o3::LevelMass<kTerms>;
  const int64_t per_cell = static_cast<int64_t>(M::kPlanes) * (W + 1) *
                           static_cast<int64_t>(sizeof(typename M::Acc));
  const h2o3::LevelTiles t = h2o3::level_tiles(n_nodes, F, per_cell);
  if (t.n_tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = level_smem<kTerms>(t.node_tile, t.feat_tile, W);
  auto kern = binned_level_kernel<CodeT, W, kTerms>;
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
      static_cast<const CodeT*>(codes), nid,
      static_cast<const typename M::In*>(mass), tables, rows, F, n_prev,
      n_nodes, level_base, t.node_tile, t.feat_tile, t.n_feat_tiles, bf16,
      nid_out, static_cast<typename M::Acc*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// The level's instance by code width and W.
template <int kTerms>
int launch_level_w(const void* codes, int code_bytes, const int* nid,
                   const void* mass, const int* tables, int64_t rows, int F,
                   int W, int n_prev, int n_nodes, int level_base, int bf16,
                   int* nid_out, void* hist, cudaStream_t s) {
  if (code_bytes == 1) {
    switch (W) {
      case 16:
        return launch_level<int8_t, 16, kTerms>(codes, nid, mass, tables,
                                                rows, F, n_prev, n_nodes,
                                                level_base, bf16, nid_out,
                                                hist, s);
      case 32:
        return launch_level<int8_t, 32, kTerms>(codes, nid, mass, tables,
                                                rows, F, n_prev, n_nodes,
                                                level_base, bf16, nid_out,
                                                hist, s);
      case 64:
        return launch_level<int8_t, 64, kTerms>(codes, nid, mass, tables,
                                                rows, F, n_prev, n_nodes,
                                                level_base, bf16, nid_out,
                                                hist, s);
      case 128:
        return launch_level<int8_t, 128, kTerms>(codes, nid, mass, tables,
                                                 rows, F, n_prev, n_nodes,
                                                 level_base, bf16, nid_out,
                                                 hist, s);
      default:
        break;
    }
  } else if (code_bytes == 2 && W == 256) {
    return launch_level<int16_t, 256, kTerms>(codes, nid, mass, tables, rows,
                                              F, n_prev, n_nodes, level_base,
                                              bf16, nid_out, hist, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------ the node-grouped float level
//
// The float packed level (K1/K3) on the grouped body of
// level_grouped.cuh: the code is the bin.

// K1's bin source: packed codes [rows, F] (int8, or int16 at W = 256; NA
// in lane W-1), int32 split tables (feat, split_bin, na_left, can).
template <typename CodeT, int W>
struct CodeBins {
  static constexpr int kW = W;
  static constexpr bool kRanges = false;
  static constexpr int kBytes = sizeof(CodeT);
  // byte codes: the code is the bin byte (the int8 body's SWAR bins)
  static constexpr bool kByteCodes = sizeof(CodeT) == 1;
  using Val = int;
  const CodeT* __restrict__ codes;
  const int* __restrict__ tables;
  __device__ __forceinline__ int load(int64_t r, int f, int F) const {
    return static_cast<int>(codes[r * F + f]);
  }
  __device__ __forceinline__ const unsigned char* rows() const {
    return reinterpret_cast<const unsigned char*>(codes);
  }
  static __device__ __forceinline__ int at(const unsigned char* row, int f) {
    return static_cast<int>(reinterpret_cast<const CodeT*>(row)[f]);
  }
  __device__ __forceinline__ bool can(int lp, int n_prev) const {
    return __ldg(tables + 3 * n_prev + lp) != 0;
  }
  __device__ __forceinline__ void split(int k, int n_prev, int F, int* feat,
                                        int* thr, int* na_right) const {
    const int f = __ldg(tables + k);
    *feat = f < 0 ? 0 : (f >= F ? F - 1 : f);
    *thr = __ldg(tables + n_prev + k);
    *na_right = __ldg(tables + 2 * n_prev + k) == 0;
  }
  __device__ __forceinline__ int right(int c, int thr, int na_right) const {
    return c == W - 1 ? na_right : (c >= thr);
  }
  // a code outside [0, W) adds nothing, as in the tiled body
  __device__ __forceinline__ int bin(int c, float, float) const {
    return static_cast<unsigned>(c) < static_cast<unsigned>(W) ? c : -1;
  }
};

// The grouped level's instance by code width and W (W <= 32: the wide
// body takes the wider levels), one bf16 term at bf16, three at float32.
// plan_only: the workspace bytes alone.
int grouped_w(int code_bytes, int W, bool plan_only, size_t* bytes,
              const void* codes, const int* nid, const float* ghw,
              const int* tables, int64_t rows, int F, int n_prev,
              int n_nodes, int level_base, int bf16, int* nid_out,
              float* hist, void* ws, cudaStream_t s) {
#define H2O3_GROUPED(CT, WW, NT)                                             \
  do {                                                                       \
    using Src = CodeBins<CT, WW>;                                            \
    using Mass = h2o3::FloatMass<NT, true>;                                  \
    if (plan_only) {                                                         \
      h2o3::GroupedPlan p;                                                   \
      const int rc = h2o3::plan_grouped<Src, Mass>(rows, F, n_prev, n_nodes, \
                                                   &p);                      \
      *bytes = rc == 0 ? p.bytes : 0;                                        \
      return rc;                                                             \
    }                                                                        \
    return h2o3::launch_grouped<Src, Mass>(                                  \
        Src{static_cast<const CT*>(codes), tables}, nid,                     \
        h2o3::GhwRec{ghw, rows}, rows, F, n_prev, n_nodes, level_base, bf16, \
        nid_out, h2o3::MergeAdd{hist}, ws, s);                               \
  } while (0)
#define H2O3_GROUPED_W(CT, WW)           \
  if (bf16) H2O3_GROUPED(CT, WW, 1);     \
  H2O3_GROUPED(CT, WW, 3);
  if (code_bytes == 1) {
    switch (W) {
      case 16: H2O3_GROUPED_W(int8_t, 16)
      case 32: H2O3_GROUPED_W(int8_t, 32)
      default: break;
    }
  }
#undef H2O3_GROUPED_W
#undef H2O3_GROUPED
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide body's instance (level_wide.cuh) by code width and W (the
// wide widths, and W = 32, where level_form weighs it). plan_only: the
// workspace bytes alone.
int wide_w(int code_bytes, int W, bool plan_only, size_t* bytes,
           const void* codes, const int* nid, const float* ghw,
           const int* tables, int64_t rows, int F, int n_prev, int n_nodes,
           int level_base, int bf16, int* nid_out, float* hist, void* ws,
           cudaStream_t s) {
#define H2O3_WIDE(CT, WW)                                                    \
  return h2o3::launch_wide<CodeBins<CT, WW>, h2o3::WideFloat>(              \
      CodeBins<CT, WW>{static_cast<const CT*>(codes), tables}, plan_only,    \
      bytes, nid, h2o3::GhwRec{ghw, rows}, rows, F, n_prev, n_nodes,         \
      level_base, bf16, nid_out, h2o3::MergeAdd{hist}, ws, s)
  if (code_bytes == 1) {
    switch (W) {
      case 32: H2O3_WIDE(int8_t, 32);
      case 64: H2O3_WIDE(int8_t, 64);
      case 128: H2O3_WIDE(int8_t, 128);
      default: break;
    }
  } else if (code_bytes == 2 && W == 256) {
    H2O3_WIDE(int16_t, 256);
  }
#undef H2O3_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float level in form `form` (after h2o3::level_form). plan_only: the
// workspace bytes alone (0 for the tiled body).
int float_level(int form, bool plan_only, size_t* bytes, const void* codes,
                int code_bytes, const int* nid, const float* ghw,
                const int* tables, int64_t rows, int F, int W, int n_prev,
                int n_nodes, int level_base, int bf16, int* nid_out,
                float* hist, void* ws, cudaStream_t s) {
  switch (form) {
    case h2o3::kTiledForm:
      if (plan_only) {
        *bytes = 0;
        return 0;
      }
      return launch_level_w<0>(codes, code_bytes, nid, ghw, tables, rows, F,
                               W, n_prev, n_nodes, level_base, bf16, nid_out,
                               hist, s);
    case h2o3::kTensorForm:
      return grouped_w(code_bytes, W, plan_only, bytes, codes, nid, ghw,
                       tables, rows, F, n_prev, n_nodes, level_base, bf16,
                       nid_out, hist, ws, s);
    case h2o3::kWideForm:
      return wide_w(code_bytes, W, plan_only, bytes, codes, nid, ghw, tables,
                    rows, F, n_prev, n_nodes, level_base, bf16, nid_out,
                    hist, ws, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8 level (K4) on the tensor-core grouped body (W <= 32): int8
// records, m16n8k32 s8 products, the merge flushing to float32.
// plan_only: the workspace bytes alone.
int grouped_i8_w(int code_bytes, int W, int terms, bool plan_only,
                 size_t* bytes, const void* codes, const int* nid,
                 const int8_t* q, const float* scales, const int* tables,
                 int64_t rows, int F, int n_prev, int n_nodes,
                 int level_base, int* nid_out, float* hist, void* ws,
                 cudaStream_t s) {
#define H2O3_GROUPED_I8(CT, WW, T)                                           \
  do {                                                                       \
    using Src = CodeBins<CT, WW>;                                            \
    using Mass = h2o3::I8Mass<T>;                                            \
    if (plan_only) {                                                         \
      h2o3::GroupedPlan p;                                                   \
      const int rc = h2o3::plan_grouped<Src, Mass>(rows, F, n_prev, n_nodes, \
                                                   &p);                      \
      *bytes = rc == 0 ? p.bytes : 0;                                        \
      return rc;                                                             \
    }                                                                        \
    return h2o3::launch_grouped<Src, Mass>(                                  \
        Src{static_cast<const CT*>(codes), tables}, nid,                     \
        h2o3::QRec<T>{q, rows}, rows, F, n_prev, n_nodes, level_base, 0,     \
        nid_out,                                                             \
        h2o3::MergeFlushI8<T>{scales, static_cast<int64_t>(n_nodes) * F * WW,\
                              hist},                                         \
        ws, s);                                                              \
  } while (0)
#define H2O3_GROUPED_I8_W(CT, WW)               \
  if (terms == 1) H2O3_GROUPED_I8(CT, WW, 1);   \
  H2O3_GROUPED_I8(CT, WW, 2);
  if (code_bytes == 1) {
    switch (W) {
      case 16: H2O3_GROUPED_I8_W(int8_t, 16)
      case 32: H2O3_GROUPED_I8_W(int8_t, 32)
      default: break;
    }
  }
#undef H2O3_GROUPED_I8_W
#undef H2O3_GROUPED_I8
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 level (K4) on the wide body (W = 64, 128, 256): int8 records,
// the masses added into int32 partials, the merge flushing to float32.
// plan_only: the workspace bytes alone.
int wide_i8_w(int code_bytes, int W, int terms, bool plan_only,
              size_t* bytes, const void* codes, const int* nid,
              const int8_t* q, const float* scales, const int* tables,
              int64_t rows, int F, int n_prev, int n_nodes, int level_base,
              int* nid_out, float* hist, void* ws, cudaStream_t s) {
#define H2O3_WIDE_I8(CT, WW, T)                                              \
  return h2o3::launch_wide<CodeBins<CT, WW>, h2o3::I8Mass<T>>(              \
      CodeBins<CT, WW>{static_cast<const CT*>(codes), tables}, plan_only,    \
      bytes, nid, h2o3::QRec<T>{q, rows}, rows, F, n_prev, n_nodes,          \
      level_base, 0, nid_out,                                                \
      h2o3::MergeFlushI8<T>{scales, static_cast<int64_t>(n_nodes) * F * WW,  \
                            hist},                                           \
      ws, s)
#define H2O3_WIDE_I8_W(CT, WW)               \
  if (terms == 1) H2O3_WIDE_I8(CT, WW, 1);   \
  H2O3_WIDE_I8(CT, WW, 2);
  if (code_bytes == 1) {
    switch (W) {
      case 64: H2O3_WIDE_I8_W(int8_t, 64)
      case 128: H2O3_WIDE_I8_W(int8_t, 128)
      default: break;
    }
  } else if (code_bytes == 2 && W == 256) {
    H2O3_WIDE_I8_W(int16_t, 256)
  }
#undef H2O3_WIDE_I8_W
#undef H2O3_WIDE_I8
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 level in form `form` (after h2o3::i8_level_form). The tiled
// body zeroes its int32 sums (in ws) and flushes them after its launch.
// plan_only: the workspace bytes alone.
int i8_level(int form, bool plan_only, size_t* bytes, const void* codes,
             int code_bytes, const int* nid, const int8_t* q, int terms,
             const float* scales, const int* tables, int64_t rows, int F,
             int W, int n_prev, int n_nodes, int level_base, int* nid_out,
             float* hist, void* ws, cudaStream_t s) {
  switch (form) {
    case h2o3::kTiledForm: {
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
              ? launch_level_w<1>(codes, code_bytes, nid, q, tables, rows, F,
                                  W, n_prev, n_nodes, level_base, 0, nid_out,
                                  acc, s)
              : launch_level_w<2>(codes, code_bytes, nid, q, tables, rows, F,
                                  W, n_prev, n_nodes, level_base, 0, nid_out,
                                  acc, s);
      if (rc != 0) return rc;
      return h2o3::launch_flush_i8(acc, scales, terms,
                                   static_cast<int64_t>(n_nodes) * F * W,
                                   hist, s);
    }
    case h2o3::kTensorForm:
      return grouped_i8_w(code_bytes, W, terms, plan_only, bytes, codes, nid,
                          q, scales, tables, rows, F, n_prev, n_nodes,
                          level_base, nid_out, hist, ws, s);
    case h2o3::kWideForm:
      return wide_i8_w(code_bytes, W, terms, plan_only, bytes, codes, nid, q,
                       scales, tables, rows, F, n_prev, n_nodes, level_base,
                       nid_out, hist, ws, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The form of binned_level_i8 at these shapes (h2o3::i8_level_form).
inline int i8_form(int form, int code_bytes, int64_t rows, int F, int W,
                   int terms, int n_prev, int n_nodes) {
  return h2o3::i8_level_form(form, false, rows, F, W, terms, code_bytes,
                             false, n_prev, n_nodes);
}

}  // namespace

extern "C" {

// The workspace bytes of h2o3_binned_level at these shapes and form (-1
// picked, or a LevelForm forced: the grouped forms' grouping and block
// partials; 0 for the tiled body), -1 where the shapes are refused.
long long h2o3_binned_level_workspace(int code_bytes, long long rows, int F,
                                      int W, int n_prev, int n_nodes,
                                      int bf16, int form) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0) return -1;
  size_t bytes = 0;
  const int rc = float_level(
      h2o3::level_form(form, false, rows, F, W, n_prev, n_nodes), true,
      &bytes, nullptr, code_bytes, nullptr, nullptr, nullptr, rows, F, W,
      n_prev, n_nodes, 0, bf16, nullptr, nullptr, nullptr, nullptr);
  return rc == 0 ? static_cast<long long>(bytes) : -1;
}

// The form h2o3_binned_level picks at these shapes (h2o3::level_form; a
// LevelForm code).
int h2o3_binned_level_picks(long long rows, int F, int W, int n_prev,
                            int n_nodes) {
  return h2o3::level_form(h2o3::kPickForm, false, rows, F, W, n_prev,
                          n_nodes);
}

// codes [rows, F] int8 (W <= 128) or int16 (W == 256), row-major; nid
// [rows] int32; ghw [3, rows] float32; tables [4, max(n_prev, 1)] int32;
// form -1 (picked from the shapes, h2o3::level_form) or forced: 0 (tiled
// body), 1 (tensor-core grouped body), 2 (wide body); a forced grouped
// form that does not fit is an error; ws,
// h2o3_binned_level_workspace bytes for the same form. Writes nid_out
// [rows] int32 and ADDS into hist [3, n_nodes, F, W] float32, which the
// caller zeroes. Returns a cudaError_t value.
int h2o3_binned_level(const void* codes, int code_bytes, const int* nid,
                      const float* ghw, const int* tables, long long rows,
                      int F, int W, int n_prev, int n_nodes, int level_base,
                      int bf16, int form, int* nid_out, float* hist,
                      void* ws, void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t unused = 0;
  return float_level(
      h2o3::level_form(form, false, rows, F, W, n_prev, n_nodes), false,
      &unused, codes, code_bytes, nid, ghw, tables, rows, F, W, n_prev,
      n_nodes, level_base, bf16, nid_out, hist, ws,
      static_cast<cudaStream_t>(stream));
}

// The workspace bytes of h2o3_binned_level_i8 at these shapes and form
// (-1 picked, or a LevelForm forced): a grouped form's grouping and block
// partials, or the tiled body's int32 sums; -1 where the shapes are
// refused (a forced grouped form that does not fit or has no instance).
long long h2o3_binned_level_i8_workspace(int code_bytes, long long rows,
                                         int F, int W, int n_prev,
                                         int n_nodes, int terms, int form) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      (terms != 1 && terms != 2))
    return -1;
  size_t bytes = 0;
  const int rc = i8_level(
      i8_form(form, code_bytes, rows, F, W, terms, n_prev, n_nodes), true,
      &bytes, nullptr, code_bytes, nullptr, nullptr, terms, nullptr, nullptr,
      rows, F, W, n_prev, n_nodes, 0, nullptr, nullptr, nullptr, nullptr);
  return rc == 0 ? static_cast<long long>(bytes) : -1;
}

// The form h2o3_binned_level_i8 picks at these shapes
// (h2o3::i8_level_form; a LevelForm code).
int h2o3_binned_level_i8_picks(int code_bytes, long long rows, int F, int W,
                               int n_prev, int n_nodes, int terms) {
  return i8_form(h2o3::kPickForm, code_bytes, rows, F, W, terms, n_prev,
                 n_nodes);
}

// The int8 level: q [3 * terms, rows] int8 (terms 1 or 2), scales [3]
// float32 in place of ghw; form -1 (picked from the shapes,
// h2o3::i8_level_form) or forced: 0 (tiled body, its int32 sums zeroed
// here, then flush_i8_kernel), 1 (tensor-core grouped body, W <= 32), 2
// (wide body, W = 64, 128, 256), the grouped ones merging and flushing in
// one pass; a forced grouped form that does not fit or has no instance at
// W is an error; ws, h2o3_binned_level_i8_workspace bytes for the same
// form. Writes nid_out [rows] int32 and hist [3, n_nodes, F, W] float32
// (all of it). Returns a cudaError_t value.
int h2o3_binned_level_i8(const void* codes, int code_bytes, const int* nid,
                         const int8_t* q, int terms, const float* scales,
                         const int* tables, long long rows, int F, int W,
                         int n_prev, int n_nodes, int level_base, int form,
                         int* nid_out, float* hist, void* ws, void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      (terms != 1 && terms != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t unused = 0;
  return i8_level(
      i8_form(form, code_bytes, rows, F, W, terms, n_prev, n_nodes), false,
      &unused, codes, code_bytes, nid, q, terms, scales, tables, rows, F, W,
      n_prev, n_nodes, level_base, nid_out, hist, ws,
      static_cast<cudaStream_t>(stream));
}

// The deepest level's route: same operands as h2o3_binned_level without
// ghw and hist. Returns a cudaError_t value.
int h2o3_binned_route_only(const void* codes, int code_bytes, const int* nid,
                           const int* tables, long long rows, int F, int W,
                           int n_prev, int level_base, int* nid_out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_prev < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks64 = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 32;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  if (code_bytes == 1) {
    binned_route_only_kernel<int8_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), nid, tables, rows, F, W, n_prev,
        level_base, nid_out);
  } else if (code_bytes == 2) {
    binned_route_only_kernel<int16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int16_t*>(codes), nid, tables, rows, F, W, n_prev,
        level_base, nid_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
