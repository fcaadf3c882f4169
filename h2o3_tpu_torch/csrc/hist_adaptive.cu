// Adaptive-bin GBM level kernels for Hopper (sm_90a), plain C interface:
// H2O's UniformAdaptive histogram, re-binned per (node, feature) at every
// level over raw float32 features (NaN = NA).
//
// adaptive_level replaces h2o3_tpu/ops/hist_adaptive.py:_kernel_t (K5, the
// [F, rows] layout) and _kernel (K8, [rows, F]); the layout is a template
// parameter. One pass per tree level: each row steps through the previous
// level's split tables by a raw-threshold compare, writes its new node id,
// and, when that node lies in the level's window, bins every feature under
// the node's range, b = floor(clip((x - lo) * inv, 0, W-2)) with NaN in
// lane W-1, and adds its (g, h, w) into the (node, feature, bin) cell.
//
// adaptive_level_i8 replaces _kernel_t_i8 (K7): the same level with the
// int8 fixed-point masses of quantize_ghw_i8 (H2O3_HIST_I8), as the
// integer-mass instance (kTerms = 1 or 2) of the same kernel, in both
// layouts (the TPU kernel exists only in [F, rows]; the port trains in
// [rows, F]). Staging, int32 shared partial with native integer atomics,
// int32 merge and float32 flush as binned_level_i8 (hist_binned.cu); the
// histogram is bit-equal to the plain version.
//
// adaptive_route_only replaces _route_kernel_t (K6) and _route_kernel
// (K9): the deepest level's route, one thread per row, no histogram.
//
// leaf_totals replaces _totals_kernel (K10): route one level of x
// [rows, F] (none when n_prev is 0), then sum float32 (g, h, w) per node
// of the window into totals [3, n_nodes]. No grower calls it, in either
// package. What bounds it: memory, rows * 24 bytes (nid in and out, ghw,
// one x value a row); 3 adds a row. Design: one thread per row; each warp
// sums the lanes of each node with 32 shuffles (the same lane order for
// every key) and its lowest lane of the node adds the sums into the
// block's [3, n_nodes] shared totals; each block then adds its nonzero
// totals into the output with global float atomics. Float sums in another
// order than the plain version's: held within 1e-4 + 1e-5 x |mass| of a
// float64 plain version, as the other float checks are.
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
// far below the 67 TFLOP/s f32 rate. adaptive_route_only moves rows * 12
// bytes; adaptive_level_i8 reads 3 * terms in place of 12 bytes of mass a
// row. Design, as binned_level's in hist_binned.cu: a block takes 512
// rows at a time; phase 1 routes them (one thread per row) and stages
// node id and (g, h, w) in shared memory; phase 2 walks the chunk's
// features in the layout's own order (consecutive threads on consecutive
// addresses: along a row in [rows, F], along a feature in [F, rows]),
// bins each value under the (node, feature) range staged in shared memory
// for the block's tile, and adds into a per-block histogram in shared
// memory at a stride of W + 1 words per feature. Blocks merge their
// partials with global atomics; node x feature tiles keep a partial within
// the shared budget (level_common.cuh). The shared-memory float atomic
// adds are compare-and-swap loops on Hopper (ATOMS.CAST.SPIN), as in
// binned_level: they, not memory, are expected to bound this kernel.

#include <math.h>

#include "level_common.cuh"

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

__global__ void __launch_bounds__(kThreads)
leaf_totals_kernel(const float* __restrict__ x,
                   const int* __restrict__ nid_in,
                   const float* __restrict__ ghw,
                   const float* __restrict__ tables, int64_t rows, int F,
                   int n_prev, int n_nodes, int level_base,
                   int* __restrict__ nid_out, float* __restrict__ totals) {
  extern __shared__ float s_tot[];  // [3][n_nodes]
  for (int i = threadIdx.x; i < 3 * n_nodes; i += blockDim.x) s_tot[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int prev_base = level_base - n_prev;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // the loop bound is the same for every lane of a warp, so the shuffles
  // below always run on the full warp
  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    (threadIdx.x - lane);
       w0 < rows; w0 += step) {
    const int64_t r = w0 + lane;
    int key = -1;
    float g = 0.f, h = 0.f, w = 0.f;
    if (r < rows) {
      int nid = nid_in[r];
      if (n_prev > 0)
        nid = route_row<false>(x, r, rows, F, nid, tables, n_prev,
                               prev_base);
      nid_out[r] = nid;
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
        sg += vg;
        sh += vh;
        sw += vw;
      }
    }
    if (key >= 0 && lowest) {  // the node's lowest lane
      atomicAdd(s_tot + key, sg);
      atomicAdd(s_tot + n_nodes + key, sh);
      atomicAdd(s_tot + 2 * n_nodes + key, sw);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * n_nodes; i += blockDim.x) {
    const float v = s_tot[i];
    if (v != 0.f) atomicAdd(totals + i, v);
  }
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

}  // namespace

extern "C" {

// x float32 [rows, F] (feat_major 0) or [F, rows] (feat_major 1), NaN =
// NA; nid [rows] int32; ghw [3, rows] float32; tables [4, max(n_prev, 1)]
// float32; lo, inv [n_nodes, F] float32. Writes nid_out [rows] int32 and
// ADDS into hist [3, n_nodes, F, W] float32, which the caller zeroes.
// Returns a cudaError_t value.
int h2o3_adaptive_level(const float* x, int feat_major, const int* nid,
                        const float* ghw, const float* tables,
                        const float* lo, const float* inv, long long rows,
                        int F, int W, int n_prev, int n_nodes, int level_base,
                        int bf16, int* nid_out, float* hist, void* stream) {
  if (F < 1 || n_nodes < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_level_lw<0>(feat_major, W, x, nid, ghw, tables, lo, inv, rows,
                            F, n_prev, n_nodes, level_base, bf16, nid_out,
                            hist, static_cast<cudaStream_t>(stream));
}

// The int8 level: q [3 * terms, rows] int8 (terms 1 or 2), scales [3]
// float32 in place of ghw; acc [3 * terms, n_nodes, F, W] int32, which the
// caller zeroes, takes the sums; writes nid_out and hist [3, n_nodes, F, W]
// float32 (all of it, in the flush). Returns a cudaError_t value.
int h2o3_adaptive_level_i8(const float* x, int feat_major, const int* nid,
                           const int8_t* q, int terms, const float* scales,
                           const float* tables, const float* lo,
                           const float* inv, long long rows, int F, int W,
                           int n_prev, int n_nodes, int level_base,
                           int* nid_out, int* acc, float* hist,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_nodes < 1 || rows < 0 || (terms != 1 && terms != 2))
    return static_cast<int>(cudaErrorInvalidValue);
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

// Route one level of x [rows, F] float32 (none when n_prev is 0) and ADD
// each node's (g, h, w) sums into totals [3, n_nodes] float32, which the
// caller zeroes; writes nid_out [rows] int32. tables [4, max(n_prev, 1)]
// float32 as h2o3_adaptive_level's. Returns a cudaError_t value.
int h2o3_leaf_totals(const float* x, const int* nid, const float* ghw,
                     const float* tables, long long rows, int F, int n_prev,
                     int n_nodes, int level_base, int* nid_out,
                     float* totals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * static_cast<size_t>(n_nodes) * sizeof(float);
  if (F < 1 || n_nodes < 1 || rows < 0 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks64 = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 4;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  leaf_totals_kernel<<<blocks, kThreads, smem, s>>>(
      x, nid, ghw, tables, rows, F, n_prev, n_nodes, level_base, nid_out,
      totals);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
