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
// adaptive_route_only replaces _route_kernel_t (K6) and _route_kernel
// (K9): the deepest level's route, one thread per row, no histogram.
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
// bytes. Design, as binned_level's in hist_binned.cu: a block takes 512
// rows at a time; phase 1 routes them (one thread per row) and stages
// node id and (g, h, w) in shared memory; phase 2 walks the chunk's
// features in the layout's own order (consecutive threads on consecutive
// addresses: along a row in [rows, F], along a feature in [F, rows]),
// bins each value under the (node, feature) range staged in shared memory
// for the block's tile, and adds into a per-block histogram in shared
// memory at a stride of W + 1 floats per feature. Blocks merge their
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

template <int W, bool kFeatMajor>
__global__ void __launch_bounds__(kThreads)
adaptive_level_kernel(const float* __restrict__ x,
                      const int* __restrict__ nid_in,
                      const float* __restrict__ ghw,
                      const float* __restrict__ tables,
                      const float* __restrict__ lo,
                      const float* __restrict__ inv, int64_t rows, int F,
                      int n_prev, int n_nodes, int level_base, int node_tile,
                      int feat_tile, int n_feat_tiles, int bf16,
                      int* __restrict__ nid_out, float* __restrict__ hist) {
  extern __shared__ float smem[];
  const int tile = blockIdx.y;
  const int n0 = (tile / n_feat_tiles) * node_tile;
  const int f0 = (tile % n_feat_tiles) * feat_tile;
  const int nt = min(node_tile, n_nodes - n0);
  const int ft = min(feat_tile, F - f0);
  constexpr int WP = W + 1;
  const int cells = node_tile * feat_tile * WP;  // per component
  const int ranges = node_tile * feat_tile;
  float* s_hist = smem;                 // [3][node_tile][feat_tile][WP]
  float* s_lo = smem + 3 * cells;       // [node_tile][feat_tile]
  float* s_inv = s_lo + ranges;
  float* s_g = s_inv + ranges;
  float* s_h = s_g + kThreads;
  float* s_w = s_h + kThreads;
  int* s_lid = reinterpret_cast<int*>(s_w + kThreads);

  for (int i = threadIdx.x; i < 3 * cells; i += blockDim.x) s_hist[i] = 0.f;
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
      float g = ghw[r], h = ghw[rows + r], w = ghw[2 * rows + r];
      if (bf16) {
        g = h2o3::round_bf16(g);
        h = h2o3::round_bf16(h);
        w = h2o3::round_bf16(w);
      }
      s_g[threadIdx.x] = g;
      s_h[threadIdx.x] = h;
      s_w[threadIdx.x] = w;
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
      atomicAdd(s_hist + cell, s_g[rr]);
      atomicAdd(s_hist + cells + cell, s_h[rr]);
      atomicAdd(s_hist + 2 * cells + cell, s_w[rr]);
    }
  }
  __syncthreads();
  h2o3::merge_partial(s_hist, cells, WP, W, node_tile, feat_tile, n0, f0,
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

template <int W, bool kFeatMajor>
int launch_level(const float* x, const int* nid, const float* ghw,
                 const float* tables, const float* lo, const float* inv,
                 int64_t rows, int F, int n_prev, int n_nodes,
                 int level_base, int bf16, int* nid_out, float* hist,
                 cudaStream_t stream) {
  // a (node, feature) holds 3 x (W + 1) partial bins and its lo/inv pair
  const int64_t per_cell =
      (3 * (W + 1) + 2) * static_cast<int64_t>(sizeof(float));
  const h2o3::LevelTiles t = h2o3::level_tiles(n_nodes, F, per_cell);
  if (t.n_tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = ((3 * static_cast<size_t>(W + 1) + 2) * t.node_tile *
                           t.feat_tile + 4 * kThreads) * sizeof(float);
  auto kern = adaptive_level_kernel<W, kFeatMajor>;
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
      x, nid, ghw, tables, lo, inv, rows, F, n_prev, n_nodes, level_base,
      t.node_tile, t.feat_tile, t.n_feat_tiles, bf16, nid_out, hist);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFeatMajor>
int launch_level_w(int W, const float* x, const int* nid, const float* ghw,
                   const float* tables, const float* lo, const float* inv,
                   int64_t rows, int F, int n_prev, int n_nodes,
                   int level_base, int bf16, int* nid_out, float* hist,
                   cudaStream_t s) {
  switch (W) {
    case 16:
      return launch_level<16, kFeatMajor>(x, nid, ghw, tables, lo, inv, rows,
                                          F, n_prev, n_nodes, level_base,
                                          bf16, nid_out, hist, s);
    case 32:
      return launch_level<32, kFeatMajor>(x, nid, ghw, tables, lo, inv, rows,
                                          F, n_prev, n_nodes, level_base,
                                          bf16, nid_out, hist, s);
    case 64:
      return launch_level<64, kFeatMajor>(x, nid, ghw, tables, lo, inv, rows,
                                          F, n_prev, n_nodes, level_base,
                                          bf16, nid_out, hist, s);
    case 128:
      return launch_level<128, kFeatMajor>(x, nid, ghw, tables, lo, inv,
                                           rows, F, n_prev, n_nodes,
                                           level_base, bf16, nid_out, hist,
                                           s);
    case 256:
      return launch_level<256, kFeatMajor>(x, nid, ghw, tables, lo, inv,
                                           rows, F, n_prev, n_nodes,
                                           level_base, bf16, nid_out, hist,
                                           s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_nodes < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (feat_major)
    return launch_level_w<true>(W, x, nid, ghw, tables, lo, inv, rows, F,
                                n_prev, n_nodes, level_base, bf16, nid_out,
                                hist, s);
  return launch_level_w<false>(W, x, nid, ghw, tables, lo, inv, rows, F,
                               n_prev, n_nodes, level_base, bf16, nid_out,
                               hist, s);
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

}  // extern "C"
