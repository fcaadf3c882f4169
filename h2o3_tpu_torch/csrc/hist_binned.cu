// Packed-code GBM level kernels for Hopper (sm_90a), plain C interface.
//
// binned_level (replaces h2o3_tpu/ops/hist_adaptive.py:_kernel_bt, K1, and
// its W=16 stripe form _kernel_bt_stripe, K3): one pass per tree level.
// Each row steps through the previous level's split tables, writes its new
// node id, and, when that node lies in the level's window, adds its
// (g, h, w) into the (node, feature, code) bin of every feature.
//
// binned_route_only (replaces _route_kernel_bt, K2): the deepest level's
// route, one thread per row, no histogram.
//
// Routing rule (both kernels, and the plain versions in
// ops/hist_adaptive.py): a row in the previous level's window whose node
// can split reads code = codes[row, feat]; NA (code == W-1) goes right
// unless na_left, any other code goes right when code >= split_bin; the
// child is 2*nid + 1 + right. Tables are int32 [4, n_prev]: feat,
// split_bin, na_left, can.
//
// What bounds them on an H100: memory. binned_level reads
// rows * (F * itemsize + 16) bytes and writes rows * 4 (about
// rows * (F * itemsize + 20) per level); its 3 * rows * F float adds are
// far below the 67 TFLOP/s f32 rate. binned_route_only moves about
// rows * 9 bytes. Design: a block takes 512 rows at a time; phase 1 routes
// them (one thread per row) and stages node id and (g, h, w) in shared
// memory; phase 2 walks the chunk's codes contiguously (coalesced byte
// loads) and adds into a per-block histogram in shared memory. Each
// feature's W bins sit at a stride of W + 1 floats, so the bins of
// neighbouring features start on different banks. At the end each block
// adds its nonzero partial cells into the output with global atomics.
// When the level's [3, N, F, W] partial does not fit the shared budget,
// the grid's second dimension splits it into node x feature tiles; each
// tile re-reads the rows it needs (level_common.cuh).
//
// What the simple design leaves on the table (later work): Hopper has no
// native shared-memory float atomic add, so each shared atomicAdd is a
// compare-and-swap loop (ATOMS.CAST.SPIN in the SASS) and the kernel is
// bound by those loops, not by memory; quantised integer masses would take
// the native ATOMS.ADD. The block-partial merge uses float atomics, so
// float sums vary in the last bits from run to run (integer masses are
// exact); a fixed-order merge would make them reproducible. No TMA or
// cp.async staging of the codes; no wgmma one-hot contraction; feature
// tiles re-read nid and ghw.

#include "level_common.cuh"

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

template <typename CodeT, int W>
__global__ void __launch_bounds__(kThreads)
binned_level_kernel(const CodeT* __restrict__ codes,
                    const int* __restrict__ nid_in,
                    const float* __restrict__ ghw,
                    const int* __restrict__ tables, int64_t rows, int F,
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
  float* s_hist = smem;                          // [3][node_tile][feat_tile][WP]
  float* s_g = smem + 3 * cells;
  float* s_h = s_g + kThreads;
  float* s_w = s_h + kThreads;
  int* s_lid = reinterpret_cast<int*>(s_w + kThreads);

  for (int i = threadIdx.x; i < 3 * cells; i += blockDim.x) s_hist[i] = 0.f;

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
    const CodeT* base = codes + r0 * F + f0;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int rr = i / ft;
      const int fl = i - rr * ft;
      const int ln = s_lid[rr];
      if (ln < 0) continue;
      const int c = static_cast<int>(base[static_cast<int64_t>(rr) * F + fl]);
      if (static_cast<unsigned>(c) >= static_cast<unsigned>(W)) continue;
      const int cell = (ln * feat_tile + fl) * WP + c;
      atomicAdd(s_hist + cell, s_g[rr]);
      atomicAdd(s_hist + cells + cell, s_h[rr]);
      atomicAdd(s_hist + 2 * cells + cell, s_w[rr]);
    }
  }
  __syncthreads();
  h2o3::merge_partial<W>(s_hist, cells, node_tile, feat_tile, n0, f0, nt, ft,
                         n_nodes, F, hist);
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

template <typename CodeT, int W>
int launch_level(const void* codes, const int* nid, const float* ghw,
                 const int* tables, int64_t rows, int F, int n_prev,
                 int n_nodes, int level_base, int bf16, int* nid_out,
                 float* hist, cudaStream_t stream) {
  const int64_t per_cell = 3 * (W + 1) * static_cast<int64_t>(sizeof(float));
  const h2o3::LevelTiles t = h2o3::level_tiles(n_nodes, F, per_cell);
  if (t.n_tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = (3 * static_cast<size_t>(t.node_tile) * t.feat_tile *
                          (W + 1) + 4 * kThreads) * sizeof(float);
  auto kern = binned_level_kernel<CodeT, W>;
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
      static_cast<const CodeT*>(codes), nid, ghw, tables, rows, F, n_prev,
      n_nodes, level_base, t.node_tile, t.feat_tile, t.n_feat_tiles, bf16,
      nid_out, hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes [rows, F] int8 (W <= 128) or int16 (W == 256), row-major; nid
// [rows] int32; ghw [3, rows] float32; tables [4, max(n_prev, 1)] int32.
// Writes nid_out [rows] int32 and ADDS into hist [3, n_nodes, F, W]
// float32, which the caller zeroes. Returns a cudaError_t value.
int h2o3_binned_level(const void* codes, int code_bytes, const int* nid,
                      const float* ghw, const int* tables, long long rows,
                      int F, int W, int n_prev, int n_nodes, int level_base,
                      int bf16, int* nid_out, float* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_nodes < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1) {
    switch (W) {
      case 16:
        return launch_level<int8_t, 16>(codes, nid, ghw, tables, rows, F,
                                        n_prev, n_nodes, level_base, bf16,
                                        nid_out, hist, s);
      case 32:
        return launch_level<int8_t, 32>(codes, nid, ghw, tables, rows, F,
                                        n_prev, n_nodes, level_base, bf16,
                                        nid_out, hist, s);
      case 64:
        return launch_level<int8_t, 64>(codes, nid, ghw, tables, rows, F,
                                        n_prev, n_nodes, level_base, bf16,
                                        nid_out, hist, s);
      case 128:
        return launch_level<int8_t, 128>(codes, nid, ghw, tables, rows, F,
                                         n_prev, n_nodes, level_base, bf16,
                                         nid_out, hist, s);
      default:
        break;
    }
  } else if (code_bytes == 2 && W == 256) {
    return launch_level<int16_t, 256>(codes, nid, ghw, tables, rows, F,
                                      n_prev, n_nodes, level_base, bf16,
                                      nid_out, hist, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
