// Pieces the histogram kernels share (hist_binned.cu, hist_adaptive.cu,
// hist_global.cu): the block shape, the shared-memory budget of a block's
// partial histogram, how a level's [planes, N, F, W] partial is cut into
// node x feature tiles that fit it, the masses a level kernel adds (float
// (g, h, w), or int8 fixed-point terms summed in int32), the merge of a
// block's partial into the output, and the int8 levels' float32 flush.
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

}  // namespace h2o3
