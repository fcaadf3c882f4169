// Pieces the histogram kernels share (hist_binned.cu, hist_adaptive.cu,
// hist_global.cu): the block shape, the shared-memory budget of a block's
// partial histogram, how a level's [3, N, F, W] partial is cut into node x
// feature tiles that fit it, and the merge of a block's partial into the
// output.
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

// Add a block's nonzero partial cells ([3][node_tile][feat_tile][stride]
// in shared memory, `width` bins used of each `stride`) into hist
// [3, n_nodes, F, width] with global atomics. The level kernels pass a
// compile-time W and W + 1; the global-sketch kernel its run-time B1.
__device__ __forceinline__ void merge_partial(const float* s_hist, int cells,
                                              int stride, int width,
                                              int node_tile, int feat_tile,
                                              int n0, int f0, int nt, int ft,
                                              int n_nodes, int F,
                                              float* __restrict__ hist) {
  for (int i = threadIdx.x; i < 3 * cells; i += blockDim.x) {
    const float v = s_hist[i];
    if (v == 0.f) continue;
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

}  // namespace h2o3
