// The adaptive level's pieces that the port's level kernels
// (hist_adaptive.cu, level_column.cuh) and the probe tools
// (h2o3_tpu_torch/tools/csrc/probes.cu) share: the raw-threshold route of
// one row, the re-bin under a node's range, the tiled body (K5 in
// [F, rows] where the column body does not fit, K7 where i8_level_form
// keeps it, and its launch), and the bin source of the node-grouped bodies
// (AdaptiveBins, K8 and K7 in [rows, F]). hist_adaptive.cu's header says
// what each computes, what bounds it and why it is built so.
#pragma once

#include <math.h>

#include "level_common.cuh"

namespace h2o3 {

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

// The tiled body (K5 where the column body does not fit, and K7 where
// i8_level_form keeps it); kA a phase knock-out (level_common.cuh), kNone
// in production.
template <int W, bool kFeatMajor, int kTerms, Ablate kA = Ablate::kNone>
__global__ void __launch_bounds__(kThreads)
adaptive_level_kernel(const float* __restrict__ x,
                      const int* __restrict__ nid_in,
                      const typename LevelMass<kTerms>::In* mass,
                      const float* __restrict__ tables,
                      const float* __restrict__ lo,
                      const float* __restrict__ inv, int64_t rows, int F,
                      int n_prev, int n_nodes, int level_base, int node_tile,
                      int feat_tile, int n_feat_tiles, int bf16,
                      int* __restrict__ nid_out,
                      typename LevelMass<kTerms>::Acc* __restrict__
                          hist) {
  using M = LevelMass<kTerms>;
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
  unsigned fold = 0u;  // kAdds: the adds' operands
  const int64_t n_chunks = (rows + kThreads - 1) / kThreads;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * kThreads;
    const int nr = (rows - r0) < kThreads ? static_cast<int>(rows - r0)
                                          : kThreads;
    __syncthreads();  // staging done / previous chunk's phase 2 done
    if (threadIdx.x < nr) {
      const int64_t r = r0 + threadIdx.x;
      int nid = nid_in[r];
      if constexpr (kA == Ablate::kRoute) {
        const int lp = nid - prev_base;
        if (n_prev > 0 && lp >= 0 && lp < n_prev &&
            __ldg(tables + 3 * n_prev + lp) > 0.5f)
          nid = 2 * nid + 1;
      } else if (n_prev > 0) {
        nid = route_row<kFeatMajor>(x, r, rows, F, nid, tables, n_prev,
                                    prev_base);
      }
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
      int bin;
      if constexpr (kA == Ablate::kBins) {
        bin = ablate_bin(static_cast<int>(r0 + rr), f0 + fl, W);
      } else {
        const float v = load_x<kFeatMajor>(x, r0 + rr, f0 + fl, rows, F);
        bin = kA == Ablate::kRanges
                  ? adaptive_bin<W>(v, -4.f, (W - 2) / 8.f)
                  : adaptive_bin<W>(v, s_lo[k], s_inv[k]);
      }
      const int cell = k * WP + bin;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if constexpr (kA == Ablate::kAdds)
          fold ^= static_cast<unsigned>(cell) ^
                  __float_as_uint(static_cast<float>(s_m[p * kThreads + rr]));
        else
          M::add(s_hist + p * cells + cell, s_m[p * kThreads + rr]);
      }
    }
  }
  if constexpr (kA == Ablate::kAdds) sink_fold(fold);
  __syncthreads();
  merge_partial(s_hist, P, cells, WP, W, node_tile, feat_tile, n0, f0,
                      nt, ft, n_nodes, F, hist);
}

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

// The tiled body's launch; a knock-out (kA) takes the production
// instance's grid.
template <int W, bool kFeatMajor, int kTerms, Ablate kA = Ablate::kNone>
int launch_adaptive_tiled(const float* x, const int* nid, const void* mass,
                          const float* tables, const float* lo,
                          const float* inv, int64_t rows, int F, int n_prev,
                          int n_nodes, int level_base, int bf16,
                          int* nid_out, void* hist, cudaStream_t stream) {
  using M = LevelMass<kTerms>;
  // a (node, feature) holds P x (W + 1) partial bins and its lo/inv pair
  const int64_t per_cell =
      static_cast<int64_t>(M::kPlanes) * (W + 1) *
          static_cast<int64_t>(sizeof(typename M::Acc)) +
      2 * static_cast<int64_t>(sizeof(float));
  const LevelTiles t = level_tiles(n_nodes, F, per_cell);
  if (t.n_tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      static_cast<size_t>(per_cell) * t.node_tile * t.feat_tile +
      kThreads * (sizeof(int) + M::kPlanes * sizeof(typename M::Stage));
  auto kern = adaptive_level_kernel<W, kFeatMajor, kTerms>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto launched = adaptive_level_kernel<W, kFeatMajor, kTerms, kA>;
  if constexpr (kA != Ablate::kNone) {
    err = cudaFuncSetAttribute(launched,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(level_grid_x(per_sm, t.n_tiles, rows)),
            static_cast<unsigned>(t.n_tiles));
  launched<<<grid, kThreads, smem, stream>>>(
      x, nid, static_cast<const typename M::In*>(mass), tables, lo, inv, rows,
      F, n_prev, n_nodes, level_base, t.node_tile, t.feat_tile,
      t.n_feat_tiles, bf16, nid_out, static_cast<typename M::Acc*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace h2o3
