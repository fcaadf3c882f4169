// The packed-code level's bin source (K1/K3, K4), shared by the port's
// level kernels (hist_binned.cu) and the probe tools (h2o3_tpu_torch/
// tools/csrc/probes.cu): the code is the bin.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace h2o3 {

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

}  // namespace h2o3
