// threefry2x32 draws on the card: jax.random.uniform's bits, and the
// row sample w * (u < rate) fused into the same pass.
//
// Replaces no TPU kernel: the JAX package draws its sampling masks with
// jax.random (threefry2x32, partitionable, 32-bit), which XLA fuses into
// one pass; in plain torch the same arithmetic is some hundred int64
// element-wise launches over the rows. Each thread takes flat indices i
// (a grid-stride loop), runs the cipher's 20 rounds on the counter
// (i >> 32, i & 0xffffffff) under the two key words, and turns
// (y0 ^ y1) >> 9 | 0x3F800000, read as a float, minus 1, into u in
// [0, 1): the bits of jax.random.uniform, element i depending on i alone.
//
// Bound: bytes on this card (4 written a row; 4 read and 4 written, 8
// read with per-class rates, for the fused sample) against ~76 integer
// operations a row, which at the card's 32-bit scalar rate take about as
// long as the uniform's store. The rotations are funnel shifts; nothing
// is staged, every store is coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ float threefry_uniform_at(uint32_t k0, uint32_t k1,
                                                     long long i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  x0 += k0;
  x1 += k1;
#define H2O3_ROUND(r) \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;
#define H2O3_GROUP_A H2O3_ROUND(13) H2O3_ROUND(15) H2O3_ROUND(26) H2O3_ROUND(6)
#define H2O3_GROUP_B H2O3_ROUND(17) H2O3_ROUND(29) H2O3_ROUND(16) H2O3_ROUND(24)
  H2O3_GROUP_A
  x0 += k1; x1 += k2 + 1u;
  H2O3_GROUP_B
  x0 += k2; x1 += k0 + 2u;
  H2O3_GROUP_A
  x0 += k0; x1 += k1 + 3u;
  H2O3_GROUP_B
  x0 += k1; x1 += k2 + 4u;
  H2O3_GROUP_A
  x0 += k2; x1 += k0 + 5u;
#undef H2O3_GROUP_A
#undef H2O3_GROUP_B
#undef H2O3_ROUND
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __uint_as_float(bits) - 1.0f;
}

// kMode 0: out = u; 1: out = w * (u < rate); 2: out = w * (u < rates[c]),
// c = y clamped into [0, n_rates)
template <int kMode>
__global__ void threefry_kernel(uint32_t k0, uint32_t k1, long long n,
                                const float* __restrict__ w,
                                const int* __restrict__ y,
                                const float* __restrict__ rates, int n_rates,
                                float rate, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float u = threefry_uniform_at(k0, k1, i);
    if (kMode == 0) {
      out[i] = u;
    } else {
      float thr = rate;
      if (kMode == 2) {
        int c = y[i];
        c = c < 0 ? 0 : (c >= n_rates ? n_rates - 1 : c);
        thr = rates[c];
      }
      // the product, as the JAX package writes w * (u < thr)
      out[i] = w[i] * (u < thr ? 1.0f : 0.0f);
    }
  }
}

constexpr int kThreads = 256;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  // a grid-stride loop past 32 resident blocks an SM of 132
  const long long cap = 132LL * 32;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

// u [n] float32: jax.random.uniform((k0, k1), shape) flattened
int h2o3_threefry_uniform(unsigned int k0, unsigned int k1, long long n,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  threefry_kernel<0><<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, nullptr, nullptr, nullptr, 0, 0.0f,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [n] = w * (u < rate), or with y and rates (n_rates > 0)
// w * (u < rates[clamp(y, 0, n_rates - 1)])
int h2o3_threefry_sample(unsigned int k0, unsigned int k1, long long n,
                         const void* w, const void* y, const void* rates,
                         int n_rates, float rate, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rates > 0) {
    threefry_kernel<2><<<grid_for(n), kThreads, 0, s>>>(
        k0, k1, n, static_cast<const float*>(w), static_cast<const int*>(y),
        static_cast<const float*>(rates), n_rates, 0.0f,
        static_cast<float*>(out));
  } else {
    threefry_kernel<1><<<grid_for(n), kThreads, 0, s>>>(
        k0, k1, n, static_cast<const float*>(w), nullptr, nullptr, 0, rate,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
