// Cyclic coordinate descent of the elastic net on one Gram: the GLM's
// penalized IRLS solve, one thread block a solve.
//
// Replaces no TPU kernel: the JAX package's _cd_elastic_net
// (h2o3_tpu/models/glm.py:442) is a lax.fori_loop that XLA keeps on the
// device; in eager torch each coordinate would be about a dozen small
// launches, some 80k for one solve at the airlines width (P = 669, 10
// sweeps), on every IRLS step of a lambda path.
//
// It minimises 1/2 b'Gb - b'beta + lam1 |beta|_1 + 1/2 lam2 |beta|_2^2 over
// the penalised coordinates (pen[j] = 1; 0 for the intercept), coordinates
// j = 0 .. P-1 in turn, n_sweeps times, keeping Gb = G beta: for each j
//   rho   = b[j] - (Gb[j] - G[j,j] beta[j])
//   bj    = sign(rho) max(|rho| - lam1 pen[j], 0)
//           / (G[j,j] + lam2 pen[j] + 1e-12)
//   bj    = max(bj, 0) where a non-negativity flag holds, clamp(bj, lo, hi)
//   Gb   += G[:, j] (bj - beta[j]);  beta[j] = bj.
// Every product and sum is rounded as the plain version rounds it (one
// IEEE operation each: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, no
// contraction into fma), so the two agree bit for bit on the same inputs.
//
// Layout: one block of up to 1024 threads; the per-coordinate vectors
// (beta, Gb, b, the diagonal, the divisor, lam1 pen, the bounds and the
// non-negativity flag: 9 floats a coordinate) live in shared memory up to
// P = kSharedMaxP, in a global workspace above it. Thread 0 forms the new
// coordinate and publishes its delta; after one barrier every thread adds
// G[:, j] delta into its entries of Gb, reading row j of G' (the wrapper
// passes G transposed, so that column j of G is contiguous), and a second
// barrier closes the step. Each thread fetches its entries of the next
// row while the current step runs.
//
// Bound: the 10 P steps are a dependent chain, each at least one block
// barrier (h2o3_cd_barrier_probe times one); G's P^2 floats, read once,
// take P^2 4 / 3.35 TB/s (0.5 us at P = 669), far below the chain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kArrays = 9;
constexpr int kSharedMaxP = 6400;     // 9 * 4 * 6400 = 230,400 bytes
constexpr int kMaxThreads = 1024;

// torch.clamp(x, min=lo) and the upper bound: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : (x > hi ? hi : x);
}

// torch.sign: (0 < x) - (x < 0), 0 for NaN
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

// kPer > 0: each thread owns kPer entries (i = tid + k * blockDim) and
// keeps their next row in registers; kPer = 0: a strided loop, no
// prefetch (P past kMaxThreads * 8)
template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
cd_elastic_net_kernel(const float* __restrict__ Gt,
                      const float* __restrict__ b,
                      const float* __restrict__ beta0,
                      const float* __restrict__ Gb0,
                      const float* __restrict__ pen,
                      const float* __restrict__ nn, int nn_mode,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi, float lam1, float lam2,
                      int P, int n_sweeps, float* ws,
                      float* __restrict__ beta_out) {
  extern __shared__ float smem[];
  __shared__ float delta_sh;
  float* base = ws != nullptr ? ws : smem;
  float* beta = base;
  float* Gb = base + P;
  float* bb = base + 2 * P;
  float* d = base + 3 * P;
  float* den = base + 4 * P;
  float* l1 = base + 5 * P;
  float* lo_ = base + 6 * P;
  float* hi_ = base + 7 * P;
  float* flag = base + 8 * P;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < P; i += nt) {
    const float dj = Gt[static_cast<long long>(i) * P + i];
    const float pj = pen[i];
    beta[i] = beta0[i];
    Gb[i] = Gb0[i];
    bb[i] = b[i];
    d[i] = dj;
    l1[i] = __fmul_rn(lam1, pj);
    den[i] = __fadd_rn(__fadd_rn(dj, __fmul_rn(lam2, pj)), 1e-12f);
    lo_[i] = lo != nullptr ? lo[i] : -__int_as_float(0x7f800000);
    hi_[i] = hi != nullptr ? hi[i] : __int_as_float(0x7f800000);
    flag[i] = nn_mode == 2 ? (nn[i] > 0.0f ? 1.0f : 0.0f)
                           : (nn_mode == 1 ? (pj > 0.0f ? 1.0f : 0.0f)
                                           : 0.0f);
  }
  float g[kPer > 0 ? kPer : 1];
  if (kPer > 0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * nt;
      g[k] = i < P ? Gt[i] : 0.0f;
    }
  }
  __syncthreads();
  for (int sweep = 0; sweep < n_sweeps; ++sweep)
  for (int j = 0; j < P; ++j) {
    const int jn = j + 1 < P ? j + 1 : 0;
    float gn[kPer > 0 ? kPer : 1];
    if (kPer > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * nt;
        gn[k] = i < P ? Gt[static_cast<long long>(jn) * P + i] : 0.0f;
      }
    }
    if (tid == 0) {
      const float bj_old = beta[j];
      const float gj = __fsub_rn(Gb[j], __fmul_rn(d[j], bj_old));
      const float rho = __fsub_rn(bb[j], gj);
      const float a = clamp_min(__fsub_rn(fabsf(rho), l1[j]), 0.0f);
      float bj = __fdiv_rn(__fmul_rn(sign_of(rho), a), den[j]);
      if (flag[j] > 0.0f) bj = clamp_min(bj, 0.0f);
      bj = clamp_max(clamp_min(bj, lo_[j]), hi_[j]);
      delta_sh = __fsub_rn(bj, bj_old);
      beta[j] = bj;
    }
    __syncthreads();
    const float dl = delta_sh;
    if (kPer > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * nt;
        if (i < P) Gb[i] = __fadd_rn(Gb[i], __fmul_rn(g[k], dl));
        g[k] = gn[k];
      }
    } else {
      const float* row = Gt + static_cast<long long>(j) * P;
      for (int i = tid; i < P; i += nt) {
        Gb[i] = __fadd_rn(Gb[i], __fmul_rn(row[i], dl));
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < P; i += nt) beta_out[i] = beta[i];
}

// one block barrier a step on a dependent chain: thread 0 advances a
// shared value (double-buffered, so that one barrier a step suffices),
// every thread reads it after the barrier
__global__ void __launch_bounds__(kMaxThreads)
barrier_probe_kernel(long long steps, float* out) {
  __shared__ float v[2];
  float acc = 0.0f;
  float x = 1.0f;
  for (long long s = 0; s < steps; ++s) {
    if (threadIdx.x == 0) {
      x = __fadd_rn(__fmul_rn(x, 0.999f), 1e-3f);
      v[s & 1] = x;
    }
    __syncthreads();
    acc = __fadd_rn(acc, v[s & 1]);
  }
  if (threadIdx.x == 0) out[0] = acc;
}

int threads_for(int P) {
  int t = P < kMaxThreads ? P : kMaxThreads;
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : t;
}

template <int kPer>
int launch(const float* Gt, const float* b, const float* beta0,
           const float* Gb0, const float* pen, const float* nn, int nn_mode,
           const float* lo, const float* hi, float lam1, float lam2, int P,
           int n_sweeps, float* ws, float* out, cudaStream_t s) {
  const int threads = threads_for(P);
  const size_t smem = ws != nullptr ? 0
                                    : static_cast<size_t>(kArrays) * P *
                                          sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cd_elastic_net_kernel<kPer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cd_elastic_net_kernel<kPer><<<1, threads, smem, s>>>(
      Gt, b, beta0, Gb0, pen, nn, nn_mode, lo, hi, lam1, lam2, P, n_sweeps,
      ws, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bytes of global workspace a solve of P coordinates needs (0: the
// vectors fit in shared memory)
long long h2o3_cd_workspace(int P) {
  return P <= kSharedMaxP ? 0
                          : static_cast<long long>(kArrays) * P *
                                static_cast<long long>(sizeof(float));
}

// beta_out [P] from Gt = G' [P, P] (row-major), b, beta0, Gb0 = G beta0,
// pen [P]; nn_mode 0 none, 1 non-negative where pen > 0, 2 where nn > 0;
// lo / hi [P] or null; ws: h2o3_cd_workspace(P) bytes or null
int h2o3_cd_elastic_net(const void* Gt, const void* b, const void* beta0,
                        const void* Gb0, const void* pen, const void* nn,
                        int nn_mode, const void* lo, const void* hi,
                        float lam1, float lam2, int P, int n_sweeps, void* ws,
                        void* beta_out, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_Gt = static_cast<const float*>(Gt);
  const float* f_b = static_cast<const float*>(b);
  const float* f_b0 = static_cast<const float*>(beta0);
  const float* f_Gb0 = static_cast<const float*>(Gb0);
  const float* f_pen = static_cast<const float*>(pen);
  const float* f_nn = static_cast<const float*>(nn);
  const float* f_lo = static_cast<const float*>(lo);
  const float* f_hi = static_cast<const float*>(hi);
  float* f_ws = static_cast<float*>(ws);
  float* f_out = static_cast<float*>(beta_out);
  if (P > kSharedMaxP && f_ws == nullptr) return cudaErrorInvalidValue;
  const int per = (P + kMaxThreads - 1) / kMaxThreads;
#define H2O3_CD_LAUNCH(K)                                                   \
  return launch<K>(f_Gt, f_b, f_b0, f_Gb0, f_pen, f_nn, nn_mode, f_lo,     \
                   f_hi, lam1, lam2, P, n_sweeps, f_ws, f_out, s)
  if (per <= 1) H2O3_CD_LAUNCH(1);
  if (per <= 2) H2O3_CD_LAUNCH(2);
  if (per <= 4) H2O3_CD_LAUNCH(4);
  if (per <= 8) H2O3_CD_LAUNCH(8);
  H2O3_CD_LAUNCH(0);
#undef H2O3_CD_LAUNCH
}

// `steps` dependent steps of one barrier each in one block of `threads`
int h2o3_cd_barrier_probe(long long steps, int threads, void* out,
                          void* stream) {
  barrier_probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
