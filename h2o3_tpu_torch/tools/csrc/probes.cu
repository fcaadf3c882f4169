// The probe kernels of the port's tools (h2o3_tpu_torch/tools), for Hopper
// (sm_90a), plain C interface. They answer, for the card, the questions the
// JAX package's TPU probes (tools/kern_*.py) asked of the TPU:
//
// P1 mxu_probe_kernel (replaces tools/kern_mxu_probe.py:47, run.kern):
//   out[M, FW] = n_tiles * L[M, K] . R[FW, K]^T, the histogram-shaped
//   contraction, bf16 -> float32 (mma.sync m16n8k16) or int8 -> int32
//   (m16n8k32, exact). The TPU kernel re-reads one resident block every
//   grid step, so it times the matrix unit's issue and not HBM; here each
//   warp stages its operands once (through shared memory into registers)
//   and issues its products n_tiles times from registers. M is padded to
//   16-row fragments, so an M below 16 leaves the tensor core's rows idle,
//   the analog of the MXU's 128-row question. Bound: operations, 2 M FW K
//   n_tiles at 989 TFLOP/s bf16 or 1979 TOP/s int8 (dense, H100 SXM).
//
// P5 gather_probe_kernel and onehot_probe_kernel (replace
//   tools/kern_gather_probe.py:24 kern_gather and :34 kern_matmul, run at
//   :45): out[S, rows] = tab[S, N][:, idx], an index outside [0, N)
//   giving 0. The gather reads the table from shared memory, exact; the
//   one-hot product runs it as bf16(tab) . onehot(idx) with mma.sync
//   m16n8k16, exact for the bf16-rounded table (one nonzero product a
//   sum). Bound: bytes, idx read and out written once.
//
// P2-P4, P6: h2o3_probe_level launches a phase knock-out (level_common.cuh
//   Ablate) of the bodies the training path runs: level_grouped_kernel
//   (level_grouped.cuh; float and int8 masses), level_wide_kernel
//   (level_wide.cuh; float and int8 masses) and the tiled
//   adaptive_level_kernel (adaptive_bins.cuh). The bodies come in through
//   the headers; no kernel is copied here. A knock-out runs on the
//   production instance's plan (span, blocks, grid), and the grouping pass
//   and the merge of a grouped body can be launched alone at the level's
//   shapes.
//
// The file is built once per part (-DH2O3_PROBE_PART=0..4, one nvcc each,
// all started together): part 0 holds P1, P5 and the tiled body's
// knock-outs, parts 1-4 the grouped float, grouped int8, wide float and
// wide int8 bodies'. Each part's h2o3_probe_level refuses the bodies of the
// others.
#include <cuda_bf16.h>

#include "../../csrc/adaptive_bins.cuh"
#include "../../csrc/code_bins.cuh"
#include "../../csrc/level_wide.cuh"

#ifndef H2O3_PROBE_PART
#define H2O3_PROBE_PART 0
#endif

namespace {

using namespace h2o3;

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

#if H2O3_PROBE_PART == 0

// ------------------------------------------------------------------- P1
//
// A block of 4 warps owns a 16 x 64 output tile and 512 bytes of K (256
// bf16 or 512 int8 values); warp w owns the tile over K bytes [128 w,
// 128 w + 128): four k-steps of 32 bytes. Its A fragments (4 x 4 words)
// and B fragments (8 n-tiles x 4 k-steps x 2 words) are read once from the
// block's staged slice; then n_tiles passes of 32 products each run from
// registers. The block adds its warps' sums in warp order and each output
// into out with one global atomic (the k-blocks' order varies: float sums
// differ in the last bits, int32 sums are exact).
constexpr int kMxuWarps = 4;
constexpr int kMxuKBytes = 512;   // K bytes a block
constexpr int kMxuCols = 64;      // output columns a block

__device__ __forceinline__ void mma_tile(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  mma_bf16(d, a, b);
}
__device__ __forceinline__ void mma_tile(int (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  mma_s8(d, a, b);
}

// Acc float: L, R bf16 [., K]; int: int8. out [M, FW] (Acc), zeroed by the
// caller. K bytes a multiple of kMxuKBytes, FW of kMxuCols.
template <typename Acc>
__global__ void __launch_bounds__(32 * kMxuWarps)
mxu_probe_kernel(const unsigned char* __restrict__ L,
                 const unsigned char* __restrict__ R, int M, int FW,
                 int kbytes, int n_tiles, Acc* __restrict__ out) {
  __shared__ __align__(16) unsigned char s_a[16 * kMxuKBytes];
  __shared__ __align__(16) unsigned char s_b[kMxuCols * kMxuKBytes];
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * kMxuCols;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * kMxuKBytes;
  // stage the slices (16-byte loads; rows of A past M are zero)
  for (int i = threadIdx.x; i < 16 * kMxuKBytes / 16; i += blockDim.x) {
    const int r = i / (kMxuKBytes / 16), c = i - r * (kMxuKBytes / 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(L + (m0 + r) * int64_t{kbytes} +
                                          k0 + 16 * c);
    reinterpret_cast<uint4*>(s_a)[i] = v;
  }
  for (int i = threadIdx.x; i < kMxuCols * kMxuKBytes / 16; i += blockDim.x) {
    const int r = i / (kMxuKBytes / 16), c = i - r * (kMxuKBytes / 16);
    reinterpret_cast<uint4*>(s_b)[i] = *reinterpret_cast<const uint4*>(
        R + (n0 + r) * int64_t{kbytes} + k0 + 16 * c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kb = warp * 128;  // this warp's K bytes in the slice
  unsigned a[4][4], b[4][8][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int o = kb + 32 * ks + 4 * t;
    a[ks][0] = *reinterpret_cast<const unsigned*>(s_a + g * kMxuKBytes + o);
    a[ks][1] =
        *reinterpret_cast<const unsigned*>(s_a + (g + 8) * kMxuKBytes + o);
    a[ks][2] =
        *reinterpret_cast<const unsigned*>(s_a + g * kMxuKBytes + o + 16);
    a[ks][3] = *reinterpret_cast<const unsigned*>(s_a + (g + 8) * kMxuKBytes +
                                                  o + 16);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const unsigned char* rb = s_b + (8 * n + g) * kMxuKBytes + o;
      b[ks][n][0] = *reinterpret_cast<const unsigned*>(rb);
      b[ks][n][1] = *reinterpret_cast<const unsigned*>(rb + 16);
    }
  }
  Acc d[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = Acc(0);
  for (int rep = 0; rep < n_tiles; ++rep) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int n = 0; n < 8; ++n) mma_tile(d[n], a[ks], b[ks][n]);
  }
  // the warps' sums in warp order (the staged slices are free now)
  __syncthreads();
  Acc* s_d = reinterpret_cast<Acc*>(s_b);  // [warps][16][64]
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      s_d[(warp * 16 + row) * kMxuCols + col] = d[n][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * kMxuCols; i += blockDim.x) {
    const int row = i / kMxuCols, col = i - row * kMxuCols;
    if (m0 + row >= M) continue;
    Acc s = s_d[i];
#pragma unroll
    for (int w = 1; w < kMxuWarps; ++w) s += s_d[w * 16 * kMxuCols + i];
    atomicAdd(out + static_cast<int64_t>(m0 + row) * FW + n0 + col, s);
  }
}

// ------------------------------------------------------------------- P5

constexpr int kProbeThreads = 256;

// A thread a row, the table in shared memory.
__global__ void __launch_bounds__(kProbeThreads)
gather_probe_kernel(const float* __restrict__ tab, int S, int N,
                    const int* __restrict__ idx, int64_t rows,
                    float* __restrict__ out) {
  extern __shared__ float s_tab[];  // [S][N]
  for (int i = threadIdx.x; i < S * N; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += step) {
    const int k = idx[r];
    const bool ok = static_cast<unsigned>(k) < static_cast<unsigned>(N);
    for (int s = 0; s < S; ++s) out[s * rows + r] = ok ? s_tab[s * N + k] : 0.f;
  }
}

// A warp takes 8 rows at a time: out[S, 8 rows] = bf16(tab)[S <= 64, N <=
// 32] . onehot[32, 8 rows], four m-tiles x two k-steps of m16n8k16. The A
// fragments (the table, rounded to bf16) are built once a warp; lane (g,
// t) builds the one-hot B fragment of row g (bf16 1.0 where idx == k).
__global__ void __launch_bounds__(kProbeThreads)
onehot_probe_kernel(const float* __restrict__ tab, int S, int N,
                    const int* __restrict__ idx, int64_t rows,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto tb = [&](int m, int k) -> unsigned {
    const float v = m < S && k < N ? tab[m * N + k] : 0.f;
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  };
  unsigned a[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int m = 16 * mt + g, k = 16 * ks + 2 * t;
      a[mt][ks][0] = tb(m, k) | tb(m, k + 1) << 16;
      a[mt][ks][1] = tb(m + 8, k) | tb(m + 8, k + 1) << 16;
      a[mt][ks][2] = tb(m, k + 8) | tb(m, k + 9) << 16;
      a[mt][ks][3] = tb(m + 8, k + 8) | tb(m + 8, k + 9) << 16;
    }
  constexpr unsigned kOne = 0x3F80u;  // bf16 1.0
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  const int64_t w0 =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  for (int64_t r0 = 8 * w0; r0 < rows; r0 += 8 * warps) {
    const int k = r0 + g < rows ? idx[r0 + g] : -1;
    float d[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kk = 16 * ks + 2 * t;
      auto one = [&](int j) { return k == j ? kOne : 0u; };
      const unsigned b[2] = {one(kk) | one(kk + 1) << 16,
                             one(kk + 8) | one(kk + 9) << 16};
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_bf16(d[mt], a[mt][ks], b);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * mt + g + 8 * (e >> 1);
        const int64_t r = r0 + 2 * t + (e & 1);
        if (m < S && r < rows) out[m * rows + r] = d[mt][e];
      }
  }
}

int probe_blocks(int64_t work, int per_block) {
  int64_t nb = (work + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  if (nb > cap) nb = cap;
  return nb < 1 ? 1 : static_cast<int>(nb);
}

#endif  // H2O3_PROBE_PART == 0

// ---------------------------------------------------- the knock-outs
//
// One launch of a probed body: the level under knock-out kA (what 0), the
// level's grouping pass alone (1) or the merge of its blocks' partials
// alone (2, reading the grouping and partials a level or grouping launch
// at the same shapes left in ws); plan_only: the workspace bytes alone.

struct LevelArgs {
  const void* vals;  // x float32 [rows, F] ([F, rows]: the tiled body)
                     // or codes [rows, F]
  const int* nid;
  const float* ghw;
  const int8_t* q;
  const float* scales;
  const void* tables;
  const float* lo;
  const float* inv;
  int64_t rows;
  int F, n_prev, n_nodes, level_base, bf16;
  int* nid_out;
  float* hist;
  void* ws;
  cudaStream_t s;
};

// Whether body kWide, bin source Src and mass Mass take knock-out kA: the
// ranges only where bins need them, the walk only where the float wide
// body walks, the gather only on the wide body.
template <bool kWide, class Src, class Mass, Ablate kA>
constexpr bool takes() {
  if (kA == Ablate::kRanges) return Src::kRanges;
  if (kA == Ablate::kWalk) return kWide && !Mass::kInt;
  if (kA == Ablate::kGather) return kWide;
  return true;
}

template <bool kWide, class Src, class Mass, Ablate kA, class Epi>
int run_body(int what, bool plan_only, size_t* bytes, const Src& src,
             typename Mass::Rec masses, Epi epi, const LevelArgs& a) {
  if constexpr (!takes<kWide, Src, Mass, kA>()) {
    return kInvalid;
  } else {
    using Part = typename Mass::Part;
    using RecT = typename Mass::Rec::T;
    int G;
    int64_t span;
    int rc;
    if constexpr (kWide) {
      WidePlan p;
      rc = plan_wide<Src, Mass>(a.rows, a.F, a.n_prev, a.n_nodes, &p);
      G = p.G;
      span = p.span;
      *bytes = rc == 0 ? p.bytes : 0;
    } else {
      GroupedPlan p;
      rc = plan_grouped<Src, Mass>(a.rows, a.F, a.n_prev, a.n_nodes, &p);
      G = p.G;
      span = p.span;
      *bytes = rc == 0 ? p.bytes : 0;
    }
    if (rc != 0 || plan_only) return rc;
    if (what == 0) {
      if constexpr (kWide)
        return launch_wide<Src, Mass, Epi, kA>(
            src, false, bytes, a.nid, masses, a.rows, a.F, a.n_prev,
            a.n_nodes, a.level_base, a.bf16, a.nid_out, epi, a.ws, a.s);
      else
        return launch_grouped<Src, Mass, Epi, kA>(
            src, a.nid, masses, a.rows, a.F, a.n_prev, a.n_nodes,
            a.level_base, a.bf16, a.nid_out, epi, a.ws, a.s);
    }
    Grouping g;
    Part* part = reinterpret_cast<Part*>(carve_grouping(
        static_cast<char*>(a.ws), a.rows, G, &g, sizeof(RecT)));
    if (what == 1) {
      const ParentKey<Src> key{a.nid,        src,       a.n_prev,
                               a.level_base - a.n_prev,
                               a.level_base, a.n_nodes, a.nid_out};
      return launch_grouping(key, masses, a.rows, G, span, g, a.s);
    }
    if (what != 2) return kInvalid;
    const int64_t fw = static_cast<int64_t>(a.F) * Src::kW;
    return launch_merge(GroupedSrc{a.n_nodes, a.n_prev, a.level_base, fw},
                        part, 2 * Mass::kPlanes * fw, g.bstart,
                        3 * a.n_nodes * fw, epi, a.s);
  }
}

template <int W>
AdaptiveBins<W> adaptive_src(const LevelArgs& a) {
  return AdaptiveBins<W>{static_cast<const float*>(a.vals),
                         static_cast<const float*>(a.tables), a.lo, a.inv};
}

template <typename CT, int W>
CodeBins<CT, W> code_src(const LevelArgs& a) {
  return CodeBins<CT, W>{static_cast<const CT*>(a.vals),
                         static_cast<const int*>(a.tables)};
}

// The probed bodies (the tools' BODIES, h2o3_tpu_torch/tools/_probes.py):
// 0 the tiled [F, rows] adaptive level at W = 32, float masses; 1, 2 the
// tensor-core grouped body, adaptive W = 32 and packed W = 16, bf16
// masses; 3, 4 the same with one-term int8 masses; 5, 6 the wide body,
// adaptive W = 64 and packed W = 256 (int16 codes), float masses; 7, 8
// the same with one-term int8 masses.
template <Ablate kA>
int body_level(int body, int what, bool plan_only, size_t* bytes,
               const LevelArgs& a) {
  const MergeAdd add{a.hist};
  const GhwRec ghw{a.ghw, a.rows};
  const QRec<1> q{a.q, a.rows};
  const int64_t cells = static_cast<int64_t>(a.n_nodes) * a.F;
  (void)add;
  (void)ghw;
  (void)q;
  (void)cells;
  switch (body) {
#if H2O3_PROBE_PART == 0
    case 0:
      if constexpr (kA == Ablate::kWalk || kA == Ablate::kGather) {
        return kInvalid;
      } else {
        if (what != 0) return kInvalid;
        *bytes = 0;
        if (plan_only) return 0;
        return launch_adaptive_tiled<32, true, 0, kA>(
            static_cast<const float*>(a.vals), a.nid, a.ghw,
            static_cast<const float*>(a.tables), a.lo, a.inv, a.rows, a.F,
            a.n_prev, a.n_nodes, a.level_base, a.bf16, a.nid_out, a.hist,
            a.s);
      }
#elif H2O3_PROBE_PART == 1
    case 1:
      return run_body<false, AdaptiveBins<32>, FloatMass<1, true>, kA>(
          what, plan_only, bytes, adaptive_src<32>(a), ghw, add, a);
    case 2:
      return run_body<false, CodeBins<int8_t, 16>, FloatMass<1, true>, kA>(
          what, plan_only, bytes, code_src<int8_t, 16>(a), ghw, add, a);
#elif H2O3_PROBE_PART == 2
    case 3:
      return run_body<false, AdaptiveBins<32>, I8Mass<1>, kA>(
          what, plan_only, bytes, adaptive_src<32>(a), q,
          MergeFlushI8<1>{a.scales, cells * 32, a.hist}, a);
    case 4:
      return run_body<false, CodeBins<int8_t, 16>, I8Mass<1>, kA>(
          what, plan_only, bytes, code_src<int8_t, 16>(a), q,
          MergeFlushI8<1>{a.scales, cells * 16, a.hist}, a);
#elif H2O3_PROBE_PART == 3
    case 5:
      return run_body<true, AdaptiveBins<64>, WideFloat, kA>(
          what, plan_only, bytes, adaptive_src<64>(a), ghw, add, a);
    case 6:
      return run_body<true, CodeBins<int16_t, 256>, WideFloat, kA>(
          what, plan_only, bytes, code_src<int16_t, 256>(a), ghw, add, a);
#elif H2O3_PROBE_PART == 4
    case 7:
      return run_body<true, AdaptiveBins<64>, I8Mass<1>, kA>(
          what, plan_only, bytes, adaptive_src<64>(a), q,
          MergeFlushI8<1>{a.scales, cells * 64, a.hist}, a);
    case 8:
      return run_body<true, CodeBins<int16_t, 256>, I8Mass<1>, kA>(
          what, plan_only, bytes, code_src<int16_t, 256>(a), q,
          MergeFlushI8<1>{a.scales, cells * 256, a.hist}, a);
#endif
    default:
      return kInvalid;
  }
}

int by_ablate(int ablate, int body, int what, bool plan_only, size_t* bytes,
              const LevelArgs& a) {
  // the grouping and the merge alone, and the workspace, are the
  // production instance's
  if (what != 0 || plan_only) ablate = 0;
  switch (ablate) {
    case 0: return body_level<Ablate::kNone>(body, what, plan_only, bytes, a);
    case 1: return body_level<Ablate::kRoute>(body, what, plan_only, bytes, a);
    case 2: return body_level<Ablate::kRanges>(body, what, plan_only, bytes, a);
    case 3: return body_level<Ablate::kBins>(body, what, plan_only, bytes, a);
    case 4: return body_level<Ablate::kAdds>(body, what, plan_only, bytes, a);
    case 5: return body_level<Ablate::kWalk>(body, what, plan_only, bytes, a);
    case 6: return body_level<Ablate::kGather>(body, what, plan_only, bytes, a);
    default: return kInvalid;
  }
}

}  // namespace

extern "C" {

// The workspace bytes of h2o3_probe_level for body `body` at these shapes;
// -1 where the part has no such body or the shapes are refused.
long long h2o3_probe_level_workspace(int body, long long rows, int F,
                                     int n_prev, int n_nodes) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0) return -1;
  LevelArgs a{};
  a.rows = rows;
  a.F = F;
  a.n_prev = n_prev;
  a.n_nodes = n_nodes;
  size_t bytes = 0;
  const int rc = by_ablate(0, body, 0, true, &bytes, a);
  return rc == 0 ? static_cast<long long>(bytes) : -1;
}

// One launch of a probed body (the bodies above; a part refuses the
// others): what 0, the level under knock-out `ablate` (an Ablate value;
// one the body does not take is refused); 1, its grouping pass alone; 2,
// its merge alone, from the grouping and partials left in ws. Operands as
// h2o3_adaptive_level / h2o3_binned_level (tables float32 or int32 by the
// bin source), the int8 bodies' q [3, rows] int8 and scales [3] float32 in
// place of ghw; the float bodies at bf16 (the grouped float ones take no
// other). The float bodies ADD into hist, which the caller zeroes; the
// int8 ones write it. Returns a cudaError_t value.
int h2o3_probe_level(int body, int ablate, int what, const void* vals,
                     const int* nid, const float* ghw, const int8_t* q,
                     const float* scales, const void* tables,
                     const float* lo, const float* inv, long long rows, int F,
                     int n_prev, int n_nodes, int level_base, int bf16,
                     int* nid_out, float* hist, void* ws, void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      (body >= 1 && body <= 2 && !bf16))
    return kInvalid;
  const LevelArgs a{vals,   nid,     ghw,        q,    scales,  tables,
                    lo,     inv,     rows,       F,    n_prev,  n_nodes,
                    level_base,      bf16,       nid_out,       hist,
                    ws,     static_cast<cudaStream_t>(stream)};
  size_t unused = 0;
  return by_ablate(ablate, body, what, false, &unused, a);
}

#if H2O3_PROBE_PART == 0

// P1: L, R [M, K] and [FW, K] of `elem` bytes (2: bf16, 1: int8),
// row-major; K * elem a multiple of 512 bytes, FW of 64; out [M, FW]
// float32 (bf16) or int32 (int8), zeroed by the caller. Returns a
// cudaError_t value.
int h2o3_mxu_probe(const void* L, const void* R, int elem, int M, int FW,
                   int K, int n_tiles, void* out, void* stream) {
  const int kbytes = K * elem;
  if ((elem != 1 && elem != 2) || M < 1 || n_tiles < 0 || FW % kMxuCols ||
      K < 1 || kbytes % kMxuKBytes)
    return kInvalid;
  const dim3 grid((M + 15) / 16, FW / kMxuCols, kbytes / kMxuKBytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const unsigned char*>(L);
  const auto* r = static_cast<const unsigned char*>(R);
  if (elem == 2)
    mxu_probe_kernel<float><<<grid, 32 * kMxuWarps, 0, s>>>(
        l, r, M, FW, kbytes, n_tiles, static_cast<float*>(out));
  else
    mxu_probe_kernel<int><<<grid, 32 * kMxuWarps, 0, s>>>(
        l, r, M, FW, kbytes, n_tiles, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P5: tab [S, N] float32, idx [rows] int32, out [S, rows] float32 (all of
// it written). onehot 0: the shared-memory gather; 1: the one-hot product
// (S <= 64, N <= 32). Returns a cudaError_t value.
int h2o3_gather_probe(const float* tab, int S, int N, const int* idx,
                      long long rows, int onehot, float* out, void* stream) {
  if (S < 1 || N < 1 || rows < 0 || (onehot && (S > 64 || N > 32)) ||
      static_cast<size_t>(S) * N * sizeof(float) > 48 * 1024)
    return kInvalid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (onehot)
    onehot_probe_kernel<<<probe_blocks(rows, 8 * (kProbeThreads / 32)),
                          kProbeThreads, 0, s>>>(tab, S, N, idx, rows, out);
  else
    gather_probe_kernel<<<probe_blocks(rows, kProbeThreads), kProbeThreads,
                          sizeof(float) * S * N, s>>>(tab, S, N, idx, rows,
                                                      out);
  return static_cast<int>(cudaGetLastError());
}

#endif  // H2O3_PROBE_PART == 0

}  // extern "C"
