// Global-sketch histogram kernel for Hopper (sm_90a), plain C interface.
//
// global_hist replaces h2o3_tpu/ops/hist_pallas.py:_kernel (K11): the
// per-node gradient histogram of the global-sketch tree grower, with no
// routing in it. For codes [rows, F] (uint8 or int32, values in [0, B1),
// the NA bin B1-1 included), per-row node ids seg [rows] (a row whose seg
// lies outside [0, N) is excluded) and (g, h, w) as ghw [3, rows], it adds
//
//   hist[k, n, f, b] += sum over rows of [seg == n] * ghw[k] * [code_f == b]
//
// into hist [3, N, F, B1] float32. With bf16 each of g, h and w is rounded
// to bfloat16 (round to nearest even) before the float32 add, as the TPU
// kernel's bf16 left operand does (its one-hots are exact).
//
// The TPU kernel contracts a node one-hot times (g, h, w) with a bin
// one-hot on the matrix unit: a chip without a fast scatter. Hopper has
// one, so this is a scatter, in one of two forms chosen per launch from
// the shapes. Both take 512 rows a block at a time; phase 1 reads each
// row's seg (one thread per row) and, for the rows it will add, stages
// (g, h, w) in shared memory; phase 2 walks the chunk's codes, row-major.
//
// - Shared partials (the shape of binned_level in hist_binned.cu): phase 2
//   adds into a per-block histogram in shared memory at a stride of
//   B1 | 1 floats per (node, feature) cell (odd, so neighbouring cells
//   start on other banks), and blocks merge their partials with global
//   atomics (level_common.cuh). The bin count is a run-time value; at
//   B1 = 1025 one cell takes 12.3 KB, so a level's [3, N, F, B1] partial
//   is cut into node x feature tiles, down to one feature and eight nodes
//   a tile, and every tile re-reads every row's seg and its own rows'
//   ghw and codes.
// - Global atomics: phase 2 adds straight into a float64 copy of hist
//   (acc, which the caller zeroes) with double atomicAdd, which Hopper
//   executes in L2 (REDG.E.ADD.F64), one pass over the rows whatever N
//   and B1 are; a second pass adds acc, rounded once, into hist. Its cost
//   follows the number of adds, not the tiles, and same-address adds
//   serialise, so it loses where few bins take many rows. The sum is
//   float64 because one global sum per bin is a chain as long as the
//   bin's rows: in float32 a 125k-row bin drifted by up to 1.25e-5 of its
//   mass from run to run, past the 1e-5 that the shared partials (short
//   chains per block) keep.
//
// The launcher alone picks the form (kMaxSharedTiles below): shared
// partials when the tiling needs at most 4 tiles, global atomics
// otherwise, also where no tiling fits (one cell past the shared budget,
// B1 above 8959, or more than 65535 tiles). The crossover was measured on
// an H100 at the global path's 10M x 28 (chip_smoke.py times both forms
// at every build): shared partials win up to 4 tiles, global atomics from
// 7 on. h2o3_global_hist_form forces one form, for that measurement and
// the tests; the training path calls h2o3_global_hist.
//
// What bounds it on an H100: memory, on paper. It must read every row's
// seg and the codes and ghw of the rows it adds, rows * 4 + added *
// (F * itemsize + 12) bytes, and write 3 * N * F * B1 * 4; its
// 3 * added * F float adds are far below the 67 TFLOP/s f32 rate. In
// practice the atomics bound both forms: the shared-memory float atomic
// add is a compare-and-swap loop on Hopper (ATOMS.CAST.SPIN), and the L2
// takes the global ones at a fixed rate. Rows sorted by node, tensor-core
// one-hot products or TMA staging are later work.

#include "level_common.cuh"

namespace {

using h2o3::kThreads;

// kTiled: the block's node x feature tile of a shared partial, merged at
// the end; else every node and feature, added straight into hist.
template <typename CodeT, bool kTiled>
__global__ void __launch_bounds__(kThreads)
global_hist_kernel(const CodeT* __restrict__ codes,
                   const int* __restrict__ seg,
                   const float* __restrict__ ghw, int64_t rows, int F,
                   int n_nodes, int B1, int stride, int node_tile,
                   int feat_tile, int n_feat_tiles, int bf16,
                   double* __restrict__ acc, float* __restrict__ hist) {
  extern __shared__ float smem[];
  const int tile = blockIdx.y;
  const int n0 = (tile / n_feat_tiles) * node_tile;
  const int f0 = (tile % n_feat_tiles) * feat_tile;
  const int nt = min(node_tile, n_nodes - n0);
  const int ft = min(feat_tile, F - f0);
  // per component: cells of the shared partial, values of hist
  const int cells = kTiled ? node_tile * feat_tile * stride : 0;
  const int64_t plane = static_cast<int64_t>(n_nodes) * F * B1;
  float* s_hist = smem;               // [3][node_tile][feat_tile][stride]
  float* s_g = smem + 3 * cells;
  float* s_h = s_g + kThreads;
  float* s_w = s_h + kThreads;
  int* s_lid = reinterpret_cast<int*>(s_w + kThreads);

  if (kTiled)
    for (int i = threadIdx.x; i < 3 * cells; i += blockDim.x) s_hist[i] = 0.f;

  const int64_t n_chunks = (rows + kThreads - 1) / kThreads;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * kThreads;
    const int nr = (rows - r0) < kThreads ? static_cast<int>(rows - r0)
                                          : kThreads;
    __syncthreads();  // zeroing done / previous chunk's phase 2 done
    if (threadIdx.x < nr) {
      const int64_t r = r0 + threadIdx.x;
      const int ln = seg[r] - n0;
      const bool mine = ln >= 0 && ln < nt;
      s_lid[threadIdx.x] = mine ? ln : -1;
      if (mine) {
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
      if (static_cast<unsigned>(c) >= static_cast<unsigned>(B1)) continue;
      if (kTiled) {
        const int cell = (ln * feat_tile + fl) * stride + c;
        atomicAdd(s_hist + cell, s_g[rr]);
        atomicAdd(s_hist + cells + cell, s_h[rr]);
        atomicAdd(s_hist + 2 * cells + cell, s_w[rr]);
      } else {
        double* o = acc + (static_cast<int64_t>(ln) * F + fl) * B1 + c;
        atomicAdd(o, static_cast<double>(s_g[rr]));
        atomicAdd(o + plane, static_cast<double>(s_h[rr]));
        atomicAdd(o + 2 * plane, static_cast<double>(s_w[rr]));
      }
    }
  }
  if (kTiled) {
    __syncthreads();
    h2o3::merge_partial(s_hist, 3, cells, stride, B1, node_tile, feat_tile,
                        n0, f0, nt, ft, n_nodes, F, hist);
  }
}

// hist[i] += acc[i], rounded once to float32: the global-atomics form's
// second pass.
__global__ void __launch_bounds__(kThreads)
add_acc_kernel(const double* __restrict__ acc, int64_t n,
               float* __restrict__ hist) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step)
    hist[i] = __fadd_rn(hist[i], __double2float_rn(acc[i]));
}

template <typename CodeT, bool kTiled>
int launch_form(const void* codes, const int* seg, const float* ghw,
                int64_t rows, int F, int n_nodes, int B1, int stride,
                const h2o3::LevelTiles& t, int bf16, double* acc,
                float* hist, cudaStream_t stream) {
  const size_t smem = (3 * static_cast<size_t>(kTiled ? t.node_tile : 0) *
                           t.feat_tile * stride + 4 * kThreads) *
                      sizeof(float);
  auto kern = global_hist_kernel<CodeT, kTiled>;
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
      static_cast<const CodeT*>(codes), seg, ghw, rows, F, n_nodes, B1,
      stride, t.node_tile, t.feat_tile, t.n_feat_tiles, bf16, acc, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess || kTiled) return static_cast<int>(err);
  const int64_t n = 3 * static_cast<int64_t>(n_nodes) * F * B1;
  const int64_t blocks64 = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 8;
  add_acc_kernel<<<static_cast<unsigned>(blocks64 > cap ? cap : blocks64),
                   kThreads, 0, stream>>>(acc, n, hist);
  return static_cast<int>(cudaGetLastError());
}

// shared partials up to this many node x feature tiles, global atomics
// beyond: the crossover of the global path's builds (10M x 28, half the
// rows added after level 0) on an H100. It moves with the share of rows a
// build adds, which the launcher does not see: at 1M rows with 90% added,
// shared partials still win at 14 tiles.
constexpr int kMaxSharedTiles = 4;

// form: kPick chooses by the tile count; kShared and kGlobal force one
// (kShared fails where no tiling fits)
enum Form { kPick = -1, kGlobal = 0, kShared = 1 };

template <typename CodeT>
int launch(const void* codes, const int* seg, const float* ghw, int64_t rows,
           int F, int n_nodes, int B1, int bf16, int form, double* acc,
           float* hist, cudaStream_t stream) {
  const int stride = B1 | 1;  // odd: neighbouring cells on other banks
  const int64_t per_cell = 3 * static_cast<int64_t>(stride) * sizeof(float);
  const h2o3::LevelTiles t = h2o3::level_tiles(n_nodes, F, per_cell);
  const bool tiled =
      form == kPick ? t.n_tiles > 0 && t.n_tiles <= kMaxSharedTiles
                    : form == kShared;
  if (tiled) {
    if (t.n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_form<CodeT, true>(codes, seg, ghw, rows, F, n_nodes, B1,
                                    stride, t, bf16, acc, hist, stream);
  }
  const h2o3::LevelTiles whole = {n_nodes, F, 1, 1};
  return launch_form<CodeT, false>(codes, seg, ghw, rows, F, n_nodes, B1,
                                   stride, whole, bf16, acc, hist, stream);
}

int launch_codes(const void* codes, int code_bytes, const int* seg,
                 const float* ghw, long long rows, int F, int n_nodes, int B1,
                 int bf16, int form, double* acc, float* hist,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_nodes < 1 || B1 < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return launch<uint8_t>(codes, seg, ghw, rows, F, n_nodes, B1, bf16, form,
                           acc, hist, s);
  if (code_bytes == 4)
    return launch<int32_t>(codes, seg, ghw, rows, F, n_nodes, B1, bf16, form,
                           acc, hist, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// codes [rows, F] uint8 (code_bytes 1) or int32 (code_bytes 4), row-major;
// seg [rows] int32; ghw [3, rows] float32. ADDS into hist [3, n_nodes, F,
// B1] float32, which the caller zeroes, in the form the shapes pick; acc,
// the same shape in float64 and zeroed by the caller, is the global-
// atomics form's scratch. Returns a cudaError_t value.
int h2o3_global_hist(const void* codes, int code_bytes, const int* seg,
                     const float* ghw, long long rows, int F, int n_nodes,
                     int B1, int bf16, double* acc, float* hist,
                     void* stream) {
  return launch_codes(codes, code_bytes, seg, ghw, rows, F, n_nodes, B1,
                      bf16, kPick, acc, hist, stream);
}

// The same with one form forced (shared 1: shared partials, an error
// where no tiling fits; 0: global atomics), for measurement and tests.
int h2o3_global_hist_form(const void* codes, int code_bytes, const int* seg,
                          const float* ghw, long long rows, int F,
                          int n_nodes, int B1, int bf16, int shared,
                          double* acc, float* hist, void* stream) {
  return launch_codes(codes, code_bytes, seg, ghw, rows, F, n_nodes, B1,
                      bf16, shared ? kShared : kGlobal, acc, hist, stream);
}

}  // extern "C"
