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
// one, so this is a scatter, with the rows grouped by node first (the row
// partition of XGBoost's gpu_hist, which hist_pallas.py names as the GPU
// design). Two forms, picked per launch from the shapes:
//
// - Node-grouped (every shape whose cell fits shared memory, up to
//   kMaxGroups nodes): the grouping pass of level_common.cuh writes the
//   rows of each node, with their (g, h, w), into one contiguous stably
//   ordered list of 16-byte records. A block owns (node, feature slice,
//   span of that node's records): it keeps [3][fs][B1 | 1] float partials
//   in shared memory (fs features, as many as the 105 KB budget allows,
//   evened out over the slices: 7 of 28 at B1 = 1025), reads each record
//   once and its row's fs codes (one or two 32-byte sectors), and adds
//   with shared float atomics. No block reads a row outside its node and
//   no code is read twice. Each block writes its partial into its own slot
//   of a scratch buffer; a second pass sums each cell's slots in slot
//   order, so no float chain runs across blocks.
// - Global atomics (one (node, feature) cell past the shared budget, B1
//   above 8959, or more than kMaxGroups nodes: no training path at its
//   default sizes): one pass over the rows adds straight into a float64
//   copy of hist with double atomicAdd (L2 REDG.E.ADD.F64), a second adds
//   it, rounded once, into hist. The sum is float64 because one global sum
//   per bin is a chain as long as the bin's rows: in float32 a 125k-row
//   bin drifted past the 1e-5 of its mass that the checks keep.
//
// This replaced (an earlier port of K11) shared partials over node x
// feature tiles, every tile re-reading every row's seg and its rows' codes
// at a 112-byte stride, with global atomics from 4 tiles on: 4.85 ms at the
// global path's N = 16 build on an H100, against 3.38 ms for one
// index_add_. h2o3_global_hist_form forces one form (grouped 1, global
// atomics 0), for the tests and chip_smoke.py; the training path calls
// h2o3_global_hist.
//
// What bounds it on an H100: memory, on paper. It must read every row's
// seg and the codes and ghw of the rows it adds, rows * 4 + added *
// (F * itemsize + 12) bytes, and write 3 * N * F * B1 * 4; its
// 3 * added * F float adds are far below the 67 TFLOP/s f32 rate. In
// practice the shared-memory float atomic add, a compare-and-swap loop on
// Hopper (ATOMS.CAST.SPIN), bounds the grouped form: three a (row,
// feature). Within a block their order follows the warps' schedule, so
// the last bits of a float histogram can still differ between runs.

#include "level_common.cuh"

namespace {

using h2o3::kThreads;

// Node-grouped form: block (b, slice) adds the records of span b (of the
// node bstart assigns it) over features [slice * fs, + fs) into its
// shared partial, then writes the partial into part[b][3][F][B1].
template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
global_hist_grouped_kernel(const CodeT* __restrict__ codes,
                           const float4* __restrict__ rec,
                           const int* __restrict__ offsets,
                           const int* __restrict__ bstart, int G,
                           int64_t span, int F, int B1, int stride, int fs,
                           int bf16, float* __restrict__ part) {
  extern __shared__ float s_hist[];  // [3][fs][stride]
  const int b = blockIdx.x;
  if (b >= __ldg(bstart + G)) return;
  const int f0 = blockIdx.y * fs;
  const int ft = min(fs, F - f0);
  const int plane = fs * stride;
  for (int i = threadIdx.x; i < 3 * plane; i += blockDim.x) s_hist[i] = 0.f;
  __syncthreads();
  const int k = h2o3::span_group(bstart, G, b);
  const int64_t i0 = __ldg(offsets + k) +
                     static_cast<int64_t>(b - __ldg(bstart + k)) * span;
  const int64_t i1 =
      h2o3::imin64(__ldg(offsets + k + 1), i0 + span);
  for (int64_t i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const float4 q = rec[i];
    float g = q.y, h = q.z, w = q.w;
    if (bf16) {
      g = h2o3::round_bf16(g);
      h = h2o3::round_bf16(h);
      w = h2o3::round_bf16(w);
    }
    const CodeT* row =
        codes + static_cast<int64_t>(__float_as_int(q.x)) * F + f0;
    for (int f8 = 0; f8 < ft; f8 += 8) {
      int cv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cv[j] = f8 + j < ft ? static_cast<int>(row[f8 + j]) : -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (static_cast<unsigned>(cv[j]) >= static_cast<unsigned>(B1))
          continue;
        float* cell = s_hist + (f8 + j) * stride + cv[j];
        atomicAdd(cell, g);
        atomicAdd(cell + plane, h);
        atomicAdd(cell + 2 * plane, w);
      }
    }
  }
  __syncthreads();
  float* pb = part + static_cast<int64_t>(b) * 3 * F * B1;
  const int per = ft * B1;
  for (int j = threadIdx.x; j < 3 * per; j += blockDim.x) {
    const int p = j / per;
    const int rem = j - p * per;
    const int fl = rem / B1, bin = rem - fl * B1;
    pb[(static_cast<int64_t>(p) * F + f0 + fl) * B1 + bin] =
        s_hist[p * plane + fl * stride + bin];
  }
}

// The sources of hist cell i ([3, N, F, B1]): its node's blocks, at the
// cell's place in a block's [3][F][B1] partial.
struct GlobalSrc {
  int n_nodes;
  int64_t fb;  // F * B1
  __device__ __forceinline__ int operator()(int64_t i, int* g,
                                            int64_t* o) const {
    const int c = static_cast<int>(i / (n_nodes * fb));
    const int64_t rem = i - c * n_nodes * fb;
    const int j = static_cast<int>(rem / fb);
    g[0] = j;
    o[0] = c * fb + (rem - j * fb);
    return 1;
  }
};

// Global-atomics form: every (row, feature) of a row in [0, N) adds into
// acc [3, N, F, B1] float64 in L2.
template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
global_hist_atomic_kernel(const CodeT* __restrict__ codes,
                          const int* __restrict__ seg,
                          const float* __restrict__ ghw, int64_t rows, int F,
                          int n_nodes, int B1, int bf16,
                          double* __restrict__ acc) {
  const int64_t plane = static_cast<int64_t>(n_nodes) * F * B1;
  const int64_t n = rows * F;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    const int64_t r = i / F;
    const int f = static_cast<int>(i - r * F);
    const int ln = seg[r];
    if (static_cast<unsigned>(ln) >= static_cast<unsigned>(n_nodes)) continue;
    const int c = static_cast<int>(codes[i]);
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(B1)) continue;
    float g = ghw[r], h = ghw[rows + r], w = ghw[2 * rows + r];
    if (bf16) {
      g = h2o3::round_bf16(g);
      h = h2o3::round_bf16(h);
      w = h2o3::round_bf16(w);
    }
    double* o = acc + (static_cast<int64_t>(ln) * F + f) * B1 + c;
    atomicAdd(o, static_cast<double>(g));
    atomicAdd(o + plane, static_cast<double>(h));
    atomicAdd(o + 2 * plane, static_cast<double>(w));
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

inline unsigned grid_for(int64_t n, int per_sm) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * per_sm;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// form: kPick chooses from the shapes; kGrouped and kGlobal force one
// (kGrouped fails where it does not fit)
enum Form { kPick = -1, kGlobal = 0, kGrouped = 1 };

// How a launch runs: the form, and for the grouped one its feature slices,
// span, blocks and shared memory; bytes of workspace either way.
struct GlobalPlan {
  bool grouped;
  int fs, slices;
  int64_t span, nblk;
  size_t smem, bytes;
};

template <typename CodeT>
int plan(int64_t rows, int F, int n_nodes, int B1, int form, GlobalPlan* p) {
  const int stride = B1 | 1;  // odd: neighbouring cells on other banks
  const int64_t fs_max =
      h2o3::kHistBudget / (3 * static_cast<int64_t>(stride) * sizeof(float));
  const bool fits = fs_max >= 1 && n_nodes <= h2o3::kMaxGroups &&
                    rows < (int64_t{1} << 31);
  p->grouped = form == kPick ? fits : form == kGrouped;
  if (!p->grouped) {
    p->bytes = sizeof(double) * 3 * static_cast<size_t>(n_nodes) * F * B1;
    return 0;
  }
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  p->slices = static_cast<int>((F + fs_max - 1) / fs_max);
  p->fs = (F + p->slices - 1) / p->slices;
  p->smem = 3 * static_cast<size_t>(p->fs) * stride * sizeof(float);
  auto kern = global_hist_grouped_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // about four waves of blocks over the card when every row is added
  int64_t target = static_cast<int64_t>(h2o3::sm_count()) * per_sm * 4 /
                   p->slices;
  if (target < 1) target = 1;
  const int64_t span = (rows + target - 1) / target;
  p->span = span < kThreads ? kThreads : span;
  p->nblk = h2o3::span_blocks(rows, n_nodes, p->span);
  p->bytes = h2o3::grouping_bytes(rows, n_nodes) +
             h2o3::align256(sizeof(float) * 3 * static_cast<size_t>(F) * B1 *
                            p->nblk);
  return 0;
}

template <typename CodeT>
int launch(const void* codes_v, const int* seg, const float* ghw,
           int64_t rows, int F, int n_nodes, int B1, int bf16, int form,
           void* ws, float* hist, cudaStream_t stream) {
  const CodeT* codes = static_cast<const CodeT*>(codes_v);
  GlobalPlan p;
  int rc = plan<CodeT>(rows, F, n_nodes, B1, form, &p);
  if (rc != 0) return rc;
  const int64_t cells = 3 * static_cast<int64_t>(n_nodes) * F * B1;
  cudaError_t err;
  if (!p.grouped) {
    double* acc = static_cast<double*>(ws);
    err = cudaMemsetAsync(acc, 0, p.bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    global_hist_atomic_kernel<CodeT><<<grid_for(rows * F, 8), kThreads, 0,
                                       stream>>>(codes, seg, ghw, rows, F,
                                                 n_nodes, B1, bf16, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    add_acc_kernel<<<grid_for(cells, 8), kThreads, 0, stream>>>(acc, cells,
                                                                 hist);
    return static_cast<int>(cudaGetLastError());
  }
  h2o3::Grouping g;
  float* part = reinterpret_cast<float*>(
      h2o3::carve_grouping(static_cast<char*>(ws), rows, n_nodes, &g));
  rc = h2o3::launch_grouping(h2o3::SegKey{seg, n_nodes}, ghw, rows, n_nodes,
                             p.span, g, stream);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(p.nblk), static_cast<unsigned>(p.slices));
  global_hist_grouped_kernel<CodeT><<<grid, kThreads, p.smem, stream>>>(
      codes, g.rec, g.offsets, g.bstart, n_nodes, p.span, F, B1, B1 | 1,
      p.fs, bf16, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fb = static_cast<int64_t>(F) * B1;
  return h2o3::launch_merge(GlobalSrc{n_nodes, fb}, part, 3 * fb, g.bstart,
                            cells, hist, stream);
}

bool valid(int code_bytes, long long rows, int F, int n_nodes, int B1) {
  return (code_bytes == 1 || code_bytes == 4) && F >= 1 && n_nodes >= 1 &&
         B1 >= 1 && rows >= 0;
}

int launch_codes(const void* codes, int code_bytes, const int* seg,
                 const float* ghw, long long rows, int F, int n_nodes, int B1,
                 int bf16, int form, void* ws, float* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(code_bytes, rows, F, n_nodes, B1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return launch<uint8_t>(codes, seg, ghw, rows, F, n_nodes, B1, bf16, form,
                           ws, hist, s);
  return launch<int32_t>(codes, seg, ghw, rows, F, n_nodes, B1, bf16, form,
                         ws, hist, s);
}

}  // namespace

extern "C" {

// The workspace bytes of a launch at these shapes (form: -1 the one the
// shapes pick, 1 grouped, 0 global atomics); *grouped says which form
// runs. -1 where the shapes are refused.
long long h2o3_global_hist_workspace(int code_bytes, long long rows, int F,
                                     int n_nodes, int B1, int form,
                                     int* grouped) {
  if (!valid(code_bytes, rows, F, n_nodes, B1)) return -1;
  GlobalPlan p;
  const int rc = code_bytes == 1
                     ? plan<uint8_t>(rows, F, n_nodes, B1, form, &p)
                     : plan<int32_t>(rows, F, n_nodes, B1, form, &p);
  if (rc != 0) return -1;
  *grouped = p.grouped ? 1 : 0;
  return static_cast<long long>(p.bytes);
}

// codes [rows, F] uint8 (code_bytes 1) or int32 (code_bytes 4), row-major;
// seg [rows] int32; ghw [3, rows] float32; ws, h2o3_global_hist_workspace
// bytes (form -1). ADDS into hist [3, n_nodes, F, B1] float32, which the
// caller zeroes, in the form the shapes pick. Returns a cudaError_t value.
int h2o3_global_hist(const void* codes, int code_bytes, const int* seg,
                     const float* ghw, long long rows, int F, int n_nodes,
                     int B1, int bf16, void* ws, float* hist, void* stream) {
  return launch_codes(codes, code_bytes, seg, ghw, rows, F, n_nodes, B1,
                      bf16, kPick, ws, hist, stream);
}

// The same with one form forced (grouped 1: node-grouped, an error where
// it does not fit; 0: global atomics), for measurement and tests; ws as
// h2o3_global_hist_workspace gives for that form.
int h2o3_global_hist_form(const void* codes, int code_bytes, const int* seg,
                          const float* ghw, long long rows, int F,
                          int n_nodes, int B1, int bf16, int grouped,
                          void* ws, float* hist, void* stream) {
  return launch_codes(codes, code_bytes, seg, ghw, rows, F, n_nodes, B1,
                      bf16, grouped ? kGrouped : kGlobal, ws, hist, stream);
}

}  // extern "C"
