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
//   evened out over the slices: 7 of 28 at B1 = 1025), and gives each
//   feature of the slice to one warp, which adds 256 records at a time in
//   record order while the block's other warps stage the next 256 with
//   their rows' fs codes (one or two 32-byte sectors a row): the lanes of
//   a bin found through a tag a bin and five ballots, their masses summed
//   in lane order, one plain add a bin. No block reads a row outside its
//   node, no code is read twice and no float add depends on the schedule.
//   Each block writes its partial into its own slot of a scratch buffer; a
//   second pass sums each cell's slots in slot order, so no float chain
//   runs across blocks.
// - Global atomics (one (node, feature) cell past the shared budget, B1
//   above 8191, or more than kMaxGroups nodes: no training path at its
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
// index_add_; and then (the first grouped form) shared float atomics
// within a block, compare-and-swap loops whose order followed the warps'
// schedule: 1.83 ms. h2o3_global_hist_form forces one form (grouped 1, global
// atomics 0), for the tests and chip_smoke.py; the training path calls
// h2o3_global_hist.
//
// What bounds it on an H100: memory, on paper. It must read every row's
// seg and the codes and ghw of the rows it adds, rows * 4 + added *
// (F * itemsize + 12) bytes, and write 3 * N * F * B1 * 4; its
// 3 * added * F float adds are far below the 67 TFLOP/s f32 rate. In
// practice the grouped form is bound by the consumers' walk over the
// staged records (a shared load, a tag store and load and five ballots a
// 32 records and feature, the sums of a bin's lanes) and by the producers'
// loads of the records and their rows' codes. The global-atomics form
// adds float64 in L2 in the schedule's order; its one rounding to float32
// can still differ in the last bit between runs.

#include "level_common.cuh"

namespace {

using h2o3::kThreads;

// Records a chunk of the grouped form holds, and the warps of a block
// that add them (consumers); the others stage the next chunk (producers,
// at least kChunkRecs threads).
constexpr int kChunkRecs = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxConsumers = kWarps - kChunkRecs / 32;

// Node-grouped form: block (b, slice) adds the records of span b (of the
// node bstart assigns it) over features [slice * fs, + fs) into its
// shared partial, then writes the partial into part[b][3][F][B1]. The
// block's warps split into consumers (one a feature of the slice, at most
// kMaxConsumers; a warp takes features w, w + consumers, ...) and
// producers. Chunks of 256 records pass through two shared buffers: while
// the consumers add chunk c from one, the producers stage chunk c + 1 into
// the other (a record a thread: its masses, and its row's fs codes as
// uint16, 0xFFFF where out of range), one barrier a chunk. A consumer
// walks the chunk in record order, 32 at a time: the lanes whose codes
// fall in the same bin are found through a tag a bin in shared memory and
// five ballots, their masses summed in lane order by the lowest of them,
// which adds the sums into the bin with a plain add. No other warp
// touches the feature's bins, so every add comes in one fixed order.
template <typename CodeT>
__global__ void __launch_bounds__(kThreads, 2)
global_hist_grouped_kernel(const CodeT* __restrict__ codes,
                           const float4* __restrict__ rec,
                           const int* __restrict__ offsets,
                           const int* __restrict__ bstart, int G,
                           int64_t span, int F, int B1, int stride, int fs,
                           int bf16, float* __restrict__ part) {
  extern __shared__ float4 s_raw[];
  float* s_hist = reinterpret_cast<float*>(s_raw);  // [3][fs][stride]
  const int plane = fs * stride;
  // [2][kChunkRecs] masses (g, h, w, 0), [2][fs][kChunkRecs] codes, then
  // a consumer warp's lane tags, [consumers][B1] bytes
  float4* s_m = s_raw + (3 * plane + 3) / 4;
  uint16_t* s_c = reinterpret_cast<uint16_t*>(s_m + 2 * kChunkRecs);
  uint8_t* s_tag = reinterpret_cast<uint8_t*>(s_c + 2 * fs * kChunkRecs);
  // the slices of a span are neighbouring blocks, so that they read its
  // records and rows from L2 at about the same time
  const int b = blockIdx.y;
  if (b >= __ldg(bstart + G)) return;
  const int f0 = blockIdx.x * fs;
  const int ft = min(fs, F - f0);
  for (int i = threadIdx.x; i < 3 * plane; i += blockDim.x) s_hist[i] = 0.f;
  const int k = h2o3::span_group(bstart, G, b);
  const int64_t i0 = __ldg(offsets + k) +
                     static_cast<int64_t>(b - __ldg(bstart + k)) * span;
  const int64_t i1 =
      h2o3::imin64(__ldg(offsets + k + 1), i0 + span);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int consumers = ft < kMaxConsumers ? ft : kMaxConsumers;
  const bool consumer = warp < consumers;
  const int p = threadIdx.x - 32 * consumers;  // producer thread's record
  // (producers) record p of chunk c into buffer buf
  auto stage = [&](int64_t c, int buf) {
    if (p >= kChunkRecs) return;
    float g = 0.f, h = 0.f, w = 0.f;
    int row = -1;
    if (c + p < i1) {
      const float4 q = rec[c + p];
      row = __float_as_int(q.x);
      g = q.y;
      h = q.z;
      w = q.w;
      if (bf16) {
        g = h2o3::round_bf16(g);
        h = h2o3::round_bf16(h);
        w = h2o3::round_bf16(w);
      }
    }
    s_m[buf * kChunkRecs + p] = make_float4(g, h, w, 0.f);
    uint16_t* sc = s_c + buf * fs * kChunkRecs;
    const CodeT* rp = codes + static_cast<int64_t>(row < 0 ? 0 : row) * F + f0;
    for (int f8 = 0; f8 < ft; f8 += 8) {
      int cv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cv[j] = row >= 0 && f8 + j < ft ? static_cast<int>(rp[f8 + j]) : -1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (f8 + j < ft)
          sc[(f8 + j) * kChunkRecs + p] = static_cast<uint16_t>(
              static_cast<unsigned>(cv[j]) < static_cast<unsigned>(B1)
                  ? cv[j]
                  : 0xFFFF);
    }
  };
  // (consumers) the chunk in buffer buf into the warp's features. The
  // lanes of a bin: each lane writes its id into its bin's tag, and the
  // lanes that read back the same id (whichever lane's store landed) are
  // matched with one ballot a bit of the id; far less issue than
  // __match_any_sync, a slow instruction on Hopper. Only the membership
  // matters, and it does not depend on which store landed.
  uint8_t* tag = s_tag + warp * B1;
  auto consume = [&](int buf) {
    const float4* sm = s_m + buf * kChunkRecs;
    for (int fl = warp; fl < ft; fl += consumers) {
      const uint16_t* sc = s_c + (buf * fs + fl) * kChunkRecs;
      float* cell0 = s_hist + fl * stride;
      for (int j0 = 0; j0 < kChunkRecs; j0 += 32) {
        const int key = sc[j0 + lane];
        const bool live = key < B1;
        if (live) tag[key] = static_cast<uint8_t>(lane);
        __syncwarp();
        const int id = live ? tag[key] : lane;
        unsigned peers = 0xffffffffu;
#pragma unroll
        for (int bit = 0; bit < 5; ++bit) {
          const bool on = (id >> bit) & 1;
          const unsigned m = __ballot_sync(0xffffffffu, on);
          peers &= on ? m : ~m;
        }
        if (live && lane == __ffs(peers) - 1) {
          float sg = 0.f, sh = 0.f, sw = 0.f;
          for (unsigned m = peers; m != 0u; m &= m - 1u) {
            const float4 v = sm[j0 + __ffs(m) - 1];
            sg = __fadd_rn(sg, v.x);
            sh = __fadd_rn(sh, v.y);
            sw = __fadd_rn(sw, v.z);
          }
          float* cell = cell0 + key;
          cell[0] = __fadd_rn(cell[0], sg);
          cell[plane] = __fadd_rn(cell[plane], sh);
          cell[2 * plane] = __fadd_rn(cell[2 * plane], sw);
        }
      }
    }
  };
  if (!consumer) stage(i0, 0);
  __syncthreads();  // chunk 0 staged, the partial zeroed
  int buf = 0;
  for (int64_t c = i0; c < i1; c += kChunkRecs, buf ^= 1) {
    if (consumer)
      consume(buf);
    else if (c + kChunkRecs < i1)
      stage(c + kChunkRecs, buf ^ 1);
    __syncthreads();  // chunk c added, chunk c + 1 staged
  }
  float* pb = part + static_cast<int64_t>(b) * 3 * F * B1;
  const int per = ft * B1;
  for (int j = threadIdx.x; j < 3 * per; j += blockDim.x) {
    const int q = j / per;
    const int rem = j - q * per;
    const int fl = rem / B1, bin = rem - fl * B1;
    pb[(static_cast<int64_t>(q) * F + f0 + fl) * B1 + bin] =
        s_hist[q * plane + fl * stride + bin];
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
  // a feature of a block's slice: its three partial planes, its staged
  // uint16 codes, twice, and (at most) a consumer's tags
  const int64_t fs_max =
      h2o3::kHistBudget /
      (3 * static_cast<int64_t>(stride) * sizeof(float) +
       2 * kChunkRecs * sizeof(uint16_t) + B1);
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
  // the partial (to a float4), two chunks' staged masses and uint16 codes,
  // the consumers' tags
  const int consumers = p->fs < kMaxConsumers ? p->fs : kMaxConsumers;
  p->smem = (3 * static_cast<size_t>(p->fs) * stride + 3) / 4 * 16 +
            2 * kChunkRecs * (sizeof(float4) +
                              static_cast<size_t>(p->fs) * sizeof(uint16_t)) +
            static_cast<size_t>(consumers) * B1;
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
  if (p->nblk > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
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
  rc = h2o3::launch_grouping(h2o3::SegKey{seg, n_nodes},
                             h2o3::GhwRec{ghw, rows}, rows, n_nodes, p.span,
                             g, stream);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(p.slices), static_cast<unsigned>(p.nblk));
  global_hist_grouped_kernel<CodeT><<<grid, kThreads, p.smem, stream>>>(
      codes, static_cast<const float4*>(g.rec), g.offsets, g.bstart,
      n_nodes, p.span, F, B1, B1 | 1,
      p.fs, bf16, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fb = static_cast<int64_t>(F) * B1;
  return h2o3::launch_merge(GlobalSrc{n_nodes, fb}, part, 3 * fb, g.bstart,
                            cells, h2o3::MergeAdd{hist}, stream);
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
