// The column body: the float adaptive level in [F, rows] (K5,
// h2o3_tpu/ops/hist_adaptive.py:_kernel_t, the layout the JAX package's
// grower takes on the TPU), a fixed-order walk down the feature columns
// of x with the rows in row order. level_form (level_wide.cuh) picks it
// in [F, rows] wherever one feature's block fits shared memory; the
// tiled body (adaptive_bins.cuh) keeps the rest.
//
// Contract (adaptive_level_plain, ops/hist_adaptive.py): x float32
// [F, rows] (NaN = NA), nid int32 [rows], ghw float32 [3, rows], tables
// float32 [4, n_prev], lo and inv float32 [n_nodes, F]; writes nid_out
// [rows] and ADDS the level's (g, h, w) histogram into hist [3, n_nodes,
// F, W], which the caller zeroes.
//
// A block owns one span of consecutive rows and one slice of fs features,
// and keeps a float32 partial [3][fs][n_nodes x W | 1] in shared memory.
// Nothing is grouped by node: in [F, rows] a warp's 32 consecutive rows of
// one feature are one coalesced 128-byte load, where a row grouped by
// node would cost a 32-byte sector for each 4-byte value. As in the wide
// body (level_wide.cuh), producers and consumers pass chunks of 256 rows
// through two shared buffers:
//
// - Producers (256 threads, a row each) stage chunk c + 1 while the
//   consumers add chunk c: the row's route (the previous level's split
//   tables, one x value gathered from its parent's split feature; the
//   blocks of the first slice write nid_out), its masses (rounded to bf16
//   at bf16), fetched a chunk ahead, and for each feature of the slice
//   the key ln * W + bin, ln the row's node in the level's window and bin
//   the raw value re-binned under that node's (lo, inv) (adaptive_bin,
//   staged per block), or none where the row lies outside the window. The
//   slice's values of a row are fs loads of consecutive addresses across
//   the warp's rows.
// - Consumers, one warp per feature of the slice, walk the chunk in row
//   order, 32 rows at a time, by the walk of the wide body (walk_keys,
//   level_common.cuh): tags over the n_nodes x W keys and five ballots
//   find the lanes of a key, the lowest sums their masses in lane order
//   and adds them into the cell with a plain add.
//
// Each block writes its partial into its own slot [span][3][n_nodes][F]
// [W] of the workspace, and merge_slots_kernel (AllSlots, MergeAdd) adds
// the spans' slots in span order. No float atomics in the level: the same
// inputs give the same bits. Masses are added unrounded in float32 at
// float32, so a bin's sum is a float32 sum in another order than the plain
// version's, held within 1e-4 + 1e-5 x the bin's absolute mass of the
// float64 plain version.
//
// Feature slices: as many features as let two blocks share an SM (at 28
// features, N = 32: 7 a slice at W = 32, 3 at W = 64; one block an SM with
// 2 at W = 256); the slices of a span are neighbouring blocks: they read
// its rows (and the route's gathers) from L2 at about the same time.
//
// What bounds it: bytes, on paper: x read once, nid and the masses once a
// slice, nid_out and the spans' slots written once, the slots read once
// (chip_smoke.py adaptive_level_bound_ms, 0.3941 ms at 10M x 28, W = 32,
// N = 32, on the H100's 3.35 TB/s). In practice the consumers' walk, a
// dependent chain of shared-memory accesses per 32 rows and feature: the
// level is slowest at the root, where every lane's key is one of W bins
// and a key's lowest lane sums many lanes. Measured (chip_smoke.py phase
// 6, 10M x 28, bf16, device time, NVIDIA H100 80GB HBM3 at 700.00 W), the
// column body against the tiled body on the same inputs: W = 32, N = 1,
// 2, 4, 8, 16, 32: 2.979 / 2.533, 2.798 / 2.661, 2.532 / 2.382, 2.493 /
// 2.915, 2.459 / 3.729, 2.581 / 3.873 ms; at N = 32, W = 64 4.836 / 7.118,
// W = 128 11.82 / 9.231, W = 256 10.60 / 12.75 ms. A bernoulli tree's six
// levels and route at W = 32 (phase_f_rows_grower, one [rows, F] tree's
// inputs replayed): 17.92 ms in [F, rows] against 14.68 in [rows, F] and
// 21.36 with the tiled body; at W = 64 17.64 against 17.43 and 22.14.
#pragma once

#include "adaptive_bins.cuh"
#include "level_wide.cuh"

namespace h2o3 {

// Block (slice, span): rows [span * blockIdx.y, + span), features
// [slice * fs, + fs); writes its partial into part[blockIdx.y][3][n_nodes]
// [F][W]. n_prev 0: no route (nid is the level's).
template <int W>
__global__ void __launch_bounds__(kWideThreads, 2)
level_column_kernel(const float* __restrict__ x, const int* __restrict__ nid,
                    const float* __restrict__ ghw,
                    const float* __restrict__ tables,
                    const float* __restrict__ lo,
                    const float* __restrict__ inv, int64_t rows,
                    int64_t span, int F, int fs, int n_prev, int n_nodes,
                    int level_base, int bf16, int* __restrict__ nid_out,
                    float* __restrict__ part) {
  using Mass = WideFloat;
  constexpr int P = Mass::kPlanes;
  const int nkeys = n_nodes * W;
  const int stride = nkeys + 1;  // odd: neighbouring cells on other banks
  const int plane = fs * stride;
  extern __shared__ float4 s_raw[];
  float* s_hist = reinterpret_cast<float*>(s_raw);  // [P][fs][stride]
  float4* s_m = s_raw + (P * plane + 3) / 4;        // [2][recs]
  float* s_lo = reinterpret_cast<float*>(s_m + 2 * kWideRecs);  // [N][fs]
  float* s_inv = s_lo + n_nodes * fs;                           // [N][fs]
  uint16_t* s_k = reinterpret_cast<uint16_t*>(s_inv + n_nodes * fs);
  uint8_t* s_tag = reinterpret_cast<uint8_t*>(s_k + 2 * fs * kWideRecs);
  const int f0 = blockIdx.x * fs;
  const int ft = min(fs, F - f0);
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * span;
  const int64_t i1 = imin64(rows, i0 + span);
  for (int i = threadIdx.x; i < P * plane; i += blockDim.x) s_hist[i] = 0.f;
  for (int i = threadIdx.x; i < n_nodes * fs; i += blockDim.x) {
    const int ln = i / fs, fl = i - ln * fs;
    const int64_t o = static_cast<int64_t>(ln) * F + f0 + fl;
    s_lo[i] = fl < ft ? lo[o] : 0.f;
    s_inv[i] = fl < ft ? inv[o] : 0.f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int consumers = ft < kWideConsumers ? ft : kWideConsumers;
  const bool consumer = warp < consumers;
  const int p = threadIdx.x - 32 * consumers;  // producer thread's row
  const int prev_base = level_base - n_prev;

  // (producers) row p of chunk c: {nid bits, g, h, w}, fetched a chunk
  // before it is staged
  auto fetch = [&](int64_t c) {
    const int64_t r = c + p;
    if (p >= kWideRecs || r >= i1) return make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(__int_as_float(__ldg(nid + r)), __ldg(ghw + r),
                       __ldg(ghw + rows + r), __ldg(ghw + 2 * rows + r));
  };
  // (producers) row p of chunk c, q, into buffer buf
  auto stage = [&](int64_t c, int buf, const float4& q) {
    if (p >= kWideRecs) return;
    const int64_t r = c + p;
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    int ln = -1;
    if (r < i1) {
      int id = __float_as_int(q.x);
      if (n_prev > 0)
        id = route_row<true>(x, r, rows, F, id, tables, n_prev, prev_base);
      if (blockIdx.x == 0) nid_out[r] = id;
      const int l = id - level_base;
      if (l >= 0 && l < n_nodes) {
        ln = l;
        m = Mass::stage(q, bf16);
      }
    }
    s_m[buf * kWideRecs + p] = m;
    uint16_t* sk = s_k + buf * fs * kWideRecs + p;
    if (ln < 0) {
      for (int fl = 0; fl < ft; ++fl) sk[fl * kWideRecs] = kNoKey;
      return;
    }
    // the slice's values of row r, eight loads in flight (each a
    // coalesced run of the warp's 32 rows), then their bins
    const float* xr = x + static_cast<int64_t>(f0) * rows + r;
    const float* rlo = s_lo + ln * fs;
    const float* rinv = s_inv + ln * fs;
    const int kb = ln * W;
    for (int fl0 = 0; fl0 < ft; fl0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = fl0 + u < ft
                   ? __ldg(xr + static_cast<int64_t>(fl0 + u) * rows)
                   : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (fl0 + u < ft)
          sk[(fl0 + u) * kWideRecs] = static_cast<uint16_t>(
              kb + adaptive_bin<W>(v[u], rlo[fl0 + u], rinv[fl0 + u]));
    }
  };
  // (consumers) the chunk in buffer buf into the warp's features
  uint8_t* tag = s_tag + warp * nkeys;
  auto walk = [&](int buf) {
    const float4* sm = s_m + buf * kWideRecs;
    for (int fl = warp; fl < ft; fl += consumers)
      walk_keys<Mass>(s_k + (buf * fs + fl) * kWideRecs, sm, kWideRecs,
                      nkeys, tag, s_hist + fl * stride, plane, lane);
  };
  __syncthreads();  // the ranges staged, the partial zeroed
  float4 qn = make_float4(0.f, 0.f, 0.f, 0.f);  // a producer's next row
  if (!consumer) {
    const float4 q = fetch(i0);
    qn = fetch(i0 + kWideRecs);
    stage(i0, 0, q);
  }
  __syncthreads();  // chunk 0 staged
  int buf = 0;
  for (int64_t c = i0; c < i1; c += kWideRecs, buf ^= 1) {
    if (consumer) {
      walk(buf);
    } else if (c + kWideRecs < i1) {
      const float4 q = qn;
      qn = fetch(c + 2 * kWideRecs);
      stage(c + kWideRecs, buf ^ 1, q);
    }
    __syncthreads();  // chunk c added, chunk c + 1 staged
  }
  // the partial into the span's slot, the slice's features; consecutive
  // threads on consecutive lanes
  float* pb = part + static_cast<int64_t>(blockIdx.y) * P * nkeys * F;
  const int per = nkeys * ft;
  for (int j = threadIdx.x; j < P * per; j += blockDim.x) {
    const int bin = j % W;
    int t = j / W;
    const int fl = t % ft;
    t /= ft;
    const int n = t % n_nodes, c = t / n_nodes;
    pb[(static_cast<int64_t>(c * n_nodes + n) * F + f0 + fl) * W + bin] =
        s_hist[c * plane + fl * stride + n * W + bin];
  }
}

// How the column body runs at these shapes: features a slice, slices,
// the span of rows a block owns, the spans, shared memory and workspace
// bytes (the spans' slots).
struct ColumnPlan {
  int fs, slices;
  int64_t span, spans;
  size_t smem, bytes;
};

// As many features a slice as let two blocks share an SM; where one
// feature does not, as many as fit one block an SM. The slices even.
template <int W>
int plan_column(int64_t rows, int F, int n_nodes, ColumnPlan* p) {
  if (!column_fits(F, W, n_nodes) || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int most = 0;
  while (most < F && column_smem(most + 1, W, n_nodes) <= kWideTwoPerSm)
    ++most;
  if (most == 0)
    while (most < F && column_smem(most + 1, W, n_nodes) <= kMaxBlockSmem)
      ++most;
  p->slices = (F + most - 1) / most;
  p->fs = (F + p->slices - 1) / p->slices;
  p->smem = column_smem(p->fs, W, n_nodes);
  auto kern = level_column_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kWideThreads, p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // about four waves of blocks over the card
  int64_t target = static_cast<int64_t>(sm_count()) * per_sm * 4 / p->slices;
  if (target < 1) target = 1;
  int64_t span = (rows + target - 1) / target;
  span = (span + kWideRecs - 1) / kWideRecs * kWideRecs;
  p->span = span < kWideRecs ? kWideRecs : span;
  p->spans = (rows + p->span - 1) / p->span;
  if (p->spans > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  p->bytes = align256(sizeof(float) * 3 * static_cast<size_t>(n_nodes) * F *
                      W * (p->spans > 0 ? p->spans : 1));
  return 0;
}

// The column level: the blocks, then the merge of their slots into hist
// (MergeAdd: ADDS). ws holds plan_column's bytes; plan_only: those bytes
// alone, into *bytes.
template <int W>
int launch_column(bool plan_only, size_t* bytes, const float* x,
                  const int* nid, const float* ghw, const float* tables,
                  const float* lo, const float* inv, int64_t rows, int F,
                  int n_prev, int n_nodes, int level_base, int bf16,
                  int* nid_out, float* hist, void* ws, cudaStream_t stream) {
  ColumnPlan p;
  const int rc = plan_column<W>(rows, F, n_nodes, &p);
  if (plan_only) {
    *bytes = rc == 0 ? p.bytes : 0;
    return rc;
  }
  if (rc != 0) return rc;
  if (p.spans == 0) return 0;
  float* part = static_cast<float*>(ws);
  dim3 grid(static_cast<unsigned>(p.slices), static_cast<unsigned>(p.spans));
  level_column_kernel<W><<<grid, kWideThreads, p.smem, stream>>>(
      x, nid, ghw, tables, lo, inv, rows, p.span, F, p.fs, n_prev, n_nodes,
      level_base, bf16, nid_out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = 3 * static_cast<int64_t>(n_nodes) * F * W;
  return launch_merge(AllSlots{static_cast<int>(p.spans)}, part, n, nullptr,
                      n, MergeAdd{hist}, stream);
}

}  // namespace h2o3
