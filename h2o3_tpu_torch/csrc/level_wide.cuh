// The wide node-grouped level: the float packed level (K1, CodeBins) and
// the float [rows, F] adaptive level (K8, AdaptiveBins) at the wide lane
// widths (W = 64, 128, 256; hist_binned.cu and hist_adaptive.cu pick it
// per level), as a fixed-order scatter into shared memory over rows
// grouped by parent; and their int8 levels (K4, K7) with integer masses
// (below). It is global_hist_grouped_kernel's design (K11,
// hist_global.cu) with the route fused into it.
//
// The grouping pass of level_common.cuh (ParentKey of level_grouped.cuh)
// writes one 16-byte record {row id, g, h, w} per row of the level, the
// rows of each parent in ascending row order. A block owns one span of
// one group's records and one slice of fs features, and keeps a float32
// partial [3][fs][2 children x W lanes | 1] in shared memory. Its warps
// split into producers and consumers, and chunks of 256 records pass
// through two shared buffers:
//
// - Producers (256 threads, a record each) stage chunk c + 1 while the
//   consumers add chunk c: the record's masses (rounded to bf16 at bf16),
//   its route (the value of the parent's split feature against the split;
//   the block of the first slice writes nid_out), and for each feature of
//   the slice the key child * W + bin of the (child, bin) cell it adds
//   into (AdaptiveBins re-bins the raw value under the child's (lo, inv),
//   CodeBins takes the code), or none: a child outside the level's window
//   or a bin outside [0, W). A producer fetches its record a chunk ahead,
//   and reads its row's slice in aligned 16-byte (float32) or 4-byte
//   (codes) loads.
// - Consumers, one warp per feature of the slice (a warp takes features
//   w, w + consumers, ...), walk the chunk in record order, 32 records at
//   a time. The lanes whose records share a key are found through a tag
//   per key in shared memory and five ballots (as K11); the lowest of
//   them sums their masses in lane order and adds the sums into the cell
//   with a plain add. No other warp touches the feature's cells, so every
//   add comes in one fixed order.
//
// Each block writes its partial into its own slot of a scratch buffer and
// merge_slots_kernel (MergeAdd) adds the slots in slot order, as the
// tensor-core body's merge does (GroupedSrc). No float atomics in the
// level: the same inputs give the same bits. Masses are added unrounded
// in float32 at float32 (no three-term split), so a bin's sum is a
// float32 sum in another order than the plain version's: held within
// 1e-4 + 1e-5 x the bin's absolute mass of the float64 plain version.
// Both children's sums come from their rows (no sibling subtraction).
//
// Why a scatter at the wide widths: the tensor-core body (level_grouped.
// cuh) makes a one-hot operand per 16 lanes of every feature, so its work
// grows with W (7 passes over the records at W = 256, F = 28, each
// re-staging every row); here the work is per (record, feature) whatever
// W, and W only sets the partial's size. Feature slices: as many features
// as let two blocks share an SM (fs = 14 at W = 256 and 128, all 28 at
// W = 64). One slice of all 28 features at one block an SM was measured
// against it on an H100 (chip_smoke.py, PERF.md): equal at W = 64, where
// it is the same plan, and 30-45% slower a tree at W = 128 and 256 (half
// the consumer warps in flight).
//
// What bounds it: memory, on paper (the records and the values of their
// rows read once a slice, the partial slots written and merged). In
// practice (the phase knock-outs of chip_smoke.py phase 9 on an H100,
// PERF.md): the consumers' walk (per 32 records and feature a key load, a
// tag store and load, five ballots, the masses and three cell loads and
// stores at random lanes: a dependent chain of shared-memory accesses),
// 28-33% of a level at 32 nodes and over half at 2; the bins 13-31%; the
// producers' gathers of scattered rows only 6-12% at 32 nodes. Matching
// by ballots on the key bits alone, or __match_any_sync, was slower than
// the tags; shared float atomics in place of the walk were 44-59% slower.
//
// The int8 instance (mass policy I8Mass<terms>, level_grouped.cuh): the
// int8 levels K4 (binned_level_i8, CodeBins) and K7 ([rows, F]
// adaptive_level_i8, AdaptiveBins) at W = 64, 128, 256, on
// quantize_ghw_i8's q (one or two terms). The grouping pass writes QRec
// records ({row id, q bytes}: 8 bytes at one term, 16 at two); producers
// stage a record's q words in place of the float4 of masses, with the
// same route, nid_out and keys; the partial is int32, [3 * terms][fs][2W
// + 1] (two terms take twice the float partial: about 7 features a slice
// at W = 256). Integer sums come out the same in any order, so there is
// no walk: the consumers are 256 threads, a record each, and each adds
// its record's 3 * terms masses (bytes sign-extended one by one) into its
// cells of every feature of the slice with shared integer atomics, native
// ATOMS.ADD on Hopper (no CAS loop). The blocks write int32 slots
// [b][3 * terms][2][F][W] and merge_slots_kernel with MergeFlushI8 sums
// them and writes the float32 histogram in one pass (no flush kernel, no
// zeroed sums): bit-equal to the plain version and to the TPU kernels. Its
// int32 bound is the grouped int8 body's: |q| <= 128 over at most 16M rows.
// Measured on an H100 (chip_smoke.py, PERF.md): this scatter took 40-78%
// of the time of the float instance's walk with int32 sums at every level
// (W = 64-256, one and two terms), and starting each thread's feature
// loop at its own feature (against hot cells) changed nothing.
#pragma once

#include <type_traits>

#include "level_grouped.cuh"

namespace h2o3 {

constexpr int kWideThreads = 512;
constexpr int kWideRecs = 256;  // records a chunk
constexpr int kWideWarps = kWideThreads / 32;
// consumer warps at most; the others (at least kWideRecs threads) stage
constexpr int kWideConsumers = kWideWarps - kWideRecs / 32;
constexpr uint16_t kNoKey = 0xFFFF;
// shared memory of a block when two share an SM: the SM's 228 KB less 1
// KB reserved per block, halved
constexpr size_t kWideTwoPerSm = (233472 - 2 * 1024) / 2;

// The float mass of the wide body: {row id, g, h, w} records (GhwRec),
// the masses staged as a float4 (rounded to bf16 at bf16), three float32
// planes added in record order. The int8 mass is I8Mass<kTerms>
// (level_grouped.cuh): QRec records, the q words staged, 3 * kTerms int32
// planes.
struct WideFloat {
  static constexpr bool kInt = false;
  static constexpr int kPlanes = 3;
  using Rec = GhwRec;
  using Stage = float4;
  using Part = float;
  static __device__ __forceinline__ int row(const float4& q) {
    return __float_as_int(q.x);
  }
  static __device__ __forceinline__ float4 stage(const float4& q, int bf16) {
    float g = q.y, h = q.z, w = q.w;
    if (bf16) {
      g = round_bf16(g);
      h = round_bf16(h);
      w = round_bf16(w);
    }
    return make_float4(g, h, w, 0.f);
  }
  static __device__ __forceinline__ float mass(const float4& m, int p) {
    return p == 0 ? m.x : (p == 1 ? m.y : m.z);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

// Shared bytes of a block of fs features at lane width W: the partial
// (planes of 4-byte sums, to a float4), two chunks' staged masses
// (stage_bytes a record), the children's ranges (AdaptiveBins), two
// chunks' keys, and the consumers' tags where they walk (the float mass).
inline size_t wide_smem(int fs, int W, bool ranges, int planes,
                        size_t stage_bytes, bool walk) {
  const size_t stride = 2 * static_cast<size_t>(W) + 1;
  const int consumers = fs < kWideConsumers ? fs : kWideConsumers;
  return (planes * static_cast<size_t>(fs) * stride + 3) / 4 * 16 +
         2 * kWideRecs * stage_bytes +
         (ranges ? 4 * sizeof(float) * static_cast<size_t>(fs) : 0) +
         2 * static_cast<size_t>(fs) * kWideRecs * sizeof(uint16_t) +
         (walk ? static_cast<size_t>(consumers) * 2 * W : 0);
}

// Shared bytes of a block of the column body (level_column.cuh) of fs
// features at lane width W and n_nodes nodes: the partial (three float
// planes of fs x (n_nodes x W + 1) sums, to a float4), two chunks' staged
// masses, the nodes' ranges, two chunks' keys and the consumers' tags
// (n_nodes x W bytes a consumer warp).
inline size_t column_smem(int fs, int W, int n_nodes) {
  const size_t keys = static_cast<size_t>(n_nodes) * W;
  const int consumers = fs < kWideConsumers ? fs : kWideConsumers;
  return (3 * static_cast<size_t>(fs) * (keys + 1) + 3) / 4 * 16 +
         2 * kWideRecs * sizeof(float4) +
         2 * sizeof(float) * static_cast<size_t>(n_nodes) * fs +
         2 * static_cast<size_t>(fs) * kWideRecs * sizeof(uint16_t) +
         static_cast<size_t>(consumers) * keys;
}

// Whether the column body takes a level: one feature's block fits the
// shared memory of a block, and every key n * W + bin lies below kNoKey.
inline bool column_fits(int F, int W, int n_nodes) {
  return F >= 1 && n_nodes >= 1 &&
         static_cast<int64_t>(n_nodes) * W < kNoKey &&
         column_smem(1, W, n_nodes) <= kMaxBlockSmem;
}

// log2 of a power of two
__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// The value of byte q of a 32-bit word w as a bin source's value: a
// signed code of kBytes 1 or 2, or a float32.
template <class Src>
__device__ __forceinline__ typename Src::Val word_value(uint32_t w, int q) {
  if constexpr (Src::kBytes == 4) {
    static_assert(std::is_same<typename Src::Val, float>::value,
                  "four-byte values are float32");
    return __uint_as_float(w);
  } else if constexpr (Src::kBytes == 2) {
    return static_cast<int>(static_cast<int16_t>(w >> (8 * q)));
  } else {
    return static_cast<int>(static_cast<int8_t>(w >> (8 * q)));
  }
}

// The bits of a staged mass, folded (the knock-outs' sink, level_common.cuh).
__device__ __forceinline__ unsigned stage_bits(const float4& m) {
  return __float_as_uint(m.x) ^ __float_as_uint(m.y) ^ __float_as_uint(m.z);
}
__device__ __forceinline__ unsigned stage_bits(unsigned m) { return m; }
__device__ __forceinline__ unsigned stage_bits(const uint2& m) {
  return m.x ^ m.y;
}

// Block (slice, b): span b of the group bstart assigns it, features
// [slice * fs, + fs); writes its partial into part[b][planes][2][F][W].
// kA: a phase knock-out (level_common.cuh), kNone in production.
template <class Src, class Mass, Ablate kA = Ablate::kNone>
__global__ void __launch_bounds__(kWideThreads, 2)
level_wide_kernel(Src src, const typename Mass::Rec::T* __restrict__ rec,
                  const int* __restrict__ offsets,
                  const int* __restrict__ bstart, int G, int64_t span, int F,
                  int fs, int n_prev, int n_nodes, int level_base, int bf16,
                  int* __restrict__ nid_out,
                  typename Mass::Part* __restrict__ part) {
  constexpr int W = Src::kW;
  constexpr int kKeys = 2 * W;
  constexpr int stride = kKeys + 1;  // odd: neighbouring cells on other banks
  constexpr int P = Mass::kPlanes;
  // the float mass walks its records in a fixed order; integer sums come
  // out the same in any order (and the kWalk knock-out adds floats so)
  constexpr bool kWalk = !Mass::kInt && kA != Ablate::kWalk;
  using Val = typename Src::Val;
  using Acc = typename Mass::Part;
  using Stage = typename Mass::Stage;
  using RecT = typename Mass::Rec::T;
  extern __shared__ float4 s_raw[];
  Acc* s_hist = reinterpret_cast<Acc*>(s_raw);  // [P][fs][stride]
  const int plane = fs * stride;
  Stage* s_m = reinterpret_cast<Stage*>(s_raw + (P * plane + 3) / 4);
  float* s_lo = reinterpret_cast<float*>(s_m + 2 * kWideRecs);  // [2][fs]
  float* s_inv = s_lo + (Src::kRanges ? 2 * fs : 0);            // [2][fs]
  uint16_t* s_k = reinterpret_cast<uint16_t*>(
      s_inv + (Src::kRanges ? 2 * fs : 0));                     // [2][fs][recs]
  uint8_t* s_tag = reinterpret_cast<uint8_t*>(s_k + 2 * fs * kWideRecs);
  // the slices of a span are neighbouring blocks: they read its records
  // and rows from L2 at about the same time
  const int b = blockIdx.y;
  if (b >= __ldg(bstart + G)) return;
  const int f0 = blockIdx.x * fs;
  const int ft = min(fs, F - f0);
  for (int i = threadIdx.x; i < P * plane; i += blockDim.x) s_hist[i] = Acc(0);
  const int k = span_group(bstart, G, b);
  const int64_t i0 = __ldg(offsets + k) +
                     static_cast<int64_t>(b - __ldg(bstart + k)) * span;
  const int64_t i1 = imin64(__ldg(offsets + k + 1), i0 + span);
  const bool parent = k < n_prev;
  const int pid = level_base - n_prev + k;  // the parent's node id
  // level-local node of slot 0: the left child, or the node itself
  const int c0 = parent ? 2 * pid + 1 - level_base : k - n_prev;
  if constexpr (Src::kRanges) {
    for (int i = threadIdx.x; i < 2 * fs; i += blockDim.x) {
      const int s = i / fs, fl = i - s * fs;
      const int node = c0 + s;
      const bool ok = (parent || s == 0) && node >= 0 && node < n_nodes &&
                      fl < ft;
      const int64_t o = static_cast<int64_t>(ok ? node : 0) * F +
                        (ok ? f0 + fl : 0);
      s_lo[i] = ok ? src.lo[o] : 0.f;
      s_inv[i] = ok ? src.inv[o] : 0.f;
    }
  }
  int feat = 0, na_right = 0;
  Val thr = Val(0);
  if (parent) src.split(k, n_prev, F, &feat, &thr, &na_right);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // consumer warps: a warp a feature where they walk, else a thread a
  // record of the chunk
  const int consumers =
      !kWalk ? kWideRecs / 32 : (ft < kWideConsumers ? ft : kWideConsumers);
  const bool consumer = warp < consumers;
  const int p = threadIdx.x - 32 * consumers;  // producer thread's record

  // (producers) the record of row p of chunk c, fetched a chunk before
  // it is staged
  auto fetch = [&](int64_t c) {
    return p >= 0 && p < kWideRecs && c + p < i1 ? rec[c + p]
                                                 : Mass::Rec::zero();
  };
  // (producers) record p of chunk c, q, into buffer buf
  auto stage = [&](int64_t c, int buf, const RecT& q) {
    if (p >= kWideRecs) return;
    Stage m{};
    int row = 0, slot = -1;
    if (c + p < i1) {
      row = Mass::row(q);
      // the row whose values the producer reads
      const int vrow = kA == Ablate::kGather ? p : row;
      int side = 0;
      if (parent) {
        if constexpr (kA != Ablate::kRoute)
          side = src.right(src.load(vrow, feat, F), thr, na_right);
        if (blockIdx.x == 0) nid_out[row] = 2 * pid + 1 + side;
      }
      if constexpr (kA == Ablate::kGather) row = vrow;
      slot = c0 + side >= 0 && c0 + side < n_nodes ? side : -1;
      m = Mass::stage(q, bf16);
    }
    s_m[buf * kWideRecs + p] = m;
    uint16_t* sk = s_k + buf * fs * kWideRecs;
    if (slot < 0) {
      for (int fl = 0; fl < ft; ++fl) sk[fl * kWideRecs + p] = kNoKey;
      return;
    }
    if constexpr (kA == Ablate::kBins) {
      for (int fl = 0; fl < ft; ++fl)
        sk[fl * kWideRecs + p] =
            static_cast<uint16_t>(slot * W + ablate_bin(row, f0 + fl, W));
      return;
    }
    // the row's slice in aligned loads, 16 bytes for float32 values and 4
    // for codes (measured: 16-byte loads of codes were slower at the
    // shallow levels). A warp's load instruction touches a line per lane
    // (its own row), so fewer and wider loads (4 in place of 14 for 14
    // float32 values, 7 or 8 in place of 14 or 28 for 28 bytes of codes).
    // The window starts at most U - 1 bytes before the slice and ends at
    // most U - 1 after it: element alignment holds the value boundaries
    // to the words, and the bytes read past the tensor lie in its
    // allocation (whole 512-byte blocks).
    constexpr int B = Src::kBytes;
    constexpr int kLogB = ilog2(B);
    constexpr int U = B == 4 ? 16 : 4;      // bytes a load
    constexpr int kLoads = U == 16 ? 2 : 4;  // loads a group of words
    constexpr int kWords = kLoads * U / 4;   // words a group
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(src.rows()) +
                         (static_cast<uint64_t>(row) * F + f0) * B;
    const int shift = static_cast<int>(a0 & (U - 1));
    const uintptr_t w0 = a0 - shift;
    const int nbytes = ft * B;
    const int nl = (shift + nbytes + U - 1) / U;  // loads of the window
    for (int l0 = 0; l0 < nl; l0 += kLoads) {
      uint32_t wv[kWords];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if constexpr (U == 16) {
          const uint4 x =
              l0 + u < nl
                  ? __ldg(reinterpret_cast<const uint4*>(w0) + l0 + u)
                  : make_uint4(0u, 0u, 0u, 0u);
          wv[4 * u] = x.x;
          wv[4 * u + 1] = x.y;
          wv[4 * u + 2] = x.z;
          wv[4 * u + 3] = x.w;
        } else {
          wv[u] = l0 + u < nl
                      ? __ldg(reinterpret_cast<const uint32_t*>(w0) + l0 + u)
                      : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
#pragma unroll
        for (int q = 0; q < 4; q += B) {
          const int fb = U * l0 + 4 * j + q - shift;  // byte in the slice
          if (fb < 0 || fb >= nbytes) continue;
          const int fl = fb >> kLogB;
          float lo = 0.f, inv = 0.f;
          if constexpr (Src::kRanges && kA == Ablate::kRanges) {
            lo = -4.f;
            inv = (W - 2) / 8.f;
          } else if constexpr (Src::kRanges) {
            lo = s_lo[slot * fs + fl];
            inv = s_inv[slot * fs + fl];
          }
          const int bin = src.bin(word_value<Src>(wv[j], q), lo, inv);
          sk[fl * kWideRecs + p] =
              static_cast<unsigned>(bin) < static_cast<unsigned>(W)
                  ? static_cast<uint16_t>(slot * W + bin)
                  : kNoKey;
        }
      }
    }
  };
  // (consumers, kWalk) the chunk in buffer buf into the warp's features,
  // each by the keyed fixed-order walk (walk_keys, level_common.cuh)
  uint8_t* tag = s_tag + warp * kKeys;
  auto walk = [&](int buf) {
    const Stage* sm = s_m + buf * kWideRecs;
    for (int fl = warp; fl < ft; fl += consumers)
      walk_keys<Mass>(s_k + (buf * fs + fl) * kWideRecs, sm, kWideRecs,
                      kKeys, tag, s_hist + fl * stride, plane, lane);
  };
  // (consumers, integer masses) thread j of the chunk in buffer buf adds
  // record j's masses into its cell of every feature of the slice with
  // shared integer atomics (native ATOMS.ADD): integer sums come out the
  // same in any order, so no warp owns a feature and none walks
  auto scatter = [&](int buf) {
    if constexpr (!kWalk) {
      const int j = threadIdx.x;
      const Stage v = s_m[buf * kWideRecs + j];
      Acc m[P];
#pragma unroll
      for (int c = 0; c < P; ++c) m[c] = Mass::mass(v, c);
      const uint16_t* sk = s_k + buf * fs * kWideRecs + j;
      for (int fl = 0; fl < ft; ++fl) {
        const int key = sk[fl * kWideRecs];
        if (key >= kKeys) continue;
        Acc* cell = s_hist + fl * stride + key;
#pragma unroll
        for (int c = 0; c < P; ++c)
          if (m[c] != 0) atomicAdd(cell + c * plane, m[c]);
      }
    }
  };
  // (consumers, kAdds) the keys and masses the adds would read, folded
  unsigned fold = 0u;
  auto fold_chunk = [&](int buf) {
    for (int j = threadIdx.x; j < kWideRecs; j += 32 * consumers) {
      unsigned v = stage_bits(s_m[buf * kWideRecs + j]);
      const uint16_t* sk = s_k + buf * fs * kWideRecs + j;
      for (int fl = 0; fl < ft; ++fl) v ^= sk[fl * kWideRecs];
      fold ^= v;
    }
  };
  __syncthreads();  // the ranges staged
  RecT qn = Mass::Rec::zero();  // a producer's next record
  if (!consumer) {
    const RecT q = fetch(i0);
    qn = fetch(i0 + kWideRecs);
    stage(i0, 0, q);
  }
  __syncthreads();  // chunk 0 staged, the partial zeroed
  int buf = 0;
  for (int64_t c = i0; c < i1; c += kWideRecs, buf ^= 1) {
    if (consumer) {
      if constexpr (kA == Ablate::kAdds)
        fold_chunk(buf);
      else if constexpr (kWalk)
        walk(buf);
      else
        scatter(buf);
    } else if (c + kWideRecs < i1) {
      const RecT q = qn;
      qn = fetch(c + 2 * kWideRecs);
      stage(c + kWideRecs, buf ^ 1, q);
    }
    __syncthreads();  // chunk c added, chunk c + 1 staged
  }
  if constexpr (kA == Ablate::kAdds) sink_fold(fold);
  // the partial into the block's slot, part[b][P][2][F][W], the slice's
  // features; consecutive threads on consecutive lanes
  Acc* pb = part + static_cast<int64_t>(b) * 2 * P * F * W;
  const int per = 2 * ft * W;
  for (int j = threadIdx.x; j < P * per; j += blockDim.x) {
    const int bin = j % W;
    const int t = j / W;
    const int fl = t % ft;
    const int cs = t / ft;  // plane * 2 + child
    const int c = cs >> 1, s = cs & 1;
    pb[(static_cast<int64_t>(cs) * F + f0 + fl) * W + bin] =
        s_hist[c * plane + fl * stride + s * W + bin];
  }
}

// How the wide level runs at these shapes: groups, feature slices, the
// span of records a block owns, the blocks, shared memory and workspace
// bytes.
struct WidePlan {
  int G, fs, slices;
  int64_t span, nblk;
  size_t smem, bytes;
};

// As many features a slice as let two blocks share an SM. A knock-out (kA)
// takes the production instance's plan.
template <class Src, class Mass, Ablate kA = Ablate::kNone>
int plan_wide(int64_t rows, int F, int n_prev, int n_nodes, WidePlan* p) {
  constexpr int W = Src::kW;
  constexpr int P = Mass::kPlanes;
  constexpr size_t kStage = sizeof(typename Mass::Stage);
  constexpr bool kWalk = !Mass::kInt;  // tags for the walk
  p->G = n_prev + n_nodes;
  if (!grouped_fits(rows, F, n_prev, n_nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  int slices = 1;
  while (slices < F &&
         wide_smem((F + slices - 1) / slices, W, Src::kRanges, P, kStage,
                   kWalk) > kWideTwoPerSm)
    ++slices;
  p->fs = (F + slices - 1) / slices;
  p->slices = (F + p->fs - 1) / p->fs;
  p->smem = wide_smem(p->fs, W, Src::kRanges, P, kStage, kWalk);
  if (p->smem > kMaxBlockSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = level_wide_kernel<Src, Mass>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // all of the SM's shared memory (L1 keeps the rest): two blocks fit
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kA != Ablate::kNone) {
    auto ko = level_wide_kernel<Src, Mass, kA>;
    err = cudaFuncSetAttribute(ko, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p->smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        ko, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kWideThreads, p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // about four waves of blocks over the card when every row is added
  int64_t target = static_cast<int64_t>(sm_count()) * per_sm * 4 / p->slices;
  if (target < 1) target = 1;
  int64_t span = (rows + target - 1) / target;
  span = (span + kWideRecs - 1) / kWideRecs * kWideRecs;
  p->span = span < kWideRecs ? kWideRecs : span;
  p->nblk = span_blocks(rows, p->G, p->span);
  if (p->nblk > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  p->bytes = grouping_bytes(rows, p->G, sizeof(typename Mass::Rec::T)) +
             align256(sizeof(typename Mass::Part) * 2 * P *
                      static_cast<size_t>(F) * W * p->nblk);
  return 0;
}

// The wide level: grouping (masses: the mass policy's record source,
// GhwRec or QRec), the blocks, then the merge of their partials with the
// epilogue epi over the 3 * n_nodes * F * W cells of hist (MergeAdd: ADDS
// into the float levels' hist; MergeFlushI8: writes the int8 levels'
// float32 hist). Writes nid_out; ws holds plan_wide's bytes. plan_only:
// those bytes alone, into *bytes.
template <class Src, class Mass, class Epi, Ablate kA = Ablate::kNone>
int launch_wide(const Src& src, bool plan_only, size_t* bytes,
                const int* nid, typename Mass::Rec masses, int64_t rows,
                int F, int n_prev, int n_nodes, int level_base, int bf16,
                int* nid_out, Epi epi, void* ws, cudaStream_t stream) {
  using RecT = typename Mass::Rec::T;
  using Part = typename Mass::Part;
  WidePlan p;
  int rc = plan_wide<Src, Mass, kA>(rows, F, n_prev, n_nodes, &p);
  if (plan_only) {
    *bytes = rc == 0 ? p.bytes : 0;
    return rc;
  }
  if (rc != 0) return rc;
  Grouping g;
  Part* part = reinterpret_cast<Part*>(carve_grouping(
      static_cast<char*>(ws), rows, p.G, &g, sizeof(RecT)));
  const ParentKey<Src> key{nid, src, n_prev, level_base - n_prev,
                           level_base, n_nodes, nid_out};
  rc = launch_grouping(key, masses, rows, p.G, p.span, g, stream);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(p.slices), static_cast<unsigned>(p.nblk));
  level_wide_kernel<Src, Mass, kA>
      <<<grid, kWideThreads, p.smem, stream>>>(
      src, static_cast<const RecT*>(g.rec), g.offsets, g.bstart, p.G,
      p.span, F, p.fs, n_prev, n_nodes, level_base, bf16, nid_out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fw = static_cast<int64_t>(F) * Src::kW;
  return launch_merge(GroupedSrc{n_nodes, n_prev, level_base, fw}, part,
                      2 * Mass::kPlanes * fw, g.bstart, 3 * n_nodes * fw,
                      epi, stream);
}

// The forms of a float level (K1 and K8), the C entries' form argument:
// forced, or picked from the shapes (kPickForm) by level_form.
enum LevelForm {
  kPickForm = -1,
  kTiledForm = 0,   // the tiled body
  kTensorForm = 1,  // the tensor-core grouped body (level_grouped.cuh)
  kWideForm = 2,    // the wide body
  kColumnForm = 3,  // the column body ([F, rows], level_column.cuh)
};

// The form a float level takes: a form >= 0 forced (a grouped form that does
// not fit or has no instance at W, or the column body in [rows, F] or where it
// does not fit, then fails at its launch), or picked (kPickForm). In [F, rows]
// (K5) the column body (level_column.cuh) wherever one feature's block fits
// shared memory (column_fits: up to N = 1024 nodes at W = 16, 512 at W = 32,
// 256 at W = 64, 128 at W = 128, 64 at W = 256), the tiled body past that. The
// column body against the tiled body, chip_smoke.py phase 6 at 10M x 28, bf16,
// on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; device ms): W = 32, N = 1..32:
// 2.979 / 2.533, 2.798 / 2.661, 2.532 / 2.382, 2.493 / 2.915, 2.459 / 3.729,
// 2.581 / 3.873, 15.84 / 18.09 a tree; at N = 32, W = 64 4.836 / 7.118, W =
// 128 11.82 / 9.231, W = 256 10.60 / 12.75. The tiled body, faster at some
// levels, adds floats in schedule order and is no candidate where the column
// body fits. The route stays inside the level: K6's route first, then the
// column body on the routed ids, took 2.638, 4.891, 11.84 and 10.65 ms at N =
// 32, W = 32, 64, 128, 256 against the level's 2.562, 4.836, 11.82 and
// 10.60: the gathers cost the level less than K6's separate pass.
//
// In [rows, F], where a grouped body takes the shapes (grouped_fits), the wide
// body at W >= 64 and the tensor-core body below; else the tiled body (levels
// past kMaxGroups groups, frames past 512 features). chip_smoke.py at 10M x
// 28, bf16, on an H100 (NVIDIA H100 80GB HBM3, 700 W; ms a tree of six levels
// N = 1..32, tensor-core / wide / tiled), K1: W = 32 11.31 / 13.96 / 13.34; W
// = 64 20.30 / 13.34 / 17.36; W = 128 37.11 / 12.92 / 23.04; W = 256 72.48 /
// 13.38 / 36.28 (at N = 32 the wide body 2.565 ms against one index_add_ of
// 5.868); K8: W = 32 14.31 / 18.50 / -; W = 64 26.08 / 16.89 / 22.17; W = 128
// 50.04 / 16.40 / 30.52; W = 256 95.15 / 16.25 / 44.94. The wide body wins
// every level at W >= 64, where the tensor-core body has no instance any more
// (its last times, K1 19.94 / 36.87 / 71.97 and K8 25.58 / 49.56 / 94.56 a
// tree at W = 64 / 128 / 256, beside the wide body's 12.76 / 12.59 / 13.08 and
// 16.43 / 16.26 / 15.90 in one run), the tensor-core body at W = 32 and below;
// the tiled body, faster at some levels below 8 nodes, adds floats in schedule
// order and is no candidate where a grouped body fits.
constexpr int kWideMinW = 64;

inline int level_form(int form, bool feat_major, int64_t rows, int F, int W,
                      int n_prev, int n_nodes) {
  if (form >= 0) return form;
  if (feat_major)
    return column_fits(F, W, n_nodes) ? kColumnForm : kTiledForm;
  if (!grouped_fits(rows, F, n_prev, n_nodes)) return kTiledForm;
  return W >= kWideMinW ? kWideForm : kTensorForm;
}

// The form an int8 level (K4, K7) takes: a form >= 0 forced (a grouped
// form that does not fit, or has no instance at W, then fails at its
// launch), or picked (kPickForm). Every form gives the same bits (integer
// sums), so the rule picks by measured time alone. In [F, rows] (K5's
// layout), past kMaxGroups groups or 512 features: the tiled body. At
// W <= 32 the tensor-core body where 3 * terms * n_nodes >= 96 (the
// levels at which the tiled body's int32 partial outgrows one tile at 28
// features; with the int8 gate 3 * terms * n_nodes <= 128 that is the
// deepest int8 level, 32 nodes at one term, 16 at two) and its staged
// rows fit a block, else the tiled body. At W >= 64 the wide body, but
// for the tiled body where its whole partial (tiled_i8_partial) is at
// most 48 KB and the level is adaptive or of two terms: there the
// grouping pass and, at two terms, the 16-byte records and two feature
// slices cost the wide body more than the tiled body's one tile does.
// chip_smoke.py at 10M x 28 on an H100 (NVIDIA H100 80GB HBM3, 700.00 W),
// ms a tree of six levels at one term, wide / tiled / tensor-core (its
// instances at W >= 64 are gone): K4 W = 64 4.88 / 8.10 / 9.55, W = 128
// 6.40 / 14.02 / 28.08, W = 256 8.55 / 25.35 / 127.85; K7 W = 64 9.86 /
// 13.29 / 22.24, W = 128 10.11 / 19.41 / 53.95, W = 256 10.52 / 31.74 /
// 139.11; at N = 32 the wide body K4 1.383, 1.331, 1.919 ms and K7 1.981,
// 2.103, 2.241 against one index_add_ of 6.436, 5.215, 6.005 and 6.100,
// 5.994, 6.471. The shallow levels, wide / tiled: K7 one term W = 64 N =
// 1, 2, 4 1.271 / 1.036, 1.400 / 1.096, 1.570 / 1.570, W = 128 N = 1, 2
// 1.325 / 1.021, 1.513 / 1.531, W = 256 N = 1 1.358 / 1.562; two terms W =
// 64 N = 1, 2 1.598 / 1.335, 1.747 / 1.866, W = 128 N = 1 1.612 / 1.843;
// K4 one term N = 1 at W = 64, 128, 256 0.838 / 0.889, 0.886 / 0.912,
// 1.022 / 1.419; two terms W = 64 N = 1, 2 1.371 / 1.237, 1.362 / 1.284,
// W = 128 N = 1 1.471 / 1.728. At W <= 32, tensor-core / tiled, N = 1, 2,
// 4, 8, 16, 32: K4 at W = 16, one term, 1.18 / 0.96, 1.22 / 0.91, 1.22 /
// 0.93, 1.21 / 0.94, 1.24 / 1.06, 1.30 / 1.37; two terms (N <= 16), 1.69 /
// 1.31, 1.72 / 1.28, 1.74 / 1.32, 1.75 / 1.45, 1.72 / 1.77; W = 32 alike
// (one term at N = 32: 1.48 / 1.76); K7 at W = 32, one term, 1.81 / 1.15,
// 1.81 / 1.20, 1.83 / 1.14, 1.86 / 1.63, 1.89 / 1.86, 1.97 / 2.50; two
// terms, 2.28 / 1.41, 2.35 / 1.53, 2.35 / 1.95, 2.35 / 2.40, 2.37 / 2.84;
// W = 16 alike (one term at N = 32: 1.70 / 1.88).
constexpr int kI8GroupedMinPlaneNodes = 96;
constexpr int64_t kI8TiledMaxPartial = 48 * 1024;

// Shared bytes of the tiled int8 body's whole partial at these shapes:
// 3 * terms int32 planes of n_nodes x F x (W + 1) sums, and the nodes'
// ranges where the bins need them.
inline int64_t tiled_i8_partial(int terms, int n_nodes, int F, int W,
                                bool ranges) {
  const int64_t cells = static_cast<int64_t>(n_nodes) * F;
  return 4 * 3 * terms * cells * (W + 1) + (ranges ? 8 * cells : 0);
}

inline int i8_level_form(int form, bool feat_major, int64_t rows, int F,
                         int W, int terms, int elem_bytes, bool ranges,
                         int n_prev, int n_nodes) {
  if (form >= 0) return form;
  if (feat_major || !grouped_fits(rows, F, n_prev, n_nodes))
    return kTiledForm;
  if (W >= kWideMinW)
    return (ranges || terms == 2) &&
                   tiled_i8_partial(terms, n_nodes, F, W, ranges) <=
                       kI8TiledMaxPartial
               ? kTiledForm
               : kWideForm;
  return 3 * terms * n_nodes >= kI8GroupedMinPlaneNodes &&
                 grouped_i8_smem(F, W, terms, elem_bytes, ranges) <=
                     kMaxBlockSmem
             ? kTensorForm
             : kTiledForm;
}

}  // namespace h2o3
