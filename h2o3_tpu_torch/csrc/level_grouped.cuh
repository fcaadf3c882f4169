// The node-grouped level on the tensor cores, shared by the [rows, F]
// adaptive level (K8 with float masses, K7 with int8 ones;
// hist_adaptive.cu) and the packed-code level (K1/K3 float, K4 int8;
// hist_binned.cu): rows grouped by parent (ParentKey and the grouping pass
// of level_common.cuh), then one block per span of a group's rows with
// both children and all F features, then a merge of the blocks' partials
// in a fixed order (merge_slots_kernel).
//
// The kernels differ in where a (row, feature)'s bin comes from, a
// bin-source policy Src:
//
//   static constexpr int kW;            lanes (bins) a feature, NA = kW - 1
//   static constexpr bool kRanges;      bins need the child's (lo, inv)
//   static constexpr int kBytes;        bytes of a value
//   using Val;                          what a (row, feature) holds
//   const float *lo, *inv;              [n_nodes, F] where kRanges
//   Val load(int64_t r, int f, int F)   x[r, f] or codes[r, f]
//   const unsigned char* rows()         x or codes, [rows, F] row-major
//   static Val at(const unsigned char* row, int f)   value f of a row
//   bool can(int lp, int n_prev)        parent lp of the window splits
//   void split(k, n_prev, F, &feat, &thr, &na_right)   parent k's split
//   int right(Val v, Val thr, int na_right)            the routing rule
//   int bin(Val v, float lo, float inv) in [0, kW), or any other value
//                                       (the row adds nothing there)
//
// AdaptiveBins (raw float32 x re-binned under the child's range) and
// CodeBins (int8 / int16 packed codes: the code is the bin) live beside
// their launchers; and in what a row adds, a mass policy (FloatMass,
// I8Mass, below): its record, its tensor-core product, its partial and
// the merge's epilogue.
//
// The histogram is the TPU kernels' one-hot contraction made narrow by the
// grouping. Float masses: per 16 rows, (bin one-hot, 16 bins x 16 rows) x
// (16 rows x (g, h, w) of each child), with mma.sync m16n8k16 bf16 -> f32.
// The products are exact: at bf16 every mass is a bf16 value; at float32
// each mass is split into three bf16 terms as the JAX package's
// _split3_bf16 does (hi, then the residuals pre-scaled by 2^8 and 2^16)
// and the three sums are recombined as its _unsplit3 does. Each block
// writes its partial into its own slot, and the merge adds the slots in a
// fixed order: there are no float atomics in the level, so the same inputs
// give the same bits. Int8 masses (H2O3_HIST_I8): per 32 rows, mma.sync
// m16n8k32 s8 -> s32 on the q bytes, the TPU kernels' int8 x int8 -> int32
// contraction, one n-tile per term; integer sums are exact in any order,
// and the merge flushes them to float32 as flush_i8_kernel does, so the
// histogram is bit-equal to the plain version and to the tiled body.
//
// Int32 bound of the int8 form: |q| <= 127 (a term of two: a in
// [-127, 127], b in [-128, 127]), and the int8 levels take at most 16M
// rows (I8_MAX_ROWS), so every partial (a block's span) and every merged
// sum is at most 128 x 16M < 2^31 in magnitude.
//
// What bounds it in practice is instruction issue and the latency of each
// chunk's dependent steps: the bins (one per row and feature), the one-hot
// fragments (float: one bf16x2 compare per two elements; int8: one PRMT
// per four) and one barrier a chunk; the staging of the next chunks is
// prefetched (float: into registers; int8: cp.async into shared memory)
// while the current chunk's products run. With the grouping pass's cost
// each level, the int8 body beats the tiled int8 body only where that
// one's partial outgrows a tile at W <= 32 (i8_level_form,
// level_wide.cuh).
#pragma once

#include <type_traits>

#include "level_common.cuh"

namespace h2o3 {

constexpr int kGrpThreads = 512;
constexpr int kGrpWarps = kGrpThreads / 32;
constexpr int kChunk = 64;                  // rows staged at a time
constexpr int kSteps = kChunk / 16;         // mma k-steps a chunk
constexpr int kBinStride = kChunk + 2;      // bf16 bins a feature: 33 words
constexpr int kStageBufs = 3;               // row ids, slots, masses
constexpr int kXPer = 4;                    // values a thread prefetches
// largest F the grouped level takes (a (row, feature) is row * 1024 +
// feature in a register)
constexpr int kMaxGroupedF = 512;

// The grouping key of a row of the level: its parent's index in the
// previous window when it is routed (the parent can split); a row that
// keeps its node id and lies in the level's window (level 0: the root)
// n_prev + its level-local node; any other row is left out. Rows that are
// not routed keep their node id (tag writes it); the histogram kernel
// routes the others and writes theirs.
template <class Src>
struct ParentKey {
  const int* __restrict__ nid;
  Src src;
  int n_prev, prev_base, level_base, n_nodes;
  int* __restrict__ nid_out;
  __device__ __forceinline__ int operator()(int64_t r) const {
    const int id = nid[r];
    const int lp = id - prev_base;
    if (n_prev > 0 && lp >= 0 && lp < n_prev && src.can(lp, n_prev))
      return lp;
    const int ln = id - level_base;
    return (ln >= 0 && ln < n_nodes) ? n_prev + ln : -1;
  }
  __device__ __forceinline__ int tag(int64_t r, int k) const {
    if (k < 0 || k >= n_prev) nid_out[r] = nid[r];
    return static_cast<int>(r);
  }
};

// The bf16 one-hot of two bins against one lane's bin: each half of pair
// and mm a bf16 integer; a half becomes bf16 1.0 where they are equal,
// else 0 (one native bf16x2 compare on sm_90).
__device__ __forceinline__ unsigned onehot2(unsigned pair, unsigned mm) {
  unsigned d;
  asm("set.eq.bf16x2.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(pair), "r"(mm));
  return d;
}

// d += a (16 x 16 bf16, row-major fragment) x b (16 x 8 bf16, col-major
// fragment), float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The exact three-term bf16 split of a float32 (the JAX package's
// _split3_bf16): t == hi + (mid / 2^8 + lo / 2^16), each term bf16-valued,
// the residuals pre-scaled so that they stay normal.
__device__ __forceinline__ void split3(float t, float* hi, float* mid,
                                       float* lo) {
  *hi = round_bf16(t);
  const float r1 = __fmul_rn(__fsub_rn(t, *hi), 256.f);
  *mid = round_bf16(r1);
  *lo = __fmul_rn(__fsub_rn(r1, *mid), 256.f);
}

template <int NT, bool kMma>
struct GroupedShape {
  // (feature, m-tile) units a warp accumulates in registers in one pass
  static constexpr int kUnits = kMma ? 4 : 1;
  // B fragments of a chunk, lane order: [kSteps][NT][32 lanes][2] words
  static constexpr int kFragWords = kMma ? kSteps * NT * 64 : 0;
  // masses of a chunk for the ablation's atomics: [3][kChunk]
  static constexpr int kMassWords = kMma ? 0 : 3 * kChunk;
};

inline size_t grouped_smem(int F, int W, int NT, bool mma, bool ranges) {
  const int words = mma ? kSteps * NT * 64 : 3 * kChunk;
  size_t b = 2 * sizeof(uint16_t) * static_cast<size_t>(F) * kBinStride +
             sizeof(unsigned) * kStageBufs * words +
             2 * sizeof(int) * kStageBufs * kChunk;
  if (ranges) b += 4 * sizeof(float) * static_cast<size_t>(F);
  if (!mma) b += sizeof(float) * 6 * static_cast<size_t>(F) * (W + 1);
  return b;
}

// The float body (FloatMass): one block, the span of group k's records
// that block b owns (k from
// bstart), both children of the parent (parent mode) or the one node
// (direct mode), every feature; blockIdx.y picks the pass, a share of the
// (feature, m-tile) units when they outgrow the registers. A chunk of 64
// records goes through three steps, pipelined over the chunks with one
// barrier a chunk:
// (1) stage (64 threads, a record each, prefetched two chunks ahead and
//     routed by the value of the split feature, prefetched one ahead):
//     row id and slot (the child's side) into shared memory, and the
//     masses (bf16-rounded, or three bf16 terms at float32) straight into
//     the B fragments of the chunk, in lane order (three buffers);
// (2) bins: every (row, feature) once, as a bf16 integer (two buffers);
//     the values are loaded into registers while the previous chunk's
//     products run;
// (3) kMma: each warp adds its units' one-hot products with mma.sync
//     m16n8k16 (A: the bin one-hot, 16 bins x 16 rows, built in registers
//     with bf16x2 compares; B: 16 rows x 8 columns, (g, h, w) of slot 0
//     and of slot 1, two columns empty; one B per term), the chunk's four
//     k-steps chained in the tensor core, then added into float32
//     registers; else (the adaptive level's ablation): shared float
//     atomics into a [3][2][F][W + 1] partial.
// The block writes its partial, [3][2][F][W], into its own slot of part.
// kA: a phase knock-out (level_common.cuh; kMma instances only).
template <class Src, int NT, bool kMma, Ablate kA = Ablate::kNone>
__device__ __forceinline__ void
grouped_float_body(Src src, const float4* __restrict__ rec,
                     const int* __restrict__ offsets,
                     const int* __restrict__ bstart, int G, int64_t span,
                     int F, int n_prev, int n_nodes, int level_base,
                     int bf16, int* __restrict__ nid_out,
                     float* __restrict__ part) {
  using Shape = GroupedShape<NT, kMma>;
  using Val = typename Src::Val;
  constexpr int W = Src::kW;
  constexpr int MT = W / 16;
  constexpr int U = Shape::kUnits;
  constexpr int kWords = kMma ? Shape::kFragWords : Shape::kMassWords;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  if (b >= __ldg(bstart + G)) return;
  const int k = span_group(bstart, G, b);
  const int64_t i0 = __ldg(offsets + k) +
                     static_cast<int64_t>(b - __ldg(bstart + k)) * span;
  const int64_t i1 = imin64(__ldg(offsets + k + 1), i0 + span);
  const bool parent = k < n_prev;
  const int pid = level_base - n_prev + k;  // the parent's node id
  // level-local node of slot 0: the left child, or the node itself
  const int c0 = parent ? 2 * pid + 1 - level_base : k - n_prev;

  uint16_t* s_bin = reinterpret_cast<uint16_t*>(smem_raw);  // [2][F][stride]
  unsigned* s_w = reinterpret_cast<unsigned*>(s_bin + 2 * F * kBinStride);
  int* s_slot = reinterpret_cast<int*>(s_w + kStageBufs * kWords);
  int* s_r = s_slot + kStageBufs * kChunk;               // [3][kChunk]
  float* s_lo = reinterpret_cast<float*>(s_r + kStageBufs * kChunk);
  float* s_inv = s_lo + 2 * F;                           // [2][F]
  float* s_hist = Src::kRanges ? s_inv + 2 * F : s_lo;   // ablation
  const int hplane = 2 * F * (W + 1);
  const int nbin = kChunk * F;

  if constexpr (Src::kRanges) {
    for (int i = threadIdx.x; i < 2 * F; i += blockDim.x) {
      const int s = i / F, f = i - s * F;
      const int node = c0 + s;
      const bool ok = (parent || s == 0) && node >= 0 && node < n_nodes;
      const int64_t o = static_cast<int64_t>(ok ? node : 0) * F + f;
      s_lo[i] = ok ? src.lo[o] : 0.f;
      s_inv[i] = ok ? src.inv[o] : 0.f;
    }
  }
  if (!kMma)
    for (int i = threadIdx.x; i < 3 * hplane; i += blockDim.x) s_hist[i] = 0.f;
  int feat = 0, na_right = 0;
  Val thr = Val(0);
  if (parent) src.split(k, n_prev, F, &feat, &thr, &na_right);

  // (1) the record of row t of chunk c (t = threadIdx.x < kChunk), its
  // split value v, into stage buffer sb
  auto stage = [&](int64_t c, int sb, const float4& q, Val v) {
    const int t = threadIdx.x;
    int slot = -1, r = 0;
    float m[3] = {0.f, 0.f, 0.f};
    if (c + t < i1) {
      r = __float_as_int(q.x);
      int side = 0;
      if (parent) {
        if constexpr (kA != Ablate::kRoute) side = src.right(v, thr, na_right);
        if (blockIdx.y == 0) nid_out[r] = 2 * pid + 1 + side;
      }
      slot = c0 + side >= 0 && c0 + side < n_nodes ? side : -1;
      m[0] = q.y;
      m[1] = q.z;
      m[2] = q.w;
    }
    s_slot[sb * kChunk + t] = slot;
    s_r[sb * kChunk + t] = r;
    unsigned* w = s_w + sb * kWords;
    if constexpr (kMma) {
      // row t is B row kk of k-step ks: lane (column n, t4), register
      // kk / 8, half kk % 2
      const int ks = t >> 4, kk = t & 15;
      const int t4 = (kk & 7) >> 1, reg = kk >> 3, half = kk & 1;
      uint16_t* w16 = reinterpret_cast<uint16_t*>(w);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float term[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          if constexpr (NT == 3) {
            float hi, mid, lw;
            split3(m[p], &hi, &mid, &lw);
            term[p] = n == 0 ? hi : (n == 1 ? mid : lw);
          } else {
            term[p] = round_bf16(m[p]);
          }
        }
#pragma unroll
        for (int col = 0; col < 8; ++col) {
          const float val =
              col < 6 && slot == col / 3 ? term[col % 3] : 0.f;
          const int word = ((ks * NT + n) * 32 + col * 4 + t4) * 2 + reg;
          w16[word * 2 + half] =
              static_cast<uint16_t>(__float_as_uint(val) >> 16);
        }
      }
    } else {
      float* sm = reinterpret_cast<float*>(w);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        sm[p * kChunk + t] = bf16 ? round_bf16(m[p]) : m[p];
    }
  };
  // this thread's (row, feature)s of a chunk, as row * 1024 + feature
  int rf[kXPer];
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    const int j = threadIdx.x + q * kGrpThreads;
    rf[q] = j < nbin ? (j / F) * 1024 + (j % F) : -1;
  }
  // their values
  Val xv[kXPer];
  auto load_x = [&](int sb) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      xv[q] = Val(0);
      if (kA != Ablate::kBins && rf[q] >= 0) {
        const int row = rf[q] >> 10;
        if (s_slot[sb * kChunk + row] >= 0)
          xv[q] = src.load(s_r[sb * kChunk + row], rf[q] & 1023, F);
      }
    }
  };
  // (2) bins of stage buffer sb into bin buffer bb, each as a bf16
  // integer (exact: bins < 256; a value outside [0, W) matches no bin);
  // values from xv, past it from memory
  auto bins = [&](int sb, int bb) {
    uint16_t* sbin = s_bin + bb * F * kBinStride;
    auto put = [&](int row, int f, Val v) {
      const int slot = s_slot[sb * kChunk + row];
      float lo = 0.f, inv = 0.f;
      if constexpr (Src::kRanges) {
        if (kA == Ablate::kRanges) {
          lo = -4.f;
          inv = (W - 2) / 8.f;
        } else if (slot >= 0) {
          lo = s_lo[slot * F + f];
          inv = s_inv[slot * F + f];
        }
      }
      int bin;
      if constexpr (kA == Ablate::kBins)
        bin = slot >= 0 ? ablate_bin(s_r[sb * kChunk + row], f, W) : 0;
      else
        bin = slot >= 0 ? src.bin(v, lo, inv) : 0;
      sbin[f * kBinStride + row] = static_cast<uint16_t>(
          __float_as_uint(static_cast<float>(bin)) >> 16);
    };
#pragma unroll
    for (int q = 0; q < kXPer; ++q)
      if (rf[q] >= 0) put(rf[q] >> 10, rf[q] & 1023, xv[q]);
    for (int j = threadIdx.x + kXPer * kGrpThreads; j < nbin;
         j += kGrpThreads) {
      const int row = j / F, f = j - row * F;
      const Val v = kA != Ablate::kBins && s_slot[sb * kChunk + row] >= 0
                        ? src.load(s_r[sb * kChunk + row], f, F)
                        : Val(0);
      put(row, f, v);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int units = F * MT;
  const int ubase = blockIdx.y * (kGrpWarps * U) + warp;  // + i * warps
  float acc[U][NT][4];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  unsigned fold = 0u;  // kAdds: the products' operands

  // (3) the products of stage buffer sb, bin buffer bb
  auto accumulate = [&](int sb, int bb) {
    const uint16_t* sbin = s_bin + bb * F * kBinStride;
    if constexpr (kMma) {
      const uint2* frag = reinterpret_cast<const uint2*>(s_w + sb * kWords);
      const unsigned* bw32 = reinterpret_cast<const unsigned*>(sbin);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = ubase + i * kGrpWarps;
        if (u < units) {
          const int f = u / MT, mt = u - f * MT;
          // this lane's two bins of the m-tile as bf16 integers, twice
          const unsigned m0 =
              __float_as_uint(static_cast<float>(mt * 16 + g8)) >> 16;
          const unsigned m8 =
              __float_as_uint(static_cast<float>(mt * 16 + g8 + 8)) >> 16;
          const unsigned mm0 = m0 * 0x10001u, mm8 = m8 * 0x10001u;
          const unsigned* bw = bw32 + f * (kBinStride / 2);
          float tmp[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[n][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            const unsigned p0 = bw[ks * 8 + t4], p1 = bw[ks * 8 + 4 + t4];
            const unsigned a[4] = {onehot2(p0, mm0), onehot2(p0, mm8),
                                   onehot2(p1, mm0), onehot2(p1, mm8)};
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const uint2 fb = frag[(ks * NT + n) * 32 + lane];
              const unsigned bb2[2] = {fb.x, fb.y};
              if constexpr (kA == Ablate::kAdds)
                fold ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ bb2[0] ^ bb2[1];
              else
                mma_bf16(tmp[n], a, bb2);
            }
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][n][e] = __fadd_rn(acc[i][n][e], tmp[n][e]);
        }
      }
    } else {
      const int* sslot = s_slot + sb * kChunk;
      const float* sm = reinterpret_cast<const float*>(s_w + sb * kWords);
      for (int j = threadIdx.x; j < nbin; j += kGrpThreads) {
        const int row = j / F, f = j - row * F;
        const int slot = sslot[row];
        if (slot < 0) continue;
        const int bin = static_cast<int>(
            __uint_as_float(static_cast<unsigned>(sbin[f * kBinStride + row])
                            << 16));
        if (static_cast<unsigned>(bin) >= static_cast<unsigned>(W)) continue;
        const int cell = (slot * F + f) * (W + 1) + bin;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          atomicAdd(s_hist + p * hplane + cell, sm[p * kChunk + row]);
      }
    }
  };

  // the pipeline: stage(c + 1) and the value loads of c + 1 overlap the
  // products of c; a stager holds the record of chunk c + 2 in flight and
  // that of c + 1 with its split value. Buffers: stage c % 3, bins c % 2.
  const bool stager = threadIdx.x < kChunk;
  const int64_t t = threadIdx.x;
  auto fetch = [&](int64_t c) {
    return stager && c + t < i1 ? rec[c + t]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto split_value = [&](int64_t c, const float4& q) {
    return kA != Ablate::kRoute && stager && parent && c + t < i1
               ? src.load(__float_as_int(q.x), feat, F)
               : Val(0);
  };
  float4 qa = fetch(i0);
  Val va = split_value(i0, qa);
  __syncthreads();  // ranges staged
  if (stager) stage(i0, 0, qa, va);
  qa = fetch(i0 + kChunk);
  va = split_value(i0 + kChunk, qa);
  float4 qb = fetch(i0 + 2 * kChunk);
  __syncthreads();
  load_x(0);
  int ci = 0;
  for (int64_t c = i0; c < i1; c += kChunk, ++ci) {
    const int sb = ci % kStageBufs, bb = ci & 1;
    bins(sb, bb);
    const bool more = c + kChunk < i1;
    if (more && stager) {
      stage(c + kChunk, (ci + 1) % kStageBufs, qa, va);
      qa = qb;
      va = split_value(c + 2 * kChunk, qa);
      qb = fetch(c + 3 * kChunk);
    }
    __syncthreads();
    if (more) load_x((ci + 1) % kStageBufs);
    accumulate(sb, bb);
  }

  if constexpr (kA == Ablate::kAdds) sink_fold(fold);
  // the block's partial into its slot: part[b][3][2][F][W]
  float* pb = part + static_cast<int64_t>(b) * 6 * F * W;
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = ubase + i * kGrpWarps;
      if (u >= units) continue;
      const int f = u / MT, mt = u - f * MT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t4 + (e & 1);
        if (col >= 6) continue;
        float v = acc[i][0][e];
        if constexpr (NT == 3)  // the JAX package's _unsplit3
          v = __fadd_rn(v, __fadd_rn(__fmul_rn(acc[i][1][e], 1.f / 256.f),
                                     __fmul_rn(acc[i][2][e], 1.f / 65536.f)));
        const int bin = mt * 16 + g8 + (e >> 1) * 8;
        pb[((col % 3) * 2 + col / 3) * F * W + f * W + bin] = v;
      }
    }
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < 6 * F * W; i += kGrpThreads) {
      const int cs = i / (F * W), fb = i - cs * F * W;
      const int f = fb / W, bin = fb - f * W;
      pb[i] = s_hist[cs * F * (W + 1) + f * (W + 1) + bin];
    }
  }
}

// ------------------------------------------------------ the int8 mass body

// d += a (16 x 32 s8, row-major fragment) x b (32 x 8 s8, col-major
// fragment), int32 accumulate: exact (no .satfinite; the int8 levels' row
// cap keeps every sum within int32).
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// PTX prmt.b32 (default mode): byte i of the result is byte (nibble i of
// s) of {b, a}.
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned s) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// The s8 one-hot of four rows against one lane's bin, one PRMT: sel holds
// four selector nibbles (bits 15:0, row i in nibble i), each the row's bin
// within the lane's octet (0..7), or a nibble with bit 3 set when the
// row's bin lies outside it; {hi, lo} is the lane's table, byte j = 1
// where j is the lane's place in the octet, else 0. PRMT gives byte i =
// table[nibble i] for a nibble below 8, and for one with its msb set
// ("replicate the sign of the byte") 0x00, since every table byte is 0 or
// 1: exact 0/1 bytes.
__device__ __forceinline__ unsigned onehot4(unsigned sel, unsigned lo,
                                            unsigned hi) {
  return prmt(lo, hi, sel);
}

// The selector word (onehot4) of four rows' byte bins x (row i in byte i)
// within one m-tile (x already XORed with 16 * mt in every byte), SWAR: a
// byte below 16 lies in the m-tile, its low nibble in the lower octet's
// half and that nibble ^ 8 in the upper's (a nibble with bit 3 set matches
// no lane); any other byte gets bit 3 in both.
__device__ __forceinline__ unsigned swar_selector(unsigned x) {
  const unsigned h = (x >> 4) & 0x0F0F0F0Fu;  // a byte's high nibble
  const unsigned out = ((h + 0x07070707u) | h) & 0x08080808u;  // h != 0
  const unsigned n = x & 0x0F0F0F0Fu;
  const unsigned lo = n | out, hi = (n ^ 0x08080808u) | out;
  // the four nibbles of a half into its low 16 bits, rows in order
  return prmt(lo | (lo >> 4), hi | (hi >> 4), 0x6420u);
}

// An asynchronous copy of N (4, 8 or 16) bytes from device to shared
// memory, both N-aligned; the copies of a thread's committed group land
// by cp_async_wait<n> (at most n later groups still in flight).
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(gmem), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The mass policies of the grouped body. FloatMass<NT, kMma>: float32
// (g, h, w) from ghw, NT bf16 terms (one at bf16, three at float32),
// tensor-core products (kMma) or the ablation's shared atomics; the float
// body above. I8Mass<kTerms>: the int8 q of quantize_ghw_i8, the int8
// body below.
template <int NT_, bool kMma_>
struct FloatMass {
  static constexpr bool kInt = false;
  static constexpr int NT = NT_;
  static constexpr bool kMma = kMma_;
  static constexpr int kPlanes = 3;
  using Rec = GhwRec;
  using Part = float;
};

template <int kTerms>
struct I8Mass {
  static constexpr bool kInt = true;
  static constexpr int NT = kTerms;  // one n-tile a term
  static constexpr bool kMma = true;
  static constexpr int kPlanes = 3 * kTerms;
  using Rec = QRec<kTerms>;
  using Part = int;
  // the wide body (level_wide.cuh): a record's q bytes staged as the
  // words after its row id (one at one term, two at two), summed in int32
  using Stage = typename std::conditional<kTerms == 1, unsigned, uint2>::type;
  static __device__ __forceinline__ int row(const typename Rec::T& v) {
    return Rec::row(v);
  }
  static __device__ __forceinline__ Stage stage(const typename Rec::T& v,
                                                int) {
    if constexpr (kTerms == 1)
      return v.y;
    else
      return make_uint2(v.y, v.z);
  }
  // q[p] of a staged record, each byte sign-extended on its own
  static __device__ __forceinline__ int mass(const Stage& s, int p) {
    unsigned w;
    if constexpr (kTerms == 1)
      w = s;
    else
      w = p < 4 ? s.x : s.y;
    return static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * (p & 3))));
  }
  static __device__ __forceinline__ int add(int a, int b) { return a + b; }
};

constexpr int kI8Chunk = 128;             // rows of a chunk
constexpr int kI8Steps = kI8Chunk / 32;   // m16n8k32 k-steps a chunk
constexpr int kI8Quads = kI8Chunk / 4;    // quads of rows a chunk
constexpr int kI8Units = 4;               // (feature, m-tile) units a warp
constexpr int kXAhead = 3;                // chunks of rows copied ahead
constexpr int kRecAhead = 5;              // chunks of records copied ahead
constexpr int kXRing = kXAhead + 1;
constexpr int kRecRing = kRecAhead + 1;
constexpr int kI8Items = 4;               // bin items a thread keeps

// Words of one staged row of F values of `bytes` each: the row's words at
// any byte offset (one more than it fills), in whole 16-byte units.
__host__ __device__ __forceinline__ int i8_row_stride(int row_bytes) {
  return ((row_bytes + 3) / 4 + 1 + 3) / 4 * 4;
}

// Words of one feature's selectors in a bin buffer: MT m-tiles of
// kI8Quads words, one more so that the features' words start on different
// banks; and of the two bin buffers, in whole 16-byte units.
__host__ __device__ __forceinline__ int sel_stride(int W) {
  return (W / 16) * kI8Quads + 1;
}
__host__ __device__ __forceinline__ int sel_words(int F, int W) {
  return (2 * F * sel_stride(W) + 3) / 4 * 4;
}

// Shared bytes of a block of the int8 body.
inline size_t grouped_i8_smem(int F, int W, int terms, int elem_bytes,
                              bool ranges) {
  const size_t rec_bytes = terms == 1 ? 8 : 16;
  return sizeof(unsigned) * kXRing * kI8Chunk *
             static_cast<size_t>(i8_row_stride(F * elem_bytes)) +
         rec_bytes * kRecRing * kI8Chunk +
         sizeof(unsigned) * static_cast<size_t>(sel_words(F, W)) +
         sizeof(unsigned) * kStageBufs * kI8Steps * terms * 64 +
         sizeof(int) * kStageBufs * kI8Chunk +
         (ranges ? 4 * sizeof(float) * static_cast<size_t>(F) : 0);
}

// The int8 body: one block, the same span, children and passes as the
// float body's, chunks of 128 records (half the barriers a row of the
// float body's 64). A chunk's values are gathered from scattered rows;
// here they come in asynchronously and far ahead, with no register to
// hold them: the records of a chunk are copied into shared memory five
// chunks ahead and the values of its rows (x or codes: the pass's
// features and the split feature, cp.async) three ahead, from the
// records' row ids; the split value of a row is read from its staged row.
// A chunk goes through three steps, one barrier a chunk:
// (1) stage (128 threads, a record each, one chunk ahead): the route, the
//     slot (the child's side) and the row's byte offset in its staged
//     row, and the q bytes of each term straight into the B fragments of
//     the chunk, in lane order (three buffers);
// (2) bins: a thread takes a quad of rows of one feature, bins the four
//     values under the slot's range and writes the quad's selector words,
//     one per m-tile: per row, a nibble of the octet its bin lies in (the
//     bin's place) and 8 in every other (onehot4); a bin outside [0, W)
//     has no octet. Byte codes go four features at a time: four row words
//     transposed by PRMT, the selectors built SWAR (swar_selector) (two
//     buffers);
// (3) each warp adds its units' products, per 32 rows an m16n8k32 s8 mma
//     (A: 16 bins x 32 rows from four PRMTs of two selector words; B: 32
//     rows x 8 columns of q bytes, (g, h, w) of slot 0 and of slot 1, two
//     empty; one n-tile a term) into int32 registers, exact.
// The block writes its int32 partial, [3 * kTerms][2][F][W] (plane c *
// kTerms + term), into its own slot of part. kA: a phase knock-out
// (level_common.cuh); under kBins the rows' staged bytes are the split
// feature's alone.
template <class Src, int kTerms, Ablate kA = Ablate::kNone>
__device__ __forceinline__ void grouped_i8_body(
    Src src, const typename QRec<kTerms>::T* __restrict__ rec,
    const int* __restrict__ offsets, const int* __restrict__ bstart, int G,
    int64_t span, int F, int n_prev, int n_nodes, int level_base,
    int* __restrict__ nid_out, int* __restrict__ part) {
  using Rec = QRec<kTerms>;
  using RecT = typename Rec::T;
  constexpr int NT = kTerms;
  constexpr int W = Src::kW;
  constexpr int MT = W / 16;
  constexpr int U = kI8Units;
  constexpr int kC = kI8Chunk;
  constexpr int kWords = kI8Steps * NT * 64;  // B fragments of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  if (b >= __ldg(bstart + G)) return;
  const int k = span_group(bstart, G, b);
  const int64_t i0 = __ldg(offsets + k) +
                     static_cast<int64_t>(b - __ldg(bstart + k)) * span;
  const int64_t i1 = imin64(__ldg(offsets + k + 1), i0 + span);
  const bool parent = k < n_prev;
  const int pid = level_base - n_prev + k;  // the parent's node id
  // level-local node of slot 0: the left child, or the node itself
  const int c0 = parent ? 2 * pid + 1 - level_base : k - n_prev;

  const int rb = F * Src::kBytes;  // bytes of a row of values
  const int xstride = i8_row_stride(rb);
  const int sstride = sel_stride(W);
  unsigned* s_x = reinterpret_cast<unsigned*>(smem_raw);  // [ring][kC][xs]
  RecT* s_rec = reinterpret_cast<RecT*>(s_x + kXRing * kC * xstride);
  unsigned* s_sel = reinterpret_cast<unsigned*>(s_rec + kRecRing * kC);
  unsigned* s_w = s_sel + sel_words(F, W);           // [3][kWords]
  int* s_so = reinterpret_cast<int*>(s_w + kStageBufs * kWords);  // [3][kC]
  float* s_lo = reinterpret_cast<float*>(s_so + kStageBufs * kC);
  float* s_inv = s_lo + 2 * F;                        // [2][F]

  if constexpr (Src::kRanges) {
    for (int i = threadIdx.x; i < 2 * F; i += blockDim.x) {
      const int s = i / F, f = i - s * F;
      const int node = c0 + s;
      const bool ok = (parent || s == 0) && node >= 0 && node < n_nodes;
      const int64_t o = static_cast<int64_t>(ok ? node : 0) * F + f;
      s_lo[i] = ok ? src.lo[o] : 0.f;
      s_inv[i] = ok ? src.inv[o] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < kStageBufs * kWords; i += blockDim.x)
    s_w[i] = 0u;
  int feat = 0, na_right = 0;
  typename Src::Val thr = 0;
  if (parent) src.split(k, n_prev, F, &feat, &thr, &na_right);
  // the features this pass bins (its units' share of F * MT), and the
  // values of a row it stages: those and the split feature, from a
  // multiple of four features
  const int u0 = blockIdx.y * (kGrpWarps * U);
  const int fa = u0 / MT;
  const int fb = min(F, (u0 + kGrpWarps * U + MT - 1) / MT);
  int ca = (parent ? min(fa, feat) : fa) / 4 * 4;
  int cb = parent ? max(fb, feat + 1) : fb;
  if constexpr (kA == Ablate::kBins) {
    ca = feat / 4 * 4;
    cb = parent ? feat + 1 : ca;
  }
  const int ba = ca * Src::kBytes, rbc = (cb - ca) * Src::kBytes;

  // the copies: chunk j's records into ring slot j % kRecRing; the staged
  // bytes [ba, ba + rbc) of its rows into slot j % kXRing, from its
  // records (landed), in 16-byte units where they are 16-byte aligned in
  // every row, else in the 4-byte words that hold them (the first at a
  // byte offset, off, in them)
  const unsigned char* gx = src.rows();
  const bool vec16 = (kA != Ablate::kBins || rbc > 0) &&
                     ((reinterpret_cast<uintptr_t>(gx) + ba) & 15) == 0 &&
                     (rb & 15) == 0 && (rbc & 15) == 0;
  const int per = vec16 ? rbc / 16 : (rbc + 3) / 4 + 1;  // copies a row
  const int tstep = kGrpThreads / per;  // rows a pass of the block copies
  const int my_t = threadIdx.x / per, my_u = threadIdx.x - my_t * per;
  auto issue_recs = [&](int j) {
    const int64_t c = i0 + static_cast<int64_t>(j) * kC;
    const int t = threadIdx.x;
    if (t < kC && c + t < i1)
      cp_async<sizeof(RecT)>(s_rec + (j % kRecRing) * kC + t, rec + c + t);
  };
  auto issue_x = [&](int j) {
    const int64_t c = i0 + static_cast<int64_t>(j) * kC;
    if (c >= i1 || my_t >= tstep) return;
    const int n = static_cast<int>(imin64(kC, i1 - c));
    const RecT* rr = s_rec + (j % kRecRing) * kC;
    unsigned* xs = s_x + (j % kXRing) * kC * xstride;
    for (int t = my_t; t < n; t += tstep) {
      const unsigned char* a =
          gx + static_cast<int64_t>(Rec::row(rr[t])) * rb + ba;
      if (vec16) {
        cp_async<16>(xs + t * xstride + 4 * my_u, a + 16 * my_u);
      } else {
        const unsigned char* w0 = reinterpret_cast<const unsigned char*>(
            reinterpret_cast<uintptr_t>(a) & ~uintptr_t{3});
        if (w0 + 4 * my_u < a + rbc)
          cp_async<4>(xs + t * xstride + my_u, w0 + 4 * my_u);
      }
    }
  };
  // the staged row t of chunk j (byte offset off), as a row of all F
  // values: value f (in [ca, cb)) at byte f * kBytes
  auto xrow = [&](int j, int t, int off) {
    return reinterpret_cast<const unsigned char*>(
               s_x + ((j % kXRing) * kC + t) * xstride) + off - ba;
  };

  // (1) stage chunk j (t = threadIdx.x < kC): route, slot and offset,
  // B fragments
  auto stage = [&](int j) {
    const int64_t c = i0 + static_cast<int64_t>(j) * kC;
    const int t = threadIdx.x, sb = j % kStageBufs;
    int slot = -1, off = 0;
    RecT q = Rec::zero();
    if (c + t < i1) {
      q = s_rec[(j % kRecRing) * kC + t];
      const int r = Rec::row(q);
      if (!vec16)
        off = static_cast<int>((reinterpret_cast<uintptr_t>(gx) +
                                static_cast<int64_t>(r) * rb + ba) &
                               3);
      int side = 0;
      if (parent) {
        if constexpr (kA != Ablate::kRoute)
          side = src.right(Src::at(xrow(j, t, off), feat), thr, na_right);
        if (blockIdx.y == 0) nid_out[r] = 2 * pid + 1 + side;
      }
      slot = c0 + side >= 0 && c0 + side < n_nodes ? side : -1;
    }
    s_so[sb * kC + t] = (slot & 0xFF) | (off << 8);
    // row t is B row kk of k-step ks: lane (column n, t4), register
    // kk / 16, byte kk % 4
    const int ks = t >> 5, kk = t & 31;
    const int t4 = (kk & 15) >> 2, reg = kk >> 4, byte = kk & 3;
    uint8_t* w8 = reinterpret_cast<uint8_t*>(s_w + sb * kWords);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int col = 0; col < 6; ++col) {  // columns 6 and 7 stay 0
        const int val = slot == col / 3 ? Rec::mass(q, (col % 3) * NT + n)
                                        : 0;
        const int word = ((ks * NT + n) * 32 + col * 4 + t4) * 2 + reg;
        w8[word * 4 + byte] = static_cast<uint8_t>(val);
      }
  };

  // (2) bins of chunk j into bin buffer j % 2. Bin items: (quad, feature)
  // or, for byte codes, (quad, four features); this thread's first
  // kI8Items as quad * 1024 + item-feature
  constexpr bool kSwar = Src::kByteCodes && kA != Ablate::kBins;
  // item-features of a quad: this pass's features, or their groups of
  // four from fi0
  const int fi0 = kSwar ? fa / 4 : fa;
  const int fper = kSwar ? (fb + 3) / 4 - fi0 : fb - fa;
  const int nitem = kI8Quads * fper;
  int qf[kI8Items];
#pragma unroll
  for (int i = 0; i < kI8Items; ++i) {
    const int it = threadIdx.x + i * kGrpThreads;
    qf[i] = it < nitem ? (it / fper) * 1024 + fi0 + (it % fper) : -1;
  }
  auto bins = [&](int j) {
    const int sb = j % kStageBufs;
    unsigned* ssel = s_sel + (j & 1) * F * sstride;
    auto put = [&](int q4, int fi) {
      const int4 so = reinterpret_cast<const int4*>(s_so + sb * kC)[q4];
      const int sos[4] = {so.x, so.y, so.z, so.w};
      if constexpr (kSwar) {
        // codes of features 4 fi .. 4 fi + 3 of the quad's rows, a word a
        // row (0xFF: a row that adds nothing), transposed by PRMT into a
        // word a feature (row i in byte i)
        unsigned rw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rw[i] = 0xFFFFFFFFu;
          if (static_cast<signed char>(sos[i] & 0xFF) >= 0) {
            const unsigned char* p = xrow(j, 4 * q4 + i, sos[i] >> 8) + 4 * fi;
            const unsigned* w = reinterpret_cast<const unsigned*>(
                reinterpret_cast<uintptr_t>(p) & ~uintptr_t{3});
            const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
            rw[i] = sh ? __funnelshift_r(w[0], w[1], 8 * sh) : w[0];
          }
        }
        const unsigned a01 = prmt(rw[0], rw[1], 0x5140u);
        const unsigned b01 = prmt(rw[0], rw[1], 0x7362u);
        const unsigned a23 = prmt(rw[2], rw[3], 0x5140u);
        const unsigned b23 = prmt(rw[2], rw[3], 0x7362u);
        const unsigned tf[4] = {prmt(a01, a23, 0x5410u),
                                prmt(a01, a23, 0x7632u),
                                prmt(b01, b23, 0x5410u),
                                prmt(b01, b23, 0x7632u)};
#pragma unroll
        for (int kf = 0; kf < 4; ++kf) {
          const int f = 4 * fi + kf;
          if (f < fa) continue;
          if (f >= fb) break;
          unsigned* dst = ssel + f * sstride + q4;
#pragma unroll
          for (int p = 0; p < MT; ++p)
            dst[p * kI8Quads] = swar_selector(tf[kf] ^ (0x10101010u * p));
        }
      } else {
        const int f = fi;
        // the feature's range under either child (selected, not indexed:
        // an indexed pair would live in local memory)
        float lo0 = 0.f, inv0 = 0.f, lo1 = 0.f, inv1 = 0.f;
        if constexpr (Src::kRanges && kA == Ablate::kRanges) {
          lo0 = lo1 = -4.f;
          inv0 = inv1 = (W - 2) / 8.f;
        } else if constexpr (Src::kRanges) {
          lo0 = s_lo[f];
          inv0 = s_inv[f];
          lo1 = s_lo[F + f];
          inv1 = s_inv[F + f];
        }
        unsigned w[MT];
#pragma unroll
        for (int p = 0; p < MT; ++p) w[p] = 0x88888888u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int slot = static_cast<signed char>(sos[i] & 0xFF);
          if (slot < 0) continue;
          int bin;
          if constexpr (kA == Ablate::kBins)
            bin = ablate_bin(
                Rec::row(s_rec[(j % kRecRing) * kC + 4 * q4 + i]), f, W);
          else
            bin = src.bin(Src::at(xrow(j, 4 * q4 + i, sos[i] >> 8), f),
                          slot ? lo1 : lo0, slot ? inv1 : inv0);
          if (static_cast<unsigned>(bin) < static_cast<unsigned>(W)) {
            const unsigned d = static_cast<unsigned>((bin & 7) ^ 8)
                               << ((bin & 8) * 2 + 4 * i);
#pragma unroll
            for (int p = 0; p < MT; ++p)
              if (p == (bin >> 4)) w[p] ^= d;
          }
        }
        unsigned* dst = ssel + f * sstride + q4;
#pragma unroll
        for (int p = 0; p < MT; ++p) dst[p * kI8Quads] = w[p];
      }
    };
#pragma unroll
    for (int i = 0; i < kI8Items; ++i)
      if (qf[i] >= 0) put(qf[i] >> 10, qf[i] & 1023);
    for (int it = threadIdx.x + kI8Items * kGrpThreads; it < nitem;
         it += kGrpThreads)
      put(it / fper, fi0 + it % fper);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int units = F * MT;
  const int ubase = blockIdx.y * (kGrpWarps * U) + warp;  // + i * warps
  int acc[U][NT][4];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
  unsigned fold = 0u;  // kAdds: the products' operands
  // this lane's one-hot table: byte g8 of {thi, tlo} is 1
  const unsigned tlo = g8 < 4 ? 1u << (8 * g8) : 0u;
  const unsigned thi = g8 < 4 ? 0u : 1u << (8 * (g8 - 4));

  // (3) the products of chunk j: per k-step, every unit's selector words
  // first, then its four PRMTs and mmas (the units' mmas interleave)
  auto accumulate = [&](int j) {
    const uint2* frag =
        reinterpret_cast<const uint2*>(s_w + (j % kStageBufs) * kWords);
    const unsigned* ssel = s_sel + (j & 1) * F * sstride;
#pragma unroll
    for (int ks = 0; ks < kI8Steps; ++ks) {
      uint2 fb[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) fb[n] = frag[(ks * NT + n) * 32 + lane];
      // rows 32 ks + 4 t4 .. + 3 and 16 rows further, of each unit
      unsigned wa[U], wb[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = ubase + i * kGrpWarps;
        wa[i] = wb[i] = 0u;
        if (u < units) {
          const int f = u / MT, mt = u - f * MT;
          const unsigned* sp = ssel + f * sstride + mt * kI8Quads + ks * 8;
          wa[i] = sp[t4];
          wb[i] = sp[4 + t4];
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (ubase + i * kGrpWarps >= units) continue;
        const unsigned a[4] = {onehot4(wa[i], tlo, thi),
                               onehot4(wa[i] >> 16, tlo, thi),
                               onehot4(wb[i], tlo, thi),
                               onehot4(wb[i] >> 16, tlo, thi)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const unsigned bb2[2] = {fb[n].x, fb[n].y};
          if constexpr (kA == Ablate::kAdds)
            fold ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ bb2[0] ^ bb2[1];
          else
            mma_s8(acc[i][n], a, bb2);
        }
      }
    }
  };

  // the pipeline: at chunk j, bins(j) and stage(j + 1) (their records and
  // rows landed two barriers ago), the copies of rows j + 3 and records
  // j + 5, one barrier, the products of j
  const bool stager = threadIdx.x < kC;
  const int nch = static_cast<int>((i1 - i0 + kC - 1) / kC);
  for (int j = 0; j < kRecAhead; ++j) issue_recs(j);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // records 0..4, ranges
  for (int j = 0; j < kXAhead; ++j) issue_x(j);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // rows 0..2
  if (stager) stage(0);
  __syncthreads();
  for (int j = 0; j < nch; ++j) {
    bins(j);
    if (stager && j + 1 < nch) stage(j + 1);
    issue_x(j + kXAhead);
    issue_recs(j + kRecAhead);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of the previous chunk
    __syncthreads();
    accumulate(j);
  }

  if constexpr (kA == Ablate::kAdds) sink_fold(fold);
  // the block's partial into its slot: part[b][planes][2][F][W]
  int* pb = part + static_cast<int64_t>(b) * 6 * NT * F * W;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = ubase + i * kGrpWarps;
    if (u >= units) continue;
    const int f = u / MT, mt = u - f * MT;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 2 * t4 + (e & 1);
      if (col >= 6) continue;
      const int bin = mt * 16 + g8 + (e >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        pb[(((col % 3) * NT + n) * 2 + col / 3) * F * W + f * W + bin] =
            acc[i][n][e];
    }
  }
}

// The grouped level's kernel: the float body or the int8 body by the mass
// policy; kA a phase knock-out (level_common.cuh), kNone in production.
template <class Src, class Mass, Ablate kA = Ablate::kNone>
__global__ void __launch_bounds__(kGrpThreads, Mass::NT == 1 ? 2 : 1)
level_grouped_kernel(Src src, const typename Mass::Rec::T* __restrict__ rec,
                     const int* __restrict__ offsets,
                     const int* __restrict__ bstart, int G, int64_t span,
                     int F, int n_prev, int n_nodes, int level_base,
                     int bf16, int* __restrict__ nid_out,
                     typename Mass::Part* __restrict__ part) {
  if constexpr (Mass::kInt)
    grouped_i8_body<Src, Mass::NT, kA>(src, rec, offsets, bstart, G, span,
                                       F, n_prev, n_nodes, level_base,
                                       nid_out, part);
  else
    grouped_float_body<Src, Mass::NT, Mass::kMma, kA>(
        src, rec, offsets, bstart, G, span, F, n_prev, n_nodes, level_base,
        bf16, nid_out, part);
}

// The sources of partial cell i ([planes, n_nodes, F, W]) in the blocks'
// [planes][2][F][W] partials: the parent's group at the cell's side, then
// the node's direct group.
struct GroupedSrc {
  int n_nodes, n_prev, level_base;
  int64_t fw;  // F * W
  __device__ __forceinline__ int operator()(int64_t i, int* g,
                                            int64_t* o) const {
    const int c = static_cast<int>(i / (n_nodes * fw));
    const int64_t rem = i - c * n_nodes * fw;
    const int j = static_cast<int>(rem / fw);
    const int64_t within = rem - j * fw;
    int ns = 0;
    const int cid = level_base + j;
    if (n_prev > 0 && cid >= 1) {
      const int lp = ((cid - 1) >> 1) - (level_base - n_prev);
      if (lp >= 0 && lp < n_prev) {
        g[ns] = lp;
        o[ns++] = (2 * c + ((cid - 1) & 1)) * fw + within;
      }
    }
    g[ns] = n_prev + j;
    o[ns++] = 2 * c * fw + within;
    return ns;
  }
};

// How the grouped level runs at these shapes: groups, passes, the span
// of rows a block owns, the blocks, shared memory and workspace bytes.
struct GroupedPlan {
  int G, passes;
  int64_t span, nblk;
  size_t smem, bytes;
};

// Whether the grouped level takes these shapes: F up to kMaxGroupedF, at
// most kMaxGroups groups, rows within an int.
inline bool grouped_fits(int64_t rows, int F, int n_prev, int n_nodes) {
  return F >= 1 && F <= kMaxGroupedF && n_prev + n_nodes <= kMaxGroups &&
         rows < (int64_t{1} << 31);
}

// Shared bytes of a block of the grouped body for a bin source and mass.
template <class Src, class Mass>
size_t grouped_smem_of(int F) {
  if constexpr (Mass::kInt)
    return grouped_i8_smem(F, Src::kW, Mass::NT, Src::kBytes, Src::kRanges);
  else
    return grouped_smem(F, Src::kW, Mass::NT, Mass::kMma, Src::kRanges);
}

// The most shared memory a block can use (227 KB): the int8 body's staged
// rows of a wide frame and the selectors of a wide W are not within it.
constexpr size_t kMaxBlockSmem = 232448;

// A knock-out (kA) takes the production instance's plan: its span and
// blocks come from that instance's occupancy.
template <class Src, class Mass, Ablate kA = Ablate::kNone>
int plan_grouped(int64_t rows, int F, int n_prev, int n_nodes,
                 GroupedPlan* p) {
  constexpr int W = Src::kW;
  constexpr int kUnits =
      Mass::kInt ? kI8Units : GroupedShape<Mass::NT, Mass::kMma>::kUnits;
  constexpr int kC = Mass::kInt ? kI8Chunk : kChunk;
  p->G = n_prev + n_nodes;
  p->smem = grouped_smem_of<Src, Mass>(F);
  if (!grouped_fits(rows, F, n_prev, n_nodes) || p->smem > kMaxBlockSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = F * (W / 16);
  // the ablation's atomics take every unit in one pass
  p->passes = Mass::kMma ? (units + kGrpWarps * kUnits - 1) /
                               (kGrpWarps * kUnits)
                         : 1;
  auto kern = level_grouped_kernel<Src, Mass>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kA != Ablate::kNone) {
    err = cudaFuncSetAttribute(level_grouped_kernel<Src, Mass, kA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p->smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kGrpThreads, p->smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // about two waves of blocks over the card, in whole chunks
  int64_t target = static_cast<int64_t>(sm_count()) * per_sm * 2 /
                   p->passes;
  if (target < 1) target = 1;
  int64_t span = (rows + target - 1) / target;
  span = (span + kC - 1) / kC * kC;
  p->span = span < kC ? kC : span;
  p->nblk = span_blocks(rows, p->G, p->span);
  p->bytes = grouping_bytes(rows, p->G, sizeof(typename Mass::Rec::T)) +
             align256(sizeof(typename Mass::Part) * 2 * Mass::kPlanes *
                      static_cast<size_t>(F) * W * p->nblk);
  return 0;
}

// The grouped level: grouping (masses: the mass policy's record source,
// GhwRec or QRec), histogram blocks, then the merge of their partials
// with the epilogue epi over the 3 * n_nodes * F * W cells of hist
// (MergeAdd: ADDS into the float levels' hist; MergeFlushI8: writes the
// int8 levels' float32 hist). Writes nid_out; ws holds plan_grouped's
// bytes.
template <class Src, class Mass, class Epi, Ablate kA = Ablate::kNone>
int launch_grouped(const Src& src, const int* nid,
                   typename Mass::Rec masses, int64_t rows, int F,
                   int n_prev, int n_nodes, int level_base, int bf16,
                   int* nid_out, Epi epi, void* ws, cudaStream_t stream) {
  using Part = typename Mass::Part;
  using RecT = typename Mass::Rec::T;
  GroupedPlan p;
  int rc = plan_grouped<Src, Mass, kA>(rows, F, n_prev, n_nodes, &p);
  if (rc != 0) return rc;
  Grouping g;
  Part* part = reinterpret_cast<Part*>(carve_grouping(
      static_cast<char*>(ws), rows, p.G, &g, sizeof(RecT)));
  const ParentKey<Src> key{nid, src, n_prev, level_base - n_prev,
                           level_base, n_nodes, nid_out};
  rc = launch_grouping(key, masses, rows, p.G, p.span, g, stream);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(p.nblk), static_cast<unsigned>(p.passes));
  level_grouped_kernel<Src, Mass, kA>
      <<<grid, kGrpThreads, p.smem, stream>>>(
      src, static_cast<const RecT*>(g.rec), g.offsets, g.bstart, p.G,
      p.span, F, n_prev, n_nodes, level_base, bf16, nid_out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fw = static_cast<int64_t>(F) * Src::kW;
  return launch_merge(GroupedSrc{n_nodes, n_prev, level_base, fw}, part,
                      2 * Mass::kPlanes * fw, g.bstart, 3 * n_nodes * fw,
                      epi, stream);
}

}  // namespace h2o3
