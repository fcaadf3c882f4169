// The node-grouped level on the tensor cores, shared by the float [rows, F]
// adaptive level (K8, hist_adaptive.cu) and the float packed-code level
// (K1/K3, hist_binned.cu): rows grouped by parent (ParentKey and the
// grouping pass of level_common.cuh), then one block per span of a group's
// rows with both children and all F features, then a merge of the blocks'
// partials in a fixed order (merge_slots_kernel).
//
// The two kernels differ only in where a (row, feature)'s bin comes from,
// a bin-source policy Src:
//
//   static constexpr int kW;            lanes (bins) a feature, NA = kW - 1
//   static constexpr bool kRanges;      bins need the child's (lo, inv)
//   using Val;                          what a (row, feature) holds
//   const float *lo, *inv;              [n_nodes, F] where kRanges
//   Val load(int64_t r, int f, int F)   x[r, f] or codes[r, f]
//   bool can(int lp, int n_prev)        parent lp of the window splits
//   void split(k, n_prev, F, &feat, &thr, &na_right)   parent k's split
//   int right(Val v, Val thr, int na_right)            the routing rule
//   int bin(Val v, float lo, float inv) in [0, kW), or any other value
//                                       (the row adds nothing there)
//
// AdaptiveBins (raw float32 x re-binned under the child's range) and
// CodeBins (int8 / int16 packed codes: the code is the bin) live beside
// their launchers.
//
// The histogram is the TPU kernels' one-hot contraction made narrow by the
// grouping: per 16 rows, (bin one-hot, 16 bins x 16 rows) x (16 rows x
// (g, h, w) of each child), with mma.sync m16n8k16 bf16 -> f32. The products
// are exact: at bf16 every mass is a bf16 value; at float32 each mass is
// split into three bf16 terms as the JAX package's _split3_bf16 does (hi,
// then the residuals pre-scaled by 2^8 and 2^16) and the three sums are
// recombined as its _unsplit3 does. Each block writes its partial into its
// own slot, and the merge adds the slots in a fixed order: there are no
// float atomics in the level, so the same inputs give the same bits.
//
// What bounds it in practice is instruction issue: the bins (one per row
// and feature), the one-hot fragments (one bf16x2 compare per two
// elements) and one barrier a 64-row chunk; the staging of the next chunk
// (records, split values, x or codes) is prefetched into registers while
// the current chunk's products run.
#pragma once

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

// One block: the span of group k's records that block b owns (k from
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
template <class Src, int NT, bool kMma>
__global__ void __launch_bounds__(kGrpThreads, NT == 1 ? 2 : 1)
level_grouped_kernel(Src src, const float4* __restrict__ rec,
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
        side = src.right(v, thr, na_right);
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
      if (rf[q] >= 0) {
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
        if (slot >= 0) {
          lo = s_lo[slot * F + f];
          inv = s_inv[slot * F + f];
        }
      }
      const int bin = slot >= 0 ? src.bin(v, lo, inv) : 0;
      sbin[f * kBinStride + row] = static_cast<uint16_t>(
          __float_as_uint(static_cast<float>(bin)) >> 16);
    };
#pragma unroll
    for (int q = 0; q < kXPer; ++q)
      if (rf[q] >= 0) put(rf[q] >> 10, rf[q] & 1023, xv[q]);
    for (int j = threadIdx.x + kXPer * kGrpThreads; j < nbin;
         j += kGrpThreads) {
      const int row = j / F, f = j - row * F;
      const Val v = s_slot[sb * kChunk + row] >= 0
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
    return stager && parent && c + t < i1
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

// The sources of hist cell i ([3, n_nodes, F, W]) in the blocks'
// [3][2][F][W] partials: the parent's group at the cell's side, then the
// node's direct group.
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

template <class Src, int NT, bool kMma>
int plan_grouped(int64_t rows, int F, int n_prev, int n_nodes,
                 GroupedPlan* p) {
  using Shape = GroupedShape<NT, kMma>;
  constexpr int W = Src::kW;
  p->G = n_prev + n_nodes;
  if (!grouped_fits(rows, F, n_prev, n_nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = F * (W / 16);
  // the ablation's atomics take every unit in one pass
  p->passes = kMma ? (units + kGrpWarps * Shape::kUnits - 1) /
                         (kGrpWarps * Shape::kUnits)
                   : 1;
  p->smem = grouped_smem(F, W, NT, kMma, Src::kRanges);
  auto kern = level_grouped_kernel<Src, NT, kMma>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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
  span = (span + kChunk - 1) / kChunk * kChunk;
  p->span = span < kChunk ? kChunk : span;
  p->nblk = span_blocks(rows, p->G, p->span);
  p->bytes = grouping_bytes(rows, p->G) +
             align256(sizeof(float) * 6 * static_cast<size_t>(F) * W *
                      p->nblk);
  return 0;
}

// The grouped level: grouping, histogram blocks, merge. Writes nid_out
// and ADDS into hist [3, n_nodes, F, W]; ws holds plan_grouped's bytes.
template <class Src, int NT, bool kMma>
int launch_grouped(const Src& src, const int* nid, const float* ghw,
                   int64_t rows, int F, int n_prev, int n_nodes,
                   int level_base, int bf16, int* nid_out, float* hist,
                   void* ws, cudaStream_t stream) {
  GroupedPlan p;
  int rc = plan_grouped<Src, NT, kMma>(rows, F, n_prev, n_nodes, &p);
  if (rc != 0) return rc;
  Grouping g;
  float* part = reinterpret_cast<float*>(
      carve_grouping(static_cast<char*>(ws), rows, p.G, &g));
  const ParentKey<Src> key{nid, src, n_prev, level_base - n_prev,
                           level_base, n_nodes, nid_out};
  rc = launch_grouping(key, ghw, rows, p.G, p.span, g, stream);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(p.nblk), static_cast<unsigned>(p.passes));
  level_grouped_kernel<Src, NT, kMma><<<grid, kGrpThreads, p.smem, stream>>>(
      src, g.rec, g.offsets, g.bstart, p.G, p.span, F, n_prev, n_nodes,
      level_base, bf16, nid_out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fw = static_cast<int64_t>(F) * Src::kW;
  return launch_merge(GroupedSrc{n_nodes, n_prev, level_base, fw}, part,
                      6 * fw, g.bstart, 3 * n_nodes * fw, hist, stream);
}

}  // namespace h2o3
