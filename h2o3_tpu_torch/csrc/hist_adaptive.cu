// Adaptive-bin GBM level kernels for Hopper (sm_90a), plain C interface:
// H2O's UniformAdaptive histogram, re-binned per (node, feature) at every
// level over raw float32 features (NaN = NA).
//
// adaptive_level replaces h2o3_tpu/ops/hist_adaptive.py:_kernel (K8, the
// [rows, F] layout, the one the training path uses) and _kernel_t (K5,
// [F, rows]). One level: each row steps through the previous level's split
// tables by a raw-threshold compare, writes its new node id, and, when
// that node lies in the level's window, bins every feature under the
// node's range, b = floor(clip((x - lo) * inv, 0, W-2)) with NaN in lane
// W-1, and adds its (g, h, w) into the (node, feature, bin) cell.
//
// K8 with float masses is node-grouped: the grouping pass of
// level_common.cuh writes the rows of each parent (in the previous window,
// can > 0.5) into one contiguous, stably ordered list of {row, g, h, w}
// records, and a block owns a span of one parent's records, both children
// and all F features, so its partial ([3][2][F][W]) needs no node or
// feature tiles and no row is read by two blocks. The histogram is the TPU
// kernel's one-hot contraction made narrow by the grouping: per 16 rows,
// (bin one-hot, 16 bins x 16 rows) x (16 rows x (g, h, w) of each child),
// with mma.sync m16n8k16 bf16 -> f32 on the tensor cores. The products are
// exact: at bf16 every mass is a bf16 value; at float32 each mass is split
// into three bf16 terms as the JAX package's _split3_bf16 does (hi, then
// the residuals pre-scaled by 2^8 and 2^16) and the three sums are
// recombined as its _unsplit3 does. Each block writes its partial into its
// own slot and a second pass adds the slots in a fixed order: there are no
// float atomics in the level, so the same inputs give the same bits.
// This replaced (an earlier port of K8) a scatter into per-block shared
// partials with shared float atomics, a compare-and-swap loop on Hopper,
// three a (row, feature), over node x feature tiles that each re-read
// every row: 2.03-3.78 ms a level at 10M x 28, W = 32, on an H100.
// adaptive_level_atomics runs the grouped kernel with shared float atomics
// in place of the products, the ablation it was measured against. K5 (no
// path trains in [F, rows]) and levels past kMaxGroups groups keep the
// tiled body, adaptive_level_kernel.
//
// adaptive_level_i8 replaces _kernel_t_i8 (K7): the same level with the
// int8 fixed-point masses of quantize_ghw_i8 (H2O3_HIST_I8), as the
// integer-mass instance (kTerms = 1 or 2) of the same kernel, in both
// layouts (the TPU kernel exists only in [F, rows]; the port trains in
// [rows, F]). Staging, int32 shared partial with native integer atomics,
// int32 merge and float32 flush as binned_level_i8 (hist_binned.cu); the
// histogram is bit-equal to the plain version.
//
// adaptive_route_only replaces _route_kernel_t (K6) and _route_kernel
// (K9): the deepest level's route, one thread per row, no histogram.
//
// leaf_totals replaces _totals_kernel (K10): route one level of x
// [rows, F] (none when n_prev is 0), then sum float32 (g, h, w) per node
// of the window into totals [3, n_nodes]. No grower calls it, in either
// package. What bounds it: memory, rows * 24 bytes (nid in and out, ghw,
// one x value a row); 3 adds a row. Design: one thread per row; each warp
// sums the lanes of each node with 32 shuffles (the same lane order for
// every key) and its lowest lane of the node adds the sums into the
// block's [3, n_nodes] shared totals; each block then adds its nonzero
// totals into the output with global float atomics. Float sums in another
// order than the plain version's: held within 1e-4 + 1e-5 x |mass| of a
// float64 plain version, as the other float checks are.
//
// Routing rule (both kernels, and the plain versions in
// ops/hist_adaptive.py): tables are float32 [4, n_prev] (feat, thr,
// na_left, can). A row in the previous level's window whose node has
// can > 0.5 reads x = x[row, feat]; NaN goes right unless na_left > 0.5,
// any other value goes right when x >= thr; the child is 2*nid + 1 + right.
//
// Numerics held to the plain version bit for bit: (x - lo) * inv is two
// IEEE-rounded operations (__fsub_rn, __fmul_rn), never a contracted or
// approximate form; fminf/fmaxf return the non-NaN operand, so NaN x is
// tested before the clip. On a zero-span node inv is 0 and an infinite x
// gives (±inf - lo) * 0 = NaN: that row takes bin 0, as the JAX package's
// CPU reference does (its astype(int32) of NaN; the TPU kernel's one-hot
// drops such a row instead).
//
// What bounds them on an H100: memory, on paper. adaptive_level reads
// rows * (F * 4 + 16) bytes and writes rows * 4 plus the histogram; its
// float work (a subtract, a multiply and 3 adds per row and feature) is
// far below the 67 TFLOP/s f32 rate, and the grouped form's one-hot
// products (2 * 16 * W * 8 per 16 rows and feature, 2 * W * F * 16 per
// row at bf16, three times that at float32) far below the 989 TFLOP/s
// bf16 rate. What bounds the grouped form in practice is instruction
// issue: the bins (one per row and feature), the one-hot fragments (one
// bf16x2 compare per two elements) and one barrier a 64-row chunk; the
// staging of the next chunk (records, split values, x) is prefetched
// into registers while the current chunk's products run.
// adaptive_route_only moves rows * 12 bytes; adaptive_level_i8 reads
// 3 * terms in place of 12 bytes of mass a row. The tiled body (K5, and
// K7's integer instances), as binned_level's in hist_binned.cu: a block
// takes 512 rows at a time; phase 1 routes them (one thread per row) and
// stages node id and masses in shared memory; phase 2 walks the chunk's
// features in the layout's own order (consecutive threads on consecutive
// addresses: along a row in [rows, F], along a feature in [F, rows]),
// bins each value under the (node, feature) range staged in shared memory
// for the block's tile, and adds into a per-block histogram in shared
// memory at a stride of W + 1 words per feature. Blocks merge their
// partials with global atomics; node x feature tiles keep a partial within
// the shared budget (level_common.cuh). Its shared-memory float atomic
// adds are compare-and-swap loops on Hopper (ATOMS.CAST.SPIN); the int8
// instances' integer adds are native.

#include <math.h>

#include "level_common.cuh"

namespace {

using h2o3::kThreads;

// x[r, f] in [rows, F] (kFeatMajor false) or [F, rows] (true).
template <bool kFeatMajor>
__device__ __forceinline__ float load_x(const float* __restrict__ x,
                                        int64_t r, int f, int64_t rows,
                                        int F) {
  return kFeatMajor ? x[static_cast<int64_t>(f) * rows + r] : x[r * F + f];
}

template <bool kFeatMajor>
__device__ __forceinline__ int route_row(const float* __restrict__ x,
                                         int64_t r, int64_t rows, int F,
                                         int nid,
                                         const float* __restrict__ tables,
                                         int n_prev, int prev_base) {
  const int lp = nid - prev_base;
  if (lp < 0 || lp >= n_prev) return nid;
  if (!(__ldg(tables + 3 * n_prev + lp) > 0.5f)) return nid;
  int f = static_cast<int>(__ldg(tables + lp));
  f = f < 0 ? 0 : (f >= F ? F - 1 : f);
  const float v = load_x<kFeatMajor>(x, r, f, rows, F);
  const int right = isnan(v) ? (__ldg(tables + 2 * n_prev + lp) < 0.5f)
                             : (v >= __ldg(tables + n_prev + lp));
  return 2 * nid + 1 + right;
}

template <int W>
__device__ __forceinline__ int adaptive_bin(float v, float lo, float inv) {
  if (isnan(v)) return W - 1;  // NA lane
  const float t = __fmul_rn(__fsub_rn(v, lo), inv);
  if (isnan(t)) return 0;      // infinite x on a zero-span node
  return static_cast<int>(
      floorf(fminf(fmaxf(t, 0.f), static_cast<float>(W - 2))));
}

template <int W, bool kFeatMajor, int kTerms>
__global__ void __launch_bounds__(kThreads)
adaptive_level_kernel(const float* __restrict__ x,
                      const int* __restrict__ nid_in,
                      const typename h2o3::LevelMass<kTerms>::In* mass,
                      const float* __restrict__ tables,
                      const float* __restrict__ lo,
                      const float* __restrict__ inv, int64_t rows, int F,
                      int n_prev, int n_nodes, int level_base, int node_tile,
                      int feat_tile, int n_feat_tiles, int bf16,
                      int* __restrict__ nid_out,
                      typename h2o3::LevelMass<kTerms>::Acc* __restrict__
                          hist) {
  using M = h2o3::LevelMass<kTerms>;
  using Acc = typename M::Acc;
  using Stage = typename M::Stage;
  constexpr int P = M::kPlanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.y;
  const int n0 = (tile / n_feat_tiles) * node_tile;
  const int f0 = (tile % n_feat_tiles) * feat_tile;
  const int nt = min(node_tile, n_nodes - n0);
  const int ft = min(feat_tile, F - f0);
  constexpr int WP = W + 1;
  const int cells = node_tile * feat_tile * WP;  // per plane
  const int ranges = node_tile * feat_tile;
  // [P][node_tile][feat_tile][WP]
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);
  float* s_lo = reinterpret_cast<float*>(s_hist + P * cells);
  float* s_inv = s_lo + ranges;                  // [node_tile][feat_tile]
  int* s_lid = reinterpret_cast<int*>(s_inv + ranges);
  Stage* s_m = reinterpret_cast<Stage*>(s_lid + kThreads);  // [P][kThreads]

  for (int i = threadIdx.x; i < P * cells; i += blockDim.x) s_hist[i] = 0;
  for (int i = threadIdx.x; i < ranges; i += blockDim.x) {
    const int ln = i / feat_tile;
    const int fl = i - ln * feat_tile;
    float l = 0.f, v = 0.f;
    if (ln < nt && fl < ft) {
      const int64_t o = static_cast<int64_t>(n0 + ln) * F + (f0 + fl);
      l = lo[o];
      v = inv[o];
    }
    s_lo[i] = l;
    s_inv[i] = v;
  }

  const int prev_base = level_base - n_prev;
  const int64_t n_chunks = (rows + kThreads - 1) / kThreads;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * kThreads;
    const int nr = (rows - r0) < kThreads ? static_cast<int>(rows - r0)
                                          : kThreads;
    __syncthreads();  // staging done / previous chunk's phase 2 done
    if (threadIdx.x < nr) {
      const int64_t r = r0 + threadIdx.x;
      int nid = nid_in[r];
      if (n_prev > 0)
        nid = route_row<kFeatMajor>(x, r, rows, F, nid, tables, n_prev,
                                    prev_base);
      if (tile == 0) nid_out[r] = nid;
      const int ln = nid - level_base;
      s_lid[threadIdx.x] = (ln >= n0 && ln < n0 + nt) ? ln - n0 : -1;
#pragma unroll
      for (int p = 0; p < P; ++p)
        s_m[p * kThreads + threadIdx.x] = M::load(mass, rows, r, p, bf16);
    }
    __syncthreads();
    const int work = nr * ft;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      int rr, fl;
      if (kFeatMajor) {
        fl = i / nr;
        rr = i - fl * nr;
      } else {
        rr = i / ft;
        fl = i - rr * ft;
      }
      const int ln = s_lid[rr];
      if (ln < 0) continue;
      const int k = ln * feat_tile + fl;
      const float v = load_x<kFeatMajor>(x, r0 + rr, f0 + fl, rows, F);
      const int cell = k * WP + adaptive_bin<W>(v, s_lo[k], s_inv[k]);
#pragma unroll
      for (int p = 0; p < P; ++p)
        M::add(s_hist + p * cells + cell, s_m[p * kThreads + rr]);
    }
  }
  __syncthreads();
  h2o3::merge_partial(s_hist, P, cells, WP, W, node_tile, feat_tile, n0, f0,
                      nt, ft, n_nodes, F, hist);
}

// ------------------------------------------- the node-grouped float level
//
// The float [rows, F] level (K8): rows grouped by parent (ParentKey), then
// one block per span of a group's rows, then a merge of the blocks'
// partials in a fixed order (level_common.cuh).

constexpr int kGrpThreads = 512;
constexpr int kGrpWarps = kGrpThreads / 32;
constexpr int kChunk = 64;                  // rows staged at a time
constexpr int kSteps = kChunk / 16;         // mma k-steps a chunk
constexpr int kBinStride = kChunk + 2;      // bf16 bins a feature: 33 words
constexpr int kStageBufs = 3;               // row ids, slots, masses
constexpr int kXPer = 4;                    // x values a thread prefetches
// largest F the grouped level takes (its bins, ranges and row ids)
constexpr int kMaxGroupedF = 512;

// The grouping key of a row of the level: its parent's index in the
// previous window when it is routed (can > 0.5); a row that keeps its node
// id and lies in the level's window (level 0: the root) n_prev + its
// level-local node; any other row is left out. Rows that are not routed
// keep their node id (tag writes it); the histogram kernel routes the
// others and writes theirs.
struct ParentKey {
  const int* __restrict__ nid;
  const float* __restrict__ tables;
  int n_prev, prev_base, level_base, n_nodes;
  int* __restrict__ nid_out;
  __device__ __forceinline__ int operator()(int64_t r) const {
    const int id = nid[r];
    const int lp = id - prev_base;
    if (n_prev > 0 && lp >= 0 && lp < n_prev &&
        __ldg(tables + 3 * n_prev + lp) > 0.5f)
      return lp;
    const int ln = id - level_base;
    return (ln >= 0 && ln < n_nodes) ? n_prev + ln : -1;
  }
  __device__ __forceinline__ int tag(int64_t r, int k) const {
    if (k < 0 || k >= n_prev) nid_out[r] = nid[r];
    return static_cast<int>(r);
  }
};

// Two bf16-valued floats as one bf16x2 register (exact: their low 16 bits
// are zero), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

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
  *hi = h2o3::round_bf16(t);
  const float r1 = __fmul_rn(__fsub_rn(t, *hi), 256.f);
  *mid = h2o3::round_bf16(r1);
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

inline size_t grouped_smem(int F, int W, int NT, bool mma) {
  const int words = mma ? kSteps * NT * 64 : 3 * kChunk;
  size_t b = 2 * sizeof(uint16_t) * static_cast<size_t>(F) * kBinStride +
             sizeof(unsigned) * kStageBufs * words +
             2 * sizeof(int) * kStageBufs * kChunk +
             4 * sizeof(float) * static_cast<size_t>(F);
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
// (2) bins: every (row, feature) once under the child's (lo, inv), as a
//     bf16 integer (two buffers); the x values are loaded into registers
//     while the previous chunk's products run;
// (3) kMma: each warp adds its units' one-hot products with mma.sync
//     m16n8k16 (A: the bin one-hot, 16 bins x 16 rows, built in registers
//     with bf16x2 compares; B: 16 rows x 8 columns, (g, h, w) of slot 0
//     and of slot 1, two columns empty; one B per term), the chunk's four
//     k-steps chained in the tensor core, then added into float32
//     registers; else (the ablation): shared float atomics into a
//     [3][2][F][W + 1] partial.
// The block writes its partial, [3][2][F][W], into its own slot of part.
template <int W, int NT, bool kMma>
__global__ void __launch_bounds__(kGrpThreads, NT == 1 ? 2 : 1)
adaptive_level_grouped_kernel(
    const float* __restrict__ x, const float* __restrict__ tables,
    const float* __restrict__ lo, const float* __restrict__ inv,
    const float4* __restrict__ rec, const int* __restrict__ offsets,
    const int* __restrict__ bstart, int G, int64_t span, int F, int n_prev,
    int n_nodes, int level_base, int bf16, int* __restrict__ nid_out,
    float* __restrict__ part) {
  using Shape = GroupedShape<NT, kMma>;
  constexpr int MT = W / 16;
  constexpr int U = Shape::kUnits;
  constexpr int kWords = kMma ? Shape::kFragWords : Shape::kMassWords;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  if (b >= __ldg(bstart + G)) return;
  const int k = h2o3::span_group(bstart, G, b);
  const int64_t i0 = __ldg(offsets + k) +
                     static_cast<int64_t>(b - __ldg(bstart + k)) * span;
  const int64_t i1 = h2o3::imin64(__ldg(offsets + k + 1), i0 + span);
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
  float* s_hist = s_inv + 2 * F;  // ablation: [3][2][F][W + 1]
  const int hplane = 2 * F * (W + 1);
  const int nbin = kChunk * F;

  for (int i = threadIdx.x; i < 2 * F; i += blockDim.x) {
    const int s = i / F, f = i - s * F;
    const int node = c0 + s;
    const bool ok = (parent || s == 0) && node >= 0 && node < n_nodes;
    const int64_t o = static_cast<int64_t>(ok ? node : 0) * F + f;
    s_lo[i] = ok ? lo[o] : 0.f;
    s_inv[i] = ok ? inv[o] : 0.f;
  }
  if (!kMma)
    for (int i = threadIdx.x; i < 3 * hplane; i += blockDim.x) s_hist[i] = 0.f;
  int feat = 0;
  float thr = 0.f;
  int na_right = 0;
  if (parent) {
    feat = static_cast<int>(__ldg(tables + k));
    feat = feat < 0 ? 0 : (feat >= F ? F - 1 : feat);
    thr = __ldg(tables + n_prev + k);
    na_right = __ldg(tables + 2 * n_prev + k) < 0.5f;
  }

  // (1) the record of row t of chunk c (t = threadIdx.x < kChunk), its
  // split value v, into stage buffer sb
  auto stage = [&](int64_t c, int sb, const float4& q, float v) {
    const int t = threadIdx.x;
    int slot = -1, r = 0;
    float m[3] = {0.f, 0.f, 0.f};
    if (c + t < i1) {
      r = __float_as_int(q.x);
      int side = 0;
      if (parent) {
        side = isnan(v) ? na_right : (v >= thr);
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
            term[p] = h2o3::round_bf16(m[p]);
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
        sm[p * kChunk + t] = bf16 ? h2o3::round_bf16(m[p]) : m[p];
    }
  };
  // this thread's (row, feature)s of a chunk, as row * 1024 + feature
  int rf[kXPer];
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    const int j = threadIdx.x + q * kGrpThreads;
    rf[q] = j < nbin ? (j / F) * 1024 + (j % F) : -1;
  }
  // their x values
  float xv[kXPer];
  auto load_x = [&](int sb) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      xv[q] = 0.f;
      if (rf[q] >= 0) {
        const int row = rf[q] >> 10;
        if (s_slot[sb * kChunk + row] >= 0)
          xv[q] = x[static_cast<int64_t>(s_r[sb * kChunk + row]) * F +
                    (rf[q] & 1023)];
      }
    }
  };
  // (2) bins of stage buffer sb into bin buffer bb, each as a bf16
  // integer (exact: bins < 256); x from xv, past it from memory
  auto bins = [&](int sb, int bb) {
    uint16_t* sbin = s_bin + bb * F * kBinStride;
    auto put = [&](int row, int f, float v) {
      const int slot = s_slot[sb * kChunk + row];
      const int bin = slot >= 0 ? adaptive_bin<W>(v, s_lo[slot * F + f],
                                                  s_inv[slot * F + f])
                                : 0;
      sbin[f * kBinStride + row] = static_cast<uint16_t>(
          __float_as_uint(static_cast<float>(bin)) >> 16);
    };
#pragma unroll
    for (int q = 0; q < kXPer; ++q)
      if (rf[q] >= 0) put(rf[q] >> 10, rf[q] & 1023, xv[q]);
    for (int j = threadIdx.x + kXPer * kGrpThreads; j < nbin;
         j += kGrpThreads) {
      const int row = j / F, f = j - row * F;
      const float v =
          s_slot[sb * kChunk + row] >= 0
              ? x[static_cast<int64_t>(s_r[sb * kChunk + row]) * F + f]
              : 0.f;
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
        const int cell = (slot * F + f) * (W + 1) + bin;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          atomicAdd(s_hist + p * hplane + cell, sm[p * kChunk + row]);
      }
    }
  };

  // the pipeline: stage(c + 1) and the x loads of c + 1 overlap the
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
               ? x[static_cast<int64_t>(__float_as_int(q.x)) * F + feat]
               : 0.f;
  };
  float4 qa = fetch(i0);
  float va = split_value(i0, qa);
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
struct AdaptiveSrc {
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

template <int W, int NT, bool kMma>
int plan_grouped(int64_t rows, int F, int n_prev, int n_nodes,
                 GroupedPlan* p) {
  using Shape = GroupedShape<NT, kMma>;
  p->G = n_prev + n_nodes;
  if (F < 1 || F > kMaxGroupedF || p->G > h2o3::kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = F * (W / 16);
  // the ablation's atomics take every unit in one pass
  p->passes = kMma ? (units + kGrpWarps * Shape::kUnits - 1) /
                         (kGrpWarps * Shape::kUnits)
                   : 1;
  p->smem = grouped_smem(F, W, NT, kMma);
  auto kern = adaptive_level_grouped_kernel<W, NT, kMma>;
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
  int64_t target = static_cast<int64_t>(h2o3::sm_count()) * per_sm * 2 /
                   p->passes;
  if (target < 1) target = 1;
  int64_t span = (rows + target - 1) / target;
  span = (span + kChunk - 1) / kChunk * kChunk;
  p->span = span < kChunk ? kChunk : span;
  p->nblk = h2o3::span_blocks(rows, p->G, p->span);
  p->bytes = h2o3::grouping_bytes(rows, p->G) +
             h2o3::align256(sizeof(float) * 6 * static_cast<size_t>(F) * W *
                            p->nblk);
  return 0;
}

template <int W, int NT, bool kMma>
int launch_grouped(const float* x, const int* nid, const float* ghw,
                   const float* tables, const float* lo, const float* inv,
                   int64_t rows, int F, int n_prev, int n_nodes,
                   int level_base, int bf16, int* nid_out, float* hist,
                   void* ws, cudaStream_t stream) {
  GroupedPlan p;
  int rc = plan_grouped<W, NT, kMma>(rows, F, n_prev, n_nodes, &p);
  if (rc != 0) return rc;
  h2o3::Grouping g;
  float* part = reinterpret_cast<float*>(
      h2o3::carve_grouping(static_cast<char*>(ws), rows, p.G, &g));
  const ParentKey key{nid, tables, n_prev, level_base - n_prev, level_base,
                      n_nodes, nid_out};
  rc = h2o3::launch_grouping(key, ghw, rows, p.G, p.span, g, stream);
  if (rc != 0) return rc;
  dim3 grid(static_cast<unsigned>(p.nblk), static_cast<unsigned>(p.passes));
  adaptive_level_grouped_kernel<W, NT, kMma>
      <<<grid, kGrpThreads, p.smem, stream>>>(
          x, tables, lo, inv, g.rec, g.offsets, g.bstart, p.G, p.span, F,
          n_prev, n_nodes, level_base, bf16, nid_out, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fw = static_cast<int64_t>(F) * W;
  return h2o3::launch_merge(AdaptiveSrc{n_nodes, n_prev, level_base, fw},
                            part, 6 * fw, g.bstart, 3 * n_nodes * fw, hist,
                            stream);
}

// The grouped level's instance: W, then the terms of the mass split (one
// at bf16, three at float32) for the tensor-core form; kMma false is the
// shared-atomics ablation. plan: only the workspace bytes (ws unused).
template <bool kMma>
int grouped_w(int W, bool plan_only, size_t* bytes, const float* x,
              const int* nid, const float* ghw, const float* tables,
              const float* lo, const float* inv, int64_t rows, int F,
              int n_prev, int n_nodes, int level_base, int bf16,
              int* nid_out, float* hist, void* ws, cudaStream_t s) {
#define H2O3_GROUPED(WW, NT)                                                \
  do {                                                                      \
    if (plan_only) {                                                        \
      GroupedPlan p;                                                        \
      const int rc = plan_grouped<WW, NT, kMma>(rows, F, n_prev, n_nodes,   \
                                                &p);                        \
      *bytes = rc == 0 ? p.bytes : 0;                                       \
      return rc;                                                            \
    }                                                                       \
    return launch_grouped<WW, NT, kMma>(x, nid, ghw, tables, lo, inv, rows, \
                                        F, n_prev, n_nodes, level_base,     \
                                        bf16, nid_out, hist, ws, s);        \
  } while (0)
#define H2O3_GROUPED_W(WW)              \
  case WW:                              \
    if (!kMma || bf16) H2O3_GROUPED(WW, 1); \
    if constexpr (kMma) H2O3_GROUPED(WW, 3); \
    return static_cast<int>(cudaErrorInvalidValue);
  switch (W) {
    H2O3_GROUPED_W(16)
    H2O3_GROUPED_W(32)
    H2O3_GROUPED_W(64)
    H2O3_GROUPED_W(128)
    H2O3_GROUPED_W(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef H2O3_GROUPED_W
#undef H2O3_GROUPED
}

// Whether the float level takes the grouped form: the [rows, F] layout,
// F up to kMaxGroupedF, at most kMaxGroups groups, under 2^30 rows; the
// [F, rows] layout (K5, no path trains in it), deeper levels and wider
// frames keep the tiled body.
inline bool takes_grouped(int feat_major, long long rows, int F, int n_prev,
                          int n_nodes) {
  // a record carries 2 * row + side in an int
  return !feat_major && F <= kMaxGroupedF &&
         n_prev + n_nodes <= h2o3::kMaxGroups && rows < (1LL << 30);
}

template <bool kFeatMajor>
__global__ void __launch_bounds__(kThreads)
adaptive_route_only_kernel(const float* __restrict__ x,
                           const int* __restrict__ nid_in,
                           const float* __restrict__ tables, int64_t rows,
                           int F, int n_prev, int level_base,
                           int* __restrict__ nid_out) {
  const int prev_base = level_base - n_prev;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rows; r += step) {
    nid_out[r] = route_row<kFeatMajor>(x, r, rows, F, nid_in[r], tables,
                                       n_prev, prev_base);
  }
}

__global__ void __launch_bounds__(kThreads)
leaf_totals_kernel(const float* __restrict__ x,
                   const int* __restrict__ nid_in,
                   const float* __restrict__ ghw,
                   const float* __restrict__ tables, int64_t rows, int F,
                   int n_prev, int n_nodes, int level_base,
                   int* __restrict__ nid_out, float* __restrict__ totals) {
  extern __shared__ float s_tot[];  // [3][n_nodes]
  for (int i = threadIdx.x; i < 3 * n_nodes; i += blockDim.x) s_tot[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int prev_base = level_base - n_prev;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // the loop bound is the same for every lane of a warp, so the shuffles
  // below always run on the full warp
  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    (threadIdx.x - lane);
       w0 < rows; w0 += step) {
    const int64_t r = w0 + lane;
    int key = -1;
    float g = 0.f, h = 0.f, w = 0.f;
    if (r < rows) {
      int nid = nid_in[r];
      if (n_prev > 0)
        nid = route_row<false>(x, r, rows, F, nid, tables, n_prev,
                               prev_base);
      nid_out[r] = nid;
      const int ln = nid - level_base;
      if (ln >= 0 && ln < n_nodes) {
        key = ln;
        g = ghw[r];
        h = ghw[rows + r];
        w = ghw[2 * rows + r];
      }
    }
    // each lane sums the lanes of its node in lane order
    float sg = 0.f, sh = 0.f, sw = 0.f;
    bool lowest = true;
    for (int src = 0; src < 32; ++src) {
      const int k = __shfl_sync(0xffffffffu, key, src);
      const float vg = __shfl_sync(0xffffffffu, g, src);
      const float vh = __shfl_sync(0xffffffffu, h, src);
      const float vw = __shfl_sync(0xffffffffu, w, src);
      if (k == key) {
        if (src < lane) lowest = false;
        sg += vg;
        sh += vh;
        sw += vw;
      }
    }
    if (key >= 0 && lowest) {  // the node's lowest lane
      atomicAdd(s_tot + key, sg);
      atomicAdd(s_tot + n_nodes + key, sh);
      atomicAdd(s_tot + 2 * n_nodes + key, sw);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * n_nodes; i += blockDim.x) {
    const float v = s_tot[i];
    if (v != 0.f) atomicAdd(totals + i, v);
  }
}

template <int W, bool kFeatMajor, int kTerms>
int launch_level(const float* x, const int* nid, const void* mass,
                 const float* tables, const float* lo, const float* inv,
                 int64_t rows, int F, int n_prev, int n_nodes,
                 int level_base, int bf16, int* nid_out, void* hist,
                 cudaStream_t stream) {
  using M = h2o3::LevelMass<kTerms>;
  // a (node, feature) holds P x (W + 1) partial bins and its lo/inv pair
  const int64_t per_cell =
      static_cast<int64_t>(M::kPlanes) * (W + 1) *
          static_cast<int64_t>(sizeof(typename M::Acc)) +
      2 * static_cast<int64_t>(sizeof(float));
  const h2o3::LevelTiles t = h2o3::level_tiles(n_nodes, F, per_cell);
  if (t.n_tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      static_cast<size_t>(per_cell) * t.node_tile * t.feat_tile +
      kThreads * (sizeof(int) + M::kPlanes * sizeof(typename M::Stage));
  auto kern = adaptive_level_kernel<W, kFeatMajor, kTerms>;
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
      x, nid, static_cast<const typename M::In*>(mass), tables, lo, inv, rows,
      F, n_prev, n_nodes, level_base, t.node_tile, t.feat_tile,
      t.n_feat_tiles, bf16, nid_out, static_cast<typename M::Acc*>(hist));
  return static_cast<int>(cudaGetLastError());
}

template <bool kFeatMajor, int kTerms>
int launch_level_w(int W, const float* x, const int* nid, const void* mass,
                   const float* tables, const float* lo, const float* inv,
                   int64_t rows, int F, int n_prev, int n_nodes,
                   int level_base, int bf16, int* nid_out, void* hist,
                   cudaStream_t s) {
  switch (W) {
    case 16:
      return launch_level<16, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 32:
      return launch_level<32, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 64:
      return launch_level<64, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 128:
      return launch_level<128, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    case 256:
      return launch_level<256, kFeatMajor, kTerms>(
          x, nid, mass, tables, lo, inv, rows, F, n_prev, n_nodes,
          level_base, bf16, nid_out, hist, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The level's instance by layout.
template <int kTerms>
int launch_level_lw(int feat_major, int W, const float* x, const int* nid,
                    const void* mass, const float* tables, const float* lo,
                    const float* inv, int64_t rows, int F, int n_prev,
                    int n_nodes, int level_base, int bf16, int* nid_out,
                    void* hist, cudaStream_t s) {
  if (feat_major)
    return launch_level_w<true, kTerms>(W, x, nid, mass, tables, lo, inv,
                                        rows, F, n_prev, n_nodes, level_base,
                                        bf16, nid_out, hist, s);
  return launch_level_w<false, kTerms>(W, x, nid, mass, tables, lo, inv, rows,
                                       F, n_prev, n_nodes, level_base, bf16,
                                       nid_out, hist, s);
}

}  // namespace

extern "C" {

// x float32 [rows, F] (feat_major 0) or [F, rows] (feat_major 1), NaN =
// NA; nid [rows] int32; ghw [3, rows] float32; tables [4, max(n_prev, 1)]
// float32; lo, inv [n_nodes, F] float32; ws, h2o3_adaptive_level_workspace
// bytes (the grouped form's; none for the tiled body). Writes nid_out
// [rows] int32 and ADDS into hist [3, n_nodes, F, W] float32, which the
// caller zeroes. Returns a cudaError_t value.
int h2o3_adaptive_level(const float* x, int feat_major, const int* nid,
                        const float* ghw, const float* tables,
                        const float* lo, const float* inv, long long rows,
                        int F, int W, int n_prev, int n_nodes, int level_base,
                        int bf16, int* nid_out, float* hist, void* ws,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (takes_grouped(feat_major, rows, F, n_prev, n_nodes)) {
    size_t unused = 0;
    return grouped_w<true>(W, false, &unused, x, nid, ghw, tables, lo, inv,
                           rows, F, n_prev, n_nodes, level_base, bf16,
                           nid_out, hist, ws, s);
  }
  return launch_level_lw<0>(feat_major, W, x, nid, ghw, tables, lo, inv, rows,
                            F, n_prev, n_nodes, level_base, bf16, nid_out,
                            hist, s);
}

// The workspace bytes h2o3_adaptive_level (atomics 0) or
// h2o3_adaptive_level_atomics (1) needs at these shapes: the grouping and
// the blocks' partials of the grouped form, 0 for the tiled body. Returns
// -1 where the shapes are refused.
long long h2o3_adaptive_level_workspace(int feat_major, long long rows, int F,
                                        int W, int n_prev, int n_nodes,
                                        int bf16, int atomics) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0) return -1;
  if (!takes_grouped(feat_major, rows, F, n_prev, n_nodes)) return atomics ? -1 : 0;
  size_t bytes = 0;
  const int rc =
      atomics
          ? grouped_w<false>(W, true, &bytes, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, rows, F, n_prev,
                             n_nodes, 0, bf16, nullptr, nullptr, nullptr,
                             nullptr)
          : grouped_w<true>(W, true, &bytes, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, rows, F, n_prev,
                            n_nodes, 0, bf16, nullptr, nullptr, nullptr,
                            nullptr);
  return rc == 0 ? static_cast<long long>(bytes) : -1;
}

// The grouped [rows, F] float level with shared float atomics in place of
// the tensor-core products: the ablation the design was measured against,
// for chip_smoke.py and the tests only. Operands as h2o3_adaptive_level
// (feat_major 0). Returns a cudaError_t value.
int h2o3_adaptive_level_atomics(const float* x, const int* nid,
                                const float* ghw, const float* tables,
                                const float* lo, const float* inv,
                                long long rows, int F, int W, int n_prev,
                                int n_nodes, int level_base, int bf16,
                                int* nid_out, float* hist, void* ws,
                                void* stream) {
  if (F < 1 || n_nodes < 1 || n_prev < 0 || rows < 0 ||
      !takes_grouped(0, rows, F, n_prev, n_nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t unused = 0;
  return grouped_w<false>(W, false, &unused, x, nid, ghw, tables, lo, inv,
                          rows, F, n_prev, n_nodes, level_base, bf16,
                          nid_out, hist, ws, static_cast<cudaStream_t>(stream));
}

// Rows grouped by key (level_common.cuh), alone, for the tests and
// chip_smoke.py: keys [rows] int32 (a key outside [0, G) leaves its row
// out), ghw [3, rows] float32 or null. Writes offsets [G + 1] int32 and
// rec [rows, 4] float32 ({row id bits, g, h, w} a row; past offsets[G]
// unwritten); ws holds h2o3_group_rows_workspace bytes (the counts and
// span starts). Returns a cudaError_t value.
long long h2o3_group_rows_workspace(long long rows, int G) {
  if (rows < 0 || G < 1 || G > h2o3::kMaxGroups) return -1;
  return static_cast<long long>(
      h2o3::counts_bytes(rows, G) +
      h2o3::align256(sizeof(int) * (static_cast<size_t>(G) + 1)));
}

int h2o3_group_rows(const int* keys, const float* ghw, long long rows, int G,
                    int* offsets, float* rec, void* ws, void* stream) {
  if (h2o3_group_rows_workspace(rows, G) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  h2o3::Grouping g;
  g.nb = h2o3::group_blocks(rows);
  g.counts = static_cast<int*>(ws);
  g.bstart = reinterpret_cast<int*>(static_cast<char*>(ws) +
                                    h2o3::counts_bytes(rows, G));
  g.offsets = offsets;
  g.rec = reinterpret_cast<float4*>(rec);
  const h2o3::SegKey key{keys, G};
  return h2o3::launch_grouping(key, ghw, rows, G, rows > 0 ? rows : 1, g,
                               static_cast<cudaStream_t>(stream));
}

// The int8 level: q [3 * terms, rows] int8 (terms 1 or 2), scales [3]
// float32 in place of ghw; acc [3 * terms, n_nodes, F, W] int32, which the
// caller zeroes, takes the sums; writes nid_out and hist [3, n_nodes, F, W]
// float32 (all of it, in the flush). Returns a cudaError_t value.
int h2o3_adaptive_level_i8(const float* x, int feat_major, const int* nid,
                           const int8_t* q, int terms, const float* scales,
                           const float* tables, const float* lo,
                           const float* inv, long long rows, int F, int W,
                           int n_prev, int n_nodes, int level_base,
                           int* nid_out, int* acc, float* hist,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_nodes < 1 || rows < 0 || (terms != 1 && terms != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc =
      terms == 1
          ? launch_level_lw<1>(feat_major, W, x, nid, q, tables, lo, inv,
                               rows, F, n_prev, n_nodes, level_base, 0,
                               nid_out, acc, s)
          : launch_level_lw<2>(feat_major, W, x, nid, q, tables, lo, inv,
                               rows, F, n_prev, n_nodes, level_base, 0,
                               nid_out, acc, s);
  if (rc != 0) return rc;
  return h2o3::launch_flush_i8(acc, scales, terms,
                               static_cast<int64_t>(n_nodes) * F * W, hist,
                               s);
}

// The deepest level's route: same operands as h2o3_adaptive_level without
// ghw, lo, inv and hist. Returns a cudaError_t value.
int h2o3_adaptive_route_only(const float* x, int feat_major, const int* nid,
                             const float* tables, long long rows, int F,
                             int n_prev, int level_base, int* nid_out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || n_prev < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks64 = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 32;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  if (feat_major)
    adaptive_route_only_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, nid, tables, rows, F, n_prev, level_base, nid_out);
  else
    adaptive_route_only_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, nid, tables, rows, F, n_prev, level_base, nid_out);
  return static_cast<int>(cudaGetLastError());
}

// Route one level of x [rows, F] float32 (none when n_prev is 0) and ADD
// each node's (g, h, w) sums into totals [3, n_nodes] float32, which the
// caller zeroes; writes nid_out [rows] int32. tables [4, max(n_prev, 1)]
// float32 as h2o3_adaptive_level's. Returns a cudaError_t value.
int h2o3_leaf_totals(const float* x, const int* nid, const float* ghw,
                     const float* tables, long long rows, int F, int n_prev,
                     int n_nodes, int level_base, int* nid_out,
                     float* totals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * static_cast<size_t>(n_nodes) * sizeof(float);
  if (F < 1 || n_nodes < 1 || rows < 0 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks64 = (rows + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(h2o3::sm_count()) * 4;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < 1 ? 1 : (blocks64 > cap ? cap : blocks64));
  leaf_totals_kernel<<<blocks, kThreads, smem, s>>>(
      x, nid, ghw, tables, rows, F, n_prev, n_nodes, level_base, nid_out,
      totals);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
