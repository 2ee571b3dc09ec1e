// Dense forward-backward scan on Hopper (sm_90a): one persistent,
// block-sparse launch per sweep.
//
// Replaces the two fused Pallas kernels of markovmodels_tpu/ops/pallas_scan.py:
//   K6a mm_dense_fwd  <- fused_forward pallas_call (:220, _make_fwd_kernel)
//   K6b mm_dense_bwd  <- fused_backward pallas_call (:269, _make_bwd_kernel)
// and, for the chunk-recompute Viterbi decode of markovmodels_tpu/viterbi.py
// (_viterbi_scale's fstep on _trop_prob_matvec, XLA there, no Pallas
// kernel):
//   K6t mm_dense_trop <- the tropical forward y[j] = max_i Wp[j, i] a[i]
//                        (viterbi.py:129-134): trop_kernel<VEC, T>, float or
//                        double, a product over the operator's non-zeros
//                        only (below, "K6t"), from a given state whose
//                        scale is seeded into the column-max row the first
//                        frame reads; it skips the product on launch frame 0
//                        only when that is global frame 0 (``first``); one
//                        launch per chunk of the decode.
//
// What the card is asked to do.  A frame is y = Wp (Sp x Sp) @ state (Sp x B)
// followed by the emission, a per-column power-of-two rescale and, backward,
// gamma and its per-pdf sums.  A dense-sized denominator's operator is
// mostly zeros: at the V=32 LM o HMM graph (Sp = 3,200 padded states) 38,913
// of 10.24 M entries are non-zero and only 1,217 of its 10,000 32 x 32 tiles
// hold any.  A zero tile adds exact zeros to a finite, non-negative state,
// so skipping it changes the result only by summation order.  What is left
// per frame at B = 128 is 1,217 tiles x 32 x 32 x 128 multiply-adds (319
// MFLOP, 4.8 us at the 67 TFLOP/s float32 peak; a fraction of a microsecond
// on the tensor cores in bf16) and one 32 x 128 block of the previous state
// read per tile (~20 MB from L2).  The TPU kernel keeps the whole operator in
// VMEM for all frames; the non-zero tiles (5.0 MB in float32) fit the
// card's shared memory spread over its SMs.  Each frame needs the whole
// previous state, so what bounds a sweep is the frame-to-frame dependency:
// a grid-wide barrier per frame plus the latency of a frame's product.
//
// The design, per sweep one cooperative launch of sweep_kernel (every CTA
// co-resident, sized with the occupancy API):
//   * the host plan (ops/dense_scan.py, tile_plan) packs the non-zero tiles
//     in (row tile, k tile) order and cuts the ordered list into one
//     contiguous range of equal tile count per CTA.  A CTA walks its range
//     as segments (the part of one row tile that lies in it); a row tile
//     that lies in one range is summed there and its epilogue runs at once;
//     one that straddles ranges writes one partial per range, and the range
//     that takes the row tile's last ticket adds the partials in range
//     order (a fixed order: no atomics on values, bit-equal run to run).
//     Row tiles without a non-zero tile are segments without tiles;
//   * the operator stays on chip: each CTA copies its range's tiles into
//     shared memory once, at kernel start, and keeps them for all frames.
//     Where a range does not fit (a denser graph, up to a fully dense 4,096
//     state operator), the same kernel streams the range's tiles every
//     frame from the packed array (L2-resident) beside the state blocks;
//   * the state block of each tile is staged by cp.async.cg into a
//     two-stage ring, the next tile's copy (across segment boundaries) in
//     flight while the current one is multiplied (a ring holding the whole
//     range measured slower: its shared memory squeezes L1); everything
//     that another CTA of the same launch wrote (the state, the partials,
//     the column statistics, gamma) is read past L1 (cp.async.cg,
//     ld.global.cg); what the next frame first reads from device memory
//     (its emission block, backward the alphas of each CTA's row tiles) is
//     prefetched into L2 a frame ahead;
//   * the frame loop runs inside the kernel, one grid barrier per frame.
//     The per-column rescale needs the column max over all row tiles: each
//     epilogue takes it with atomicMax on the float bits (exact and
//     order-free for non-negative floats, so deterministic) into one of
//     three rows, and the next frame's epilogues derive the scale from it.
//     What the TPU kernel's per-frame finalize did runs in the next frame:
//     the forward's scale output, ksum and Kahan shift (one CTA, while
//     that frame's first copies are in flight), the backward's pdf sums
//     over its CSR lists and their normalisation (all CTAs, after that
//     frame's product, from a double-buffered gamma and per-row-tile
//     column sums added in a fixed order); after the last frame, one more
//     phase.  The
//     barrier is a counter and generation flag in global memory, fenced,
//     valid because the cooperative launch guarantees co-residency.
//
// Arithmetic.  'high': full float32 FMA on the non-zero tiles (no TF32);
// each thread owns 4 rows x 4 columns of the 32 x 128 output block.  'bf16'
// (pallas_scan.py _mm :76-80 under DEFAULT precision): mma.sync m16n8k16 on
// the tiles, packed in the A-fragment order so one 16-byte load per lane
// gives a fragment, float32 sums; the epilogue writes each new state also
// rounded to bf16 (round to nearest even, once per frame), as pairs of rows
// in one 32-bit word, which is the B-fragment order, so the next frame's
// product stages half the bytes and converts nothing.  The state is rounded
// unscaled; rounding to bf16 commutes with the power-of-two scale in the
// normal range, so the mantissas are those of the scaled state the TPU
// kernel rounds.
//
// The epilogue is that of the TPU kernels: the emission gathered by the
// state->pdf map, the previous frame's exact power-of-two scale applied on
// read, frame 0 of the forward skips the product (p = a0) and the last
// frame of the backward starts from beta = 1 (pallas_scan.py:145, :186),
// gamma = alpha * ascale * y, the pdf sums over each pdf's states in
// increasing state order (a CSR list).
//
// The value type T (the last template argument): float, or double for a
// float64 graph (the JAX package runs those in XLA: its Pallas kernels take
// float32).  A double instantiation keeps every value in double: the tiles,
// the states, scales, emissions, partials, gamma, posteriors and the
// forward's sums; its column maxima are the double's bits, taken by a 64-bit
// atomicMax (exact and order-free for non-negative values), in 64-bit words
// of the sync buffer (from the first even word after the tickets); its
// scales are exact powers of two from the exponent bits (value_common.cuh).
// No bf16 x double.
//
// K6a/K6b in double (DM: sweep_kernel<BWD, VEC, false, false, double>) have
// a layout of their own, made for the card's FP64 units.  What held the
// float layout back in double: a 9 KB tile and a 32 KB stage per 32 x 128
// block, so a CTA's range (5 tiles at the V=32 operator) no longer fit
// beside two stages at 2 CTAs per SM and every tile was restaged every
// frame; the 4 x 4 FFMA product of each thread spilled; and the FP64 tensor
// cores stood idle.  The DM layout:
//   * column blocks of TBD = 64 batch columns, a tile's product in one
//     pass: a stage is 32 x 64 doubles, its rows padded to XLDD = 68
//     (17 KB), so the range's tiles (8 KB each, unpadded) stay resident
//     beside a ring of NSD = 3 stages at 2 CTAs per SM (94 KB at the V=32
//     operator); a range too large for that (a fully dense operator)
//     streams its tiles through the stages;
//   * a frame's passes in one sequence through the ring, the copies of the
//     next two in flight while one multiplies, across tiles, column blocks
//     and segment ends, one block barrier per pass;
//   * the product on the FP64 tensor cores, mma.sync m8n8k4 f64 (IEEE
//     double FMAs; wgmma takes no f64): warp w owns rows (w % 4) * 8 .. +8
//     and columns (w / 4) * 32 .. +32 of the 32 x 64 block, four 8 x 8
//     accumulators of 2 doubles a thread; per k step one A fragment (one
//     double, the tile kept in shared memory in A-fragment order, each
//     16-byte chunk of the row-major packed tile placed as it is copied:
//     dm_chunk) and four B fragments read from the stage (conflict-free at
//     the padded pitch);
//   * an epilogue that waits on one round of L2 reads (the emissions, and
//     backward alpha, all issued before any is used; the column scales
//     computed once per block and frame into shared memory: col_scales),
//     and a straddling row tile's last range reading the partials slot by
//     slot, each slot's pairs together.  The 64-bit column maxima, the
//     exact power-of-two scales and the range-order sums of the partials
//     are those of the float layout.
//
// Conventions: states (Sp, B) row-major T; ext (Nf, P1, B); the emission of
// state s is ext[t, spdf[s], b].  A stored state is unscaled, with a (B,)
// scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "coop_common.cuh"
#include "value_common.cuh"

namespace {

constexpr int TR = 32;        // operator rows per tile
constexpr int TK = 32;        // operator columns (contraction) per tile
constexpr int TB = 128;       // batch columns per column block
constexpr int NT = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int NW = NT / 32;
constexpr int WLD = TK + 4;   // a tile row in shared memory (float, double)
constexpr int XW = TB + 8;    // bf16 state stage: words per row pair
constexpr int XLD = TB + 4;   // bf16 accumulator scratch row
constexpr int PY = 8;         // backward pdf sums: thread rows per item
constexpr int PC = 32;        // backward pdf sums: columns per item
constexpr int PPI = 2;        // backward pdf sums: pdfs per item

// shared-memory bytes of one tile and of one state stage, per precision
// and value type (float: 4,608 and 16,384; double: 9,216 and 32,768)
template <class T>
constexpr int TILE_V = TR * WLD * static_cast<int>(sizeof(T));
constexpr int TILE_H = TR * TK * 2;        // 2,048 (A-fragment order)
template <class T>
constexpr int XST_V = TK * TB * static_cast<int>(sizeof(T));
constexpr int XST_H = TK / 2 * XW * 4;     // 8,704
constexpr int SCR_H = TR * XLD * 4;        // 16,896
// the double K6a/K6b (DM): a tile's product in one pass over column blocks
// of TBD batch columns, the stage's rows padded by 4 doubles, tiles
// unpadded in A-fragment order; warp w owns columns
// (w / 4) * TBD / 2 .. +TBD / 2, NBD groups of 8
constexpr int TBD = 64;
constexpr int NBD = TBD / 16;
constexpr int XLDD = TBD + 4;
constexpr int TILE_D = TR * TK * 8;        // 8,192
constexpr int XST_D = TK * XLDD * 8;       // 17,408
constexpr int NSD = 3;                     // the DM stage ring's depth
// A compiler fence for memory operations: no load or store moves across.
__device__ __forceinline__ void compiler_fence() {
  asm volatile("" ::: "memory");
}

// The host plan of one direction's operator (ops/dense_scan.py TilePlan).
struct Plan {
  const void* tiles;    // (T, 1024): value row-major, or bf16 fragments
  const int* tile_k;    // (T,) k tile of each packed tile
  const int* lo;        // (G + 1,) each CTA's range of packed tiles
  const int* seg_ptr;   // (G + 1,) each CTA's segments
  const int4* segs;     // (row tile, first tile, end tile, partial slot)
  const int2* rt_parts; // per row tile (first partial slot, partials)
};

template <class T>
struct Args {
  Plan pl;
  const int* spdf;
  int Sp, P1, B, Nf, n_slots, resident;
  const T* ext;
  // forward
  const T* a0;
  const T* mshift;
  T* states;
  T* scales;
  T* ksum;
  T* shift;
  T* comp;
  // backward
  const int* perm;
  const int* off;
  const T* alphas;
  const T* ascale;
  T* work;      // (2, Sp, B) beta
  T* gamma;     // (2, Sp, B)
  T* posts;
  T* part;      // (2, Sp / 32, B) column sums of gamma per row tile
  // scratch
  T* partial;   // (partial slots, 32, B)
  // [count, generation, tickets (Sp / 32 x column blocks), column max
  // (3, B) in BitsT<T> words (double: from the next even word)], zeroed by
  // the caller
  unsigned* sync;
  unsigned* xb;     // bf16: (2, Sp / 2, B) words, the state in row pairs
};

// Four columns b .. b+3 of one row, read past L1 (another CTA of this
// launch may have written them).
template <bool VEC>
__device__ __forceinline__ float4 load4_l2(const float* row, int b, int B) {
  if constexpr (VEC) {
    return b < B ? __ldcg(reinterpret_cast<const float4*>(row + b))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(b < B ? __ldcg(row + b) : 0.f,
                       b + 1 < B ? __ldcg(row + b + 1) : 0.f,
                       b + 2 < B ? __ldcg(row + b + 2) : 0.f,
                       b + 3 < B ? __ldcg(row + b + 3) : 0.f);
  }
}

// The same for launch inputs, which nothing in the launch writes.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int b,
                                        int B) {
  if constexpr (VEC) {
    return b < B ? __ldg(reinterpret_cast<const float4*>(row + b))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(b < B ? __ldg(row + b) : 0.f,
                       b + 1 < B ? __ldg(row + b + 1) : 0.f,
                       b + 2 < B ? __ldg(row + b + 2) : 0.f,
                       b + 3 < B ? __ldg(row + b + 3) : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int b, int B, float4 v) {
  if constexpr (VEC) {
    if (b < B) *reinterpret_cast<float4*>(row + b) = v;
  } else {
    if (b < B) row[b] = v.x;
    if (b + 1 < B) row[b + 1] = v.y;
    if (b + 2 < B) row[b + 2] = v.z;
    if (b + 3 < B) row[b + 3] = v.w;
  }
}

// The same three for double rows (VEC: B % 4 == 0, so each access is
// 32-byte aligned: two 16-byte halves).
template <bool VEC>
__device__ __forceinline__ D4 load4_l2(const double* row, int b, int B) {
  if constexpr (VEC) {
    if (!(b < B)) return D4{0.0, 0.0, 0.0, 0.0};
    const double2 lo = __ldcg(reinterpret_cast<const double2*>(row + b));
    const double2 hi = __ldcg(reinterpret_cast<const double2*>(row + b) + 1);
    return D4{lo.x, lo.y, hi.x, hi.y};
  } else {
    return D4{b < B ? __ldcg(row + b) : 0.0, b + 1 < B ? __ldcg(row + b + 1) : 0.0,
              b + 2 < B ? __ldcg(row + b + 2) : 0.0,
              b + 3 < B ? __ldcg(row + b + 3) : 0.0};
  }
}

template <bool VEC>
__device__ __forceinline__ D4 load4(const double* __restrict__ row, int b,
                                    int B) {
  if constexpr (VEC) {
    if (!(b < B)) return D4{0.0, 0.0, 0.0, 0.0};
    const double2 lo = __ldg(reinterpret_cast<const double2*>(row + b));
    const double2 hi = __ldg(reinterpret_cast<const double2*>(row + b) + 1);
    return D4{lo.x, lo.y, hi.x, hi.y};
  } else {
    return D4{b < B ? __ldg(row + b) : 0.0, b + 1 < B ? __ldg(row + b + 1) : 0.0,
              b + 2 < B ? __ldg(row + b + 2) : 0.0,
              b + 3 < B ? __ldg(row + b + 3) : 0.0};
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(double* row, int b, int B, D4 v) {
  if constexpr (VEC) {
    if (b < B) {
      reinterpret_cast<double2*>(row + b)[0] = make_double2(v.x, v.y);
      reinterpret_cast<double2*>(row + b)[1] = make_double2(v.z, v.w);
    }
  } else {
    if (b < B) row[b] = v.x;
    if (b + 1 < B) row[b + 1] = v.y;
    if (b + 2 < B) row[b + 2] = v.z;
    if (b + 3 < B) row[b + 3] = v.w;
  }
}

// Two consecutive doubles b, b + 1 of one row, read past L1, as a launch
// input, and written (the DM layout's column pairs; VEC: b is even and
// B % 4 == 0, so a pair is one 16-byte access).
template <bool VEC>
__device__ __forceinline__ double2 load2_l2(const double* row, int b, int B) {
  if constexpr (VEC) {
    return b < B ? __ldcg(reinterpret_cast<const double2*>(row + b))
                 : make_double2(0.0, 0.0);
  } else {
    return make_double2(b < B ? __ldcg(row + b) : 0.0,
                        b + 1 < B ? __ldcg(row + b + 1) : 0.0);
  }
}

template <bool VEC>
__device__ __forceinline__ double2 load2(const double* __restrict__ row, int b,
                                         int B) {
  if constexpr (VEC) {
    return b < B ? __ldg(reinterpret_cast<const double2*>(row + b))
                 : make_double2(0.0, 0.0);
  } else {
    return make_double2(b < B ? __ldg(row + b) : 0.0,
                        b + 1 < B ? __ldg(row + b + 1) : 0.0);
  }
}

template <bool VEC>
__device__ __forceinline__ void store2(double* row, int b, int B, double2 v) {
  if constexpr (VEC) {
    if (b < B) *reinterpret_cast<double2*>(row + b) = v;
  } else {
    if (b < B) row[b] = v.x;
    if (b + 1 < B) row[b + 1] = v.y;
  }
}

// d += a (8x4, row-major) * b (4x8, column-major) on the FP64 tensor cores,
// one warp: lane l holds a[l / 4][l % 4], b[l % 4][l / 4] and
// d[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major): bf16 operands, float32
// accumulation, one warp.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Where one frame reads and writes.
template <class T>
struct Frame {
  const T* prev;            // the previous state (forward frame 0: a0)
  const T* ext_t;           // (P1, B) emissions
  T* out;                   // the new state
  const BitsT<T>* cm_prev;  // the previous state's column max (its bits)
  BitsT<T>* cm_cur;         // this frame's, taken with atomicMax
  BitsT<T>* cm_next;        // the next frame's, zeroed during this one
  const unsigned* xb_prev;  // bf16: the previous state in row pairs
  unsigned* xb_out;         // bf16: the new state in row pairs
  const T* alpha_t;         // backward: alphas[t], ascale[t]
  const T* ascale_t;
  T* gamma;                 // backward: this frame's gamma (Sp, B)
  T* csum;                  // backward: its column sums per row tile
  int t;
};

template <bool BF16, class T, bool DM = false>
struct Layout {
  // batch columns per column block, and warp rows of the epilogue's
  // column reduction
  static constexpr int CB = DM ? TBD : TB;
  static constexpr int RW = DM ? 4 : 2;
  static constexpr int NST = DM ? NSD : 2;  // stages of the ring
  static constexpr int TILE = BF16 ? TILE_H : DM ? TILE_D : TILE_V<T>;
  static constexpr int XST = BF16 ? XST_H : DM ? XST_D : XST_V<T>;
  // bf16: the accumulator scratch; DM: the column block's scales
  static constexpr int SCR = BF16 ? SCR_H : DM ? 2 * TBD * 8 : 0;
  // bytes of one packed tile in global memory, and its 16-byte chunks
  static constexpr int TILE_G = TR * TK * (BF16 ? 2 : sizeof(T));
  static constexpr int TILE_CHUNKS = TILE_G / 16;
  // dynamic shared memory: resident tiles, two stages (the state block,
  // then the streamed tile), the bf16 accumulator scratch
  static size_t bytes(bool resident, int max_tiles) {
    return (resident ? static_cast<size_t>(max_tiles) * TILE : 0) +
           NST * static_cast<size_t>(XST + (resident ? 0 : TILE)) + SCR;
  }
};

// The layout of an instantiation: DM for K6a/K6b in double.
template <bool BF16, class T>
constexpr bool uses_dmma() {
  return is_f64<T>() && !BF16;
}

// The exact power-of-two scale of a column from its max's bits.
template <class T>
__device__ __forceinline__ T scale_of(const BitsT<T>* cm, int b, int B) {
  return b < B ? pow2_scale(pow2_exponent(from_bits(__ldcg(cm + b)))) : T(0);
}

template <bool BWD, bool VEC, bool BF16, class T>
struct Sweep {
  static constexpr bool DM = uses_dmma<BF16, T>();
  using L = Layout<BF16, T, DM>;
  using V = V4<T>;
  const Args<T>& p;
  unsigned char* res;   // resident tiles
  unsigned char* stg;   // stage ring
  float* scr;           // bf16 accumulator scratch
  int stage_bytes, lo, n_mine;
  T (*red)[L::RW][L::CB];
  int* flag;

  // rows r0 + wr*16 + i*4 + lr (i < 4) and columns b0 + wc*32 + lc*4 + j
  // (j < 4) of a 32 x 128 block belong to this thread
  int tid, warp, lane, wr, wc, lr, lc;

  __device__ Sweep(const Args<T>& a, unsigned char* smem,
                   T (*r)[L::RW][L::CB], int* f)
      : p(a), red(r), flag(f) {
    tid = threadIdx.x;
    warp = tid / 32;
    lane = tid % 32;
    wr = warp / 4;
    wc = warp % 4;
    lr = lane / 8;
    lc = lane % 8;
    lo = p.pl.lo[blockIdx.x];
    n_mine = p.pl.lo[blockIdx.x + 1] - lo;
    res = smem;
    stg = smem + (p.resident ? static_cast<size_t>(n_mine) * L::TILE : 0);
    stage_bytes = L::XST + (p.resident ? 0 : L::TILE);
    scr = reinterpret_cast<float*>(stg + L::NST * stage_bytes);
  }

  __device__ unsigned char* stage(int j) const {
    return stg + static_cast<size_t>(j & 1) * stage_bytes;
  }

  // Copy this CTA's range of packed tiles into shared memory.
  __device__ void load_resident() {
    if (!p.resident || n_mine == 0) return;
    constexpr int CH = L::TILE_CHUNKS;
    const unsigned char* src =
        static_cast<const unsigned char*>(p.pl.tiles) +
        static_cast<size_t>(lo) * L::TILE_G;
    // 16-byte chunks per tile row (float: 8, double: 16)
    constexpr int RC = TK * static_cast<int>(sizeof(T)) / 16;
    for (int ch = tid; ch < n_mine * CH; ch += NT) {
      const int j = ch / CH, w = ch % CH;
      unsigned char* dst = res + static_cast<size_t>(j) * L::TILE;
      if constexpr (BF16)
        dst += w * 16;
      else if constexpr (DM)
        dst += dm_chunk(w);
      else
        dst += (w / RC) * WLD * static_cast<int>(sizeof(T)) + (w % RC) * 16;
      cp_async16(dst, src + static_cast<size_t>(ch) * 16, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // DM: the shared-memory byte offset of the 16-byte chunk w of a double
  // tile packed row-major (row w / 16, columns 2 (w % 16) and + 1).  The
  // tile is kept in the A-fragment order of mma.m8n8k4: value (r, k) at
  // ((r / 8) * 8 + k / 4) * 32 + (r % 8) * 4 + k % 4, the (row block, k
  // step) fragment's 32 lanes in a row; the two values of a chunk stay
  // adjacent.
  static __device__ __forceinline__ int dm_chunk(int w) {
    const int r = w / 16, k = (w % 16) * 2;
    return (((r / 8) * (TK / 4) + k / 4) * 32 + (r % 8) * 4 + k % 4) * 8;
  }

  __device__ const unsigned char* tile_at(int j) const {
    return p.resident ? res + static_cast<size_t>(j) * L::TILE
                      : stage(j) + L::XST;
  }

  // Issue the copies of local tile j into its stage: the state block of
  // its k tile (columns b0 .. b0+127) and, streaming, the tile itself.
  __device__ void issue(const Frame<T>& fr, int j, int b0) {
    const int i = lo + j, kt = __ldg(p.pl.tile_k + i), B = p.B;
    unsigned char* st = stage(j);
    if constexpr (BF16) {
      unsigned* X = reinterpret_cast<unsigned*>(st);
      const unsigned* src = fr.xb_prev + static_cast<size_t>(kt) * (TK / 2) * B;
#pragma unroll
      for (int u = 0; u < TK / 2 * TB / 4 / NT; ++u) {
        const int idx = tid + u * NT, k = idx / (TB / 4),
                  c = (idx % (TB / 4)) * 4, b = b0 + c;
        const unsigned* s = src + static_cast<size_t>(k) * B;
        if constexpr (VEC) {
          cp_async16(&X[k * XW + c], b < B ? s + b : s, b < B);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            X[k * XW + c + q] = b + q < B ? __ldcg(s + b + q) : 0u;
        }
      }
      if (!p.resident && tid < TILE_H / 16)
        cp_async16(st + L::XST + tid * 16,
                   static_cast<const unsigned char*>(p.pl.tiles) +
                       static_cast<size_t>(i) * TILE_H + tid * 16,
                   true);
    } else {
      // E values per 16-byte chunk (float 4, double 2): the state block's
      // chunks and, streaming, the tile's, spread over the threads
      constexpr int E = 16 / static_cast<int>(sizeof(T));
      T* X = reinterpret_cast<T*>(st);
      const T* src = fr.prev + static_cast<size_t>(kt) * TK * B;
#pragma unroll
      for (int u = 0; u < TK * TB / E / NT; ++u) {
        const int idx = tid + u * NT, k = idx / (TB / E),
                  c = (idx % (TB / E)) * E, b = b0 + c;
        const T* s = src + static_cast<size_t>(k) * B;
        if constexpr (VEC) {
          cp_async16(&X[k * TB + c], b < B ? s + b : s, b < B);
        } else {
#pragma unroll
          for (int q = 0; q < E; ++q)
            X[k * TB + c + q] = b + q < B ? __ldcg(s + b + q) : T(0);
        }
      }
      if (!p.resident) {
#pragma unroll
        for (int u = 0; u < TR * TK / E / NT; ++u) {
          const int ch = tid + u * NT, r = ch / (TK / E),
                    ce = (ch % (TK / E)) * E;
          cp_async16(st + L::XST + (r * WLD + ce) * static_cast<int>(sizeof(T)),
                     static_cast<const T*>(p.pl.tiles) +
                         static_cast<size_t>(i) * TR * TK + r * TK + ce,
                     true);
        }
      }
    }
    cp_async_commit();
  }

  // acc += tile j (float32 or double) times its staged state block.
  __device__ void mul_val(int j, T (&acc)[4][4]) const {
    const T* W = reinterpret_cast<const T*>(tile_at(j));
    const T* X = reinterpret_cast<const T*>(stage(j));
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      V w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = lds4(&W[(wr * 16 + i * 4 + lr) * WLD + kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const V x = lds4(&X[(kk + q) * TB + wc * 32 + lc * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T wv = get(w[i], q);
          acc[i][0] = fma_(wv, x.x, acc[i][0]);
          acc[i][1] = fma_(wv, x.y, acc[i][1]);
          acc[i][2] = fma_(wv, x.z, acc[i][2]);
          acc[i][3] = fma_(wv, x.w, acc[i][3]);
        }
      }
    }
  }

  // d += tile j (bf16 fragments) times its staged bf16 state block: warp
  // (wr, wc) owns rows wr*16 .. +16 and columns wc*32 .. +32, four n8 tiles.
  __device__ void mul_bf16(int j, float (&d)[4][4]) const {
    const uint4* A = reinterpret_cast<const uint4*>(tile_at(j));
    const unsigned* X = reinterpret_cast<const unsigned*>(stage(j));
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      const uint4 a = A[(wr * (TK / 16) + ks) * 32 + lane];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = wc * 32 + n * 8 + g;
        mma_bf16(d[n], a, X[(ks * 8 + q) * XW + c], X[(ks * 8 + q + 4) * XW + c]);
      }
    }
  }

  // The mma accumulators into the 4 x 4-per-thread layout of the epilogue,
  // through the warp's own rows of the scratch.
  __device__ void frag_to_acc(const float (&d)[4][4], float (&acc)[4][4]) {
    const int g = lane / 4, q = lane % 4, mr = wr * 16, nc = wc * 32;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = nc + n * 8 + 2 * q;
      scr[(mr + g) * XLD + c] = d[n][0];
      scr[(mr + g) * XLD + c + 1] = d[n][1];
      scr[(mr + g + 8) * XLD + c] = d[n][2];
      scr[(mr + g + 8) * XLD + c + 1] = d[n][3];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          &scr[(mr + i * 4 + lr) * XLD + nc + lc * 4]);
      acc[i][0] = v.x;
      acc[i][1] = v.y;
      acc[i][2] = v.z;
      acc[i][3] = v.w;
    }
    __syncwarp();
  }

  // One row tile's epilogue over columns b0 .. b0+127, with s the previous
  // state's scale (from its column max):
  //   forward: y = acc * s (or prev on frame 0), y *= e.
  //   backward: y = acc * s (or 1 on the last frame);
  //     gamma = alpha_t * ascale_t * y; beta = y * e;
  //     csum[rt] = column sum of gamma.
  // The column max of the new state goes to cm_cur by atomicMax on its
  // float bits: exact and order-free for non-negative floats.
  __device__ void epilogue(const Frame<T>& fr, int rt, int b0, bool skip,
                           const T (&acc)[4][4]) {
    const int B = p.B, r0 = rt * TR, bcol = b0 + wc * 32 + lc * 4;
    T sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[j] = skip ? T(0) : scale_of<T>(fr.cm_prev, bcol + j, B);
    V asc = zero4<T>();
    if constexpr (BWD) asc = load4<VEC>(fr.ascale_t, bcol, B);
    T cmax[4] = {T(0), T(0), T(0), T(0)}, csum[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + wr * 16 + i * 4 + lr;
      const size_t rB = static_cast<size_t>(r) * B;
      const V e = load4<VEC>(
          fr.ext_t + static_cast<size_t>(__ldg(p.spdf + r)) * B, bcol, B);
      T v[4];
      if constexpr (!BWD) {
        V pv = zero4<T>();
        if (skip) pv = load4_l2<VEC>(fr.prev + rB, bcol, B);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (skip ? get(pv, j) : acc[i][j] * sc[j]) * get(e, j);
          cmax[j] = fmax_(cmax[j], v[j]);
        }
      } else {
        const V a = load4<VEC>(fr.alpha_t + rB, bcol, B);
        T g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T y = skip ? T(1) : acc[i][j] * sc[j];
          g[j] = get(a, j) * get(asc, j) * y;
          csum[j] += g[j];
          v[j] = y * get(e, j);
          cmax[j] = fmax_(cmax[j], v[j]);
        }
        store4<VEC>(fr.gamma + rB, bcol, B, make4<T>(g[0], g[1], g[2], g[3]));
      }
      store4<VEC>(fr.out + rB, bcol, B, make4<T>(v[0], v[1], v[2], v[3]));
      if constexpr (BF16) {
        static_assert(!is_f64<T>(), "no bf16 x double");
        // rows r (lr even) and r + 1 (the lane 8 above) as one word each
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = __shfl_down_sync(0xffffffffu, v[j], 8);
        if ((lr & 1) == 0) {
          unsigned* w = fr.xb_out + static_cast<size_t>(r / 2) * B;
          const unsigned x[4] = {pack_bf16(v[0], o[0]), pack_bf16(v[1], o[1]),
                                 pack_bf16(v[2], o[2]), pack_bf16(v[3], o[3])};
          if constexpr (VEC) {
            if (bcol < B)
              *reinterpret_cast<uint4*>(w + bcol) =
                  make_uint4(x[0], x[1], x[2], x[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (bcol + j < B) w[bcol + j] = x[j];
          }
        }
      }
    }
    // reduce over the 4 row lanes (lr) of each column, then the 2 warp rows
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int m = 8; m <= 16; m *= 2) {
        cmax[j] = fmax_(cmax[j], __shfl_xor_sync(0xffffffffu, cmax[j], m));
        if constexpr (BWD) csum[j] += __shfl_xor_sync(0xffffffffu, csum[j], m);
      }
    }
    if (lr == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[0][wr][wc * 32 + lc * 4 + j] = cmax[j];
        red[1][wr][wc * 32 + lc * 4 + j] = csum[j];
      }
    }
    __syncthreads();
    const int c = tid;
    if (c < TB && b0 + c < B) {
      atomicMax(fr.cm_cur + b0 + c, to_bits(fmax_(red[0][0][c], red[0][1][c])));
      if constexpr (BWD)
        fr.csum[static_cast<size_t>(rt) * B + b0 + c] =
            red[1][0][c] + red[1][1][c];
    }
    __syncthreads();  // red is free for the next epilogue
  }

  // A straddling row tile: write this range's partial, take a ticket; the
  // range that takes the last one adds the partials in range order and
  // runs the epilogue.
  __device__ void partial(const Frame<T>& fr, int rt, int b0, int cb,
                          int slot, T (&acc)[4][4]) {
    const int B = p.B, bcol = b0 + wc * 32 + lc * 4;
    const size_t SB = static_cast<size_t>(TR) * B;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4<VEC>(p.partial + slot * SB +
                      static_cast<size_t>(wr * 16 + i * 4 + lr) * B,
                  bcol, B, make4<T>(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    // the block barrier, then one thread's fence, publishes every thread's
    // partial before the ticket (as the grid barrier does)
    __syncthreads();
    const int2 rp = p.pl.rt_parts[rt];
    if (tid == 0) {
      const int ncb = (B + TB - 1) / TB;
      unsigned* tk = p.sync + 2 + static_cast<size_t>(rt) * ncb + cb;
      __threadfence();
      *flag = atomicAdd(tk, 1u) == static_cast<unsigned>(rp.y - 1);
      if (*flag) atomicExch(tk, 0u);
      __threadfence();
    }
    __syncthreads();
    if (!*flag) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t row = static_cast<size_t>(wr * 16 + i * 4 + lr) * B;
      V v = load4_l2<VEC>(p.partial + rp.x * SB + row, bcol, B);
      for (int q = 1; q < rp.y; ++q) {
        const V w = load4_l2<VEC>(p.partial + (rp.x + q) * SB + row, bcol, B);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      acc[i][0] = v.x;
      acc[i][1] = v.y;
      acc[i][2] = v.z;
      acc[i][3] = v.w;
    }
    epilogue(fr, rt, b0, false, acc);
  }

  // Product and epilogue of one frame: this CTA's segments, per column
  // block, the tiles' state blocks staged through the two-stage ring in
  // order (the next tile's copy in flight while one is multiplied, across
  // segment boundaries).  `pre` runs once, while the first copies are in
  // flight.
  template <class Pre>
  __device__ void product(const Frame<T>& fr, Pre&& pre) {
    const int s0 = p.pl.seg_ptr[blockIdx.x], s1 = p.pl.seg_ptr[blockIdx.x + 1];
    const int ncb = (p.B + TB - 1) / TB;
    for (int cb = 0; cb < ncb; ++cb) {
      const int b0 = cb * TB;
      int issued = 0;
      for (; issued < n_mine && issued < 2; ++issued) issue(fr, issued, b0);
      if (cb == 0) pre();
      int j = 0;
      for (int s = s0; s < s1; ++s) {
        const int4 sg = p.pl.segs[s];
        T acc[4][4] = {};
        float d[4][4] = {};
        for (; j < sg.z - lo; ++j) {
          if (issued > j + 1)
            cp_async_wait<1>();
          else
            cp_async_wait<0>();
          __syncthreads();
          if constexpr (BF16)
            mul_bf16(j, d);
          else
            mul_val(j, acc);
          __syncthreads();  // the stage is free for tile j + 2
          if (issued < n_mine) issue(fr, issued++, b0);
        }
        if constexpr (BF16) frag_to_acc(d, acc);
        if (sg.w < 0)
          epilogue(fr, sg.x, b0, false, acc);
        else
          partial(fr, sg.x, b0, cb, sg.w, acc);
      }
    }
  }

  // Frames that skip the product: every row tile's epilogue, round robin.
  __device__ void no_product(const Frame<T>& fr) {
    const T acc[4][4] = {};
    const int n_rt = p.Sp / TR, ncb = (p.B + TB - 1) / TB;
    for (int rt = blockIdx.x; rt < n_rt; rt += gridDim.x)
      for (int cb = 0; cb < ncb; ++cb) epilogue(fr, rt, cb * TB, true, acc);
  }

  // ---- the DM layout (K6a/K6b in double): 32 x TBD blocks, the product on
  // the FP64 tensor cores.  Thread (warp w, lane l) owns row
  // (w % 4) * 8 + l / 4 of the block and its columns
  // (w / 4) * TBD / 2 + n * 8 + 2 (l % 4) + {0, 1}, n < NBD: d[n][0..1].
  // A frame's passes run in one sequence q = cb * n_mine + j over the
  // column blocks cb and the range's tiles j, through a ring of NSD stages: the copies of passes q + 1 .. q + NSD - 1
  // are in flight while pass q multiplies, across tiles, column blocks and
  // segment ends.

  __device__ unsigned char* stage_dm(int q) const {
    return stg + static_cast<size_t>(q % NSD) * stage_bytes;
  }

  // Issue the copies of pass q into its stage: the TK x TBD state block of
  // its tile (rows at the padded pitch XLDD) and, streaming, the tile in
  // A-fragment order.
  __device__ void issue_dm(const Frame<T>& fr, int q) {
    const int i = lo + q % n_mine, b0 = q / n_mine * TBD;
    const int B = p.B, kt = __ldg(p.pl.tile_k + i);
    unsigned char* st = stage_dm(q);
    T* X = reinterpret_cast<T*>(st);
    const T* src = fr.prev + static_cast<size_t>(kt) * TK * B;
#pragma unroll 1  // unrolled, K6b's scalar branch spills at 128 registers
    for (int u = 0; u < TK * TBD / 2 / NT; ++u) {
      const int idx = tid + u * NT, k = idx / (TBD / 2),
                c = (idx % (TBD / 2)) * 2, b = b0 + c;
      const T* s = src + static_cast<size_t>(k) * B;
      if constexpr (VEC) {
        cp_async16(&X[k * XLDD + c], b < B ? s + b : s, b < B);
      } else {
        X[k * XLDD + c] = b < B ? __ldcg(s + b) : T(0);
        X[k * XLDD + c + 1] = b + 1 < B ? __ldcg(s + b + 1) : T(0);
      }
    }
    if (!p.resident) {
#pragma unroll
      for (int u = 0; u < L::TILE_CHUNKS / NT; ++u) {
        const int ch = tid + u * NT;
        cp_async16(st + L::XST + dm_chunk(ch),
                   static_cast<const unsigned char*>(p.pl.tiles) +
                       static_cast<size_t>(i) * L::TILE_G + ch * 16,
                   true);
      }
    }
    cp_async_commit();
  }

  // Wait until at most n of this thread's copy groups are in flight.
  static __device__ __forceinline__ void wait_dm(int n) {
    static_assert(NSD <= 3, "wait_dm covers up to 2 groups in flight");
    if (n >= 2)
      cp_async_wait<2>();
    else if (n == 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
  }

  // d += pass q's local tile j times its staged state block: per k step of
  // 4, one A fragment and NBD m8n8k4 products, one per 8-column group.
  __device__ void mul_dm(int q, int j, T (&d)[NBD][2]) const {
    const T* A = reinterpret_cast<const T*>(
        p.resident ? res + static_cast<size_t>(j) * L::TILE
                   : stage_dm(q) + L::XST);
    const T* X = reinterpret_cast<const T*>(stage_dm(q));
    const int mb = warp % 4;
    const T* x = X + (lane % 4) * XLDD + (warp / 4) * (TBD / 2) + lane / 4;
#pragma unroll 1  // unrolled, the k steps' fragments spill at 128 registers
    for (int ks = 0; ks < TK / 4; ++ks) {
      const T a = A[(mb * (TK / 4) + ks) * 32 + lane];
#pragma unroll
      for (int n = 0; n < NBD; ++n)
        dmma(d[n], a, x[ks * 4 * XLDD + n * 8]);
    }
  }

  // The scales of column block b0 in shared memory (the scratch), once per
  // block and frame: the previous state's (from its column max; 0 on a
  // frame that skips the product) and, backward, alpha's.
  __device__ void col_scales(const Frame<T>& fr, int b0, bool skip) {
    T* cs = reinterpret_cast<T*>(scr);
    const int B = p.B;
    for (int c = tid; c < TBD; c += NT) {
      cs[c] = skip ? T(0) : scale_of<T>(fr.cm_prev, b0 + c, B);
      if constexpr (BWD)
        cs[TBD + c] = b0 + c < B ? __ldg(fr.ascale_t + b0 + c) : T(0);
    }
  }

  // One row tile's epilogue over columns b0 .. b0+TBD-1 on the DM layout:
  // the arithmetic of epilogue() above, value for value, with the column
  // scales from col_scales().  Its global loads (the emissions and,
  // backward, alpha; forward frame 0, the initial state) issue together,
  // EG column pairs at a time (backward: two groups), before any is used;
  // each pair is reduced over the warp's 8 rows (lane bits 2-4) as it is
  // done.
  __device__ void epilogue_dm(const Frame<T>& fr, int rt, int b0, bool skip,
                              const T (&d)[NBD][2]) {
    constexpr int EG = BWD ? NBD / 2 : NBD;
    const T* cs = reinterpret_cast<const T*>(scr);
    const int B = p.B, g = lane / 4, mb = warp % 4;
    const int r = rt * TR + mb * 8 + g;
    const int c0 = (warp / 4) * (TBD / 2) + 2 * (lane % 4);
    const size_t rB = static_cast<size_t>(r) * B;
    const T* erow = fr.ext_t + static_cast<size_t>(__ldg(p.spdf + r)) * B;
#pragma unroll
    for (int n0 = 0; n0 < NBD; n0 += EG) {
      double2 e[EG], a[EG];
#pragma unroll
      for (int u = 0; u < EG; ++u) {
        const int bc = b0 + c0 + (n0 + u) * 8;
        e[u] = load2<VEC>(erow, bc, B);
        a[u] = make_double2(0.0, 0.0);
        if constexpr (BWD)
          a[u] = load2<VEC>(fr.alpha_t + rB, bc, B);
        else if (skip)
          a[u] = load2_l2<VEC>(fr.prev + rB, bc, B);
      }
#pragma unroll
      for (int u = 0; u < EG; ++u) {
        const int n = n0 + u, c = c0 + n * 8, bc = b0 + c;
        const T s0 = cs[c], s1 = cs[c + 1];
        double2 v, gm = make_double2(0.0, 0.0);
        if constexpr (!BWD) {
          v.x = (skip ? a[u].x : d[n][0] * s0) * e[u].x;
          v.y = (skip ? a[u].y : d[n][1] * s1) * e[u].y;
        } else {
          const T y0 = skip ? T(1) : d[n][0] * s0;
          const T y1 = skip ? T(1) : d[n][1] * s1;
          gm = make_double2(a[u].x * cs[TBD + c] * y0,
                            a[u].y * cs[TBD + c + 1] * y1);
          v = make_double2(y0 * e[u].x, y1 * e[u].y);
          store2<VEC>(fr.gamma + rB, bc, B, gm);
        }
        store2<VEC>(fr.out + rB, bc, B, v);
#pragma unroll
        for (int m = 4; m <= 16; m *= 2) {
          v.x = fmax_(v.x, __shfl_xor_sync(0xffffffffu, v.x, m));
          v.y = fmax_(v.y, __shfl_xor_sync(0xffffffffu, v.y, m));
          if constexpr (BWD) {
            gm.x += __shfl_xor_sync(0xffffffffu, gm.x, m);
            gm.y += __shfl_xor_sync(0xffffffffu, gm.y, m);
          }
        }
        if (g == 0) {
          red[0][mb][c] = v.x;
          red[0][mb][c + 1] = v.y;
          red[1][mb][c] = gm.x;
          red[1][mb][c + 1] = gm.y;
        }
      }
      compiler_fence();
    }
    __syncthreads();
    const int c = tid;
    if (c < TBD && b0 + c < B) {
      atomicMax(fr.cm_cur + b0 + c,
                to_bits(fmax_(fmax_(red[0][0][c], red[0][1][c]),
                              fmax_(red[0][2][c], red[0][3][c]))));
      if constexpr (BWD)
        fr.csum[static_cast<size_t>(rt) * B + b0 + c] =
            ((red[1][0][c] + red[1][1][c]) + red[1][2][c]) + red[1][3][c];
    }
    __syncthreads();  // red is free for the next epilogue
  }

  // A straddling row tile on the DM layout: partial(), the ticket and the
  // range-order sum of the partials, then epilogue_dm().
  __device__ void partial_dm(const Frame<T>& fr, int rt, int b0, int cb,
                             int slot, T (&d)[NBD][2]) {
    const int B = p.B, bc0 = b0 + (warp / 4) * (TBD / 2) + 2 * (lane % 4);
    const size_t SB = static_cast<size_t>(TR) * B;
    const size_t row = static_cast<size_t>((warp % 4) * 8 + lane / 4) * B;
#pragma unroll
    for (int n = 0; n < NBD; ++n)
      store2<VEC>(p.partial + slot * SB + row, bc0 + n * 8, B,
                  make_double2(d[n][0], d[n][1]));
    __syncthreads();
    const int2 rp = p.pl.rt_parts[rt];
    if (tid == 0) {
      const int ncb = (B + TBD - 1) / TBD;
      unsigned* tk = p.sync + 2 + static_cast<size_t>(rt) * ncb + cb;
      __threadfence();
      *flag = atomicAdd(tk, 1u) == static_cast<unsigned>(rp.y - 1);
      if (*flag) atomicExch(tk, 0u);
      __threadfence();
    }
    __syncthreads();
    if (!*flag) return;
    // the partials in range order, one slot at a time: a slot's pairs are
    // read together, so each slot costs one round trip
    for (int q = 0; q < rp.y; ++q) {
      const T* src = p.partial + (rp.x + q) * SB + row;
      double2 w[NBD];
#pragma unroll
      for (int n = 0; n < NBD; ++n) w[n] = load2_l2<VEC>(src, bc0 + n * 8, B);
#pragma unroll
      for (int n = 0; n < NBD; ++n) {
        d[n][0] = q == 0 ? w[n].x : d[n][0] + w[n].x;
        d[n][1] = q == 0 ? w[n].y : d[n][1] + w[n].y;
      }
    }
    epilogue_dm(fr, rt, b0, false, d);
  }

  // product() on the DM layout: the passes of every column block in one
  // sequence through the NSD-stage ring, one block barrier per pass (the
  // barrier after pass q - 1's reads frees the stage pass q + NSD - 1
  // fills).
  template <class Pre>
  __device__ void product_dm(const Frame<T>& fr0, Pre&& pre) {
    // the frame's pointers from shared memory, not held in registers
    // across the passes (the register budget of 2 CTAs per SM)
    __shared__ Frame<T> sfr;
    if (tid == 0) sfr = fr0;
    __syncthreads();
    const Frame<T>& fr = sfr;
    const int s0 = p.pl.seg_ptr[blockIdx.x], s1 = p.pl.seg_ptr[blockIdx.x + 1];
    const int ncb = (p.B + TBD - 1) / TBD, total = n_mine * ncb;
    int issued = 0;
    for (; issued < total && issued < NSD - 1; ++issued) issue_dm(fr, issued);
    pre();
    int q = 0;
    for (int cb = 0; cb < ncb; ++cb) {
      const int b0 = cb * TBD;
      // read by the block's epilogues after the next pass's barrier (the
      // last epilogue of the previous block ended on one)
      col_scales(fr, b0, false);
      if (n_mine == 0) __syncthreads();
      int j = 0;
      for (int s = s0; s < s1; ++s) {
        const int4 sg = p.pl.segs[s];
        T d[NBD][2] = {};
        for (; j < sg.z - lo; ++j, ++q) {
          wait_dm(issued - q - 1);
          __syncthreads();
          if (issued < total) issue_dm(fr, issued++);
          mul_dm(q, j, d);
        }
        if (sg.w < 0)
          epilogue_dm(fr, sg.x, b0, false, d);
        else
          partial_dm(fr, sg.x, b0, cb, sg.w, d);
      }
    }
  }

  // no_product() on the DM layout.
  __device__ void no_product_dm(const Frame<T>& fr) {
    const T d[NBD][2] = {};
    const int n_rt = p.Sp / TR, ncb = (p.B + TBD - 1) / TBD;
    for (int rt = blockIdx.x; rt < n_rt; rt += gridDim.x) {
      for (int cb = 0; cb < ncb; ++cb) {
        col_scales(fr, cb * TBD, true);
        __syncthreads();
        epilogue_dm(fr, rt, cb * TBD, true, d);
      }
    }
  }

  // The last CTA's share of each frame: zero the next frame's column max
  // (read for the last time one frame ago).
  __device__ void clear_next(const Frame<T>& fr) {
    if (blockIdx.x != gridDim.x - 1) return;
    for (int b = tid; b < p.B; b += NT) fr.cm_next[b] = 0;
  }

  // Forward outputs of frame t, once its column max is complete: the
  // scale 2^-k, ksum += k and the Kahan-compensated emission shift (the
  // last CTA, one thread per column).
  __device__ void frame_out(int t) {
    if (blockIdx.x != gridDim.x - 1) return;
    const int B = p.B;
    const BitsT<T>* cm = cm_row(t);
    const T* msh = p.mshift + static_cast<size_t>(t) * B;
    T* scale = p.scales + static_cast<size_t>(t % p.n_slots) * B;
    for (int b = tid; b < B; b += NT) {
      const T k = pow2_exponent(from_bits(__ldcg(cm + b)));
      scale[b] = pow2_scale(k);
      p.ksum[b] += k;
      const T xc = __ldg(msh + b) - p.comp[b];
      const T s = p.shift[b] + xc;
      p.comp[b] = (s - p.shift[b]) - xc;
      p.shift[b] = s;
    }
  }

  // Backward posteriors of frame f (time t), once its gamma and column
  // sums are complete: posts_t[p, b] = (sum of gamma over pdf p's states)
  // / (column sum of gamma, or 1 where it is 0).  An item is 32 columns x
  // PPI pdfs, one per CTA where there are enough CTAs: the 8 thread rows
  // of a column split the row-tile sums, the 8 / PPI rows of a pdf split
  // its CSR list (strided, in increasing state order), and each part sum
  // is added in a fixed order.
  __device__ void posts_of(int f, T (*rs)[PY][PC]) {
    constexpr int SPL = PY / PPI;  // thread rows per pdf
    const int B = p.B, P1 = p.P1, n_rt = p.Sp / TR, t = p.Nf - 1 - f;
    const int ncol = (B + PC - 1) / PC;
    const int n_items = ncol * ((P1 + PPI - 1) / PPI);
    const int tx = tid % PC, ty = tid / PC;
    const T* gamma = p.gamma + static_cast<size_t>(f % 2) * p.Sp * B;
    const T* cs = p.part + static_cast<size_t>(f % 2) * n_rt * B;
    T* posts_t = p.posts + static_cast<size_t>(t) * P1 * B;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int b = (item % ncol) * PC + tx;
      const int pd = (item / ncol) * PPI + ty / SPL, part = ty % SPL;
      T sm = T(0), g = T(0);
      if (b < B) {
#pragma unroll 4
        for (int r = ty; r < n_rt; r += PY)
          sm += __ldcg(cs + static_cast<size_t>(r) * B + b);
        if (pd < P1) {
          const int q1 = __ldg(p.off + pd + 1);
#pragma unroll 4
          for (int q = __ldg(p.off + pd) + part; q < q1; q += SPL)
            g += __ldcg(gamma + static_cast<size_t>(__ldg(p.perm + q)) * B +
                        b);
        }
      }
      rs[0][ty][tx] = sm;
      rs[1][ty][tx] = g;
      __syncthreads();
      if (part == 0 && b < B && pd < P1) {
        T tot = T(0), gs = T(0);
#pragma unroll
        for (int q = 0; q < PY; ++q) tot += rs[0][q][tx];
#pragma unroll
        for (int q = 0; q < SPL; ++q) gs += rs[1][ty + q][tx];
        posts_t[static_cast<size_t>(pd) * B + b] =
            gs / (tot > T(0) ? tot : T(1));
      }
      __syncthreads();  // rs is free for the next item
    }
  }

  // Pull into L2 what frame f + 1 reads first from device memory: its
  // emission block (spread over the grid) and, backward, the alphas rows of
  // this CTA's row tiles; otherwise each epilogue waits on them.
  __device__ void prefetch_next(int f) const {
    if (f + 1 >= p.Nf) return;
    const int B = p.B, t = BWD ? p.Nf - 2 - f : f + 1;
    constexpr int LINE = 128 / sizeof(T);  // values per 128-byte line
    const T* e = p.ext + static_cast<size_t>(t) * p.P1 * B;
    const int n_e = (p.P1 * B + LINE - 1) / LINE;
    for (int i = blockIdx.x * NT + tid; i < n_e; i += gridDim.x * NT)
      prefetch_l2(e + static_cast<size_t>(i) * LINE);
    if constexpr (BWD) {
      const int s0 = p.pl.seg_ptr[blockIdx.x];
      const int per_rt = (TR * B + LINE - 1) / LINE;
      const int n_a = (p.pl.seg_ptr[blockIdx.x + 1] - s0) * per_rt;
      const T* a = p.alphas + static_cast<size_t>(t) * p.Sp * B;
      for (int i = tid; i < n_a; i += NT) {
        const int rt = p.pl.segs[s0 + i / per_rt].x;
        prefetch_l2(a + static_cast<size_t>(rt) * TR * B +
                    static_cast<size_t>(i % per_rt) * LINE);
      }
    }
  }

  // The column max of frame f's state: three buffers in turn (double:
  // 64-bit words from the first even word after the tickets).
  __device__ BitsT<T>* cm_row(int f) const {
    const int n_rt = p.Sp / TR, ncb = (p.B + L::CB - 1) / L::CB;
    const size_t base = 2 + static_cast<size_t>(n_rt) * ncb;
    if constexpr (is_f64<T>())
      return reinterpret_cast<unsigned long long*>(p.sync + base + base % 2) +
             static_cast<size_t>(f % 3) * p.B;
    else
      return p.sync + base + static_cast<size_t>(f % 3) * p.B;
  }

  __device__ Frame<T> frame(int f) const {
    const int Nf = p.Nf, B = p.B;
    const size_t SB = static_cast<size_t>(p.Sp) * B;
    const size_t XB = static_cast<size_t>(p.Sp / 2) * B;
    Frame<T> fr{};
    fr.cm_prev = cm_row(f + 2);
    fr.cm_cur = cm_row(f);
    fr.cm_next = cm_row(f + 1);
    if constexpr (!BWD) {
      const int t = f, cur = t % p.n_slots,
                prv = (t + p.n_slots - 1) % p.n_slots;
      fr.t = t;
      fr.prev = t == 0 ? p.a0 : p.states + prv * SB;
      fr.out = p.states + cur * SB;
    } else {
      const int t = Nf - 1 - f, cur = t % 2, prv = (t + 1) % 2;
      fr.t = t;
      fr.prev = p.work + prv * SB;
      fr.out = p.work + cur * SB;
      fr.alpha_t = p.alphas + t * SB;
      fr.ascale_t = p.ascale + static_cast<size_t>(t) * B;
      fr.gamma = p.gamma + static_cast<size_t>(f % 2) * SB;
      fr.csum = p.part + static_cast<size_t>(f % 2) * (p.Sp / TR) * B;
    }
    fr.xb_prev = p.xb + ((f + 1) % 2) * XB;
    fr.xb_out = p.xb + (f % 2) * XB;
    fr.ext_t = p.ext + static_cast<size_t>(fr.t) * p.P1 * B;
    return fr;
  }
};

// One sweep (K6a: BWD = false; K6b: BWD = true) over all Nf frames, one
// grid barrier per frame.  What a frame's statistics feed is taken up by
// the next frame: its scale by every epilogue (from the column max), the
// forward's scale, ksum and shift and the backward's posteriors by the
// next frame's phase (and, after the last frame, by one more phase).
template <bool BWD, bool VEC, bool BF16, class T>
__global__ void __launch_bounds__(NT, 2) sweep_kernel(const Args<T> p) {
  using Sw = Sweep<BWD, VEC, BF16, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  // [max, sum][warp row][column]
  __shared__ T red[2][Sw::L::RW][Sw::L::CB];
  __shared__ T rsum[2][PY][PC];  // backward pdf sums: [den, gamma]
  __shared__ int flag;
  Sw sw(p, smem, red, &flag);
  sw.load_resident();
  for (int f = 0; f < p.Nf; ++f) {
    const Frame<T> fr = sw.frame(f);
    sw.clear_next(fr);
    sw.prefetch_next(f);
    if (f == 0) {
      // forward: p = a0; backward: beta = 1
      if constexpr (Sw::DM)
        sw.no_product_dm(fr);
      else
        sw.no_product(fr);
    } else {
      if constexpr (Sw::DM)
        sw.product_dm(fr, [&] {
          if constexpr (!BWD) sw.frame_out(f - 1);
        });
      else
        sw.product(fr, [&] {
          if constexpr (!BWD) sw.frame_out(f - 1);
        });
      if constexpr (BWD) sw.posts_of(f - 1, rsum);  // the previous frame's
    }
    grid_sync(p.sync);
  }
  if constexpr (BWD)
    sw.posts_of(p.Nf - 1, rsum);
  else
    sw.frame_out(p.Nf - 1);
}

// The launch: every CTA of the plan's grid co-resident.  The range's tiles
// stay in shared memory when that many bytes still let the grid be
// co-resident, else they stream.
template <bool BWD, bool VEC, bool BF16, class T>
cudaError_t launch_t(Args<T> a, int n_ctas, int max_tiles, cudaStream_t st) {
  using L = Layout<BF16, T, uses_dmma<BF16, T>()>;
  const void* kern =
      reinterpret_cast<const void*>(sweep_kernel<BWD, VEC, BF16, T>);
  int dev = 0, optin = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  auto fits = [&](size_t bytes) {
    if (bytes + fa.sharedSizeBytes > static_cast<size_t>(optin)) return false;
    int per_sm = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      bytes) != cudaSuccess) {
      cudaGetLastError();  // clear the refusal
      return false;
    }
    return per_sm * n_sm >= n_ctas;
  };
  size_t bytes = L::bytes(true, max_tiles);
  a.resident = 1;
  if (!fits(bytes)) {
    bytes = L::bytes(false, max_tiles);
    a.resident = 0;
    if (!fits(bytes)) return cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(n_ctas), dim3(NT), args, bytes,
                                    st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The instantiation of a launch: prec 0 float, 1 bf16 tiles (float
// values), 2 double; VEC where B % 4 == 0.
template <bool BWD, class T>
cudaError_t launch(const Args<T>& a, int prec, int n_ctas, int max_tiles,
                   cudaStream_t st) {
  const bool vec = a.B % 4 == 0;
  if constexpr (!is_f64<T>()) {
    if (prec == 1)
      return vec ? launch_t<BWD, true, true, T>(a, n_ctas, max_tiles, st)
                 : launch_t<BWD, false, true, T>(a, n_ctas, max_tiles, st);
  }
  return vec ? launch_t<BWD, true, false, T>(a, n_ctas, max_tiles, st)
             : launch_t<BWD, false, false, T>(a, n_ctas, max_tiles, st);
}

bool bad_shape(int Sp, int P1, int B, int Nf, int n_ctas, int max_tiles) {
  return Sp <= 0 || Sp % TR || Sp % TK || P1 <= 0 || B <= 0 || Nf <= 0 ||
         n_ctas <= 0 || max_tiles < 0;
}

Plan plan_of(const void* tiles, const int* tile_k, const int* lo,
             const int* seg_ptr, const int* segs, const int* rt_parts) {
  return Plan{tiles, tile_k, lo, seg_ptr, reinterpret_cast<const int4*>(segs),
              reinterpret_cast<const int2*>(rt_parts)};
}

// The forward's arguments (K6a and K6t) in the value type T.
template <class T>
Args<T> fwd_args(Plan pl, const int* spdf, const void* a0, const void* ext,
                 const void* mshift, int Sp, int P1, int B, int Nf,
                 int n_slots, void* states, void* scales, void* ksum,
                 void* shift, void* comp, void* partial, unsigned* sync,
                 unsigned* xb) {
  Args<T> a{};
  a.pl = pl;
  a.spdf = spdf;
  a.Sp = Sp;
  a.P1 = P1;
  a.B = B;
  a.Nf = Nf;
  a.n_slots = n_slots;
  a.ext = static_cast<const T*>(ext);
  a.a0 = static_cast<const T*>(a0);
  a.mshift = static_cast<const T*>(mshift);
  a.states = static_cast<T*>(states);
  a.scales = static_cast<T*>(scales);
  a.ksum = static_cast<T*>(ksum);
  a.shift = static_cast<T*>(shift);
  a.comp = static_cast<T*>(comp);
  a.partial = static_cast<T*>(partial);
  a.sync = sync;
  a.xb = xb;
  return a;
}

// The backward's arguments (K6b) in the value type T.
template <class T>
Args<T> bwd_args(Plan pl, const int* spdf, const int* perm, const int* off,
                 const void* ext, const void* alphas, const void* ascale,
                 int Sp, int P1, int B, int Nf, void* work, void* gamma,
                 void* posts, void* part, void* partial, unsigned* sync,
                 unsigned* xb) {
  Args<T> a{};
  a.pl = pl;
  a.spdf = spdf;
  a.Sp = Sp;
  a.P1 = P1;
  a.B = B;
  a.Nf = Nf;
  a.n_slots = 2;
  a.ext = static_cast<const T*>(ext);
  a.perm = perm;
  a.off = off;
  a.alphas = static_cast<const T*>(alphas);
  a.ascale = static_cast<const T*>(ascale);
  a.work = static_cast<T*>(work);
  a.gamma = static_cast<T*>(gamma);
  a.posts = static_cast<T*>(posts);
  a.part = static_cast<T*>(part);
  a.partial = static_cast<T*>(partial);
  a.sync = sync;
  a.xb = xb;
  return a;
}

// ---- K6t: the tropical forward as a sparse product ----
//
// y[j, b] = max over the non-zeros W[j, i] of W[j, i] * prev[i, b], started
// from +0: every product is >= 0 (an absent arc's is +0), so this is the
// dense max bit for bit, and it does not depend on order.  Then
// u = (y * s) * e with the previous state's scale s (from its column max)
// and the emission e, stored unscaled, its column max by atomicMax on the
// value's bits, as K6a.  The host plan (ops/dense_scan.py trop_plan) lists
// the operator's non-zeros by destination row and cuts the rows into
// pieces (a row whose entries outweigh two warps' share into pieces of
// about one share, which the final state's 1,025 in-arcs at the V=32 graph
// need), dealt out to the grid's warps in row order by balanced cost (the
// entries, and a few entries' worth per row for its epilogue).  A warp
// owns 128 batch columns, a lane four of them; per piece it loads TU
// entries and their source rows (past L1: another CTA wrote them) before
// any is used, and takes the max of their products by compare and select
// (float: on the products' bits as ints, two products per 3-input max;
// double: a DSETP and selects, never fmax, which sm_90 lowers to a
// quarter-rate sequence).  A whole row's epilogue runs in the warp that
// summed it; a split row's pieces take the max into the row's partial
// slot by atomicMax on the bits (order-free for values >= 0) and take the
// row's ticket, and the piece that takes the last one reads the slot back,
// zeroes it for the next frame and runs the epilogue.  The column scales
// are computed once per column block and frame into shared memory, and each
// lane keeps its columns' max in the warp's row of a shared table (each
// lane deriving its own scales and holding its maxima in registers, the
// float frame measured 13.7 us against 9.5: PERF.md section 6); each CTA's
// column max takes one atomicMax per column and frame.  Nothing is staged:
// the state rows come from L2.

// entries a lane loads before any is used (double: 8 spilled)
template <class T>
constexpr int TU = is_f64<T>() ? 6 : 8;
constexpr int TGEN = 32;  // the barrier's generation word: its own line

template <class T>
struct TropArgs {
  const int* src;      // (nnz,) source state of each entry, by row
  const T* w;          // (nnz,) its weight
  const int4* pieces;  // (row, first entry, end entry, partial slot or -1)
  const int* wp;       // (warps + 1,) each warp's pieces
  const int2* parts;   // (Sp,) a split row's partial slot and its pieces
  const int* spdf;
  int Sp, P1, B, Nf, n_slots, first;
  const T* ext;
  const T* a0;
  const T* mshift;
  T* states;
  T* scales;
  T* ksum;
  T* shift;
  T* comp;
  T* partial;  // (split rows, B) zeroed; each piece's maxima by atomicMax
  // [count, .., generation (word TGEN), tickets (Sp x column blocks), column
  // max (3, B) in BitsT<T> words (double: from the next even word)], zeroed
  unsigned* sync;
};

// The larger of two values >= 0 by compare and select (no fmax).
template <class T>
__device__ __forceinline__ T vmax(T a, T b) {
  return b > a ? b : a;
}

// The column max of frame f's state: three rows in turn, after the tickets.
template <class T>
__device__ __forceinline__ BitsT<T>* trop_cm(const TropArgs<T>& p, int f) {
  const size_t base =
      TGEN + 1 + static_cast<size_t>(p.Sp) * ((p.B + TB - 1) / TB);
  if constexpr (is_f64<T>())
    return reinterpret_cast<unsigned long long*>(p.sync + base + base % 2) +
           static_cast<size_t>(f % 3) * p.B;
  else
    return p.sync + base + static_cast<size_t>(f % 3) * p.B;
}

// The max over entries q0 .. q1 - 1 of w * prev[src], columns bcol .. +3.
template <bool VEC, class T>
__device__ __forceinline__ V4<T> trop_max(const TropArgs<T>& p,
                                          const T* prev, int q0, int q1,
                                          int bcol) {
  const int B = p.B;
  if constexpr (is_f64<T>()) {
    T m[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 1
    for (int q = q0; q < q1; q += TU<T>) {
      int sr[TU<T>];
      T w[TU<T>];
      D4 x[TU<T>];
#pragma unroll
      for (int u = 0; u < TU<T>; ++u) {
        sr[u] = q + u < q1 ? __ldg(p.src + q + u) : -1;
        w[u] = q + u < q1 ? __ldg(p.w + q + u) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < TU<T>; ++u)
        x[u] = sr[u] >= 0
                   ? load4_l2<VEC>(prev + static_cast<size_t>(sr[u]) * B, bcol,
                                   B)
                   : D4{0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int u = 0; u < TU<T>; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) m[c] = vmax(m[c], mul_rn(w[u], get(x[u], c)));
    }
    return D4{m[0], m[1], m[2], m[3]};
  } else {
    int m[4] = {0, 0, 0, 0};  // the bits of the running max (+0)
#pragma unroll 1
    for (int q = q0; q < q1; q += TU<T>) {
      int sr[TU<T>];
      float w[TU<T>];
      float4 x[TU<T>];
#pragma unroll
      for (int u = 0; u < TU<T>; ++u) {
        sr[u] = q + u < q1 ? __ldg(p.src + q + u) : -1;
        w[u] = q + u < q1 ? __ldg(p.w + q + u) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < TU<T>; ++u)
        x[u] = sr[u] >= 0
                   ? load4_l2<VEC>(prev + static_cast<size_t>(sr[u]) * B, bcol,
                                   B)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < TU<T>; u += 2)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          m[c] = max(max(m[c], __float_as_int(mul_rn(w[u], get(x[u], c)))),
                     __float_as_int(mul_rn(w[u + 1], get(x[u + 1], c))));
    }
    return make_float4(__int_as_float(m[0]), __int_as_float(m[1]),
                       __int_as_float(m[2]), __int_as_float(m[3]));
  }
}

// A split row's piece: its maxima into the row's partial slot by atomicMax
// on their bits, then the row's ticket (per column block); the piece that
// takes the last one reads the slot into acc, zeroes it for the next frame
// and returns true.
template <bool VEC, class T>
__device__ __forceinline__ bool trop_merge(const TropArgs<T>& p, int r,
                                           int slot, int cb, int bcol,
                                           V4<T>& acc) {
  const int B = p.B, ncb = (B + TB - 1) / TB;
  T* row = p.partial + static_cast<size_t>(slot) * B;
  BitsT<T>* bits = reinterpret_cast<BitsT<T>*>(row);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (bcol + c < B) atomicMax(bits + bcol + c, to_bits(get(acc, c)));
  // every lane's maxima are in before the ticket (as the grid barrier)
  __threadfence();
  __syncwarp();
  const int2 rp = p.parts[r];
  unsigned last = 0;
  if (threadIdx.x % 32 == 0) {
    unsigned* tk = p.sync + TGEN + 1 + static_cast<size_t>(r) * ncb + cb;
    last = atomicAdd(tk, 1u) == static_cast<unsigned>(rp.y - 1);
    if (last) atomicExch(tk, 0u);
    __threadfence();
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return false;
  acc = load4_l2<VEC>(row, bcol, B);
  store4<VEC>(row, bcol, B, zero4<T>());
  return true;
}

// Row r's new state u = y * e (columns bcol .. +3) stored, its values into
// the lane's column max (cmax: its four columns of the warp's row).
template <bool VEC, class T>
__device__ __forceinline__ void trop_store(const TropArgs<T>& p, T* out,
                                          int r, int bcol, const T (&y)[4],
                                          const V4<T>& e, T* cmax) {
  T v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = y[c] * get(e, c);
    cmax[c] = vmax(cmax[c], v[c]);
  }
  store4<VEC>(out + static_cast<size_t>(r) * p.B, bcol, p.B,
              make4<T>(v[0], v[1], v[2], v[3]));
}

// The emissions of row r, columns bcol .. +3.
template <bool VEC, class T>
__device__ __forceinline__ V4<T> trop_emission(const TropArgs<T>& p,
                                              const T* ext_t, int r,
                                              int bcol) {
  return load4<VEC>(ext_t + static_cast<size_t>(__ldg(p.spdf + r)) * p.B,
                    bcol, p.B);
}

// Frame t's outputs once its column max is complete: the scale, ksum and
// the Kahan-compensated emission shift (the last CTA; Sweep::frame_out).
template <class T>
__device__ __forceinline__ void trop_frame_out(const TropArgs<T>& p, int t) {
  const int B = p.B;
  const BitsT<T>* cm = trop_cm(p, t);
  const T* msh = p.mshift + static_cast<size_t>(t) * B;
  T* scale = p.scales + static_cast<size_t>(t % p.n_slots) * B;
  for (int b = threadIdx.x; b < B; b += NT) {
    const T k = pow2_exponent(from_bits(__ldcg(cm + b)));
    scale[b] = pow2_scale(k);
    p.ksum[b] += k;
    const T xc = __ldg(msh + b) - p.comp[b];
    const T s = p.shift[b] + xc;
    p.comp[b] = (s - p.shift[b]) - xc;
    p.shift[b] = s;
  }
}

// K6t over launch frames 0 .. Nf-1, one grid barrier per frame.  Launch
// frame 0 skips the product only when ``first`` (global frame 0: u = a0 *
// e, every row's epilogue dealt out to the warps round robin); otherwise
// it multiplies a0, whose column max the caller seeded.
template <bool VEC, class T>
__global__ void __launch_bounds__(NT, 2) trop_kernel(const TropArgs<T> p) {
  __shared__ T red[NW][TB];  // each warp's column max
  __shared__ T scs[TB];      // the previous state's column scales
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gw = blockIdx.x * NW + warp, n_warps = gridDim.x * NW;
  const int B = p.B, ncb = (B + TB - 1) / TB;
  const size_t SB = static_cast<size_t>(p.Sp) * B;
  const int pc0 = p.wp[gw], pc1 = p.wp[gw + 1];
  const bool last_cta = blockIdx.x == gridDim.x - 1;
  for (int f = 0; f < p.Nf; ++f) {
    const T* prev = f == 0 ? p.a0
                           : p.states + static_cast<size_t>(
                                            (f + p.n_slots - 1) % p.n_slots) *
                                            SB;
    T* out = p.states + static_cast<size_t>(f % p.n_slots) * SB;
    const T* ext_t = p.ext + static_cast<size_t>(f) * p.P1 * B;
    const BitsT<T>* cm_prev = trop_cm(p, f + 2);
    BitsT<T>* cm_cur = trop_cm(p, f);
    if (last_cta) {
      BitsT<T>* cm_next = trop_cm(p, f + 1);  // read last one frame ago
      for (int b = tid; b < B; b += NT) cm_next[b] = 0;
      if (f > 0) trop_frame_out(p, f - 1);
    }
    if (f + 1 < p.Nf) {  // the next frame's emissions into L2, spread
      constexpr int LINE = 128 / sizeof(T);
      const T* e = ext_t + static_cast<size_t>(p.P1) * B;
      const int n_e = (p.P1 * B + LINE - 1) / LINE;
      for (int i = blockIdx.x * NT + tid; i < n_e; i += gridDim.x * NT)
        prefetch_l2(e + static_cast<size_t>(i) * LINE);
    }
    const bool skip = f == 0 && p.first;
    for (int cb = 0; cb < ncb; ++cb) {
      const int bcol = cb * TB + lane * 4;
      T* cmax = &red[warp][lane * 4];  // this lane's columns' max
#pragma unroll
      for (int c = 0; c < 4; ++c) cmax[c] = T(0);
      if (tid < TB)
        scs[tid] = skip ? T(0) : scale_of<T>(cm_prev, cb * TB + tid, B);
      __syncthreads();
      const T* sc = &scs[lane * 4];
      if (skip) {
        for (int r = gw; r < p.Sp; r += n_warps) {
          const V4<T> e = trop_emission<VEC>(p, ext_t, r, bcol);
          const V4<T> a =
              load4_l2<VEC>(prev + static_cast<size_t>(r) * B, bcol, B);
          const T y[4] = {get(a, 0), get(a, 1), get(a, 2), get(a, 3)};
          trop_store<VEC>(p, out, r, bcol, y, e, cmax);
        }
      } else {
        for (int pc = pc0; pc < pc1; ++pc) {
          const int4 pi = p.pieces[pc];
          V4<T> e = zero4<T>();
          if (pi.w < 0) e = trop_emission<VEC>(p, ext_t, pi.x, bcol);
          V4<T> acc = trop_max<VEC>(p, prev, pi.y, pi.z, bcol);
          if (pi.w >= 0) {
            if (!trop_merge<VEC>(p, pi.x, pi.w, cb, bcol, acc)) continue;
            e = trop_emission<VEC>(p, ext_t, pi.x, bcol);
          }
          const T y[4] = {get(acc, 0) * sc[0], get(acc, 1) * sc[1],
                          get(acc, 2) * sc[2], get(acc, 3) * sc[3]};
          trop_store<VEC>(p, out, pi.x, bcol, y, e, cmax);
        }
      }
      __syncthreads();
      if (tid < TB && cb * TB + tid < B) {
        T m = red[0][tid];
#pragma unroll
        for (int w = 1; w < NW; ++w) m = vmax(m, red[w][tid]);
        atomicMax(cm_cur + cb * TB + tid, to_bits(m));
      }
      __syncthreads();  // red is free for the next column block
    }
    grid_sync<TGEN, 256, true>(p.sync);
  }
  if (last_cta) trop_frame_out(p, p.Nf - 1);
}

// K6t's launch: every CTA of the plan's grid co-resident.
template <bool VEC, class T>
cudaError_t launch_trop(const TropArgs<T>& a, int n_ctas, cudaStream_t st) {
  const void* kern = reinterpret_cast<const void*>(trop_kernel<VEC, T>);
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, 0);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sm < n_ctas) return cudaErrorCooperativeLaunchTooLarge;
  TropArgs<T> arg = a;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(kern, dim3(n_ctas), dim3(NT), args, 0, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class T>
cudaError_t trop(const int* src, const void* w, const int* pieces,
                 const int* wp, const int* parts, int n_ctas, const int* spdf,
                 const void* a0, const void* ext, const void* mshift, int Sp,
                 int P1, int B, int Nf, int n_slots, int first, void* states,
                 void* scales, void* ksum, void* shift, void* comp,
                 void* partial, unsigned* sync, cudaStream_t st) {
  TropArgs<T> a{};
  a.src = src;
  a.w = static_cast<const T*>(w);
  a.pieces = reinterpret_cast<const int4*>(pieces);
  a.wp = wp;
  a.parts = reinterpret_cast<const int2*>(parts);
  a.spdf = spdf;
  a.Sp = Sp;
  a.P1 = P1;
  a.B = B;
  a.Nf = Nf;
  a.n_slots = n_slots;
  a.first = first != 0;
  a.ext = static_cast<const T*>(ext);
  a.a0 = static_cast<const T*>(a0);
  a.mshift = static_cast<const T*>(mshift);
  a.states = static_cast<T*>(states);
  a.scales = static_cast<T*>(scales);
  a.ksum = static_cast<T*>(ksum);
  a.shift = static_cast<T*>(shift);
  a.comp = static_cast<T*>(comp);
  a.partial = static_cast<T*>(partial);
  a.sync = sync;
  return B % 4 == 0 ? launch_trop<true, T>(a, n_ctas, st)
                    : launch_trop<false, T>(a, n_ctas, st);
}

}  // namespace

// K6a: the forward sweep over frames 0 .. Nf-1 from a0, one launch.  Frame t
// writes its unscaled state to states[t % n_slots] and its scale to
// scales[t % n_slots] (n_slots = Nf keeps every frame, 2 a ping-pong pair);
// ksum, shift and comp accumulate the exponents and the emission shift (the
// caller zeroes them).  The plan (tiles .. rt_parts, n_ctas CTAs, at most
// max_tiles tiles per range) is ops/dense_scan.py's TilePlan of the forward
// operator.  prec: 0 float tiles and values, 1 bf16 fragments (float
// values), 2 double tiles and values (a0 .. comp and partial are then
// double).  partial holds the plan's partial slots x 32 x B values, sync
// 2 + Sp / 32 x ceil(B / 128) zeroed words and then the 3 x B column-max
// words (double: 64-bit, from the next even word), xb (bf16 only) 2 x
// Sp / 2 x B words.
extern "C" int mm_dense_fwd(const void* tiles, const int* tile_k,
                            const int* lo, const int* seg_ptr, const int* segs,
                            const int* rt_parts, int n_ctas, int max_tiles,
                            const int* spdf, const void* a0, const void* ext,
                            const void* mshift, int Sp, int P1, int B, int Nf,
                            int n_slots, int prec, void* states, void* scales,
                            void* ksum, void* shift, void* comp, void* partial,
                            unsigned* sync, unsigned* xb, void* stream) {
  if (bad_shape(Sp, P1, B, Nf, n_ctas, max_tiles) ||
      (n_slots != Nf && n_slots != 2) || prec < 0 || prec > 2 ||
      (prec == 1 && xb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(tiles, tile_k, lo, seg_ptr, segs, rt_parts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prec == 2)
    return static_cast<int>(launch<false>(
        fwd_args<double>(pl, spdf, a0, ext, mshift, Sp, P1, B, Nf, n_slots,
                         states, scales, ksum, shift, comp, partial, sync, xb),
        prec, n_ctas, max_tiles, st));
  return static_cast<int>(launch<false>(
      fwd_args<float>(pl, spdf, a0, ext, mshift, Sp, P1, B, Nf, n_slots,
                      states, scales, ksum, shift, comp, partial, sync, xb),
      prec, n_ctas, max_tiles, st));
}

// K6t: the tropical forward over launch frames 0 .. Nf-1 from a0, one
// launch of n_ctas CTAs over the plan (src .. parts: ops/dense_scan.py's
// TropPlan of the forward operator, 8 warps a CTA), float values, or double
// with f64 != 0.  Frame t writes its unscaled state to states[t % n_slots]
// and its scale to scales[t % n_slots] (n_slots = Nf or 2).  Launch frame 0
// skips the product only when first != 0 (global frame 0); otherwise it
// multiplies a0, whose scale the caller seeds into sync's third column-max
// row as the bits of 1 / scale.  ksum, shift and comp carry on from their
// values on entry.  partial holds the plan's split rows x B zeroed values
// (zero again on return), sync 33 + Sp x ceil(B / 128) zeroed words and
// then the 3 x B column-max words (double: 64-bit, from the next even
// word).
extern "C" int mm_dense_trop(const int* src, const void* w,
                             const int* pieces, const int* wp,
                             const int* parts, int n_ctas, const int* spdf,
                             const void* a0, const void* ext,
                             const void* mshift, int Sp, int P1, int B,
                             int Nf, int n_slots, int first, int f64,
                             void* states, void* scales, void* ksum,
                             void* shift, void* comp, void* partial,
                             unsigned* sync, void* stream) {
  if (Sp <= 0 || P1 <= 0 || B <= 0 || Nf <= 0 || n_ctas <= 0 ||
      (n_slots != Nf && n_slots != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = f64 ? &trop<double> : &trop<float>;
  return static_cast<int>(run(src, w, pieces, wp, parts, n_ctas, spdf, a0,
                              ext, mshift, Sp, P1, B, Nf, n_slots, first,
                              states, scales, ksum, shift, comp, partial,
                              sync, static_cast<cudaStream_t>(stream)));
}

// K6b: the reverse sweep over frames Nf-1 .. 0 over the forward's alphas
// (Nf, Sp, B) and scales (Nf, B), one launch.  posts (Nf, P1, B) receives
// every frame's normalised pdf posteriors.  work (2, Sp, B), gamma (2, Sp,
// B) and part (2, Sp / 32, B) are scratch; the plan (of the backward
// operator), prec, partial, sync and xb as for mm_dense_fwd.  perm / off:
// the states of pdf p are perm[off[p] .. off[p+1]), in increasing order
// (padding states, whose gamma is always 0, may be left out).
extern "C" int mm_dense_bwd(const void* tiles, const int* tile_k,
                            const int* lo, const int* seg_ptr, const int* segs,
                            const int* rt_parts, int n_ctas, int max_tiles,
                            const int* spdf, const int* perm, const int* off,
                            const void* ext, const void* alphas,
                            const void* ascale, int Sp, int P1, int B, int Nf,
                            int prec, void* work, void* gamma, void* posts,
                            void* part, void* partial, unsigned* sync,
                            unsigned* xb, void* stream) {
  if (bad_shape(Sp, P1, B, Nf, n_ctas, max_tiles) || prec < 0 || prec > 2 ||
      (prec == 1 && xb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(tiles, tile_k, lo, seg_ptr, segs, rt_parts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prec == 2)
    return static_cast<int>(launch<true>(
        bwd_args<double>(pl, spdf, perm, off, ext, alphas, ascale, Sp, P1, B,
                         Nf, work, gamma, posts, part, partial, sync, xb),
        prec, n_ctas, max_tiles, st));
  return static_cast<int>(launch<true>(
      bwd_args<float>(pl, spdf, perm, off, ext, alphas, ascale, Sp, P1, B, Nf,
                      work, gamma, posts, part, partial, sync, xb),
      prec, n_ctas, max_tiles, st));
}
