// Dense forward-backward scan on Hopper (sm_90a): one persistent,
// block-sparse launch per sweep.
//
// Replaces the two fused Pallas kernels of markovmodels_tpu/ops/pallas_scan.py:
//   K6a mm_dense_fwd  <- fused_forward pallas_call (:220, _make_fwd_kernel)
//   K6b mm_dense_bwd  <- fused_backward pallas_call (:269, _make_bwd_kernel)
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
// Conventions: states (Sp, B) row-major float32; ext (Nf, P1, B); the
// emission of state s is ext[t, spdf[s], b].  A stored state is unscaled,
// with a (B,) scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "coop_common.cuh"

namespace {

constexpr int TR = 32;        // operator rows per tile
constexpr int TK = 32;        // operator columns (contraction) per tile
constexpr int TB = 128;       // batch columns per column block
constexpr int NT = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int NW = NT / 32;
constexpr int WLD = TK + 4;   // float32 tile row in shared memory
constexpr int XW = TB + 8;    // bf16 state stage: words per row pair
constexpr int XLD = TB + 4;   // bf16 accumulator scratch row
constexpr int PY = 8;         // backward pdf sums: thread rows per item
constexpr int PC = 32;        // backward pdf sums: columns per item
constexpr int PPI = 2;        // backward pdf sums: pdfs per item

// shared-memory bytes of one tile and of one state stage, per precision
constexpr int TILE_F = TR * WLD * 4;       // 4,608
constexpr int TILE_H = TR * TK * 2;        // 2,048 (A-fragment order)
constexpr int XST_F = TK * TB * 4;         // 16,384
constexpr int XST_H = TK / 2 * XW * 4;     // 8,704
constexpr int SCR_H = TR * XLD * 4;        // 16,896

// The host plan of one direction's operator (ops/dense_scan.py TilePlan).
struct Plan {
  const void* tiles;    // (T, 1024): float row-major, or bf16 fragments
  const int* tile_k;    // (T,) k tile of each packed tile
  const int* lo;        // (G + 1,) each CTA's range of packed tiles
  const int* seg_ptr;   // (G + 1,) each CTA's segments
  const int4* segs;     // (row tile, first tile, end tile, partial slot)
  const int2* rt_parts; // per row tile (first partial slot, partials)
};

struct Args {
  Plan pl;
  const int* spdf;
  int Sp, P1, B, Nf, n_slots, resident;
  const float* ext;
  // forward
  const float* a0;
  const float* mshift;
  float* states;
  float* scales;
  float* ksum;
  float* shift;
  float* comp;
  // backward
  const int* perm;
  const int* off;
  const float* alphas;
  const float* ascale;
  float* work;      // (2, Sp, B) beta
  float* gamma;     // (2, Sp, B)
  float* posts;
  float* part;      // (2, Sp / 32, B) column sums of gamma per row tile
  // scratch
  float* partial;   // (partial slots, 32, B)
  // [count, generation, tickets (Sp / 32 x column blocks), column max
  // (3, B)], zeroed by the caller
  unsigned* sync;
  unsigned* xb;     // bf16: (2, Sp / 2, B) words, the state in row pairs
};

// floor(log2 m) from the exponent bits, 0 for m == 0, clamped at -126 so
// that the scale 2^-k stays finite (block_scan._pow2_exponent).
__device__ __forceinline__ float pow2_exponent(float m) {
  if (!(m > 0.f)) return 0.f;
  int e;
  frexpf(m, &e);
  return fmaxf(static_cast<float>(e - 1), -126.f);
}

// 2^-k for an integer k in [-126, 126], built from its exponent bits.
__device__ __forceinline__ float pow2_scale(float k) {
  return __int_as_float((127 - static_cast<int>(k)) << 23);
}

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

__device__ __forceinline__ float get(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
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
struct Frame {
  const float* prev;        // the previous state (forward frame 0: a0)
  const float* ext_t;       // (P1, B) emissions
  float* out;               // the new state
  const unsigned* cm_prev;  // the previous state's column max (float bits)
  unsigned* cm_cur;         // this frame's, taken with atomicMax
  unsigned* cm_next;        // the next frame's, zeroed during this one
  const unsigned* xb_prev;  // bf16: the previous state in row pairs
  unsigned* xb_out;         // bf16: the new state in row pairs
  const float* alpha_t;     // backward: alphas[t], ascale[t]
  const float* ascale_t;
  float* gamma;             // backward: this frame's gamma (Sp, B)
  float* csum;              // backward: its column sums per row tile
  int t;
};

template <bool BF16>
struct Layout {
  static constexpr int TILE = BF16 ? TILE_H : TILE_F;
  static constexpr int XST = BF16 ? XST_H : XST_F;
  static constexpr int SCR = BF16 ? SCR_H : 0;
  // 16-byte chunks of one packed tile in global memory
  static constexpr int TILE_CHUNKS = TR * TK * (BF16 ? 2 : 4) / 16;
  // dynamic shared memory: resident tiles, two stages (the state block,
  // then the streamed tile), the bf16 accumulator scratch
  static size_t bytes(bool resident, int max_tiles) {
    return (resident ? static_cast<size_t>(max_tiles) * TILE : 0) +
           2 * static_cast<size_t>(XST + (resident ? 0 : TILE)) + SCR;
  }
};

// The exact power-of-two scale of a column from its max's float bits.
__device__ __forceinline__ float scale_of(const unsigned* cm, int b, int B) {
  return b < B ? pow2_scale(pow2_exponent(__uint_as_float(__ldcg(cm + b))))
               : 0.f;
}

template <bool BWD, bool VEC, bool BF16>
struct Sweep {
  using L = Layout<BF16>;
  const Args& p;
  unsigned char* res;   // resident tiles
  unsigned char* stg;   // stage ring
  float* scr;           // bf16 accumulator scratch
  int stage_bytes, lo, n_mine;
  float (*red)[2][TB];
  int* flag;

  // rows r0 + wr*16 + i*4 + lr (i < 4) and columns b0 + wc*32 + lc*4 + j
  // (j < 4) of a 32 x 128 block belong to this thread
  int tid, warp, lane, wr, wc, lr, lc;

  __device__ Sweep(const Args& a, unsigned char* smem, float (*r)[2][TB],
                   int* f)
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
    scr = reinterpret_cast<float*>(stg + 2 * stage_bytes);
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
        static_cast<size_t>(lo) * TR * TK * (BF16 ? 2 : 4);
    for (int ch = tid; ch < n_mine * CH; ch += NT) {
      const int j = ch / CH, w = ch % CH;
      unsigned char* dst = res + static_cast<size_t>(j) * L::TILE;
      if constexpr (BF16)
        dst += w * 16;
      else
        dst += (w / 8) * WLD * 4 + (w % 8) * 16;
      cp_async16(dst, src + static_cast<size_t>(ch) * 16, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  __device__ const unsigned char* tile_at(int j) const {
    return p.resident ? res + static_cast<size_t>(j) * L::TILE
                      : stage(j) + L::XST;
  }

  // Issue the copies of local tile j into its stage: the state block of
  // its k tile (columns b0 .. b0+127) and, streaming, the tile itself.
  __device__ void issue(const Frame& fr, int j, int b0) {
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
      float* X = reinterpret_cast<float*>(st);
      const float* src = fr.prev + static_cast<size_t>(kt) * TK * B;
#pragma unroll
      for (int u = 0; u < TK * TB / 4 / NT; ++u) {
        const int idx = tid + u * NT, k = idx / (TB / 4),
                  c = (idx % (TB / 4)) * 4, b = b0 + c;
        const float* s = src + static_cast<size_t>(k) * B;
        if constexpr (VEC) {
          cp_async16(&X[k * TB + c], b < B ? s + b : s, b < B);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            X[k * TB + c + q] = b + q < B ? __ldcg(s + b + q) : 0.f;
        }
      }
      if (!p.resident) {
        const int r = tid / 8, c4 = (tid % 8) * 4;
        cp_async16(st + L::XST + (r * WLD + c4) * 4,
                   static_cast<const float*>(p.pl.tiles) +
                       static_cast<size_t>(i) * TR * TK + r * TK + c4,
                   true);
      }
    }
    cp_async_commit();
  }

  // acc += tile j (float32) times its staged state block.
  __device__ void mul_f32(int j, float (&acc)[4][4]) const {
    const float* W = reinterpret_cast<const float*>(tile_at(j));
    const float* X = reinterpret_cast<const float*>(stage(j));
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const float4*>(
            &W[(wr * 16 + i * 4 + lr) * WLD + kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            &X[(kk + q) * TB + wc * 32 + lc * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = get(w[i], q);
          acc[i][0] = fmaf(wv, x.x, acc[i][0]);
          acc[i][1] = fmaf(wv, x.y, acc[i][1]);
          acc[i][2] = fmaf(wv, x.z, acc[i][2]);
          acc[i][3] = fmaf(wv, x.w, acc[i][3]);
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
  __device__ void epilogue(const Frame& fr, int rt, int b0, bool skip,
                           const float (&acc)[4][4]) {
    const int B = p.B, r0 = rt * TR, bcol = b0 + wc * 32 + lc * 4;
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[j] = skip ? 0.f : scale_of(fr.cm_prev, bcol + j, B);
    float4 asc = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (BWD) asc = load4<VEC>(fr.ascale_t, bcol, B);
    float cmax[4] = {0.f, 0.f, 0.f, 0.f}, csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + wr * 16 + i * 4 + lr;
      const size_t rB = static_cast<size_t>(r) * B;
      const float4 e = load4<VEC>(
          fr.ext_t + static_cast<size_t>(__ldg(p.spdf + r)) * B, bcol, B);
      float v[4];
      if constexpr (!BWD) {
        float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (skip) pv = load4_l2<VEC>(fr.prev + rB, bcol, B);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = (skip ? get(pv, j) : acc[i][j] * sc[j]) * get(e, j);
          cmax[j] = fmaxf(cmax[j], v[j]);
        }
      } else {
        const float4 a = load4<VEC>(fr.alpha_t + rB, bcol, B);
        float g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = skip ? 1.f : acc[i][j] * sc[j];
          g[j] = get(a, j) * get(asc, j) * y;
          csum[j] += g[j];
          v[j] = y * get(e, j);
          cmax[j] = fmaxf(cmax[j], v[j]);
        }
        store4<VEC>(fr.gamma + rB, bcol, B,
                    make_float4(g[0], g[1], g[2], g[3]));
      }
      store4<VEC>(fr.out + rB, bcol, B, make_float4(v[0], v[1], v[2], v[3]));
      if constexpr (BF16) {
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
        cmax[j] = fmaxf(cmax[j], __shfl_xor_sync(0xffffffffu, cmax[j], m));
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
      atomicMax(fr.cm_cur + b0 + c,
                __float_as_uint(fmaxf(red[0][0][c], red[0][1][c])));
      if constexpr (BWD)
        fr.csum[static_cast<size_t>(rt) * B + b0 + c] =
            red[1][0][c] + red[1][1][c];
    }
    __syncthreads();  // red is free for the next epilogue
  }

  // A straddling row tile: write this range's partial, take a ticket; the
  // range that takes the last one adds the partials in range order and
  // runs the epilogue.
  __device__ void partial(const Frame& fr, int rt, int b0, int cb, int slot,
                          float (&acc)[4][4]) {
    const int B = p.B, bcol = b0 + wc * 32 + lc * 4;
    const size_t SB = static_cast<size_t>(TR) * B;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4<VEC>(p.partial + slot * SB +
                      static_cast<size_t>(wr * 16 + i * 4 + lr) * B,
                  bcol, B,
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
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
      float4 v = load4_l2<VEC>(p.partial + rp.x * SB + row, bcol, B);
      for (int q = 1; q < rp.y; ++q) {
        const float4 w = load4_l2<VEC>(p.partial + (rp.x + q) * SB + row,
                                       bcol, B);
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
  __device__ void product(const Frame& fr, Pre&& pre) {
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
        float acc[4][4] = {};
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
            mul_f32(j, acc);
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
  __device__ void no_product(const Frame& fr) {
    const float acc[4][4] = {};
    const int n_rt = p.Sp / TR, ncb = (p.B + TB - 1) / TB;
    for (int rt = blockIdx.x; rt < n_rt; rt += gridDim.x)
      for (int cb = 0; cb < ncb; ++cb) epilogue(fr, rt, cb * TB, true, acc);
  }

  // The last CTA's share of each frame: zero the next frame's column max
  // (read for the last time one frame ago).
  __device__ void clear_next(const Frame& fr) {
    if (blockIdx.x != gridDim.x - 1) return;
    for (int b = tid; b < p.B; b += NT) fr.cm_next[b] = 0u;
  }

  // Forward outputs of frame t, once its column max is complete: the
  // scale 2^-k, ksum += k and the Kahan-compensated emission shift (the
  // last CTA, one thread per column).
  __device__ void frame_out(int t) {
    if (blockIdx.x != gridDim.x - 1) return;
    const int B = p.B;
    const unsigned* cm = cm_row(t);
    const float* msh = p.mshift + static_cast<size_t>(t) * B;
    float* scale = p.scales + static_cast<size_t>(t % p.n_slots) * B;
    for (int b = tid; b < B; b += NT) {
      const float k = pow2_exponent(__uint_as_float(__ldcg(cm + b)));
      scale[b] = pow2_scale(k);
      p.ksum[b] += k;
      const float xc = __ldg(msh + b) - p.comp[b];
      const float s = p.shift[b] + xc;
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
  __device__ void posts_of(int f, float (*rs)[PY][PC]) {
    constexpr int SPL = PY / PPI;  // thread rows per pdf
    const int B = p.B, P1 = p.P1, n_rt = p.Sp / TR, t = p.Nf - 1 - f;
    const int ncol = (B + PC - 1) / PC;
    const int n_items = ncol * ((P1 + PPI - 1) / PPI);
    const int tx = tid % PC, ty = tid / PC;
    const float* gamma = p.gamma + static_cast<size_t>(f % 2) * p.Sp * B;
    const float* cs = p.part + static_cast<size_t>(f % 2) * n_rt * B;
    float* posts_t = p.posts + static_cast<size_t>(t) * P1 * B;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int b = (item % ncol) * PC + tx;
      const int pd = (item / ncol) * PPI + ty / SPL, part = ty % SPL;
      float sm = 0.f, g = 0.f;
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
        float tot = 0.f, gs = 0.f;
#pragma unroll
        for (int q = 0; q < PY; ++q) tot += rs[0][q][tx];
#pragma unroll
        for (int q = 0; q < SPL; ++q) gs += rs[1][ty + q][tx];
        posts_t[static_cast<size_t>(pd) * B + b] = gs / (tot > 0.f ? tot : 1.f);
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
    constexpr int LINE = 32;  // floats per 128-byte line
    const float* e = p.ext + static_cast<size_t>(t) * p.P1 * B;
    const int n_e = (p.P1 * B + LINE - 1) / LINE;
    for (int i = blockIdx.x * NT + tid; i < n_e; i += gridDim.x * NT)
      prefetch_l2(e + static_cast<size_t>(i) * LINE);
    if constexpr (BWD) {
      const int s0 = p.pl.seg_ptr[blockIdx.x];
      const int per_rt = (TR * B + LINE - 1) / LINE;
      const int n_a = (p.pl.seg_ptr[blockIdx.x + 1] - s0) * per_rt;
      const float* a = p.alphas + static_cast<size_t>(t) * p.Sp * B;
      for (int i = tid; i < n_a; i += NT) {
        const int rt = p.pl.segs[s0 + i / per_rt].x;
        prefetch_l2(a + static_cast<size_t>(rt) * TR * B +
                    static_cast<size_t>(i % per_rt) * LINE);
      }
    }
  }

  // The column max of frame f's state: three buffers in turn.
  __device__ unsigned* cm_row(int f) const {
    const int n_rt = p.Sp / TR, ncb = (p.B + TB - 1) / TB;
    return p.sync + 2 + static_cast<size_t>(n_rt) * ncb +
           static_cast<size_t>(f % 3) * p.B;
  }

  __device__ Frame frame(int f) const {
    const int Nf = p.Nf, B = p.B;
    const size_t SB = static_cast<size_t>(p.Sp) * B;
    const size_t XB = static_cast<size_t>(p.Sp / 2) * B;
    Frame fr{};
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
template <bool BWD, bool VEC, bool BF16>
__global__ void __launch_bounds__(NT, 2) sweep_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][2][TB];  // [max, sum][warp row][column]
  __shared__ float rsum[2][PY][PC];  // backward pdf sums: [den, gamma]
  __shared__ int flag;
  Sweep<BWD, VEC, BF16> sw(p, smem, red, &flag);
  sw.load_resident();
  for (int f = 0; f < p.Nf; ++f) {
    const Frame fr = sw.frame(f);
    sw.clear_next(fr);
    sw.prefetch_next(f);
    if (f == 0) {
      sw.no_product(fr);  // forward: p = a0; backward: beta = 1
    } else {
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
template <bool BWD, bool VEC, bool BF16>
cudaError_t launch_t(Args a, int n_ctas, int max_tiles, cudaStream_t st) {
  using L = Layout<BF16>;
  const void* kern = reinterpret_cast<const void*>(sweep_kernel<BWD, VEC, BF16>);
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

template <bool BWD>
cudaError_t launch(const Args& a, bool bf16, int n_ctas, int max_tiles,
                   cudaStream_t st) {
  const bool vec = a.B % 4 == 0;
  if (bf16)
    return vec ? launch_t<BWD, true, true>(a, n_ctas, max_tiles, st)
               : launch_t<BWD, false, true>(a, n_ctas, max_tiles, st);
  return vec ? launch_t<BWD, true, false>(a, n_ctas, max_tiles, st)
             : launch_t<BWD, false, false>(a, n_ctas, max_tiles, st);
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

}  // namespace

// K6a: the forward sweep over frames 0 .. Nf-1 from a0, one launch.  Frame t
// writes its unscaled state to states[t % n_slots] and its scale to
// scales[t % n_slots] (n_slots = Nf keeps every frame, 2 a ping-pong pair);
// ksum, shift and comp accumulate the exponents and the emission shift (the
// caller zeroes them).  The plan (tiles .. rt_parts, n_ctas CTAs, at most
// max_tiles tiles per range) is ops/dense_scan.py's TilePlan of the forward
// operator: float tiles, or bf16 fragments when bf16 != 0.  partial holds
// the plan's partial slots x 32 x B floats, sync 2 + Sp / 32 x
// ceil(B / 128) + 3 x B zeroed words, xb (bf16 only) 2 x Sp / 2 x B words.
extern "C" int mm_dense_fwd(const void* tiles, const int* tile_k,
                            const int* lo, const int* seg_ptr, const int* segs,
                            const int* rt_parts, int n_ctas, int max_tiles,
                            const int* spdf, const float* a0, const float* ext,
                            const float* mshift, int Sp, int P1, int B, int Nf,
                            int n_slots, int bf16, float* states,
                            float* scales, float* ksum, float* shift,
                            float* comp, float* partial, unsigned* sync,
                            unsigned* xb, void* stream) {
  if (bad_shape(Sp, P1, B, Nf, n_ctas, max_tiles) ||
      (n_slots != Nf && n_slots != 2) || (bf16 && xb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.pl = plan_of(tiles, tile_k, lo, seg_ptr, segs, rt_parts);
  a.spdf = spdf;
  a.Sp = Sp;
  a.P1 = P1;
  a.B = B;
  a.Nf = Nf;
  a.n_slots = n_slots;
  a.ext = ext;
  a.a0 = a0;
  a.mshift = mshift;
  a.states = states;
  a.scales = scales;
  a.ksum = ksum;
  a.shift = shift;
  a.comp = comp;
  a.partial = partial;
  a.sync = sync;
  a.xb = xb;
  return static_cast<int>(launch<false>(a, bf16 != 0, n_ctas, max_tiles,
                                        static_cast<cudaStream_t>(stream)));
}

// K6b: the reverse sweep over frames Nf-1 .. 0 over the forward's alphas
// (Nf, Sp, B) and scales (Nf, B), one launch.  posts (Nf, P1, B) receives
// every frame's normalised pdf posteriors.  work (2, Sp, B), gamma (2, Sp,
// B) and part (2, Sp / 32, B) are scratch; the plan (of the backward
// operator), partial, sync and xb as for mm_dense_fwd.  perm / off: the
// states of pdf p are perm[off[p] .. off[p+1]), in increasing order
// (padding states, whose gamma is always 0, may be left out).
extern "C" int mm_dense_bwd(const void* tiles, const int* tile_k,
                            const int* lo, const int* seg_ptr, const int* segs,
                            const int* rt_parts, int n_ctas, int max_tiles,
                            const int* spdf, const int* perm, const int* off,
                            const float* ext, const float* alphas,
                            const float* ascale, int Sp, int P1, int B, int Nf,
                            int bf16, float* work, float* gamma, float* posts,
                            float* part, float* partial, unsigned* sync,
                            unsigned* xb, void* stream) {
  if (bad_shape(Sp, P1, B, Nf, n_ctas, max_tiles) || (bf16 && xb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.pl = plan_of(tiles, tile_k, lo, seg_ptr, segs, rt_parts);
  a.spdf = spdf;
  a.Sp = Sp;
  a.P1 = P1;
  a.B = B;
  a.Nf = Nf;
  a.n_slots = 2;
  a.ext = ext;
  a.perm = perm;
  a.off = off;
  a.alphas = alphas;
  a.ascale = ascale;
  a.work = work;
  a.gamma = gamma;
  a.posts = posts;
  a.part = part;
  a.partial = partial;
  a.sync = sync;
  a.xb = xb;
  return static_cast<int>(launch<true>(a, bf16 != 0, n_ctas, max_tiles,
                                       static_cast<cudaStream_t>(stream)));
}
