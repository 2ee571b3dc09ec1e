// Dense forward-backward scan on Hopper (sm_90a).
//
// Replaces the two fused Pallas kernels of markovmodels_tpu/ops/pallas_scan.py:
//   K6a mm_dense_fwd  <- fused_forward pallas_call (_make_fwd_kernel)
//   K6b mm_dense_bwd  <- fused_backward pallas_call (_make_bwd_kernel)
//
// What the card is asked to do, per frame and sweep, at the V=32 LM∘HMM
// denominator (Sp = 3,200 padded states) and B = 128 sequences:
//   * the product Wp (Sp x Sp) @ state (Sp x B): 2*Sp*Sp*B = 2.62 GFLOP of
//     float32 multiply-adds, 39 us at the 67 TFLOP/s non-tensor peak;
//   * the operator, 41 MB per direction, read once (it fits the 50 MB L2
//     only if nothing evicts it), and the 1.6 MB state read by every CTA.
// The TPU kernel pins the whole operator in VMEM for all frames; an SM has
// 227 KB of shared memory, so here the operator streams every frame.  Each
// frame reads the whole previous state, so a frame is a grid-wide
// dependency: as in block_scan.cu, two launches per frame from a host loop
// inside this library:
//   step_kernel     CTAs per 32-row tile of the operator, each covering all
//                   128 batch columns, so each operator element is read
//                   once per frame.  The product is a shared-memory tiled
//                   FMA loop (full float32, no TF32): 32 x 32 operator and
//                   32 x 128 state stages, double-buffered with cp.async;
//                   each thread owns 4 rows x 4 columns, a warp 16 rows x 32
//                   columns, so a 4-deep k step costs 8 shared-memory
//                   wavefronts for 64 FMAs per warp.  The contraction is
//                   split in `split` parts (split-K) so that the CTAs fill
//                   whole waves of SMs: each part writes its partial
//                   product, and the part of a tile that finishes last
//                   (an atomic ticket) sums the partials in part order, a
//                   fixed order, so the result does not depend on which
//                   part finishes last.  That CTA runs the epilogue: the
//                   previous frame's scale and the emission gathered by the
//                   state->pdf map, the state and the per-tile column max
//                   (and, backward, gamma and its column sum);
//   finalize        reduces the per-tile partials in a fixed order, derives
//                   the next power-of-two scale from the exponent bits of
//                   the column max (forward: also ksum and the Kahan shift),
//                   and backward sums gamma over each pdf's states in
//                   increasing state order (a CSR list): deterministic, no
//                   atomics.
// The scale is applied when the next frame reads the state (exact: powers of
// two), so the rescale costs no pass of its own.  Frame 0 of the forward
// skips the product (p = a0) and the last frame of the backward starts from
// beta = 1, as pallas_scan.py:145 and :186 do.
//
// What bounds it: the FMA loop.  At Sp = 3,200 there are only 100 row
// tiles for 132 SMs; one full-K tile is ~58 us of FMA issue on one SM, and
// one CTA of 8 warps per SM hides too little latency, so the contraction
// is split (5 parts at Sp = 3,200: 500 CTAs, up to 3 resident per SM).
// Later designs: TF32/3xTF32 or wgmma, skipping all-zero operator tiles
// (0.4 % of the V=32 operator is non-zero), a persistent kernel.
//
// Precision 'bf16' (pallas_scan.py _mm :76-80 under DEFAULT precision, on
// the products at :144 and :185) is a template branch (BF16) of the step
// kernel: the operator arrives in bf16 (half the bytes: both directions'
// operators, 41 MB together at Sp = 3,200, fit the L2), its stages are
// loaded with cp.async as before, the state stages stay float32 and are
// rounded to bf16 (__floats2bfloat162_rn) as the mma fragments are built,
// and the product runs on the tensor cores (mma.sync m16n8k16, float32
// accumulation): each warp's 16 rows x 32 columns are 4 n8 tiles per
// 16-deep step, product_bf16.  The state is rounded unscaled; rounding to
// bf16 commutes with the power-of-two scale in the normal range, so the
// mantissas are those of the scaled state the TPU kernel rounds.  Split-K,
// the ticket, the epilogue and both finalizes are the float32 code.
//
// Conventions: states (Sp, B) row-major float32; ext (Nf, P1, B); the
// emission of state s is ext[t, spdf[s], b].  A stored state is unscaled,
// with a (B,) scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int TR = 32;        // operator rows per CTA (_TILE_ROWS)
constexpr int TB = 128;       // batch columns per CTA
constexpr int TK = 32;        // contraction depth per stage (_TILE_K)
constexpr int WLD = TK + 4;   // padded row stride of the operator stage
constexpr int NT = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int FC = 8;         // forward finalize: columns per block
constexpr int FR = 128;       // forward finalize: threads per column
constexpr int PC = 32;        // backward finalize: columns per block
constexpr int PY = 8;         // backward finalize: pdfs per block
constexpr int KS = 16;        // bf16: contraction depth of one mma step
constexpr int BWLD = TK + 8;  // bf16: operator stage row (80 bytes)
constexpr int XLD = TB + 4;   // bf16: state stage row (conflict-free reads)

// The operator's element type: bf16 under precision 'bf16', else float.
template <bool BF16>
using OpT = typename std::conditional<BF16, __nv_bfloat16, float>::type;

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

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int b,
                                        int B) {
  if constexpr (VEC) {
    return b < B ? *reinterpret_cast<const float4*>(row + b)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(b < B ? row[b] : 0.f, b + 1 < B ? row[b + 1] : 0.f,
                       b + 2 < B ? row[b + 2] : 0.f,
                       b + 3 < B ? row[b + 3] : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ row, int b, int B,
                                       float4 v) {
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

// Asynchronous copies global -> shared; a false predicate zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Stage {
  float W[TR][WLD];  // operator rows r0 .. r0+TR-1, columns k0 .. k0+TK-1
  float X[TK][TB];   // state rows k0 .. k0+TK-1, columns b0 .. b0+TB-1
};

// A stage of the bf16 product: the operator in bf16, the state in float32
// (rounded when the fragments are built).
struct Stage16 {
  __nv_bfloat16 W[TR][BWLD];  // operator rows r0 .., columns k0 .. k0+TK-1
  float X[TK][XLD];           // state rows k0 .., columns b0 .. b0+TB-1
};

template <bool BF16>
using StageT = typename std::conditional<BF16, Stage16, Stage>::type;

// Issue the copies of one stage: operator rows [r0, r0+TR) x columns
// [k0, k0+TK) (one 16-byte chunk per thread) and state rows [k0, k0+TK) x
// columns [b0, b0+TB) (four chunks per thread, masked past B).
template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& st,
                                           const float* __restrict__ wp,
                                           const float* __restrict__ prev,
                                           int Sp, int B, int r0, int k0,
                                           int b0) {
  const int tid = threadIdx.x;
  {
    const int r = tid / (TK / 4), c = (tid % (TK / 4)) * 4;
    cp_async16(&st.W[r][c], wp + static_cast<size_t>(r0 + r) * Sp + k0 + c,
               true);
  }
#pragma unroll
  for (int u = 0; u < TK * TB / 4 / NT; ++u) {
    const int idx = tid + u * NT;
    const int k = idx / (TB / 4), c = (idx % (TB / 4)) * 4;
    const int b = b0 + c;
    const float* src = prev + static_cast<size_t>(k0 + k) * B;
    if constexpr (VEC) {
      cp_async16(&st.X[k][c], b < B ? src + b : src, b < B);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(&st.X[k][c + j], b + j < B ? src + b + j : src, b + j < B);
    }
  }
}

// The bf16 stage: the operator's TR x TK block as 16-byte chunks (threads
// 0 .. 127), the state as load_stage does, into rows of XLD floats.
template <bool VEC>
__device__ __forceinline__ void load_stage16(
    Stage16& st, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ prev, int Sp, int B, int r0, int k0, int b0) {
  const int tid = threadIdx.x;
  constexpr int WCH = TK / 8;  // 16-byte chunks per operator row
  if (tid < TR * WCH) {
    const int r = tid / WCH, c = (tid % WCH) * 8;
    cp_async16(&st.W[r][c], wp + static_cast<size_t>(r0 + r) * Sp + k0 + c,
               true);
  }
#pragma unroll
  for (int u = 0; u < TK * TB / 4 / NT; ++u) {
    const int idx = tid + u * NT;
    const int k = idx / (TB / 4), c = (idx % (TB / 4)) * 4;
    const int b = b0 + c;
    const float* src = prev + static_cast<size_t>(k0 + k) * B;
    if constexpr (VEC) {
      cp_async16(&st.X[k][c], b < B ? src + b : src, b < B);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(&st.X[k][c + j], b + j < B ? src + b + j : src, b + j < B);
    }
  }
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major): bf16 operands, float32
// accumulation, one warp.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// product's bf16 branch: the same acc[i][j] (the same rows and columns per
// thread) from the tensor cores.  Warp (wr, wc) owns rows wr*16 .. +16 and
// columns wc*32 .. +32 in both layouts, so the accumulators pass from the
// mma fragment layout to acc through the warp's own part of the (then
// idle) stage memory, with no block barrier.
template <bool VEC>
__device__ __forceinline__ void product_bf16(
    Stage16 (&st)[2], const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ prev, int Sp, int B, int r0, int b0, int kt0,
    int kt1, float (&acc)[4][4]) {
  static_assert(TK % KS == 0 && NT == 256 && TR == 32 && TB == 128 &&
                    sizeof(Stage16) * 2 >= sizeof(float) * TR * XLD,
                "bf16 tiles");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4, lr = lane / 8, lc = lane % 8;
  const int g = lane / 4, q = lane % 4;  // fragment row group, its thread
  const int mr = wr * 16, nc = wc * 32;
  float d[4][4] = {};  // [n8 tile][fragment]
  load_stage16<VEC>(st[kt0 & 1], wp, prev, Sp, B, r0, kt0 * TK, b0);
  cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    if (kt + 1 < kt1) {
      load_stage16<VEC>(st[(kt + 1) & 1], wp, prev, Sp, B, r0, (kt + 1) * TK,
                        b0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage16& s = st[kt & 1];
#pragma unroll
    for (int kk = 0; kk < TK; kk += KS) {
      const unsigned a[4] = {lds32(&s.W[mr + g][kk + 2 * q]),
                             lds32(&s.W[mr + g + 8][kk + 2 * q]),
                             lds32(&s.W[mr + g][kk + 2 * q + 8]),
                             lds32(&s.W[mr + g + 8][kk + 2 * q + 8])};
      const int k0 = kk + 2 * q;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = nc + n * 8 + g;
        mma_bf16(d[n], a, pack_bf16(s.X[k0][c], s.X[k0 + 1][c]),
                 pack_bf16(s.X[k0 + 8][c], s.X[k0 + 9][c]));
      }
    }
    __syncthreads();  // the stage is overwritten by the load after next
  }
  auto C = reinterpret_cast<float(*)[XLD]>(&st[0]);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = nc + n * 8 + 2 * q;
    C[mr + g][c] = d[n][0];
    C[mr + g][c + 1] = d[n][1];
    C[mr + g + 8][c] = d[n][2];
    C[mr + g + 8][c + 1] = d[n][3];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v =
        *reinterpret_cast<const float4*>(&C[mr + i * 4 + lr][nc + lc * 4]);
    acc[i][0] = v.x;
    acc[i][1] = v.y;
    acc[i][2] = v.z;
    acc[i][3] = v.w;
  }
}

// acc[i][j] = sum_k wp[row(i), k] * prev[k, col(j)] over the operator
// columns of stages [kt0, kt1), row(i) = r0 + wr*16 + i*4 + lr, col(j) =
// b0 + wc*32 + lc*4 + j (rows interleaved so that a warp's operator reads
// hit distinct banks).
template <bool VEC>
__device__ __forceinline__ void product(Stage (&st)[2],
                                        const float* __restrict__ wp,
                                        const float* __restrict__ prev,
                                        int Sp, int B, int r0, int b0,
                                        int kt0, int kt1, float (&acc)[4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4, lr = lane / 8, lc = lane % 8;
  load_stage<VEC>(st[kt0 & 1], wp, prev, Sp, B, r0, kt0 * TK, b0);
  cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    if (kt + 1 < kt1) {
      load_stage<VEC>(st[(kt + 1) & 1], wp, prev, Sp, B, r0, (kt + 1) * TK,
                      b0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage& s = st[kt & 1];
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const float4*>(&s.W[wr * 16 + i * 4 + lr][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(&s.X[kk + q][wc * 32 + lc * 4]);
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
    __syncthreads();  // the stage is overwritten by the load after next
  }
}

// Four columns b .. b+3 of one row written by another CTA of this launch:
// loaded from L2 (ld.global.cg), past the incoherent L1.
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

// One frame of one sweep over one 32-row tile and 128 columns, contraction
// part blockIdx.y of `split`.
//   BWD = false (K6a): y = (Wp prev)*s (or prev on frame 0), y *= e;
//     part[tile] = column max of y.
//   BWD = true (K6b): y = (Wp prev)*s (or 1 on the last frame);
//     gamma = alpha_t * ascale_t * y, written to gamma_out; beta = y * e;
//     part[0][tile] = column max of beta, part[1][tile] = column sum of
//     gamma.
// BF16: wp in bf16, the product on the tensor cores (product_bf16).
template <bool BWD, bool VEC, bool BF16>
__global__ void __launch_bounds__(NT) step_kernel(
    const OpT<BF16>* __restrict__ wp, const int* __restrict__ spdf, int Sp,
    int B, const float* __restrict__ prev, const float* __restrict__ scale,
    const float* __restrict__ ext_t, int skip_product,
    float* __restrict__ out, float* __restrict__ part,
    const float* __restrict__ alpha_t, const float* __restrict__ ascale_t,
    float* __restrict__ gamma_out, float* partial,
    unsigned* __restrict__ tickets) {
  __shared__ __align__(16) StageT<BF16> st[2];
  __shared__ float red[2][2][TB];  // [max, sum][warp row][column]
  __shared__ int is_last;

  const int tile = blockIdx.x, r0 = tile * TR, b0 = blockIdx.z * TB;
  const int split = gridDim.y, sidx = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4, lr = lane / 8, lc = lane % 8;
  const int bcol = b0 + wc * 32 + lc * 4;  // this thread's 4 columns
  const size_t SB = static_cast<size_t>(Sp) * B;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (skip_product) {
    if (sidx != 0) return;  // one CTA per tile runs the epilogue
  } else {
    const int nk = Sp / TK;
    if constexpr (BF16)
      product_bf16<VEC>(st, wp, prev, Sp, B, r0, b0, sidx * nk / split,
                        (sidx + 1) * nk / split, acc);
    else
      product<VEC>(st, wp, prev, Sp, B, r0, b0, sidx * nk / split,
                   (sidx + 1) * nk / split, acc);
    if (split > 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t rB = static_cast<size_t>(r0 + wr * 16 + i * 4 + lr) * B;
        store4<VEC>(partial + sidx * SB + rB, bcol, B,
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
      __threadfence();  // the partial is visible before the ticket
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned* t = tickets + static_cast<size_t>(tile) * gridDim.z +
                      blockIdx.z;
        is_last = atomicAdd(t, 1u) == static_cast<unsigned>(split - 1);
        if (is_last) *t = 0u;  // every part has its ticket: reset
      }
      __syncthreads();
      if (!is_last) return;
      __threadfence();
      // the sum of the parts in part order, whichever part came last
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t rB = static_cast<size_t>(r0 + wr * 16 + i * 4 + lr) * B;
        float4 v = load4_l2<VEC>(partial + rB, bcol, B);
        for (int q = 1; q < split; ++q) {
          const float4 w = load4_l2<VEC>(partial + q * SB + rB, bcol, B);
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
    }
  }

  const float4 sc = load4<VEC>(scale, bcol, B);
  float4 asc = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (BWD) asc = load4<VEC>(ascale_t, bcol, B);
  float cmax[4] = {0.f, 0.f, 0.f, 0.f}, csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + wr * 16 + i * 4 + lr;
    const size_t rB = static_cast<size_t>(r) * B;
    const float4 e = load4<VEC>(ext_t + static_cast<size_t>(spdf[r]) * B,
                                bcol, B);
    float v[4];
    if constexpr (!BWD) {
      const float4 p = skip_product ? load4<VEC>(prev + rB, bcol, B) : sc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (skip_product ? get(p, j) : acc[i][j] * get(sc, j)) * get(e, j);
        cmax[j] = fmaxf(cmax[j], v[j]);
      }
    } else {
      const float4 a = load4<VEC>(alpha_t + rB, bcol, B);
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = skip_product ? 1.f : acc[i][j] * get(sc, j);
        g[j] = get(a, j) * get(asc, j) * y;
        csum[j] += g[j];
        v[j] = y * get(e, j);
        cmax[j] = fmaxf(cmax[j], v[j]);
      }
      store4<VEC>(gamma_out + rB, bcol, B, make_float4(g[0], g[1], g[2], g[3]));
    }
    store4<VEC>(out + rB, bcol, B, make_float4(v[0], v[1], v[2], v[3]));
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
  const int c = threadIdx.x;
  if (c < TB && b0 + c < B) {
    const size_t n_tiles = gridDim.x;
    part[static_cast<size_t>(tile) * B + b0 + c] =
        fmaxf(red[0][0][c], red[0][1][c]);
    if constexpr (BWD)
      part[(n_tiles + tile) * B + b0 + c] = red[1][0][c] + red[1][1][c];
  }
}

// Forward end of a frame, per column: the column max over the tiles (a
// fixed-order tree), the new scale 2^-k, ksum += k and the Kahan-compensated
// emission shift.
__global__ void __launch_bounds__(FC * FR) finalize_fwd_kernel(
    int B, int n_tiles, const float* __restrict__ part,
    float* __restrict__ scale_out, const float* __restrict__ mshift_t,
    float* __restrict__ ksum, float* __restrict__ shift,
    float* __restrict__ comp) {
  __shared__ float r0[FR][FC];
  const int bl = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.x * FC + bl;
  float mx = 0.f;
  if (b < B)
    for (int t = ry; t < n_tiles; t += FR)
      mx = fmaxf(mx, part[static_cast<size_t>(t) * B + b]);
  r0[ry][bl] = mx;
  __syncthreads();
  for (int h = FR / 2; h > 0; h /= 2) {
    if (ry < h) r0[ry][bl] = fmaxf(r0[ry][bl], r0[ry + h][bl]);
    __syncthreads();
  }
  if (b >= B || ry != 0) return;
  const float k = pow2_exponent(r0[0][bl]);
  scale_out[b] = pow2_scale(k);
  ksum[b] += k;
  const float xc = mshift_t[b] - comp[b];
  const float t = shift[b] + xc;
  comp[b] = (t - shift[b]) - xc;
  shift[b] = t;
}

// Backward end of a frame: posts_t[p, b] = (sum of gamma over pdf p's
// states, in increasing state order) / (column sum of gamma, or 1 where it
// is 0), and the new scale of beta from its column max.  The PY threads of
// a column split the tile partials and add their sums in a fixed order.
__global__ void __launch_bounds__(PC * PY) finalize_bwd_kernel(
    int B, int P1, int n_tiles, const float* __restrict__ part,
    const float* __restrict__ gamma, const int* __restrict__ perm,
    const int* __restrict__ off, float* __restrict__ posts_t,
    float* __restrict__ scale_out) {
  __shared__ float rsum[PY][PC], rmax[PY][PC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.x * PC + tx;
  const int p = blockIdx.y * PY + ty;
  const bool want_max = blockIdx.y == 0;  // one block row sets the scale
  float sm = 0.f, mx = 0.f;
  if (b < B) {
    for (int t = ty; t < n_tiles; t += PY) {
      sm += part[(static_cast<size_t>(n_tiles) + t) * B + b];
      if (want_max) mx = fmaxf(mx, part[static_cast<size_t>(t) * B + b]);
    }
  }
  rsum[ty][tx] = sm;
  rmax[ty][tx] = mx;
  __syncthreads();
  if (b >= B) return;
  float tot = 0.f;
#pragma unroll
  for (int q = 0; q < PY; ++q) tot += rsum[q][tx];
  const float den = tot > 0.f ? tot : 1.f;
  if (p < P1) {
    float g = 0.f;
#pragma unroll 8
    for (int q = off[p]; q < off[p + 1]; ++q)
      g += gamma[static_cast<size_t>(perm[q]) * B + b];
    posts_t[static_cast<size_t>(p) * B + b] = g / den;
  }
  if (want_max && ty == 0) {
    float m = 0.f;
#pragma unroll
    for (int q = 0; q < PY; ++q) m = fmaxf(m, rmax[q][tx]);
    scale_out[b] = pow2_scale(pow2_exponent(m));
  }
}

struct Split {
  int parts;         // contraction parts per tile (1: no partials)
  float* partial;    // (parts, Sp, B) partial products
  unsigned* tickets; // (Sp / TR) x ceil(B / TB), zero between launches
};

template <bool BWD, bool BF16>
cudaError_t launch_step_t(cudaStream_t st, const void* wp, const int* spdf,
                          int Sp, int B, const float* prev,
                          const float* scale, const float* e, int skip,
                          float* out, float* part, const float* alpha_t,
                          const float* ascale_t, float* gamma_out,
                          const Split& sk) {
  const dim3 grid(Sp / TR, sk.parts, (B + TB - 1) / TB);
  const OpT<BF16>* w = static_cast<const OpT<BF16>*>(wp);
  if (B % 4 == 0)
    step_kernel<BWD, true, BF16><<<grid, NT, 0, st>>>(
        w, spdf, Sp, B, prev, scale, e, skip, out, part, alpha_t, ascale_t,
        gamma_out, sk.partial, sk.tickets);
  else
    step_kernel<BWD, false, BF16><<<grid, NT, 0, st>>>(
        w, spdf, Sp, B, prev, scale, e, skip, out, part, alpha_t, ascale_t,
        gamma_out, sk.partial, sk.tickets);
  return cudaGetLastError();
}

// One step launch; bf16: wp is bf16 (precision 'bf16').
template <bool BWD>
cudaError_t launch_step(cudaStream_t st, const void* wp, bool bf16,
                        const int* spdf, int Sp, int B, const float* prev,
                        const float* scale, const float* e, int skip,
                        float* out, float* part, const float* alpha_t,
                        const float* ascale_t, float* gamma_out,
                        const Split& sk) {
  return bf16 ? launch_step_t<BWD, true>(st, wp, spdf, Sp, B, prev, scale, e,
                                         skip, out, part, alpha_t, ascale_t,
                                         gamma_out, sk)
              : launch_step_t<BWD, false>(st, wp, spdf, Sp, B, prev, scale, e,
                                          skip, out, part, alpha_t, ascale_t,
                                          gamma_out, sk);
}

bool bad_shape(int Sp, int P1, int B, int Nf, int split) {
  return Sp <= 0 || Sp % TR || Sp % TK || P1 <= 0 || B <= 0 || Nf <= 0 ||
         split < 1 || split > Sp / TK;
}

}  // namespace

// K6a: the forward sweep over frames 0 .. Nf-1 from a0.  Frame t writes its
// unscaled state to states[t % n_slots] and its scale to scales[t % n_slots]
// (n_slots = Nf keeps every frame, 2 a ping-pong pair); ksum, shift and comp
// accumulate the exponents and the emission shift (the caller zeroes them).
// part holds Sp / 32 x B floats; split > 1 needs partial (split, Sp, B) and
// zeroed tickets (Sp / 32 x ceil(B / 128) unsigned).  wp: float, or bf16
// when bf16 != 0 (precision 'bf16').
extern "C" int mm_dense_fwd(const void* wp, const int* spdf, const float* a0,
                            const float* ext, const float* mshift, int Sp,
                            int P1, int B, int Nf, int n_slots, int split,
                            int bf16, float* states, float* scales,
                            float* ksum, float* shift, float* comp,
                            float* part, float* partial, unsigned* tickets,
                            void* stream) {
  if (bad_shape(Sp, P1, B, Nf, split) || (n_slots != Nf && n_slots != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Split sk{split, partial, tickets};
  const size_t SB = static_cast<size_t>(Sp) * B;
  const int n_tiles = Sp / TR;
  for (int t = 0; t < Nf; ++t) {
    const int cur = t % n_slots, prv = (t + n_slots - 1) % n_slots;
    const float* prev = t == 0 ? a0 : states + prv * SB;
    float* s_cur = scales + static_cast<size_t>(cur) * B;
    const float* s_prev = t == 0 ? s_cur : scales + static_cast<size_t>(prv) * B;
    cudaError_t err = launch_step<false>(
        st, wp, bf16, spdf, Sp, B, prev, s_prev,
        ext + static_cast<size_t>(t) * P1 * B, t == 0, states + cur * SB, part,
        nullptr, nullptr, nullptr, sk);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_fwd_kernel<<<(B + FC - 1) / FC, dim3(FC, FR), 0, st>>>(
        B, n_tiles, part, s_cur, mshift + static_cast<size_t>(t) * B, ksum,
        shift, comp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b: the reverse sweep over frames Nf-1 .. 0 over the forward's alphas
// (Nf, Sp, B) and scales (Nf, B).  posts (Nf, P1, B) receives every frame's
// normalised pdf posteriors.  work (2, Sp, B), bscale (2, B) and gamma
// (Sp, B) are scratch; part holds 2 x Sp / 32 x B floats; split, partial
// and tickets as for mm_dense_fwd.  perm / off: the states of pdf p are
// perm[off[p] .. off[p+1]), in increasing order (padding states, whose
// gamma is always 0, may be left out).  wp and bf16 as for mm_dense_fwd.
extern "C" int mm_dense_bwd(const void* wp, const int* spdf, const int* perm,
                            const int* off, const float* ext,
                            const float* alphas, const float* ascale, int Sp,
                            int P1, int B, int Nf, int split, int bf16,
                            float* work, float* bscale, float* gamma,
                            float* posts, float* part, float* partial,
                            unsigned* tickets, void* stream) {
  if (bad_shape(Sp, P1, B, Nf, split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Split sk{split, partial, tickets};
  const size_t SB = static_cast<size_t>(Sp) * B;
  const int n_tiles = Sp / TR;
  const dim3 fin_grid((B + PC - 1) / PC, (P1 + PY - 1) / PY);
  for (int t = Nf - 1; t >= 0; --t) {
    const int cur = t % 2, prv = (t + 1) % 2;
    cudaError_t err = launch_step<true>(
        st, wp, bf16, spdf, Sp, B, work + prv * SB,
        bscale + static_cast<size_t>(prv) * B,
        ext + static_cast<size_t>(t) * P1 * B, t == Nf - 1, work + cur * SB,
        part, alphas + t * SB, ascale + static_cast<size_t>(t) * B, gamma,
        sk);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_bwd_kernel<<<fin_grid, dim3(PC, PY), 0, st>>>(
        B, P1, n_tiles, part, gamma, perm, off,
        posts + static_cast<size_t>(t) * P1 * B,
        bscale + static_cast<size_t>(cur) * B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
