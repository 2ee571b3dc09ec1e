// Blocked forward-backward scan of the LF-MMI denominator on Hopper (sm_90a).
//
// Replaces the three fused Pallas kernels of markovmodels_tpu/ops/pallas_block.py:
//   K2 mm_block_fwd        <- _run_slice forward pallas_call, _make_fwd_kernel
//   K3 mm_block_recompute  <- _run_slice recompute pallas_call, _make_recompute_kernel
//   K4 mm_block_bwd        <- _run_slice backward pallas_call, _make_bwd_kernel
// and their shared in-kernel matvec K1 (_make_matvec), here the __device__
// function tier_tile() plus the band/omega epilogue of step_kernel().
//
// What the card is asked to do, per frame and sweep, at the 2M-arc graph
// (Sp = 49,280 states, one tier of K = 128 panels of Sm x D = 128 x 128) and
// B = 128 sequences:
//   * the tier: K*Sm*D*B*2 = 537 MFLOP of float32 multiply-adds;
//   * the state: 25 MB read and 25 MB written (plus 25 MB of alphas read by
//     the backward), against a 50 MB L2;
//   * three reductions over the whole state: the omega dot into the phony
//     state, the per-column max behind the rescale, and the posterior
//     normaliser.
// Each frame reads the whole previous state, so a frame is a grid-wide
// dependency.  This first design runs two launches per frame from a host
// loop inside this library:
//   step_kernel     one block per (64-row tile, 64-column tile): a tier tile
//                   computes its 64 destination rows as a 64x64x128 product
//                   in shared memory (FMA on the CUDA cores: full float32,
//                   like HIGHEST on the TPU), adds the band terms, applies
//                   the emission and writes the state; the remaining rows
//                   (band-only rows, listed once per graph) take the same
//                   epilogue without the product.  Every block writes its
//                   per-column partial max and partial sum (omega dot or
//                   posterior normaliser) to a partials buffer: no atomics
//                   in the forward;
//   finalize_kernel reduces the partials in a fixed order (deterministic),
//                   sets the phony state, and derives the next power-of-two
//                   scale from the exponent bits of the column max.
// The scale is applied when the next frame reads the state (exact: powers
// of two), so the rescale costs no pass of its own; every frame is rescaled.
// The tier is computed by destination (pull): each destination row is
// produced by exactly one (k, d), so the tier needs no atomics either.  The
// backward's per-pdf-group posterior sums cross tiles and use atomicAdd on
// float: each (group, column) gets at most two contributions (admission
// checks it, block_scan._posterior_tiles), which add in the same result in
// either order.
//
// The capped layout of a separate-state backoff graph (ov_layout) adds the
// overflow branch of K1 (pallas_block.py apply_ov, and the per-lane
// emissions and posteriors of K2-K4): nOv lane-groups of overflow rows
// [ov_lo, ov_hi), each row with its own pdf, joined to the core by
// overflow families.  Here every row's pdf comes from one table
// (Layout::row_pdf: the group in the uniform rows, the lane's pdf in the
// overflow rows, the phony pdf in the tail), and the families arrive as
// per-row lists of (source, weight) terms in a fixed order (the host
// expands 'in' families into the overflow rows' lists and 'out' families
// into the core rows' lists), which the row's threads pull after the bands:
// no atomics, deterministic.  A row with a long list (an 'in' window: 128
// terms) would keep its 64-row tile busy for ~100 us of dependent loads,
// so such heavy rows take a tile each (the first blocks of the grid, so
// that their loads overlap the rest), whose 16 thread rows split the terms
// and whose partial sums are added in a fixed order.  The capped layout's
// code (the pdf table, the family terms, the overflow gammas) is a template
// branch (FAM), so the uniform layout runs without it and takes row j's
// pdf as j / cmax.  A pdf
// owns both uniform rows and overflow rows, so its posterior would take a
// third atomic add, whose order would show in the result; instead K4
// writes the overflow rows' gammas to their own buffer, and the finalize
// adds them to each pdf's tile sums in lane order before normalising.
//
// Precision 'bf16' (pallas_block.py _make_matvec :469-475, the panels cast
// by block_fused_fb :1089-1093) is a template branch (BF16) of the step
// kernel: the panels arrive in bf16, the gathered state rows are rounded to
// bf16 as they are staged, and the 64x64x128 tile product runs on the
// tensor cores (mma.sync m16n8k16, float32 accumulation), tier_tile_bf16.
// Everything else (bands, families, emission, omega, the rescale, gamma,
// posteriors, the finalize) is the float32 code of the other
// instantiations, which the branch leaves as they were.
//
// What bounds it, measured on an H100 SXM (700 W): neither the FMA rate nor
// memory bandwidth; the step is latency-bound (the tier tiles alone reach
// ~20 % of the float32 FMA peak), so occupancy decides: registers are capped
// to keep MIN_BLOCKS blocks of 256 threads resident per SM, the tier stages
// through shared memory with per-thread strided pointers, and state rows move
// as float4 when B % 4 == 0.  Later designs: 3xTF32 mma for the tier, a
// persistent kernel or CUDA graph per chunk, the finalize fused away.
//
// Conventions: state (Sp, B) row-major, float32; ext (frames, P1, B); the
// emission of state j is ext[t, pdf(j), b], pdf(j) = j / cmax in the uniform
// layout and row_pdf[j] in the capped one.
// A carried state is stored unscaled with a (B,) scale.  Index maps of the
// tier come from the host as ints: src(k, s) = g0 + k*gk + s*gs,
// dst(k, d) = d0 + k*dk + d*dd.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "block_common.cuh"

namespace {

constexpr int TB = 64;   // batch columns per tile
constexpr int TS = 32;   // tier contraction depth per shared-memory stage
constexpr int NT = 256;  // threads per step block: 16 x 16, 4x4 outputs each
constexpr int FC = 8;    // finalize: columns per block
constexpr int FR = 128;  // finalize: threads splitting the partials per column
constexpr int PER = TS * TR / NT;  // tier values each thread stages per stage
constexpr int MIN_BLOCKS = 4;  // step blocks resident per SM (caps registers)
constexpr int KS = 16;   // bf16 tier: contraction depth of one mma step
constexpr int BST = TS + 8;  // bf16 tier: padded stage row (80 bytes)

// The tier panels' element type: bf16 under precision 'bf16', else float.
template <bool BF16>
using TierT = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// Device tables of the layout (host: block_scan._ilayout, the same order).
struct Layout {
  const int* row_pdf;   // (Sp,) pdf of each state row
  const int* fam_ptr;   // (Sp + 1,) row j's family terms: [fam_ptr[j], fam_ptr[j+1])
  const int* fam_src;   // (nfam,) source row of each term
  const float* fam_w;   // (nfam,) its weight
  const int* ovp_ptr;   // (P1 + 1,) pdf p's overflow rows: ovp_lane[ovp_ptr[p] ..]
  const int* ovp_lane;  // (ov_hi - ov_lo,) those rows minus ov_lo, increasing
  const int* heavy_rows;  // (nheavy,) the rows with a tile each
};

Layout parse_layout(const long long* a) {
  Layout l;
  l.row_pdf = reinterpret_cast<const int*>(a[0]);
  l.fam_ptr = reinterpret_cast<const int*>(a[1]);
  l.fam_src = reinterpret_cast<const int*>(a[2]);
  l.fam_w = reinterpret_cast<const float*>(a[3]);
  l.ovp_ptr = reinterpret_cast<const int*>(a[4]);
  l.ovp_lane = reinterpret_cast<const int*>(a[5]);
  l.heavy_rows = reinterpret_cast<const int*>(a[6]);
  return l;
}

// K1, tier part: acc[i][c] = sum_s W[k, s, d] * prev[src(k, s), b] for the
// 4x4 outputs of this thread (d = dbase + ty*4 + i, b = b0 + tx*4 + c).
// Staging: thread tid copies column tid % 64 of rows tid / 64 + 4u of each
// (TS x 64) stage of W[k] and of the gathered state rows.
__device__ __forceinline__ void tier_tile(
    const Meta& m, int B, const float* __restrict__ prev,
    const float* __restrict__ W, long long k, long long dbase, int b0,
    float (&Ws)[TS][TR], float (&Xs)[TS][TB], float (&acc)[4][4]) {
  static_assert(TR == TB && NT % TR == 0 && TS % (NT / TR) == 0, "tiles");
  constexpr int RS = NT / TR;  // staged rows per pass
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col = tid % TR, row0 = tid / TR;
  const bool dok = dbase + col < m.D, bok = b0 + col < B;
  const float* pw = W + (k * m.Sm + row0) * m.D + dbase + col;
  const float* px = prev + (m.g0 + k * m.gk + row0 * m.gs) * B + b0 + col;
  const long long wstep = RS * m.D, xstep = RS * m.gs * B;
  for (long long s0 = 0; s0 < m.Sm; s0 += TS) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool sok = s0 + row0 + u * RS < m.Sm;
      Ws[row0 + u * RS][col] = (sok && dok) ? pw[u * wstep] : 0.f;
      Xs[row0 + u * RS][col] = (sok && bok) ? px[u * xstep] : 0.f;
    }
    pw += TS * m.D;
    px += TS * m.gs * B;
    __syncthreads();
#pragma unroll 8
    for (int ss = 0; ss < TS; ++ss) {
      const float4 w = *reinterpret_cast<const float4*>(&Ws[ss][ty * 4]);
      const float4 x = *reinterpret_cast<const float4*>(&Xs[ss][tx * 4]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wv[i], xv[c], acc[i][c]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
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

// K1, tier part under precision 'bf16': acc[i][c] as in tier_tile, on the
// tensor cores.  The panels are bf16 in device memory; the gathered state
// rows are rounded to bf16 (__float2bfloat16_rn) as they are staged, and
// the products are summed in float32.  The port stores the state unscaled
// and applies 2^-k after the product, while the TPU kernel casts the scaled
// state: rounding to bf16 commutes with a power-of-two scale in the normal
// range, so both round the same mantissas.  A stage holds Wb[d][s] and
// Xb[b][s] (s contiguous, in the float stages' memory), so that each mma
// fragment register is one 32-bit shared load; each of the 8 warps owns 16
// destination rows x 32 columns (4 n8 tiles) for every 16-deep step.  The
// staging copies whole pairs (s, s+1) and the product whole steps: Sm % 16
// == 0 (block_scan._bf16_tile_reason).  The accumulators leave the mma in
// its fragment layout and pass through C to this thread's 4x4 outputs.
__device__ __forceinline__ void tier_tile_bf16(
    const Meta& m, int B, const float* __restrict__ prev,
    const __nv_bfloat16* __restrict__ W, long long k, long long dbase,
    int b0, float (&Ws)[TS][TR], float (&Xs)[TS][TB],
    float (&C)[TR][TB + 1], float (&acc)[4][4]) {
  static_assert(TR * BST * 2 <= TS * TR * 4 && TR == TB && NT == 256 &&
                    TS % KS == 0, "bf16 tiles");
  constexpr int PR = NT / TR;  // pair rows staged per pass
  auto Wb = reinterpret_cast<__nv_bfloat16(*)[BST]>(&Ws[0][0]);
  auto Xb = reinterpret_cast<__nv_bfloat16(*)[BST]>(&Xs[0][0]);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;  // fragment row group, its thread
  const int mr = (warp / 2) * 16, nc = (warp % 2) * 32;  // the warp's tile
  const int col = tid % TR, pr = tid / TR;  // staging: column, pair row
  const bool dok = dbase + col < m.D, bok = b0 + col < B;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const __nv_bfloat16* pw = W + (k * m.Sm) * m.D + dbase + col;
  const float* px = prev + (m.g0 + k * m.gk) * B + b0 + col;
  float d[4][4] = {};  // [n8 tile][fragment]
  for (long long s0 = 0; s0 < m.Sm; s0 += TS) {
#pragma unroll
    for (int u = 0; u < TS / 2 / PR; ++u) {
      const int s = 2 * (pr + u * PR);
      const bool sok = s0 + s < m.Sm;  // both of the pair (Sm even)
      __nv_bfloat162 w2, x2;
      w2.x = w2.y = x2.x = x2.y = zero;
      if (sok && dok) {
        const __nv_bfloat16* w = pw + (s0 + s) * m.D;
        w2.x = w[0];
        w2.y = w[m.D];
      }
      if (sok && bok) {
        const float* x = px + (s0 + s) * m.gs * B;
        x2 = __floats2bfloat162_rn(x[0], x[m.gs * B]);
      }
      *reinterpret_cast<__nv_bfloat162*>(&Wb[col][s]) = w2;
      *reinterpret_cast<__nv_bfloat162*>(&Xb[col][s]) = x2;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TS; kk += KS) {
      if (s0 + kk >= m.Sm) break;  // uniform across the block
      const unsigned a[4] = {lds32(&Wb[mr + g][kk + 2 * q]),
                             lds32(&Wb[mr + g + 8][kk + 2 * q]),
                             lds32(&Wb[mr + g][kk + 2 * q + 8]),
                             lds32(&Wb[mr + g + 8][kk + 2 * q + 8])};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const __nv_bfloat16* x = &Xb[nc + n * 8 + g][kk + 2 * q];
        mma_bf16(d[n], a, lds32(x), lds32(x + 8));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = nc + n * 8 + 2 * q;
    C[mr + g][c] = d[n][0];
    C[mr + g][c + 1] = d[n][1];
    C[mr + g + 8][c] = d[n][2];
    C[mr + g + 8][c + 1] = d[n][3];
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = C[ty * 4 + i][tx * 4 + c];
}

// K1, family part of a heavy row j (a tile of its own): thread row ty takes
// every 16th of the row's terms for this thread's 4 columns; the partial
// sums land in P[ty][col], which the row's epilogue adds in ty order.
template <bool VEC>
__device__ __forceinline__ void heavy_terms(const Layout& lay, int B,
                                            const float* __restrict__ prev,
                                            int j, int b0,
                                            float (&P)[TS][TB]) {
  static_assert(NT / 16 <= TS, "partials");
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int q1 = lay.fam_ptr[j + 1];
  for (int q = lay.fam_ptr[j] + ty; q < q1; q += NT / 16) {
    const float w = lay.fam_w[q];
    const float4 x =
        load4<VEC>(prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = fmaf(w, get(x, c), s[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) P[ty][tx * 4 + c] = s[c];
}

// One frame of one sweep over one (row tile, column tile): a heavy row's
// tile (FAM only: blocks 0 .. nheavy-1), a tier tile (64 destinations of
// one tier block) or a band tile (64 rows of band_rows).
//   BWD = false (K2, K3): y = (M prev)*s (or prev on frame 0), y *= e;
//     partial[0] = column max of y, partial[1] = omega . prev (unscaled).
//   BWD = true (K4): y = (M prev + omega * prev[fin])*s (or 1 on the last
//     padded frame); gamma = alpha_t * ascale_t * y summed into the pdf
//     groups of posts_t (overflow rows: written to ovg instead); beta =
//     y * e; partial[0] = column max of beta, partial[1] = column sum of
//     gamma.
// M prev = tier + bands + the row's family terms (FAM: the capped layout);
// BF16: the tier on the tensor cores (tier_tile_bf16).
template <bool BWD, bool VEC, bool FAM, bool BF16>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) step_kernel(
    Meta m, Layout lay, int B, const float* __restrict__ prev,
    const float* __restrict__ scale, const float* __restrict__ ext_t,
    const float* __restrict__ band_w, const TierT<BF16>* __restrict__ W,
    const float* __restrict__ omega, const int* __restrict__ band_rows,
    int skip_matvec, float* __restrict__ out, float* __restrict__ part,
    const float* __restrict__ alpha_t, const float* __restrict__ ascale_t,
    float* __restrict__ posts_t, float* __restrict__ ovg) {
  __shared__ __align__(16) float Ws[TS][TR];
  __shared__ __align__(16) float Xs[TS][TB];
  __shared__ float red[2][16][TB];
  // BWD: the tile's gammas; BF16: first the tier product's outputs
  __shared__ float G[(BWD || BF16) ? TR : 1][TB + 1];
  __shared__ int rows_s[TR];  // state row of each tile row, -1 if none
  __shared__ int pdf_s[TR];   // its pdf (the emission's row of ext)
  __shared__ int grp_s[TR];   // BWD: its posterior row, -1 for overflow rows

  const long long blk = blockIdx.x;  // this block's partials
  const long long heavy = blk;  // the heavy row, if is_heavy
  const bool is_heavy = FAM && heavy < m.nheavy;
  const long long tile = blk - (FAM ? m.nheavy : 0);  // tier or band tile
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;  // this thread's columns bcol .. bcol+3
  const bool is_tier = !is_heavy && tile < m.n_tier_tiles;
  const long long dtiles = (m.D + TR - 1) / TR;
  const long long k = is_tier ? tile / dtiles : 0;
  const long long dbase = is_tier ? (tile % dtiles) * TR : 0;

  if (tid < TR) {
    long long j = -1;
    if (is_heavy) {
      if (tid == 0) j = lay.heavy_rows[heavy];
    } else if (is_tier) {
      const long long d = dbase + tid;
      if (d < m.D) j = m.d0 + k * m.dk + d * m.dd;
    } else {
      const long long r = (tile - m.n_tier_tiles) * TR + tid;
      if (r < m.nband) j = band_rows[r];
    }
    const int p =
        j < 0 ? -1 : (FAM ? lay.row_pdf[j] : static_cast<int>(j / m.cmax));
    rows_s[tid] = static_cast<int>(j);
    pdf_s[tid] = p;
    grp_s[tid] = (FAM && j >= m.ov_lo && j < m.ov_hi) ? -1 : p;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  if (is_tier && !skip_matvec) {
    if constexpr (BF16)
      tier_tile_bf16(m, B, prev, W, k, dbase, b0, Ws, Xs, G, acc);
    else
      tier_tile(m, B, prev, W, k, dbase, b0, Ws, Xs, acc);
  }
  if constexpr (FAM) {
    if (is_heavy && !skip_matvec)
      heavy_terms<VEC>(lay, B, prev, lay.heavy_rows[heavy], b0, Xs);
  }
  __syncthreads();

  const float4 sc = load4<VEC>(scale, bcol, B);
  float4 pfin = make_float4(0.f, 0.f, 0.f, 0.f), asc = pfin;
  if constexpr (BWD) {
    pfin = load4<VEC>(prev + static_cast<size_t>(m.fin) * B, bcol, B);
    asc = load4<VEC>(ascale_t, bcol, B);
  }
  float colmax[4] = {0.f, 0.f, 0.f, 0.f}, colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int j = rows_s[r];
    if (j < 0) {
      if constexpr (BWD)
        for (int c = 0; c < 4; ++c) G[r][tx * 4 + c] = 0.f;
      continue;
    }
    const size_t jB = static_cast<size_t>(j) * B;
    const float4 e =
        load4<VEC>(ext_t + static_cast<size_t>(pdf_s[r]) * B, bcol, B);
    const float om = omega[j];
    float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    if (!skip_matvec) {
#pragma unroll
      for (int o = 0; o < MAX_BANDS; ++o) {
        if (o >= m.nO) break;  // uniform across the block
        const int src = j - m.off[o];
        if (src < 0 || src >= m.Sp) continue;  // wrapped: no arc
        const float w = band_w[static_cast<size_t>(o) * m.Sp + j];
        const float4 x = load4<VEC>(prev + static_cast<size_t>(src) * B, bcol, B);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = fmaf(w, get(x, c), v[c]);
      }
      if constexpr (FAM) {  // overflow families (K1's apply_ov)
        if (is_heavy) {  // split over the thread rows
          for (int g = 0; g < NT / 16; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] += Xs[g][tx * 4 + c];
        } else {  // pulled by this thread
          const int e1 = lay.fam_ptr[j + 1];
#pragma unroll 4
          for (int q = lay.fam_ptr[j]; q < e1; ++q) {
            const float w = lay.fam_w[q];
            const float4 x = load4<VEC>(
                prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] = fmaf(w, get(x, c), v[c]);
          }
        }
      }
    }
    float4 y4;
    if constexpr (!BWD) {
      const float4 p = load4<VEC>(prev + jB, bcol, B);
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[c] = (skip_matvec ? get(p, c) : v[c] * get(sc, c)) * get(e, c);
        colsum[c] = fmaf(om, get(p, c), colsum[c]);
        colmax[c] = fmaxf(colmax[c], y[c]);
      }
      y4 = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      const float4 a = load4<VEC>(alpha_t + jB, bcol, B);
      float bn[4], gv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float y =
            skip_matvec ? 1.f : fmaf(om, get(pfin, c), v[c]) * get(sc, c);
        const float g = get(a, c) * get(asc, c) * y;
        G[r][tx * 4 + c] = g;
        gv[c] = g;
        colsum[c] += g;
        bn[c] = y * get(e, c);
        colmax[c] = fmaxf(colmax[c], bn[c]);
      }
      if (FAM && j >= m.ov_lo && j < m.ov_hi)
        store4<VEC>(ovg + static_cast<size_t>(j - m.ov_lo) * B, bcol, B,
                    make_float4(gv[0], gv[1], gv[2], gv[3]));
      y4 = make_float4(bn[0], bn[1], bn[2], bn[3]);
    }
    store4<VEC>(out + jB, bcol, B, y4);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red[0][ty][tx * 4 + c] = colmax[c];
    red[1][ty][tx * 4 + c] = colsum[c];
  }
  __syncthreads();
  if (tid < TB && b0 + tid < B) {
    const int b = b0 + tid;
    float mx = 0.f, sm = 0.f;
    for (int q = 0; q < 16; ++q) {
      mx = fmaxf(mx, red[0][q][tid]);
      sm += red[1][q][tid];
    }
    part[blk * B + b] = mx;
    part[(m.n_tiles + blk) * B + b] = sm;
    if constexpr (BWD) {
      // runs of rows in one pdf group add up here, one atomic per run
      int g = -1;
      float run = 0.f;
      for (int q = 0; q < TR; ++q) {
        const int gq = grp_s[q];
        if (gq < 0) continue;
        if (gq != g) {
          if (g >= 0) atomicAdd(&posts_t[static_cast<size_t>(g) * B + b], run);
          g = gq;
          run = 0.f;
        }
        run += G[q][tid];
      }
      if (g >= 0) atomicAdd(&posts_t[static_cast<size_t>(g) * B + b], run);
    }
  }
}

// Per-column end of a frame: reduce the step's partials (a fixed-order
// tree, so the result does not vary from run to run), then
//   forward: y[fin] = (omega . prev) * s_prev * e_fin unless frame 0, the
//     new scale 2^-k from the column max, and (K2 only, ksum != nullptr)
//     ksum += k and the Kahan-compensated emission shift;
//   backward: the new scale of beta; posts_t += the overflow rows' gammas
//     of each pdf (in lane order), then /= the column's gamma sum.
template <bool BWD>
__global__ void __launch_bounds__(FC * FR) finalize_kernel(
    Meta m, Layout lay, int B, const float* __restrict__ part,
    float* __restrict__ state,
    const float* __restrict__ ext_t,
    const float* scale_in,  // may alias scale_out (read before written)
    float* scale_out, int skip_matvec,
    const float* __restrict__ mshift_t, float* __restrict__ ksum,
    float* __restrict__ shift, float* __restrict__ comp,
    float* __restrict__ posts_t, const float* __restrict__ ovg) {
  __shared__ float r0[FR][FC], r1[FR][FC];
  const int bl = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.x * FC + bl;
  float mx = 0.f, sm = 0.f;
  if (b < B) {
    for (long long t = ry; t < m.n_tiles; t += FR) {
      mx = fmaxf(mx, part[t * B + b]);
      sm += part[(m.n_tiles + t) * B + b];
    }
  }
  r0[ry][bl] = mx;
  r1[ry][bl] = sm;
  __syncthreads();
  for (int h = FR / 2; h > 0; h /= 2) {
    if (ry < h) {
      r0[ry][bl] = fmaxf(r0[ry][bl], r0[ry + h][bl]);
      r1[ry][bl] += r1[ry + h][bl];
    }
    __syncthreads();
  }
  mx = r0[0][bl];
  sm = r1[0][bl];
  if (b >= B) return;
  if constexpr (!BWD) {
    if (ry == 0) {
      if (!skip_matvec) {
        const int pfin =
            m.ov_lo < m.ov_hi ? lay.row_pdf[m.fin] : m.fin / m.cmax;
        const float yfin =
            sm * scale_in[b] * ext_t[static_cast<size_t>(pfin) * B + b];
        state[static_cast<size_t>(m.fin) * B + b] = yfin;
        mx = fmaxf(mx, yfin);
      }
      const float k = pow2_exponent(mx);
      scale_out[b] = pow2_scale(k);
      if (ksum != nullptr) {
        ksum[b] += k;
        const float xc = mshift_t[b] - comp[b];
        const float t = shift[b] + xc;
        comp[b] = (t - shift[b]) - xc;
        shift[b] = t;
      }
    }
  } else {
    if (ry == 0) scale_out[b] = pow2_scale(pow2_exponent(mx));
    const float den = sm > 0.f ? sm : 1.f;
    for (int p = ry; p < m.P1; p += FR) {
      float* pp = posts_t + static_cast<size_t>(p) * B + b;
      float v = *pp;
      if (m.ov_lo < m.ov_hi) {
        const int l1 = lay.ovp_ptr[p + 1];
        for (int l = lay.ovp_ptr[p]; l < l1; ++l)
          v += ovg[static_cast<size_t>(lay.ovp_lane[l]) * B + b];
      }
      *pp = v / den;
    }
  }
}

struct Launch {
  dim3 step_grid, fin_grid, fin_block;
  size_t SB;
  bool vec;
};

Launch launch_shape(const Meta& m, int B) {
  Launch l;
  l.step_grid = dim3(static_cast<unsigned>(m.n_tiles), (B + TB - 1) / TB);
  l.fin_grid = dim3((B + FC - 1) / FC);
  l.fin_block = dim3(FC, FR);
  l.SB = static_cast<size_t>(m.Sp) * B;
  l.vec = B % 4 == 0;
  return l;
}

template <bool BWD, bool BF16>
cudaError_t launch_step_t(const Launch& l, cudaStream_t st, const Meta& m,
                          const Layout& lay, int B, const float* prev,
                          const float* scale, const float* e,
                          const float* band_w, const void* W,
                          const float* omega, const int* band_rows, int skip,
                          float* out, float* part, const float* alpha_t,
                          const float* ascale_t, float* posts_t, float* ovg) {
  const bool fam = m.nfam > 0 || m.ov_lo < m.ov_hi;  // a capped layout
  auto kernel = l.vec ? (fam ? step_kernel<BWD, true, true, BF16>
                             : step_kernel<BWD, true, false, BF16>)
                      : (fam ? step_kernel<BWD, false, true, BF16>
                             : step_kernel<BWD, false, false, BF16>);
  kernel<<<l.step_grid, NT, 0, st>>>(
      m, lay, B, prev, scale, e, band_w, static_cast<const TierT<BF16>*>(W),
      omega, band_rows, skip, out, part, alpha_t, ascale_t, posts_t, ovg);
  return cudaGetLastError();
}

// One step launch; bf16: the panels W are bf16 (precision 'bf16').
template <bool BWD>
cudaError_t launch_step(const Launch& l, cudaStream_t st, const Meta& m,
                        const Layout& lay, int B, const float* prev,
                        const float* scale, const float* e,
                        const float* band_w, const void* W, bool bf16,
                        const float* omega, const int* band_rows, int skip,
                        float* out, float* part, const float* alpha_t,
                        const float* ascale_t, float* posts_t, float* ovg) {
  return bf16 ? launch_step_t<BWD, true>(l, st, m, lay, B, prev, scale, e,
                                         band_w, W, omega, band_rows, skip,
                                         out, part, alpha_t, ascale_t,
                                         posts_t, ovg)
              : launch_step_t<BWD, false>(l, st, m, lay, B, prev, scale, e,
                                          band_w, W, omega, band_rows, skip,
                                          out, part, alpha_t, ascale_t,
                                          posts_t, ovg);
}

// The bf16 tier tile stages whole 16-deep steps (tier_tile_bf16).
bool bad_tier(const Meta& m, int bf16) { return bf16 && m.Sm % KS; }

}  // namespace

// K2: the forward sweep over frames 0 .. Npad-1 from a0.  Before frame t with
// t % chunk == 0 the carried state and its scale are copied to checkpoint
// t / chunk.  Frame Npad-1 writes a_last; scale ends as its scale; ksum,
// shift and comp accumulate the exponents and the emission shift (the
// caller initialises scale = 1, ksum = shift = comp = 0).  W: the tier
// panels, float, or bf16 when bf16 != 0 (precision 'bf16').
extern "C" int mm_block_fwd(
    const float* a0, const float* ext, const float* mshift,
    const float* band_w, const void* W, const float* omega,
    const int* band_rows, const long long* imeta, const long long* ilay,
    int B, int Npad, int chunk, int bf16, float* work, float* a_last,
    float* bounds, float* bscale, float* scale, float* ksum, float* shift,
    float* comp, float* part, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || Npad <= 0 || chunk <= 0 ||
      Npad % chunk || bad_tier(m, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = parse_layout(ilay);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch l = launch_shape(m, B);
  const float* prev = a0;
  for (int t = 0; t < Npad; ++t) {
    if (t % chunk == 0) {
      const int c = t / chunk;
      cudaError_t err = cudaMemcpyAsync(bounds + c * l.SB, prev,
                                        l.SB * sizeof(float),
                                        cudaMemcpyDeviceToDevice, st);
      if (err == cudaSuccess)
        err = cudaMemcpyAsync(bscale + static_cast<size_t>(c) * B, scale,
                              B * sizeof(float), cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    float* cur = (t == Npad - 1) ? a_last : work + (t % 2) * l.SB;
    const float* e = ext + static_cast<size_t>(t) * m.P1 * B;
    cudaError_t err = launch_step<false>(
        l, st, m, lay, B, prev, scale, e, band_w, W, bf16, omega, band_rows,
        t == 0, cur, part, nullptr, nullptr, nullptr, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<false><<<l.fin_grid, l.fin_block, 0, st>>>(
        m, lay, B, part, cur, e, scale, scale, t == 0,
        mshift + static_cast<size_t>(t) * B, ksum, shift, comp, nullptr,
        nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = cur;
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: frames t0 .. t0+K-1 from a checkpoint (bound, bscale); writes every
// frame's unscaled state to alphas[j] and its scale to ascale[j].
extern "C" int mm_block_recompute(
    const float* bound, const float* bscale, const float* ext_c,
    const float* band_w, const void* W, const float* omega,
    const int* band_rows, const long long* imeta, const long long* ilay,
    int B, int t0, int K, int bf16, float* alphas, float* ascale, float* part,
    void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || K <= 0 || t0 < 0 ||
      bad_tier(m, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = parse_layout(ilay);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch l = launch_shape(m, B);
  const float* prev = bound;
  const float* s_prev = bscale;
  for (int j = 0; j < K; ++j) {
    float* cur = alphas + j * l.SB;
    float* s_cur = ascale + static_cast<size_t>(j) * B;
    const float* e = ext_c + static_cast<size_t>(j) * m.P1 * B;
    cudaError_t err = launch_step<false>(
        l, st, m, lay, B, prev, s_prev, e, band_w, W, bf16, omega, band_rows,
        t0 + j == 0, cur, part, nullptr, nullptr, nullptr, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<false><<<l.fin_grid, l.fin_block, 0, st>>>(
        m, lay, B, part, cur, e, s_prev, s_cur, t0 + j == 0, nullptr,
        nullptr, nullptr, nullptr, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = cur;
    s_prev = s_cur;
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: the reverse sweep over frames t0+K-1 .. t0.  beta_in and scale (in
// place) carry the state from the chunk after; the last padded frame
// (t == Npad-1) starts from beta = 1.  posts (K, P1, B) must be zero on
// entry; frame t's normalised posteriors land in posts[t - t0].  beta_out
// receives the state of frame t0 (unscaled, with scale).  ovg (ov_hi -
// ov_lo, B) holds one frame's overflow-row gammas between the step and
// the finalize.
extern "C" int mm_block_bwd(
    const float* beta_in, const float* alphas, const float* ascale,
    const float* ext_c, const float* band_w, const void* W,
    const float* omega, const int* band_rows, const long long* imeta,
    const long long* ilay, int B, int t0, int K, int Npad, int bf16,
    float* work, float* beta_out, float* scale, float* posts, float* ovg,
    float* part, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || K <= 0 || t0 < 0 ||
      t0 + K > Npad || bad_tier(m, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = parse_layout(ilay);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch l = launch_shape(m, B);
  const float* prev = beta_in;
  for (int j = K - 1; j >= 0; --j) {
    const int t = t0 + j;
    float* cur = (j == 0) ? beta_out : work + (j % 2) * l.SB;
    const float* e = ext_c + static_cast<size_t>(j) * m.P1 * B;
    float* pt = posts + static_cast<size_t>(j) * m.P1 * B;
    cudaError_t err = launch_step<true>(
        l, st, m, lay, B, prev, scale, e, band_w, W, bf16, omega, band_rows,
        t == Npad - 1, cur, part, alphas + j * l.SB,
        ascale + static_cast<size_t>(j) * B, pt, ovg);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<true><<<l.fin_grid, l.fin_block, 0, st>>>(
        m, lay, B, part, cur, e, scale, scale, 0, nullptr, nullptr, nullptr,
        nullptr, pt, ovg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = cur;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
