// Blocked forward-backward scan of the LF-MMI denominator on Hopper (sm_90a).
//
// Replaces the three fused Pallas kernels of markovmodels_tpu/ops/pallas_block.py:
//   K2 mm_block_fwd        <- _run_slice forward pallas_call, _make_fwd_kernel
//   K3 mm_block_recompute  <- _run_slice recompute pallas_call, _make_recompute_kernel
//   K4 mm_block_bwd        <- _run_slice backward pallas_call (:945),
//                             _make_bwd_kernel (:706)
// and their shared in-kernel matvec K1 (_make_matvec), here the __device__
// function tier_tile() plus the band/omega epilogue of the step.
//
// What the card is asked to do, per frame and sweep, at the 2M-arc graph
// (Sp = 49,280 states, one tier of K = 128 panels of Sm x D = 128 x 128) and
// B = 128 sequences:
//   * the tier: K*Sm*D*B*2 = 537 MFLOP of float32 multiply-adds (8 us at the
//     FMA peak);
//   * the state: 25 MB read and 25 MB written (plus 25 MB of alphas read by
//     the backward, from device memory), against a 50 MB L2;
//   * three reductions over the whole state: the omega dot into the phony
//     state, the per-column max behind the rescale, and the posterior
//     normaliser.
// Each frame reads the whole previous state, so a frame is a grid-wide
// dependency.
//
// K2 and K3 run two launches per frame from a host loop inside this
// library:
//   step_kernel     one block per (64-row tile, 64-column tile): a tier tile
//                   computes its 64 destination rows as a 64x64x128 product
//                   in shared memory (FMA on the CUDA cores: full float32,
//                   like HIGHEST on the TPU), adds the band terms, applies
//                   the emission and writes the state; the remaining rows
//                   (band-only rows, listed once per graph) take the same
//                   epilogue without the product.  Every block writes its
//                   per-column partial max and omega dot to a partials
//                   buffer: no atomics;
//   finalize_kernel reduces the partials in a fixed order (deterministic),
//                   sets the phony state, and derives the next power-of-two
//                   scale from the exponent bits of the column max.
// The scale is applied when the next frame reads the state (exact: powers
// of two), so the rescale costs no pass of its own; every frame is rescaled.
// The tier is computed by destination (pull): each destination row is
// produced by exactly one (k, d), so the tier needs no atomics either.
//
// K4 runs one persistent cooperative launch per 64-frame chunk
// (bwd_chunk_kernel; every CTA co-resident, as many as the occupancy API
// allows: 4 per SM, 3 for the capped layout).  What bounds a backward frame
// on this card is neither the tier's 8 us of FMAs nor the ~15 us of alpha
// and beta traffic at the HBM rate alone: a frame moves ~150 MB through L2
// (alphas, betas written and read back by the bands, the tier's panels and
// gathered rows), and with every CTA's loads in flight a memory round trip
// takes several us, so a work item's chain of loads sets its duration.  A
// step and a finalize launch per frame from a host loop (the forward's
// form) would add 128 launches per chunk, their gaps, and a finalize that
// re-reduces ~770 per-tile partials per column and normalises every pdf on
// the frame's critical path.  Instead:
//   * the work items of a frame (row tile x 64-column tile: heavy rows,
//     tier tiles, band tiles) come from a queue that the host plan orders
//     (ops/block_scan.py bwd_plan: heavy rows first, tier tiles spread
//     among the first band tiles); a CTA takes the next item from an
//     atomic position as it finishes the last (thread 0 takes it ahead),
//     so no CTA idles while items are left; one grid barrier per frame (a
//     counter and a generation flag in global memory, fenced, polled with
//     backoff);
//   * which CTA runs an item shows in no result: each item's column sums of
//     gamma are kept apart and added in tile order after the chunk; the
//     column max of beta, which the next frame's scale needs, is taken by
//     atomicMax on the float bits (exact and order-free for non-negative
//     floats) into CM copies (CTA c into copy c % CM: one row of B words
//     would take every item's atomics on a few cache lines), whose max the
//     next frame takes;
//   * the normalisation, with the overflow rows' gammas added to their pdfs
//     in lane order, leaves the frame: every frame keeps its unnormalised
//     posteriors, its items' column sums and its overflow gammas, and all K
//     frames are normalised after the chunk's last barrier, inside the same
//     launch.  No finalize launch is left;
//   * an item's 64 x 64 block of alpha goes to shared memory by cp.async
//     under an L2 evict-first policy (read once, it should not push out of
//     L2 the betas the next frame reads), issued as soon as the stages are
//     free; the tier's next stage waits in registers while one is
//     multiplied; a band tile of consecutive rows is queued with its first
//     row, so its row table needs no load; a tile whose rows all lie in one
//     pdf group adds its gamma column sum with one atomic per column;
//   * everything another CTA of the launch wrote (the state, the column
//     maxima, the posteriors, the column sums, the overflow gammas) is read
//     past L1 (ld.global.cg, cp.async.cg);
//   * deterministic: the pdf-group posterior sums keep their atomicAdd, at
//     most two per (group, column) and frame (admission checks it,
//     block_scan._posterior_tiles), which add to the same result in either
//     order; every other sum is taken in a fixed order.
// The tier panels stream from L2 with the gathered rows: keeping each tier
// tile's panel resident in its own CTA's shared memory (3 CTAs per SM beside
// a 32 KB panel) measured the same on this card (PERF.md §6, designs 12-12c).
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
// into the core rows' lists), which the row's threads pull: no atomics,
// deterministic.  A row with a long list (an 'in' window: 128 terms) would
// keep its 64-row tile busy for ~100 us of dependent loads, so such heavy
// rows take a tile each (the first tiles), whose 16 thread rows split the
// terms and whose partial sums are added in a fixed order.  The capped
// layout's code (the pdf table, the family terms, the overflow gammas) is a
// template branch (FAM), so the uniform layout runs without it and takes row
// j's pdf as j / cmax.  A pdf owns both uniform rows and overflow rows, so
// its posterior would take a third atomic add, whose order would show in
// the result; instead K4 writes the overflow rows' gammas to their own
// buffer, and adds them to each pdf's group sums in lane order before
// normalising.
//
// Precision 'bf16' (pallas_block.py _make_matvec :469-475, the panels cast
// by block_fused_fb :1089-1093) is a template branch (BF16) of the step and
// chunk kernels: the panels arrive in bf16, the gathered state rows are
// rounded to bf16 as they are staged, and the 64x64x128 tile product runs on
// the tensor cores (mma.sync m16n8k16, float32 accumulation),
// tier_tile_bf16.  Everything else (bands, families, emission, omega, the
// rescale, gamma, posteriors, the normalisation) is the float32 code of the
// other instantiations, which the branch leaves as they were.
//
// The forward step is latency-bound too, measured on an H100 SXM (700 W):
// the tier tiles alone reach ~20 % of the float32 FMA peak, so occupancy
// decides: registers are capped to keep MIN_BLOCKS blocks of 256 threads
// resident per SM, the tier stages through shared memory with per-thread
// strided pointers, and state rows move as float4 when B % 4 == 0.
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
#include "coop_common.cuh"

namespace {

constexpr int TB = 64;   // batch columns per tile
constexpr int TS = 32;   // tier contraction depth per shared-memory stage
constexpr int NT = 256;  // threads per step block: 16 x 16, 4x4 outputs each
constexpr int FC = 8;    // finalize: columns per block
constexpr int FR = 128;  // finalize: threads splitting the partials per column
constexpr int PER = TS * TR / NT;  // tier values each thread stages per stage
constexpr int MIN_BLOCKS = 4;  // step blocks resident per SM (caps registers)
// K4: copies of each frame's column max of beta; CTA c takes it into copy
// c % CM, so that no few cache lines take every item's atomics
constexpr int CM = 16;
// K4 CTAs resident per SM: the capped layout's family code needs more
// registers than 4 blocks of 256 threads leave (it spilled 1.1 KB per
// thread in bf16)
template <bool FAM>
constexpr int bwd_blocks() { return FAM ? 3 : 4; }
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

// K1, tier part: acc[i][c] += sum_s W[k, s, d] * prev[src(k, s), b] for the
// 4x4 outputs of this thread (d = dbase + ty*4 + i, b = b0 + tx*4 + c), in s
// order.  Staging: thread tid copies column tid % 64 of rows tid / 64 + 4u of
// each (TS x 64) stage of W[k] and of the gathered state rows.  BWD (K4):
// the state is read past L1 (another CTA of the launch wrote it) and the
// next stage's values wait in registers while this one is multiplied.
template <bool BWD>
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
  float wn[PER], xn[PER];
  auto fetch = [&](long long s0) {  // BWD: the stage into registers
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool sok = s0 + row0 + u * RS < m.Sm;
      wn[u] = (sok && dok) ? pw[u * wstep] : 0.f;
      xn[u] = (sok && bok) ? __ldcg(px + u * xstep) : 0.f;
    }
    pw += TS * m.D;
    px += TS * m.gs * B;
  };
  if constexpr (BWD) fetch(0);
  for (long long s0 = 0; s0 < m.Sm; s0 += TS) {
    if constexpr (BWD) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        Ws[row0 + u * RS][col] = wn[u];
        Xs[row0 + u * RS][col] = xn[u];
      }
    } else {  // each value stored as it arrives
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const bool sok = s0 + row0 + u * RS < m.Sm;
        Ws[row0 + u * RS][col] = (sok && dok) ? pw[u * wstep] : 0.f;
        Xs[row0 + u * RS][col] = (sok && bok) ? px[u * xstep] : 0.f;
      }
      pw += TS * m.D;
      px += TS * m.gs * B;
    }
    __syncthreads();
    if constexpr (BWD) {
      if (s0 + TS < m.Sm) fetch(s0 + TS);
    }
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
// its fragment layout and pass through C to this thread's 4x4 outputs
// (acc = the tile's product).  BWD as in tier_tile.
template <bool BWD>
__device__ __forceinline__ void tier_tile_bf16(
    const Meta& m, int B, const float* __restrict__ prev,
    const __nv_bfloat16* __restrict__ W, long long k, long long dbase,
    int b0, float (&Ws)[TS][TR], float (&Xs)[TS][TB],
    float (&C)[TR][TB + 1], float (&acc)[4][4]) {
  static_assert(TR * BST * 2 <= TS * TR * 4 && TR == TB && NT == 256 &&
                    TS % KS == 0, "bf16 tiles");
  constexpr int PR = NT / TR;      // pair rows staged per pass
  constexpr int PU = TS / 2 / PR;  // pairs each thread stages per stage
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
  // the pair (s, s+1) of a stage as the product reads it; BWD: the state
  // past L1
  auto pair = [&](long long s0, int s, __nv_bfloat162& w2,
                  __nv_bfloat162& x2) {
    const bool sok = s0 + s < m.Sm;  // both of the pair (Sm even)
    w2.x = w2.y = x2.x = x2.y = zero;
    if (sok && dok) {
      const __nv_bfloat16* w = pw + (s0 + s) * m.D;
      w2.x = w[0];
      w2.y = w[m.D];
    }
    if (sok && bok) {
      const float* x = px + (s0 + s) * m.gs * B;
      x2 = BWD ? __floats2bfloat162_rn(__ldcg(x), __ldcg(x + m.gs * B))
               : __floats2bfloat162_rn(x[0], x[m.gs * B]);
    }
  };
  __nv_bfloat162 wn[PU], xn[PU];  // BWD: the next stage
  if constexpr (BWD) {
#pragma unroll
    for (int u = 0; u < PU; ++u) pair(0, 2 * (pr + u * PR), wn[u], xn[u]);
  }
  for (long long s0 = 0; s0 < m.Sm; s0 += TS) {
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int s = 2 * (pr + u * PR);
      if constexpr (!BWD) pair(s0, s, wn[u], xn[u]);
      *reinterpret_cast<__nv_bfloat162*>(&Wb[col][s]) = wn[u];
      *reinterpret_cast<__nv_bfloat162*>(&Xb[col][s]) = xn[u];
    }
    __syncthreads();
    if constexpr (BWD) {
      if (s0 + TS < m.Sm) {
#pragma unroll
        for (int u = 0; u < PU; ++u)
          pair(s0 + TS, 2 * (pr + u * PR), wn[u], xn[u]);
      }
    }
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
// BWD (K4): the state read past L1, the loop unrolled so that the terms'
// loads overlap (the same sums in the same order).
template <bool VEC, bool BWD>
__device__ __forceinline__ void heavy_terms(const Layout& lay, int B,
                                            const float* __restrict__ prev,
                                            int j, int b0,
                                            float (&P)[TS][TB]) {
  static_assert(NT / 16 <= TS, "partials");
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int q1 = lay.fam_ptr[j + 1];
  auto term = [&](int q) {
    const float w = lay.fam_w[q];
    const float4 x = load4<VEC, BWD>(
        prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = fmaf(w, get(x, c), s[c]);
  };
  if constexpr (BWD) {
#pragma unroll 4
    for (int q = lay.fam_ptr[j] + ty; q < q1; q += NT / 16) term(q);
  } else {
    for (int q = lay.fam_ptr[j] + ty; q < q1; q += NT / 16) term(q);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) P[ty][tx * 4 + c] = s[c];
}

// One frame of the forward sweep (K2, K3) over one (row tile, column tile):
// a heavy row's tile (FAM only: blocks 0 .. nheavy-1), a tier tile (64
// destinations of one tier block) or a band tile (64 rows of band_rows):
// y = (M prev)*s (or prev on frame 0), y *= e; partial[0] = column max of
// y, partial[1] = omega . prev (unscaled).
// M prev = tier + bands + the row's family terms (FAM: the capped layout);
// BF16: the tier on the tensor cores (tier_tile_bf16).
template <bool VEC, bool FAM, bool BF16>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) step_kernel(
    Meta m, Layout lay, int B, const float* __restrict__ prev,
    const float* __restrict__ scale, const float* __restrict__ ext_t,
    const float* __restrict__ band_w, const TierT<BF16>* __restrict__ W,
    const float* __restrict__ omega, const int* __restrict__ band_rows,
    int skip_matvec, float* __restrict__ out, float* __restrict__ part) {
  __shared__ __align__(16) float Ws[TS][TR];
  __shared__ __align__(16) float Xs[TS][TB];
  __shared__ float red[2][16][TB];
  // BF16: the tier product's outputs
  __shared__ float G[BF16 ? TR : 1][TB + 1];
  __shared__ int rows_s[TR];  // state row of each tile row, -1 if none
  __shared__ int pdf_s[TR];   // its pdf (the emission's row of ext)

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
    rows_s[tid] = static_cast<int>(j);
    pdf_s[tid] =
        j < 0 ? -1 : (FAM ? lay.row_pdf[j] : static_cast<int>(j / m.cmax));
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  if (is_tier && !skip_matvec) {
    if constexpr (BF16)
      tier_tile_bf16<false>(m, B, prev, W, k, dbase, b0, Ws, Xs, G, acc);
    else
      tier_tile<false>(m, B, prev, W, k, dbase, b0, Ws, Xs, acc);
  }
  if constexpr (FAM) {
    if (is_heavy && !skip_matvec)
      heavy_terms<VEC, false>(lay, B, prev, lay.heavy_rows[heavy], b0, Xs);
  }
  __syncthreads();

  const float4 sc = load4<VEC>(scale, bcol, B);
  float colmax[4] = {0.f, 0.f, 0.f, 0.f}, colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int j = rows_s[r];
    if (j < 0) continue;
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
    const float4 p = load4<VEC>(prev + jB, bcol, B);
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = (skip_matvec ? get(p, c) : v[c] * get(sc, c)) * get(e, c);
      colsum[c] = fmaf(om, get(p, c), colsum[c]);
      colmax[c] = fmaxf(colmax[c], y[c]);
    }
    store4<VEC>(out + jB, bcol, B, make_float4(y[0], y[1], y[2], y[3]));
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
  }
}

// Per-column end of a forward frame: reduce the step's partials (a
// fixed-order tree, so the result does not vary from run to run), then
// y[fin] = (omega . prev) * s_prev * e_fin unless frame 0, the new scale
// 2^-k from the column max, and (K2 only, ksum != nullptr) ksum += k and
// the Kahan-compensated emission shift.
__global__ void __launch_bounds__(FC * FR) finalize_kernel(
    Meta m, Layout lay, int B, const float* __restrict__ part,
    float* __restrict__ state,
    const float* __restrict__ ext_t,
    const float* scale_in,  // may alias scale_out (read before written)
    float* scale_out, int skip_matvec,
    const float* __restrict__ mshift_t, float* __restrict__ ksum,
    float* __restrict__ shift, float* __restrict__ comp) {
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

// The capped layout (the overflow family branch) of a descriptor.
bool is_fam(const Meta& m) { return m.nfam > 0 || m.ov_lo < m.ov_hi; }

template <bool BF16>
cudaError_t launch_step_t(const Launch& l, cudaStream_t st, const Meta& m,
                          const Layout& lay, int B, const float* prev,
                          const float* scale, const float* e,
                          const float* band_w, const void* W,
                          const float* omega, const int* band_rows, int skip,
                          float* out, float* part) {
  const bool fam = is_fam(m);
  auto kernel = l.vec ? (fam ? step_kernel<true, true, BF16>
                             : step_kernel<true, false, BF16>)
                      : (fam ? step_kernel<false, true, BF16>
                             : step_kernel<false, false, BF16>);
  kernel<<<l.step_grid, NT, 0, st>>>(
      m, lay, B, prev, scale, e, band_w, static_cast<const TierT<BF16>*>(W),
      omega, band_rows, skip, out, part);
  return cudaGetLastError();
}

// One forward step launch; bf16: the panels W are bf16 (precision 'bf16').
cudaError_t launch_step(const Launch& l, cudaStream_t st, const Meta& m,
                        const Layout& lay, int B, const float* prev,
                        const float* scale, const float* e,
                        const float* band_w, const void* W, bool bf16,
                        const float* omega, const int* band_rows, int skip,
                        float* out, float* part) {
  return bf16 ? launch_step_t<true>(l, st, m, lay, B, prev, scale, e, band_w,
                                    W, omega, band_rows, skip, out, part)
              : launch_step_t<false>(l, st, m, lay, B, prev, scale, e,
                                     band_w, W, omega, band_rows, skip, out,
                                     part);
}

// The bf16 tier tile stages whole 16-deep steps (tier_tile_bf16).
bool bad_tier(const Meta& m, int bf16) { return bf16 && m.Sm % KS; }

// ---------------------------------------------------------------------------
// K4: the backward over one chunk, one persistent cooperative launch
// ---------------------------------------------------------------------------

// The exact power-of-two scale of column b from its max's float bits, the
// max of the CM copies (each B apart).
__device__ __forceinline__ float scale_of(const unsigned* cm, int b, int B) {
  if (b >= B) return 0.f;
  unsigned mx = 0u;
#pragma unroll
  for (int c = 0; c < CM; ++c) mx = max(mx, __ldcg(cm + c * B + b));
  return pow2_scale(pow2_exponent(__uint_as_float(mx)));
}

struct BwdArgs {
  Meta m;
  Layout lay;
  int B, K, skip_last;  // skip_last: frame K-1 starts from beta = 1
  const float* beta_in;   // (Sp, B) the state after the chunk, unscaled
  const float* scale_in;  // (B,) its scale
  const float* alphas;    // (K, Sp, B) unscaled
  const float* ascale;    // (K, B)
  const float* ext;       // (K, P1, B)
  const float* band_w;
  const void* W;
  const float* omega;
  const int* band_rows;
  // (n_items,) the queue: (tile * ncb + column tile, the first row of a
  // band tile of consecutive rows or -1)
  const int2* queue;
  int n_items;          // n_tiles * ncb
  float* work;          // (2, Sp, B) the states between the frames
  float* beta_out;      // (Sp, B) frame 0's state, unscaled
  float* scale_out;     // (B,) its scale
  float* posts;         // (K, P1, B) zero on entry
  float* ovg;           // (K, ov_hi - ov_lo, B) the overflow rows' gammas
  float* csum;          // (K, n_items, TB) each item's column sums of gamma
  unsigned* cm;         // (K, CM, B) column max of beta (float bits), zeroed
  unsigned* ctr;        // (K,) each frame's queue position, zeroed
  unsigned* sync;       // (2,) barrier counter and generation, zeroed
};

// Shared memory of one CTA: the tier stages, the reductions, the gamma
// tile (BF16: first the tier product's outputs) and the tile's row tables.
struct BwdSmem {
  // the tier stages; after the product (at once for a band tile) they
  // hold the item's 64 x 64 block of alpha_t
  float Ws[TS][TR];
  float Xs[TS][TB];
  float red[2][16][TB];
  float G[TR][TB + 1];  // the gamma tile (BF16: first the tier's outputs)
  int rows[TR];  // state row of each tile row, -1 if none
  int pdf[TR];   // its pdf (the emission's row of ext)
  int grp[TR];   // its posterior row, -1 for overflow rows
  float rs[8][32];  // the normalisation's column sums
  int2 next[2];     // the queue entries taken for the next items
  float sc[TB];     // the previous frame's scale of the item's columns
};

// Where frame j of the chunk reads and writes.
struct BwdFrame {
  const float* prev;        // beta of frame j+1 (unscaled)
  float* out;               // beta of frame j
  const float* ext_t;
  const float* alpha_t;
  const float* ascale_t;
  float* posts_t;           // (P1, B) unnormalised posteriors
  float* ovg_t;
  unsigned* cm_t;           // this frame's column max (CM copies)
  const unsigned* cm_prev;  // frame j+1's, null: scale_in
  bool skip;                // the last padded frame: y = 1
};

// One work item of one frame: the backward step over one (row tile, column
// tile).  y = (M prev + omega * prev[fin])*s (or 1 on the last padded
// frame); gamma = alpha_t * ascale_t * y summed into the pdf groups of
// posts_t (overflow rows: written to ovg_t instead); beta = y * e, its
// column max into cm_t.  M prev = tier + bands + the row's family terms.
// row0: the first row of a band tile of consecutive rows, else -1.  The
// item's alpha block is copied to shared memory (cp.async, B % 4 == 0) as
// soon as nothing else uses the stages: at once for a band tile, after the
// product for a tier tile; the band and family terms are summed while it
// is in flight.  Returns, in threads tid < TB, the item's column sum of
// gamma for column b0 + tid (0 elsewhere).
template <bool VEC, bool FAM, bool BF16>
__device__ __forceinline__ float bwd_item(
    const BwdArgs& p, const BwdFrame& f, long long tile, int b0, int row0,
    BwdSmem& s, const float* __restrict__ prev, float* __restrict__ out,
    const float* __restrict__ ext_t, const float* __restrict__ alpha_t,
    const float* __restrict__ omega, const float* __restrict__ band_w) {
  const Meta& m = p.m;
  const Layout& lay = p.lay;
  const int B = p.B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;  // this thread's columns bcol .. bcol+3
  const bool is_heavy = FAM && tile < m.nheavy;
  const long long tt = tile - (FAM ? m.nheavy : 0);  // tier or band tile
  const bool is_tier = !is_heavy && tt < m.n_tier_tiles;
  const long long dtiles = (m.D + TR - 1) / TR;
  const long long k = is_tier ? tt / dtiles : 0;
  const long long dbase = is_tier ? (tt % dtiles) * TR : 0;

  if (tid < TR) {
    long long j = -1;
    if (is_heavy) {
      if (tid == 0) j = lay.heavy_rows[tile];
    } else if (is_tier) {
      const long long d = dbase + tid;
      if (d < m.D) j = m.d0 + k * m.dk + d * m.dd;
    } else {
      const long long r = (tt - m.n_tier_tiles) * TR + tid;
      if (r < m.nband) j = row0 >= 0 ? row0 + tid : p.band_rows[r];
    }
    // the uniform rows' pdf is j / cmax, the tail's the phony pdf; the
    // overflow rows' comes from the table
    int pd = -1;
    if (j >= 0) {
      if constexpr (FAM)
        pd = j < m.ov_lo ? static_cast<int>(j / m.cmax)
                         : (j >= m.ov_hi ? m.P1 - 1 : lay.row_pdf[j]);
      else
        pd = static_cast<int>(j / m.cmax);
    }
    s.rows[tid] = static_cast<int>(j);
    s.pdf[tid] = pd;
    s.grp[tid] = (FAM && j >= m.ov_lo && j < m.ov_hi) ? -1 : pd;
  } else if (tid < TR + TB) {
    const int b = b0 + tid - TR;
    s.sc[tid - TR] = f.cm_prev == nullptr ? (b < B ? p.scale_in[b] : 0.f)
                                          : scale_of(f.cm_prev, b, B);
  }
  __syncthreads();
  // alpha_t's block of the tile: 64 rows x 16 chunks of 4 columns
  float* A = &s.Ws[0][0];
  const bool staged = VEC && !is_heavy;
  auto stage_alpha = [&]() {
    const unsigned long long once = evict_first_policy();
#pragma unroll
    for (int u = 0; u < TR * TB / 4 / NT; ++u) {
      const int c = tid + u * NT, r = c / (TB / 4), c4 = (c % (TB / 4)) * 4;
      const int j = s.rows[r], b = b0 + c4;
      const bool ok = j >= 0 && b < B;
      cp_async16_hint(&A[r * TB + c4],
                      ok ? alpha_t + static_cast<size_t>(j) * B + b : alpha_t,
                      ok, once);
    }
    cp_async_commit();
  };
  if (staged && !is_tier) stage_alpha();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  if constexpr (FAM && !BF16) {
    // a tier row's family terms before its float32 tier product: the first
    // term of each of the thread's 4 rows in flight at once, any others
    // after (the bf16 tier pulls them after the product, with the bands:
    // accumulators live across the tensor-core tile spill)
    if (is_tier && !f.skip) {
      int q0[4], q1[4], src[4];
      float w[4];
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = s.rows[ty * 4 + i];
        q0[i] = j < 0 ? 0 : lay.fam_ptr[j];
        q1[i] = j < 0 ? 0 : lay.fam_ptr[j + 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool any = q0[i] < q1[i];
        w[i] = any ? lay.fam_w[q0[i]] : 0.f;
        src[i] = any ? lay.fam_src[q0[i]] : -1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = src[i] < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : load4<VEC, true>(
                                prev + static_cast<size_t>(src[i]) * B,
                                bcol, B);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = w[i] * get(x[i], c);
        for (int q = q0[i] + 1; q < q1[i]; ++q) {
          const float wq = lay.fam_w[q];
          const float4 xq = load4<VEC, true>(
              prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wq, get(xq, c), acc[i][c]);
        }
      }
    }
  }
  if (is_tier && !f.skip) {
    if constexpr (BF16)
      tier_tile_bf16<true>(m, B, prev, static_cast<const __nv_bfloat16*>(p.W),
                           k, dbase, b0, s.Ws, s.Xs, s.G, acc);
    else
      tier_tile<true>(m, B, prev, static_cast<const float*>(p.W), k, dbase, b0,
                      s.Ws, s.Xs, acc);
  }
  if (staged && is_tier) stage_alpha();  // the stages are free
  if constexpr (FAM) {
    if (is_heavy && !f.skip)
      heavy_terms<VEC, true>(lay, B, prev, lay.heavy_rows[tile], b0, s.Xs);
  }
  // the band terms, then (capped layout) a band row's family terms, while
  // the alphas are in flight
  if (!f.skip) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = s.rows[ty * 4 + i];
      if (j < 0) continue;
#pragma unroll
      for (int o = 0; o < MAX_BANDS; ++o) {
        if (o >= m.nO) break;  // uniform across the block
        const int src = j - m.off[o];
        if (src < 0 || src >= m.Sp) continue;  // wrapped: no arc
        const float w = band_w[static_cast<size_t>(o) * m.Sp + j];
        const float4 x =
            load4<VEC, true>(prev + static_cast<size_t>(src) * B, bcol, B);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(w, get(x, c), acc[i][c]);
      }
      if constexpr (FAM) {  // overflow families (K1's apply_ov)
        if (!is_heavy && (BF16 || !is_tier)) {  // pulled by this thread
          const int e1 = lay.fam_ptr[j + 1];
#pragma unroll 4
          for (int q = lay.fam_ptr[j]; q < e1; ++q) {
            const float w = lay.fam_w[q];
            const float4 x = load4<VEC, true>(
                prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(w, get(x, c), acc[i][c]);
          }
        }
      }
    }
  }
  if (staged) cp_async_wait<0>();
  // the barrier publishes the alphas and the heavy row's partial sums;
  // one pdf group for every row of the tile: its posterior sum is the
  // column sum of gamma
  const int mixed =
      __syncthreads_or(tid < TR && s.rows[tid] >= 0 && s.grp[tid] != s.grp[0]);
  const bool one_group = !mixed && s.grp[0] >= 0;

  const float4 sc = make_float4(s.sc[tx * 4], s.sc[tx * 4 + 1],
                                s.sc[tx * 4 + 2], s.sc[tx * 4 + 3]);
  const float4 pfin =
      load4<VEC, true>(prev + static_cast<size_t>(m.fin) * B, bcol, B);
  const float4 asc = load4<VEC>(f.ascale_t, bcol, B);
  float colmax[4] = {0.f, 0.f, 0.f, 0.f}, colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int j = s.rows[r];
    if (j < 0) {
      for (int c = 0; c < 4; ++c) s.G[r][tx * 4 + c] = 0.f;
      continue;
    }
    const size_t jB = static_cast<size_t>(j) * B;
    const float4 e =
        load4<VEC>(ext_t + static_cast<size_t>(s.pdf[r]) * B, bcol, B);
    const float om = omega[j];
    float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    if constexpr (FAM) {
      if (is_heavy && !f.skip) {  // split over the thread rows
        for (int g = 0; g < NT / 16; ++g)
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] += s.Xs[g][tx * 4 + c];
      }
    }
    const float4 a =
        staged ? *reinterpret_cast<const float4*>(&A[r * TB + tx * 4])
               : load4<VEC>(alpha_t + jB, bcol, B);
    float bn[4], gv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float y =
          f.skip ? 1.f : fmaf(om, get(pfin, c), v[c]) * get(sc, c);
      const float g = get(a, c) * get(asc, c) * y;
      s.G[r][tx * 4 + c] = g;
      gv[c] = g;
      colsum[c] += g;
      bn[c] = y * get(e, c);
      colmax[c] = fmaxf(colmax[c], bn[c]);
    }
    if (FAM && j >= m.ov_lo && j < m.ov_hi)
      store4<VEC>(f.ovg_t + static_cast<size_t>(j - m.ov_lo) * B, bcol, B,
                  make_float4(gv[0], gv[1], gv[2], gv[3]));
    store4<VEC>(out + jB, bcol, B, make_float4(bn[0], bn[1], bn[2], bn[3]));
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.red[0][ty][tx * 4 + c] = colmax[c];
    s.red[1][ty][tx * 4 + c] = colsum[c];
  }
  __syncthreads();
  float sm = 0.f;
  if (tid < TB && b0 + tid < B) {
    const int b = b0 + tid;
    float mx = 0.f;
    for (int q = 0; q < 16; ++q) {
      mx = fmaxf(mx, s.red[0][q][tid]);
      sm += s.red[1][q][tid];
    }
    atomicMax(f.cm_t + (blockIdx.x % CM) * B + b, __float_as_uint(mx));
    if (one_group) {
      atomicAdd(&f.posts_t[static_cast<size_t>(s.grp[0]) * B + b], sm);
    } else {
      // runs of rows in one pdf group add up here, one atomic per run
      int g = -1;
      float run = 0.f;
      for (int q = 0; q < TR; ++q) {
        const int gq = s.grp[q];
        if (gq < 0) continue;
        if (gq != g) {
          if (g >= 0)
            atomicAdd(&f.posts_t[static_cast<size_t>(g) * B + b], run);
          g = gq;
          run = 0.f;
        }
        run += s.G[q][tid];
      }
      if (g >= 0) atomicAdd(&f.posts_t[static_cast<size_t>(g) * B + b], run);
    }
  }
  __syncthreads();  // the tables and tiles are free for the next item
  return sm;
}

// After the chunk's last frame: every frame's posteriors normalised.  An
// item is (frame, 32 columns): the column sum of gamma over the work
// items' sums (8 thread rows, each every 8th row tile in order, then the
// rows in order), then posts_t[p] += the overflow rows' gammas of pdf p (in
// lane order), /= that sum (or 1 where it is 0).
template <bool FAM>
__device__ __forceinline__ void bwd_normalise(const BwdArgs& p, BwdSmem& s) {
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB, n_tiles = p.n_items / ncb;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int ncol = (B + 31) / 32, n_norm = p.K * ncol;
  const size_t nov = static_cast<size_t>(m.ov_hi - m.ov_lo);
  for (int it = blockIdx.x; it < n_norm; it += gridDim.x) {
    const int j = it / ncol, b = (it % ncol) * 32 + tx;
    float sm = 0.f;
    if (b < B) {
      const float* cs = p.csum +
                        (static_cast<size_t>(j) * p.n_items + b / TB) * TB +
                        b % TB;
      const size_t step = static_cast<size_t>(ncb) * TB;
#pragma unroll 4
      for (int t = ty; t < n_tiles; t += 8) sm += __ldcg(cs + t * step);
    }
    s.rs[ty][tx] = sm;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) tot += s.rs[q][tx];
    const float den = tot > 0.f ? tot : 1.f;
    if (b < B) {
      float* pt = p.posts + static_cast<size_t>(j) * m.P1 * B + b;
      const float* og = p.ovg + static_cast<size_t>(j) * nov * B + b;
#pragma unroll 4
      for (int pd = ty; pd < m.P1; pd += 8) {
        float v = __ldcg(pt + static_cast<size_t>(pd) * B);
        if constexpr (FAM) {
          if (nov) {
            const int l1 = p.lay.ovp_ptr[pd + 1];
            for (int l = p.lay.ovp_ptr[pd]; l < l1; ++l)
              v += __ldcg(og + static_cast<size_t>(p.lay.ovp_lane[l]) * B);
          }
        }
        pt[static_cast<size_t>(pd) * B] = v / den;
      }
    }
    __syncthreads();  // rs is free for the next item
  }
}

// K4 over frames K-1 .. 0 of one chunk: each CTA runs its plan items of
// every frame, one grid barrier per frame; then the normalisation and the
// outgoing scale.
template <bool VEC, bool FAM, bool BF16>
__global__ void __launch_bounds__(NT, bwd_blocks<FAM>())
    bwd_chunk_kernel(const __grid_constant__ BwdArgs p) {
  __shared__ __align__(16) BwdSmem s;
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB, tid = threadIdx.x;
  const size_t SB = static_cast<size_t>(m.Sp) * B;
  const size_t PB = static_cast<size_t>(m.P1) * B;
  const size_t OB = static_cast<size_t>(m.ov_hi - m.ov_lo) * B;
  for (int j = p.K - 1; j >= 0; --j) {
    BwdFrame f;
    f.prev = j == p.K - 1 ? p.beta_in : p.work + ((j + 1) % 2) * SB;
    f.out = j == 0 ? p.beta_out : p.work + (j % 2) * SB;
    f.ext_t = p.ext + j * PB;
    f.alpha_t = p.alphas + j * SB;
    f.ascale_t = p.ascale + static_cast<size_t>(j) * B;
    f.posts_t = p.posts + j * PB;
    f.ovg_t = p.ovg + j * OB;
    f.cm_t = p.cm + static_cast<size_t>(j) * CM * B;
    f.cm_prev =
        j == p.K - 1 ? nullptr : p.cm + static_cast<size_t>(j + 1) * CM * B;
    f.skip = p.skip_last && j == p.K - 1;
    if (j > 0) {  // the next frame's emissions into L2, spread over the grid
      constexpr int LINE = 32;  // floats per 128-byte line
      const float* e = p.ext + (j - 1) * PB;
      const size_t n_e = (PB + LINE - 1) / LINE;
      for (size_t i = static_cast<size_t>(blockIdx.x) * NT + tid; i < n_e;
           i += static_cast<size_t>(gridDim.x) * NT)
        prefetch_l2(e + i * LINE);
    }
    // items from the frame's queue: thread 0 takes the next position and
    // reads its entry while the current item runs
    auto take = [&]() {
      const int q = static_cast<int>(atomicAdd(p.ctr + j, 1u));
      return q < p.n_items ? p.queue[q] : make_int2(-1, -1);
    };
    if (tid == 0) s.next[0] = take();
    __syncthreads();
    int par = 0;
    for (int2 q = s.next[0]; q.x >= 0; q = s.next[par]) {
      if (tid == 0) s.next[par ^ 1] = take();
      const float sm = bwd_item<VEC, FAM, BF16>(
          p, f, q.x / ncb, (q.x % ncb) * TB, q.y, s, f.prev, f.out, f.ext_t,
          f.alpha_t, p.omega, p.band_w);
      if (tid < TB)
        p.csum[(static_cast<size_t>(j) * p.n_items + q.x) * TB + tid] = sm;
      par ^= 1;  // bwd_item ends with a block barrier: s.next[par] is set
    }
    grid_sync(p.sync);
  }
  if (blockIdx.x == 0)
    for (int b = tid; b < B; b += NT) p.scale_out[b] = scale_of(p.cm, b, B);
  bwd_normalise<FAM>(p, s);
}

const void* bwd_kernel(bool vec, bool fam, bool bf16) {
  if (bf16)
    return vec ? (fam ? (const void*)bwd_chunk_kernel<true, true, true>
                      : (const void*)bwd_chunk_kernel<true, false, true>)
               : (fam ? (const void*)bwd_chunk_kernel<false, true, true>
                      : (const void*)bwd_chunk_kernel<false, false, true>);
  return vec ? (fam ? (const void*)bwd_chunk_kernel<true, true, false>
                    : (const void*)bwd_chunk_kernel<true, false, false>)
             : (fam ? (const void*)bwd_chunk_kernel<false, true, false>
                    : (const void*)bwd_chunk_kernel<false, false, false>);
}

// CTAs of a K4 instantiation that can be co-resident on the current
// device (0 where the device cannot launch cooperatively).
cudaError_t bwd_co_resident(const void* kern, int* n) {
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, 0);
  *n = coop ? per_sm * n_sm : 0;
  return err;
}

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
    cudaError_t err = launch_step(l, st, m, lay, B, prev, scale, e, band_w,
                                  W, bf16, omega, band_rows, t == 0, cur,
                                  part);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<<<l.fin_grid, l.fin_block, 0, st>>>(
        m, lay, B, part, cur, e, scale, scale, t == 0,
        mshift + static_cast<size_t>(t) * B, ksum, shift, comp);
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
    cudaError_t err = launch_step(l, st, m, lay, B, prev, s_prev, e, band_w,
                                  W, bf16, omega, band_rows, t0 + j == 0,
                                  cur, part);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<<<l.fin_grid, l.fin_block, 0, st>>>(
        m, lay, B, part, cur, e, s_prev, s_cur, t0 + j == 0, nullptr,
        nullptr, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = cur;
    s_prev = s_cur;
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the K4 launch that can be co-resident on the current device for
// this instantiation (vec: B % 4 == 0; fam: the capped layout; bf16: bf16
// panels), or minus a CUDA error code.
extern "C" int mm_block_bwd_ctas(int vec, int fam, int bf16) {
  int n = 0;
  const cudaError_t err = bwd_co_resident(bwd_kernel(vec, fam, bf16), &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// K4: the reverse sweep over frames t0+K-1 .. t0 in one cooperative launch
// of n_ctas CTAs, which take the work items of every frame from a queue in
// the plan's order (queue: ops/block_scan.py bwd_plan for ncb = ceil(B /
// 64) column tiles, n_items = n_tiles * ncb pairs of ints: the item, the
// first row of a band tile of consecutive rows or -1).  beta_in and bscale carry the state from the chunk after; the
// last padded frame (t == Npad-1) starts from beta = 1.  posts (K, P1, B)
// must be zero on entry; frame t's normalised posteriors land in posts[t -
// t0].  beta_out and scale_out receive the state of frame t0 (unscaled,
// with its scale).  Scratch: work (2, Sp, B), ovg (K, ov_hi - ov_lo, B),
// csum (K, n_items, 64), and cm (K, B), ctr (K) and sync (2) zeroed words.
extern "C" int mm_block_bwd(
    const float* beta_in, const float* bscale, const float* alphas,
    const float* ascale, const float* ext_c, const float* band_w,
    const void* W, const float* omega, const int* band_rows,
    const long long* imeta, const long long* ilay, const int* queue,
    int n_items, int n_ctas, int B, int t0, int K, int Npad, int bf16,
    float* work, float* beta_out, float* scale_out, float* posts, float* ovg,
    float* csum, unsigned* cm, unsigned* ctr, unsigned* sync, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || K <= 0 || t0 < 0 ||
      t0 + K > Npad || n_ctas <= 0 || n_items != m.n_tiles * ((B + TB - 1) / TB) ||
      bad_tier(m, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.m = m;
  a.lay = parse_layout(ilay);
  a.B = B;
  a.K = K;
  a.skip_last = t0 + K == Npad;
  a.beta_in = beta_in;
  a.scale_in = bscale;
  a.alphas = alphas;
  a.ascale = ascale;
  a.ext = ext_c;
  a.band_w = band_w;
  a.W = W;
  a.omega = omega;
  a.band_rows = band_rows;
  a.queue = reinterpret_cast<const int2*>(queue);
  a.n_items = n_items;
  a.work = work;
  a.beta_out = beta_out;
  a.scale_out = scale_out;
  a.posts = posts;
  a.ovg = ovg;
  a.csum = csum;
  a.cm = cm;
  a.ctr = ctr;
  a.sync = sync;
  const void* kern = bwd_kernel(B % 4 == 0, is_fam(m), bf16 != 0);
  int max_ctas = 0;
  cudaError_t err = bwd_co_resident(kern, &max_ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ctas > max_ctas)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(n_ctas), dim3(NT), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
