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
// K2 runs one persistent cooperative launch per sweep and K3 one per
// 64-frame chunk (fwd_chunk_kernel; every CTA co-resident: 3 per SM), the
// frame loop inside, one grid barrier per frame.  A per-frame step and
// finalize launch from a host loop left ~30 us of a 53 us frame to a frame
// without work (the epilogue-only step, the finalize launch, the gaps
// between launches).  Instead:
//   * a frame's work items (row tile x 64-column tile: heavy rows, tier
//     tiles, band tiles) come from a queue that the host plan orders
//     (ops/block_scan.py fwd_plan: K4's order, the tier items among the
//     first tenth of the band items); a CTA takes the next item from an
//     atomic position as it finishes the last.  A tier tile computes its
//     64 destination rows as a 64x64x128 product in shared memory (FMA on
//     the CUDA cores: full float32, like HIGHEST on the TPU), adds the band
//     terms, applies the emission and writes the state; a band tile (the
//     rows the tier does not write) takes the same epilogue without the
//     product.  The tier is computed by destination (pull): each row is
//     produced by exactly one item, so it needs no atomics;
//   * the per-frame finalize has no launch of its own.  The column max
//     behind the next frame's scale is taken by atomicMax on the float bits
//     into CM copies, as K4's.  The phony row y[fin] = (omega . prev) * s *
//     e_fin is the one value of a frame that needs a grid-wide sum of the
//     frame before: every item writes its tile's partial of omega . y from
//     the rows it has just computed (the partial the next frame's step
//     would have taken from them), and in the next frame CTAs c < B / 2
//     reduce those partials in the finalize's fixed order (two columns
//     each), derive the scale, advance K2's ksum and emission shift, and
//     write y[fin] and its column max before that frame's barrier: the
//     frame's items never read y[fin];
//   * what bounds the frame is memory latency: an item's chain of loads.
//     The epilogue loads a pair of rows' band terms before it sums any, one
//     round trip per pair of rows, not one per term; the float32 tier's
//     stages move by cp.async through a ring of two in shared memory; the
//     state a frame reads is marked first to leave L2 and the state it
//     writes last, so that the next frame finds it there;
//   * the results are the per-frame launches' bit for bit: the same sums in
//     the same order (the tile arithmetic, the per-tile partials, the
//     finalize's reduction), max and the power-of-two scale exact;
//   * everything another CTA of the launch wrote is read past L1
//     (ld.global.cg), and K2 writes each chunk's checkpoint from its items.
// The scale is applied when the next frame reads the state (exact: powers
// of two), so the rescale costs no pass of its own; every frame is rescaled.
//
// K4 runs one persistent cooperative launch per 64-frame chunk
// (bwd_chunk_kernel; every CTA co-resident, as many as the occupancy API
// allows: 4 per SM, 3 for the capped layout).  What bounds a backward frame
// on this card is neither the tier's 8 us of FMAs nor the ~15 us of alpha
// and beta traffic at the HBM rate alone: a frame moves ~150 MB through L2
// (alphas, betas written and read back by the bands, the tier's panels and
// gathered rows), and with every CTA's loads in flight a memory round trip
// takes several us, so a work item's chain of loads sets its duration.  A
// step and a finalize launch per frame from a host loop would add 128
// launches per chunk, their gaps, and a finalize that re-reduces ~770
// per-tile partials per column and normalises every pdf on the frame's
// critical path.  Instead:
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
// A float64 graph (compile_fsm dtype=float64, pallas_block.py :313-316
// declines it on the TPU, where the JAX package answers it through XLA)
// takes the double instantiation (T = double): every value the kernels
// read or write is double (state, emissions and their shift, panels,
// bands, family weights, omega, column maxima, checkpoints, alphas, pdf
// sums and posteriors), on the CUDA cores' FP64 FMAs, at half their FP32
// rate on an H100 SXM (33.5 against 67 TFLOP/s).  The sums are the float
// instantiation's, in the same order; the per-frame scale is the exact
// power of two from the 11 exponent bits; the column max is the 64-bit
// atomicMax on the bits (exact and order-free for non-negative doubles).
// It is the simple one: no cp.async ring, no alpha staging, no L2 hints,
// stages of 16 rows (the float ones' bytes), 2 CTAs per SM, and K4's
// shared block (69 KB) in dynamic shared memory.  No bf16 panels with
// double values.
//
// The items are latency-bound too, measured on an H100 SXM (700 W): the
// tier tiles alone reach ~20 % of the float32 FMA peak, so occupancy
// decides: registers are capped to keep 3 or 4 CTAs of 256 threads
// resident per SM, the tier stages through shared memory with per-thread
// strided pointers, and state rows move as float4 when B % 4 == 0.
//
// Conventions: state (Sp, B) row-major, float32 (or double); ext (frames,
// P1, B); the emission of state j is ext[t, pdf(j), b], pdf(j) = j / cmax in
// the uniform layout and row_pdf[j] in the capped one.
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
constexpr int NT = 256;  // threads per CTA: 16 x 16, 4x4 outputs each
constexpr int FR = 128;  // the forward's omega reduction: threads per column
// copies of each frame's column max; CTA c takes it into copy c % CM, so
// that no few cache lines take every item's atomics
constexpr int CM = 16;
// K4's CTAs resident per SM (caps registers): the capped layout's family
// code needs more registers than 4 CTAs of 256 threads leave (it spilled
// 1.1 KB per thread in bf16)
template <bool FAM, class T = float>
constexpr int bwd_blocks() { return sizeof(T) == 8 ? 2 : FAM ? 3 : 4; }
// K2/K3's: 3 for every layout, so that a pair of rows' band terms fit in
// registers (at 4 the forward spilled and ran slower); the double
// instantiation's values take two registers each: 2
template <class T>
constexpr int fwd_blocks() { return sizeof(T) == 8 ? 2 : 3; }
constexpr int KS = 16;   // bf16 tier: contraction depth of one mma step
constexpr int BST = TS + 8;  // bf16 tier: padded stage row (80 bytes)

// The tier panels' element type: bf16 under precision 'bf16', else float.
template <bool BF16>
using TierT = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// The value type T of an instantiation (value_common.cuh): float, or
// double (a float64 graph: state, emissions, panels, bands, family weights,
// omega, column maxima, checkpoints and posteriors all double).  The tier
// stages' depth depends on it: the double stages take the float ones' bytes
template <class T>
__host__ __device__ constexpr int stage_depth() {
  return is_f64<T>() ? TS / 2 : TS;
}

// The CTA's shared memory: a static block for the float instantiations,
// the dynamic block (sized by the launch) where a double one passes the
// 48 KB of a static block (K4's).
template <class S, bool DYN>
__device__ __forceinline__ S& cta_smem() {
  if constexpr (DYN) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    return *reinterpret_cast<S*>(dyn_smem);
  } else {
    __shared__ __align__(16) S s;
    return s;
  }
}

// Device tables of the layout (host: block_scan._ilayout, the same order).
template <class T = float>
struct Layout {
  const int* row_pdf;   // (Sp,) pdf of each state row
  const int* fam_ptr;   // (Sp + 1,) row j's family terms: [fam_ptr[j], fam_ptr[j+1])
  const int* fam_src;   // (nfam,) source row of each term
  const T* fam_w;       // (nfam,) its weight
  const int* ovp_ptr;   // (P1 + 1,) pdf p's overflow rows: ovp_lane[ovp_ptr[p] ..]
  const int* ovp_lane;  // (ov_hi - ov_lo,) those rows minus ov_lo, increasing
  const int* heavy_rows;  // (nheavy,) the rows with a tile each
};

template <class T>
Layout<T> parse_layout(const long long* a) {
  Layout<T> l;
  l.row_pdf = reinterpret_cast<const int*>(a[0]);
  l.fam_ptr = reinterpret_cast<const int*>(a[1]);
  l.fam_src = reinterpret_cast<const int*>(a[2]);
  l.fam_w = reinterpret_cast<const T*>(a[3]);
  l.ovp_ptr = reinterpret_cast<const int*>(a[4]);
  l.ovp_lane = reinterpret_cast<const int*>(a[5]);
  l.heavy_rows = reinterpret_cast<const int*>(a[6]);
  return l;
}

// One staged (TS-deep) step of the tier product: acc[i][c] += Ws[s][ty*4 +
// i] * Xs[s][tx*4 + c] for s in order, by fused multiply-adds.
template <class T, int S>
__device__ __forceinline__ void tier_stage(T (&Ws)[S][TR], T (&Xs)[S][TB],
                                           T (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int ss = 0; ss < S; ++ss) {
    const V4<T> w = lds4(&Ws[ss][ty * 4]);
    const V4<T> x = lds4(&Xs[ss][tx * 4]);
    const T wv[4] = {w.x, w.y, w.z, w.w};
    const T xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fma_(wv[i], xv[c], acc[i][c]);
  }
}

// K1, tier part: acc[i][c] += sum_s W[k, s, d] * prev[src(k, s), b] for the
// 4x4 outputs of this thread (d = dbase + ty*4 + i, b = b0 + tx*4 + c), in s
// order.  Staging: thread tid copies column tid % 64 of rows tid / 64 + 4u of
// each (S x 64) stage of W[k] and of the gathered state rows (S = TS for
// float, stage_depth<double>() for double); the state is read past L1
// (another CTA of the persistent launch wrote it), and the next stage's
// values wait in registers while this one is multiplied.
template <class T, int S>
__device__ __forceinline__ void tier_tile(
    const Meta& m, int B, const T* __restrict__ prev,
    const T* __restrict__ W, long long k, long long dbase, int b0,
    T (&Ws)[S][TR], T (&Xs)[S][TB], T (&acc)[4][4]) {
  static_assert(TR == TB && NT % TR == 0 && S % (NT / TR) == 0, "tiles");
  constexpr int RS = NT / TR;  // staged rows per pass
  constexpr int PS = S * TR / NT;  // values each thread stages per stage
  const int tid = threadIdx.x;
  const int col = tid % TR, row0 = tid / TR;
  const bool dok = dbase + col < m.D, bok = b0 + col < B;
  const T* pw = W + (k * m.Sm + row0) * m.D + dbase + col;
  const T* px = prev + (m.g0 + k * m.gk + row0 * m.gs) * B + b0 + col;
  const long long wstep = RS * m.D, xstep = RS * m.gs * B;
  T wn[PS], xn[PS];
  auto fetch = [&](long long s0) {  // the stage into registers
#pragma unroll
    for (int u = 0; u < PS; ++u) {
      const bool sok = s0 + row0 + u * RS < m.Sm;
      wn[u] = (sok && dok) ? pw[u * wstep] : T(0);
      xn[u] = (sok && bok) ? __ldcg(px + u * xstep) : T(0);
    }
    pw += S * m.D;
    px += S * m.gs * B;
  };
  fetch(0);
  for (long long s0 = 0; s0 < m.Sm; s0 += S) {
#pragma unroll
    for (int u = 0; u < PS; ++u) {
      Ws[row0 + u * RS][col] = wn[u];
      Xs[row0 + u * RS][col] = xn[u];
    }
    __syncthreads();
    if (s0 + S < m.Sm) fetch(s0 + S);
    tier_stage(Ws, Xs, acc);
    __syncthreads();
  }
}

// The forward's tier part, float32, where B % 4 == 0 and D % 4 == 0: the
// sums of tier_tile in the same order, the stages copied as 16-byte
// cp.async (thread tid copies columns 4 (tid % 16) .. +3 of rows tid / 16
// + 16u) into a ring of two in shared memory, the next one in flight while
// one is multiplied (no registers held for it: with a stage in registers
// the forward spilled); the panels under L2 evict_last (every frame reads
// them again), the gathered state rows under `once` (the caller's policy
// for the frame's state reads).
__device__ __forceinline__ void fwd_tier_tile4(
    const Meta& m, int B, const float* __restrict__ prev,
    const float* __restrict__ W, long long k, long long dbase, int b0,
    float (&Ws)[TS][TR], float (&Xs)[TS][TB], float (&Ws2)[TS][TR],
    float (&Xs2)[TS][TB], float (&acc)[4][4], unsigned long long once) {
  constexpr int RV = NT / (TR / 4);  // rows staged per pass
  static_assert(TS == 2 * RV && TR == TB, "two float4 passes per stage");
  const unsigned long long keep = evict_last_policy();
  const int tid = threadIdx.x, c4 = (tid % 16) * 4, r = tid / 16;
  const bool dok = dbase + c4 < m.D, bok = b0 + c4 < B;
  const float* pw = W + (k * m.Sm + r) * m.D + dbase + c4;
  const float* px = prev + (m.g0 + k * m.gk + r * m.gs) * B + b0 + c4;
  const long long wstep = RV * m.D, xstep = RV * m.gs * B;
  auto issue = [&](long long s0, float (&Wd)[TS][TR], float (&Xd)[TS][TB]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool sok = s0 + r + u * RV < m.Sm;
      cp_async16_hint(&Wd[r + u * RV][c4], sok && dok ? pw + u * wstep : pw,
                      sok && dok, keep);
      cp_async16_hint(&Xd[r + u * RV][c4], sok && bok ? px + u * xstep : px,
                      sok && bok, once);
    }
    cp_async_commit();
    pw += TS * m.D;
    px += TS * m.gs * B;
  };
  issue(0, Ws, Xs);
  int buf = 0;
  for (long long s0 = 0; s0 < m.Sm; s0 += TS, buf ^= 1) {
    if (s0 + TS < m.Sm) {
      if (buf) issue(s0 + TS, Ws, Xs); else issue(s0 + TS, Ws2, Xs2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (buf) tier_stage(Ws2, Xs2, acc); else tier_stage(Ws, Xs, acc);
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
// (acc = the tile's product).  PRE (K4): the next stage's values wait in
// registers while this one is multiplied (the bf16 forward measured slower
// with it); else each pair is stored as it arrives, the state read under
// the L2 policy `once`.
template <bool PRE>
__device__ __forceinline__ void tier_tile_bf16(
    const Meta& m, int B, const float* __restrict__ prev,
    const __nv_bfloat16* __restrict__ W, long long k, long long dbase,
    int b0, float (&Ws)[TS][TR], float (&Xs)[TS][TB],
    float (&C)[TR][TB + 1], float (&acc)[4][4],
    unsigned long long once = 0) {
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
  // the pair (s, s+1) of a stage as the product reads it, the state past L1
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
      if constexpr (PRE)
        x2 = __floats2bfloat162_rn(__ldcg(x), __ldcg(x + m.gs * B));
      else
        x2 = __floats2bfloat162_rn(ldcg_hint(x, once),
                                   ldcg_hint(x + m.gs * B, once));
    }
  };
  __nv_bfloat162 wn[PU], xn[PU];  // PRE: the next stage
  if constexpr (PRE) {
#pragma unroll
    for (int u = 0; u < PU; ++u) pair(0, 2 * (pr + u * PR), wn[u], xn[u]);
  }
  for (long long s0 = 0; s0 < m.Sm; s0 += TS) {
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int s = 2 * (pr + u * PR);
      if constexpr (!PRE) pair(s0, s, wn[u], xn[u]);
      *reinterpret_cast<__nv_bfloat162*>(&Wb[col][s]) = wn[u];
      *reinterpret_cast<__nv_bfloat162*>(&Xb[col][s]) = xn[u];
    }
    __syncthreads();
    if constexpr (PRE) {
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
// sums land in P[ty][col], which the row's epilogue adds in ty order.  The
// loop is unrolled so that the terms' loads overlap (the same sums in the
// same order); the state is read past L1, the forward's (not BWD) under
// the L2 policy `once`.
template <bool VEC, bool BWD, class T, int S>
__device__ __forceinline__ void heavy_terms(const Layout<T>& lay, int B,
                                            const T* __restrict__ prev,
                                            int j, int b0,
                                            T (&P)[S][TB],
                                            unsigned long long once = 0) {
  static_assert(NT / 16 <= S, "partials");
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;
  T s[4] = {T(0), T(0), T(0), T(0)};
  const int q1 = lay.fam_ptr[j + 1];
  auto term = [&](int q) {
    const T w = lay.fam_w[q];
    const T* row = prev + static_cast<size_t>(lay.fam_src[q]) * B;
    const V4<T> x = BWD ? load4<VEC, true>(row, bcol, B)
                        : load4_hint<VEC>(row, bcol, B, once);
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = fma_(w, get(x, c), s[c]);
  };
#pragma unroll 4
  for (int q = lay.fam_ptr[j] + ty; q < q1; q += NT / 16) term(q);
#pragma unroll
  for (int c = 0; c < 4; ++c) P[ty][tx * 4 + c] = s[c];
}

// The state row of row r of tile `tile` in the kernels' tile order (a
// heavy row's tile, then the tier tiles, then the 64-row band tiles), or -1.
// row0: the first row of a band tile of consecutive rows, else -1.
template <bool FAM, class L>
__device__ __forceinline__ long long tile_row(const Meta& m, const L& lay,
                                              const int* band_rows,
                                              long long tile, int r,
                                              int row0) {
  if (FAM && tile < m.nheavy) return r == 0 ? lay.heavy_rows[tile] : -1;
  const long long tt = tile - (FAM ? m.nheavy : 0);
  if (tt < m.n_tier_tiles) {
    const long long dtiles = (m.D + TR - 1) / TR;
    const long long k = tt / dtiles, d = (tt % dtiles) * TR + r;
    return d < m.D ? m.d0 + k * m.dk + d * m.dd : -1;
  }
  const long long q = (tt - m.n_tier_tiles) * TR + r;
  return q < m.nband ? (row0 >= 0 ? row0 + r : band_rows[q]) : -1;
}

// The exponent k of column b's scale 2^-k from its max's float bits, the
// max of the CM copies (each B apart), which another CTA wrote.
__device__ __forceinline__ float exponent_of(const unsigned* cm, int b, int B) {
  unsigned mx = 0u;
#pragma unroll
  for (int c = 0; c < CM; ++c) mx = max(mx, __ldcg(cm + c * B + b));
  return pow2_exponent(__uint_as_float(mx));
}

// The same from a double max's bits.
__device__ __forceinline__ double exponent_of(const unsigned long long* cm,
                                              int b, int B) {
  unsigned long long mx = 0ull;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    const unsigned long long v = __ldcg(cm + c * B + b);
    mx = v > mx ? v : mx;
  }
  return pow2_exponent(__longlong_as_double(static_cast<long long>(mx)));
}

// The exact power-of-two scale of column b, 0 past the batch.
template <class U>
__device__ __forceinline__ auto scale_of(const U* cm, int b, int B) {
  using T = decltype(exponent_of(cm, b, B));
  return b < B ? pow2_scale(exponent_of(cm, b, B)) : T(0);
}

// ---------------------------------------------------------------------------
// K2 and K3: the forward over a sweep or a chunk, one persistent launch
// ---------------------------------------------------------------------------

// V: the value type (float or double).
template <class V = float>
struct FwdArgs {
  Meta m;
  Layout<V> lay;
  int B, T;        // T frames
  int skip_first;  // frame 0 is the sweep's first: y = prev * e
  int chunk;       // K2: a checkpoint before every chunk-th frame; K3: 0
  const V* a0;        // (Sp, B) the state before frame 0, unscaled
  const V* scale_in;  // (B,) its scale
  const V* ext;       // (T, P1, B)
  const V* mshift;    // K2: (T, 1, B) the emission shifts
  const V* band_w;
  const void* W;
  const V* omega;
  const int* band_rows;
  const int2* queue;  // (n_items,) as K4's (fwd_plan)
  int n_items;
  long long fin_tile;  // the tile that holds the phony final row
  int fin_row0;        // its queue's first row (-1: its row list)
  V* out;     // K3: (T, Sp, B) every frame's state; K2: (2, Sp, B)
  V* last;    // K2: (Sp, B) frame T-1's state; K3: null
  V* bounds;  // K2: (T / chunk, Sp, B) the checkpoints
  V* bscale;  // K2: (T / chunk, B) their scales
  V* scales;  // K3: (T, B) every frame's scale; K2: (B,) the last one
  V* ksum;    // K2: (B,) sum of the exponents, zero on entry
  V* shift;   // K2: (B,) the Kahan-compensated emission shift, zero
  V* comp;    // K2: (B,) its compensation, zero
  V* part;    // (2, n_tiles, B) per-tile partials of omega . state
  BitsT<V>* cm;  // (T, CM, B) column max of each frame (value bits), zeroed
  unsigned* ctr;   // (T,) each frame's queue position, zeroed
  unsigned* sync;  // (SYNC_GEN + 1,) barrier counter, generation, zeroed
};

// The forward's grid barrier: the generation on its own line of L2, apart
// from the counter that every arriving CTA adds to, and the waiters polling
// at most every 256 ns (a frame is ~30-50 us).
constexpr int SYNC_GEN = 32;  // the barrier takes SYNC_GEN + 1 words
__device__ __forceinline__ void fwd_grid_sync(unsigned* sync) {
  grid_sync<SYNC_GEN, 256>(sync);
}

// Shared memory of one forward CTA (V: the value type; 37 KB for double).
template <bool BF16, class V = float>
struct FwdSmem {
  static constexpr int S = stage_depth<V>();
  // the float32 tier's ring of two stages (cp.async)
  static constexpr bool RING = !BF16 && !is_f64<V>();
  V Ws[S][TR];  // the tier stages (a heavy row: its 16 partial sums)
  V Xs[S][TB];
  V Ws2[RING ? S : 1][TR];  // float32: the second stage of the ring
  V Xs2[RING ? S : 1][TB];
  V red[2][16][TB];
  float G[BF16 ? TR : 1][TB + 1];  // BF16: the tier product's outputs
  int rows[TR];  // state row of each tile row, -1 if none
  int pdf[TR];   // its pdf (the emission's row of ext)
  V sc[TB];  // the previous frame's scale of the item's columns
  int2 next[2];  // the queue entries taken for the next items
  V fr[2][FR];  // the omega reduction of two columns
  V fp[2][16];  // the phony row's tile: its thread rows' partials
};

// Where frame j of the launch reads and writes.
template <class V>
struct FwdFrame {
  const V* prev;        // the state of frame j-1 (a0 for j = 0)
  V* out;               // the state of frame j
  const V* ext_t;
  const BitsT<V>* cm_prev;  // frame j-1's column max, null: scale_in
  BitsT<V>* cm_t;
  const V* part_prev;   // frame j-1's omega partials (prologue: a0's)
  V* part_t;            // frame j's
  V* bound;             // K2 before a chunk: the checkpoint, else null
  bool skip;                // the sweep's first frame: y = prev * e
};

// One work item of one forward frame (K2, K3) over one (row tile, column
// tile): a heavy row's tile (FAM only: tiles 0 .. nheavy-1), a tier tile
// (64 destinations of one tier block) or a band tile (64 rows of
// band_rows): y = (M prev)*s (or prev on the sweep's first frame), y *= e,
// its column max into cm_t (atomicMax on the float bits, CTA c into copy c %
// CM), and the tile's partial of omega . y (each thread's rows by fused
// multiply-adds, then the 16 thread rows in order) into part_t, the next
// frame's phony row.  M prev = tier + bands + the row's family terms (FAM:
// the capped layout); BF16: the tier on the tensor cores (tier_tile_bf16).
// The phony row itself is left to the frame's finalize (fwd_finalize),
// except on the sweep's first frame, which has none.  Before a chunk (K2)
// the tile's rows of prev are copied to the checkpoint.  The arithmetic is
// that of the per-frame step it replaces, sum for sum.
template <bool VEC, bool FAM, bool BF16, class T>
__device__ __forceinline__ void fwd_item(
    const FwdArgs<T>& p, const FwdFrame<T>& f, long long tile, int b0,
    int row0, FwdSmem<BF16, T>& s, const T* __restrict__ prev,
    T* __restrict__ out, const T* __restrict__ ext_t,
    const T* __restrict__ omega, const T* __restrict__ band_w) {
  const Meta& m = p.m;
  const Layout<T>& lay = p.lay;
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
    const long long j = tile_row<FAM>(m, lay, p.band_rows, tile, tid, row0);
    s.rows[tid] = static_cast<int>(j);
    s.pdf[tid] =
        j < 0 ? -1 : (FAM ? lay.row_pdf[j] : static_cast<int>(j / m.cmax));
  } else if (tid < TR + TB) {
    const int b = b0 + tid - TR;
    s.sc[tid - TR] = f.cm_prev == nullptr ? (b < B ? p.scale_in[b] : T(0))
                                          : scale_of(f.cm_prev, b, B);
  }
  // the state read under evict_first, the new state stored under
  // evict_last: what the next frame reads stays in L2 before what this
  // frame has read
  const unsigned long long once = evict_first_policy();
  const unsigned long long keep = evict_last_policy();
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = T(0);
  if (is_tier && !f.skip) {
    const T* Wf = static_cast<const T*>(p.W);
    if constexpr (BF16)
      tier_tile_bf16<false>(m, B, prev,
                            static_cast<const __nv_bfloat16*>(p.W), k, dbase,
                            b0, s.Ws, s.Xs, s.G, acc, once);
    else if constexpr (is_f64<T>())
      tier_tile(m, B, prev, Wf, k, dbase, b0, s.Ws, s.Xs, acc);
    else if (VEC && m.D % 4 == 0)
      fwd_tier_tile4(m, B, prev, Wf, k, dbase, b0, s.Ws, s.Xs, s.Ws2, s.Xs2,
                     acc, once);
    else
      tier_tile(m, B, prev, Wf, k, dbase, b0, s.Ws, s.Xs, acc);
  }
  if constexpr (FAM) {
    if (is_heavy && !f.skip)
      heavy_terms<VEC, false>(lay, B, prev, lay.heavy_rows[tile], b0, s.Xs,
                              once);
  }
  __syncthreads();

  const V4<T> sc = make4<T>(s.sc[tx * 4], s.sc[tx * 4 + 1],
                            s.sc[tx * 4 + 2], s.sc[tx * 4 + 3]);
  T colmax[4] = {T(0), T(0), T(0), T(0)}, colsum[4] = {T(0), T(0), T(0), T(0)};
  // rows in pairs: a pair's first PB band terms (weight and state row)
  // are all loaded before any is used, one memory round trip per pair
  // instead of one per term (four rows at once spilled); the sums then run
  // in the per-frame step's order
  constexpr int PB = 2;
#pragma unroll
  for (int i0 = 0; i0 < 4; i0 += 2) {
    V4<T> xb[2][PB];
    T wb[2][PB];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ty * 4 + i0 + h, j = s.rows[r];
#pragma unroll
      for (int o = 0; o < PB; ++o) {
        const int src = j - m.off[o];
        const bool ok = !f.skip && j >= 0 && o < m.nO && src >= 0 &&
                        src < m.Sp;
        wb[h][o] = ok ? band_w[static_cast<size_t>(o) * m.Sp + j] : T(0);
        xb[h][o] = ok ? load4_hint<VEC>(prev + static_cast<size_t>(src) * B,
                                        bcol, B, once)
                      : zero4<T>();
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h;
      const int r = ty * 4 + i;
      const int j = s.rows[r];
      if (j < 0) continue;
      const size_t jB = static_cast<size_t>(j) * B;
      const V4<T> e =
          load4<VEC>(ext_t + static_cast<size_t>(s.pdf[r]) * B, bcol, B);
      const T om = omega[j];
      T v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      if (!f.skip) {
#pragma unroll
        for (int o = 0; o < MAX_BANDS; ++o) {
          if (o >= m.nO) break;  // uniform across the block
          const int src = j - m.off[o];
          if (src < 0 || src >= m.Sp) continue;  // wrapped: no arc
          const T w = o < PB ? wb[h][o < PB ? o : 0]
                             : band_w[static_cast<size_t>(o) * m.Sp + j];
          const V4<T> x =
              o < PB ? xb[h][o < PB ? o : 0]
                     : load4_hint<VEC>(prev + static_cast<size_t>(src) * B,
                                       bcol, B, once);
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = fma_(w, get(x, c), v[c]);
        }
        if constexpr (FAM) {  // overflow families (K1's apply_ov)
          if (is_heavy) {  // split over the thread rows
            for (int g = 0; g < NT / 16; ++g)
#pragma unroll
              for (int c = 0; c < 4; ++c) v[c] += s.Xs[g][tx * 4 + c];
          } else {  // pulled by this thread
            const int e1 = lay.fam_ptr[j + 1];
#pragma unroll 4
            for (int q = lay.fam_ptr[j]; q < e1; ++q) {
              const T w = lay.fam_w[q];
              const V4<T> x = load4_hint<VEC>(
                  prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B,
                  once);
#pragma unroll
              for (int c = 0; c < 4; ++c) v[c] = fma_(w, get(x, c), v[c]);
            }
          }
        }
      }
      V4<T> pv = zero4<T>();
      if (f.skip || f.bound != nullptr)
        pv = load4<VEC, true>(prev + jB, bcol, B);
      if (f.bound != nullptr) store4<VEC>(f.bound + jB, bcol, B, pv);
      T y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[c] = (f.skip ? get(pv, c) : v[c] * get(sc, c)) * get(e, c);
        colmax[c] = fmax_(colmax[c], y[c]);
        colsum[c] = fma_(om, y[c], colsum[c]);
      }
      if (f.skip || j != m.fin)
        store4_hint<VEC>(out + jB, bcol, B, make4<T>(y[0], y[1], y[2], y[3]),
                         keep);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.red[0][ty][tx * 4 + c] = colmax[c];
    s.red[1][ty][tx * 4 + c] = colsum[c];
  }
  __syncthreads();
  if (tid < TB && b0 + tid < B) {
    const int b = b0 + tid;
    T mx = T(0), sm = T(0);
    for (int q = 0; q < 16; ++q) {
      mx = fmax_(mx, s.red[0][q][tid]);
      sm += s.red[1][q][tid];
    }
    atomicMax(f.cm_t + (blockIdx.x % CM) * B + b, to_bits(mx));
    f.part_t[tile * B + b] = sm;
  }
  __syncthreads();  // the tables and stages are free for the next item
}

// The omega partials of the launch's first state a0 (K3 from a
// checkpoint), the same per-tile sums as fwd_item's, over a static round
// robin of the items.
template <bool VEC, bool FAM, class T>
__device__ __forceinline__ void fwd_prologue(const FwdArgs<T>& p, T* part,
                                             T (&red)[2][16][TB]) {
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int it = blockIdx.x; it < p.n_items; it += gridDim.x) {
    const long long tile = it / ncb;
    const int b0 = (it % ncb) * TB, bcol = b0 + tx * 4;
    T colsum[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long j =
          tile_row<FAM>(m, p.lay, p.band_rows, tile, ty * 4 + i, -1);
      if (j < 0) continue;
      const T om = p.omega[j];
      const V4<T> x = load4<VEC, true>(p.a0 + j * B, bcol, B);
#pragma unroll
      for (int c = 0; c < 4; ++c) colsum[c] = fma_(om, get(x, c), colsum[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) red[1][ty][tx * 4 + c] = colsum[c];
    __syncthreads();
    if (tid < TB && b0 + tid < B) {
      T sm = T(0);
      for (int q = 0; q < 16; ++q) sm += red[1][q][tid];
      part[tile * B + b0 + tid] = sm;
    }
    __syncthreads();
  }
}

// The end of forward frame j-1 and the phony row of frame j, which the
// per-frame finalize did (for frame j-1) between two step launches; here in
// frame j, by CTAs c < ceil(B / 2) (two columns each, FR threads per
// column) before they take items.  Frame j-1's column max is complete
// (the last barrier): its scale s = 2^-k, and K2's ksum += k and the Kahan
// emission shift, or K3's scale output.  Frame j's phony row y[fin] =
// (omega . prev) * s * e_fin: the per-tile partials of frame j-1 (each
// written by fwd_item from its own y, but the phony row's tile, whose
// partial is taken again here from prev's final rows), summed in the
// per-frame finalize's fixed order (thread ry every FR-th tile from ry,
// then a tree), written to out and taken into frame j's column max before
// the barrier that ends frame j, since frame j's items do not read it.
// Each thread issues PT loads of partials before it sums any.
template <bool FAM, bool BF16, class T>
__device__ __forceinline__ void fwd_finalize(const FwdArgs<T>& p,
                                             const FwdFrame<T>& f, int j,
                                             FwdSmem<BF16, T>& s) {
  constexpr int PT = 8;
  const Meta& m = p.m;
  const int B = p.B, tid = threadIdx.x, h = tid / FR, ry = tid % FR;
  const int pfin = FAM ? p.lay.row_pdf[m.fin] : m.fin / m.cmax;
  for (int cp = blockIdx.x; 2 * cp < B; cp += gridDim.x) {
    const int b = 2 * cp + h;
    const bool ok = b < B;
    // the first PT partials in flight while the scale is derived and
    // threads ry < 16 take thread row ry's part of the phony row's tile
    // from prev's final rows
    T v[PT];
    auto load = [&](long long t0) {
#pragma unroll
      for (int u = 0; u < PT; ++u) {
        const long long t = t0 + u * FR;
        v[u] = ok && t < m.n_tiles && t != p.fin_tile
                   ? __ldcg(f.part_prev + t * B + b)
                   : T(0);
      }
    };
    load(ry);
    T sc = T(0);
    if (ok && j == 0) {
      sc = p.scale_in[b];
    } else if (ok) {
      const T k = exponent_of(f.cm_prev, b, B);
      sc = pow2_scale(k);
      if (ry == 0) {
        if (p.ksum != nullptr) {  // K2
          p.ksum[b] = __ldcg(p.ksum + b) + k;
          const T sh = __ldcg(p.shift + b), cmp = __ldcg(p.comp + b);
          const T xc = p.mshift[static_cast<size_t>(j - 1) * B + b] - cmp;
          const T t = sh + xc;
          p.comp[b] = (t - sh) - xc;
          p.shift[b] = t;
          if (j % p.chunk == 0)
            p.bscale[static_cast<size_t>(j / p.chunk) * B + b] = sc;
        } else {  // K3
          p.scales[static_cast<size_t>(j - 1) * B + b] = sc;
        }
      }
    }
    if (ry < 16) {
      T cs = T(0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = tile_row<FAM>(m, p.lay, p.band_rows, p.fin_tile,
                                          ry * 4 + i, p.fin_row0);
        if (r >= 0 && ok)
          cs = fma_(p.omega[r], __ldcg(f.prev + r * B + b), cs);
      }
      s.fp[h][ry] = cs;
    }
    __syncthreads();
    T sm = T(0);
    for (long long t0 = ry; t0 < m.n_tiles; t0 += PT * FR) {
      if (t0 != ry) load(t0);
#pragma unroll
      for (int u = 0; u < PT; ++u) {
        const long long t = t0 + u * FR;
        if (t == p.fin_tile) {  // its thread rows' partials in order
          v[u] = T(0);
          for (int q = 0; q < 16; ++q) v[u] += s.fp[h][q];
        }
        if (t < m.n_tiles) sm += v[u];
      }
    }
    s.fr[h][ry] = sm;
    __syncthreads();
    for (int hh = FR / 2; hh > 0; hh /= 2) {
      if (ry < hh) s.fr[h][ry] += s.fr[h][ry + hh];
      __syncthreads();
    }
    if (ry == 0 && ok) {
      const T yfin =
          s.fr[h][0] * sc * f.ext_t[static_cast<size_t>(pfin) * B + b];
      f.out[static_cast<size_t>(m.fin) * B + b] = yfin;
      atomicMax(f.cm_t + (blockIdx.x % CM) * B + b, to_bits(yfin));
    }
    __syncthreads();  // fp and fr are free
  }
}

// K2 / K3 over frames 0 .. T-1: each CTA runs the frame's finalize share
// (fwd_finalize) and then items from the frame's queue, one grid barrier
// per frame; after the last, frame T-1's scale (and K2's ksum and shift).
template <bool VEC, bool FAM, bool BF16, class T>
__global__ void __launch_bounds__(NT, fwd_blocks<T>())
    fwd_chunk_kernel(const __grid_constant__ FwdArgs<T> p) {
  __shared__ __align__(16) FwdSmem<BF16, T> s;
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB, tid = threadIdx.x;
  const size_t SB = static_cast<size_t>(m.Sp) * B;
  const size_t PB = static_cast<size_t>(m.P1) * B;
  const size_t NB = static_cast<size_t>(m.n_tiles) * B;
  auto state = [&](int j) -> T* {
    if (p.last == nullptr) return p.out + j * SB;  // K3: every frame
    return j == p.T - 1 ? p.last : p.out + (j % 2) * SB;
  };
  if (!p.skip_first) {  // a0's omega partials, for frame 0's phony row
    fwd_prologue<VEC, FAM>(p, p.part + NB, s.red);
    fwd_grid_sync(p.sync);
  }
  for (int j = 0; j < p.T; ++j) {
    FwdFrame<T> f;
    f.prev = j == 0 ? p.a0 : state(j - 1);
    f.out = state(j);
    f.ext_t = p.ext + j * PB;
    f.cm_prev = j == 0 ? nullptr : p.cm + static_cast<size_t>(j - 1) * CM * B;
    f.cm_t = p.cm + static_cast<size_t>(j) * CM * B;
    f.part_prev = p.part + ((j + 1) % 2) * NB;
    f.part_t = p.part + (j % 2) * NB;
    f.bound = p.chunk && j % p.chunk == 0
                  ? p.bounds + static_cast<size_t>(j / p.chunk) * SB
                  : nullptr;
    f.skip = p.skip_first && j == 0;
    if (j + 1 < p.T) {  // the next frame's emissions into L2, spread
      constexpr int LINE = 128 / sizeof(T);  // values per 128-byte line
      const T* e = p.ext + (j + 1) * PB;
      const size_t n_e = (PB + LINE - 1) / LINE;
      for (size_t i = static_cast<size_t>(blockIdx.x) * NT + tid; i < n_e;
           i += static_cast<size_t>(gridDim.x) * NT)
        prefetch_l2(e + i * LINE);
    }
    if (!f.skip) {
      fwd_finalize<FAM, BF16, T>(p, f, j, s);
    } else if (p.chunk) {  // K2's first checkpoint scale
      for (int b = blockIdx.x * NT + tid; b < B; b += gridDim.x * NT)
        p.bscale[b] = p.scale_in[b];
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
      fwd_item<VEC, FAM, BF16, T>(p, f, q.x / ncb, (q.x % ncb) * TB, q.y, s,
                                  f.prev, f.out, f.ext_t, p.omega, p.band_w);
      par ^= 1;  // fwd_item ends with a block barrier: s.next[par] is set
    }
    fwd_grid_sync(p.sync);
  }
  // frame T-1's scale, once its column max is complete
  const BitsT<T>* cm = p.cm + static_cast<size_t>(p.T - 1) * CM * B;
  for (int b = blockIdx.x * NT + tid; b < B; b += gridDim.x * NT) {
    const T k = exponent_of(cm, b, B);
    if (p.ksum != nullptr) {  // K2
      p.scales[b] = pow2_scale(k);
      p.ksum[b] = __ldcg(p.ksum + b) + k;
      const T sh = __ldcg(p.shift + b), cmp = __ldcg(p.comp + b);
      const T xc = p.mshift[static_cast<size_t>(p.T - 1) * B + b] - cmp;
      const T t = sh + xc;
      p.comp[b] = (t - sh) - xc;
      p.shift[b] = t;
    } else {
      p.scales[static_cast<size_t>(p.T - 1) * B + b] = pow2_scale(k);
    }
  }
}

// The bf16 tier tile stages whole 16-deep steps (tier_tile_bf16).
bool bad_tier(const Meta& m, int bf16) { return bf16 && m.Sm % KS; }

// ---------------------------------------------------------------------------
// K4: the backward over one chunk, one persistent cooperative launch
// ---------------------------------------------------------------------------

// V: the value type (float or double).
template <class V = float>
struct BwdArgs {
  Meta m;
  Layout<V> lay;
  int B, K, skip_last;  // skip_last: frame K-1 starts from beta = 1
  const V* beta_in;   // (Sp, B) the state after the chunk, unscaled
  const V* scale_in;  // (B,) its scale
  const V* alphas;    // (K, Sp, B) unscaled
  const V* ascale;    // (K, B)
  const V* ext;       // (K, P1, B)
  const V* band_w;
  const void* W;
  const V* omega;
  const int* band_rows;
  // (n_items,) the queue: (tile * ncb + column tile, the first row of a
  // band tile of consecutive rows or -1)
  const int2* queue;
  int n_items;          // n_tiles * ncb
  V* work;          // (2, Sp, B) the states between the frames
  V* beta_out;      // (Sp, B) frame 0's state, unscaled
  V* scale_out;     // (B,) its scale
  V* posts;         // (K, P1, B) zero on entry
  V* ovg;           // (K, ov_hi - ov_lo, B) the overflow rows' gammas
  V* csum;          // (K, n_items, TB) each item's column sums of gamma
  BitsT<V>* cm;     // (K, CM, B) column max of beta (value bits), zeroed
  unsigned* ctr;        // (K,) each frame's queue position, zeroed
  unsigned* sync;       // (2,) barrier counter and generation, zeroed
};

// Shared memory of one CTA: the tier stages, the reductions, the gamma
// tile (BF16: first the tier product's outputs) and the tile's row tables
// (V: the value type; 69 KB for double, the dynamic block).
template <class V = float>
struct BwdSmem {
  static constexpr int S = stage_depth<V>();
  // the tier stages; after the product (at once for a band tile; float
  // only) they hold the item's 64 x 64 block of alpha_t
  V Ws[S][TR];
  V Xs[S][TB];
  V red[2][16][TB];
  V G[TR][TB + 1];  // the gamma tile (BF16: first the tier's outputs)
  int rows[TR];  // state row of each tile row, -1 if none
  int pdf[TR];   // its pdf (the emission's row of ext)
  int grp[TR];   // its posterior row, -1 for overflow rows
  V rs[8][32];  // the normalisation's column sums
  int2 next[2];     // the queue entries taken for the next items
  V sc[TB];     // the previous frame's scale of the item's columns
};

// Where frame j of the chunk reads and writes.
template <class V>
struct BwdFrame {
  const V* prev;        // beta of frame j+1 (unscaled)
  V* out;               // beta of frame j
  const V* ext_t;
  const V* alpha_t;
  const V* ascale_t;
  V* posts_t;           // (P1, B) unnormalised posteriors
  V* ovg_t;
  BitsT<V>* cm_t;           // this frame's column max (CM copies)
  const BitsT<V>* cm_prev;  // frame j+1's, null: scale_in
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
template <bool VEC, bool FAM, bool BF16, class T>
__device__ __forceinline__ T bwd_item(
    const BwdArgs<T>& p, const BwdFrame<T>& f, long long tile, int b0,
    int row0, BwdSmem<T>& s, const T* __restrict__ prev,
    T* __restrict__ out, const T* __restrict__ ext_t,
    const T* __restrict__ alpha_t, const T* __restrict__ omega,
    const T* __restrict__ band_w) {
  const Meta& m = p.m;
  const Layout<T>& lay = p.lay;
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
    s.sc[tid - TR] = f.cm_prev == nullptr ? (b < B ? p.scale_in[b] : T(0))
                                          : scale_of(f.cm_prev, b, B);
  }
  __syncthreads();
  // alpha_t's block of the tile: 64 rows x 16 chunks of 4 columns (float:
  // the double block would not fit the stages)
  T* A = &s.Ws[0][0];
  const bool staged = VEC && !is_heavy && !is_f64<T>();
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
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = T(0);
  if constexpr (FAM && !BF16) {
    // a tier row's family terms before its float32 tier product: the first
    // term of each of the thread's 4 rows in flight at once, any others
    // after (the bf16 tier pulls them after the product, with the bands:
    // accumulators live across the tensor-core tile spill)
    if (is_tier && !f.skip) {
      int q0[4], q1[4], src[4];
      T w[4];
      V4<T> x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = s.rows[ty * 4 + i];
        q0[i] = j < 0 ? 0 : lay.fam_ptr[j];
        q1[i] = j < 0 ? 0 : lay.fam_ptr[j + 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool any = q0[i] < q1[i];
        w[i] = any ? lay.fam_w[q0[i]] : T(0);
        src[i] = any ? lay.fam_src[q0[i]] : -1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = src[i] < 0 ? zero4<T>()
                          : load4<VEC, true>(
                                prev + static_cast<size_t>(src[i]) * B,
                                bcol, B);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = w[i] * get(x[i], c);
        for (int q = q0[i] + 1; q < q1[i]; ++q) {
          const T wq = lay.fam_w[q];
          const V4<T> xq = load4<VEC, true>(
              prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fma_(wq, get(xq, c), acc[i][c]);
        }
      }
    }
  }
  if (is_tier && !f.skip) {
    if constexpr (BF16)
      tier_tile_bf16<true>(m, B, prev, static_cast<const __nv_bfloat16*>(p.W),
                           k, dbase, b0, s.Ws, s.Xs, s.G, acc);
    else
      tier_tile(m, B, prev, static_cast<const T*>(p.W), k, dbase, b0, s.Ws,
                s.Xs, acc);
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
        const T w = band_w[static_cast<size_t>(o) * m.Sp + j];
        const V4<T> x =
            load4<VEC, true>(prev + static_cast<size_t>(src) * B, bcol, B);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fma_(w, get(x, c), acc[i][c]);
      }
      if constexpr (FAM) {  // overflow families (K1's apply_ov)
        if (!is_heavy && (BF16 || !is_tier)) {  // pulled by this thread
          const int e1 = lay.fam_ptr[j + 1];
#pragma unroll 4
          for (int q = lay.fam_ptr[j]; q < e1; ++q) {
            const T w = lay.fam_w[q];
            const V4<T> x = load4<VEC, true>(
                prev + static_cast<size_t>(lay.fam_src[q]) * B, bcol, B);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fma_(w, get(x, c), acc[i][c]);
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

  const V4<T> sc = make4<T>(s.sc[tx * 4], s.sc[tx * 4 + 1],
                            s.sc[tx * 4 + 2], s.sc[tx * 4 + 3]);
  const V4<T> pfin =
      load4<VEC, true>(prev + static_cast<size_t>(m.fin) * B, bcol, B);
  const V4<T> asc = load4<VEC>(f.ascale_t, bcol, B);
  T colmax[4] = {T(0), T(0), T(0), T(0)}, colsum[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int j = s.rows[r];
    if (j < 0) {
      for (int c = 0; c < 4; ++c) s.G[r][tx * 4 + c] = T(0);
      continue;
    }
    const size_t jB = static_cast<size_t>(j) * B;
    const V4<T> e =
        load4<VEC>(ext_t + static_cast<size_t>(s.pdf[r]) * B, bcol, B);
    const T om = omega[j];
    T v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    if constexpr (FAM) {
      if (is_heavy && !f.skip) {  // split over the thread rows
        for (int g = 0; g < NT / 16; ++g)
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] += s.Xs[g][tx * 4 + c];
      }
    }
    const V4<T> a = staged ? lds4(&A[r * TB + tx * 4])
                           : load4<VEC>(alpha_t + jB, bcol, B);
    T bn[4], gv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T y =
          f.skip ? T(1) : fma_(om, get(pfin, c), v[c]) * get(sc, c);
      const T g = get(a, c) * get(asc, c) * y;
      s.G[r][tx * 4 + c] = g;
      gv[c] = g;
      colsum[c] += g;
      bn[c] = y * get(e, c);
      colmax[c] = fmax_(colmax[c], bn[c]);
    }
    if (FAM && j >= m.ov_lo && j < m.ov_hi)
      store4<VEC>(f.ovg_t + static_cast<size_t>(j - m.ov_lo) * B, bcol, B,
                  make4<T>(gv[0], gv[1], gv[2], gv[3]));
    store4<VEC>(out + jB, bcol, B, make4<T>(bn[0], bn[1], bn[2], bn[3]));
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.red[0][ty][tx * 4 + c] = colmax[c];
    s.red[1][ty][tx * 4 + c] = colsum[c];
  }
  __syncthreads();
  T sm = T(0);
  if (tid < TB && b0 + tid < B) {
    const int b = b0 + tid;
    T mx = T(0);
    for (int q = 0; q < 16; ++q) {
      mx = fmax_(mx, s.red[0][q][tid]);
      sm += s.red[1][q][tid];
    }
    atomicMax(f.cm_t + (blockIdx.x % CM) * B + b, to_bits(mx));
    if (one_group) {
      atomicAdd(&f.posts_t[static_cast<size_t>(s.grp[0]) * B + b], sm);
    } else {
      // runs of rows in one pdf group add up here, one atomic per run
      int g = -1;
      T run = T(0);
      for (int q = 0; q < TR; ++q) {
        const int gq = s.grp[q];
        if (gq < 0) continue;
        if (gq != g) {
          if (g >= 0)
            atomicAdd(&f.posts_t[static_cast<size_t>(g) * B + b], run);
          g = gq;
          run = T(0);
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
template <bool FAM, class T>
__device__ __forceinline__ void bwd_normalise(const BwdArgs<T>& p,
                                              BwdSmem<T>& s) {
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB, n_tiles = p.n_items / ncb;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int ncol = (B + 31) / 32, n_norm = p.K * ncol;
  const size_t nov = static_cast<size_t>(m.ov_hi - m.ov_lo);
  for (int it = blockIdx.x; it < n_norm; it += gridDim.x) {
    const int j = it / ncol, b = (it % ncol) * 32 + tx;
    T sm = T(0);
    if (b < B) {
      const T* cs = p.csum +
                        (static_cast<size_t>(j) * p.n_items + b / TB) * TB +
                        b % TB;
      const size_t step = static_cast<size_t>(ncb) * TB;
#pragma unroll 4
      for (int t = ty; t < n_tiles; t += 8) sm += __ldcg(cs + t * step);
    }
    s.rs[ty][tx] = sm;
    __syncthreads();
    T tot = T(0);
#pragma unroll
    for (int q = 0; q < 8; ++q) tot += s.rs[q][tx];
    const T den = tot > T(0) ? tot : T(1);
    if (b < B) {
      T* pt = p.posts + static_cast<size_t>(j) * m.P1 * B + b;
      const T* og = p.ovg + static_cast<size_t>(j) * nov * B + b;
#pragma unroll 4
      for (int pd = ty; pd < m.P1; pd += 8) {
        T v = __ldcg(pt + static_cast<size_t>(pd) * B);
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
template <bool VEC, bool FAM, bool BF16, class T>
__global__ void __launch_bounds__(NT, bwd_blocks<FAM, T>())
    bwd_chunk_kernel(const __grid_constant__ BwdArgs<T> p) {
  BwdSmem<T>& s = cta_smem<BwdSmem<T>, is_f64<T>()>();
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB, tid = threadIdx.x;
  const size_t SB = static_cast<size_t>(m.Sp) * B;
  const size_t PB = static_cast<size_t>(m.P1) * B;
  const size_t OB = static_cast<size_t>(m.ov_hi - m.ov_lo) * B;
  for (int j = p.K - 1; j >= 0; --j) {
    BwdFrame<T> f;
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
      constexpr int LINE = 128 / sizeof(T);  // values per 128-byte line
      const T* e = p.ext + (j - 1) * PB;
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
      const T sm = bwd_item<VEC, FAM, BF16, T>(
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
  bwd_normalise<FAM, T>(p, s);
}

// The instantiation of K2/K3 (fwd) or K4 for B % 4 == 0 (vec), the capped
// layout (fam) and prec: 0 float, 1 bf16 panels (the rest float), 2 double
// (no bf16 panels with double values).
template <template <bool, bool, bool, class> class K>
const void* pick(bool vec, bool fam, int prec) {
  if (prec == 2)
    return vec ? (fam ? K<true, true, false, double>::f()
                      : K<true, false, false, double>::f())
               : (fam ? K<false, true, false, double>::f()
                      : K<false, false, false, double>::f());
  if (prec == 1)
    return vec ? (fam ? K<true, true, true, float>::f()
                      : K<true, false, true, float>::f())
               : (fam ? K<false, true, true, float>::f()
                      : K<false, false, true, float>::f());
  return vec ? (fam ? K<true, true, false, float>::f()
                    : K<true, false, false, float>::f())
             : (fam ? K<false, true, false, float>::f()
                    : K<false, false, false, float>::f());
}
template <bool V, bool F, bool H, class T>
struct FwdK {
  static const void* f() { return (const void*)fwd_chunk_kernel<V, F, H, T>; }
};
template <bool V, bool F, bool H, class T>
struct BwdK {
  static const void* f() { return (const void*)bwd_chunk_kernel<V, F, H, T>; }
};

const void* coop_kernel(bool bwd, bool vec, bool fam, int prec) {
  return bwd ? pick<BwdK>(vec, fam, prec) : pick<FwdK>(vec, fam, prec);
}

// The dynamic shared memory of an instantiation: K4's double one (its
// block passes a static block's 48 KB), none for the others.
size_t dyn_bytes(bool bwd, int prec) {
  return bwd && prec == 2 ? sizeof(BwdSmem<double>) : 0;
}

// CTAs of a persistent instantiation with `dyn` bytes of dynamic shared
// memory that can be co-resident on the current device (0 where the device
// cannot launch cooperatively).
cudaError_t co_resident(const void* kern, size_t dyn, int* n) {
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && dyn > 0)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                        dyn);
  *n = coop ? per_sm * n_sm : 0;
  return err;
}

// One cooperative launch of n_ctas CTAs of kern with its argument block.
template <class Args>
int launch_coop(const void* kern, size_t dyn, Args& a, int n_ctas,
                void* stream) {
  int max_ctas = 0;
  cudaError_t err = co_resident(kern, dyn, &max_ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ctas > max_ctas)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(n_ctas), dim3(NT), args, dyn,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The forward's arguments shared by K2 and K3 (queue: ops/block_scan.py
// fwd_plan for ncb = ceil(B / 64) column tiles, n_items = n_tiles * ncb
// pairs of ints; fin_tile and fin_row0 the phony row's tile and its first
// row or -1).
template <class T>
bool fwd_args(FwdArgs<T>* a, const long long* imeta, const long long* ilay,
              int B, int T_, int prec, const int* queue, int n_items,
              int n_ctas, long long fin_tile, int fin_row0) {
  if (!parse_meta(imeta, &a->m) || B <= 0 || T_ <= 0 || n_ctas <= 0 ||
      n_items != a->m.n_tiles * ((B + TB - 1) / TB) || fin_tile < 0 ||
      fin_tile >= a->m.n_tiles || bad_tier(a->m, prec == 1))
    return false;
  a->lay = parse_layout<T>(ilay);
  a->B = B;
  a->T = T_;
  a->queue = reinterpret_cast<const int2*>(queue);
  a->n_items = n_items;
  a->fin_tile = fin_tile;
  a->fin_row0 = fin_row0;
  return true;
}

template <class T>
int block_fwd(const void* a0, const void* scale_in, const void* ext,
              const void* mshift, const void* band_w, const void* W,
              const void* omega, const int* band_rows, const long long* imeta,
              const long long* ilay, const int* queue, int n_items,
              int n_ctas, int fin_tile, int fin_row0, int B, int Npad,
              int chunk, int prec, void* work, void* a_last, void* bounds,
              void* bscale, void* scale, void* ksum, void* shift, void* comp,
              void* part, unsigned* cm, unsigned* ctr, unsigned* sync,
              void* stream) {
  FwdArgs<T> a{};
  if (!fwd_args(&a, imeta, ilay, B, Npad, prec, queue, n_items, n_ctas,
                fin_tile, fin_row0) ||
      chunk <= 0 || Npad % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  a.skip_first = 1;
  a.chunk = chunk;
  a.a0 = static_cast<const T*>(a0);
  a.scale_in = static_cast<const T*>(scale_in);
  a.ext = static_cast<const T*>(ext);
  a.mshift = static_cast<const T*>(mshift);
  a.band_w = static_cast<const T*>(band_w);
  a.W = W;
  a.omega = static_cast<const T*>(omega);
  a.band_rows = band_rows;
  a.out = static_cast<T*>(work);
  a.last = static_cast<T*>(a_last);
  a.bounds = static_cast<T*>(bounds);
  a.bscale = static_cast<T*>(bscale);
  a.scales = static_cast<T*>(scale);
  a.ksum = static_cast<T*>(ksum);
  a.shift = static_cast<T*>(shift);
  a.comp = static_cast<T*>(comp);
  a.part = static_cast<T*>(part);
  a.cm = reinterpret_cast<BitsT<T>*>(cm);
  a.ctr = ctr;
  a.sync = sync;
  return launch_coop(coop_kernel(false, B % 4 == 0, is_fam(a.m), prec),
                     dyn_bytes(false, prec), a, n_ctas, stream);
}

template <class T>
int block_recompute(const void* bound, const void* bscale, const void* ext_c,
                    const void* band_w, const void* W, const void* omega,
                    const int* band_rows, const long long* imeta,
                    const long long* ilay, const int* queue, int n_items,
                    int n_ctas, int fin_tile, int fin_row0, int B, int t0,
                    int K, int prec, void* alphas, void* ascale, void* part,
                    unsigned* cm, unsigned* ctr, unsigned* sync,
                    void* stream) {
  FwdArgs<T> a{};
  if (!fwd_args(&a, imeta, ilay, B, K, prec, queue, n_items, n_ctas,
                fin_tile, fin_row0) ||
      t0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.skip_first = t0 == 0;
  a.a0 = static_cast<const T*>(bound);
  a.scale_in = static_cast<const T*>(bscale);
  a.ext = static_cast<const T*>(ext_c);
  a.band_w = static_cast<const T*>(band_w);
  a.W = W;
  a.omega = static_cast<const T*>(omega);
  a.band_rows = band_rows;
  a.out = static_cast<T*>(alphas);
  a.scales = static_cast<T*>(ascale);
  a.part = static_cast<T*>(part);
  a.cm = reinterpret_cast<BitsT<T>*>(cm);
  a.ctr = ctr;
  a.sync = sync;
  return launch_coop(coop_kernel(false, B % 4 == 0, is_fam(a.m), prec),
                     dyn_bytes(false, prec), a, n_ctas, stream);
}

template <class T>
int block_bwd(const void* beta_in, const void* bscale, const void* alphas,
              const void* ascale, const void* ext_c, const void* band_w,
              const void* W, const void* omega, const int* band_rows,
              const long long* imeta, const long long* ilay, const int* queue,
              int n_items, int n_ctas, int B, int t0, int K, int Npad,
              int prec, void* work, void* beta_out, void* scale_out,
              void* posts, void* ovg, void* csum, unsigned* cm, unsigned* ctr,
              unsigned* sync, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || K <= 0 || t0 < 0 ||
      t0 + K > Npad || n_ctas <= 0 || n_items != m.n_tiles * ((B + TB - 1) / TB) ||
      bad_tier(m, prec == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs<T> a{};
  a.m = m;
  a.lay = parse_layout<T>(ilay);
  a.B = B;
  a.K = K;
  a.skip_last = t0 + K == Npad;
  a.beta_in = static_cast<const T*>(beta_in);
  a.scale_in = static_cast<const T*>(bscale);
  a.alphas = static_cast<const T*>(alphas);
  a.ascale = static_cast<const T*>(ascale);
  a.ext = static_cast<const T*>(ext_c);
  a.band_w = static_cast<const T*>(band_w);
  a.W = W;
  a.omega = static_cast<const T*>(omega);
  a.band_rows = band_rows;
  a.queue = reinterpret_cast<const int2*>(queue);
  a.n_items = n_items;
  a.work = static_cast<T*>(work);
  a.beta_out = static_cast<T*>(beta_out);
  a.scale_out = static_cast<T*>(scale_out);
  a.posts = static_cast<T*>(posts);
  a.ovg = static_cast<T*>(ovg);
  a.csum = static_cast<T*>(csum);
  a.cm = reinterpret_cast<BitsT<T>*>(cm);
  a.ctr = ctr;
  a.sync = sync;
  return launch_coop(coop_kernel(true, B % 4 == 0, is_fam(m), prec),
                     dyn_bytes(true, prec), a, n_ctas, stream);
}

bool bad_prec(int prec) { return prec < 0 || prec > 2; }

}  // namespace

// CTAs of the K2/K3 (bwd = 0) or K4 (bwd = 1) launch that can be
// co-resident on the current device for this instantiation (vec: B % 4 ==
// 0; fam: the capped layout; prec: 0 float, 1 bf16 panels, 2 double), or
// minus a CUDA error code.
extern "C" int mm_block_ctas(int bwd, int vec, int fam, int prec) {
  if (bad_prec(prec)) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = co_resident(coop_kernel(bwd, vec, fam, prec),
                                      dyn_bytes(bwd, prec), &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// K2: the forward sweep over frames 0 .. Npad-1 from a0 in one cooperative
// launch of n_ctas CTAs.  Before frame t with t % chunk == 0 the carried
// state and its scale are written to checkpoint t / chunk.  Frame Npad-1
// writes a_last; scale receives its scale; ksum, shift and comp accumulate
// the exponents and the emission shift (zero on entry).  scale_in: ones.
// prec 0: every value float; 1: the tier panels W in bf16 (precision
// 'bf16'), the rest float; 2: every value double (a float64 graph).
// Scratch: work (2, Sp, B), part (2, n_tiles, B), and cm (Npad, 16, B)
// values' bits (8-byte aligned for double), ctr (Npad) and sync (33)
// zeroed words.
extern "C" int mm_block_fwd(
    const void* a0, const void* scale_in, const void* ext,
    const void* mshift, const void* band_w, const void* W,
    const void* omega, const int* band_rows, const long long* imeta,
    const long long* ilay, const int* queue, int n_items, int n_ctas,
    int fin_tile, int fin_row0, int B, int Npad, int chunk, int prec,
    void* work, void* a_last, void* bounds, void* bscale, void* scale,
    void* ksum, void* shift, void* comp, void* part, unsigned* cm,
    unsigned* ctr, unsigned* sync, void* stream) {
  if (bad_prec(prec)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    return block_fwd<T>(a0, scale_in, ext, mshift, band_w, W, omega,
                        band_rows, imeta, ilay, queue, n_items, n_ctas,
                        fin_tile, fin_row0, B, Npad, chunk, prec, work,
                        a_last, bounds, bscale, scale, ksum, shift, comp,
                        part, cm, ctr, sync, stream);
  };
  return prec == 2 ? run(0.0) : run(0.f);
}

// K3: frames t0 .. t0+K-1 from a checkpoint (bound, bscale) in one
// cooperative launch; writes every frame's unscaled state to alphas[j] and
// its scale to ascale[j].  prec and scratch as K2's, over K frames.
extern "C" int mm_block_recompute(
    const void* bound, const void* bscale, const void* ext_c,
    const void* band_w, const void* W, const void* omega,
    const int* band_rows, const long long* imeta, const long long* ilay,
    const int* queue, int n_items, int n_ctas, int fin_tile, int fin_row0,
    int B, int t0, int K, int prec, void* alphas, void* ascale, void* part,
    unsigned* cm, unsigned* ctr, unsigned* sync, void* stream) {
  if (bad_prec(prec)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    return block_recompute<T>(bound, bscale, ext_c, band_w, W, omega,
                              band_rows, imeta, ilay, queue, n_items, n_ctas,
                              fin_tile, fin_row0, B, t0, K, prec, alphas,
                              ascale, part, cm, ctr, sync, stream);
  };
  return prec == 2 ? run(0.0) : run(0.f);
}

// K4: the reverse sweep over frames t0+K-1 .. t0 in one cooperative launch
// of n_ctas CTAs, which take the work items of every frame from a queue in
// the plan's order (queue: ops/block_scan.py bwd_plan for ncb = ceil(B /
// 64) column tiles, n_items = n_tiles * ncb pairs of ints: the item, the
// first row of a band tile of consecutive rows or -1).  beta_in and bscale carry the state from the chunk after; the
// last padded frame (t == Npad-1) starts from beta = 1.  posts (K, P1, B)
// must be zero on entry; frame t's normalised posteriors land in posts[t -
// t0].  beta_out and scale_out receive the state of frame t0 (unscaled,
// with its scale).  prec as K2's.  Scratch: work (2, Sp, B), ovg (K, ov_hi
// - ov_lo, B), csum (K, n_items, 64), and cm (K, 16, B) values' bits, ctr
// (K) and sync (2) zeroed words.
extern "C" int mm_block_bwd(
    const void* beta_in, const void* bscale, const void* alphas,
    const void* ascale, const void* ext_c, const void* band_w,
    const void* W, const void* omega, const int* band_rows,
    const long long* imeta, const long long* ilay, const int* queue,
    int n_items, int n_ctas, int B, int t0, int K, int Npad, int prec,
    void* work, void* beta_out, void* scale_out, void* posts, void* ovg,
    void* csum, unsigned* cm, unsigned* ctr, unsigned* sync, void* stream) {
  if (bad_prec(prec)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto zero) {
    using T = decltype(zero);
    return block_bwd<T>(beta_in, bscale, alphas, ascale, ext_c, band_w, W,
                        omega, band_rows, imeta, ilay, queue, n_items, n_ctas,
                        B, t0, K, Npad, prec, work, beta_out, scale_out,
                        posts, ovg, csum, cm, ctr, sync, stream);
  };
  return prec == 2 ? run(0.0) : run(0.f);
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
