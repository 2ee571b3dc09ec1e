// Stacked-banded forward-backward of the LF-MMI numerators on Hopper (sm_90a).
//
// Replaces the two fused Pallas kernels of markovmodels_tpu/ops/pallas_banded.py:
//   K5a mm_banded_fwd  <- _run forward pallas_call, _make_fwd_kernel
//   K5b mm_banded_bwd  <- _run backward pallas_call, _make_bwd_kernel
//
// G independent graphs (numerator lattices of Sp padded states each) share
// nO <= 8 band offsets; graph g runs the sequence in column g.  Per frame and
// graph the work is tiny: nO shifted multiply-adds over Sp states, two
// reductions over the states (the omega dot into the phony final state and
// the column max behind the rescale), one emission gather and one store.  At
// the main shape (G = 128, Sp = 80, nO = 2, Nf = 701) a sweep moves ~57 MB
// of float64 alphas and touches ~29 MB of emissions: ~0.03 ms of bandwidth.
// The frames are a serial chain, so a sweep is bound by the latency of one
// frame, not by bytes or FLOPs.
//
// Design: graphs are independent, so there is no grid-wide dependency and
// ONE launch runs a whole sweep, one CTA per graph (the 128 chains on 128
// SMs).  One warp, the chain, runs the graph through all frames on shared
// memory and registers alone: lane l owns states l, l + 32, ... (J per
// lane, a template argument), whose values stay in registers through a
// frame; the first two offsets' band weights and omega sit in registers,
// so every shared-memory read of a frame (the state's band sources and
// the emissions) issues at once; the rescale's exponent is one warp max of
// 32-bit keys; a __syncwarp is the frame's only barrier.  A frame's inputs
// do not depend on the chain, so a helper warp (emission_helper) gathers
// each frame's emissions by cp.async into a ring in shared memory DEPTH
// frames ahead and publishes each slot to the chain under an mbarrier
// LEAD frames ahead; every global request of the sweep (each a warp-wide
// access to 32 lines, the layout's stride) is issued by another warp.
//   K5a: the chain writes each frame's rescaled alpha into the slot, and
//   the helper stores it after the chain releases the slot.
//   K5b: the chain hands each frame's beta (before the emission) through a
//   ring of YRING frames to POST_WARPS posterior warps, which take the
//   frames in turn and form gamma = alpha * beta with alphas each fetched
//   ahead itself, its state sum, and the pdf posteriors: a host plan lists
//   each graph's distinct pdfs and, for each, its states in a fixed order,
//   so each pdf's sum runs in that order (no atomics: bit-equal run to run)
//   and is scaled by one reciprocal of the frame's gamma sum.  Only those
//   <= Sp entries per graph and frame are written; a memset zeroes the
//   rest of (Nf, P1, G) once per call.
// Every global array keeps G as its fastest axis (the JAX layout), but
// the alphas of the wide instantiations (below).
// Each kernel has three instantiations with the same operations per state.
// The narrow one above keeps a lane's states in registers and takes
// Sp <= 32 * MAX_J where its rings fit a CTA's shared memory.  A longer
// lattice (a numerator of a long utterance with skip arcs: ~1,200 states
// at 700 frames, and no bound but the card's memory) runs its chain on the
// WT = 256 threads of WW = 8 warps of one CTA (banded_fwd_wide_kernel,
// banded_bwd_wide_kernel): thread i owns states i, i + WT, ..., J of them
// in registers, with the weights of its first WREG offsets and omega.  A
// frame of the forward: the band terms of the thread's states (sources of
// any offset read from the previous frame's state in shared memory, the
// offsets' loop unrolled and predicated), the emission, the warp max of
// the exponent keys and the warp sum of the omega dot; one named barrier
// of the chain threads (the helper and posterior warps never join it);
// then every thread reads the WW keys and partial dots, adds the dots in
// warp order (fixed: bit-equal run to run), forms the phony final row and
// the frame's exponent.  The state buffer holds each frame's y UNSCALED
// (and the final row's band value, which its readers replace by the dot,
// held by every thread), so the one barrier orders both the reductions
// and the state's exchange: a reader scales each source by the previous
// frame's 2^-k, the same multiply the owner makes.  The alphas go out
// from the chain's registers graph-major, (Nf, G, Sp): a warp stores 32
// adjacent states, whole sectors.  The helper gathers a frame's emission
// once per distinct pdf of the lattice (the plan's entries: ~370 of
// 1,200 states at 384 pdfs), the scattered reads that bound it.  K5b's
// chain forms gamma = alpha * beta itself (alphas fetched with the
// emissions by the helper, whole 16-byte copies) into a ring of WRING
// frames, with the warps' partial gamma sums, and WPOST posterior warps
// take the frames in turn: the pdf sums in the plan's order, a pdf with
// more than LONG states (a repeated one) summed by the whole warp.  Past
// WT * MAX_WJ states (1,280; more states per thread spill) or where the
// wide layout passes a CTA's shared memory, the global instantiation
// (banded_fwd_global_kernel, banded_bwd_global_kernel) runs the same
// frames with the same operations in the same order on the WT chain
// threads alone: the state (and K5b's gamma) in a scratch buffer in global
// memory beside the graph's weights, omega and pdfs staged there once,
// each state's emission gathered from the inputs every frame, and K5b's
// pdf sums on the chain threads after the barrier.  Its
// outputs equal the wide one's bit for bit.  A launch takes the narrow
// instantiation where it fits, else the wide one where it fits, else the
// global one (fwd_mode, bwd_mode).
//
// Semantics (the Pallas kernels', kept by the plain twins in
// ops/banded_scan.py):
//   forward  y[s] = sum_o bf[o, s] * a[s - off_o] (zero outside [0, Sp)),
//            y[fin] = omega . a (replaced; omega[fin] = 1 is the phony
//            self-loop), frame 0 takes a0 with no matvec; y *= e; rescale
//            by 2^-k with k = floor(log2 max y) from the exponent bits;
//            ksum += k and shift += the emission shift of the frame.
//   backward y[s] = sum_o bb[o, s] * b[s + off_o] + omega[s] * b[fin],
//            the last frame starts from ones; gamma = alpha_t * y;
//            posts_t[p] = sum_{spdf[s] = p} gamma[s] / sum_s gamma[s]
//            (0 where the sum is 0); b = y * e rescaled like the forward.
// One repair against the Pallas kernel: the state (alpha, beta), gamma and
// its sums, and the logZ pieces (v_final, the exponent sum, the emission
// shift) are float64; the inputs and the posteriors keep the graph's type
// (float32, or float64 for a float64 graph).  alpha and beta are each
// normalised to max 1 per frame, and on a long lattice their masses sit
// at opposite ends (alpha runs ahead of the sequence, beta behind it).  At the main shape both factors at the posterior's
// peak fall to 1e-27 .. 1e-40 in mid-sequence and their product to
// ~1e-54: in float32 the product underflows (every posterior of those
// frames lost) and the factors lose their mantissa in the subnormal
// range.  The sweep is latency-bound, so float64 costs little.
// Every kernel takes the type of its inputs and posteriors (a0, the bands,
// omega, the emissions, their shift, posts) as a template argument T:
// float for a float32 graph, double for a float64 one.  The state and its
// arithmetic are float64 in both, so T = double changes only the loads,
// the emission ring's words (8 bytes each, by 8-byte cp.async) and the
// posteriors' store.
#include <cuda_runtime.h>

#include <type_traits>

#include "coop_common.cuh"

namespace {

constexpr int MAX_BANDS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 8;       // frames fetched ahead of the chain
constexpr int LEAD = 4;        // frames the helper publishes ahead
constexpr int POST_WARPS = 2;  // K5b's posterior warps (frames in turn)
constexpr int YRING = 8;       // frames of beta between K5b's warps
constexpr int MAX_J = 32;      // states per lane: Sp <= 32 * MAX_J
constexpr int WDEPTH = 4;      // the wide instantiation's DEPTH
constexpr int WLEAD = 2;       // and LEAD
constexpr int WT = 256;        // the wide and global chains' threads
constexpr int WW = WT / 32;    // and warps
constexpr int MAX_WJ = 5;      // states per wide chain thread: Sp <= WT * 5
constexpr int WREG = 3;        // offsets whose weights a wide thread holds
constexpr int WPOST = 6;       // the wide K5b's posterior warps
constexpr int WRING = 8;       // frames of gamma between its warps
constexpr int LONG = 32;       // a plan entry of more states is summed by
                               // a whole warp (pdf_sums)
constexpr int GU = 4;          // a global chain thread's states whose loads
                               // issue together
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a CTA (227 KB)
static_assert(0 < LEAD && LEAD < DEPTH && DEPTH <= 64, "K5a's ring");
static_assert(0 < WLEAD && WLEAD < WDEPTH, "the wide ring");
static_assert(YRING % POST_WARPS == 0, "a beta slot has one consumer");
static_assert(WRING > WPOST, "a posterior warp holds one slot at a time");

struct Meta {
  int Sp, G, P1, Nf, nO;
  int off[MAX_BANDS];
};

// Host int64 descriptor layout (banded_scan._imeta):
// [Sp, G, P1, Nf, nO, off[8], gm]; gm = 1 where the alphas are graph-major
// (Nf, G, Sp), the wide and global instantiations' layout, else (Nf, Sp, G)
bool parse_meta(const long long* im, Meta* m, int* gm) {
  for (int i = 0; i < 4; ++i)
    if (im[i] <= 0 || im[i] >= (1LL << 31)) return false;
  if (im[4] < 0 || im[4] > MAX_BANDS) return false;
  if (im[13] != 0 && im[13] != 1) return false;
  m->Sp = static_cast<int>(im[0]);
  m->G = static_cast<int>(im[1]);
  m->P1 = static_cast<int>(im[2]);
  m->Nf = static_cast<int>(im[3]);
  m->nO = static_cast<int>(im[4]);
  *gm = static_cast<int>(im[13]);
  if (m->Sp > (1 << 26)) return false;  // int indices of the plan's rows
  for (int o = 0; o < MAX_BANDS; ++o) {
    if (im[5 + o] <= -im[0] || im[5 + o] >= im[0]) return false;
    m->off[o] = static_cast<int>(im[5 + o]);
  }
  return true;
}

// The instantiation a launch takes (banded_scan._modes).
enum Mode { NARROW = 0, WIDE = 1, GLOBAL = 2 };

// Shared-memory words (4 bytes) of one CTA, one graph
// (banded_scan._mode_words), of an instantiation whose inputs take tw
// words each (1 float, 2 double).
// K5a narrow: the float64 state double buffer X[2][Sp], bands BW[nO][Sp]
// (one zero band when nO = 0), omega OM[Sp] and the alpha ring AL[D][Sp],
// the mbarriers FULL[D] and DONE[D] (8 bytes each), then the emission ring
// ER[D][Sp] and shift ring MR[D] (T).
// K5b narrow: X[2][Sp], BW[nO][Sp], OM[Sp], the beta ring YR[R][Sp], and
// per posterior warp gamma GM[Sp] and the alpha ring AR[D][Sp] (float64),
// the mbarriers FULL[R] and EMPTY[R] of the beta ring and FULL[D] and
// DONE[D] of the emission ring, then ER[D][Sp] (T) and the plan's state
// order ST[Sp] (int).
// K5a wide: the unscaled state Y[2][Sp], the weights of the offsets past
// the WREG-th BX[nO - WREG][Sp] and the warps' partial dots SD[2][WW]
// (float64), FULL[D] and DONE[D], the emission ring ER[D][Sp] (a slot
// holds a frame's emission of each of the graph's distinct pdfs, at most
// Sp) and MR[D] (T), then the distinct pdfs EP[Sp], each state's entry
// among them EI[Sp] and the warps' keys SK[2][WW] (int).
// K5b wide: Y[2][Sp], BX, the alpha ring AR[D][Sp], the gamma ring
// GM[R][Sp] and its partial sums TT[R][WW] (float64), the mbarriers
// FULL[D] and DONE[D] of the emission ring and FULL[R] and EMPTY[R] of the
// gamma ring, ER[D][Sp] (T), EP[Sp], EI[Sp], the plan's ranges SEG[Sp + 1],
// each state's position in the plan's order POS[Sp] and SK[2][WW] (int).
// The global instantiation's few words are static.
__host__ __device__ int fwd_smem_words(int Sp, int nO, int mode, int tw) {
  if (mode == GLOBAL) return 0;
  if (mode == WIDE) {
    const int nx = nO > WREG ? nO - WREG : 0, D = WDEPTH;
    return 2 * ((2 + nx) * Sp + 2 * WW) + 4 * D + tw * (D * Sp + D) +
           2 * Sp + 2 * WW;
  }
  const int D = DEPTH;
  return 2 * (2 + (nO > 0 ? nO : 1) + 1 + D) * Sp + 4 * D +
         tw * (D * Sp + D);
}
__host__ __device__ int bwd_smem_words(int Sp, int nO, int mode, int tw) {
  if (mode == GLOBAL) return 0;
  if (mode == WIDE) {
    const int nx = nO > WREG ? nO - WREG : 0, D = WDEPTH, R = WRING;
    return 2 * ((2 + nx + D + R) * Sp + R * WW) + 4 * (D + R) +
           tw * D * Sp + 4 * Sp + 1 + 2 * WW;
  }
  const int D = DEPTH, R = YRING, W = POST_WARPS;
  return 2 * (2 + (nO > 0 ? nO : 1) + 1 + R + W * (1 + D)) * Sp +
         4 * (R + D) + tw * D * Sp + Sp;
}

// The narrow instantiation where its states fit in registers (MAX_J per
// lane) and its shared memory in a CTA; else the wide one where its states
// fit (MAX_WJ per thread) and its shared memory; else the global one.
int fwd_mode(int Sp, int nO, int tw) {
  if (Sp <= 32 * MAX_J && 4 * fwd_smem_words(Sp, nO, NARROW, tw) <= SMEM_MAX)
    return NARROW;
  if (Sp <= WT * MAX_WJ && 4 * fwd_smem_words(Sp, nO, WIDE, tw) <= SMEM_MAX)
    return WIDE;
  return GLOBAL;
}
int bwd_mode(int Sp, int nO, int tw) {
  if (Sp <= 32 * MAX_J && 4 * bwd_smem_words(Sp, nO, NARROW, tw) <= SMEM_MAX)
    return NARROW;
  if (Sp <= WT * MAX_WJ && 4 * bwd_smem_words(Sp, nO, WIDE, tw) <= SMEM_MAX)
    return WIDE;
  return GLOBAL;
}

// The rescale's exponent comes from a warp max of 32-bit keys (one
// __reduce_max_sync): the key of a non-negative double is 0 for 0, else its
// biased exponent, at least 1 (a subnormal counts as the smallest normal:
// both take the clamped exponent -1022).  The key is monotone in the value,
// so the max key is the max's key, and key_exponent gives floor(log2 max)
// clamped at -1022, 0 for a zero max (block_scan._pow2_exponent for
// float64).
__device__ __forceinline__ unsigned exp_key(double v) {
  const unsigned e =
      static_cast<unsigned>(__double_as_longlong(v) >> 52) & 0x7ffu;
  return v > 0.0 ? max(e, 1u) : 0u;
}

__device__ __forceinline__ int key_exponent(unsigned key) {
  return key ? static_cast<int>(key) - 1023 : 0;
}

// 2^-k for an integer k in [-1022, 1022], from its exponent bits (exact;
// block_scan._pow2_scale for float64).
__device__ __forceinline__ double pow2_scale(int k) {
  return __longlong_as_double(static_cast<long long>(1023 - k) << 52);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// One input element into shared memory by cp.async, 4 or 8 bytes.
template <typename T>
__device__ __forceinline__ void cp_async_el(T* smem, const T* gmem) {
  if constexpr (sizeof(T) == 8)
    cp_async8(smem, gmem);
  else
    cp_async4(smem, gmem);
}

// Bands and omega of graph g into shared memory, as float64.
template <typename T>
__device__ __forceinline__ void load_bands(const Meta& m, double* BW,
                                           double* OM,
                                           const T* __restrict__ bands,
                                           const T* __restrict__ omega,
                                           int g, int t0, int nt) {
  for (int s = t0; s < m.Sp; s += nt) {
    const size_t sg = static_cast<size_t>(s) * m.G + g;
    for (int o = 0; o < m.nO; ++o)
      BW[o * m.Sp + s] = bands[static_cast<size_t>(o) * m.Sp * m.G + sg];
    OM[s] = omega[sg];
  }
}

// The band terms of a lane's states with their first two offsets (the
// self-loop and the chain of a numerator lattice): the weights held in
// registers, masked to 0 where the source state lies outside the lattice,
// and the source indices clamped into it, so that a frame issues every
// source read at once and adds the masked terms (an exact +0) in the
// offsets' order.  dir = -1 (forward: source s - off) or +1 (backward).
template <int J>
struct Lead {
  double w[2][J];
  int src[2][J];
};

template <int J>
__device__ __forceinline__ void lead_bands(const Meta& m, const double* BW,
                                           int lane, int dir, Lead<J>& L) {
#pragma unroll
  for (int o = 0; o < 2; ++o) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = lane + 32 * j, src = s + dir * m.off[o];
      const bool ok = o < m.nO && s < m.Sp && src >= 0 && src < m.Sp;
      L.w[o][j] = ok ? BW[o * m.Sp + s] : 0.0;
      L.src[o][j] = ok ? src : 0;
    }
  }
}

// v[j] = sum_o BW[o, s] * a[s + dir * off_o] for the lane's states, in the
// offsets' order; offsets past the second (skip arcs) from shared memory.
template <int J>
__device__ __forceinline__ void band_pass(const Meta& m, const Lead<J>& L,
                                          const double* BW, const double* a,
                                          int lane, int dir, double (&v)[J]) {
  double x0[J], x1[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    x0[j] = a[L.src[0][j]];
    x1[j] = a[L.src[1][j]];
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    v[j] = fma(L.w[1][j], x1[j], fma(L.w[0][j], x0[j], 0.0));
  for (int o = 2; o < m.nO; ++o) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = lane + 32 * j, src = s + dir * m.off[o];
      if (s < m.Sp && src >= 0 && src < m.Sp)
        v[j] = fma(BW[o * m.Sp + s], a[src], v[j]);
    }
  }
}

// The helper warp of a sweep: every global read of the chain.  Step i of
// the sweep reads frame frame_of(i): the lane's states' gathered emissions
// (and lane 0 the frame's shift, where MR is given) go into ring slot
// i % D by cp.async; the slot is published to the chain (FULL) LD steps
// ahead of it and refilled with step i + D once the chain has released it
// (DONE).  between(i, slot) runs in that gap (K5a: the alpha stores of
// step i).  Phase u of a slot's barriers belongs to step slot + u * D, and
// no barrier runs two phases ahead of its waiter: step i + D is published
// only after the helper saw step i + D - LD - 1 >= i released, and
// released only after it was published.  The beta ring of K5b follows the
// same rule (a slot is written again only after EMPTY says it was read).
// J > 0 (narrow): the lane's J pdfs from spdf, held in registers; J = 0
// (wide): every state's pdf from PD in shared memory.
template <int J, int D, int LD, typename T, typename FrameOf,
          typename Between>
__device__ __forceinline__ void emission_helper(
    const Meta& m, int g, int lane, const int* __restrict__ spdf,
    const int* PD, const T* __restrict__ ext,
    const T* __restrict__ mshift, T* ER, T* MR,
    unsigned long long* full, unsigned long long* done, FrameOf frame_of,
    Between between) {
  const int Sp = m.Sp, G = m.G, Nf = m.Nf;
  int pdf[J > 0 ? J : 1];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    pdf[j] = s < Sp ? spdf[static_cast<size_t>(s) * G + g] : 0;
  }
  auto fetch = [&](int i) {
    if (i < Nf) {
      const int t = frame_of(i);
      T* dst = ER + (i % D) * Sp;
      const T* src = ext + static_cast<size_t>(t) * m.P1 * G + g;
      if constexpr (J > 0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int s = lane + 32 * j;
          if (s < Sp)
            cp_async_el(dst + s, src + static_cast<size_t>(pdf[j]) * G);
        }
      } else {
        for (int s = lane; s < Sp; s += 32)
          cp_async_el(dst + s, src + static_cast<size_t>(PD[s]) * G);
      }
      if (MR != nullptr && lane == 0)
        cp_async_el(MR + i % D, mshift + static_cast<size_t>(t) * G + g);
    }
    cp_async_commit();
  };
  for (int i = 0; i < D; ++i) fetch(i);
  cp_async_wait<D - LD>();  // steps 0 .. LD - 1
  for (int i = 0; i < LD && i < Nf; ++i) mbar_arrive(full + i);
  for (int i = 0; i < Nf; ++i) {
    const int r = i % D;
    cp_async_wait<D - LD - 1>();  // step i + LD is in
    if (i + LD < Nf) mbar_arrive(full + (i + LD) % D);
    mbar_wait(done + r, (i / D) & 1);
    between(i, r);
    fetch(i + D);  // into the slot step i has just used
  }
  cp_async_wait<0>();
}

// K5a: graph g = blockIdx.x.  Warp 0 runs the chain through all Nf
// frames on shared memory; warp 1, the helper, gathers frame t's
// emissions and shift into ring slot t % DEPTH, and stores the alphas the
// chain wrote into the slot once it is released.
template <typename T, int J>
__global__ void __launch_bounds__(64) banded_fwd_kernel(
    Meta m, const T* __restrict__ a0, const T* __restrict__ bf,
    const T* __restrict__ omega, const int* __restrict__ fin_g,
    const int* __restrict__ spdf, const T* __restrict__ ext,
    const T* __restrict__ mshift, double* __restrict__ alphas,
    double* __restrict__ vfin, double* __restrict__ shift_out,
    double* __restrict__ ksum_out) {
  extern __shared__ __align__(16) float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x;
  const int Sp = m.Sp, G = m.G, Nf = m.Nf;
  double* X = reinterpret_cast<double*>(smem);
  double* BW = X + 2 * Sp;
  double* OM = BW + (m.nO > 0 ? m.nO : 1) * Sp;
  double* AL = OM + Sp;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(AL + DEPTH * Sp);
  unsigned long long* done = full + DEPTH;
  T* ER = reinterpret_cast<T*>(done + DEPTH);
  T* MR = ER + DEPTH * Sp;
  load_bands(m, BW, OM, bf, omega, g, threadIdx.x, 64);
  for (int s = threadIdx.x; s < Sp; s += 64)
    X[s] = a0[static_cast<size_t>(s) * G + g];
  if (threadIdx.x < DEPTH) {
    mbar_init(full + threadIdx.x, 32);
    mbar_init(done + threadIdx.x, 32);
  }
  __syncthreads();

  if (w == 1) {  // the helper: emissions in, alphas out
    emission_helper<J, DEPTH, LEAD, T>(
        m, g, lane, spdf, nullptr, ext, mshift, ER, MR, full, done,
        [](int i) { return i; },
        [&](int t, int r) {
          if (alphas == nullptr) return;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int s = lane + 32 * j;
            if (s < Sp)
              alphas[(static_cast<size_t>(t) * Sp + s) * G + g] =
                  AL[r * Sp + s];
          }
        });
    return;
  }

  // the chain
  const int fin = fin_g[g];
  Lead<J> L;
  lead_bands(m, BW, lane, -1, L);
  double om[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    om[j] = lane + 32 * j < Sp ? OM[lane + 32 * j] : 0.0;
  double ksum = 0.0, shift = 0.0;
  int cur = 0;
  for (int t = 0; t < Nf; ++t) {
    const int r = t % DEPTH;
    mbar_wait(full + r, (t / DEPTH) & 1);  // frame t's emissions are in
    const double* a = X + cur * Sp;
    double* yn = X + (cur ^ 1) * Sp;
    const T* er = ER + r * Sp;
    double y[J], as[J];
    T ev[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {  // read with the band sources
      const int s = lane + 32 * j < Sp ? lane + 32 * j : 0;
      as[j] = a[s];
      ev[j] = er[s];
    }
    unsigned key = 0;
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        y[j] = lane + 32 * j < Sp ? as[j] * double(ev[j]) : 0.0;
        key = max(key, exp_key(y[j]));
      }
      key = __reduce_max_sync(FULL, key);
    } else {
      // the omega dot needs only the previous state: its reduction runs
      // beside the band terms, which the max key over every state but the
      // phony final one follows
      const T ef = er[fin];
      double dot = 0.0;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < Sp) dot = fma(om[j], as[j], dot);
      dot = warp_sum(dot);
      double v[J];
      band_pass(m, L, BW, a, lane, -1, v);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = lane + 32 * j;
        y[j] = 0.0;
        if (s < Sp) {
          y[j] = v[j] * double(ev[j]);
          if (s != fin) key = max(key, exp_key(y[j]));
        }
      }
      key = __reduce_max_sync(FULL, key);
      // the phony final row
      const double vf = dot * double(ef);
      key = max(key, exp_key(vf));
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j == fin) y[j] = vf;
    }
    const int k = key_exponent(key);
    const double sc = pow2_scale(k);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = lane + 32 * j;
      if (s < Sp) {
        const double v = y[j] * sc;
        yn[s] = v;
        AL[r * Sp + s] = v;
      }
    }
    ksum += k;  // every lane keeps the same exponent sum
    if (lane == 0) shift += MR[r];
    __syncwarp();
    mbar_arrive(done + r);  // the helper may store and refill slot r
    cur ^= 1;
  }
  if (lane == 0) {
    vfin[g] = X[cur * Sp + fin];
    shift_out[g] = shift;
    ksum_out[g] = ksum;
  }
}

// K5b: warp 0 runs graph g = blockIdx.x backwards through all Nf frames
// (the beta chain, on shared memory only); warp 1 is the emission helper;
// posterior warp p = 0 .. POST_WARPS - 1 (warp 2 + p) takes iterations
// i = p, p + POST_WARPS, ...: it turns the frame's beta into gamma with
// alphas it fetched ahead itself, and writes the frame's posteriors of
// the graph's own pdfs.  Iteration i runs frame t = Nf - 1 - i.
template <typename T, int J>
__global__ void __launch_bounds__(32 * (2 + POST_WARPS)) banded_bwd_kernel(
    Meta m, const T* __restrict__ bb, const T* __restrict__ omega,
    const int* __restrict__ fin_g, const int* __restrict__ spdf,
    const int* __restrict__ plan, const T* __restrict__ ext,
    const double* __restrict__ alphas, T* __restrict__ posts) {
  extern __shared__ __align__(16) float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x;
  const int Sp = m.Sp, G = m.G, Nf = m.Nf, P1 = m.P1;
  double* X = reinterpret_cast<double*>(smem);
  double* BW = X + 2 * Sp;
  double* OM = BW + (m.nO > 0 ? m.nO : 1) * Sp;
  double* YR = OM + Sp;
  double* GM = YR + YRING * Sp;    // [POST_WARPS][Sp]
  double* AR = GM + POST_WARPS * Sp;  // [POST_WARPS][DEPTH][Sp]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(AR + POST_WARPS * DEPTH * Sp);
  unsigned long long* empty = full + YRING;
  unsigned long long* efull = empty + YRING;
  unsigned long long* edone = efull + DEPTH;
  T* ER = reinterpret_cast<T*>(edone + DEPTH);
  int* ST = reinterpret_cast<int*>(ER + DEPTH * Sp);
  // the plan row of graph g: [n, pdf[Sp], seg[Sp + 1], state[Sp]]
  const int* prow = plan + static_cast<size_t>(g) * (3 * Sp + 2);
  load_bands(m, BW, OM, bb, omega, g, threadIdx.x, blockDim.x);
  for (int s = threadIdx.x; s < Sp; s += blockDim.x)
    ST[s] = prow[2 * Sp + 2 + s];
  if (threadIdx.x < YRING) {
    mbar_init(full + threadIdx.x, 32);
    mbar_init(empty + threadIdx.x, 32);
  }
  if (threadIdx.x < DEPTH) {
    mbar_init(efull + threadIdx.x, 32);
    mbar_init(edone + threadIdx.x, 32);
  }
  __syncthreads();

  if (w == 1) {  // the emission helper
    emission_helper<J, DEPTH, LEAD, T>(
        m, g, lane, spdf, nullptr, ext, nullptr, ER, nullptr, efull, edone,
        [Nf](int i) { return Nf - 1 - i; }, [](int, int) {});
    return;
  }
  if (w == 0) {  // the beta chain
    const int fin = fin_g[g];
    Lead<J> L;
    lead_bands(m, BW, lane, +1, L);
    double om[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      om[j] = lane + 32 * j < Sp ? OM[lane + 32 * j] : 0.0;
    int cur = 0;
    for (int i = 0; i < Nf; ++i) {
      mbar_wait(efull + i % DEPTH, (i / DEPTH) & 1);  // the emissions
      const double* b = X + cur * Sp;
      double* bn = X + (cur ^ 1) * Sp;
      const T* er = ER + (i % DEPTH) * Sp;
      T ev[J];
#pragma unroll
      for (int j = 0; j < J; ++j)  // read with the band sources
        ev[j] = er[lane + 32 * j < Sp ? lane + 32 * j : 0];
      double y[J];
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < J; ++j) y[j] = 1.0;
      } else {
        const double bfin = b[fin];
        band_pass(m, L, BW, b, lane, +1, y);
#pragma unroll
        for (int j = 0; j < J; ++j)
          y[j] = lane + 32 * j < Sp ? fma(om[j], bfin, y[j]) : 0.0;
      }
      // hand beta of frame t to the posterior warp
      const int r = i % YRING;
      if (i >= YRING) mbar_wait(empty + r, ((i / YRING) - 1) & 1);
      unsigned key = 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = lane + 32 * j;
        if (s < Sp) {
          YR[r * Sp + s] = y[j];
          y[j] *= double(ev[j]);
          key = max(key, exp_key(y[j]));
        }
      }
      mbar_arrive(full + r);
      mbar_arrive(edone + i % DEPTH);  // the emission slot is free
      const double sc =
          pow2_scale(key_exponent(__reduce_max_sync(FULL, key)));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = lane + 32 * j;
        if (s < Sp) bn[s] = y[j] * sc;
      }
      __syncwarp();
      cur ^= 1;
    }
  } else {  // gamma and the posteriors of iterations i = p0, p0 + PW, ...
    const int p0 = w - 2;
    double* gm = GM + p0 * Sp;
    double* ar = AR + p0 * DEPTH * Sp;
    // the lane's plan entries e = lane + 32 q: the pdf, its states
    // ST[e0 .. e1), the first of them in f0
    const int n = prow[0];
    int epdf[J], e0[J], e1[J], f0[J];
#pragma unroll
    for (int q = 0; q < J; ++q) {
      const int e = lane + 32 * q;
      epdf[q] = e < n ? prow[1 + e] : 0;
      e0[q] = e < n ? prow[Sp + 1 + e] : 0;
      e1[q] = e < n ? prow[Sp + 2 + e] : 0;
      f0[q] = e < n ? ST[e0[q]] : 0;
    }
    // this warp's k-th iteration's alphas into ring slot k % DEPTH
    auto fetch = [&](int k) {
      const int i = p0 + k * POST_WARPS;
      if (i < Nf) {
        double* dst = ar + (k % DEPTH) * Sp;
        const double* src =
            alphas + static_cast<size_t>(Nf - 1 - i) * Sp * G + g;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int s = lane + 32 * j;
          if (s < Sp) cp_async8(dst + s, src + static_cast<size_t>(s) * G);
        }
      }
      cp_async_commit();
    };
    for (int k = 0; k < DEPTH; ++k) fetch(k);
    for (int k = 0, i = p0; i < Nf; ++k, i += POST_WARPS) {
      const int t = Nf - 1 - i;
      const int r = i % YRING;
      cp_async_wait<DEPTH - 1>();
      mbar_wait(full + r, (i / YRING) & 1);
      const double* al = ar + (k % DEPTH) * Sp;
      double gam[J];
      double tot = 0.0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = lane + 32 * j;
        gam[j] = 0.0;
        if (s < Sp) {
          gam[j] = al[s] * YR[r * Sp + s];
          tot += gam[j];
        }
      }
      mbar_arrive(empty + r);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = lane + 32 * j;
        if (s < Sp) gm[s] = gam[j];
      }
      tot = warp_sum(tot);
      __syncwarp();
      const double rt = tot > 0.0 ? 1.0 / tot : 1.0;
      T* pt = posts + static_cast<size_t>(t) * P1 * G + g;
      double acc[J];
#pragma unroll
      for (int q = 0; q < J; ++q) acc[q] = gm[f0[q]];  // 0 + the first
#pragma unroll
      for (int q = 0; q < J; ++q) {
        if (lane + 32 * q < n) {
          for (int c = e0[q] + 1; c < e1[q]; ++c) acc[q] += gm[ST[c]];
          pt[static_cast<size_t>(epdf[q]) * G] =
              static_cast<T>(acc[q] * rt);
        }
      }
      __syncwarp();  // gm is rewritten next time
      fetch(k + DEPTH);
    }
    cp_async_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// The wide and global instantiations (one graph per CTA, the chain on WT
// threads; see the top of the file)
// ---------------------------------------------------------------------------

// Named barrier 1 of the WT chain threads (warps 0 .. WW - 1) of a wide
// kernel: its helper and posterior warps never join it.
__device__ __forceinline__ void chain_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WT) : "memory");
}

// After the chain's barrier: the frame's exponent key, the max of the WW
// warps' keys ...
__device__ __forceinline__ unsigned warps_key(const unsigned* sk) {
  unsigned k = sk[0];
#pragma unroll
  for (int w = 1; w < WW; ++w) k = max(k, sk[w]);
  return k;
}

// ... and a sum of the warps' partial sums, in warp order.
__device__ __forceinline__ double warps_sum(const double* sd) {
  double v = sd[0];
#pragma unroll
  for (int w = 1; w < WW; ++w) v += sd[w];
  return v;
}

// A forward source's value in the previous frame: its unscaled y, or for
// the phony final row the dot every thread holds, times that frame's 2^-k
// (the multiply its owner makes for the alpha).
__device__ __forceinline__ double src_val(const double* y, int src, int fin,
                                          double vf, double sc) {
  return (src == fin ? vf : y[src]) * sc;
}

// Element (t, s, g) of the alphas: graph-major (Nf, G, Sp) where gm, else
// (Nf, Sp, G).
__device__ __forceinline__ size_t alpha_at(const Meta& m, int gm, int t,
                                           int s, int g) {
  return gm ? (static_cast<size_t>(t) * m.G + g) * m.Sp + s
            : (static_cast<size_t>(t) * m.Sp + s) * m.G + g;
}

// The posteriors of one frame of a graph, by one warp or by each warp of
// the chain: its n entries e = base + lane, base = first, first + stride,
// ... (the plan's pdfs, entry e's pdf epdf[e] and its states' positions
// seg[e] .. seg[e + 1] in the plan's order; gamma gm in that order, or,
// where st is given, gm[st[c]] the c-th).  An entry of up to LONG states
// is summed by its lane in the plan's order (0 + the first); a longer one
// (a pdf repeated along the lattice) by the whole warp, lane l over its
// states l, l + 32, ..., then the xor butterfly, in the order of the
// entries.  Each sum is scaled by one reciprocal of the frame's gamma sum
// tot, divided by tot where tot is subnormal (its reciprocal would
// overflow), left as it is where tot is 0 (an infeasible lattice: every
// sum 0), and written at its pdf of pt (the frame's row of the graph,
// stride G).  Bit-equal run to run.
template <typename T>
__device__ __forceinline__ void pdf_sums(int n, const int* seg,
                                         const int* epdf, const int* st,
                                         const double* gm, double tot, T* pt,
                                         int G, int first, int stride,
                                         int lane) {
  const double rt = tot > 0.0 ? 1.0 / tot : 1.0;
  const bool div = tot > 0.0 && tot < 0x1p-1022;
  auto post = [&](double acc) {
    return static_cast<T>(div ? acc / tot : acc * rt);
  };
  for (int base = first; base < n; base += stride) {
    const int e = base + lane;
    const int c0 = e < n ? seg[e] : 0, c1 = e < n ? seg[e + 1] : 0;
    const bool lng = c1 - c0 > LONG;
    if (e < n && !lng) {
      double acc = gm[st ? st[c0] : c0];
      for (int c = c0 + 1; c < c1; ++c) acc += gm[st ? st[c] : c];
      pt[static_cast<size_t>(epdf[e]) * G] = post(acc);
    }
    for (unsigned many = __ballot_sync(FULL, lng); many; many &= many - 1) {
      const int l = __ffs(many) - 1;
      const int d0 = __shfl_sync(FULL, c0, l), d1 = __shfl_sync(FULL, c1, l);
      double acc = 0.0;
      for (int c = d0 + lane; c < d1; c += 32) acc += gm[st ? st[c] : c];
      acc = warp_sum(acc);
      if (lane == 0) pt[static_cast<size_t>(epdf[base + l]) * G] = post(acc);
    }
  }
}

// The wide kernels' plan in shared memory: the helper gathers a frame's
// emission once per distinct pdf of the graph (the plan's n entries: EP[e]
// is entry e's pdf) and state s reads entry EI[s]; where SEG is given
// (K5b), the entries' ranges of the plan's order SEG[0 .. n] and each
// state's position in it POS[s].  Returns n.
__device__ __forceinline__ int plan_entries(const int* __restrict__ prow,
                                            int Sp, int* EP, int* EI,
                                            int* SEG, int* POS, int t0,
                                            int nt) {
  const int n = prow[0];
  for (int e = t0; e <= n; e += nt) {
    if (SEG != nullptr) SEG[e] = prow[Sp + 1 + e];
    if (e == n) continue;
    EP[e] = prow[1 + e];
    const int c1 = prow[Sp + 2 + e];
    for (int c = prow[Sp + 1 + e]; c < c1; ++c) {
      const int st = prow[2 * Sp + 2 + c];
      EI[st] = e;
      if (POS != nullptr) POS[st] = c;
    }
  }
  return n;
}

// K5a, wide: graph g = blockIdx.x.  Warps 0 .. WW - 1 run the chain,
// thread i the states i + WT j (j < J) in registers; warp WW, the helper,
// gathers frame t's emissions and shift into ring slot t % WDEPTH
// (emission_helper).  A frame: the omega dot of the thread's previous
// states and the band terms of the new ones (sources from the previous
// frame's unscaled y in Y, scaled), the emission, the key, the y into Y;
// the warp max and sum; the chain's barrier; the exponent from the warps'
// keys and the phony final row's value; the alphas out (graph-major).
template <typename T, int J>
__global__ void __launch_bounds__(WT + 32) banded_fwd_wide_kernel(
    Meta m, const T* __restrict__ a0, const T* __restrict__ bf,
    const T* __restrict__ omega, const int* __restrict__ fin_g,
    const int* __restrict__ spdf, const int* __restrict__ plan,
    const T* __restrict__ ext,
    const T* __restrict__ mshift, double* __restrict__ alphas,
    double* __restrict__ vfin, double* __restrict__ shift_out,
    double* __restrict__ ksum_out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const int Sp = m.Sp, G = m.G, Nf = m.Nf, nO = m.nO;
  const int nx = nO > WREG ? nO - WREG : 0;
  double* Y = reinterpret_cast<double*>(smem);  // [2][Sp]
  double* BX = Y + 2 * Sp;                       // [nx][Sp]
  double* SD = BX + nx * Sp;                     // [2][WW]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(SD + 2 * WW);
  unsigned long long* done = full + WDEPTH;
  T* ER = reinterpret_cast<T*>(done + WDEPTH);
  T* MR = ER + WDEPTH * Sp;
  int* EP = reinterpret_cast<int*>(MR + WDEPTH);
  int* EI = EP + Sp;
  unsigned* SK = reinterpret_cast<unsigned*>(EI + Sp);  // [2][WW]
  const int n = plan_entries(plan + static_cast<size_t>(g) * (3 * Sp + 2),
                             Sp, EP, EI, nullptr, nullptr, tid, WT + 32);
  for (int s = tid; s < Sp; s += WT + 32) {
    const size_t sg = static_cast<size_t>(s) * G + g;
    for (int o = WREG; o < nO; ++o)
      BX[(o - WREG) * Sp + s] = bf[static_cast<size_t>(o) * Sp * G + sg];
  }
  if (tid < WDEPTH) {
    mbar_init(full + tid, 32);
    mbar_init(done + tid, 1);
  }
  __syncthreads();

  if (w == WW) {  // the helper: the n entries' emissions and the shifts in
    Meta me = m;
    me.Sp = n;
    emission_helper<0, WDEPTH, WLEAD, T>(
        me, g, lane, spdf, EP, ext, mshift, ER, MR, full, done,
        [](int i) { return i; }, [](int, int) {});
    return;
  }

  // the chain: the weights of the first WREG offsets (0 where the source
  // lies outside the lattice) and omega in registers, y holds frame 0's
  // start
  const int fin = fin_g[g], efin = EI[fin];
  double wr[WREG][J], om[J], y[J];
  int ei[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = tid + WT * j;
    const bool in = s < Sp;
    const size_t sg = static_cast<size_t>(in ? s : 0) * G + g;
    ei[j] = in ? EI[s] : 0;
#pragma unroll
    for (int o = 0; o < WREG; ++o) {
      const int src = s - m.off[o];
      wr[o][j] = in && o < nO && src >= 0 && src < Sp
                     ? double(bf[static_cast<size_t>(o) * Sp * G + sg])
                     : 0.0;
    }
    om[j] = in ? double(omega[sg]) : 0.0;
    y[j] = in ? double(a0[sg]) : 0.0;
  }
  double ksum = 0.0, shift = 0.0, vf = 0.0, sc = 1.0;
  for (int t = 0; t < Nf; ++t) {
    const int r = t % WDEPTH, p = t & 1;
    mbar_wait(full + r, (t / WDEPTH) & 1);  // frame t's emissions are in
    const T* er = ER + r * n;
    const double* a = Y + p * Sp;  // frame t - 1's y, unscaled
    double* yn = Y + (p ^ 1) * Sp;
    const double ef = double(er[efin]);
    T ev[J];
#pragma unroll
    for (int j = 0; j < J; ++j) ev[j] = er[ei[j]];
    unsigned key = 0;
    double dot = 0.0;
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        y[j] *= double(ev[j]);
        key = max(key, exp_key(y[j]));
      }
    } else {
      double v[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = tid + WT * j;
        dot = fma(om[j], (s == fin ? vf : y[j]) * sc, dot);
        v[j] = 0.0;
      }
#pragma unroll
      for (int o = 0; o < WREG; ++o) {
        double x[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          x[j] = src_val(a, min(max(tid + WT * j - m.off[o], 0), Sp - 1),
                         fin, vf, sc);
#pragma unroll
        for (int j = 0; j < J; ++j) v[j] = fma(wr[o][j], x[j], v[j]);
      }
#pragma unroll
      for (int o = WREG; o < MAX_BANDS; ++o) {
        if (o < nO) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int s = tid + WT * j, src = s - m.off[o];
            if (s < Sp && src >= 0 && src < Sp)
              v[j] = fma(BX[(o - WREG) * Sp + s],
                         src_val(a, src, fin, vf, sc), v[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        y[j] = v[j] * double(ev[j]);
        if (tid + WT * j != fin) key = max(key, exp_key(y[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (tid + WT * j < Sp) yn[tid + WT * j] = y[j];
    key = __reduce_max_sync(FULL, key);
    dot = warp_sum(dot);
    if (lane == 0) {
      SK[p * WW + w] = key;
      SD[p * WW + w] = dot;
    }
    chain_sync();
    key = warps_key(SK + p * WW);
    if (t == 0) {
      vf = yn[fin];
    } else {  // the phony final row
      vf = warps_sum(SD + p * WW) * ef;
      key = max(key, exp_key(vf));
    }
    const int k = key_exponent(key);
    sc = pow2_scale(k);
    if (alphas != nullptr) {
      double* at = alphas + (static_cast<size_t>(t) * G + g) * Sp;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = tid + WT * j;
        if (s < Sp) at[s] = (s == fin ? vf : y[j]) * sc;
      }
    }
    ksum += k;  // every thread keeps the same exponent sum
    if (tid == 0) {
      shift += MR[r];
      mbar_arrive(done + r);  // every chain thread has read slot r
    }
  }
  if (tid == 0) {
    vfin[g] = vf * sc;
    shift_out[g] = shift;
    ksum_out[g] = ksum;
  }
}

// The global instantiations' per-graph constants, staged once at the
// start of a sweep into the graph's rows of the scratch after its state
// (and gamma): the weights of every offset W[nO][Sp] and omega OM[Sp] as
// float64, each state's pdf PD[Sp] and, where prow is given (K5b), its
// position in the plan's order POS[Sp] (int, in the next row), so that a
// frame reads them coalesced (the inputs keep G as their fastest axis).
template <typename T>
__device__ __forceinline__ void stage_consts(const Meta& m, int g,
                                            const T* __restrict__ bands,
                                            const T* __restrict__ omega,
                                            const int* __restrict__ spdf,
                                            const int* __restrict__ prow,
                                            double* W, double* OM, int* PD) {
  const int Sp = m.Sp;
  for (int s = threadIdx.x; s < Sp; s += blockDim.x) {
    const size_t sg = static_cast<size_t>(s) * m.G + g;
    for (int o = 0; o < m.nO; ++o)
      W[o * Sp + s] = double(bands[static_cast<size_t>(o) * Sp * m.G + sg]);
    OM[s] = double(omega[sg]);
    PD[s] = spdf[sg];
  }
  if (prow != nullptr)
    for (int c = threadIdx.x; c < Sp; c += blockDim.x)
      PD[Sp + prow[2 * Sp + 2 + c]] = c;
  __syncthreads();
}

// K5a, global: banded_fwd_wide_kernel's frames, operations and order on
// the WT chain threads alone, the state in ybuf (G, 4 + nO, Sp) float64
// in global memory (the state [2][Sp], then stage_consts' rows), each
// state's emission gathered from the inputs in every frame.
template <typename T>
__global__ void __launch_bounds__(WT) banded_fwd_global_kernel(
    Meta m, const T* __restrict__ a0, const T* __restrict__ bf,
    const T* __restrict__ omega, const int* __restrict__ fin_g,
    const int* __restrict__ spdf, const T* __restrict__ ext,
    const T* __restrict__ mshift, double* __restrict__ alphas,
    double* __restrict__ vfin, double* __restrict__ shift_out,
    double* __restrict__ ksum_out, double* ybuf) {
  __shared__ double SD[2 * WW];
  __shared__ unsigned SK[2 * WW];
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const int Sp = m.Sp, G = m.G, Nf = m.Nf, nO = m.nO;
  const int fin = fin_g[g];
  double* Y = ybuf + static_cast<size_t>(g) * (4 + nO) * Sp;
  double* W = Y + 2 * Sp;
  double* OM = W + nO * Sp;
  int* PD = reinterpret_cast<int*>(OM + Sp);
  stage_consts(m, g, bf, omega, spdf, static_cast<const int*>(nullptr), W,
               OM, PD);
  double ksum = 0.0, shift = 0.0, vf = 0.0, sc = 1.0;
  for (int t = 0; t < Nf; ++t) {
    const int p = t & 1;
    const double* a = Y + p * Sp;
    double* yn = Y + (p ^ 1) * Sp;
    const T* e = ext + static_cast<size_t>(t) * m.P1 * G + g;
    const double ef = double(e[static_cast<size_t>(PD[fin]) * G]);
    const T ms = tid == 0 ? mshift[static_cast<size_t>(t) * G + g] : T(0);
    unsigned key = 0;
    double dot = 0.0;
    // the thread's states in chunks of GU: a chunk's loads of its first
    // WREG offsets all issue before its arithmetic and its stores into Y
    // (which may alias them for all the compiler knows; an offset past nO
    // or a source outside the lattice reads a zero weight and value:
    // fma(0, 0, v) is v), the offsets past the WREG-th after them
    for (int s0 = tid; s0 < Sp; s0 += GU * WT) {
      double es[GU], own[GU], om[GU], xw[WREG][GU], xs[WREG][GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int s = s0 + WT * u, sl = min(s, Sp - 1);
        es[u] = double(e[static_cast<size_t>(PD[sl]) * G]);
        own[u] = t == 0 ? double(a0[static_cast<size_t>(sl) * G + g])
                        : src_val(a, sl, fin, vf, sc);
        om[u] = OM[sl];
#pragma unroll
        for (int o = 0; o < WREG; ++o) {
          const int src = s - m.off[o];
          const bool ok = t > 0 && o < nO && s < Sp && src >= 0 && src < Sp;
          xw[o][u] = ok ? W[o * Sp + sl] : 0.0;
          xs[o][u] = ok ? src_val(a, src, fin, vf, sc) : 0.0;
        }
      }
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int s = s0 + WT * u;
        if (s >= Sp) break;
        double y;
        if (t == 0) {
          y = own[u] * es[u];
          key = max(key, exp_key(y));
        } else {
          dot = fma(om[u], own[u], dot);
          double v = 0.0;
#pragma unroll
          for (int o = 0; o < WREG; ++o) v = fma(xw[o][u], xs[o][u], v);
          for (int o = WREG; o < nO; ++o) {
            const int src = s - m.off[o];
            if (src >= 0 && src < Sp)
              v = fma(W[o * Sp + s], src_val(a, src, fin, vf, sc), v);
          }
          y = v * es[u];
          if (s != fin) key = max(key, exp_key(y));
        }
        yn[s] = y;
      }
    }
    key = __reduce_max_sync(FULL, key);
    dot = warp_sum(dot);
    if (lane == 0) {
      SK[p * WW + w] = key;
      SD[p * WW + w] = dot;
    }
    __syncthreads();
    key = warps_key(SK + p * WW);
    if (t == 0) {
      vf = yn[fin];
    } else {
      vf = warps_sum(SD + p * WW) * ef;
      key = max(key, exp_key(vf));
    }
    const int k = key_exponent(key);
    sc = pow2_scale(k);
    if (alphas != nullptr) {
      double* at = alphas + (static_cast<size_t>(t) * G + g) * Sp;
      for (int s0 = tid; s0 < Sp; s0 += GU * WT) {
        double yv[GU];
#pragma unroll
        for (int u = 0; u < GU; ++u) yv[u] = yn[min(s0 + WT * u, Sp - 1)];
#pragma unroll
        for (int u = 0; u < GU; ++u) {
          const int s = s0 + WT * u;
          if (s < Sp) at[s] = (s == fin ? vf : yv[u]) * sc;
        }
      }
    }
    ksum += k;
    if (tid == 0) shift += ms;
  }
  if (tid == 0) {
    vfin[g] = vf * sc;
    shift_out[g] = shift;
    ksum_out[g] = ksum;
  }
}

// K5b, wide: warps 0 .. WW - 1 run graph g's beta chain backwards
// (iteration i is frame t = Nf - 1 - i), thread i the states i + WT j in
// registers; warp WW, the helper, gathers each frame's emissions and
// fetches its alphas into ring slot i % WDEPTH; the chain forms gamma =
// alpha * beta (beta before the emission) into gamma slot i % WRING, in
// the plan's order, with its warps' partial sums, and posterior warp p
// (warp WW + 1 + p) takes
// iterations p, p + WPOST, ...: the frame's pdf sums in the plan's order.
template <typename T, int J>
__global__ void __launch_bounds__(WT + 32 * (1 + WPOST))
    banded_bwd_wide_kernel(Meta m, int gm, const T* __restrict__ bb,
                           const T* __restrict__ omega,
                           const int* __restrict__ fin_g,
                           const int* __restrict__ spdf,
                           const int* __restrict__ plan,
                           const T* __restrict__ ext,
                           const double* __restrict__ alphas,
                           T* __restrict__ posts) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const int Sp = m.Sp, G = m.G, Nf = m.Nf, nO = m.nO;
  const int nx = nO > WREG ? nO - WREG : 0;
  double* Y = reinterpret_cast<double*>(smem);  // [2][Sp]
  double* BX = Y + 2 * Sp;                       // [nx][Sp]
  double* AR = BX + nx * Sp;                     // [WDEPTH][Sp]
  double* GM = AR + WDEPTH * Sp;                 // [WRING][Sp]
  double* TT = GM + WRING * Sp;                  // [WRING][WW]
  unsigned long long* efull =
      reinterpret_cast<unsigned long long*>(TT + WRING * WW);
  unsigned long long* edone = efull + WDEPTH;
  unsigned long long* full = edone + WDEPTH;
  unsigned long long* empty = full + WRING;
  T* ER = reinterpret_cast<T*>(empty + WRING);
  int* EP = reinterpret_cast<int*>(ER + WDEPTH * Sp);
  int* EI = EP + Sp;
  int* SEG = EI + Sp;  // [Sp + 1]
  int* POS = SEG + Sp + 1;
  unsigned* SK = reinterpret_cast<unsigned*>(POS + Sp);  // [2][WW]
  const int n = plan_entries(plan + static_cast<size_t>(g) * (3 * Sp + 2),
                             Sp, EP, EI, SEG, POS, tid, blockDim.x);
  for (int s = tid; s < Sp; s += blockDim.x) {
    const size_t sg = static_cast<size_t>(s) * G + g;
    for (int o = WREG; o < nO; ++o)
      BX[(o - WREG) * Sp + s] = bb[static_cast<size_t>(o) * Sp * G + sg];
  }
  if (tid < WDEPTH) {
    mbar_init(efull + tid, 32);
    mbar_init(edone + tid, 1);
  }
  if (tid < WRING) {
    mbar_init(full + tid, 1);
    mbar_init(empty + tid, 32);
  }
  __syncthreads();

  if (w == WW) {  // the helper: emissions and alphas in
    // whole 16-byte copies where the alphas are graph-major and aligned
    const bool v16 = gm && Sp % 2 == 0 &&
                     (reinterpret_cast<size_t>(AR) & 15) == 0 &&
                     (reinterpret_cast<size_t>(alphas) & 15) == 0;
    auto fetch_alphas = [&](int i, int r) {
      if (i >= Nf) return;
      const int t = Nf - 1 - i;
      double* dst = AR + r * Sp;
      if (v16) {
        const double* src = alphas + alpha_at(m, 1, t, 0, g);
        for (int c = 2 * lane; c < Sp; c += 64)
          cp_async16(dst + c, src + c, true);
      } else {
        for (int s = lane; s < Sp; s += 32)
          cp_async8(dst + s, alphas + alpha_at(m, gm, t, s, g));
      }
    };
    // steps 0 .. WDEPTH - 1 join the first fetch's group; step i + WDEPTH
    // joins its emissions' group
    for (int i = 0; i < WDEPTH; ++i) fetch_alphas(i, i);
    Meta me = m;
    me.Sp = n;
    emission_helper<0, WDEPTH, WLEAD, T>(
        me, g, lane, spdf, EP, ext, nullptr, ER, nullptr, efull, edone,
        [Nf](int i) { return Nf - 1 - i; },
        [&](int i, int r) { fetch_alphas(i + WDEPTH, r); });
    return;
  }
  if (w > WW) {  // a posterior warp
    for (int i = w - WW - 1; i < Nf; i += WPOST) {
      const int q = i % WRING;
      mbar_wait(full + q, (i / WRING) & 1);
      pdf_sums(n, SEG, EP, static_cast<const int*>(nullptr), GM + q * Sp,
               warps_sum(TT + q * WW),
               posts + static_cast<size_t>(Nf - 1 - i) * m.P1 * G + g, G, 0,
               32, lane);
      mbar_arrive(empty + q);  // this lane has read the slot
    }
    return;
  }

  // the beta chain: each state's emission entry and its position in the
  // plan's order (where its gamma goes) in registers
  const int fin = fin_g[g];
  double wr[WREG][J], om[J];
  int ei[J], pos[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = tid + WT * j;
    const bool in = s < Sp;
    const size_t sg = static_cast<size_t>(in ? s : 0) * G + g;
    ei[j] = in ? EI[s] : 0;
    pos[j] = in ? POS[s] : 0;
#pragma unroll
    for (int o = 0; o < WREG; ++o) {
      const int src = s + m.off[o];
      wr[o][j] = in && o < nO && src >= 0 && src < Sp
                     ? double(bb[static_cast<size_t>(o) * Sp * G + sg])
                     : 0.0;
    }
    om[j] = in ? double(omega[sg]) : 0.0;
  }
  double sc = 1.0;
  for (int i = 0; i < Nf; ++i) {
    const int r = i % WDEPTH, q = i % WRING, p = i & 1;
    mbar_wait(efull + r, (i / WDEPTH) & 1);  // the emissions and alphas
    if (i >= WRING) mbar_wait(empty + q, ((i / WRING) - 1) & 1);
    const T* er = ER + r * n;
    const double* al = AR + r * Sp;
    const double* b = Y + p * Sp;  // the next frame's y, unscaled
    double* yn = Y + (p ^ 1) * Sp;
    double* gq = GM + q * Sp;
    double y[J];
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) y[j] = 1.0;
    } else {
      const double bfin = b[fin] * sc;
#pragma unroll
      for (int j = 0; j < J; ++j) y[j] = 0.0;
#pragma unroll
      for (int o = 0; o < WREG; ++o) {
        double x[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          x[j] = b[min(max(tid + WT * j + m.off[o], 0), Sp - 1)] * sc;
#pragma unroll
        for (int j = 0; j < J; ++j) y[j] = fma(wr[o][j], x[j], y[j]);
      }
#pragma unroll
      for (int o = WREG; o < MAX_BANDS; ++o) {
        if (o < nO) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int s = tid + WT * j, src = s + m.off[o];
            if (s < Sp && src >= 0 && src < Sp)
              y[j] = fma(BX[(o - WREG) * Sp + s], b[src] * sc, y[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) y[j] = fma(om[j], bfin, y[j]);
    }
    double tot = 0.0;
    unsigned key = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = tid + WT * j;
      if (s < Sp) {
        const double gam = al[s] * y[j];
        gq[pos[j]] = gam;
        tot += gam;
        const double yv = y[j] * double(er[ei[j]]);
        key = max(key, exp_key(yv));
        yn[s] = yv;
      }
    }
    key = __reduce_max_sync(FULL, key);
    tot = warp_sum(tot);
    if (lane == 0) {
      SK[p * WW + w] = key;
      TT[q * WW + w] = tot;
    }
    chain_sync();
    sc = pow2_scale(key_exponent(warps_key(SK + p * WW)));
    if (tid == 0) {
      mbar_arrive(edone + r);  // every chain thread has read slot r
      mbar_arrive(full + q);   // and written gamma slot q
    }
  }
}

// K5b, global: banded_bwd_wide_kernel's frames, operations and order on
// the WT chain threads alone, the state and gamma (in the plan's order)
// in ybuf (G, 6 + nO, Sp) float64 in global memory (the state [2][Sp],
// gamma [2][Sp], then stage_consts' rows), the alphas and emissions read
// from the inputs in every frame, and the pdf sums of each frame after
// its barrier.
template <typename T>
__global__ void __launch_bounds__(WT) banded_bwd_global_kernel(
    Meta m, int gm, const T* __restrict__ bb, const T* __restrict__ omega,
    const int* __restrict__ fin_g, const int* __restrict__ spdf,
    const int* __restrict__ plan, const T* __restrict__ ext,
    const double* __restrict__ alphas, T* __restrict__ posts,
    double* ybuf) {
  __shared__ double TT[2 * WW];
  __shared__ unsigned SK[2 * WW];
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const int Sp = m.Sp, G = m.G, Nf = m.Nf, nO = m.nO;
  const int fin = fin_g[g];
  const int* prow = plan + static_cast<size_t>(g) * (3 * Sp + 2);
  double* Y = ybuf + static_cast<size_t>(g) * (6 + nO) * Sp;
  double* GMb = Y + 2 * Sp;
  double* W = GMb + 2 * Sp;
  double* OM = W + nO * Sp;
  int* PD = reinterpret_cast<int*>(OM + Sp);
  const int* POS = PD + Sp;
  stage_consts(m, g, bb, omega, spdf, prow, W, OM, PD);
  double sc = 1.0;
  for (int i = 0; i < Nf; ++i) {
    const int t = Nf - 1 - i, p = i & 1;
    const double* b = Y + p * Sp;
    double* yn = Y + (p ^ 1) * Sp;
    double* gp = GMb + p * Sp;
    const T* e = ext + static_cast<size_t>(t) * m.P1 * G + g;
    const double bfin = i > 0 ? b[fin] * sc : 0.0;
    double tot = 0.0;
    unsigned key = 0;
    for (int s0 = tid; s0 < Sp; s0 += GU * WT) {  // as K5a's: loads first
      double es[GU], al[GU], om[GU], xw[WREG][GU], xs[WREG][GU];
      int pos[GU];
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int s = s0 + WT * u, sl = min(s, Sp - 1);
        es[u] = double(e[static_cast<size_t>(PD[sl]) * G]);
        al[u] = alphas[alpha_at(m, gm, t, sl, g)];
        om[u] = OM[sl];
        pos[u] = POS[sl];
#pragma unroll
        for (int o = 0; o < WREG; ++o) {
          const int src = s + m.off[o];
          const bool ok = i > 0 && o < nO && s < Sp && src >= 0 && src < Sp;
          xw[o][u] = ok ? W[o * Sp + sl] : 0.0;
          xs[o][u] = ok ? b[src] * sc : 0.0;
        }
      }
#pragma unroll
      for (int u = 0; u < GU; ++u) {
        const int s = s0 + WT * u;
        if (s >= Sp) break;
        double y = 1.0;
        if (i > 0) {
          y = 0.0;
#pragma unroll
          for (int o = 0; o < WREG; ++o) y = fma(xw[o][u], xs[o][u], y);
          for (int o = WREG; o < nO; ++o) {
            const int src = s + m.off[o];
            if (src >= 0 && src < Sp) y = fma(W[o * Sp + s], b[src] * sc, y);
          }
          y = fma(om[u], bfin, y);
        }
        const double gam = al[u] * y;
        gp[pos[u]] = gam;  // in the plan's order
        tot += gam;
        const double yv = y * es[u];
        key = max(key, exp_key(yv));
        yn[s] = yv;
      }
    }
    key = __reduce_max_sync(FULL, key);
    tot = warp_sum(tot);
    if (lane == 0) {
      SK[p * WW + w] = key;
      TT[p * WW + w] = tot;
    }
    __syncthreads();
    sc = pow2_scale(key_exponent(warps_key(SK + p * WW)));
    pdf_sums(prow[0], prow + Sp + 1, prow + 1,
             static_cast<const int*>(nullptr), gp, warps_sum(TT + p * WW),
             posts + static_cast<size_t>(t) * m.P1 * G + g, G, tid - lane, WT,
             lane);
  }
}

// Dynamic shared memory of a launch; above the default 48 KB the kernel
// must opt in (the admission caps it at 227 KB).
template <typename Kernel>
cudaError_t smem_cfg(Kernel kernel, int words, size_t* smem) {
  *smem = static_cast<size_t>(words) * sizeof(float);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

// The instantiated states-per-lane counts; a launch takes the smallest
// that covers Sp, calling launch(std::integral_constant<int, J>()).
template <typename Launch>
cudaError_t dispatch_j(int Sp, Launch launch) {
  using std::integral_constant;
  const int need = (Sp + 31) / 32;
  if (need <= 1) return launch(integral_constant<int, 1>());
  if (need <= 2) return launch(integral_constant<int, 2>());
  if (need <= 3) return launch(integral_constant<int, 3>());
  if (need <= 4) return launch(integral_constant<int, 4>());
  if (need <= 6) return launch(integral_constant<int, 6>());
  if (need <= 8) return launch(integral_constant<int, 8>());
  if (need <= 12) return launch(integral_constant<int, 12>());
  if (need <= 16) return launch(integral_constant<int, 16>());
  if (need <= 24) return launch(integral_constant<int, 24>());
  return launch(integral_constant<int, MAX_J>());
}

// The wide instantiations' states per thread; a launch takes the smallest
// that covers Sp (J = 5 is a ~1,200-state lattice's), calling
// launch(std::integral_constant<int, J>()).
template <typename Launch>
cudaError_t dispatch_wj(int Sp, Launch launch) {
  using std::integral_constant;
  if ((Sp + WT - 1) / WT <= 4) return launch(integral_constant<int, 4>());
  return launch(integral_constant<int, MAX_WJ>());
}

template <typename T>
cudaError_t banded_fwd(const Meta& m, int gm, const T* a0, const T* bf,
                       const T* omega, const int* fin, const int* spdf,
                       const int* plan, const T* ext, const T* mshift, double* alphas,
                       double* vfin, double* shift, double* ksum,
                       double* scratch, cudaStream_t s) {
  constexpr int tw = sizeof(T) / sizeof(float);
  const int mode = fwd_mode(m.Sp, m.nO, tw);
  // the alphas' layout is the instantiation's; the global one's state
  // lives in scratch
  if ((alphas != nullptr && gm != (mode != NARROW)) ||
      (mode == GLOBAL && scratch == nullptr))
    return cudaErrorInvalidValue;
  size_t smem;
  if (mode == NARROW)
    return dispatch_j(m.Sp, [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      cudaError_t err = smem_cfg(banded_fwd_kernel<T, J>,
                                 fwd_smem_words(m.Sp, m.nO, NARROW, tw),
                                 &smem);
      if (err != cudaSuccess) return err;
      banded_fwd_kernel<T, J><<<m.G, 64, smem, s>>>(
          m, a0, bf, omega, fin, spdf, ext, mshift, alphas, vfin, shift, ksum);
      return cudaGetLastError();
    });
  if (mode == WIDE)
    return dispatch_wj(m.Sp, [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      cudaError_t err = smem_cfg(banded_fwd_wide_kernel<T, J>,
                                 fwd_smem_words(m.Sp, m.nO, WIDE, tw), &smem);
      if (err != cudaSuccess) return err;
      banded_fwd_wide_kernel<T, J><<<m.G, WT + 32, smem, s>>>(
          m, a0, bf, omega, fin, spdf, plan, ext, mshift, alphas, vfin, shift,
          ksum);
      return cudaGetLastError();
    });
  banded_fwd_global_kernel<T><<<m.G, WT, 0, s>>>(
      m, a0, bf, omega, fin, spdf, ext, mshift, alphas, vfin, shift, ksum,
      scratch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t banded_bwd(const Meta& m, int gm, const T* bb, const T* omega,
                       const int* fin, const int* spdf, const int* plan,
                       const T* ext, const double* alphas, T* posts,
                       double* scratch, cudaStream_t s) {
  constexpr int tw = sizeof(T) / sizeof(float);
  const int mode = bwd_mode(m.Sp, m.nO, tw);
  // the narrow instantiation reads (Nf, Sp, G) alphas only
  if ((mode == NARROW && gm) || (mode == GLOBAL && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      posts, 0, static_cast<size_t>(m.Nf) * m.P1 * m.G * sizeof(T), s);
  if (err != cudaSuccess) return err;
  size_t smem;
  if (mode == NARROW)
    return dispatch_j(m.Sp, [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      cudaError_t e = smem_cfg(banded_bwd_kernel<T, J>,
                               bwd_smem_words(m.Sp, m.nO, NARROW, tw), &smem);
      if (e != cudaSuccess) return e;
      banded_bwd_kernel<T, J><<<m.G, 32 * (2 + POST_WARPS), smem, s>>>(
          m, bb, omega, fin, spdf, plan, ext, alphas, posts);
      return cudaGetLastError();
    });
  if (mode == WIDE)
    return dispatch_wj(m.Sp, [&](auto jc) {
      constexpr int J = decltype(jc)::value;
      cudaError_t e = smem_cfg(banded_bwd_wide_kernel<T, J>,
                               bwd_smem_words(m.Sp, m.nO, WIDE, tw), &smem);
      if (e != cudaSuccess) return e;
      banded_bwd_wide_kernel<T, J><<<m.G, WT + 32 * (1 + WPOST), smem, s>>>(
          m, gm, bb, omega, fin, spdf, plan, ext, alphas, posts);
      return cudaGetLastError();
    });
  banded_bwd_global_kernel<T><<<m.G, WT, 0, s>>>(
      m, gm, bb, omega, fin, spdf, plan, ext, alphas, posts, scratch);
  return cudaGetLastError();
}

}  // namespace

// K5a: the forward sweep over frames 0 .. Nf-1.  plan (G, 3 Sp + 2) int32
// is banded_scan.pdf_plan (the wide instantiation gathers a frame's
// emissions by its entries).  alphas may be null (logZ only): (Nf, Sp, G) from the narrow instantiation, graph-major (Nf, G, Sp)
// from the wide and global ones (imeta's gm says which the caller
// allocated); vfin, shift and ksum (G,) are written, float64.  scratch
// (G, 4 + nO, Sp) float64 holds the global instantiation's state and
// constants (else it may be null).  The inputs a0, bf, omega, ext and mshift are float (f64 = 0) or
// double (f64 = 1).
extern "C" int mm_banded_fwd(const void* a0, const void* bf,
                             const void* omega, const int* fin,
                             const int* spdf, const int* plan,
                             const void* ext,
                             const void* mshift, const long long* imeta,
                             double* alphas, double* vfin, double* shift,
                             double* ksum, double* scratch, int f64,
                             void* stream) {
  Meta m;
  int gm;
  if (!parse_meta(imeta, &m, &gm))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return static_cast<int>(banded_fwd(
        m, gm, static_cast<const double*>(a0), static_cast<const double*>(bf),
        static_cast<const double*>(omega), fin, spdf, plan,
        static_cast<const double*>(ext), static_cast<const double*>(mshift),
        alphas, vfin, shift, ksum, scratch, s));
  return static_cast<int>(banded_fwd(
      m, gm, static_cast<const float*>(a0), static_cast<const float*>(bf),
      static_cast<const float*>(omega), fin, spdf, plan,
      static_cast<const float*>(ext), static_cast<const float*>(mshift),
      alphas, vfin, shift, ksum, scratch, s));
}

// K5b: the backward sweep over frames Nf-1 .. 0 from the forward's alphas
// ((Nf, Sp, G), or graph-major (Nf, G, Sp) where imeta's gm is 1, which the
// narrow instantiation refuses); posts (Nf, P1, G) is zeroed, then each
// graph's plan pdfs are written for every frame.  plan (G, 3 Sp + 2) int32
// is banded_scan.pdf_plan.  scratch (G, 6 + nO, Sp) float64 holds the
// global instantiation's state, gamma and constants (else it may be null).  bb, omega, ext
// and posts are float (f64 = 0) or double (f64 = 1).
extern "C" int mm_banded_bwd(const void* bb, const void* omega,
                             const int* fin, const int* spdf, const int* plan,
                             const void* ext, const double* alphas,
                             const long long* imeta, void* posts,
                             double* scratch, int f64, void* stream) {
  Meta m;
  int gm;
  if (!parse_meta(imeta, &m, &gm))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return static_cast<int>(banded_bwd(
        m, gm, static_cast<const double*>(bb),
        static_cast<const double*>(omega), fin, spdf, plan,
        static_cast<const double*>(ext), alphas, static_cast<double*>(posts),
        scratch, s));
  return static_cast<int>(banded_bwd(
      m, gm, static_cast<const float*>(bb), static_cast<const float*>(omega),
      fin, spdf, plan, static_cast<const float*>(ext), alphas,
      static_cast<float*>(posts), scratch, s));
}

// The instantiation K5a (bwd = 0) or K5b (bwd = 1) takes at Sp states and
// nO offsets, float (f64 = 0) or double inputs: 0 narrow, 1 wide, 2 global
// (the admission's choice, banded_scan._modes, checked on the card).
extern "C" int mm_banded_mode(int Sp, int nO, int bwd, int f64) {
  const int tw = f64 ? 2 : 1;
  return bwd ? bwd_mode(Sp, nO, tw) : fwd_mode(Sp, nO, tw);
}

// Dynamic shared-memory bytes of one CTA of K5a (bwd = 0) or K5b (bwd = 1)
// at Sp states and nO offsets, of the instantiation a launch takes there,
// float (f64 = 0) or double inputs: the admission's figure, checked on the
// card.
extern "C" int mm_banded_smem(int Sp, int nO, int bwd, int f64) {
  const int tw = f64 ? 2 : 1;
  return static_cast<int>(sizeof(float)) *
         (bwd ? bwd_smem_words(Sp, nO, bwd_mode(Sp, nO, tw), tw)
              : fwd_smem_words(Sp, nO, fwd_mode(Sp, nO, tw), tw));
}
