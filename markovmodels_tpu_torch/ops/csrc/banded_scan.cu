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
// Every global array keeps G as its fastest axis (the JAX layout).
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
// shift) are float64; the inputs and the posteriors stay float32.  alpha
// and beta are each normalised to max 1 per frame, and on a long lattice
// their masses sit at opposite ends (alpha runs ahead of the sequence,
// beta behind it).  At the main shape both factors at the posterior's
// peak fall to 1e-27 .. 1e-40 in mid-sequence and their product to
// ~1e-54: in float32 the product underflows (every posterior of those
// frames lost) and the factors lose their mantissa in the subnormal
// range.  The sweep is latency-bound, so float64 costs little.
#include <cuda_runtime.h>

#include "coop_common.cuh"

namespace {

constexpr int MAX_BANDS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 8;       // frames fetched ahead of the chain
constexpr int LEAD = 4;        // frames the helper publishes ahead
constexpr int POST_WARPS = 2;  // K5b's posterior warps (frames in turn)
constexpr int YRING = 8;       // frames of beta between K5b's warps
constexpr int MAX_J = 32;      // states per lane: Sp <= 32 * MAX_J
static_assert(0 < LEAD && LEAD < DEPTH && DEPTH <= 64, "K5a's ring");
static_assert(YRING % POST_WARPS == 0, "a beta slot has one consumer");

struct Meta {
  int Sp, G, P1, Nf, nO;
  int off[MAX_BANDS];
};

// Host int64 descriptor layout (banded_scan._imeta):
// [Sp, G, P1, Nf, nO, off[8]]
bool parse_meta(const long long* im, Meta* m) {
  for (int i = 0; i < 4; ++i)
    if (im[i] <= 0 || im[i] >= (1LL << 31)) return false;
  if (im[4] < 0 || im[4] > MAX_BANDS) return false;
  m->Sp = static_cast<int>(im[0]);
  m->G = static_cast<int>(im[1]);
  m->P1 = static_cast<int>(im[2]);
  m->Nf = static_cast<int>(im[3]);
  m->nO = static_cast<int>(im[4]);
  if (m->Sp > 32 * MAX_J) return false;
  for (int o = 0; o < MAX_BANDS; ++o) {
    if (im[5 + o] <= -im[0] || im[5 + o] >= im[0]) return false;
    m->off[o] = static_cast<int>(im[5 + o]);
  }
  return true;
}

// Shared-memory words (4 bytes) of one CTA, one graph
// (banded_scan._smem_words).
// K5a: the float64 state double buffer X[2][Sp], bands BW[nO][Sp] (one
// zero band when nO = 0), omega OM[Sp] and the alpha ring AL[DEPTH][Sp],
// the mbarriers FULL[DEPTH] and DONE[DEPTH] (8 bytes each), then the float
// emission ring ER[DEPTH][Sp] and shift ring MR[DEPTH].
// K5b: X[2][Sp], BW[nO][Sp], OM[Sp], the beta ring YR[YRING][Sp], and per
// posterior warp gamma GM[Sp] and the alpha ring AR[DEPTH][Sp] (float64),
// the mbarriers FULL[YRING] and EMPTY[YRING] of the beta ring and
// FULL[DEPTH] and DONE[DEPTH] of the emission ring, then ER[DEPTH][Sp]
// (float) and the plan's state order ST[Sp] (int).
__host__ __device__ int fwd_smem_words(int Sp, int nO) {
  return 2 * (2 + (nO > 0 ? nO : 1) + 1 + DEPTH) * Sp + 4 * DEPTH +
         DEPTH * Sp + DEPTH;
}
__host__ __device__ int bwd_smem_words(int Sp, int nO) {
  return 2 * (2 + (nO > 0 ? nO : 1) + 1 + YRING +
              POST_WARPS * (1 + DEPTH)) * Sp +
         4 * (YRING + DEPTH) + (DEPTH + 1) * Sp;
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


// Bands and omega of graph g into shared memory, as float64.
__device__ __forceinline__ void load_bands(const Meta& m, double* BW,
                                           double* OM,
                                           const float* __restrict__ bands,
                                           const float* __restrict__ omega,
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
// i % DEPTH by cp.async; the slot is published to the chain (FULL) LEAD
// steps ahead of it and refilled with step i + DEPTH once the chain has
// released it (DONE).  between(i, slot) runs in that gap (K5a: the alpha
// stores of step i).  Phase u of a slot's barriers belongs to step
// slot + u * DEPTH, and no barrier runs two phases ahead of its waiter:
// step i + DEPTH is published only after the helper saw step i + DEPTH -
// LEAD - 1 >= i released, and released only after it was published.  The
// beta ring of K5b follows the same rule (a slot is written again only
// after EMPTY says it was read).
template <int J, typename FrameOf, typename Between>
__device__ __forceinline__ void emission_helper(
    const Meta& m, int g, int lane, const int* __restrict__ spdf,
    const float* __restrict__ ext, const float* __restrict__ mshift,
    float* ER, float* MR, unsigned long long* full, unsigned long long* done,
    FrameOf frame_of, Between between) {
  const int Sp = m.Sp, G = m.G, Nf = m.Nf;
  int pdf[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    pdf[j] = s < Sp ? spdf[static_cast<size_t>(s) * G + g] : 0;
  }
  auto fetch = [&](int i) {
    if (i < Nf) {
      const int t = frame_of(i);
      float* dst = ER + (i % DEPTH) * Sp;
      const float* src = ext + static_cast<size_t>(t) * m.P1 * G + g;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = lane + 32 * j;
        if (s < Sp) cp_async4(dst + s, src + static_cast<size_t>(pdf[j]) * G);
      }
      if (MR != nullptr && lane == 0)
        cp_async4(MR + i % DEPTH, mshift + static_cast<size_t>(t) * G + g);
    }
    cp_async_commit();
  };
  for (int i = 0; i < DEPTH; ++i) fetch(i);
  cp_async_wait<DEPTH - LEAD>();  // steps 0 .. LEAD - 1
  for (int i = 0; i < LEAD && i < Nf; ++i) mbar_arrive(full + i);
  for (int i = 0; i < Nf; ++i) {
    const int r = i % DEPTH;
    cp_async_wait<DEPTH - LEAD - 1>();  // step i + LEAD is in
    if (i + LEAD < Nf) mbar_arrive(full + (i + LEAD) % DEPTH);
    mbar_wait(done + r, (i / DEPTH) & 1);
    between(i, r);
    fetch(i + DEPTH);  // into the slot step i has just used
  }
  cp_async_wait<0>();
}

// K5a: graph g = blockIdx.x.  Warp 0 runs the chain through all Nf
// frames on shared memory; warp 1, the helper, gathers frame t's
// emissions and shift into ring slot t % DEPTH, and stores the alphas the
// chain wrote into the slot once it is released.
template <int J>
__global__ void __launch_bounds__(64) banded_fwd_kernel(
    Meta m, const float* __restrict__ a0, const float* __restrict__ bf,
    const float* __restrict__ omega, const int* __restrict__ fin_g,
    const int* __restrict__ spdf, const float* __restrict__ ext,
    const float* __restrict__ mshift, double* __restrict__ alphas,
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
  float* ER = reinterpret_cast<float*>(done + DEPTH);
  float* MR = ER + DEPTH * Sp;
  load_bands(m, BW, OM, bf, omega, g, threadIdx.x, 64);
  for (int s = threadIdx.x; s < Sp; s += 64)
    X[s] = a0[static_cast<size_t>(s) * G + g];
  if (threadIdx.x < DEPTH) {
    mbar_init(full + threadIdx.x, 32);
    mbar_init(done + threadIdx.x, 32);
  }
  __syncthreads();

  if (w == 1) {  // the helper: emissions in, alphas out
    emission_helper<J>(
        m, g, lane, spdf, ext, mshift, ER, MR, full, done,
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
    const float* er = ER + r * Sp;
    double y[J], as[J];
    float ev[J];
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
      const float ef = er[fin];
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
template <int J>
__global__ void __launch_bounds__(32 * (2 + POST_WARPS)) banded_bwd_kernel(
    Meta m, const float* __restrict__ bb, const float* __restrict__ omega,
    const int* __restrict__ fin_g, const int* __restrict__ spdf,
    const int* __restrict__ plan, const float* __restrict__ ext,
    const double* __restrict__ alphas, float* __restrict__ posts) {
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
  float* ER = reinterpret_cast<float*>(edone + DEPTH);
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
    emission_helper<J>(
        m, g, lane, spdf, ext, nullptr, ER, nullptr, efull, edone,
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
      const float* er = ER + (i % DEPTH) * Sp;
      float ev[J];
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
      float* pt = posts + static_cast<size_t>(t) * P1 * G + g;
      double acc[J];
#pragma unroll
      for (int q = 0; q < J; ++q) acc[q] = gm[f0[q]];  // 0 + the first
#pragma unroll
      for (int q = 0; q < J; ++q) {
        if (lane + 32 * q < n) {
          for (int c = e0[q] + 1; c < e1[q]; ++c) acc[q] += gm[ST[c]];
          pt[static_cast<size_t>(epdf[q]) * G] =
              static_cast<float>(acc[q] * rt);
        }
      }
      __syncwarp();  // gm is rewritten next time
      fetch(k + DEPTH);
    }
    cp_async_wait<0>();
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
// that covers Sp.
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_j(int Sp, Args... args) {
  const int need = (Sp + 31) / 32;
  if (need <= 1) return Launch<1>::run(args...);
  if (need <= 2) return Launch<2>::run(args...);
  if (need <= 3) return Launch<3>::run(args...);
  if (need <= 4) return Launch<4>::run(args...);
  if (need <= 6) return Launch<6>::run(args...);
  if (need <= 8) return Launch<8>::run(args...);
  if (need <= 12) return Launch<12>::run(args...);
  if (need <= 16) return Launch<16>::run(args...);
  if (need <= 24) return Launch<24>::run(args...);
  return Launch<MAX_J>::run(args...);
}

template <int J>
struct FwdLaunch {
  static cudaError_t run(const Meta& m, const float* a0, const float* bf,
                         const float* omega, const int* fin, const int* spdf,
                         const float* ext, const float* mshift,
                         double* alphas, double* vfin, double* shift,
                         double* ksum, cudaStream_t stream) {
    size_t smem;
    cudaError_t err = smem_cfg(banded_fwd_kernel<J>,
                               fwd_smem_words(m.Sp, m.nO), &smem);
    if (err != cudaSuccess) return err;
    banded_fwd_kernel<J><<<m.G, 64, smem, stream>>>(
        m, a0, bf, omega, fin, spdf, ext, mshift, alphas, vfin, shift, ksum);
    return cudaGetLastError();
  }
};

template <int J>
struct BwdLaunch {
  static cudaError_t run(const Meta& m, const float* bb, const float* omega,
                         const int* fin, const int* spdf, const int* plan,
                         const float* ext, const double* alphas,
                         float* posts, cudaStream_t stream) {
    size_t smem;
    cudaError_t err = smem_cfg(banded_bwd_kernel<J>,
                               bwd_smem_words(m.Sp, m.nO), &smem);
    if (err != cudaSuccess) return err;
    banded_bwd_kernel<J><<<m.G, 32 * (2 + POST_WARPS), smem, stream>>>(
        m, bb, omega, fin, spdf, plan, ext, alphas, posts);
    return cudaGetLastError();
  }
};

}  // namespace

// K5a: the forward sweep over frames 0 .. Nf-1.  alphas (Nf, Sp, G) may be
// null (logZ only); vfin, shift and ksum (G,) are written.  Every output
// is float64.
extern "C" int mm_banded_fwd(const float* a0, const float* bf,
                             const float* omega, const int* fin,
                             const int* spdf, const float* ext,
                             const float* mshift, const long long* imeta,
                             double* alphas, double* vfin, double* shift,
                             double* ksum, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_j<FwdLaunch>(
      m.Sp, m, a0, bf, omega, fin, spdf, ext, mshift, alphas, vfin, shift,
      ksum, static_cast<cudaStream_t>(stream)));
}

// K5b: the backward sweep over frames Nf-1 .. 0 from the forward's alphas;
// posts (Nf, P1, G) is zeroed, then each graph's plan pdfs are written
// for every frame.  plan (G, 3 Sp + 2) int32 is banded_scan.pdf_plan.
extern "C" int mm_banded_bwd(const float* bb, const float* omega,
                             const int* fin, const int* spdf, const int* plan,
                             const float* ext, const double* alphas,
                             const long long* imeta, float* posts,
                             void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      posts, 0, static_cast<size_t>(m.Nf) * m.P1 * m.G * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch_j<BwdLaunch>(
      m.Sp, m, bb, omega, fin, spdf, plan, ext, alphas, posts, s));
}

// Dynamic shared-memory bytes of one CTA of K5a (bwd = 0) or K5b (bwd = 1)
// at Sp states and nO offsets: the admission's figure, checked on the card.
extern "C" int mm_banded_smem(int Sp, int nO, int bwd) {
  return static_cast<int>(sizeof(float)) *
         (bwd ? bwd_smem_words(Sp, nO) : fwd_smem_words(Sp, nO));
}
