// The recompute walk of the chunk-recompute Viterbi decode on Hopper
// (sm_90a): W2 mm_rec_walk.
//
// Replaces XLA code, no Pallas kernel: the reverse scan of bstep in
// markovmodels_tpu/viterbi.py's _viterbi_scale (:514-563), which picks the
// state of frame t as the best in-arc source of the state of frame t + 1
// from the frame's recomputed alphas.  One launch walks one chunk of frames
// t0 .. t0 + nK - 1 in reverse, for every sequence, from the states of
// frame t0 + nK (s_next); the chunk's alphas come from the tropical sweep
// that recomputed them (K6t for a 'dense' graph, K7n for a 'block' one).
//
// Per sequence b and frame t (s = the state of frame t + 1, L = length):
//   * t >= L: the decoder is parked on the phony final state fin;
//   * t == L - 1: the source of the omega arc into fin, argmax over all Sp
//     states j of (a_t[j] * scale) * omega[j], ties to the largest j;
//   * otherwise: over the first min(cnt, Dmax) in-arcs of s (its positions
//     in the dst-sorted edge list, cnt = 0 for fin), the candidate
//     logf(a_t[src] * scale) + w (-inf where a_t[src] is 0), argmax with
//     ties to the largest position; fin where every candidate is -inf.
// The alphas are stored unscaled with a per-column power-of-two scale, and
// the JAX package takes the log of the scaled value: the scale multiplies
// before the log (exact in the normal range), so the candidates, hence the
// states, are the JAX package's.  logf is the accurate one (no fast math in
// the build).
//
// The value type T (the template argument): float, or double for a float64
// graph, whose states, scales, arc weights and omega are double; the log is
// then the double one, the argmax shuffles move 64-bit values, and the
// rules (the scale before the log, the ties) are the same.
//
// What bounds it on the card: not bytes (~1 KB of scattered reads per frame
// and sequence) but the chain of dependent loads that each frame waits on
// before the next can start, one warp per sequence.  A plain walk takes
// per frame the state's row pointers, then its sources, then the alphas
// (one more source -> alpha round trip for every further 32 in-arcs: up to
// 5 on the 2M-arc graph's 129), then a reload of the winner's source.  The
// chain floor is two round trips a frame: the state's in-arc records (L2)
// and the gather of their alphas (device memory, 32 scattered values a
// warp instruction; tools/latency_probe.py measures both).  The design:
//   * each in-arc is one packed record (int32 source beside the weight:
//     8 bytes, 16 in double) and each state one (begin, count <= Dmax) pair
//     (vit_scan.rec_walk_tables builds both once per graph);
//   * a lane issues the records of all its in-arcs (R rounds of 32,
//     predicated; R, a template argument, the smallest of 2, 5, 8 that
//     covers Dmax) before any alpha, then all their alphas before the
//     first compare;
//   * with the alphas each lane also loads the (begin, count) pair of its
//     candidate sources, so the winning lane already holds the next
//     frame's row;
//   * every round's log is computed at once (independent chains), then the
//     compares; the warp's argmax is two reductions (__reduce_max_sync on
//     the value's order-preserving key, then on the position among the
//     lanes that hold it) and the winner's source and pair are shuffled
//     from its lane;
//   * the next frame's scale is fetched one frame ahead;
//   * at t == L - 1 the omega argmax runs over the omega support only (the
//     states with omega != 0, listed once per graph), OU entries a lane
//     loaded at a time: a state outside it scores 0 and cannot beat a
//     positive maximum.  Only where the support's maximum is <= 0 (or NaN)
//     does the warp scan all Sp states, as the JAX package's argmax over
//     every state does (ties to the largest j).
#include <cuda_runtime.h>

#include "value_common.cuh"

namespace {

// sequences per CTA, one warp each: four warps of one CTA share an SM's L1,
// where the rows and records they read meet (faster than 1 or 2 a CTA)
constexpr int WARPS = 4;
// in-arc rounds of 32 a lane issues before the first compare: the template
// argument R of rec_walk_kernel, the smallest of 2, 5, 8 that covers Dmax
// (rec_walk_rounds); past 8 rounds (Dmax > 256) a frame loads in batches
// of 8
constexpr int RMAX = 8;
// omega-support entries a lane loads at a time: 16 floats, 8 doubles
template <class T>
constexpr int OU = is_f64<T>() ? 8 : 16;
constexpr unsigned FULL = 0xffffffffu;

// (v, i) beats (bv, bi): a larger value, or an equal one at a larger index
template <class T>
__device__ __forceinline__ bool beats(T v, int i, T bv, int bi) {
  return v > bv || (v == bv && i > bi);
}

// The warp's argmax of (v, i) under beats(); every lane gets it.
template <class T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) {
    const T ov = __shfl_xor_sync(FULL, v, m);
    const int oi = __shfl_xor_sync(FULL, i, m);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// A non-NaN value's key: keys order as the values do (-0 as +0).
__device__ __forceinline__ unsigned long long okey(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long okey(double v) {
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(v + 0.0));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

// The warp's winner under beats() by reductions: the largest key, then
// the largest position among the lanes that hold it; the winning lane
// (position % 32) sends its source and pair.  Returns false where every
// value is -inf (or there is none).
template <class T>
__device__ __forceinline__ bool warp_argmax_redux(T v, int d, int& src,
                                                  int2& row) {
  const unsigned long long k = okey(v);
  unsigned hit;
  if constexpr (is_f64<T>()) {
    const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(k >> 32));
    const unsigned lo = __reduce_max_sync(
        FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k)
                                                   : 0u);
    hit = (static_cast<unsigned>(k >> 32) == hi &&
           static_cast<unsigned>(k) == lo);
  } else {
    hit = static_cast<unsigned>(k) ==
          __reduce_max_sync(FULL, static_cast<unsigned>(k));
  }
  const unsigned dw = __reduce_max_sync(FULL, hit ? unsigned(d + 1) : 0u);
  const int wl = static_cast<int>(dw - 1) & 31;
  src = __shfl_sync(FULL, src, wl);
  row.x = __shfl_sync(FULL, row.x, wl);
  row.y = __shfl_sync(FULL, row.y, wl);
  return __shfl_sync(FULL, v, wl) != T(-INFINITY) && dw != 0;
}

// log of a positive value in its own type (the accurate ones)
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Record i of a packed table (vit_scan._records): an int32 index beside a
// float (8 bytes) or a double (16: the index, a pad word, the value's low
// and high words).
__device__ __forceinline__ void load_rec(const int* p, int i, int& idx,
                                         float& v) {
  const int2 r = __ldg(reinterpret_cast<const int2*>(p) + i);
  idx = r.x;
  v = __int_as_float(r.y);
}
__device__ __forceinline__ void load_rec(const int* p, int i, int& idx,
                                         double& v) {
  const int4 r = __ldg(reinterpret_cast<const int4*>(p) + i);
  idx = r.x;
  v = __hiloint2double(r.w, r.z);
}

// The source of the omega arc into fin at t == L - 1: the argmax of
// (a[j] * sc) * omega[j], ties to the largest j.  a points at the frame's
// column b (stride B).
template <class T>
__device__ __forceinline__ int omega_arg(const T* __restrict__ a, T sc,
                         const int* __restrict__ sup, int nS,
                         const T* __restrict__ omega, int Sp, int B,
                         int lane) {
  T bv = T(-1);
  int bj = -1;
  constexpr int U = OU<T>;
  for (int k0 = 0; k0 < nS; k0 += 32 * U) {
    int j[U];
    T om[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      j[u] = 0;
      om[u] = T(0);
      if (k0 + lane + 32 * u < nS)
        load_rec(sup, k0 + lane + 32 * u, j[u], om[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      av[u] = k0 + lane + 32 * u < nS
                  ? __ldg(a + static_cast<size_t>(j[u]) * B)
                  : T(0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T v = mul_rn(mul_rn(av[u], sc), om[u]);
      // ascending j: an equal value moves to the larger j
      if (k0 + lane + 32 * u < nS && v >= bv) {
        bv = v;
        bj = j[u];
      }
    }
  }
  warp_argmax(bv, bj);
  if (bv > T(0)) return bj;
  // the support's maximum is <= 0, NaN, or there is none: every state
  bv = T(-1);
  bj = -1;
  for (int j = lane; j < Sp; j += 32) {
    const T v = mul_rn(mul_rn(__ldg(a + static_cast<size_t>(j) * B), sc),
                       __ldg(omega + j));
    if (v >= bv) {
      bv = v;
      bj = j;
    }
  }
  warp_argmax(bv, bj);
  return bj;
}

// (the minimum of one CTA an SM lets ptxas keep R = 8's arrays in registers)
template <class T, int R>
__global__ void __launch_bounds__(WARPS * 32, 1) rec_walk_kernel(
    const T* __restrict__ states, const T* __restrict__ scales,
    const int* __restrict__ lengths, const int2* __restrict__ rows,
    const int* __restrict__ rec, const int* __restrict__ sup, int nS,
    const T* __restrict__ omega, int nK, int t0, int Sp, int B, int fin,
    const int* __restrict__ s_next, int* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (b >= B) return;  // a whole warp leaves together
  const int L = __ldg(lengths + b);
  const int s0 = __ldg(s_next + b);
  int2 row = s0 >= 0 && s0 < Sp ? __ldg(rows + s0) : make_int2(0, 0);
  T sc = __ldg(scales + static_cast<size_t>(nK - 1) * B + b);
  for (int i = nK - 1; i >= 0; --i) {
    const int t = t0 + i;
    const T* a = states + static_cast<size_t>(i) * Sp * B + b;
    const T sc_next =
        i > 0 ? __ldg(scales + static_cast<size_t>(i - 1) * B + b) : T(0);
    int st = fin;
    int2 nrow = make_int2(0, 0);  // fin's: no in-arc
    if (t == L - 1) {
      st = omega_arg(a, sc, sup, nS, omega, Sp, B, lane);
      if (st >= 0 && st < Sp) nrow = __ldg(rows + st);
    } else if (t < L) {
      T bv = -INFINITY;
      int bd = -1, bs = fin;
      int2 br = make_int2(0, 0);
      for (int d0 = 0; d0 < row.y; d0 += 32 * R) {
        int src[R];
        T w[R], av[R], v[R];
        int2 rw[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {  // the records, then ...
          src[r] = 0;
          w[r] = T(0);
          if (d0 + lane + 32 * r < row.y)
            load_rec(rec, row.x + d0 + lane + 32 * r, src[r], w[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {  // ... the alphas and the next rows
          av[r] = T(0);
          rw[r] = make_int2(0, 0);
          if (d0 + lane + 32 * r < row.y) {
            av[r] = __ldg(a + static_cast<size_t>(src[r]) * B);
            rw[r] = __ldg(rows + src[r]);
          }
        }
        // every round's log at once (independent chains), then the compares
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T x = mul_rn(av[r], sc);
          const T lx = log_(x > T(0) ? x : T(1));
          v[r] = x > T(0) ? add_rn(lx, w[r]) : T(-INFINITY);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (d0 + lane + 32 * r < row.y && v[r] >= bv) {  // ties move up
            bv = v[r];
            bd = d0 + lane + 32 * r;
            bs = src[r];
            br = rw[r];
          }
      }
      if (warp_argmax_redux(bv, bd, bs, br)) {
        st = bs;
        nrow = br;
      }
    }
    if (lane == 0) out[static_cast<size_t>(i) * B + b] = st;
    row = nrow;
    sc = sc_next;
  }
}

// The in-arc rounds a frame issues at once for a largest in-degree dmax.
int rec_walk_rounds(int dmax) { return dmax <= 64 ? 2 : dmax <= 160 ? 5 : 8; }

template <class T>
cudaError_t rec_walk_launch(const T* states, const T* scales,
                            const int* lengths, const int2* rows,
                            const int* rec, const int* sup, int n_sup,
                            const T* omega, int nK, int t0, int Sp, int B,
                            int dmax, int fin, const int* s_next, int* out,
                            cudaStream_t st) {
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  const int R = rec_walk_rounds(dmax);
  auto kern = R == 2   ? rec_walk_kernel<T, 2>
              : R == 5 ? rec_walk_kernel<T, 5>
                       : rec_walk_kernel<T, RMAX>;
  kern<<<grid, block, 0, st>>>(states, scales, lengths, rows, rec, sup, n_sup,
                               omega, nK, t0, Sp, B, fin, s_next, out);
  return cudaGetLastError();
}

}  // namespace

// W2: the walk over one chunk.  states (nK, Sp, B) unscaled alphas of
// frames t0 .. t0 + nK - 1 with scales (nK, B); lengths (B,); rows (Sp, 2)
// each state's (begin, count) in rec, count = min(in-degree, Dmax) and 0
// for fin; rec the packed in-arc records of the dst-sorted edges (source,
// log weight); sup the n_sup packed (state, omega) records of the omega
// support in ascending state order; omega (Sp,) the probabilities of the
// arcs into fin; s_next (B,) the states of frame t0 + nK.  out (nK, B)
// receives the states of the chunk's frames (compiled numbering); out[0] is
// the next chunk's s_next; dmax the largest count in rows (it picks the
// rounds a frame issues at once).  f64 != 0: states, scales, omega and the
// records' values are double, else float.
extern "C" int mm_rec_walk(const void* states, const void* scales,
                           const int* lengths, const int* rows,
                           const int* rec, const int* sup, int n_sup,
                           const void* omega, int nK, int t0, int Sp, int B,
                           int dmax, int fin, int f64, const int* s_next,
                           int* out, void* stream) {
  if (nK <= 0 || t0 < 0 || Sp <= 0 || B <= 0 || n_sup < 0 || dmax <= 0 ||
      fin < 0 || fin >= Sp)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* r2 = reinterpret_cast<const int2*>(rows);
  const cudaError_t err =
      f64 ? rec_walk_launch(static_cast<const double*>(states),
                            static_cast<const double*>(scales), lengths, r2,
                            rec, sup, n_sup, static_cast<const double*>(omega),
                            nK, t0, Sp, B, dmax, fin, s_next, out, st)
          : rec_walk_launch(static_cast<const float*>(states),
                            static_cast<const float*>(scales), lengths, r2,
                            rec, sup, n_sup, static_cast<const float*>(omega),
                            nK, t0, Sp, B, dmax, fin, s_next, out, st);
  return static_cast<int>(err);
}
