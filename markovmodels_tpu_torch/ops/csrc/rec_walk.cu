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
// What bounds it on the card: a chain of dependent loads per frame and
// sequence (the state's row pointers, its in-arcs, the gathered alphas),
// about 1 KB per frame and sequence of scattered reads, far below any
// bandwidth; so one warp per sequence keeps the chain short: its lanes take
// 32 in-arcs at a time and the argmax is a warp shuffle tree, and the omega
// step's Sp-wide argmax is spread over the warp too.
#include <cuda_runtime.h>

#include "value_common.cuh"

namespace {

constexpr int WARPS = 4;  // sequences per CTA, one warp each
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

// log of a positive value in its own type (the accurate ones)
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <class T>
__global__ void __launch_bounds__(WARPS * 32) rec_walk_kernel(
    const T* __restrict__ states, const T* __restrict__ scales,
    const int* __restrict__ lengths, const int* __restrict__ rowptr,
    const int* __restrict__ src, const T* __restrict__ w,
    const T* __restrict__ omega, int nK, int t0, int Sp, int B, int Dmax,
    int fin, const int* __restrict__ s_next, int* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (b >= B) return;  // a whole warp leaves together
  const int L = __ldg(lengths + b);
  int s = __ldg(s_next + b);
  for (int i = nK - 1; i >= 0; --i) {
    const int t = t0 + i;
    const T* a = states + static_cast<size_t>(i) * Sp * B + b;
    const T sc = __ldg(scales + static_cast<size_t>(i) * B + b);
    int st = fin;
    if (t == L - 1) {
      T bv = T(-1);
      int bj = -1;
      for (int j = lane; j < Sp; j += 32) {
        const T v = mul_rn(mul_rn(__ldg(a + static_cast<size_t>(j) * B), sc),
                           __ldg(omega + j));
        if (v >= bv) {  // ascending j: an equal value moves to the larger j
          bv = v;
          bj = j;
        }
      }
      warp_argmax(bv, bj);
      st = bj;
    } else if (t < L) {
      const int rp = __ldg(rowptr + s);
      const int cnt = s == fin ? 0 : min(__ldg(rowptr + s + 1) - rp, Dmax);
      T bv = -INFINITY;
      int bd = -1;
      for (int d = lane; d < cnt; d += 32) {
        const int e = rp + d;
        const T av =
            mul_rn(__ldg(a + static_cast<size_t>(__ldg(src + e)) * B), sc);
        const T v = av > T(0) ? add_rn(log_(av), __ldg(w + e)) : T(-INFINITY);
        if (v >= bv) {
          bv = v;
          bd = d;
        }
      }
      warp_argmax(bv, bd);
      st = bv == -INFINITY ? fin : __ldg(src + rp + bd);
    }
    if (lane == 0) out[static_cast<size_t>(i) * B + b] = st;
    s = st;
  }
}

}  // namespace

// W2: the walk over one chunk.  states (nK, Sp, B) unscaled alphas of
// frames t0 .. t0 + nK - 1 with scales (nK, B); lengths (B,); rowptr
// (Sp + 1,), src / w (E,) the in-arc lists of the dst-sorted edges (log
// weights); omega (Sp,) the probabilities of the arcs into fin; Dmax the
// in-arcs a state may take; s_next (B,) the states of frame t0 + nK.
// out (nK, B) receives the states of the chunk's frames (compiled
// numbering); out[0] is the next chunk's s_next.  f64 != 0: states,
// scales, w and omega are double, else float.
extern "C" int mm_rec_walk(const void* states, const void* scales,
                           const int* lengths, const int* rowptr,
                           const int* src, const void* w, const void* omega,
                           int nK, int t0, int Sp, int B, int Dmax, int fin,
                           int f64, const int* s_next, int* out,
                           void* stream) {
  if (nK <= 0 || t0 < 0 || Sp <= 0 || B <= 0 || Dmax <= 0 || fin < 0 ||
      fin >= Sp)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    rec_walk_kernel<double><<<grid, block, 0, st>>>(
        static_cast<const double*>(states), static_cast<const double*>(scales),
        lengths, rowptr, src, static_cast<const double*>(w),
        static_cast<const double*>(omega), nK, t0, Sp, B, Dmax, fin, s_next,
        out);
  else
    rec_walk_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(states), static_cast<const float*>(scales),
        lengths, rowptr, src, static_cast<const float*>(w),
        static_cast<const float*>(omega), nK, t0, Sp, B, Dmax, fin, s_next,
        out);
  return static_cast<int>(cudaGetLastError());
}
