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
// What bounds it on the card: a chain of dependent loads per frame and
// sequence (the state's row pointers, its in-arcs, the gathered alphas),
// about 1 KB per frame and sequence of scattered reads, far below any
// bandwidth; so one warp per sequence keeps the chain short: its lanes take
// 32 in-arcs at a time and the argmax is a warp shuffle tree, and the omega
// step's Sp-wide argmax is spread over the warp too.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // sequences per CTA, one warp each
constexpr unsigned FULL = 0xffffffffu;

// (v, i) beats (bv, bi): a larger value, or an equal one at a larger index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i > bi);
}

// The warp's argmax of (v, i) under beats(); every lane gets it.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) {
    const float ov = __shfl_xor_sync(FULL, v, m);
    const int oi = __shfl_xor_sync(FULL, i, m);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32) rec_walk_kernel(
    const float* __restrict__ states, const float* __restrict__ scales,
    const int* __restrict__ lengths, const int* __restrict__ rowptr,
    const int* __restrict__ src, const float* __restrict__ w,
    const float* __restrict__ omega, int nK, int t0, int Sp, int B, int Dmax,
    int fin, const int* __restrict__ s_next, int* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (b >= B) return;  // a whole warp leaves together
  const int L = __ldg(lengths + b);
  int s = __ldg(s_next + b);
  for (int i = nK - 1; i >= 0; --i) {
    const int t = t0 + i;
    const float* a = states + static_cast<size_t>(i) * Sp * B + b;
    const float sc = __ldg(scales + static_cast<size_t>(i) * B + b);
    int st = fin;
    if (t == L - 1) {
      float bv = -1.f;
      int bj = -1;
      for (int j = lane; j < Sp; j += 32) {
        const float v = __fmul_rn(__fmul_rn(__ldg(a + static_cast<size_t>(j) * B),
                                            sc),
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
      float bv = -INFINITY;
      int bd = -1;
      for (int d = lane; d < cnt; d += 32) {
        const int e = rp + d;
        const float av =
            __fmul_rn(__ldg(a + static_cast<size_t>(__ldg(src + e)) * B), sc);
        const float v = av > 0.f ? __fadd_rn(logf(av), __ldg(w + e)) : -INFINITY;
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
// numbering); out[0] is the next chunk's s_next.
extern "C" int mm_rec_walk(const float* states, const float* scales,
                           const int* lengths, const int* rowptr,
                           const int* src, const float* w,
                           const float* omega, int nK, int t0, int Sp, int B,
                           int Dmax, int fin, const int* s_next, int* out,
                           void* stream) {
  if (nK <= 0 || t0 < 0 || Sp <= 0 || B <= 0 || Dmax <= 0 || fin < 0 ||
      fin >= Sp)
    return static_cast<int>(cudaErrorInvalidValue);
  rec_walk_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      states, scales, lengths, rowptr, src, w, omega, nK, t0, Sp, B, Dmax,
      fin, s_next, out);
  return static_cast<int>(cudaGetLastError());
}
