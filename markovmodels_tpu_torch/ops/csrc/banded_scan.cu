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
// of float64 alphas and touches ~29 MB of emissions: ~0.03 ms of
// bandwidth.  The
// frames are a serial chain, so the sweep is bound by the latency of one
// frame (shared-memory round trips, two warp reductions, one L2 load), not
// by bytes or FLOPs.
//
// Design: graphs are independent, so there is no grid-wide dependency and
// ONE launch runs the whole sweep.  One warp owns one graph for all frames
// (WPB warps, i.e. graphs, per CTA): its state, bands, omega and state->pdf
// map sit in the warp's slice of shared memory, lane l handles states
// l, l + 32, ...; both reductions are warp shuffles, and a __syncwarp is
// the only barrier.  The emission of state s is gathered from the extended
// emission matrix ext (Nf, P1, G) in the kernel, and K5b reduces gamma to
// pdf posteriors in the kernel (shared-memory atomics into one frame's P1
// sums, then one normalised write of the whole (P1,) column), so neither
// an (Nf, Sp, G) emission stream nor a gamma stream is written.
// Every global array keeps G as its fastest axis (the JAX layout); a warp's
// accesses are strided by G, and the CTA's WPB graphs share each 32-byte
// sector through L1/L2.
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

namespace {

constexpr int WPB = 4;  // graphs (warps) per CTA (_WARPS_PER_BLOCK)
constexpr int MAX_BANDS = 8;
constexpr unsigned FULL = 0xffffffffu;

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
  for (int o = 0; o < MAX_BANDS; ++o) {
    if (im[5 + o] <= -im[0] || im[5 + o] >= im[0]) return false;
    m->off[o] = static_cast<int>(im[5 + o]);
  }
  return true;
}

// Shared-memory words of one warp: (backward) one frame's P1 float64 pdf
// sums, the float64 state double buffer, then max(nO, 1) float bands,
// omega and the int state->pdf map; even, so that every warp's slice
// stays 8-byte aligned.
__host__ __device__ int fwd_smem_words(const Meta& m) {
  return (4 * m.Sp + ((m.nO > 0 ? m.nO : 1) + 2) * m.Sp + 1) & ~1;
}
__host__ __device__ int bwd_smem_words(const Meta& m) {
  return 2 * m.P1 + fwd_smem_words(m);
}

// floor(log2 m) from the exponent bits (ilogb: frexp's exponent - 1,
// without its pointer), 0 for m == 0, clamped at -1022
// (block_scan._pow2_exponent for float64).
__device__ __forceinline__ int pow2_exponent(double m) {
  if (!(m > 0.0)) return 0;
  return max(ilogb(m), -1022);
}

// 2^-k for an integer k in [-1022, 1022], from its exponent bits (exact;
// block_scan._pow2_scale for float64).
__device__ __forceinline__ double pow2_scale(int k) {
  return __longlong_as_double(static_cast<long long>(1023 - k) << 52);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmax(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// The warp's shared-memory slice: (backward) PS[P1] float64 pdf sums,
// X[2][Sp] float64 state, BW[nO][Sp] bands, OM[Sp], PDF[Sp] (int).
struct Slice {
  double* PS;
  double* X;
  float* BW;
  float* OM;
  int* PDF;
};

__device__ __forceinline__ Slice load_slice(const Meta& m, float* base,
                                            bool with_ps,
                                            const float* __restrict__ bands,
                                            const float* __restrict__ omega,
                                            const int* __restrict__ spdf,
                                            int g, int lane) {
  const int nOb = m.nO > 0 ? m.nO : 1;
  Slice sl;
  sl.PS = with_ps ? reinterpret_cast<double*>(base) : nullptr;
  sl.X = reinterpret_cast<double*>(with_ps ? base + 2 * m.P1 : base);
  sl.BW = reinterpret_cast<float*>(sl.X + 2 * m.Sp);
  sl.OM = sl.BW + nOb * m.Sp;
  sl.PDF = reinterpret_cast<int*>(sl.OM + m.Sp);
  for (int s = lane; s < m.Sp; s += 32) {
    const size_t sg = static_cast<size_t>(s) * m.G + g;
    for (int o = 0; o < m.nO; ++o)
      sl.BW[o * m.Sp + s] = bands[static_cast<size_t>(o) * m.Sp * m.G + sg];
    sl.OM[s] = omega[sg];
    sl.PDF[s] = spdf[sg];
  }
  return sl;
}

// K5a: one warp runs graph g through all Nf frames.
__global__ void __launch_bounds__(WPB * 32) banded_fwd_kernel(
    Meta m, const float* __restrict__ a0, const float* __restrict__ bf,
    const float* __restrict__ omega, const int* __restrict__ fin_g,
    const int* __restrict__ spdf, const float* __restrict__ ext,
    const float* __restrict__ mshift, double* __restrict__ alphas,
    double* __restrict__ vfin, double* __restrict__ shift_out,
    double* __restrict__ ksum_out) {
  extern __shared__ __align__(16) float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * WPB + w;
  if (g >= m.G) return;  // the whole warp leaves together
  const Slice sl = load_slice(m, smem + static_cast<size_t>(w) *
                                           fwd_smem_words(m),
                              false, bf, omega, spdf, g, lane);
  const int fin = fin_g[g];
  const int Sp = m.Sp, G = m.G;
  for (int s = lane; s < Sp; s += 32)
    sl.X[s] = a0[static_cast<size_t>(s) * G + g];
  __syncwarp();

  double ksum = 0.0, shift = 0.0;
  int cur = 0;
  for (int t = 0; t < m.Nf; ++t) {
    const double* a = sl.X + cur * Sp;
    double* y = sl.X + (cur ^ 1) * Sp;
    const float* e = ext + static_cast<size_t>(t) * m.P1 * G + g;
    // band terms and the omega dot, from the previous (rescaled) state
    double dot = 0.0;
    for (int s = lane; s < Sp; s += 32) {
      double v;
      if (t == 0) {
        v = a[s];
      } else {
        v = 0.0;
#pragma unroll
        for (int o = 0; o < MAX_BANDS; ++o) {
          if (o >= m.nO) break;  // uniform across the warp
          const int src = s - m.off[o];
          if (src >= 0 && src < Sp)
            v = fma(double(sl.BW[o * Sp + s]), a[src], v);
        }
        dot = fma(double(sl.OM[s]), a[s], dot);
      }
      y[s] = v;
    }
    dot = warp_sum(dot);
    // the phony final row, the emission, the column max
    double mx = 0.0;
    for (int s = lane; s < Sp; s += 32) {
      double v = (t > 0 && s == fin) ? dot : y[s];
      v *= e[static_cast<size_t>(sl.PDF[s]) * G];
      y[s] = v;
      mx = fmax(mx, v);
    }
    mx = warp_max(mx);
    const int k = pow2_exponent(mx);
    const double sc = pow2_scale(k);
    for (int s = lane; s < Sp; s += 32) {
      const double v = y[s] * sc;
      y[s] = v;
      if (alphas != nullptr)
        alphas[(static_cast<size_t>(t) * Sp + s) * G + g] = v;
    }
    ksum += k;  // every lane keeps the same sums
    shift += mshift[static_cast<size_t>(t) * G + g];
    __syncwarp();
    cur ^= 1;
  }
  if (lane == 0) {
    vfin[g] = sl.X[cur * Sp + fin];
    shift_out[g] = shift;
    ksum_out[g] = ksum;
  }
}

// K5b: one warp runs graph g backwards through all Nf frames and writes
// posts[t, :, g] for every frame.
__global__ void __launch_bounds__(WPB * 32) banded_bwd_kernel(
    Meta m, const float* __restrict__ bb, const float* __restrict__ omega,
    const int* __restrict__ fin_g, const int* __restrict__ spdf,
    const float* __restrict__ ext, const double* __restrict__ alphas,
    float* __restrict__ posts) {
  extern __shared__ __align__(16) float smem[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * WPB + w;
  if (g >= m.G) return;
  const Slice sl = load_slice(m, smem + static_cast<size_t>(w) *
                                           bwd_smem_words(m),
                              true, bb, omega, spdf, g, lane);
  const int fin = fin_g[g];
  const int Sp = m.Sp, G = m.G, P1 = m.P1;
  for (int p = lane; p < P1; p += 32) sl.PS[p] = 0.0;
  __syncwarp();

  int cur = 0;
  for (int t = m.Nf - 1; t >= 0; --t) {
    const double* b = sl.X + cur * Sp;
    double* bn = sl.X + (cur ^ 1) * Sp;
    const float* e = ext + static_cast<size_t>(t) * P1 * G + g;
    const double* at = alphas + static_cast<size_t>(t) * Sp * G + g;
    const bool last = t == m.Nf - 1;
    const double bfin = last ? 0.0 : b[fin];
    double tot = 0.0, mx = 0.0;
    for (int s = lane; s < Sp; s += 32) {
      double y = 1.0;
      if (!last) {
        y = 0.0;
#pragma unroll
        for (int o = 0; o < MAX_BANDS; ++o) {
          if (o >= m.nO) break;
          const int src = s + m.off[o];
          if (src >= 0 && src < Sp)
            y = fma(double(sl.BW[o * Sp + s]), b[src], y);
        }
        y = fma(double(sl.OM[s]), bfin, y);
      }
      const int p = sl.PDF[s];
      const double gam = at[static_cast<size_t>(s) * G] * y;
      tot += gam;
      atomicAdd(&sl.PS[p], gam);
      const double v = y * e[static_cast<size_t>(p) * G];
      bn[s] = v;
      mx = fmax(mx, v);
    }
    tot = warp_sum(tot);
    mx = warp_max(mx);
    __syncwarp();  // every pdf sum of frame t is in
    const double den = tot > 0.0 ? tot : 1.0;
    float* pt = posts + static_cast<size_t>(t) * P1 * G + g;
    for (int p = lane; p < P1; p += 32) {
      pt[static_cast<size_t>(p) * G] = static_cast<float>(sl.PS[p] / den);
      sl.PS[p] = 0.0;
    }
    const double sc = pow2_scale(pow2_exponent(mx));
    for (int s = lane; s < Sp; s += 32) bn[s] *= sc;
    __syncwarp();
    cur ^= 1;
  }
}

// Grid and dynamic shared memory of a sweep (one warp per graph); above the
// default 48 KB the kernel must opt in (the admission caps it at 227 KB).
template <typename Kernel>
cudaError_t launch_cfg(Kernel kernel, int words, const Meta& m, dim3* grid,
                       size_t* smem) {
  *grid = dim3(static_cast<unsigned>((m.G + WPB - 1) / WPB));
  *smem = static_cast<size_t>(WPB) * words * sizeof(float);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

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
  dim3 grid;
  size_t smem;
  cudaError_t err = launch_cfg(banded_fwd_kernel,
                               fwd_smem_words(m), m, &grid, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_fwd_kernel<<<grid, WPB * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      m, a0, bf, omega, fin, spdf, ext, mshift, alphas, vfin, shift, ksum);
  return static_cast<int>(cudaGetLastError());
}

// K5b: the backward sweep over frames Nf-1 .. 0 from the forward's alphas;
// writes every entry of posts (Nf, P1, G).
extern "C" int mm_banded_bwd(const float* bb, const float* omega,
                             const int* fin, const int* spdf, const float* ext,
                             const double* alphas, const long long* imeta,
                             float* posts, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  size_t smem;
  cudaError_t err = launch_cfg(banded_bwd_kernel,
                               bwd_smem_words(m), m, &grid, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_bwd_kernel<<<grid, WPB * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      m, bb, omega, fin, spdf, ext, alphas, posts);
  return static_cast<int>(cudaGetLastError());
}
