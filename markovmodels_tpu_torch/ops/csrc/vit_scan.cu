// Fused tropical Viterbi sweep (K7) and the backtrace walk on Hopper (sm_90a).
//
// Replaces the Pallas kernel of markovmodels_tpu/ops/pallas_block.py:
//   K7 mm_vit_fwd  <- _run_vit_slice pallas_call, _make_vit_kernel
// (the max-product form of its in-kernel matvec K1 is vit_tier_tile() plus
// the band epilogue of vit_step_kernel()), and the walk of
// markovmodels_tpu/viterbi.py's _viterbi_scale_bp, which the JAX package
// leaves to XLA:
//   mm_vit_walk    one thread per sequence.
//
// What K7 computes, per frame t and column b of the (Sp, B) state a:
//   y[j] = max( max_o band_w[o, j] * a[j - off_o],          (bands, in order)
//               max_s W[k, s, d] * a[src(k, s)] )            (tier, j = dst(k, d))
//   with the winning candidate id (Sm + o for a band, s for the tier, 255
//   for no incoming mass) stored as one uint8 per (t, j, b) for the main
//   region j < RW = R*W; the phony final state gets max_j omega[j] * a[j]
//   and its smallest argmax j (fins); frame 0 keeps a = alpha0; then the
//   emission multiply and an exact power-of-two rescale.
// Ties follow the TPU kernel: bands in offset order with a strict >, the
// smallest s among equal tier maxima, the tier merged with a strict >.
//
// What bounds it on the card, at the 2M-arc graph (Sp = 49,280; one tier of
// K = 128 panels of Sm x D = 128 x 128) and B = 128: the tier is
// K*Sm*D*B = 268 M candidate products per frame, each a multiply, a compare
// and two selects (value and id) on the CUDA cores -- the max-product
// reduction has no tensor-core form.  At ~33.5 T lane-instructions/s that
// is ~32 us per frame; the memory per frame is 6.3 MB of ids written plus
// the state (25 MB read by the tier and the bands, 25 MB written), against
// a 50 MB L2.  So the floor is the instruction rate.
//
// Design (a simple one): three launches per frame from a host loop inside
// this library, as block_scan.cu's K2 with its step split in two:
//   vit_step_kernel     one block per (64-row tile, 64-column tile): a tier
//                       tile keeps a running (max, argmax) per output in
//                       registers over a 64x64x128 product staged through
//                       shared memory; then every row takes the band
//                       epilogue, the emission multiply, the state store and
//                       the id store (4 columns in one 32-bit store).  The
//                       tier tiles (96 registers, 2 blocks per SM) and the
//                       band-only tiles (the rows the tier does not write,
//                       compiled for 4 blocks per SM) are two launches.  Each
//                       block writes per-column partials: the state's column
//                       max, and the max and smallest argmax of the omega
//                       products over its own rows of the previous state;
//   vit_finalize_kernel reduces the partials in a fixed order (the argmax
//                       breaks ties by the smaller index, so the result does
//                       not depend on the order), sets the phony state,
//                       records fins[t], and derives the next power-of-two
//                       scale from the exponent bits of the column max.
// The state is stored unscaled; the scale is applied as the next frame reads
// it (exact: powers of two), which reproduces the TPU kernel's rescaled
// state bit for bit, hence its products and ids.  No atomics.
//
// Conventions: state (Sp, B) row-major float32; ext (Nf, P1, B), the emission
// of state j is ext[t, j / cmax, b] (uniform pdf-grouped layout); ids
// (Nf, RW, B) uint8; fins (Nf, B) int32.  Index maps of the tier come from
// the host as ints: src(k, s) = g0 + k*gk + s*gs, dst(k, d) = d0 + k*dk + d*dd.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_common.cuh"

namespace {

constexpr int TB = 64;   // batch columns per tile
constexpr int TS = 32;   // tier contraction depth per shared-memory stage
constexpr int NT = 256;  // threads per step block: 16 x 16, 4x4 outputs each
constexpr int FC = 8;    // finalize: columns per block
constexpr int FR = 128;  // finalize: threads splitting the partials per column
constexpr int PER = TS * TR / NT;  // tier values each thread stages per stage
constexpr int MIN_BLOCKS = 2;  // tier blocks resident per SM (caps registers)
constexpr int MIN_BLOCKS_BAND = 4;  // band-only blocks resident per SM
constexpr int NO_CAND = 255;
constexpr int NO_ARG = 0x7fffffff;
constexpr int WALK_THREADS = 128;

// (v, i) := the larger value, the smaller index among equal values.
__device__ __forceinline__ void arg_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// K1 in max-product form, tier part: for the 4x4 outputs of this thread
// (d = dbase + ty*4 + i, b = b0 + tx*4 + c) the largest product
// W[k, s, d] * a[src(k, s), b] over s and the first s attaining it, where
// a = prev * scale is the rescaled previous state (scaled as it is staged).
__device__ __forceinline__ void vit_tier_tile(
    const Meta& m, int B, const float* __restrict__ prev,
    const float* __restrict__ scale, const float* __restrict__ W, long long k,
    long long dbase, int b0, float (&Ws)[TS][TR], float (&Xs)[TS][TB],
    float (&best)[4][4], int (&arg)[4][4]) {
  static_assert(TR == TB && NT % TR == 0 && TS % (NT / TR) == 0, "tiles");
  constexpr int RS = NT / TR;  // staged rows per pass
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col = tid % TR, row0 = tid / TR;
  const bool dok = dbase + col < m.D, bok = b0 + col < B;
  const float scol = bok ? scale[b0 + col] : 0.f;
  const float* pw = W + (k * m.Sm + row0) * m.D + dbase + col;
  const float* px = prev + (m.g0 + k * m.gk + row0 * m.gs) * B + b0 + col;
  const long long wstep = RS * m.D, xstep = RS * m.gs * B;
  for (long long s0 = 0; s0 < m.Sm; s0 += TS) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool sok = s0 + row0 + u * RS < m.Sm;
      Ws[row0 + u * RS][col] = (sok && dok) ? pw[u * wstep] : 0.f;
      Xs[row0 + u * RS][col] = (sok && bok) ? px[u * xstep] * scol : 0.f;
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
      const int s = static_cast<int>(s0) + ss;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = wv[i] * xv[c];
          if (p > best[i][c]) {
            best[i][c] = p;
            arg[i][c] = s;
          }
        }
    }
    __syncthreads();
  }
}

// One frame over one (row tile, column tile): the new state u = y * e
// (y = a on frame 0), the ids of its main-region rows, and the partials
// part[0] = column max of u, part[1] / parti = max and smallest argmax of
// omega[j] * a[j] over this tile's rows j of the previous state.  TIER:
// tile0 + blockIdx.x is a tier tile; otherwise a band-only tile (the rows
// the tier does not write), compiled apart with few registers so that more
// of these light blocks stay resident.
template <bool VEC, bool TIER>
__global__ void __launch_bounds__(NT, TIER ? MIN_BLOCKS : MIN_BLOCKS_BAND)
vit_step_kernel(
    Meta m, int B, int RW, long long tile0, const float* __restrict__ prev,
    const float* __restrict__ scale, const float* __restrict__ ext_t,
    const float* __restrict__ band_w, const float* __restrict__ W,
    const float* __restrict__ omega, const int* __restrict__ band_rows,
    int first, float* __restrict__ out, uint8_t* __restrict__ bp_t,
    float* __restrict__ part, int* __restrict__ parti) {
  __shared__ __align__(16) float Ws[TIER ? TS : 1][TR];
  __shared__ __align__(16) float Xs[TIER ? TS : 1][TB];
  __shared__ float red_m[16][TB];
  __shared__ float red_v[16][TB];
  __shared__ int red_i[16][TB];
  __shared__ int rows_s[TR];  // state row of each tile row, -1 if none
  __shared__ int grp_s[TR];   // its pdf group (emission row)

  const long long tile = tile0 + blockIdx.x;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;  // this thread's columns bcol .. bcol+3
  constexpr bool is_tier = TIER;
  const long long dtiles = (m.D + TR - 1) / TR;
  const long long k = is_tier ? tile / dtiles : 0;
  const long long dbase = is_tier ? (tile % dtiles) * TR : 0;

  if (tid < TR) {
    long long j = -1;
    if (is_tier) {
      const long long d = dbase + tid;
      if (d < m.D) j = m.d0 + k * m.dk + d * m.dd;
    } else {
      const long long r = (tile - m.n_tier_tiles) * TR + tid;
      if (r < m.nband) j = band_rows[r];
    }
    rows_s[tid] = static_cast<int>(j);
    grp_s[tid] = j < 0 ? -1 : static_cast<int>(j / m.cmax);
  }
  float best[4][4];
  int arg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      best[i][c] = -1.f;  // below every product: s = 0 always enters
      arg[i][c] = 0;
    }
  if constexpr (TIER)
    vit_tier_tile(m, B, prev, scale, W, k, dbase, b0, Ws, Xs, best, arg);
  __syncthreads();

  const float4 sc = load4<VEC>(scale, bcol, B);
  float colmax[4] = {0.f, 0.f, 0.f, 0.f};
  float omv[4] = {-1.f, -1.f, -1.f, -1.f};
  int omi[4] = {NO_ARG, NO_ARG, NO_ARG, NO_ARG};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int j = rows_s[r];
    if (j < 0) continue;
    const size_t jB = static_cast<size_t>(j) * B;
    const float4 e =
        load4<VEC>(ext_t + static_cast<size_t>(grp_s[r]) * B, bcol, B);
    const float4 p = load4<VEC>(prev + jB, bcol, B);
    const float om = omega[j];
    float a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a[c] = get(p, c) * get(sc, c);
      arg_merge(omv[c], omi[c], om * a[c], j);
    }
    const bool main_row = j < RW;
    float vb[4] = {0.f, 0.f, 0.f, 0.f};
    int cb[4] = {NO_CAND, NO_CAND, NO_CAND, NO_CAND};
    if (main_row) {
#pragma unroll
      for (int o = 0; o < MAX_BANDS; ++o) {
        if (o >= m.nO) break;  // uniform across the block
        const int src = j - m.off[o];
        if (src < 0 || src >= RW) continue;  // no arc from outside the main region
        const float w = band_w[static_cast<size_t>(o) * m.Sp + j];
        const float4 x =
            load4<VEC>(prev + static_cast<size_t>(src) * B, bcol, B);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pv = w * (get(x, c) * get(sc, c));
          if (pv > vb[c]) {
            vb[c] = pv;
            cb[c] = static_cast<int>(m.Sm) + o;
          }
        }
      }
      if constexpr (TIER) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (best[i][c] > vb[c]) {
            vb[c] = best[i][c];
            cb[c] = arg[i][c];
          }
      }
    }
    float u[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      u[c] = (first ? a[c] : vb[c]) * get(e, c);
      colmax[c] = fmaxf(colmax[c], u[c]);
    }
    store4<VEC>(out + jB, bcol, B, make_float4(u[0], u[1], u[2], u[3]));
    if (main_row) {
      if constexpr (VEC) {
        if (bcol < B)
          *reinterpret_cast<uint32_t*>(bp_t + jB + bcol) =
              static_cast<uint32_t>(cb[0]) |
              (static_cast<uint32_t>(cb[1]) << 8) |
              (static_cast<uint32_t>(cb[2]) << 16) |
              (static_cast<uint32_t>(cb[3]) << 24);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (bcol + c < B) bp_t[jB + bcol + c] = static_cast<uint8_t>(cb[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red_m[ty][tx * 4 + c] = colmax[c];
    red_v[ty][tx * 4 + c] = omv[c];
    red_i[ty][tx * 4 + c] = omi[c];
  }
  __syncthreads();
  if (tid < TB && b0 + tid < B) {
    const int b = b0 + tid;
    float mx = 0.f, v = -1.f;
    int vi = NO_ARG;
    for (int q = 0; q < 16; ++q) {
      mx = fmaxf(mx, red_m[q][tid]);
      arg_merge(v, vi, red_v[q][tid], red_i[q][tid]);
    }
    part[tile * B + b] = mx;
    part[(m.n_tiles + tile) * B + b] = v;
    parti[tile * B + b] = vi;
  }
}

// Per-column end of a frame: reduce the step's partials (a fixed-order tree;
// the argmax keeps the smaller index on ties), then, unless frame 0, the
// phony state u[fin] = (max_j omega[j] a[j]) * e_fin; fins[t] = the argmax;
// the new scale 2^-k from the column max; ksum += k and the Kahan-compensated
// emission shift.
__global__ void __launch_bounds__(FC * FR) vit_finalize_kernel(
    Meta m, int B, const float* __restrict__ part,
    const int* __restrict__ parti, float* __restrict__ state,
    const float* __restrict__ ext_t, int first, float* __restrict__ scale,
    const float* __restrict__ mshift_t, float* __restrict__ ksum,
    float* __restrict__ shift, float* __restrict__ comp,
    int* __restrict__ fins_t) {
  __shared__ float r_m[FR][FC], r_v[FR][FC];
  __shared__ int r_i[FR][FC];
  const int bl = threadIdx.x, ry = threadIdx.y;
  const int b = blockIdx.x * FC + bl;
  float mx = 0.f, v = -1.f;
  int vi = NO_ARG;
  if (b < B) {
    for (long long t = ry; t < m.n_tiles; t += FR) {
      mx = fmaxf(mx, part[t * B + b]);
      arg_merge(v, vi, part[(m.n_tiles + t) * B + b], parti[t * B + b]);
    }
  }
  r_m[ry][bl] = mx;
  r_v[ry][bl] = v;
  r_i[ry][bl] = vi;
  __syncthreads();
  for (int h = FR / 2; h > 0; h /= 2) {
    if (ry < h) {
      r_m[ry][bl] = fmaxf(r_m[ry][bl], r_m[ry + h][bl]);
      float v2 = r_v[ry][bl];
      int i2 = r_i[ry][bl];
      arg_merge(v2, i2, r_v[ry + h][bl], r_i[ry + h][bl]);
      r_v[ry][bl] = v2;
      r_i[ry][bl] = i2;
    }
    __syncthreads();
  }
  if (b >= B || ry != 0) return;
  mx = r_m[0][bl];
  if (!first) {
    const float yfin =
        r_v[0][bl] * ext_t[static_cast<size_t>(m.fin / m.cmax) * B + b];
    state[static_cast<size_t>(m.fin) * B + b] = yfin;
    mx = fmaxf(mx, yfin);
  }
  fins_t[b] = r_i[0][bl];
  const float k = pow2_exponent(mx);
  scale[b] = pow2_scale(k);
  ksum[b] += k;
  const float xc = mshift_t[b] - comp[b];
  const float t = shift[b] + xc;
  comp[b] = (t - shift[b]) - xc;
  shift[b] = t;
}

// The backtrace of one sequence per thread (viterbi._viterbi_scale_bp's
// wstep): from the phony state at frame Nf-1 down to frame 1, decode the id
// of the current state s to its source; at t == length the source is the
// frame's omega argmax, past the length the phony state.  states[t-1, b]
// receives the state of frame t-1 (compiled numbering).
__global__ void __launch_bounds__(WALK_THREADS) vit_walk_kernel(
    const uint8_t* __restrict__ bps, const int* __restrict__ fins,
    const int* __restrict__ lengths, const int* __restrict__ k_of,
    const int* __restrict__ sidx, const int* __restrict__ offs, int Nf,
    int RW, int B, int Sp, int K, int Sm, int nO, int fin,
    int* __restrict__ states) {
  const int b = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (b >= B) return;
  const int L = lengths[b];
  const int nOff = nO > 0 ? nO : 1;
  int s = fin;
  for (int t = Nf - 1; t >= 1; --t) {
    const int c =
        s < RW ? bps[(static_cast<size_t>(t) * RW + s) * B + b] : NO_CAND;
    const int ks = min(max(k_of[min(max(s, 0), Sp - 1)], 0), K - 1);
    const int tier_src = sidx[ks * Sm + min(max(c, 0), Sm - 1)];
    const int band_src = s - offs[min(max(c - Sm, 0), nOff - 1)];
    int src = c < Sm ? tier_src : band_src;
    if (c == NO_CAND) src = fin;
    int sp = t == L ? fins[static_cast<size_t>(t) * B + b] : src;
    if (t > L) sp = fin;
    states[static_cast<size_t>(t - 1) * B + b] = sp;
    s = sp;
  }
}

}  // namespace

// K7: the tropical sweep over frames 0 .. Nf-1 from a0 (the initial state,
// (Sp, B), with scale = 1; the caller initialises ksum = shift = comp = 0).
// Frame t writes work[t % 2] (unscaled), ids[t] and fins[t]; on return scale
// is the last frame's, so v_final = work[(Nf-1) % 2][fin] * scale.
extern "C" int mm_vit_fwd(
    const float* a0, const float* ext, const float* mshift,
    const float* band_w, const float* W, const float* omega,
    const int* band_rows, const long long* imeta, int B, int Nf, int RW,
    float* work, uint8_t* bps, int* fins, float* scale, float* ksum,
    float* shift, float* comp, float* part, int* parti, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || m.ov_lo != m.Sp || m.nfam != 0 ||
      m.Sm + m.nO >= NO_CAND || B <= 0 || Nf <= 0 || RW <= 0 || RW > m.Sp ||
      m.fin < RW)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned ctiles = (B + TB - 1) / TB;
  const long long n_band = m.n_tiles - m.n_tier_tiles;
  const dim3 tier_grid(static_cast<unsigned>(m.n_tier_tiles), ctiles);
  const dim3 band_grid(static_cast<unsigned>(n_band), ctiles);
  const dim3 fin_grid((B + FC - 1) / FC), fin_block(FC, FR);
  const size_t SB = static_cast<size_t>(m.Sp) * B;
  const bool vec = B % 4 == 0;
  const float* prev = a0;
  for (int t = 0; t < Nf; ++t) {
    float* cur = work + (t % 2) * SB;
    const float* e = ext + static_cast<size_t>(t) * m.P1 * B;
    uint8_t* bp_t = bps + static_cast<size_t>(t) * RW * B;
    if (m.n_tier_tiles > 0) {
      if (vec)
        vit_step_kernel<true, true><<<tier_grid, NT, 0, st>>>(
            m, B, RW, 0, prev, scale, e, band_w, W, omega, band_rows, t == 0,
            cur, bp_t, part, parti);
      else
        vit_step_kernel<false, true><<<tier_grid, NT, 0, st>>>(
            m, B, RW, 0, prev, scale, e, band_w, W, omega, band_rows, t == 0,
            cur, bp_t, part, parti);
    }
    if (n_band > 0) {
      if (vec)
        vit_step_kernel<true, false><<<band_grid, NT, 0, st>>>(
            m, B, RW, m.n_tier_tiles, prev, scale, e, band_w, W, omega,
            band_rows, t == 0, cur, bp_t, part, parti);
      else
        vit_step_kernel<false, false><<<band_grid, NT, 0, st>>>(
            m, B, RW, m.n_tier_tiles, prev, scale, e, band_w, W, omega,
            band_rows, t == 0, cur, bp_t, part, parti);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    vit_finalize_kernel<<<fin_grid, fin_block, 0, st>>>(
        m, B, part, parti, cur, e, t == 0, scale,
        mshift + static_cast<size_t>(t) * B, ksum, shift, comp,
        fins + static_cast<size_t>(t) * B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = cur;
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk over ids (Nf, RW, B) and fins (Nf, B) into states (Nf-1, B).
extern "C" int mm_vit_walk(const uint8_t* bps, const int* fins,
                           const int* lengths, const int* k_of,
                           const int* sidx, const int* offs, int Nf, int RW,
                           int B, int Sp, int K, int Sm, int nO, int fin,
                           int* states, void* stream) {
  if (Nf <= 0 || RW <= 0 || B <= 0 || Sp < RW || K <= 0 || Sm <= 0 ||
      nO < 0 || fin < 0 || fin >= Sp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Nf == 1) return static_cast<int>(cudaSuccess);
  vit_walk_kernel<<<(B + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      bps, fins, lengths, k_of, sidx, offs, Nf, RW, B, Sp, K, Sm, nO, fin,
      states);
  return static_cast<int>(cudaGetLastError());
}
