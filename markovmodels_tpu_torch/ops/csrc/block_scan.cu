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
// float: at the 2M-arc graph each (group, column) gets at most two
// contributions, which add in the same result in either order.
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
// emission of state j is ext[t, j / cmax, b] (uniform pdf-grouped layout).
// A carried state is stored unscaled with a (B,) scale.  Index maps of the
// tier come from the host as ints: src(k, s) = g0 + k*gk + s*gs,
// dst(k, d) = d0 + k*dk + d*dd.
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;   // state rows per tile (_TILE_ROWS in block_scan.py)
constexpr int TB = 64;   // batch columns per tile
constexpr int TS = 32;   // tier contraction depth per shared-memory stage
constexpr int NT = 256;  // threads per step block: 16 x 16, 4x4 outputs each
constexpr int MAX_BANDS = 8;
constexpr int FC = 8;    // finalize: columns per block
constexpr int FR = 128;  // finalize: threads splitting the partials per column
constexpr int PER = TS * TR / NT;  // tier values each thread stages per stage
constexpr int MIN_BLOCKS = 4;  // step blocks resident per SM (caps registers)

struct Meta {
  int Sp, P1, cmax, fin;
  int nO;
  int off[MAX_BANDS];
  long long K, Sm, D, g0, gk, gs, d0, dk, dd;
  long long nband, n_tier_tiles, n_tiles;
};

// Host int64 descriptor layout (block_scan._imeta):
// [Sp, P1, cmax, fin, nO, off[8], K, Sm, D, g0, gk, gs, d0, dk, dd, nband, n_tiles]
bool parse_meta(const long long* im, Meta* m) {
  if (im[0] <= 0 || im[0] >= (1LL << 31) || im[4] < 0 || im[4] > MAX_BANDS)
    return false;
  m->Sp = static_cast<int>(im[0]);
  m->P1 = static_cast<int>(im[1]);
  m->cmax = static_cast<int>(im[2]);
  m->fin = static_cast<int>(im[3]);
  m->nO = static_cast<int>(im[4]);
  for (int o = 0; o < MAX_BANDS; ++o) {
    if (im[5 + o] <= -im[0] || im[5 + o] >= im[0]) return false;
    m->off[o] = static_cast<int>(im[5 + o]);
  }
  m->K = im[13]; m->Sm = im[14]; m->D = im[15];
  m->g0 = im[16]; m->gk = im[17]; m->gs = im[18];
  m->d0 = im[19]; m->dk = im[20]; m->dd = im[21];
  m->nband = im[22];
  m->n_tier_tiles = m->K * ((m->D + TR - 1) / TR);
  m->n_tiles = m->n_tier_tiles + (m->nband + TR - 1) / TR;
  return m->n_tiles == im[23] && m->cmax > 0 &&
         static_cast<long long>(m->P1) * m->cmax == m->Sp && m->fin >= 0 &&
         m->fin < m->Sp;
}

// floor(log2 m) from the exponent bits, 0 for m == 0, clamped at -126 so
// that the scale 2^-k stays finite (block_scan._pow2_exponent).
__device__ __forceinline__ float pow2_exponent(float m) {
  if (!(m > 0.f)) return 0.f;
  int e;
  frexpf(m, &e);
  return fmaxf(static_cast<float>(e - 1), -126.f);
}

// 2^-k for an integer k in [-126, 126], built from its exponent bits
// (exact; block_scan._pow2_scale).
__device__ __forceinline__ float pow2_scale(float k) {
  return __int_as_float((127 - static_cast<int>(k)) << 23);
}

// Four consecutive batch columns b .. b+3 of one state row.  VEC: one
// 16-byte access (B % 4 == 0, so every row start and b are aligned);
// otherwise masked scalar accesses.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int b,
                                        int B) {
  if constexpr (VEC) {
    return b < B ? *reinterpret_cast<const float4*>(row + b)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(b < B ? row[b] : 0.f, b + 1 < B ? row[b + 1] : 0.f,
                       b + 2 < B ? row[b + 2] : 0.f,
                       b + 3 < B ? row[b + 3] : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ row, int b, int B,
                                       float4 v) {
  if constexpr (VEC) {
    if (b < B) *reinterpret_cast<float4*>(row + b) = v;
  } else {
    if (b < B) row[b] = v.x;
    if (b + 1 < B) row[b + 1] = v.y;
    if (b + 2 < B) row[b + 2] = v.z;
    if (b + 3 < B) row[b + 3] = v.w;
  }
}

__device__ __forceinline__ float get(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
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

// One frame of one sweep over one (row tile, column tile).
//   BWD = false (K2, K3): y = (M prev)*s (or prev on frame 0), y *= e;
//     partial[0] = column max of y, partial[1] = omega . prev (unscaled).
//   BWD = true (K4): y = (M prev + omega * prev[fin])*s (or 1 on the last
//     padded frame); gamma = alpha_t * ascale_t * y summed into the pdf
//     groups of posts_t; beta = y * e; partial[0] = column max of beta,
//     partial[1] = column sum of gamma.
template <bool BWD, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) step_kernel(
    Meta m, int B, const float* __restrict__ prev,
    const float* __restrict__ scale, const float* __restrict__ ext_t,
    const float* __restrict__ band_w, const float* __restrict__ W,
    const float* __restrict__ omega, const int* __restrict__ band_rows,
    int skip_matvec, float* __restrict__ out, float* __restrict__ part,
    const float* __restrict__ alpha_t, const float* __restrict__ ascale_t,
    float* __restrict__ posts_t) {
  __shared__ __align__(16) float Ws[TS][TR];
  __shared__ __align__(16) float Xs[TS][TB];
  __shared__ float red[2][16][TB];
  __shared__ float G[BWD ? TR : 1][TB + 1];
  __shared__ int rows_s[TR];  // state row of each tile row, -1 if none
  __shared__ int grp_s[TR];   // its pdf group (BWD: posterior row)

  const long long tile = blockIdx.x;
  const int b0 = blockIdx.y * TB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;  // this thread's columns bcol .. bcol+3
  const bool is_tier = tile < m.n_tier_tiles;
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
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  if (is_tier && !skip_matvec) tier_tile(m, B, prev, W, k, dbase, b0, Ws, Xs, acc);
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
        load4<VEC>(ext_t + static_cast<size_t>(grp_s[r]) * B, bcol, B);
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
      float bn[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float y =
            skip_matvec ? 1.f : fmaf(om, get(pfin, c), v[c]) * get(sc, c);
        const float g = get(a, c) * get(asc, c) * y;
        G[r][tx * 4 + c] = g;
        colsum[c] += g;
        bn[c] = y * get(e, c);
        colmax[c] = fmaxf(colmax[c], bn[c]);
      }
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
    part[tile * B + b] = mx;
    part[(m.n_tiles + tile) * B + b] = sm;
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
//   backward: the new scale of beta and posts_t /= the column's gamma sum.
template <bool BWD>
__global__ void __launch_bounds__(FC * FR) finalize_kernel(
    Meta m, int B, const float* __restrict__ part, float* __restrict__ state,
    const float* __restrict__ ext_t,
    const float* scale_in,  // may alias scale_out (read before written)
    float* scale_out, int skip_matvec,
    const float* __restrict__ mshift_t, float* __restrict__ ksum,
    float* __restrict__ shift, float* __restrict__ comp,
    float* __restrict__ posts_t) {
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
        const float yfin = sm * scale_in[b] *
                           ext_t[static_cast<size_t>(m.fin / m.cmax) * B + b];
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
    for (int p = ry; p < m.P1; p += FR)
      posts_t[static_cast<size_t>(p) * B + b] /= den;
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

template <bool BWD>
cudaError_t launch_step(const Launch& l, cudaStream_t st, const Meta& m,
                        int B, const float* prev, const float* scale,
                        const float* e, const float* band_w, const float* W,
                        const float* omega, const int* band_rows, int skip,
                        float* out, float* part, const float* alpha_t,
                        const float* ascale_t, float* posts_t) {
  if (l.vec)
    step_kernel<BWD, true><<<l.step_grid, NT, 0, st>>>(
        m, B, prev, scale, e, band_w, W, omega, band_rows, skip, out, part,
        alpha_t, ascale_t, posts_t);
  else
    step_kernel<BWD, false><<<l.step_grid, NT, 0, st>>>(
        m, B, prev, scale, e, band_w, W, omega, band_rows, skip, out, part,
        alpha_t, ascale_t, posts_t);
  return cudaGetLastError();
}

}  // namespace

// K2: the forward sweep over frames 0 .. Npad-1 from a0.  Before frame t with
// t % chunk == 0 the carried state and its scale are copied to checkpoint
// t / chunk.  Frame Npad-1 writes a_last; scale ends as its scale; ksum,
// shift and comp accumulate the exponents and the emission shift (the
// caller initialises scale = 1, ksum = shift = comp = 0).
extern "C" int mm_block_fwd(
    const float* a0, const float* ext, const float* mshift,
    const float* band_w, const float* W, const float* omega,
    const int* band_rows, const long long* imeta, int B, int Npad, int chunk,
    float* work, float* a_last, float* bounds, float* bscale, float* scale,
    float* ksum, float* shift, float* comp, float* part, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || Npad <= 0 || chunk <= 0 ||
      Npad % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
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
        l, st, m, B, prev, scale, e, band_w, W, omega, band_rows, t == 0, cur,
        part, nullptr, nullptr, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<false><<<l.fin_grid, l.fin_block, 0, st>>>(
        m, B, part, cur, e, scale, scale, t == 0,
        mshift + static_cast<size_t>(t) * B, ksum, shift, comp, nullptr);
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
    const float* band_w, const float* W, const float* omega,
    const int* band_rows, const long long* imeta, int B, int t0, int K,
    float* alphas, float* ascale, float* part, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || K <= 0 || t0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch l = launch_shape(m, B);
  const float* prev = bound;
  const float* s_prev = bscale;
  for (int j = 0; j < K; ++j) {
    float* cur = alphas + j * l.SB;
    float* s_cur = ascale + static_cast<size_t>(j) * B;
    const float* e = ext_c + static_cast<size_t>(j) * m.P1 * B;
    cudaError_t err = launch_step<false>(
        l, st, m, B, prev, s_prev, e, band_w, W, omega, band_rows, t0 + j == 0,
        cur, part, nullptr, nullptr, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<false><<<l.fin_grid, l.fin_block, 0, st>>>(
        m, B, part, cur, e, s_prev, s_cur, t0 + j == 0, nullptr, nullptr,
        nullptr, nullptr, nullptr);
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
// receives the state of frame t0 (unscaled, with scale).
extern "C" int mm_block_bwd(
    const float* beta_in, const float* alphas, const float* ascale,
    const float* ext_c, const float* band_w, const float* W,
    const float* omega, const int* band_rows, const long long* imeta, int B,
    int t0, int K, int Npad, float* work, float* beta_out, float* scale,
    float* posts, float* part, void* stream) {
  Meta m;
  if (!parse_meta(imeta, &m) || B <= 0 || K <= 0 || t0 < 0 ||
      t0 + K > Npad)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch l = launch_shape(m, B);
  const float* prev = beta_in;
  for (int j = K - 1; j >= 0; --j) {
    const int t = t0 + j;
    float* cur = (j == 0) ? beta_out : work + (j % 2) * l.SB;
    const float* e = ext_c + static_cast<size_t>(j) * m.P1 * B;
    float* pt = posts + static_cast<size_t>(j) * m.P1 * B;
    cudaError_t err = launch_step<true>(
        l, st, m, B, prev, scale, e, band_w, W, omega, band_rows,
        t == Npad - 1, cur, part, alphas + j * l.SB,
        ascale + static_cast<size_t>(j) * B, pt);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_kernel<true><<<l.fin_grid, l.fin_block, 0, st>>>(
        m, B, part, cur, e, scale, scale, 0, nullptr, nullptr, nullptr,
        nullptr, pt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    prev = cur;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
