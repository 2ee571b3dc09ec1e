// Shared by the blocked kernels (block_scan.cu, vit_scan.cu): the host
// descriptor of one direction's blocked operator and the four-column state
// row accesses (plain, past L1, and under an L2 policy), for float rows and
// (the float64 instantiations) double rows; the value-type overloads and
// the exact power-of-two rescale come from value_common.cuh.
#pragma once

#include <cuda_runtime.h>

#include "coop_common.cuh"
#include "value_common.cuh"

namespace {

constexpr int TR = 64;  // state rows per tile (_TILE_ROWS in block_scan.py)
constexpr int MAX_BANDS = 8;

struct Meta {
  int Sp, P1, cmax, fin;
  int nO;
  int off[MAX_BANDS];
  long long K, Sm, D, g0, gk, gs, d0, dk, dd;
  long long nband, n_tier_tiles, n_band_tiles, n_tiles;
  // overflow rows [ov_lo, ov_hi) of a capped layout (ov_lo = ov_hi = Sp:
  // the uniform layout, row j in pdf group j / cmax); family terms; rows
  // with a tile of their own (the first nheavy tiles of the grid)
  int ov_lo, ov_hi;
  long long nfam, nheavy;
};

// Host int64 descriptor layout (block_scan._imeta):
// [Sp, P1, cmax, fin, nO, off[8], K, Sm, D, g0, gk, gs, d0, dk, dd, nband,
//  n_tiles, ov_lo, ov_hi, nfam, nheavy]
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
  if (im[24] < 0 || im[24] > im[25] || im[25] > im[0] || im[26] < 0 ||
      im[27] < 0)
    return false;
  m->ov_lo = static_cast<int>(im[24]);
  m->ov_hi = static_cast<int>(im[25]);
  m->nfam = im[26];
  m->nheavy = im[27];
  m->n_tier_tiles = m->K * ((m->D + TR - 1) / TR);
  m->n_band_tiles = (m->nband + TR - 1) / TR;
  m->n_tiles = m->n_tier_tiles + m->n_band_tiles + m->nheavy;
  const bool uniform = m->ov_lo == m->Sp;
  return m->n_tiles == im[23] && m->cmax > 0 && m->P1 > 0 &&
         (!uniform || static_cast<long long>(m->P1) * m->cmax == m->Sp) &&
         m->fin >= 0 && m->fin < m->Sp;
}

// The capped layout (the overflow family branch) of a descriptor.
inline bool is_fam(const Meta& m) { return m.nfam > 0 || m.ov_lo < m.ov_hi; }

// Four consecutive batch columns b .. b+3 of one state row.  VEC: one
// 16-byte access (B % 4 == 0, so every row start and b are aligned);
// otherwise masked scalar accesses.  CG: read past L1 (ld.global.cg), for a
// row that another CTA of a persistent launch may have written.
template <bool VEC, bool CG = false>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int b,
                                        int B) {
  if constexpr (CG) {
    if constexpr (VEC)
      return b < B ? __ldcg(reinterpret_cast<const float4*>(row + b))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    else
      return make_float4(b < B ? __ldcg(row + b) : 0.f,
                         b + 1 < B ? __ldcg(row + b + 1) : 0.f,
                         b + 2 < B ? __ldcg(row + b + 2) : 0.f,
                         b + 3 < B ? __ldcg(row + b + 3) : 0.f);
  } else if constexpr (VEC) {
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

// The double rows as load4 / store4 move float rows: VEC (B % 4 == 0, so
// each access is 32-byte aligned) as two 16-byte halves, else masked
// scalars; CG past L1.
template <bool VEC, bool CG = false>
__device__ __forceinline__ D4 load4(const double* __restrict__ row, int b,
                                    int B) {
  if constexpr (VEC) {
    if (!(b < B)) return D4{0.0, 0.0, 0.0, 0.0};
    const double2* p = reinterpret_cast<const double2*>(row + b);
    const double2 lo = CG ? __ldcg(p) : p[0];
    const double2 hi = CG ? __ldcg(p + 1) : p[1];
    return D4{lo.x, lo.y, hi.x, hi.y};
  } else {
    auto at = [&](int i) {
      return b + i < B ? (CG ? __ldcg(row + b + i) : row[b + i]) : 0.0;
    };
    return D4{at(0), at(1), at(2), at(3)};
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(double* __restrict__ row, int b, int B,
                                       D4 v) {
  if constexpr (VEC) {
    if (b < B) {
      double2* p = reinterpret_cast<double2*>(row + b);
      p[0] = make_double2(v.x, v.y);
      p[1] = make_double2(v.z, v.w);
    }
  } else {
    if (b < B) row[b] = v.x;
    if (b + 1 < B) row[b + 1] = v.y;
    if (b + 2 < B) row[b + 2] = v.z;
    if (b + 3 < B) row[b + 3] = v.w;
  }
}

// Four consecutive columns of a state row that another CTA of the launch
// wrote, read past L1 under an L2 policy (VEC), or as load4 does.
template <bool VEC>
__device__ __forceinline__ float4 load4_hint(const float* __restrict__ row,
                                             int b, int B,
                                             unsigned long long policy) {
  if constexpr (VEC)
    return b < B ? ldcg4_hint(row + b, policy)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  else
    return load4<VEC, true>(row, b, B);
}

template <bool VEC>
__device__ __forceinline__ void store4_hint(float* __restrict__ row, int b,
                                            int B, float4 v,
                                            unsigned long long policy) {
  if constexpr (VEC) {
    if (b < B) st4_hint(row + b, v, policy);
  } else {
    store4<VEC>(row, b, B, v);
  }
}

// The double rows take no L2 policy (the float64 instantiation is the
// simple one): past L1, as load4 does.
template <bool VEC>
__device__ __forceinline__ D4 load4_hint(const double* __restrict__ row,
                                         int b, int B, unsigned long long) {
  return load4<VEC, true>(row, b, B);
}

template <bool VEC>
__device__ __forceinline__ void store4_hint(double* __restrict__ row, int b,
                                            int B, D4 v, unsigned long long) {
  store4<VEC>(row, b, B, v);
}

}  // namespace
