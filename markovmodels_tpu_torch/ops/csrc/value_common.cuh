// The value-type overloads every kernel source shares (block_scan.cu and
// vit_scan.cu through block_common.cuh, dense_scan.cu, rec_walk.cu): the
// exact power-of-two rescale, four consecutive values of one state row, and
// the arithmetic a kernel body calls through one name, so that one body
// serves a float instantiation and a double one (a float64 graph).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

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

// floor(log2 m) of a double, clamped at -1022, and 2^-k for an integer k
// in [-1022, 1022] from its 11 exponent bits (block_scan._pow2_exponent and
// _pow2_scale on float64).
__device__ __forceinline__ double pow2_exponent(double m) {
  if (!(m > 0.0)) return 0.0;
  int e;
  frexp(m, &e);
  return fmax(static_cast<double>(e - 1), -1022.0);
}

__device__ __forceinline__ double pow2_scale(double k) {
  return __longlong_as_double(static_cast<long long>(1023 - static_cast<int>(k))
                              << 52);
}

// Four consecutive doubles of one state row: the float64 counterpart of a
// float4 (two 16-byte halves).
struct alignas(16) D4 {
  double x, y, z, w;
};

__device__ __forceinline__ float get(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ double get(const D4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The value type T of an instantiation: float, or double (a float64 graph:
// every value the kernel reads or writes is double).  What depends on it:
template <class T>
__host__ __device__ constexpr bool is_f64() { return sizeof(T) == 8; }
// four consecutive columns of a row, and the unsigned word whose bits order
// non-negative values as they compare (column maxima by atomicMax)
template <class T>
using V4 = typename std::conditional<is_f64<T>(), D4, float4>::type;
template <class T>
using BitsT =
    typename std::conditional<is_f64<T>(), unsigned long long, unsigned>::type;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) {
  return fmax(a, b);
}
// a product rounded once, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}
__device__ __forceinline__ float from_bits(unsigned b) {
  return __uint_as_float(b);
}
__device__ __forceinline__ double from_bits(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}
template <class T>
__device__ __forceinline__ V4<T> make4(T a, T b, T c, T d) {
  if constexpr (is_f64<T>())
    return D4{a, b, c, d};
  else
    return make_float4(a, b, c, d);
}
template <class T>
__device__ __forceinline__ V4<T> zero4() {
  return make4<T>(T(0), T(0), T(0), T(0));
}
// four values from shared memory (16-byte aligned)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ D4 lds4(const double* p) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  return D4{lo.x, lo.y, hi.x, hi.y};
}

}  // namespace
