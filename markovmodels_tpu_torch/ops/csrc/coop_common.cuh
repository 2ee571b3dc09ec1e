// Shared by the persistent cooperative kernels (dense_scan.cu sweep_kernel,
// block_scan.cu fwd_chunk_kernel and bwd_chunk_kernel): asynchronous copies
// to shared memory, L2 hints, and the grid-wide barrier between two frames.
#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes global -> shared, through L2 only; a false predicate zero-fills.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// The same with an L2 policy: evict_first for data read once (a frame's
// alphas), so that it does not push out of L2 what the next frame reads.
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem,
                                                bool pred,
                                                unsigned long long policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s),
      "l"(gmem), "r"(pred ? 16 : 0), "l"(policy));
}

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// evict_last: for data read again soon (the panels of every frame, the
// state the next frame reads).
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// 16 bytes past L1 (another CTA of the launch wrote them) under an L2
// policy.
__device__ __forceinline__ float4 ldcg4_hint(const float* p,
                                             unsigned long long policy) {
  float4 v;
  asm volatile(
      "ld.global.cg.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float ldcg_hint(const float* p,
                                           unsigned long long policy) {
  float v;
  asm volatile("ld.global.cg.L2::cache_hint.f32 %0, [%1], %2;\n"
               : "=f"(v)
               : "l"(p), "l"(policy));
  return v;
}

// 16 bytes of data that no CTA of the launch writes, under an L2 policy.
__device__ __forceinline__ float4 ldnc4_hint(const float* p,
                                             unsigned long long policy) {
  float4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void st4_hint(float* p, float4 v,
                                         unsigned long long policy) {
  asm volatile(
      "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A hint to pull the 128-byte line at p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Grid-wide barrier of a cooperative launch: a counter and a generation
// flag in global memory (zeroed words; the generation GEN words after the
// counter).  The last CTA to arrive resets the counter and advances the
// generation; the fences make every write before the barrier visible to
// every read after it.  The waiters poll with exponential backoff (32 ns
// to MAX_NS): they all poll one line of L2.
template <int GEN = 1, unsigned MAX_NS = 1024>
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + GEN;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + GEN, 1u);
    } else {
      unsigned ns = 32;
      while (*gen == g) {
        __nanosleep(ns);
        ns = ns < MAX_NS ? 2 * ns : ns;
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace
