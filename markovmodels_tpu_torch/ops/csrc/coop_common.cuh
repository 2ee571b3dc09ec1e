// Shared by the persistent cooperative kernels (dense_scan.cu sweep_kernel,
// block_scan.cu fwd_chunk_kernel and bwd_chunk_kernel) and the numerator
// sweeps (banded_scan.cu): asynchronous copies to shared memory, L2 hints,
// mbarriers between the warps of one CTA, and the grid-wide barrier between
// two frames.
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

// 4 and 8 bytes global -> shared, through L1 (the smallest copies
// cp.async takes; a gather of single values).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
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

// An mbarrier in shared memory that completes a phase when ``count``
// threads have arrived.  An arrive releases the thread's earlier shared-
// memory reads and writes; a wait that sees the phase complete acquires
// them.  Initialise before a __syncthreads.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(s),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(s)
      : "memory");
}

// Wait until the phase of parity ``parity`` (0 for the first, 1 for the
// second, ...) has completed.  A wait that never ends (a protocol fault)
// traps after 2^26 tries, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(s), "r"(parity)
        : "memory");
    if (done) return;
    if (tries >= (1u << 26)) __trap();
  }
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
