// Shared by the persistent cooperative kernels (dense_scan.cu sweep_kernel,
// block_scan.cu bwd_chunk_kernel): asynchronous copies to shared memory, L2
// hints, and the grid-wide barrier between two frames.
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
// flag in global memory (two zeroed words).  The last CTA to arrive resets
// the counter and advances the generation; the fences make every write
// before the barrier visible to every read after it.  The waiters poll with
// exponential backoff (32 ns to 1 us): they all poll one line of L2.
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      unsigned ns = 32;
      while (*gen == g) {
        __nanosleep(ns);
        ns = ns < 1024 ? 2 * ns : ns;
      }
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace
