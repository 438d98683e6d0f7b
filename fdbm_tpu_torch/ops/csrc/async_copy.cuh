// Asynchronous copies into shared memory and the split cluster barrier,
// shared by the kernels of lstm.cu, gridrnn.cu and simt_gemm.cuh.
#pragma once

#include <cuda_runtime.h>

namespace {

// cp.async of N bytes (4 or 16) from device to shared memory; the
// destination is zero-filled when !valid (src is then not read).
template <int N>
__device__ __forceinline__ void cp_async_to(float* dst, const float* src, bool valid) {
  static_assert(N == 4 || N == 16, "cp.async copies 4 or 16 bytes here");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier in two halves: a thread's writes before arrive (to
// its own or another block's shared memory) are seen by every thread of
// the cluster after its wait. Between the halves a thread may do work that
// touches nothing the barrier guards. Arrive and wait alternate.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace
