// Tensor-core building blocks of the bf16 forms of kernels 1, 3 and 7
// (gridrnn.cu's gridrnn_mma_kernel, attention.cu's attn_mma_kernel,
// lstm.cu's dense_mma_kernel and lstm_mma_kernel): mma.sync m16n8k16 with
// bf16 operands and fp32 accumulators, ldmatrix (and its transposed form) to
// load its fragments from shared memory, the swizzled tiles they read, raw
// cp.async of bf16 into shared memory, a split barrier of the block on an
// mbarrier, and the LSTM cell's fast activations.
//
// Fragments of mma.m16n8k16.row.col (lane = 4 g + t4): A (16 x 16, row
// major) a0 = rows g, k 2t4..2t4+1; a1 = rows g+8, the same k; a2, a3 the same
// at k + 8. B (16 x 8, "col": k fastest) b0 = k 2t4..2t4+1 of column g, b1
// the same at k + 8. C (16 x 8 fp32) c0, c1 = row g, columns 2t4, 2t4+1;
// c2, c3 = row g+8. ldmatrix .x4 loads four 8 x 8 matrices of 16-byte rows,
// lanes 8i..8i+7 giving the row addresses of matrix i; a lane receives row
// g, elements 2t4..2t4+1 of each matrix: an A fragment of a row-major tile,
// or a B fragment of a tile stored column by column.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The transposed forms (.x2: two matrices, lanes 0-15 give the row
// addresses): a lane receives elements 2t4..2t4+1 of column g of each
// matrix, so a tile stored k-row by k-row ([k][n], n fastest) gives the B
// fragments of mma's "col" operand.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Swizzled bf16 tiles of 16 k x rows, each row two 16-byte chunks, the
// chunks of rows 4-7 (mod 8) swapped, so that the eight rows an ldmatrix
// reads at one chunk fall in eight different bank groups.
__device__ __forceinline__ int swz(int k, int row) {
  return (row * 2 + (((k >> 3) & 1) ^ ((row >> 2) & 1))) * 8 + (k & 7);
}

// An LSTM cell's activations with the fast exponential and division
// (relative error about 1e-7, far inside the serving kernels' gates; the
// bf16 recurrences round h to bf16, 4e-3, right after): they sit on a
// recurrence's chain.
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float fast_tanh(float v) { return 2.f * fast_sigmoid(2.f * v) - 1.f; }

// d += a * b on the tensor cores: bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of raw bf16 from device to shared memory (both 16-byte aligned),
// zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// N (4, 8 or 16) bytes from device to shared memory, both N-byte aligned,
// zero-filled when !valid (src is then not read); N = 2 is a plain load and
// store (cp.async copies at least 4 bytes).
template <int N>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, bool valid) {
  if constexpr (N == 2) {
    *static_cast<unsigned short*>(dst) = valid ? *static_cast<const unsigned short*>(src) : 0;
  } else if constexpr (N == 16) {
    cp_async_16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(N), "r"(valid ? N : 0));
  }
}

__device__ __forceinline__ void cp_async_commit_raw() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n (0 or 1) of this thread's newest groups are pending.
__device__ __forceinline__ void cp_async_wait_raw(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A split barrier of the block on an mbarrier in shared memory: arrive
// releases the arriving thread's writes, wait(phase) acquires the writes of
// every arrival of that phase (phases count from 0).
__device__ __forceinline__ void block_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void block_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void block_bar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(phase & 1)
      : "memory");
}

}  // namespace
