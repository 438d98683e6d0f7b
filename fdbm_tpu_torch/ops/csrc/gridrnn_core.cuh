// The fold of the TF-GridNet RNN path on the H100, shared by kernels 1, 4
// and 5 (gridrnn.cu), whose cluster recurrence has the input projection
// fused in and leaves the hidden states h in device memory.
//
// Layout: a canvas x [B, S, P, C] with the sequence on axis 1; each (b, p)
// is one line of S rows, L = S - 3 unfold windows per line. A
// sequence-major [S, lines, C] array is the canvas with B = 1, P = lines.
// Per-position tensors are line-major: [2 directions][lines][L][width].
//
// fold_kernel: z = A @ B_d over the FOLD_BM positions a block of output
// rows needs, then the 4-tap overlap-add from shared memory, writing each
// output row once in canvas layout, per direction or summed over both: the
// deconv (A = h, B = wd). B operands are read through strides,
// B_d[k][n] = Bw[d*b_dir + k*b_k + n*b_n]. The k-fastest staging of B
// (B_K_FAST; a weight's transpose) is launched by no kernel now; it stays
// because taking it out (with the strides) changed the code nvcc makes of
// the fold the kernels run (PERF.md, PR 10).
// T is the storage type of h and of the outputs (bf16_io.cuh): under bf16
// io the deconv weight is rounded to bf16 as it is staged, the products and
// the overlap-add sum in fp32, and each output is rounded once, as the JAX
// kernel's fold does (fdbm_tpu/ops/gridrnn.py:180-195).
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int KS = 4;  // unfold width (emb_ks)

// ---- product + overlap-add ----------------------------------------------------
// Block = (line, row tile[, direction]). It computes z = A_d @ B_d for the
// FOLD_BM positions q in [r0 - 3, r0 + FOLD_R) (zero outside [0, L)), then
// out[r] = sum_j z[r - j][tap j] for its FOLD_R output rows. A is
// [2][lines][L][K]; B_d is [K][4C]. SUM adds both directions into out0.
constexpr int FOLD_BM = 64, FOLD_R = FOLD_BM - (KS - 1);
constexpr int FOLD_MAX_C = 64;
constexpr int FOLD_PER_THREAD = (FOLD_R * FOLD_MAX_C + GEMM_THREADS - 1) / GEMM_THREADS;

template <int BN, bool B_K_FAST, bool SUM, class T = float>
__global__ void __launch_bounds__(GEMM_THREADS)
fold_kernel(const T* __restrict__ A, int K, const float* __restrict__ Bw, long long b_dir,
            int b_kst, int b_nst, T* __restrict__ out0, T* __restrict__ out1, int S,
            int P, int C, int L, int n_lines) {
  extern __shared__ __align__(16) float smem[];
  const long long line = blockIdx.x;
  const int r0 = blockIdx.y * FOLD_R;
  const int N = KS * C;
  const long long b = line / P, pc = line % P;
  constexpr int LDZ = BN + 1;
  float* zs = smem;  // [FOLD_BM][LDZ], reuses the staging buffers
  float sum[FOLD_PER_THREAD];  // SUM: this thread's output elements, both directions
#pragma unroll
  for (int i = 0; i < FOLD_PER_THREAD; ++i) sum[i] = 0.f;

  const int d_begin = SUM ? 0 : (int)blockIdx.z, d_end = SUM ? 2 : d_begin + 1;
  for (int d = d_begin; d < d_end; ++d) {
    const T* a = A + ((long long)d * n_lines + line) * L * K;
    auto a_row = [&](int m) -> long long {
      const int q = r0 - (KS - 1) + m;
      return (q >= 0 && q < L) ? (long long)q * K : -1;
    };
    auto a_col = [&](int k) -> long long { return k; };
    auto b_k = [&](int k) -> long long { return d * b_dir + (long long)k * b_kst; };
    auto b_n = [&](int n) -> long long { return n < N ? (long long)n * b_nst : -1; };
    float acc[FOLD_BM / 16][BN / 16];
    gemm_tile<FOLD_BM, BN, B_K_FAST, T>(K, a, a_row, a_col, Bw, b_k, b_n, acc, smem);
#pragma unroll
    for (int i = 0; i < FOLD_BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        zs[tile_row<FOLD_BM, BN>(i) * LDZ + tile_col(j)] = acc[i][j];
    __syncthreads();
    if constexpr (SUM) {
#pragma unroll
      for (int i = 0; i < FOLD_PER_THREAD; ++i) {
        const int e = threadIdx.x + i * GEMM_THREADS;
        if (e < FOLD_R * C) {
          const int rl = e / C, c = e % C;
#pragma unroll
          for (int j = 0; j < KS; ++j) sum[i] += zs[(rl + KS - 1 - j) * LDZ + j * C + c];
        }
      }
    } else {
      T* out = d == 0 ? out0 : out1;
      for (int e = threadIdx.x; e < FOLD_R * C; e += GEMM_THREADS) {
        const int rl = e / C, c = e % C;
        const int r = r0 + rl;
        if (r >= S) break;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j) v += zs[(rl + KS - 1 - j) * LDZ + j * C + c];
        store_f(out + ((b * S + r) * P + pc) * C + c, v);
      }
    }
    __syncthreads();  // zs is the next pass's staging buffer
  }
  if constexpr (SUM) {
#pragma unroll
    for (int i = 0; i < FOLD_PER_THREAD; ++i) {
      const int e = threadIdx.x + i * GEMM_THREADS;
      const int r = r0 + e / C;
      if (e < FOLD_R * C && r < S) store_f(out0 + ((b * S + r) * P + pc) * C + e % C, sum[i]);
    }
  }
}

template <int BN, bool B_K_FAST, bool SUM, class T>
cudaError_t launch_fold_bn(const T* A, int K, const float* Bw, long long b_dir, int b_kst,
                           int b_nst, T* out0, T* out1, int B, int S, int P, int C,
                           cudaStream_t stream) {
  const size_t stage = GemmTile<FOLD_BM, BN>::SMEM_FLOATS;
  const size_t z = (size_t)FOLD_BM * (BN + 1);
  const size_t smem = (stage > z ? stage : z) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fold_kernel<BN, B_K_FAST, SUM, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int L = S - (KS - 1);
  const int n_lines = B * P;
  dim3 grid(n_lines, (S + FOLD_R - 1) / FOLD_R, SUM ? 1 : 2);
  fold_kernel<BN, B_K_FAST, SUM, T><<<grid, GEMM_THREADS, smem, stream>>>(
      A, K, Bw, b_dir, b_kst, b_nst, out0, out1, S, P, C, L, n_lines);
  return cudaGetLastError();
}

template <bool B_K_FAST, bool SUM, class T>
cudaError_t launch_fold(const T* A, int K, const float* Bw, long long b_dir, int b_kst,
                        int b_nst, T* out0, T* out1, int B, int S, int P, int C,
                        cudaStream_t stream) {
  if (KS * C <= 128)
    return launch_fold_bn<128, B_K_FAST, SUM>(A, K, Bw, b_dir, b_kst, b_nst, out0, out1, B, S, P,
                                              C, stream);
  return launch_fold_bn<256, B_K_FAST, SUM>(A, K, Bw, b_dir, b_kst, b_nst, out0, out1, B, S, P, C,
                                            stream);
}

// Shapes every entry takes: 1 <= H <= 128, C % 8 == 0, C <= 64, at least
// one window.
constexpr int MAX_H = 128;

inline bool shape_ok(int S, int C, int H) {
  return S - (KS - 1) >= 1 && H >= 1 && H <= MAX_H && C % 8 == 0 && C <= FOLD_MAX_C;
}

}  // namespace
