// Deterministic reductions over all (line, step) positions, shared by the
// backward kernels (gridrnn_train.cu, lstm.cu).
//
// A weight gradient sums a product over every position of every line into a
// small matrix. Each such sum is split over the position axis into partial
// sums, one per block (partial[sp][d][...]), and reduce_kernel then adds the
// splits in a fixed order. No atomics: the gradients are the same from run
// to run.
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int WG_BM = 128, WG_BN = 64;  // tile of a weight-gradient product
constexpr int SMS = 132;                // H100 SXM streaming multiprocessors
constexpr int MIN_DEPTH = 512;

// partial[sp][d][N] = column sums of g[d] ([dirs][NL][N]) over its split.
__global__ void __launch_bounds__(GEMM_THREADS)
bias_kernel(const float* __restrict__ g, float* __restrict__ partial, long long NL, int N,
            int dirs, int splits, int depth) {
  const int d = blockIdx.y / splits, sp = blockIdx.y % splits;
  const int n = blockIdx.x * GEMM_THREADS + threadIdx.x;
  if (n >= N) return;
  const long long k0 = (long long)sp * depth;
  const long long k1 = k0 + depth < NL ? k0 + depth : NL;
  const float* col = g + (long long)d * NL * N + n;
  float acc = 0.f;
  for (long long k = k0; k < k1; ++k) acc += col[k * N];
  partial[((long long)sp * dirs + d) * N + n] = acc;
}

// out[i] = sum over sp of partial[sp][i], in split order.
__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                              long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[sp * n + i];
  out[i] = acc;
}

// Splits of the NL-deep reduction for a product with `tiles` output tiles
// per direction: about 8 blocks per SM over all directions, each split at
// least MIN_DEPTH deep.
int wgrad_splits(long long NL, long long tiles, int dirs) {
  long long by_blocks = (8LL * SMS + dirs * tiles - 1) / (dirs * tiles);
  long long by_depth = NL / MIN_DEPTH;
  long long n = by_blocks < by_depth ? by_blocks : by_depth;
  return n < 1 ? 1 : (int)n;
}

int split_depth(long long NL, int splits) {
  return (int)(((NL + splits - 1) / splits + GEMM_BK - 1) / GEMM_BK * GEMM_BK);
}

long long tiles_of(int M, int N) {
  return (long long)((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
}

long long wgrad_floats(long long NL, int M, int N, int dirs) {
  return (long long)wgrad_splits(NL, tiles_of(M, N), dirs) * dirs * M * N;
}

cudaError_t reduce(const float* partial, float* out, long long n, int splits,
                   cudaStream_t stream) {
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n, splits);
  return cudaGetLastError();
}

// out[d][N] = column sums of g [dirs][NL][N], through the workspace.
cudaError_t column_sums(const float* g, float* work, float* out, long long NL, int N, int dirs,
                        cudaStream_t stream) {
  const int splits = wgrad_splits(NL, 1, dirs);
  dim3 grid((N + GEMM_THREADS - 1) / GEMM_THREADS, dirs * splits);
  bias_kernel<<<grid, GEMM_THREADS, 0, stream>>>(g, work, NL, N, dirs, splits,
                                                 split_depth(NL, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(work, out, (long long)dirs * N, splits, stream);
}

long long column_sum_floats(long long NL, int N, int dirs) {
  return (long long)wgrad_splits(NL, 1, dirs) * dirs * N;
}

}  // namespace
