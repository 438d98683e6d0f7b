// Deterministic reductions over all (line, step) positions, shared by the
// backward kernels (gridrnn_train.cu, lstm.cu).
//
// A weight gradient sums a product over every position of every line into a
// small matrix. Each such sum is split over the position axis into partial
// sums, one per block (partial[sp][...]), and the splits are then added in a
// fixed order (reduce_kernel here, or a kernel of the caller's that also
// scatters the sums to their gradients). No atomics: the gradients are the
// same from run to run.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SMS = 132;  // H100 SXM streaming multiprocessors

// out[i] = sum over sp of partial[sp][i], in split order.
__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                              long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[sp * n + i];
  out[i] = acc;
}

cudaError_t reduce(const float* partial, float* out, long long n, int splits,
                   cudaStream_t stream) {
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n, splits);
  return cudaGetLastError();
}

}  // namespace
