// Full-band frame attention of TF-GridNet and the PReLU + group norm that
// feeds it, on the flat head-minor layouts of the model.
//
// Replaces two Pallas kernels of fdbm_tpu/ops/attention.py:
//
// flat_group_norm (_norm_kernel / _prelu_norm / _group_mean): PReLU and a
//   per-group affine norm over aligned runs of W lanes of x [rows, L]
//   (groups cycle over the H heads), fp32 two-pass biased variance, eps
//   1e-5 inside the root. Bound by bytes: each element is read once and
//   written once. Design: one thread per group keeps the group's W values
//   in registers (vector loads for W >= 2), so the kernel is a single
//   coalesced streaming pass; the TPU's lane-roll butterfly has no
//   counterpart because a thread owns its whole group.
//
// frame_attention (_attn_kernel): per batch and head h,
//   S[t, u] = scale * sum_{q, e} Q[t, q, h, e] K[u, q, h, e],
//   P = softmax_u(S) in fp32, O[t, q, h, d] = sum_u P[t, u] V[u, q, h, d],
//   with q, k [B, T, Q*H*E], v and o [B, T, Q*H*D], scale 1/sqrt(E*Q).
//   Bound by operations at the production shape (1.35 GFLOP fp32 per call
//   at B=1, T=256, Q=257 against 21 MB of tensors). Design: three kernels,
//   attn_scores_kernel and attn_values_kernel are tiled fp32 products that
//   read the head's interleaved lanes in place through their offsets, and
//   attn_softmax_kernel normalises one score row per block. Unlike the TPU
//   kernel, which keeps a query tile's scores in VMEM, this version writes
//   the [B, H, T, T] scores to device memory (2 MB at B=2, T=256) and reads
//   them back twice; in exchange it takes any T, with no tiling ladder or
//   VMEM gate.
#include <cuda_runtime.h>

#include <cmath>

#include "tile_gemm.cuh"

namespace {

// ---- flat_group_norm ------------------------------------------------------------
template <int W>
__global__ void group_norm_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                                  const float* __restrict__ gamma, const float* __restrict__ beta,
                                  float* __restrict__ out, long long n_groups, int n_head,
                                  float eps) {
  const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= n_groups) return;
  const int head = (int)(gi % n_head);
  const float* src = x + gi * W;
  float v[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int e = 0; e < W; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + e);
      v[e] = t.x; v[e + 1] = t.y; v[e + 2] = t.z; v[e + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = src[0];
  }
  const float a = alpha[head];
  float mu = 0.f;
#pragma unroll
  for (int e = 0; e < W; ++e) {
    v[e] = v[e] >= 0.f ? v[e] : a * v[e];
    mu += v[e];
  }
  mu *= 1.f / W;
  float var = 0.f;
#pragma unroll
  for (int e = 0; e < W; ++e) {
    v[e] -= mu;
    var = fmaf(v[e], v[e], var);
  }
  const float inv = 1.f / sqrtf(var * (1.f / W) + eps);
  float* dst = out + gi * W;
#pragma unroll
  for (int e = 0; e < W; ++e) dst[e] = v[e] * inv * gamma[head * W + e] + beta[head * W + e];
}

template <int W>
cudaError_t launch_group_norm(const float* x, const float* alpha, const float* gamma,
                              const float* beta, float* out, long long n_elems, int n_head,
                              cudaStream_t stream) {
  const long long n_groups = n_elems / W;
  const int threads = 256;
  const long long blocks = (n_groups + threads - 1) / threads;
  group_norm_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(x, alpha, gamma, beta, out,
                                                                 n_groups, n_head, 1e-5f);
  return cudaGetLastError();
}

// ---- frame_attention ----------------------------------------------------------------
constexpr int SC_BM = 32, SC_BN = 32;  // score tiles: T x T is small, keep many blocks
constexpr int VA_BM = 64, VA_BN = 64;

// grid (u tiles, t tiles, B*H); scores [B, H, T, T].
__global__ void __launch_bounds__(GEMM_THREADS)
attn_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   float* __restrict__ scores, int T, int Q, int H, int E, float scale) {
  __shared__ __align__(16) float smem[GemmTile<SC_BM, SC_BN>::SMEM_FLOATS];
  const int bh = blockIdx.z;
  const long long b = bh / H;
  const int h = bh % H;
  const int t0 = blockIdx.y * SC_BM, u0 = blockIdx.x * SC_BN;
  const long long row_len = (long long)Q * H * E;
  // Depth index kk = q*E + e reads lane q*H*E + h*E + e of a frame.
  auto lane = [&](int kk) -> long long { return (long long)(kk / E) * H * E + h * E + kk % E; };
  auto a_row = [&](int m) -> long long { return t0 + m < T ? (b * T + t0 + m) * row_len : -1; };
  auto b_n = [&](int n) -> long long { return u0 + n < T ? (b * T + u0 + n) * row_len : -1; };
  float acc[SC_BM / 16][SC_BN / 16];
  gemm_tile<SC_BM, SC_BN, true>(Q * E, q, a_row, lane, k, lane, b_n, acc, smem);
  float* s = scores + (long long)bh * T * T;
#pragma unroll
  for (int i = 0; i < SC_BM / 16; ++i) {
    const int t = t0 + tile_row<SC_BM, SC_BN>(i);
#pragma unroll
    for (int j = 0; j < SC_BN / 16; ++j) {
      const int u = u0 + tile_col(j);
      if (t < T && u < T) s[(long long)t * T + u] = acc[i][j] * scale;
    }
  }
}

// One block per score row: max, sum of exponentials, normalise, in place.
constexpr int SM_THREADS = 256;

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < SM_THREADS / 32 ? red[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(SM_THREADS)
attn_softmax_kernel(float* __restrict__ scores, int T) {
  __shared__ float red[SM_THREADS / 32];
  float* row = scores + (long long)blockIdx.x * T;
  float m = -INFINITY;
  for (int u = threadIdx.x; u < T; u += SM_THREADS) m = fmaxf(m, row[u]);
  m = block_reduce(m, true, red);
  float sum = 0.f;
  for (int u = threadIdx.x; u < T; u += SM_THREADS) sum += expf(row[u] - m);
  sum = block_reduce(sum, false, red);
  const float inv = 1.f / sum;
  for (int u = threadIdx.x; u < T; u += SM_THREADS) row[u] = expf(row[u] - m) * inv;
}

// grid (n tiles over Q*D, t tiles, B*H); out [B, T, Q*H*D].
__global__ void __launch_bounds__(GEMM_THREADS)
attn_values_kernel(const float* __restrict__ probs, const float* __restrict__ v,
                   float* __restrict__ out, int T, int Q, int H, int D) {
  __shared__ __align__(16) float smem[GemmTile<VA_BM, VA_BN>::SMEM_FLOATS];
  const int bh = blockIdx.z;
  const long long b = bh / H;
  const int h = bh % H;
  const int t0 = blockIdx.y * VA_BM, n0 = blockIdx.x * VA_BN;
  const long long row_len = (long long)Q * H * D;
  const int NQD = Q * D;
  // Column index n = q*D + d is lane q*H*D + h*D + d of a frame.
  auto lane = [&](int n) -> long long { return (long long)(n / D) * H * D + h * D + n % D; };
  const float* p = probs + (long long)bh * T * T;
  auto a_row = [&](int m) -> long long { return t0 + m < T ? (long long)(t0 + m) * T : -1; };
  auto a_col = [&](int kk) -> long long { return kk; };
  auto b_k = [&](int kk) -> long long { return (b * T + kk) * row_len; };
  auto b_n = [&](int n) -> long long { return n0 + n < NQD ? lane(n0 + n) : -1; };
  float acc[VA_BM / 16][VA_BN / 16];
  gemm_tile<VA_BM, VA_BN, false>(T, p, a_row, a_col, v, b_k, b_n, acc, smem);
#pragma unroll
  for (int i = 0; i < VA_BM / 16; ++i) {
    const int t = t0 + tile_row<VA_BM, VA_BN>(i);
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < VA_BN / 16; ++j) {
      const int n = n0 + tile_col(j);
      if (n < NQD) out[(b * T + t) * row_len + lane(n)] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x, out [rows, L] with L a multiple of width * n_head; alpha [H],
// gamma/beta [H, width]; width a power of two up to 64.
int flat_group_norm(const float* x, const float* alpha, const float* gamma, const float* beta,
                    float* out, long long n_elems, int n_head, int width, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (width) {
    case 1: return launch_group_norm<1>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    case 2: return launch_group_norm<2>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    case 4: return launch_group_norm<4>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    case 8: return launch_group_norm<8>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    case 16: return launch_group_norm<16>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    case 32: return launch_group_norm<32>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    case 64: return launch_group_norm<64>(x, alpha, gamma, beta, out, n_elems, n_head, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q, k [B, T, Q*H*E]; v, out [B, T, Q*H*D]; scores scratch [B, H, T, T].
int frame_attention(const float* q, const float* k, const float* v, float* scores, float* out,
                    int B, int T, int Q, int H, int E, int D, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int BH = B * H;
  dim3 sgrid((T + SC_BN - 1) / SC_BN, (T + SC_BM - 1) / SC_BM, BH);
  attn_scores_kernel<<<sgrid, GEMM_THREADS, 0, stream>>>(q, k, scores, T, Q, H, E, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_softmax_kernel<<<(unsigned)((long long)BH * T), SM_THREADS, 0, stream>>>(scores, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 vgrid((Q * D + VA_BN - 1) / VA_BN, (T + VA_BM - 1) / VA_BM, BH);
  attn_values_kernel<<<vgrid, GEMM_THREADS, 0, stream>>>(scores, v, out, T, Q, H, D);
  return cudaGetLastError();
}

}  // extern "C"
