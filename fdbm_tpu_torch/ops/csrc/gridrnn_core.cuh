// The three stages of the TF-GridNet RNN path on the H100, run in turn by
// the training kernels (gridrnn_train.cu); the serving kernel (gridrnn.cu)
// fuses the first two into one cluster recurrence and takes only the fold
// from here.
//
// Layout: a canvas x [B, S, P, C] with the sequence on axis 1; each (b, p)
// is one line of S rows, L = S - 3 unfold windows per line. A
// sequence-major [S, lines, C] array is the canvas with B = 1, P = lines.
// Per-position tensors are line-major: [2 directions][lines][L][width].
//
//   1. window_proj_kernel: out_d[m] = win_d[m] @ B_d (+ bias_d) for every
//      window m = (line, l) of both directions, the k=4 windows read
//      straight from the canvas (the unfold never exists in memory). The
//      input projection of the LSTM (B = w_ih) and, in the backward, the
//      deconv's transpose on the windows of the output cotangent
//      (B = wd^T) are this product.
//   2. gridrnn_rec_kernel: the recurrence, one block per direction and
//      group of REC_G = 4 lines, one thread per gate column. The first
//      REC_KR rows of the thread's w_hh column live in its registers and
//      the rest in shared memory, so w_hh is read from neither device
//      memory nor L2 inside the loop; the four lines' hidden states are one
//      broadcast float4 read per row. With STASH it also writes what the
//      backward needs: the activated gates, in place over the
//      pre-activations, and the cell states.
//   3. fold_kernel: z = A @ B_d over the FOLD_BM positions a block of output
//      rows needs, then the 4-tap overlap-add from shared memory, writing
//      each output row once in canvas layout, per direction or summed over
//      both. The deconv (A = h, B = wd) and, in the backward, the unfold's
//      transpose (A = dgates, B = w_ih^T) are this fold.
// B operands are read through strides, B_d[k][n] = Bw[d*b_dir + k*b_k + n*b_n],
// so one kernel serves a weight and its transpose.
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int KS = 4;  // unfold width (emb_ks)

// ---- 1. window projection ----------------------------------------------------
constexpr int PROJ_BM = 128, PROJ_BN = 64;

template <bool B_K_FAST>
__global__ void __launch_bounds__(GEMM_THREADS)
window_proj_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                   const float* __restrict__ Bw, long long b_dir, int b_kst, int b_nst,
                   const float* __restrict__ bias, float* __restrict__ out, int S, int P,
                   int C, int L, int N, long long M) {
  __shared__ __align__(16) float smem[GemmTile<PROJ_BM, PROJ_BN>::SMEM_FLOATS];
  const int d = blockIdx.z;
  const float* x = d == 0 ? x0 : x1;
  const int K = KS * C;
  const long long m0 = (long long)blockIdx.x * PROJ_BM;
  const int n0 = blockIdx.y * PROJ_BN;
  // Row m is window (line, l): taps j at canvas rows l + j.
  auto a_row = [&](int m) -> long long {
    const long long row = m0 + m;
    if (row >= M) return -1;
    const long long line = row / L;
    const long long l = row % L;
    const long long b = line / P, pc = line % P;
    return ((b * S + l) * P + pc) * C;
  };
  auto a_col = [&](int k) -> long long { return (long long)(k / C) * P * C + k % C; };
  auto b_k = [&](int k) -> long long { return d * b_dir + (long long)k * b_kst; };
  auto b_n = [&](int n) -> long long { return (n0 + n < N) ? (long long)(n0 + n) * b_nst : -1; };
  float acc[PROJ_BM / 16][PROJ_BN / 16];
  gemm_tile<PROJ_BM, PROJ_BN, B_K_FAST>(K, x, a_row, a_col, Bw, b_k, b_n, acc, smem);
#pragma unroll
  for (int i = 0; i < PROJ_BM / 16; ++i) {
    const long long row = m0 + tile_row<PROJ_BM, PROJ_BN>(i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < PROJ_BN / 16; ++j) {
      const int n = n0 + tile_col(j);
      if (n < N) out[((long long)d * M + row) * N + n] = acc[i][j] + (bias ? bias[d * N + n] : 0.f);
    }
  }
}

template <bool B_K_FAST>
cudaError_t launch_window_proj(const float* x0, const float* x1, const float* Bw, long long b_dir,
                               int b_kst, int b_nst, const float* bias, float* out, int B, int S,
                               int P, int C, int N, cudaStream_t stream) {
  const int L = S - (KS - 1);
  const long long M = (long long)B * P * L;
  dim3 grid((unsigned)((M + PROJ_BM - 1) / PROJ_BM), (N + PROJ_BN - 1) / PROJ_BN, 2);
  window_proj_kernel<B_K_FAST><<<grid, GEMM_THREADS, 0, stream>>>(x0, x1, Bw, b_dir, b_kst, b_nst,
                                                                 bias, out, S, P, C, L, N, M);
  return cudaGetLastError();
}

// ---- 2. recurrence -----------------------------------------------------------
constexpr int REC_G = 4;    // lines per block (one float4 of state per row)
constexpr int REC_KR = 64;  // weight rows held in registers
constexpr int REC_MAX_THREADS = 512;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// xp [2][lines][L][4H] pre-activations (bias included), hout [2][lines][L][H].
// With STASH, xp is overwritten with the activated gates (i, f, g, o) of its
// position and cout [2][lines][L][H] receives the cell states.
// Shared memory: w_hh rows >= REC_KR [H-REC_KR][4H], hidden state
// [max(H, REC_KR)][REC_G] (rows >= H stay 0), gates [REC_G][4H].
template <bool STASH>
__global__ void __launch_bounds__(REC_MAX_THREADS, 1)
gridrnn_rec_kernel(float* __restrict__ xp, const float* __restrict__ w_hh,
                   float* __restrict__ hout, float* __restrict__ cout, int n_lines, int L,
                   int H) {
  extern __shared__ __align__(16) float smem[];
  const int N = 4 * H;
  const int d = blockIdx.y;
  const int g = threadIdx.x;  // gate column in phase A, (line, unit) in phase B
  const int hrows = H > REC_KR ? H : REC_KR;
  float* ws = smem;                                          // [(H - KR) * N]
  float* hs = ws + (H > REC_KR ? (H - REC_KR) * N : 0);      // [hrows * G]
  float* gs = hs + hrows * REC_G;                            // [G * N]
  const float* w = w_hh + (long long)d * H * N;

  float wr[REC_KR];
#pragma unroll
  for (int k = 0; k < REC_KR; ++k) wr[k] = (g < N && k < H) ? w[(long long)k * N + g] : 0.f;
  for (int e = threadIdx.x; e < (H - REC_KR) * N; e += blockDim.x)
    ws[e] = w[(long long)REC_KR * N + e];
  for (int e = threadIdx.x; e < hrows * REC_G; e += blockDim.x) hs[e] = 0.f;

  const int line0 = blockIdx.x * REC_G;
  // Phase B ownership: thread -> (line bl, hidden unit bj).
  const int bl = g / H, bj = g % H;
  const bool b_owner = g < REC_G * H;
  const bool b_valid = b_owner && line0 + bl < n_lines;
  float c_state = 0.f;

  const long long dir_off = (long long)d * n_lines * L;
  auto xp_at = [&](int l, int p) -> float {
    const int line = line0 + l;
    return (g < N && line < n_lines) ? xp[((dir_off + (long long)line * L) + p) * N + g] : 0.f;
  };
  float xnext[REC_G];
  {
    const int p0 = d == 0 ? 0 : L - 1;
#pragma unroll
    for (int l = 0; l < REC_G; ++l) xnext[l] = xp_at(l, p0);
  }
  __syncthreads();

  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  for (int s = 0; s < L; ++s) {
    const int p = d == 0 ? s : L - 1 - s;
    // Phase A: gate column g for the four lines.
    float acc[REC_G];
#pragma unroll
    for (int l = 0; l < REC_G; ++l) acc[l] = xnext[l];
    if (s + 1 < L) {
      const int pn = d == 0 ? s + 1 : L - 2 - s;
#pragma unroll
      for (int l = 0; l < REC_G; ++l) xnext[l] = xp_at(l, pn);
    }
    if (g < N) {
#pragma unroll
      for (int k = 0; k < REC_KR; ++k) {
        const float4 hv = hs4[k];
        acc[0] = fmaf(hv.x, wr[k], acc[0]);
        acc[1] = fmaf(hv.y, wr[k], acc[1]);
        acc[2] = fmaf(hv.z, wr[k], acc[2]);
        acc[3] = fmaf(hv.w, wr[k], acc[3]);
      }
      for (int k = REC_KR; k < H; ++k) {
        const float wv = ws[(k - REC_KR) * N + g];
        const float4 hv = hs4[k];
        acc[0] = fmaf(hv.x, wv, acc[0]);
        acc[1] = fmaf(hv.y, wv, acc[1]);
        acc[2] = fmaf(hv.z, wv, acc[2]);
        acc[3] = fmaf(hv.w, wv, acc[3]);
      }
#pragma unroll
      for (int l = 0; l < REC_G; ++l) gs[l * N + g] = acc[l];
    }
    __syncthreads();
    // Phase B: cell update of (line bl, unit bj), gate order i, f, g, o.
    if (b_owner) {
      const float* gl = gs + bl * N;
      const float ig = sigmoidf_(gl[bj]);
      const float fg = sigmoidf_(gl[H + bj]);
      const float gg = tanhf(gl[2 * H + bj]);
      const float og = sigmoidf_(gl[3 * H + bj]);
      c_state = fg * c_state + ig * gg;
      const float h = og * tanhf(c_state);
      hs[bj * REC_G + bl] = h;
      if (b_valid) {
        const long long pos = dir_off + (long long)(line0 + bl) * L + p;
        hout[pos * H + bj] = h;
        if (STASH) {
          // This position's pre-activations were read a step ago (xnext).
          float* gp = xp + pos * N + bj;
          gp[0] = ig;
          gp[H] = fg;
          gp[2 * H] = gg;
          gp[3 * H] = og;
          cout[pos * H + bj] = c_state;
        }
      }
    }
    __syncthreads();
  }
}

template <bool STASH>
cudaError_t launch_rec(float* xp, const float* w_hh, float* hs, float* cs, int n_lines, int L,
                       int H, cudaStream_t stream) {
  const int N = 4 * H;
  const int hrows = H > REC_KR ? H : REC_KR;
  const size_t smem =
      ((size_t)(H > REC_KR ? (H - REC_KR) * N : 0) + hrows * REC_G + REC_G * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gridrnn_rec_kernel<STASH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = ((N > REC_G * H ? N : REC_G * H) + 31) / 32 * 32;
  dim3 grid((n_lines + REC_G - 1) / REC_G, 2);
  gridrnn_rec_kernel<STASH><<<grid, threads, smem, stream>>>(xp, w_hh, hs, cs, n_lines, L, H);
  return cudaGetLastError();
}

// ---- 3. product + overlap-add ----------------------------------------------------
// Block = (line, row tile[, direction]). It computes z = A_d @ B_d for the
// FOLD_BM positions q in [r0 - 3, r0 + FOLD_R) (zero outside [0, L)), then
// out[r] = sum_j z[r - j][tap j] for its FOLD_R output rows. A is
// [2][lines][L][K]; B_d is [K][4C]. SUM adds both directions into out0.
constexpr int FOLD_BM = 64, FOLD_R = FOLD_BM - (KS - 1);
constexpr int FOLD_MAX_C = 64;
constexpr int FOLD_PER_THREAD = (FOLD_R * FOLD_MAX_C + GEMM_THREADS - 1) / GEMM_THREADS;

template <int BN, bool B_K_FAST, bool SUM>
__global__ void __launch_bounds__(GEMM_THREADS)
fold_kernel(const float* __restrict__ A, int K, const float* __restrict__ Bw, long long b_dir,
            int b_kst, int b_nst, float* __restrict__ out0, float* __restrict__ out1, int S,
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
    const float* a = A + ((long long)d * n_lines + line) * L * K;
    auto a_row = [&](int m) -> long long {
      const int q = r0 - (KS - 1) + m;
      return (q >= 0 && q < L) ? (long long)q * K : -1;
    };
    auto a_col = [&](int k) -> long long { return k; };
    auto b_k = [&](int k) -> long long { return d * b_dir + (long long)k * b_kst; };
    auto b_n = [&](int n) -> long long { return n < N ? (long long)n * b_nst : -1; };
    float acc[FOLD_BM / 16][BN / 16];
    gemm_tile<FOLD_BM, BN, B_K_FAST>(K, a, a_row, a_col, Bw, b_k, b_n, acc, smem);
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
      float* out = d == 0 ? out0 : out1;
      for (int e = threadIdx.x; e < FOLD_R * C; e += GEMM_THREADS) {
        const int rl = e / C, c = e % C;
        const int r = r0 + rl;
        if (r >= S) break;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j) v += zs[(rl + KS - 1 - j) * LDZ + j * C + c];
        out[((b * S + r) * P + pc) * C + c] = v;
      }
    }
    __syncthreads();  // zs is the next pass's staging buffer
  }
  if constexpr (SUM) {
#pragma unroll
    for (int i = 0; i < FOLD_PER_THREAD; ++i) {
      const int e = threadIdx.x + i * GEMM_THREADS;
      const int r = r0 + e / C;
      if (e < FOLD_R * C && r < S) out0[((b * S + r) * P + pc) * C + e % C] = sum[i];
    }
  }
}

template <int BN, bool B_K_FAST, bool SUM>
cudaError_t launch_fold_bn(const float* A, int K, const float* Bw, long long b_dir, int b_kst,
                           int b_nst, float* out0, float* out1, int B, int S, int P, int C,
                           cudaStream_t stream) {
  const size_t stage = GemmTile<FOLD_BM, BN>::SMEM_FLOATS;
  const size_t z = (size_t)FOLD_BM * (BN + 1);
  const size_t smem = (stage > z ? stage : z) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fold_kernel<BN, B_K_FAST, SUM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int L = S - (KS - 1);
  const int n_lines = B * P;
  dim3 grid(n_lines, (S + FOLD_R - 1) / FOLD_R, SUM ? 1 : 2);
  fold_kernel<BN, B_K_FAST, SUM><<<grid, GEMM_THREADS, smem, stream>>>(
      A, K, Bw, b_dir, b_kst, b_nst, out0, out1, S, P, C, L, n_lines);
  return cudaGetLastError();
}

template <bool B_K_FAST, bool SUM>
cudaError_t launch_fold(const float* A, int K, const float* Bw, long long b_dir, int b_kst,
                        int b_nst, float* out0, float* out1, int B, int S, int P, int C,
                        cudaStream_t stream) {
  if (KS * C <= 128)
    return launch_fold_bn<128, B_K_FAST, SUM>(A, K, Bw, b_dir, b_kst, b_nst, out0, out1, B, S, P,
                                              C, stream);
  return launch_fold_bn<256, B_K_FAST, SUM>(A, K, Bw, b_dir, b_kst, b_nst, out0, out1, B, S, P, C,
                                            stream);
}

// Shapes every entry takes: 1 <= H <= 128 (4H <= 512 threads), C % 8 == 0,
// C <= 64, at least one window.
inline bool shape_ok(int S, int C, int H) {
  return S - (KS - 1) >= 1 && H >= 1 && 4 * H <= REC_MAX_THREADS && C % 8 == 0 &&
         C <= FOLD_MAX_C;
}

}  // namespace
