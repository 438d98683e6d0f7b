// TF-GridNet RNN path on the canvas: unfold(k=4) -> BiLSTM -> deconv(k=4)
// -> overlap-add, for both directions, as three kernels.
//
// Replaces fdbm_tpu/ops/gridrnn.py:grid_rnn_seq1_pair (the Pallas
// _canvas_kernel and its _advance_and_fold core), which does the whole path
// per grid cell in VMEM. Shapes: x [B, S, P, C] with the sequence on axis 1
// and P batch-like, so each (b, p) is one independent line of S rows;
// L = S - 3 unfold windows per line; w_ih [2, 4C, 4H] tap-major rows,
// w_hh [2, H, 4H], bias [2, 4H] (gates i, f, g, o), wd [2H, 4C] tap-major
// columns. Returns the unsummed per-direction folds outf, outb [B, S, P, C]
// (no deconv bias), exact on every row; the model reads rows [3, L-1].
//
// What bounds it on the H100: the recurrence. Each of the L steps of a line
// needs the whole previous hidden state, so the 2 * 4H * H fp32 operations
// per line and step are a chain of L dependent matrix-vector products; the
// card's 67 TFLOP/s fp32 would take 0.2 ms for the recurrence of a
// production call, and the time goes instead to per-step latency (shared
// memory reads, two block barriers a step).
//
// What the design does about it:
//   1. gridrnn_proj_kernel takes the input projection, 2/3 of the FLOPs and
//      free of the recurrence, out of the sequential loop: one tiled product
//      for all lines, steps and both directions, reading the k=4 windows
//      straight from the canvas (the unfold never exists in memory).
//   2. gridrnn_rec_kernel runs the recurrence: one block per direction and
//      group of REC_G = 4 lines, one thread per gate column. The first
//      REC_KR rows of the thread's w_hh column live in its registers and the
//      rest in shared memory, so w_hh is read from neither device memory
//      nor L2 inside the loop; the four lines' hidden states are one
//      broadcast float4 read per row. The cell update keeps c in a register
//      of the thread that owns (line, unit). Next step's pre-activations
//      are fetched while this step's products run.
//   3. gridrnn_fold_kernel computes the deconv projection as a tiled
//      product over the hidden states and does the 4-tap overlap-add from
//      shared memory, writing each output row once, in canvas layout.
// The hidden states cross device memory once (2 x lines x L x H floats),
// and so do the pre-activations (2 x lines x L x 4H floats) that the TPU
// kernel recomputes per step in VMEM.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int KS = 4;  // unfold width (emb_ks)

// ---- 1. input projection ---------------------------------------------------
constexpr int PROJ_BM = 128, PROJ_BN = 64;

__global__ void __launch_bounds__(GEMM_THREADS)
gridrnn_proj_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                    const float* __restrict__ bias, float* __restrict__ xp, int S, int P,
                    int C, int L, int H, long long M) {
  __shared__ __align__(16) float smem[GemmTile<PROJ_BM, PROJ_BN>::SMEM_FLOATS];
  const int d = blockIdx.z;
  const int N = 4 * H, K = KS * C;
  const long long m0 = (long long)blockIdx.x * PROJ_BM;
  const int n0 = blockIdx.y * PROJ_BN;
  // Row m of A is window (line, p): taps j at canvas rows p + j.
  auto a_row = [&](int m) -> long long {
    const long long row = m0 + m;
    if (row >= M) return -1;
    const long long line = row / L;
    const long long p = row % L;
    const long long b = line / P, pc = line % P;
    return ((b * S + p) * P + pc) * C;
  };
  auto a_col = [&](int k) -> long long { return (long long)(k / C) * P * C + k % C; };
  auto b_k = [&](int k) -> long long { return ((long long)d * K + k) * N; };
  auto b_n = [&](int n) -> long long { return (n0 + n < N) ? n0 + n : -1; };
  float acc[PROJ_BM / 16][PROJ_BN / 16];
  gemm_tile<PROJ_BM, PROJ_BN, false>(K, x, a_row, a_col, w_ih, b_k, b_n, acc, smem);
#pragma unroll
  for (int i = 0; i < PROJ_BM / 16; ++i) {
    const long long row = m0 + tile_row<PROJ_BM, PROJ_BN>(i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < PROJ_BN / 16; ++j) {
      const int n = n0 + tile_col(j);
      if (n < N) xp[((long long)d * M + row) * N + n] = acc[i][j] + bias[d * N + n];
    }
  }
}

// ---- 2. recurrence -----------------------------------------------------------
constexpr int REC_G = 4;    // lines per block (one float4 of hidden state per row)
constexpr int REC_KR = 64;  // w_hh rows held in registers
constexpr int REC_MAX_THREADS = 512;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// xp [2][lines][L][4H] pre-activations (bias included), hout [2][lines][L][H].
// Shared memory: w_hh rows >= REC_KR [H-REC_KR][4H], hidden state
// [max(H, REC_KR)][REC_G] (rows >= H stay 0), gates [REC_G][4H].
__global__ void __launch_bounds__(REC_MAX_THREADS, 1)
gridrnn_rec_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                   float* __restrict__ hout, int n_lines, int L, int H) {
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
      if (b_valid) hout[((dir_off + (long long)(line0 + bl) * L) + p) * H + bj] = h;
    }
    __syncthreads();
  }
}

// ---- 3. deconv projection + overlap-add ----------------------------------------
// Block = (line, row tile, direction). It computes z = h @ wd_dir for the
// FOLD_BM positions q in [r0 - 3, r0 + FOLD_R) (zero outside [0, L)), then
// out[r] = sum_j z[r - j][tap j] for its FOLD_R output rows.
constexpr int FOLD_BM = 64, FOLD_R = FOLD_BM - (KS - 1);

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS)
gridrnn_fold_kernel(const float* __restrict__ hs, const float* __restrict__ wd,
                    float* __restrict__ outf, float* __restrict__ outb, int S, int P, int C,
                    int L, int H, int n_lines) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.z;
  const long long line = blockIdx.x;
  const int r0 = blockIdx.y * FOLD_R;
  const int N = KS * C;
  const float* h = hs + ((long long)d * n_lines + line) * L * H;
  auto a_row = [&](int m) -> long long {
    const int q = r0 - (KS - 1) + m;
    return (q >= 0 && q < L) ? (long long)q * H : -1;
  };
  auto a_col = [&](int k) -> long long { return k; };
  auto b_k = [&](int k) -> long long { return ((long long)d * H + k) * N; };
  auto b_n = [&](int n) -> long long { return n < N ? n : -1; };
  float acc[FOLD_BM / 16][BN / 16];
  gemm_tile<FOLD_BM, BN, false>(H, h, a_row, a_col, wd, b_k, b_n, acc, smem);

  constexpr int LDZ = BN + 1;
  float* zs = smem;  // [FOLD_BM][LDZ], reuses the staging buffers
#pragma unroll
  for (int i = 0; i < FOLD_BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      zs[tile_row<FOLD_BM, BN>(i) * LDZ + tile_col(j)] = acc[i][j];
  __syncthreads();

  float* out = d == 0 ? outf : outb;
  const long long b = line / P, pc = line % P;
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

template <int BN>
size_t fold_smem_bytes() {
  const size_t stage = GemmTile<FOLD_BM, BN>::SMEM_FLOATS;
  const size_t z = (size_t)FOLD_BM * (BN + 1);
  return (stage > z ? stage : z) * sizeof(float);
}

template <int BN>
cudaError_t launch_fold(const float* hs, const float* wd, float* outf, float* outb, int B, int S,
                        int P, int C, int L, int H, cudaStream_t stream) {
  const size_t smem = fold_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(gridrnn_fold_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_lines = B * P;
  dim3 grid(n_lines, (S + FOLD_R - 1) / FOLD_R, 2);
  gridrnn_fold_kernel<BN><<<grid, GEMM_THREADS, smem, stream>>>(hs, wd, outf, outb, S, P, C, L,
                                                                H, n_lines);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the caller allocates: xp [2, B*P, L, 4H] and hs [2, B*P, L, H],
// L = S - 3. Requires 1 <= H <= 128, 4H <= 512 threads, C % 8 == 0,
// C <= 64, all pointers fp32, contiguous, on the stream's device.
int gridrnn_seq1_pair(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                      const float* wd, float* xp, float* hs, float* outf, float* outb, int B,
                      int S, int P, int C, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int L = S - (KS - 1);
  if (L < 1 || H < 1 || 4 * H > REC_MAX_THREADS || C % 8 != 0 || C > 64)
    return cudaErrorInvalidValue;
  const int n_lines = B * P;
  const long long M = (long long)n_lines * L;

  dim3 pgrid((unsigned)((M + PROJ_BM - 1) / PROJ_BM), (4 * H + PROJ_BN - 1) / PROJ_BN, 2);
  gridrnn_proj_kernel<<<pgrid, GEMM_THREADS, 0, stream>>>(x, w_ih, bias, xp, S, P, C, L, H, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int N = 4 * H;
  const int hrows = H > REC_KR ? H : REC_KR;
  const size_t rec_smem =
      ((size_t)(H > REC_KR ? (H - REC_KR) * N : 0) + hrows * REC_G + REC_G * N) * sizeof(float);
  err = cudaFuncSetAttribute(gridrnn_rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rec_smem);
  if (err != cudaSuccess) return err;
  const int threads = ((N > REC_G * H ? N : REC_G * H) + 31) / 32 * 32;
  dim3 rgrid((n_lines + REC_G - 1) / REC_G, 2);
  gridrnn_rec_kernel<<<rgrid, threads, rec_smem, stream>>>(xp, w_hh, hs, n_lines, L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (KS * C <= 128) return launch_fold<128>(hs, wd, outf, outb, B, S, P, C, L, H, stream);
  return launch_fold<256>(hs, wd, outf, outb, B, S, P, C, L, H, stream);
}

}  // extern "C"
