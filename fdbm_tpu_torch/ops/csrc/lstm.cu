// Single-layer LSTM directions over sequence-major inputs x [S, B, D]: the
// recurrences of TF-GridNet's generic RNN path, which runs where the fused
// grid kernels (gridrnn_core.cuh) do not reach (C > 64 or H > 128).
//
// Replaces four Pallas kernels of the JAX package (fdbm_tpu/ops/lstm.py):
//   bilstm_fused_forward (:537, _bilstm_fused_kernel): both directions,
//     forward only, the backward one zero-initialised at the last frame;
//   lstm_core's forward (:298, _lstm_kernel_train): one direction, with
//     the stashes its backward needs;
//   lstm_core's backward (:354 _lstm_core_bwd, _lstm_bwd_kernel): the
//     reverse sweep, dx and the gradients of w_ih, w_hh and the bias;
//   lstm_forward_pallas (:108, _lstm_kernel): one direction, forward only.
// Gate order i, f, g, o; fp32 throughout, the carry included. Per-position
// tensors are [dirs][S][B][width], position-major; direction d runs back to
// front iff (d == 1) != rev, and its outputs stay in time order.
//
// What bounds it on the H100: the recurrence. Each step of a line needs the
// whole previous state, so the S steps are a chain of [lines, H] x [H, 4H]
// products. At H = 200, w_hh is 200 x 800 x 4 B = 640 KB per direction:
// nearly three times the 227 KB of shared memory a block can have, so unlike
// gridrnn_core.cuh's recurrence (4H <= 512, w_hh on one SM) it cannot stay
// on chip, and every block re-reads most of it from L2 every step. The
// recurrence is L2-bandwidth-bound: per step, blocks x (H - R) rows x 16H
// bytes, R the rows that do fit in shared memory. The input projection
// (x @ w_ih for all S x B positions) and the backward's reductions are
// tiled products over all positions at once.
//
// What the design does about it:
//   Forward: dense_kernel computes the pre-activations x @ w_ih + b of
//   every position and direction (tile_gemm.cuh) into device memory; then
//   lstm_rec_kernel runs the recurrence, one block per direction and LB = 8
//   lines (so each step's w_hh stream serves 8 lines; 262 lines and two
//   directions make 66 blocks), one thread per gate column. Thread t sums
//   h[l] . w_hh[:, t] for the block's 8 lines: the first R rows of w_hh
//   from shared memory (as many as fit beside the state), the rest read
//   straight from L2, 8 rows in flight per thread; the 8 lines' states are
//   two broadcast float4 reads per row. Then thread (line, unit) applies
//   the cell. With STASH the activated gates overwrite their
//   pre-activations and c is stashed, so the backward reads the gates
//   instead of recomputing them.
//   Backward, in four stages on the current stream:
//   1. lstm_rec_bwd_kernel: the reverse sweep, the forward's recurrence
//      transposed. Thread (q, j) sums quarter q of dgates . w_hh[j] for
//      the block's 8 lines, w_hh^T (a copy the wrapper makes) partly in
//      shared memory and the rest from L2; thread (line, unit) adds the
//      four quarters and the output cotangent, carries dc, and writes
//      dgates.
//   2. dx = dgates w_ih^T: dense_kernel reading w_ih through strides.
//   3. dW_ih = x^T dgates, dW_hh = h_{s-1}^T dgates, db = sum dgates:
//      reductions over all positions, split into per-block partial sums
//      and added in a fixed order (split_k.cuh). No atomics: two backward
//      calls give the same gradients, bit for bit.
#include <cuda_runtime.h>

#include "split_k.cuh"
#include "tile_gemm.cuh"

namespace {

// ---- dense products ------------------------------------------------------------
// out[d][m][n] = sum_k A[m][k] B_d[k][n] (+ bias[d][n]) with A [M][K] row-major
// (shared by the directions) and B_d[k][n] = Bw[d*b_dir + k*b_kst + n*b_nst]:
// the input projection (B = w_ih, K = D) and dx (B = w_ih^T through strides).
constexpr int DN_BM = 128, DN_BN = 64;

template <bool B_K_FAST>
__global__ void __launch_bounds__(GEMM_THREADS)
dense_kernel(const float* __restrict__ A, const float* __restrict__ Bw, long long b_dir,
             int b_kst, int b_nst, const float* __restrict__ bias, float* __restrict__ out,
             long long M, int K, int N) {
  __shared__ __align__(16) float smem[GemmTile<DN_BM, DN_BN>::SMEM_FLOATS];
  const int d = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * DN_BM;
  const int n0 = blockIdx.y * DN_BN;
  auto a_row = [&](int m) -> long long { return m0 + m < M ? (m0 + m) * K : -1; };
  auto a_col = [&](int k) -> long long { return k; };
  auto b_k = [&](int k) -> long long { return d * b_dir + (long long)k * b_kst; };
  auto b_n = [&](int n) -> long long { return n0 + n < N ? (long long)(n0 + n) * b_nst : -1; };
  float acc[DN_BM / 16][DN_BN / 16];
  gemm_tile<DN_BM, DN_BN, B_K_FAST>(K, A, a_row, a_col, Bw, b_k, b_n, acc, smem);
#pragma unroll
  for (int i = 0; i < DN_BM / 16; ++i) {
    const long long row = m0 + tile_row<DN_BM, DN_BN>(i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < DN_BN / 16; ++j) {
      const int n = n0 + tile_col(j);
      if (n < N) out[((long long)d * M + row) * N + n] = acc[i][j] + (bias ? bias[d * N + n] : 0.f);
    }
  }
}

template <bool B_K_FAST>
cudaError_t dense(const float* A, const float* Bw, long long b_dir, int b_kst, int b_nst,
                  const float* bias, float* out, long long M, int K, int N, int dirs,
                  cudaStream_t stream) {
  dim3 grid((unsigned)((M + DN_BM - 1) / DN_BM), (N + DN_BN - 1) / DN_BN, dirs);
  dense_kernel<B_K_FAST><<<grid, GEMM_THREADS, 0, stream>>>(A, Bw, b_dir, b_kst, b_nst, bias,
                                                            out, M, K, N);
  return cudaGetLastError();
}

// ---- recurrences ---------------------------------------------------------------------
constexpr int LB = 8;                    // lines per block: two float4 of state per row
constexpr int REC_MAX_THREADS = 1024;    // one thread per gate column: 4H <= 1024
constexpr int SMEM_FLOATS = 232448 / 4;  // a block's shared memory on the H100 (227 KB)

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void fma8(float (&acc)[LB], float w, const float4* st, int k) {
  const float4 a = st[2 * k], b = st[2 * k + 1];
  acc[0] = fmaf(a.x, w, acc[0]);
  acc[1] = fmaf(a.y, w, acc[1]);
  acc[2] = fmaf(a.z, w, acc[2]);
  acc[3] = fmaf(a.w, w, acc[3]);
  acc[4] = fmaf(b.x, w, acc[4]);
  acc[5] = fmaf(b.y, w, acc[5]);
  acc[6] = fmaf(b.z, w, acc[6]);
  acc[7] = fmaf(b.w, w, acc[7]);
}

// acc[l] += sum_{k < H} st[k][l] * w_k for the LB lines, with w_k = ws[k*N + t]
// for k < R (shared memory) and wg[k * w_st] beyond (L2).
__device__ __forceinline__ void rec_matvec(float (&acc)[LB], const float* ws, int R, int N,
                                           int t, const float* __restrict__ wg, int w_st,
                                           int H, const float4* st) {
#pragma unroll 4
  for (int k = 0; k < R; ++k) fma8(acc, ws[k * N + t], st, k);
#pragma unroll 8
  for (int k = R; k < H; ++k) fma8(acc, __ldg(wg + (long long)k * w_st), st, k);
}

// Rows of w_hh (or of w_hh^T's quarters) that fit in shared memory beside
// `other` floats.
int rec_rows(int H, int other) {
  const int rows = (SMEM_FLOATS - other) / (4 * H);
  return rows < H ? rows : H;
}

int rec_threads(int H) { return (4 * H + 31) / 32 * 32; }

// xp [dirs][S][B][4H] pre-activations (bias included), w_hh [dirs][H][4H] ->
// hout [dirs][S][B][H]. With STASH, xp is overwritten with the activated
// gates (i, f, g, o) of its position and cout [dirs][S][B][H] receives c.
// Block = (tile of LB lines, direction). Shared memory: w_hh rows < R
// [R][4H], the state h [H][LB], the gates [LB][4H]. Thread t < 4H owns gate
// column t; thread t also owns the cell pairs e = t and t + blockDim (line
// e / H, unit e % H): blockDim >= 4H makes that all LB * H pairs.
template <bool STASH>
__global__ void __launch_bounds__(REC_MAX_THREADS, 1)
lstm_rec_kernel(float* __restrict__ xp, const float* __restrict__ w_hh, float* __restrict__ hout,
                float* __restrict__ cout, int S, int B, int H, int R, int rev) {
  extern __shared__ __align__(16) float smem[];
  const int N = 4 * H;
  const int d = blockIdx.y;
  const bool reverse = (d == 1) != (rev != 0);
  const int t = threadIdx.x;
  float* ws = smem;         // [R][N]
  float* hs = ws + R * N;   // [H][LB]
  float* gs = hs + H * LB;  // [LB][N]
  const float* w = w_hh + (long long)d * H * N;
  for (int e = t; e < R * N; e += blockDim.x) ws[e] = w[e];
  for (int e = t; e < H * LB; e += blockDim.x) hs[e] = 0.f;
  const int line0 = blockIdx.x * LB;
  float c_state[2] = {0.f, 0.f};
  __syncthreads();

  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  for (int s = 0; s < S; ++s) {
    const int p = reverse ? S - 1 - s : s;
    const long long row0 = ((long long)d * S + p) * B + line0;  // (d, p, line0)
    if (t < N) {
      // This step's pre-activations, loaded first so that they arrive
      // during the product.
      float xv[LB], acc[LB];
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        xv[l] = line0 + l < B ? xp[(row0 + l) * N + t] : 0.f;
        acc[l] = 0.f;
      }
      rec_matvec(acc, ws, R, N, t, w + t, N, H, hs4);
#pragma unroll
      for (int l = 0; l < LB; ++l) gs[l * N + t] = acc[l] + xv[l];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = t + i * blockDim.x;
      if (e >= LB * H) break;
      const int l = e / H, j = e % H;
      const float* gl = gs + l * N;
      const float ig = sigmoidf_(gl[j]);
      const float fg = sigmoidf_(gl[H + j]);
      const float gg = tanhf(gl[2 * H + j]);
      const float og = sigmoidf_(gl[3 * H + j]);
      const float c = fg * c_state[i] + ig * gg;
      const float h = og * tanhf(c);
      c_state[i] = c;
      hs[j * LB + l] = h;
      if (line0 + l < B) {
        const long long pos = row0 + l;
        hout[pos * H + j] = h;
        if (STASH) {
          // This position's pre-activations were read before the barrier.
          float* gp = xp + pos * N + j;
          gp[0] = ig;
          gp[H] = fg;
          gp[2 * H] = gg;
          gp[3 * H] = og;
          cout[pos * H + j] = c;
        }
      }
    }
    __syncthreads();
  }
}

template <bool STASH>
cudaError_t launch_rec(float* xp, const float* w_hh, float* hout, float* cout, int S, int B,
                       int H, int dirs, int rev, cudaStream_t stream) {
  const int N = 4 * H;
  const int other = H * LB + LB * N;
  const int R = rec_rows(H, other);
  const size_t smem = (size_t)(R * N + other) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_rec_kernel<STASH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + LB - 1) / LB, dirs);
  lstm_rec_kernel<STASH><<<grid, rec_threads(H), smem, stream>>>(xp, w_hh, hout, cout, S, B, H,
                                                                 R, rev);
  return cudaGetLastError();
}

// The reverse sweep of one direction (reversed iff rev). gates [S][B][4H]
// activated (i, f, g, o), cs [S][B][H] cell states, dout [S][B][H] the
// cotangent of h, w_t [4H][H] = w_hh^T -> dgates [S][B][4H], the gradient
// of the pre-activations. Steps run from the forward's last to its first.
// Shared memory: ws[k][t] = w_t[q*H + k][j] for k < R (t = q*H + j), the
// previous step's dgates [4H][LB], the quarter sums [LB][4H].
__global__ void __launch_bounds__(REC_MAX_THREADS, 1)
lstm_rec_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                    const float* __restrict__ dout, const float* __restrict__ w_t,
                    float* __restrict__ dgates, int S, int B, int H, int R, int rev) {
  extern __shared__ __align__(16) float smem[];
  const int N = 4 * H;
  const int t = threadIdx.x;
  const int q = t / H, j = t % H;  // phase A: quarter q of dgates . w_hh[j]
  float* ws = smem;          // [R][N]
  float* dgs = ws + R * N;   // [N][LB]
  float* part = dgs + N * LB;  // [LB][N]
  for (int e = t; e < R * N; e += blockDim.x) {
    const int k = e / N, tt = e % N;
    ws[e] = w_t[((long long)(tt / H) * H + k) * H + tt % H];
  }
  for (int e = t; e < N * LB; e += blockDim.x) dgs[e] = 0.f;
  const int line0 = blockIdx.x * LB;
  float dc_carry[2] = {0.f, 0.f};
  __syncthreads();

  const float4* dgs4 = reinterpret_cast<const float4*>(dgs);
  for (int s = 0; s < S; ++s) {
    const int p = rev ? s : S - 1 - s;
    const int pp = rev ? p + 1 : p - 1;  // the position whose state step p consumed
    const bool has_prev = pp >= 0 && pp < S;
    // Phase B's inputs for this step, loaded first so that they arrive
    // during the product.
    float gv[2][4], cc[2], cp[2], dh[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = t + i * blockDim.x;
      const int l = e / H, jj = e % H;
      const bool valid = e < LB * H && line0 + l < B;
      const long long pos = (long long)p * B + line0 + l;
#pragma unroll
      for (int u = 0; u < 4; ++u) gv[i][u] = valid ? gates[pos * N + u * H + jj] : 0.f;
      cc[i] = valid ? cs[pos * H + jj] : 0.f;
      cp[i] = valid && has_prev ? cs[((long long)pp * B + line0 + l) * H + jj] : 0.f;
      dh[i] = valid ? dout[pos * H + jj] : 0.f;
    }
    // Phase A: the previous step's dgates times w_hh^T, quarter q.
    if (t < N) {
      float acc[LB];
#pragma unroll
      for (int l = 0; l < LB; ++l) acc[l] = 0.f;
      rec_matvec(acc, ws, R, N, t, w_t + (long long)q * H * H + j, H, H, dgs4 + 2 * q * H);
#pragma unroll
      for (int l = 0; l < LB; ++l) part[l * N + t] = acc[l];
    }
    __syncthreads();
    // Phase B: the cell's backward for (line l, unit jj).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = t + i * blockDim.x;
      if (e >= LB * H) break;
      const int l = e / H, jj = e % H;
      const float* pl = part + l * N + jj;
      const float dhv = dh[i] + pl[0] + pl[H] + pl[2 * H] + pl[3 * H];
      const float ig = gv[i][0], fg = gv[i][1], gg = gv[i][2], og = gv[i][3];
      const float tc = tanhf(cc[i]);
      const float dc = dhv * og * (1.f - tc * tc) + dc_carry[i];
      const float dg[4] = {dc * gg * ig * (1.f - ig), dc * cp[i] * fg * (1.f - fg),
                           dc * ig * (1.f - gg * gg), dhv * tc * og * (1.f - og)};
      dc_carry[i] = dc * fg;
#pragma unroll
      for (int u = 0; u < 4; ++u) dgs[(u * H + jj) * LB + l] = dg[u];
      if (line0 + l < B) {
        float* out = dgates + ((long long)p * B + line0 + l) * N + jj;
#pragma unroll
        for (int u = 0; u < 4; ++u) out[u * H] = dg[u];
      }
    }
    __syncthreads();
  }
}

cudaError_t launch_rec_bwd(const float* gates, const float* cs, const float* dout,
                           const float* w_t, float* dgates, int S, int B, int H, int rev,
                           cudaStream_t stream) {
  const int N = 4 * H;
  const int other = 2 * N * LB;
  const int R = rec_rows(H, other);
  const size_t smem = (size_t)(R * N + other) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_rec_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_rec_bwd_kernel<<<(B + LB - 1) / LB, rec_threads(H), smem, stream>>>(
      gates, cs, dout, w_t, dgates, S, B, H, R, rev);
  return cudaGetLastError();
}

// ---- weight gradients: split reductions over the S x B positions ----------------------
// out[m][n] = sum_kk A(kk)[m] dgates[kk][n] over positions kk = p * B + b:
// W_IH: A(kk) = x[kk] (M = D); W_HH: A(kk) = h at the position step kk
// consumed (M = H; zero at the direction's first step). Block (m tile,
// n tile, split sp) writes partial[sp][M][N].
enum LstmWGrad { WG_IH, WG_HH };

template <LstmWGrad KIND>
__global__ void __launch_bounds__(GEMM_THREADS)
lstm_wgrad_kernel(const float* __restrict__ A, const float* __restrict__ dgates,
                  float* __restrict__ partial, long long NL, int B, int M, int N, int rev,
                  int depth) {
  __shared__ __align__(16) float smem[GemmTile<WG_BM, WG_BN>::SMEM_FLOATS];
  const int sp = blockIdx.z;
  const long long k_begin = (long long)sp * depth;
  const int K = (int)(NL - k_begin < depth ? NL - k_begin : depth);
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  auto a_row = [&](int m) -> long long { return m0 + m < M ? m0 + m : -1; };
  auto a_col = [&](int k) -> long long {
    long long kk = k_begin + k;
    if (KIND == WG_HH) {
      kk = rev ? kk + B : kk - B;
      if (kk < 0 || kk >= NL) return -1;
    }
    return kk * M;
  };
  auto b_k = [&](int k) -> long long { return (k_begin + k) * N; };
  auto b_n = [&](int n) -> long long { return n0 + n < N ? n0 + n : -1; };
  float acc[WG_BM / 16][WG_BN / 16];
  gemm_tile<WG_BM, WG_BN, false>(K, A, a_row, a_col, dgates, b_k, b_n, acc, smem);
  float* out = partial + (long long)sp * M * N;
#pragma unroll
  for (int i = 0; i < WG_BM / 16; ++i) {
    const int m = m0 + tile_row<WG_BM, WG_BN>(i);
    if (m >= M) continue;
#pragma unroll
    for (int jn = 0; jn < WG_BN / 16; ++jn) {
      const int n = n0 + tile_col(jn);
      if (n < N) out[(long long)m * N + n] = acc[i][jn];
    }
  }
}

template <LstmWGrad KIND>
cudaError_t lstm_wgrad(const float* A, const float* dgates, float* work, float* out, long long NL,
                       int B, int M, int N, int rev, cudaStream_t stream) {
  const int splits = wgrad_splits(NL, tiles_of(M, N), 1);
  dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, splits);
  lstm_wgrad_kernel<KIND><<<grid, GEMM_THREADS, 0, stream>>>(A, dgates, work, NL, B, M, N, rev,
                                                             split_depth(NL, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(work, out, (long long)M * N, splits, stream);
}

// Shapes every entry takes: at least one step, line and input feature, and
// 4H <= 1024 (one thread per gate column).
inline bool shape_ok(int S, int B, int D, int H) {
  return S >= 1 && B >= 1 && D >= 1 && H >= 1 && 4 * H <= REC_MAX_THREADS;
}

}  // namespace

extern "C" {

// Forward only: out [dirs][S][B][H]; scratch xp [dirs][S][B][4H].
// dirs = 2 (bilstm_fused_forward): w_ih [2][D][4H], w_hh [2][H][4H],
// bias [2][4H], direction 1 reversed. dirs = 1 (lstm_forward): one
// direction, reversed iff rev.
int lstm_forward(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                 float* xp, float* out, int S, int B, int D, int H, int dirs, int rev,
                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H) || dirs < 1 || dirs > 2) return cudaErrorInvalidValue;
  const int N = 4 * H;
  cudaError_t err = dense<false>(x, w_ih, (long long)D * N, N, 1, bias, xp, (long long)S * B, D,
                                 N, dirs, stream);
  if (err != cudaSuccess) return err;
  return launch_rec<false>(xp, w_hh, out, nullptr, S, B, H, dirs, rev, stream);
}

// lstm_core's forward, one direction: h [S][B][H] and the stashes of its
// backward, gates [S][B][4H] (activated i, f, g, o) and c [S][B][H].
int lstm_train_fwd(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                   float* gates, float* h, float* c, int S, int B, int D, int H, int rev,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H)) return cudaErrorInvalidValue;
  const int N = 4 * H;
  cudaError_t err = dense<false>(x, w_ih, 0, N, 1, bias, gates, (long long)S * B, D, N, 1,
                                 stream);
  if (err != cudaSuccess) return err;
  return launch_rec<true>(gates, w_hh, h, c, S, B, H, 1, rev, stream);
}

// Floats of the backward's reduction workspace.
long long lstm_train_bwd_workspace(int S, int B, int D, int H) {
  const long long NL = (long long)S * B;
  const long long a = wgrad_floats(NL, D, 4 * H, 1);
  const long long b = wgrad_floats(NL, H, 4 * H, 1);
  const long long c = column_sum_floats(NL, 4 * H, 1);
  const long long ab = a > b ? a : b;
  return ab > c ? ab : c;
}

// lstm_core's backward. Inputs: x [S][B][D], the forward's h, c and gates,
// the cotangent dout [S][B][H] of h, w_ih [D][4H], w_t = w_hh^T [4H][H].
// Scratch: dgates [S][B][4H], work (workspace floats). Outputs: dx [S][B][D],
// dw_ih [D][4H], dw_hh [H][4H], db [4H].
int lstm_train_bwd(const float* x, const float* h, const float* c, const float* gates,
                   const float* dout, const float* w_ih, const float* w_t, float* dgates,
                   float* work, float* dx, float* dw_ih, float* dw_hh, float* db, int S, int B,
                   int D, int H, int rev, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H)) return cudaErrorInvalidValue;
  const int N = 4 * H;
  const long long NL = (long long)S * B;
  cudaError_t err = launch_rec_bwd(gates, c, dout, w_t, dgates, S, B, H, rev, stream);
  if (err != cudaSuccess) return err;
  // dx[m][n] = sum_k dgates[m][k] w_ih[n][k]
  err = dense<true>(dgates, w_ih, 0, 1, N, nullptr, dx, NL, N, D, 1, stream);
  if (err != cudaSuccess) return err;
  err = lstm_wgrad<WG_IH>(x, dgates, work, dw_ih, NL, B, D, N, rev, stream);
  if (err != cudaSuccess) return err;
  err = lstm_wgrad<WG_HH>(h, dgates, work, dw_hh, NL, B, H, N, rev, stream);
  if (err != cudaSuccess) return err;
  return column_sums(dgates, work, db, NL, N, 1, stream);
}

}  // extern "C"
