// TF-GridNet RNN path on sequence-major lines, for training: the forward
// with the stashes the backward needs, its backward, and the forward alone.
//
// Replaces three Pallas kernels of the JAX package:
//   grid_bilstm_fold (fdbm_tpu/ops/gridrnn.py:217, _grid_kernel): the
//     summed fold, no stashes (the valid loss, under no gradient);
//   grid_fold_train_pair's forward (fdbm_tpu/ops/gridrnn_train.py:217
//     _fwd_call, _fwd_kernel): the per-direction folds plus stashes;
//   its backward (gridrnn_train.py:508 _bwd_call, _bwd_kernel,
//     _bwd_dir_sweep): dx and the gradients of w_ih, w_hh, bias and wd.
// Shapes: x [S, lines, C] (the canvas of gridrnn_core.cuh with B = 1,
// P = lines), L = S - 3, w_ih [2, 4C, 4H], w_hh [2, H, 4H], bias [2, 4H],
// wd [2H, 4C]; per-position tensors [2][lines][L][width]. Every row of the
// outputs is exact, and the backward is the gradient of the ideal
// unfold -> BiLSTM -> deconv -> fold for any cotangent (the JAX kernels
// are exact on rows [3, L-1], which is all the model reads).
//
// What bounds it on the H100: the two recurrences. Each of the L steps of a
// line needs the whole previous state, so per line and step the forward's
// 4H x H and the backward's 4H x H products form chains of L dependent
// matrix-vector products, and their time is per-step latency (shared
// memory reads, two block barriers a step), not FLOPs. Everything else is
// tiled products over all lines and steps at once.
//
// What the design does about it:
//   Forward: the three stages of gridrnn_core.cuh. The TPU kernel stashes
//   h_{s-1} and c_{s-1} and has its backward recompute the gates in one
//   batched product per chunk. Here the pre-activations already cross
//   device memory (the projection is its own kernel), so the recurrence
//   writes the activated gates back over them in place and stashes c; the
//   backward reads the gates instead of recomputing them (2 x lines x L x
//   4H floats kept per call: about 0.44 GB at B=2, 256 frames, 10 calls a
//   step, which 80 GB holds) and takes h_{s-1} from the hidden states the
//   fold already needed.
//   Backward, in five stages, all on the current stream:
//   1. dh from the deconv: window_proj_kernel on the windows of each
//      direction's output cotangent (the fold's transpose) times wd^T.
//   2. gridrnn_rec_bwd_kernel: the reverse sweep of each direction, the
//      forward's recurrence transposed. One block per direction and 4
//      lines; thread (q, j) keeps w_hh[j][qH .. qH+H) (64 values in
//      registers, the rest in shared memory) and sums a quarter of
//      dgates . w_hh[j]; thread (line, j) adds the four quarters, does the
//      cell's backward in registers (dc carried), and writes dgates.
//   3. dx: fold_kernel on dgates times w_ih^T (the unfold's transpose),
//      both directions summed into one write of each row.
//   4. dW_ih = windows^T dgates, dW_hh = h_{s-1}^T dgates,
//      dW_deconv = h^T windows(dout), dbias = sum dgates: reductions over
//      lines x L, each a tiled product split over the reduction axis into
//      partial sums per block (wgrad_kernel, bias_kernel),
//   5. then summed over the splits in a fixed order (reduce_kernel). No
//      atomics: the gradients are the same from run to run.
#include "gridrnn_core.cuh"

namespace {

// ---- backward recurrence ---------------------------------------------------------
// gates [2][lines][L][4H] activated (i, f, g, o), cs [2][lines][L][H] cell
// states, dhd [2][lines][L][H] gradient of h from the deconv, w_hh [2][H][4H]
// -> dgates [2][lines][L][4H] (gradient of the pre-activations).
// Shared memory: w_hh quarters rows >= REC_KR [H-REC_KR][4H], the previous
// step's dgates [4H + REC_KR][REC_G] (rows >= 4H stay 0), quarter sums
// [4H][REC_G].
__global__ void __launch_bounds__(REC_MAX_THREADS, 1)
gridrnn_rec_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                       const float* __restrict__ dhd, const float* __restrict__ w_hh,
                       float* __restrict__ dgates, int n_lines, int L, int H) {
  extern __shared__ __align__(16) float smem[];
  const int N = 4 * H;
  const int d = blockIdx.y;
  const int t = threadIdx.x;
  float* ws = smem;                                         // [(H - KR) * N]
  float* dgs = ws + (H > REC_KR ? (H - REC_KR) * N : 0);    // [(N + KR) * G]
  float* part = dgs + (N + REC_KR) * REC_G;                 // [N * G]
  const float* w = w_hh + (long long)d * H * N;

  // Phase A ownership: thread -> (quarter q, unit j); it sums
  // dgates[qH + k] * w_hh[j][qH + k] over k < H.
  const int q = t / H, j = t % H;
  const bool a_owner = t < N;
  float wr[REC_KR];
#pragma unroll
  for (int k = 0; k < REC_KR; ++k)
    wr[k] = (a_owner && k < H) ? w[(long long)j * N + q * H + k] : 0.f;
  for (int e = t; e < (H - REC_KR) * N; e += blockDim.x) {
    const int k = REC_KR + e / N, tt = e % N;
    ws[e] = w[(long long)(tt % H) * N + (tt / H) * H + k];
  }
  for (int e = t; e < (N + REC_KR) * REC_G; e += blockDim.x) dgs[e] = 0.f;

  const int line0 = blockIdx.x * REC_G;
  // Phase B ownership: thread -> (line bl, hidden unit bj).
  const int bl = t / H, bj = t % H;
  const bool b_owner = t < REC_G * H;
  const bool b_valid = b_owner && line0 + bl < n_lines;
  const long long base = ((long long)d * n_lines + line0 + bl) * L;  // position 0 of the line
  // Processing order: the reverse of the forward's, so the state a step
  // consumed (its "previous") belongs to the step processed next.
  auto pos = [&](int s) -> int { return d == 0 ? L - 1 - s : s; };
  float gv[4], dh_in = 0.f, c_cur = 0.f, c_prev = 0.f, dc_carry = 0.f;
  auto load_step = [&](int s, float (&g)[4], float& dh) {
    const long long o = base + pos(s);
#pragma unroll
    for (int u = 0; u < 4; ++u) g[u] = b_valid ? gates[o * N + u * H + bj] : 0.f;
    dh = b_valid ? dhd[o * H + bj] : 0.f;
  };
  auto load_c = [&](int s) -> float {
    return (b_valid && s < L) ? cs[(base + pos(s)) * H + bj] : 0.f;
  };
  load_step(0, gv, dh_in);
  c_cur = load_c(0);
  c_prev = load_c(1);
  __syncthreads();

  const float4* dgs4 = reinterpret_cast<const float4*>(dgs);
  float4* part4 = reinterpret_cast<float4*>(part);
  for (int s = 0; s < L; ++s) {
    // Next step's inputs, fetched while this step's products run.
    float gn[4] = {0.f, 0.f, 0.f, 0.f}, dhn = 0.f;
    if (s + 1 < L) load_step(s + 1, gn, dhn);
    const float c_next_prev = load_c(s + 2);
    // Phase A: quarter sums of the previous step's dgates . w_hh[j].
    if (a_owner) {
      float acc[REC_G] = {0.f, 0.f, 0.f, 0.f};
      const float4* dq = dgs4 + q * H;
#pragma unroll
      for (int k = 0; k < REC_KR; ++k) {
        const float4 gv4 = dq[k];
        acc[0] = fmaf(gv4.x, wr[k], acc[0]);
        acc[1] = fmaf(gv4.y, wr[k], acc[1]);
        acc[2] = fmaf(gv4.z, wr[k], acc[2]);
        acc[3] = fmaf(gv4.w, wr[k], acc[3]);
      }
      for (int k = REC_KR; k < H; ++k) {
        const float wv = ws[(k - REC_KR) * N + t];
        const float4 gv4 = dq[k];
        acc[0] = fmaf(gv4.x, wv, acc[0]);
        acc[1] = fmaf(gv4.y, wv, acc[1]);
        acc[2] = fmaf(gv4.z, wv, acc[2]);
        acc[3] = fmaf(gv4.w, wv, acc[3]);
      }
      part4[t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    // Phase B: the cell's backward for (line bl, unit bj).
    if (b_owner) {
      float dh = dh_in;
#pragma unroll
      for (int u = 0; u < 4; ++u) dh += part[(u * H + bj) * REC_G + bl];
      const float ig = gv[0], fg = gv[1], gg = gv[2], og = gv[3];
      const float tc = tanhf(c_cur);
      const float dc = dh * og * (1.f - tc * tc) + dc_carry;
      const float dgi = dc * gg * ig * (1.f - ig);
      const float dgf = dc * c_prev * fg * (1.f - fg);
      const float dgg = dc * ig * (1.f - gg * gg);
      const float dgo = dh * tc * og * (1.f - og);
      dc_carry = dc * fg;
      dgs[(0 * H + bj) * REC_G + bl] = dgi;
      dgs[(1 * H + bj) * REC_G + bl] = dgf;
      dgs[(2 * H + bj) * REC_G + bl] = dgg;
      dgs[(3 * H + bj) * REC_G + bl] = dgo;
      if (b_valid) {
        float* out = dgates + (base + pos(s)) * N + bj;
        out[0] = dgi;
        out[H] = dgf;
        out[2 * H] = dgg;
        out[3 * H] = dgo;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) gv[u] = gn[u];
    dh_in = dhn;
    c_cur = c_prev;
    c_prev = c_next_prev;
    __syncthreads();
  }
}

cudaError_t launch_rec_bwd(const float* gates, const float* cs, const float* dhd,
                           const float* w_hh, float* dgates, int n_lines, int L, int H,
                           cudaStream_t stream) {
  const int N = 4 * H;
  const size_t smem = ((size_t)(H > REC_KR ? (H - REC_KR) * N : 0) + (N + REC_KR) * REC_G +
                       (size_t)N * REC_G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gridrnn_rec_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = ((N > REC_G * H ? N : REC_G * H) + 31) / 32 * 32;
  dim3 grid((n_lines + REC_G - 1) / REC_G, 2);
  gridrnn_rec_bwd_kernel<<<grid, threads, smem, stream>>>(gates, cs, dhd, w_hh, dgates, n_lines,
                                                          L, H);
  return cudaGetLastError();
}

// ---- weight gradients: split reductions over lines x L ------------------------------
// out[d][m][n] = sum_kk A_d[m][kk] B_d[kk][n] over kk = line * L + l. Block
// (m tile, n tile, d * splits + sp) sums kk in [sp * depth, (sp+1) * depth)
// into partial[sp][d][M][N].
constexpr int WG_BM = 128, WG_BN = 64;
enum WGrad { W_IH, W_HH, W_DECONV };

template <WGrad KIND>
__global__ void __launch_bounds__(GEMM_THREADS)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dout0,
             const float* __restrict__ dout1, const float* __restrict__ hs,
             const float* __restrict__ dgates, float* __restrict__ partial, int n_lines, int L,
             int C, int H, int M, int N, int splits, int depth) {
  __shared__ __align__(16) float smem[GemmTile<WG_BM, WG_BN>::SMEM_FLOATS];
  const int d = blockIdx.z / splits, sp = blockIdx.z % splits;
  const long long NL = (long long)n_lines * L;
  const long long k_begin = (long long)sp * depth;
  const int K = (int)((NL - k_begin < depth) ? NL - k_begin : depth);
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int G4 = 4 * H;
  // kk -> (line, l)
  auto line_of = [&](int k) { return (k_begin + k) / L; };
  auto l_of = [&](int k) { return (int)((k_begin + k) % L); };
  auto in_m = [&](int m) { return m0 + m < M; };
  auto in_n = [&](int n) { return n0 + n < N; };
  float acc[WG_BM / 16][WG_BN / 16];
  if constexpr (KIND == W_IH) {
    // A[m][kk] = window of x at (line, l), feature m = (tap, c); B = dgates.
    auto a_row = [&](int m) -> long long {
      const int mm = m0 + m;
      return in_m(m) ? (long long)(mm / C) * n_lines * C + mm % C : -1;
    };
    auto a_col = [&](int k) -> long long {
      return ((long long)l_of(k) * n_lines + line_of(k)) * C;
    };
    auto b_k = [&](int k) -> long long { return ((long long)d * NL + k_begin + k) * G4; };
    auto b_n = [&](int n) -> long long { return in_n(n) ? n0 + n : -1; };
    gemm_tile<WG_BM, WG_BN, false>(K, x, a_row, a_col, dgates, b_k, b_n, acc, smem);
  } else if constexpr (KIND == W_HH) {
    // A[m][kk] = h_{s-1}[m]: the state the step at (line, l) consumed,
    // zero at the direction's first step; B = dgates.
    auto a_row = [&](int m) -> long long { return in_m(m) ? m0 + m : -1; };
    auto a_col = [&](int k) -> long long {
      const int lp = d == 0 ? l_of(k) - 1 : l_of(k) + 1;
      if (lp < 0 || lp >= L) return -1;
      return (((long long)d * n_lines + line_of(k)) * L + lp) * H;
    };
    auto b_k = [&](int k) -> long long { return ((long long)d * NL + k_begin + k) * G4; };
    auto b_n = [&](int n) -> long long { return in_n(n) ? n0 + n : -1; };
    gemm_tile<WG_BM, WG_BN, false>(K, hs, a_row, a_col, dgates, b_k, b_n, acc, smem);
  } else {
    // A[m][kk] = h[m] at (line, l); B[kk][n] = window of the output
    // cotangent at (line, l), n = (tap, c).
    auto a_row = [&](int m) -> long long { return in_m(m) ? m0 + m : -1; };
    auto a_col = [&](int k) -> long long { return ((long long)d * NL + k_begin + k) * H; };
    auto b_k = [&](int k) -> long long {
      return ((long long)l_of(k) * n_lines + line_of(k)) * C;
    };
    auto b_n = [&](int n) -> long long {
      const int nn = n0 + n;
      return in_n(n) ? (long long)(nn / C) * n_lines * C + nn % C : -1;
    };
    gemm_tile<WG_BM, WG_BN, false>(K, hs, a_row, a_col, d == 0 ? dout0 : dout1, b_k, b_n, acc,
                                   smem);
  }
  float* out = partial + ((long long)sp * 2 + d) * M * N;
#pragma unroll
  for (int i = 0; i < WG_BM / 16; ++i) {
    const int m = m0 + tile_row<WG_BM, WG_BN>(i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < WG_BN / 16; ++j) {
      const int n = n0 + tile_col(j);
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

// partial[sp][d][4H] = column sums of dgates[d] over its split of lines x L.
__global__ void __launch_bounds__(GEMM_THREADS)
bias_kernel(const float* __restrict__ dgates, float* __restrict__ partial, long long NL, int N,
            int splits, int depth) {
  const int d = blockIdx.y / splits, sp = blockIdx.y % splits;
  const int n = blockIdx.x * GEMM_THREADS + threadIdx.x;
  if (n >= N) return;
  const long long k0 = (long long)sp * depth;
  const long long k1 = k0 + depth < NL ? k0 + depth : NL;
  const float* g = dgates + (long long)d * NL * N + n;
  float acc = 0.f;
  for (long long k = k0; k < k1; ++k) acc += g[k * N];
  partial[((long long)sp * 2 + d) * N + n] = acc;
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

constexpr int SMS = 132;     // H100 SXM streaming multiprocessors
constexpr int MIN_DEPTH = 512;

// Splits of the lines x L reduction for a product with `tiles` output tiles
// per direction: about 8 blocks per SM over both directions, each split at
// least MIN_DEPTH deep.
int wgrad_splits(long long NL, long long tiles) {
  long long by_blocks = (8LL * SMS + 2 * tiles - 1) / (2 * tiles);
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

cudaError_t reduce(const float* partial, float* out, long long n, int splits,
                   cudaStream_t stream) {
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n, splits);
  return cudaGetLastError();
}

template <WGrad KIND>
cudaError_t wgrad(const float* x, const float* dout0, const float* dout1, const float* hs,
                  const float* dgates, float* work, float* out, int n_lines, int L, int C, int H,
                  int M, int N, cudaStream_t stream) {
  const long long NL = (long long)n_lines * L;
  const int splits = wgrad_splits(NL, tiles_of(M, N));
  const int depth = split_depth(NL, splits);
  dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, 2 * splits);
  wgrad_kernel<KIND><<<grid, GEMM_THREADS, 0, stream>>>(x, dout0, dout1, hs, dgates, work,
                                                        n_lines, L, C, H, M, N, splits, depth);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(work, out, 2LL * M * N, splits, stream);
}

long long wgrad_floats(long long NL, int M, int N) {
  return (long long)wgrad_splits(NL, tiles_of(M, N)) * 2 * M * N;
}

}  // namespace

extern "C" {

// grid_bilstm_fold: out [S, lines, C] = outf + outb, no deconv bias.
// Scratch: xp [2, lines, L, 4H], hs [2, lines, L, H].
int grid_bilstm_fold(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                     const float* wd, float* xp, float* hs, float* out, int S, int n_lines, int C,
                     int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int L = S - (KS - 1);
  const int N = 4 * H;
  cudaError_t err = launch_window_proj<false>(x, x, w_ih, (long long)KS * C * N, N, 1, bias, xp,
                                              1, S, n_lines, C, N, stream);
  if (err != cudaSuccess) return err;
  err = launch_rec<false>(xp, w_hh, hs, nullptr, n_lines, L, H, stream);
  if (err != cudaSuccess) return err;
  return launch_fold<false, true>(hs, H, wd, (long long)H * KS * C, KS * C, 1, out, nullptr, 1, S,
                                  n_lines, C, stream);
}

// Training forward: outf, outb [S, lines, C]; stashes for the backward:
// gates [2, lines, L, 4H] (activated i, f, g, o), hs and cs [2, lines, L, H].
int grid_fold_train_fwd(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                        const float* wd, float* gates, float* hs, float* cs, float* outf,
                        float* outb, int S, int n_lines, int C, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int L = S - (KS - 1);
  const int N = 4 * H;
  cudaError_t err = launch_window_proj<false>(x, x, w_ih, (long long)KS * C * N, N, 1, bias,
                                              gates, 1, S, n_lines, C, N, stream);
  if (err != cudaSuccess) return err;
  err = launch_rec<true>(gates, w_hh, hs, cs, n_lines, L, H, stream);
  if (err != cudaSuccess) return err;
  return launch_fold<false, false>(hs, H, wd, (long long)H * KS * C, KS * C, 1, outf, outb, 1, S,
                                   n_lines, C, stream);
}

// Floats of the backward's reduction workspace.
long long grid_fold_train_bwd_workspace(int S, int n_lines, int C, int H) {
  const long long NL = (long long)n_lines * (S - (KS - 1));
  const long long a = wgrad_floats(NL, KS * C, 4 * H);
  const long long b = wgrad_floats(NL, H, 4 * H);
  const long long c = wgrad_floats(NL, H, KS * C);
  const long long e = (long long)wgrad_splits(NL, 1) * 2 * 4 * H;
  const long long ab = a > b ? a : b, ce = c > e ? c : e;
  return ab > ce ? ab : ce;
}

// Training backward. Inputs: x and the output cotangents doutf, doutb
// [S, lines, C], the forward's stashes, the weights. Scratch: dhd
// [2, lines, L, H], dgates [2, lines, L, 4H], work (workspace floats).
// Outputs: dx [S, lines, C], dw_ih [2, 4C, 4H], dw_hh [2, H, 4H],
// dbias [2, 4H], dwd [2H, 4C].
int grid_fold_train_bwd(const float* x, const float* doutf, const float* doutb,
                        const float* gates, const float* hs, const float* cs, const float* w_ih,
                        const float* w_hh, const float* wd, float* dhd, float* dgates, float* work,
                        float* dx, float* dw_ih, float* dw_hh, float* dbias, float* dwd, int S,
                        int n_lines, int C, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int L = S - (KS - 1);
  const int N = 4 * H;
  const long long NL = (long long)n_lines * L;
  // 1. dh from the deconv: windows of dout_d times wd_d^T.
  cudaError_t err = launch_window_proj<true>(doutf, doutb, wd, (long long)H * KS * C, 1, KS * C,
                                             nullptr, dhd, 1, S, n_lines, C, H, stream);
  if (err != cudaSuccess) return err;
  // 2. reverse sweeps -> dgates.
  err = launch_rec_bwd(gates, cs, dhd, w_hh, dgates, n_lines, L, H, stream);
  if (err != cudaSuccess) return err;
  // 3. dx: the unfold's transpose, dgates times w_ih_d^T folded, both
  // directions summed.
  err = launch_fold<true, true>(dgates, N, w_ih, (long long)KS * C * N, 1, N, dx, nullptr, 1, S,
                                n_lines, C, stream);
  if (err != cudaSuccess) return err;
  // 4-5. weight gradients, one after another through the workspace.
  err = wgrad<W_IH>(x, doutf, doutb, hs, dgates, work, dw_ih, n_lines, L, C, H, KS * C, N,
                    stream);
  if (err != cudaSuccess) return err;
  err = wgrad<W_HH>(x, doutf, doutb, hs, dgates, work, dw_hh, n_lines, L, C, H, H, N, stream);
  if (err != cudaSuccess) return err;
  err = wgrad<W_DECONV>(x, doutf, doutb, hs, dgates, work, dwd, n_lines, L, C, H, H, KS * C,
                        stream);
  if (err != cudaSuccess) return err;
  const int splits = wgrad_splits(NL, 1);
  dim3 bgrid((N + GEMM_THREADS - 1) / GEMM_THREADS, 2 * splits);
  bias_kernel<<<bgrid, GEMM_THREADS, 0, stream>>>(dgates, work, NL, N, splits,
                                                  split_depth(NL, splits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(work, dbias, 2LL * N, splits, stream);
}

}  // extern "C"
