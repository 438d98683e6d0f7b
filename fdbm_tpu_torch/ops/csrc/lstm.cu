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
// products, and a step's time is the latency of that chain. At H = 200,
// w_hh is 200 x 800 x 4 B = 640 KB per direction: nearly three times the
// 227 KB of shared memory a block can have, so one block cannot hold it
// (unlike gridrnn_core.cuh's recurrence, 4H <= 512). A block that streams
// the rest from L2 every step waits on L2 latency and two barriers per step
// with a third of the SMs busy. The input projection (x @ w_ih for all
// S x B positions) and the backward's reductions are tiled products over
// all positions at once.
//
// What the design does about it:
//   Forward: dense_kernel computes the pre-activations x @ w_ih + b of
//   every position and direction (tile_gemm.cuh) into device memory; then
//   lstm_rec_kernel runs the recurrence on thread-block clusters: CS blocks
//   (4 at H = 200) share one tile of lines of one direction, each holding
//   the weights of H/CS units (160 KB at CS = 4) in shared memory for the
//   whole sweep and exchanging its slice of h with the others through
//   distributed shared memory, one cluster barrier per step. No weight
//   leaves the chip inside the step loop, the products are register-blocked
//   (a float4 of weights and LINES/4 float4 of state per k, 4 x LINES FMAs),
//   and the wrapper (ops/lstm.py: recurrence_plan) sizes the tile so that
//   the grid is one wave of clusters on the card. With STASH the activated
//   gates overwrite their pre-activations and c is stashed, so the backward
//   reads the gates instead of recomputing them.
//   Backward, in four stages on the current stream:
//   1. lstm_rec_bwd_kernel: the reverse sweep, the forward's recurrence
//      transposed. One block per 8 lines; thread (q, j) sums quarter q of
//      dgates . w_hh[j] for them, w_hh^T (a copy the wrapper makes) partly
//      in shared memory and the rest from L2; thread (line, unit) adds the
//      four quarters and the output cotangent, carries dc, and writes
//      dgates.
//   2. dx = dgates w_ih^T: dense_kernel reading w_ih through strides.
//   3. dW_ih = x^T dgates, dW_hh = h_{s-1}^T dgates, db = sum dgates:
//      reductions over all positions, split into per-block partial sums
//      and added in a fixed order (split_k.cuh). No atomics: two backward
//      calls give the same gradients, bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "split_k.cuh"
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

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
constexpr int LB = 8;                    // lines per block of the reverse sweep
constexpr int REC_MAX_THREADS = 1024;    // the reverse sweep: one thread per gate column
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

// ---- the forward recurrence: a cluster of blocks per tile of lines ------------------
// xp [dirs][S][B][4H] pre-activations (bias included), w_hh [dirs][H][4H] ->
// hout [dirs][S][B][H]. With STASH, xp is overwritten with the activated
// gates (i, f, g, o) of its position and cout [dirs][S][B][H] receives c.
//
// A cluster of CS blocks runs one tile of LINES lines of one direction.
// Block r owns units [r*UC, (r+1)*UC) (UC = ceil(H / CS)) and their four
// gate columns: ws[k][4j + g] = w_hh[k][g*H + r*UC + j], resident for the
// whole sweep, so no weight is read from L2 inside the step loop. Each block
// keeps its own copy of the tile's state h, [2][H][LBP] (double-buffered).
// Per step, lane ks of unit j sums k = ks, ks + 4, ... of the four gates of
// unit j for all LINES lines (a float4 of weights and LINES/4 float4 of h
// per k), a reduce-scatter over the unit's four lanes leaves each lane the
// full gates of LINES/4 lines, and the lane applies their cells (c stays in
// registers) and writes h into the next buffer of every block of the
// cluster (distributed shared memory). One cluster barrier ends the step:
// a block overwrites a buffer only after every block has passed the step
// that read it.
constexpr int RC_KS = 4;                 // lanes splitting one unit's product over k
constexpr int RC_MAX_LINES = 24;         // lines per cluster: a multiple of 4 up to this
constexpr int RC_MAX_THREADS = 256;      // 255 registers a thread: the gates of 24 lines

struct RecPlan {
  int uc;   // units per block
  int wst;  // row stride of ws: 4 * uc padded to 8 (mod 32) floats, so the four
            // lanes of a unit read k rows that fall in other banks
  int lbp;  // row stride of h: lines padded so that lbp / 4 is odd (same reason)
  int nt;   // threads: four lanes per unit, whole warps
  long long bytes;
};

bool rec_plan(int H, int cs, int lines, RecPlan& p) {
  if (H < 1 || (cs != 1 && cs != 2 && cs != 4 && cs != 8)) return false;
  if (lines < 4 || lines > RC_MAX_LINES || lines % 4) return false;
  p.uc = (H + cs - 1) / cs;
  p.wst = 4 * p.uc + (8 - (4 * p.uc) % 32 + 32) % 32;
  p.lbp = (lines / 4) % 2 ? lines : lines + 4;
  p.nt = (p.uc * RC_KS + 31) / 32 * 32;
  p.bytes = 4LL * H * (p.wst + 2LL * p.lbp);
  return p.nt <= RC_MAX_THREADS && p.bytes <= 4LL * SMEM_FLOATS;
}

__device__ __forceinline__ void fma_gates(float (&acc)[4], float h, const float4 w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// grid (CS * tiles, dirs), clusters of CS blocks along x.
template <int LINES, bool STASH>
__global__ void __launch_bounds__(RC_MAX_THREADS, 1)
lstm_rec_kernel(float* __restrict__ xp, const float* __restrict__ w_hh, float* __restrict__ hout,
                float* __restrict__ cout, int S, int B, int H, int uc, int wst, int lbp,
                int rev) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L4 = LINES / 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = 4 * H;
  const int d = blockIdx.y;
  const bool reverse = (d == 1) != (rev != 0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int line0 = (blockIdx.x / cs) * LINES;
  const int u0 = rank * uc;
  float* ws = smem;                         // [H][wst]
  float* hb = ws + (long long)H * wst;      // [2][H][lbp]
  const float* w = w_hh + (long long)d * H * N;
  for (int e = tid; e < H * 4 * uc; e += nt) {
    const int k = e / (4 * uc), g = (e / uc) % 4, j = e % uc;
    ws[k * wst + 4 * j + g] = u0 + j < H ? w[(long long)k * N + g * H + u0 + j] : 0.f;
  }
  for (int e = tid; e < H * lbp; e += nt) hb[e] = 0.f;

  // Lanes past the last unit repeat its product (every lane of a warp takes
  // part in the shuffles) and own nothing.
  const int ks = tid % RC_KS;
  const int j = min(tid / RC_KS, uc - 1);
  const int unit = u0 + tid / RC_KS;
  const bool owner = tid / RC_KS < uc && unit < H;
  const int lq0 = ks * L4;  // this lane's cells: lines lq0 .. lq0 + L4 - 1 of the tile
  const bool hi1 = ks & 2, hi0 = ks & 1;
  float c_state[L4];
#pragma unroll
  for (int q = 0; q < L4; ++q) c_state[q] = 0.f;
  cluster.sync();  // weights and h are in place in every block before any remote write

  for (int s = 0; s < S; ++s) {
    const int p = reverse ? S - 1 - s : s;
    const long long row0 = ((long long)d * S + p) * B + line0 + lq0;  // (d, p, first cell line)
    const float* hcur = hb + (s & 1) * H * lbp;
    float* hnext = hb + ((s + 1) & 1) * H * lbp;
    // This step's pre-activations of the lane's cells, loaded first so that
    // they arrive during the product.
    float xv[L4][4];
#pragma unroll
    for (int q = 0; q < L4; ++q)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xv[q][g] = owner && line0 + lq0 + q < B ? xp[(row0 + q) * N + g * H + unit] : 0.f;
    float acc[LINES][4];
#pragma unroll
    for (int l = 0; l < LINES; ++l)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[l][g] = 0.f;
#pragma unroll 4
    for (int k = ks; k < H; k += RC_KS) {
      const float4 wv = *reinterpret_cast<const float4*>(ws + k * wst + 4 * j);
      const float4* hk = reinterpret_cast<const float4*>(hcur + k * lbp);
#pragma unroll
      for (int l4 = 0; l4 < L4; ++l4) {
        const float4 hv = hk[l4];
        fma_gates(acc[4 * l4], hv.x, wv);
        fma_gates(acc[4 * l4 + 1], hv.y, wv);
        fma_gates(acc[4 * l4 + 2], hv.z, wv);
        fma_gates(acc[4 * l4 + 3], hv.w, wv);
      }
    }
    // Reduce-scatter over the unit's four lanes (xor 2, then xor 1): lane ks
    // keeps the sums of lines ks*L4 .. ks*L4 + L4 - 1 in acc[0 .. L4).
#pragma unroll
    for (int l = 0; l < LINES / 2; ++l)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float lo = acc[l][g], hi = acc[l + LINES / 2][g];
        acc[l][g] = (hi1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, hi1 ? lo : hi, 2);
      }
#pragma unroll
    for (int l = 0; l < L4; ++l)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float lo = acc[l][g], hi = acc[l + L4][g];
        acc[l][g] = (hi0 ? hi : lo) + __shfl_xor_sync(0xffffffffu, hi0 ? lo : hi, 1);
      }
#pragma unroll
    for (int q = 0; q < L4; ++q) {
      const float ig = sigmoidf_(acc[q][0] + xv[q][0]);
      const float fg = sigmoidf_(acc[q][1] + xv[q][1]);
      const float gg = tanhf(acc[q][2] + xv[q][2]);
      const float og = sigmoidf_(acc[q][3] + xv[q][3]);
      const float c = fg * c_state[q] + ig * gg;
      const float h = og * tanhf(c);
      c_state[q] = c;
      if (!owner) continue;
      for (int r = 0; r < cs; ++r) cluster.map_shared_rank(hnext, r)[unit * lbp + lq0 + q] = h;
      if (line0 + lq0 + q < B) {
        const long long pos = row0 + q;
        hout[pos * H + unit] = h;
        if (STASH) {
          float* gp = xp + pos * N + unit;
          gp[0] = ig;
          gp[H] = fg;
          gp[2 * H] = gg;
          gp[3 * H] = og;
          cout[pos * H + unit] = c;
        }
      }
    }
    cluster.sync();
  }
}

using RecKernel = void (*)(float*, const float*, float*, float*, int, int, int, int, int, int,
                           int);

template <bool STASH>
RecKernel rec_kernel(int lines) {
  switch (lines) {
    case 4: return lstm_rec_kernel<4, STASH>;
    case 8: return lstm_rec_kernel<8, STASH>;
    case 12: return lstm_rec_kernel<12, STASH>;
    case 16: return lstm_rec_kernel<16, STASH>;
    case 20: return lstm_rec_kernel<20, STASH>;
    case 24: return lstm_rec_kernel<24, STASH>;
    default: return nullptr;
  }
}

// The launch configuration of (cs, lines) over `tiles` tiles and `dirs`
// directions, with the kernel's shared memory set; false if the plan does
// not fit.
struct RecLaunch {
  RecPlan plan;
  RecKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t rec_launch_config(RecLaunch& L, int H, int cs, int lines, bool stash, int tiles,
                              int dirs, cudaStream_t stream) {
  if (!rec_plan(H, cs, lines, L.plan)) return cudaErrorInvalidValue;
  L.fn = stash ? rec_kernel<true>(lines) : rec_kernel<false>(lines);
  cudaError_t err = cudaFuncSetAttribute(L.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.plan.bytes));
  if (err != cudaSuccess) return err;
  L.cfg = {};
  L.cfg.gridDim = dim3(cs * tiles, dirs);
  L.cfg.blockDim = dim3(L.plan.nt);
  L.cfg.dynamicSmemBytes = L.plan.bytes;
  L.cfg.stream = stream;
  L.attr[0].id = cudaLaunchAttributeClusterDimension;
  L.attr[0].val.clusterDim.x = cs;
  L.attr[0].val.clusterDim.y = 1;
  L.attr[0].val.clusterDim.z = 1;
  L.cfg.attrs = L.attr;
  L.cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool STASH>
cudaError_t launch_rec(float* xp, const float* w_hh, float* hout, float* cout, int S, int B,
                       int H, int dirs, int rev, int cs, int lines, cudaStream_t stream) {
  RecLaunch L;
  cudaError_t err = rec_launch_config(L, H, cs, lines, STASH, (B + lines - 1) / lines, dirs,
                                      stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&L.cfg, L.fn, xp, w_hh, hout, cout, S, B, H, L.plan.uc, L.plan.wst,
                           L.plan.lbp, rev);
  if (err != cudaSuccess) return err;
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
                 float* xp, float* out, int S, int B, int D, int H, int dirs, int rev, int cs,
                 int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H) || dirs < 1 || dirs > 2) return cudaErrorInvalidValue;
  const int N = 4 * H;
  cudaError_t err = dense<false>(x, w_ih, (long long)D * N, N, 1, bias, xp, (long long)S * B, D,
                                 N, dirs, stream);
  if (err != cudaSuccess) return err;
  return launch_rec<false>(xp, w_hh, out, nullptr, S, B, H, dirs, rev, cs, lines, stream);
}

// lstm_core's forward, one direction: h [S][B][H] and the stashes of its
// backward, gates [S][B][4H] (activated i, f, g, o) and c [S][B][H].
int lstm_train_fwd(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                   float* gates, float* h, float* c, int S, int B, int D, int H, int rev,
                   int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H)) return cudaErrorInvalidValue;
  const int N = 4 * H;
  cudaError_t err = dense<false>(x, w_ih, 0, N, 1, bias, gates, (long long)S * B, D, N, 1,
                                 stream);
  if (err != cudaSuccess) return err;
  return launch_rec<true>(gates, w_hh, h, c, S, B, H, 1, rev, cs, lines, stream);
}

// The card's most clusters of the recurrence plan (cs, lines) at width H
// that can run at once (cudaOccupancyMaxActiveClusters), 0 if the plan does
// not fit a block, or minus a CUDA error.
int lstm_rec_max_clusters(int H, int cs, int lines, int stash) {
  RecLaunch L;
  cudaError_t err = rec_launch_config(L, H, cs, lines, stash != 0, 1, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, L.fn, &L.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory of a block of the recurrence plan, or -1 if it does not fit.
long long lstm_rec_smem(int H, int cs, int lines) {
  RecPlan p;
  return rec_plan(H, cs, lines, p) ? p.bytes : -1;
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
