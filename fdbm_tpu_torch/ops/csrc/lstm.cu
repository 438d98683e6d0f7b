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
// products (and, in the backward, [lines, 4H] x [4H, H]), and a step's time
// is the latency of that chain. At H = 200, w_hh is 200 x 800 x 4 B = 640 KB
// per direction: nearly three times the 227 KB of shared memory a block can
// have, so one block cannot hold it (unlike gridrnn.cu's recurrence). The
// input projection (x @ w_ih for all S x B positions), dx and the weight
// gradients are products over all positions at once, bound by the fp32
// FMA rate of the CUDA cores (no TF32: tile_gemm.cuh).
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
//   Backward, in three stages on the current stream:
//   1. lstm_sweep_kernel: the reverse sweep on the forward's clusters,
//      transposed. Each block holds the forward's slice of w_hh (its units'
//      gate columns, staged n-major from w_hh itself: no transposed copy in
//      device memory) and computes its part of dh_prev for every unit from
//      its own dgates columns; a reduce-scatter through distributed shared
//      memory hands each part to the unit's owner; after one cluster
//      barrier each block runs its cells' backward (the stashes loaded
//      during the product) and writes dgates, and one block barrier hands
//      the new dgates to the next step's product. The wrapper
//      (ops/lstm.py: sweep_plan) sizes the tile to one wave.
//   2. dx = dgates w_ih^T: lstm_dx_kernel on simt_gemm.cuh, both operands
//      read as they lie (8 x 8 per thread, a three-stage cp.async ring).
//   3. dW_ih, dW_hh and db as one product over [x | h_{s-1} | 1] against
//      dgates (lstm_wgrad_kernel on simt_gemm.cuh: 8 x 8 per thread, a
//      four-stage cp.async ring), so dgates is read once for all three;
//      split over positions into per-block partial sums added in a fixed
//      order (split_k.cuh). No atomics anywhere: two backward calls give
//      the same gradients, bit for bit.
//
// The bf16 form of bilstm_fused_forward (lstm_forward_bf16; the JAX kernel's
// bf16 io, fdbm_tpu/ops/lstm.py:500-521,548): x and the hidden states are
// bf16 in device memory, w_ih and w_hh are rounded to bf16 as they are
// staged, h is rounded to bf16 before it enters the next step's product, and
// the pre-activations (xp, scratch in device memory, as the TPU kernel keeps
// them in VMEM), the bias, c and the gates stay fp32. Both of its products
// run on the tensor cores (mma.sync m16n8k16, mma_bf16.cuh).
//   What bounds it on the H100: the recurrence's chain, as in fp32; its
//   products (85 GFLOP at the main path's shape, x [260, 263, 192], H = 200,
//   both directions) take 87 us at 989 TFLOP/s, and the projection's fp32
//   pre-activations (438 MB written and read) 0.26 ms at 3.35 TB/s.
//   Projection (dense_mma_kernel): persistent blocks, each holding one
//   160-column tile of a direction's w_ih for the whole depth, rounded to
//   bf16 as it is staged ([k][n], read by ldmatrix.trans), and walking the
//   rows' 128-row (or 64-row) tiles, the next x tile staged by 16-byte
//   cp.async while the current one is multiplied; the bias is added in the
//   epilogue, which writes the fp32 pre-activations.
//   Recurrence (lstm_mma_kernel): kernel 1's bf16 design without the window:
//   a cluster of CS blocks takes a tile of 16 or 32 lines of one direction,
//   block r the gate columns of units [r*uc, (r+1)*uc) of w_hh, rounded to
//   bf16 and swizzled for ldmatrix (at H = 200, 320 KB a direction: 160 KB a
//   block at CS = 2, 80 KB at CS = 4), resident for the whole sweep, in the
//   column order of gridrnn_mma_kernel (a quad of units is two n8 tiles,
//   (i, f) then (g, o)), so that one lane's accumulators hold all four gates
//   of its cells and the cell runs in registers, c in fp32. h, rounded to
//   bf16, goes into the next step's swizzled h tile of every block of the
//   cluster (distributed shared memory), from which the next step loads its
//   A fragments; one cluster barrier a step, split: a lane loads its cells'
//   next pre-activations between the arrive and the wait. The plan (CS,
//   lines) is one wave of clusters on the card (ops/lstm.py:
//   recurrence_mma_plan, which mirrors lstm_mma_plan).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma_bf16.cuh"
#include "simt_gemm.cuh"
#include "split_k.cuh"
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- the input projection --------------------------------------------------------
// out[d][m][n] = sum_k A[m][k] W_d[k][n] + bias[d][n] with A [M][K] row-major
// (shared by the directions) and W_d = W + d * w_dir, [K][N] row-major.
constexpr int DN_BM = 128, DN_BN = 64;

__global__ void __launch_bounds__(GEMM_THREADS)
dense_kernel(const float* __restrict__ A, const float* __restrict__ W, long long w_dir,
             const float* __restrict__ bias, float* __restrict__ out, long long M, int K,
             int N) {
  __shared__ __align__(16) float smem[GemmTile<DN_BM, DN_BN>::SMEM_FLOATS];
  const int d = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * DN_BM;
  const int n0 = blockIdx.y * DN_BN;
  auto a_row = [&](int m) -> long long { return m0 + m < M ? (m0 + m) * K : -1; };
  auto a_col = [&](int k) -> long long { return k; };
  auto b_k = [&](int k) -> long long { return d * w_dir + (long long)k * N; };
  auto b_n = [&](int n) -> long long { return n0 + n < N ? n0 + n : -1; };
  float acc[DN_BM / 16][DN_BN / 16];
  gemm_tile<DN_BM, DN_BN, false>(K, A, a_row, a_col, W, b_k, b_n, acc, smem);
#pragma unroll
  for (int i = 0; i < DN_BM / 16; ++i) {
    const long long row = m0 + tile_row<DN_BM, DN_BN>(i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < DN_BN / 16; ++j) {
      const int n = n0 + tile_col(j);
      if (n < N) out[((long long)d * M + row) * N + n] = acc[i][j] + bias[d * N + n];
    }
  }
}

cudaError_t dense(const float* A, const float* W, long long w_dir, const float* bias, float* out,
                  long long M, int K, int N, int dirs, cudaStream_t stream) {
  dim3 grid((unsigned)((M + DN_BM - 1) / DN_BM), (N + DN_BN - 1) / DN_BN, dirs);
  dense_kernel<<<grid, GEMM_THREADS, 0, stream>>>(A, W, w_dir, bias, out, M, K, N);
  return cudaGetLastError();
}

// ---- recurrences ---------------------------------------------------------------------
constexpr int SMEM_FLOATS = 232448 / 4;  // a block's shared memory on the H100 (227 KB)

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// ---- the forward recurrence: a cluster of blocks per tile of lines ------------------
// xp [dirs][S][B][4H] pre-activations (bias included), w_hh [dirs][H][4H] ->
// hout [dirs][S][B][H]. With STASH, xp is
// overwritten with the activated gates (i, f, g, o) of its position and cout
// [dirs][S][B][H] receives c.
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
    ws[k * wst + 4 * j + g] =
        u0 + j < H ? w[(long long)k * N + g * H + u0 + j] : 0.f;
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

// ---- the reverse sweep: the forward's clusters, transposed ----------------------------
// gates [S][B][4H] activated (i, f, g, o), cst [S][B][H] cell states, dout
// [S][B][H] the cotangent of h, w_hh [H][4H] -> dgates [S][B][4H], the
// gradient of the pre-activations. Steps run from the forward's last
// position to its first (front to back iff rev).
//
// A cluster of CS blocks runs one tile of LINES lines. Block r owns units
// J_r = [r*uc, (r+1)*uc) and their gate columns G_r, the forward's slice,
// and holds it for the whole sweep n-major, wt[n][k] = w_hh[k][G_r(n)]
// (n = 4j + g), staged once from w_hh itself. Per step:
//   1. product: the block's part of dh_prev, part[l][k] = sum over n in G_r
//      of dg[l][n] w_hh[k][n], for every unit k and line l, from its own
//      dgates columns of the previous step (dgs [LINES][4uc], in shared
//      memory). Lane ks of group kq sums the n quads ks, ks + 4, ... for
//      units 4kq .. 4kq + 3 and all LINES lines (per quad four float4 of
//      weights and one float4 of dgates per line, 16 x LINES FMAs); a
//      reduce-scatter of shuffles over the group's four lanes leaves each
//      lane the sums of LINES/4 lines;
//   2. reduce-scatter across the cluster: each sum goes to the receive tile
//      of its unit's owner, recv [2][CS][LINES][uc] (distributed shared
//      memory, double-buffered);
//   3. one cluster barrier;
//   4. the cell: thread (line, unit) adds dout and the CS parts in rank
//      order, runs the cell's backward with dc carried in a register (its
//      gates, c_prev and dout were copied into shared memory by cp.async
//      during the product, off the chain; c is the c_prev of the step
//      before), and writes dgates to device memory and to dgs;
//   5. one block barrier: dgs is read by every lane of the block.
// Nothing is summed with atomics, so two calls give the same bits.
// Cells (line, unit) per thread: at most LINES / 4 + 1 (5 of 6 at H = 200,
// CS = 4, 20 lines), so that their carried state fits in registers.
__host__ __device__ constexpr int sweep_cells(int lines) { return lines / 4 + 1; }
constexpr int SW_STASH = 6;  // floats of a cell's stash per step: 4 gates, c_prev, dout

struct SweepPlan {
  int uc;       // units per block
  int ncol;     // gate columns per block, 4 * uc
  int kp;       // units padded to whole float4: the row length of wt
  int kgroups;  // groups of four units of the product, kp / 4
  int nt;       // threads: four lanes per group, whole warps
  long long bytes;
};

bool sweep_plan(int H, int cs, int lines, SweepPlan& p) {
  if (H < 1 || (cs != 1 && cs != 2 && cs != 4 && cs != 8)) return false;
  if (lines < 4 || lines > RC_MAX_LINES || lines % 4) return false;
  p.uc = (H + cs - 1) / cs;
  p.ncol = 4 * p.uc;
  p.kgroups = (H + 3) / 4;
  p.kp = 4 * p.kgroups;
  p.nt = (p.kgroups * RC_KS + 31) / 32 * 32;
  p.bytes = 4LL * ((long long)p.ncol * p.kp + (long long)lines * p.ncol +
                   (2LL * cs + SW_STASH) * lines * p.uc);
  const int cells = (lines * p.uc + p.nt - 1) / p.nt;
  return p.nt <= RC_MAX_THREADS && cells <= sweep_cells(lines) && p.bytes <= 4LL * SMEM_FLOATS;
}

// grid (CS * tiles), clusters of CS blocks along x.
template <int LINES>
__global__ void __launch_bounds__(RC_MAX_THREADS, 1)
lstm_sweep_kernel(const float* __restrict__ gates, const float* __restrict__ cst,
                  const float* __restrict__ dout, const float* __restrict__ w_hh,
                  float* __restrict__ dgates, int S, int B, int H, int rev, int uc, int kp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L4 = LINES / 4, CELLS = sweep_cells(LINES);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = 4 * H, ncol = 4 * uc, kgroups = kp / 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int line0 = (blockIdx.x / cs) * LINES;
  const int u0 = rank * uc;
  float* wt = smem;                            // [ncol][kp]
  float* dgs = wt + ncol * kp;                 // [LINES][ncol]
  float* recv = dgs + LINES * ncol;            // [2][cs][LINES][uc]
  float* stash = recv + 2 * cs * LINES * uc;   // [SW_STASH][LINES][uc]
  for (int e = tid; e < ncol * kp; e += nt) {
    const int n = e / kp, k = e % kp, u = u0 + n / 4;
    wt[e] = k < H && u < H ? w_hh[(long long)k * N + (n % 4) * H + u] : 0.f;
  }
  for (int e = tid; e < LINES * ncol; e += nt) dgs[e] = 0.f;

  // Product lanes: group kq (units 4kq .. 4kq + 3), lane ks of its four.
  // Lanes past the last group repeat its product and own nothing.
  const int ks = tid % RC_KS;
  const int kq = min(tid / RC_KS, kgroups - 1);
  const bool sender = tid / RC_KS < kgroups;
  const bool hi1 = ks & 2, hi0 = ks & 1;
  float* dst[4];  // the receive tile of each of the lane's units' owners
  int dst_col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = min(4 * kq + i, H - 1), owner = k / uc;
    dst[i] = cluster.map_shared_rank(recv, owner) + rank * LINES * uc;
    dst_col[i] = k - owner * uc;
  }
  // Cell threads: cell i of this thread is (line e / uc, unit e % uc), e =
  // tid + i * nt. c of a step's position is the c_prev copied a step
  // earlier (cv), so a step copies c only at the position before it.
  float dc_carry[CELLS], cv[CELLS];
  bool cell_ok[CELLS];
  int off_h[CELLS], off_g[CELLS];  // the cell's offsets in a position's [B][H] and [B][4H]
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const int e = tid + i * nt;
    const int l = e / uc, u = u0 + e % uc;
    cell_ok[i] = e < LINES * uc && line0 + l < B && u < H;
    off_h[i] = (line0 + l) * H + u;
    off_g[i] = (line0 + l) * N + u;
    dc_carry[i] = 0.f;
    cv[i] = cell_ok[i] ? cst[(long long)(rev ? 0 : S - 1) * B * H + off_h[i]] : 0.f;
  }
  cluster.sync();  // weights and dgs in place in every block before any remote write

  for (int s = 0; s < S; ++s) {
    const int p = rev ? s : S - 1 - s;
    const int pp = rev ? p + 1 : p - 1;  // the position whose state step p consumed
    const bool has_prev = pp >= 0 && pp < S;
    // The cells' stashes for this step, loaded first so that they arrive
    // during the product.
    const float* gates_p = gates + (long long)p * B * N;
    const float* dout_p = dout + (long long)p * B * H;
    const float* c_pp = cst + (long long)pp * B * H;
    // Each thread copies its own cells' stashes (so it alone reads them).
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * nt;
      if (e >= LINES * uc) break;
      const bool ok = cell_ok[i];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        cp_async_to<4>(stash + g * LINES * uc + e, ok ? gates_p + off_g[i] + g * H : gates, ok);
      cp_async_to<4>(stash + 4 * LINES * uc + e, ok && has_prev ? c_pp + off_h[i] : cst,
                     ok && has_prev);
      cp_async_to<4>(stash + 5 * LINES * uc + e, ok ? dout_p + off_h[i] : dout, ok);
    }
    cp_async_commit_group();
    // 1. The block's part of dh_prev.
    float acc[LINES][4];
#pragma unroll
    for (int l = 0; l < LINES; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[l][i] = 0.f;
#pragma unroll 2
    for (int nq = ks; nq < uc; nq += RC_KS) {
      const float* wq = wt + 4 * nq * kp + 4 * kq;
      const float4 w0 = *reinterpret_cast<const float4*>(wq);
      const float4 w1 = *reinterpret_cast<const float4*>(wq + kp);
      const float4 w2 = *reinterpret_cast<const float4*>(wq + 2 * kp);
      const float4 w3 = *reinterpret_cast<const float4*>(wq + 3 * kp);
#pragma unroll
      for (int l = 0; l < LINES; ++l) {
        const float4 dv = *reinterpret_cast<const float4*>(dgs + l * ncol + 4 * nq);
        fma_gates(acc[l], dv.x, w0);
        fma_gates(acc[l], dv.y, w1);
        fma_gates(acc[l], dv.z, w2);
        fma_gates(acc[l], dv.w, w3);
      }
    }
    // Reduce-scatter over the group's four lanes (xor 2, then xor 1): lane
    // ks keeps the sums of lines ks*L4 .. ks*L4 + L4 - 1 in acc[0 .. L4).
#pragma unroll
    for (int l = 0; l < LINES / 2; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = acc[l][i], hi = acc[l + LINES / 2][i];
        acc[l][i] = (hi1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, hi1 ? lo : hi, 2);
      }
#pragma unroll
    for (int l = 0; l < L4; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = acc[l][i], hi = acc[l + L4][i];
        acc[l][i] = (hi0 ? hi : lo) + __shfl_xor_sync(0xffffffffu, hi0 ? lo : hi, 1);
      }
    // 2. Each sum to its unit's owner.
    const int buf = (s & 1) * cs * LINES * uc;
    if (sender) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * kq + i >= H) break;
#pragma unroll
        for (int q = 0; q < L4; ++q) dst[i][buf + (ks * L4 + q) * uc + dst_col[i]] = acc[q][i];
      }
    }
    // 3.
    cluster.sync();
    // 4. The cells' backward.
    const float* rv = recv + buf;
    cp_async_wait_groups<0>();
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * nt;
      if (e >= LINES * uc) break;
      const int l = e / uc, j = e % uc;
      float dhv = stash[5 * LINES * uc + e];
      for (int r = 0; r < cs; ++r) dhv += rv[(r * LINES + l) * uc + j];
      const float ig = stash[e], fg = stash[LINES * uc + e], gg = stash[2 * LINES * uc + e],
                  og = stash[3 * LINES * uc + e], cp = stash[4 * LINES * uc + e];
      const float tc = tanhf(cv[i]);
      const float dc = dhv * og * (1.f - tc * tc) + dc_carry[i];
      float4 dg = make_float4(dc * gg * ig * (1.f - ig), dc * cp * fg * (1.f - fg),
                              dc * ig * (1.f - gg * gg), dhv * tc * og * (1.f - og));
      dc_carry[i] = dc * fg;
      cv[i] = cp;
      if (!cell_ok[i]) dg = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dgs + l * ncol + 4 * j) = dg;
      if (cell_ok[i]) {
        float* out = dgates + (long long)p * B * N + off_g[i];
        out[0] = dg.x;
        out[H] = dg.y;
        out[2 * H] = dg.z;
        out[3 * H] = dg.w;
      }
    }
    // 5.
    __syncthreads();
  }
}

using SweepKernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                             int, int, int, int, int);

SweepKernel sweep_kernel(int lines) {
  switch (lines) {
    case 4: return lstm_sweep_kernel<4>;
    case 8: return lstm_sweep_kernel<8>;
    case 12: return lstm_sweep_kernel<12>;
    case 16: return lstm_sweep_kernel<16>;
    case 20: return lstm_sweep_kernel<20>;
    case 24: return lstm_sweep_kernel<24>;
    default: return nullptr;
  }
}

struct SweepLaunch {
  SweepPlan plan;
  SweepKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t sweep_launch_config(SweepLaunch& L, int H, int cs, int lines, int tiles,
                                cudaStream_t stream) {
  if (!sweep_plan(H, cs, lines, L.plan)) return cudaErrorInvalidValue;
  L.fn = sweep_kernel(lines);
  cudaError_t err = cudaFuncSetAttribute(L.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.plan.bytes));
  if (err != cudaSuccess) return err;
  L.cfg = {};
  L.cfg.gridDim = dim3(cs * tiles);
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

cudaError_t launch_sweep(const float* gates, const float* cst, const float* dout,
                         const float* w_hh, float* dgates, int S, int B, int H, int rev, int cs,
                         int lines, cudaStream_t stream) {
  SweepLaunch L;
  cudaError_t err = sweep_launch_config(L, H, cs, lines, (B + lines - 1) / lines, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&L.cfg, L.fn, gates, cst, dout, w_hh, dgates, S, B, H, rev, L.plan.uc,
                           L.plan.kp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- the weight gradients: one product over [x | h_prev | 1] -------------------------
// dwg[m][n] = sum over positions kk of A(kk)[m] dgates[kk][n], with A(kk) =
// x[kk] (m < D), the h that step kk consumed (D <= m < D + H; zero at the
// direction's first step) and 1 (m = D + H: the column sums, db). One pass
// over dgates gives dW_ih, dW_hh and db. Split over positions, block
// (m tile, n tile, split) writes partial[split][D + H + 1][4H]; the splits
// are then added in a fixed order (split_k.cuh: reduce).
using WgTile = SimtTile<200, 160, 16, 4>;  // M = 392 + 1 rows in 2 tiles at D = 192, H = 200

template <bool VEC>
__global__ void __launch_bounds__(WgTile::THREADS, 1)
lstm_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ h,
                  const float* __restrict__ dgates, float* __restrict__ partial, long long NL,
                  int B, int D, int H, int rev, long long depth) {
  using T = WgTile;
  extern __shared__ __align__(16) float smem[];
  const int MA = D + H, M = MA + 1, N = 4 * H;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN, sp = blockIdx.z;
  const long long k_begin = (long long)sp * depth;
  const long long k_end = min(NL, k_begin + depth);
  const int k_tiles = k_end > k_begin ? (int)((k_end - k_begin + T::BK - 1) / T::BK) : 0;
  // Rows of A that no copy writes: the ones (m = D + H) and beyond M.
  for (int e = threadIdx.x; e < T::STAGES * T::BK * T::BM; e += T::THREADS) {
    const int m = m0 + e % T::BM;
    if (m >= MA) smem[(e / (T::BK * T::BM)) * T::STAGE_FLOATS + e % (T::BK * T::BM)] =
        m == MA ? 1.f : 0.f;
  }
  auto a_src = [&](long long kk, int m, bool& ok) -> const float* {
    if (m < D) return x + kk * D + m;
    const long long kp = rev ? kk + B : kk - B;
    ok = ok && kp >= 0 && kp < NL;
    return h + kp * H + (m - D);
  };
  auto load = [&](float* As, float* Bs, int kt) {
    const long long kb = k_begin + (long long)kt * T::BK;
    constexpr int AW = VEC ? 4 : 1;  // floats per copy of A
    for (int e = threadIdx.x; e < T::BK * T::BM / AW; e += T::THREADS) {
      const int kr = e / (T::BM / AW), mc = (e % (T::BM / AW)) * AW;
      const int m = m0 + mc;
      if (m >= MA) continue;
      const long long kk = kb + kr;
      bool ok = kk < k_end;
      const float* src = ok ? a_src(kk, m, ok) : x;
      cp_async_to<AW * 4>(As + kr * T::BM + mc, ok ? src : x, ok);
    }
    for (int e = threadIdx.x; e < T::BK * T::BN / 4; e += T::THREADS) {
      const int kr = e / (T::BN / 4), nc = (e % (T::BN / 4)) * 4;
      const long long kk = kb + kr;
      const bool ok = kk < k_end && n0 + nc < N;
      cp_async_to<16>(Bs + kr * T::BN + nc, ok ? dgates + kk * N + n0 + nc : dgates, ok);
    }
  };
  float acc[8][8];
  simt_gemm_tn<T>(k_tiles, load, smem, acc);
  float* out = partial + (long long)sp * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + simt_row<T>(i);
    if (m >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + simt_col<T>(4 * jh);
      if (n < N)
        *reinterpret_cast<float4*>(out + (long long)m * N + n) =
            make_float4(acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
    }
  }
}

// ---- dx = dgates w_ih^T ------------------------------------------------------------
// dx[m][n] = sum_k dgates[m][k] w_ih[n][k] over the 4H gate columns k, both
// operands read as they lie (simt_gemm_nt): [S*B][4H] and w_ih [D][4H].
// 24 threads across: a quarter warp reads eight consecutive rows of Bs.
using DxTile = SimtTileNT<128, 192, 16, 3>;  // D = 192 in one tile of columns

__global__ void __launch_bounds__(DxTile::THREADS, 1)
lstm_dx_kernel(const float* __restrict__ dgates, const float* __restrict__ w_ih,
               float* __restrict__ dx, long long M, int N, int K) {
  using T = DxTile;
  extern __shared__ __align__(16) float smem[];
  const long long m0 = (long long)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  auto load = [&](float* As, float* Bs, int kt) {
    const int k0 = kt * T::BK;
    for (int e = threadIdx.x; e < T::BM * T::BK / 4; e += T::THREADS) {
      const int m = e / (T::BK / 4), c = 4 * (e % (T::BK / 4));
      const bool ok = m0 + m < M && k0 + c < K;
      cp_async_to<16>(As + m * T::LDK + c, ok ? dgates + (m0 + m) * K + k0 + c : dgates, ok);
    }
    for (int e = threadIdx.x; e < T::BN * T::BK / 4; e += T::THREADS) {
      const int n = e / (T::BK / 4), c = 4 * (e % (T::BK / 4));
      const bool ok = n0 + n < N && k0 + c < K;
      cp_async_to<16>(Bs + n * T::LDK + c, ok ? w_ih + (long long)(n0 + n) * K + k0 + c : w_ih,
                      ok);
    }
  };
  float acc[8][8];
  simt_gemm_nt<T>((K + T::BK - 1) / T::BK, load, smem, acc);
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty + T::TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + T::TX * j;
      if (n < N) dx[m * N + n] = acc[i][j];
    }
  }
}

cudaError_t lstm_dx(const float* dgates, const float* w_ih, float* dx, long long M, int N, int K,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_dx_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DxTile::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((M + DxTile::BM - 1) / DxTile::BM), (N + DxTile::BN - 1) / DxTile::BN);
  lstm_dx_kernel<<<grid, DxTile::THREADS, DxTile::SMEM_BYTES, stream>>>(dgates, w_ih, dx, M, N,
                                                                       K);
  return cudaGetLastError();
}

// Splits of the positions: one block per SM over all tiles (a block takes
// an SM: WgTile::THREADS threads), each split at least 8 tiles of k deep.
int wgrad_split_count(long long NL, int D, int H) {
  const long long tiles = (long long)((D + H + 1 + WgTile::BM - 1) / WgTile::BM) *
                          ((4 * H + WgTile::BN - 1) / WgTile::BN);
  long long n = SMS / tiles;
  const long long by_depth = NL / (8 * WgTile::BK);
  if (n > by_depth) n = by_depth;
  return n < 1 ? 1 : (int)n;
}

cudaError_t lstm_wgrad(const float* x, const float* h, const float* dgates, float* work,
                       float* dwg, long long NL, int B, int D, int H, int rev,
                       cudaStream_t stream) {
  const int M = D + H + 1, N = 4 * H;
  const int splits = wgrad_split_count(NL, D, H);
  const long long depth = ((NL + splits - 1) / splits + WgTile::BK - 1) / WgTile::BK * WgTile::BK;
  const bool vec = D % 4 == 0 && H % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0;
  auto fn = vec ? lstm_wgrad_kernel<true> : lstm_wgrad_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WgTile::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((M + WgTile::BM - 1) / WgTile::BM, (N + WgTile::BN - 1) / WgTile::BN, splits);
  fn<<<grid, WgTile::THREADS, WgTile::SMEM_BYTES, stream>>>(x, h, dgates, work, NL, B, D, H, rev,
                                                            depth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(work, dwg, (long long)M * N, splits, stream);
}


// ---- the bf16 form on the tensor cores: projection ----------------------------------
// out[d][m][n] = sum_k x[m][k] W_d[k][n] + bias[d][n], x [M][K] bf16, W_d =
// W + d * K * N fp32 [K][N] rounded to bf16 as it is staged. Eight warps, 2
// (rows) x 4 (columns), each MW m16 tiles x DM_NT n8 tiles.
constexpr int DM_NT = 5;               // n8 tiles a warp
constexpr int DM_BN = 4 * 8 * DM_NT;   // 160 columns a block
constexpr int DM_THREADS = 256;

struct DenseMmaPlan {
  int mw, bm;        // m16 tiles a warp (4 or 2), rows a tile (32 mw)
  int kp, ast, wst;  // K rounded to 16; row strides of the x and W tiles (odd 16-byte chunks)
  long long w_bytes, a_bytes, bytes;
};

bool dense_mma_plan(int K, DenseMmaPlan& p) {
  if (K < 1) return false;
  p.kp = (K + 15) / 16 * 16;
  p.ast = p.kp + 8;
  p.wst = DM_BN + 8;
  for (p.mw = 4; p.mw >= 2; p.mw -= 2) {
    p.bm = 32 * p.mw;
    p.w_bytes = 2LL * p.kp * p.wst;
    p.a_bytes = 2LL * p.bm * p.ast;
    p.bytes = p.w_bytes + 2 * p.a_bytes;
    if (p.bytes <= 4LL * SMEM_FLOATS) return true;
  }
  return false;
}

// grid (G, column tiles, dirs): block (i, j, d) takes column tile j of
// direction d and row tiles i, i + G, ...
template <int MW>
__global__ void __launch_bounds__(DM_THREADS, 1)
dense_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ W,
                 const float* __restrict__ bias, float* __restrict__ out, long long M, int K,
                 int N, DenseMmaPlan p) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = 32 * MW;
  extern __shared__ __align__(16) unsigned char dm_smem[];
  bf16* ws = reinterpret_cast<bf16*>(dm_smem);                    // [kp][wst]
  bf16* as = reinterpret_cast<bf16*>(dm_smem + p.w_bytes);         // [2][BM][ast]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int d = blockIdx.z, n0 = blockIdx.y * DM_BN;
  const long long m_tiles = (M + BM - 1) / BM;
  const float* w = W + (long long)d * K * N;
  // The W tile, rounded to bf16 (zero past K and N).
  for (int e = tid; e < p.kp * DM_BN; e += DM_THREADS) {
    const int k = e / DM_BN, n = e - k * DM_BN;
    ws[k * p.wst + n] =
        __float2bfloat16(k < K && n0 + n < N ? w[(long long)k * N + n0 + n] : 0.f);
  }
  // The depth padding of both x tiles, written once (the copies never reach it).
  const int kpad = p.kp - K;
  for (int e = tid; e < 2 * BM * kpad; e += DM_THREADS)
    as[(e / kpad) * p.ast + K + e % kpad] = __float2bfloat16(0.f);
  const bool vec = K % 8 == 0;
  auto stage = [&](long long tile, int buf) {
    bf16* dst = as + buf * BM * p.ast;
    const long long m0 = tile * BM;
    if (vec) {
      const int per_row = K / 8;
      for (int e = tid; e < BM * per_row; e += DM_THREADS) {
        const int r = e / per_row, c = (e - r * per_row) * 8;
        const bool ok = m0 + r < M;
        cp_async_16(dst + r * p.ast + c, ok ? x + (m0 + r) * K + c : x, ok);
      }
    } else {
      for (int e = tid; e < BM * K; e += DM_THREADS) {
        const int r = e / K, c = e - r * K;
        dst[r * p.ast + c] = m0 + r < M ? x[(m0 + r) * K + c] : __float2bfloat16(0.f);
      }
    }
  };
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int v_k = lane & 15, v_hi = lane >> 4;
  long long tile = blockIdx.x;
  if (tile < m_tiles) stage(tile, 0);
  cp_async_commit_raw();
  for (int i = 0; tile < m_tiles; ++i, tile += gridDim.x) {
    const bool next = tile + gridDim.x < m_tiles;
    if (next) stage(tile + gridDim.x, (i + 1) & 1);
    cp_async_commit_raw();
    cp_async_wait_raw(1);
    __syncthreads();
    const bf16* at = as + (i & 1) * BM * p.ast + (wm * 16 * MW + a_row) * p.ast + a_k;
    float acc[MW][DM_NT][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int j = 0; j < DM_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    for (int kt = 0; kt < p.kp / 16; ++kt) {
      unsigned bfr[DM_NT][2];
      const bf16* wrow = ws + (kt * 16 + v_k) * p.wst + wn * 8 * DM_NT;
#pragma unroll
      for (int j = 0; j + 1 < DM_NT; j += 2) {
        unsigned r4[4];
        ldsm_x4_trans(r4, wrow + 8 * (j + v_hi));
        bfr[j][0] = r4[0];
        bfr[j][1] = r4[1];
        bfr[j + 1][0] = r4[2];
        bfr[j + 1][1] = r4[3];
      }
      if constexpr (DM_NT % 2) {
        unsigned r2[2];
        ldsm_x2_trans(r2, wrow + 8 * (DM_NT - 1));
        bfr[DM_NT - 1][0] = r2[0];
        bfr[DM_NT - 1][1] = r2[1];
      }
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        unsigned a[4];
        ldsm_x4(a, at + m * 16 * p.ast + kt * 16);
#pragma unroll
        for (int j = 0; j < DM_NT; ++j) mma_bf16(acc[m][j], a, bfr[j][0], bfr[j][1]);
      }
    }
    const long long m0 = tile * BM + wm * 16 * MW;
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long row = m0 + m * 16 + g + 8 * hr;
        if (row >= M) continue;
        float* orow = out + ((long long)d * M + row) * N;
#pragma unroll
        for (int j = 0; j < DM_NT; ++j) {
          const int n = n0 + wn * 8 * DM_NT + j * 8 + 2 * t4;
          if (n + 1 < N) {
            *reinterpret_cast<float2*>(orow + n) =
                make_float2(acc[m][j][2 * hr] + bias[d * N + n],
                            acc[m][j][2 * hr + 1] + bias[d * N + n + 1]);
          } else if (n < N) {
            orow[n] = acc[m][j][2 * hr] + bias[d * N + n];
          }
        }
      }
    __syncthreads();  // this x tile's buffer is free again
  }
  cp_async_wait_raw(0);
}

using DenseMmaKernel = void (*)(const __nv_bfloat16*, const float*, const float*, float*,
                                long long, int, int, DenseMmaPlan);

// The card's blocks of a dense_mma_kernel form at once.
int dense_mma_resident(DenseMmaKernel fn, long long bytes) {
  static int cached[2][64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  int& c = cached[fn == dense_mma_kernel<4> ? 0 : 1][dev];
  if (c) return c;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, DM_THREADS, bytes) !=
          cudaSuccess)
    return 0;
  c = sms * per_sm;
  return c;
}

cudaError_t dense_mma(const __nv_bfloat16* x, const float* W, const float* bias, float* out,
                      long long M, int K, int N, int dirs, cudaStream_t stream) {
  DenseMmaPlan p;
  if (!dense_mma_plan(K, p)) return cudaErrorInvalidValue;
  DenseMmaKernel fn = p.mw == 4 ? dense_mma_kernel<4> : dense_mma_kernel<2>;
  const int resident = dense_mma_resident(fn, p.bytes);
  if (resident < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.bytes));
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + DM_BN - 1) / DM_BN;
  const long long m_tiles = (M + p.bm - 1) / p.bm;
  const long long groups = std::max(1LL, std::min(m_tiles, (long long)resident /
                                                                (n_tiles * dirs)));
  fn<<<dim3((unsigned)groups, n_tiles, dirs), DM_THREADS, p.bytes, stream>>>(x, W, bias, out, M,
                                                                           K, N, p);
  return cudaGetLastError();
}

// ---- the bf16 form on the tensor cores: the recurrence ------------------------------
constexpr int LM_QPW = 2;  // unit quads a warp
constexpr int LM_MAX_THREADS = 512;

struct LstmMmaPlan {
  int cs, mt, lines;  // blocks a cluster; m16 tiles of lines (lines = 16 mt)
  int uc, quads, n;   // units a block, their quads, gate columns (16 quads)
  int kh;             // H padded to 16 (zero rows)
  int nw, nt;         // warps (LM_QPW quads each) and threads
  long long w_bytes, h_bytes, bytes;
};

bool lstm_mma_plan(int H, int cs, int mt, LstmMmaPlan& p) {
  if (H < 1 || H > 256 || (cs != 1 && cs != 2 && cs != 4 && cs != 8) || (mt != 1 && mt != 2))
    return false;
  p.cs = cs;
  p.mt = mt;
  p.lines = 16 * mt;
  p.uc = (H + cs - 1) / cs;
  p.quads = (p.uc + 3) / 4;
  p.n = 16 * p.quads;
  p.kh = (H + 15) / 16 * 16;
  p.nw = (p.quads + LM_QPW - 1) / LM_QPW;
  p.nt = 32 * p.nw;
  p.w_bytes = 2LL * p.kh * p.n;
  p.h_bytes = 2LL * 2 * p.kh * p.lines;
  p.bytes = p.w_bytes + p.h_bytes;
  return p.nt <= LM_MAX_THREADS && p.bytes <= 4LL * SMEM_FLOATS;
}

// xp [dirs][S][B][4H] fp32 pre-activations (bias included), w_hh [dirs][H][4H]
// fp32 -> hout [dirs][S][B][H] bf16. grid (CS * tiles, dirs), clusters of CS
// blocks along x, p.nt threads. Shared memory: the block's gate columns of
// w_hh in bf16, [kh / 16][n] swizzled tiles; h [2][kh / 16][lines] swizzled
// tiles (double buffered; every block holds the whole tile's h).
template <int MT>
__global__ void __launch_bounds__(LM_MAX_THREADS, 1)
lstm_mma_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                __nv_bfloat16* __restrict__ hout, int S, int B, int H, int rev, LstmMmaPlan p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char lm_smem[];
  constexpr int LINES = 16 * MT;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = 4 * H, n = p.n;
  const int d = blockIdx.y;
  const bool reverse = (d == 1) != (rev != 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int line0 = (blockIdx.x / p.cs) * LINES;
  const int u0 = rank * p.uc;
  bf16* ws = reinterpret_cast<bf16*>(lm_smem);
  bf16* hb = reinterpret_cast<bf16*>(lm_smem + p.w_bytes);
  const int h_buf = (p.kh / 16) * LINES * 16;

  // The gate columns, rounded to bf16: column 16 q + 8 (gate / 2) + 2 (j % 4)
  // + gate % 2 holds gate `gate` of local unit j = 4 q + j % 4 (zero rows
  // past H, zero columns past the block's units).
  {
    const float* w = w_hh + (long long)d * H * N;
    const int uq = 4 * p.quads;
    for (int e = tid; e < p.kh * 4 * uq; e += p.nt) {
      const int k = e / (4 * uq), gate = (e / uq) % 4, j = e % uq;
      const float val = k < H && j < p.uc && u0 + j < H ? w[(long long)k * N + gate * H + u0 + j]
                                                        : 0.f;
      ws[(k >> 4) * n * 16 + swz(k, (j >> 2) * 16 + (gate >> 1) * 8 + (j & 3) * 2 + (gate & 1))] =
          __float2bfloat16(val);
    }
  }
  for (int e = tid; e < 2 * h_buf; e += p.nt) hb[e] = __float2bfloat16(0.f);

  // The warp's quads warp + i * nw; a lane's cells: unit 4 q + t4 of the
  // block at lines m * 16 + g + 8 hr of the tile.
  int unit[LM_QPW], h_at[LM_QPW][MT][2];
  bool has_quad[LM_QPW], owner[LM_QPW], line_ok[MT][2];
  const bf16* wb[LM_QPW];  // the quad's B fragments: lane's row and chunk of k-tile 0
  float c_state[MT][LM_QPW][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) line_ok[m][hr] = line0 + m * 16 + g + 8 * hr < B;
#pragma unroll
  for (int i = 0; i < LM_QPW; ++i) {
    const int q = warp + i * p.nw, j = 4 * q + t4;
    has_quad[i] = q < p.quads;
    unit[i] = u0 + j;
    owner[i] = has_quad[i] && j < p.uc && unit[i] < H;
    const int bcol = 16 * min(q, p.quads - 1) + (lane & 7) + (lane >> 4) * 8;
    wb[i] = ws + swz(((lane >> 3) & 1) * 8, bcol);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        c_state[m][i][hr] = 0.f;
        h_at[i][m][hr] =
            owner[i] ? (unit[i] / 16) * LINES * 16 + swz(unit[i], m * 16 + g + 8 * hr) : -1;
      }
  }
  // The lane's cells' pre-activations of a step (zero where no cell).
  float xv[MT][LM_QPW][2][4];
  auto load_xp = [&](int s) {
    const int pos = reverse ? S - 1 - s : s;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float* row = xp + (((long long)d * S + pos) * B + line0 + m * 16 + g + 8 * hr) * N;
#pragma unroll
        for (int i = 0; i < LM_QPW; ++i)
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            xv[m][i][hr][gate] =
                owner[i] && line_ok[m][hr] ? row[gate * H + unit[i]] : 0.f;
      }
  };
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int h_off = swz(a_k, a_row);
  load_xp(0);
  cluster.sync();  // weights and h in place in every block before any remote write

  for (int s = 0; s < S; ++s) {
    const int pos = reverse ? S - 1 - s : s;
    const bf16* hcur = hb + (s & 1) * h_buf;
    bf16* hnext = hb + ((s + 1) & 1) * h_buf;
    if (s > 0) cluster_wait();  // every block's h of the last step is in hcur
    float acc[MT][LM_QPW][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < LM_QPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][0][e] = acc[m][i][1][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < p.kh / 16; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldsm_x4(a[m], hcur + kk * LINES * 16 + m * 16 * 16 + h_off);
#pragma unroll
      for (int i = 0; i < LM_QPW; ++i) {
        if (!has_quad[i]) continue;
        unsigned bw[4];
        ldsm_x4(bw, wb[i] + kk * n * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][i][0], a[m], bw[0], bw[1]);
          mma_bf16(acc[m][i][1], a[m], bw[2], bw[3]);
        }
      }
    }
    // The cell in registers (fast activations, as kernel 1's), c in fp32; h
    // rounded to bf16 enters the next step's product (every block of the
    // cluster) and the output.
    bf16* hrow = hout + (((long long)d * S + pos) * B + line0) * H;
#pragma unroll
    for (int i = 0; i < LM_QPW; ++i) {
      if (!has_quad[i]) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float ig = fast_sigmoid(acc[m][i][0][2 * hr] + xv[m][i][hr][0]);
          const float fg = fast_sigmoid(acc[m][i][0][2 * hr + 1] + xv[m][i][hr][1]);
          const float gg = fast_tanh(acc[m][i][1][2 * hr] + xv[m][i][hr][2]);
          const float og = fast_sigmoid(acc[m][i][1][2 * hr + 1] + xv[m][i][hr][3]);
          float& c = c_state[m][i][hr];
          c = fg * c + ig * gg;
          const bf16 hv = __float2bfloat16(og * fast_tanh(c));
          const int at = h_at[i][m][hr];
          if (at < 0) continue;
          for (int r = 0; r < p.cs; ++r) cluster.map_shared_rank(hnext, r)[at] = hv;
          if (line_ok[m][hr]) hrow[(m * 16 + g + 8 * hr) * H + unit[i]] = hv;
        }
    }
    cluster_arrive();
    if (s + 1 < S) load_xp(s + 1);  // arrives during the barrier and the next product
  }
  cluster_wait();  // no block leaves while another may still write its h
}

using LstmMmaKernel = void (*)(const float*, const float*, __nv_bfloat16*, int, int, int, int,
                               LstmMmaPlan);

struct LstmMmaLaunch {
  LstmMmaPlan plan;
  LstmMmaKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

// The launch of plan (cs, lines = 16 mt) over `tiles` tiles and `dirs`
// directions, with the kernel's shared memory set.
cudaError_t lstm_mma_launch_config(LstmMmaLaunch& L, int H, int cs, int lines, int tiles,
                                   int dirs, cudaStream_t stream) {
  if (lines % 16 || !lstm_mma_plan(H, cs, lines / 16, L.plan)) return cudaErrorInvalidValue;
  L.fn = L.plan.mt == 1 ? lstm_mma_kernel<1> : lstm_mma_kernel<2>;
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

// Shapes every entry takes: at least one step, line and input feature, and
// H <= 256 (the recurrences' four lanes per unit or group in 256 threads).
inline bool shape_ok(int S, int B, int D, int H) {
  return S >= 1 && B >= 1 && D >= 1 && H >= 1 && H <= 256;
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
  cudaError_t err = dense(x, w_ih, (long long)D * N, bias, xp, (long long)S * B, D, N, dirs,
                          stream);
  if (err != cudaSuccess) return err;
  return launch_rec<false>(xp, w_hh, out, nullptr, S, B, H, dirs, rev, cs, lines, stream);
}

// The bf16 form of lstm_forward on the tensor cores: x [S][B][D] (16-byte
// aligned) and out [dirs][S][B][H] bf16, the weights and bias fp32 (rounded
// to bf16 in the kernels), xp fp32; (cs, lines) the recurrence's plan
// (lstm_mma_plan).
int lstm_forward_bf16(const __nv_bfloat16* x, const float* w_ih, const float* w_hh,
                      const float* bias, float* xp, __nv_bfloat16* out, int S, int B, int D,
                      int H, int dirs, int rev, int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H) || dirs < 1 || dirs > 2) return cudaErrorInvalidValue;
  LstmMmaLaunch L;
  cudaError_t err = lstm_mma_launch_config(L, H, cs, lines, (B + lines - 1) / lines, dirs, stream);
  if (err != cudaSuccess) return err;
  err = dense_mma(x, w_ih, bias, xp, (long long)S * B, D, 4 * H, dirs, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&L.cfg, L.fn, static_cast<const float*>(xp), w_hh, out, S, B, H, rev,
                           L.plan);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The projection of lstm_forward_bf16 alone (dense_mma_kernel), for timing:
// xp [dirs][S*B][4H] from x and w_ih, bias.
int lstm_projection_bf16(const __nv_bfloat16* x, const float* w_ih, const float* bias, float* xp,
                         long long M, int D, int N, int dirs, void* stream_ptr) {
  return dense_mma(x, w_ih, bias, xp, M, D, N, dirs, static_cast<cudaStream_t>(stream_ptr));
}

// Dynamic shared memory of the projection at depth D, or -1 if it does not fit.
long long lstm_projection_smem(int D) {
  DenseMmaPlan p;
  return dense_mma_plan(D, p) ? p.bytes : -1;
}

// The card's most clusters of the bf16 recurrence plan (cs, lines) at width
// H that can run at once, 0 if the plan does not fit a block, or minus a
// CUDA error.
int lstm_mma_max_clusters(int H, int cs, int lines) {
  LstmMmaLaunch L;
  cudaError_t err = lstm_mma_launch_config(L, H, cs, lines, 1, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, L.fn, &L.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory of a block of the bf16 recurrence plan, or -1 if it
// does not fit.
long long lstm_mma_smem(int H, int cs, int lines) {
  LstmMmaPlan p;
  return lines % 16 == 0 && lstm_mma_plan(H, cs, lines / 16, p) ? p.bytes : -1;
}

// lstm_core's forward, one direction: h [S][B][H] and the stashes of its
// backward, gates [S][B][4H] (activated i, f, g, o) and c [S][B][H].
int lstm_train_fwd(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                   float* gates, float* h, float* c, int S, int B, int D, int H, int rev,
                   int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H)) return cudaErrorInvalidValue;
  const int N = 4 * H;
  cudaError_t err = dense(x, w_ih, 0, bias, gates, (long long)S * B, D, N, 1, stream);
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

// The card's most clusters of the reverse sweep's plan (cs, lines) at width
// H that can run at once, 0 if the plan does not fit a block, or minus a
// CUDA error.
int lstm_sweep_max_clusters(int H, int cs, int lines) {
  SweepLaunch L;
  cudaError_t err = sweep_launch_config(L, H, cs, lines, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, L.fn, &L.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory of a block of the sweep's plan, or -1 if it does not fit.
long long lstm_sweep_smem(int H, int cs, int lines) {
  SweepPlan p;
  return sweep_plan(H, cs, lines, p) ? p.bytes : -1;
}

// Floats of the backward's reduction workspace.
long long lstm_train_bwd_workspace(int S, int B, int D, int H) {
  const long long NL = (long long)S * B;
  return (long long)wgrad_split_count(NL, D, H) * (D + H + 1) * 4 * H;
}

// lstm_core's backward. Inputs: x [S][B][D], the forward's h, c and gates,
// the cotangent dout [S][B][H] of h, w_ih [D][4H], w_hh [H][4H]; the sweep's
// plan (cs, lines). Scratch: dgates [S][B][4H], work (workspace floats).
// Outputs: dx [S][B][D] and dwg [D + H + 1][4H]: rows 0 .. D-1 dW_ih, rows
// D .. D+H-1 dW_hh, row D+H db.
int lstm_train_bwd(const float* x, const float* h, const float* c, const float* gates,
                   const float* dout, const float* w_ih, const float* w_hh, float* dgates,
                   float* work, float* dx, float* dwg, int S, int B, int D, int H, int rev,
                   int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, B, D, H)) return cudaErrorInvalidValue;
  const int N = 4 * H;
  const long long NL = (long long)S * B;
  cudaError_t err = launch_sweep(gates, c, dout, w_hh, dgates, S, B, H, rev, cs, lines, stream);
  if (err != cudaSuccess) return err;
  err = lstm_dx(dgates, w_ih, dx, NL, D, N, stream);
  if (err != cudaSuccess) return err;
  return lstm_wgrad(x, h, dgates, work, dwg, NL, B, D, H, rev, stream);
}

}  // extern "C"
