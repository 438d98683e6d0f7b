// TF-GridNet RNN path on sequence-major lines, for training: the backward of
// the fused unfold -> BiLSTM -> deconv -> fold (kernel 6). The training
// forward with the stashes this backward reads (kernel 5) is kernel 1's
// fused cluster recurrence with STASH set (gridrnn.cu: grid_fold_train_fwd),
// and the forward alone with both directions summed (kernel 4) is kernel 1's
// (gridrnn.cu: grid_bilstm_fold).
//
// Replaces the Pallas kernel of grid_fold_train_pair's backward
// (fdbm_tpu/ops/gridrnn_train.py:508 _bwd_call, _bwd_kernel,
// _bwd_dir_sweep): dx and the gradients of w_ih, w_hh, bias and wd.
// Shapes: x [S, lines, C] (the canvas of gridrnn_core.cuh with B = 1,
// P = lines), L = S - 3, w_ih [2, 4C, 4H], w_hh [2, H, 4H], bias [2, 4H],
// wd [2H, 4C]; per-position tensors [2][lines][L][width]. Every row of the
// outputs is exact, and the backward is the gradient of the ideal
// unfold -> BiLSTM -> deconv -> fold for any cotangent (the JAX kernels
// are exact on rows [3, L-1], which is all the model reads).
//
// What bounds the backward on the H100: the reverse sweep and the products
// over all positions. Each of the L steps of a line needs the dgates of the
// step after it, so per line the sweep is a chain of L dependent 4H x H
// matrix-vector products (plus dh from the deconv, 4C x H, free of the
// chain); at the main path's shape (524 or 526 lines a direction, C = 32,
// H = 100) a one-wave grid puts 16 lines of one direction on each SM, 7
// warps, so a step is the latency of its chain more than its FMAs. The
// weight gradients are 2 x (4C + H + 1) x 4H FMAs a position (50 GFLOP a
// call at B = 2, 256 frames) and dx 2 x 8H x 4C (28 GFLOP), bound by the
// fp32 FMA rate of the CUDA cores (no TF32: tile_gemm.cuh).
//
// What the design does about it, in five kernels on the current stream:
//   1. train_sweep_kernel: the reverse sweep on thread-block clusters, one
//      wave (ops/gridrnn_train.py: train_sweep_plan sizes the clusters and
//      the tiles of lines). CS blocks (2 at C = 32, H = 100) share one tile
//      of lines of one direction. Block r holds for the whole sweep the gate
//      columns of its units of w_hh, wt[4j + g][k] = w_hh[k][g*H + r*uc + j]
//      (staged from w_hh itself, no transposed copy), and its C / CS
//      channels' rows of wd^T, wdt[(tap, c)][k] = wd[d*H + k][tap*C + c].
//      Per step, lane (group kq, ks) of eight sums, for the four units
//      4kq .. 4kq + 3 and every line of the tile, its share of (a) dh_prev
//      from the block's own dgates columns of the step before (dgs, in
//      shared memory with the lines contiguous: per column one float4 of
//      weights and LINES/4 float4 of dgates for 4 x LINES FMAs, so that the
//      lane's 64 sums stay in registers) and (b) dh from the deconv, the
//      window of the output cotangent at the step times wdt (its channels'
//      rows reach shared memory through a ring filled by cp.async six rows
//      ahead, so no dh buffer and no projection pass exist). Part (b) does
//      not depend on the chain: it is computed for the next step between
//      the two halves of the step's cluster barrier. A reduce-scatter of
//      shuffles over the eight lanes leaves each lane the sums of
//      LINES / 8 lines, which it writes to the receive tile of the units'
//      owners (distributed shared memory, double-buffered). After the
//      barrier, thread (line, unit) adds the CS parts in rank order, runs
//      the cell's backward from the forward's stash (the activated gates
//      as one float4 and c_prev, copied into shared memory by cp.async
//      during the product; c and dc carried in registers) and writes
//      dgates to device memory and to dgs; one block barrier hands dgs to
//      the next step's product.
//   2. train_dx_kernel: dx, the unfold's transpose: z = dgates w_ih^T for
//      the positions a block of output rows needs, both directions as one
//      product over 8H (simt_gemm.cuh's simt_gemm_nt: both operands read as
//      they lie, 8 x 8 per thread), then the 4-tap overlap-add from shared
//      memory, one write of each output row.
//   3. train_wgrad_kernel: dW_ih, dW_hh and db as one product over
//      [windows(x) | h_{s-1} | 1] (K = 4C + H + 1) against dgates
//      (simt_gemm_tn, 8 x 8 per thread, a four-stage cp.async ring). The
//      loader reads the k = 4 windows of x and the shifted h row straight
//      from their tensors, so nothing is copied in device memory; dgates is
//      read once for all three, and a row of ones makes db the column sums.
//   4. train_dwd_kernel: dW_deconv = h^T windows(dout) on the same tile.
//   5. grad_reduce_kernel: both products are split over the positions into
//      per-block partial sums; it adds the splits in a fixed order and
//      writes each gradient. No atomics anywhere: two backward calls give
//      the same bits.
#include <cooperative_groups.h>

#include <cstdint>

#include "async_copy.cuh"
#include "gridrnn_core.cuh"
#include "simt_gemm.cuh"
#include "split_k.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- 1. the reverse sweep on clusters --------------------------------------------
constexpr int SW_KS = 8;            // lanes splitting a group's sums
constexpr int SW_MAX_THREADS = 256;
constexpr int SW_RING = 8;          // cotangent rows a block holds
constexpr int SW_AHEAD = 6;         // rows staged ahead of the first step that reads them
constexpr int SW_STAGE = 4;         // cotangent floats a thread copies per staged row
constexpr int SW_MAX_CELLS = 5;     // cells (line, unit) a thread owns
constexpr int SW_STASH = 5;         // floats of a cell's stash per step: 4 gates, c_prev
constexpr long long SW_SMEM = 232448;  // a block's shared memory on the H100 (227 KB)

struct SweepPlan {
  int uc;   // units per block
  int cc;   // cotangent channels per block, C / CS
  int kp;   // row stride of wt and wdt: 4 * ceil(H / 4) padded to 16 (mod 32)
            // floats, so the two lanes of a quarter warp that read other rows
            // fall in other banks
  int lbp;  // row stride of the staged rows and of dgs: lines padded so that
            // lbp / 4 is odd
  int nt;   // threads: a warp is four groups x eight lanes (and at least a
            // quarter of a staged row's floats), whole warps
  long long bytes;
};

bool sweep_plan(int C, int H, int cs, int lines, SweepPlan& p) {
  if (H < 1 || C < 1 || (cs != 1 && cs != 2 && cs != 4 && cs != 8) || C % cs) return false;
  if (lines != 8 && lines != 16) return false;
  const int kgroups = (H + 3) / 4;
  p.uc = (H + cs - 1) / cs;
  p.cc = C / cs;
  p.kp = 4 * kgroups + (48 - (4 * kgroups) % 32) % 32;
  p.lbp = (lines / 4) % 2 ? lines : lines + 4;
  const int lanes = (kgroups + 3) / 4 * 32;
  const int stagers = (lines * p.cc + SW_STAGE - 1) / SW_STAGE;
  p.nt = lanes > stagers ? lanes : (stagers + 31) / 32 * 32;
  p.bytes = 4LL * (4LL * (p.uc + p.cc) * p.kp + 4LL * p.uc * p.lbp +
                   2LL * cs * lines * p.uc + (long long)SW_RING * p.cc * p.lbp +
                   (long long)SW_STASH * lines * p.uc);
  const int cells = (lines * p.uc + p.nt - 1) / p.nt;
  return p.nt <= SW_MAX_THREADS && cells <= SW_MAX_CELLS && p.bytes <= SW_SMEM;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float v, const float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// One stage of the lanes' reduce-scatter: a lane keeps the lower or upper
// HALF lines (hi_half) of its sums plus the partner's (lane mask `mask`).
// HALF is a template constant so that every index into acc is one, and acc
// stays in registers.
template <int HALF, int LINES>
__device__ __forceinline__ void rs_stage(float (&acc)[LINES][4], bool hi_half, int mask) {
#pragma unroll
  for (int l = 0; l < HALF; ++l)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = acc[l][i], hi = acc[l + HALF][i];
      acc[l][i] = (hi_half ? hi : lo) + __shfl_xor_sync(0xffffffffu, hi_half ? lo : hi, mask);
    }
}

// dout0, dout1 [S][lines][C] the output cotangents, gates [2][lines][L][H][4]
// and cst [2][lines][L][H] the forward's stashes, w_hh [2][H][4H], wd
// [2H][4C] -> dgates [2][lines][L][4H], the gradient of the pre-activations.
// grid (CS * tiles, 2), clusters of CS blocks along x. Shared memory: wt
// [4uc][kp], wdt [4cc][kp], dgs [4uc][lbp], recv [2][CS][LINES][uc], the
// ring of cotangent rows [SW_RING][cc][lbp], the cells' stashes of a step
// [LINES * uc] float4 gates and [LINES * uc] c_prev. Step s of direction d is
// position p = L - 1 - s (d = 0) or s (d = 1); its window taps i = 0 .. 3
// are canvas rows p + i, which are sweep rows s + 3 - i (d = 0; sweep row t
// is canvas row S - 1 - t) or s + i (d = 1; canvas row t).
template <int LINES>
__global__ void __launch_bounds__(SW_MAX_THREADS, 1)
train_sweep_kernel(const float* __restrict__ dout0, const float* __restrict__ dout1,
                   const float* __restrict__ gates, const float* __restrict__ cst,
                   const float* __restrict__ w_hh, const float* __restrict__ wd,
                   float* __restrict__ dgates, int S, int C, int H, int n_lines, int uc, int cc,
                   int kp, int lbp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L8 = LINES / SW_KS;  // lines of a lane's sums after the reduce-scatter
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = 4 * H, KW = KS * C, L = S - (KS - 1);
  const int d = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int line0 = (blockIdx.x / cs) * LINES;
  const int u0 = rank * uc, c0 = rank * cc, ncol = 4 * uc;
  const int kgroups = (H + 3) / 4;
  float* wt = smem;                               // [4uc][kp]
  float* wdt = wt + (long long)ncol * kp;         // [4cc][kp]
  float* dgs = wdt + (long long)4 * cc * kp;      // [4uc][lbp]
  float* recv = dgs + ncol * lbp;                 // [2][cs][LINES][uc]
  float* ring = recv + 2 * cs * LINES * uc;       // [SW_RING][cc][lbp]
  float* gst = ring + SW_RING * cc * lbp;         // [LINES * uc][4]
  float* cpst = gst + 4 * LINES * uc;             // [LINES * uc]
  const float* wh = w_hh + (long long)d * H * N;
  const float* dout = d == 0 ? dout0 : dout1;
  for (int e = tid; e < ncol * kp; e += nt) {
    const int n = e / kp, k = e % kp, u = u0 + n / 4;
    wt[e] = k < H && u < H ? wh[(long long)k * N + (n % 4) * H + u] : 0.f;
  }
  for (int e = tid; e < 4 * cc * kp; e += nt) {
    const int r = e / kp, k = e % kp;
    wdt[e] = k < H ? wd[((long long)d * H + k) * KW + (r / cc) * C + c0 + r % cc] : 0.f;
  }
  for (int e = tid; e < ncol * lbp; e += nt) dgs[e] = 0.f;
  // The thread's floats of a staged row: (line l, channel c0 + c) for e =
  // l * cc + c = tid + i * nt, at offset src + row * lines * C, ring offset dst.
  long long st_src[SW_STAGE];
  int st_dst[SW_STAGE];
  bool st_ok[SW_STAGE];
#pragma unroll
  for (int i = 0; i < SW_STAGE; ++i) {
    const int e = tid + i * nt, l = e / cc, c = e % cc, line = line0 + l;
    st_ok[i] = e < LINES * cc && line < n_lines;
    st_src[i] = st_ok[i] ? (long long)line * C + c0 + c : 0;
    st_dst[i] = c * lbp + l;
  }
  // Sweep row t of the tile's lines into ring slot t % SW_RING, c-major.
  auto stage_row = [&](int t) {
    const long long roff = (long long)(d == 0 ? S - 1 - t : t) * n_lines * C;
    float* dst = ring + (t % SW_RING) * cc * lbp;
#pragma unroll
    for (int i = 0; i < SW_STAGE; ++i)
      if (tid + i * nt < LINES * cc)
        cp_async_to<4>(dst + st_dst[i], st_ok[i] ? dout + st_src[i] + roff : dout, st_ok[i]);
  };
  for (int t = 0; t < SW_AHEAD && t < S; ++t) stage_row(t);
  cp_async_commit_group();
  cp_async_wait_groups<0>();

  // Product lanes: a warp is groups 4w .. 4w + 3 (lane bits 0-1) x eight
  // lanes ks (lane bits 2-4), so a quarter warp reads four groups' columns
  // of two rows. Lanes past the last group repeat its product and send
  // nothing; warps past it skip the product.
  const int lane = tid & 31, warp = tid >> 5;
  const int ks = lane >> 2;
  const bool in_warp = 4 * warp < kgroups;
  const bool sender = 4 * warp + (lane & 3) < kgroups;
  const int kq = min(4 * warp + (lane & 3), kgroups - 1);
  float* dst[4];  // the receive tile of each of the lane's units' owners
  int dst_col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = min(4 * kq + i, H - 1), owner = k / uc;
    dst[i] = cluster.map_shared_rank(recv, owner) + rank * LINES * uc;
    dst_col[i] = k - owner * uc;
  }
  // Cells: cell i of this thread is (line l = e / uc, unit u0 + j, j =
  // e % uc), e = tid + i * nt. Its offset in [2][lines][L][H] at position 0
  // (cell_at; -1 off the tile), its unit and its place in dgs are computed
  // once (the entry keeps every offset below 2^31). Its stashes go through
  // shared memory (copied by the thread itself, so it alone reads them) to
  // keep the product's sums in registers. c of a step's position is the
  // c_prev of the step before (cv).
  const int p_first = d == 0 ? L - 1 : 0;
  float dc_carry[SW_MAX_CELLS], cv[SW_MAX_CELLS];
  int cell_at[SW_MAX_CELLS], cell_u[SW_MAX_CELLS], cell_dgs[SW_MAX_CELLS];
#pragma unroll
  for (int i = 0; i < SW_MAX_CELLS; ++i) {
    const int e = tid + i * nt, l = e / uc, j = e % uc;
    const bool ok = e < LINES * uc && line0 + l < n_lines && u0 + j < H;
    cell_at[i] = ok ? ((d * n_lines + line0 + l) * L) * H + u0 + j : -1;
    cell_u[i] = u0 + j;
    cell_dgs[i] = 4 * j * lbp + l;
    dc_carry[i] = 0.f;
    cv[i] = ok ? cst[cell_at[i] + (long long)p_first * H] : 0.f;
  }

  float acc[LINES][4];
  // Part (b) of step s: the window of dout at the step times the block's
  // rows of wd^T, into fresh sums.
  auto window = [&](int s) {
#pragma unroll
    for (int l = 0; l < LINES; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[l][i] = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int t = d == 0 ? s + KS - 1 - i : s + i;
      const float* rows = ring + (t % SW_RING) * cc * lbp;
      const float* wrow = wdt + (long long)i * cc * kp + 4 * kq;
#pragma unroll 2
      for (int c = ks; c < cc; c += SW_KS) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + c * kp);
        const float4* rk = reinterpret_cast<const float4*>(rows + c * lbp);
#pragma unroll
        for (int l4 = 0; l4 < LINES / 4; ++l4) {
          const float4 v = rk[l4];
          fma4(acc[4 * l4], v.x, w);
          fma4(acc[4 * l4 + 1], v.y, w);
          fma4(acc[4 * l4 + 2], v.z, w);
          fma4(acc[4 * l4 + 3], v.w, w);
        }
      }
    }
  };
  cluster.sync();  // weights, dgs and the first rows in place in every block
  if (in_warp) window(0);

  for (int s = 0; s < L; ++s) {
    const int p = d == 0 ? L - 1 - s : s;
    const int pp = d == 0 ? p - 1 : p + 1;  // the position whose state step p consumed
    const bool has_prev = pp >= 0 && pp < L;
    // The cells' stashes of this step, copied first so that they arrive
    // during the product.
#pragma unroll
    for (int i = 0; i < SW_MAX_CELLS; ++i) {
      const int e = tid + i * nt;
      if (e >= LINES * uc) break;
      const bool ok = cell_at[i] >= 0;
      cp_async_to<16>(gst + 4 * e, ok ? gates + 4 * (cell_at[i] + (long long)p * H) : gates, ok);
      cp_async_to<4>(cpst + e, ok && has_prev ? cst + cell_at[i] + (long long)pp * H : cst,
                     ok && has_prev);
    }
    cp_async_commit_group();
    const int buf = (s & 1) * cs * LINES * uc;
    if (in_warp) {
      // (a) the block's part of dh_prev from its dgates columns of the step
      // before: lane ks takes columns n = ks, ks + 8, ... of the 4uc; per
      // column one float4 of weights and LINES/4 float4 of dgates for
      // 4 x LINES FMAs.
      if (s > 0) {
#pragma unroll 2
        for (int n = ks; n < ncol; n += SW_KS) {
          const float4 w = *reinterpret_cast<const float4*>(wt + (long long)n * kp + 4 * kq);
          const float4* dv = reinterpret_cast<const float4*>(dgs + n * lbp);
#pragma unroll
          for (int l4 = 0; l4 < LINES / 4; ++l4) {
            const float4 v = dv[l4];
            fma4(acc[4 * l4], v.x, w);
            fma4(acc[4 * l4 + 1], v.y, w);
            fma4(acc[4 * l4 + 2], v.z, w);
            fma4(acc[4 * l4 + 3], v.w, w);
          }
        }
      }
      // Reduce-scatter over the eight lanes (ks bits 2, 1, 0: lane masks 16,
      // 8, 4): lane ks keeps the sums of lines ks*L8 .. ks*L8 + L8 - 1.
      rs_stage<LINES / 2>(acc, ks & 4, 16);
      rs_stage<LINES / 4>(acc, ks & 2, 8);
      rs_stage<LINES / 8>(acc, ks & 1, 4);
      // Each sum to its unit's owner.
      if (sender) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * kq + i >= H) break;
#pragma unroll
          for (int q = 0; q < L8; ++q)
            dst[i][buf + (ks * L8 + q) * uc + dst_col[i]] = acc[q][i];
        }
      }
    }
    // Row s + 6 starts its copy; row s + 5 and the cells' stashes (copied by
    // this thread) are complete before the arrive, so every thread may read
    // the row after the next wait.
    if (s + SW_AHEAD < S) stage_row(s + SW_AHEAD);
    cp_async_commit_group();
    cp_async_wait_groups<1>();
    cluster_arrive();
    if (in_warp && s + 1 < L) window(s + 1);
    cluster_wait();  // every rank's parts of this step are in recv
    // The cells' backward.
    const float* rv = recv + buf;
#pragma unroll
    for (int i = 0; i < SW_MAX_CELLS; ++i) {
      const int e = tid + i * nt;
      if (e >= LINES * uc) break;
      float dh = 0.f;
      for (int r = 0; r < cs; ++r) dh += rv[r * LINES * uc + e];
      const float4 gv = *reinterpret_cast<const float4*>(gst + 4 * e);
      const float ig = gv.x, fg = gv.y, gg = gv.z, og = gv.w, cp = cpst[e];
      const float tc = tanhf(cv[i]);
      const float dc = dh * og * (1.f - tc * tc) + dc_carry[i];
      float4 dg = make_float4(dc * gg * ig * (1.f - ig), dc * cp * fg * (1.f - fg),
                              dc * ig * (1.f - gg * gg), dh * tc * og * (1.f - og));
      dc_carry[i] = dc * fg;
      cv[i] = cp;
      const bool ok = cell_at[i] >= 0;
      if (!ok) dg = make_float4(0.f, 0.f, 0.f, 0.f);
      float* dcol = dgs + cell_dgs[i];
      dcol[0] = dg.x;
      dcol[lbp] = dg.y;
      dcol[2 * lbp] = dg.z;
      dcol[3 * lbp] = dg.w;
      if (ok) {
        float* out = dgates + 4 * (cell_at[i] + (long long)p * H) - 3 * cell_u[i];
        out[0] = dg.x;
        out[H] = dg.y;
        out[2 * H] = dg.z;
        out[3 * H] = dg.w;
      }
    }
    __syncthreads();  // dgs is read by every lane of the block's next product
  }
}

using SweepKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                             const float*, float*, int, int, int, int, int, int, int, int);

SweepKernel sweep_kernel(int lines) {
  switch (lines) {
    case 8: return train_sweep_kernel<8>;
    case 16: return train_sweep_kernel<16>;
    default: return nullptr;
  }
}

struct SweepLaunch {
  SweepPlan plan;
  SweepKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t sweep_launch_config(SweepLaunch& W, int C, int H, int cs, int lines, int tiles,
                                cudaStream_t stream) {
  if (!sweep_plan(C, H, cs, lines, W.plan)) return cudaErrorInvalidValue;
  W.fn = sweep_kernel(lines);
  cudaError_t err = cudaFuncSetAttribute(W.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(W.plan.bytes));
  if (err != cudaSuccess) return err;
  W.cfg = {};
  W.cfg.gridDim = dim3(cs * tiles, 2);
  W.cfg.blockDim = dim3(W.plan.nt);
  W.cfg.dynamicSmemBytes = W.plan.bytes;
  W.cfg.stream = stream;
  W.attr[0].id = cudaLaunchAttributeClusterDimension;
  W.attr[0].val.clusterDim.x = cs;
  W.attr[0].val.clusterDim.y = 1;
  W.attr[0].val.clusterDim.z = 1;
  W.cfg.attrs = W.attr;
  W.cfg.numAttrs = 1;
  return cudaSuccess;
}

// ---- 2. dx: the unfold's transpose -------------------------------------------------
// Block (line, row tile) computes z[m][n] = sum over d and k < 4H of
// dgates_d[line][q][k] w_ih[d][n][k] for the DX_BM positions q = r0 - 3 + m
// (zero outside [0, L)) and every column n = (tap, c), one n tile of 128
// after another into zs [DX_BM][4C + 1], then dx[r] = sum over taps i of
// z[r - i][tap i] for its DX_R rows r. 136 positions for 133 rows: a 263-row
// line is two row tiles.
using DxTile = SimtTileNT<136, 128, 16, 3>;
constexpr int DX_R = DxTile::BM - (KS - 1);

__global__ void __launch_bounds__(DxTile::THREADS)
train_dx_kernel(const float* __restrict__ dgates, const float* __restrict__ w_ih,
                float* __restrict__ dx, int S, int n_lines, int C, int H) {
  using T = DxTile;
  extern __shared__ __align__(16) float smem[];
  const int line = blockIdx.x, r0 = blockIdx.y * DX_R;
  const int L = S - (KS - 1), N = 4 * H, NC = KS * C, ldz = NC + 1;
  const int n_tiles = (NC + T::BN - 1) / T::BN;
  float* zs = n_tiles > 1 ? smem + T::STAGES * T::STAGE_FLOATS : smem;  // one tile: over the stages
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  for (int nti = 0; nti < n_tiles; ++nti) {
    const int n0 = nti * T::BN;
    // k in [0, 8H): direction k / 4H, gate column k % 4H (4H is a multiple
    // of 4, so no 16-byte copy straddles the directions).
    auto load = [&](float* As, float* Bs, int kt) {
      const int k0 = kt * T::BK;
      for (int e = threadIdx.x; e < T::BM * T::BK / 4; e += T::THREADS) {
        const int m = e / (T::BK / 4), c = 4 * (e % (T::BK / 4));
        const int k = k0 + c, dd = k >= N ? 1 : 0, q = r0 - (KS - 1) + m;
        const bool ok = k < 2 * N && q >= 0 && q < L;
        cp_async_to<16>(As + m * T::LDK + c,
                        ok ? dgates + (((long long)dd * n_lines + line) * L + q) * N + k - dd * N
                           : dgates,
                        ok);
      }
      for (int e = threadIdx.x; e < T::BN * T::BK / 4; e += T::THREADS) {
        const int n = e / (T::BK / 4), c = 4 * (e % (T::BK / 4));
        const int k = k0 + c, dd = k >= N ? 1 : 0;
        const bool ok = k < 2 * N && n0 + n < NC;
        cp_async_to<16>(Bs + n * T::LDK + c,
                        ok ? w_ih + ((long long)dd * NC + n0 + n) * N + k - dd * N : w_ih, ok);
      }
    };
    float acc[8][8];
    simt_gemm_nt<T>((2 * N + T::BK - 1) / T::BK, load, smem, acc);
    __syncthreads();  // every thread is done with the stages (zs may lie over them)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + T::TX * j;
        if (n < NC) zs[(ty + T::TY * i) * ldz + n] = acc[i][j];
      }
    __syncthreads();  // zs complete; the next tile's copies may fill the stages
  }
  for (int e = threadIdx.x; e < DX_R * C; e += T::THREADS) {
    const int rl = e / C, c = e % C, r = r0 + rl;
    if (r >= S) break;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) v += zs[(rl + KS - 1 - i) * ldz + i * C + c];
    dx[((long long)r * n_lines + line) * C + c] = v;
  }
}

size_t dx_smem(int C) {
  const size_t stages = (size_t)DxTile::STAGES * DxTile::STAGE_FLOATS;
  const size_t z = (size_t)DxTile::BM * (KS * C + 1);
  return 4 * (KS * C > DxTile::BN ? stages + z : (stages > z ? stages : z));
}

// ---- 3. the weight gradients -----------------------------------------------------
// train_wgrad_kernel: dwg[d][m][n] = sum over positions kk = (line, l) of
// A_d(kk)[m] dgates_d[kk][n], with A_d(kk) = the k = 4 window of x at (line,
// l) (m < 4C, tap-major), the h that step consumed (4C <= m < 4C + H; zero
// at the direction's first step) and 1 (m = 4C + H: db). Block (m tile,
// n tile, d * splits + sp) sums kk in [sp * depth, (sp+1) * depth) into
// partial[sp][d][4C + H + 1][4H].
using WgTile = SimtTile<232, 136, 16, 4>;  // C = 32, H = 100: M = 229 in one tile, N = 400 in 3

template <bool VEC>
__global__ void __launch_bounds__(WgTile::THREADS, 1)
train_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ hs,
                   const float* __restrict__ dgates, float* __restrict__ partial, int n_lines,
                   int L, int C, int H, int splits, int depth) {
  using T = WgTile;
  extern __shared__ __align__(16) float smem[];
  const int KW = KS * C, MA = KW + H, M = MA + 1, N = 4 * H;
  const int NL = n_lines * L;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int d = blockIdx.z / splits, sp = blockIdx.z % splits;
  // Positions and offsets within a row block of x are ints (the entry
  // checks that x has fewer than 2^30 floats).
  const int k_begin = sp * depth;
  const int k_end = min(NL, k_begin + depth);
  const int k_tiles = k_end > k_begin ? (k_end - k_begin + T::BK - 1) / T::BK : 0;
  // Rows of A that no copy writes: the ones (m = 4C + H) and beyond M.
  for (int e = threadIdx.x; e < T::STAGES * T::BK * T::BM; e += T::THREADS) {
    const int m = m0 + e % T::BM;
    if (m >= MA)
      smem[(e / (T::BK * T::BM)) * T::STAGE_FLOATS + e % (T::BK * T::BM)] = m == MA ? 1.f : 0.f;
  }
  const float* hd = hs + (long long)d * NL * H;
  const float* gd = dgates + (long long)d * NL * N;
  // The thread's copies are the same in every k tile: precompute their row
  // kr of the tile, their place in it and the part of their source offset
  // that does not depend on the position kk = (line, l). A window copy
  // reads x at (l * lines + line) * C + fix (fix: the tap's rows and the
  // channel), an h copy h at kk * H + fix (fix: the shifted row, -H or +H,
  // and the unit).
  constexpr int AW = VEC ? 4 : 1;  // floats per copy of A
  constexpr int A_SLOTS = (T::BK * T::BM / AW + T::THREADS - 1) / T::THREADS;
  constexpr int B_SLOTS = (T::BK * T::BN / 4 + T::THREADS - 1) / T::THREADS;
  int a_kr[A_SLOTS], a_dst[A_SLOTS], a_kind[A_SLOTS];  // kind: 0 none, 1 window of x, 2 h
  int a_fix[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const int e = threadIdx.x + i * T::THREADS;
    const int kr = e / (T::BM / AW), mc = (e % (T::BM / AW)) * AW, m = m0 + mc;
    a_kr[i] = kr;
    a_dst[i] = kr * T::BM + mc;
    a_kind[i] = e >= T::BK * T::BM / AW || m >= MA ? 0 : m < KW ? 1 : 2;
    a_fix[i] = m < KW ? (m / C) * n_lines * C + m % C : (d == 0 ? -H : H) + (m - KW);
  }
  // A slot past the tile copies nothing (dst -1): a copy that is not ok
  // still writes its zeros.
  int b_kr[B_SLOTS], b_dst[B_SLOTS];
  bool b_ok[B_SLOTS];
#pragma unroll
  for (int i = 0; i < B_SLOTS; ++i) {
    const int e = threadIdx.x + i * T::THREADS;
    const int kr = e / (T::BN / 4), nc = (e % (T::BN / 4)) * 4;
    b_kr[i] = kr;
    b_dst[i] = e < T::BK * T::BN / 4 ? kr * T::BN + nc : -1;
    b_ok[i] = n0 + nc < N;
  }
  auto load = [&](float* As, float* Bs, int kt) {
    const int kb = k_begin + kt * T::BK;
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      if (a_kind[i] == 0) continue;
      const int kk = kb + a_kr[i], line = kk / L, l = kk - line * L;
      bool ok = kk < k_end;
      const float* src;
      if (a_kind[i] == 1) {
        src = x + ((long long)l * n_lines + line) * C + a_fix[i];
      } else {
        const int lp = d == 0 ? l - 1 : l + 1;
        ok = ok && lp >= 0 && lp < L;
        src = hd + (long long)kk * H + a_fix[i];
      }
      cp_async_to<AW * 4>(As + a_dst[i], ok ? src : x, ok);
    }
#pragma unroll
    for (int i = 0; i < B_SLOTS; ++i) {
      if (b_dst[i] < 0) continue;
      const int kk = kb + b_kr[i];
      const bool ok = b_ok[i] && kk < k_end;
      cp_async_to<16>(Bs + b_dst[i], ok ? gd + (long long)kk * N + n0 + (b_dst[i] % T::BN) : gd,
                      ok);
    }
  };
  float acc[8][8];
  simt_gemm_tn<T>(k_tiles, load, smem, acc);
  float* out = partial + ((long long)sp * 2 + d) * M * N;
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

// train_dwd_kernel: dwd[d*H + m][n] = sum over positions kk of h_d[kk][m]
// times the window of dout_d at kk, n = (tap, c); partial[sp][d][H][4C].
using DwdTile = SimtTile<104, 128, 16, 4>;  // M = 100, N = 128 in one tile at C = 32, H = 100

template <bool VEC>
__global__ void __launch_bounds__(DwdTile::THREADS, 2)
train_dwd_kernel(const float* __restrict__ dout0, const float* __restrict__ dout1,
                 const float* __restrict__ hs, float* __restrict__ partial, int n_lines, int L,
                 int C, int H, int splits, int depth) {
  using T = DwdTile;
  extern __shared__ __align__(16) float smem[];
  const int KW = KS * C;
  const int NL = n_lines * L;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int d = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int k_begin = sp * depth;
  const int k_end = min(NL, k_begin + depth);
  const int k_tiles = k_end > k_begin ? (k_end - k_begin + T::BK - 1) / T::BK : 0;
  const float* hd = hs + (long long)d * NL * H;
  const float* dout = d == 0 ? dout0 : dout1;
  // The thread's copies, as in train_wgrad_kernel: a copy of B reads dout at
  // (l * lines + line) * C + fix (fix: the tap's rows and the channel).
  constexpr int AW = VEC ? 4 : 1;
  constexpr int A_SLOTS = (T::BK * T::BM / AW + T::THREADS - 1) / T::THREADS;
  constexpr int B_SLOTS = (T::BK * T::BN / 4 + T::THREADS - 1) / T::THREADS;
  int a_kr[A_SLOTS], a_dst[A_SLOTS];
  bool a_ok[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const int e = threadIdx.x + i * T::THREADS;
    const int kr = e / (T::BM / AW), mc = (e % (T::BM / AW)) * AW;
    a_kr[i] = kr;
    a_dst[i] = e < T::BK * T::BM / AW ? kr * T::BM + mc : -1;  // -1: past the tile
    a_ok[i] = m0 + mc < H;
  }
  int b_kr[B_SLOTS], b_dst[B_SLOTS];
  bool b_ok[B_SLOTS];
  int b_fix[B_SLOTS];
#pragma unroll
  for (int i = 0; i < B_SLOTS; ++i) {
    const int e = threadIdx.x + i * T::THREADS;
    const int kr = e / (T::BN / 4), nc = (e % (T::BN / 4)) * 4, n = n0 + nc;
    b_kr[i] = kr;
    b_dst[i] = e < T::BK * T::BN / 4 ? kr * T::BN + nc : -1;
    b_ok[i] = n < KW;
    b_fix[i] = (n / C) * n_lines * C + n % C;
  }
  auto load = [&](float* As, float* Bs, int kt) {
    const int kb = k_begin + kt * T::BK;
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      if (a_dst[i] < 0) continue;
      const int kk = kb + a_kr[i];
      const bool ok = a_ok[i] && kk < k_end;
      cp_async_to<AW * 4>(As + a_dst[i], ok ? hd + (long long)kk * H + m0 + a_dst[i] % T::BM : hd,
                          ok);
    }
#pragma unroll
    for (int i = 0; i < B_SLOTS; ++i) {
      if (b_dst[i] < 0) continue;
      const int kk = kb + b_kr[i], line = kk / L, l = kk - line * L;
      const bool ok = b_ok[i] && kk < k_end;
      cp_async_to<16>(Bs + b_dst[i], ok ? dout + ((long long)l * n_lines + line) * C + b_fix[i]
                                        : dout, ok);
    }
  };
  float acc[8][8];
  simt_gemm_tn<T>(k_tiles, load, smem, acc);
  float* out = partial + ((long long)sp * 2 + d) * H * KW;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + simt_row<T>(i);
    if (m >= H) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + simt_col<T>(4 * jh);
      if (n < KW)
        *reinterpret_cast<float4*>(out + (long long)m * KW + n) =
            make_float4(acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
    }
  }
}

// ---- 4. the splits, added in a fixed order -----------------------------------------
// Element i of [2][4C + H + 1][4H] (the first product) or of [2][H][4C]
// (dW_deconv, after it) is the sum over the splits of its partials, in split
// order, written to its gradient.
__global__ void grad_reduce_kernel(const float* __restrict__ p1, int s1,
                                   const float* __restrict__ p2, int s2, float* __restrict__ dw_ih,
                                   float* __restrict__ dw_hh, float* __restrict__ dbias,
                                   float* __restrict__ dwd, int C, int H) {
  const int KW = KS * C, M = KW + H + 1, N = 4 * H;
  const long long n1 = 2LL * M * N, n2 = 2LL * H * KW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n1) {
    float acc = 0.f;
    for (int sp = 0; sp < s1; ++sp) acc += p1[sp * n1 + i];
    const int d = (int)(i / ((long long)M * N)), m = (int)(i / N % M), n = (int)(i % N);
    if (m < KW)
      dw_ih[((long long)d * KW + m) * N + n] = acc;
    else if (m < KW + H)
      dw_hh[((long long)d * H + m - KW) * N + n] = acc;
    else
      dbias[d * N + n] = acc;
  } else if (i < n1 + n2) {
    const long long j = i - n1;
    float acc = 0.f;
    for (int sp = 0; sp < s2; ++sp) acc += p2[sp * n2 + j];
    dwd[j] = acc;
  }
}

// Splits of the NL positions for `tiles` output tiles a direction, at
// `per_sm` blocks an SM: one wave over both directions, each split at least
// eight k tiles deep.
int grad_splits(long long NL, long long tiles, int per_sm) {
  long long n = (long long)per_sm * SMS / (2 * tiles);
  const long long by_depth = NL / (8 * 16);
  if (n > by_depth) n = by_depth;
  return n < 1 ? 1 : (int)n;
}

int split_depth(long long NL, int splits) {
  return (int)(((NL + splits - 1) / splits + 15) / 16 * 16);
}

struct GradSplits {
  int s1, s2;
  long long floats1, floats2;
};

GradSplits grad_splits_of(long long NL, int C, int H) {
  const int M = KS * C + H + 1, N = 4 * H;
  GradSplits g;
  g.s1 = grad_splits(NL, (long long)((M + WgTile::BM - 1) / WgTile::BM) *
                             ((N + WgTile::BN - 1) / WgTile::BN), 1);
  g.s2 = grad_splits(NL, (long long)((H + DwdTile::BM - 1) / DwdTile::BM) *
                             ((KS * C + DwdTile::BN - 1) / DwdTile::BN), 2);
  g.floats1 = (long long)g.s1 * 2 * M * N;
  g.floats2 = (long long)g.s2 * 2 * H * KS * C;
  return g;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Floats of the backward's workspace: the partial sums of both products.
long long grid_fold_train_bwd_workspace(int S, int n_lines, int C, int H) {
  const GradSplits g = grad_splits_of((long long)n_lines * (S - (KS - 1)), C, H);
  return g.floats1 + g.floats2;
}

// Kernel 6, the training backward. Inputs: x and the output cotangents
// doutf, doutb [S, lines, C], the forward's stashes (gates [2, lines, L, H,
// 4], hs and cs [2, lines, L, H]), the weights; (cs_, lines) is the sweep's
// plan. Scratch: dgates [2, lines, L, 4H], work (workspace floats). Outputs:
// dx [S, lines, C], dw_ih [2, 4C, 4H], dw_hh [2, H, 4H], dbias [2, 4H],
// dwd [2H, 4C].
int grid_fold_train_bwd(const float* x, const float* doutf, const float* doutb,
                        const float* gates, const float* hs, const float* cs, const float* w_ih,
                        const float* w_hh, const float* wd, float* dgates, float* work, float* dx,
                        float* dw_ih, float* dw_hh, float* dbias, float* dwd, int S, int n_lines,
                        int C, int H, int cs_, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int L = S - (KS - 1);
  const long long NL = (long long)n_lines * L;
  // Positions and offsets are ints where they fit: x below 2^30 floats,
  // dgates below 2^31.
  if ((long long)S * n_lines * C > 0x3fffffffLL || 8LL * n_lines * L * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // 1. the reverse sweeps, dh from the deconv fused in -> dgates.
  SweepLaunch W;
  cudaError_t err = sweep_launch_config(W, C, H, cs_, lines, (n_lines + lines - 1) / lines,
                                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&W.cfg, W.fn, doutf, doutb, gates, cs, w_hh, wd, dgates, S, C, H,
                           n_lines, W.plan.uc, W.plan.cc, W.plan.kp, W.plan.lbp);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2. dx, both directions summed.
  const size_t dsm = dx_smem(C);
  err = cudaFuncSetAttribute(train_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dsm);
  if (err != cudaSuccess) return err;
  train_dx_kernel<<<dim3(n_lines, (S + DX_R - 1) / DX_R), DxTile::THREADS, dsm, stream>>>(
      dgates, w_ih, dx, S, n_lines, C, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. dW_ih | dW_hh | db as one product, then dW_deconv.
  const GradSplits g = grad_splits_of(NL, C, H);
  const int M = KS * C + H + 1, N = 4 * H;
  const bool vec = H % 4 == 0 && aligned16(x) && aligned16(hs);
  auto wg = vec ? train_wgrad_kernel<true> : train_wgrad_kernel<false>;
  err = cudaFuncSetAttribute(wg, cudaFuncAttributeMaxDynamicSharedMemorySize, WgTile::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  wg<<<dim3((M + WgTile::BM - 1) / WgTile::BM, (N + WgTile::BN - 1) / WgTile::BN, 2 * g.s1),
       WgTile::THREADS, WgTile::SMEM_BYTES, stream>>>(x, hs, dgates, work, n_lines, L, C, H, g.s1,
                                                      split_depth(NL, g.s1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dw = vec ? train_dwd_kernel<true> : train_dwd_kernel<false>;
  err = cudaFuncSetAttribute(dw, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DwdTile::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  float* work2 = work + g.floats1;
  dw<<<dim3((H + DwdTile::BM - 1) / DwdTile::BM, (KS * C + DwdTile::BN - 1) / DwdTile::BN,
            2 * g.s2),
       DwdTile::THREADS, DwdTile::SMEM_BYTES, stream>>>(doutf, doutb, hs, work2, n_lines, L, C,
                                                        H, g.s2, split_depth(NL, g.s2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 4. the splits, in a fixed order.
  const long long outs = 2LL * M * N + 2LL * H * KS * C;
  grad_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, stream>>>(
      work, g.s1, work2, g.s2, dw_ih, dw_hh, dbias, dwd, C, H);
  return cudaGetLastError();
}

// The card's most clusters of the sweep's plan (cs, lines) at widths C, H
// that can run at once (cudaOccupancyMaxActiveClusters), 0 if the plan does
// not fit a block, or minus a CUDA error.
int grid_train_sweep_max_clusters(int C, int H, int cs, int lines) {
  SweepLaunch W;
  cudaError_t err = sweep_launch_config(W, C, H, cs, lines, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, W.fn, &W.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory of a block of the sweep's plan, or -1 if it does not fit.
long long grid_train_sweep_smem(int C, int H, int cs, int lines) {
  SweepPlan p;
  return sweep_plan(C, H, cs, lines, p) ? p.bytes : -1;
}

}  // extern "C"
