// TF-GridNet RNN path on the canvas: unfold(k=4) -> BiLSTM -> deconv(k=4)
// -> overlap-add, for both directions, as two kernels; for serving (kernel
// 1), for the summed fold without a gradient (kernel 4) and, with the
// stashes of its backward, for training (kernel 5).
//
// Replaces fdbm_tpu/ops/gridrnn.py:grid_rnn_seq1_pair (the Pallas
// _canvas_kernel and its _advance_and_fold core), which does the whole path
// per grid cell in VMEM, each step one product of [window | h] against the
// stacked [W_ih; W_hh]; fdbm_tpu/ops/gridrnn.py:grid_bilstm_fold (:217,
// _grid_kernel), the same path on sequence-major lines [S, lines, C] (the
// canvas with B = 1, P = lines) with both directions summed; and the
// forward of fdbm_tpu/ops/gridrnn_train.py:grid_fold_train_pair (_fwd_call
// :217, _fwd_kernel), the same lines with the per-direction folds and
// stashes. Shapes: x [B, S, P, C] with the
// sequence on axis 1 and P batch-like, so each (b, p) is one independent
// line of S rows;
// L = S - 3 unfold windows per line; w_ih [2, 4C, 4H] tap-major rows,
// w_hh [2, H, 4H], bias [2, 4H] (gates i, f, g, o), wd [2H, 4C] tap-major
// columns. Returns the unsummed per-direction folds outf, outb [B, S, P, C]
// (no deconv bias), exact on every row; the model reads rows [3, L-1].
//
// What bounds it on the H100: the FMAs of the stacked product, 2 x (4C + H)
// x 4H per line and step, issued with the shared-memory loads that feed
// them, and the latency of the recurrence's chain. Each of the L steps of a
// line needs the whole previous hidden state, so only the window part of a
// step (4C of the 4C + H rows) is free of the chain; at the main path's
// shape (263 lines, C = 32, H = 100) a one-wave grid puts 8 lines of one
// direction on each SM, so each step's FMAs are spread over few warps.
//
// What the design does about it:
//   1. gridrnn_fused_kernel runs the TPU kernel's design on thread-block
//      clusters: CS blocks (2 at C = 32, H = 100) share one tile of lines of
//      one direction; block r owns H/CS units and holds their gate columns
//      of the stacked [W_ih; W_hh] in shared memory for the whole sweep
//      (182 KB at CS = 2). The canvas rows reach shared memory through a
//      ring filled by cp.async six rows ahead, one new row of C floats per
//      line and step, so the pre-activations never exist in device memory.
//      Per step, on a tile of 8 lines, eight lanes split the sum over k of a
//      pair of units (per k two float4 of weights and two of rows for 64
//      FMAs, so that fewer loads are issued per FMA); on a tile of 16 lines,
//      four lanes split that of one unit (one float4 of weights and four of
//      rows for 64 FMAs), so that a lane's 64 sums stay in registers. A
//      reduce-scatter of shuffles leaves each lane the gates of its share
//      of the lines, the cell runs in registers (fast exponential and
//      division for serving), and the lane writes h into every block of
//      the cluster (distributed shared memory). One cluster barrier
//      per step, split: after its arrive a block computes the next step's
//      window part (independent of h), which fills the barrier's latency,
//      then waits. The wrapper (ops/gridrnn.py: fused_plan) sizes the
//      clusters and tiles so that the grid is one wave on the card.
//      With STASH (kernel 5) the cell takes the accurate activations and
//      also writes what the reverse sweep of gridrnn_train.cu reads: the
//      activated gates of a unit as one float4 and c; the lane holds both
//      in registers, so the stash costs stores only (2 x lines x L x 5H
//      floats, beside h).
//   2. fold_kernel (gridrnn_core.cuh) computes the deconv projection as a
//      tiled product over the hidden states and does the 4-tap overlap-add
//      from shared memory, writing each output row once, in canvas layout.
// The hidden states cross device memory once (2 x lines x L x H floats).
// The training shapes (524 or 526 lines a direction) run one wave of 66
// clusters of 2 blocks of 16 lines, kernel 5 (ops/gridrnn_train.py:
// train_fwd_plan) and kernel 4 (ops/gridrnn.py: fused_plan) alike; kernel 4
// is kernel 1's kernel on those lines, the fold summing both directions.
//
// Kernel 1's bf16 form (gridrnn_seq1_pair_bf16; inference_dtype=bfloat16,
// fdbm_tpu/ops/gridrnn.py:467,514-515,550-553): the canvas, h and the outputs
// are bf16 in device memory; w_ih, w_hh and wd are rounded to bf16 as they are
// staged (the TPU kernel ships them pre-cast); h is rounded to bf16 before it
// enters the next step's product and the deconv; the sums, the bias, c and
// the gates stay fp32, as in the TPU kernel's bf16 path.
// What bounds it on the H100: the recurrence's chain. Its 28.4 GFLOP at the
// main path's shape (263 lines, L = 260, C = 32, H = 100) take 29 us at the
// bf16 tensor cores' 989 TFLOP/s (0.46 ms at the folder's 4208 lines), and
// its bytes less; but each of the 260 steps waits for the last step's h: the
// h product (112 of the 240 rows), the cell and a barrier are on the chain,
// and a step reads the block's whole stacked weight from shared memory (192
// KB at CS = 1: about 1500 cycles at the SM's 128 bytes a cycle). Measured
// on the H100 (chip_smoke.py --probe-bf16: clock stamps in one block, PERF.md):
// a step at the main path's shape takes 7500-8100 cycles, in phases that
// every warp runs in step with the others: the h product (2300-2600), the
// cell (about 1800: ten MUFU operations a cell, which the SM issues at 16 a
// cycle) and the next window (2500-2800). A cluster of 2 blocks halves each
// block's products but adds the cluster barrier and the remote writes of h
// (about 800 cycles at the arrive alone) and measured no faster; the plan
// takes what the card's counts favour.
// Design (gridrnn_mma_kernel): a block takes a tile of 16 or 32 lines (one or
// two M tiles of mma) of one direction and the gate columns of
// H / CS units. A step is gates[lines x 16 quads] = [window | h] . [W_ih;
// W_hh] on mma.sync m16n8k16, bf16 operands by ldmatrix from shared memory,
// fp32 sums. The staged weight columns are ordered so that a quad of units is
// two n8 tiles, (i, f) of its four units and then (g, o): a lane's
// accumulators hold all four gates of its (line, unit) cells, so the cell
// runs in registers, c in fp32, with no shuffle. h is rounded to bf16 and
// written into the next step's h buffer (every cluster block's, through
// distributed shared memory, when CS > 1), from which the next step loads its
// A fragments. The weights stay bf16 in shared memory, swizzled so that
// ldmatrix reads them without bank conflicts: at half the fp32 bytes the
// whole stacked weight of one direction fits one block, so CS = 1 becomes
// possible, and there a step synchronises on the block's own mbarrier, not a
// cluster barrier. The canvas rows reach a bf16 ring by raw 16-byte cp.async
// (a line's 32 channels are 64 contiguous bytes), seven rows ahead. The
// window part (4C of the depth) is off the chain: it runs after the arrive.
// The plan (CS, lines a tile) comes from the wrapper (ops/gridrnn.py:
// mma_plan), sized from the card's cluster occupancy; the fold is
// gridrnn_core.cuh's fold_kernel on bf16 h, as before.
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "gridrnn_core.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FR_MAX_THREADS = 256;
constexpr int FR_RING = 8;          // canvas rows a block holds
constexpr int FR_AHEAD = 6;         // rows staged ahead of the first step that reads them
constexpr int FR_STAGE = 4;         // canvas floats a thread copies per staged row
constexpr long long FR_SMEM = 232448;  // a block's shared memory on the H100 (227 KB)

struct FusedPlan {
  int uc;   // units per block
  int wst;  // row stride of ws: 4 * uc padded to 8 (mod 32) floats, so the
            // lanes of a quarter warp read rows that fall in other banks
  int lbp;  // row stride of h and of the staged rows: lines padded so that
            // lbp / 4 is odd (same reason)
  int nt;   // threads: the lanes of every group of units (FusedLanes, and at
            // least a quarter of a staged row's floats), whole warps
  long long bytes;
};

// The lanes of a tile of LINES lines: KSL lanes split the sum over k of a
// group of UPL units, so a lane sums UPL x LINES x 4 gates (64 either way,
// which keeps them in registers): eight lanes per pair of units for 8
// lines, four lanes per unit for 16.
template <int LINES>
struct FusedLanes {
  static_assert(LINES == 8 || LINES == 16, "tiles of 8 or 16 lines");
  static constexpr int KSL = LINES == 8 ? 8 : 4, UPL = LINES == 8 ? 2 : 1;
  static constexpr int LQ = LINES / KSL;  // lines of a lane's cells
};

int fused_lanes(int lines, int uc) {
  return lines == 8 ? FusedLanes<8>::KSL * ((uc + 1) / 2) : FusedLanes<16>::KSL * uc;
}

bool fused_plan(int C, int H, int cs, int lines, FusedPlan& p) {
  if (H < 1 || C < 1 || (cs != 1 && cs != 2 && cs != 4 && cs != 8)) return false;
  if (lines != 8 && lines != 16) return false;
  p.uc = (H + cs - 1) / cs;
  p.wst = 4 * p.uc + (8 - (4 * p.uc) % 32 + 32) % 32;
  p.lbp = (lines / 4) % 2 ? lines : lines + 4;
  const int stagers = (lines * C + FR_STAGE - 1) / FR_STAGE;
  const int lanes = fused_lanes(lines, p.uc);
  p.nt = ((lanes > stagers ? lanes : stagers) + 31) / 32 * 32;
  p.bytes = 4LL * ((long long)(KS * C + H) * p.wst + 2LL * H * p.lbp +
                   (long long)FR_RING * C * p.lbp);
  return p.nt <= FR_MAX_THREADS && p.bytes <= FR_SMEM;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float v, const float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// acc[u][l][g] += sum over the lane's k of rows[k][l] * ws[k][4 j_u + g] for
// the UPL units of the lane and the LINES lines: k = ks, ks + KSL, ... < n
// of a [n][lbp] block of rows; w[u] points at unit u's columns of row 0.
// Per k UPL float4 of weights and LINES/4 float4 of rows for 4 x UPL x
// LINES FMAs.
template <int LINES>
__device__ __forceinline__ void fused_sum(
    float (&acc)[FusedLanes<LINES>::UPL][LINES][4], const float* const (&w)[FusedLanes<LINES>::UPL],
    int wst, const float* rows, int lbp, int n, int ks) {
  using F = FusedLanes<LINES>;
#pragma unroll 2
  for (int k = ks; k < n; k += F::KSL) {
    float4 wv[F::UPL];
#pragma unroll
    for (int u = 0; u < F::UPL; ++u) wv[u] = *reinterpret_cast<const float4*>(w[u] + k * wst);
    const float4* rk = reinterpret_cast<const float4*>(rows + k * lbp);
#pragma unroll
    for (int l4 = 0; l4 < LINES / 4; ++l4) {
      const float4 v = rk[l4];
#pragma unroll
      for (int u = 0; u < F::UPL; ++u) {
        fma4(acc[u][4 * l4], v.x, wv[u]);
        fma4(acc[u][4 * l4 + 1], v.y, wv[u]);
        fma4(acc[u][4 * l4 + 2], v.z, wv[u]);
        fma4(acc[u][4 * l4 + 3], v.w, wv[u]);
      }
    }
  }
}

// The cell's activations: mma_bf16.cuh's fast_sigmoid and fast_tanh (they
// sit on the step's chain).

// The training forward (ACCURATE) takes the accurate ones: its gradient is
// held to 1e-3 of the plain route's on every leaf of a training step, and
// fast_tanh's absolute error (about 1e-7 near 0, from 2 sigmoid - 1) moves
// the leaves whose gradients are mostly rounding (the q/k norms') past it.
template <bool ACCURATE>
__device__ __forceinline__ float cell_sigmoid(float v) {
  return ACCURATE ? 1.f / (1.f + expf(-v)) : fast_sigmoid(v);
}
template <bool ACCURATE>
__device__ __forceinline__ float cell_tanh(float v) {
  return ACCURATE ? tanhf(v) : fast_tanh(v);
}

// The lane order of a warp. Eight lanes per pair: lane bits 0-1 and 3 are
// ks bits 0-1 and 2, lane bits 2 and 4 pick the pair, so a quarter warp is
// two pairs x four ks; four lanes per unit: lane bits 0-1 are ks, the rest
// pick the unit, so a quarter warp is two units x four ks (either way its
// rows and columns fall in 32 different banks).
template <int LINES>
__device__ __forceinline__ int lane_ks(int t) {
  return LINES == 8 ? (t & 3) | ((t >> 1) & 4) : t & 3;
}
template <int LINES>
__device__ __forceinline__ int lane_group(int t) {
  return LINES == 8 ? (t >> 5) * 4 + ((t >> 2) & 1) + ((t >> 3) & 2) : t >> 2;
}

// One stage of a reduce-scatter over lanes: a lane keeps the lower or upper
// HALF lines (hi_half) of its sums plus the partner's (lane mask `mask`).
// HALF is a template constant so that every index into acc is one, and acc
// stays in registers.
template <int HALF, int UPL, int LINES>
__device__ __forceinline__ void rs_stage(float (&acc)[UPL][LINES][4], bool hi_half, int mask) {
#pragma unroll
  for (int u = 0; u < UPL; ++u)
#pragma unroll
    for (int l = 0; l < HALF; ++l)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float lo = acc[u][l][g], hi = acc[u][l + HALF][g];
        const float send = hi_half ? lo : hi;
        acc[u][l][g] = (hi_half ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, mask);
      }
}

// Reduce-scatter over a group's KSL lanes (eight: ks bits 2, 1, 0 at lane
// masks 8, 2, 1; four: ks bits 1, 0 at lane masks 2, 1): lane ks keeps the
// sums of lines ks*LQ .. ks*LQ + LQ - 1 of its units in acc[u][0 .. LQ).
template <int LINES>
__device__ __forceinline__ void lane_reduce_scatter(
    float (&acc)[FusedLanes<LINES>::UPL][LINES][4], int ks) {
  if constexpr (FusedLanes<LINES>::KSL == 8) {
    rs_stage<LINES / 2>(acc, ks & 4, 8);
    rs_stage<LINES / 4>(acc, ks & 2, 2);
    rs_stage<LINES / 8>(acc, ks & 1, 1);
  } else {
    rs_stage<LINES / 2>(acc, ks & 2, 2);
    rs_stage<LINES / 4>(acc, ks & 1, 1);
  }
}

// x [B][S][P][C] canvas, w_ih [2][4C][4H], w_hh [2][H][4H], bias [2][4H] ->
// hout [2][lines][L][H]. With STASH (the training forward, kernel 5) it also
// writes what the reverse sweep of gridrnn_train.cu reads: the activated
// gates gout [2][lines][L][H][4] (i, f, g, o of a unit as one float4) and the
// cell states cout [2][lines][L][H]. grid (CS * tiles, 2), clusters of CS
// blocks along x.
// Block r owns units [r*uc, (r+1)*uc) and their four gate columns of the
// stacked weights: ws[k][4j + g] = [W_ih; W_hh][k][g*H + r*uc + j]. Shared
// memory: ws [4C + H][wst], h [2][H][lbp] (double-buffered, its own copy of
// the tile's state), the ring of canvas rows [FR_RING][C][lbp]. Sequence row
// t of direction d is canvas row t (d = 0) or S - 1 - t (d = 1); step s of
// the direction reads rows s .. s + 3 of that order. Lane ks of group jg
// owns units jg + u * groups (u < UPL).
template <int LINES, bool STASH>
__global__ void __launch_bounds__(FR_MAX_THREADS, 1)
gridrnn_fused_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh, const float* __restrict__ bias,
                     float* __restrict__ hout, float* __restrict__ gout, float* __restrict__ cout,
                     int S, int P, int C, int H, int n_lines, int uc, int wst, int lbp) {
  extern __shared__ __align__(16) float smem[];
  using F = FusedLanes<LINES>;
  constexpr int UPL = F::UPL, LQ = F::LQ;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = 4 * H, KW = KS * C, L = S - (KS - 1);
  const int d = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int line0 = (blockIdx.x / cs) * LINES;
  const int u0 = rank * uc;
  float* ws = smem;                              // [KW + H][wst]
  float* hb = ws + (long long)(KW + H) * wst;    // [2][H][lbp]
  float* ring = hb + 2 * H * lbp;                // [FR_RING][C][lbp]
  const float* wi = w_ih + (long long)d * KW * N;
  const float* wh = w_hh + (long long)d * H * N;
  for (int e = tid; e < (KW + H) * 4 * uc; e += nt) {
    const int k = e / (4 * uc), g = (e / uc) % 4, j = e % uc;
    const int col = g * H + u0 + j;
    float v = 0.f;
    if (u0 + j < H) v = k < KW ? wi[(long long)k * N + col] : wh[(long long)(k - KW) * N + col];
    ws[k * wst + 4 * j + g] = v;
  }
  for (int e = tid; e < 2 * H * lbp; e += nt) hb[e] = 0.f;
  // The thread's floats of a staged row: (line l, channel c) for e = l * C +
  // c = tid + i * nt, at canvas offset src + row * P * C, ring offset dst.
  long long st_src[FR_STAGE];
  int st_dst[FR_STAGE];
  bool st_ok[FR_STAGE];
#pragma unroll
  for (int i = 0; i < FR_STAGE; ++i) {
    const int e = tid + i * nt, l = e / C, c = e % C, line = line0 + l;
    st_ok[i] = e < LINES * C && line < n_lines;
    st_src[i] = st_ok[i] ? ((long long)(line / P) * S * P + line % P) * C + c : 0;
    st_dst[i] = c * lbp + l;
  }
  // Sequence row t of the tile's lines into ring slot t % FR_RING, c-major,
  // by cp.async.
  auto stage_row = [&](int t) {
    const long long roff = (long long)(d == 0 ? t : S - 1 - t) * P * C;
    float* dst = ring + (t % FR_RING) * C * lbp;
#pragma unroll
    for (int i = 0; i < FR_STAGE; ++i)
      if (tid + i * nt < LINES * C)
        cp_async_to<4>(dst + st_dst[i], st_ok[i] ? x + st_src[i] + roff : x, st_ok[i]);
  };
  for (int t = 0; t < FR_AHEAD && t < S; ++t) stage_row(t);
  cp_async_commit_group();
  cp_async_wait_groups<0>();

  // Group jg of `groups` owns units jg + u * groups (u < UPL). Lanes past
  // the last group repeat its product (every lane of a warp takes part in
  // the shuffles) and own nothing.
  const int ks = lane_ks<LINES>(tid), groups = (uc + UPL - 1) / UPL;
  const int jg = min(lane_group<LINES>(tid), groups - 1);
  const bool has_group = lane_group<LINES>(tid) < groups;
  int units[UPL], col[UPL];
  bool owner[UPL];
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
    units[u] = u0 + jg + u * groups;
    col[u] = 4 * min(jg + u * groups, uc - 1);
    owner[u] = has_group && jg + u * groups < uc && units[u] < H;
  }
  const int lq0 = ks * LQ;  // this lane's cells: lines lq0 .. lq0 + LQ - 1 of the tile
  float bv[UPL][4], c_state[UPL][LQ];
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bv[u][g] = owner[u] ? bias[d * N + g * H + units[u]] : 0.f;
#pragma unroll
    for (int q = 0; q < LQ; ++q) c_state[u][q] = 0.f;
  }
  const float* wh_cols[UPL];  // the units' columns of the w_hh rows of ws
#pragma unroll
  for (int u = 0; u < UPL; ++u) wh_cols[u] = ws + KW * wst + col[u];
  float acc[UPL][LINES][4];
  // The window part of step s: taps i = 0 .. 3 are sequence rows s + i
  // (d = 0) or s + 3 - i (d = 1).
  auto window = [&](int s) {
#pragma unroll
    for (int u = 0; u < UPL; ++u)
#pragma unroll
      for (int l = 0; l < LINES; ++l)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[u][l][g] = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int t = d == 0 ? s + i : s + KS - 1 - i;
      const float* wrow = ws + i * C * wst;
      const float* wp[UPL];
#pragma unroll
      for (int u = 0; u < UPL; ++u) wp[u] = wrow + col[u];
      fused_sum<LINES>(acc, wp, wst, ring + (t % FR_RING) * C * lbp, lbp, C, ks);
    }
  };
  cluster.sync();  // weights, h and the first rows in place in every block
  window(0);

  for (int s = 0; s < L; ++s) {
    const int p = d == 0 ? s : L - 1 - s;
    const float* hcur = hb + (s & 1) * H * lbp;
    float* hnext = hb + ((s + 1) & 1) * H * lbp;
    if (s > 0) cluster_wait();  // every block's h of the last step is in hcur
    fused_sum<LINES>(acc, wh_cols, wst, hcur, lbp, H, ks);
    lane_reduce_scatter<LINES>(acc, ks);
#pragma unroll
    for (int u = 0; u < UPL; ++u)
#pragma unroll
      for (int q = 0; q < LQ; ++q) {
        const float ig = cell_sigmoid<STASH>(acc[u][q][0] + bv[u][0]);
        const float fg = cell_sigmoid<STASH>(acc[u][q][1] + bv[u][1]);
        const float gg = cell_tanh<STASH>(acc[u][q][2] + bv[u][2]);
        const float og = cell_sigmoid<STASH>(acc[u][q][3] + bv[u][3]);
        c_state[u][q] = fg * c_state[u][q] + ig * gg;
        const float h = og * cell_tanh<STASH>(c_state[u][q]);
        if (!owner[u]) continue;
        for (int r = 0; r < cs; ++r)
          cluster.map_shared_rank(hnext, r)[units[u] * lbp + lq0 + q] = h;
        const int line = line0 + lq0 + q;
        if (line >= n_lines) continue;
        const long long at = (((long long)d * n_lines + line) * L + p) * H + units[u];
        hout[at] = h;
        if constexpr (STASH) {
          reinterpret_cast<float4*>(gout)[at] = make_float4(ig, fg, gg, og);
          cout[at] = c_state[u][q];
        }
      }
    // Row s + 6 starts its copy; row s + 5 (copied by this thread) is
    // complete before the arrive, so every thread may read it after the
    // next wait.
    if (s + FR_AHEAD < S) stage_row(s + FR_AHEAD);
    cp_async_commit_group();
    cp_async_wait_groups<1>();
    cluster_arrive();
    if (s + 1 < L) window(s + 1);
  }
  cluster_wait();  // no block leaves while another may still write its h
}

using FusedKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                             float*, float*, int, int, int, int, int, int, int, int);

FusedKernel fused_kernel(int lines, bool stash) {
  switch (lines) {
    case 8: return stash ? gridrnn_fused_kernel<8, true> : gridrnn_fused_kernel<8, false>;
    case 16: return stash ? gridrnn_fused_kernel<16, true> : gridrnn_fused_kernel<16, false>;
    default: return nullptr;
  }
}

struct FusedLaunch {
  FusedPlan plan;
  FusedKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t fused_launch_config(FusedLaunch& F, int C, int H, int cs, int lines, bool stash,
                                int tiles, cudaStream_t stream) {
  if (!fused_plan(C, H, cs, lines, F.plan)) return cudaErrorInvalidValue;
  F.fn = fused_kernel(lines, stash);
  if (F.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(F.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F.plan.bytes));
  if (err != cudaSuccess) return err;
  F.cfg = {};
  F.cfg.gridDim = dim3(cs * tiles, 2);
  F.cfg.blockDim = dim3(F.plan.nt);
  F.cfg.dynamicSmemBytes = F.plan.bytes;
  F.cfg.stream = stream;
  F.attr[0].id = cudaLaunchAttributeClusterDimension;
  F.attr[0].val.clusterDim.x = cs;
  F.attr[0].val.clusterDim.y = 1;
  F.attr[0].val.clusterDim.z = 1;
  F.cfg.attrs = F.attr;
  F.cfg.numAttrs = 1;
  return cudaSuccess;
}


// ---- kernel 1's bf16 form on the tensor cores ---------------------------------------
constexpr int GM_RING = 8;    // canvas rows a block holds
constexpr int GM_AHEAD = 7;   // row s + 7 is staged at step s
constexpr int GM_QPW = 2;     // unit quads a warp
constexpr int GM_MAX_THREADS = 512;
constexpr int GM_STAGE = 4;   // 16-byte copies a thread stages a row, at most

// Clock stamps of the bf16 step by phase, compiled in only with -DGM_STAMPS
// (chip_smoke.py --probe-bf16, which reads them with gm_read_stamps):
// clock64 of lane 0 of the first and the last warp of block (0, 0) at steps
// 10-41, six a step (GM_STEP_STAMP(j), inside the step loop), and the
// globaltimer of every block at entry, after the prologue and after the steps
// (GM_BLOCK_STAMP(j)).
#ifdef GM_STAMPS
constexpr int GM_STAMP_BLOCKS = 4096;
__device__ long long g_steps[2 * 32 * 6];
__device__ unsigned long long g_blocks[GM_STAMP_BLOCKS * 3];
#define GM_STEP_STAMP(j)                                                                     \
  if (lane == 0 && blockIdx.x == 0 && blockIdx.y == 0 && (warp == 0 || warp == p.nw - 1) &&  \
      s >= 10 && s < 42)                                                                     \
    g_steps[((warp == 0 ? 0 : 1) * 32 + s - 10) * 6 + (j)] = clock64();
#define GM_BLOCK_STAMP(j)                                                                    \
  {                                                                                          \
    unsigned long long t_;                                                                   \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                                   \
    const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x;                                 \
    if (threadIdx.x == 0 && b_ < GM_STAMP_BLOCKS) g_blocks[b_ * 3 + (j)] = t_;               \
  }
#else
#define GM_STEP_STAMP(j)
#define GM_BLOCK_STAMP(j)
#endif

// A block's share of the stacked product gates[lines][16 quads] =
// [window | h][lines][kt] . W[kt][16 quads] for one tile of lines of one
// direction. Quad q holds units 4q .. 4q + 3 of the block as two n8 tiles,
// (i, f) of the four units in the first and (g, o) in the second, so that
// lane 4 g + t4 of a warp finds all four gates of unit 4q + t4 for lines g
// and g + 8 of each m16 tile in its accumulators.
struct MmaPlan {
  int cs, mt, lines;  // blocks a cluster; m16 tiles of lines a block, 1 or 2 (lines = 16 mt)
  int uc;             // units a block, ceil(H / cs)
  int quads;          // ceil(uc / 4)
  int n;              // gate columns a block, 16 quads
  int kw, kh, kt;     // depth: the window's 4C, h's H padded to 16 (zero rows), both
  int cch;            // 16-byte chunks a line of a ring row: C / 8, made odd
  int nw, nt;         // warps (GM_QPW quads each) and threads; they stage a row's lines
                      // x C / 8 copies, GM_STAGE at most a thread
  long long w_bytes, h_bytes, r_bytes, bytes;
};

bool mma_plan(int C, int H, int cs, int mt, MmaPlan& p) {
  if (C < 8 || C % 8 || C > FOLD_MAX_C || H < 1 || H > MAX_H) return false;
  if ((cs != 1 && cs != 2 && cs != 4 && cs != 8) || (mt != 1 && mt != 2)) return false;
  p.cs = cs;
  p.mt = mt;
  p.lines = 16 * mt;
  p.uc = (H + cs - 1) / cs;
  p.quads = (p.uc + 3) / 4;
  p.n = 16 * p.quads;
  p.kw = KS * C;
  p.kh = (H + 15) / 16 * 16;
  p.kt = p.kw + p.kh;
  p.cch = (C / 8) % 2 ? C / 8 : C / 8 + 1;
  p.nw = (p.quads + GM_QPW - 1) / GM_QPW;
  p.nt = 32 * p.nw;
  p.w_bytes = 2LL * p.kt * p.n;
  p.h_bytes = 2LL * 2 * p.kh * p.lines;
  p.r_bytes = 16LL * GM_RING * p.lines * p.cch;
  p.bytes = p.w_bytes + p.h_bytes + p.r_bytes + 16;  // and the block's mbarrier
  return p.nt <= GM_MAX_THREADS && p.bytes <= FR_SMEM && p.lines * (C / 8) <= GM_STAGE * p.nt;
}

// x [B][S][P][C] bf16 canvas, w_ih [2][4C][4H], w_hh [2][H][4H], bias [2][4H]
// fp32 -> hout [2][lines][L][H] bf16. grid (CS * tiles, 2), clusters of CS
// blocks along x, p.nt threads. Block r owns units [r*uc, (r+1)*uc) of one
// tile of 16 MT lines and direction. Shared memory: the block's gate columns
// of [W_ih; W_hh] rounded to bf16, [kt / 16][n] swizzled tiles (192 KB at
// C = 32, H = 100, CS = 1); h [2][kh / 16][lines] swizzled tiles (double
// buffered; with CS > 1 every block holds the whole tile's h); the ring of
// canvas rows [GM_RING][lines][cch][8]; an mbarrier (CS = 1). Sequence row t
// of direction d is canvas row t (d = 0) or S - 1 - t (d = 1); step s reads
// rows s .. s + 3 of that order.
template <int MT, bool CLUSTER>
__global__ void __launch_bounds__(GM_MAX_THREADS, 1)
gridrnn_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w_ih,
                   const float* __restrict__ w_hh, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ hout, int S, int P, int C, int H, int n_lines,
                   MmaPlan p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char gm_smem[];
  constexpr int LINES = 16 * MT;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = CLUSTER ? static_cast<int>(cluster.block_rank()) : 0;
  const int N = 4 * H, KW = p.kw, L = S - (KS - 1), n = p.n;
  const int d = blockIdx.y;
  const int tid = threadIdx.x, nt = p.nt, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int line0 = (blockIdx.x / p.cs) * LINES;
  const int u0 = rank * p.uc;
  GM_BLOCK_STAMP(0)
  bf16* ws = reinterpret_cast<bf16*>(gm_smem);
  bf16* hb = reinterpret_cast<bf16*>(gm_smem + p.w_bytes);
  bf16* ring = reinterpret_cast<bf16*>(gm_smem + p.w_bytes + p.h_bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(gm_smem + p.w_bytes + p.h_bytes + p.r_bytes);
  const int h_buf = (p.kh / 16) * LINES * 16;  // elements of one h buffer

  // The gate columns, rounded to bf16: column 16 q + 8 (gate / 2) + 2 (j % 4)
  // + gate % 2 holds gate `gate` of local unit j = 4 q + j % 4. A warp takes
  // a row k at a time, its lanes consecutive units of each gate, and issues
  // the row's loads (4 gates x up to 4 runs of 32 units) before its stores.
  {
    const int uq = 4 * p.quads;
    for (int k = warp; k < p.kt; k += p.nw) {
      const float* wrow = k < KW ? w_ih + ((long long)d * KW + k) * N
                                 : w_hh + ((long long)d * H + (k - KW)) * N;
      const bool real = k < KW || k - KW < H;
      float val[4][4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = lane + 32 * r;
          val[gate][r] = real && j < p.uc && u0 + j < H ? wrow[gate * H + u0 + j] : 0.f;
        }
      bf16* wk = ws + (k >> 4) * n * 16;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = lane + 32 * r;
          if (j < uq)
            wk[swz(k, (j >> 2) * 16 + (gate >> 1) * 8 + (j & 3) * 2 + (gate & 1))] =
                __float2bfloat16(val[gate][r]);
        }
    }
  }
  for (int e = tid; e < 2 * h_buf; e += nt) hb[e] = __float2bfloat16(0.f);
  // Sequence row t of the tile's lines into ring slot t % GM_RING: a line's C
  // channels are C / 8 raw 16-byte copies (zeros past the last line). A
  // thread's copies (e = tid + i * nt < lines * C / 8, at most GM_STAGE) keep
  // their canvas offset without the row, and their ring offset.
  const int cpl = C / 8, slot = LINES * p.cch * 8;
  long long st_src[GM_STAGE];
  int st_dst[GM_STAGE];
  bool st_ok[GM_STAGE], st_on[GM_STAGE];
#pragma unroll
  for (int i = 0; i < GM_STAGE; ++i) {
    const int e = tid + i * nt, l = e / cpl, ch = e - l * cpl, line = line0 + l;
    st_on[i] = e < LINES * cpl;
    st_ok[i] = st_on[i] && line < n_lines;
    st_src[i] = st_ok[i] ? ((long long)(line / P) * S * P + line % P) * C + ch * 8 : 0;
    st_dst[i] = (l * p.cch + ch) * 8;
  }
  auto stage_row = [&](int t) {
    const long long roff = (long long)(d == 0 ? t : S - 1 - t) * P * C;
    bf16* dst = ring + (t % GM_RING) * slot;
#pragma unroll
    for (int i = 0; i < GM_STAGE; ++i)
      if (st_on[i]) cp_async_16(dst + st_dst[i], st_ok[i] ? x + st_src[i] + roff : x, st_ok[i]);
  };
  for (int t = 0; t < GM_AHEAD && t < S; ++t) stage_row(t);
  cp_async_commit_raw();
  cp_async_wait_raw(0);
  if constexpr (!CLUSTER) {
    if (tid == 0) block_bar_init(bar, p.nw);  // one arrival a warp
  }

  // The warp's quads warp + i * nw; a lane's cells: unit 4 q + t4 of the
  // block at lines m * 16 + g + 8 hr of the tile.
  int unit[GM_QPW];
  bool has_quad[GM_QPW], owner[GM_QPW];
  float bv[GM_QPW][4], c_state[MT][GM_QPW][2];
  const bf16* wb[GM_QPW];  // the quad's B fragments: lane's row and chunk of k-tile 0
#pragma unroll
  for (int i = 0; i < GM_QPW; ++i) {
    const int q = warp + i * p.nw, j = 4 * q + t4;
    has_quad[i] = q < p.quads;
    unit[i] = u0 + j;
    owner[i] = has_quad[i] && j < p.uc && unit[i] < H;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
      bv[i][gate] = owner[i] ? bias[d * N + gate * H + unit[i]] : 0.f;
    const int bcol = 16 * min(q, p.quads - 1) + (lane & 7) + (lane >> 4) * 8;
    wb[i] = ws + swz(((lane >> 3) & 1) * 8, bcol);
#pragma unroll
    for (int m = 0; m < MT; ++m) c_state[m][i][0] = c_state[m][i][1] = 0.f;
  }
  // The cells' offsets in an h buffer and, from the step's row of hout, in
  // hout (-1: not written, a unit past H or a line past the last).
  int h_at[GM_QPW][MT][2], o_at[GM_QPW][MT][2];
#pragma unroll
  for (int i = 0; i < GM_QPW; ++i)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int line = m * 16 + g + 8 * hr;
        h_at[i][m][hr] = owner[i] ? (unit[i] / 16) * LINES * 16 + swz(unit[i], line) : -1;
        o_at[i][m][hr] = owner[i] && line0 + line < n_lines ? line * L * H + unit[i] : -1;
      }
  // A fragments: rows (lines) lane & 15 of each m16 tile, chunk lane >> 4.
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int h_off = swz(a_k, a_row);
  float acc[MT][GM_QPW][2][4];
  auto products = [&](int kk, const unsigned (&a)[MT][4]) {
#pragma unroll
    for (int i = 0; i < GM_QPW; ++i) {
      if (!has_quad[i]) continue;
      unsigned bw[4];
      ldsm_x4(bw, wb[i] + kk * n * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][i][0], a[m], bw[0], bw[1]);
        mma_bf16(acc[m][i][1], a[m], bw[2], bw[3]);
      }
    }
  };
  // The window part of step s, off the chain: taps i = 0 .. 3 are sequence
  // rows s + i (d = 0) or s + 3 - i (d = 1); k-tile kk covers taps and
  // channels by k = tap * C + c.
  const bf16* ring_lane = ring + a_row * p.cch * 8;
  auto window = [&](int s) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < GM_QPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][0][e] = acc[m][i][1][e] = 0.f;
    // The lane's k = kk * 16 + a_k is tap `tap`, channel c, kept without a
    // division (one costs the MT = 1 form spills and 7 % at B = 1); a_k = 8
    // is already tap 1 at C = 8.
    const int t0 = d == 0 ? s : s + KS - 1, dt = d == 0 ? 1 : -1;
    int tap = 0, c = a_k;
    for (; c >= C; c -= C) ++tap;
    if constexpr (MT == 1) {
      // One M tile: the fragments of four k-tiles are loaded first, so that
      // their loads overlap (all of them would spill at 128 registers).
      for (int k0 = 0; k0 < KW / 16; k0 += 4) {
        unsigned a[4][1][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (k0 + kk < KW / 16) {
            ldsm_x4(a[kk][0], ring_lane + ((t0 + dt * tap) & (GM_RING - 1)) * slot + (c >> 3) * 8);
            for (c += 16; c >= C; c -= C) ++tap;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (k0 + kk < KW / 16) products(k0 + kk, a[kk]);
      }
    } else {
      for (int kk = 0; kk < KW / 16; ++kk) {
        const bf16* ra = ring_lane + ((t0 + dt * tap) & (GM_RING - 1)) * slot + (c >> 3) * 8;
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldsm_x4(a[m], ra + m * 16 * p.cch * 8);
        products(kk, a);
        for (c += 16; c >= C; c -= C) ++tap;
      }
    }
  };
  auto arrive = [&]() {
    if constexpr (CLUSTER) {
      cluster_arrive();
    } else {
      __syncwarp();  // the warp's h writes are ordered before its lane 0 arrives
      if (lane == 0) block_bar_arrive(bar);
    }
  };
  auto wait = [&](int phase) {
    if constexpr (CLUSTER) cluster_wait();
    else block_bar_wait(bar, phase);
  };
  if constexpr (CLUSTER) cluster.sync();  // weights, h and the first rows in every block
  else __syncthreads();
  GM_BLOCK_STAMP(1)
  window(0);

  for (int s = 0; s < L; ++s) {
    const int pos = d == 0 ? s : L - 1 - s;
    const bf16* hcur = hb + (s & 1) * h_buf;
    bf16* hnext = hb + ((s + 1) & 1) * h_buf;
    bf16* hrow = hout + (((long long)d * n_lines + line0) * L + pos) * H;
    if (s > 0) wait(s - 1);  // every block's h of the last step is in hcur
    GM_STEP_STAMP(0)
    if constexpr (MT == 1) {
      // As the window: h's fragments (H <= 128: at most 8 k-tiles) first.
      unsigned a[8][1][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk < p.kh / 16) ldsm_x4(a[kk][0], hcur + kk * LINES * 16 + h_off);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk < p.kh / 16) products(KW / 16 + kk, a[kk]);
    } else {
      for (int kk = 0; kk < p.kh / 16; ++kk) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldsm_x4(a[m], hcur + kk * LINES * 16 + m * 16 * 16 + h_off);
        products(KW / 16 + kk, a);
      }
    }
    GM_STEP_STAMP(1)
    // The cell in registers, c in fp32; h rounded to bf16 enters the next
    // step's product (every block of the cluster) and the fold.
#pragma unroll
    for (int i = 0; i < GM_QPW; ++i) {
      if (!has_quad[i]) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float ig = fast_sigmoid(acc[m][i][0][2 * hr] + bv[i][0]);
          const float fg = fast_sigmoid(acc[m][i][0][2 * hr + 1] + bv[i][1]);
          const float gg = fast_tanh(acc[m][i][1][2 * hr] + bv[i][2]);
          const float og = fast_sigmoid(acc[m][i][1][2 * hr + 1] + bv[i][3]);
          float& c = c_state[m][i][hr];
          c = fg * c + ig * gg;
          const bf16 hv = __float2bfloat16(og * fast_tanh(c));
          const int at = h_at[i][m][hr];
          if (at < 0) continue;
          if constexpr (CLUSTER) {
            for (int r = 0; r < p.cs; ++r) cluster.map_shared_rank(hnext, r)[at] = hv;
          } else {
            hnext[at] = hv;
          }
          if (o_at[i][m][hr] >= 0) hrow[o_at[i][m][hr]] = hv;
        }
    }
    GM_STEP_STAMP(2)
    arrive();
    GM_STEP_STAMP(3)
    // Row s + 7 starts its copy after the arrive; row s + 6 (this thread's
    // part) completes before the next arrive, so every thread may read it
    // after the wait of step s + 1, before window(s + 3) reads it.
    if (s + GM_AHEAD < S) stage_row(s + GM_AHEAD);
    cp_async_commit_raw();
    cp_async_wait_raw(1);
    GM_STEP_STAMP(4)
    if (s < L - 1) window(s + 1);
    GM_STEP_STAMP(5)
  }
  GM_BLOCK_STAMP(2)
  wait(L - 1);  // no block leaves while another may still write its h
}

using MmaKernel = void (*)(const __nv_bfloat16*, const float*, const float*, const float*,
                           __nv_bfloat16*, int, int, int, int, int, MmaPlan);

MmaKernel mma_kernel(int mt, bool cluster) {
  switch (mt) {
    case 1: return cluster ? gridrnn_mma_kernel<1, true> : gridrnn_mma_kernel<1, false>;
    case 2: return cluster ? gridrnn_mma_kernel<2, true> : gridrnn_mma_kernel<2, false>;
    default: return nullptr;
  }
}

struct MmaLaunch {
  MmaPlan plan;
  MmaKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

// The launch of plan (cs, lines = 16 mt) on `tiles` tiles, with the kernel's
// shared memory set.
cudaError_t mma_launch_config(MmaLaunch& F, int C, int H, int cs, int lines, int tiles,
                              cudaStream_t stream) {
  if (lines % 16 || !mma_plan(C, H, cs, lines / 16, F.plan)) return cudaErrorInvalidValue;
  F.fn = mma_kernel(F.plan.mt, cs > 1);
  if (F.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(F.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F.plan.bytes));
  if (err != cudaSuccess) return err;
  F.cfg = {};
  F.cfg.gridDim = dim3(cs * tiles, 2);
  F.cfg.blockDim = dim3(F.plan.nt);
  F.cfg.dynamicSmemBytes = F.plan.bytes;
  F.cfg.stream = stream;
  F.attr[0].id = cudaLaunchAttributeClusterDimension;
  F.attr[0].val.clusterDim.x = cs;
  F.attr[0].val.clusterDim.y = 1;
  F.attr[0].val.clusterDim.z = 1;
  F.cfg.attrs = F.attr;
  F.cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch the caller allocates: hs [2, B*P, L, H], L = S - 3. (cs, lines)
// is the recurrence's plan. Requires 1 <= H <= 128, C % 8 == 0, C <= 64,
// all pointers fp32, contiguous, on the stream's device.
int gridrnn_seq1_pair(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                      const float* wd, float* hs, float* outf, float* outb, int B, int S, int P,
                      int C, int H, int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int n_lines = B * P;
  FusedLaunch F;
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, false, (n_lines + lines - 1) / lines,
                                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&F.cfg, F.fn, x, w_ih, w_hh, bias, hs, nullptr, nullptr, S, P, C, H,
                           n_lines, F.plan.uc, F.plan.wst, F.plan.lbp);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<false, false, float>(hs, H, wd, (long long)H * KS * C, KS * C, 1, outf, outb,
                                          B, S, P, C, stream);
}

// Kernel 1's bf16 form on the tensor cores: x, hs, outf and outb bf16, the
// weights fp32 (rounded to bf16 in the kernel), x 16-byte aligned; (cs,
// lines) is the recurrence's plan (ops/gridrnn.py: mma_plan), lines 16 or
// 32; otherwise as gridrnn_seq1_pair.
int gridrnn_seq1_pair_bf16(const __nv_bfloat16* x, const float* w_ih, const float* w_hh,
                           const float* bias, const float* wd, __nv_bfloat16* hs,
                           __nv_bfloat16* outf, __nv_bfloat16* outb, int B, int S, int P, int C,
                           int H, int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H) || lines < 16) return cudaErrorInvalidValue;
  const int n_lines = B * P;
  MmaLaunch F;
  cudaError_t err = mma_launch_config(F, C, H, cs, lines, (n_lines + lines - 1) / lines, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&F.cfg, F.fn, x, w_ih, w_hh, bias, hs, S, P, C, H, n_lines, F.plan);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<false, false, __nv_bfloat16>(hs, H, wd, (long long)H * KS * C, KS * C, 1,
                                                  outf, outb, B, S, P, C, stream);
}

// Kernel 4, the summed fold on sequence-major lines x [S, lines, C] (the
// canvas with B = 1, P = lines), forward only: out [S, lines, C] = outf +
// outb, no deconv bias. The serving recurrence (no stash, the fast cell),
// then the fold with both directions summed. Scratch: hs [2, lines, L, H].
// (cs, lines) is the recurrence's plan.
int grid_bilstm_fold(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                     const float* wd, float* hs, float* out, int S, int n_lines, int C, int H,
                     int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  FusedLaunch F;
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, false, (n_lines + lines - 1) / lines,
                                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&F.cfg, F.fn, x, w_ih, w_hh, bias, hs, nullptr, nullptr, S, n_lines, C,
                           H, n_lines, F.plan.uc, F.plan.wst, F.plan.lbp);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<false, true, float>(hs, H, wd, (long long)H * KS * C, KS * C, 1, out,
                                         nullptr, 1, S, n_lines, C, stream);
}

// Kernel 5, the training forward on sequence-major lines x [S, lines, C]
// (the canvas with B = 1, P = lines): outf, outb [S, lines, C] and the
// stashes of the reverse sweep, gates [2, lines, L, H, 4], hs and cs
// [2, lines, L, H]. (cs_, lines) is the recurrence's plan.
int grid_fold_train_fwd(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                        const float* wd, float* gates, float* hs, float* cs, float* outf,
                        float* outb, int S, int n_lines, int C, int H, int cs_, int lines,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  FusedLaunch F;
  cudaError_t err = fused_launch_config(F, C, H, cs_, lines, true, (n_lines + lines - 1) / lines,
                                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&F.cfg, F.fn, x, w_ih, w_hh, bias, hs, gates, cs, S, n_lines, C, H,
                           n_lines, F.plan.uc, F.plan.wst, F.plan.lbp);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<false, false, float>(hs, H, wd, (long long)H * KS * C, KS * C, 1, outf, outb,
                                          1, S, n_lines, C, stream);
}

// The card's most clusters of the plan (cs, lines) at widths C, H that can
// run at once (cudaOccupancyMaxActiveClusters), of the serving kernel or
// (stash != 0) the training forward's; 0 if the plan does not fit a block,
// or minus a CUDA error.
int gridrnn_fused_max_clusters(int C, int H, int cs, int lines, int stash) {
  FusedLaunch F;
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, stash != 0, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, F.fn, &F.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The card's most clusters of kernel 1's bf16 plan (cs, lines) at widths C,
// H that can run at once, 0 if the plan does not fit a block, or minus a
// CUDA error.
int gridrnn_mma_max_clusters(int C, int H, int cs, int lines) {
  MmaLaunch F;
  cudaError_t err = mma_launch_config(F, C, H, cs, lines, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, F.fn, &F.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory of a block of kernel 1's bf16 plan, or -1 if it does
// not fit.
long long gridrnn_mma_smem(int C, int H, int cs, int lines) {
  MmaPlan p;
  return lines % 16 == 0 && mma_plan(C, H, cs, lines / 16, p) ? p.bytes : -1;
}

// Dynamic shared memory of a block of the plan, or -1 if it does not fit.
long long gridrnn_fused_smem(int C, int H, int cs, int lines) {
  FusedPlan p;
  return fused_plan(C, H, cs, lines, p) ? p.bytes : -1;
}

#ifdef GM_STAMPS
// The bf16 step's stamps of the last launch (GM_STEP_STAMP, GM_BLOCK_STAMP).
int gm_read_stamps(long long* steps, unsigned long long* blocks) {
  cudaError_t err = cudaMemcpyFromSymbol(steps, g_steps, sizeof(g_steps));
  return err != cudaSuccess ? err : cudaMemcpyFromSymbol(blocks, g_blocks, sizeof(g_blocks));
}
#endif

}  // extern "C"
