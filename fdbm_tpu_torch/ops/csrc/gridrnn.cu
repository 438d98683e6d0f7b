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
// fdbm_tpu/ops/gridrnn.py:467,514-515,550-553) is the same two kernels on
// T = __nv_bfloat16 (bf16_io.cuh): the canvas, h and the outputs are bf16 in
// device memory, w_ih, w_hh and wd are rounded to bf16 as they are staged
// (the TPU kernel ships them pre-cast), h is rounded to bf16 before it
// enters the next step's product and the deconv, and the sums, the bias, c
// and the gates stay fp32, as in the TPU kernel's bf16 path. cp.async cannot
// widen, so the ring's rows are loaded into registers at the start of a
// step, off its chain, and stored widened after the cell; the ring, the
// weights and h stay fp32 in shared memory, so the products are the fp32
// kernel's on bf16-valued operands. The streams halve, but the recurrence's
// chain, not the bytes, sets the time.
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "bf16_io.cuh"
#include "gridrnn_core.cuh"

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

// The cell's activations with the fast exponential and division (relative
// error about 1e-7, far inside the kernel's 1e-4 gate): they sit on the
// step's chain.
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float fast_tanh(float v) { return 2.f * fast_sigmoid(2.f * v) - 1.f; }

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
// hout [2][lines][L][H], x and hout of storage type T (bf16 only without
// STASH). With STASH (the training forward, kernel 5) it also
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
template <int LINES, bool STASH, class T = float>
__global__ void __launch_bounds__(FR_MAX_THREADS, 1)
gridrnn_fused_kernel(const T* __restrict__ x, const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh, const float* __restrict__ bias,
                     T* __restrict__ hout, float* __restrict__ gout, float* __restrict__ cout,
                     int S, int P, int C, int H, int n_lines, int uc, int wst, int lbp) {
  extern __shared__ __align__(16) float smem[];
  static_assert(!(STASH && kIsBf16<T>), "the stashing forward is fp32");
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
    ws[k * wst + 4 * j + g] = round_to<T>(v);
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
  // Sequence row t of the tile's lines into ring slot t % FR_RING, c-major:
  // fp32 by cp.async; bf16 in two halves, fetch_row into registers (st_val)
  // and put_row widened into the ring, so a step can start its loads early.
  auto row_offset = [&](int t) { return (long long)(d == 0 ? t : S - 1 - t) * P * C; };
  float st_val[FR_STAGE];
  auto fetch_row = [&](int t) {
    const long long roff = row_offset(t);
#pragma unroll
    for (int i = 0; i < FR_STAGE; ++i) st_val[i] = st_ok[i] ? load_f(x + st_src[i] + roff) : 0.f;
  };
  auto put_row = [&](int t) {
    float* dst = ring + (t % FR_RING) * C * lbp;
#pragma unroll
    for (int i = 0; i < FR_STAGE; ++i)
      if (tid + i * nt < LINES * C) dst[st_dst[i]] = st_val[i];
  };
  auto stage_row = [&](int t) {
    if constexpr (kIsBf16<T>) {
      fetch_row(t);
      put_row(t);
    } else {
      const long long roff = row_offset(t);
      float* dst = ring + (t % FR_RING) * C * lbp;
#pragma unroll
      for (int i = 0; i < FR_STAGE; ++i)
        if (tid + i * nt < LINES * C)
          cp_async_to<4>(dst + st_dst[i], st_ok[i] ? x + st_src[i] + roff : x, st_ok[i]);
    }
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
    // bf16: this step's ring row is loaded now and arrives during the product.
    if constexpr (kIsBf16<T>)
      if (s + FR_AHEAD < S) fetch_row(s + FR_AHEAD);
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
        // bf16: h enters the next product and the deconv rounded, c stays fp32.
        const float h = round_to<T>(og * cell_tanh<STASH>(c_state[u][q]));
        if (!owner[u]) continue;
        for (int r = 0; r < cs; ++r)
          cluster.map_shared_rank(hnext, r)[units[u] * lbp + lq0 + q] = h;
        const int line = line0 + lq0 + q;
        if (line >= n_lines) continue;
        const long long at = (((long long)d * n_lines + line) * L + p) * H + units[u];
        store_f(hout + at, h);
        if constexpr (STASH) {
          reinterpret_cast<float4*>(gout)[at] = make_float4(ig, fg, gg, og);
          cout[at] = c_state[u][q];
        }
      }
    // Row s + 6 starts its copy; row s + 5 (copied by this thread) is
    // complete before the arrive, so every thread may read it after the
    // next wait. bf16: row s + 6, loaded at the top of the step, is stored.
    if constexpr (kIsBf16<T>) {
      if (s + FR_AHEAD < S) put_row(s + FR_AHEAD);
    } else {
      if (s + FR_AHEAD < S) stage_row(s + FR_AHEAD);
      cp_async_commit_group();
      cp_async_wait_groups<1>();
    }
    cluster_arrive();
    if (s + 1 < L) window(s + 1);
  }
  cluster_wait();  // no block leaves while another may still write its h
}

template <class T>
using FusedKernel = void (*)(const T*, const float*, const float*, const float*, T*, float*,
                             float*, int, int, int, int, int, int, int, int);

template <class T>
FusedKernel<T> fused_kernel(int lines, bool stash) {
  if constexpr (kIsBf16<T>) {
    if (stash) return nullptr;
    switch (lines) {
      case 8: return gridrnn_fused_kernel<8, false, T>;
      case 16: return gridrnn_fused_kernel<16, false, T>;
      default: return nullptr;
    }
  } else {
    switch (lines) {
      case 8: return stash ? gridrnn_fused_kernel<8, true> : gridrnn_fused_kernel<8, false>;
      case 16: return stash ? gridrnn_fused_kernel<16, true> : gridrnn_fused_kernel<16, false>;
      default: return nullptr;
    }
  }
}

template <class T = float>
struct FusedLaunch {
  FusedPlan plan;
  FusedKernel<T> fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

template <class T>
cudaError_t fused_launch_config(FusedLaunch<T>& F, int C, int H, int cs, int lines, bool stash,
                                int tiles, cudaStream_t stream) {
  if (!fused_plan(C, H, cs, lines, F.plan)) return cudaErrorInvalidValue;
  F.fn = fused_kernel<T>(lines, stash);
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
  FusedLaunch<> F;
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

// Kernel 1's bf16 form: x, hs, outf and outb bf16, the weights fp32 (rounded
// to bf16 in the kernels); otherwise as gridrnn_seq1_pair.
int gridrnn_seq1_pair_bf16(const __nv_bfloat16* x, const float* w_ih, const float* w_hh,
                           const float* bias, const float* wd, __nv_bfloat16* hs,
                           __nv_bfloat16* outf, __nv_bfloat16* outb, int B, int S, int P, int C,
                           int H, int cs, int lines, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int n_lines = B * P;
  FusedLaunch<__nv_bfloat16> F;
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, false, (n_lines + lines - 1) / lines,
                                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&F.cfg, F.fn, x, w_ih, w_hh, bias, hs, nullptr, nullptr, S, P, C, H,
                           n_lines, F.plan.uc, F.plan.wst, F.plan.lbp);
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
  FusedLaunch<> F;
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
  FusedLaunch<> F;
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
  FusedLaunch<> F;
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, stash != 0, 1, nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, F.fn, &F.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory of a block of the plan, or -1 if it does not fit.
long long gridrnn_fused_smem(int C, int H, int cs, int lines) {
  FusedPlan p;
  return fused_plan(C, H, cs, lines, p) ? p.bytes : -1;
}

}  // extern "C"
