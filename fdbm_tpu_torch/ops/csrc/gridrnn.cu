// TF-GridNet RNN path on the canvas: unfold(k=4) -> BiLSTM -> deconv(k=4)
// -> overlap-add, for both directions, as two kernels.
//
// Replaces fdbm_tpu/ops/gridrnn.py:grid_rnn_seq1_pair (the Pallas
// _canvas_kernel and its _advance_and_fold core), which does the whole path
// per grid cell in VMEM, each step one product of [window | h] against the
// stacked [W_ih; W_hh]. Shapes: x [B, S, P, C] with the sequence on axis 1
// and P batch-like, so each (b, p) is one independent line of S rows;
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
//      Per step, eight lanes split the sum over k of a pair of units (per k
//      two float4 of weights and two of rows for 64 FMAs, so that fewer
//      loads are issued per FMA), a reduce-scatter of shuffles leaves each
//      lane the gates of one eighth of the lines, the cell runs in registers
//      (fast exponential and division), and the lane writes h into every
//      block of the cluster (distributed shared memory). One cluster barrier
//      per step, split: after its arrive a block computes the next step's
//      window part (independent of h), which fills the barrier's latency,
//      then waits. The wrapper (ops/gridrnn.py: fused_plan) sizes the
//      clusters and tiles so that the grid is one wave on the card.
//   2. fold_kernel (gridrnn_core.cuh) computes the deconv projection as a
//      tiled product over the hidden states and does the 4-tap overlap-add
//      from shared memory, writing each output row once, in canvas layout.
// The hidden states cross device memory once (2 x lines x L x H floats).
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "gridrnn_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FR_KS = 8;            // lanes splitting a pair of units' sum over k
constexpr int FR_MAX_LINES = 16;    // lines per cluster: 8 or 16
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
  int nt;   // threads: eight lanes per pair of units (and at least a
            // quarter of a staged row's floats), whole warps
  long long bytes;
};

bool fused_plan(int C, int H, int cs, int lines, FusedPlan& p) {
  if (H < 1 || C < 1 || (cs != 1 && cs != 2 && cs != 4 && cs != 8)) return false;
  if (lines != 8 && lines != 16) return false;
  p.uc = (H + cs - 1) / cs;
  p.wst = 4 * p.uc + (8 - (4 * p.uc) % 32 + 32) % 32;
  p.lbp = (lines / 4) % 2 ? lines : lines + 4;
  const int stagers = (lines * C + FR_STAGE - 1) / FR_STAGE;
  const int lanes = FR_KS * ((p.uc + 1) / 2);
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
// the two units of the lane and the LINES lines: k = ks, ks + 8, ... < n of
// a [n][lbp] block of rows; wa, wb point at the units' columns of row 0.
// Per k two float4 of weights and LINES/4 float4 of rows for 8 x LINES FMAs.
template <int LINES>
__device__ __forceinline__ void fused_sum(float (&acc)[2][LINES][4], const float* wa,
                                          const float* wb, int wst, const float* rows, int lbp,
                                          int n, int ks) {
#pragma unroll 2
  for (int k = ks; k < n; k += FR_KS) {
    const float4 w0 = *reinterpret_cast<const float4*>(wa + k * wst);
    const float4 w1 = *reinterpret_cast<const float4*>(wb + k * wst);
    const float4* rk = reinterpret_cast<const float4*>(rows + k * lbp);
#pragma unroll
    for (int l4 = 0; l4 < LINES / 4; ++l4) {
      const float4 v = rk[l4];
      fma4(acc[0][4 * l4], v.x, w0);
      fma4(acc[0][4 * l4 + 1], v.y, w0);
      fma4(acc[0][4 * l4 + 2], v.z, w0);
      fma4(acc[0][4 * l4 + 3], v.w, w0);
      fma4(acc[1][4 * l4], v.x, w1);
      fma4(acc[1][4 * l4 + 1], v.y, w1);
      fma4(acc[1][4 * l4 + 2], v.z, w1);
      fma4(acc[1][4 * l4 + 3], v.w, w1);
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

// The lane order of a warp: lane bits 0-1 and 3 are ks bits 0-1 and 2, lane
// bits 2 and 4 pick the pair, so a quarter warp is two pairs x four ks (its
// rows and columns fall in 32 different banks).
__device__ __forceinline__ int lane_ks(int t) { return (t & 3) | ((t >> 1) & 4); }
__device__ __forceinline__ int lane_pair(int t) {
  return (t >> 5) * 4 + ((t >> 2) & 1) + ((t >> 3) & 2);
}

// Reduce-scatter over the pair's eight lanes (ks bits 2, 1, 0: lane masks
// 8, 2, 1): lane ks keeps the sums of lines ks*L8 .. ks*L8 + L8 - 1 of both
// units in acc[u][0 .. L8).
template <int LINES>
__device__ __forceinline__ void lane_reduce_scatter(float (&acc)[2][LINES][4], int ks) {
#pragma unroll
  for (int stage = 0; stage < 3; ++stage) {
    const int bit = 4 >> stage, mask = stage == 0 ? 8 : bit;
    const int half = LINES >> (stage + 1);
    const bool hi_half = ks & bit;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int l = 0; l < half; ++l)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float lo = acc[u][l][g], hi = acc[u][l + half][g];
          const float send = hi_half ? lo : hi;
          acc[u][l][g] = (hi_half ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, mask);
        }
  }
}

// x [B][S][P][C] canvas, w_ih [2][4C][4H], w_hh [2][H][4H], bias [2][4H] ->
// hout [2][lines][L][H]. grid (CS * tiles, 2), clusters of CS blocks along x.
// Block r owns units [r*uc, (r+1)*uc) and their four gate columns of the
// stacked weights: ws[k][4j + g] = [W_ih; W_hh][k][g*H + r*uc + j]. Shared
// memory: ws [4C + H][wst], h [2][H][lbp] (double-buffered, its own copy of
// the tile's state), the ring of canvas rows [FR_RING][C][lbp]. Sequence row
// t of direction d is canvas row t (d = 0) or S - 1 - t (d = 1); step s of
// the direction reads rows s .. s + 3 of that order. Lane ks of pair jp owns
// units jp and jp + pairs.
template <int LINES>
__global__ void __launch_bounds__(FR_MAX_THREADS, 1)
gridrnn_fused_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh, const float* __restrict__ bias,
                     float* __restrict__ hout, int S, int P, int C, int H, int n_lines, int uc,
                     int wst, int lbp) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L8 = LINES / FR_KS;  // lines of a lane's cells
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
  // Sequence row t of the tile's lines into ring slot t % FR_RING, c-major.
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

  // Lanes past the last pair repeat its product (every lane of a warp takes
  // part in the shuffles) and own nothing.
  const int ks = lane_ks(tid), pairs = (uc + 1) / 2;
  const int ja = min(lane_pair(tid), pairs - 1), jb = min(ja + pairs, uc - 1);
  const bool has_pair = lane_pair(tid) < pairs;
  const int units[2] = {u0 + ja, u0 + ja + pairs};
  const bool owner[2] = {has_pair && units[0] < H, has_pair && ja + pairs < uc && units[1] < H};
  const int lq0 = ks * L8;  // this lane's cells: lines lq0 .. lq0 + L8 - 1 of the tile, both units
  float bv[2][4], c_state[2][L8];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bv[u][g] = owner[u] ? bias[d * N + g * H + units[u]] : 0.f;
#pragma unroll
    for (int q = 0; q < L8; ++q) c_state[u][q] = 0.f;
  }
  float acc[2][LINES][4];
  // The window part of step s: taps i = 0 .. 3 are sequence rows s + i
  // (d = 0) or s + 3 - i (d = 1).
  auto window = [&](int s) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int l = 0; l < LINES; ++l)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[u][l][g] = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int t = d == 0 ? s + i : s + KS - 1 - i;
      const float* wrow = ws + i * C * wst;
      fused_sum<LINES>(acc, wrow + 4 * ja, wrow + 4 * jb, wst, ring + (t % FR_RING) * C * lbp,
                       lbp, C, ks);
    }
  };
  cluster.sync();  // weights, h and the first rows in place in every block
  window(0);

  for (int s = 0; s < L; ++s) {
    const int p = d == 0 ? s : L - 1 - s;
    const float* hcur = hb + (s & 1) * H * lbp;
    float* hnext = hb + ((s + 1) & 1) * H * lbp;
    if (s > 0) cluster_wait();  // every block's h of the last step is in hcur
    fused_sum<LINES>(acc, ws + KW * wst + 4 * ja, ws + KW * wst + 4 * jb, wst, hcur, lbp, H, ks);
    lane_reduce_scatter<LINES>(acc, ks);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < L8; ++q) {
        const float ig = fast_sigmoid(acc[u][q][0] + bv[u][0]);
        const float fg = fast_sigmoid(acc[u][q][1] + bv[u][1]);
        const float gg = fast_tanh(acc[u][q][2] + bv[u][2]);
        const float og = fast_sigmoid(acc[u][q][3] + bv[u][3]);
        c_state[u][q] = fg * c_state[u][q] + ig * gg;
        const float h = og * fast_tanh(c_state[u][q]);
        if (!owner[u]) continue;
        for (int r = 0; r < cs; ++r)
          cluster.map_shared_rank(hnext, r)[units[u] * lbp + lq0 + q] = h;
        const int line = line0 + lq0 + q;
        if (line < n_lines) hout[(((long long)d * n_lines + line) * L + p) * H + units[u]] = h;
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

using FusedKernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                             int, int, int, int, int, int, int);

FusedKernel fused_kernel(int lines) {
  switch (lines) {
    case 8: return gridrnn_fused_kernel<8>;
    case 16: return gridrnn_fused_kernel<16>;
    default: return nullptr;
  }
}

struct FusedLaunch {
  FusedPlan plan;
  FusedKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t fused_launch_config(FusedLaunch& F, int C, int H, int cs, int lines, int tiles,
                                cudaStream_t stream) {
  if (!fused_plan(C, H, cs, lines, F.plan)) return cudaErrorInvalidValue;
  F.fn = fused_kernel(lines);
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
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, (n_lines + lines - 1) / lines,
                                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&F.cfg, F.fn, x, w_ih, w_hh, bias, hs, S, P, C, H, n_lines,
                           F.plan.uc, F.plan.wst, F.plan.lbp);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold<false, false>(hs, H, wd, (long long)H * KS * C, KS * C, 1, outf, outb, B, S,
                                   P, C, stream);
}

// The card's most clusters of the plan (cs, lines) at widths C, H that can
// run at once (cudaOccupancyMaxActiveClusters), 0 if the plan does not fit
// a block, or minus a CUDA error.
int gridrnn_fused_max_clusters(int C, int H, int cs, int lines) {
  FusedLaunch F;
  cudaError_t err = fused_launch_config(F, C, H, cs, lines, 1, nullptr);
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
