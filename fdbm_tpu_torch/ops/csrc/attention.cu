// Full-band frame attention of TF-GridNet and the PReLU + group norm that
// feeds it, on the flat head-minor layouts of the model.
//
// Replaces two Pallas kernels of fdbm_tpu/ops/attention.py:
//
// flat_group_norm (_norm_kernel / _prelu_norm / _group_mean): PReLU and a
//   per-group affine norm over aligned runs of W lanes of x [rows, L]
//   (groups cycle over the H heads), fp32 two-pass biased variance, eps
//   1e-5 inside the root. Bound by bytes: each element is read once and
//   written once (at the main path's shape the q, k and v maps of one
//   attention call are 25.4 MB, 7.6 us at 3.35 TB/s), and at that size by
//   the launch as much: one map alone is a few microseconds of traffic.
//   Design: one launch normalizes all the maps of one attention call
//   (norm_segments_kernel; up to three segments, the blocks that fill the
//   card split over them in proportion to their sizes). Every thread moves
//   16 bytes at a time: at W = 1 or 2 a float4 holds 4 / W groups; at W >= 4
//   a group is W / 4 neighbouring lanes, their sums joined by xor shuffles
//   (the TPU's lane-roll butterfly, within a warp). A grid stride that is a
//   multiple of the H * W lanes of a period keeps each thread on the same
//   lanes of the period, so its PReLU slope, gamma and beta sit in
//   registers for the whole pass.
//
// frame_attention (_attn_kernel): per batch and head h,
//   S[t, u] = scale * sum_{q, e} Q[t, q, h, e] K[u, q, h, e],
//   P = softmax_u(S) in fp32, O[t, q, h, d] = sum_u P[t, u] V[u, q, h, d],
//   with q, k [B, T, Q*H*E], v and o [B, T, Q*H*D], scale 1/sqrt(E*Q).
//
//   What bounds it on the H100: fp32 operations (1.36 GFLOP at B=1, T=257,
//   Q=257, D=8 against 21 MB of tensors, 0.020 ms on the CUDA cores), four
//   fifths of them in the value product, whose width Q*D (2056; 3084 at
//   D=12) is 4-6 times the score depth Q*E. Then the loads: a head's lanes
//   are 2 (E) or 8-12 (D) floats at a stride of H*E or H*D, so a copy takes
//   8 or 32 bytes of each 128-byte line, loads cost by line rather than by
//   byte, and a warp waits while its copies are dispatched. Measured with
//   chip_smoke.py --probe-kernels at the main-path shape: of 0.139 ms the
//   value FMAs take about 46 us, the V loads 21, the key loads 15, the score
//   FMAs 19.
//
//   Design: one kernel per call, no scores in device memory. A block takes
//   one batch item, one head and TR query rows; a cluster of NS blocks
//   shares them. Rank r of the cluster computes the scores of keys
//   [r*T/NS, (r+1)*T/NS) against the TR rows (the q tile staged once in
//   shared memory, keys streamed through a two-stage cp.async ring, 8 rows
//   x 4 keys per thread with the depth split over threads) and writes them
//   into the score tile of every block of its cluster through distributed
//   shared memory, so no block recomputes a score and each reads only its
//   share of the keys. After one cluster barrier each block takes the fp32
//   softmax of its TR x T copy (max, expf, 1/sum) and sweeps slice r of the
//   value width: P from shared memory, V through a two-stage cp.async ring
//   of vector copies, 8 rows x 8 columns per thread, written straight to
//   the head-minor output. Arithmetic is fp32 FMA on the CUDA cores (see
//   tile_gemm.cuh on TF32). The plan (TR, NS) is chosen by the wrapper
//   (ops/attention.py: attention_plan) and checked here by attn_plan, whose
//   shared-memory layout the wrapper mirrors; a plan that does not fit is
//   refused, never cut short.
//
// The bf16 forms (inference_dtype=bfloat16; fdbm_tpu/ops/attention.py:199,
// 229, 351-353). The norm is norm_segments_kernel on T = __nv_bfloat16
// (bf16_io.cuh): bf16 in and out, fp32 statistics and parameters. The
// attention (attn_mma_kernel) computes what _attn_kernel computes with
// mm_dt = bf16: S = scale * Q_h K_h^T with bf16 operands and fp32 sums,
// P = softmax(S) in fp32, normalised, then rounded to bf16, O = P V_h with
// bf16 operands, fp32 sums and a bf16 output.
//   What bounds it on the H100: bytes (10.6 MB at B=1, T=257, Q=257, D=8:
//   3.2 us at 3.35 TB/s; its 1.36 GFLOP take 1.4 us at the bf16 tensor
//   cores' 989 TFLOP/s); then the loads from L2, whose head-minor lanes
//   (E = 2 bf16, 4 bytes, at a stride of H*E; D = 8, 16 bytes, at H*D) fill
//   a quarter or half of each 32-byte sector a copy touches.
//   Design: both products on mma.sync m16n8k16 (mma_bf16.cuh). The two-phase
//   form of the fp32 kernel stays: a block takes one batch item, one head
//   and TR = 16 MT query rows, a cluster of NS blocks shares them; rank r
//   computes the scores of keys [r*KR, (r+1)*KR) and writes them, scaled,
//   into the fp32 score tile of every block of its cluster (distributed
//   shared memory), so no score reaches device memory. The relayout is the
//   kernel's own staging: q and k reach shared memory head-major, a row per
//   frame with the head's Q*E lanes contiguous (2E-byte cp.async copies,
//   rows padded to an odd count of 16-byte chunks, so that the eight rows an
//   ldmatrix reads fall in eight bank groups), and the score fragments are
//   ldmatrix loads of them (A: the query rows; B: the keys, one per column).
//   After one cluster barrier each block takes the fp32 softmax of its TR x
//   T rows (a warp a row), writes P rounded to bf16 as the A operand of P.V,
//   and sweeps slice r of the value width (whole bins of the head's D
//   lanes): V through a ring of 32-key stages filled by cp.async rows of the
//   head's D lanes (16 bytes at D = 8, three 8-byte copies at D = 12), its B
//   fragments by ldmatrix.trans from the key-major stage, each warp NPW n8
//   tiles of every m16 tile, written as bf16 pairs straight to the
//   head-minor output. The plan (MT, NS) is chosen by the wrapper
//   (ops/attention.py: attention_mma_plan, which mirrors attn_mma_plan's
//   layout); a plan that does not fit is refused, never cut short.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>

#include "bf16_io.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- flat_group_norm ------------------------------------------------------------
constexpr int GN_THREADS = 256;
constexpr int GN_MAX_SEGS = 3;
constexpr int GN_DESC = 7;  // x, alpha, gamma, beta, out, elements, width
constexpr float GN_EPS = 1e-5f;

// One map of a launch: x and out [rows, L] (L a multiple of n_head * width)
// of storage type T, alpha [H], gamma and beta [H][width] fp32; blocks
// [block0, block0 + blocks).
template <class T>
struct NormSeg {
  const T* x;
  const float* alpha;
  const float* gamma;
  const float* beta;
  T* out;
  long long n;  // elements, a multiple of width
  int width;
  int block0, blocks;
};

template <class T>
struct NormSegs {
  NormSeg<T> seg[GN_MAX_SEGS];
  int count, n_head;
};

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

// W >= 4: a group is W / 4 neighbouring lanes of one warp, a float4 each,
// its sums joined by xor shuffles. The thread's offset within the H * W
// lanes of a period is the same at every stride (the wrapper makes 4 x the
// stride a multiple of H * W), so its slope, gamma and beta are loaded once.
// The loop runs while the warp's first float4 is in the map, so every lane
// of a warp takes part in every shuffle.
template <int W, class T>
__device__ __forceinline__ void norm_lanes(const NormSeg<T>& g, int H, long long t,
                                           long long stride) {
  constexpr int G = W / 4;
  const long long n4 = g.n / 4;
  const int off = static_cast<int>((4 * t) % (H * W));  // head * W + 4 * (lane of the group)
  const float a = g.alpha[off / W];
  const float4 gm = *reinterpret_cast<const float4*>(g.gamma + off);
  const float4 bt = *reinterpret_cast<const float4*>(g.beta + off);
  for (long long i = t; i - (threadIdx.x & 31) < n4; i += stride) {
    const bool ok = i < n4;
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    if (ok) load_vec<4>(g.x + 4 * i, e);
    float4 v = make_float4(prelu(e[0], a), prelu(e[1], a), prelu(e[2], a), prelu(e[3], a));
    float s = (v.x + v.y) + (v.z + v.w);
#pragma unroll
    for (int m = 1; m < G; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    const float mu = s * (1.f / W);
    v = make_float4(v.x - mu, v.y - mu, v.z - mu, v.w - mu);
    float q = v.x * v.x;
    q = fmaf(v.y, v.y, q);
    q = fmaf(v.z, v.z, q);
    q = fmaf(v.w, v.w, q);
#pragma unroll
    for (int m = 1; m < G; m <<= 1) q += __shfl_xor_sync(0xffffffffu, q, m);
    const float inv = 1.f / sqrtf(q * (1.f / W) + GN_EPS);
    if (ok) {
      const float o[4] = {v.x * inv * gm.x + bt.x, v.y * inv * gm.y + bt.y,
                          v.z * inv * gm.z + bt.z, v.w * inv * gm.w + bt.w};
      store_vec<4>(g.out + 4 * i, o);
    }
  }
}

// W = 1 or 2: a float4 holds 4 / W whole groups, whose heads are the same
// at every stride (as above). A map whose size is no multiple of 4 ends in
// a partial float4, read and written element by element.
template <int W, class T>
__device__ __forceinline__ void norm_groups(const NormSeg<T>& g, int H, long long t,
                                            long long stride) {
  constexpr int NG = 4 / W;
  float a[NG], gm[4], bt[4];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int head = static_cast<int>((4 * t / W + j) % H);
    a[j] = g.alpha[head];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      gm[j * W + e] = g.gamma[head * W + e];
      bt[j * W + e] = g.beta[head * W + e];
    }
  }
  for (long long i = t; 4 * i < g.n; i += stride) {
    const long long e0 = 4 * i;
    const bool whole = e0 + 4 <= g.n;
    float v[4];
    if (whole) {
      load_vec<4>(g.x + e0, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = e0 + k < g.n ? load_f(g.x + e0 + k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      float mu = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        v[j * W + e] = prelu(v[j * W + e], a[j]);
        mu += v[j * W + e];
      }
      mu *= 1.f / W;
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        v[j * W + e] -= mu;
        q = fmaf(v[j * W + e], v[j * W + e], q);
      }
      const float inv = 1.f / sqrtf(q * (1.f / W) + GN_EPS);
#pragma unroll
      for (int e = 0; e < W; ++e) v[j * W + e] = v[j * W + e] * inv * gm[j * W + e] + bt[j * W + e];
    }
    if (whole) {
      store_vec<4>(g.out + e0, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e0 + k < g.n) store_f(g.out + e0 + k, v[k]);
    }
  }
}

// Every map of one launch: a block belongs to one segment, and its threads
// walk that map by float4s at a stride of the segment's threads. The
// segments stay in the kernel's parameter space (__grid_constant__), read
// in place.
template <class T>
__global__ void __launch_bounds__(GN_THREADS)
norm_segments_kernel(const __grid_constant__ NormSegs<T> segs) {
  int s = 0;
  while (s + 1 < segs.count && static_cast<int>(blockIdx.x) >= segs.seg[s + 1].block0) ++s;
  const NormSeg<T>& g = segs.seg[s];
  const long long t = static_cast<long long>(blockIdx.x - g.block0) * GN_THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(g.blocks) * GN_THREADS;
  const int H = segs.n_head;
  switch (g.width) {
    case 1: norm_groups<1>(g, H, t, stride); break;
    case 2: norm_groups<2>(g, H, t, stride); break;
    case 4: norm_lanes<4>(g, H, t, stride); break;
    case 8: norm_lanes<8>(g, H, t, stride); break;
    case 16: norm_lanes<16>(g, H, t, stride); break;
    case 32: norm_lanes<32>(g, H, t, stride); break;
    case 64: norm_lanes<64>(g, H, t, stride); break;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The card's blocks of norm_segments_kernel<T> at once (SMs x blocks an SM).
template <class T>
int norm_resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, norm_segments_kernel<T>,
                                                    GN_THREADS, 0) != cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = sms * per_sm;
  return sms * per_sm;
}

// ---- frame_attention ----------------------------------------------------------------
constexpr int AT_RM = 8;              // query rows per thread in both products
constexpr int AT_UT = 32;             // keys per score tile (4 per thread, strided by 8)
constexpr int AT_KC = 128;            // depth of a staged key chunk
constexpr int AT_KCP = AT_KC + 4;     // its row stride: keys 8 apart land in other banks
constexpr int AT_DS_MAX = 16;         // depth split of the score product
constexpr int AT_RING_BYTES = 98304;  // the V ring, all stages
constexpr int AT_MIN_THREADS = 128, AT_MAX_THREADS = 512;
// (key ring, V ring) stages, deepest first: the first that fits is taken.
constexpr int AT_STAGES[4][2] = {{3, 4}, {3, 3}, {2, 3}, {2, 2}};
constexpr long long SMEM_LIMIT = 232448;  // a block's shared memory on the H100 (227 KB)

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int round_up(int a, int b) { return cdiv(a, b) * b; }

struct AttnPlan {
  int tr, ns;   // query rows per block; blocks per cluster (slices of the value width)
  int rg;       // row groups of AT_RM rows
  int nt;       // threads
  int keys;     // keys per rank, ceil(T / ns)
  int slice;    // value columns per rank, a multiple of 8
  int tcp;      // thread columns (8 value columns each) per pass, nt / rg
  int nks;      // stages of the key ring
  int nvs;      // stages of the V ring
  int uk;       // key rows per V ring stage
  int ds;       // depth split of the score product
  int t_pad;    // score rows held: T rounded up to uk
  int region;   // floats shared by the score phase and the value phase
  long long bytes;
};

// The layout of a plan; false if it does not fit a block.
bool attn_plan(int T, int Q, int E, int D, int tr, int ns, AttnPlan& p) {
  if (T < 1 || tr < AT_RM || tr > 64 || tr % AT_RM || ns < 1 || ns > 8) return false;
  p.tr = tr;
  p.ns = ns;
  p.rg = tr / AT_RM;
  p.keys = cdiv(T, ns);
  p.slice = round_up(cdiv(Q * D, ns), 8);
  const int want = std::max(p.rg * (p.slice / 8), p.rg * (AT_UT / 4) * 4);
  p.nt = std::min(AT_MAX_THREADS, std::max(AT_MIN_THREADS, round_up(want, 32)));
  p.tcp = p.nt / p.rg;
  p.ds = std::min(AT_DS_MAX, std::max(1, p.nt / (p.rg * (AT_UT / 4))));
  for (const auto& st : AT_STAGES) {
    p.nks = st[0];
    p.nvs = st[1];
    p.uk = std::min(8, std::max(1, AT_RING_BYTES / (p.nvs * p.tcp * 8 * 4)));
    p.t_pad = round_up(T, p.uk);
    const int scores = Q * E * tr + p.nks * AT_UT * AT_KCP + p.ds * tr * AT_UT;
    const int ring = p.nvs * p.uk * p.tcp * 8;
    p.region = std::max(std::max(scores, ring), p.nt + 2 * tr);
    p.bytes = 4LL * ((long long)p.t_pad * tr + p.region);
    if (p.bytes <= SMEM_LIMIT) return true;
  }
  return false;
}

// cp.async of N bytes (4, 8 or 16); zero-fills the destination when !valid.
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Waits until at most n (0-3) of this thread's newest groups are pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

__device__ __forceinline__ void copy_lanes(float* dst, const float* src, bool valid, int w) {
  if (w == 4) cp_async<16>(dst, src, valid);
  else if (w == 2) cp_async<8>(dst, src, valid);
  else cp_async<4>(dst, src, valid);
}

// N floats of src into dst (zeros when !valid).
template <int N>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, bool valid) {
  cp_async<4 * N>(dst, src, valid);
}
__device__ __forceinline__ void unpack(const float4 a, float* o) {
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

// How the nt threads of a block cover an ncols x nrows staging copy: each
// thread a column (or, past nt columns, every nt-th column) and every
// rstep-th row, so the column's source offset is computed once per column,
// not once per copy.
struct Cover {
  int c0, cstep, r0, rstep;
  bool active;
};
__device__ __forceinline__ Cover cover(int ncols, int nt, int tid) {
  if (ncols >= nt) return {tid, nt, 0, 1, true};
  const int per = nt / ncols;
  return {tid % ncols, ncols, tid / ncols, per, tid < per * ncols};
}

// grid (ns * row tiles, H, B), clusters of ns blocks along x; VW the widest
// vector (4, 2 or 1 floats) that divides D. Every warp stages a share of
// each copy: dispatching the copies (a sector of each 128-byte line) is what
// bounds the loads, and it runs on all four schedulers of the SM.
template <int VW>
__global__ void __launch_bounds__(AT_MAX_THREADS)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int T, int Q, int H, int E, int D, float scale,
            AttnPlan p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nt = p.nt, tr = p.tr;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int t0 = (blockIdx.x / p.ns) * tr;
  const int QE = Q * E, HE = H * E, HD = H * D;
  const long long qk_row = (long long)Q * HE, v_row = (long long)Q * HD;
  float* sP = smem;                         // [t_pad][tr] scores, then probabilities
  float* sQ = smem + (long long)p.t_pad * tr;  // [QE][tr]
  float* sK = sQ + QE * tr;                 // [nks][AT_UT][AT_KCP]
  float* part = sK + p.nks * AT_UT * AT_KCP;  // [ds][tr][AT_UT]
  float* ring = sQ;                         // value phase: [nvs][uk][2][tcp][4]
  float* red = sQ;                          // softmax: [nt] partials, [2][tr] row results

  // -- the padding rows of the scores; the query tile rides with the first keys --
  for (int e = T * tr + tid; e < p.t_pad * tr; e += nt) sP[e] = 0.f;
  const Cover cq = cover(QE, nt, tid);
  if (cq.active)
    for (int kk = cq.c0; kk < QE; kk += cq.cstep) {
      const float* col = q + b * T * qk_row + (kk / E) * HE + h * E + kk % E;
      for (int r = cq.r0; r < tr; r += cq.rstep) {
        const int t = t0 + r;
        stage_vec<1>(sQ + kk * tr + r, t < T ? col + t * qk_row : q, t < T);
      }
    }
  cluster.sync();  // every block of the cluster runs before any remote write

  // -- scores of keys [ua, ub) into every block's sP ----------------------------
  // The rank's keys go in n_ut tiles of ut keys (a multiple of 8, at most
  // AT_UT), as even as that allows; key tile x depth chunk is one step.
  const int ua = rank * p.keys, ub = min(T, ua + p.keys);
  const int n_ut = ub > ua ? cdiv(ub - ua, AT_UT) : 0;
  const int ut = n_ut ? round_up(cdiv(ub - ua, n_ut), 8) : 0;
  const int nkc = cdiv(QE, AT_KC);
  const int steps = n_ut * nkc;
  const int ew = E % 4 == 0 ? 4 : (E % 2 == 0 ? 2 : 1);
  auto stage_keys = [&](int i) {
    const int ut0 = ua + (i / nkc) * ut, kc0 = (i % nkc) * AT_KC;
    const int per_key = min(AT_KC, QE - kc0) / ew;
    float* dst = sK + (i % p.nks) * AT_UT * AT_KCP;
    const Cover ck = cover(per_key, nt, tid);
    if (!ck.active) return;
    for (int c = ck.c0; c < per_key; c += ck.cstep) {
      const int kg = kc0 + c * ew;
      const float* col = k + b * T * qk_row + (kg / E) * HE + h * E + kg % E;
      for (int u = ck.r0; u < ut; u += ck.rstep) {
        const bool ok = ut0 + u < ub;
        copy_lanes(dst + u * AT_KCP + c * ew, ok ? col + (ut0 + u) * qk_row : k, ok, ew);
      }
    }
  };
  const int uq = tid % (AT_UT / 4), rgs = (tid / (AT_UT / 4)) % p.rg;
  const int dsi = tid / ((AT_UT / 4) * p.rg);
  float acc[AT_RM][4];
#pragma unroll
  for (int i = 0; i < AT_RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < p.nks - 1; ++i) {
    if (i < steps) stage_keys(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    if (i + p.nks - 1 < steps) stage_keys(i + p.nks - 1);
    cp_async_commit();
    cp_async_wait_n(p.nks - 1);
    __syncthreads();
    const int kc0 = (i % nkc) * AT_KC, kn = min(AT_KC, QE - kc0);
    if (dsi < p.ds) {
      const float* qa = sQ + kc0 * tr + rgs * AT_RM;
      const float* kb = sK + (i % p.nks) * AT_UT * AT_KCP + uq * AT_KCP;
#pragma unroll 2
      for (int kk = dsi; kk < kn; kk += p.ds) {
        float a[AT_RM], bk[4];
        unpack(*reinterpret_cast<const float4*>(qa + kk * tr), a);
        unpack(*reinterpret_cast<const float4*>(qa + kk * tr + 4), a + 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j * 8 < ut) bk[j] = kb[j * 8 * AT_KCP + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j * 8 < ut)
#pragma unroll
            for (int r = 0; r < AT_RM; ++r) acc[r][j] = fmaf(a[r], bk[j], acc[r][j]);
      }
    }
    if (i % nkc == nkc - 1) {
      // Last chunk of this key tile: sum the depth split, scale, scatter.
      if (dsi < p.ds) {
#pragma unroll
        for (int r = 0; r < AT_RM; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            part[(dsi * tr + rgs * AT_RM + r) * AT_UT + uq + 8 * j] = acc[r][j];
            acc[r][j] = 0.f;
          }
      }
      __syncthreads();
      const int ut0 = ua + (i / nkc) * ut;
      for (int o = tid; o < tr * ut; o += nt) {
        const int r = o / ut, u = o % ut;
        if (ut0 + u >= ub) continue;
        float s = 0.f;
        for (int d = 0; d < p.ds; ++d) s += part[(d * tr + r) * AT_UT + u];
        s *= scale;
        for (int rr = 0; rr < p.ns; ++rr)
          cluster.map_shared_rank(sP, rr)[(long long)(ut0 + u) * tr + r] = s;
      }
    }
    __syncthreads();  // stage i of the ring and the partials are free again
  }
  cp_async_wait<0>();
  cluster.sync();  // every block holds all TR x T scores; no remote access after this

  // -- softmax of each row, in place -----------------------------------------------
  {
    const int parts = nt / tr, r = tid % tr, pi = tid / tr;
    float m = -INFINITY;
    if (pi < parts)
      for (int u = pi; u < T; u += parts) m = fmaxf(m, sP[(long long)u * tr + r]);
    red[tid] = m;
    __syncthreads();
    if (tid < tr) {
      for (int j = 1; j < parts; ++j) m = fmaxf(m, red[j * tr + tid]);
      red[nt + tid] = m;
    }
    __syncthreads();
    m = red[nt + r];
    float sum = 0.f;
    if (pi < parts)
      for (int u = pi; u < T; u += parts) sum += expf(sP[(long long)u * tr + r] - m);
    __syncthreads();
    red[tid] = sum;
    __syncthreads();
    if (tid < tr) {
      for (int j = 1; j < parts; ++j) sum += red[j * tr + tid];
      red[nt + tr + tid] = 1.f / sum;
    }
    __syncthreads();
    const float inv = red[nt + tr + r];
    if (pi < parts)
      for (int u = pi; u < T; u += parts) {
        float* s = sP + (long long)u * tr + r;
        *s = expf(*s - m) * inv;
      }
    __syncthreads();
  }

  // -- values: slice `rank` of the value width -------------------------------------
  const int c_lo = rank * p.slice, c_hi = min(Q * D, c_lo + p.slice);
  if (c_lo >= c_hi) return;
  const int tcp = p.tcp, rgv = tid / tcp, tcx = tid % tcp;
  const int stage_floats = p.uk * 2 * tcp * 4;
  const int cpr = tcp * (8 / VW);  // vector copies per key row
  const int passes = cdiv(cdiv(c_hi - c_lo, 8), tcp);
  const int n_chunks = p.t_pad / p.uk;
  for (int pass = 0; pass < passes; ++pass) {
    const int col0 = c_lo + pass * tcp * 8;
    const Cover cv = cover(cpr, nt, tid);
    auto stage_values = [&](int ci) {
      if (!cv.active) return;
      const int u0 = ci * p.uk;
      float* dst = ring + (ci % p.nvs) * stage_floats;
      for (int c = cv.c0; c < cpr; c += cv.cstep) {
        const int tcl = c / (8 / VW), j = (c % (8 / VW)) * VW, n = col0 + tcl * 8 + j;
        const float* col = v + b * T * v_row + (n / D) * HD + h * D + n % D;
        float* dcol = dst + ((j >> 2) * tcp + tcl) * 4 + (j & 3);
        for (int uu = cv.r0; uu < p.uk; uu += cv.rstep) {
          const bool ok = u0 + uu < T && n < c_hi;
          stage_vec<VW>(dcol + uu * 2 * tcp * 4, ok ? col + (u0 + uu) * v_row : v, ok);
        }
      }
    };
    float o[AT_RM][8];
#pragma unroll
    for (int i = 0; i < AT_RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
    for (int ci = 0; ci < p.nvs - 1; ++ci) {
      if (ci < n_chunks) stage_values(ci);
      cp_async_commit();
    }
    for (int ci = 0; ci < n_chunks; ++ci) {
      if (ci + p.nvs - 1 < n_chunks) stage_values(ci + p.nvs - 1);
      cp_async_commit();
      cp_async_wait_n(p.nvs - 1);
      __syncthreads();
      if (rgv < p.rg) {
        const float4* vs = reinterpret_cast<const float4*>(ring + (ci % p.nvs) * stage_floats);
        const float* ps = sP + (long long)ci * p.uk * tr + rgv * AT_RM;
#pragma unroll 2
        for (int uu = 0; uu < p.uk; ++uu) {
          float a[AT_RM], w[8];
          unpack(*reinterpret_cast<const float4*>(ps + uu * tr), a);
          unpack(*reinterpret_cast<const float4*>(ps + uu * tr + 4), a + 4);
          unpack(vs[(uu * 2) * tcp + tcx], w);
          unpack(vs[(uu * 2 + 1) * tcp + tcx], w + 4);
#pragma unroll
          for (int i = 0; i < AT_RM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) o[i][j] = fmaf(a[i], w[j], o[i][j]);
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    if (rgv < p.rg) {
#pragma unroll
      for (int i = 0; i < AT_RM; ++i) {
        const int t = t0 + rgv * AT_RM + i;
        if (t >= T) continue;
        float* orow = out + (b * T + t) * v_row + h * D;
#pragma unroll
        for (int j = 0; j < 8; j += VW) {
          const int n = col0 + tcx * 8 + j;
          if (n >= c_hi) continue;
          store_vec<VW>(orow + (n / D) * HD + n % D, &o[i][j]);
        }
      }
    }
  }
}

using AttnKernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int,
                            int, float, AttnPlan);

AttnKernel attn_kernel_for(int D) {
  if (D % 4 == 0) return attn_kernel<4>;
  if (D % 2 == 0) return attn_kernel<2>;
  return attn_kernel<1>;
}

// The launch configuration of a plan, with the kernel's shared memory set.
struct AttnLaunch {
  AttnKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

cudaError_t attn_launch_config(AttnLaunch& L, const AttnPlan& p, int D, dim3 grid,
                               cudaStream_t stream) {
  L.fn = attn_kernel_for(D);
  cudaError_t err = cudaFuncSetAttribute(L.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.bytes));
  if (err != cudaSuccess) return err;
  L.cfg = {};
  L.cfg.gridDim = grid;
  L.cfg.blockDim = dim3(p.nt);
  L.cfg.dynamicSmemBytes = p.bytes;
  L.cfg.stream = stream;
  L.attr[0].id = cudaLaunchAttributeClusterDimension;
  L.attr[0].val.clusterDim.x = p.ns;
  L.attr[0].val.clusterDim.y = 1;
  L.attr[0].val.clusterDim.z = 1;
  L.cfg.attrs = L.attr;
  L.cfg.numAttrs = 1;
  return cudaSuccess;
}

// n_seg maps in one launch, desc [n_seg][7]: x, alpha, gamma, beta and out
// (device addresses), elements, width. Each map's x and out are [rows, L]
// with L a multiple of width * n_head, alpha [H], gamma and beta [H, width];
// width a power of two up to 64; gamma and beta on 16-byte boundaries, x
// and out too (8-byte for bf16). The blocks that fill the card once are
// split over the maps in proportion to their sizes, each map's count rounded
// up so that 4 x its threads are a multiple of n_head * width (and no more
// than one float4 a thread needs).
template <class T>
int norm_segments(const long long* desc, int n_seg, int n_head, void* stream_ptr) {
  if (n_seg < 1 || n_seg > GN_MAX_SEGS || n_head < 1) return cudaErrorInvalidValue;
  NormSegs<T> segs = {};
  segs.count = n_seg;
  segs.n_head = n_head;
  long long total = 0;
  for (int s = 0; s < n_seg; ++s) {
    const long long* d = desc + GN_DESC * s;
    NormSeg<T>& g = segs.seg[s];
    g.x = reinterpret_cast<const T*>(d[0]);
    g.alpha = reinterpret_cast<const float*>(d[1]);
    g.gamma = reinterpret_cast<const float*>(d[2]);
    g.beta = reinterpret_cast<const float*>(d[3]);
    g.out = reinterpret_cast<T*>(d[4]);
    g.n = d[5];
    g.width = static_cast<int>(d[6]);
    const int w = g.width;
    const bool io_aligned = kIsBf16<T> ? reinterpret_cast<uintptr_t>(g.x) % 8 == 0 &&
                                             reinterpret_cast<uintptr_t>(g.out) % 8 == 0
                                       : aligned16(g.x) && aligned16(g.out);
    if (w < 1 || w > 64 || (w & (w - 1)) || g.n < 1 || g.n % w || !io_aligned ||
        !aligned16(g.gamma) || !aligned16(g.beta))
      return cudaErrorInvalidValue;
    total += g.n;
  }
  const int resident = norm_resident_blocks<T>();
  if (resident < 1) return cudaErrorInvalidValue;
  int blocks = 0;
  for (int s = 0; s < n_seg; ++s) {
    NormSeg<T>& g = segs.seg[s];
    const long long period = (long long)n_head * g.width;
    const long long unit = period / std::gcd(period, 4LL * GN_THREADS);
    const long long need = ((g.n + 3) / 4 + GN_THREADS - 1) / GN_THREADS;
    const long long share = (resident * g.n + total - 1) / total;
    long long b = need < share ? need : share;
    b = (b + unit - 1) / unit * unit;
    if (blocks + b > 0x7fffffffLL) return cudaErrorInvalidValue;
    g.block0 = blocks;
    g.blocks = static_cast<int>(b);
    blocks += g.blocks;
  }
  norm_segments_kernel<T><<<blocks, GN_THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      segs);
  return cudaGetLastError();
}

int attention(const float* q, const float* k, const float* v, float* out, int B, int T, int Q,
              int H, int E, int D, float scale, int tr, int ns, void* stream_ptr) {
  AttnPlan p;
  if (B < 1 || Q < 1 || H < 1 || E < 1 || D < 1 || B > 65535 || H > 65535 ||
      !attn_plan(T, Q, E, D, tr, ns, p))
    return cudaErrorInvalidValue;
  AttnLaunch L;
  cudaError_t err = attn_launch_config(L, p, D, dim3(ns * cdiv(T, tr), H, B),
                                       static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&L.cfg, L.fn, q, k, v, out, T, Q, H, E, D, scale, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// ---- frame_attention's bf16 form on the tensor cores ---------------------------------
constexpr int AM_VK = 32;         // keys a V ring stage: two k16 tiles of P.V
constexpr int AM_KC_MAX = 80;     // keys a staged K chunk
constexpr int AM_MIN_WARPS = 4, AM_MAX_WARPS = 16;

// n8 tiles of the value slice a warp holds: MT x NPW accumulators of 4.
__host__ __device__ constexpr int am_npw(int mt) { return mt <= 2 ? 8 : (mt == 3 ? 6 : 5); }

struct AttnMmaPlan {
  int mt, tr, ns;      // m16 tiles of query rows a block (TR = 16 MT); blocks a cluster
  int nw, nt;          // warps and threads
  int qe, qek, qes;    // the score depth Q*E, its k16 tiles, sQ's and sK's row stride
  int kr, kc;          // keys a rank (even), keys a staged K chunk (a multiple of 16)
  int items, ksplit;   // score work items (m16 tile, 16 keys) a chunk; depth split
  int t16, t32;        // T rounded up to 16 and to 32
  int ldp, ldb;        // row strides of the fp32 scores and of bf16 P
  int ub, br;          // bins of a unit (lcm(8, D) / D), bins a rank (whole units)
  int bp, pt, passes;  // bins, n8 tiles and passes of the value sweep
  int vst, nvs;        // a V stage's row stride, V stages
  long long p_bytes, region, bytes;
};

// The layout of a plan; false if it does not fit a block.
bool attn_mma_plan(int T, int Q, int E, int D, int mt, int ns, AttnMmaPlan& p) {
  if (T < 1 || Q < 1 || E < 1 || D < 1 || mt < 1 || mt > 4 ||
      (ns != 1 && ns != 2 && ns != 4 && ns != 8))
    return false;
  p.mt = mt;
  p.tr = 16 * mt;
  p.ns = ns;
  p.qe = Q * E;
  p.qek = cdiv(p.qe, 16);
  p.qes = 16 * p.qek + 8;
  p.kr = round_up(cdiv(T, ns), 2);
  p.kc = std::min(round_up(p.kr, 16), AM_KC_MAX);
  p.t16 = round_up(T, 16);
  p.t32 = round_up(T, 32);
  p.ldp = p.t32 + 8;
  p.ldb = p.t32 + 8;
  const int l8 = 8 / std::gcd(8, D) * D;  // lcm(8, D)
  p.ub = l8 / D;
  p.br = round_up(cdiv(Q, ns), p.ub);
  const int npw = am_npw(mt);
  p.nw = std::min(AM_MAX_WARPS, std::max(AM_MIN_WARPS, cdiv(p.br * D / 8, npw)));
  p.nt = 32 * p.nw;
  p.items = mt * (p.kc / 16);
  p.ksplit = std::max(1, p.nw / p.items);
  p.p_bytes = 4LL * p.tr * p.ldp;
  const long long score =
      2LL * (p.tr + p.kc) * p.qes + (p.ksplit > 1 ? 4LL * p.ksplit * p.tr * p.kc : 0);
  // The widest pass the warps hold, halved (in whole units) while the V ring
  // does not fit beside P; 3 stages, else 2.
  p.bp = std::min(p.br, p.nw * npw * 8 / l8 * p.ub);
  while (p.bp >= p.ub) {
    p.pt = p.bp * D / 8;
    p.passes = cdiv(p.br, p.bp);
    p.vst = 8 * p.pt + (p.pt % 2 ? 0 : 8);
    for (p.nvs = 3; p.nvs >= 2; --p.nvs) {
      p.region = std::max(score, 2LL * p.tr * p.ldb + 2LL * p.nvs * AM_VK * p.vst);
      p.bytes = p.p_bytes + p.region;
      if (p.bytes <= SMEM_LIMIT) return true;
    }
    if (p.bp == p.ub) break;
    p.bp = std::max(p.ub, p.bp / 2 / p.ub * p.ub);
  }
  return false;
}

// The widest copy (16, 8, 4 or 2 bytes) that divides a run of w bf16 lanes.
__host__ __device__ __forceinline__ int copy_bytes(int w) {
  const int nb = 2 * w;
  return nb % 16 == 0 ? 16 : nb % 8 == 0 ? 8 : nb % 4 == 0 ? 4 : 2;
}

// rows x bins runs of W bf16 lanes into shared memory: run (r, c) of
// src + (row0 + r) * row_stride + c * bin_stride (zeros where row0 + r >=
// row_end or c >= bins_real) to dst + r * dst_stride + c * W, in CW-byte
// copies; the threads walk the runs' copies in order.
template <int CW>
__device__ __forceinline__ void stage_runs(__nv_bfloat16* dst, int dst_stride,
                                           const __nv_bfloat16* src, long long row_stride,
                                           int bin_stride, int row0, int row_end, int rows,
                                           int bins, int bins_real, int W, int tid, int nt) {
  constexpr int EL = CW / 2;  // lanes a copy
  const int per_bin = W / EL, per_row = bins * per_bin, n = rows * per_row;
  int r = tid / per_row, c = tid - r * per_row;
  const int dr = nt / per_row, dc = nt - dr * per_row;
  for (int e = tid; e < n; e += nt) {
    const int bin = per_bin == 1 ? c : c / per_bin, el = (c - bin * per_bin) * EL;
    const bool ok = row0 + r < row_end && bin < bins_real;
    const __nv_bfloat16* s =
        ok ? src + (long long)(row0 + r) * row_stride + (long long)bin * bin_stride + el : src;
    cp_async_bytes<CW>(dst + r * dst_stride + bin * W + el, s, ok);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ void stage_runs_any(int cw, __nv_bfloat16* dst, int dst_stride,
                                               const __nv_bfloat16* src, long long row_stride,
                                               int bin_stride, int row0, int row_end, int rows,
                                               int bins, int bins_real, int W, int tid, int nt) {
  switch (cw) {
    case 16: stage_runs<16>(dst, dst_stride, src, row_stride, bin_stride, row0, row_end, rows,
                            bins, bins_real, W, tid, nt); break;
    case 8: stage_runs<8>(dst, dst_stride, src, row_stride, bin_stride, row0, row_end, rows,
                          bins, bins_real, W, tid, nt); break;
    case 4: stage_runs<4>(dst, dst_stride, src, row_stride, bin_stride, row0, row_end, rows,
                          bins, bins_real, W, tid, nt); break;
    default: stage_runs<2>(dst, dst_stride, src, row_stride, bin_stride, row0, row_end, rows,
                           bins, bins_real, W, tid, nt);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// grid (NS * row tiles, H, B), clusters of NS blocks along x, p.nt threads.
// Shared memory: the fp32 scores [tr][ldp]; then a region that holds, in the
// score phase, the query tile sQ [tr][qes] and a K chunk sK [kc][qes]
// (head-major bf16; depth lanes past Q*E zero) and the depth split's partial
// sums [ksplit][tr][kc]; in the value phase P [tr][ldb] (bf16) and the V ring
// [nvs][AM_VK][vst] (bf16, key-major, the pass's bins' D lanes contiguous).
template <int MT>
__global__ void __launch_bounds__(AM_MAX_WARPS * 32, 1)
attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int T,
                int Q, int H, int E, int D, float scale, AttnMmaPlan p) {
  using bf16 = __nv_bfloat16;
  constexpr int NPW = am_npw(MT);
  extern __shared__ __align__(16) unsigned char am_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nt = p.nt, nw = p.nw, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int t0 = (blockIdx.x / p.ns) * p.tr;
  const int HE = H * E, HD = H * D;
  float* sP = reinterpret_cast<float*>(am_smem);
  bf16* sQ = reinterpret_cast<bf16*>(am_smem + p.p_bytes);
  bf16* sK = sQ + p.tr * p.qes;
  float* red = reinterpret_cast<float*>(sK + p.kc * p.qes);
  bf16* sPb = sQ;
  bf16* ring = sPb + p.tr * p.ldb;
  // A fragment rows and depth of a lane (a 16 x 16 tile, row-major); B
  // fragment key and depth of a lane (two n8 tiles of keys, k fastest).
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_key = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;

  // -- the query tile, head-major; the depth padding of sQ and sK rows -------------
  const int kpad = 16 * p.qek - p.qe;
  for (int e = tid; e < (p.tr + p.kc) * kpad; e += nt)
    sQ[(e / kpad) * p.qes + p.qe + e % kpad] = __float2bfloat16(0.f);
  const long long qk_row = (long long)Q * HE;
  const int cw_e = copy_bytes(E);
  stage_runs_any(cw_e, sQ, p.qes, q + b * T * qk_row + h * E, qk_row, HE, t0, T, p.tr, Q, Q, E,
                 tid, nt);
  cp_async_commit();
  cluster.sync();  // every block of the cluster runs before any remote write

  // -- scores of the rank's keys [ua, ub) into every block's sP -------------------
  const int ua = rank * p.kr, ub = min(T, ua + p.kr);
  const int n_ch = ub > ua ? cdiv(ub - ua, p.kc) : 0;
  for (int ch = 0; ch < n_ch; ++ch) {
    const int u0 = ua + ch * p.kc, un = min(p.kc, ub - u0), pairs = cdiv(un, 16);
    stage_runs_any(cw_e, sK, p.qes, k + b * T * qk_row + h * E, qk_row, HE, u0, ub, 16 * pairs,
                   Q, Q, E, tid, nt);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // Work unit = (m16 tile, 16 keys) x a share of the depth's k16 tiles.
    for (int unit = warp; unit < p.items * p.ksplit; unit += nw) {
      const int item = unit % p.items, part = unit / p.items;
      const int m = item % MT, pair = item / MT;
      if (pair >= pairs) continue;
      float acc[2][4] = {};
      const bf16* qa = sQ + (m * 16 + a_row) * p.qes + a_k;
      const bf16* kb = sK + (pair * 16 + b_key) * p.qes + b_k;
      for (int kk = part; kk < p.qek; kk += p.ksplit) {
        unsigned a[4], bb[4];
        ldsm_x4(a, qa + kk * 16);
        ldsm_x4(bb, kb + kk * 16);
        mma_bf16(acc[0], a, bb[0], bb[1]);
        mma_bf16(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m * 16 + g + 8 * hr, kl = pair * 16 + j * 8 + 2 * t4;
          if (p.ksplit > 1) {
            *reinterpret_cast<float2*>(red + (part * p.tr + row) * p.kc + kl) =
                make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
          } else if (kl < un) {
            const float s0 = acc[j][2 * hr] * scale, s1 = acc[j][2 * hr + 1] * scale;
            for (int rr = 0; rr < p.ns; ++rr) {
              float* dst = cluster.map_shared_rank(sP, rr) + row * p.ldp + u0 + kl;
              if (kl + 1 < un) *reinterpret_cast<float2*>(dst) = make_float2(s0, s1);
              else dst[0] = s0;
            }
          }
        }
    }
    if (p.ksplit > 1) {
      __syncthreads();
      for (int o = tid; o < p.tr * un; o += nt) {
        const int row = o / un, kl = o - row * un;
        float s = 0.f;
        for (int part = 0; part < p.ksplit; ++part) s += red[(part * p.tr + row) * p.kc + kl];
        s *= scale;
        for (int rr = 0; rr < p.ns; ++rr)
          cluster.map_shared_rank(sP, rr)[row * p.ldp + u0 + kl] = s;
      }
    }
    __syncthreads();  // sK and the partial sums are free again
  }
  cp_async_wait<0>();
  cluster.sync();  // every block holds all TR x T scores; no remote access after this

  // -- softmax, a warp a row; P normalised, then rounded to bf16 --------------------------
  for (int r = warp; r < p.tr; r += nw) {
    float* row = sP + r * p.ldp;
    float mx = -INFINITY;
    for (int u = lane; u < T; u += 32) mx = fmaxf(mx, row[u]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int u = lane; u < T; u += 32) {
      const float e = expf(row[u] - mx);
      row[u] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    bf16* pb = sPb + r * p.ldb;
    for (int u = lane; u < p.t32; u += 32) pb[u] = __float2bfloat16(u < T ? row[u] * inv : 0.f);
  }
  __syncthreads();

  // -- values: slice `rank` of the bins, in passes of p.bp bins -------------------------
  const int bin_lo = rank * p.br, bin_hi = min(Q, bin_lo + p.br);
  const long long v_row = (long long)Q * HD;
  const bf16* vb = v + b * T * v_row + h * D;
  const int cw_d = copy_bytes(D), n_kt = p.t16 / 16, n_chunks = cdiv(p.t16, AM_VK);
  const int stage = AM_VK * p.vst;
  // B fragments of two n8 tiles by ldmatrix.x4.trans: lanes 0-15 the first
  // tile's k rows 0-15, lanes 16-31 the second's.
  const int v_k = lane & 15, v_hi = lane >> 4;
  for (int pb0 = bin_lo; pb0 < bin_hi; pb0 += p.bp) {
    const int pbins = min(p.bp, bin_hi - pb0), ptiles = cdiv(pbins * D, 8);
    auto stage_chunk = [&](int ci) {
      stage_runs_any(cw_d, ring + (ci % p.nvs) * stage, p.vst, vb + (long long)pb0 * HD, v_row,
                     HD, ci * AM_VK, T, AM_VK, pbins, pbins, D, tid, nt);
    };
    float acc[MT][NPW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    for (int ci = 0; ci < p.nvs - 1; ++ci) {
      if (ci < n_chunks) stage_chunk(ci);
      cp_async_commit();
    }
    for (int ci = 0; ci < n_chunks; ++ci) {
      if (ci + p.nvs - 1 < n_chunks) stage_chunk(ci + p.nvs - 1);
      cp_async_commit();
      cp_async_wait_n(p.nvs - 1);
      __syncthreads();
      const bf16* vs = ring + (ci % p.nvs) * stage;
#pragma unroll
      for (int kk = 0; kk < AM_VK / 16; ++kk) {
        const int kt = ci * (AM_VK / 16) + kk;
        if (kt >= n_kt) break;
        unsigned bfr[NPW][2];
#pragma unroll
        for (int j = 0; j < NPW; j += 2) {
          const int jt0 = warp + nw * j, jt1 = warp + nw * (j + 1);
          if (jt0 >= ptiles) break;
          const bf16* row = vs + (kk * 16 + v_k) * p.vst;
          if (j + 1 < NPW && jt1 < ptiles) {
            unsigned r4[4];
            ldsm_x4_trans(r4, row + 8 * (v_hi ? jt1 : jt0));
            bfr[j][0] = r4[0];
            bfr[j][1] = r4[1];
            bfr[j + 1][0] = r4[2];
            bfr[j + 1][1] = r4[3];
          } else {
            unsigned r2[2];
            ldsm_x2_trans(r2, row + 8 * jt0);
            bfr[j][0] = r2[0];
            bfr[j][1] = r2[1];
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_x4(a, sPb + (m * 16 + a_row) * p.ldb + kt * 16 + a_k);
#pragma unroll
          for (int j = 0; j < NPW; ++j)
            if (warp + nw * j < ptiles) mma_bf16(acc[m][j], a, bfr[j][0], bfr[j][1]);
        }
      }
      __syncthreads();  // stage ci of the ring is free again
    }
    cp_async_wait<0>();
    // The outputs: row t0 + m*16 + g (+8), pass columns 8 jt + 2 t4 (+1).
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int jt = warp + nw * j;
        if (jt >= ptiles) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + m * 16 + g + 8 * hr;
          if (t >= T) continue;
          bf16* orow = out + (b * T + t) * v_row + h * D;
          const int col = 8 * jt + 2 * t4;
          if (D % 2 == 0) {
            const int bin = col / D, d = col - bin * D;
            if (bin < pbins)
              *reinterpret_cast<__nv_bfloat162*>(orow + (long long)(pb0 + bin) * HD + d) =
                  __floats2bfloat162_rn(acc[m][j][2 * hr], acc[m][j][2 * hr + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int bin = (col + e) / D, d = col + e - bin * D;
              if (bin < pbins)
                orow[(long long)(pb0 + bin) * HD + d] = __float2bfloat16(acc[m][j][2 * hr + e]);
            }
          }
        }
      }
  }
}

using AttnMmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                               __nv_bfloat16*, int, int, int, int, int, float, AttnMmaPlan);

AttnMmaKernel attn_mma_kernel_for(int mt) {
  switch (mt) {
    case 1: return attn_mma_kernel<1>;
    case 2: return attn_mma_kernel<2>;
    case 3: return attn_mma_kernel<3>;
    case 4: return attn_mma_kernel<4>;
    default: return nullptr;
  }
}

struct AttnMmaLaunch {
  AttnMmaPlan plan;
  AttnMmaKernel fn;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
};

// The launch of plan (mt, ns) over `grid`, with the kernel's shared memory
// set; cudaErrorInvalidValue if the plan does not fit.
cudaError_t attn_mma_launch_config(AttnMmaLaunch& L, int T, int Q, int E, int D, int mt, int ns,
                                   dim3 grid, cudaStream_t stream) {
  if (!attn_mma_plan(T, Q, E, D, mt, ns, L.plan)) return cudaErrorInvalidValue;
  L.fn = attn_mma_kernel_for(mt);
  cudaError_t err = cudaFuncSetAttribute(L.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.plan.bytes));
  if (err != cudaSuccess) return err;
  L.cfg = {};
  L.cfg.gridDim = grid;
  L.cfg.blockDim = dim3(L.plan.nt);
  L.cfg.dynamicSmemBytes = L.plan.bytes;
  L.cfg.stream = stream;
  L.attr[0].id = cudaLaunchAttributeClusterDimension;
  L.attr[0].val.clusterDim.x = ns;
  L.attr[0].val.clusterDim.y = 1;
  L.attr[0].val.clusterDim.z = 1;
  L.cfg.attrs = L.attr;
  L.cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// n_seg maps in one launch (see norm_segments), fp32 x and out.
int flat_group_norm_segments(const long long* desc, int n_seg, int n_head, void* stream_ptr) {
  return norm_segments<float>(desc, n_seg, n_head, stream_ptr);
}

// The same with bf16 x and out (the parameters stay fp32).
int flat_group_norm_segments_bf16(const long long* desc, int n_seg, int n_head,
                                  void* stream_ptr) {
  return norm_segments<__nv_bfloat16>(desc, n_seg, n_head, stream_ptr);
}

// Dynamic shared memory of the attention plan (tr, ns), or -1 if it does not fit.
long long frame_attention_smem(int T, int Q, int E, int D, int tr, int ns) {
  AttnPlan p;
  return attn_plan(T, Q, E, D, tr, ns, p) ? p.bytes : -1;
}

// The card's most clusters of the plan (tr, ns) that can run at once
// (cudaOccupancyMaxActiveClusters), 0 if the plan does not fit a block, or
// minus a CUDA error.
int frame_attention_max_clusters(int T, int Q, int E, int D, int tr, int ns) {
  AttnPlan p;
  if (!attn_plan(T, Q, E, D, tr, ns, p)) return 0;
  AttnLaunch L;
  cudaError_t err = attn_launch_config(L, p, D, dim3(ns), nullptr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, L.fn, &L.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// q, k [B, T, Q*H*E]; v, out [B, T, Q*H*D]; the plan: tr query rows per
// block, clusters of ns blocks.
int frame_attention(const float* q, const float* k, const float* v, float* out, int B, int T,
                    int Q, int H, int E, int D, float scale, int tr, int ns, void* stream_ptr) {
  return attention(q, k, v, out, B, T, Q, H, E, D, scale, tr, ns, stream_ptr);
}

// The bf16 form on the tensor cores: q, k, v and out bf16 (16-byte
// aligned); the plan: mt m16 tiles of query rows a block, clusters of ns
// blocks.
int frame_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* out, int B, int T, int Q, int H,
                         int E, int D, float scale, int mt, int ns, void* stream_ptr) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  AttnMmaLaunch L;
  cudaError_t err = attn_mma_launch_config(L, T, Q, E, D, mt, ns,
                                           dim3(ns * cdiv(T, 16 * mt), H, B),
                                           static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&L.cfg, L.fn, q, k, v, out, T, Q, H, E, D, scale, L.plan);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Dynamic shared memory of the bf16 plan (mt, ns), or -1 if it does not fit.
long long frame_attention_mma_smem(int T, int Q, int E, int D, int mt, int ns) {
  AttnMmaPlan p;
  return attn_mma_plan(T, Q, E, D, mt, ns, p) ? p.bytes : -1;
}

// The threads of a block of the bf16 plan (mt, ns), or -1 if it does not fit.
int frame_attention_mma_threads(int T, int Q, int E, int D, int mt, int ns) {
  AttnMmaPlan p;
  return attn_mma_plan(T, Q, E, D, mt, ns, p) ? p.nt : -1;
}

// The card's most clusters of the bf16 plan (mt, ns) at once, 0 if the plan
// does not fit a block, or minus a CUDA error.
int frame_attention_mma_max_clusters(int T, int Q, int E, int D, int mt, int ns) {
  AttnMmaLaunch L;
  cudaError_t err = attn_mma_launch_config(L, T, Q, E, D, mt, ns, dim3(ns), nullptr);
  if (err == cudaErrorInvalidValue) return 0;
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, L.fn, &L.cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
