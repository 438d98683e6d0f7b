// Shared fp32 block-tile matrix product for the port's kernels.
//
// One block of GEMM_THREADS = 256 threads computes a BM x BN tile of
// C = A B over the full depth K, in steps of GEMM_BK. Each operand is read
// through a separable offset, A[a_row(m) + a_col(k)] and B[b_k(k) + b_n(n)],
// with m and n relative to the tile and -1 marking an element outside the
// problem (read as 0). That is how each kernel folds its own layout (the k=4
// unfold windows, the head-interleaved attention lanes) into the product
// without a copy in device memory; the row offsets are computed once per
// block and the column offsets once per depth step.
//
// Thread (ty, tx) of the 16 x 16 grid owns rows ty*TM .. ty*TM+TM-1 and
// columns tx + 16*j, so the A reads of a warp are broadcasts and its B reads
// hit 16 consecutive banks. All arithmetic is fp32 FMA on the CUDA cores:
// the port holds its kernels to fp32 parity with the JAX reference, which
// TF32 tensor cores (10-bit mantissa) would not meet. A may be stored in
// bf16 (the serving kernels' bf16 io): it is widened to float as it is
// staged. TR rounds B's elements to its precision as they are staged (a
// weight pre-cast to bf16, as the JAX kernels ship theirs); float leaves
// them as they are.
#pragma once

#include "bf16_io.cuh"

constexpr int GEMM_THREADS = 256;
constexpr int GEMM_BK = 8;

template <int BM, int BN>
struct GemmTile {
  static_assert(BM % 32 == 0 && BN % 32 == 0, "tile sides must be multiples of 32");
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 16;
  static constexpr int LDA = BM + 4;  // keeps rows 16-byte aligned, spreads banks
  static constexpr int SMEM_FLOATS = GEMM_BK * (LDA + BN);
};

// B_K_FAST picks how the block stages B: k fastest when each column n is a
// row of the source tensor (the keys of the score product), n fastest when
// B is row-major in k (weights [K][N], the values).
template <int BM, int BN, bool B_K_FAST, class TR = float, class TA, class ARow, class ACol,
          class BK_, class BN_>
__device__ __forceinline__ void gemm_tile(int K, const TA* __restrict__ A, const ARow& a_row,
                                          const ACol& a_col, const float* __restrict__ B,
                                          const BK_& b_k, const BN_& b_n,
                                          float (&acc)[BM / 16][BN / 16], float* smem) {
  using T = GemmTile<BM, BN>;
  static_assert(B_K_FAST || GEMM_THREADS % BN == 0, "n-fast staging needs BN | 256");
  constexpr int A_REP = BM * GEMM_BK / GEMM_THREADS;
  constexpr int B_REP = BN * GEMM_BK / GEMM_THREADS;
  float* As = smem;
  float* Bs = smem + GEMM_BK * T::LDA;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // Staging coordinates that stay fixed over the depth loop.
  const int ak = tid % GEMM_BK;
  long long arow[A_REP];
#pragma unroll
  for (int r = 0; r < A_REP; ++r) arow[r] = a_row(tid / GEMM_BK + r * (GEMM_THREADS / GEMM_BK));
  long long bfix[B_REP];
#pragma unroll
  for (int r = 0; r < B_REP; ++r)
    bfix[r] = B_K_FAST ? b_n(tid / GEMM_BK + r * (GEMM_THREADS / GEMM_BK)) : 0;
  const long long bn_fast = B_K_FAST ? 0 : b_n(tid % BN);

#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    const long long acol = (k0 + ak < K) ? a_col(k0 + ak) : -1;
#pragma unroll
    for (int r = 0; r < A_REP; ++r) {
      const int m = tid / GEMM_BK + r * (GEMM_THREADS / GEMM_BK);
      As[ak * T::LDA + m] = (arow[r] >= 0 && acol >= 0) ? load_f(A + arow[r] + acol) : 0.f;
    }
    if (B_K_FAST) {
      const long long bk = (k0 + ak < K) ? b_k(k0 + ak) : -1;
#pragma unroll
      for (int r = 0; r < B_REP; ++r) {
        const int n = tid / GEMM_BK + r * (GEMM_THREADS / GEMM_BK);
        Bs[ak * BN + n] = (bfix[r] >= 0 && bk >= 0) ? round_to<TR>(B[bk + bfix[r]]) : 0.f;
      }
    } else {
#pragma unroll
      for (int r = 0; r < B_REP; ++r) {
        const int k = tid / BN + r * (GEMM_THREADS / BN);
        const long long bk = (k0 + k < K) ? b_k(k0 + k) : -1;
        Bs[k * BN + tid % BN] = (bn_fast >= 0 && bk >= 0) ? round_to<TR>(B[bk + bn_fast]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GEMM_BK; ++k) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) a[i] = As[k * T::LDA + ty * T::TM + i];
#pragma unroll
      for (int j = 0; j < T::TN; ++j) b[j] = Bs[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Tile row and column that accumulator acc[i][j] of this thread holds.
template <int BM, int BN>
__device__ __forceinline__ int tile_row(int i) {
  return (threadIdx.x / 16) * GemmTile<BM, BN>::TM + i;
}
__device__ __forceinline__ int tile_col(int j) { return threadIdx.x % 16 + 16 * j; }
