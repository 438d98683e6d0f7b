// fp32 block-tile products on the CUDA cores. simt_gemm_tn takes operands
// that are both stored k-major (row k of A holds the M values of position
// k, row k of B its N values): C[m][n] = sum_k A[k][m] B[k][n], the shape of
// a weight gradient summed over positions; simt_gemm_nt (below) operands
// that are both k-contiguous.
//
// A block of TY x TX threads computes a BM x BN tile (BM = 8 TY, BN = 8 TX)
// over a range of k in steps of BK. Thread (ty, tx) holds an 8 x 8 tile of
// C in registers: rows ty*4 .. +3 and BM/2 + ty*4 .. +3, columns tx*4 .. +3
// and BN/2 + tx*4 .. +3, so each step of k reads two float4 of A (the same
// for a row of threads: a broadcast) and two float4 of B for 64 FMAs. The
// operands reach shared memory through a ring of STAGES stages filled by
// cp.async, STAGES - 1 tiles ahead of the product, with one block barrier
// per tile of k. The caller's loader issues the copies of one tile and so
// folds its own layout (a concatenation, a shifted row) into the product
// without a copy in device memory. fp32 FMA throughout: the port holds its
// kernels to fp32 parity with the JAX reference (tile_gemm.cuh says why not
// TF32).
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

template <int BM_, int BN_, int BK_, int STAGES_>
struct SimtTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static_assert(BM % 8 == 0 && BN % 8 == 0 && STAGES >= 2, "8 x 8 per thread, two stages");
  static constexpr int TY = BM / 8, TX = BN / 8, THREADS = TX * TY;
  static constexpr int STAGE_FLOATS = BK * (BM + BN);  // As [BK][BM], then Bs [BK][BN]
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

// acc = the tile's sum over k tiles 0 .. k_tiles - 1. load(As, Bs, kt)
// issues (without committing) the cp.async copies of k tile kt into one
// stage; smem holds STAGES stages. Every thread of the block calls this.
template <class T, class Load>
__device__ __forceinline__ void simt_gemm_tn(int k_tiles, const Load& load, float* smem,
                                             float (&acc)[8][8]) {
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto stage = [&](int s) { return smem + s * T::STAGE_FLOATS; };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < k_tiles) load(stage(s), stage(s) + T::BK * T::BM, s);
    cp_async_commit_group();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait_groups<T::STAGES - 2>();
    __syncthreads();  // tile kt is in; every thread is done with the stage refilled below
    const int nk = kt + T::STAGES - 1;
    if (nk < k_tiles) {
      float* s = stage(nk % T::STAGES);
      load(s, s + T::BK * T::BM, nk);
    }
    cp_async_commit_group();
    const float* As = stage(kt % T::STAGES);
    const float* Bs = As + T::BK * T::BM;
#pragma unroll
    for (int k = 0; k < T::BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * T::BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * T::BM + T::BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * T::BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * T::BN + T::BN / 2 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait_groups<0>();
}

// The same product for operands that are both stored k-contiguous (row m of
// A holds the K values of output row m, row n of B those of output column
// n): C[m][n] = sum_k A[m][k] B[n][k], the shape of a product against a
// transposed weight. The stages hold the tiles as they lie in memory, As
// [BM][BK + 4] and Bs [BN][BK + 4] (16-byte cp.async copies, rows padded so
// that eight consecutive rows fall in other banks); thread (ty, tx) holds
// rows ty + TY*i and columns tx + TX*j, and per four steps of k reads eight
// float4 of A and eight of B for 256 FMAs.
template <int BM_, int BN_, int BK_, int STAGES_>
struct SimtTileNT {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static_assert(BM % 8 == 0 && BN % 8 == 0 && BK % 4 == 0 && STAGES >= 2, "8 x 8 per thread");
  static constexpr int TY = BM / 8, TX = BN / 8, THREADS = TX * TY;
  static constexpr int LDK = BK + 4;
  static constexpr int STAGE_FLOATS = (BM + BN) * LDK;  // As [BM][LDK], then Bs [BN][LDK]
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

template <class T, class Load>
__device__ __forceinline__ void simt_gemm_nt(int k_tiles, const Load& load, float* smem,
                                             float (&acc)[8][8]) {
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto stage = [&](int s) { return smem + s * T::STAGE_FLOATS; };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < k_tiles) load(stage(s), stage(s) + T::BM * T::LDK, s);
    cp_async_commit_group();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait_groups<T::STAGES - 2>();
    __syncthreads();  // tile kt is in; every thread is done with the stage refilled below
    const int nk = kt + T::STAGES - 1;
    if (nk < k_tiles) {
      float* s = stage(nk % T::STAGES);
      load(s, s + T::BM * T::LDK, nk);
    }
    cp_async_commit_group();
    const float* As = stage(kt % T::STAGES);
    const float* Bs = As + T::BM * T::LDK;
#pragma unroll
    for (int k4 = 0; k4 < T::BK / 4; ++k4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + T::TY * i) * T::LDK + 4 * k4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + T::TX * j) * T::LDK + 4 * k4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait_groups<0>();
}

// Tile row of acc[i][.] and tile column of acc[.][j] for this thread.
template <class T>
__device__ __forceinline__ int simt_row(int i) {
  return (i < 4 ? 0 : T::BM / 2) + (threadIdx.x / T::TX) * 4 + i % 4;
}
template <class T>
__device__ __forceinline__ int simt_col(int j) {
  return (j < 4 ? 0 : T::BN / 2) + (threadIdx.x % T::TX) * 4 + j % 4;
}

}  // namespace
