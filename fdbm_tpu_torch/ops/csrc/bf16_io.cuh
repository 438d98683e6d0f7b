// Storage types of the serving kernels' activation streams: float, or
// __nv_bfloat16 under inference_dtype=bfloat16, the JAX package's bf16 io of
// kernels 1, 2, 3 and 7 (fdbm_tpu/ops/gridrnn.py:467,514; attention.py:199,
// 351; lstm.py:548). A bf16 value widens to float exactly, so a kernel that
// loads bf16 operands into float registers and multiplies them with fmaf
// computes the products of bf16 operands with fp32 accumulation, as the TPU's
// bf16 matmuls with preferred_element_type=float32 do; round_to rounds a
// float operand (a weight, the recurrent h, a softmax probability) to the
// storage type where the JAX kernel casts it, round to nearest even as
// astype(bfloat16) does. For float every helper is the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

template <class T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (kIsBf16<T>) return __bfloat162float(__float2bfloat16(v));
  else return v;
}

// N consecutive elements of T (N = 1, 2 or 4, aligned to N elements) into
// floats, and back; one vector access of N * sizeof(T) bytes.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 1) {
    o[0] = __bfloat162float(*p);
  } else if constexpr (N == 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    static_assert(N == 4, "1, 2 or 4 bf16 values");
    __nv_bfloat162 h[2];
    *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 1) {
    *p = __float2bfloat16(v[0]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    static_assert(N == 4, "1, 2 or 4 bf16 values");
    const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                                 __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
}

}  // namespace
