// Shared helpers of the port's CUDA kernels: dtype conversion, warp
// reductions and the reference's masking constant.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

// Large-negative instead of -inf, as in the reference kernels: a masked
// score contributes exp(NEG_INF - m) == 0 once a row has seen a real score.
constexpr float NEG_INF = -1e30f;
// A key that does not exist (past the range a block visits): excluded from
// the running max and contributes exactly 0.
#define REPRO_ABSENT (-CUDART_INF_F)

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro
