// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel has a plain C entry point (extern "C", pointers as void*,
// the CUDA stream last) so that Python loads the library with ctypes.
// Entry points return 0 on success, kErrUnsupported for a dtype or shape
// that has no instantiation, or the cudaGetLastError() of the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace skk {

// Dtype codes shared with skypilot_tpu_torch/ops/_kernels.py.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kErrUnsupported = -1;

// The -1e30 "minus infinity" of the JAX kernels: exp(-1e30 - m) is 0 for
// any finite running max m, and it never produces inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace skk
