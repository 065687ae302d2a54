// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, per row, in f32,
// cast back to x's dtype.
//
// Replaces skypilot_tpu/ops/rmsnorm.py::_rmsnorm_pallas (body
// _rmsnorm_kernel), which kept 256-row blocks resident in VMEM.
//
// Bound on the H100: bytes.  The kernel reads x and w once and writes y
// once (3 flops per element, far below the card's 295 flop/byte ridge),
// so its floor is (2 * rows * d + d) * sizeof(T) / 3.35 TB/s.  Design:
// one 256-thread block per row, 16-byte vector loads (8 bf16 or 4 f32 per
// thread per load), the sum of squares reduced with warp shuffles and
// one shared-memory step, and the second pass re-reading the row while
// it is still in L1/L2 rather than holding it in registers, so any d
// that is a multiple of 8 takes the same code.
#include "common.cuh"

namespace skk {
namespace {

constexpr int kRmsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kRmsThreads) {
    const uint4 raw = xr[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
  __shared__ float red[kRmsThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kRmsThreads / 32 ? red[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / static_cast<float>(d) + eps);

  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  for (int i = threadIdx.x; i < nvec; i += kRmsThreads) {
    const uint4 raw = xr[i];
    const uint4 wraw = wr[i];
    uint4 res;
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* we = reinterpret_cast<const T*>(&wraw);
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_f32<T>(to_f32(e[j]) * r * to_f32(we[j]));
    yr[i] = res;
  }
}

template <typename T>
int launch_rmsnorm(const void* x, const void* w, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kRmsThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d, eps);
  return launch_status();
}

}  // namespace
}  // namespace skk

// x, y: (rows, d) contiguous, 16-byte aligned; w: (d,).  d % 8 == 0.
extern "C" int skk_rmsnorm(const void* x, const void* w, void* y,
                           long long rows, int d, float eps, int dtype,
                           void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 8 || d % 8 != 0)
    return skk::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case skk::kBF16:
      return skk::launch_rmsnorm<__nv_bfloat16>(x, w, y, rows, d, eps, s);
    case skk::kF32:
      return skk::launch_rmsnorm<float>(x, w, y, rows, d, eps, s);
    default:
      return skk::kErrUnsupported;
  }
}
