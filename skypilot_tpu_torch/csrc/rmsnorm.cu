// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, per row, in f32,
// cast back to x's dtype.
//
// Replaces skypilot_tpu/ops/rmsnorm.py::_rmsnorm_pallas (:31; body
// _rmsnorm_kernel :17), which kept 256-row blocks resident in VMEM.
//
// Bound on the H100: bytes.  The kernel reads x and w once and writes y
// once (3 flops per element, far below the card's 295 flop/byte ridge),
// so its floor is (2 * rows * d + d) * sizeof(T) / 3.35 TB/s: 4-10 us at
// 2,048 rows of the presets' widths; at decode's 8 to 264 rows, the
// launch and one trip to memory.
//
// Design.  A row belongs to a group of tpr threads (a power of two, 32
// to 1,024), and each thread holds NV 16-byte vectors of it in registers
// (vectors t + j tpr of the row, j < NV: neighbouring threads on
// neighbouring addresses), so x is read from memory once and the sum of
// squares and the scale both run on the registers.  NV is a compile-time
// count (1, 2, 3, 4, 6, 8, 12, 16: the presets' widths 1,536, 3,072,
// 4,096 and 8,192 split into these with no vector wasted), and vectors
// past the row are predicated off, so any d % 8 == 0 up to NV tpr vectors
// takes the same code.  A block of max(tpr, 256) threads walks the rows
// (grid-stride), and each thread loads its NV vectors of w into registers
// once, before the walk.  Where a warp owns a row (tpr 32) the row's sum
// is the warp's shuffles and nothing else; a wider row adds its warps'
// partials through shared memory behind one __syncthreads a row (the
// partials double-buffered by the walk's parity, so no second barrier).
// The launch policy (ops/rmsnorm.py, _norm_launch: a function of rows, d,
// the dtype's size and the SM count, so one decision holds for a captured
// graph) takes the fewest threads a row whose vectors fit the registers
// (a warp a row at the presets' widths in bf16) while the rows fill the
// card, and spreads a few rows (decode's 8, verify's 104, the fused
// lane's 264) over more threads and blocks, so that one row's loads are
// spread over more SMs.  NV 0 is the same kernel for a row too long for
// the registers (more than 4 vectors a thread at 1,024 threads): it loops
// over the row, and its scale pass reads the row again, from L2.
#include "common.cuh"

namespace skk {
namespace {

// The most threads a block may have at NV vectors a thread: the launch
// bounds that leave x's and w's 8 NV registers in registers (the policy's
// _NORM_MAX_VECS in ops/rmsnorm.py).
template <int NV>
constexpr int rms_max_threads() {
  return NV <= 4 ? 1024 : NV <= 12 ? 512 : 256;
}

constexpr int kRmsMinBlock = 256;

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& v) {
  const T* e = reinterpret_cast<const T*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) {
    const float f = to_f32(e[j]);
    s += f * f;
  }
  return s;
}

template <typename T>
__device__ __forceinline__ uint4 scaled(const uint4& xv, const uint4& wv, float r) {
  const T* e = reinterpret_cast<const T*>(&xv);
  const T* we = reinterpret_cast<const T*>(&wv);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    o[j] = from_f32<T>(to_f32(e[j]) * r * to_f32(we[j]));
  return out;
}

// Marks v as changed, so that the compiler converts it to f32 again where
// it is used next rather than keeping f32 copies alive: x's between the
// two passes, w's across the rows (8 registers a vector instead of 4;
// ptxas otherwise spills NV 4, 8 and 12 at their launch bounds).
__device__ __forceinline__ void keep_packed(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

template <typename T, int NV>
__global__ void __launch_bounds__(rms_max_threads<NV>())
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                   long long rows, int d, int tpr, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const int rpb = blockDim.x / tpr;        // rows a block takes at a time
  const int slot = threadIdx.x / tpr;      // this thread's row among them
  const int t = threadIdx.x - slot * tpr;  // and its place in the row
  const int warps = tpr >> 5;              // warps a row
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  __shared__ float part[2][32];  // the warps' partial sums, by parity

  uint4 wr[NV > 0 ? NV : 1];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = t + j * tpr;
    wr[j] = i < nvec ? wv[i] : make_uint4(0u, 0u, 0u, 0u);
  }

  int parity = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * rpb; base < rows;
       base += static_cast<long long>(gridDim.x) * rpb, parity ^= 1) {
    const long long row = base + slot;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nvec;
    uint4 xv[NV > 0 ? NV : 1];
    float ss = 0.f;
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = t + j * tpr;
        xv[j] = live && i < nvec ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        ss += sum_sq<T>(xv[j]);
        keep_packed(xv[j]);
        keep_packed(wr[j]);
      }
    } else if (live) {
      for (int i = t; i < nvec; i += tpr) ss += sum_sq<T>(xr[i]);
    }
    ss = warp_sum(ss);
    if (warps > 1) {  // the same for the whole block: every thread meets the barrier
      if ((threadIdx.x & 31) == 0) part[parity][threadIdx.x >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < warps; ++k) ss += part[parity][slot * warps + k];
    }
    if (!live) continue;
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    uint4* yr = reinterpret_cast<uint4*>(y) + row * nvec;
    if constexpr (NV > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = t + j * tpr;
        if (i < nvec) yr[i] = scaled<T>(xv[j], wr[j], r);
      }
    } else {
      for (int i = t; i < nvec; i += tpr) yr[i] = scaled<T>(xr[i], wv[i], r);
    }
  }
}

template <typename T, int NV>
int launch_rmsnorm(const void* x, const void* w, void* y, long long rows, int d, float eps,
                   int tpr, int grid, cudaStream_t stream) {
  const int block = tpr > kRmsMinBlock ? tpr : kRmsMinBlock;
  if (block > rms_max_threads<NV>() ||
      (NV > 0 && static_cast<long long>(NV) * tpr * (16 / sizeof(T)) < d))
    return kErrUnsupported;
  rmsnorm_kernel<T, NV><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), rows, d, tpr,
      eps);
  return launch_status();
}

template <typename T>
int launch_rmsnorm_nv(const void* x, const void* w, void* y, long long rows, int d, float eps,
                      int tpr, int nv, int grid, cudaStream_t stream) {
#define SKK_RMS(NV) \
  case NV:          \
    return launch_rmsnorm<T, NV>(x, w, y, rows, d, eps, tpr, grid, stream)
  switch (nv) {
    SKK_RMS(0);
    SKK_RMS(1);
    SKK_RMS(2);
    SKK_RMS(3);
    SKK_RMS(4);
    SKK_RMS(6);
    SKK_RMS(8);
    SKK_RMS(12);
    SKK_RMS(16);
    default:
      return kErrUnsupported;
  }
#undef SKK_RMS
}

}  // namespace
}  // namespace skk

// x, y: (rows, d) contiguous, 16-byte aligned; w: (d,).  d % 8 == 0.  The
// launch (ops/rmsnorm.py, _norm_launch): tpr threads a row (a power of
// two, 32 to 1,024), nv vectors a thread (0: the loop), grid blocks.
extern "C" int skk_rmsnorm(const void* x, const void* w, void* y, long long rows, int d,
                           float eps, int dtype, int tpr, int nv, int grid, void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0 || tpr < 32 || tpr > 1024 || (tpr & (tpr - 1)) != 0 ||
      grid < 1)
    return skk::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case skk::kBF16:
      return skk::launch_rmsnorm_nv<__nv_bfloat16>(x, w, y, rows, d, eps, tpr, nv, grid, s);
    case skk::kF32:
      return skk::launch_rmsnorm_nv<float>(x, w, y, rows, d, eps, tpr, nv, grid, s);
    default:
      return skk::kErrUnsupported;
  }
}
