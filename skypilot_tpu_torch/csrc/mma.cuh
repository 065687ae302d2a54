// Tensor-core building blocks shared by the bf16 flash kernels
// (flash_fwd.cu: K2; flash_bwd.cu: K5, K6): cp.async loads into padded
// shared-memory tiles, ldmatrix, and mma.sync m16n8k16 bf16 -> f32 with
// its fragment conversions.
//
// Tiles are 64 rows of D bf16 (4 warps of 16 rows a block), row stride
// D + 8 in shared memory: the 16-byte pad puts the eight rows of an
// ldmatrix 8 x 8 in distinct banks.
#pragma once

#include "common.cuh"

namespace skk {

using bf16 = __nv_bfloat16;

// Threads of a tensor-core flash block: 4 warps.
constexpr int kMmaThreads = 128;

template <int D>
struct MmaTile {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
  static constexpr int LD = D + 8;
  static constexpr int TILE = 64 * LD;  // elements of one 64-row tile
  static constexpr int DK = D / 16;     // k16 steps over D
  static constexpr int DN = D / 8;      // n8 tiles of an output row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (4) bytes; src_bytes 0 zero-fills the destination and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and each thread receives (row lane / 4, cols 2 (lane % 4), +1)
// of every matrix (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16).  Thread (g, t) =
// (lane / 4, lane % 4) holds c rows g, g + 8 and cols 2t, 2t + 1 as
// c[0..1], c[2..3]; a as (row g, cols 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); b as (k rows 2t.., col g), (2t + 8.., g).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 16 chunk of a (16 x 8n) f32 accumulator,
// rounded to bf16: its n8 tiles c0 and c1 side by side.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copies 64 rows of D bf16 from sequence row `row0` of a strided (S, D)
// view into a smem tile of row stride D + 8 with cp.async, zero-filling
// rows at or past S.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int64_t row_stride,
                                                int row0, int seq_len) {
  constexpr int VPR = D / 8;
#pragma unroll
  for (int n = 0; n < 64 * VPR / kMmaThreads; ++n) {
    const int i = threadIdx.x + n * kMmaThreads;
    const int r = i / VPR;
    const int c = i - r * VPR;
    const bool in = row0 + r < seq_len;
    const bf16* from = in ? src + static_cast<int64_t>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(smem_u32(dst + r * MmaTile<D>::LD + c * 8), from, in ? 16 : 0);
  }
}

// The tensor-core route of the flash kernels: bf16 at D 64 and 128.  f32
// would need TF32, which changes f32 results; bf16 at D 256 would need
// 256 registers a thread for K6's accumulators alone.
inline bool tensor_core_route(int dtype, int head_dim) {
  return dtype == kBF16 && (head_dim == 64 || head_dim == 128);
}

}  // namespace skk
