// Paged single-token GQA decode attention over the pooled KV arena.
//
// Replaces skypilot_tpu/ops/decode_attention.py::decode_attention_pooled
// (body _pooled_attn_kernel -> _decode_attn_kernel, window=1).  The TPU
// kernel walked a (B, T) grid of logical blocks with the table lookup in
// its index map, clamping every block past pos // BS to the last live one
// so Pallas skipped the repeated DMA.  Here a block walks only the live
// keys and stops: nothing past min(pos + 1, T * BS) is read.
//
// q:      (B, KV, G, HD), head h = kv * G + g.
// arena:  (L, NB, BS, KV, HD) for K and for V, contiguous.
// tables: (B, T) int32; tables[b, j] is the arena block that holds slot
//         b's logical rows [j * BS, (j + 1) * BS).
// positions: (B,) int32; keys 0 .. positions[b] are visible.
// out:    (B, KV, G, HD) in the dtype of q.
//
// Bound on the H100: bytes.  A decode step reads each live K/V row once
// (2 * ctx * KV * HD * sizeof(T) per slot) and does 4 flops per element
// read, so its floor is those bytes over 3.35 TB/s.  Design: one
// 128-thread block per (slot, KV head); the G query rows of the head share
// every K/V chunk staged in shared memory, so the arena is read once per
// KV head, not once per query head.  Each chunk of up to 64 keys is loaded
// with 16-byte vector loads (one row of one KV head is HD contiguous
// elements), scored with one warp per (query row, key), folded into an f32
// online softmax (running max and sum per query row), and accumulated into
// f32 registers, one head-dim column per thread.  Not yet done: splitting
// the keys of one slot across blocks (split-KV), which a long context at
// small batch needs to fill the 132 SMs.
#include "common.cuh"

namespace skk {
namespace {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxGroup = 8;

template <typename T, int HD>
struct DecodeCfg {
  // Keys per chunk: K + V chunks take at most 32 KB of shared memory.
  static constexpr int CH_FIT = 32768 / (2 * HD * static_cast<int>(sizeof(T)));
  static constexpr int CH = CH_FIT > 64 ? 64 : CH_FIT;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int VPR = HD / VEC;  // 16-byte vectors per key row
  static constexpr int DPT = (HD + kDecThreads - 1) / kDecThreads;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_arena,
    const T* __restrict__ v_arena, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out, int kv_heads,
    int group, int n_blocks, int block_size, int t_width, int layer,
    float scale) {
  using C = DecodeCfg<T, HD>;
  __shared__ __align__(16) T k_s[C::CH * HD];
  __shared__ __align__(16) T v_s[C::CH * HD];
  __shared__ float q_s[kMaxGroup * HD];
  __shared__ float p_s[kMaxGroup * C::CH];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float corr_s[kMaxGroup];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int pos = positions[b];
  const long long live = static_cast<long long>(t_width) * block_size;
  const int n_keys = static_cast<int>(min(static_cast<long long>(pos) + 1, live));

  const T* qb = q + (static_cast<int64_t>(b) * kv_heads + kvh) * group * HD;
  for (int i = tid; i < group * HD; i += kDecThreads) q_s[i] = to_f32(qb[i]);
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kMaxGroup][C::DPT];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) acc[g][j] = 0.f;

  const int* trow = tables + static_cast<int64_t>(b) * t_width;
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t blk_stride = static_cast<int64_t>(block_size) * row_stride;
  const int64_t base = static_cast<int64_t>(layer) * n_blocks * blk_stride +
                       static_cast<int64_t>(kvh) * HD;
  __syncthreads();

  for (int c0 = 0; c0 < n_keys; c0 += C::CH) {
    const int n = min(C::CH, n_keys - c0);
    for (int i = tid; i < n * C::VPR; i += kDecThreads) {
      const int r = i / C::VPR;
      const int c = i - r * C::VPR;
      const int t = c0 + r;
      const int64_t off = base + static_cast<int64_t>(trow[t / block_size]) * blk_stride +
                          static_cast<int64_t>(t % block_size) * row_stride + c * C::VEC;
      reinterpret_cast<uint4*>(k_s)[i] = *reinterpret_cast<const uint4*>(k_arena + off);
      reinterpret_cast<uint4*>(v_s)[i] = *reinterpret_cast<const uint4*>(v_arena + off);
    }
    __syncthreads();

    // Scores: one warp per (query row g, key r), lanes across HD.
    for (int p = warp; p < group * n; p += kDecWarps) {
      const int g = p / n;
      const int r = p - g * n;
      float s = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) s += q_s[g * HD + d] * to_f32(k_s[r * HD + d]);
      s = warp_sum(s);
      if (lane == 0) p_s[g * C::CH + r] = s * scale;
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int g = warp; g < group; g += kDecWarps) {
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, p_s[g * C::CH + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(p_s[g * C::CH + r] - m_new);
        p_s[g * C::CH + r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread tid owns head-dim columns tid, tid + 128, ...
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        const float corr = corr_s[g];
#pragma unroll
        for (int j = 0; j < C::DPT; ++j) {
          const int d = tid + j * kDecThreads;
          if (d < HD) {
            float a = acc[g][j] * corr;
            for (int r = 0; r < n; ++r) a += p_s[g * C::CH + r] * to_f32(v_s[r * HD + d]);
            acc[g][j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<int64_t>(b) * kv_heads + kvh) * group * HD;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const float inv = 1.f / l_s[g];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) {
        const int d = tid + j * kDecThreads;
        if (d < HD) ob[g * HD + d] = from_f32<T>(acc[g][j] * inv);
      }
    }
  }
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* tables, const void* positions, void* out,
                  int batch, int kv_heads, int group, int n_blocks,
                  int block_size, int t_width, int layer, float scale,
                  cudaStream_t stream) {
  const dim3 grid(batch, kv_heads);
  paged_decode_kernel<T, HD><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), kv_heads,
      group, n_blocks, block_size, t_width, layer, scale);
  return launch_status();
}

template <typename T>
int dispatch_decode(int head_dim, const void* q, const void* k,
                    const void* v, const void* tables, const void* positions,
                    void* out, int batch, int kv_heads, int group,
                    int n_blocks, int block_size, int t_width, int layer,
                    float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_decode<T, 64>(q, k, v, tables, positions, out, batch,
                                  kv_heads, group, n_blocks, block_size,
                                  t_width, layer, scale, stream);
    case 128:
      return launch_decode<T, 128>(q, k, v, tables, positions, out, batch,
                                   kv_heads, group, n_blocks, block_size,
                                   t_width, layer, scale, stream);
    case 256:
      return launch_decode<T, 256>(q, k, v, tables, positions, out, batch,
                                   kv_heads, group, n_blocks, block_size,
                                   t_width, layer, scale, stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace
}  // namespace skk

extern "C" int skk_paged_decode(const void* q, const void* k_arena,
                                const void* v_arena, const void* tables,
                                const void* positions, void* out, int batch,
                                int kv_heads, int group, int head_dim,
                                int n_blocks, int block_size, int t_width,
                                int layer, float scale, int dtype,
                                void* stream) {
  if (batch < 1 || kv_heads < 1 || kv_heads > 65535 ||
      group < 1 || group > skk::kMaxGroup || block_size < 1 || t_width < 1 ||
      layer < 0)
    return skk::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case skk::kBF16:
      return skk::dispatch_decode<__nv_bfloat16>(
          head_dim, q, k_arena, v_arena, tables, positions, out, batch,
          kv_heads, group, n_blocks, block_size, t_width, layer, scale, s);
    case skk::kF32:
      return skk::dispatch_decode<float>(
          head_dim, q, k_arena, v_arena, tables, positions, out, batch,
          kv_heads, group, n_blocks, block_size, t_width, layer, scale, s);
    default:
      return skk::kErrUnsupported;
  }
}
