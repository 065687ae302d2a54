// Single-token GQA decode attention: one body, two ways to find a key row.
//
// K1 (skk_paged_decode) replaces
// skypilot_tpu/ops/decode_attention.py::decode_attention_pooled (body
// _pooled_attn_kernel -> _decode_attn_kernel, window=1): the pooled KV
// arena read through per-slot block tables.  K7 (skk_contig_decode)
// replaces skypilot_tpu/ops/decode_attention.py::decode_attention (the
// same _decode_attn_kernel over the contiguous, length-bucketed cache of
// the legacy decode_impl='paged' plane).  On the TPU the two shared one
// body and differed only in their index maps; here they share one
// templated kernel and differ only in the Rows policy that maps (slot,
// key) to a cache row.  The TPU kernel walked a grid of logical blocks,
// clamping every block past pos // block to the last live one so Pallas
// skipped the repeated DMA.  Here a block walks only the live keys and
// stops: nothing past min(pos + 1, capacity) is read.
//
// q:      (B, KV, G, HD), head h = kv * G + g.
// K1 arena:  (L, NB, BS, KV, HD) for K and for V, contiguous; tables
//            (B, T) int32, tables[b, j] the arena block of slot b's
//            logical rows [j * BS, (j + 1) * BS).
// K7 cache:  (L, B, S, KV, HD) for K and for V, contiguous.
// Either: bf16/f32 in q's dtype, or int8 with k_scale/v_scale of the
//         same shape without HD, f32.
// positions: (B,) int32; keys 0 .. positions[b] are visible.
// out:    (B, KV, G, HD) in the dtype of q.
//
// Bound on the H100: bytes.  A decode step reads each live K/V row once
// (2 * ctx * KV * HD * sizeof(element) per slot, plus 8 bytes of scales
// per row and KV head for int8) and does 4 flops per element read, so
// its floor is those bytes over 3.35 TB/s.  Design: one 128-thread block
// per (slot, KV head); the G query rows of the head share every K/V chunk
// staged in shared memory, so the cache is read once per KV head, not
// once per query head.  Each chunk of up to 64 keys is loaded with
// 16-byte vector loads (one row of one KV head is HD contiguous
// elements), scored with one warp per (query row, key), folded into an
// f32 online softmax (running max and sum per query row), and accumulated
// into f32 registers, one head-dim column per thread.  An int8 cache is
// dequantized element by element with its (row, KV head) scale before
// each product, as the TPU kernel did.  Row offsets are 64-bit: L * B * S
// * KV * HD passes 2^31 for a contiguous 8B cache at batch >= 32.  Not
// yet done: splitting the keys of one slot across blocks (split-KV),
// which a long context at small batch needs to fill the 132 SMs.
#include "common.cuh"

namespace skk {
namespace {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxGroup = 8;

// Rows policies: n_keys(b, pos) is how many keys slot b attends,
// row(b, t) where its key t sits, in units of one (KV, HD) cache row (the
// int8 scales sit at row * KV + kv).
struct PooledRows {
  const int* tables;
  int t_width;
  int block_size;
  int n_blocks;
  int layer;
  __device__ int n_keys(int, int pos) const {
    return static_cast<int>(min(static_cast<long long>(pos) + 1,
                                static_cast<long long>(t_width) * block_size));
  }
  __device__ int64_t row(int b, int t) const {
    const int blk = tables[static_cast<int64_t>(b) * t_width + t / block_size];
    return (static_cast<int64_t>(layer) * n_blocks + blk) * block_size +
           t % block_size;
  }
};

struct ContigRows {
  int batch;
  int s_len;
  int layer;
  __device__ int n_keys(int, int pos) const { return min(pos + 1, s_len); }
  __device__ int64_t row(int b, int t) const {
    return (static_cast<int64_t>(layer) * batch + b) * s_len + t;
  }
};

template <typename T, int HD>
struct DecodeCfg {
  // Keys per chunk: K + V chunks take at most 32 KB of shared memory.
  // T is the cache's element type.
  static constexpr int CH_FIT = 32768 / (2 * HD * static_cast<int>(sizeof(T)));
  static constexpr int CH = CH_FIT > 64 ? 64 : CH_FIT;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int VPR = HD / VEC;  // 16-byte vectors per key row
  static constexpr int DPT = (HD + kDecThreads - 1) / kDecThreads;
};

// TQ: q and out (f32 or bf16); T: cache elements (TQ, or int8 with
// per-(row, KV head) f32 scales).
template <typename TQ, typename T, int HD, typename Rows>
__global__ void __launch_bounds__(kDecThreads) decode_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, Rows rows,
    const int* __restrict__ positions, TQ* __restrict__ out, int kv_heads,
    int group, float scale) {
  using C = DecodeCfg<T, HD>;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  __shared__ __align__(16) T k_s[C::CH * HD];
  __shared__ __align__(16) T v_s[C::CH * HD];
  __shared__ float ks_s[kQuant ? C::CH : 1];
  __shared__ float vs_s[kQuant ? C::CH : 1];
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

  const int n_keys = rows.n_keys(b, positions[b]);

  const TQ* qb = q + (static_cast<int64_t>(b) * kv_heads + kvh) * group * HD;
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

  const int64_t row_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t col0 = static_cast<int64_t>(kvh) * HD;
  __syncthreads();

  for (int c0 = 0; c0 < n_keys; c0 += C::CH) {
    const int n = min(C::CH, n_keys - c0);
    for (int i = tid; i < n * C::VPR; i += kDecThreads) {
      const int r = i / C::VPR;
      const int c = i - r * C::VPR;
      const int64_t row = rows.row(b, c0 + r);
      const int64_t off = row * row_stride + col0 + c * C::VEC;
      reinterpret_cast<uint4*>(k_s)[i] = *reinterpret_cast<const uint4*>(k_cache + off);
      reinterpret_cast<uint4*>(v_s)[i] = *reinterpret_cast<const uint4*>(v_cache + off);
      if constexpr (kQuant) {
        if (c == 0) {
          const int64_t soff = row * kv_heads + kvh;
          ks_s[r] = k_scale[soff];
          vs_s[r] = v_scale[soff];
        }
      }
    }
    __syncthreads();

    // Scores: one warp per (query row g, key r), lanes across HD.
    for (int p = warp; p < group * n; p += kDecWarps) {
      const int g = p / n;
      const int r = p - g * n;
      float s = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) {
        float kd = to_f32(k_s[r * HD + d]);
        if constexpr (kQuant) kd *= ks_s[r];
        s += q_s[g * HD + d] * kd;
      }
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
            for (int r = 0; r < n; ++r) {
              float vd = to_f32(v_s[r * HD + d]);
              if constexpr (kQuant) vd *= vs_s[r];
              a += p_s[g * C::CH + r] * vd;
            }
            acc[g][j] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  TQ* ob = out + (static_cast<int64_t>(b) * kv_heads + kvh) * group * HD;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const float inv = 1.f / l_s[g];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) {
        const int d = tid + j * kDecThreads;
        if (d < HD) ob[g * HD + d] = from_f32<TQ>(acc[g][j] * inv);
      }
    }
  }
}

template <typename TQ, typename T, int HD, typename Rows>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale, Rows rows,
                  const void* positions, void* out, int batch, int kv_heads,
                  int group, float scale, cudaStream_t stream) {
  const dim3 grid(batch, kv_heads);
  decode_kernel<TQ, T, HD, Rows><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), rows,
      static_cast<const int*>(positions), static_cast<TQ*>(out), kv_heads,
      group, scale);
  return launch_status();
}

template <typename TQ, typename T, typename Rows>
int dispatch_head_dim(int head_dim, const void* q, const void* k,
                      const void* v, const void* k_scale, const void* v_scale,
                      Rows rows, const void* positions, void* out, int batch,
                      int kv_heads, int group, float scale,
                      cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_decode<TQ, T, 64, Rows>(q, k, v, k_scale, v_scale, rows,
                                            positions, out, batch, kv_heads,
                                            group, scale, stream);
    case 128:
      return launch_decode<TQ, T, 128, Rows>(q, k, v, k_scale, v_scale, rows,
                                             positions, out, batch, kv_heads,
                                             group, scale, stream);
    case 256:
      return launch_decode<TQ, T, 256, Rows>(q, k, v, k_scale, v_scale, rows,
                                             positions, out, batch, kv_heads,
                                             group, scale, stream);
    default:
      return kErrUnsupported;
  }
}

// q_dtype: kF32 or kBF16; kv_dtype: q_dtype, or kI8 with both scale
// pointers set.
template <typename Rows>
int dispatch_decode(const void* q, const void* k, const void* v,
                    const void* k_scale, const void* v_scale, Rows rows,
                    const void* positions, void* out, int batch, int kv_heads,
                    int group, int head_dim, float scale, int q_dtype,
                    int kv_dtype, void* stream) {
  if (batch < 1 || kv_heads < 1 || kv_heads > 65535 || group < 1 ||
      group > kMaxGroup || rows.layer < 0)
    return kErrUnsupported;
  if (kv_dtype == kI8 && (k_scale == nullptr || v_scale == nullptr))
    return kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKK_DECODE(TQ, T)                                                   \
  dispatch_head_dim<TQ, T, Rows>(head_dim, q, k, v, k_scale, v_scale, rows, \
                                 positions, out, batch, kv_heads, group,    \
                                 scale, s)
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return SKK_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kF32) return SKK_DECODE(float, float);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return SKK_DECODE(__nv_bfloat16, int8_t);
  if (q_dtype == kF32 && kv_dtype == kI8) return SKK_DECODE(float, int8_t);
#undef SKK_DECODE
  return kErrUnsupported;
}

}  // namespace
}  // namespace skk

// K1: the pooled arena (L, n_blocks, block_size, KV, HD) through tables
// (batch, t_width).
extern "C" int skk_paged_decode(const void* q, const void* k_arena,
                                const void* v_arena, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* positions, void* out, int batch,
                                int kv_heads, int group, int head_dim,
                                int n_blocks, int block_size, int t_width,
                                int layer, float scale, int q_dtype,
                                int kv_dtype, void* stream) {
  if (block_size < 1 || t_width < 1) return skk::kErrUnsupported;
  const skk::PooledRows rows{static_cast<const int*>(tables), t_width,
                             block_size, n_blocks, layer};
  return skk::dispatch_decode(q, k_arena, v_arena, k_scale, v_scale, rows,
                              positions, out, batch, kv_heads, group,
                              head_dim, scale, q_dtype, kv_dtype, stream);
}

// K7: the contiguous cache (L, batch, s_len, KV, HD).
extern "C" int skk_contig_decode(const void* q, const void* k_cache,
                                 const void* v_cache, const void* k_scale,
                                 const void* v_scale, const void* positions,
                                 void* out, int batch, int kv_heads,
                                 int group, int head_dim, int s_len,
                                 int layer, float scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  if (s_len < 1) return skk::kErrUnsupported;
  const skk::ContigRows rows{batch, s_len, layer};
  return skk::dispatch_decode(q, k_cache, v_cache, k_scale, v_scale, rows,
                              positions, out, batch, kv_heads, group,
                              head_dim, scale, q_dtype, kv_dtype, stream);
}
