// Paged window attention over the pooled KV arena: W queries per slot,
// window row w seeing keys <= positions[b] + w.  It serves the
// speculative verify step (W = spec_k + 1 per slot) and the prefill lane
// of the fused prefill+decode step (one slot, W = fuse_budget).
//
// Replaces skypilot_tpu/ops/decode_attention.py::
// decode_window_attention_pooled (body _pooled_attn_kernel ->
// _decode_attn_kernel with window=W).  The TPU kernel gave one grid row
// to each slot and stacked all KV * W * G query rows of the slot into one
// VMEM tile; its (B, T) grid walked the logical blocks in order, clamped
// past the slot's last live block so Pallas skipped the repeated DMA.
// On the H100 a block holds far fewer rows in registers (K1 keeps at most
// 8), and a fused lane of width 264 at G 4 has 1,056 rows per KV head, so
// the rows are tiled: one 128-thread block per (slot, KV head, tile of
// R = 16 rows), in the TPU kernel's row order (kv-major, then window, then
// group: row = w * G + g inside a KV head).
//
// q:      (B, KV, W * G, HD), the kv-major row layout (the wrapper
//         permutes the (B, W, KV, G, HD) queries into it).
// arena:  (L, NB, BS, KV, HD) for K and for V, contiguous; bf16/f32 in
//         q's dtype, or int8 with k_scale/v_scale (L, NB, BS, KV) f32.
// tables: (B, T) int32; tables[b, j] holds slot b's logical rows
//         [j * BS, (j + 1) * BS).
// positions: (B,) int32, the cache row of window row 0.
// out:    (B, KV, W * G, HD) in the dtype of q.
//
// A tile whose deepest row is window row w_max reads keys
// 0 .. min(positions[b] + w_max, T * BS - 1) and nothing else: no key past
// the window, no table entry past the keys it needs.  Each chunk of CH
// keys is staged once in shared memory (16-byte vector loads, rows padded
// by 16 bytes so the score phase's vector reads of 8 neighbouring keys hit
// 8 distinct bank groups) and serves all R rows; each row masks it at
// key <= positions[b] + w(row).  Scores: thread (key j, rows of its group)
// accumulates R * CH / 128 dot products over 16-byte slices of its key.
// Softmax: f32 online softmax per row (running max, sum), one warp per
// row.  P.V: each thread owns head-dim columns and keeps R f32
// accumulators.  An int8 arena is dequantized element by element with its
// (row, KV head) scale before each product, as the TPU kernel did.
//
// Bound on the H100: the verify shape (B 8, W 13, G 4, ~700 keys a slot)
// is bound by bytes like K1: each live K/V row is read once per
// (slot, KV head, tile), 4 tiles of 16 rows for 52 rows.  The fused lane
// (B 1, W 264, G 4) does 4 * HD flops per (row, visible key): ~3 GFLOP
// per layer at ~700 keys, bound by operations at the 989 TFLOP/s bf16
// tensor-core peak.  This first version does its products with f32 FMAs
// on the CUDA cores, so it sits far above that bound; wgmma on the score
// and P.V tiles is the fix.
#include "common.cuh"

namespace skk {
namespace {

constexpr int kWinThreads = 128;
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kWinRows = 16;

template <typename T, int HD>
struct WindowCfg {
  static constexpr int R = kWinRows;
  static constexpr int ESZ = static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / ESZ;  // elements of one 16-byte vector
  static constexpr int VPR = HD / VEC;  // vectors per key row
  static constexpr int LD = HD + VEC;   // smem row stride, 16-byte pad
  static constexpr int DPT = (HD + kWinThreads - 1) / kWinThreads;
  // Keys per chunk: the largest of 64, 32, 16, 8 whose staging fits the
  // 48 KB of static shared memory beside the q tile.
  static constexpr int FIXED = R * HD * 4 + 3 * R * 4;
  static constexpr int PER_KEY = 2 * LD * ESZ + R * 4 + 2 * 4;
  static constexpr int BUDGET = 48 * 1024 - 256;
  static constexpr int CH = FIXED + 64 * PER_KEY <= BUDGET   ? 64
                            : FIXED + 32 * PER_KEY <= BUDGET ? 32
                            : FIXED + 16 * PER_KEY <= BUDGET ? 16
                                                             : 8;
  static constexpr int NG = kWinThreads / CH;  // row groups, score phase
  static constexpr int RPT = R / NG;           // rows per thread, score phase
  static_assert(FIXED + CH * PER_KEY <= BUDGET, "window tile too large");
  static_assert(R % NG == 0, "rows must split over the row groups");
};

// TQ: q and out (f32 or bf16); T: arena elements (TQ, or int8 with
// per-(row, KV head) f32 scales).
template <typename TQ, typename T, int HD>
__global__ void __launch_bounds__(kWinThreads) paged_window_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k_arena,
    const T* __restrict__ v_arena, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, TQ* __restrict__ out, int kv_heads,
    int rows, int group, int n_blocks, int block_size, int t_width,
    int layer, float scale) {
  using C = WindowCfg<T, HD>;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int R = C::R;
  constexpr int CH = C::CH;
  __shared__ __align__(16) T k_s[CH * C::LD];
  __shared__ __align__(16) T v_s[CH * C::LD];
  __shared__ __align__(16) float q_s[R * HD];
  __shared__ float p_s[R * CH];
  __shared__ float ks_s[kQuant ? CH : 1];
  __shared__ float vs_s[kQuant ? CH : 1];
  __shared__ float m_s[R];
  __shared__ float l_s[R];
  __shared__ float corr_s[R];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.z * R;
  const int nr = min(R, rows - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int pos = positions[b];
  // The tile's deepest query is window row (r0 + nr - 1) / group.
  const long long live = static_cast<long long>(t_width) * block_size;
  const int n_keys = static_cast<int>(
      min(static_cast<long long>(pos) + (r0 + nr - 1) / group + 1, live));

  const int64_t q_off = ((static_cast<int64_t>(b) * kv_heads + kvh) * rows + r0) * HD;
  for (int i = tid; i < R * HD; i += kWinThreads)
    q_s[i] = i < nr * HD ? to_f32(q[q_off + i]) : 0.f;
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[R][C::DPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) acc[r][j] = 0.f;

  const int* trow = tables + static_cast<int64_t>(b) * t_width;
  const int64_t layer_blk = static_cast<int64_t>(layer) * n_blocks;
  // Score phase: this thread's key and the first of its rows.
  const int sj = tid % CH;
  const int sr = (tid / CH) * C::RPT;
  __syncthreads();

  for (int c0 = 0; c0 < n_keys; c0 += CH) {
    const int n = min(CH, n_keys - c0);
    for (int i = tid; i < n * C::VPR; i += kWinThreads) {
      const int r = i / C::VPR;
      const int c = i - r * C::VPR;
      const int t = c0 + r;
      const int64_t row = (layer_blk + trow[t / block_size]) * block_size + t % block_size;
      const int64_t off = (row * kv_heads + kvh) * HD + c * C::VEC;
      *reinterpret_cast<uint4*>(k_s + r * C::LD + c * C::VEC) =
          *reinterpret_cast<const uint4*>(k_arena + off);
      *reinterpret_cast<uint4*>(v_s + r * C::LD + c * C::VEC) =
          *reinterpret_cast<const uint4*>(v_arena + off);
      if constexpr (kQuant) {
        if (c == 0) {
          ks_s[r] = k_scale[row * kv_heads + kvh];
          vs_s[r] = v_scale[row * kv_heads + kvh];
        }
      }
    }
    __syncthreads();

    // Scores: thread (key sj, rows sr .. sr + RPT - 1).
    if (sj < n) {
      float s[C::RPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) s[i] = 0.f;
      const T* krow = k_s + sj * C::LD;
      float ksc = 1.f;
      if constexpr (kQuant) ksc = ks_s[sj];
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += C::VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
        const T* kv = reinterpret_cast<const T*>(&raw);
        float kf[C::VEC];
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) {
          kf[e] = to_f32(kv[e]);
          if constexpr (kQuant) kf[e] *= ksc;
        }
#pragma unroll
        for (int i = 0; i < C::RPT; ++i) {
          const float* qr = q_s + (sr + i) * HD + d0;
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) s[i] += qr[e] * kf[e];
        }
      }
      const int key = c0 + sj;
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const int w = (r0 + sr + i) / group;
        p_s[(sr + i) * CH + sj] = key <= pos + w ? s[i] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one warp per row.
    for (int r = warp; r < R; r += kWinWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r * CH + j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(p_s[r * CH + j] - m_new);
        p_s[r * CH + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread tid owns head-dim columns tid, tid + 128, ...
#pragma unroll
    for (int jj = 0; jj < C::DPT; ++jj) {
      const int d = tid + jj * kWinThreads;
      if (d < HD) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][jj] *= corr_s[r];
        for (int j = 0; j < n; ++j) {
          float vd = to_f32(v_s[j * C::LD + d]);
          if constexpr (kQuant) vd *= vs_s[j];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][jj] += p_s[r * CH + j] * vd;
        }
      }
    }
    __syncthreads();
  }

  TQ* ob = out + q_off;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      const float inv = 1.f / l_s[r];
#pragma unroll
      for (int jj = 0; jj < C::DPT; ++jj) {
        const int d = tid + jj * kWinThreads;
        if (d < HD) ob[r * HD + d] = from_f32<TQ>(acc[r][jj] * inv);
      }
    }
  }
}

template <typename TQ, typename T, int HD>
int launch_window(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* tables, const void* positions, void* out,
                  int batch, int kv_heads, int rows, int group, int n_blocks,
                  int block_size, int t_width, int layer, float scale,
                  cudaStream_t stream) {
  const dim3 grid(batch, kv_heads, (rows + kWinRows - 1) / kWinRows);
  paged_window_kernel<TQ, T, HD><<<grid, kWinThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<TQ*>(out), kv_heads,
      rows, group, n_blocks, block_size, t_width, layer, scale);
  return launch_status();
}

template <typename TQ, typename T>
int dispatch_window(int head_dim, const void* q, const void* k,
                    const void* v, const void* k_scale, const void* v_scale,
                    const void* tables, const void* positions, void* out,
                    int batch, int kv_heads, int rows, int group,
                    int n_blocks, int block_size, int t_width, int layer,
                    float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_window<TQ, T, 64>(q, k, v, k_scale, v_scale, tables,
                                      positions, out, batch, kv_heads, rows,
                                      group, n_blocks, block_size, t_width,
                                      layer, scale, stream);
    case 128:
      return launch_window<TQ, T, 128>(q, k, v, k_scale, v_scale, tables,
                                       positions, out, batch, kv_heads, rows,
                                       group, n_blocks, block_size, t_width,
                                       layer, scale, stream);
    case 256:
      return launch_window<TQ, T, 256>(q, k, v, k_scale, v_scale, tables,
                                       positions, out, batch, kv_heads, rows,
                                       group, n_blocks, block_size, t_width,
                                       layer, scale, stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace
}  // namespace skk

// rows = W * G query rows per (slot, KV head).  q_dtype: kF32 or kBF16;
// kv_dtype: q_dtype, or kI8 with both scale pointers set.
extern "C" int skk_paged_window(const void* q, const void* k_arena,
                                const void* v_arena, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* positions, void* out, int batch,
                                int kv_heads, int rows, int group,
                                int head_dim, int n_blocks, int block_size,
                                int t_width, int layer, float scale,
                                int q_dtype, int kv_dtype, void* stream) {
  if (batch < 1 || kv_heads < 1 || kv_heads > 65535 || group < 1 ||
      rows < group || rows % group != 0 ||
      (rows + skk::kWinRows - 1) / skk::kWinRows > 65535 || block_size < 1 ||
      t_width < 1 || layer < 0)
    return skk::kErrUnsupported;
  if (kv_dtype == skk::kI8 && (k_scale == nullptr || v_scale == nullptr))
    return skk::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKK_WINDOW(TQ, T)                                                     \
  skk::dispatch_window<TQ, T>(head_dim, q, k_arena, v_arena, k_scale,          \
                              v_scale, tables, positions, out, batch,          \
                              kv_heads, rows, group, n_blocks, block_size,     \
                              t_width, layer, scale, s)
  if (q_dtype == skk::kBF16 && kv_dtype == skk::kBF16)
    return SKK_WINDOW(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == skk::kF32 && kv_dtype == skk::kF32)
    return SKK_WINDOW(float, float);
  if (q_dtype == skk::kBF16 && kv_dtype == skk::kI8)
    return SKK_WINDOW(__nv_bfloat16, int8_t);
  if (q_dtype == skk::kF32 && kv_dtype == skk::kI8)
    return SKK_WINDOW(float, int8_t);
#undef SKK_WINDOW
  return skk::kErrUnsupported;
}
