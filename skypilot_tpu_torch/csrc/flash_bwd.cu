// Flash attention backward, (B, S, H, D) layout, GQA: dq (K5) and dk, dv
// (K6), from the forward's row logsumexp (flash_fwd.cu) and
// delta = rowsum(o * do), which the wrapper computes.
//
// Replaces the two pallas_calls of skypilot_tpu/ops/attention.py::
// _flash_bwd: _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel.  On the TPU
// both ran a (B, H, block, block) grid whose innermost axis walked the
// other operand's blocks in order, carrying an f32 accumulator in VMEM,
// and the dk/dv kernel wrote per-query-head partials (B, H, S, D) that XLA
// then summed over the GQA group.  On the H100 blocks run in parallel and
// in no order, so a block owns its output tile and loops itself:
//
// - K5 (dq): one block per (q-block, head, batch), as the forward.  It
//   walks the k-blocks up to the diagonal (all of them when not causal),
//   recomputes s = q k^T and dp = do v^T on each, p = exp(scale s - lse)
//   and ds = p (dp - delta), and accumulates ds k in f32; it writes
//   scale * dq once.
// - K6 (dk, dv): one block per (k-block, KV head, batch).  It walks the G
//   query heads of its group and, for each, the q-blocks from the
//   diagonal on, and accumulates dv += p^T do and dk += ds^T q in f32 for
//   the KV head itself.  So it writes (B, S, KV, D) once, not 2 (B, S, H,
//   D) partials and a reduction (4x fewer bytes at G = 4).
//
// Numerics follow the TPU kernels: s, p, dp and every accumulator in f32;
// p and ds rounded to the input dtype before the dv, dq and dk products;
// the causal mask q_row >= k_col; rows and keys past S (zero-filled on
// load) are masked like the causal ones, so they add exactly 0.
//
// Bound on the H100: operations at training lengths (6 D flops a visible
// (query, key) pair for K5, 8 D for K6, against 989 TFLOP/s in bf16).
// This first version does its products with f32 FMAs on the CUDA cores,
// staged through shared memory like K2, 128 threads a block.  K6 holds two
// (BK x D) accumulators, so its key tile shrinks with D (BK = 4096 / D:
// 64, 32, 16 keys) to keep them at 64 registers a thread.  Tensor-core
// products (mma.sync, then wgmma fed by TMA) are the next step.
#include "common.cuh"

namespace skk {
namespace {

constexpr int kBwdThreads = 128;

// (batch, seq, head) element strides of q, k, v, do and the two outputs
// (dq and unused for K5; dk and dv for K6).  The last dims are contiguous.
struct BwdStrides {
  int64_t q[3], k[3], v[3], g[3], a[3], b[3];
};

// Copies ROWS rows of D elements from sequence row `row0` of a strided
// (S, D) view into a smem tile of row stride LD, zero-filling rows at or
// past S.
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t row_stride, int row0,
                                          int seq_len) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kBwdThreads) {
    const int r = i / VPR;
    const int c = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq_len)
      val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * row_stride +
                                            c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) = val;
  }
}

// lse or delta of ROWS query rows from `row0` (0 past S).
template <int ROWS>
__device__ __forceinline__ void load_stats(float* dst, const float* src, int row0, int seq_len) {
  for (int r = threadIdx.x; r < ROWS; r += kBwdThreads)
    dst[r] = row0 + r < seq_len ? src[row0 + r] : 0.f;
}

// s = q k^T and dp = do v^T over a (16 SR x 8 SC) tile: thread (ty, tx) of
// a 16 x 8 grid holds rows ty + 16 i and cols tx + 8 j of both.
template <typename T, int D, int LD, int SR, int SC>
__device__ __forceinline__ void score_tiles(const T* q_s, const T* g_s, const T* k_s, const T* v_s,
                                            int ty, int tx, float (&s)[SR][SC],
                                            float (&dp)[SR][SC]) {
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qv[SR], gv[SR], kv[SC], vv[SC];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      qv[i] = to_f32(q_s[(ty + 16 * i) * LD + d]);
      gv[i] = to_f32(g_s[(ty + 16 * i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      kv[j] = to_f32(k_s[(tx + 8 * j) * LD + d]);
      vv[j] = to_f32(v_s[(tx + 8 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += gv[i] * vv[j];
      }
  }
}

// K5 tiles: as the forward (64 x 64, 32 x 32 at D = 256).
template <typename T, int D>
struct DqCfg {
  static constexpr int BQ = D <= 128 ? 64 : 32;
  static constexpr int BK = BQ;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int LD = D + PAD;    // smem row stride of q, do, k, v
  static constexpr int LDP = BK + PAD;  // smem row stride of the ds tile
  static constexpr int SR = BQ / 16;    // score tile: 16 x 8 threads
  static constexpr int SC = BK / 8;
  static constexpr int OR = BQ / 8;     // dq tile: 8 x 16 threads
  static constexpr int OC = D / 16;
  static constexpr size_t SMEM =
      static_cast<size_t>(2 * BQ * LD + 2 * BK * LD + BQ * LDP) * sizeof(T) +
      2 * BQ * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int seq_len, int group, int causal, float scale, BwdStrides st) {
  using C = DqCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = q_s + C::BQ * C::LD;
  T* k_s = g_s + C::BQ * C::LD;
  T* v_s = k_s + C::BK * C::LD;
  T* ds_s = v_s + C::BK * C::LD;
  float* lse_s = reinterpret_cast<float*>(ds_s + C::BQ * C::LDP);
  float* delta_s = lse_s + C::BQ;

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;    // score tile coordinates
  const int oy = tid >> 4, ox = tid & 15;   // dq tile coordinates
  const int q0 = qb * C::BQ;
  const int64_t stat0 = (static_cast<int64_t>(b) * gridDim.y + h) * seq_len;

  const T* kp = k + b * st.k[0] + kvh * st.k[2];
  const T* vp = v + b * st.v[0] + kvh * st.v[2];
  load_rows<T, D, C::LD, C::BQ>(q_s, q + b * st.q[0] + h * st.q[2], st.q[1], q0, seq_len);
  load_rows<T, D, C::LD, C::BQ>(g_s, g + b * st.g[0] + h * st.g[2], st.g[1], q0, seq_len);
  load_stats<C::BQ>(lse_s, lse + stat0, q0, seq_len);
  load_stats<C::BQ>(delta_s, delta + stat0, q0, seq_len);

  float acc[C::OR][C::OC];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int j = 0; j < C::OC; ++j) acc[i][j] = 0.f;

  const int n_kb = (seq_len + C::BK - 1) / C::BK;
  const int last_kb = causal ? min(n_kb - 1, (q0 + C::BQ - 1) / C::BK) : n_kb - 1;
  for (int kb = 0; kb <= last_kb; ++kb) {
    const int k0 = kb * C::BK;
    load_rows<T, D, C::LD, C::BK>(k_s, kp, st.k[1], k0, seq_len);
    load_rows<T, D, C::LD, C::BK>(v_s, vp, st.v[1], k0, seq_len);
    __syncthreads();

    float s[C::SR][C::SC], dp[C::SR][C::SC];
    score_tiles<T, D, C::LD, C::SR, C::SC>(q_s, g_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int row = ty + 16 * i;
      const int qi = q0 + row;
      const float lse_r = lse_s[row], delta_r = delta_s[row];
#pragma unroll
      for (int j = 0; j < C::SC; ++j) {
        const int kj = k0 + tx + 8 * j;
        const bool ok = qi < seq_len && kj < seq_len && (!causal || kj <= qi);
        const float p = ok ? expf(s[i][j] * scale - lse_r) : 0.f;
        ds_s[row * C::LDP + tx + 8 * j] = from_f32<T>(p * (dp[i][j] - delta_r));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < C::BK; ++kk) {
      float dsv[C::OR], kv[C::OC];
#pragma unroll
      for (int i = 0; i < C::OR; ++i) dsv[i] = to_f32(ds_s[(oy + 8 * i) * C::LDP + kk]);
#pragma unroll
      for (int j = 0; j < C::OC; ++j) kv[j] = to_f32(k_s[kk * C::LD + ox + 16 * j]);
#pragma unroll
      for (int i = 0; i < C::OR; ++i)
#pragma unroll
        for (int j = 0; j < C::OC; ++j) acc[i][j] += dsv[i] * kv[j];
    }
    __syncthreads();
  }

  T* dqp = dq + b * st.a[0] + h * st.a[2];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int row = oy + 8 * i;
    if (q0 + row < seq_len) {
      T* out = dqp + static_cast<int64_t>(q0 + row) * st.a[1];
#pragma unroll
      for (int j = 0; j < C::OC; ++j) out[ox + 16 * j] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// K6 tiles: 64 query rows against BK = 4096 / D keys, so the two (BK x D)
// f32 accumulators take 2 * BK * D / 128 = 64 registers a thread.
template <typename T, int D>
struct DkvCfg {
  static constexpr int BQ = 64;
  static constexpr int BK = 4096 / D;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int LD = D + PAD;    // smem row stride of q, do, k, v
  static constexpr int LDP = BK + PAD;  // smem row stride of the p, ds tiles
  static constexpr int SR = BQ / 16;    // score tile: 16 x 8 threads
  static constexpr int SC = BK / 8;
  static constexpr int OR = BK / 8;     // dk, dv tiles: 8 x 16 threads
  static constexpr int OC = D / 16;
  static constexpr size_t SMEM =
      static_cast<size_t>(2 * BQ * LD + 2 * BK * LD + 2 * BQ * LDP) * sizeof(T) +
      2 * BQ * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int seq_len, int group, int causal, float scale,
    BwdStrides st) {
  using C = DkvCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = q_s + C::BQ * C::LD;
  T* k_s = g_s + C::BQ * C::LD;
  T* v_s = k_s + C::BK * C::LD;
  T* p_s = v_s + C::BK * C::LD;
  T* ds_s = p_s + C::BQ * C::LDP;
  float* lse_s = reinterpret_cast<float*>(ds_s + C::BQ * C::LDP);
  float* delta_s = lse_s + C::BQ;

  const int kb = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y * group;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;    // score tile coordinates
  const int oy = tid >> 4, ox = tid & 15;   // dk, dv tile coordinates
  const int k0 = kb * C::BK;

  load_rows<T, D, C::LD, C::BK>(k_s, k + b * st.k[0] + kvh * st.k[2], st.k[1], k0, seq_len);
  load_rows<T, D, C::LD, C::BK>(v_s, v + b * st.v[0] + kvh * st.v[2], st.v[1], k0, seq_len);

  float acc_dk[C::OR][C::OC], acc_dv[C::OR][C::OC];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int j = 0; j < C::OC; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }

  const int n_qb = (seq_len + C::BQ - 1) / C::BQ;
  // The first q-block with a row at or past k0 (causal: earlier rows see
  // none of these keys).
  const int first_qb = causal ? k0 / C::BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const T* qp = q + b * st.q[0] + h * st.q[2];
    const T* gp = g + b * st.g[0] + h * st.g[2];
    const int64_t stat0 = (static_cast<int64_t>(b) * heads + h) * seq_len;
    for (int qb = first_qb; qb < n_qb; ++qb) {
      const int q0 = qb * C::BQ;
      load_rows<T, D, C::LD, C::BQ>(q_s, qp, st.q[1], q0, seq_len);
      load_rows<T, D, C::LD, C::BQ>(g_s, gp, st.g[1], q0, seq_len);
      load_stats<C::BQ>(lse_s, lse + stat0, q0, seq_len);
      load_stats<C::BQ>(delta_s, delta + stat0, q0, seq_len);
      __syncthreads();

      float s[C::SR][C::SC], dp[C::SR][C::SC];
      score_tiles<T, D, C::LD, C::SR, C::SC>(q_s, g_s, k_s, v_s, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < C::SR; ++i) {
        const int row = ty + 16 * i;
        const int qi = q0 + row;
        const float lse_r = lse_s[row], delta_r = delta_s[row];
#pragma unroll
        for (int j = 0; j < C::SC; ++j) {
          const int col = tx + 8 * j;
          const int kj = k0 + col;
          const bool ok = qi < seq_len && kj < seq_len && (!causal || kj <= qi);
          const float p = ok ? expf(s[i][j] * scale - lse_r) : 0.f;
          p_s[row * C::LDP + col] = from_f32<T>(p);
          ds_s[row * C::LDP + col] = from_f32<T>(p * (dp[i][j] - delta_r));
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < C::BQ; ++qq) {
        float pv[C::OR], dsv[C::OR], gv[C::OC], qv[C::OC];
#pragma unroll
        for (int i = 0; i < C::OR; ++i) {
          pv[i] = to_f32(p_s[qq * C::LDP + oy + 8 * i]);
          dsv[i] = to_f32(ds_s[qq * C::LDP + oy + 8 * i]);
        }
#pragma unroll
        for (int j = 0; j < C::OC; ++j) {
          gv[j] = to_f32(g_s[qq * C::LD + ox + 16 * j]);
          qv[j] = to_f32(q_s[qq * C::LD + ox + 16 * j]);
        }
#pragma unroll
        for (int i = 0; i < C::OR; ++i)
#pragma unroll
          for (int j = 0; j < C::OC; ++j) {
            acc_dv[i][j] += pv[i] * gv[j];
            acc_dk[i][j] += dsv[i] * qv[j];
          }
      }
      __syncthreads();
    }
  }

  T* dkp = dk + b * st.a[0] + kvh * st.a[2];
  T* dvp = dv + b * st.b[0] + kvh * st.b[2];
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int row = oy + 8 * i;
    if (k0 + row < seq_len) {
      T* dk_row = dkp + static_cast<int64_t>(k0 + row) * st.a[1];
      T* dv_row = dvp + static_cast<int64_t>(k0 + row) * st.b[1];
#pragma unroll
      for (int j = 0; j < C::OC; ++j) {
        dk_row[ox + 16 * j] = from_f32<T>(acc_dk[i][j] * scale);
        dv_row[ox + 16 * j] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory has to be allowed first,
// once per instantiation.
template <typename K>
int allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, void* dq, int batch, int seq_len, int heads, int group,
              int causal, float scale, const BwdStrides& st, cudaStream_t stream) {
  using C = DqCfg<T, D>;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static bool smem_allowed = false;
  if (const int e = allow_smem(kernel, C::SMEM, &smem_allowed)) return e;
  const dim3 grid((seq_len + C::BQ - 1) / C::BQ, heads, batch);
  kernel<<<grid, kBwdThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dq), seq_len, group, causal, scale, st);
  return launch_status();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const float* lse,
               const float* delta, void* dk, void* dv, int batch, int seq_len, int kv_heads,
               int group, int causal, float scale, const BwdStrides& st, cudaStream_t stream) {
  using C = DkvCfg<T, D>;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static bool smem_allowed = false;
  if (const int e = allow_smem(kernel, C::SMEM, &smem_allowed)) return e;
  const dim3 grid((seq_len + C::BK - 1) / C::BK, kv_heads, batch);
  kernel<<<grid, kBwdThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq_len,
      group, causal, scale, st);
  return launch_status();
}

BwdStrides unpack_strides(const long long* s) {
  BwdStrides st;
  int64_t* dst[6] = {st.q, st.k, st.v, st.g, st.a, st.b};
  for (int t = 0; t < 6; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = s[3 * t + i];
  return st;
}

bool bad_shape(int batch, int seq_len, int heads, int kv_heads) {
  return batch < 1 || batch > 65535 || seq_len < 1 || heads < 1 || heads > 65535 ||
         kv_heads < 1 || heads % kv_heads != 0;
}

}  // namespace
}  // namespace skk

// q, do: (B, S, H, D); k, v: (B, S, KV, D), each with a contiguous last dim;
// lse, delta: (B, H, S) f32 contiguous.  strides: 18 element strides,
// (batch, seq, head) of q, k, v, do, then of the outputs: dq (and again dq)
// for K5, dk then dv for K6.
extern "C" int skk_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int batch,
                                int seq_len, int heads, int kv_heads, int head_dim, int causal,
                                float scale, const long long* strides, int dtype, void* stream) {
  if (skk::bad_shape(batch, seq_len, heads, kv_heads)) return skk::kErrUnsupported;
  const int group = heads / kv_heads;
  const skk::BwdStrides st = skk::unpack_strides(strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKK_DQ(T, D)                                                                              \
  return skk::launch_dq<T, D>(q, k, v, dout, l, dl, dq, batch, seq_len, heads, group, causal, \
                              scale, st, s)
  if (dtype == skk::kBF16) {
    if (head_dim == 64) SKK_DQ(__nv_bfloat16, 64);
    if (head_dim == 128) SKK_DQ(__nv_bfloat16, 128);
    if (head_dim == 256) SKK_DQ(__nv_bfloat16, 256);
  } else if (dtype == skk::kF32) {
    if (head_dim == 64) SKK_DQ(float, 64);
    if (head_dim == 128) SKK_DQ(float, 128);
    if (head_dim == 256) SKK_DQ(float, 256);
  }
#undef SKK_DQ
  return skk::kErrUnsupported;
}

extern "C" int skk_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int batch, int seq_len, int heads, int kv_heads, int head_dim,
                                 int causal, float scale, const long long* strides, int dtype,
                                 void* stream) {
  if (skk::bad_shape(batch, seq_len, heads, kv_heads)) return skk::kErrUnsupported;
  const int group = heads / kv_heads;
  const skk::BwdStrides st = skk::unpack_strides(strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKK_DKV(T, D)                                                                         \
  return skk::launch_dkv<T, D>(q, k, v, dout, l, dl, dk, dv, batch, seq_len, kv_heads, group, \
                               causal, scale, st, s)
  if (dtype == skk::kBF16) {
    if (head_dim == 64) SKK_DKV(__nv_bfloat16, 64);
    if (head_dim == 128) SKK_DKV(__nv_bfloat16, 128);
    if (head_dim == 256) SKK_DKV(__nv_bfloat16, 256);
  } else if (dtype == skk::kF32) {
    if (head_dim == 64) SKK_DKV(float, 64);
    if (head_dim == 128) SKK_DKV(float, 128);
    if (head_dim == 256) SKK_DKV(float, 256);
  }
#undef SKK_DKV
  return skk::kErrUnsupported;
}
