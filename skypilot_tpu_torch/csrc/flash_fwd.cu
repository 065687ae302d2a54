// Causal (or full) flash attention forward, (B, S, H, D) layout, GQA,
// with the row logsumexp that the backward (flash_bwd.cu) reads.
//
// Replaces skypilot_tpu/ops/attention.py::_flash_fwd (body
// _flash_fwd_kernel), the TPU kernel whose grid (B, H, q-block, k-block)
// ran the k-block axis in order with the running max, sum and accumulator
// in VMEM scratch.  On the H100 blocks run in parallel and in no order, so
// one thread block owns one (q-block, head, batch) tile and loops over the
// k-blocks itself; causal k-blocks past the q-block are never visited.
//
// q: (B, S, H, D); k, v: (B, S, KV, D); o: (B, S, H, D); lse, when not
// null: (B, H, S) f32, m + log(l) of each row (the TPU kernel broadcast it
// over 128 lanes for its tiling; one float a row is enough here), written
// only when the caller needs a gradient.  The KV head of query head h is
// h / (H / KV).  Tensors are read through their strides
// (the last dim must be contiguous), so the (B, S, H, D) layout needs no
// transpose copy.  S need not be a multiple of the tile: rows and keys
// past S are zero-filled on load and masked.
//
// Numerics follow the TPU kernel: scores and the online softmax in f32,
// the row sum taken over f32 probabilities, the probabilities cast to the
// value dtype before P.V, and P.V accumulated in f32.
//
// Bound on the H100: at prompt lengths of a few hundred tokens and up the
// work is operations (4 * D flops per visible (query, key) pair, against
// 989 TFLOP/s in bf16); below that, bytes (q, k, v read once, o written
// once, over 3.35 TB/s).  This first version does its products with f32
// FMAs on the CUDA cores (67 TFLOP/s at most), staged through shared
// memory: 64 x 64 tiles (32 x 32 at D = 256), each of 128 threads holding
// a 4 x 8 block of scores and a 8 x 8 block of the output accumulator,
// smem rows padded by 16 bytes to spread banks.  Tensor-core products
// (mma.sync, then wgmma fed by TMA) are the next step.
#include "common.cuh"

namespace skk {
namespace {

constexpr int kFlashThreads = 128;

template <typename T, int D>
struct FlashCfg {
  static constexpr int BQ = D <= 128 ? 64 : 32;
  static constexpr int BK = BQ;
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int LD = D + PAD;   // smem row stride of q, k, v tiles
  static constexpr int LDP = BK + PAD; // smem row stride of the P tile
  // Score tile: a 16 x 8 grid of threads, rows ty + 16 i, cols tx + 8 j.
  static constexpr int SR = BQ / 16;
  static constexpr int SC = BK / 8;
  // Output tile: an 8 x 16 grid of threads, rows oy + 8 i, cols ox + 16 j.
  static constexpr int OR = BQ / 8;
  static constexpr int OC = D / 16;
  static constexpr size_t SMEM =
      static_cast<size_t>(BQ * LD + 2 * BK * LD + BQ * LDP) * sizeof(T) +
      2 * BQ * sizeof(float);
};

// Copies `rows` rows of D elements starting at sequence row `row0` of a
// strided (S, D) view into a smem tile of stride LD, zero-filling rows
// at or past S.
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride,
                                          int row0, int seq_len) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kFlashThreads) {
    const int r = i / VPR;
    const int c = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq_len)
      val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * row_stride +
                                            c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int seq_len, int group,
    int causal, float scale,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh) {
  using C = FlashCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + C::BQ * C::LD;
  T* v_s = k_s + C::BK * C::LD;
  T* p_s = v_s + C::BK * C::LD;
  float* corr_s = reinterpret_cast<float*>(p_s + C::BQ * C::LDP);
  float* l_s = corr_s + C::BQ;

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;    // score tile coordinates
  const int oy = tid >> 4, ox = tid & 15;   // output tile coordinates
  const int q0 = qb * C::BQ;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + kvh * k_sh;
  const T* vp = v + b * v_sb + kvh * v_sh;
  load_tile<T, D, C::LD, C::BQ>(q_s, qp, q_ss, q0, seq_len);

  float m[C::SR], l[C::SR];
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[C::OR][C::OC];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int j = 0; j < C::OC; ++j) acc[i][j] = 0.f;

  const int n_kb = (seq_len + C::BK - 1) / C::BK;
  const int last_kb = causal ? min(n_kb - 1, (q0 + C::BQ - 1) / C::BK) : n_kb - 1;

  for (int kb = 0; kb <= last_kb; ++kb) {
    const int k0 = kb * C::BK;
    load_tile<T, D, C::LD, C::BK>(k_s, kp, k_ss, k0, seq_len);
    load_tile<T, D, C::LD, C::BK>(v_s, vp, v_ss, k0, seq_len);
    __syncthreads();

    float s[C::SR][C::SC];
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int j = 0; j < C::SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::SR], kv[C::SC];
#pragma unroll
      for (int i = 0; i < C::SR; ++i) qv[i] = to_f32(q_s[(ty + 16 * i) * C::LD + d]);
#pragma unroll
      for (int j = 0; j < C::SC; ++j) kv[j] = to_f32(k_s[(tx + 8 * j) * C::LD + d]);
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
#pragma unroll
        for (int j = 0; j < C::SC; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int row = ty + 16 * i;
      const int qi = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::SC; ++j) {
        const int kj = k0 + tx + 8 * j;
        const bool ok = kj < seq_len && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 8 threads of a row are 8 consecutive lanes.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::SC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[row * C::LDP + tx + 8 * j] = from_f32<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
      if (tx == 0) corr_s[row] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < C::OR; ++i) {
      const float corr = corr_s[oy + 8 * i];
#pragma unroll
      for (int j = 0; j < C::OC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < C::BK; ++kk) {
      float pv[C::OR], vv[C::OC];
#pragma unroll
      for (int i = 0; i < C::OR; ++i) pv[i] = to_f32(p_s[(oy + 8 * i) * C::LDP + kk]);
#pragma unroll
      for (int j = 0; j < C::OC; ++j) vv[j] = to_f32(v_s[kk * C::LD + ox + 16 * j]);
#pragma unroll
      for (int i = 0; i < C::OR; ++i)
#pragma unroll
        for (int j = 0; j < C::OC; ++j) acc[i][j] += pv[i] * vv[j];
    }
    __syncthreads();
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const int row = ty + 16 * i;
      l_s[row] = l[i];
      if (lse != nullptr && q0 + row < seq_len)
        lse[(static_cast<int64_t>(b) * gridDim.y + h) * seq_len + q0 + row] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();
  T* op = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int row = oy + 8 * i;
    if (q0 + row < seq_len) {
      const float inv = 1.f / l_s[row];
      T* orow = op + static_cast<int64_t>(q0 + row) * o_ss;
#pragma unroll
      for (int j = 0; j < C::OC; ++j) orow[ox + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int seq_len, int heads, int group, int causal,
                 float scale, const long long* strides, cudaStream_t stream) {
  using C = FlashCfg<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  const dim3 grid((seq_len + C::BQ - 1) / C::BQ, heads, batch);
  kernel<<<grid, kFlashThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq_len, group, causal,
      scale, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], strides[6], strides[7], strides[8], strides[9], strides[10],
      strides[11]);
  return launch_status();
}

template <typename T>
int dispatch_flash(int head_dim, const void* q, const void* k, const void* v,
                   void* o, float* lse, int batch, int seq_len, int heads, int group,
                   int causal, float scale, const long long* strides,
                   cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_flash<T, 64>(q, k, v, o, lse, batch, seq_len, heads, group,
                                 causal, scale, strides, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, lse, batch, seq_len, heads, group,
                                  causal, scale, strides, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, lse, batch, seq_len, heads, group,
                                  causal, scale, strides, stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace
}  // namespace skk

// strides: 12 element strides, (batch, seq, head) for q, k, v and o in
// that order; each tensor's last dim is contiguous.  lse: (B, H, S) f32
// contiguous, or null when no gradient is wanted.
extern "C" int skk_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int seq_len, int heads,
                             int kv_heads, int head_dim, int causal,
                             float scale, const long long* strides,
                             int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || seq_len < 1 || heads < 1 ||
      heads > 65535 || kv_heads < 1 || heads % kv_heads != 0)
    return skk::kErrUnsupported;
  const int group = heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case skk::kBF16:
      return skk::dispatch_flash<__nv_bfloat16>(head_dim, q, k, v, o,
                                                static_cast<float*>(lse), batch,
                                                seq_len, heads, group, causal,
                                                scale, strides, s);
    case skk::kF32:
      return skk::dispatch_flash<float>(head_dim, q, k, v, o,
                                        static_cast<float*>(lse), batch, seq_len,
                                        heads, group, causal, scale, strides,
                                        s);
    default:
      return skk::kErrUnsupported;
  }
}
