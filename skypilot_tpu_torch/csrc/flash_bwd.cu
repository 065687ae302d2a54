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
// No atomics: each output tile is written by one block, so two launches
// on the same inputs give bitwise-equal dq, dk and dv.  That is why s and
// dp are computed in both kernels (FA2's single kernel adds dq atomically).
//
// Numerics follow the TPU kernels: s, p, dp and every accumulator in f32;
// p and ds rounded to the input dtype before the dv, dq and dk products;
// the causal mask q_row >= k_col; rows and keys past S (zero-filled on
// load) are masked like the causal ones, so they add exactly 0.
//
// Bound on the H100: operations at training lengths (6 D flops a visible
// (query, key) pair for K5, 8 D for K6, against 989 TFLOP/s in bf16).
// Two routes, a fixed function of (dtype, head_dim) (flash_bwd_route):
//
// - bf16 at D 64 and 128 (every training configuration of the repo): the
//   products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32 with
//   operands loaded from shared memory by ldmatrix (.trans where the
//   contraction runs over the sequence: k in K5's ds k, q and do in K6's
//   ds^T q and p^T do).  4 warps of 16 rows a block, 64 x 64 tiles.  The
//   scores stay in registers: p and ds go from the f32 accumulators,
//   rounded to bf16, straight into the next product's A fragments (the
//   m16n8 accumulator and the m16k16 A operand share their layout), so
//   they never pass through shared memory.  The streamed operand (k and
//   v in K5, q, do, lse and delta in K6) comes through a two-stage
//   cp.async ring, zero-filled past S, so a tile's load overlaps the
//   previous tile's products.  K5 launches its heavy causal q-blocks
//   first; only tiles that cross the diagonal or the end of S are masked,
//   and tiles above the diagonal are never loaded.  K6 keeps its k and v
//   tiles resident and its dk and dv accumulators (2 x 16 x D / 32 f32 a
//   thread) in registers, and takes the scores of a 64-row q-tile in
//   passes of QN columns so that the pass's s^T and dp^T fit beside them.
//   Shared-memory rows are padded by 16 bytes, so the eight rows of an
//   ldmatrix 8 x 8 fall in distinct banks.  The building blocks (cp.async,
//   ldmatrix, mma.sync, fragment conversions) are mma.cuh's, shared with
//   K2.  The next step is wgmma fed by TMA with warp specialisation.
// - f32 at every D (tensor cores would need TF32, which changes f32
//   results), and bf16 at D 256 (its dk and dv accumulators alone would
//   take 256 registers a thread at 16 rows a warp): scalar f32 FMAs on
//   the CUDA cores, staged through shared memory like K2's FMA kernel,
//   128 threads a block.  K6 holds two (BK x D) accumulators, so its key tile shrinks
//   with D (BK = 4096 / D: 64, 32, 16 keys) to keep them at 64 registers
//   a thread.
#include "mma.cuh"

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

// ---- tensor-core route: bf16 at D 64 and 128 -------------------------------
// (building blocks in mma.cuh)

template <int D>
struct MmaCfg : MmaTile<D> {
  using Tile = MmaTile<D>;
  // K6's query columns per score pass: its 2 x DN x 4 accumulator
  // registers plus QN of scores stay under the 255-register cap at D 128
  // (248 registers; 64 columns spilled there and ran slower).
  static constexpr int QN = D >= 128 ? 32 : 64;
  // K5: q, do, and two stages of k and v.  K6: k, v, and two stages of q,
  // do, lse and delta.
  static constexpr size_t SMEM_DQ = 6 * Tile::TILE * sizeof(bf16);
  static constexpr size_t SMEM_DKV =
      6 * Tile::TILE * sizeof(bf16) + 2 * 2 * Tile::BQ * sizeof(float);
};

// lse or delta of 64 query rows from `row0` (0 past S).
__device__ __forceinline__ void load_stats_async(float* dst, const float* src, int row0,
                                                 int seq_len) {
  const int r = threadIdx.x;
  if (r < 64) {
    const bool in = row0 + r < seq_len;
    cp_async4(smem_u32(dst + r), in ? src + row0 + r : src, in ? 4 : 0);
  }
}

// K5's p = exp(scale s - lse) and ds = p (dp - delta) over a warp's
// 16 x 64 tile, in s: this thread's rows row_g and row_g + 8, columns
// col_t + 8 j and + 1.  MASK on a tile that crosses the diagonal or the
// end of S (elsewhere every pair is visible).
template <bool MASK>
__device__ __forceinline__ void dq_probs(float (&s)[8][4], const float (&dp)[8][4],
                                         const float (&lse_r)[2], const float (&delta_r)[2],
                                         int row_g, int col_t, int seq_len, int causal,
                                         float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_g + (e >> 1) * 8;
      const int col = col_t + j * 8 + (e & 1);
      const bool ok = !MASK || (row < seq_len && col < seq_len && (!causal || col <= row));
      const float p = ok ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
      s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
    }
}

// K6's p^T = exp(scale s^T - lse[col]) in s and ds^T = p^T (dp^T -
// delta[col]) in dp over a warp's 16 x 8N tile: the row statistics are
// per column here, lse_t[8 j] and lse_t[8 j + 1] for columns col_t + 8 j
// and + 1 (likewise delta_t).
template <bool MASK, int N>
__device__ __forceinline__ void dkv_probs(float (&s)[N][4], float (&dp)[N][4],
                                          const float* lse_t, const float* delta_t, int row_g,
                                          int col_t, int seq_len, int causal, float scale) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + j * 8);
    const float2 d2 = *reinterpret_cast<const float2*>(delta_t + j * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_g + (e >> 1) * 8;
      const int col = col_t + j * 8 + (e & 1);
      const bool ok = !MASK || (row < seq_len && col < seq_len && (!causal || row <= col));
      const float p = ok ? expf(s[j][e] * scale - ((e & 1) ? l2.y : l2.x)) : 0.f;
      dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      s[j][e] = p;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int seq_len, int group, int causal, float scale, BwdStrides st) {
  using C = MmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + C::TILE;
  bf16* kv_s = g_s + C::TILE;  // stage i: k at kv_s + 2 i TILE, v after it

  // Heavy causal q-blocks (more keys) first.
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qb * C::BQ;
  const int64_t stat0 = (static_cast<int64_t>(b) * gridDim.y + h) * seq_len;
  const bf16* kp = k + b * st.k[0] + kvh * st.k[2];
  const bf16* vp = v + b * st.v[0] + kvh * st.v[2];

  const int n_kb = (seq_len + C::BK - 1) / C::BK;
  const int n_run = causal ? min(n_kb, (q0 + C::BQ - 1) / C::BK + 1) : n_kb;
  load_tile_async<D>(q_s, q + b * st.q[0] + h * st.q[2], st.q[1], q0, seq_len);
  load_tile_async<D>(g_s, g + b * st.g[0] + h * st.g[2], st.g[1], q0, seq_len);
  load_tile_async<D>(kv_s, kp, st.k[1], 0, seq_len);
  load_tile_async<D>(kv_s + C::TILE, vp, st.v[1], 0, seq_len);
  cp_async_commit();

  // This thread's query rows: g and g + 8 of its warp's 16.
  const int row_g = q0 + warp * 16 + (lane >> 2);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_g + 8 * i;
    lse_r[i] = row < seq_len ? lse[stat0 + row] : 0.f;
    delta_r[i] = row < seq_len ? delta[stat0 + row] : 0.f;
  }

  // ldmatrix lane offsets: an A operand (or a B operand by .trans) from a
  // row-major tile, and a B operand from an (n, k) tile.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const uint32_t q_frag = smem_u32(q_s + (warp * 16 + a_row) * C::LD + a_col);
  const uint32_t g_frag = smem_u32(g_s + (warp * 16 + a_row) * C::LD + a_col);

  float acc[C::DN][4];
#pragma unroll
  for (int j = 0; j < C::DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kb = 0; kb < n_run; ++kb) {
    if (kb + 1 < n_run) {
      bf16* nxt = kv_s + ((kb + 1) & 1) * 2 * C::TILE;
      load_tile_async<D>(nxt, kp, st.k[1], (kb + 1) * C::BK, seq_len);
      load_tile_async<D>(nxt + C::TILE, vp, st.v[1], (kb + 1) * C::BK, seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = kv_s + (kb & 1) * 2 * C::TILE;
    const bf16* v_s = k_s + C::TILE;
    const int k0 = kb * C::BK;

    // s = q k^T and dp = do v^T, 16 rows x 64 keys a warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kc = 0; kc < C::DK; ++kc) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, q_frag + kc * 32);
      ldsm_x4(ga, g_frag + kc * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, smem_u32(k_s + (np * 16 + b_row) * C::LD + kc * 16 + b_col));
        ldsm_x4(vf, smem_u32(v_s + (np * 16 + b_row) * C::LD + kc * 16 + b_col));
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], ga, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], ga, vf[2], vf[3]);
      }
    }

    // p and ds in s; masked only on a tile that crosses the diagonal or
    // the end of S.
    if (k0 + C::BK > seq_len || q0 + C::BQ > seq_len || (causal && k0 + C::BK - 1 > q0))
      dq_probs<true>(s, dp, lse_r, delta_r, row_g, k0 + 2 * (lane & 3), seq_len, causal, scale);
    else
      dq_probs<false>(s, dp, lse_r, delta_r, row_g, k0 + 2 * (lane & 3), seq_len, causal, scale);

    // dq += ds k: ds (bf16) from registers, k by ldmatrix.trans.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t dsa[4];
      acc_to_a(dsa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < C::DK; ++dn) {
        uint32_t kf[4];
        ldsm_x4_t(kf, smem_u32(k_s + (kc * 16 + a_row) * C::LD + dn * 16 + a_col));
        mma_bf16(acc[2 * dn], dsa, kf[0], kf[1]);
        mma_bf16(acc[2 * dn + 1], dsa, kf[2], kf[3]);
      }
    }
    __syncthreads();
  }

  bf16* dqp = dq + b * st.a[0] + h * st.a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_g + 8 * i;
    if (row < seq_len) {
      bf16* out = dqp + static_cast<int64_t>(row) * st.a[1] + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < C::DN; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_len, int group, int causal,
    float scale, BwdStrides st) {
  using C = MmaCfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + C::TILE;
  bf16* qg_s = v_s + C::TILE;  // stage i: q at qg_s + 2 i TILE, do after it
  float* stat_s = reinterpret_cast<float*>(qg_s + 4 * C::TILE);  // stage i: lse, delta

  const int kb = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y * group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = kb * C::BK;

  // Iteration `it` takes query head kvh * group + it / nq and q-block
  // first_qb + it % nq: causal, the q-blocks from the diagonal on.
  const int n_qb = (seq_len + C::BQ - 1) / C::BQ;
  const int first_qb = causal ? k0 / C::BQ : 0;
  const int nq = n_qb - first_qb;
  const int n_it = group * nq;
  auto issue = [&](int it, int stage) {
    const int h = kvh * group + it / nq;
    const int q0 = (first_qb + it % nq) * C::BQ;
    bf16* dst = qg_s + stage * 2 * C::TILE;
    load_tile_async<D>(dst, q + b * st.q[0] + h * st.q[2], st.q[1], q0, seq_len);
    load_tile_async<D>(dst + C::TILE, g + b * st.g[0] + h * st.g[2], st.g[1], q0, seq_len);
    const int64_t stat0 = (static_cast<int64_t>(b) * heads + h) * seq_len;
    load_stats_async(stat_s + stage * 2 * C::BQ, lse + stat0, q0, seq_len);
    load_stats_async(stat_s + stage * 2 * C::BQ + C::BQ, delta + stat0, q0, seq_len);
  };
  load_tile_async<D>(k_s, k + b * st.k[0] + kvh * st.k[2], st.k[1], k0, seq_len);
  load_tile_async<D>(v_s, v + b * st.v[0] + kvh * st.v[2], st.v[1], k0, seq_len);
  issue(0, 0);
  cp_async_commit();

  // This thread's key rows: g and g + 8 of its warp's 16.
  const int row_g = k0 + warp * 16 + (lane >> 2);
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const uint32_t k_frag = smem_u32(k_s + (warp * 16 + a_row) * C::LD + a_col);
  const uint32_t v_frag = smem_u32(v_s + (warp * 16 + a_row) * C::LD + a_col);

  float acc_dk[C::DN][4], acc_dv[C::DN][4];
#pragma unroll
  for (int j = 0; j < C::DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_dk[j][e] = 0.f;
      acc_dv[j][e] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* q_s = qg_s + (it & 1) * 2 * C::TILE;
    const bf16* g_s = q_s + C::TILE;
    const float* lse_s = stat_s + (it & 1) * 2 * C::BQ;
    const float* delta_s = lse_s + C::BQ;
    const int q0 = (first_qb + it % nq) * C::BQ;
    const bool edge = q0 + C::BQ > seq_len || k0 + C::BK > seq_len ||
                      (causal && q0 < k0 + C::BK - 1);
    const int col_t = q0 + 2 * (lane & 3);  // this thread's first column

#pragma unroll
    for (int qh = 0; qh < C::BQ; qh += C::QN) {
      // s^T = k q^T and dp^T = v do^T, 16 keys x QN query rows a warp.
      float s[C::QN / 8][4], dp[C::QN / 8][4];
#pragma unroll
      for (int j = 0; j < C::QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kc = 0; kc < C::DK; ++kc) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, k_frag + kc * 32);
        ldsm_x4(va, v_frag + kc * 32);
#pragma unroll
        for (int np = 0; np < C::QN / 16; ++np) {
          uint32_t qf[4], gf[4];
          ldsm_x4(qf, smem_u32(q_s + (qh + np * 16 + b_row) * C::LD + kc * 16 + b_col));
          ldsm_x4(gf, smem_u32(g_s + (qh + np * 16 + b_row) * C::LD + kc * 16 + b_col));
          mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[2 * np], va, gf[0], gf[1]);
          mma_bf16(dp[2 * np + 1], va, gf[2], gf[3]);
        }
      }

      // p^T in s and ds^T in dp, masked only on an edge tile.
      const float* lse_t = lse_s + qh + 2 * (lane & 3);
      const float* delta_t = delta_s + qh + 2 * (lane & 3);
      if (edge)
        dkv_probs<true, C::QN / 8>(s, dp, lse_t, delta_t, row_g, col_t + qh, seq_len, causal,
                                   scale);
      else
        dkv_probs<false, C::QN / 8>(s, dp, lse_t, delta_t, row_g, col_t + qh, seq_len, causal,
                                    scale);

      // dv += p^T do and dk += ds^T q: p^T, ds^T (bf16) from registers, do
      // and q by ldmatrix.trans.
#pragma unroll
      for (int kc = 0; kc < C::QN / 16; ++kc) {
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
        acc_to_a(dsa, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < C::DK; ++dn) {
          uint32_t gf[4], qf[4];
          ldsm_x4_t(gf, smem_u32(g_s + (qh + kc * 16 + a_row) * C::LD + dn * 16 + a_col));
          ldsm_x4_t(qf, smem_u32(q_s + (qh + kc * 16 + a_row) * C::LD + dn * 16 + a_col));
          mma_bf16(acc_dv[2 * dn], pa, gf[0], gf[1]);
          mma_bf16(acc_dv[2 * dn + 1], pa, gf[2], gf[3]);
          mma_bf16(acc_dk[2 * dn], dsa, qf[0], qf[1]);
          mma_bf16(acc_dk[2 * dn + 1], dsa, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();
  }

  bf16* dkp = dk + b * st.a[0] + kvh * st.a[2];
  bf16* dvp = dv + b * st.b[0] + kvh * st.b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_g + 8 * i;
    if (row < seq_len) {
      bf16* dk_row = dkp + static_cast<int64_t>(row) * st.a[1] + 2 * (lane & 3);
      bf16* dv_row = dvp + static_cast<int64_t>(row) * st.b[1] + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < C::DN; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + j * 8) =
            __floats2bfloat162_rn(acc_dk[j][2 * i] * scale, acc_dk[j][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + j * 8) =
            __floats2bfloat162_rn(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
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

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* delta, void* dq, int batch, int seq_len, int heads, int group,
                  int causal, float scale, const BwdStrides& st, cudaStream_t stream) {
  using C = MmaCfg<D>;
  auto kernel = flash_bwd_dq_mma_kernel<D>;
  static bool smem_allowed = false;
  if (const int e = allow_smem(kernel, C::SMEM_DQ, &smem_allowed)) return e;
  const dim3 grid((seq_len + C::BQ - 1) / C::BQ, heads, batch);
  kernel<<<grid, kBwdThreads, C::SMEM_DQ, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dq), seq_len, group, causal,
      scale, st);
  return launch_status();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* g, const float* lse,
                   const float* delta, void* dk, void* dv, int batch, int seq_len, int kv_heads,
                   int group, int causal, float scale, const BwdStrides& st,
                   cudaStream_t stream) {
  using C = MmaCfg<D>;
  auto kernel = flash_bwd_dkv_mma_kernel<D>;
  static bool smem_allowed = false;
  if (const int e = allow_smem(kernel, C::SMEM_DKV, &smem_allowed)) return e;
  const dim3 grid((seq_len + C::BK - 1) / C::BK, kv_heads, batch);
  kernel<<<grid, kBwdThreads, C::SMEM_DKV, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      seq_len, group, causal, scale, st);
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
#define SKK_DQ_MMA(D)                                                                           \
  return skk::launch_dq_mma<D>(q, k, v, dout, l, dl, dq, batch, seq_len, heads, group, causal, \
                               scale, st, s)
  if (skk::tensor_core_route(dtype, head_dim)) {
    if (head_dim == 64) SKK_DQ_MMA(64);
    SKK_DQ_MMA(128);
  }
  if (dtype == skk::kBF16) {
    if (head_dim == 256) SKK_DQ(__nv_bfloat16, 256);
  } else if (dtype == skk::kF32) {
    if (head_dim == 64) SKK_DQ(float, 64);
    if (head_dim == 128) SKK_DQ(float, 128);
    if (head_dim == 256) SKK_DQ(float, 256);
  }
#undef SKK_DQ
#undef SKK_DQ_MMA
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
#define SKK_DKV_MMA(D)                                                                         \
  return skk::launch_dkv_mma<D>(q, k, v, dout, l, dl, dk, dv, batch, seq_len, kv_heads, group, \
                                causal, scale, st, s)
  if (skk::tensor_core_route(dtype, head_dim)) {
    if (head_dim == 64) SKK_DKV_MMA(64);
    SKK_DKV_MMA(128);
  }
  if (dtype == skk::kBF16) {
    if (head_dim == 256) SKK_DKV(__nv_bfloat16, 256);
  } else if (dtype == skk::kF32) {
    if (head_dim == 64) SKK_DKV(float, 64);
    if (head_dim == 128) SKK_DKV(float, 128);
    if (head_dim == 256) SKK_DKV(float, 256);
  }
#undef SKK_DKV
#undef SKK_DKV_MMA
  return skk::kErrUnsupported;
}

// 1 when (dtype, head_dim) takes the tensor-core kernels, 0 when the FMA
// kernels: the wrappers count launches by route.
extern "C" int skk_flash_bwd_route(int dtype, int head_dim) {
  return skk::tensor_core_route(dtype, head_dim) ? 1 : 0;
}
