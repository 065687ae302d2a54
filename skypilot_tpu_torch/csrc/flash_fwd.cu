// Causal (or full) flash attention forward, (B, S, H, D) layout, GQA,
// with the row logsumexp that the backward (flash_bwd.cu) reads.
//
// Replaces skypilot_tpu/ops/attention.py::_flash_fwd (body
// _flash_fwd_kernel), the TPU kernel whose grid (B, H, q-block, k-block)
// ran the k-block axis in order with the running max, sum and accumulator
// in VMEM scratch.  On the H100 blocks run in parallel and in no order, so
// one thread block owns one (q-block, head, batch) tile and loops over the
// k-blocks itself, in ascending order; causal k-blocks past the q-block
// are never visited.
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
// once, over 3.35 TB/s).  Two routes, a fixed function of (dtype,
// head_dim) (skk_flash_fwd_route, the same split as K5 and K6):
//
// - bf16 at D 64 and 128 (every model configuration of the repo),
//   flash_fwd_mma_kernel: s = q k^T and o += p v on the tensor cores,
//   mma.sync m16n8k16 bf16 -> f32 (building blocks in mma.cuh).  4 warps
//   of 2 m16 tiles (32 query rows), a 128-row q-tile per block, over
//   64-key tiles: each k and v fragment that a warp loads from shared
//   memory by ldmatrix feeds both of its m16 tiles, which halves the k
//   and v reads per product against 16-row warps (q's fragments are
//   loaded again at every k16 step: at D 128 the o accumulators, 128
//   f32 a thread, and the scores, 64, leave no registers to keep them).
//   k and v stream through a two-stage cp.async ring (zero-filled past
//   S), so a tile's load overlaps the previous tile's products.  The
//   online softmax runs in registers: a thread holds rows g and g + 8 of
//   each m16 tile, the row max takes two __shfl_xor within the quad of
//   lanes that share a row, each thread keeps its own part of the row
//   sum (added up once at the end), and the exponentials are exp2 of
//   scores scaled by scale * log2(e).  p goes from the s accumulator,
//   rounded to bf16, straight into the A fragment of P.V (the m16n8
//   accumulator and the m16k16 A operand share their layout), with v by
//   ldmatrix.trans.  The k-tiles are walked in ascending order; only
//   tiles that cross a warp's diagonal or the end of S are masked, and a
//   masked p is exactly 0, so a row's fully masked tile adds nothing
//   whatever its running max; a warp skips the causal tiles past its
//   last row, tiles past the q-tile's last row are never loaded, and
//   heavy causal q-blocks launch first.  Shared memory: q and two stages
//   of k and v, rows padded to D + 8 (102 KB at D 128: two blocks an
//   SM).  The next step is wgmma fed by TMA with warp specialisation.
// - f32 at every D (tensor cores would need TF32, which changes f32
//   results) and bf16 at D 256, flash_fwd_kernel: f32 FMAs on the CUDA
//   cores (67 TFLOP/s at most), staged through shared memory: 64 x 64
//   tiles (32 x 32 at D = 256), each of 128 threads holding a 4 x 8 block
//   of scores and a 8 x 8 block of the output accumulator, smem rows
//   padded by 16 bytes to spread banks.
#include "mma.cuh"

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

// One k-tile of the tensor-core kernel's online softmax, on one m16
// tile's 16 x 64 scores s: this thread's rows row_g and row_g + 8
// (e / 2), columns col + 8 j and + 1 (e % 2).  s holds q k^T scaled by
// scale * log2(e) on entry, so the running max m_r is in log2 units and
// p = exp2(s - m) = exp(scale q k^T - m ln 2).  Updates m_r and this
// thread's part of the row sum l_r, rescales the o accumulator and
// leaves p in s.  MASK on a tile that crosses the diagonal or the end of
// S: a masked p is exactly 0.
template <bool MASK, int DN>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m_r)[2], float (&l_r)[2],
                                             float (&acc)[DN][4], int row_g, int col,
                                             int seq_len, int causal, float scale_log2) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col + j * 8 + (e & 1);
      const bool ok = !MASK || (c < seq_len && (!causal || c <= row_g + (e >> 1) * 8));
      s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2f(m_r[i] - mx[i]);
    m_r[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col + j * 8 + (e & 1);
      const bool ok = !MASK || (c < seq_len && (!causal || c <= row_g + (e >> 1) * 8));
      const float p = ok ? exp2f(s[j][e] - mx[e >> 1]) : 0.f;
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + sum[i];
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }
}

template <int D>
struct FwdMmaCfg : MmaTile<D> {
  // Query rows of a warp, in m16 tiles: each k and v fragment loaded
  // from shared memory feeds this many tiles' products.  2 is faster
  // than 1 at the training shapes (at 255 registers a thread at D 128,
  // 0 spill), a little slower at short prompts, where 128-row q-tiles
  // make fewer blocks.
  static constexpr int MT = 2;
  static constexpr int BQ = 64 * MT;  // the q-tile: 4 warps x MT m16 tiles
  // q, then two stages of k and v.
  static constexpr size_t SMEM = (BQ + 4 * 64) * MmaTile<D>::LD * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int seq_len, int group, int causal,
    float scale, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh) {
  using C = FwdMmaCfg<D>;
  constexpr int MT = C::MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + C::BQ * C::LD;  // stage i: k at kv_s + 2 i TILE, v after it

  // Heavy causal q-blocks (more keys) first.
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qb * C::BQ;
  const bf16* kp = k + b * k_sb + kvh * k_sh;
  const bf16* vp = v + b * v_sb + kvh * v_sh;

  const int n_kb = (seq_len + C::BK - 1) / C::BK;
  const int n_run = causal ? min(n_kb, (q0 + C::BQ - 1) / C::BK + 1) : n_kb;
  const bf16* qp = q + b * q_sb + h * q_sh;
#pragma unroll
  for (int t = 0; t < MT; ++t)
    load_tile_async<D>(q_s + t * C::TILE, qp, q_ss, q0 + 64 * t, seq_len);
  load_tile_async<D>(kv_s, kp, k_ss, 0, seq_len);
  load_tile_async<D>(kv_s + C::TILE, vp, v_ss, 0, seq_len);
  cp_async_commit();

  // ldmatrix lane offsets: an A operand (or a B operand by .trans) from a
  // row-major tile, and a B operand from an (n, k) tile.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  // This warp's first query row and m16 tile t's rows, g and g + 8 (in
  // the sequence); this thread's first column of a score tile.
  const int warp_row0 = q0 + warp * 16 * MT;
  const int row_g = warp_row0 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const uint32_t q_frag = smem_u32(q_s + (warp * 16 * MT + a_row) * C::LD + a_col);

  float m_r[MT][2], l_r[MT][2];
  float acc[MT][C::DN][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    m_r[t][0] = m_r[t][1] = kNegInf;
    l_r[t][0] = l_r[t][1] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  }
  const float scale_log2 = scale * 1.4426950408889634f;

  for (int kb = 0; kb < n_run; ++kb) {
    if (kb + 1 < n_run) {
      bf16* nxt = kv_s + ((kb + 1) & 1) * 2 * C::TILE;
      load_tile_async<D>(nxt, kp, k_ss, (kb + 1) * C::BK, seq_len);
      load_tile_async<D>(nxt + C::TILE, vp, v_ss, (kb + 1) * C::BK, seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = kv_s + (kb & 1) * 2 * C::TILE;
    const bf16* v_s = k_s + C::TILE;
    const int k0 = kb * C::BK;

    // A causal tile whose keys all lie past this warp's last row adds
    // nothing to it (the block's other warps may still need the tile).
    if (!causal || k0 <= warp_row0 + 16 * MT - 1) {
      // s = q k^T, MT x 16 rows x 64 keys a warp; q by ldmatrix.
      float s[MT][8][4];
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < C::DK; ++kc) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int t = 0; t < MT; ++t) ldsm_x4(qa[t], q_frag + (t * 16 * C::LD + kc * 16) * 2);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, smem_u32(k_s + (np * 16 + b_row) * C::LD + kc * 16 + b_col));
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            mma_bf16(s[t][2 * np], qa[t], kf[0], kf[1]);
            mma_bf16(s[t][2 * np + 1], qa[t], kf[2], kf[3]);
          }
        }
      }

      // Online softmax: masked only on a tile that crosses the diagonal
      // or the end of S, where a masked p is exactly 0.
      const bool edge = k0 + C::BK > seq_len || (causal && k0 + C::BK - 1 > warp_row0);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (edge)
          softmax_tile<true>(s[t], m_r[t], l_r[t], acc[t], row_g + 16 * t, k0 + col_t, seq_len,
                             causal, scale_log2);
        else
          softmax_tile<false>(s[t], m_r[t], l_r[t], acc[t], row_g + 16 * t, k0 + col_t,
                              seq_len, causal, scale_log2);
      }

      // o += p v: p (bf16) from registers, v by ldmatrix.trans.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int t = 0; t < MT; ++t) acc_to_a(pa[t], s[t][2 * kc], s[t][2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < C::DK; ++dn) {
          uint32_t vf[4];
          ldsm_x4_t(vf, smem_u32(v_s + (kc * 16 + a_row) * C::LD + dn * 16 + a_col));
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            mma_bf16(acc[t][2 * dn], pa[t], vf[0], vf[1]);
            mma_bf16(acc[t][2 * dn + 1], pa[t], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  bf16* op = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The row sum over the quad of lanes that hold the row.
      float l = l_r[t][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row_g + 16 * t + 8 * i;
      if (row < seq_len) {
        const float inv = 1.f / l;
        bf16* out = op + static_cast<int64_t>(row) * o_ss + col_t;
#pragma unroll
        for (int j = 0; j < C::DN; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
              __floats2bfloat162_rn(acc[t][j][2 * i] * inv, acc[t][j][2 * i + 1] * inv);
        if (lse != nullptr && (lane & 3) == 0)
          lse[(static_cast<int64_t>(b) * gridDim.y + h) * seq_len + row] =
              m_r[t][i] * 0.6931471805599453f + logf(l);
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

template <int D>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                     int batch, int seq_len, int heads, int group, int causal, float scale,
                     const long long* strides, cudaStream_t stream) {
  using C = FwdMmaCfg<D>;
  auto kernel = flash_fwd_mma_kernel<D>;
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  const dim3 grid((seq_len + C::BQ - 1) / C::BQ, heads, batch);
  kernel<<<grid, kMmaThreads, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, seq_len, group, causal, scale, strides[0], strides[1],
      strides[2], strides[3], strides[4], strides[5], strides[6], strides[7], strides[8],
      strides[9], strides[10], strides[11]);
  return launch_status();
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
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SKK_FLASH(T, D)                                                                       \
  return skk::launch_flash<T, D>(q, k, v, o, l, batch, seq_len, heads, group, causal, scale, \
                                 strides, s)
#define SKK_FLASH_MMA(D)                                                                      \
  return skk::launch_flash_mma<D>(q, k, v, o, l, batch, seq_len, heads, group, causal, scale, \
                                  strides, s)
  if (skk::tensor_core_route(dtype, head_dim)) {
    if (head_dim == 64) SKK_FLASH_MMA(64);
    SKK_FLASH_MMA(128);
  }
  if (dtype == skk::kBF16) {
    if (head_dim == 256) SKK_FLASH(__nv_bfloat16, 256);
  } else if (dtype == skk::kF32) {
    if (head_dim == 64) SKK_FLASH(float, 64);
    if (head_dim == 128) SKK_FLASH(float, 128);
    if (head_dim == 256) SKK_FLASH(float, 256);
  }
#undef SKK_FLASH
#undef SKK_FLASH_MMA
  return skk::kErrUnsupported;
}

// 1 when (dtype, head_dim) takes the tensor-core kernel, 0 when the FMA
// kernel: the wrapper counts launches by route.
extern "C" int skk_flash_fwd_route(int dtype, int head_dim) {
  return skk::tensor_core_route(dtype, head_dim) ? 1 : 0;
}
