// Paged window attention over the pooled KV arena: W queries per slot,
// window row w seeing keys <= positions[b] + w.  It serves the
// speculative verify step (W = spec_k + 1 per slot) and the prefill lane
// of the fused prefill+decode step (one slot, W = fuse_budget).
//
// Replaces skypilot_tpu/ops/decode_attention.py::
// decode_window_attention_pooled (body _pooled_attn_kernel ->
// _decode_attn_kernel with window=W).  The TPU kernel gave one grid row
// to each slot and stacked all KV * W * G query rows of the slot into one
// VMEM tile; its (B, T) grid walked the logical blocks in order, carrying
// the running max, sum and accumulator from step to step.  Blocks of the
// H100 run in parallel and in no order, so here a block owns a tile of
// rows and one share of the keys, and a second pass sums the shares.
//
// q, out: (B, W, KV, G, HD), the caller's layout; inside a KV head the
//         rows are r = w * G + g (the TPU kernel's row order), and row r
//         of KV head kv sits at (((b W + w) KV + kv) G + g) HD.
// arena:  (L, NB, BS, KV, HD) for K and for V, contiguous; bf16/f32 in
//         q's dtype, or int8 with k_scale/v_scale (L, NB, BS, KV) f32.
// tables: (B, T) int32; tables[b, j] holds slot b's logical rows
//         [j * BS, (j + 1) * BS).
// positions: (B,) int32, the cache row of window row 0.
//
// Row r of slot b sees keys 0 .. min(positions[b] + r / G, T BS - 1).
// No key past a tile's deepest row is read, and no table entry past the
// keys it needs.
//
// Bound on the H100.  The verify shape (B 8, W 13, G 4, hd 128, ~700 keys
// a slot) does 4 HD flops per (row, visible key) on 52 rows a KV head,
// 52 flops a byte of K/V read: below the tensor cores' ~295, so it is
// bound by bytes, each live K/V row read once (0.0074 ms for 5,599 keys
// at 3.35 TB/s), if every key row is read once per (slot, KV head).  The
// fused lane (B 1, W 264, G 4: 1,056 rows a KV head over ~700 keys) is
// bound by operations (2.4 GFLOP a layer, 0.0025 ms at 989 TFLOP/s bf16).
// Gemma-7B's verify (KV 16, G 1, hd 256: 13 rows a KV head) does the
// same 0.30 GFLOP over 4x the bytes (16 KB a key, 0.027 ms); its fused
// lane (264 rows a KV head) 2.46 GFLOP over 11.5 MB, bound by bytes at
// 0.0034 ms.  Three routes, a fixed function of (q dtype, head_dim)
// (paged_window_tc_route, reported by skk_paged_window_route, as K2 and
// K5/K6 report theirs):
//
// - bf16 q at HD 64 and 128, over a bf16 or an int8 arena,
//   paged_window_mma_kernel: S = Q K^T and O += P V by mma.sync m16n8k16
//   bf16 -> f32 (mma.cuh).  A block of 4 warps takes 64 rows of one
//   (slot, KV head), a warp one m16 tile, so the verify window's 52 rows
//   fit one tile and each K/V row of a split is read once per (slot, KV
//   head); the fused lane has 17 tiles.  Split-KV: the grid is (row
//   tiles x splits, KV, B), block s of a tile takes keys [s L, (s + 1)
//   L) up to the tile's deepest visible key (L from the host's
//   _window_splits, a fixed function of the launch's sizes and the SM
//   count, never of positions, so the launch can be captured in a CUDA
//   graph), and a split that starts past them returns at once.  Keys
//   stream in tiles of 64 through a two-stage cp.async ring; each key
//   row is found through the table (16-byte copies, rows of KV HD
//   elements apart in the arena), and keys past the split's last
//   visible one are zero-filled, never read.  q's tile is staged once
//   and read by ldmatrix; K by ldmatrix, V by ldmatrix.trans.  The
//   online softmax runs in registers (K2's: a thread holds rows g and
//   g + 8 of its warp's tile, the row max takes two __shfl_xor in the
//   quad, exp2 of log2-scaled scores), p goes from the score
//   accumulator, rounded to bf16, into P V's A fragment, and only key
//   tiles that hold some row's last visible key are masked (a masked p
//   is exactly 0); a warp skips a key tile that none of its rows sees.
//   An int8 tile is staged as it is and converted to bf16 in shared
//   memory (integers in [-128, 127] are exact in bf16); the K scale
//   multiplies each f32 score column after the product, the V scale
//   each probability before its rounding (the plain version's order),
//   so no dequantized copy of the arena is made.  With one split the
//   block writes its rows; with more, it writes f32 (m, l, acc) per row
//   to scratch (B, KV, splits, W G, .), and paged_window_combine_kernel
//   sums, row by row, the splits that hold the row's keys, counted from
//   positions, in ascending order: no atomics, so two launches are
//   bitwise equal.
// - bf16 q at HD 256 (Gemma), over a bf16 or an int8 arena,
//   paged_window_row16_mma_kernel: the same products, softmax, masks,
//   scales, split-KV and combine, laid out for what HD 256 costs.
//   * Registers: one m16 tile's output accumulator is 16 x 256 f32, 128
//     registers a thread, as in K2<256> (246) and K5<256> (249), so a
//     warp holds one m16 tile and a 16-key score tile (8 registers), and
//     q's fragments are loaded again at each of the 16 k16 steps.
//   * Idle warps: Gemma-7B is MHA, so a (slot, KV head) has only W G =
//     13 verify rows (5 at spec_k 4), one m16 tile; the 64-row block
//     above would idle three of its four warps.  Here a block takes one
//     16-row tile of one (slot, KV head) and its 4 warps divide the
//     split's keys: warp w takes the 16-key chunks w, w + 4, w + 8, ...,
//     each through its own cp.async ring, with its own running (m, l,
//     acc); at the end the warps put them in shared memory and the
//     block's threads merge the four, in warp order, into the row's
//     output (one split) or its partial (more).  Each live K/V row of a
//     split is read once per (slot, KV head, row tile): once at Gemma-7B's
//     verify, 17 times at its fused lane (264 rows: 17 tiles, mostly L2
//     hits, 11.5 MB of K/V against the 50 MB L2) and 7 times at
//     Gemma-2B's MQA verify (8 query heads on 1 KV head: 104 rows, r = w
//     G + g).  The warps share no barrier inside the key loop.
//   * Shared memory: q's tile (16 rows of 264 bf16, 8.4 KB), then a ring
//     of three 16-key stages a warp (bf16: K and V padded, 16.9 KB a
//     stage; int8: 8.3 KB a stage plus the warp's bf16 conversion
//     buffer, 16.9 KB), 211 KB in bf16 and 176 KB in int8: one block an
//     SM, 4 warps, each with two chunks (32 KB) in flight while it
//     computes a third.  Verify is bound by bytes, so what the SM needs
//     is bytes in flight, not warps.  The merge reuses the rings.
// - f32 q at every HD, paged_window_kernel: f32 FMAs on the CUDA cores
//   (tensor cores would need TF32, which changes f32 results), one
//   128-thread block per (slot, KV head, tile of 16 rows), each chunk of
//   keys staged once in shared memory for the tile's rows; an int8 arena
//   dequantized element by element with its (row, KV head) scale before
//   each product.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, graph_ms) the
// verify shape takes 0.029 ms (int8 0.032) against its 0.0074 ms byte
// bound and SDPA's 0.107, and the fused lane 0.045 ms (int8 0.051)
// against 0.0025 and SDPA's 0.067.  Verify is the longest split's four
// key tiles plus the combine launch (0.011 ms alone); at rows 436..699
// the fused lane's 272 live blocks overflow one wave of two blocks an
// SM.  At HD 256 (same card and limit; Gemma-7B, G 1) verify takes
// 0.068 ms (int8 0.084) against its 0.028 ms byte bound, SDPA's 0.193
// and the FMA route's 0.721, and the fused lane 0.102 ms (int8 0.135)
// against 0.0047, SDPA's 0.132 and the FMA route's 0.331: its 17 row
// tiles each read the K/V rows.  The next step is wgmma fed by TMA
// (ROADMAP B5), and for the HD-256 fused lane a tile of more rows.
#include "mma.cuh"

namespace skk {
namespace {

// Row r of KV head kvh of slot b in the (B, W, KV, G, HD) q and out, in
// units of HD elements.
__device__ __forceinline__ int64_t window_row(int b, int kvh, int r, int win, int kv_heads,
                                              int group) {
  const int w = r / group;
  return ((static_cast<int64_t>(b) * win + w) * kv_heads + kvh) * group + (r - w * group);
}

// ---- the FMA route ----------------------------------------------------------

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

// q and out f32; T: arena elements (f32, or int8 with per-(row, KV
// head) f32 scales).  Four blocks an SM: the minimum keeps ptxas from
// spilling (as in K1's decode_kernel).
template <typename T, int HD>
__global__ void __launch_bounds__(kWinThreads, 4) paged_window_kernel(
    const float* __restrict__ q, const T* __restrict__ k_arena,
    const T* __restrict__ v_arena, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ out, int win,
    int kv_heads, int group, int n_blocks, int block_size, int t_width,
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
  __shared__ int64_t row_s[R];  // the tile's rows in q and out (window_row)

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int rows = win * group;
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

  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    row_s[tid] = window_row(b, kvh, r0 + min(tid, nr - 1), win, kv_heads, group);
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += kWinThreads) {
    const int r = i / HD;
    q_s[i] = r < nr ? q[row_s[r] * HD + i - r * HD] : 0.f;
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

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      float* ob = out + row_s[r] * HD;
      const float inv = 1.f / l_s[r];
#pragma unroll
      for (int jj = 0; jj < C::DPT; ++jj) {
        const int d = tid + jj * kWinThreads;
        if (d < HD) ob[d] = acc[r][jj] * inv;
      }
    }
  }
}

// ---- the tensor-core route --------------------------------------------------

// Keys a tensor-core block stages at a time (_WINDOW_CHUNK in
// ops/decode_attention.py: a split's length is a multiple of it), and
// query rows of its tile (_WINDOW_ROWS): 4 warps of one m16 tile.
constexpr int kWinKeys = 64;
constexpr int kWinTcRows = 64;

// Shared memory of one instantiation: q's 64-row bf16 tile, then a ring
// of two stages, each the K and V rows of 64 keys as they arrive (bf16:
// padded tiles that ldmatrix reads; int8: rows of HD bytes) and, for
// int8, their 64 + 64 f32 scales; for int8, then the K and V tiles
// converted to bf16.
template <typename T, int HD>
struct WindowMmaCfg : MmaTile<HD> {
  static constexpr bool QUANT = std::is_same<T, int8_t>::value;
  static constexpr int TILE_BYTES = MmaTile<HD>::TILE * 2;
  static constexpr int KV_BYTES = QUANT ? kWinKeys * HD : TILE_BYTES;
  static constexpr int SC_OFF = 2 * KV_BYTES;  // the scales, in a stage
  static constexpr int STAGE = SC_OFF + (QUANT ? 2 * kWinKeys * 4 : 0);
  static constexpr int RING_OFF = TILE_BYTES;
  static constexpr int CVT_OFF = RING_OFF + 2 * STAGE;
  static constexpr int SMEM = CVT_OFF + (QUANT ? 2 * TILE_BYTES : 0);
  // 16-byte vectors of a key row, and of a 64-key tile per thread.
  static constexpr int VPR = HD * static_cast<int>(sizeof(T)) / 16;
  static constexpr int VPT = kWinKeys * VPR / kMmaThreads;
  static_assert(kWinKeys * VPR % kMmaThreads == 0, "key tile must split over the threads");
};

// The int8 K and V rows of a tile (ROWS rows of HD bytes each, V
// kv_bytes after K at src) into bf16 tiles of row stride HD + 8 (V ROWS
// rows after K at dst), 16 elements a step; integers in [-128, 127] are
// exact in bf16.  THREADS threads share the work, this one as index t.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void int8_kv_to_bf16(bf16* dst, const unsigned char* src,
                                                int kv_bytes, int t) {
  constexpr int VPR = HD / 16;  // 16-byte vectors of a row
  static_assert(2 * ROWS * VPR % THREADS == 0, "a tile must split over the threads");
#pragma unroll
  for (int n = 0; n < 2 * ROWS * VPR / THREADS; ++n) {
    const int idx = t + n * THREADS;
    const int kv = idx / (ROWS * VPR);
    const int j = idx - kv * ROWS * VPR;
    const int r = j / VPR;
    const int c = j - r * VPR;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + kv * kv_bytes + r * HD + c * 16);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      packed[e] = pack_bf16(static_cast<float>(x[2 * e]), static_cast<float>(x[2 * e + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + (kv * ROWS + r) * (HD + 8) + c * 16);
    d[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    d[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

// One key tile of the online softmax on a warp's 16 x 8 KN scores s
// (this thread's rows g and g + 8 (e / 2), key columns col + 8 j + e % 2):
// scales them to log2 units (times the int8 K scale of each column, ks
// at this thread's first column), updates the running max m_r and this
// thread's part of the row sum l_r, rescales the accumulator and leaves
// p in s.  MASK on a tile that holds some row's last visible key (lim,
// per row): a masked p is exactly 0.
template <bool MASK, bool QUANT, int KN, int DN>
__device__ __forceinline__ void window_softmax(float (&s)[KN][4], float (&m_r)[2],
                                               float (&l_r)[2], float (&acc)[DN][4],
                                               const int (&lim)[2], int col, const float* ks,
                                               float scale_log2) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < KN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float f = scale_log2;
      if constexpr (QUANT) f *= ks[j * 8 + (e & 1)];
      const bool ok = !MASK || col + j * 8 + (e & 1) <= lim[e >> 1];
      s[j][e] = ok ? s[j][e] * f : kNegInf;
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
  for (int j = 0; j < KN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !MASK || col + j * 8 + (e & 1) <= lim[e >> 1];
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

// T: the arena's elements, bf16 or int8 (with f32 scales); q and out are
// bf16.  part_acc/part_ml: f32 scratch of (B, KV, splits, W G, HD) and
// (..., 2) (m in natural-log units, l), used when splits > 1.  Two blocks
// an SM (87 KB of shared memory each): without that minimum stated,
// ptxas held the int8 and hd-64 instantiations at 168 and 128 registers
// and spilled 8-24 bytes.
template <typename T, int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) paged_window_mma_kernel(
    const bf16* __restrict__ q, const T* __restrict__ k_arena, const T* __restrict__ v_arena,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ positions, bf16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int win, int kv_heads,
    int group, int n_blocks, int block_size, int t_width, int layer, int splits,
    int split_len, float scale) {
  using C = WindowMmaCfg<T, HD>;
  constexpr bool QUANT = C::QUANT;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);

  const int split = blockIdx.x % splits;
  const int r0 = (blockIdx.x / splits) * kWinTcRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = win * group;
  const int capacity = t_width * block_size;
  const int pos = positions[b];
  // Keys of the tile's deepest row, and this split's share of them.
  const int r_last = min(r0 + kWinTcRows - 1, rows - 1);
  const int n_keys = static_cast<int>(
      min(static_cast<long long>(pos) + r_last / group + 1, static_cast<long long>(capacity)));
  const int key0 = split * split_len;
  if (key0 >= n_keys) return;
  const int key_end = min(key0 + split_len, n_keys);
  const int n_tiles = (key_end - key0 + kWinKeys - 1) / kWinKeys;

  // The q tile: rows past W G zero-filled.
#pragma unroll
  for (int n = 0; n < kWinTcRows * (HD / 8) / kMmaThreads; ++n) {
    const int i = tid + n * kMmaThreads;
    const int r = i / (HD / 8);
    const int c = i - r * (HD / 8);
    const bool in = r0 + r < rows;
    const bf16* from =
        in ? q + window_row(b, kvh, r0 + r, win, kv_heads, group) * HD + c * 8 : q;
    cp_async16(smem_u32(q_s + r * LD + c * 8), from, in ? 16 : 0);
  }

  // Stage key tile i (keys key0 + 64 i ..) into ring stage i % 2: each
  // key row through the table; keys at or past key_end zero-filled.  A
  // thread copies rows r(n) = (tid + 128 n) / VPR of each tile (n < VPT =
  // VPR / 2), and for int8 the K (even tid) or V (odd tid) scale of row
  // r((tid % VPR) / 2), so every row's two scales are copied once; the
  // table entries of its rows are fetched one tile ahead into blk (-1:
  // past key_end), so that the copy of a tile never waits on a table
  // read.
  const int* trow = tables + static_cast<int64_t>(b) * t_width;
  const int64_t layer_blk = static_cast<int64_t>(layer) * n_blocks;
  unsigned char* ring = smem + C::RING_OFF;
  int blk[C::VPT];
  auto fetch_blocks = [&](int i) {
#pragma unroll
    for (int n = 0; n < C::VPT; ++n) {
      const int t = key0 + i * kWinKeys + (tid + n * kMmaThreads) / C::VPR;
      blk[n] = t < key_end ? trow[t / block_size] : -1;
    }
  };
  auto load_tile = [&](int i) {
    unsigned char* st = ring + (i & 1) * C::STAGE;
#pragma unroll
    for (int n = 0; n < C::VPT; ++n) {
      const int idx = tid + n * kMmaThreads;
      const int r = idx / C::VPR;
      const int c = idx - r * C::VPR;
      int64_t row = 0;
      if (blk[n] >= 0)
        row = (layer_blk + blk[n]) * block_size + (key0 + i * kWinKeys + r) % block_size;
      const int64_t off = (row * kv_heads + kvh) * HD + c * (16 / static_cast<int>(sizeof(T)));
      const int dst = QUANT ? r * HD + c * 16 : (r * LD + c * 8) * 2;
      const int bytes = blk[n] >= 0 ? 16 : 0;
      cp_async16(smem_u32(st + dst), k_arena + off, bytes);
      cp_async16(smem_u32(st + C::KV_BYTES + dst), v_arena + off, bytes);
      if constexpr (QUANT) {
        if (n == (tid % C::VPR) / 2) {
          const float* src = (tid & 1) ? v_scale : k_scale;
          cp_async4(smem_u32(st + C::SC_OFF + (tid & 1) * kWinKeys * 4 + r * 4),
                    src + row * kv_heads + kvh, bytes / 4);
        }
      }
    }
  };
  fetch_blocks(0);
  load_tile(0);
  cp_async_commit();
  fetch_blocks(1);

  // ldmatrix lane offsets: an A operand (or a B operand by .trans) from a
  // row-major tile, and a B operand from an (n, k) tile.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int col_t = 2 * (lane & 3);
  const uint32_t q_frag = smem_u32(q_s + (warp * 16 + a_row) * LD + a_col);
  // The last key each of this thread's two rows sees (rows past W G as
  // the last row), and the least and greatest over the warp's 16 rows.
  auto last_key = [&](int r) {
    return static_cast<int>(min(static_cast<long long>(pos) + min(r, rows - 1) / group,
                                static_cast<long long>(capacity) - 1));
  };
  const int warp_r0 = r0 + warp * 16;
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = last_key(warp_r0 + (lane >> 2) + 8 * i);
  const int lim_lo = last_key(warp_r0);
  const int lim_hi = last_key(warp_r0 + 15);

  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float acc[C::DN][4];
#pragma unroll
  for (int j = 0; j < C::DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_tile(i + 1);
      cp_async_commit();
      fetch_blocks(i + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* st = ring + (i & 1) * C::STAGE;
    const bf16* k_s = reinterpret_cast<const bf16*>(st);
    const bf16* v_s = reinterpret_cast<const bf16*>(st + C::KV_BYTES);
    const float* ks_s = nullptr;
    const float* vs_s = nullptr;
    if constexpr (QUANT) {
      bf16* cvt = reinterpret_cast<bf16*>(smem + C::CVT_OFF);
      int8_kv_to_bf16<HD, kWinKeys, kMmaThreads>(cvt, st, C::KV_BYTES, tid);
      __syncthreads();
      k_s = cvt;
      v_s = cvt + MmaTile<HD>::TILE;
      ks_s = reinterpret_cast<const float*>(st + C::SC_OFF);
      vs_s = ks_s + kWinKeys;
    }
    const int k0 = key0 + i * kWinKeys;

    // A key tile that none of this warp's rows sees adds nothing to them.
    if (k0 <= lim_hi) {
      // s = q k^T, 16 rows x 64 keys; q and k by ldmatrix.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < C::DK; ++kc) {
        uint32_t qa[4];
        ldsm_x4(qa, q_frag + kc * 16 * 2);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, smem_u32(k_s + (np * 16 + b_row) * LD + kc * 16 + b_col));
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }

      const float* ks = QUANT ? ks_s + col_t : nullptr;
      if (k0 + kWinKeys - 1 > lim_lo)
        window_softmax<true, QUANT>(s, m_r, l_r, acc, lim, k0 + col_t, ks, scale_log2);
      else
        window_softmax<false, QUANT>(s, m_r, l_r, acc, lim, k0 + col_t, ks, scale_log2);
      if constexpr (QUANT) {
        // The V scale of each key column, before p is rounded.
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= vs_s[col_t + j * 8 + (e & 1)];
      }

      // o += p v: p (bf16) from registers, v by ldmatrix.trans.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[4];
        acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < C::DK; ++dn) {
          uint32_t vf[4];
          ldsm_x4_t(vf, smem_u32(v_s + (kc * 16 + a_row) * LD + dn * 16 + a_col));
          mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // The row sum over the quad of lanes that hold the row.
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = warp_r0 + (lane >> 2) + 8 * i;
    if (r >= rows) continue;
    if (splits == 1) {
      const float inv = 1.f / l;
      bf16* o = out + window_row(b, kvh, r, win, kv_heads, group) * HD + col_t;
#pragma unroll
      for (int j = 0; j < C::DN; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    } else {
      const int64_t part =
          ((static_cast<int64_t>(b) * kv_heads + kvh) * splits + split) * rows + r;
      float* a = part_acc + part * HD + col_t;
#pragma unroll
      for (int j = 0; j < C::DN; ++j)
        *reinterpret_cast<float2*>(a + j * 8) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      if ((lane & 3) == 0) {
        part_ml[part * 2] = m_r[i] * 0.6931471805599453f;
        part_ml[part * 2 + 1] = l;
      }
    }
  }
}

// ---- the tensor-core route at HD 256 ----------------------------------------

// Query rows of a block (one m16 tile: _WINDOW_ROWS[256] in
// ops/decode_attention.py), keys a warp takes at a time (one k16 step of
// P V), the stages of a warp's cp.async ring, and the block's warps.
constexpr int kWin16Rows = 16;
constexpr int kWinWarpKeys = 16;
constexpr int kWin16Stages = 3;
constexpr int kWin16Warps = kMmaThreads / 32;

// Shared memory of one instantiation: q's 16-row bf16 tile, then each
// warp's ring of kWin16Stages chunks as they arrive (bf16: K and V rows
// padded to HD + 8; int8: rows of HD bytes, then the 16 K and 16 V f32
// scales) and, for int8, the warp's K and V chunk converted to bf16.
// After the key loop the rings hold each warp's (acc, m, l) for the
// merge, rows of HD + 4 floats.
template <typename T, int HD>
struct Window16Cfg {
  static constexpr bool QUANT = std::is_same<T, int8_t>::value;
  static constexpr int LD = HD + 8;
  static constexpr int DK = HD / 16;  // k16 steps over HD
  static constexpr int DN = HD / 8;   // n8 tiles of an output row
  static constexpr int Q_BYTES = kWin16Rows * LD * 2;
  static constexpr int KV_BYTES = QUANT ? kWinWarpKeys * HD : kWinWarpKeys * LD * 2;
  static constexpr int SC_OFF = 2 * KV_BYTES;  // the scales, in a stage
  static constexpr int STAGE = SC_OFF + (QUANT ? 2 * kWinWarpKeys * 4 : 0);
  static constexpr int CVT_OFF = kWin16Stages * STAGE;  // in a warp's share
  static constexpr int WARP_BYTES = CVT_OFF + (QUANT ? 2 * kWinWarpKeys * LD * 2 : 0);
  static constexpr int MLD = HD + 4;  // floats of a merge row
  static constexpr int MERGE_BYTES = kWin16Warps * kWin16Rows * (MLD + 2) * 4;
  static constexpr int RING_BYTES = kWin16Warps * WARP_BYTES;
  static constexpr int SMEM = Q_BYTES + (RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES);
  // 16-byte vectors of a key row, and of a chunk per lane.
  static constexpr int VPR = HD * static_cast<int>(sizeof(T)) / 16;
  static constexpr int VPL = kWinWarpKeys * VPR / 32;
  static_assert(kWinWarpKeys * VPR % 32 == 0, "a chunk must split over the lanes");
  static_assert(STAGE % 16 == 0 && WARP_BYTES % 16 == 0, "16-byte aligned stages");
};

// Arguments and scratch as paged_window_mma_kernel's.  One block an SM
// (211 KB of shared memory in bf16, 176 KB in int8), so ptxas may give a
// thread up to 255 registers.
template <typename T, int HD>
__global__ void __launch_bounds__(kMmaThreads, 1) paged_window_row16_mma_kernel(
    const bf16* __restrict__ q, const T* __restrict__ k_arena, const T* __restrict__ v_arena,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ positions, bf16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int win, int kv_heads,
    int group, int n_blocks, int block_size, int t_width, int layer, int splits,
    int split_len, float scale) {
  using C = Window16Cfg<T, HD>;
  constexpr bool QUANT = C::QUANT;
  constexpr int LD = C::LD;
  constexpr int S = kWin16Stages;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);

  const int split = blockIdx.x % splits;
  const int r0 = (blockIdx.x / splits) * kWin16Rows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = win * group;
  const int capacity = t_width * block_size;
  const int pos = positions[b];
  // Keys of the tile's deepest row, and this split's share of them, in
  // 16-key chunks; warp w takes chunks w, w + 4, ... (my_chunks of them).
  const int r_last = min(r0 + kWin16Rows - 1, rows - 1);
  const int n_keys = static_cast<int>(
      min(static_cast<long long>(pos) + r_last / group + 1, static_cast<long long>(capacity)));
  const int key0 = split * split_len;
  if (key0 >= n_keys) return;
  const int key_end = min(key0 + split_len, n_keys);
  const int n_chunks = (key_end - key0 + kWinWarpKeys - 1) / kWinWarpKeys;
  const int my_chunks = n_chunks > warp ? (n_chunks - warp + kWin16Warps - 1) / kWin16Warps : 0;

  // The q tile: rows past W G zero-filled; its own cp.async group.
#pragma unroll
  for (int n = 0; n < kWin16Rows * (HD / 8) / kMmaThreads; ++n) {
    const int i = tid + n * kMmaThreads;
    const int r = i / (HD / 8);
    const int c = i - r * (HD / 8);
    const bool in = r0 + r < rows;
    const bf16* from =
        in ? q + window_row(b, kvh, r0 + r, win, kv_heads, group) * HD + c * 8 : q;
    cp_async16(smem_u32(q_s + r * LD + c * 8), from, in ? 16 : 0);
  }
  cp_async_commit();

  // Stage this warp's chunk jj (keys key0 + 16 (w + 4 jj) ..) into ring
  // stage jj % S: lane l copies vectors l, l + 32, ... of the chunk's K
  // and V rows, each row found through the table; keys at or past
  // key_end zero-filled.  For int8, lanes 0-15 copy the K scale of row l
  // and lanes 16-31 the V scale of row l - 16.  Lanes 0-15 read the
  // table entry of row l of the warp's next chunk into blk (-1: past
  // key_end) one chunk ahead, and hand it over by __shfl_sync.
  const int* trow = tables + static_cast<int64_t>(b) * t_width;
  const int64_t layer_blk = static_cast<int64_t>(layer) * n_blocks;
  unsigned char* ring = smem + C::Q_BYTES + warp * C::WARP_BYTES;
  int blk = -1;
  auto chunk_key0 = [&](int jj) { return key0 + (warp + kWin16Warps * jj) * kWinWarpKeys; };
  auto fetch_blocks = [&](int jj) {
    const int t = chunk_key0(jj) + (lane & (kWinWarpKeys - 1));
    blk = jj < my_chunks && t < key_end ? trow[t / block_size] : -1;
  };
  auto load_chunk = [&](int jj) {
    unsigned char* st = ring + (jj % S) * C::STAGE;
    const int c0 = chunk_key0(jj);
#pragma unroll
    for (int n = 0; n < C::VPL; ++n) {
      const int idx = lane + n * 32;
      const int r = idx / C::VPR;
      const int c = idx - r * C::VPR;
      const int bk = __shfl_sync(0xffffffffu, blk, r);
      int64_t row = 0;
      if (bk >= 0) row = (layer_blk + bk) * block_size + (c0 + r) % block_size;
      const int64_t off = (row * kv_heads + kvh) * HD + c * (16 / static_cast<int>(sizeof(T)));
      const int dst = QUANT ? r * HD + c * 16 : (r * LD + c * 8) * 2;
      const int bytes = bk >= 0 ? 16 : 0;
      cp_async16(smem_u32(st + dst), k_arena + off, bytes);
      cp_async16(smem_u32(st + C::KV_BYTES + dst), v_arena + off, bytes);
    }
    if constexpr (QUANT) {
      const int r = lane & (kWinWarpKeys - 1);
      const int bk = __shfl_sync(0xffffffffu, blk, r);
      int64_t row = 0;
      if (bk >= 0) row = (layer_blk + bk) * block_size + (c0 + r) % block_size;
      const float* src = (lane >> 4) ? v_scale : k_scale;
      cp_async4(smem_u32(st + C::SC_OFF + (lane >> 4) * kWinWarpKeys * 4 + r * 4),
                src + row * kv_heads + kvh, bk >= 0 ? 4 : 0);
    }
  };
  // The ring's first S - 1 chunks, a group each (empty past my_chunks).
  fetch_blocks(0);
#pragma unroll
  for (int jj = 0; jj < S - 1; ++jj) {
    if (jj < my_chunks) {
      load_chunk(jj);
      fetch_blocks(jj + 1);
    }
    cp_async_commit();
  }
  // q's group is the oldest: done when at most S - 1 are pending; every
  // thread's share of it, after the barrier.
  cp_async_wait<S - 1>();
  __syncthreads();

  // ldmatrix lane offsets: an A operand (or a B operand by .trans) from a
  // row-major tile, and a B operand from an (n, k) tile.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int col_t = 2 * (lane & 3);
  const uint32_t q_frag = smem_u32(q_s + a_row * LD + a_col);
  // The last key each of this thread's two rows sees (rows past W G as
  // the last row), and the least over the tile's 16 rows.
  auto last_key = [&](int r) {
    return static_cast<int>(min(static_cast<long long>(pos) + min(r, rows - 1) / group,
                                static_cast<long long>(capacity) - 1));
  };
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = last_key(r0 + (lane >> 2) + 8 * i);
  const int lim_lo = last_key(r0);

  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float acc[C::DN][4];
#pragma unroll
  for (int j = 0; j < C::DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;

  for (int jj = 0; jj < my_chunks; ++jj) {
    // Chunk jj landed (at most S - 2 newer groups pending) and every lane
    // is done with the stage that chunk jj + S - 1 overwrites.
    cp_async_wait<S - 2>();
    __syncwarp();
    if (jj + S - 1 < my_chunks) {
      load_chunk(jj + S - 1);
      fetch_blocks(jj + S);
    }
    cp_async_commit();
    const unsigned char* st = ring + (jj % S) * C::STAGE;
    const bf16* k_s = reinterpret_cast<const bf16*>(st);
    const bf16* v_s = reinterpret_cast<const bf16*>(st + C::KV_BYTES);
    const float* ks_s = nullptr;
    const float* vs_s = nullptr;
    if constexpr (QUANT) {
      bf16* cvt = reinterpret_cast<bf16*>(ring + C::CVT_OFF);
      int8_kv_to_bf16<HD, kWinWarpKeys, 32>(cvt, st, C::KV_BYTES, lane);
      __syncwarp();
      k_s = cvt;
      v_s = cvt + kWinWarpKeys * LD;
      ks_s = reinterpret_cast<const float*>(st + C::SC_OFF);
      vs_s = ks_s + kWinWarpKeys;
    }
    const int k0 = chunk_key0(jj);

    // s = q k^T, 16 rows x 16 keys; q and k by ldmatrix.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < C::DK; ++kc) {
      uint32_t qa[4], kf[4];
      ldsm_x4(qa, q_frag + kc * 16 * 2);
      ldsm_x4(kf, smem_u32(k_s + b_row * LD + kc * 16 + b_col));
      mma_bf16(s[0], qa, kf[0], kf[1]);
      mma_bf16(s[1], qa, kf[2], kf[3]);
    }

    const float* ks = QUANT ? ks_s + col_t : nullptr;
    if (k0 + kWinWarpKeys - 1 > lim_lo)
      window_softmax<true, QUANT>(s, m_r, l_r, acc, lim, k0 + col_t, ks, scale_log2);
    else
      window_softmax<false, QUANT>(s, m_r, l_r, acc, lim, k0 + col_t, ks, scale_log2);
    if constexpr (QUANT) {
      // The V scale of each key column, before p is rounded.
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vs_s[col_t + j * 8 + (e & 1)];
    }

    // o += p v: p (bf16) from registers, v by ldmatrix.trans.
    uint32_t pa[4];
    acc_to_a(pa, s[0], s[1]);
#pragma unroll
    for (int dn = 0; dn < C::DK; ++dn) {
      uint32_t vf[4];
      ldsm_x4_t(vf, smem_u32(v_s + a_row * LD + dn * 16 + a_col));
      mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
      mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();

  // The merge: each warp's (acc, m, l) of the 16 rows into shared memory
  // (over the rings, once every warp is done with its own), then thread t
  // takes row t / 8, columns 4 (t % 8) + 32 n, and sums the warps in
  // order: M = max m_w, l = sum e^(m_w - M) l_w, acc = sum e^(m_w - M)
  // acc_w.  A warp that saw none of a row's keys has m_w = -1e30 and
  // adds 0.
  float* m_acc = reinterpret_cast<float*>(smem + C::Q_BYTES);
  float* m_ml = m_acc + kWin16Warps * kWin16Rows * C::MLD;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = warp * kWin16Rows + (lane >> 2) + 8 * i;
    float* a = m_acc + row * C::MLD + col_t;
#pragma unroll
    for (int j = 0; j < C::DN; ++j)
      *reinterpret_cast<float2*>(a + j * 8) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    if ((lane & 3) == 0) {
      m_ml[row * 2] = m_r[i];
      m_ml[row * 2 + 1] = l;
    }
  }
  __syncthreads();
  const int row = tid >> 3;
  const int r = r0 + row;
  if (r >= rows) return;
  float mw[kWin16Warps];
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWin16Warps; ++w) {
    mw[w] = m_ml[(w * kWin16Rows + row) * 2];
    mx = fmaxf(mx, mw[w]);
  }
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWin16Warps; ++w) {
    mw[w] = exp2f(mw[w] - mx);
    den = fmaf(mw[w], m_ml[(w * kWin16Rows + row) * 2 + 1], den);
  }
  const int64_t part =
      ((static_cast<int64_t>(b) * kv_heads + kvh) * splits + split) * rows + r;
  bf16* o = out + window_row(b, kvh, r, win, kv_heads, group) * HD;
  const float inv = 1.f / den;
#pragma unroll
  for (int n = 0; n < HD / 32; ++n) {
    const int c = 4 * (tid & 7) + 32 * n;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWin16Warps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(m_acc + (w * kWin16Rows + row) * C::MLD + c);
      num.x = fmaf(mw[w], x.x, num.x);
      num.y = fmaf(mw[w], x.y, num.y);
      num.z = fmaf(mw[w], x.z, num.z);
      num.w = fmaf(mw[w], x.w, num.w);
    }
    if (splits == 1) {
      reinterpret_cast<__nv_bfloat162*>(o + c)[0] = __floats2bfloat162_rn(num.x * inv, num.y * inv);
      reinterpret_cast<__nv_bfloat162*>(o + c)[1] = __floats2bfloat162_rn(num.z * inv, num.w * inv);
    } else {
      *reinterpret_cast<float4*>(part_acc + part * HD + c) = num;
    }
  }
  if (splits > 1 && (tid & 7) == 0) {
    part_ml[part * 2] = mx * 0.6931471805599453f;
    part_ml[part * 2 + 1] = den;
  }
}

// The split-KV combine: warp w of block (x, kv, b) takes row r = 4 x + w
// of (slot b, KV head kv), reads the splits that hold its keys
// (min(positions[b] + r / G, capacity - 1) / split_len + 1 of them) and
// nothing else, and writes o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s -
// M) l_s in ascending s; lane i sums the float4 columns i, i + 32, ...
// (elements 4 i .. 4 i + 3 of each 128).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) paged_window_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ positions, bf16* __restrict__ out, int win, int kv_heads,
    int group, int splits, int split_len, int capacity) {
  const int rows = win * group;
  const int r = blockIdx.x * (kMmaThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const long long last = min(static_cast<long long>(positions[b]) + r / group,
                             static_cast<long long>(capacity) - 1);
  const int live = static_cast<int>(min(static_cast<long long>(splits), last / split_len + 1));
  const int64_t base = (static_cast<int64_t>(b) * kv_heads + kvh) * splits * rows + r;
  float mx = kNegInf;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, part_ml[(base + s * rows) * 2]);
  constexpr int NV = HD / 4;             // float4 columns of a row
  constexpr int CPL = (NV + 31) / 32;    // ... a lane
  float den = 0.f;
  float4 num[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) num[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < live; ++s) {
    const int64_t part = base + static_cast<int64_t>(s) * rows;
    const float w = expf(part_ml[part * 2] - mx);
    den = fmaf(w, part_ml[part * 2 + 1], den);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (lane + 32 * c < NV) {
        const float4 x = reinterpret_cast<const float4*>(part_acc + part * HD)[lane + 32 * c];
        num[c].x = fmaf(w, x.x, num[c].x);
        num[c].y = fmaf(w, x.y, num[c].y);
        num[c].z = fmaf(w, x.z, num[c].z);
        num[c].w = fmaf(w, x.w, num[c].w);
      }
    }
  }
  bf16* o = out + window_row(b, kvh, r, win, kv_heads, group) * HD;
  const float inv = 1.f / den;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (lane + 32 * c < NV) {
      auto* o2 = reinterpret_cast<__nv_bfloat162*>(o + 4 * (lane + 32 * c));
      o2[0] = __floats2bfloat162_rn(num[c].x * inv, num[c].y * inv);
      o2[1] = __floats2bfloat162_rn(num[c].z * inv, num[c].w * inv);
    }
  }
}

// ---- launches ---------------------------------------------------------------

struct WindowArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const void* tables;
  const void* positions;
  void* out;
  void* part_acc;
  void* part_ml;
  int batch;
  int win;
  int kv_heads;
  int group;
  int n_blocks;
  int block_size;
  int t_width;
  int layer;
  int splits;
  int split_len;
  float scale;
};

template <typename T, int HD>
int launch_window(const WindowArgs& a, cudaStream_t stream) {
  const int rows = a.win * a.group;
  const dim3 grid(a.batch, a.kv_heads, (rows + kWinRows - 1) / kWinRows);
  paged_window_kernel<T, HD><<<grid, kWinThreads, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.positions),
      static_cast<float*>(a.out), a.win, a.kv_heads, a.group, a.n_blocks, a.block_size,
      a.t_width, a.layer, a.scale);
  return launch_status();
}

template <int HD>
int launch_window_combine(const WindowArgs& a, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kMmaThreads / 32;
  const int rows = a.win * a.group;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock, a.kv_heads, a.batch);
  paged_window_combine_kernel<HD><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<const int*>(a.positions), static_cast<bf16*>(a.out), a.win, a.kv_heads,
      a.group, a.splits, a.split_len, a.t_width * a.block_size);
  return launch_status();
}

// Query rows of a tensor-core tile: one m16 tile at HD 256
// (paged_window_row16_mma_kernel), 4 at 64 and 128.
constexpr int window_tile_rows(int head_dim) { return head_dim == 256 ? kWin16Rows : kWinTcRows; }

// The tensor-core kernel of an instantiation and its shared memory.
template <typename T, int HD>
auto window_mma_kernel() {
  if constexpr (HD == 256)
    return paged_window_row16_mma_kernel<T, HD>;
  else
    return paged_window_mma_kernel<T, HD>;
}
template <typename T, int HD>
constexpr int window_mma_smem() {
  if constexpr (HD == 256)
    return Window16Cfg<T, HD>::SMEM;
  else
    return WindowMmaCfg<T, HD>::SMEM;
}

template <typename T, int HD>
int launch_window_mma(const WindowArgs& a, cudaStream_t stream) {
  constexpr int kSmem = window_mma_smem<T, HD>();
  auto kernel = window_mma_kernel<T, HD>();
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  constexpr int kRows = window_tile_rows(HD);
  const int row_tiles = (a.win * a.group + kRows - 1) / kRows;
  const dim3 grid(row_tiles * a.splits, a.kv_heads, a.batch);
  kernel<<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.positions),
      static_cast<bf16*>(a.out), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), a.win, a.kv_heads, a.group, a.n_blocks, a.block_size,
      a.t_width, a.layer, a.splits, a.split_len, a.scale);
  if (const int e = launch_status()) return e;
  return a.splits > 1 ? launch_window_combine<HD>(a, stream) : 0;
}

// K4's tensor-core route: bf16 q at head_dim 64, 128 and 256 (f32 would
// need TF32, which changes f32 results).
bool paged_window_tc_route(int dtype, int head_dim) {
  return dtype == kBF16 && (head_dim == 64 || head_dim == 128 || head_dim == 256);
}

// The FMA route (f32 q), by head_dim.
template <typename T>
int dispatch_window(int head_dim, const WindowArgs& a, cudaStream_t stream) {
  if (head_dim == 64) return launch_window<T, 64>(a, stream);
  if (head_dim == 128) return launch_window<T, 128>(a, stream);
  if (head_dim == 256) return launch_window<T, 256>(a, stream);
  return kErrUnsupported;
}

// The tensor-core route, by head_dim.
template <typename T>
int dispatch_window_mma(int head_dim, const WindowArgs& a, cudaStream_t stream) {
  if (head_dim == 64) return launch_window_mma<T, 64>(a, stream);
  if (head_dim == 128) return launch_window_mma<T, 128>(a, stream);
  if (head_dim == 256) return launch_window_mma<T, 256>(a, stream);
  return kErrUnsupported;
}

// Sizes a launch of either route takes; the tensor-core route also its
// split: split_len a multiple of the key tile, splits covering the
// capacity, scratch with more than one.
bool valid_window(const WindowArgs& a, int head_dim, bool tc) {
  if (a.batch < 1 || a.batch > 65535 || a.kv_heads < 1 || a.kv_heads > 65535 || a.win < 1 ||
      a.group < 1 || a.block_size < 1 || a.t_width < 1 || a.layer < 0 ||
      static_cast<long long>(a.block_size) * a.t_width > (1LL << 30))
    return false;
  const long long rows = static_cast<long long>(a.win) * a.group;
  if (!tc) return a.splits == 1 && (rows + kWinRows - 1) / kWinRows <= 65535;
  const long long capacity = static_cast<long long>(a.block_size) * a.t_width;
  if (a.splits < 1 || a.split_len < kWinKeys || a.split_len % kWinKeys ||
      static_cast<long long>(a.splits) * a.split_len < capacity)
    return false;
  const int tile = window_tile_rows(head_dim);
  if ((rows + tile - 1) / tile * a.splits > 0x7fffffffLL) return false;
  return a.splits == 1 || (a.part_acc != nullptr && a.part_ml != nullptr);
}

}  // namespace
}  // namespace skk

// q, out: (batch, win, kv_heads, group, head_dim) in q_dtype (kF32 or
// kBF16); kv_dtype: q_dtype, or kI8 with both scale pointers set.  The
// tensor-core route (skk_paged_window_route) splits each row tile's keys
// into `splits` of `split_len` and, with more than one, leaves its f32
// partials in part_acc (batch, kv_heads, splits, win * group, head_dim)
// and part_ml (..., 2) and combines them; the FMA route takes splits 1
// (scratch unused, may be null).
extern "C" int skk_paged_window(const void* q, const void* k_arena, const void* v_arena,
                                const void* k_scale, const void* v_scale, const void* tables,
                                const void* positions, void* out, void* part_acc,
                                void* part_ml, int batch, int win, int kv_heads, int group,
                                int head_dim, int n_blocks, int block_size, int t_width,
                                int layer, int splits, int split_len, float scale,
                                int q_dtype, int kv_dtype, void* stream) {
  const skk::WindowArgs a{q,     k_arena,   v_arena,   k_scale,  v_scale,  tables,
                          positions, out,   part_acc,  part_ml,  batch,    win,
                          kv_heads, group,  n_blocks,  block_size, t_width, layer,
                          splits,  split_len, scale};
  const bool tc = skk::paged_window_tc_route(q_dtype, head_dim);
  if (!skk::valid_window(a, head_dim, tc)) return skk::kErrUnsupported;
  if (kv_dtype == skk::kI8 && (k_scale == nullptr || v_scale == nullptr))
    return skk::kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (kv_dtype == skk::kBF16) return skk::dispatch_window_mma<__nv_bfloat16>(head_dim, a, s);
    if (kv_dtype == skk::kI8) return skk::dispatch_window_mma<int8_t>(head_dim, a, s);
    return skk::kErrUnsupported;
  }
  if (q_dtype != skk::kF32) return skk::kErrUnsupported;
  if (kv_dtype == skk::kF32) return skk::dispatch_window<float>(head_dim, a, s);
  if (kv_dtype == skk::kI8) return skk::dispatch_window<int8_t>(head_dim, a, s);
  return skk::kErrUnsupported;
}

// 1 when (q dtype, head_dim) takes the tensor-core kernel (and the split
// policy), 0 when the FMA kernel: the wrapper counts launches by route.
extern "C" int skk_paged_window_route(int q_dtype, int head_dim) {
  return skk::paged_window_tc_route(q_dtype, head_dim) ? 1 : 0;
}

// The combine pass alone, on partials a split launch of the tensor-core
// route left in part_acc/part_ml; bf16 out (batch, win, kv_heads, group,
// head_dim).  Phase 3 of chip_smoke.py holds it against its plain
// version.
extern "C" int skk_paged_window_combine(const void* part_acc, const void* part_ml,
                                        const void* positions, void* out, int batch, int win,
                                        int kv_heads, int group, int head_dim, int splits,
                                        int split_len, int capacity, void* stream) {
  if (batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 || win < 1 ||
      group < 1 || splits < 2 || split_len < 1 || capacity < 1 ||
      (head_dim != 64 && head_dim != 128 && head_dim != 256))
    return skk::kErrUnsupported;
  // The combine reads only the capacity, as block_size * t_width.
  const skk::WindowArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          positions, out, const_cast<void*>(part_acc),
                          const_cast<void*>(part_ml), batch, win, kv_heads, group, 0,
                          capacity, 1, 0, splits, split_len, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return skk::launch_window_combine<64>(a, s);
  if (head_dim == 128) return skk::launch_window_combine<128>(a, s);
  return skk::launch_window_combine<256>(a, s);
}
