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
// skipped the repeated DMA.  Here nothing past min(pos + 1, capacity) is
// read.
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
// per row and KV head for int8) and does 4 flops per element read, far
// below the CUDA cores' ~20 flops a byte, so its floor is those bytes
// over 3.35 TB/s, and the kernel has to keep enough of them in flight.
//
// Design (split-KV).  The grid is (splits, KV, B): block s of (b, kv)
// takes keys [s * split_len, min((s + 1) * split_len, n_keys)), and a
// block whose range starts past n_keys returns at once.  splits and
// split_len come from the host (ops/decode_attention.py::_decode_splits)
// as a fixed function of batch, KV heads, capacity and the SM count
// (about two blocks an SM when every slot is full), so a launch never
// depends on positions and can be captured in a CUDA graph; each block
// finds its range on the device.  The G query rows of a KV head share
// every chunk of 32 keys staged in shared memory, so the cache is read
// once per KV head, not once per query head.  Chunks stream through a
// cp.async ring of 2-4 stages (16-byte copies; each thread looks up the
// row of one key, through the table for K1, once per chunk), with two
// barriers a chunk.  Scores: lane r of warp w takes key r of the chunk
// for query rows w and w + 4, looping over HD with q broadcast from
// shared memory (K rows padded by 16 bytes, so the lanes' 16-byte reads
// hit distinct banks); the warp keeps each row's running max, each lane
// its own running sum of e^(s - m).  The probabilities go to shared
// memory key-major, (32, NG) for a block built for NG = 4 or 8 rows, so
// that P.V reads a key's NG probabilities in one or two 16-byte loads
// and runs without a branch on the group.  P.V: thread t owns head-dim
// columns 2 c, 2 c + 1 (c = t mod HD / 2) for every (128 / (HD / 2))-th
// key of the chunk, in f32 registers, summed across those key groups
// once at the end.  An int8 cache is dequantized element by element with
// its (row, KV head) scale before each product, as the TPU kernel did;
// scores, probabilities and sums stay f32 and only the output is
// rounded.  With one split the block writes the output; with more, each
// block writes its f32 (m, l) per query row and its (G, HD) accumulator
// to scratch (B, KV, splits, G, .), and decode_combine_kernel (grid (KV,
// B)) finds each slot's live splits from positions and sums them:
// o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.  No atomics: two
// launches are bitwise equal.  Row offsets are 64-bit: L * B * S * KV *
// HD passes 2^31 for a contiguous 8B cache at batch >= 32.
//
// At the 8B serving shape (q (8, 8, 4, 128), bf16, 5,515 live keys of
// 2,048) the pair of kernels takes 0.035 ms of device time against a
// 0.0068 ms byte bound on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 3, graph_ms): the longest split walks 13 chunks one after
// another, and the combine is a second launch.
#include "mma.cuh"

namespace skk {
namespace {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxGroup = 8;
// Keys a block stages at a time: one per lane of a scoring warp (the
// split length, _DECODE_CHUNK in ops/decode_attention.py, is a multiple).
constexpr int kDecChunk = 32;

// Rows policies: n_keys(pos) is how many keys a slot at position pos
// attends, row(b, t) where slot b's key t sits, in units of one (KV, HD)
// cache row (the int8 scales sit at row * KV + kv).
struct PooledRows {
  const int* tables;
  int t_width;
  int block_size;
  int n_blocks;
  int layer;
  __device__ int n_keys(int pos) const {
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
  __device__ int n_keys(int pos) const {
    return static_cast<int>(min(static_cast<long long>(pos) + 1,
                                static_cast<long long>(s_len)));
  }
  __device__ int64_t row(int b, int t) const {
    return (static_cast<int64_t>(layer) * batch + b) * s_len + t;
  }
};

// Shared-memory layout of one instantiation.  T is the cache's element
// type.  A ring stage holds a chunk's K rows (padded), V rows and, for
// int8, their scales; q (f32) and the chunk's probabilities follow the
// ring.  After the last chunk the ring holds the key groups' partial
// accumulators.
template <typename T, int HD>
struct DecodeCfg {
  static constexpr bool QUANT = std::is_same<T, int8_t>::value;
  static constexpr int CH = kDecChunk;
  static constexpr int ROW = HD * static_cast<int>(sizeof(T));  // bytes
  static constexpr int KSTR = ROW + 16;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // a granule
  static constexpr int VPR = ROW / 16;                           // granules a row
  static constexpr int TPK = kDecThreads / CH;                   // copy threads a key
  static constexpr int GPT = VPR / TPK;                          // granules a thread
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = CH * KSTR;
  static constexpr int KS_OFF = V_OFF + CH * ROW;
  static constexpr int STAGE = KS_OFF + (QUANT ? 2 * CH * 4 : 0);
  static constexpr int NST = STAGE <= 12288 ? 4 : (STAGE <= 24576 ? 3 : 2);
  static constexpr int NCP = HD / 2;                             // column pairs
  static constexpr int KG = kDecThreads / NCP;                   // P.V key groups
  static constexpr int Q_OFF = NST * STAGE;
  static constexpr int P_OFF = Q_OFF + kMaxGroup * HD * 4;
  static constexpr int SMEM = P_OFF + kMaxGroup * CH * 4;
  static_assert(GPT * TPK == VPR, "a key's granules split evenly");
  static_assert(KG * NCP == kDecThreads, "P.V covers the block");
  static_assert(KG * kMaxGroup * HD * 4 <= NST * STAGE,
                "the partial accumulators fit in the ring");
};

// The VEC elements of one 16-byte granule, in f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
}

// Two adjacent elements of a V row, in f32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// TQ: q and out (f32 or bf16); T: cache elements (TQ, or int8 with
// per-(row, KV head) f32 scales); NG: query rows a block is built for,
// 4 (group 1..4) or 8 (group 5..8).  part_acc (B, KV, splits, G, HD) and
// part_ml (B, KV, splits, G, 2) are written only when splits > 1, out
// only when splits == 1.
// Four blocks an SM (at most 128 registers a thread): without the
// minimum, ptxas held some instantiations to 64 registers and spilled.
template <typename TQ, typename T, int HD, int NG, typename Rows>
__global__ void __launch_bounds__(kDecThreads, 4) decode_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, Rows rows,
    const int* __restrict__ positions, TQ* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int kv_heads,
    int group, int split_len, float scale) {
  using C = DecodeCfg<T, HD>;
  constexpr int RPW = NG / kDecWarps;  // scoring rows a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float corr_s[NG];
  __shared__ float m_s[NG];
  __shared__ float l_s[NG];

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int n_keys = rows.n_keys(positions[b]);
  const int start = split * split_len;
  // Block 0 always runs, so the combine has a split to read even for a
  // (never used) position below 0.
  if (split > 0 && start >= n_keys) return;
  const int end = min(start + split_len, n_keys);
  const int n_chunks = end > start ? (end - start + C::CH - 1) / C::CH : 0;

  // q in f32; the chunk's probabilities key-major, (CH, NG), with the
  // rows past group kept at 0 (and their correction at 1) so that P.V
  // runs over NG rows without a branch.
  float* q_s = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* p_s = reinterpret_cast<float*>(smem + C::P_OFF);
  const int64_t slot = static_cast<int64_t>(b) * kv_heads + kvh;
  const TQ* qb = q + slot * group * HD;
  for (int i = tid; i < group * HD; i += kDecThreads) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < C::CH * NG; i += kDecThreads) p_s[i] = 0.f;
  if (tid < NG) corr_s[tid] = 1.f;

  // Copies: thread tid stages key tid / TPK of a chunk, granules
  // tid % TPK + j * TPK of its K and V rows (and its two scales).
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * HD;
  const T* k_head = k_cache + static_cast<int64_t>(kvh) * HD;
  const T* v_head = v_cache + static_cast<int64_t>(kvh) * HD;
  const int cr = tid / C::TPK;
  const int cc = tid % C::TPK;
  auto issue = [&](int chunk) {
    const int t = start + chunk * C::CH + cr;
    if (t < end) {
      unsigned char* st = smem + (chunk % C::NST) * C::STAGE;
      const int64_t row = rows.row(b, t);
      const T* ks = k_head + row * row_stride;
      const T* vs = v_head + row * row_stride;
#pragma unroll
      for (int j = 0; j < C::GPT; ++j) {
        const int c = cc + j * C::TPK;
        cp_async16(smem_u32(st + C::K_OFF + cr * C::KSTR + c * 16), ks + c * C::VEC, 16);
        cp_async16(smem_u32(st + C::V_OFF + cr * C::ROW + c * 16), vs + c * C::VEC, 16);
      }
      if constexpr (C::QUANT) {
        if (cc == 0) {
          const int64_t soff = row * kv_heads + kvh;
          cp_async4(smem_u32(st + C::KS_OFF + cr * 4), k_scale + soff, 4);
          cp_async4(smem_u32(st + C::KS_OFF + (C::CH + cr) * 4), v_scale + soff, 4);
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < C::NST - 1; ++i) {
    if (i < n_chunks) issue(i);
    cp_async_commit();
  }

  // This warp scores rows warp + 4 h (h < RPW) that are below group,
  // with a running max (the warp's) and a running sum of e^(s - m) over
  // the keys of each lane (summed across the warp at the end).
  bool live[RPW];
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int h = 0; h < RPW; ++h) {
    live[h] = warp + h * kDecWarps < group;
    m_run[h] = kNegInf;
    l_run[h] = 0.f;
  }

  const int cp = tid % C::NCP;
  const int kg = tid / C::NCP;
  float acc[NG][2];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<C::NST - 2>();
    __syncthreads();  // chunk landed; everyone is done with chunk - 1
    if (chunk + C::NST - 1 < n_chunks) issue(chunk + C::NST - 1);
    cp_async_commit();

    const unsigned char* st = smem + (chunk % C::NST) * C::STAGE;
    const float* ks_s = reinterpret_cast<const float*>(st + C::KS_OFF);
    const float* vs_s = ks_s + C::CH;
    const int n = min(C::CH, end - start - chunk * C::CH);

    // Scores and online softmax: lane = key.
    if (live[0]) {
      // PS partial sums a row: four chains of FMAs a lane either way.
      constexpr int PS = 4 / RPW;
      float a[RPW][PS];
#pragma unroll
      for (int h = 0; h < RPW; ++h)
#pragma unroll
        for (int e = 0; e < PS; ++e) a[h][e] = 0.f;
      if (lane < n) {
        const unsigned char* krow = st + C::K_OFF + lane * C::KSTR;
        const float ksc = C::QUANT ? ks_s[lane] : 1.f;
#pragma unroll
        for (int c = 0; c < C::VPR; ++c) {
          float kf[C::VEC];
          unpack(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
          if constexpr (C::QUANT) {
#pragma unroll
            for (int e = 0; e < C::VEC; ++e) kf[e] *= ksc;
          }
#pragma unroll
          for (int h = 0; h < RPW; ++h) {
            if (h == 0 || live[h]) {
              const float4* qv = reinterpret_cast<const float4*>(
                  q_s + (warp + h * kDecWarps) * HD + c * C::VEC);
#pragma unroll
              for (int j = 0; j < C::VEC / 4; ++j) {
                const float4 x = qv[j];
                a[h][0 % PS] = fmaf(x.x, kf[4 * j], a[h][0 % PS]);
                a[h][1 % PS] = fmaf(x.y, kf[4 * j + 1], a[h][1 % PS]);
                a[h][2 % PS] = fmaf(x.z, kf[4 * j + 2], a[h][2 % PS]);
                a[h][3 % PS] = fmaf(x.w, kf[4 * j + 3], a[h][3 % PS]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < RPW; ++h) {
        if (live[h]) {
          const int g = warp + h * kDecWarps;
          float dot = a[h][0];
#pragma unroll
          for (int e = 1; e < PS; ++e) dot += a[h][e];
          const float s = lane < n ? dot * scale : kNegInf;
          const float m_new = fmaxf(m_run[h], warp_max(s));
          const float e = lane < n ? expf(s - m_new) : 0.f;
          const float corr = expf(m_run[h] - m_new);
          l_run[h] = l_run[h] * corr + e;
          m_run[h] = m_new;
          p_s[lane * NG + g] = e;
          if (lane == 0) corr_s[g] = corr;
        }
      }
    }
    __syncthreads();

    // P.V: columns 2 cp, 2 cp + 1 over keys kg, kg + KG, ..., all NG rows.
    const T* v_s = reinterpret_cast<const T*>(st + C::V_OFF);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float corr = corr_s[g];
      acc[g][0] *= corr;
      acc[g][1] *= corr;
    }
#pragma unroll 4
    for (int r = kg; r < n; r += C::KG) {
      float2 vv = load_pair(v_s + r * HD + 2 * cp);
      if constexpr (C::QUANT) {
        vv.x *= vs_s[r];
        vv.y *= vs_s[r];
      }
      const float4* pr = reinterpret_cast<const float4*>(p_s + r * NG);
#pragma unroll
      for (int g4 = 0; g4 < NG / 4; ++g4) {
        const float4 p = pr[g4];
        acc[4 * g4][0] = fmaf(p.x, vv.x, acc[4 * g4][0]);
        acc[4 * g4][1] = fmaf(p.x, vv.y, acc[4 * g4][1]);
        acc[4 * g4 + 1][0] = fmaf(p.y, vv.x, acc[4 * g4 + 1][0]);
        acc[4 * g4 + 1][1] = fmaf(p.y, vv.y, acc[4 * g4 + 1][1]);
        acc[4 * g4 + 2][0] = fmaf(p.z, vv.x, acc[4 * g4 + 2][0]);
        acc[4 * g4 + 2][1] = fmaf(p.z, vv.y, acc[4 * g4 + 2][1]);
        acc[4 * g4 + 3][0] = fmaf(p.w, vv.x, acc[4 * g4 + 3][0]);
        acc[4 * g4 + 3][1] = fmaf(p.w, vv.y, acc[4 * g4 + 3][1]);
      }
    }
  }

  // Sum the key groups' accumulators (in the ring, now free) in order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < group) {
      red[(kg * group + g) * HD + 2 * cp] = acc[g][0];
      red[(kg * group + g) * HD + 2 * cp + 1] = acc[g][1];
    }
  }
#pragma unroll
  for (int h = 0; h < RPW; ++h) {
    if (live[h]) {
      const float l = warp_sum(l_run[h]);
      if (lane == 0) {
        m_s[warp + h * kDecWarps] = m_run[h];
        l_s[warp + h * kDecWarps] = l;
      }
    }
  }
  __syncthreads();
  const int64_t part = (slot * splits + split) * group;
  for (int i = tid; i < group * HD; i += kDecThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    float a = red[g * HD + d];
#pragma unroll
    for (int k = 1; k < C::KG; ++k) a += red[(k * group + g) * HD + d];
    if (splits == 1) {
      out[slot * group * HD + i] = from_f32<TQ>(a * (1.f / l_s[g]));
    } else {
      part_acc[part * HD + i] = a;
    }
  }
  if (splits > 1 && tid < group) {
    part_ml[(part + tid) * 2] = m_s[tid];
    part_ml[(part + tid) * 2 + 1] = l_s[tid];
  }
}

// The split-KV combine: block (kv, b) reads the live splits of slot b
// (ceil(n_keys / split_len) of them, from positions) and writes
// o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.  Warp w takes rows
// w, w + 4: its lanes stride over the splits for M and the denominator
// (a fixed shuffle tree) and leave each split's weight e^(m_s - M) in
// shared memory (group x splits f32); then thread i sums elements 4 i ..
// 4 i + 3 of the live accumulators in ascending s, with 16-byte loads
// that do not wait on the sums.
template <typename TQ>
__global__ void __launch_bounds__(kDecThreads) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ positions, TQ* __restrict__ out, int kv_heads,
    int group, int head_dim, int splits, int split_len, int capacity) {
  extern __shared__ float w_s[];
  __shared__ float den_s[kMaxGroup];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long n_keys =
      min(static_cast<long long>(positions[b]) + 1, static_cast<long long>(capacity));
  const int live = static_cast<int>(
      max(1LL, min(static_cast<long long>(splits), (n_keys + split_len - 1) / split_len)));
  const int64_t slot = static_cast<int64_t>(b) * kv_heads + kvh;
  const float* ml = part_ml + slot * splits * group * 2;
  const float* acc = part_acc + slot * splits * group * head_dim;
  for (int g = warp; g < group; g += kDecWarps) {
    float mx = kNegInf;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, ml[(s * group + g) * 2]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float w = expf(ml[(s * group + g) * 2] - mx);
      w_s[g * splits + s] = w;
      den += w * ml[(s * group + g) * 2 + 1];
    }
    den = warp_sum(den);
    if (lane == 0) den_s[g] = den;
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(group) * head_dim;  // one split
  for (int i = tid; i < group * head_dim / 4; i += kDecThreads) {
    const int g = 4 * i / head_dim;
    const float* w = w_s + g * splits;
    const float4* a = reinterpret_cast<const float4*>(acc) + i;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < live; ++s) {
      const float4 x = a[s * row / 4];
      num.x = fmaf(w[s], x.x, num.x);
      num.y = fmaf(w[s], x.y, num.y);
      num.z = fmaf(w[s], x.z, num.z);
      num.w = fmaf(w[s], x.w, num.w);
    }
    TQ* o = out + slot * row + 4 * i;
    o[0] = from_f32<TQ>(num.x / den_s[g]);
    o[1] = from_f32<TQ>(num.y / den_s[g]);
    o[2] = from_f32<TQ>(num.z / den_s[g]);
    o[3] = from_f32<TQ>(num.w / den_s[g]);
  }
}

// What a decode launch needs besides the Rows policy.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const void* positions;
  void* out;
  void* part_acc;
  void* part_ml;
  int batch;
  int kv_heads;
  int group;
  int splits;
  int split_len;
  float scale;
};

// The combine's weights take group x splits f32 of shared memory.
constexpr int kCombineSmem = 48 * 1024;

template <typename TQ>
int launch_combine(const DecodeArgs& a, int head_dim, int capacity, cudaStream_t stream) {
  const int smem = a.group * a.splits * static_cast<int>(sizeof(float));
  decode_combine_kernel<TQ><<<dim3(a.kv_heads, a.batch), kDecThreads, smem, stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<const int*>(a.positions), static_cast<TQ*>(a.out), a.kv_heads, a.group,
      head_dim, a.splits, a.split_len, capacity);
  return launch_status();
}

template <typename TQ, typename T, int HD, int NG, typename Rows>
int launch_decode(const DecodeArgs& a, Rows rows, int capacity, cudaStream_t stream) {
  using C = DecodeCfg<T, HD>;
  auto kernel = decode_kernel<TQ, T, HD, NG, Rows>;
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = true;
  }
  const dim3 grid(a.splits, a.kv_heads, a.batch);
  kernel<<<grid, kDecThreads, C::SMEM, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), rows,
      static_cast<const int*>(a.positions), static_cast<TQ*>(a.out),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml), a.kv_heads,
      a.group, a.split_len, a.scale);
  if (const int e = launch_status()) return e;
  return a.splits > 1 ? launch_combine<TQ>(a, HD, capacity, stream) : 0;
}

template <typename TQ, typename T, typename Rows>
int dispatch_head_dim(int head_dim, const DecodeArgs& a, Rows rows, int capacity,
                      cudaStream_t stream) {
  const bool wide = a.group > 4;
  switch (head_dim) {
    case 64:
      return wide ? launch_decode<TQ, T, 64, 8, Rows>(a, rows, capacity, stream)
                  : launch_decode<TQ, T, 64, 4, Rows>(a, rows, capacity, stream);
    case 128:
      return wide ? launch_decode<TQ, T, 128, 8, Rows>(a, rows, capacity, stream)
                  : launch_decode<TQ, T, 128, 4, Rows>(a, rows, capacity, stream);
    case 256:
      return wide ? launch_decode<TQ, T, 256, 8, Rows>(a, rows, capacity, stream)
                  : launch_decode<TQ, T, 256, 4, Rows>(a, rows, capacity, stream);
    default:
      return kErrUnsupported;
  }
}

bool valid_split(const DecodeArgs& a, int capacity) {
  if (a.splits < 1 || a.split_len < 1 || a.split_len % kDecChunk) return false;
  if (static_cast<long long>(a.group) * a.splits * 4 > kCombineSmem) return false;
  if (static_cast<long long>(a.splits) * a.split_len < capacity) return false;
  return a.splits == 1 || (a.part_acc != nullptr && a.part_ml != nullptr);
}

// q_dtype: kF32 or kBF16; kv_dtype: q_dtype, or kI8 with both scale
// pointers set.
template <typename Rows>
int dispatch_decode(const DecodeArgs& a, Rows rows, int capacity, int head_dim,
                    int q_dtype, int kv_dtype, void* stream) {
  if (a.batch < 1 || a.batch > 65535 || a.kv_heads < 1 || a.kv_heads > 65535 ||
      a.group < 1 || a.group > kMaxGroup || rows.layer < 0 || !valid_split(a, capacity))
    return kErrUnsupported;
  if (kv_dtype == kI8 && (a.k_scale == nullptr || a.v_scale == nullptr))
    return kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, Rows>(head_dim, a, rows, capacity, s);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_head_dim<float, float, Rows>(head_dim, a, rows, capacity, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return dispatch_head_dim<__nv_bfloat16, int8_t, Rows>(head_dim, a, rows, capacity, s);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return dispatch_head_dim<float, int8_t, Rows>(head_dim, a, rows, capacity, s);
  return kErrUnsupported;
}

}  // namespace
}  // namespace skk

// K1: the pooled arena (L, n_blocks, block_size, KV, HD) through tables
// (batch, t_width).  part_acc/part_ml: f32 scratch of (batch, KV, splits,
// group, head_dim) and (..., 2) elements, unused (may be null) when
// splits == 1.
extern "C" int skk_paged_decode(const void* q, const void* k_arena,
                                const void* v_arena, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* positions, void* out,
                                void* part_acc, void* part_ml, int batch,
                                int kv_heads, int group, int head_dim,
                                int n_blocks, int block_size, int t_width,
                                int layer, int splits, int split_len,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (block_size < 1 || t_width < 1 ||
      static_cast<long long>(block_size) * t_width > (1LL << 30))
    return skk::kErrUnsupported;
  const skk::PooledRows rows{static_cast<const int*>(tables), t_width,
                             block_size, n_blocks, layer};
  const skk::DecodeArgs a{q, k_arena, v_arena, k_scale, v_scale, positions, out,
                          part_acc, part_ml, batch, kv_heads, group, splits,
                          split_len, scale};
  return skk::dispatch_decode(a, rows, block_size * t_width, head_dim, q_dtype,
                              kv_dtype, stream);
}

// K7: the contiguous cache (L, batch, s_len, KV, HD); scratch as K1's.
extern "C" int skk_contig_decode(const void* q, const void* k_cache,
                                 const void* v_cache, const void* k_scale,
                                 const void* v_scale, const void* positions,
                                 void* out, void* part_acc, void* part_ml,
                                 int batch, int kv_heads, int group,
                                 int head_dim, int s_len, int layer,
                                 int splits, int split_len, float scale,
                                 int q_dtype, int kv_dtype, void* stream) {
  if (s_len < 1) return skk::kErrUnsupported;
  const skk::ContigRows rows{batch, s_len, layer};
  const skk::DecodeArgs a{q, k_cache, v_cache, k_scale, v_scale, positions, out,
                          part_acc, part_ml, batch, kv_heads, group, splits,
                          split_len, scale};
  return skk::dispatch_decode(a, rows, s_len, head_dim, q_dtype, kv_dtype, stream);
}

// The combine pass alone, on partials a split launch of K1 or K7 left in
// part_acc/part_ml (capacity: the launch's t_width * block_size or
// s_len); phase 3 of chip_smoke.py holds it against its plain version.
extern "C" int skk_decode_combine(const void* part_acc, const void* part_ml,
                                  const void* positions, void* out, int batch,
                                  int kv_heads, int group, int head_dim,
                                  int splits, int split_len, int capacity,
                                  int q_dtype, void* stream) {
  if (batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 || group < 1 ||
      group > skk::kMaxGroup || head_dim < 4 || head_dim % 4 || splits < 2 || split_len < 1 ||
      capacity < 1 || static_cast<long long>(group) * splits * 4 > skk::kCombineSmem)
    return skk::kErrUnsupported;
  const skk::DecodeArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, positions, out,
                          const_cast<void*>(part_acc), const_cast<void*>(part_ml), batch,
                          kv_heads, group, splits, split_len, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == skk::kBF16) return skk::launch_combine<__nv_bfloat16>(a, head_dim, capacity, s);
  if (q_dtype == skk::kF32) return skk::launch_combine<float>(a, head_dim, capacity, s);
  return skk::kErrUnsupported;
}
