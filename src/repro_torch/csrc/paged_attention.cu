// Paged GQA decode / verify / tail-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py
// `_attn_kernel` with `_online_update` and `_finish` (launched by
// `paged_attention_padded` with k_exp=None) and `_attn_kernel_quant` with
// `_unpack_int4` (the same launcher with per-block exponents).  Contract:
//   q    (B, T, K, G, hd) row r < T*G of (b, kh) is q[b, r/G, kh, r%G] at q_pos = pos0[b] + r/G
//   k/v  (n_blocks, block, K, hd) pools, f32 | bf16 | int8 (x kv_scale, KV_F int8), or
//        SYMOG-quantized: int8 words (n_blocks, block, K, hd) or int4 split-halves words
//        (n_blocks, block, K, hd/2; word i = lane i in the low nibble, lane i + hd/2 in the
//        high one, both sign-extended), each (block, head) dequantized as word * 2^e with e
//        from k_exp/v_exp (n_blocks, K) int32 — exact in fp32 (|word| <= 127, e in [-20, 20])
//   bt   (B, max_blocks) int32 physical block ids (0 = trash)
//   mask kv_pos <= q_pos && q_pos - kv_pos < window (2^30 = no window)
//   s = scale * q.k, softcap tanh(s/cap)*cap if cap > 0, masked logits -1e30,
//   p zeroed under the mask, out = acc / (l == 0 ? 1 : l).
//
// On the TPU the grid walks the row's blocks j in order and carries
// (m, l, acc) in scratch across grid steps.  CUDA blocks do not carry state,
// so the walk over `bt[b, j]` is a loop INSIDE each thread block.
//
// What bounds it on the H100: the bytes of the KV blocks a row can see
// (decode: 2 x tokens x hd x 2 bytes per (row, KV head) in bf16); the
// arithmetic is ~1 FMA per loaded element.  Design:
//   * one thread block per (b, kv_head, row tile of 16 query rows, KV split);
//     all G query heads of a KV head share each K/V tile loaded to shared
//     memory, so the pool is read once per KV head, not once per query head;
//   * decode has few (b, kv_head) pairs (B=4, K=8 -> 32), far fewer than the
//     132 SMs, so the row's blocks are split over grid.y; each split runs the
//     online softmax over its range and a second small kernel merges the
//     (m, l, acc) partials: M = max m_s, L = sum l_s e^(m_s-M),
//     O = sum acc_s e^(m_s-M) / L — the same recurrence, regrouped;
//   * blocks past the tile's last query position, and blocks wholly outside
//     the window, are skipped: their masked logits would contribute p = 0
//     and alpha = 1 exactly, so skipping changes no bit of the math, and
//     the work follows the row's real length instead of max_blocks;
//   * the K/V tile is read with 16-byte loads, several per thread issued
//     before any is used, so a tile costs about one memory round trip;
//   * q.k dot products: one warp per (row, key) pair, lanes over hd, shuffle
//     reduction; p.v: each thread owns hd columns of the accumulator.
// q, k and v are converted to fp32 on load (int4 words unpacked there, each
// source scaled by its own 2^e: K and V blocks carry different exponents);
// all math is fp32 (expf, tanhf).
#include "common.cuh"

namespace {

constexpr int kRows = 16;      // query rows per thread block
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kQ8 = 3;  // pool codes beyond common.cuh's: int8 words + exponents
constexpr int kQ4 = 4;  // int4 split-halves words + exponents

struct Params {
  const int* bt;
  const int* pos0;
  const int* k_exp;  // (n_blocks, K) exponents of quantized pools, else null
  const int* v_exp;
  float* ws_m;
  float* ws_l;
  float* ws_acc;
  int B, T, K, TG, G, hd, hdw, block, max_blocks, window, n_split, chunk;  // hdw: words/row
  int vec;  // 16-byte loads allowed (aligned bases, hd a multiple of the vector)
  float scale, cap, kv_scale;
};

constexpr int kLoads = 4;  // 16-byte loads in flight per thread and source

// dst_a/b[r*hd + d] = src_a/b[row(r) + d] * scale_a/b for r < rows, d < hd, where
// row(r) = ((r0 + r) / G) * stride + ((r0 + r) % G) * hd: consecutive rows
// within a group of G, groups `stride` apart (G = 1: plain strided rows).
// Every thread issues up to kLoads 16-byte loads per source before it
// converts and stores any of them (a load followed at once by its use
// leaves one load in flight per thread and makes the tile latency-bound).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ a, const T* __restrict__ b,
                                          int r0, int G, size_t stride, int rows, int hd,
                                          float* dst_a, float* dst_b, float scale_a,
                                          float scale_b, int vec) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (vec) {
    const int vpr = hd / E, nv = rows * vpr;
    for (int base = 0; base < nv; base += kLoads * kThreads) {
      uint4 ra[kLoads], rb[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nv) {
          const int r = r0 + i / vpr;
          const size_t off = static_cast<size_t>(r / G) * stride + (r % G) * hd + (i % vpr) * E;
          ra[u] = __ldg(reinterpret_cast<const uint4*>(a + off));
          if (b) rb[u] = __ldg(reinterpret_cast<const uint4*>(b + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nv) {
          const int o = (i / vpr) * hd + (i % vpr) * E;
          float f[E];
          repro::unpack16<T>(ra[u], f);
#pragma unroll
          for (int e = 0; e < E; ++e) dst_a[o + e] = f[e] * scale_a;
          if (b) {
            repro::unpack16<T>(rb[u], f);
#pragma unroll
            for (int e = 0; e < E; ++e) dst_b[o + e] = f[e] * scale_b;
          }
        }
      }
    }
    return;
  }
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd, rr = r0 + r;
    const size_t off = static_cast<size_t>(rr / G) * stride + (rr % G) * hd + d;
    dst_a[i] = repro::to_f32(a[off]) * scale_a;
    if (b) dst_b[i] = repro::to_f32(b[off]) * scale_b;
  }
}

// the two sign-extended nibbles of an int4 split-halves word
__device__ __forceinline__ float lo_nibble(int8_t w) {
  return static_cast<float>(static_cast<int>((static_cast<uint8_t>(w) & 15u) ^ 8u) - 8);
}
__device__ __forceinline__ float hi_nibble(int8_t w) {
  return static_cast<float>(static_cast<int>((static_cast<uint8_t>(w) >> 4) ^ 8u) - 8);
}

// load_rows for int4 split-halves pools (G = 1, r0 = 0): row r holds hd/2
// words, `stride` words apart; word c of row r gives lanes c and c + hd/2.
__device__ __forceinline__ void load_rows_int4(const int8_t* __restrict__ a,
                                               const int8_t* __restrict__ b, size_t stride,
                                               int rows, int hd, float* dst_a, float* dst_b,
                                               float scale_a, float scale_b, int vec) {
  const int hw = hd / 2, tid = threadIdx.x;
  if (vec) {  // 16 words (32 lanes) per 16-byte load, kLoads loads in flight
    const int vpr = hw / 16, nv = rows * vpr;
    for (int base = 0; base < nv; base += kLoads * kThreads) {
      uint4 ra[kLoads], rb[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nv) {
          const size_t off = static_cast<size_t>(i / vpr) * stride + (i % vpr) * 16;
          ra[u] = __ldg(reinterpret_cast<const uint4*>(a + off));
          rb[u] = __ldg(reinterpret_cast<const uint4*>(b + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nv) {
          const int o = (i / vpr) * hd + (i % vpr) * 16;
          const int8_t* wa = reinterpret_cast<const int8_t*>(&ra[u]);
          const int8_t* wb = reinterpret_cast<const int8_t*>(&rb[u]);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            dst_a[o + e] = lo_nibble(wa[e]) * scale_a;
            dst_a[o + hw + e] = hi_nibble(wa[e]) * scale_a;
            dst_b[o + e] = lo_nibble(wb[e]) * scale_b;
            dst_b[o + hw + e] = hi_nibble(wb[e]) * scale_b;
          }
        }
      }
    }
    return;
  }
  for (int i = tid; i < rows * hw; i += kThreads) {
    const int r = i / hw, c = i - r * hw;
    const size_t off = static_cast<size_t>(r) * stride + c;
    dst_a[r * hd + c] = lo_nibble(a[off]) * scale_a;
    dst_a[r * hd + hw + c] = hi_nibble(a[off]) * scale_a;
    dst_b[r * hd + c] = lo_nibble(b[off]) * scale_b;
    dst_b[r * hd + hw + c] = hi_nibble(b[off]) * scale_b;
  }
}

// QMODE: 0 float / KV_F pools (static kv_scale); 8 int8 words and 4 int4
// words, each (block, head) scaled by 2^k_exp / 2^v_exp
template <typename QT, typename KVT, int QMODE>
__global__ void __launch_bounds__(kThreads)
attn_partial(const QT* __restrict__ q, const KVT* __restrict__ kp, const KVT* __restrict__ vp,
             QT* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd, blk = p.block;
  float* q_s = smem;                    // [kRows][hd]
  float* k_s = q_s + kRows * hd;        // [blk][hd]
  float* v_s = k_s + blk * hd;          // [blk][hd]
  float* acc_s = v_s + blk * hd;        // [kRows][hd]
  float* p_s = acc_s + kRows * hd;      // [kRows][blk]
  float* m_s = p_s + kRows * blk;       // [kRows]
  float* l_s = m_s + kRows;             // [kRows]
  float* a_s = l_s + kRows;             // [kRows] alpha

  const int bk = blockIdx.x;            // b * K + kh
  const int b = bk / p.K, kh = bk % p.K;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int nrows = min(kRows, p.TG - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // q[b, t, kh, g, :] for rows row0.. (t = r / G, g = r % G); out alike
  const size_t q_base = (static_cast<size_t>(b) * p.T * p.K + kh) * p.G * hd;
  const size_t q_stride = static_cast<size_t>(p.K) * p.G * hd;
  load_rows<QT>(q + q_base, nullptr, row0, p.G, q_stride, nrows, hd, q_s, nullptr, 1.f, 1.f,
                p.vec);
  for (int i = tid; i < nrows * hd; i += kThreads) acc_s[i] = 0.f;
  if (tid < kRows) { m_s[tid] = kNegInf; l_s[tid] = 0.f; }

  const int pos0 = p.pos0[b];
  const int qpos_lo = pos0 + row0 / p.G;
  const int qpos_hi = pos0 + (row0 + nrows - 1) / p.G;
  const int j_begin = split * p.chunk;
  const int j_end = min(p.max_blocks, j_begin + p.chunk);
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const int kv0 = j * blk;
    if (kv0 > qpos_hi) break;                        // causal: nothing visible from here on
    if (qpos_lo - (kv0 + blk - 1) >= p.window) continue;  // wholly outside every row's window
    const int phys = p.bt[b * p.max_blocks + j];
    // K/V tile: token t of physical block `phys`, head kh (rows K*hdw words apart)
    const size_t tile = (static_cast<size_t>(phys) * blk * p.K + kh) * p.hdw;
    const size_t kv_stride = static_cast<size_t>(p.K) * p.hdw;
    float sk = p.kv_scale, sv = p.kv_scale;
    if (QMODE != 0) {  // this (block, head)'s exponents, exact powers of two
      const size_t ei = static_cast<size_t>(phys) * p.K + kh;
      sk = ldexpf(1.f, p.k_exp[ei]);
      sv = ldexpf(1.f, p.v_exp[ei]);
    }
    if (QMODE == 4)
      load_rows_int4(reinterpret_cast<const int8_t*>(kp) + tile,
                     reinterpret_cast<const int8_t*>(vp) + tile, kv_stride, blk, hd, k_s, v_s,
                     sk, sv, p.vec);
    else
      load_rows<KVT>(kp + tile, vp + tile, 0, 1, kv_stride, blk, hd, k_s, v_s, sk, sv, p.vec);
    __syncthreads();
    // s = scale * q.k (+ softcap), one warp per (row, token) pair
    for (int pr = warp; pr < nrows * blk; pr += kWarps) {
      const int r = pr / blk, t = pr - r * blk;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s = fmaf(q_s[r * hd + d], k_s[t * hd + d], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        s *= p.scale;
        if (p.cap > 0.f) s = tanhf(s / p.cap) * p.cap;
        p_s[r * blk + t] = s;
      }
    }
    __syncthreads();
    // online-softmax update, one thread per row
    if (tid < nrows) {
      const int r = tid;
      const int qpos = pos0 + (row0 + r) / p.G;
      float mx = kNegInf;
      for (int t = 0; t < blk; ++t) {
        const int kvp = kv0 + t;
        const bool ok = kvp <= qpos && qpos - kvp < p.window;
        const float s = ok ? p_s[r * blk + t] : kNegInf;
        p_s[r * blk + t] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < blk; ++t) {
        const int kvp = kv0 + t;
        const bool ok = kvp <= qpos && qpos - kvp < p.window;
        const float e = ok ? expf(p_s[r * blk + t] - m_new) : 0.f;
        p_s[r * blk + t] = e;
        sum += e;
      }
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
      a_s[r] = alpha;
    }
    __syncthreads();
    // acc = alpha * acc + p @ v; each thread owns columns d
    for (int d = tid; d < hd; d += kThreads) {
      for (int r = 0; r < nrows; ++r) {
        float a = acc_s[r * hd + d] * a_s[r];
        for (int t = 0; t < blk; ++t) a = fmaf(p_s[r * blk + t], v_s[t * hd + d], a);
        acc_s[r * hd + d] = a;
      }
    }
    __syncthreads();
  }

  if (p.n_split == 1) {  // finish in place: out = acc / l
    for (int i = tid; i < nrows * hd; i += kThreads) {
      const int r = i / hd, rr = row0 + r;
      const float l = l_s[r];
      out[q_base + (rr / p.G) * q_stride + (rr % p.G) * hd + (i - r * hd)] =
          repro::from_f32<QT>(acc_s[i] / (l == 0.f ? 1.f : l));
    }
    return;
  }
  // split partials: (bk, split, row) for m/l and (bk, split, row, d) for acc
  const size_t prow = (static_cast<size_t>(bk) * p.n_split + split) * p.TG + row0;
  for (int i = tid; i < nrows * hd; i += kThreads) p.ws_acc[prow * hd + i] = acc_s[i];
  if (tid < nrows) { p.ws_m[prow + tid] = m_s[tid]; p.ws_l[prow + tid] = l_s[tid]; }
}

template <typename QT>
__global__ void attn_combine(QT* __restrict__ out, Params p) {
  // one thread block per (bk, row); w_s = e^(m_s - M) / L per split into
  // shared memory first, then each thread sums its hd columns over the
  // splits with 4 independent loads in flight
  extern __shared__ float w_s[];  // [n_split]
  __shared__ float red[2];
  const int bk = blockIdx.x, r = blockIdx.y;
  const int TG = p.TG, S = p.n_split;
  const size_t row = static_cast<size_t>(bk) * S * TG + r;  // split s at row + s*TG
  const int b = bk / p.K, kh = bk % p.K;
  const size_t o_base = (((static_cast<size_t>(b) * p.T + r / p.G) * p.K + kh) * p.G + r % p.G) *
                        p.hd;
  if (threadIdx.x == 0) {
    float M = kNegInf;
    for (int s = 0; s < S; ++s) M = fmaxf(M, p.ws_m[row + static_cast<size_t>(s) * TG]);
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = row + static_cast<size_t>(s) * TG;
      L += p.ws_l[i] * expf(p.ws_m[i] - M);
    }
    red[0] = M;
    red[1] = 1.f / (L == 0.f ? 1.f : L);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    w_s[s] = expf(p.ws_m[row + static_cast<size_t>(s) * TG] - red[0]) * red[1];
  __syncthreads();
  for (int d = threadIdx.x; d < p.hd; d += blockDim.x) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 4 <= S; s += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] += w_s[s + j] * p.ws_acc[(row + static_cast<size_t>(s + j) * TG) * p.hd + d];
    }
    for (int j = 0; s < S; ++s, ++j)
      o[j] += w_s[s] * p.ws_acc[(row + static_cast<size_t>(s) * TG) * p.hd + d];
    out[o_base + d] = repro::from_f32<QT>((o[0] + o[1]) + (o[2] + o[3]));
  }
}

template <typename QT, typename KVT, int QMODE>
int launch(const void* q, const void* k, const void* v, void* out, const Params& p,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * kRows * p.hd + 2 * p.block * p.hd + kRows * p.block + 3 * kRows);
  auto kern = attn_partial<QT, KVT, QMODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(p.B * p.K, p.n_split, (p.TG + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const QT*>(q), static_cast<const KVT*>(k),
                                     static_cast<const KVT*>(v), static_cast<QT*>(out), p);
  if (p.n_split > 1) {
    dim3 g2(p.B * p.K, p.TG);
    attn_combine<QT><<<g2, kThreads, sizeof(float) * p.n_split, st>>>(static_cast<QT*>(out), p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v, void* out,
              const Params& p, cudaStream_t st) {
  if (kv_dtype == repro::kF32) return launch<QT, float, 0>(q, k, v, out, p, st);
  if (kv_dtype == repro::kBF16) return launch<QT, __nv_bfloat16, 0>(q, k, v, out, p, st);
  if (kv_dtype == repro::kI8) return launch<QT, int8_t, 0>(q, k, v, out, p, st);
  if (kv_dtype == kQ8) return launch<QT, int8_t, 8>(q, k, v, out, p, st);
  if (kv_dtype == kQ4) return launch<QT, int8_t, 4>(q, k, v, out, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Absorbed multi-head-latent-attention (MLA) decode.
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py
// `_mla_kernel` (float / KV_F int8 pools) and `_mla_kernel_quant` (SYMOG int8
// or int4 words), both launched by `paged_attention_mla_padded`.  Contract:
//   q_eff (B, T, H, r), q_rope (B, T, H, rope): row i < T*H of batch b is
//        (t = i / H, h = i % H) at q_pos = pos0[b] + i / H
//   pools c_kv (n_blocks, block, r) and k_rope (n_blocks, block, rope): f32 | bf16 |
//        int8 (x kv_scale, KV_F), or SYMOG words: int8, or int4 split halves (last dims
//        r/2 and rope/2; word i = lane i low nibble, lane i + w/2 high nibble), each
//        physical block p of a pool scaled by 2^c_exp[p] / 2^r_exp[p] (no head axis)
//   s = scale * (q_eff . c_kv + q_rope . k_rope), masked (kv_pos > q_pos) to -1e30 with
//   p zeroed, online softmax, value = c_kv itself: out (B, T, H, r) = acc / (l == 0 ? 1 : l)
//   in rank space (the caller expands it with kv_b_v).
//
// What bounds it on the H100: operations.  Every query row needs the full
// rank-r dot product with every visible token, and the value is the same
// c_kv tile, so a decode step (B 4, H 128, r 512, rope 64, ~300 tokens a row)
// is ~334 MFLOP against 1.4 MB of bf16 pool (0.35 MB at int4).  The TPU
// kernel keeps one batch row's whole (T*H, r) fp32 accumulator in VMEM:
// 128 x 512 x 4 B = 256 KB, more than the 227 KB a Hopper thread block may
// have.  Design:
//   * one thread block per (b, tile of 16 query rows, KV split): the tile's
//     rows share each c_kv/k_rope tile loaded to shared memory, and the
//     tile's (16, r) accumulator fits beside it (~106 KB at r = 512, so two
//     thread blocks share an SM); rows are tiled, not r: every logit needs
//     the full-rank dot product;
//   * KV split over grid.y with the GQA kernel's (m, l, acc) combine
//     (attn_combine with K = 1, G = H, hd = r);
//   * each physical block is walked in tiles of 16 tokens; tiles wholly past
//     the row tile's last query position are skipped (p = 0, alpha = 1 there:
//     exact);
//   * logits: each warp owns two query rows and all 16 tokens of the tile,
//     lanes over r and rope with 32 independent partial sums (each q value
//     loaded once, each c_kv value used by both rows), a butterfly reduction,
//     and the same warp's online-softmax update of its rows; p . c_kv: each
//     thread owns columns d of the accumulator and holds the tile's 16 values
//     of column d in registers across the rows.
// All math is fp32 (pools dequantized on load, word * 2^e exact); the output
// is rounded to q's dtype once.  bf16 mma/wgmma on the query tile and TMA
// loads of the blocks are left for later work.
constexpr int kMlaRows = 16;      // query rows per thread block (ops.py MLA_ROWS)
constexpr int kMlaTile = 16;      // KV tokens per shared-memory tile
constexpr int kMlaThreads = 256;  // 8 warps
constexpr int kMlaWarps = kMlaThreads / 32;
static_assert(kMlaRows == 2 * kMlaWarps, "each warp owns two query rows");
static_assert(kMlaTile % 4 == 0, "p rows are read as float4");

struct MlaParams {
  const int* bt;
  const int* pos0;
  const int* c_exp;  // (n_blocks,) exponents of quantized pools, else null
  const int* r_exp;
  float* ws_m;
  float* ws_l;
  float* ws_acc;
  int B, T, H, TH, r, rope, rw, ropew, block, max_blocks, n_split, chunk;  // rw/ropew: words/row
  int vec_q, vec_c, vec_r;  // 16-byte loads allowed: queries, c_kv pool, k_rope pool
  float scale, kv_scale;
};

// dst[i * width + c] = src[i * stride + c] * scale for i < rows, c < width
template <typename T>
__device__ __forceinline__ void mla_load(const T* __restrict__ src, size_t stride, int rows,
                                         int width, float* dst, float scale, int vec) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (vec) {
    const int vpr = width / E, nv = rows * vpr;
    for (int base = 0; base < nv; base += kLoads * kMlaThreads) {
      uint4 reg[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kMlaThreads + tid;
        if (i < nv)
          reg[u] = __ldg(reinterpret_cast<const uint4*>(
              src + static_cast<size_t>(i / vpr) * stride + (i % vpr) * E));
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kMlaThreads + tid;
        if (i < nv) {
          float f[E];
          repro::unpack16<T>(reg[u], f);
          float* d = dst + (i / vpr) * width + (i % vpr) * E;
#pragma unroll
          for (int e = 0; e < E; ++e) d[e] = f[e] * scale;
        }
      }
    }
    return;
  }
  for (int i = tid; i < rows * width; i += kMlaThreads) {
    const int row = i / width, c = i - row * width;
    dst[i] = repro::to_f32(src[static_cast<size_t>(row) * stride + c]) * scale;
  }
}

// mla_load for int4 split-halves words: row i holds width/2 words, `stride`
// words apart; word c gives lanes c (low nibble) and c + width/2 (high)
__device__ __forceinline__ void mla_load_int4(const int8_t* __restrict__ src, size_t stride,
                                              int rows, int width, float* dst, float scale,
                                              int vec) {
  const int hw = width / 2, tid = threadIdx.x;
  if (vec) {  // 16 words (32 lanes) per 16-byte load
    const int vpr = hw / 16, nv = rows * vpr;
    for (int base = 0; base < nv; base += kLoads * kMlaThreads) {
      uint4 reg[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kMlaThreads + tid;
        if (i < nv)
          reg[u] = __ldg(reinterpret_cast<const uint4*>(
              src + static_cast<size_t>(i / vpr) * stride + (i % vpr) * 16));
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kMlaThreads + tid;
        if (i < nv) {
          const int8_t* w = reinterpret_cast<const int8_t*>(&reg[u]);
          float* d = dst + (i / vpr) * width + (i % vpr) * 16;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            d[e] = lo_nibble(w[e]) * scale;
            d[hw + e] = hi_nibble(w[e]) * scale;
          }
        }
      }
    }
    return;
  }
  for (int i = tid; i < rows * hw; i += kMlaThreads) {
    const int row = i / hw, c = i - row * hw;
    const int8_t w = src[static_cast<size_t>(row) * stride + c];
    dst[row * width + c] = lo_nibble(w) * scale;
    dst[row * width + hw + c] = hi_nibble(w) * scale;
  }
}

// One query row's online-softmax update from its tile logits ``sv`` (the
// same values in every lane of the calling warp): mask kv_pos > q_pos (and
// tokens past the block) to -1e30, fold into (m, l), and write p and alpha.
__device__ __forceinline__ void mla_row_update(float (&sv)[kMlaTile], int rr, int qpos, int kvt,
                                               int ntok, float scale, int lane, float* m_s,
                                               float* l_s, float* a_s, float* p_s) {
  float mx = kNegInf;
#pragma unroll
  for (int t = 0; t < kMlaTile; ++t) {
    sv[t] = t < ntok && kvt + t <= qpos ? sv[t] * scale : kNegInf;
    mx = fmaxf(mx, sv[t]);
  }
  const float m_prev = m_s[rr];
  const float m_new = fmaxf(m_prev, mx);
  const float alpha = expf(m_prev - m_new);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kMlaTile; ++t) {
    sv[t] = t < ntok && kvt + t <= qpos ? expf(sv[t] - m_new) : 0.f;
    sum += sv[t];
  }
  __syncwarp();  // every lane has read m_s[rr] before lane 0 rewrites it
  if (lane == 0) {
    m_s[rr] = m_new;
    l_s[rr] = l_s[rr] * alpha + sum;
    a_s[rr] = alpha;
#pragma unroll
    for (int t = 0; t < kMlaTile; ++t) p_s[rr * kMlaTile + t] = sv[t];
  }
}

// QMODE: 0 float / KV_F pools (static kv_scale); 8 int8 words and 4 int4
// words, each physical block of each pool scaled by its own 2^e
template <typename QT, typename KVT, int QMODE>
__global__ void __launch_bounds__(kMlaThreads)
mla_partial(const QT* __restrict__ q_eff, const QT* __restrict__ q_rope,
            const KVT* __restrict__ cp, const KVT* __restrict__ kp, QT* __restrict__ out,
            MlaParams p) {
  extern __shared__ float smem[];
  const int r = p.r, rope = p.rope;
  float* qc_s = smem;                    // [kMlaRows][r]
  float* qr_s = qc_s + kMlaRows * r;     // [kMlaRows][rope]
  float* c_s = qr_s + kMlaRows * rope;   // [kMlaTile][r]
  float* kr_s = c_s + kMlaTile * r;      // [kMlaTile][rope]
  float* acc_s = kr_s + kMlaTile * rope; // [kMlaRows][r]
  float* p_s = acc_s + kMlaRows * r;     // [kMlaRows][kMlaTile]
  float* m_s = p_s + kMlaRows * kMlaTile;
  float* l_s = m_s + kMlaRows;
  float* a_s = l_s + kMlaRows;           // alpha

  const int b = blockIdx.x, split = blockIdx.y, row0 = blockIdx.z * kMlaRows;
  const int nrows = min(kMlaRows, p.TH - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const size_t q_row = static_cast<size_t>(b) * p.TH + row0;  // first row of (B*T*H)
  mla_load<QT>(q_eff + q_row * r, r, nrows, r, qc_s, 1.f, p.vec_q);
  mla_load<QT>(q_rope + q_row * rope, rope, nrows, rope, qr_s, 1.f, p.vec_q);
  for (int i = tid; i < nrows * r; i += kMlaThreads) acc_s[i] = 0.f;
  if (tid < kMlaRows) { m_s[tid] = kNegInf; l_s[tid] = 0.f; }

  const int pos0 = p.pos0[b];
  const int qpos_hi = pos0 + (row0 + nrows - 1) / p.H;
  const int j_begin = split * p.chunk;
  const int j_end = min(p.max_blocks, j_begin + p.chunk);
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const int kv0 = j * p.block;
    if (kv0 > qpos_hi) break;  // causal: nothing visible from here on
    const int phys = p.bt[b * p.max_blocks + j];
    float sc = p.kv_scale, sr = p.kv_scale;
    if (QMODE != 0) {  // this block's exponents, exact powers of two
      sc = ldexpf(1.f, p.c_exp[phys]);
      sr = ldexpf(1.f, p.r_exp[phys]);
    }
    for (int t0 = 0; t0 < p.block; t0 += kMlaTile) {
      const int kvt = kv0 + t0;
      if (kvt > qpos_hi) break;
      const int ntok = min(kMlaTile, p.block - t0);
      const size_t tok = static_cast<size_t>(phys) * p.block + t0;
      if (QMODE == 4) {
        mla_load_int4(reinterpret_cast<const int8_t*>(cp) + tok * p.rw, p.rw, ntok, r, c_s, sc,
                      p.vec_c);
        mla_load_int4(reinterpret_cast<const int8_t*>(kp) + tok * p.ropew, p.ropew, ntok, rope,
                      kr_s, sr, p.vec_r);
      } else {
        mla_load<KVT>(cp + tok * p.rw, p.rw, ntok, r, c_s, sc, p.vec_c);
        mla_load<KVT>(kp + tok * p.ropew, p.ropew, ntok, rope, kr_s, sr, p.vec_r);
      }
      __syncthreads();
      // logits and the online-softmax update: warp w owns rows 2w and 2w + 1
      // and all the tile's tokens; each lane keeps 2 x kMlaTile partial sums
      // over its lanes of r and rope (independent FMAs: each q value loaded
      // once, each c_kv value used by both rows), a butterfly reduction leaves
      // the full sums in every lane, and the same warp folds them into its
      // rows' (m, l) and writes p
      if (warp * 2 < nrows) {
        const int ra = warp * 2, rb = min(ra + 1, nrows - 1);
        float sa[kMlaTile], sb[kMlaTile];
#pragma unroll
        for (int t = 0; t < kMlaTile; ++t) sa[t] = sb[t] = 0.f;
        for (int d = lane; d < r; d += 32) {
          const float qa = qc_s[ra * r + d], qb = qc_s[rb * r + d];
#pragma unroll
          for (int t = 0; t < kMlaTile; ++t) {
            const float c = c_s[t * r + d];
            sa[t] = fmaf(qa, c, sa[t]);
            sb[t] = fmaf(qb, c, sb[t]);
          }
        }
        for (int d = lane; d < rope; d += 32) {
          const float qa = qr_s[ra * rope + d], qb = qr_s[rb * rope + d];
#pragma unroll
          for (int t = 0; t < kMlaTile; ++t) {
            const float k = kr_s[t * rope + d];
            sa[t] = fmaf(qa, k, sa[t]);
            sb[t] = fmaf(qb, k, sb[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < kMlaTile; ++t) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            sa[t] += __shfl_xor_sync(0xffffffffu, sa[t], o);
            sb[t] += __shfl_xor_sync(0xffffffffu, sb[t], o);
          }
        }
        mla_row_update(sa, ra, pos0 + (row0 + ra) / p.H, kvt, ntok, p.scale, lane, m_s, l_s,
                       a_s, p_s);
        if (rb != ra)
          mla_row_update(sb, rb, pos0 + (row0 + rb) / p.H, kvt, ntok, p.scale, lane, m_s, l_s,
                         a_s, p_s);
      }
      __syncthreads();
      // acc = alpha * acc + p @ c_kv: column d of the tile in registers, the
      // rows' FMA chains independent of each other
      for (int d = tid; d < r; d += kMlaThreads) {
        float cv[kMlaTile];
#pragma unroll
        for (int t = 0; t < kMlaTile; ++t) cv[t] = t < ntok ? c_s[t * r + d] : 0.f;
#pragma unroll
        for (int rr = 0; rr < kMlaRows; ++rr) {
          if (rr < nrows) {
            const float4* p4 = reinterpret_cast<const float4*>(p_s + rr * kMlaTile);
            float a = acc_s[rr * r + d] * a_s[rr];
#pragma unroll
            for (int t4 = 0; t4 < kMlaTile / 4; ++t4) {
              const float4 pv = p4[t4];
              a = fmaf(pv.x, cv[4 * t4], a);
              a = fmaf(pv.y, cv[4 * t4 + 1], a);
              a = fmaf(pv.z, cv[4 * t4 + 2], a);
              a = fmaf(pv.w, cv[4 * t4 + 3], a);
            }
            acc_s[rr * r + d] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  if (p.n_split == 1) {  // finish in place: out = acc / l
    for (int i = tid; i < nrows * r; i += kMlaThreads) {
      const float l = l_s[i / r];
      out[q_row * r + i] = repro::from_f32<QT>(acc_s[i] / (l == 0.f ? 1.f : l));
    }
    return;
  }
  // split partials in attn_combine's layout (bk = b, K = 1): (b, split, row)
  // for m/l and (b, split, row, d) for acc
  const size_t prow = (static_cast<size_t>(b) * p.n_split + split) * p.TH + row0;
  for (int i = tid; i < nrows * r; i += kMlaThreads) p.ws_acc[prow * r + i] = acc_s[i];
  if (tid < nrows) { p.ws_m[prow + tid] = m_s[tid]; p.ws_l[prow + tid] = l_s[tid]; }
}

size_t mla_smem_bytes(int r, int rope) {
  return sizeof(float) * (static_cast<size_t>(kMlaRows) * (2 * r + rope) +
                          static_cast<size_t>(kMlaTile) * (r + rope) + kMlaRows * kMlaTile +
                          3 * kMlaRows);
}

template <typename QT, typename KVT, int QMODE>
int launch_mla(const void* qe, const void* qr, const void* c, const void* k, void* out,
               const MlaParams& p, cudaStream_t st) {
  const size_t smem = mla_smem_bytes(p.r, p.rope);
  auto kern = mla_partial<QT, KVT, QMODE>;
  static size_t smem_allowed = 48 * 1024;  // per instantiation: raised once, not per launch
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  dim3 grid(p.B, p.n_split, (p.TH + kMlaRows - 1) / kMlaRows);
  kern<<<grid, kMlaThreads, smem, st>>>(static_cast<const QT*>(qe), static_cast<const QT*>(qr),
                                        static_cast<const KVT*>(c), static_cast<const KVT*>(k),
                                        static_cast<QT*>(out), p);
  if (p.n_split > 1) {  // the GQA combine, read as K = 1 KV head of G = H rows, hd = r
    Params cp{};
    cp.ws_m = p.ws_m;
    cp.ws_l = p.ws_l;
    cp.ws_acc = p.ws_acc;
    cp.B = p.B; cp.T = p.T; cp.K = 1; cp.TG = p.TH; cp.G = p.H; cp.hd = p.r;
    cp.n_split = p.n_split;
    dim3 g2(p.B, p.TH);
    attn_combine<QT><<<g2, kThreads, sizeof(float) * p.n_split, st>>>(static_cast<QT*>(out), cp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_mla_kv(int kv_dtype, const void* qe, const void* qr, const void* c, const void* k,
                  void* out, const MlaParams& p, cudaStream_t st) {
  if (kv_dtype == repro::kF32) return launch_mla<QT, float, 0>(qe, qr, c, k, out, p, st);
  if (kv_dtype == repro::kBF16) return launch_mla<QT, __nv_bfloat16, 0>(qe, qr, c, k, out, p, st);
  if (kv_dtype == repro::kI8) return launch_mla<QT, int8_t, 0>(qe, qr, c, k, out, p, st);
  if (kv_dtype == kQ8) return launch_mla<QT, int8_t, 8>(qe, qr, c, k, out, p, st);
  if (kv_dtype == kQ4) return launch_mla<QT, int8_t, 4>(qe, qr, c, k, out, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,T,K,G,hd) f32|bf16; pools (n_blocks, block, K, hd) f32|bf16|int8 (kv_dtype 0|1|2),
// int8 words (3) or (n_blocks, block, K, hd/2) int4 words (4) with k_exp/v_exp
// (n_blocks, K) i32 (null otherwise); bt (B,max_blocks) i32; pos0 (B,) i32; out like q;
// ws_m/ws_l (B*K, n_split, TG) f32 and ws_acc (B*K, n_split, TG, hd) f32 scratch (unused
// when n_split == 1).  Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* bt, const void* pos0, const void* k_exp,
                                      const void* v_exp, void* out, void* ws_m,
                                      void* ws_l, void* ws_acc, int B, int K, int T, int G,
                                      int hd, int block, int max_blocks, int window,
                                      int q_dtype, int kv_dtype, int n_split, float scale,
                                      float cap, float kv_scale, void* stream) {
  const bool quant = kv_dtype == kQ8 || kv_dtype == kQ4;
  if (B < 1 || K < 1 || T < 1 || G < 1 || hd < 1 || block < 1 || max_blocks < 1 ||
      n_split < 1 || (quant && (!k_exp || !v_exp)) || (kv_dtype == kQ4 && hd % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int TG = T * G;
  Params p;
  p.bt = static_cast<const int*>(bt);
  p.pos0 = static_cast<const int*>(pos0);
  p.k_exp = static_cast<const int*>(k_exp);
  p.v_exp = static_cast<const int*>(v_exp);
  p.ws_m = static_cast<float*>(ws_m);
  p.ws_l = static_cast<float*>(ws_l);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.B = B; p.T = T; p.K = K; p.TG = TG; p.G = G; p.hd = hd; p.block = block;
  p.hdw = kv_dtype == kQ4 ? hd / 2 : hd;
  p.max_blocks = max_blocks; p.window = window; p.n_split = n_split;
  p.chunk = (max_blocks + n_split - 1) / n_split;
  const size_t kv_elt = kv_dtype == repro::kF32 ? 4 : kv_dtype == repro::kBF16 ? 2 : 1;
  const size_t q_elt = q_dtype == repro::kF32 ? 4 : 2;
  auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.vec = (p.hdw * kv_elt) % 16 == 0 && (hd * q_elt) % 16 == 0 && al16(q) && al16(k_pool) &&
          al16(v_pool);
  p.scale = scale; p.cap = cap; p.kv_scale = kv_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32) return launch_kv<float>(kv_dtype, q, k_pool, v_pool, out, p, st);
  if (q_dtype == repro::kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, out, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_eff (B,T,H,r) and q_rope (B,T,H,rope) f32|bf16; pools c_kv (n_blocks, block, r) and
// k_rope (n_blocks, block, rope) f32|bf16|int8 (kv_dtype 0|1|2), int8 words (3) or int4
// words with last dims r/2, rope/2 (4), with c_exp/r_exp (n_blocks,) i32 (null otherwise);
// bt (B,max_blocks) i32; pos0 (B,) i32; out like q_eff; ws_m/ws_l (B, n_split, T*H) f32
// and ws_acc (B, n_split, T*H, r) f32 scratch (unused when n_split == 1).
// Returns cudaGetLastError().
extern "C" int paged_attention_mla_launch(const void* q_eff, const void* q_rope,
                                          const void* ckv_pool, const void* krope_pool,
                                          const void* bt, const void* pos0, const void* c_exp,
                                          const void* r_exp, void* out, void* ws_m, void* ws_l,
                                          void* ws_acc, int B, int T, int H, int r, int rope,
                                          int block, int max_blocks, int q_dtype, int kv_dtype,
                                          int n_split, float scale, float kv_scale,
                                          void* stream) {
  const bool quant = kv_dtype == kQ8 || kv_dtype == kQ4;
  if (B < 1 || T < 1 || H < 1 || r < 1 || rope < 1 || block < 1 || max_blocks < 1 ||
      n_split < 1 || (quant && (!c_exp || !r_exp)) ||
      (kv_dtype == kQ4 && (r % 2 || rope % 2)) ||
      (n_split > 1 && (!ws_m || !ws_l || !ws_acc)) || mla_smem_bytes(r, rope) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  MlaParams p;
  p.bt = static_cast<const int*>(bt);
  p.pos0 = static_cast<const int*>(pos0);
  p.c_exp = static_cast<const int*>(c_exp);
  p.r_exp = static_cast<const int*>(r_exp);
  p.ws_m = static_cast<float*>(ws_m);
  p.ws_l = static_cast<float*>(ws_l);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.B = B; p.T = T; p.H = H; p.TH = T * H; p.r = r; p.rope = rope;
  p.rw = kv_dtype == kQ4 ? r / 2 : r;
  p.ropew = kv_dtype == kQ4 ? rope / 2 : rope;
  p.block = block; p.max_blocks = max_blocks; p.n_split = n_split;
  p.chunk = (max_blocks + n_split - 1) / n_split;
  const size_t kv_elt = kv_dtype == repro::kF32 ? 4 : kv_dtype == repro::kBF16 ? 2 : 1;
  const size_t q_elt = q_dtype == repro::kF32 ? 4 : 2;
  auto al16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.vec_q = (r * q_elt) % 16 == 0 && (rope * q_elt) % 16 == 0 && al16(q_eff) && al16(q_rope);
  // int4 rows: 16 words (32 lanes) a load; other pools: 16 / kv_elt lanes a load
  p.vec_c = (p.rw * kv_elt) % 16 == 0 && al16(ckv_pool);
  p.vec_r = (p.ropew * kv_elt) % 16 == 0 && al16(krope_pool);
  p.scale = scale; p.kv_scale = kv_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return launch_mla_kv<float>(kv_dtype, q_eff, q_rope, ckv_pool, krope_pool, out, p, st);
  if (q_dtype == repro::kBF16)
    return launch_mla_kv<__nv_bfloat16>(kv_dtype, q_eff, q_rope, ckv_pool, krope_pool, out, p,
                                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}
