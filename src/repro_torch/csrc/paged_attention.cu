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
