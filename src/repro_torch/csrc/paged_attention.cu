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
//   hd a multiple of 8, at most 256.
//
// On the TPU the grid walks the row's blocks j in order and carries
// (m, l, acc) in scratch across grid steps.  Here every warp walks its own
// tiles (a KV block, or 16 tokens of a longer one) with its own (m, l, acc)
// in registers, and the partials are merged once at the end.
//
// What bounds it on the H100: the bytes of the KV tiles a row can see
// (decode: 2 x tokens x hd x 2 bytes per (row, KV head) in bf16, a quarter
// of that in int4), ~1 FMA per loaded element.  At decode that is 0.8-5 MB
// a call, 0.2-1.5 us at 3.35 TB/s, so what sets the time is the chain of
// round trips (pos0 -> block table -> KV tile -> compute -> merge) and how
// many bytes are in flight at once, not the bandwidth.  Design:
//   * grid (split, b * K + kh, row tile); the splits of one (b, kh, row tile)
//     form a thread-block cluster of 1, 2, 4 or 8 (the wrapper's `_n_split`,
//     from B * K and the row tiles, with max_blocks only as an upper bound);
//   * each thread block reads pos0[b] and derives the row tile's visible tile
//     range on the device: tiles past the tile's last query position, and
//     tiles wholly outside every row's window, are skipped (their masked
//     logits would contribute p = 0 and alpha = 1 exactly, so skipping
//     changes no bit of the math); the range, not max_blocks, is cut into
//     split x 4 contiguous pieces, one per warp, and a warp with no tile does
//     no loads;
//   * a warp copies its tiles' raw pool words (f32, bf16, int8 or int4 bytes)
//     into its own 2-stage shared-memory ring with 16-byte `cp.async` (4-byte
//     copies where a row is not a multiple of 16 bytes), the next tile in
//     flight while it computes on this one; the block-table entries of up to
//     32 tiles are read at once, one per lane;
//   * the 1, 2 or 4 query rows of a row tile stay in registers, lanes over
//     the head dimension (4 or 8 dims a lane); words are dequantized in
//     registers (bf16: a shift; int8 / int4: `prmt` / `lop3` into the
//     mantissa of 2^23 and one subtract) and the tile's 2^e (or kv_scale)
//     is folded into the logit and into p, both exact powers of two;
//   * q.k: each lane forms its partial dot products for the tile's 16 tokens,
//     and a transposing butterfly (8 + 4 + 2 + 1 + 1 shuffles a row) leaves
//     token lane/2's full logit in lanes 2t and 2t + 1; the online softmax is
//     warp-parallel (shuffle max and sum over the 16 tokens); p . v takes p
//     of token t from lane 2t by shuffle;
//   * the merge: each warp's (m, l, acc) into shared memory, the 4 warps
//     merged in warp order, then the cluster's thread blocks merged in rank
//     order through distributed shared memory (each rank finishes a slice of
//     the outputs), M = max m_s, L = sum l_s e^(m_s-M), O = sum acc_s
//     e^(m_s-M) / L: one launch, no global workspace, no atomics, the same
//     bits on every call.
// All math is fp32 (expf, tanhf); the output is rounded to q's dtype once.
// Tensor cores are not used: at decode a KV head has 1-2 query rows (up to
// 8 in verify), far below an mma tile's 16.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using repro::bf16x2_bits;
using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::cp_async_z;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::nibbles_bf16x2;
using repro::split_bf16x2;

constexpr float kNegInf = -1e30f;
constexpr int kQ8 = 3;  // pool codes beyond common.cuh's: int8 words + exponents
constexpr int kQ4 = 4;  // int4 split-halves words + exponents
constexpr unsigned kFull = 0xffffffffu;

constexpr int kTile = 16;          // KV tokens a warp takes at a time
constexpr int kWarps = 4;          // warps per thread block, each with its own tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;       // thread blocks per cluster (the portable maximum)

struct GqaParams {
  const int* bt;
  const int* pos0;
  const int* k_exp;  // (n_blocks, K) exponents of quantized pools, else null
  const int* v_exp;
  int B, T, K, G, TG, hd, block, max_blocks, window, n_split;
  int tpb;        // tiles per block: ceil(block / kTile)
  int row_bytes;  // bytes of one token's words of one KV head
  int pitch;      // row_bytes rounded up to 16: a row of the shared-memory ring
  int chunk;      // bytes per copy into the ring: 16 or 4 (cp.async), 1 (plain loads)
  int stages;     // ring stages per warp (1 or 2)
  float scale, cap, kv_scale;
};

// The head dimension a lane's slot i stands for.  int4 rows: the lane's
// DPL/2 words give DPL/2 low-nibble dims and, hd/2 further on, DPL/2
// high-nibble ones; other pools: DPL consecutive dims.
template <int MODE, int DPL>
__device__ __forceinline__ int dim_of(int lane, int i, int hd) {
  if (MODE == 4) return i < DPL / 2 ? lane * (DPL / 2) + i : hd / 2 + lane * (DPL / 2) + i - DPL / 2;
  return lane * DPL + i;
}

// A lane's DPL values of one ring row, in word units (unscaled).
template <int MODE, int DPL>
__device__ __forceinline__ void row_values(const uint8_t* row, int lane, float (&v)[DPL]) {
  if constexpr (MODE == 0) {
    const float4* p = reinterpret_cast<const float4*>(row) + lane * (DPL / 4);
#pragma unroll
    for (int j = 0; j < DPL / 4; ++j) {
      const float4 x = p[j];
      v[4 * j] = x.x; v[4 * j + 1] = x.y; v[4 * j + 2] = x.z; v[4 * j + 3] = x.w;
    }
  } else if constexpr (MODE == 1) {
    uint32_t w[DPL / 2];
    if constexpr (DPL == 4) {
      const uint2 x = reinterpret_cast<const uint2*>(row)[lane];
      w[0] = x.x; w[1] = x.y;
    } else {
      const uint4 x = reinterpret_cast<const uint4*>(row)[lane];
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    }
#pragma unroll
    for (int j = 0; j < DPL / 2; ++j) {  // bf16 -> f32: the bits in the high half
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else if constexpr (MODE == 4) {
    const uint32_t w = DPL == 4 ? reinterpret_cast<const uint16_t*>(row)[lane]
                                : reinterpret_cast<const uint32_t*>(row)[lane];
    const uint32_t t = w ^ 0x88888888u;  // each nibble x -> x + 8 in [0, 15]
#pragma unroll
    for (int j = 0; j < DPL / 2; ++j) {  // 2^23 + (x + 8), less 2^23 + 8: x exactly
      v[j] = __uint_as_float(0x4b000000u | ((t >> (8 * j)) & 15u)) - 8388616.f;
      v[DPL / 2 + j] = __uint_as_float(0x4b000000u | ((t >> (8 * j + 4)) & 15u)) - 8388616.f;
    }
  } else {  // int8 words
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + lane * (DPL / 4);
#pragma unroll
    for (int j = 0; j < DPL / 4; ++j) {
      const uint32_t t = p[j] ^ 0x80808080u;  // each byte x -> x + 128
#pragma unroll
      for (int i = 0; i < 4; ++i)  // byte i into the low byte of 2^23's bits
        v[4 * j + i] = __uint_as_float(__byte_perm(t, 0x4b000000u, 0x7440 + i)) - 8388736.f;
    }
  }
}

// v[r][0..15], one value per token in every lane -> lanes 2t and 2t + 1 hold
// token t's sum over the 32 lanes.  Each step keeps half of the values (the
// half the lane's bit selects) and adds the partner lane's copy of them.
template <int RT>
__device__ __forceinline__ void reduce_tokens(float (&v)[RT][kTile], float (&s)[RT], int lane) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float a[8], b[4], c[2];
    bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = up ? v[r][i] : v[r][8 + i];
      a[i] = (up ? v[r][8 + i] : v[r][i]) + __shfl_xor_sync(kFull, send, 16);
    }
    up = lane & 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up ? a[i] : a[4 + i];
      b[i] = (up ? a[4 + i] : a[i]) + __shfl_xor_sync(kFull, send, 8);
    }
    up = lane & 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? b[i] : b[2 + i];
      c[i] = (up ? b[2 + i] : b[i]) + __shfl_xor_sync(kFull, send, 4);
    }
    up = lane & 2;
    const float d = (up ? c[1] : c[0]) + __shfl_xor_sync(kFull, up ? c[0] : c[1], 2);
    s[r] = d + __shfl_xor_sync(kFull, d, 1);
  }
}

// max / sum over the 16 tokens (lanes 2t and 2t + 1 hold the same value)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 16; o > 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 16; o > 1; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// QT: query / output type; MODE: the pool code (0 f32, 1 bf16, 2 int8 KV_F x
// kv_scale, 3 int8 words and 4 int4 words x 2^e per (block, head)); RT: query
// rows per thread block (1, 2 or 4); DPL: head dims a lane holds (4: hd <= 128,
// 8: hd <= 256)
template <typename QT, int MODE, int RT, int DPL>
__global__ void __launch_bounds__(kThreads)
gqa_decode(const QT* __restrict__ q, const uint8_t* __restrict__ kp,
           const uint8_t* __restrict__ vp, QT* __restrict__ out, GqaParams p) {
  extern __shared__ __align__(16) uint8_t gqa_smem[];
  namespace cg = cooperative_groups;
  const int hd = p.hd, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bk = blockIdx.y, b = bk / p.K, kh = bk - b * p.K;
  const int row0 = blockIdx.z * RT, nrows = min(RT, p.TG - row0);
  const int split = blockIdx.x;  // the cluster spans grid.x: its rank
  const bool lane_ok = lane * DPL < hd;

  // the tile's query rows (row r = t * G + g) in registers, lanes over dims
  const size_t q_stride = static_cast<size_t>(p.K) * p.G * hd;  // one t further
  const size_t q_base = (static_cast<size_t>(b) * p.T * p.K + kh) * p.G * hd;
  float qv[RT][DPL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int rr = row0 + min(r, nrows - 1);
    const QT* qr = q + q_base + (rr / p.G) * q_stride + (rr % p.G) * hd;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      qv[r][i] = lane_ok && r < nrows ? repro::to_f32(qr[dim_of<MODE, DPL>(lane, i, hd)]) : 0.f;
  }

  // the row tile's visible tiles, from pos0 on the device
  const int pos0 = p.pos0[b];
  int qpos[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) qpos[r] = pos0 + (row0 + min(r, nrows - 1)) / p.G;
  const int n_tok = p.max_blocks * p.block;
  const int hi_tok = min(qpos[RT - 1], n_tok - 1);  // last key any row may see
  const int lo_tok = max(0, qpos[0] - p.window + 1);  // first key inside any row's window
  int u_lo = 0, u_hi = 0;  // [u_lo, u_hi): tile u is block u / tpb, tokens (u % tpb) * 16..
  if (lo_tok <= hi_tok) {
    u_lo = (lo_tok / p.block) * p.tpb + (lo_tok % p.block) / kTile;
    u_hi = (hi_tok / p.block) * p.tpb + (hi_tok % p.block) / kTile + 1;
  }
  const int n_workers = p.n_split * kWarps, w = split * kWarps + warp, n = u_hi - u_lo;
  const int u0 = u_lo + static_cast<int>(static_cast<long long>(w) * n / n_workers);
  const int u1 = u_lo + static_cast<int>(static_cast<long long>(w + 1) * n / n_workers);

  // this warp's ring: stages x (K rows, V rows, the two exponents)
  const int stage_bytes = 2 * kTile * p.pitch + 16;
  uint8_t* ring = gqa_smem + static_cast<size_t>(warp) * p.stages * stage_bytes;
  const size_t g_row = static_cast<size_t>(p.K) * p.row_bytes;  // one token further in a pool
  int bt_base = u0 - 32, bt_lane = 0;  // lane l holds the block id of tile bt_base + l
  auto issue = [&](int u, int s) {
    if (u - bt_base >= 32) {
      bt_base = u;
      const int uu = u + lane;
      bt_lane = uu < u1 ? p.bt[static_cast<size_t>(b) * p.max_blocks + uu / p.tpb] : 0;
    }
    const int phys = __shfl_sync(kFull, bt_lane, u - bt_base);
    const int j = u / p.tpb, tok0 = (u - j * p.tpb) * kTile, ntok = min(kTile, p.block - tok0);
    const size_t off = ((static_cast<size_t>(phys) * p.block + tok0) * p.K + kh) * p.row_bytes;
    uint8_t* dk = ring + s * stage_bytes;
    uint8_t* dv = dk + kTile * p.pitch;
    const int per_row = p.row_bytes / p.chunk, n_chunks = ntok * per_row;
    for (int c = lane; c < n_chunks; c += 32) {
      const int t = c / per_row, o = (c - t * per_row) * p.chunk;
      const size_t src = off + t * g_row + o;
      if (p.chunk == 1) {
        dk[t * p.pitch + o] = kp[src];
        dv[t * p.pitch + o] = vp[src];
      } else {
        cp_async(dk + t * p.pitch + o, kp + src, p.chunk);
        cp_async(dv + t * p.pitch + o, vp + src, p.chunk);
      }
    }
    if (MODE >= kQ8 && lane == 0) {
      int* de = reinterpret_cast<int*>(dv + kTile * p.pitch);
      const size_t ei = static_cast<size_t>(phys) * p.K + kh;
      cp_async(de, p.k_exp + ei, 4);
      cp_async(de + 1, p.v_exp + ei, 4);
    }
  };

  float m[RT], l[RT], acc[RT][DPL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  for (int k = 0; k + 1 < p.stages; ++k) {
    if (u0 + k < u1) issue(u0 + k, k);
    cp_async_commit();
  }
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0, s = i % p.stages;
    if (u + p.stages - 1 < u1) issue(u + p.stages - 1, (i + p.stages - 1) % p.stages);
    cp_async_commit();
    if (p.stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();
    const uint8_t* ks = ring + s * stage_bytes;
    const uint8_t* vs = ks + kTile * p.pitch;
    const int j = u / p.tpb, tok0 = (u - j * p.tpb) * kTile, ntok = min(kTile, p.block - tok0);
    const int kv0 = j * p.block + tok0;
    float sk = p.kv_scale, sv = p.kv_scale;
    if (MODE >= kQ8) {  // this (block, head)'s exponents, exact powers of two
      const int* e = reinterpret_cast<const int*>(vs + kTile * p.pitch);
      sk = ldexpf(1.f, e[0]);
      sv = ldexpf(1.f, e[1]);
    }
    // q.k: partial dot products over the lane's dims, then the butterfly
    float part[RT][kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      float kv[DPL];
      if (t < ntok && lane_ok) {
        row_values<MODE, DPL>(ks + t * p.pitch, lane, kv);
      } else {
#pragma unroll
        for (int d = 0; d < DPL; ++d) kv[d] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float a = qv[r][0] * kv[0];
#pragma unroll
        for (int d = 1; d < DPL; ++d) a = fmaf(qv[r][d], kv[d], a);
        part[r][t] = a;
      }
    }
    float sc[RT];
    reduce_tokens<RT>(part, sc, lane);
    // online softmax, lanes over tokens (token lane / 2)
    const int t = lane >> 1, kvp = kv0 + t;
    float pv[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const bool ok = t < ntok && kvp <= qpos[r] && qpos[r] - kvp < p.window;
      float x = sc[r] * (p.scale * sk);
      if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[r], max16(x));
      const float alpha = expf(m[r] - m_new);
      const float e = ok ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + sum16(e);
      m[r] = m_new;
      pv[r] = e * sv;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
    }
    // p . v: token t's p from lane 2t
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < ntok) {
        float vv[DPL];
        if (lane_ok) {
          row_values<MODE, DPL>(vs + tt * p.pitch, lane, vv);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) vv[d] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float pt = __shfl_sync(kFull, pv[r], 2 * tt);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(pt, vv[d], acc[r][d]);
        }
      }
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
  }
  cp_async_wait<0>();

  // merge: the warps' partials in shared memory, in warp order
  float* part_acc = reinterpret_cast<float*>(gqa_smem + static_cast<size_t>(kWarps) * p.stages *
                                                        stage_bytes);  // [kWarps][RT][hd]
  float* part_m = part_acc + kWarps * RT * hd;                        // [kWarps][RT]
  float* part_l = part_m + kWarps * RT;
  float* blk_acc = part_l + kWarps * RT;                              // [RT][hd]
  float* blk_m = blk_acc + RT * hd;                                   // [RT]
  float* blk_l = blk_m + RT;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (lane_ok) {
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        part_acc[(warp * RT + r) * hd + dim_of<MODE, DPL>(lane, d, hd)] = acc[r][d];
    }
    if (lane == 0) {
      part_m[warp * RT + r] = m[r];
      part_l[warp * RT + r] = l[r];
    }
  }
  __syncthreads();
  const int n_items = nrows * hd;
  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    const int r = it / hd, d = it - r * hd;
    float M = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) M = fmaxf(M, part_m[ww * RT + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = expf(part_m[ww * RT + r] - M);
      L += part_l[ww * RT + r] * f;
      O += part_acc[(ww * RT + r) * hd + d] * f;
    }
    if (p.n_split == 1) {
      const int rr = row0 + r;
      out[q_base + (rr / p.G) * q_stride + (rr % p.G) * hd + d] =
          repro::from_f32<QT>(O / (L == 0.f ? 1.f : L));
    } else {
      blk_acc[it] = O;
      if (d == 0) { blk_m[r] = M; blk_l[r] = L; }
    }
  }
  if (p.n_split == 1) return;
  // the cluster's thread blocks, in rank order; rank c writes outputs
  // [c * n_items / S, (c + 1) * n_items / S)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = p.n_split;
  const int lo = split * n_items / S, hi = (split + 1) * n_items / S;
  for (int it = lo + threadIdx.x; it < hi; it += kThreads) {
    const int r = it / hd, rr = row0 + r;
    float M = kNegInf;
    for (int c = 0; c < S; ++c) M = fmaxf(M, cluster.map_shared_rank(blk_m, c)[r]);
    float L = 0.f, O = 0.f;
    for (int c = 0; c < S; ++c) {
      const float f = expf(cluster.map_shared_rank(blk_m, c)[r] - M);
      L += cluster.map_shared_rank(blk_l, c)[r] * f;
      O += cluster.map_shared_rank(blk_acc, c)[it] * f;
    }
    out[q_base + (rr / p.G) * q_stride + (rr % p.G) * hd + (it - r * hd)] =
        repro::from_f32<QT>(O / (L == 0.f ? 1.f : L));
  }
  cluster.sync();  // every block's partials stay until the others have read them
}

size_t gqa_smem_bytes(const GqaParams& p, int rt) {
  return static_cast<size_t>(kWarps) * p.stages * (2 * kTile * p.pitch + 16) +
         sizeof(float) * (static_cast<size_t>(kWarps + 1) * rt * (p.hd + 2));
}

template <typename QT, int MODE, int RT, int DPL>
int launch_gqa(const void* q, const void* k, const void* v, void* out, const GqaParams& p,
               cudaStream_t st) {
  auto kern = gqa_decode<QT, MODE, RT, DPL>;
  const size_t smem = gqa_smem_bytes(p, RT);
  static size_t smem_allowed = 48 * 1024;  // per instantiation: raised once, not per launch
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(p.n_split, p.B * p.K, (p.TG + RT - 1) / RT);
  const auto* qp = static_cast<const QT*>(q);
  const auto* kp = static_cast<const uint8_t*>(k);
  const auto* vp = static_cast<const uint8_t*>(v);
  auto* op = static_cast<QT*>(out);
  if (p.n_split == 1) {
    kern<<<grid, kThreads, smem, st>>>(qp, kp, vp, op, p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = grid;
  lc.blockDim = dim3(kThreads, 1, 1);
  lc.dynamicSmemBytes = smem;
  lc.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;  // one cluster per (b, kh, row tile)
  cluster[0].val.clusterDim.x = p.n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  lc.attrs = cluster;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, kern, qp, kp, vp, op, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int MODE, int DPL>
int launch_gqa_rows(const void* q, const void* k, const void* v, void* out, const GqaParams& p,
                    cudaStream_t st) {
  if (p.TG == 1) return launch_gqa<QT, MODE, 1, DPL>(q, k, v, out, p, st);
  if (p.TG == 2) return launch_gqa<QT, MODE, 2, DPL>(q, k, v, out, p, st);
  return launch_gqa<QT, MODE, 4, DPL>(q, k, v, out, p, st);
}

template <typename QT, int MODE>
int launch_gqa_dims(const void* q, const void* k, const void* v, void* out, const GqaParams& p,
                    cudaStream_t st) {
  if (p.hd <= 128) return launch_gqa_rows<QT, MODE, 4>(q, k, v, out, p, st);
  return launch_gqa_rows<QT, MODE, 8>(q, k, v, out, p, st);
}

template <typename QT>
int launch_gqa_pool(int kv_dtype, const void* q, const void* k, const void* v, void* out,
                    const GqaParams& p, cudaStream_t st) {
  if (kv_dtype == repro::kF32) return launch_gqa_dims<QT, 0>(q, k, v, out, p, st);
  if (kv_dtype == repro::kBF16) return launch_gqa_dims<QT, 1>(q, k, v, out, p, st);
  if (kv_dtype == repro::kI8) return launch_gqa_dims<QT, 2>(q, k, v, out, p, st);
  if (kv_dtype == kQ8) return launch_gqa_dims<QT, kQ8>(q, k, v, out, p, st);
  if (kv_dtype == kQ4) return launch_gqa_dims<QT, kQ4>(q, k, v, out, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The split-KV combine of the MLA kernel: (m, l, acc) partials of n_split
// thread blocks per (bk, row) in a global workspace, merged by a second
// launch.  Read with K = 1 KV head of G = H rows and hd = r.
struct Params {
  float* ws_m;
  float* ws_l;
  float* ws_acc;
  int T, K, TG, G, hd, n_split;
};
constexpr int kCombineThreads = 128;

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

constexpr int kLoads = 4;  // 16-byte loads in flight per thread (MLA tile loads)

// the two sign-extended nibbles of an int4 split-halves word
__device__ __forceinline__ float lo_nibble(int8_t w) {
  return static_cast<float>(static_cast<int>((static_cast<uint8_t>(w) & 15u) ^ 8u) - 8);
}
__device__ __forceinline__ float hi_nibble(int8_t w) {
  return static_cast<float>(static_cast<int>((static_cast<uint8_t>(w) >> 4) ^ 8u) - 8);
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
// is rounded to q's dtype once.  Since the tensor-core kernel below
// (mla_decode_tc) takes bf16 queries over pools exact in bf16, this kernel
// serves fp32 queries (the parity runs), fp32 pools and widths the
// tensor-core tiles do not take (ops.py `_mla_route`).
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
    cp.T = p.T; cp.K = 1; cp.TG = p.TH; cp.G = p.H; cp.hd = p.r;
    cp.n_split = p.n_split;
    dim3 g2(p.B, p.TH);
    attn_combine<QT><<<g2, kCombineThreads, sizeof(float) * p.n_split, st>>>(static_cast<QT*>(out), cp);
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

// ---------------------------------------------------------------------------
// mla_decode_tc: the absorbed MLA decode on the tensor cores, for bf16
// queries over pools whose values are exact in bf16.
//
// Replaces the same TPU kernels as mla_partial (`_mla_kernel`,
// `_mla_kernel_quant`) on the serving path; the contract is
// paged_attention_mla's, with bf16 q_eff / q_rope / out.
//
// What bounds it on the H100: latency.  At deepseek-v3's decode shape (B 4,
// H 128, r 512, rope 64, ~300 tokens a row) a call moves 2.5 MB and does
// 0.33 GFLOP, under 1 us of either bound; what costs is the chain pos0 ->
// block table -> KV tile -> products -> merge, and how many of those chains
// run at once.  The 128 heads of a batch row share one latent KV stream, so
// the work is a (heads x (r + rope)) . ((r + rope) x tokens) product, a
// softmax, and a (heads x tokens) . (tokens x r) product: tensor-core shapes.
// Design:
//   * one thread block per (KV split, tile of 32 query rows, batch row);
//     the splits of one (row tile, b) form a thread-block cluster of up to 8
//     (the wrapper's `_mla_tc_split`: blocks for at most 3/4 of the SMs, so
//     that every cluster is resident at once, one block an SM; deepseek's
//     B 4 takes 6).  32 rows, not 64: the (rows, r) fp32 accumulator is 64
//     registers a thread over 8 warps, <= 128 in all, so two blocks may
//     share an SM where the grid is larger; each KV byte is read from L2
//     by 4 row tiles of a 128-head row instead of 8;
//   * pos0, the row's block table and the row tile's queries are read at
//     once (the table and queries by `cp.async` into shared memory); the
//     block cuts the tile's visible tiles (a KV block, or 16 tokens of a
//     longer one; tiles past the tile's last query position are skipped,
//     which is exact: p = 0, alpha = 1) into contiguous shares, one per
//     rank, balanced to one tile;
//   * the share's tiles are copied by 16-byte `cp.async` (16 threads a
//     token row, no divisions) into a ring of 3 stages; a bf16 pool's rows
//     land as the bf16 tile itself, pool words (KV_F int8 x kv_scale, SYMOG
//     int8 / int4 x 2^e) are converted once per tile into a bf16 tile
//     [tokens][r + rope] -- exact: a word needs at most 8 significant bits
//     and every scale is a power of two (int4: one `lop3` and one bf16x2
//     FMA a pair of words);
//   * `mma.sync.m16n8k16` bf16, fp32 accumulators: warp (row group rg,
//     column group cg) forms its 16 rows' logits over every 4th k-step of
//     r + rope (queries and keys by `ldmatrix`); the 4 warps of a row group
//     add their partial logits through shared memory in a fixed order, and
//     each runs the same online softmax (base 2) on the sums; p . c_kv
//     takes every 4th 16-column pair of r, with V = the same bf16 tile read
//     by `ldmatrix.trans` (the value is c_kv itself);
//   * p in two bf16 parts, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
//     products: rounding p to bf16 alone misses the bf16 bar on wide SYMOG
//     spreads (|out| up to ~400), the pair keeps p to ~16 bits;
//   * one launch, no workspace: each rank leaves its (m, l, acc) in shared
//     memory; after a cluster barrier rank c finishes its share of the
//     (row, 4-column) items, reading every rank's partial by DSMEM (16-byte
//     loads, the (m, l) of every rank staged once) and adding them in rank
//     order: the same bits on every call.  The exchange (the other ranks'
//     share of a 32 x r fp32 tile, over DSMEM) is the largest fixed cost
//     left; storing the partials into their owners' memory instead (8-byte
//     remote stores) was slower.
constexpr int kTcRows = 32;       // query rows per thread block (ops.py MLA_TC_ROWS)
constexpr int kTcWarps = 8;       // 2 row groups of 16 rows x 4 column groups
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcStages = 3;      // KV tiles in flight a thread block (two blocks an SM)
constexpr int kTcMaxDepth = 576;  // r + rope: 36 k-steps of 16, 9 a warp
constexpr int kTcMaxRank = 512;   // r: 32 column pairs of 16, 8 a warp
constexpr int kTcKs = kTcMaxDepth / 16 / 4;
constexpr int kTcPairs = kTcMaxRank / 16 / 4;
constexpr int kTcTable = 256;     // block-table entries read ahead (later ones: one load a tile)

struct MlaTcParams {
  const int* bt;
  const int* pos0;
  const int* c_exp;  // (n_blocks,) exponents of SYMOG pools, else null
  const int* r_exp;
  int TH, H, r, rope, block, max_blocks, tpb, n_split;
  int cbytes, rbytes;  // bytes of one token's c_kv / k_rope words in the pools
  int cpitch, pitch;   // stage row: c_kv words at 0, k_rope words at cpitch; row stride
  int tpitch;          // row stride of a bf16 tile: 2 (r + rope) + 16 (ldmatrix banks)
  int chunk, qchunk;   // bytes per cp.async of pool rows / query rows: 16, 8 or 4
  int stage_bytes;     // 16 rows + 16 bytes of exponents
  int region;          // bytes of queries + ring (+ converted tile), or of the merge's tile
  float scale, kv_scale;
};

// A stage's pool words -> the bf16 tile [16 tokens][r + rope], each value
// word * scale (exact); token rows past ntok are zeros.
template <int MODE>
__device__ __forceinline__ void mla_tc_convert(const uint8_t* st, uint8_t* tile, int ntok,
                                               const MlaTcParams& p) {
  float sc = p.kv_scale, sr = p.kv_scale;
  if (MODE >= kQ8) {  // this block's exponents, exact powers of two
    const int* e = reinterpret_cast<const int*>(st + kMlaTile * p.pitch);
    sc = ldexpf(1.f, e[0]);
    sr = ldexpf(1.f, e[1]);
  }
  // int4: the scale pairs (2^e, 2^e) and -136 * (2^e, 2^e) of each part as bf16x2
  const uint32_t sc2 = bf16x2_bits(sc, sc), sr2 = bf16x2_bits(sr, sr);
  const uint32_t cc2 = bf16x2_bits(-136.f * sc, -136.f * sc);
  const uint32_t cr2 = bf16x2_bits(-136.f * sr, -136.f * sr);
  // 16 threads a token row, chunks of 8 dims (one 16-byte store) ck, ck + 16, ..
  const int r = p.r, t = threadIdx.x >> 4, nch = (r + p.rope) / 8;
#pragma unroll
  for (int k = 0; k < (kTcMaxDepth / 8 + 15) / 16; ++k) {
    const int ch = (threadIdx.x & 15) + 16 * k, d0 = ch * 8;
    if (ch >= nch) break;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (t < ntok) {
      const bool cpart = d0 < r;
      const int dd = cpart ? d0 : d0 - r;
      const uint8_t* row = st + t * p.pitch + (cpart ? 0 : p.cpitch);
      if (MODE == kQ4) {  // dims dd..dd+7: low nibbles of words dd.., or high ones of dd - w/2..
        const int hw = (cpart ? r : p.rope) / 2;
        const bool hi = dd >= hw;
        uint2 x = *reinterpret_cast<const uint2*>(row + (hi ? dd - hw : dd));
        if (hi) {
          x.x >>= 4;
          x.y >>= 4;
        }
        const uint32_t s2 = cpart ? sc2 : sr2, c2 = cpart ? cc2 : cr2;
        // words 2i and 2i + 1 into the two halves, then their fields
        o.x = nibbles_bf16x2(__byte_perm(x.x, 0u, 0x4140), s2, c2);
        o.y = nibbles_bf16x2(__byte_perm(x.x, 0u, 0x4342), s2, c2);
        o.z = nibbles_bf16x2(__byte_perm(x.y, 0u, 0x4140), s2, c2);
        o.w = nibbles_bf16x2(__byte_perm(x.y, 0u, 0x4342), s2, c2);
      } else {  // int8 words to exact floats by the mantissa of 2^23 (as gqa_decode's row_values)
        const float s = cpart ? sc : sr;
        const uint2 x = *reinterpret_cast<const uint2*>(row + dd);
        const uint32_t w[2] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u};  // byte f -> f + 128
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4b000000u, 0x7440 + (i & 3))) -
                 8388736.f;
        o.x = bf16x2_bits(v[0] * s, v[1] * s);
        o.y = bf16x2_bits(v[2] * s, v[3] * s);
        o.z = bf16x2_bits(v[4] * s, v[5] * s);
        o.w = bf16x2_bits(v[6] * s, v[7] * s);
      }
    }
    *reinterpret_cast<uint4*>(tile + t * p.tpitch + d0 * 2) = o;
  }
}

// MODE: the pool code, 1 bf16 (its rows are the tile), 2 int8 x kv_scale
// (KV_F), 3 int8 words and 4 int4 words x 2^e per physical block
template <int MODE>
__global__ void __launch_bounds__(kTcThreads, 2)
mla_decode_tc(const __nv_bfloat16* __restrict__ q_eff, const __nv_bfloat16* __restrict__ q_rope,
              const uint8_t* __restrict__ cp, const uint8_t* __restrict__ kp,
              __nv_bfloat16* __restrict__ out, MlaTcParams p) {
  constexpr bool kDirect = MODE == repro::kBF16;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 2, cgp = warp & 3;  // row group (16 rows), column group
  const int g = lane >> 2, t4 = lane & 3;    // mma fragment row / column pair
  const int split = blockIdx.x, row0 = blockIdx.y * kTcRows, b = blockIdx.z;
  const int S = p.n_split, r = p.r, rope = p.rope;
  const int nrows = min(kTcRows, p.TH - row0);
  const int n_ks = (r + rope) / 16, n_pairs = r / 16;

  uint8_t* q_s = tc_smem;  // [kTcRows][r + rope] bf16, rows tpitch apart
  uint8_t* ring = q_s + kTcRows * p.tpitch;
  uint8_t* ctile = ring + static_cast<size_t>(kTcStages) * p.stage_bytes;  // word pools
  float* sred = reinterpret_cast<float*>(tc_smem + p.region);  // [2][4][8][32] partial logits
  float* part_ml = sred + 2 * 4 * 8 * 32;       // this rank's m, l: [2][kTcRows]
  float* ml_s = part_ml + 2 * kTcRows;          // every rank's: [kMaxSplit][2][kTcRows]
  int* bt_s = reinterpret_cast<int*>(ml_s + kMaxSplit * 2 * kTcRows);  // [kTcTable]

  // pos0, the batch row's block table (its first kTcTable entries) and the
  // tile's query rows [q_eff | q_rope] (rows past T*H zero-filled) are read
  // at once: the table and the queries in two copy groups
  const int pos0 = __ldg(p.pos0 + b);
  const int n_tab = min(p.max_blocks, kTcTable);
  for (int j = tid; j < n_tab; j += kTcThreads)
    cp_async(bt_s + j, p.bt + static_cast<size_t>(b) * p.max_blocks + j, 4);
  cp_async_commit();
  {  // 8 threads a query row
    const int row = tid >> 3, qb = row < nrows ? p.qchunk : 0;
    const size_t qrow = static_cast<size_t>(b) * p.TH + row0 + min(row, nrows - 1);
    const uint8_t* se = reinterpret_cast<const uint8_t*>(q_eff + qrow * r);
    const uint8_t* sr = reinterpret_cast<const uint8_t*>(q_rope + qrow * rope);
    uint8_t* dst = q_s + row * p.tpitch;
    for (int o = (tid & 7) * p.qchunk; o < 2 * r; o += 8 * p.qchunk)
      cp_async_z(dst + o, se + o, p.qchunk, qb);
    for (int o = (tid & 7) * p.qchunk; o < 2 * rope; o += 8 * p.qchunk)
      cp_async_z(dst + 2 * r + o, sr + o, p.qchunk, qb);
  }
  cp_async_commit();

  // the row tile's visible tiles from pos0 on the device, this rank's share
  const int ra = row0 + rg * 16 + g, rb = ra + 8;  // this lane's two query rows
  const int qpos[2] = {ra < p.TH ? pos0 + ra / p.H : -1, rb < p.TH ? pos0 + rb / p.H : -1};
  const int hi_tok = min(pos0 + (row0 + nrows - 1) / p.H, p.max_blocks * p.block - 1);
  const int n_u = hi_tok < 0 ? 0 : (hi_tok / p.block) * p.tpb + (hi_tok % p.block) / kMlaTile + 1;
  const int u0 = static_cast<int>(static_cast<long long>(split) * n_u / S);
  const int u1 = static_cast<int>(static_cast<long long>(split + 1) * n_u / S);
  const int n = u1 - u0;

  cp_async_wait<1>();  // the table (the queries may still be in flight)
  __syncthreads();
  // 16 threads a token row of a tile: thread (ct, ck) copies chunks ck, ck + 16, ..
  const int ct = tid >> 4, ck = (tid & 15) * p.chunk;
  auto issue = [&](int u, int s) {
    const int j = u / p.tpb, tok0 = (u - j * p.tpb) * kMlaTile;
    const int phys =
        j < kTcTable ? bt_s[j] : __ldg(p.bt + static_cast<size_t>(b) * p.max_blocks + j);
    const int ntok = min(kMlaTile, p.block - tok0);
    uint8_t* st = ring + static_cast<size_t>(s) * p.stage_bytes;
    uint8_t* dst = st + ct * p.pitch;
    const size_t tok = static_cast<size_t>(phys) * p.block + tok0 + ct;
    if (ct < ntok) {
      const uint8_t* sc = cp + tok * p.cbytes;
      const uint8_t* sk = kp + tok * p.rbytes;
      for (int o = ck; o < p.cbytes; o += 16 * p.chunk)
        cp_async_z(dst + o, sc + o, p.chunk, p.chunk);
      for (int o = ck; o < p.rbytes; o += 16 * p.chunk)
        cp_async_z(dst + p.cpitch + o, sk + o, p.chunk, p.chunk);
    } else if (kDirect) {  // rows past the block: zeros (0 x garbage could be NaN)
      for (int o = ck; o < p.cbytes; o += 16 * p.chunk) cp_async_z(dst + o, cp, p.chunk, 0);
      for (int o = ck; o < p.rbytes; o += 16 * p.chunk)
        cp_async_z(dst + p.cpitch + o, cp, p.chunk, 0);
    }
    if (MODE >= kQ8 && tid == 0) {
      int* e = reinterpret_cast<int*>(st + kMlaTile * p.pitch);
      cp_async(e, p.c_exp + phys, 4);
      cp_async(e + 1, p.r_exp + phys, 4);
    }
  };

  float acc[kTcPairs][2][4];
#pragma unroll
  for (int i = 0; i < kTcPairs; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // each lane's ldmatrix row addresses: queries (A: rows, then k + 8), the
  // tile as K (B: tokens, then k + 8) and as V (B, transposed: tokens, then n + 8)
  const uint8_t* q_lane = q_s + (rg * 16 + (lane & 15)) * p.tpitch + (lane >> 4) * 16;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * p.tpitch + ((lane >> 3) & 1) * 16;
  const int v_lane = (lane & 15) * p.tpitch + (lane >> 4) * 16;
  for (int k = 0; k < kTcStages - 1; ++k) {
    if (k < n) issue(u0 + k, k);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kTcStages - 1 < n) issue(u0 + i + kTcStages - 1, (i + kTcStages - 1) % kTcStages);
    cp_async_commit();
    cp_async_wait<kTcStages - 1>();
    __syncthreads();  // tile i is in its stage, for every thread
    const int u = u0 + i, j = u / p.tpb, tok0 = (u - j * p.tpb) * kMlaTile;
    const int ntok = min(kMlaTile, p.block - tok0), kv0 = j * p.block + tok0;
    const uint8_t* tile = ring + static_cast<size_t>(i % kTcStages) * p.stage_bytes;
    if constexpr (!kDirect) {
      mla_tc_convert<MODE>(tile, ctile, ntok, p);
      __syncthreads();
      tile = ctile;
    }
    // partial logits over this warp's k-steps: tokens are the n8 tiles
    float sp[2][4], sq[2][4];  // even / odd k-steps: two mma chains, summed after
#pragma unroll
    for (int e = 0; e < 8; ++e) sp[e >> 2][e & 3] = sq[e >> 2][e & 3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcKs; ++kk) {
      const int ks = cgp + 4 * kk;
      if (ks < n_ks) {
        uint32_t qa[4], kb[4];
        ldsm_x4(qa, q_lane + ks * 32);
        ldsm_x4(kb, tile + k_lane + ks * 32);
        float (&d)[2][4] = kk & 1 ? sq : sp;
        mma_bf16(d[0], qa, kb[0], kb[1]);
        mma_bf16(d[1], qa, kb[2], kb[3]);
      }
    }
    float* red = sred + (rg * 4) * 8 * 32;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[(cgp * 8 + e) * 32 + lane] = sp[e >> 2][e & 3] + sq[e >> 2][e & 3];
    __syncthreads();
    // the row group's logits in a fixed order, then the same online softmax
    // in each of its 4 warps: lane holds rows g (e & 2 == 0) and g + 8 of
    // tokens 8 * nt + 2 * t4 + (e & 1)
    float x[2][4], mx[2] = {kNegInf, kNegInf};
    bool ok[2][4];
    const float sl = p.scale * 1.4426950408889634f;  // logits in log2 units: exp2, not exp
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int nt = e >> 2, c = e & 3, h = c >> 1;
      float s = red[e * 32 + lane];
#pragma unroll
      for (int w = 1; w < 4; ++w) s += red[(w * 8 + e) * 32 + lane];
      const int tok = 8 * nt + 2 * t4 + (c & 1);
      ok[nt][c] = tok < ntok && kv0 + tok <= qpos[h];
      x[nt][c] = ok[nt][c] ? s * sl : kNegInf;
      mx[h] = fmaxf(mx[h], x[nt][c]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int nt = e >> 2, c = e & 3, h = c >> 1;
      x[nt][c] = ok[nt][c] ? exp2f(x[nt][c] - m[h]) : 0.f;
      sum[h] += x[nt][c];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(kFull, sum[h], 1);
      sum[h] += __shfl_xor_sync(kFull, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
    // p as A fragments (the logits' accumulator layout is the A layout):
    // a0 / a1 = rows g / g + 8 of tokens 0..7, a2 / a3 of tokens 8..15
    uint32_t ph[4], pl[4];
    split_bf16x2(x[0][0], x[0][1], ph[0], pl[0]);
    split_bf16x2(x[0][2], x[0][3], ph[1], pl[1]);
    split_bf16x2(x[1][0], x[1][1], ph[2], pl[2]);
    split_bf16x2(x[1][2], x[1][3], ph[3], pl[3]);
    // acc = alpha * acc + p_hi . V + p_lo . V over this warp's column pairs
#pragma unroll
    for (int pi = 0; pi < kTcPairs; ++pi) {
      const int cp2 = cgp + 4 * pi;
      if (cp2 < n_pairs) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc[pi][nt][0] *= alpha[0];
          acc[pi][nt][1] *= alpha[0];
          acc[pi][nt][2] *= alpha[1];
          acc[pi][nt][3] *= alpha[1];
        }
        uint32_t vb[4];
        ldsm_x4_trans(vb, tile + v_lane + cp2 * 32);
        mma_bf16(acc[pi][0], ph, vb[0], vb[1]);
        mma_bf16(acc[pi][1], ph, vb[2], vb[3]);
        mma_bf16(acc[pi][0], pl, vb[0], vb[1]);
        mma_bf16(acc[pi][1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this tile and the partial logits
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's space becomes the merge's accumulator tile

  // the merge: each rank leaves its (m, l) and fp32 accumulator tile in its
  // shared memory (over the ring and queries, now free); after a cluster
  // barrier rank `split` finishes the items (a row's 4 columns) [split *
  // n_items / S, (split + 1) * n_items / S), reading every rank's values by
  // DSMEM (16-byte loads, a warp's 32 lanes on 512 contiguous bytes) and
  // adding them in rank order
  float* part_acc = reinterpret_cast<float*>(tc_smem);  // [kTcRows][r + 4]
  const int apitch = r + 4;
  const int lr = rg * 16 + g;
#pragma unroll
  for (int pi = 0; pi < kTcPairs; ++pi) {
    const int cp2 = cgp + 4 * pi;
    if (cp2 < n_pairs) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = cp2 * 16 + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(part_acc + lr * apitch + col) =
            make_float2(acc[pi][nt][0], acc[pi][nt][1]);
        *reinterpret_cast<float2*>(part_acc + (lr + 8) * apitch + col) =
            make_float2(acc[pi][nt][2], acc[pi][nt][3]);
      }
    }
  }
  if (cgp == 0 && t4 == 0) {
    part_ml[lr] = m[0];
    part_ml[lr + 8] = m[1];
    part_ml[kTcRows + lr] = l[0];
    part_ml[kTcRows + lr + 8] = l[1];
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) cluster.sync(); else __syncthreads();
  auto rank_ptr = [&](float* ptr, int c) -> const float* {
    return S == 1 ? ptr : cluster.map_shared_rank(ptr, c);
  };
  // every rank's (m, l) of every row, one load a thread: ml_s[c][0 / 1][row]
  for (int i = tid; i < S * 2 * kTcRows; i += kTcThreads)
    ml_s[i] = rank_ptr(part_ml, i / (2 * kTcRows))[i % (2 * kTcRows)];
  __syncthreads();
  const int q4 = r / 4, n_items = nrows * q4;
  const int lo = split * n_items / S, hi = (split + 1) * n_items / S;
  for (int it = lo + tid; it < hi; it += kTcThreads) {
    const int row = it / q4, col = (it - row * q4) * 4;
    float4 a[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c)
      if (c < S)
        a[c] = *reinterpret_cast<const float4*>(rank_ptr(part_acc, c) + row * apitch + col);
    float M = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c)
      if (c < S) M = fmaxf(M, ml_s[c * 2 * kTcRows + row]);
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      if (c < S) {
        const float f = exp2f(ml_s[c * 2 * kTcRows + row] - M);
        L += ml_s[(c * 2 + 1) * kTcRows + row] * f;
        o.x += a[c].x * f;
        o.y += a[c].y * f;
        o.z += a[c].z * f;
        o.w += a[c].w * f;
      }
    }
    if (L == 0.f) L = 1.f;
    uint2 v;
    v.x = bf16x2_bits(o.x / L, o.y / L);
    v.y = bf16x2_bits(o.z / L, o.w / L);
    *reinterpret_cast<uint2*>(out + (static_cast<size_t>(b) * p.TH + row0 + row) * r + col) = v;
  }
  if (S > 1) cluster.sync();  // every block's partials stay until the others have read them
}

size_t mla_tc_smem_bytes(const MlaTcParams& p) {  // the region, then partial logits, m, l, table
  return static_cast<size_t>(p.region) +
         sizeof(float) * (2 * 4 * 8 * 32 + 2 * (kMaxSplit + 1) * kTcRows) +
         sizeof(int) * kTcTable;
}

template <int MODE>
int launch_mla_tc(const void* qe, const void* qr, const void* c, const void* k, void* out,
                  const MlaTcParams& p, int B, cudaStream_t st) {
  auto kern = mla_decode_tc<MODE>;
  const size_t smem = mla_tc_smem_bytes(p);
  static size_t smem_allowed = 48 * 1024;  // per instantiation: raised once, not per launch
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(p.n_split, (p.TH + kTcRows - 1) / kTcRows, B);
  const auto* qep = static_cast<const __nv_bfloat16*>(qe);
  const auto* qrp = static_cast<const __nv_bfloat16*>(qr);
  const auto* cpp = static_cast<const uint8_t*>(c);
  const auto* kpp = static_cast<const uint8_t*>(k);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (p.n_split == 1) {
    kern<<<grid, kTcThreads, smem, st>>>(qep, qrp, cpp, kpp, op, p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = grid;
  lc.blockDim = dim3(kTcThreads, 1, 1);
  lc.dynamicSmemBytes = smem;
  lc.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;  // one cluster per (row tile, b)
  cluster[0].val.clusterDim.x = p.n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  lc.attrs = cluster;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, kern, qep, qrp, cpp, kpp, op, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,T,K,G,hd) f32|bf16; pools (n_blocks, block, K, hd) f32|bf16|int8 (kv_dtype 0|1|2),
// int8 words (3) or (n_blocks, block, K, hd/2) int4 words (4) with k_exp/v_exp
// (n_blocks, K) i32 (null otherwise); bt (B,max_blocks) i32; pos0 (B,) i32; out like q;
// hd a multiple of 8 up to 256; n_split 1, 2, 4 or 8 thread blocks (one cluster) per
// (b, kv_head, row tile).  Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* bt, const void* pos0, const void* k_exp,
                                      const void* v_exp, void* out, int B, int K, int T, int G,
                                      int hd, int block, int max_blocks, int window,
                                      int q_dtype, int kv_dtype, int n_split, float scale,
                                      float cap, float kv_scale, void* stream) {
  const bool quant = kv_dtype == kQ8 || kv_dtype == kQ4;
  if (B < 1 || K < 1 || T < 1 || G < 1 || hd < 8 || hd > 256 || hd % 8 || block < 1 ||
      max_blocks < 1 || window < 1 || n_split < 1 || n_split > kMaxSplit ||
      (n_split & (n_split - 1)) || (quant && (!k_exp || !v_exp)) || kv_dtype < 0 ||
      kv_dtype > kQ4)
    return static_cast<int>(cudaErrorInvalidValue);
  GqaParams p;
  p.bt = static_cast<const int*>(bt);
  p.pos0 = static_cast<const int*>(pos0);
  p.k_exp = static_cast<const int*>(k_exp);
  p.v_exp = static_cast<const int*>(v_exp);
  p.B = B; p.T = T; p.K = K; p.G = G; p.TG = T * G; p.hd = hd; p.block = block;
  p.max_blocks = max_blocks; p.window = window; p.n_split = n_split;
  p.tpb = (block + kTile - 1) / kTile;
  const int elem_bits = kv_dtype == repro::kF32 ? 32 : kv_dtype == repro::kBF16 ? 16
                        : kv_dtype == kQ4 ? 4 : 8;
  p.row_bytes = hd * elem_bits / 8;
  p.pitch = (p.row_bytes + 15) / 16 * 16;
  auto aligned = [](const void* ptr, int n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; };
  p.chunk = p.row_bytes % 16 == 0 && aligned(k_pool, 16) && aligned(v_pool, 16) ? 16
            : p.row_bytes % 4 == 0 && aligned(k_pool, 4) && aligned(v_pool, 4) ? 4 : 1;
  const int rt = p.TG == 1 ? 1 : p.TG == 2 ? 2 : 4;
  p.stages = 2;  // one stage where two would leave room for only one thread block an SM
  if (gqa_smem_bytes(p, rt) > 113 * 1024) p.stages = 1;
  if (gqa_smem_bytes(p, rt) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  p.scale = scale; p.cap = cap; p.kv_scale = kv_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return launch_gqa_pool<float>(kv_dtype, q, k_pool, v_pool, out, p, st);
  if (q_dtype == repro::kBF16)
    return launch_gqa_pool<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, out, p, st);
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

// mla_decode_tc: q_eff (B,T,H,r) and q_rope (B,T,H,rope) bf16, 4-byte aligned; pools as
// paged_attention_mla_launch's but bf16 (kv_dtype 1, kv_scale 1), int8 x a power-of-two
// kv_scale (2), int8 (3) or int4 (4) words with c_exp/r_exp; r and rope multiples of 16,
// 16 <= r <= 512, rope >= 16, r + rope <= 576; out (B,T,H,r) bf16; n_split 1..8 thread
// blocks (one cluster) per (row tile, b).  Returns cudaGetLastError().
extern "C" int paged_attention_mla_tc_launch(const void* q_eff, const void* q_rope,
                                             const void* ckv_pool, const void* krope_pool,
                                             const void* bt, const void* pos0,
                                             const void* c_exp, const void* r_exp, void* out,
                                             int B, int T, int H, int r, int rope, int block,
                                             int max_blocks, int kv_dtype, int n_split,
                                             float scale, float kv_scale, void* stream) {
  const bool quant = kv_dtype == kQ8 || kv_dtype == kQ4;
  auto aligned = [](const void* ptr, int n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; };
  if (B < 1 || T < 1 || H < 1 || r < 16 || r > kTcMaxRank || r % 16 || rope < 16 || rope % 16 ||
      r + rope > kTcMaxDepth || block < 1 || max_blocks < 1 || n_split < 1 ||
      n_split > kMaxSplit || kv_dtype < repro::kBF16 || kv_dtype > kQ4 ||
      (quant && (!c_exp || !r_exp)) || !aligned(q_eff, 4) || !aligned(q_rope, 4) ||
      !aligned(out, 8) || B > 65535 ||
      (static_cast<long long>(T) * H + kTcRows - 1) / kTcRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  MlaTcParams p;
  p.bt = static_cast<const int*>(bt);
  p.pos0 = static_cast<const int*>(pos0);
  p.c_exp = static_cast<const int*>(c_exp);
  p.r_exp = static_cast<const int*>(r_exp);
  p.TH = T * H; p.H = H; p.r = r; p.rope = rope; p.block = block; p.max_blocks = max_blocks;
  p.tpb = (block + kMlaTile - 1) / kMlaTile;
  p.n_split = n_split;
  const int elt_bits = kv_dtype == repro::kBF16 ? 16 : kv_dtype == kQ4 ? 4 : 8;
  p.cbytes = r * elt_bits / 8;
  p.rbytes = rope * elt_bits / 8;
  p.tpitch = 2 * (r + rope) + 16;
  if (kv_dtype == repro::kBF16) {  // the stage is the bf16 tile
    p.cpitch = 2 * r;
    p.pitch = p.tpitch;
  } else {
    p.cpitch = (p.cbytes + 15) / 16 * 16;
    p.pitch = p.cpitch + (p.rbytes + 15) / 16 * 16;
  }
  p.chunk = p.qchunk = 0;
  const int chunks[3] = {16, 8, 4};
  for (int ch : chunks) {
    if (!p.chunk && p.cbytes % ch == 0 && p.rbytes % ch == 0 && aligned(ckv_pool, ch) &&
        aligned(krope_pool, ch))
      p.chunk = ch;
    if (!p.qchunk && aligned(q_eff, ch) && aligned(q_rope, ch)) p.qchunk = ch;  // rows: 32k B
  }
  if (!p.chunk || !p.qchunk) return static_cast<int>(cudaErrorInvalidValue);
  p.stage_bytes = kMlaTile * p.pitch + 16;
  const int ring = kTcRows * p.tpitch + kTcStages * p.stage_bytes +
                   (kv_dtype == repro::kBF16 ? 0 : kMlaTile * p.tpitch);
  const int merge = kTcRows * (r + 4) * static_cast<int>(sizeof(float));
  p.region = ((ring > merge ? ring : merge) + 15) / 16 * 16;
  if (mla_tc_smem_bytes(p) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  p.scale = scale; p.kv_scale = kv_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == repro::kBF16)
    return launch_mla_tc<repro::kBF16>(q_eff, q_rope, ckv_pool, krope_pool, out, p, B, st);
  if (kv_dtype == repro::kI8)
    return launch_mla_tc<repro::kI8>(q_eff, q_rope, ckv_pool, krope_pool, out, p, B, st);
  if (kv_dtype == kQ8)
    return launch_mla_tc<kQ8>(q_eff, q_rope, ckv_pool, krope_pool, out, p, B, st);
  return launch_mla_tc<kQ4>(q_eff, q_rope, ckv_pool, krope_pool, out, p, B, st);
}
