// Paged GQA attention at T > 1 (tail prefill, prefill chunks, prefix-hit
// tails) on Hopper's tensor cores (sm_90a): `gqa_prefill`.
//
// Replaces the Pallas TPU kernels repro/kernels/paged_attention/kernel.py
// `_attn_kernel` (bf16 / KV_F int8 pools) and `_attn_kernel_quant` (SYMOG
// int8 / int4 words x 2^e), both launched by `paged_attention_padded`, where
// a call has many query rows a KV head (T*G at or above the wrapper's
// threshold, ops.py `_gqa_route`); `gqa_decode` (paged_attention.cu) keeps
// the decode shapes and fp32.  The contract is gqa_decode's, with bf16 q / out:
//   q    (B, T, K, G, hd) bf16; row r < T*G of (b, kh) is q[b, r/G, kh, r%G] at
//        q_pos = pos0[b] + r/G
//   k/v  (n_blocks, block, K, hd) bf16 (kv_scale 1) | int8 x kv_scale (a power of two,
//        KV_F) | SYMOG int8 words or int4 split-halves words (n_blocks, block, K, hd/2;
//        word i = lane i low nibble, lane i + hd/2 high nibble) x 2^e, e from k_exp /
//        v_exp (n_blocks, K) int32: every value exact in bf16
//   bt   (B, max_blocks) int32 physical block ids (0 = trash)
//   mask kv_pos <= q_pos && q_pos - kv_pos < window (2^30 = no window)
//   s = scale * q.k, softcap tanh(s/cap)*cap if cap > 0, online softmax, p zeroed
//   under the mask, out = acc / (l == 0 ? 1 : l).  hd a multiple of 16 up to 256,
//   block a multiple of 16.
//
// What bounds it on the H100: operations, from T ~256 up.  gemma3's admission
// (K 4, G 2, hd 256, T 2048 from 0) has ~2.1 M visible (query, key) pairs a KV
// head: 4 x 2.1 M x 8 x 256 = 17 GFLOP, 0.017 ms at 989 TFLOP/s, against
// ~2 MB of int4 pool.  gqa_decode holds 4 query rows a thread block, so each
// block streams its own copy of the visible keys and forms q.k and p.v as
// CUDA-core FMAs: the keys are read ~1,000 times at T 2048.  Design:
//   * one thread block per (query tile of 64 rows of one (b, kh)'s T*G row
//     axis, b * K + kh, KV split): 64/G positions x the G heads that share
//     the KV head.  8 warps: 4 row groups of 16 rows x the two 32-key halves
//     of each key tile, each warp with its own online softmax over its
//     half, the halves merged once at the end (4 warps holding all 64 keys
//     left the SM's one block too few warps to hide the ring's and the
//     conversion's latency).  The tile's queries are staged once by
//     `cp.async` and read by `ldmatrix` for every key tile, so each key
//     tile is read once a query tile, not once per 4 rows.  The grid puts
//     the query tile on its slowest axis, last tile first: under the causal
//     mask the last tiles see the most keys and start first;
//   * key tiles of 64 tokens (four 16-token sub-tiles; the route asks block
//     % 16 == 0, so a 16-key `mma` step never straddles two blocks),
//     gathered through the block table (its entries for the block's key
//     range staged once in shared memory); a sub-tile with no key in the
//     query tile's range is not read but zero-filled, so that a block no row
//     may see (NaN, say) never reaches p . v; raw pool words go by 16-byte
//     `cp.async` into a 2-stage ring, the next tile in flight while this one
//     is computed.  A bf16 pool's rows land as the bf16 tile itself; words
//     (KV_F int8 x kv_scale, SYMOG int8 / int4 x 2^e per (block, head)) are
//     converted once a tile into a bf16 K tile and V tile, as mla_decode_tc
//     converts them: exact, since a word needs at most 8 significant bits
//     and every scale is a power of two;
//   * S = Q.K^T on `mma.sync.m16n8k16` bf16 with fp32 accumulators (Q and K
//     by `ldmatrix`), scale and softcap (`tanhf`), then the online softmax
//     (m, l per row) in fp32 registers, on logits in natural units with p =
//     2^((x - m) log2 e): x - m is exact near the max, so the one rounding
//     the plain version makes (s * scale) is the kernel's too (SYMOG pools
//     of wide exponents give logits in the thousands, where scaling by
//     log2 e first would add an ulp of ~1e-4 to every p).  The mask is built
//     only on tiles that cross the causal edge, the window edge or the
//     table's end; a wholly visible tile takes none;
//   * P.V with V by `ldmatrix.trans`; p in two bf16 parts, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), two products (one bf16 p misses the bf16 bar on
//     wide SYMOG spreads, as mla_decode_tc found); O in fp32 registers (hd/2
//     a thread: 128 at hd 256), rounded to bf16 once;
//   * key tiles outside the query tile's range [first row's window start,
//     last row's position] are skipped on the device: exact, as gqa_decode
//     argues (p = 0 and alpha = 1 there);
//   * where query tiles x B x K leave SMs idle (a 256-row chunk: 8 tiles x 4
//     heads), the key range is cut over a cluster of 2 or 4 thread blocks
//     (the wrapper's `_prefill_split`); each rank leaves its (m, l, acc) in
//     shared memory and rank c finishes its share of the outputs, reading
//     every rank's partial by DSMEM and adding them in rank order: one
//     launch, no workspace, no atomics, the same bits on every call.
// Not used: `wgmma` and TMA (each 16-token block is a separate gather, and
// word pools need a conversion pass between load and product).
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kQ8 = 3;  // pool codes beyond common.cuh's: int8 words + exponents
constexpr int kQ4 = 4;  // int4 split-halves words + exponents
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;     // query rows a thread block (ops.py PREFILL_ROWS)
constexpr int kKeys = 64;     // keys a tile (ops.py PREFILL_KEYS)
constexpr int kWarps = 8;     // 4 row groups of 16 query rows x 2 halves of a key tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;    // key tiles in flight
constexpr int kMaxSplit = 4;  // thread blocks per cluster
constexpr int kTable = 512;   // block-table entries staged (later ones: one load a token row)

struct PrefillParams {
  const int* bt;
  const int* pos0;
  const int* k_exp;  // (n_blocks, K) exponents of SYMOG pools, else null
  const int* v_exp;
  int T, K, G, TG, hd, block, max_blocks, window, n_split;
  int row_bytes;    // bytes of one token's words of one KV head in the pools
  int pitch;        // a ring row: the bf16 tile's tpitch (bf16 pools), else row_bytes to 16
  int tpitch;       // a bf16 tile's row: 2 hd + 16 (ldmatrix banks)
  int chunk;        // bytes a cp.async of pool rows: 16 or 8
  int stage_bytes;  // K rows, V rows, 8 exponents
  int region;       // bytes of queries + ring (+ converted tiles), or of the merge's tile
  float scale, cap, kv_scale;
};

// dims d0..d0+7 of a raw word row as 8 bf16 (word x s, exact)
template <int MODE>
__device__ __forceinline__ uint4 words_bf16x8(const uint8_t* row, int d0, int hd, float s) {
  uint4 o;
  if constexpr (MODE == kQ4) {  // low nibbles of words d0.., or high ones of d0 - hd/2..
    const int hw = hd / 2;
    const bool hi = d0 >= hw;
    uint2 x = *reinterpret_cast<const uint2*>(row + (hi ? d0 - hw : d0));
    if (hi) {
      x.x >>= 4;
      x.y >>= 4;
    }
    const uint32_t s2 = bf16x2_bits(s, s), c2 = bf16x2_bits(-136.f * s, -136.f * s);
    o.x = nibbles_bf16x2(__byte_perm(x.x, 0u, 0x4140), s2, c2);
    o.y = nibbles_bf16x2(__byte_perm(x.x, 0u, 0x4342), s2, c2);
    o.z = nibbles_bf16x2(__byte_perm(x.y, 0u, 0x4140), s2, c2);
    o.w = nibbles_bf16x2(__byte_perm(x.y, 0u, 0x4342), s2, c2);
  } else {  // int8 words to exact floats by the mantissa of 2^23
    const uint2 x = *reinterpret_cast<const uint2*>(row + d0);
    const uint32_t w[2] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u};  // byte f -> f + 128
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4b000000u, 0x7440 + (i & 3))) - 8388736.f;
    o.x = bf16x2_bits(v[0] * s, v[1] * s);
    o.y = bf16x2_bits(v[2] * s, v[3] * s);
    o.z = bf16x2_bits(v[4] * s, v[5] * s);
    o.w = bf16x2_bits(v[6] * s, v[7] * s);
  }
  return o;
}

// A stage's raw K or V rows -> the bf16 tile [64 tokens][hd]; rows outside
// [t_lo, t_hi) (not read) are zeros.  `e` holds the 4 sub-tiles' exponents
// (SYMOG pools).  16 threads a token row: thread (ct, ck) converts rows ct
// + 16 i (sub-tile i) and their 8-dim chunks ck + 16 k, all unrolled.
template <int MODE, int HDM>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, uint8_t* tile, const int* e,
                                             int t_lo, int t_hi, const PrefillParams& p) {
  const int ct = threadIdx.x >> 4, ck = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i) {
    const int t = ct + 16 * i;
    // 2^e by its bits (|e| <= 20 here), or the KV_F scale
    const float s = MODE >= kQ8 ? __int_as_float((e[i] + 127) << 23) : p.kv_scale;
    const bool read = t_lo <= t && t < t_hi;
#pragma unroll
    for (int k = 0; k < (HDM / 8 + 15) / 16; ++k) {
      const int ch = ck + 16 * k;
      if (ch * 8 < p.hd) {
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (read) o = words_bf16x8<MODE>(raw + t * p.pitch, ch * 8, p.hd, s);
        *reinterpret_cast<uint4*>(tile + t * p.tpitch + ch * 16) = o;
      }
    }
  }
}

// MODE: the pool code, 1 bf16 (its rows are the tile), 2 int8 x kv_scale
// (KV_F), 3 int8 words and 4 int4 words x 2^e per (block, head); HDM: the
// largest head dim the instantiation takes (64, 128 or 256)
template <int MODE, int HDM>
__global__ void __launch_bounds__(kThreads, 1)
gqa_prefill(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ kp,
            const uint8_t* __restrict__ vp, __nv_bfloat16* __restrict__ out, PrefillParams p) {
  constexpr bool kDirect = MODE == repro::kBF16;
  constexpr int kPairs = HDM / 16;  // 16-column pairs of the head dim: hd's k-steps too
  extern __shared__ __align__(16) uint8_t pf_smem[];
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, kq = warp >> 2;  // row group (16 rows), key half (32 keys a tile)
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column pair
  const int split = blockIdx.x, bk = blockIdx.y, b = bk / p.K, kh = bk - b * p.K;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // the last query tile first
  const int S = p.n_split, hd = p.hd, n_ks = hd / 16;
  const int nrows = min(kRows, p.TG - row0);

  uint8_t* q_s = pf_smem;  // [kRows][hd] bf16, rows tpitch apart
  uint8_t* ring = q_s + kRows * p.tpitch;
  uint8_t* ktile = ring + kStages * p.stage_bytes;  // word pools: converted K, then V
  uint8_t* vtile = ktile + kKeys * p.tpitch;
  float* part_ml = reinterpret_cast<float*>(pf_smem + p.region);  // this rank's m, l: [2][kRows]
  float* ml_s = part_ml + 2 * kRows;                               // every rank's: [S][2][kRows]
  int* bt_s = reinterpret_cast<int*>(ml_s + kMaxSplit * 2 * kRows);  // [kTable]

  // the query tile's key range from pos0 on the device, this rank's share
  const int pos0 = __ldg(p.pos0 + b);
  const int n_tok = p.max_blocks * p.block;
  const int pos_first = pos0 + row0 / p.G, pos_last = pos0 + (row0 + nrows - 1) / p.G;
  const int hi_tok = min(pos_last, n_tok - 1);                   // last key any row may see
  const int lo_tok = max(0, pos_first - p.window + 1);           // first key in any row's window
  int v_lo = 0, n_v = 0;  // key tiles [v_lo, v_lo + n_v): tile v holds tokens 64 v ..
  if (lo_tok <= hi_tok) {
    v_lo = lo_tok / kKeys;
    n_v = hi_tok / kKeys + 1 - v_lo;
  }
  const int v0 = v_lo + static_cast<int>(static_cast<long long>(split) * n_v / S);
  const int n = v_lo + static_cast<int>(static_cast<long long>(split + 1) * n_v / S) - v0;

  // the block table from this rank's first key block, and the tile's queries
  // (rows past T*G zero-filled), in two copy groups
  const int j_base = v0 * kKeys / p.block;
  const size_t bt_row = static_cast<size_t>(b) * p.max_blocks;
  const int n_tab = max(0, min(kTable, p.max_blocks - j_base));
  for (int j = tid; j < n_tab; j += kThreads) cp_async(bt_s + j, p.bt + bt_row + j_base + j, 4);
  cp_async_commit();
  const size_t q_t = static_cast<size_t>(p.K) * p.G * hd;  // one t further
  const size_t q_base = (static_cast<size_t>(b) * p.T * p.K + kh) * p.G * hd;
  const int ct = tid >> 4, ck = tid & 15;  // 16 threads a row, 16 rows a pass
  for (int r = ct; r < kRows; r += kThreads / 16) {
    const int rr = row0 + min(r, nrows - 1);
    const __nv_bfloat16* src = q + q_base + (rr / p.G) * q_t + (rr % p.G) * hd;
    for (int o = ck * 16; o < 2 * hd; o += 256)
      cp_async_z(q_s + r * p.tpitch + o, reinterpret_cast<const uint8_t*>(src) + o, 16,
                 r < nrows ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the table (the queries may still be in flight)
  __syncthreads();

  auto phys_of = [&](int j) {
    const int i = j - j_base;
    return i < kTable ? bt_s[i] : __ldg(p.bt + bt_row + j);
  };
  // the tokens [t_lo, t_hi) of tile kv0.. that are read: its 16-token
  // sub-tiles holding a key in [lo_tok, hi_tok] (one block each: block % 16
  // == 0).  The others belong to blocks no row may see (before a window, or
  // past the table's used entries, whose contents may be anything) and
  // become zeros: 0 x NaN would reach the output through p . v
  auto t_lo_of = [&](int kv0) { return max(0, lo_tok - kv0) >> 4 << 4; };
  auto t_hi_of = [&](int kv0) { return min(kKeys, ((hi_tok - kv0) >> 4) * 16 + 16); };
  auto issue = [&](int v, int s) {
    const int kv0 = v * kKeys, t_lo = t_lo_of(kv0), t_hi = t_hi_of(kv0);
    uint8_t* st = ring + static_cast<size_t>(s) * p.stage_bytes;
#pragma unroll
    for (int i = 0; i < kKeys / 16; ++i) {  // token ct + 16 i: sub-tile i
      const int t = ct + 16 * i;
      uint8_t* dk = st + t * p.pitch;
      uint8_t* dv = dk + kKeys * p.pitch;
      if (t_lo <= t && t < t_hi) {
        const int kv = kv0 + t, j = kv / p.block;
        const size_t src =
            ((static_cast<size_t>(phys_of(j)) * p.block + (kv - j * p.block)) * p.K + kh) *
            p.row_bytes;
        for (int o = ck * p.chunk; o < p.row_bytes; o += 16 * p.chunk) {
          cp_async_z(dk + o, kp + src + o, p.chunk, p.chunk);
          cp_async_z(dv + o, vp + src + o, p.chunk, p.chunk);
        }
      } else if (kDirect) {
        for (int o = ck * p.chunk; o < p.row_bytes; o += 16 * p.chunk) {
          cp_async_z(dk + o, kp, p.chunk, 0);
          cp_async_z(dv + o, vp, p.chunk, 0);
        }
      }
    }
    if (MODE >= kQ8 && tid < 8) {  // sub-tile c's K (tid < 4) and V exponents
      const int c = tid & 3;
      int* e = reinterpret_cast<int*>(st + 2 * kKeys * p.pitch) + tid;
      const bool read = t_lo <= 16 * c && 16 * c < t_hi;
      const int* src = p.k_exp;  // a sub-tile not read: zero-filled, nothing read
      if (read)
        src = (tid < 4 ? p.k_exp : p.v_exp) +
              static_cast<size_t>(phys_of((kv0 + 16 * c) / p.block)) * p.K + kh;
      cp_async_z(e, src, 4, read ? 4 : 0);
    }
  };

  // this lane's two query rows (g and g + 8 of its row group) and their limits
  int qpos[2], qlim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row0 + min(rg * 16 + g + 8 * h, nrows - 1);
    qpos[h] = pos0 + rr / p.G;
    qlim[h] = min(qpos[h], n_tok - 1);
  }
  float acc[kPairs][2][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // each lane's ldmatrix row addresses: queries (A: rows, then k + 8), the
  // warp's 32 keys of a tile as K (B: tokens, then k + 8) and as V (B,
  // transposed: tokens, then n + 8)
  const uint8_t* q_lane = q_s + (rg * 16 + (lane & 15)) * p.tpitch + (lane >> 4) * 16;
  const int k_lane = (kq * 32 + (lane & 7) + ((lane >> 4) << 3)) * p.tpitch +
                     ((lane >> 3) & 1) * 16;
  const int v_lane = (kq * 32 + (lane & 15)) * p.tpitch + (lane >> 4) * 16;
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n) issue(v0 + k, k);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) issue(v0 + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i (and the queries) in shared memory, for every thread
    const int kv0 = (v0 + i) * kKeys;
    const uint8_t* st = ring + static_cast<size_t>(i % kStages) * p.stage_bytes;
    const uint8_t* kt = st;
    const uint8_t* vt = st + kKeys * p.pitch;
    if constexpr (!kDirect) {
      const int* e = reinterpret_cast<const int*>(st + 2 * kKeys * p.pitch);
      const int t_lo = t_lo_of(kv0), t_hi = t_hi_of(kv0);
      convert_tile<MODE, HDM>(st, ktile, e, t_lo, t_hi, p);
      convert_tile<MODE, HDM>(st + kKeys * p.pitch, vtile, e + 4, t_lo, t_hi, p);
      __syncthreads();
      kt = ktile;
      vt = vtile;
    }
    // S = Q.K^T over the warp's 32 keys: 4 n8 tiles of tokens, hd / 16 k-steps
    float sc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kPairs; ++ks) {
      if (ks < n_ks) {
        uint32_t qa[4];
        ldsm_x4(qa, q_lane + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, kt + np * 16 * p.tpitch + k_lane + ks * 32);
          mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
          mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
    }
    // scale, softcap, the mask where the tile crosses an edge, online softmax
    // over this warp's keys: lane holds rows g (c < 2) and g + 8 of tokens
    // 32 kq + 8 nt + 2 t4 + (c & 1)
    const bool full = kv0 + kKeys - 1 <= min(pos_first, n_tok - 1) &&
                      pos_last - kv0 < p.window;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        float x = p.cap > 0.f ? tanhf(sc[nt][c] * p.scale / p.cap) * p.cap : sc[nt][c] * p.scale;
        if (!full) {
          const int tok = kv0 + kq * 32 + 8 * nt + 2 * t4 + (c & 1);
          if (!(tok <= qlim[h] && qpos[h] - tok < p.window)) x = kNegInf;
        }
        sc[nt][c] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        const float x = sc[nt][c];
        sc[nt][c] = x == kNegInf ? 0.f : exp2f((x - m[h]) * kLog2e);
        sum[h] += sc[nt][c];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(kFull, sum[h], 1);
      sum[h] += __shfl_xor_sync(kFull, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int cp2 = 0; cp2 < kPairs; ++cp2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[cp2][nt][0] *= alpha[0];
        acc[cp2][nt][1] *= alpha[0];
        acc[cp2][nt][2] *= alpha[1];
        acc[cp2][nt][3] *= alpha[1];
      }
    // acc += p_hi.V + p_lo.V, 16 keys a k-step: p's accumulator layout is the
    // A layout (a0 / a1 = rows g / g + 8 of keys 0..7, a2 / a3 of keys 8..15)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int cp2 = 0; cp2 < kPairs; ++cp2) {
        if (cp2 < n_ks) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + kk * 16 * p.tpitch + v_lane + cp2 * 32);
          mma_bf16(acc[cp2][0], ph, vb[0], vb[1]);
          mma_bf16(acc[cp2][1], ph, vb[2], vb[3]);
          mma_bf16(acc[cp2][0], pl, vb[0], vb[1]);
          mma_bf16(acc[cp2][1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage (and the converted tiles)
  }
  cp_async_wait<0>();

  // the two key halves of each row group, merged in a fixed order: the
  // second half's warps leave (m, l, acc) in shared memory (over the queries
  // and the ring, now free), the first half's fold them into their own
  float* part_acc = reinterpret_cast<float*>(pf_smem);  // [kRows][hd + 4]
  const int apitch = hd + 4;
  const int lr = rg * 16 + g;  // this lane's first row in the tile
  if (kq == 1) {
#pragma unroll
    for (int cp2 = 0; cp2 < kPairs; ++cp2) {
      if (cp2 < n_ks) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = cp2 * 16 + nt * 8 + 2 * t4;
          *reinterpret_cast<float2*>(part_acc + lr * apitch + col) =
              make_float2(acc[cp2][nt][0], acc[cp2][nt][1]);
          *reinterpret_cast<float2*>(part_acc + (lr + 8) * apitch + col) =
              make_float2(acc[cp2][nt][2], acc[cp2][nt][3]);
        }
      }
    }
    if (t4 == 0) {
      part_ml[lr] = m[0];
      part_ml[lr + 8] = m[1];
      part_ml[kRows + lr] = l[0];
      part_ml[kRows + lr + 8] = l[1];
    }
  }
  __syncthreads();
  if (kq == 0) {
    float f0[2], f1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 8 * h;
      const float m1 = part_ml[r], l1 = part_ml[kRows + r];
      const float M = fmaxf(m[h], m1);
      f0[h] = exp2f((m[h] - M) * kLog2e);
      f1[h] = exp2f((m1 - M) * kLog2e);
      m[h] = M;
      l[h] = l[h] * f0[h] + l1 * f1[h];
    }
    __syncwarp();  // every lane has read its rows' (m, l) before lane t4 == 0 rewrites them
#pragma unroll
    for (int cp2 = 0; cp2 < kPairs; ++cp2) {
      if (cp2 < n_ks) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = cp2 * 16 + nt * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* a1 = reinterpret_cast<float2*>(part_acc + (lr + 8 * h) * apitch + col);
            const float2 o = *a1;
            acc[cp2][nt][2 * h] = acc[cp2][nt][2 * h] * f0[h] + o.x * f1[h];
            acc[cp2][nt][2 * h + 1] = acc[cp2][nt][2 * h + 1] * f0[h] + o.y * f1[h];
            if (S > 1) *a1 = make_float2(acc[cp2][nt][2 * h], acc[cp2][nt][2 * h + 1]);
          }
        }
      }
    }
    if (S == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr + 8 * h, rr = row0 + r;
        if (r < nrows) {
          const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
          __nv_bfloat16* o = out + q_base + (rr / p.G) * q_t + (rr % p.G) * hd;
#pragma unroll
          for (int cp2 = 0; cp2 < kPairs; ++cp2)
            if (cp2 < n_ks)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                *reinterpret_cast<uint32_t*>(o + cp2 * 16 + nt * 8 + 2 * t4) =
                    bf16x2_bits(acc[cp2][nt][2 * h] * inv, acc[cp2][nt][2 * h + 1] * inv);
        }
      }
    } else if (t4 == 0) {
      part_ml[lr] = m[0];
      part_ml[lr + 8] = m[1];
      part_ml[kRows + lr] = l[0];
      part_ml[kRows + lr + 8] = l[1];
    }
  }
  if (S == 1) return;
  // the cluster's ranks: after a cluster barrier rank `split` finishes the
  // items (a row's 4 columns) [split * n_items / S, (split + 1) * n_items /
  // S), reading every rank's (m, l, acc) by DSMEM and adding them in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = tid; i < S * 2 * kRows; i += kThreads)
    ml_s[i] = cluster.map_shared_rank(part_ml, i / (2 * kRows))[i % (2 * kRows)];
  __syncthreads();
  const int q4 = hd / 4, n_items = nrows * q4;
  const int lo = split * n_items / S, hi = (split + 1) * n_items / S;
  for (int it = lo + tid; it < hi; it += kThreads) {
    const int row = it / q4, col = (it - row * q4) * 4, rr = row0 + row;
    float4 a[kMaxSplit];
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c)
      if (c < S)
        a[c] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part_acc, c) +
                                                row * apitch + col);
    float M = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c)
      if (c < S) M = fmaxf(M, ml_s[c * 2 * kRows + row]);
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kMaxSplit; ++c) {
      if (c < S) {
        const float f = exp2f((ml_s[c * 2 * kRows + row] - M) * kLog2e);
        L += ml_s[(c * 2 + 1) * kRows + row] * f;
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
    *reinterpret_cast<uint2*>(out + q_base + (rr / p.G) * q_t + (rr % p.G) * hd + col) = v;
  }
  cluster.sync();  // every block's partials stay until the others have read them
}

size_t prefill_smem_bytes(const PrefillParams& p) {  // the region, then m, l, table
  return static_cast<size_t>(p.region) + sizeof(float) * 2 * (kMaxSplit + 1) * kRows +
         sizeof(int) * kTable;
}

template <int MODE, int HDM>
int launch_prefill(const void* q, const void* k, const void* v, void* out,
                   const PrefillParams& p, int B, cudaStream_t st) {
  auto kern = gqa_prefill<MODE, HDM>;
  const size_t smem = prefill_smem_bytes(p);
  static size_t smem_allowed = 48 * 1024;  // per instantiation: raised once, not per launch
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const dim3 grid(p.n_split, B * p.K, (p.TG + kRows - 1) / kRows);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kpp = static_cast<const uint8_t*>(k);
  const auto* vpp = static_cast<const uint8_t*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (p.n_split == 1) {
    kern<<<grid, kThreads, smem, st>>>(qp, kpp, vpp, op, p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = grid;
  lc.blockDim = dim3(kThreads, 1, 1);
  lc.dynamicSmemBytes = smem;
  lc.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;  // one cluster per (query tile, b, kh)
  cluster[0].val.clusterDim.x = p.n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  lc.attrs = cluster;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, kern, qp, kpp, vpp, op, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_prefill_dims(const void* q, const void* k, const void* v, void* out,
                        const PrefillParams& p, int B, cudaStream_t st) {
  if (p.hd <= 64) return launch_prefill<MODE, 64>(q, k, v, out, p, B, st);
  if (p.hd <= 128) return launch_prefill<MODE, 128>(q, k, v, out, p, B, st);
  return launch_prefill<MODE, 256>(q, k, v, out, p, B, st);
}

}  // namespace

// gqa_prefill: q (B,T,K,G,hd) bf16, 16-byte aligned; pools (n_blocks, block, K, hd) bf16
// (kv_dtype 1, kv_scale 1) or int8 x a power-of-two kv_scale (2), int8 words (3) or
// (n_blocks, block, K, hd/2) int4 words (4) with k_exp/v_exp (n_blocks, K) i32 (null
// otherwise); bt (B,max_blocks) i32; pos0 (B,) i32; out like q; hd a multiple of 16 in
// [16, 256]; block a multiple of 16; n_split 1, 2 or 4 thread blocks (one cluster) per
// (query tile, b, kv_head).  Returns cudaGetLastError().
extern "C" int gqa_prefill_launch(const void* q, const void* k_pool, const void* v_pool,
                                  const void* bt, const void* pos0, const void* k_exp,
                                  const void* v_exp, void* out, int B, int K, int T, int G,
                                  int hd, int block, int max_blocks, int window, int kv_dtype,
                                  int n_split, float scale, float cap, float kv_scale,
                                  void* stream) {
  const bool quant = kv_dtype == kQ8 || kv_dtype == kQ4;
  auto aligned = [](const void* ptr, int n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; };
  const long long TG = static_cast<long long>(T) * G;
  if (B < 1 || K < 1 || T < 1 || G < 1 || hd < 16 || hd > 256 || hd % 16 || block < 16 ||
      block % 16 || max_blocks < 1 || window < 1 || kv_dtype < repro::kBF16 || kv_dtype > kQ4 ||
      (n_split != 1 && n_split != 2 && n_split != 4) || (quant && (!k_exp || !v_exp)) ||
      !aligned(q, 16) || !aligned(out, 4) || static_cast<long long>(B) * K > 65535 ||
      (TG + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillParams p;
  p.bt = static_cast<const int*>(bt);
  p.pos0 = static_cast<const int*>(pos0);
  p.k_exp = static_cast<const int*>(k_exp);
  p.v_exp = static_cast<const int*>(v_exp);
  p.T = T; p.K = K; p.G = G; p.TG = static_cast<int>(TG); p.hd = hd; p.block = block;
  p.max_blocks = max_blocks; p.window = window; p.n_split = n_split;
  const int elt_bits = kv_dtype == repro::kBF16 ? 16 : kv_dtype == kQ4 ? 4 : 8;
  p.row_bytes = hd * elt_bits / 8;
  p.tpitch = 2 * hd + 16;
  p.pitch = kv_dtype == repro::kBF16 ? p.tpitch : (p.row_bytes + 15) / 16 * 16;
  p.chunk = p.row_bytes % 16 == 0 && aligned(k_pool, 16) && aligned(v_pool, 16) ? 16
            : p.row_bytes % 8 == 0 && aligned(k_pool, 8) && aligned(v_pool, 8) ? 8 : 0;
  if (!p.chunk) return static_cast<int>(cudaErrorInvalidValue);
  p.stage_bytes = 2 * kKeys * p.pitch + 32;
  const int loop = kRows * p.tpitch + kStages * p.stage_bytes +
                   (kv_dtype == repro::kBF16 ? 0 : 2 * kKeys * p.tpitch);
  const int merge = kRows * (hd + 4) * static_cast<int>(sizeof(float));
  p.region = ((loop > merge ? loop : merge) + 15) / 16 * 16;
  if (prefill_smem_bytes(p) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  p.scale = scale; p.cap = cap; p.kv_scale = kv_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == repro::kBF16)
    return launch_prefill_dims<repro::kBF16>(q, k_pool, v_pool, out, p, B, st);
  if (kv_dtype == repro::kI8)
    return launch_prefill_dims<repro::kI8>(q, k_pool, v_pool, out, p, B, st);
  if (kv_dtype == kQ8) return launch_prefill_dims<kQ8>(q, k_pool, v_pool, out, p, B, st);
  return launch_prefill_dims<kQ4>(q, k_pool, v_pool, out, p, B, st);
}
