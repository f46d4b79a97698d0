// Fixed-point matmul with 2/4-bit packed SYMOG weights, for Hopper (sm_90a).
//
//   y (M,N) = x (M,K) · (m (K,N) · 2^-f) + b (N)             (2-D form)
//   y[e] (C,N) = x[e] (C,K) · (m[e] (K,N) · 2^-f[e])          (experts form)
//
// Replaces the Pallas TPU kernel repro/kernels/fixedpoint_matmul/kernel.py
// `_kernel` (launched by `fixedpoint_matmul_padded`), and its MoE-stack form
// ops.py `fixedpoint_matmul_experts`, which runs the same body under
// `jax.vmap` with one exponent per expert.  Each int8 word holds 8/n_bits
// two's-complement mantissas along N, little-endian within the byte; they
// are decoded as in kernel.py: `& 0xFF`, shift, mask, `(f ^ sign) - sign`.
//
// What bounds it on the H100: at decode (M = n_slots, a handful of rows;
// the MoE decode gives each expert C = 4 slots) the work is a matrix-vector
// product and the bound is the weight bytes, K·N·n_bits/8 per matrix (4 MB
// for a 2048x8192 2-bit projection, ~1.3 us at 3.35 TB/s; 33.6 MB for one
// olmoe stack of 64 2048x1024 experts, ~10 us).  The design is built around
// streaming those words once:
//   * each thread owns one 32-bit word of a weight row (16 columns at 2 bits,
//     8 at 4 bits), so a warp reads 128 contiguous bytes of a row per load;
//   * the 8 warps of a block walk different rows K of the same 128-byte
//     column group, 8 rows per warp per step with all 8 loads issued before
//     the first use (one load in flight per warp is latency-bound: ~100 GB/s
//     on an H100 SXM, chip_smoke.py);
//   * the experts form adds the expert to grid.y (one launch for the whole
//     stack, no loop over experts); every offset that crosses experts is a
//     size_t (a stacked olmoe leaf holds 2^31 elements);
//   * enough blocks exist to fill the 132 SMs by splitting K across blocks
//     (grid.z) when the column groups x row tiles x experts are few; the
//     block's warps are summed by a fixed-order tree in shared memory;
//   * mantissas are unpacked in registers next to the FMAs, never written
//     back; each thread keeps MT x 16 fp32 accumulators for MT rows of x;
//   * the split-K partial sums go to an fp32 workspace and a second small
//     kernel sums them in a fixed order (deterministic: no atomics), applies
//     the exact power-of-two scale 2^-f (2^-f[e]) ONCE and the bias, and
//     casts to x's dtype — the epilogue of the TPU kernel's last K step.
// f is read from device memory (a runtime scalar or (E,) vector), so no
// layer recompiles and the host never synchronises on it.  This streaming
// kernel serves fp32 activations (the MoE serves' fp32 head, the fp32
// parity runs) and bf16 rows that are not 16-byte aligned (ops.py
// `_pick_route`).  It runs on the CUDA cores in fp32 (exact for |m| <= 7),
// where at 2 bits and 4 rows a byte of words costs 16 FMAs: the cores, not
// the bytes, bound it, so bf16 calls take `fpmm_decode` (up to 8 rows) or
// `fpmm_tc` (prefill) instead.
//
// fpmm_tc: the tensor-core route (bf16 x, M or C at or above the threshold).
// At prefill the work is compute-bound (2·M·K·N operations against K·N/4
// bytes of 2-bit words: 256 operations per byte at M = 128), the regime the
// TPU kernel runs through the MXU (kernel.py:50: bf16 mantissas, fp32
// accumulator); the expert stacks at C <= 20 stay bound by their words.
// Design:
//   * `mma.sync.m16n8k16` bf16 with fp32 accumulators in registers, with
//     A and B swapped: the kernel computes yᵀ = (m·2^-f)ᵀ · xᵀ, so the
//     16-row MMA operand is 16 output columns and the 8-wide operand is 8
//     tokens.  A warp owns 128 columns (2-bit; 64 at 4 bits) and a block's
//     32 tokens (four n8 tiles; tiles past the call's last token are
//     skipped), so an experts call at C = 2..80 pays for 8-token granules,
//     not 64-row tiles.  (`wgmma`, the only way to the card's full
//     tensor-core rate, is later work.)
//   * the words are dequantized straight into A fragments, never through
//     shared memory: lane (g, t) of a warp owns word g of its 8-word group
//     in each weight row, so it holds 16 (8) columns of rows 2t, 2t+1,
//     2t+8, 2t+9 of each 16-row step; `prmt` pairs rows 2t / 2t+1 per
//     16-bit half, and field i of the low / high half becomes A-tile i's
//     rows g / g+8 (the column permutation is undone in the epilogue).  A
//     field becomes bf16 by one `lop3` ((f ^ sign) | 0x4300 in the
//     mantissa: 128 + (f ^ sign)·2^p) and one bf16x2 FMA (·2^-p, minus
//     128·2^-p + sign), exact, two fields per instruction pair, with a
//     shift only once per 3 fields (2-bit) or per field (4-bit);
//   * a pipeline step of weight rows and the x tile (32 tokens, K-major,
//     rows padded by 16 bytes so that `ldmatrix` hits distinct banks) go
//     to shared memory by `cp.async` (16-byte chunks; a row of words that
//     is not 16-byte aligned, N = 200 or 40, is copied by plain loads),
//     in a ring of 4 stages: the next 3 steps' copies overlap this step's
//     MMAs, and each 16-row MMA step's operands are read while the one
//     before it runs.  Rows past K and tokens past M are zero-filled;
//   * three block shapes, picked by the host (ops.py `_tc_tile`; columns at
//     2 bits): `lines`, 4 warps side by side over 512 columns, 128 rows a
//     step, where its grid fills the card (every expert stack, the wide 2-D
//     projections): each weight row is read as whole 128-byte lines;
//     `narrow`, one 128-column tile whose 4 warps split each 128-row step;
//     `deep`, the narrow tile with 8 warps on 256-row steps, for calls of
//     few tiles.  The warps that split a step sum their accumulators by a
//     fixed-order tree through shared memory;
//   * a call of few tiles (a 32-token k_proj has 8) also splits K across a
//     cluster of up to 4 blocks (grid.z): rank 0 adds the other blocks'
//     sums from their shared memory (distributed shared memory), in rank
//     order — no atomics, no global workspace, deterministic;
//   * the epilogue applies 2^-f[e] (ldexpf) and the bias once and writes y
//     in bf16: one launch per call, no fp32 workspace, no second kernel;
//   * the expert and the column tile share grid.x (E x column tiles <
//     2^31), token tiles grid.y, so 256 experts cannot overflow the grid.
//
// fpmm_decode: the decode route (bf16 x, 1..8 rows: M = n_slots, C per
// expert, the smallest prefill capacities).  At 4 rows a 2-bit byte of
// words is 32 bf16 MMA operations, far below the tensor cores' 295 a byte,
// so the words bound it (a deepseek-v3 MoE layer's 3 stacks: 2.82 GB,
// 0.84 ms at 3.35 TB/s); but only if the dequantization keeps pace, which
// fp32 FMAs on the CUDA cores do not.  Design:
//   * the tensor cores with A and B swapped as in fpmm_tc, the tokens ONE
//     n8 tile (no 32-token block tile), the words dequantized by the same
//     `prmt` / `lop3` / bf16x2 FMA straight into A fragments;
//   * a ring of 128-row stages in shared memory, filled by `cp.async`
//     16-byte chunks, 48 KB of words in flight a block (4 stages of 128-byte
//     rows, 7 of 64, 13 of 32): the card's byte-latency product spread over
//     132 SMs is ~25 KB an SM, and two blocks share an SM;
//   * 8 warps a block: wn side by side on 32 word bytes each (wn = 4, 2, 1,
//     picked by the host from the shape, ops.py `_decode_tile`), the other
//     8 / wn splitting each stage's rows;
//   * K split across a thread-block cluster of up to 8 blocks where the
//     tiles are few: each block folds its warps' sums (K slice order) into
//     a (token, column) tile, and each rank finishes 1/split of the
//     columns, adding the ranks' tiles in rank order through distributed
//     shared memory (deterministic; one launch, no workspace, no atomics);
//   * the experts form takes `rows` (E,), each expert's kept rows: every
//     block builds the list of occupied experts on the device (a ballot
//     and prefix count over E <= 256) and the clusters walk the (occupied
//     expert, column tile) items in grid stride.  The grid is sized by the
//     host from a bound (`max_active`) only, so a wrong bound costs time,
//     never an expert; there is no host sync.  An empty expert's words are
//     not read: its output is written +0, what its zero rows of x give;
//   * the epilogue applies 2^-f[e] and the bias once and writes bf16 pairs.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::ldsm_x4;
using repro::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupBytes = 32 * 4;  // one 32-bit word per lane
constexpr int kUnroll = 8;           // weight rows in flight per warp

template <typename T, int NBITS, int MT>
__global__ void __launch_bounds__(kThreads)
fpmm_partial(const T* __restrict__ x, const uint8_t* __restrict__ w, float* __restrict__ ws,
             int E, int M, int K, int N, int nbytes, int rows_per_split, int m_tiles,
             int aligned) {
  constexpr int PER = 8 / NBITS;   // fields per byte
  constexpr int COLS = 4 * PER;    // columns per 32-bit word
  constexpr int MASK = (1 << NBITS) - 1;
  constexpr int SIGN = 1 << (NBITS - 1);
  constexpr int TILE = MT * COLS * 32;
  __shared__ float red[kWarps / 2][TILE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int word = blockIdx.x * 32 + lane;  // word index within a weight row
  const int e = blockIdx.y / m_tiles;       // expert (0 in the 2-D form)
  const int m0 = (blockIdx.y - e * m_tiles) * MT;
  const int split = blockIdx.z;
  x += static_cast<size_t>(e) * M * K;
  w += static_cast<size_t>(e) * K * nbytes;
  const int k0 = split * rows_per_split;
  const int k1 = min(K, k0 + rows_per_split);
  const int b0 = word * 4;                  // first byte of this lane's word

  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  // each warp takes kUnroll consecutive rows per step and issues all their
  // loads before the first use, so kUnroll row reads are in flight per warp
  for (int kb = k0 + warp * kUnroll; kb < k1; kb += kWarps * kUnroll) {
    uint32_t u[kUnroll];
    float xv[kUnroll][MT];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int k = kb + i;
      u[i] = 0;
      if (k < k1) {
        const uint8_t* row = w + static_cast<size_t>(k) * nbytes;
        if (aligned && b0 + 4 <= nbytes) {
          u[i] = __ldg(reinterpret_cast<const uint32_t*>(row + b0));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (b0 + j < nbytes) u[i] |= static_cast<uint32_t>(row[b0 + j]) << (8 * j);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[i][m] = (k < k1 && m0 + m < M)
                       ? repro::to_f32(x[static_cast<size_t>(m0 + m) * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int field = static_cast<int>((u[i] >> (c * NBITS)) & MASK);
        const float wv = static_cast<float>((field ^ SIGN) - SIGN);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[i][m], wv, acc[m][c]);
      }
    }
  }

  // tree-reduce the 8 warps' partial sums in a fixed order (deterministic):
  // warps [h, 2h) hand their sums to warps [0, h) for h = 4, 2, 1
#pragma unroll
  for (int h = kWarps / 2; h >= 1; h >>= 1) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c) red[warp - h][(m * COLS + c) * 32 + lane] = acc[m][c];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[m][c] += red[warp][(m * COLS + c) * 32 + lane];
    }
    __syncthreads();
  }
  if (warp != 0) return;
  // column of (lane, c) is word * COLS + c
  const int col0 = word * COLS;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    float* dst = ws + ((static_cast<size_t>(split) * E + e) * M + m0 + m) * N;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (col0 + c < N) dst[col0 + c] = acc[m][c];
  }
}

template <typename T>
__global__ void fpmm_finish(const float* __restrict__ ws, const int* __restrict__ f,
                            const float* __restrict__ bias, T* __restrict__ y, int E, int M,
                            int N, int split) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t per_expert = static_cast<size_t>(M) * N;
  const size_t total = per_expert * E;
  if (i >= total) return;
  // 8 independent partial loads in flight, summed in a fixed order
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int p = 0;
  for (; p + 8 <= split; p += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) part[j] += ws[(p + j) * total + i];
  }
  for (int j = 0; p < split; ++p, ++j) part[j] += ws[p * total + i];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += part[j];
  float v = s * ldexpf(1.f, -f[i / per_expert]);  // exact power-of-two scale
  if (bias) v += bias[i % N];
  y[i] = repro::from_f32<T>(v);
}

struct Shape {
  int E, M, K, N, nbytes, split, rows, aligned;
};

template <typename T, int NBITS, int MT>
void launch_partial(const void* x, const void* w, float* ws, const Shape& s, cudaStream_t st) {
  const int m_tiles = (s.M + MT - 1) / MT;
  dim3 grid((s.nbytes + kGroupBytes - 1) / kGroupBytes, s.E * m_tiles, s.split);
  fpmm_partial<T, NBITS, MT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), ws, s.E, s.M, s.K, s.N,
      s.nbytes, s.rows, m_tiles, s.aligned);
}

template <typename T, int NBITS>
void dispatch_mt(int mt, const void* x, const void* w, float* ws, const Shape& s,
                 cudaStream_t st) {
  if (mt == 1) launch_partial<T, NBITS, 1>(x, w, ws, s, st);
  else if (mt == 2) launch_partial<T, NBITS, 2>(x, w, ws, s, st);
  else launch_partial<T, NBITS, 4>(x, w, ws, s, st);
}

template <typename T>
void launch_all(int n_bits, int mt, const void* x, const void* w, const void* f,
                const void* bias, void* y, float* ws, const Shape& s, cudaStream_t st) {
  if (n_bits == 2) dispatch_mt<T, 2>(mt, x, w, ws, s, st);
  else dispatch_mt<T, 4>(mt, x, w, ws, s, st);
  const size_t total = static_cast<size_t>(s.E) * s.M * s.N;
  const int threads = 64;  // small blocks: more of them in flight for the L2 reads
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  fpmm_finish<T><<<blocks, threads, 0, st>>>(ws, static_cast<const int*>(f),
                                             static_cast<const float*>(bias),
                                             static_cast<T*>(y), s.E, s.M, s.N, s.split);
}

int launch_checked(const void* x, const void* w, const void* f, const void* bias, void* y,
                   void* ws, int E, int M, int K, int N, int nbytes, int n_bits, int x_dtype,
                   int split, int m_tile, void* stream) {
  const int mt = m_tile == 1 ? 1 : m_tile == 2 ? 2 : 4;  // dispatch_mt's tile
  if ((n_bits != 2 && n_bits != 4) || E < 1 || M < 1 || K < 1 || N < 1 || split < 1 ||
      E > 65535 / ((M + mt - 1) / mt))  // grid.y = E x row tiles
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  s.E = E; s.M = M; s.K = K; s.N = N; s.nbytes = nbytes; s.split = split;
  s.rows = (K + split - 1) / split;
  s.aligned = (nbytes % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  float* wsf = static_cast<float*>(ws);
  if (x_dtype == repro::kF32)
    launch_all<float>(n_bits, m_tile, x, w, f, bias, y, wsf, s, st);
  else if (x_dtype == repro::kBF16)
    launch_all<__nv_bfloat16>(n_bits, m_tile, x, w, f, bias, y, wsf, s, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fpmm_tc: the tensor-core route (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kStages = 4;             // ring depth: 3 steps in flight
constexpr int kTok = 32;               // tokens per block: four n8 tiles a warp

// WN warps side by side on (128-column at 2 bits, 32-token) tiles, each
// tile's K steps split over KS warps, KSTEPS 16-row MMA steps a warp per
// pipeline step
template <int NBITS, int WN, int KS, int KSTEPS>
struct TcCfg {
  static constexpr int kWarps = WN * KS;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBK = 16 * KS * KSTEPS;     // weight rows per pipeline step
  static constexpr int kTiles = 16 / NBITS;        // m16 tiles per warp (fields per half word)
  static constexpr int kBytes = WN * 32;           // word bytes of a weight row per block
  static constexpr int kWRow = kBytes + 16;        // smem row stride: rows 2t on distinct banks
  static constexpr int kXRow = kBK * 2 + 16;       // smem row stride of x: ldmatrix rows too
  static constexpr int kStageBytes = kBK * kWRow + kTok * kXRow;
  static constexpr int kAcc = kTiles * 4 * 4;      // fp32 accumulators per thread
  // the K slices' tree, and one block's sums read by its cluster's rank 0
  static constexpr int kRedBytes = (KS > 1 ? KS / 2 : 1) * WN * kAcc * 32 * 4;
  static constexpr int kSmem =
      kStages * kStageBytes > kRedBytes ? kStages * kStageBytes : kRedBytes;
};

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {  // f(integral_constant<I>), ..., up to N
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    static_for<I + 1, N>(f);
  }
}

// bf16 bits of num * 2^-shift (num < 256: exact)
__host__ __device__ constexpr uint32_t bf16_bits(int num, int shift) {
  int p = 0;
  while ((num >> (p + 1)) != 0) ++p;
  return static_cast<uint32_t>(((127 + p - shift) << 7) | ((num - (1 << p)) << (7 - p)));
}

// Field I of both 16-bit halves of u (NBITS-bit two's complement) as a
// bf16 pair, exact: (f ^ sign) placed at bit P of the bf16 mantissa of 128
// gives 128 + (f ^ sign)·2^P; one FMA by 2^-P minus (128·2^-P + sign)
// leaves (f ^ sign) - sign.
template <int NBITS, int I>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t u) {
  constexpr int MASK = (1 << NBITS) - 1, SIGN = 1 << (NBITS - 1);
  constexpr int G = (7 / NBITS) * NBITS;  // field bits that fit the 7-bit mantissa at once
  constexpr int POS = I * NBITS;
  constexpr int BASE = (POS / G) * G;     // one shift per G bits
  constexpr int P = POS - BASE;
  constexpr uint32_t M2 = static_cast<uint32_t>(MASK << P) * 0x10001u;
  constexpr uint32_t X2 = static_cast<uint32_t>((SIGN << P) | 0x4300) * 0x10001u;
  constexpr uint32_t S2 = bf16_bits(1, P) * 0x10001u;
  constexpr uint32_t O2 = (bf16_bits(128 + (SIGN << P), P) | 0x8000u) * 0x10001u;
  uint32_t v, r;  // one lop3 (a & M2) ^ X2: X2 from a register, M2 the immediate
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(v) : "r"(u >> BASE), "n"(M2), "r"(X2));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(S2), "r"(O2));
  return r;
}

// 16-byte async copy; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a warp's accumulators to / from shared memory, lane-interleaved
template <int T>
__device__ __forceinline__ void store_acc(const float (&acc)[T][4][4], float* buf) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) buf[((i * 4 + j) * 4 + c) * 32] = acc[i][j][c];
}

template <int T>
__device__ __forceinline__ void add_acc(float (&acc)[T][4][4], const float* buf) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += buf[((i * 4 + j) * 4 + c) * 32];
}

template <int NBITS, int WN, int KS, int KSTEPS>
__global__ void __launch_bounds__(TcCfg<NBITS, WN, KS, KSTEPS>::kThreads)
fpmm_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
        const int* __restrict__ f, const float* __restrict__ bias,
        __nv_bfloat16* __restrict__ y, int M, int K, int N, int nbytes, int col_tiles,
        int vec16) {
  using C = TcCfg<NBITS, WN, KS, KSTEPS>;
  constexpr int kTiles = C::kTiles, kBK = C::kBK, kXRow = C::kXRow;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ks = warp % KS, wn = warp / KS;
  const int e = blockIdx.x / col_tiles;
  const int byte0 = (blockIdx.x - e * col_tiles) * C::kBytes;
  const int tok0 = blockIdx.y * kTok;
  x += static_cast<size_t>(e) * M * K;
  w += static_cast<size_t>(e) * K * nbytes;
  y += static_cast<size_t>(e) * M * N;
  const int fe = f[e];
  // the cluster's blocks (grid.z) split the K steps into contiguous ranges
  const int split = blockIdx.z, n_split = gridDim.z;
  const int all_steps = (K + kBK - 1) / kBK;
  const int per_split = (all_steps + n_split - 1) / n_split;
  const int first = split * per_split;
  const int n_steps = max(0, min(all_steps, first + per_split) - first);
  // n8 tiles of this warp that hold tokens (warp-uniform)
  const int nt = min(4, (M - tok0 + 7) / 8);

  auto load_stage = [&](int stage, int step) {
    uint8_t* sw = smem + stage * C::kStageBytes;
    uint8_t* sx = sw + kBK * C::kWRow;
    const int k0 = (first + step) * kBK;
    constexpr int kChunks = C::kBytes / 16;  // 16-byte chunks of a word row
    for (int c = tid; c < kBK * kChunks; c += C::kThreads) {
      const int r = c / kChunks, j = c - r * kChunks;
      const int k = k0 + r, b = byte0 + j * 16;
      uint8_t* dst = sw + r * C::kWRow + j * 16;
      if (vec16) {  // nbytes % 16 == 0: a chunk is whole or past the row
        const bool ok = k < K && b < nbytes;
        cp_async16(dst, ok ? w + static_cast<size_t>(k) * nbytes + b : w, ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (k < K) {
          const uint8_t* row = w + static_cast<size_t>(k) * nbytes;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (b + i < nbytes) v[i >> 2] |= static_cast<uint32_t>(row[b + i]) << (8 * (i & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    constexpr int kXChunks = kBK / 8;  // 16-byte chunks of a token's K step
    for (int c = tid; c < kTok * kXChunks; c += C::kThreads) {
      const int r = c / kXChunks, j = c - r * kXChunks;
      const int tok = tok0 + r, k = k0 + j * 8;
      const bool ok = tok < M && k < K;  // K % 8 == 0: a chunk is whole or past the row
      cp_async16(sx + r * kXRow + j * 16, ok ? x + static_cast<size_t>(tok) * K + k : x,
                 ok ? 16 : 0);
    }
  };

  float acc[kTiles][4][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }
  // per-lane offsets in a stage: the words of rows 2t (+1, +8, +9) of this
  // warp's K slice, word g of the warp's group; the ldmatrix row of x
  // (lanes 8m..8m+7 address matrix m: tokens 8 (m >> 1) + .., k 8 (m & 1) + ..)
  const int w_off = (ks * 16 + 2 * t) * C::kWRow + (wn * 8 + g) * 4;
  const int x_off = (((lane >> 4) * 8 + (lane & 7)) * kXRow + ((lane >> 3) & 1) * 16) + ks * 32;
  constexpr int kQ = kBK / 16 / KS;  // 16-row MMA steps of a warp per pipeline step
  struct Frags {
    uint32_t w[4];     // words of rows 2t, 2t+1, 2t+8, 2t+9
    uint32_t b[4][2];  // x fragments of the four n8 tiles
  };
  // a 16-row step's operands from shared memory
  auto load_frags = [&](const uint8_t* sw, int q, Frags& fr) {
    const uint8_t* wp = sw + w_off + q * KS * 16 * C::kWRow;
    fr.w[0] = *reinterpret_cast<const uint32_t*>(wp);
    fr.w[1] = *reinterpret_cast<const uint32_t*>(wp + C::kWRow);
    fr.w[2] = *reinterpret_cast<const uint32_t*>(wp + 8 * C::kWRow);
    fr.w[3] = *reinterpret_cast<const uint32_t*>(wp + 9 * C::kWRow);
    const uint8_t* xp = sw + kBK * C::kWRow + x_off + q * KS * 32;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t r[4] = {0u, 0u, 0u, 0u};
      if (2 * jj < nt) ldsm_x4(r, xp + jj * 16 * kXRow);
      fr.b[2 * jj][0] = r[0];
      fr.b[2 * jj][1] = r[1];
      fr.b[2 * jj + 1][0] = r[2];
      fr.b[2 * jj + 1][1] = r[3];
    }
  };
  int stage = 0;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tiles are in; every warp is done with step - 1's
    const int next = step + kStages - 1;
    if (next < n_steps) load_stage(next % kStages, next);
    cp_async_commit();
    const uint8_t* sw = smem + stage * C::kStageBytes;
    stage = stage == kStages - 1 ? 0 : stage + 1;
    if (nt == 0) continue;
    Frags cur, nxt;
    load_frags(sw, 0, cur);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (q + 1 < kQ) load_frags(sw, q + 1, nxt);  // in flight under this step's MMAs
      // rows (2t, 2t+1) and (2t+8, 2t+9) paired per 16-bit half: low halves
      // hold fields 0..kTiles-1 (A rows g), high halves the rest (rows g+8)
      const uint32_t lo01 = __byte_perm(cur.w[0], cur.w[1], 0x5410);
      const uint32_t hi01 = __byte_perm(cur.w[0], cur.w[1], 0x7632);
      const uint32_t lo89 = __byte_perm(cur.w[2], cur.w[3], 0x5410);
      const uint32_t hi89 = __byte_perm(cur.w[2], cur.w[3], 0x7632);
      static_for<0, kTiles>([&](auto tile) {
        constexpr int i = decltype(tile)::value;
        const uint32_t a[4] = {dequant_pair<NBITS, i>(lo01), dequant_pair<NBITS, i>(hi01),
                               dequant_pair<NBITS, i>(lo89), dequant_pair<NBITS, i>(hi89)};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nt) mma_bf16(acc[i][j], a, cur.b[j][0], cur.b[j][1]);
      });
      if (q + 1 < kQ) cur = nxt;
    }
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {
    // the K slices' sums, by a fixed-order tree through shared memory:
    // slices [h, 2h) hand theirs to slices [0, h) for h = KS/2, ..., 1
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = KS / 2; h >= 1; h >>= 1) {
      __syncthreads();  // every warp is done with the ring, or with the last round
      float* buf = red + static_cast<size_t>((ks % h) * WN + wn) * C::kAcc * 32 + lane;
      if (ks >= h && ks < 2 * h) store_acc(acc, buf);
      __syncthreads();
      if (ks < h) add_acc(acc, buf);
    }
  }
  if (n_split > 1) {
    // the cluster's K ranges: rank 0 adds the others' sums from their
    // shared memory, in rank order (deterministic; no global workspace)
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(smem) + static_cast<size_t>(wn) * C::kAcc * 32 + lane;
    __syncthreads();  // the tree's last reads are done
    if (ks == 0) store_acc(acc, part);
    cluster.sync();
    if (split == 0 && ks == 0)
      for (int r = 1; r < n_split; ++r) add_acc(acc, cluster.map_shared_rank(part, r));
    cluster.sync();  // every block's sums stay until rank 0 has read them
  }
  if (split > 0) return;  // the whole block: its sums are in rank 0's

  // epilogue: the scale and bias applied, the block's 32 x kCols bf16 tile
  // is laid out in shared memory (A-tile i, row g -> field i of the lane's
  // word, row g+8 -> field kTiles + i; accumulator c -> row g + 8 (c >> 1),
  // token 2t + (c & 1)) and written to y in coalesced 4-byte pairs
  constexpr int kColsW = 8 * (32 / NBITS);  // columns of a warp
  constexpr int kCols = WN * kColsW;        // columns of the block
  constexpr int kORow = kCols + 8;          // halves per staged token row
  static_assert(kTok * kORow * 2 <= C::kSmem, "the output tile fits the ring");
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  const float scale = ldexpf(1.f, -fe);  // exact power-of-two scale
  const int col_blk = (byte0 / 4) * (32 / NBITS);
  __syncthreads();  // every read of the ring and of the sums' buffers is done
  if (ks == 0) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = wn * kColsW + g * (32 / NBITS) + h * kTiles + i;
        const float bv = bias && col_blk + c < N ? bias[col_blk + c] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float v = acc[i][j][2 * h + p] * scale;
            if (bias) v += bv;
            out[(j * 8 + 2 * t + p) * kORow + c] = __float2bfloat16(v);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < kTok * kCols / 2; q += C::kThreads) {
    const int r = q / (kCols / 2), c = (q - r * (kCols / 2)) * 2;
    const int tok = tok0 + r, col = col_blk + c;
    if (tok < M && col < N)  // N is even: the pair is whole
      *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(tok) * N + col) =
          *reinterpret_cast<const uint32_t*>(out + r * kORow + c);
  }
}

template <int NBITS, int WN, int KS, int KSTEPS>
int launch_tc_cfg(const void* x, const void* w, const void* f, const void* bias, void* y, int E,
                  int M, int K, int N, int nbytes, int vec16, int split, cudaStream_t st) {
  using C = TcCfg<NBITS, WN, KS, KSTEPS>;
  const int col_tiles = (nbytes + C::kBytes - 1) / C::kBytes;
  const long long gx = static_cast<long long>(E) * col_tiles;
  const int gy = (M + kTok - 1) / kTok;
  if (gx > 2147483647LL || gy > 65535 || split > 8 || split > (K + C::kBK - 1) / C::kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fpmm_tc<NBITS, WN, KS, KSTEPS>;
  if (C::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(gx), gy, split);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* fp = static_cast<const int*>(f);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (split == 1) {
    kern<<<grid, C::kThreads, C::kSmem, st>>>(xp, wp, fp, bp, yp, M, K, N, nbytes, col_tiles,
                                              vec16);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = grid;
  lc.blockDim = dim3(C::kThreads, 1, 1);
  lc.dynamicSmemBytes = C::kSmem;
  lc.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;  // one cluster per tile
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  lc.attrs = cluster;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, kern, xp, wp, fp, bp, yp, M, K, N, nbytes,
                                       col_tiles, vec16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// tile 0: lines (4 warps side by side over 512 columns at 2 bits: each
// weight row read as whole 128-byte lines); 1: narrow (one 128-column tile,
// 4 warps split each 128-row K step); 2: deep (the narrow tile, 8 warps
// split each 256-row K step, two per scheduler).  32 tokens a block.
// split > 1 (narrow and deep): a cluster of that many blocks per tile
// splits K.
int launch_tc(const void* x, const void* w, const void* f, const void* bias, void* y, int E,
              int M, int K, int N, int nbytes, int n_bits, int tile, int split, void* stream) {
  if ((n_bits != 2 && n_bits != 4) || tile < 0 || tile > 2 || E < 1 || M < 1 || K < 1 ||
      N < 1 || N % 2 != 0 || K % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || split < 1 ||
      (split > 1 && tile == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec16 = (nbytes % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
#define REPRO_TC_TILE(NB, WN, KS, KSTEPS) \
  launch_tc_cfg<NB, WN, KS, KSTEPS>(x, w, f, bias, y, E, M, K, N, nbytes, vec16, split, st)
  if (n_bits == 2) {
    if (tile == 0) return REPRO_TC_TILE(2, 4, 1, 8);
    if (tile == 1) return REPRO_TC_TILE(2, 1, 4, 2);
    return REPRO_TC_TILE(2, 1, 8, 2);
  }
  if (tile == 0) return REPRO_TC_TILE(4, 4, 1, 8);
  if (tile == 1) return REPRO_TC_TILE(4, 1, 4, 2);
  return REPRO_TC_TILE(4, 1, 8, 2);
#undef REPRO_TC_TILE
}

// ---------------------------------------------------------------------------
// fpmm_decode: the decode route (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kDecTok = 8;                 // every token of the call: one n8 tile
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBK = 128;                // weight rows per ring stage
constexpr int kDecXRow = kDecBK * 2 + 16;  // smem row stride of x: b0/b1 loads on distinct banks
constexpr int kDecMaxE = 256;              // experts a `rows` vector may hold
constexpr int kDecRedStride = 33;          // floats a sums' slot: 32 lanes + 1 (banks)
constexpr int kDecMaxSplit = 8;            // blocks a cluster may split K over

// WN warps side by side on 32 word bytes each (128 columns at 2 bits), the
// other 8 / WN warps splitting each stage's 128 rows
template <int NBITS, int WN>
struct DecCfg {
  static constexpr int kKS = kDecWarps / WN;
  static constexpr int kQ = kDecBK / 16 / kKS;    // 16-row MMA steps of a warp per stage
  static constexpr int kTiles = 16 / NBITS;       // m16 tiles per warp
  static constexpr int kBytes = WN * 32;          // word bytes of a row per block
  static constexpr int kWRow = kBytes + 16;       // smem row stride: rows 2t on distinct banks
  static constexpr int kStageBytes = kDecBK * kWRow + kDecTok * kDecXRow;
  // ring depth (stages - 1 in flight): 48 KB of words a block at every width
  static constexpr int kStages = WN == 4 ? 4 : WN == 2 ? 7 : 13;
  static constexpr int kSlots = kTiles * 4;       // fp32 accumulators per lane
  static constexpr int kRedBytes = kDecWarps * kSlots * kDecRedStride * 4;
  static constexpr int kColsW = 8 * (32 / NBITS);  // columns of a warp
  static constexpr int kCols = WN * kColsW;        // columns of the block
  static constexpr int kTRow = kCols + 4;          // floats a token row of the folded tile
  static constexpr int kSums = kRedBytes + kDecTok * kTRow * 4;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kSmem = kRing > kSums ? kRing : kSums;
};

template <int NBITS, int WN, bool EXPERTS>
__global__ void __launch_bounds__(kDecThreads, 2)
fpmm_decode(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
            const int* __restrict__ f, const float* __restrict__ bias,
            const int* __restrict__ rows, __nv_bfloat16* __restrict__ y, int E, int M, int K,
            int N, int nbytes, int col_tiles, int split, int vec16) {
  using D = DecCfg<NBITS, WN>;
  constexpr int kTiles = D::kTiles, kKS = D::kKS, kQ = D::kQ, kWRow = D::kWRow;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_occ[kDecMaxE];   // experts that hold a row, in expert order
  __shared__ int s_free[kDecMaxE];  // the others
  __shared__ int s_count[2];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, ks = warp / WN;
  const int rank = split > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const size_t per_expert = static_cast<size_t>(M) * N;  // output elements of one expert

  int n_work = E;  // experts to compute
  if (EXPERTS && rows != nullptr) {
    // the occupied-expert list, built on the device: warp 0 reads rows[]
    // (all loads in flight at once) and places each expert by a ballot and
    // a prefix count; every block builds the same list
    if (warp == 0) {
      int r[kDecMaxE / 32];
#pragma unroll
      for (int j = 0; j < kDecMaxE / 32; ++j) {
        const int e = j * 32 + lane;
        r[j] = e < E ? rows[e] : 0;
      }
      const unsigned below = (1u << lane) - 1u;
      int n_occ = 0, n_free = 0;
#pragma unroll
      for (int j = 0; j < kDecMaxE / 32; ++j) {
        const int e = j * 32 + lane;
        const bool occ = e < E && r[j] > 0, fre = e < E && r[j] <= 0;
        const unsigned mo = __ballot_sync(0xffffffffu, occ);
        const unsigned mf = __ballot_sync(0xffffffffu, fre);
        if (occ) s_occ[n_occ + __popc(mo & below)] = e;
        if (fre) s_free[n_free + __popc(mf & below)] = e;
        n_occ += __popc(mo);
        n_free += __popc(mf);
      }
      if (lane == 0) {
        s_count[0] = n_occ;
        s_count[1] = n_free;
      }
    }
    __syncthreads();
    n_work = s_count[0];
  }

  // the cluster's blocks split the K steps into contiguous ranges
  const int all_steps = (K + kDecBK - 1) / kDecBK;
  const int per_split = (all_steps + split - 1) / split;
  const int first = rank * per_split;
  const int n_steps = max(0, min(all_steps, first + per_split) - first);
  const int n_items = n_work * col_tiles;
  const int n_clusters = gridDim.x / split;
  float* red = reinterpret_cast<float*>(smem);

  // each cluster walks the (occupied expert, column tile) items in grid
  // stride: a grid sized for fewer experts than hold rows only loops more
  for (int item = blockIdx.x / split; item < n_items; item += n_clusters) {
    const int j = item / col_tiles;
    const int e = !EXPERTS ? 0 : rows != nullptr ? s_occ[j] : j;
    const int byte0 = (item - j * col_tiles) * D::kBytes;
    const __nv_bfloat16* xe = x + static_cast<size_t>(e) * M * K;
    const uint8_t* we = w + static_cast<size_t>(e) * K * nbytes;

    auto load_stage = [&](int stage, int step) {
      uint8_t* sw = smem + stage * D::kStageBytes;
      uint8_t* sx = sw + kDecBK * kWRow;
      const int k0 = (first + step) * kDecBK;
      constexpr int kChunks = D::kBytes / 16;  // 16-byte chunks of a word row
#pragma unroll
      for (int i = 0; i < kDecBK * kChunks / kDecThreads; ++i) {
        const int c = tid + i * kDecThreads;
        const int r = c / kChunks, jj = c - r * kChunks;
        const int k = k0 + r, b = byte0 + jj * 16;
        uint8_t* dst = sw + r * kWRow + jj * 16;
        if (vec16) {  // nbytes % 16 == 0: a chunk is whole or past the row
          const bool ok = k < K && b < nbytes;
          cp_async16(dst, ok ? we + static_cast<size_t>(k) * nbytes + b : we, ok ? 16 : 0);
        } else {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (k < K) {
            const uint8_t* row = we + static_cast<size_t>(k) * nbytes;
#pragma unroll
            for (int q = 0; q < 16; ++q)
              if (b + q < nbytes) v[q >> 2] |= static_cast<uint32_t>(row[b + q]) << (8 * (q & 3));
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      constexpr int kXChunks = kDecBK / 8;  // 16-byte chunks of a token's stage
      if (tid < kDecTok * kXChunks) {
        const int r = tid / kXChunks, jj = tid - r * kXChunks;
        const int k = k0 + jj * 8;
        const bool ok = r < M && k < K;  // K % 8 == 0: a chunk is whole or past the row
        cp_async16(sx + r * kDecXRow + jj * 16, ok ? xe + static_cast<size_t>(r) * K + k : xe,
                   ok ? 16 : 0);
      }
    };

    float acc[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

#pragma unroll
    for (int s = 0; s < D::kStages - 1; ++s) {
      if (s < n_steps) load_stage(s, s);
      cp_async_commit();
    }
    // this lane's words (rows 2t, 2t+1, 2t+8, 2t+9 of each 16-row step of
    // the warp's share, word g of its 32-byte group) and x pairs (token g,
    // k 2t and 2t+8 of the step)
    const int w_lane = (ks * kQ * 16 + 2 * t) * kWRow + (wn * 8 + g) * 4;
    const int x_lane = kDecBK * kWRow + g * kDecXRow + (ks * kQ * 16 + 2 * t) * 2;
    int stage = 0;
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait<D::kStages - 2>();
      __syncthreads();  // this step's stage is in; every warp is done with step - 1's
      const int next = step + D::kStages - 1;
      if (next < n_steps) load_stage(next % D::kStages, next);
      cp_async_commit();
      const uint8_t* sw = smem + stage * D::kStageBytes;
      stage = stage == D::kStages - 1 ? 0 : stage + 1;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const uint8_t* wp = sw + w_lane + q * 16 * kWRow;
        const uint8_t* xp = sw + x_lane + q * 32;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + kWRow);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wp + 8 * kWRow);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wp + 9 * kWRow);
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xp + 16);
        // rows (2t, 2t+1) and (2t+8, 2t+9) paired per 16-bit half, as in fpmm_tc
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5410);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7632);
        const uint32_t lo89 = __byte_perm(w8, w9, 0x5410);
        const uint32_t hi89 = __byte_perm(w8, w9, 0x7632);
        static_for<0, kTiles>([&](auto tile) {
          constexpr int i = decltype(tile)::value;
          const uint32_t a[4] = {dequant_pair<NBITS, i>(lo01), dequant_pair<NBITS, i>(hi01),
                                 dequant_pair<NBITS, i>(lo89), dequant_pair<NBITS, i>(hi89)};
          mma_bf16(acc[i], a, b0, b1);
        });
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: it holds the sums next

    // every warp's sums, lane-interleaved; the K slices' sums folded in
    // slice order into the block's (token, column) tile; then the cluster's
    // blocks each finish their share of the tile's columns, adding the
    // ranks' tiles in rank order (deterministic; no atomics, no workspace)
    {
      float* mine = red + static_cast<size_t>(warp) * D::kSlots * kDecRedStride + lane;
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) mine[(i * 4 + c) * kDecRedStride] = acc[i][c];
    }
    __syncthreads();
    float* tile = red + D::kRedBytes / 4;
#pragma unroll
    for (int q = tid; q < WN * D::kSlots * 32; q += kDecThreads) {
      // (warp column wc, slot = 4 A-tile + accumulator, lane): accumulator c
      // holds column half c >> 1 and token 2t + (c & 1)
      const int ln = q & 31, slot = (q >> 5) % D::kSlots, wc = (q >> 5) / D::kSlots;
      float v = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < kKS; ++k2)
        v += red[((k2 * WN + wc) * D::kSlots + slot) * kDecRedStride + ln];
      const int i = slot >> 2, c = slot & 3;
      const int tok = 2 * (ln & 3) + (c & 1);
      const int col = wc * D::kColsW + (ln >> 2) * (32 / NBITS) + (c >> 1) * kTiles + i;
      tile[tok * D::kTRow + col] = v;
    }
    if (split > 1) cluster.sync();
    else __syncthreads();
    const float scale = ldexpf(1.f, -f[e]);  // exact power-of-two scale
    const int col_blk = byte0 * (8 / NBITS);
    const int cpr = D::kCols / split;  // columns this rank finishes (even)
    for (int q = tid; q < M * (cpr / 2); q += kDecThreads) {
      const int tok = q / (cpr / 2);
      const int col = rank * cpr + 2 * (q - tok * (cpr / 2));  // within the block's tile
      if (col_blk + col >= N) continue;  // N is even: the pair is whole
      const int idx = tok * D::kTRow + col;
      float2 part[kDecMaxSplit];
#pragma unroll
      for (int r = 0; r < kDecMaxSplit; ++r)  // every rank's pair in flight at once
        if (r < split)
          part[r] = *reinterpret_cast<const float2*>(
              (split > 1 ? cluster.map_shared_rank(tile, r) : tile) + idx);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int r = 0; r < kDecMaxSplit; ++r)
        if (r < split) {
          v0 += part[r].x;
          v1 += part[r].y;
        }
      v0 *= scale;
      v1 *= scale;
      if (bias) {
        v0 += bias[col_blk + col];
        v1 += bias[col_blk + col + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(e) * per_expert +
                                         static_cast<size_t>(tok) * N + col_blk + col) =
          __floats2bfloat162_rn(v0, v1);
    }
    // every block's sums stay until the cluster has read them, and the
    // ring is free again for the next item
    if (split > 1) cluster.sync();
    else __syncthreads();
  }
  if (EXPERTS && rows != nullptr) {
    // an expert that holds no row gets +0 everywhere, written by every
    // block in grid stride once its items are done (their loads go first):
    // its words are never read and 2^-f[e] never applied (what the all-zero
    // rows of x would give, for any finite f)
    const size_t all = static_cast<size_t>(s_count[1]);
    const size_t gtid = static_cast<size_t>(blockIdx.x) * kDecThreads + tid;
    const size_t gstride = static_cast<size_t>(gridDim.x) * kDecThreads;
    if (per_expert % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
      const size_t per = per_expert / 8;
      for (size_t i = gtid; i < all * per; i += gstride) {
        const size_t j = i / per;
        reinterpret_cast<uint4*>(y + static_cast<size_t>(s_free[j]) * per_expert)[i - j * per] =
            make_uint4(0u, 0u, 0u, 0u);
      }
    } else {  // N is even: pairs
      const size_t per = per_expert / 2;
      for (size_t i = gtid; i < all * per; i += gstride) {
        const size_t j = i / per;
        reinterpret_cast<uint32_t*>(y + static_cast<size_t>(s_free[j]) * per_expert)[i - j * per] =
            0u;
      }
    }
  }
}

template <int NBITS, int WN, bool EXPERTS>
int launch_decode_cfg(const void* x, const void* w, const void* f, const void* bias,
                      const void* rows, void* y, int E, int M, int K, int N, int nbytes,
                      int vec16, int split, int n_clusters, cudaStream_t st) {
  using D = DecCfg<NBITS, WN>;
  const int col_tiles = (nbytes + D::kBytes - 1) / D::kBytes;
  const long long gx = static_cast<long long>(n_clusters) * split;
  if (gx > 2147483647LL || static_cast<long long>(E) * col_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fpmm_decode<NBITS, WN, EXPERTS>;
  if (D::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           D::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* fp = static_cast<const int*>(f);
  const auto* bp = static_cast<const float*>(bias);
  const auto* rp = static_cast<const int*>(rows);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const dim3 grid(static_cast<unsigned>(gx), 1, 1);
  if (split == 1) {
    kern<<<grid, kDecThreads, D::kSmem, st>>>(xp, wp, fp, bp, rp, yp, E, M, K, N, nbytes,
                                              col_tiles, split, vec16);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = grid;
  lc.blockDim = dim3(kDecThreads, 1, 1);
  lc.dynamicSmemBytes = D::kSmem;
  lc.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;  // the blocks of one item
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  lc.attrs = cluster;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, kern, xp, wp, fp, bp, rp, yp, E, M, K, N, nbytes,
                                       col_tiles, split, vec16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_decode(const void* x, const void* w, const void* f, const void* bias,
                  const void* rows, void* y, int E, int M, int K, int N, int nbytes, int n_bits,
                  int wn, int split, int n_clusters, int experts, void* stream) {
  if ((n_bits != 2 && n_bits != 4) || (wn != 1 && wn != 2 && wn != 4) ||
      (split != 1 && split != 2 && split != 4 && split != kDecMaxSplit) || E < 1 || M < 1 ||
      M > kDecTok || K < 1 || K % 8 != 0 || N < 2 || N % 2 != 0 || n_clusters < 1 ||
      nbytes != N * n_bits / 8 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 4 != 0 || (rows != nullptr && E > kDecMaxE) ||
      (!experts && (E != 1 || rows != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec16 = (nbytes % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
#define REPRO_DEC(NB, WN)                                                                 \
  (experts ? launch_decode_cfg<NB, WN, true>(x, w, f, bias, rows, y, E, M, K, N, nbytes, vec16, \
                                             split, n_clusters, st)                            \
           : launch_decode_cfg<NB, WN, false>(x, w, f, bias, rows, y, E, M, K, N, nbytes,      \
                                              vec16, split, n_clusters, st))
  if (n_bits == 2) {
    if (wn == 4) return REPRO_DEC(2, 4);
    if (wn == 2) return REPRO_DEC(2, 2);
    return REPRO_DEC(2, 1);
  }
  if (wn == 4) return REPRO_DEC(4, 4);
  if (wn == 2) return REPRO_DEC(4, 2);
  return REPRO_DEC(4, 1);
#undef REPRO_DEC
}

}  // namespace

// x (M,K) f32|bf16 contiguous; w (K, nbytes) int8 contiguous, nbytes = N*n_bits/8;
// f int32 scalar on the device; bias (N,) f32 or null; y (M,N) in x's dtype;
// ws (split, M, N) f32 scratch.  Returns cudaGetLastError().
extern "C" int fixedpoint_matmul_launch(const void* x, const void* w, const void* f,
                                        const void* bias, void* y, void* ws, int M, int K,
                                        int N, int nbytes, int n_bits, int x_dtype, int split,
                                        int m_tile, void* stream) {
  return launch_checked(x, w, f, bias, y, ws, 1, M, K, N, nbytes, n_bits, x_dtype, split,
                        m_tile, stream);
}

// x (E,C,K) f32|bf16 contiguous; w (E, K, nbytes) int8 contiguous; f (E,) int32 on the
// device; y (E,C,N) in x's dtype; ws (split, E, C, N) f32 scratch.  Returns cudaGetLastError().
extern "C" int fixedpoint_matmul_experts_launch(const void* x, const void* w, const void* f,
                                                void* y, void* ws, int E, int C, int K, int N,
                                                int nbytes, int n_bits, int x_dtype, int split,
                                                int m_tile, void* stream) {
  return launch_checked(x, w, f, nullptr, y, ws, E, C, K, N, nbytes, n_bits, x_dtype, split,
                        m_tile, stream);
}

// Tensor-core route.  x (M,K) bf16 contiguous, 16-byte aligned, K % 8 == 0;
// w (K, nbytes) int8; f int32 scalar on the device; bias (N,) f32 or null;
// y (M,N) bf16.  tile: 0 lines, 1 narrow, 2 deep; split: blocks per cluster
// splitting K (1..8, narrow and deep only).  Returns cudaGetLastError().
extern "C" int fixedpoint_matmul_tc_launch(const void* x, const void* w, const void* f,
                                           const void* bias, void* y, int M, int K, int N,
                                           int nbytes, int n_bits, int tile, int split,
                                           void* stream) {
  return launch_tc(x, w, f, bias, y, 1, M, K, N, nbytes, n_bits, tile, split, stream);
}

// Tensor-core route, experts form.  x (E,C,K) bf16 as above; w (E, K, nbytes)
// int8; f (E,) int32 on the device; y (E,C,N) bf16.  Returns cudaGetLastError().
extern "C" int fixedpoint_matmul_experts_tc_launch(const void* x, const void* w, const void* f,
                                                   void* y, int E, int C, int K, int N,
                                                   int nbytes, int n_bits, int tile,
                                                   int split, void* stream) {
  return launch_tc(x, w, f, nullptr, y, E, C, K, N, nbytes, n_bits, tile, split, stream);
}

// Decode route (bf16 x, 1..8 rows; one template for both forms).  x (E,M,K)
// bf16 contiguous, 16-byte aligned, K % 8 == 0; w (E, K, nbytes) int8; f (E,)
// int32 on the device; bias (N,) f32 or null; rows (E,) int32 on the device
// or null (experts form only): the rows of x[e] that hold a token (E <= 256);
// an expert with none is written +0 and its words are not read; y (E,M,N)
// bf16.  wn: warps side by side (1, 2, 4: 32, 64, 128 word bytes a block);
// split: blocks per cluster splitting K (1, 2, 4, 8); n_clusters: clusters of
// the grid, which walk the (occupied expert, column tile) items in grid
// stride; experts: 0 for the 2-D form (E = 1, no rows), 1 for the experts
// form (its own kernel symbol, so that a profile tells the two apart).
// Returns cudaGetLastError().
extern "C" int fixedpoint_matmul_decode_launch(const void* x, const void* w, const void* f,
                                               const void* bias, const void* rows, void* y,
                                               int E, int M, int K, int N, int nbytes,
                                               int n_bits, int wn, int split, int n_clusters,
                                               int experts, void* stream) {
  return launch_decode(x, w, f, bias, rows, y, E, M, K, N, nbytes, n_bits, wn, split,
                       n_clusters, experts, stream);
}
