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
// layer recompiles and the host never synchronises on it.  At prefill (M up
// to 512; C up to 80 per expert) the same kernel re-reads the words once per
// 4-row tile from L2; it runs on the CUDA cores in fp32, which is exact for
// |m| <= 7 — tensor cores are later work.
#include "common.cuh"

namespace {

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
