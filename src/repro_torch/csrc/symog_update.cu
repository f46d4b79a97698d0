// Fused SYMOG optimizer step (paper Alg. 1 lines 15-17: SGD with Nesterov
// momentum, the Eq. 4 regularizer gradient and the §3.4 weight clip), for
// Hopper (sm_90a).  Per element, with Δ, λ_eff = λ·2/M_l, η, μ:
//
//   m     = clip(rint(w/Δ), ±qmax)          (round half to even)
//   g_tot = (g + λ_eff·(w − m·Δ))·s
//   v'    = μ·v + g_tot
//   w'    = clip(w − η·(g_tot + μ·v'), ±Δ·qmax)
//
// s is the clip scale of a chain(clip_by_global_norm(c), sgd) step, read
// from device memory (s = min(1, c/(√Σ + 1e-9)), made on the device from the
// norm pass below), or 1 (by value; ×1 is exact, so the unclipped step's
// bits are unchanged).
//
// The norm pass, `symog_sqnorm_kernel`, is the clip's Σ over one leaf:
// Σ (g + λ_eff·(w − m·Δ))², with m, the product and the sum of the update's
// own arithmetic, so both passes agree on q bit for bit.  Each thread sums
// its grid-stride elements in order, each block its threads in a fixed
// tree, and the last block to finish sums the per-block partials in a fixed
// order: two calls on one device give the same bits.  It reads w and g,
// 8 B an element.
//
// Δ is one value for the whole tensor, or one per leading group of `group`
// consecutive elements (element i takes delta[i / group]): an MoE expert
// stack (L, E, D, F) with one f per (layer, expert) is E·L groups of D·F.
//
// Replaces the Pallas TPU kernel repro/kernels/symog_update/kernel.py
// `_kernel` (launched by `symog_update_2d`).
//
// What bounds it on the H100: bytes.  Five fp32 streams, 20 B per element
// (read w, g, v; write w', v') against ~12 flops: the full-width
// internlm2-1.8b update moves 34 GB, 10.1 ms at 3.35 TB/s.  The design
// streams each element once:
//   * a grid-stride loop over 16-byte vectors (float4) when w, g and v are
//     16-byte aligned, then a scalar loop over the tail (n % 4 elements), or
//     over everything when a pointer is not aligned; any n, no padding to the
//     TPU's (R, 128) tiles;
//   * w and v are updated IN PLACE (JAX returns new arrays);
//   * Δ is read from device memory (the leaf's fp32 2^-f, made once), so the
//     host never learns f; λ_eff, η, μ and qmax come by value — a new value
//     recompiles nothing;
//   * a Δ per group is a template instance of its own, so the single-Δ loop
//     stays as it was.  Grouped, the vector loop reads one Δ per float4
//     (the wrapper takes it only when `group` is a multiple of 4, so that no
//     vector straddles two groups) and the scalar loop one per element; the
//     clip limit Δ·qmax follows Δ.  The gather is ≤ L·E floats, L1-resident,
//     against 20 B an element: the byte bound is unchanged.
// Arithmetic uses the IEEE round-to-nearest intrinsics (__fdiv_rn, __fmul_rn,
// __fadd_rn, __fsub_rn), which nvcc never contracts into FMAs: the kernel
// performs the plain version's operations in its order and gives its results
// bit for bit.  w/Δ is exact for a power of two Δ only with IEEE division,
// so the library is not built with --use_fast_math.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float delta, lam_eff, lr, mu, qmax, lim, gscale;
};

// g + λ_eff·(w − m·Δ): the update's and the norm pass's shared arithmetic
__device__ __forceinline__ float total_grad(float w, float g, const Scalars& s) {
  const float m = fminf(fmaxf(rintf(__fdiv_rn(w, s.delta)), -s.qmax), s.qmax);
  const float q = __fmul_rn(m, s.delta);
  return __fadd_rn(g, __fmul_rn(s.lam_eff, __fsub_rn(w, q)));
}

__device__ __forceinline__ void step(float& w, float g, float& v, const Scalars& s) {
  const float g_tot = __fmul_rn(total_grad(w, g, s), s.gscale);
  const float v_new = __fadd_rn(__fmul_rn(s.mu, v), g_tot);
  const float upd = __fadd_rn(g_tot, __fmul_rn(s.mu, v_new));
  w = fminf(fmaxf(__fsub_rn(w, __fmul_rn(s.lr, upd)), -s.lim), s.lim);
  v = v_new;
}

__device__ __forceinline__ void set_delta(Scalars& s, float d) {
  s.delta = d;
  s.lim = __fmul_rn(d, s.qmax);
}

template <bool kGrouped>
__global__ void __launch_bounds__(kThreads)
symog_update_kernel(float* __restrict__ w, const float* __restrict__ g, float* __restrict__ v,
                    const float* __restrict__ delta, const float* __restrict__ gscale,
                    long long n, long long n_vec, long long group, float lam_eff, float lr,
                    float mu, float qmax, float gscale_value) {
  Scalars s;
  s.lam_eff = lam_eff;
  s.lr = lr;
  s.mu = mu;
  s.qmax = qmax;
  s.gscale = gscale != nullptr ? __ldg(gscale) : gscale_value;
  if (!kGrouped) set_delta(s, *delta);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* w4 = reinterpret_cast<float4*>(w);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = tid; i < n_vec; i += stride) {
    if (kGrouped) set_delta(s, __ldg(delta + (i * 4) / group));
    float4 a = w4[i];
    const float4 b = g4[i];
    float4 c = v4[i];
    step(a.x, b.x, c.x, s);
    step(a.y, b.y, c.y, s);
    step(a.z, b.z, c.z, s);
    step(a.w, b.w, c.w, s);
    w4[i] = a;
    v4[i] = c;
  }
  for (long long i = n_vec * 4 + tid; i < n; i += stride) {
    if (kGrouped) set_delta(s, __ldg(delta + i / group));
    float a = w[i], c = v[i];
    step(a, g[i], c, s);
    w[i] = a;
    v[i] = c;
  }
}

template <bool kGrouped>
__global__ void __launch_bounds__(kThreads)
symog_sqnorm_kernel(const float* __restrict__ w, const float* __restrict__ g,
                    const float* __restrict__ delta, long long n, long long n_vec,
                    long long group, float lam_eff, float qmax, float* __restrict__ partials,
                    unsigned int* __restrict__ done, float* __restrict__ out) {
  __shared__ float red[kThreads];
  __shared__ bool last;
  Scalars s;
  s.lam_eff = lam_eff;
  s.qmax = qmax;
  if (!kGrouped) set_delta(s, *delta);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float acc = 0.f;
  auto add = [&](float a, float b) {
    const float t = total_grad(a, b, s);
    acc = __fadd_rn(acc, __fmul_rn(t, t));
  };
  for (long long i = tid; i < n_vec; i += stride) {
    if (kGrouped) set_delta(s, __ldg(delta + (i * 4) / group));
    const float4 a = w4[i];
    const float4 b = g4[i];
    add(a.x, b.x);
    add(a.y, b.y);
    add(a.z, b.z);
    add(a.w, b.w);
  }
  for (long long i = n_vec * 4 + tid; i < n; i += stride) {
    if (kGrouped) set_delta(s, __ldg(delta + i / group));
    add(w[i], g[i]);
  }
  // fixed-order tree over the block's threads
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + off]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = red[0];
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the partials in block order, then the same tree
  __threadfence();
  float sum = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
    sum = __fadd_rn(sum, __ldcg(partials + b));
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + off]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *out = red[0];
    *done = 0u;  // ready for the next launch that reuses the counter
  }
}

}  // namespace

// w, v (n,) fp32 updated in place; g (n,) fp32; delta n / group fp32 values on the
// device (group == n: one Δ).  gscale: one fp32 clip scale on the device, or null for
// gscale_value.  blocks: the grid size the wrapper chose (a few per SM).
// Returns cudaError_t.
extern "C" int symog_update_launch(void* w, const void* g, void* v, const void* delta,
                                   const void* gscale, long long n, long long group,
                                   float lam_eff, float lr, float mu, float qmax,
                                   float gscale_value, int blocks, void* stream) {
  if (n < 0 || blocks < 1 || group < 1 || (n > 0 && n % group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const bool grouped = group != n;
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(v)) & 15u;
  // a float4 must not straddle two groups
  const long long n_vec = mis == 0 && (!grouped || group % 4 == 0) ? n / 4 : 0;
  auto* wp = static_cast<float*>(w);
  auto* gp = static_cast<const float*>(g);
  auto* vp = static_cast<float*>(v);
  auto* dp = static_cast<const float*>(delta);
  auto* sp = static_cast<const float*>(gscale);
  auto st = static_cast<cudaStream_t>(stream);
  if (grouped)
    symog_update_kernel<true><<<blocks, kThreads, 0, st>>>(wp, gp, vp, dp, sp, n, n_vec, group,
                                                           lam_eff, lr, mu, qmax, gscale_value);
  else
    symog_update_kernel<false><<<blocks, kThreads, 0, st>>>(wp, gp, vp, dp, sp, n, n_vec, group,
                                                            lam_eff, lr, mu, qmax, gscale_value);
  return static_cast<int>(cudaGetLastError());
}

// The norm pass: out[0] = Σ (g + λ_eff·(w − q))² over w, g (n,) fp32, with delta as above.
// partials: `blocks` fp32 of scratch; done: a uint32 counter that is 0 at launch (the
// kernel leaves it 0).  Returns cudaError_t.
extern "C" int symog_sqnorm_launch(const void* w, const void* g, const void* delta,
                                   long long n, long long group, float lam_eff, float qmax,
                                   void* partials, void* done, void* out, int blocks,
                                   void* stream) {
  if (n < 0 || blocks < 1 || group < 1 || (n > 0 && n % group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float), st));
  const bool grouped = group != n;
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g)) & 15u;
  const long long n_vec = mis == 0 && (!grouped || group % 4 == 0) ? n / 4 : 0;
  auto* wp = static_cast<const float*>(w);
  auto* gp = static_cast<const float*>(g);
  auto* dp = static_cast<const float*>(delta);
  auto* pp = static_cast<float*>(partials);
  auto* cp = static_cast<unsigned int*>(done);
  auto* op = static_cast<float*>(out);
  if (grouped)
    symog_sqnorm_kernel<true><<<blocks, kThreads, 0, st>>>(wp, gp, dp, n, n_vec, group, lam_eff,
                                                           qmax, pp, cp, op);
  else
    symog_sqnorm_kernel<false><<<blocks, kThreads, 0, st>>>(wp, gp, dp, n, n_vec, group,
                                                            lam_eff, qmax, pp, cp, op);
  return static_cast<int>(cudaGetLastError());
}
