// Fused SYMOG optimizer step (paper Alg. 1 lines 15-17: SGD with Nesterov
// momentum, the Eq. 4 regularizer gradient and the §3.4 weight clip), for
// Hopper (sm_90a).  Per element, with scalars Δ, λ_eff = λ·2/M_l, η, μ:
//
//   m     = clip(rint(w/Δ), ±qmax)          (round half to even)
//   g_tot = g + λ_eff·(w − m·Δ)
//   v'    = μ·v + g_tot
//   w'    = clip(w − η·(g_tot + μ·v'), ±Δ·qmax)
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
//     recompiles nothing.
// Arithmetic uses the IEEE round-to-nearest intrinsics (__fdiv_rn, __fmul_rn,
// __fadd_rn, __fsub_rn), which nvcc never contracts into FMAs: the kernel
// performs the plain version's operations in its order and gives its results
// bit for bit.  w/Δ is exact for a power of two Δ only with IEEE division,
// so the library is not built with --use_fast_math.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Scalars {
  float delta, lam_eff, lr, mu, qmax, lim;
};

__device__ __forceinline__ void step(float& w, float g, float& v, const Scalars& s) {
  const float m = fminf(fmaxf(rintf(__fdiv_rn(w, s.delta)), -s.qmax), s.qmax);
  const float q = __fmul_rn(m, s.delta);
  const float g_tot = __fadd_rn(g, __fmul_rn(s.lam_eff, __fsub_rn(w, q)));
  const float v_new = __fadd_rn(__fmul_rn(s.mu, v), g_tot);
  const float upd = __fadd_rn(g_tot, __fmul_rn(s.mu, v_new));
  w = fminf(fmaxf(__fsub_rn(w, __fmul_rn(s.lr, upd)), -s.lim), s.lim);
  v = v_new;
}

__global__ void __launch_bounds__(kThreads)
symog_update_kernel(float* __restrict__ w, const float* __restrict__ g, float* __restrict__ v,
                    const float* __restrict__ delta, long long n, long long n_vec, float lam_eff,
                    float lr, float mu, float qmax) {
  Scalars s;
  s.delta = *delta;
  s.lam_eff = lam_eff;
  s.lr = lr;
  s.mu = mu;
  s.qmax = qmax;
  s.lim = __fmul_rn(s.delta, qmax);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* w4 = reinterpret_cast<float4*>(w);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = tid; i < n_vec; i += stride) {
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
    float a = w[i], c = v[i];
    step(a, g[i], c, s);
    w[i] = a;
    v[i] = c;
  }
}

}  // namespace

// w, v (n,) fp32 updated in place; g (n,) fp32; delta one fp32 on the device.
// blocks: the grid size the wrapper chose (a few per SM).  Returns cudaError_t.
extern "C" int symog_update_launch(void* w, const void* g, void* v, const void* delta,
                                   long long n, float lam_eff, float lr, float mu, float qmax,
                                   int blocks, void* stream) {
  if (n < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(v)) & 15u;
  const long long n_vec = mis == 0 ? n / 4 : 0;
  symog_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<const float*>(g), static_cast<float*>(v),
      static_cast<const float*>(delta), n, n_vec, lam_eff, lr, mu, qmax);
  return static_cast<int>(cudaGetLastError());
}
