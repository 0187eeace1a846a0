// Inverse-CDF event sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_icdf_kernel` in
// src/repro/kernels/inverse_cdf.py (line 23), which the JAX package launches
// once per observable channel on a [K, E] slab.  Here ONE launch covers the
// whole [K, E, C] uniform tensor in its native layout:
//
//     y[r, e, c] = mu[r, c] + s[r, c] * log(u / (1 - u)) + k[r, c] * (u - 0.5)
//
// with u = clamp(u[r, e, c], 1e-6, 1 - 1e-6), fp32 math, and y written in
// u's dtype (fp32 or bf16, the two the TPU kernel takes).
//
// Bound: bytes.  Each element reads 4 B of u and writes 4 B of y (2 + 2 in
// bf16) for ~10 fp32 operations, far below the card's ~20 operations per
// byte; the per-row parameters add 3·K·C·4 B.  At the solve service's main
// path shape, u [2048, 64, 2] fp32, that is ~2.1 MB, ~0.6 us at 3.35 TB/s,
// so a launch costs more than the work: the kernel is launch- and
// bandwidth-bound.  Design: a grid-stride loop, one element a thread per
// step, consecutive threads on consecutive addresses (coalesced); the
// parameter reads are cached in L1/L2.  Making it fast (vector loads,
// fusing into the caller) is later work.
//
// Numerics: built WITHOUT --use_fast_math, so logf and the division are
// the accurate versions (__logf misses rtol 1e-4 near u = 0.5).  The clamp
// is written with comparisons so NaN stays NaN, as jnp.clip does; fmaxf /
// fminf would replace it.
//
// Interface: a plain C function, loaded with ctypes (repro_torch/kernels/
// build.py).  It launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM on an H100

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename TU, typename TP>
__global__ void __launch_bounds__(kThreads)
    icdf_kernel(const TU *__restrict__ u, const TP *__restrict__ mu,
                const TP *__restrict__ s, const TP *__restrict__ k,
                TU *__restrict__ y, int64_t n, int64_t ec, int64_t c) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t p = (i / ec) * c + i % c;  // row r, channel c of u[r, e, c]
    float x = to_float(u[i]);
    x = x < kEps ? kEps : x;                  // NaN compares false: kept
    x = x > 1.0f - kEps ? 1.0f - kEps : x;
    const float v = to_float(mu[p]) + to_float(s[p]) * logf(x / (1.0f - x)) +
                    to_float(k[p]) * (x - 0.5f);
    y[i] = from_float<TU>(v);
  }
}

template <typename TU, typename TP>
int launch(const void *u, const void *mu, const void *s, const void *k,
           void *y, int64_t rows, int64_t e, int64_t c, cudaStream_t stream) {
  const int64_t n = rows * e * c;
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  icdf_kernel<TU, TP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TU *>(u), static_cast<const TP *>(mu),
      static_cast<const TP *>(s), static_cast<const TP *>(k),
      static_cast<TU *>(y), n, e * c, c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok),
// or -1 for a dtype code it does not take.
extern "C" int repro_inverse_cdf(const void *u, const void *mu, const void *s,
                                 const void *k, void *y, int64_t rows,
                                 int64_t e, int64_t c, int u_dtype,
                                 int p_dtype, void *stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_dtype == 0 && p_dtype == 0)
    return launch<float, float>(u, mu, s, k, y, rows, e, c, st);
  if (u_dtype == 0 && p_dtype == 1)
    return launch<float, __nv_bfloat16>(u, mu, s, k, y, rows, e, c, st);
  if (u_dtype == 1 && p_dtype == 0)
    return launch<__nv_bfloat16, float>(u, mu, s, k, y, rows, e, c, st);
  if (u_dtype == 1 && p_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(u, mu, s, k, y, rows, e, c,
                                                 st);
  return -1;
}
