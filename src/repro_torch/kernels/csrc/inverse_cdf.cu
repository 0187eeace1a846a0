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
// byte; the per-row parameters add 3·K·C·4 B.  The solve service calls it
// on u [2048, 64, 2] (proxy1d) and [2048, 64, 1] (the imaging noise), 2.1
// and 1.1 MB, which a launch outlasts; the GAN trainer's preset draws u
// [8192, 100, 2], 13.3 MB (4.0 us at 3.35 TB/s).
//
// Design: a warp takes whole rows r of u, one at a time (at most 8 blocks
// of 8 warps an SM: one wave, one row a warp, at the service's and the
// trainer's shapes).  It reads the row's C values of mu, s and k once
// into registers (C = 1 and 2 are template cases; other C read them per
// element), then walks the row's E * C contiguous elements with 16-byte
// loads and stores (4 fp32 or 8 bf16), two a lane in flight, offsets
// 32-bit from the row's base.  Where u, y and the row length are all
// 16-byte multiples (both main paths), that is all; otherwise a scalar
// head and tail take the elements before a row's first 16-byte boundary
// and after its last, and a row whose u and y are not equally misaligned
// (a view at an odd offset) is all scalar.  One wave of loads, then the
// arithmetic, then the stores: holding the next row's loads in flight
// with fewer blocks an SM was slower at u [8192, 100, 2] (PERF.md §6).
//
// Numerics: built WITHOUT --use_fast_math, so logf and the division are
// the accurate versions (__logf misses rtol 1e-4 near u = 0.5).  The clamp
// is written with comparisons so NaN stays NaN, as jnp.clip does; fmaxf /
// fminf would replace it.
//
// Interface: plain C functions, loaded with ctypes (repro_torch/kernels/
// build.py).  Each launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.  `repro_inverse_cdf_floor`
// launches an empty kernel on the grid the sampler would take: the launch
// floor that the sampler's time is measured against.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kEps = 1e-6f;
constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;             // 2048 threads an SM

__device__ __forceinline__ float icdf(float x, float mu, float s, float k) {
  x = x < kEps ? kEps : x;                  // NaN compares false: kept
  x = x > 1.0f - kEps ? 1.0f - kEps : x;
  return mu + s * logf(x / (1.0f - x)) + k * (x - 0.5f);
}

// The parameters of one row: for C = 1 and 2 in registers, else read per
// element (channel ch of row r at p[ch]).
template <typename TP, int C> struct RowParams {
  float mu[C], s[C], k[C];
  __device__ __forceinline__ RowParams(const TP *mu_r, const TP *s_r,
                                       const TP *k_r, int) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mu[c] = to_float(mu_r[c]);
      s[c] = to_float(s_r[c]);
      k[c] = to_float(k_r[c]);
    }
  }
  // element i of the row (i counted from the row's base)
  __device__ __forceinline__ float operator()(float x, int i) const {
    const int c = C == 1 ? 0 : (i & 1);
    return icdf(x, mu[c], s[c], k[c]);
  }
};
template <typename TP> struct RowParams<TP, 0> {
  const TP *mu, *s, *k;
  int c;
  __device__ __forceinline__ RowParams(const TP *mu_r, const TP *s_r,
                                       const TP *k_r, int c_)
      : mu(mu_r), s(s_r), k(k_r), c(c_) {}
  __device__ __forceinline__ float operator()(float x, int i) const {
    const int ch = i % c;
    return icdf(x, to_float(mu[ch]), to_float(s[ch]), to_float(k[ch]));
  }
};

// 16 bytes of u -> 16 bytes of y for elements [i0, i0 + N) of a row
template <typename TU, typename F>
__device__ __forceinline__ typename Vec<TU>::Raw apply(
    const typename Vec<TU>::Raw &v, const F &f, int i0) {
  float x[Vec<TU>::N];
  Vec<TU>::unpack(v, x);
#pragma unroll
  for (int j = 0; j < Vec<TU>::N; ++j) x[j] = f(x[j], i0 + j);
  return Vec<TU>::pack(x);
}

// Rows r, r + warps, ... of one warp.  Aligned: u and y 16-byte aligned
// and every row a whole number of 16-byte vectors (the service's and the
// trainer's shapes), so each row is vectors alone and element i0 of a
// vector is even.  Otherwise each row has a scalar head up to its first
// 16-byte boundary, the vectors, and a scalar tail; it is all scalar when
// u and y are misaligned against each other.
template <typename TU, typename TP, int C, bool Aligned>
__device__ __forceinline__ void icdf_rows(
    const TU *__restrict__ u, const TP *__restrict__ mu,
    const TP *__restrict__ s, const TP *__restrict__ k, TU *__restrict__ y,
    int64_t rows, int len, int c, int64_t r, int64_t warps, int lane) {
  using Raw = typename Vec<TU>::Raw;
  constexpr int N = Vec<TU>::N;
  for (; r < rows; r += warps) {
    const TU *ur = u + r * len;
    TU *yr = y + r * len;
    const RowParams<TP, C> f(mu + r * c, s + r * c, k + r * c, c);
    int head = 0, nvec = len / N;
    if (!Aligned) {
      const uintptr_t au = reinterpret_cast<uintptr_t>(ur) & 15;
      const uintptr_t ay = reinterpret_cast<uintptr_t>(yr) & 15;
      head = len;
      nvec = 0;
      if (au == ay && au % sizeof(TU) == 0) {
        head = (int)((16 - au) % 16 / sizeof(TU));
        head = head < len ? head : len;
        nvec = (len - head) / N;
      }
      for (int i = lane; i < head; i += 32)
        yr[i] = from_float<TU>(f(to_float(ur[i]), i));
    }
    const Raw *uv = reinterpret_cast<const Raw *>(ur + head);
    Raw *yv = reinterpret_cast<Raw *>(yr + head);
    for (int q = lane; q < nvec; q += 64) {
      const bool two = q + 32 < nvec;      // both loads before any store
      const Raw a = uv[q];
      Raw b{};
      if (two) b = uv[q + 32];
      yv[q] = apply<TU>(a, f, head + q * N);
      if (two) yv[q + 32] = apply<TU>(b, f, head + (q + 32) * N);
    }
    if (!Aligned)
      for (int i = head + nvec * N + lane; i < len; i += 32)
        yr[i] = from_float<TU>(f(to_float(ur[i]), i));
  }
}

// C: 1, 2, or 0 for any other channel count (then c_any is it).
template <typename TU, typename TP, int C>
__global__ void __launch_bounds__(kThreads)
    icdf_kernel(const TU *__restrict__ u, const TP *__restrict__ mu,
                const TP *__restrict__ s, const TP *__restrict__ k,
                TU *__restrict__ y, int64_t rows, int e, int c_any,
                int aligned) {
  const int c = C > 0 ? C : c_any;
  const int len = e * c;                   // elements of a row, < 2^31
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  if (aligned)
    icdf_rows<TU, TP, C, true>(u, mu, s, k, y, rows, len, c, r, warps,
                               threadIdx.x & 31);
  else
    icdf_rows<TU, TP, C, false>(u, mu, s, k, y, rows, len, c, r, warps,
                                threadIdx.x & 31);
}

__global__ void floor_kernel() {}

// the grid of a launch over `rows` rows: one warp a row, at most
// kBlocksPerSm blocks an SM (then each warp takes several rows)
unsigned grid_for(int64_t rows) {
  const int64_t most = (int64_t)hopper::device_limits().sms * kBlocksPerSm;
  const int64_t want = (rows + kWarps - 1) / kWarps;
  return (unsigned)(want < most ? want : most);
}

template <typename TU, typename TP>
int launch(const void *u, const void *mu, const void *s, const void *k,
           void *y, int64_t rows, int64_t e, int64_t c, cudaStream_t stream) {
  if (rows * e * c == 0) return 0;
  const unsigned grid = grid_for(rows);
  const TU *u_ = static_cast<const TU *>(u);
  const TP *mu_ = static_cast<const TP *>(mu), *s_ = static_cast<const TP *>(s),
           *k_ = static_cast<const TP *>(k);
  TU *y_ = static_cast<TU *>(y);
  const int64_t row_bytes = e * c * (int64_t)sizeof(TU);
  const int aligned = reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                      row_bytes % 16 == 0;
  if (c == 1)
    icdf_kernel<TU, TP, 1><<<grid, kThreads, 0, stream>>>(
        u_, mu_, s_, k_, y_, rows, (int)e, 1, aligned);
  else if (c == 2)
    icdf_kernel<TU, TP, 2><<<grid, kThreads, 0, stream>>>(
        u_, mu_, s_, k_, y_, rows, (int)e, 2, aligned);
  else
    icdf_kernel<TU, TP, 0><<<grid, kThreads, 0, stream>>>(
        u_, mu_, s_, k_, y_, rows, (int)e, (int)c, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok),
// or -1 for a dtype code or a row of 2^31 elements or more.
extern "C" int repro_inverse_cdf(const void *u, const void *mu, const void *s,
                                 const void *k, void *y, int64_t rows,
                                 int64_t e, int64_t c, int u_dtype,
                                 int p_dtype, void *stream) {
  if (e * c >= ((int64_t)1 << 31)) return -1;
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

// An empty kernel on the grid repro_inverse_cdf takes for `rows` rows.
extern "C" int repro_inverse_cdf_floor(int64_t rows, void *stream) {
  if (rows == 0) return 0;
  floor_kernel<<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(
                                                  stream)>>>();
  return (int)cudaGetLastError();
}
