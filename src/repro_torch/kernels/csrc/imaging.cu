// The imaging problems' forward operators for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/imaging.py:
//
//   mask_apply  `_mask_kernel` (line 45):  y[k, p] = x[k, p] * m[p]
//               (the inpainting occlusion, problem `imaging`)
//   blur2d      `_blur_kernel` (line 87):  separable 3-tap (0.25, 0.5, 0.25)
//               blur of each [H, W] image, rows then columns, zero boundary
//               (problem `imaging_blur`)
//
// Both take fp32 or bf16, do fp32 math and write x's dtype, as the TPU
// kernels do.  The solve service calls them on x [2048, 1024] and
// x [2048, 32, 32] fp32 (DEFAULT preset, 16 ranks x 128 candidates).
//
// Bound: bytes, for both.  Each element is read once and written once
// (4 + 4 B in fp32) for 1 (mask) or ~8 (blur) fp32 operations, far below
// the card's ~20 operations per byte.  At the DEFAULT shape that is
// 16.8 MB, ~5.0 us at 3.35 TB/s, for each kernel.
//
// mask_apply: a grid-stride loop, one element a thread per step,
// consecutive threads on consecutive addresses (coalesced); m[p] is reused
// by every row and stays in L1/L2.  The product is one fp32 multiply, so
// the result equals the plain version bitwise.
//
// blur2d: one block per tile of `images` whole images.  The tile is
// staged in shared memory as fp32 (one coalesced read of the block's
// contiguous images), then every output pixel is computed from its 3x3
// neighbourhood there, in the plain version's order: the vertical pass
// v = 0.5 * x + 0.25 * (up + down) at columns c-1, c, c+1, then
// y = 0.5 * v + 0.25 * (left + right), with zero outside the image.  The
// products by 0.5 and 0.25 are exact, so whether nvcc contracts a line
// into an FMA does not change its rounding (outside subnormal values).
// A 32x32 image is 4 KB of shared memory; an image of any H x W whose tile
// fits in the block's shared memory (227 KB) is taken.
//
// Numerics: built WITHOUT --use_fast_math.  Interface: plain C functions
// loaded with ctypes (repro_torch/kernels/build.py); each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() after
// the launch.  The fp32/bf16 helpers repeat those of inverse_cdf.cu, so
// that each source builds alone.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kW0 = 0.5f;   // repro.kernels.imaging BLUR_W0
constexpr float kW1 = 0.25f;  // BLUR_W1
constexpr int kBlurThreads = 256;
constexpr int kStaticSmem = 48 * 1024;  // above this, opt in per kernel
constexpr int kMaxBlocks = 132 * 16;    // 16 blocks per SM on an H100

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

template <typename TX, typename TM>
__global__ void mask_kernel(const TX *__restrict__ x,
                            const TM *__restrict__ m, TX *__restrict__ y,
                            int64_t n, int64_t p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    y[i] = from_float<TX>(to_float(x[i]) * to_float(m[i % p]));
}

template <typename TX, typename TM>
int launch_mask(const void *x, const void *m, void *y, int64_t rows,
                int64_t cols, int threads, cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n == 0) return 0;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  mask_kernel<TX, TM><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const TX *>(x), static_cast<const TM *>(m),
      static_cast<TX *>(y), n, cols);
  return (int)cudaGetLastError();
}

// x, y [k, h, w]; block b takes images [b * images, b * images + nk).
template <typename T>
__global__ void __launch_bounds__(kBlurThreads)
    blur_kernel(const T *__restrict__ x, T *__restrict__ y, int64_t k,
                int h, int w, int images) {
  extern __shared__ float tile[];  // [nk, h, w] fp32
  const int64_t k0 = (int64_t)blockIdx.x * images;
  const int nk = (int)(k - k0 < images ? k - k0 : images);
  const int hw = h * w;
  const int n = nk * hw;
  const T *src = x + k0 * hw;
  T *dst = y + k0 * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = to_float(src[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = i % hw;
    const int r = q / w, c = q % w;
    const float *img = tile + (i - q);
    // the vertical pass at column cc of row r: 0.5 x + 0.25 (up + down)
    auto vert = [&](int cc) {
      const float up = r < h - 1 ? img[(r + 1) * w + cc] : 0.0f;
      const float down = r > 0 ? img[(r - 1) * w + cc] : 0.0f;
      return kW0 * img[r * w + cc] + kW1 * (up + down);
    };
    const float left = c < w - 1 ? vert(c + 1) : 0.0f;
    const float right = c > 0 ? vert(c - 1) : 0.0f;
    dst[i] = from_float<T>(kW0 * vert(c) + kW1 * (left + right));
  }
}

template <typename T>
int launch_blur(const void *x, void *y, int64_t k, int64_t h, int64_t w,
                int images, cudaStream_t stream) {
  if (k == 0 || h == 0 || w == 0) return 0;
  if (images > k) images = (int)k;
  const size_t smem = sizeof(float) * (size_t)images * (size_t)(h * w);
  if (smem > kStaticSmem) {
    int device = 0, optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        blur_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (k + images - 1) / images;
  blur_kernel<T><<<(unsigned)blocks, kBlurThreads, smem, stream>>>(
      static_cast<const T *>(x), static_cast<T *>(y), k, (int)h, (int)w,
      images);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t
// (0 = ok), or -1 for a dtype code or launch shape it does not take.

// x [rows, cols], m [cols] -> y [rows, cols]; threads per block in
// [32, 1024], a multiple of 32.
extern "C" int repro_mask_apply(const void *x, const void *m, void *y,
                                int64_t rows, int64_t cols, int x_dtype,
                                int m_dtype, int threads, void *stream) {
  if (threads < 32 || threads > 1024 || threads % 32) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && m_dtype == 0)
    return launch_mask<float, float>(x, m, y, rows, cols, threads, st);
  if (x_dtype == 0 && m_dtype == 1)
    return launch_mask<float, __nv_bfloat16>(x, m, y, rows, cols, threads,
                                             st);
  if (x_dtype == 1 && m_dtype == 0)
    return launch_mask<__nv_bfloat16, float>(x, m, y, rows, cols, threads,
                                             st);
  if (x_dtype == 1 && m_dtype == 1)
    return launch_mask<__nv_bfloat16, __nv_bfloat16>(x, m, y, rows, cols,
                                                     threads, st);
  return -1;
}

// x [k, h, w] -> y [k, h, w]; `images` whole images per block (>= 1).
// Returns cudaErrorInvalidValue when the tile does not fit in a block's
// shared memory.
extern "C" int repro_blur2d(const void *x, void *y, int64_t k, int64_t h,
                            int64_t w, int dtype, int images, void *stream) {
  if (images < 1 || h * w > (int64_t)1 << 30) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_blur<float>(x, y, k, h, w, images, st);
  if (dtype == 1)
    return launch_blur<__nv_bfloat16>(x, y, k, h, w, images, st);
  return -1;
}
