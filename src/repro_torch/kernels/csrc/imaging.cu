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
// blur2d: the K images are K * H rows of W, cut into bands of
// `band_rows` rows (kernels/imaging.py `band_plan`: whole images when an
// image is small, part of one image otherwise).  A band's span, its rows
// and the row above and below within the same image, is one contiguous
// piece of x: thread 0 copies it into shared memory with one bulk copy
// (cp.async.bulk, completing on an mbarrier).  A persistent grid (a few
// blocks an SM) walks the bands with a ring of up to 3 spans a block, so
// the next bands' copies are in flight while one is computed.  Each thread
// computes 16 bytes of a row (4 fp32 or 8 bf16 pixels) from three
// 16-byte shared-memory reads, takes the column halo from the neighbouring
// lane (shared memory at a warp's edge), and stores 16 bytes.  No image
// size is refused: a view at an offset that is not a multiple of 16
// bytes, a row of W * sizeof(T) bytes that is not, or rows so wide that
// three do not fit in shared memory take a scalar path in the same kernel
// (nine reads from global memory a pixel).  The arithmetic is the plain
// version's, in its order: v = 0.5 * x + 0.25 * (up + down), then
// y = 0.5 * v + 0.25 * (left + right), zero outside the image.  The
// products by 0.5 and 0.25 are exact, so whether nvcc contracts a line
// into an FMA does not change its rounding (outside subnormal values).
//
// Numerics: built WITHOUT --use_fast_math.  Interface: plain C functions
// loaded with ctypes (repro_torch/kernels/build.py); each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() after
// the launch.  The fp32/bf16 helpers are hopper.cuh's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kW0 = 0.5f;   // repro.kernels.imaging BLUR_W0
constexpr float kW1 = 0.25f;  // BLUR_W1
constexpr int kBlurThreads = 256;      // kernels/imaging.py BLUR_THREADS
constexpr int kMaxStages = 3;           // kernels/imaging.py MAX_STAGES
constexpr int kBarBytes = 128;          // the stages' mbarriers, aligned
constexpr int kMaxBlocks = 132 * 16;    // 16 blocks per SM on an H100

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

// ---- blur2d ------------------------------------------------------------------
// x, y [k, h, w] seen as rows_total = k * h rows of w.  Band b is output rows
// [b * band_rows, min((b + 1) * band_rows, rows_total)); its span adds the
// row above and the row below where they lie in the same image, and is one
// contiguous piece of x.

__device__ __forceinline__ void band_span(int64_t band, int band_rows,
                                          int64_t rows_total, int h,
                                          int64_t &g0, int64_t &g1,
                                          int64_t &s0, int64_t &s1) {
  g0 = band * band_rows;
  g1 = g0 + band_rows < rows_total ? g0 + band_rows : rows_total;
  s0 = g0 % h ? g0 - 1 : g0;
  s1 = g1 % h ? g1 + 1 : g1;  // g1 % h == 0 at rows_total
}

// the vertical pass 0.5 x + 0.25 (up + down) at the pixel `p` of row r of
// its image, rows w elements apart (in shared or global memory)
template <typename T>
__device__ __forceinline__ float vert1(const T *p, int w, int r, int h) {
  const float up = r < h - 1 ? to_float(p[w]) : 0.0f;
  const float down = r > 0 ? to_float(p[-w]) : 0.0f;
  return kW0 * to_float(*p) + kW1 * (up + down);
}

// The band path: w % Vec<T>::N == 0 and x, y 16-byte aligned, so every span
// is one bulk copy.  A ring of `stages` spans per block: band n + stages is
// in flight while band n is computed.  Thread t computes 16 bytes of
// output (4 fp32 or 8 bf16 pixels of one row) per item; the column halo
// comes from the neighbouring lane, which holds the neighbouring item of
// the same row, or from shared memory at a warp's edge.
template <typename T>
__device__ __forceinline__ void blur_bands(const T *__restrict__ x,
                                           T *__restrict__ y,
                                           int64_t rows_total, int h, int w,
                                           int band_rows, int stages,
                                           int stage_bytes, uint64_t *bar,
                                           unsigned char *smem) {
  constexpr int V = Vec<T>::N;
  const int nv = w / V;                       // items per row
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t nbands = (rows_total + band_rows - 1) / band_rows;
  // item i of a band is row i / nv, 16-byte column i % nv: this thread's
  // first, and the step to its next (blockDim.x items on)
  const int j_first = tid / nv, c_first = tid - j_first * nv;
  const int dj = blockDim.x / nv, dc = blockDim.x - dj * nv;

  auto issue = [&](int st, int64_t band) {    // thread 0 only
    int64_t g0, g1, s0, s1;
    band_span(band, band_rows, rows_total, h, g0, g1, s0, s1);
    const uint32_t bytes = (uint32_t)((s1 - s0) * w * (int64_t)sizeof(T));
    hopper::mbar_expect_tx(&bar[st], bytes);
    hopper::bulk_load(smem + (size_t)st * stage_bytes, x + s0 * w, bytes,
                      &bar[st]);
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) hopper::mbar_init(&bar[st], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int n = 0; n < stages; ++n) {
      const int64_t band = blockIdx.x + (int64_t)n * gridDim.x;
      if (band < nbands) issue(n, band);
    }

  for (int n = 0;; ++n) {
    const int64_t band = blockIdx.x + (int64_t)n * gridDim.x;
    if (band >= nbands) break;
    const int st = n % stages;
    int64_t g0, g1, s0, s1;
    band_span(band, band_rows, rows_total, h, g0, g1, s0, s1);
    const T *tile = reinterpret_cast<const T *>(smem + (size_t)st * stage_bytes);
    const int lo = (int)(g0 - s0);             // tile row of output row g0
    const int r0 = (int)(g0 % h);              // its row in its image
    const int nrows = (int)(g1 - g0);
    T *out = y + g0 * w;
    hopper::mbar_wait(&bar[st], (uint32_t)((n / stages) & 1));

    // the trip count is the same for every thread, so each shuffle has
    // the whole warp; item i0 + tid is output row g0 + j, columns
    // [c V, c V + V)
    int j = j_first, c = c_first;
    for (int i0 = 0; i0 < nrows * nv; i0 += blockDim.x) {
      const bool act = j < nrows;
      const int r = (r0 + j) % h;
      const T *p = tile + (lo + j) * w + c * V;
      float v[V];                              // the vertical pass
      if (act) {
        float mid[V], up[V], down[V];
        Vec<T>::load(p, mid);
        if (r < h - 1) Vec<T>::load(p + w, up);
        else
#pragma unroll
          for (int e = 0; e < V; ++e) up[e] = 0.0f;
        if (r > 0) Vec<T>::load(p - w, down);
        else
#pragma unroll
          for (int e = 0; e < V; ++e) down[e] = 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = kW0 * mid[e] + kW1 * (up[e] + down[e]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.0f;
      }
      const float from_left = __shfl_up_sync(0xffffffffu, v[V - 1], 1);
      const float from_right = __shfl_down_sync(0xffffffffu, v[0], 1);
      if (act) {
        // v at columns c V - 1 and c V + V, zero outside the image
        float vl = 0.0f, vr = 0.0f;
        if (c > 0) vl = lane > 0 ? from_left : vert1(p - 1, w, r, h);
        if (c < nv - 1) vr = lane < 31 ? from_right : vert1(p + V, w, r, h);
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float left = e < V - 1 ? v[e + 1] : vr;    // v[c + 1]
          const float right = e > 0 ? v[e - 1] : vl;       // v[c - 1]
          o[e] = kW0 * v[e] + kW1 * (left + right);
        }
        Vec<T>::store(out + (int64_t)j * w + c * V, o);
      }
      j += dj;
      c += dc;
      if (c >= nv) {
        c -= nv;
        ++j;
      }
    }
    __syncthreads();                           // every read of stage st done
    if (tid == 0) {
      const int64_t next = band + (int64_t)stages * gridDim.x;
      if (next < nbands) issue(st, next);
    }
  }
}

// The scalar path, for every other x: a view at an offset that is not a
// multiple of 16 bytes, a row of w * sizeof(T) bytes that is not, or rows
// too wide for three of them to fit in shared memory.  One pixel a thread
// per step, its nine neighbours read from global memory (L1 serves the
// reuse).
template <typename T>
__device__ __forceinline__ void blur_scalar(const T *__restrict__ x,
                                            T *__restrict__ y,
                                            int64_t rows_total, int h,
                                            int w) {
  const int64_t n = rows_total * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t g = i / w;
    const int c = (int)(i - g * w);
    const int r = (int)(g % h);
    const T *p = x + i;
    const float left = c < w - 1 ? vert1(p + 1, w, r, h) : 0.0f;
    const float right = c > 0 ? vert1(p - 1, w, r, h) : 0.0f;
    y[i] = from_float<T>(kW0 * vert1(p, w, r, h) + kW1 * (left + right));
  }
}

// One kernel, two paths; `bands` is the same for the whole launch.
template <typename T>
__global__ void __launch_bounds__(kBlurThreads)
    blur_kernel(const T *__restrict__ x, T *__restrict__ y,
                int64_t rows_total, int h, int w, int band_rows, int stages,
                int stage_bytes, int bands) {
  // dynamic shared memory: the stages' mbarriers, then the stages
  extern __shared__ __align__(128) unsigned char smem[];
  if (bands)
    blur_bands<T>(x, y, rows_total, h, w, band_rows, stages, stage_bytes,
                  reinterpret_cast<uint64_t *>(smem), smem + kBarBytes);
  else
    blur_scalar<T>(x, y, rows_total, h, w);
}

template <typename T>
int launch_blur(const void *x, void *y, int64_t k, int64_t h, int64_t w,
                int band_rows, int stages, int per_sm, cudaStream_t stream) {
  const int64_t rows_total = k * h;
  if (rows_total == 0 || w == 0) return 0;
  const hopper::DeviceLimits &dev = hopper::device_limits();
  const int64_t row_bytes = w * (int64_t)sizeof(T);
  if (band_rows > rows_total) band_rows = (int)rows_total;
  // a span is at most band_rows + 2 rows; stages start 128 bytes apart
  const int64_t stage_bytes = ((band_rows + 2) * row_bytes + 127) / 128 * 128;
  const bool bands =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(y) % 16 == 0) && row_bytes % 16 == 0 &&
      kBarBytes + stages * stage_bytes <= dev.smem_optin;
  if (bands) {
    const size_t smem = (size_t)(kBarBytes + stages * stage_bytes);
    static size_t opted = 0;
    const int err = hopper::opt_in_smem(blur_kernel<T>, smem, &opted);
    if (err) return err;
    const int64_t nbands = (rows_total + band_rows - 1) / band_rows;
    const int64_t most = (int64_t)dev.sms * per_sm;
    const int64_t blocks = nbands < most ? nbands : most;
    blur_kernel<T><<<(unsigned)blocks, kBlurThreads, smem, stream>>>(
        static_cast<const T *>(x), static_cast<T *>(y), rows_total, (int)h,
        (int)w, band_rows, stages, (int)stage_bytes, 1);
  } else {
    const int64_t n = rows_total * w;
    int64_t blocks = (n + kBlurThreads - 1) / kBlurThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    blur_kernel<T><<<(unsigned)blocks, kBlurThreads, 0, stream>>>(
        static_cast<const T *>(x), static_cast<T *>(y), rows_total, (int)h,
        (int)w, band_rows, stages, 0, 0);
  }
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

// x [k, h, w] -> y [k, h, w].  The band plan (kernels/imaging.py
// `band_plan`): `band_rows` output rows per band (>= 1), a ring of `stages`
// spans per block (1 to 3), `per_sm` blocks per SM (>= 1).  Any h and w
// below 2^31 are taken; x and y as they lie pick the path (see
// launch_blur), and the result does not depend on the plan.
extern "C" int repro_blur2d(const void *x, void *y, int64_t k, int64_t h,
                            int64_t w, int dtype, int band_rows, int stages,
                            int per_sm, void *stream) {
  if (band_rows < 1 || stages < 1 || stages > kMaxStages || per_sm < 1 ||
      h >= ((int64_t)1 << 31) || w >= ((int64_t)1 << 31))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_blur<float>(x, y, k, h, w, band_rows, stages, per_sm, st);
  if (dtype == 1)
    return launch_blur<__nv_bfloat16>(x, y, k, h, w, band_rows, stages,
                                      per_sm, st);
  return -1;
}
