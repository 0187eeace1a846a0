// The Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (line 25, entry `ssd_scan` line 71):
//
//   x [B, S, H, P], dt [B, S, H] (fp32, after softplus), A [H] (fp32,
//   negative), Bc/Cc [B, S, N] (x's dtype, shared by every head)
//   -> y [B, S, H, P] in x's dtype, fp32 math, without the D x skip term.
//
// Per chunk of Q = min(chunk, S) positions, with the fp32 state [P, N]
// carried from chunk to chunk:
//   seg   = cumsum(dt A)                                (within the chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//         + exp(seg_i) C_i . state
//   state = exp(seg_last) state + sum_j exp(seg_last - seg_j) dt_j x_j B_j^T
//
// The LLM trainer calls it once per layer of a forward pass: mamba2-130m
// at batch 8 and seq 256 gives x [8, 256, 24, 64] bf16, N 128, one chunk
// of 256 (ssm_chunk 512 is cut to S).
//
// Bound: operations.  The causal half at that shape is 4.04e9 FLOP over
// 13.8 MB (~290 FLOP a byte, at the card's ~295 for bf16 tensor cores).
// This first kernel does its math in fp32 FMAs on the CUDA cores (67
// TFLOP/s at most), so those bound it; wgmma on bf16 tiles is later work.
//
// Design.  The Pallas grid (B, H, n_chunks) walks the chunks in order on
// one core with the state in VMEM.  Here one block of 256 threads per
// (b, h) walks the chunks of its sequence in order, with the state in
// shared memory as fp32 [N][P]; the B H blocks run in parallel.  A chunk
// of Q = 512 would need a 1 MiB [Q, Q] decay matrix, so a chunk is taken
// in tiles of TILE rows (32, 64 or 128, a template argument):
//   1. warp 0 scans seg = cumsum(dt A) over the chunk into shared memory
//      (each lane a contiguous run, then a shuffle scan of the run sums),
//      in fp64: seg falls by |dt A| ~ 1 a position, so at Q = 512 it
//      reaches hundreds and an fp32 difference seg_i - seg_j would keep
//      only ~1e-4 of its value; every decay is exp of an fp64 difference
//      rounded to fp32 (the plain version does the same);
//   2. for each query tile i: acc = exp(seg_i) C_i state^T; then for each
//      key tile j <= i (tiles above the diagonal are skipped), the scores
//      C_i B_j^T, masked BEFORE the exp (a position after the query gets 0
//      and no exp is taken, so no positive difference is ever exponentiated)
//      and scaled by exp(seg_i - seg_j), times dt_j x_j, added to acc;
//      acc is written to y;
//   3. after the last query tile of a chunk (and never after the last
//      chunk), state = exp(seg_last) state + sum_j (dt_j x_j
//      exp(seg_last - seg_j))^T B_j.
// N is taken in slabs of 32 columns, so no [TILE, N] tile is held.  Every
// product reads one operand broadcast (a warp shares its row) and one as
// consecutive floats; the transposed B slab's rows are padded by one float
// so its transposing write falls into distinct banks.
//
// Strides: a head's rows of x and y are H P apart, dt's H apart; Bc and Cc
// rows are N apart and read by every head of the batch row.
//
// Any S.  The Pallas entry pads S to a multiple of Q with dt = 0 and cuts
// y back to S.  Padded positions come after every real one, so they change
// only themselves and the final state, neither of which is written: here
// the last chunk is just shorter, nothing past S is read, and y is written
// for s < S only.  The result equals the padded one.
//
// Invariance: chunk and TILE change only the order of fp32 sums.
//
// Shared memory: 8 Q + 4 (N P + 32 TILE + 32 (TILE + 1) + 2 TILE P +
// TILE^2) bytes, 102,528 at N 128, P 64, Q 512, TILE 64, and 200,832 at
// TILE 128: dynamic, opted in above 48 KB.  A shape that does not fit in
// the block's 227 KB is refused with cudaErrorInvalidValue.
//
// Numerics: built WITHOUT --use_fast_math (expf, not __expf).  Interface:
// a plain C function loaded with ctypes (repro_torch/kernels/build.py); it
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 32;               // columns of N per slab
constexpr int kStaticSmem = 48 * 1024;  // above this, opt in per kernel

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

__host__ __device__ constexpr size_t smem_floats(int n, int p, int q,
                                                 int tile) {
  return (size_t)n * p + 2 * (size_t)q + (size_t)tile * kSlab +
         (size_t)kSlab * (tile + 1) + 2 * (size_t)tile * p +
         (size_t)tile * tile;
}

// One block per (b, h): blockIdx.x = b * H + h.
template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T *__restrict__ x, const float *__restrict__ dt,
               const float *__restrict__ A, const T *__restrict__ Bc,
               const T *__restrict__ Cc, T *__restrict__ y, int64_t S,
               int H, int P, int N, int Q) {
  extern __shared__ double smem[];
  double *seg = smem;                           // [Q] fp64
  float *state = reinterpret_cast<float *>(seg + Q);   // [N][P]
  float *cs = state + (size_t)N * P;            // [TILE][kSlab] row-major
  float *bt = cs + TILE * kSlab;                // [kSlab][TILE + 1]
  float *xs = bt + kSlab * (TILE + 1);          // [TILE][P]
  float *acc = xs + TILE * P;                   // [TILE][P]
  float *sc = acc + TILE * P;                   // [TILE][TILE]

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / H;
  const int h = (int)(blockIdx.x % H);
  const float a = A[h];
  const int64_t hp = (int64_t)H * P;
  const T *xb = x + b * S * hp + (int64_t)h * P;    // row s at xb + s hp
  T *yb = y + b * S * hp + (int64_t)h * P;
  const float *dtb = dt + b * S * H + h;            // row s at dtb[s H]
  const T *Bb = Bc + b * S * N;                     // row s at Bb + s N
  const T *Cb = Cc + b * S * N;

  for (int e = tid; e < N * P; e += kThreads) state[e] = 0.0f;

  for (int64_t c0 = 0; c0 < S; c0 += Q) {
    const int L = (int)(S - c0 < Q ? S - c0 : Q);   // the last may be short
    // -- 1. seg = cumsum(dt A) over the chunk ------------------------------
    if (tid < 32) {
      const int per = (L + 31) / 32;
      const int lo = tid * per;
      const int hi = lo + per < L ? lo + per : L;
      double run = 0.0;
      for (int i = lo; i < hi; ++i) {
        run += (double)(dtb[(c0 + i) * H] * a);
        seg[i] = run;
      }
      double inc = run;                    // inclusive scan of run sums
      for (int d = 1; d < 32; d <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, inc, d);
        if (tid >= d) inc += v;
      }
      const double off = inc - run;
      for (int i = lo; i < hi; ++i) seg[i] += off;
    }
    __syncthreads();

    // -- 2. y for each query tile ------------------------------------------
    for (int i0 = 0; i0 < L; i0 += TILE) {
      const int ti = L - i0 < TILE ? L - i0 : TILE;
      // inter-chunk: acc = exp(seg_i) C_i state^T
      for (int e = tid; e < TILE * P; e += kThreads) acc[e] = 0.0f;
      for (int n0 = 0; n0 < N; n0 += kSlab) {
        const int kn = N - n0 < kSlab ? N - n0 : kSlab;
        for (int e = tid; e < TILE * kSlab; e += kThreads) {
          const int t = e / kSlab, k = e % kSlab;
          cs[e] = (t < ti && k < kn)
                      ? to_float(Cb[(c0 + i0 + t) * N + n0 + k]) : 0.0f;
        }
        __syncthreads();
        for (int e = tid; e < ti * P; e += kThreads) {
          const int t = e / P, p = e % P;
          float s = 0.0f;
          for (int k = 0; k < kn; ++k)
            s += cs[t * kSlab + k] * state[(n0 + k) * P + p];
          acc[e] += s;
        }
        __syncthreads();
      }
      for (int e = tid; e < ti * P; e += kThreads)
        acc[e] *= expf((float)seg[i0 + e / P]);

      // intra-chunk: key tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int tj = L - j0 < TILE ? L - j0 : TILE;
        for (int e = tid; e < TILE * TILE; e += kThreads) sc[e] = 0.0f;
        for (int n0 = 0; n0 < N; n0 += kSlab) {
          const int kn = N - n0 < kSlab ? N - n0 : kSlab;
          for (int e = tid; e < TILE * kSlab; e += kThreads) {
            const int t = e / kSlab, k = e % kSlab;
            const bool in = k < kn;
            cs[e] = (t < ti && in)
                        ? to_float(Cb[(c0 + i0 + t) * N + n0 + k]) : 0.0f;
            bt[k * (TILE + 1) + t] =
                (t < tj && in) ? to_float(Bb[(c0 + j0 + t) * N + n0 + k])
                               : 0.0f;
          }
          __syncthreads();
          for (int e = tid; e < ti * TILE; e += kThreads) {
            const int t = e / TILE, s = e % TILE;
            float v = 0.0f;
            for (int k = 0; k < kn; ++k)
              v += cs[t * kSlab + k] * bt[k * (TILE + 1) + s];
            sc[e] += v;
          }
          __syncthreads();
        }
        // mask before the exp, then the decay; and x_j dt_j
        for (int e = tid; e < ti * TILE; e += kThreads) {
          const int t = e / TILE, s = e % TILE;
          const int qi = i0 + t, kj = j0 + s;
          sc[e] = (s < tj && kj <= qi)
                      ? sc[e] * expf((float)(seg[qi] - seg[kj])) : 0.0f;
        }
        for (int e = tid; e < TILE * P; e += kThreads) {
          const int s = e / P, p = e % P;
          const int64_t pos = c0 + j0 + s;
          xs[e] = s < tj ? to_float(xb[pos * hp + p]) * dtb[pos * H] : 0.0f;
        }
        __syncthreads();
        for (int e = tid; e < ti * P; e += kThreads) {
          const int t = e / P, p = e % P;
          float v = 0.0f;
          const int send = j0 + TILE <= i0 ? tj : (t + 1 < tj ? t + 1 : tj);
          for (int s = 0; s < send; ++s) v += sc[t * TILE + s] * xs[s * P + p];
          acc[e] += v;
        }
        __syncthreads();
      }
      for (int e = tid; e < ti * P; e += kThreads)
        yb[(c0 + i0 + e / P) * hp + e % P] = from_float<T>(acc[e]);
      __syncthreads();
    }

    // -- 3. carry the state into the next chunk -----------------------------
    if (c0 + L >= S) break;
    const double last = seg[L - 1];
    const float chunk_decay = expf((float)last);
    for (int e = tid; e < N * P; e += kThreads) state[e] *= chunk_decay;
    for (int j0 = 0; j0 < L; j0 += TILE) {
      const int tj = L - j0 < TILE ? L - j0 : TILE;
      for (int e = tid; e < TILE * P; e += kThreads) {
        const int s = e / P, p = e % P;
        const int64_t pos = c0 + j0 + s;
        xs[e] = s < tj ? to_float(xb[pos * hp + p]) * dtb[pos * H] *
                             expf((float)(last - seg[j0 + s]))
                       : 0.0f;
      }
      for (int n0 = 0; n0 < N; n0 += kSlab) {
        const int kn = N - n0 < kSlab ? N - n0 : kSlab;
        for (int e = tid; e < TILE * kSlab; e += kThreads) {
          const int s = e / kSlab, k = e % kSlab;
          cs[e] = (s < tj && k < kn)
                      ? to_float(Bb[(c0 + j0 + s) * N + n0 + k]) : 0.0f;
        }
        __syncthreads();
        for (int e = tid; e < kn * P; e += kThreads) {
          const int k = e / P, p = e % P;
          float v = 0.0f;
          for (int s = 0; s < tj; ++s) v += cs[s * kSlab + k] * xs[s * P + p];
          state[(n0 + k) * P + p] += v;
        }
        __syncthreads();
      }
    }
    __syncthreads();                 // seg is rewritten by the next chunk
  }
}

template <typename T, int TILE>
int launch(const void *x, const float *dt, const float *A, const void *Bc,
           const void *Cc, void *y, int64_t B, int64_t S, int H, int P, int N,
           int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(N, P, Q, TILE);
  if (smem > kStaticSmem) {
    static size_t opted = 0;         // the largest size set for this kernel
    if (smem > opted) {
      int device = 0, optin = 0;
      cudaGetDevice(&device);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
      if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
      const cudaError_t err = cudaFuncSetAttribute(
          ssd_kernel<T, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      opted = smem;
    }
  }
  ssd_kernel<T, TILE><<<(unsigned)(B * H), kThreads, smem, stream>>>(
      static_cast<const T *>(x), dt, A, static_cast<const T *>(Bc),
      static_cast<const T *>(Cc), static_cast<T *>(y), S, H, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tile(int tile, const void *x, const float *dt, const float *A,
                  const void *Bc, const void *Cc, void *y, int64_t B,
                  int64_t S, int H, int P, int N, int Q, cudaStream_t st) {
  switch (tile) {
    case 32: return launch<T, 32>(x, dt, A, Bc, Cc, y, B, S, H, P, N, Q, st);
    case 64: return launch<T, 64>(x, dt, A, Bc, Cc, y, B, S, H, P, N, Q, st);
    case 128: return launch<T, 128>(x, dt, A, Bc, Cc, y, B, S, H, P, N, Q, st);
    default: return -1;
  }
}

}  // namespace

// x [B, S, H, P], dt [B, S, H] fp32, A [H] fp32, Bc/Cc [B, S, N] in x's
// dtype -> y [B, S, H, P]; dtype code 0 = float32, 1 = bfloat16; chunk
// >= 1 (Q = min(chunk, S)); tile 32, 64 or 128.  Returns a cudaError_t
// (0 = ok), or -1 for a dtype code, tile or shape it does not take.
extern "C" int repro_ssd_scan(const void *x, const void *dt, const void *A,
                              const void *Bc, const void *Cc, void *y,
                              int64_t B, int64_t S, int64_t H, int64_t P,
                              int64_t N, int64_t chunk, int tile, int dtype,
                              void *stream) {
  if (B < 0 || S < 0 || H < 1 || P < 1 || N < 1 || chunk < 1) return -1;
  if (B * H > ((int64_t)1 << 31) - 1 || P > 4096 || N > 4096) return -1;
  if (B == 0 || S == 0) return 0;
  const int Q = (int)(chunk < S ? chunk : S);
  if (Q > 1 << 16) return -1;
  const float *dtf = static_cast<const float *>(dt);
  const float *Af = static_cast<const float *>(A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_tile<float>(tile, x, dtf, Af, Bc, Cc, y, B, S, (int)H,
                                (int)P, (int)N, Q, st);
  if (dtype == 1)
    return dispatch_tile<__nv_bfloat16>(tile, x, dtf, Af, Bc, Cc, y, B, S,
                                        (int)H, (int)P, (int)N, Q, st);
  return -1;
}
