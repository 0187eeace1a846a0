// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (line 34, entry `flash_attention`
// line 83): blockwise online-softmax attention, causal and/or sliding
// window, GQA through the KV-head index h // G, with an fp32 running max,
// denominator and accumulator, and the output acc / max(l, 1e-30) written
// in q's dtype.
//
//   q [B, H, Sq, hd], k/v [B, KV, Sk, hd] -> o [B, H, Sq, hd]
//   s = (q . k) * scale; key c visible to query r when c < Sk and
//   (!causal || c <= r) and (window <= 0 || c > r - window)
//
// The serving path calls it once per attention layer of a prefill:
// tinyllama-1.1b at batch 8 and prompt 1024 gives q [8, 32, 1024, 64] and
// k/v [8, 4, 1024, 64] in bf16, causal.
//
// Bound: operations.  The causal half at that shape is 3.44e10 FLOP over
// 75.5 MB of q, k, v and o: ~455 FLOP a byte, above the card's ~295 for
// bf16 tensor cores.  This first kernel does its math in fp32 FMAs on the
// CUDA cores (67 TFLOP/s at most), so it is bounded by those, not by the
// memory; wgmma on bf16 tiles is for a later kernel.
//
// Design.  One block of 256 threads (16 x 16) per (q tile, head, batch);
// the q tiles of the longest causal rows are scheduled first.  The block
// stages its q tile in shared memory as fp32, then walks the KV tiles of
// head h / (H / KV) that hold a visible key (tiles wholly above the causal
// diagonal or wholly before the window are skipped: they contribute
// exactly nothing).  For each KV tile:
//   1. K is staged transposed; thread (ty, tx) computes the scores of rows
//      ty + 16 i and columns tx + 16 j, i < BQ/16, j < BK/16, as one fp32
//      FMA chain over hd each;
//   2. the mask, then the online softmax: the 16 threads of a row are 16
//      lanes of one warp, so the row max and row sum are warp shuffles;
//      each of them keeps the row's running max m and denominator l;
//   3. P goes to shared memory (transposed), V replaces K in its buffer,
//      and the thread accumulates acc[ty + 16 i][tx + 16 d] += P V over
//      the tile, after scaling acc by corr = exp(m_old - m_new).
// Row and column strides of the staged tiles are padded by one float, so
// the transposed writes and the strided reads fall into distinct banks.
//
// Masking trap.  The Pallas kernel masks with a finite -1e30: a row whose
// first tile is wholly masked (a window smaller than the tile) sums
// spurious exp(0) terms that a later tile's corr = exp(-1e30 - m) zeroes.
// Masking with -inf instead would give exp(-inf - -inf) = NaN there.  This
// kernel masks with -inf and takes the exponent base 0 while a row's
// running max is still -inf, so such a row contributes exactly 0 and its
// corr is exp(-inf) = 0: the same result without the spurious terms.  A row
// with no visible key at all writes 0.
//
// Tile sizes.  block_q and block_k (each 32, 64 or 128) and hd (32, 64, 80
// or 128; each a multiple of the 16 threads of a row, which own hd / 16
// output columns each) are template arguments; the Pallas signature
// takes block_q/block_k too, and the result depends on them only through
// fp32 reordering: each score is the same FMA chain for every tiling,
// only the softmax's running rescaling differs.  Shared memory is
// 4 (hd (BQ + 1) + hd (BK + 1) + BK (BQ + 1)) bytes, 49,920 at 64/64/64,
// 148,608 at 128/128 and hd 80, and 198,144 at 128/128/128, taken as
// dynamic shared memory above 48 KB.
//
// Numerics: built WITHOUT --use_fast_math (expf, not __expf): the
// kernel holds fp32 rtol 1e-4 / atol 1e-5 against its plain version.
// Interface: a plain C function loaded with ctypes
// (repro_torch/kernels/build.py); it launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;              // threads per row and per column
constexpr int kThreads = kSide * kSide;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float((int)0xff800000u);
}

__device__ __forceinline__ float load(const void *p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16 *>(p)[i])
              : static_cast<const float *>(p)[i];
}

__device__ __forceinline__ void store(void *p, int64_t i, float x, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16 *>(p)[i] = __float2bfloat16(x);  // RNE
  else
    static_cast<float *>(p)[i] = x;
}

// max and sum over the 16 lanes of a row (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int BQ, int BK, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)HD * (BQ + 1) + (size_t)HD * (BK + 1) +
                           (size_t)BK * (BQ + 1));
}

template <int BQ, int BK, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const void *__restrict__ q, const void *__restrict__ k,
                 const void *__restrict__ v, void *__restrict__ o, int H,
                 int KV, int Sq, int Sk, int causal, int window, float scale,
                 int bf16) {
  static_assert(HD % kSide == 0, "a row's 16 threads split hd evenly");
  constexpr int TM = BQ / kSide, TN = BK / kSide, TD = HD / kSide;
  constexpr int QLD = BQ + 1, KLD = BK + 1;
  extern __shared__ float smem[];
  float *qs = smem;              // [HD][QLD] the q tile, transposed
  float *kv = qs + HD * QLD;     // [HD][KLD] K transposed, then [BK][HD] V
  float *ps = kv + HD * KLD;     // [BK][QLD] P, transposed

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t q_base = ((int64_t)b * H + h) * Sq * HD;
  const int64_t kv_base = ((int64_t)b * KV + h / (H / KV)) * Sk * HD;

  for (int i = threadIdx.x; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[d * QLD + r] =
        q0 + r < Sq ? load(q, q_base + (int64_t)(q0 + r) * HD + d, bf16) : 0.f;
  }

  // the KV tiles that hold a key visible to some row of this q tile
  const int nk = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(nk, q_last / BK + 1) : nk;
  const int first = window > 0 ? q0 - window + 1 : 0;
  const int k_lo = first > 0 ? first / BK : 0;

  float m_run[TM], l_run[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = neg_inf();
    l_run[i] = 0.f;
#pragma unroll
    for (int d = 0; d < TD; ++d) acc[i][d] = 0.f;
  }

  for (int kt = k_lo; kt < k_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's readers of kv and ps are done
    for (int i = threadIdx.x; i < BK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      kv[d * KLD + c] =
          k0 + c < Sk ? load(k, kv_base + (int64_t)(k0 + c) * HD + d, bf16)
                      : 0.f;
    }
    __syncthreads();

    // 1. scores: one FMA chain over hd for each
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[d * QLD + ty + kSide * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = kv[d * KLD + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // 2. mask and online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = q0 + ty + kSide * i;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx + kSide * j;
        const bool ok = c < Sk && (!causal || c <= r) &&
                        (window <= 0 || c > r - window);
        s[i][j] = ok ? s[i][j] * scale : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float base = m_new == neg_inf() ? 0.f : m_new;  // see the header
      const float corr = expf(m_run[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - base);
        sum += s[i][j];
      }
      l_run[i] = l_run[i] * corr + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int d = 0; d < TD; ++d) acc[i][d] *= corr;
    }
    __syncthreads();   // every read of the K tile is done

    // 3. P to shared memory, V over K, then acc += P V
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        ps[(tx + kSide * j) * QLD + ty + kSide * i] = s[i][j];
    for (int i = threadIdx.x; i < BK * HD; i += kThreads) {
      const int c = i / HD;
      kv[i] = k0 + c < Sk ? load(v, kv_base + (int64_t)k0 * HD + i, bf16)
                          : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ps[c * QLD + ty + kSide * i];
#pragma unroll
      for (int d = 0; d < TD; ++d) vv[d] = kv[c * HD + tx + kSide * d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int d = 0; d < TD; ++d) acc[i][d] = fmaf(p[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + kSide * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < TD; ++d)
      store(o, q_base + (int64_t)r * HD + tx + kSide * d, acc[i][d] / denom,
            bf16);
  }
}

template <int BQ, int BK, int HD>
int launch(const void *q, const void *k, const void *v, void *o, int B,
           int H, int KV, int Sq, int Sk, int causal, int window, float scale,
           int bf16, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BQ, BK, HD>();
  static bool opted_in = false;   // per instantiation; set once per process
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<BQ, BK, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_kernel<BQ, BK, HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, H, KV, Sq, Sk, causal, window, scale, bf16);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void *, const void *, const void *, void *, int,
                       int, int, int, int, int, int, float, int,
                       cudaStream_t);

template <int BQ, int BK>
Launch pick_hd(int hd) {
  switch (hd) {
    case 32: return launch<BQ, BK, 32>;
    case 64: return launch<BQ, BK, 64>;
    case 80: return launch<BQ, BK, 80>;
    case 128: return launch<BQ, BK, 128>;
  }
  return nullptr;
}

template <int BQ>
Launch pick_bk(int bk, int hd) {
  switch (bk) {
    case 32: return pick_hd<BQ, 32>(hd);
    case 64: return pick_hd<BQ, 64>(hd);
    case 128: return pick_hd<BQ, 128>(hd);
  }
  return nullptr;
}

Launch pick(int bq, int bk, int hd) {
  switch (bq) {
    case 32: return pick_bk<32>(bk, hd);
    case 64: return pick_bk<64>(bk, hd);
    case 128: return pick_bk<128>(bk, hd);
  }
  return nullptr;
}

}  // namespace

// q [B, H, Sq, hd], k/v [B, KV, Sk, hd], o [B, H, Sq, hd], all contiguous
// and of one dtype (0 = float32, 1 = bfloat16); H a multiple of KV;
// window <= 0 means none.  Returns a cudaError_t (0 = ok), or -1 for a
// shape, tile or dtype it does not take.
extern "C" int repro_flash_attention(const void *q, const void *k,
                                     const void *v, void *o, int64_t B,
                                     int64_t H, int64_t KV, int64_t Sq,
                                     int64_t Sk, int64_t hd, int causal,
                                     int64_t window, int block_q, int block_k,
                                     float scale, int dtype, void *stream) {
  const int64_t kMaxLen = (int64_t)1 << 29;   // positions and r - window fit
  if (dtype != 0 && dtype != 1) return -1;
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1) return -1;
  if (B > 65535 || H > 65535 || Sq > kMaxLen || Sk > kMaxLen) return -1;
  const Launch fn = pick(block_q, block_k, (int)hd);
  if (fn == nullptr) return -1;
  // a window wider than every distance masks nothing
  const int w = window <= 0 ? 0 : (int)(window < Sq + Sk ? window : Sq + Sk);
  return fn(q, k, v, o, (int)B, (int)H, (int)KV, (int)Sq, (int)Sk, causal, w,
            scale, dtype, static_cast<cudaStream_t>(stream));
}
