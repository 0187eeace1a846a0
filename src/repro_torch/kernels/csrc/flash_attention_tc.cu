// Flash attention (forward), the bf16 route: Hopper tensor cores (sm_90a).
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (line 34, entry `flash_attention`
// line 83, model layout `repro.kernels.ops.flash_attention` line 47):
// blockwise online-softmax attention, causal and/or sliding window, GQA
// through the KV-head index h // G, fp32 running max, denominator and
// accumulator, output acc / max(l, 1e-30) in bf16.  fp32 inputs keep
// flash_attention.cu (fp32 FMAs, which hold fp32 tolerances).
//
//   q (b, s, h) -> (b, h // G, s, h % G) with any strides, k/v (b, kv, s),
//   o likewise; the head dim is contiguous.  Key c is visible to query r
//   when c < Sk and (!causal || c <= r) and (window <= 0 || c > r - window).
//
// Bound: operations.  The serving path (tinyllama-1.1b, batch 8, prompt
// 1024: q [8, 32, 1024, 64], k/v [8, 4, 1024, 64], causal) does 3.44e10
// FLOP over 75.5 MB, ~455 FLOP a byte, above the ~295 at which the bf16
// tensor cores (989 TFLOP/s) and not the memory (3.35 TB/s) bound the card.
//
// Design.  Both products run on the tensor cores by wgmma, bf16 operands
// and fp32 accumulation:
//   * one block per (q tile of BQ rows, head, batch); the q tiles of the
//     longest causal rows are scheduled first over the whole grid.  BQ / 64
//     warpgroups own 64 rows each;
//   * thread 0 brings the q tile, then every K and V tile that holds a key
//     visible to the block, by TMA into a ring of two stages on mbarriers:
//     tile t + 2 is requested as soon as every warp is done with tile t
//     (a named barrier), so each load overlaps the products of the tile
//     before it.  Tiles wholly above the diagonal or before the window are
//     not loaded, and a warpgroup passes over the tiles wholly masked for
//     its own rows; rows past Sq or Sk are zero-filled by TMA and masked;
//   * S = Q K^T is a wgmma m64nBKk16 from shared memory, both operands
//     K-major; a bf16 row of 64 is one 128-byte swizzle row (hd 32: a 64-
//     byte swizzle; hd 128: two 128-byte atoms side by side; hd 80: five
//     32-byte atoms of 16, each one K step, so the head dim is neither
//     padded nor read twice);
//   * the online softmax runs on the accumulator fragments: a row lives in
//     the 4 lanes of a quad, so its max is two xor-shuffles; m is kept in
//     the log2 domain and p = 2^(s scale log2(e) - m) is one FMA and one
//     ex2; m, l and acc stay fp32 (l's quad sum is taken once, at the end);
//   * O += P V: P is rounded to bf16 in registers and is the register A
//     operand of a wgmma (the accumulator layout is the A fragment layout),
//     with V from shared memory as the MN-major B operand.
// Measured on an H100 at the prefill shape (PERF.md §6): a separate
// producer warp, three stages, and a software pipeline that overlaps S_t
// with P_{t-1} V_{t-1} inside a warpgroup were each slower than this
// (fewer blocks an SM: at 64 rows, 4 blocks of 128 threads and 106
// registers keep 16 warps on an SM), and 64-row tiles beat 128.
// GQA: each block reads the K/V tiles of its KV head; the G query heads
// of a KV head are separate blocks (their rows are not packed into one
// block), so K/V tiles are read G times, from L2 after the first.
//
// Masking trap (as flash_attention.cu): masked scores are -inf, and the
// exponent base is 0 while a row's running max is -inf, so a row whose
// first tiles are wholly masked contributes exactly 0; a row with no
// visible key writes 0.
//
// Tiles: BQ (64 or 128) and BK (64 or 128) are template arguments; the
// wrapper maps block_q/block_k onto them (kernels/flash_attention.py,
// `tc_tiles`).  Rounding P to bf16 happens after each tile's rescaling, so
// results depend on the tiles within bf16 rounding.
//
// Numerics: built WITHOUT --use_fast_math; p by ex2.approx.ftz (relative
// error ~2^-22, far inside P's bf16 rounding), the rescaling by exp2f.
// Interface: a plain C function loaded with ctypes (build.py); it builds
// the TMA maps on the host, launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 2;

// 2^x by the special-function unit, subnormal results flushed to 0 (P
// below 2^-126 is 0 after its bf16 rounding anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float((int)0xff800000u);
}

template <int BQ, int BK, int HD>
struct Cfg {
  static constexpr int NWG = BQ / 64;              // warpgroups, 64 rows each
  static constexpr int THREADS = NWG * 128;
  // bf16 per swizzle row: 64 (128-byte swizzle) where it divides hd, else
  // 32 (hd 32, 64-byte swizzle), else 16 (hd 80: five 32-byte atoms)
  static constexpr int ATOM = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static_assert(HD % 16 == 0 && HD <= 256, "a wgmma N and K steps of 16");
  static constexpr int NATOM = HD / ATOM;
  static constexpr int SW = ATOM * 2;              // swizzle bytes
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 64 + 1024;   // + base alignment
};

template <int BQ, int BK, int HD>
__global__ void __launch_bounds__(Cfg<BQ, BK, HD>::THREADS)
    flash_kernel_tc(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16 *__restrict__ o, int64_t osb, int64_t oss,
                    int64_t osk, int64_t osg, int B, int H, int KV, int Sq,
                    int Sk, int causal, int window, float scale_log2) {
  using C = Cfg<BQ, BK, HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = reinterpret_cast<uint8_t *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t *qs = smem;
  uint8_t *ks = smem + C::K_OFF;
  uint8_t *vs = smem + C::V_OFF;
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::BAR_OFF);
  uint64_t *qbar = full + kStages;

  // longest causal rows first over the whole grid: the q tile is the
  // slowest index
  const int nqt = (Sq + BQ - 1) / BQ;
  const int per_tile = H * B;
  const int qt = nqt - 1 - (int)blockIdx.x / per_tile;
  const int rest = (int)blockIdx.x % per_tile;
  const int h = rest % H, b = rest / H;
  const int G = H / KV, kvh = h / G, g = h % G;
  const int q0 = qt * BQ;

  // the K/V tiles that hold a key visible to some row of this q tile
  const int nk = (Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(nk, q_last / BK + 1) : nk;
  const int first = window > 0 ? q0 - window + 1 : 0;
  const int k_lo = first > 0 ? min(first / BK, k_hi) : 0;
  const int ntiles = k_hi - k_lo;

  // thread 0 loads: tile t's K and V into stage t % kStages
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
    const int k0 = (k_lo + t) * BK;
    for (int a = 0; a < C::NATOM; ++a) {
      tma_load_4d(ks + s * C::KV_BYTES + a * BK * C::SW, &kmap, &full[s],
                  a * C::ATOM, kvh, k0, b);
      tma_load_4d(vs + s * C::KV_BYTES + a * BK * C::SW, &vmap, &full[s],
                  a * C::ATOM, kvh, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, C::Q_BYTES);
    for (int w = 0; w < C::NWG; ++w)
      for (int a = 0; a < C::NATOM; ++a)
        tma_load_5d(qs + a * BQ * C::SW + w * 64 * C::SW, &qmap, qbar,
                    a * C::ATOM, g, kvh, q0 + 64 * w, b);
    for (int t = 0; t < ntiles && t < kStages; ++t) load_kv(t);
  }

  // warpgroup w owns rows q0 + 64 w .. + 63
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp / 4, wi = warp % 4;
  const int r0 = q0 + 64 * w + 16 * wi + lane / 4, r1 = r0 + 8;
  const int wg_first = q0 + 64 * w;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  const uint8_t *qw = qs + w * 64 * C::SW;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const int k0 = (k_lo + t) * BK;
    const uint8_t *kt = ks + s * C::KV_BYTES;
    const uint8_t *vt = vs + s * C::KV_BYTES;
    // a tile wholly masked for this warpgroup's 64 rows (above their
    // diagonal, or before their window) adds exactly nothing
    if (!((causal && k0 > wg_first + 63) ||
          (window > 0 && k0 + BK - 1 <= wg_first - window))) {
      // S = Q K^T
      float sc[BK / 2];
      fence_operand(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a = kk * 16 / C::ATOM, off = (kk * 16 % C::ATOM) * 2;
        Wgmma<BK>::template ss<0, 0>(
            sc, desc_k(qw + a * BQ * C::SW + off, C::SW),
            desc_k(kt + a * BK * C::SW + off, C::SW), kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_operand(sc);

      // the mask, then the online softmax on the fragments: the row max
      // of the raw scores, m in the log2 domain, p = 2^(s scale - m) by
      // one FMA and ex2
      const bool need_mask = k0 + BK > Sk ||
                             (causal && k0 + BK - 1 > wg_first) ||
                             (window > 0 && k0 <= wg_first + 63 - window);
      float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (need_mask) {
            const int c = k0 + 8 * j + 2 * (lane % 4) + e;
            const bool in = c < Sk;
            if (!(in && (!causal || c <= r0) &&
                  (window <= 0 || c > r0 - window)))
              sc[4 * j + e] = neg_inf();
            if (!(in && (!causal || c <= r1) &&
                  (window <= 0 || c > r1 - window)))
              sc[4 * j + 2 + e] = neg_inf();
          }
          mx0 = fmaxf(mx0, sc[4 * j + e]);
          mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0 * scale_log2);
      const float n1 = fmaxf(m1, mx1 * scale_log2);
      const float base0 = n0 == neg_inf() ? 0.f : n0;
      const float base1 = n1 == neg_inf() ? 0.f : n1;
      const float corr0 = exp2f(m0 - base0), corr1 = exp2f(m1 - base1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -base0));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -base1));
          sum0 += sc[4 * j + e];
          sum1 += sc[4 * j + 2 + e];
        }
      }
      l0 = l0 * corr0 + sum0;   // this thread's share; quad-summed at the end
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }

      // O += P V, P rounded to bf16 in registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_operand(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HD>::template rs<1>(
            acc, pa[kk], desc_mn(vt + kk * 16 * C::SW, BK * C::SW, C::SW), 1);
      wg_commit();
      wg_wait0();
      fence_operand(acc);
    }
    // every warp is done with stage s: thread 0 refills it
    named_sync(1, C::THREADS);
    if (threadIdx.x == 0 && t + kStages < ntiles) load_kv(t + kStages);
  }

#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16 *ob = o + b * osb + kvh * osk + g * osg;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162 *>(ob + r0 * oss + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162 *>(ob + r1 * oss + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o;
  int64_t B, H, KV, Sq, Sk;
  const int64_t *qst, *kst, *vst, *ost;   // (b, s, kv, g) / (b, s, kv)
  int causal, window;
  float scale_log2;
  cudaStream_t stream;
};

template <int BQ, int BK, int HD>
int launch(const Args &a) {
  using C = Cfg<BQ, BK, HD>;
  const int64_t G = a.H / a.KV;
  CUtensorMap qm, km, vm;
  // q: (d, g, kv, s, b); k/v: (d, kv, s, b)
  const int64_t qdims[5] = {HD, G, a.KV, a.Sq, a.B};
  const int64_t qstr[4] = {a.qst[3], a.qst[2], a.qst[1], a.qst[0]};
  const uint32_t qbox[5] = {(uint32_t)C::ATOM, 1, 1, 64, 1};
  const int64_t kdims[4] = {HD, a.KV, a.Sk, a.B};
  const int64_t kstr[3] = {a.kst[2], a.kst[1], a.kst[0]};
  const int64_t vstr[3] = {a.vst[2], a.vst[1], a.vst[0]};
  const uint32_t kbox[4] = {(uint32_t)C::ATOM, 1, (uint32_t)BK, 1};
  int err = make_map(&qm, a.q, 5, qdims, qstr, qbox);
  if (!err) err = make_map(&km, a.k, 4, kdims, kstr, kbox);
  if (!err) err = make_map(&vm, a.v, 4, kdims, vstr, kbox);
  if (err) return err;
  static size_t opted = 0;
  err = opt_in_smem(flash_kernel_tc<BQ, BK, HD>, C::SMEM, &opted);
  if (err) return err;
  const int64_t nqt = (a.Sq + BQ - 1) / BQ;
  flash_kernel_tc<BQ, BK, HD><<<(unsigned)(nqt * a.H * a.B), C::THREADS,
                                C::SMEM, a.stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16 *>(a.o), a.ost[0], a.ost[1],
      a.ost[2], a.ost[3], (int)a.B, (int)a.H, (int)a.KV, (int)a.Sq,
      (int)a.Sk, a.causal, a.window, a.scale_log2);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const Args &);

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

Launch pick(int bq, int bk, int hd) {
  if (bq == 64) return bk == 64 ? pick_hd<64, 64>(hd)
                     : bk == 128 ? pick_hd<64, 128>(hd) : nullptr;
  if (bq == 128) return bk == 64 ? pick_hd<128, 64>(hd)
                      : bk == 128 ? pick_hd<128, 128>(hd) : nullptr;
  return nullptr;
}

}  // namespace

// bf16 q/k/v/o with the head dim contiguous and element strides q_strides
// (b, s, kv, g), k_strides and v_strides (b, s, kv), o_strides (b, s, kv,
// g); every stride a multiple of 8 elements and every base 16-byte
// aligned (TMA).  H a multiple of KV; window <= 0 means none; bq, bk the
// kernel's tiles (64 or 128).  Returns a cudaError_t (0 = ok), -1 for a
// shape or tile it does not take, -2/-3 when the TMA map cannot be made.
extern "C" int repro_flash_attention_tc(
    const void *q, const void *k, const void *v, void *o, int64_t B,
    int64_t H, int64_t KV, int64_t Sq, int64_t Sk, int64_t hd,
    const int64_t *q_strides, const int64_t *k_strides,
    const int64_t *v_strides, const int64_t *o_strides, int causal,
    int64_t window, int bq, int bk, float scale, void *stream) {
  const int64_t kMaxLen = (int64_t)1 << 29;
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1) return -1;
  if (Sq > kMaxLen || Sk > kMaxLen || B * H * ((Sq + 63) / 64) > INT32_MAX)
    return -1;
  const Launch fn = pick(bq, bk, (int)hd);
  if (fn == nullptr) return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.B = B; a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk;
  a.qst = q_strides; a.kst = k_strides; a.vst = v_strides; a.ost = o_strides;
  a.causal = causal;
  a.window = window <= 0 ? 0 : (int)(window < Sq + Sk ? window : Sq + Sk);
  a.scale_log2 = scale * 1.4426950408889634f;
  a.stream = static_cast<cudaStream_t>(stream);
  return fn(a);
}
