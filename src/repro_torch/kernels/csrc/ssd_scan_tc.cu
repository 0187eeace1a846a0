// The Mamba-2 SSD chunked scan (forward), the bf16 route: Hopper tensor
// cores (sm_90a).
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py (line 25, entry `ssd_scan` line 71; model
// layout `repro.kernels.ops.ssd_scan` line 84):
//
//   x [B, S, H, P] bf16, dt [B, S, H] fp32 (after softplus), A [H] fp32
//   (negative), Bc/Cc [B, S, N] bf16 (shared by every head)
//   -> y [B, S, H, P] bf16, fp32 math for the state and the decays,
//      without the D x skip term.
// fp32 inputs keep ssd_scan.cu (fp32 FMAs, which hold fp32 tolerances).
//
// Per chunk of Q = min(chunk, S) positions, with seg = cumsum(dt A) inside
// the chunk and the state [P, N] carried from chunk to chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//         + exp(seg_i) C_i . state
//   state = exp(seg_last) state + sum_j exp(seg_last - seg_j) dt_j x_j B_j^T
//
// The LLM trainer calls it once per layer of a forward pass: mamba2-130m at
// batch 8 and seq 256 gives x [8, 256, 24, 64], N 128, one chunk of 256.
//
// Bound: at that shape the bytes (13.8 MB at 3.35 TB/s, 0.0041 ms) and the
// causal half's 4.04e9 FLOP on the bf16 tensor cores (0.0041 ms) are level.
// ssd_scan.cu spends 0.86 ms there: fp32 FMAs with two shared-memory loads
// each, C B^T recomputed for each of the 24 heads, and one block per
// (batch, head) walking its sequence.
//
// Design: the SSD algorithm's steps (Dao & Gu, arXiv:2405.21060, section
// 7), each a kernel, every product a wgmma (bf16 operands, fp32 sums):
//   0. ssd_kernel_tc_seg: seg = cumsum(dt A) per (batch, chunk, head), one
//      warp each, summed in fp64 (seg falls by |dt A| ~ 1 a position, so
//      at Q = 512 an fp32 difference seg_i - seg_j keeps ~1e-4 of its
//      value); also each chunk's decay exp(seg_last), rounded to fp32;
//   1. ssd_kernel_tc_states (S > Q only): each chunk's own final state per
//      (batch, chunk, head): (w x)^T B over the chunk, w_j = dt_j
//      exp(seg_last - seg_j): x's tile is scaled row by row in shared
//      memory into its bf16 operand copy (split, below) and both operands
//      are MN-major;
//   2. ssd_kernel_tc_pass (S > Q only): the short sequential pass over the
//      chunks, elementwise over (batch, head, P, N): the carried state stays
//      fp32; what is written is its bf16 operand copy (split), the state
//      entering each chunk;
//   3. ssd_kernel_tc_out: y per (batch, chunk, query tile of 64 rows, group
//      of kHeads heads).  The inter-chunk term first: C_i state^T [64, N] x
//      [N, P] by wgmma, scaled by exp(seg_i) in fp32.  Then for each key
//      tile j <= i the score tile C_i B_j^T by wgmma over depth N, ONCE for
//      the group's heads (Bc/Cc are shared by every head); for each head
//      the scores are scaled by exp(seg_i - seg_j) dt_j in fp32, masked
//      before the exp, rounded to bf16 in registers (split) and used as the
//      register A operand of a wgmma with x_h [64, P] as it arrives in bf16.
//      Folding dt into the scores keeps x exact.
//      A producer warp brings C_i (and the states) once, then B_j and the
//      heads' x_j by TMA into a ring of kStages stages on mbarriers, with
//      seg and dt of the key positions beside them.
// The split: an operand computed in fp32 (the scaled scores, w x, the
// state) is rounded to hi = bf16(v) and lo = bf16(v - hi), and its product
// is taken twice, with hi and with lo, into the same fp32 accumulator.
// Rounding once to bf16 (8 bits) misses the bf16 bar of rtol/atol 2e-2 on
// y: at N 128 the scores reach ~10 and y hundreds, so relative 2^-9
// errors summed over a chunk leave several bf16 ulps of y on entries near
// 0 (on the card, and in the CPU emulation of
// tests/test_torch_tensorcore.py); with the split every entry holds.  The
// operands that arrive in bf16 (x, Bc, Cc) are exact and are not split.
// Grouping: kHeads = 2 heads a block.  At the training shape that is 8 x 4
// query tiles x 12 groups = 384 blocks of 160 threads, 85 KB of shared
// memory each: two blocks an SM, 264 at once, the longest (last query
// tile, most key tiles) first.  Each score tile is computed once for two
// heads; four heads a block would halve that again but give 192 blocks
// with twice the accumulator registers.
//
// Any S: the last chunk is shorter; TMA zero-fills rows past S and nothing
// past S is written.  Chunks shorter than a 64-row tile mask the rows and
// keys of the next chunk.  Chunk and the wrapper's `tile` change only the
// order of sums and where bf16 rounds.  Shapes: P 32 or 64, N 16, 32, 64
// or 128 (at N 256 the two parts of two heads' states, 128 KB, and the
// ring do not fit in a block's shared memory).
//
// Numerics: built WITHOUT --use_fast_math.  Interface: a plain C function
// loaded with ctypes (build.py); it launches on the caller's stream (two
// launches for one chunk, four for more), allocates nothing (the wrapper
// passes the scratch), and returns cudaGetLastError() after the launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 2;
constexpr int kHeads = 2;      // heads a block of the output kernel
constexpr int kT = 64;         // rows of a query or key tile (one wgmma M)

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

// ---- 0. seg = cumsum(dt A) in fp64, and each chunk's decay ---------------
__global__ void ssd_kernel_tc_seg(const float *__restrict__ dt,
                                  const float *__restrict__ A,
                                  double *__restrict__ seg,
                                  float *__restrict__ cdecay, int64_t S,
                                  int H, int Q, int nc, int64_t nwarps) {
  const int64_t wid = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= nwarps) return;
  const int h = (int)(wid % H);
  const int64_t bc = wid / H;
  const int c = (int)(bc % nc);
  const int64_t b = bc / nc;
  const int64_t c0 = (int64_t)c * Q;
  const int L = (int)(S - c0 < Q ? S - c0 : Q);
  const float a = A[h];
  double carry = 0.0;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int i = i0 + lane;
    double v = i < L ? (double)(dt[(b * S + c0 + i) * H + h] * a) : 0.0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (i < L) seg[(b * S + c0 + i) * H + h] = carry + v;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) cdecay[bc * H + h] = (float)exp(carry);
}

// ---- 1. each chunk's own final state ---------------------------------------
template <int P, int NA>   // NA: bf16 per swizzle row of Bc (16, 32 or 64)
struct StatesCfg {
  static constexpr int SWP = P * 2, SWN = NA * 2;
  static constexpr int X_BYTES = kT * P * 2;
};

template <int P>
constexpr size_t states_smem(int N) {   // the ring, the lo tile, barriers
  return (size_t)kStages * align1k(kT * N * 2 + kT * P * 2) + kT * P * 2 +
         64 + 1024;
}

template <int P, int NA>
__global__ void __launch_bounds__(160, 1)
    ssd_kernel_tc_states(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap bmap,
                         const float *__restrict__ dt,
                         const double *__restrict__ seg,
                         float *__restrict__ states, int64_t S, int H, int N,
                         int Q, int nc) {
  using C = StatesCfg<P, NA>;
  const int natoms = N / NA;
  const int b_bytes = kT * N * 2;
  const int stage_bytes = align1k(b_bytes + C::X_BYTES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = reinterpret_cast<uint8_t *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t *xlo = smem + kStages * stage_bytes;        // (w x) - bf16(w x)
  uint64_t *full = reinterpret_cast<uint64_t *>(xlo + C::X_BYTES);
  uint64_t *empty = full + kStages;

  // blockIdx.x = (b (nc - 1) + c) H + h, chunks 0 .. nc - 2
  const int h = (int)(blockIdx.x % H);
  const int64_t bc = blockIdx.x / H;
  const int c = (int)(bc % (nc - 1));
  const int64_t b = bc / (nc - 1);
  const int64_t c0 = (int64_t)c * Q;   // not the last chunk: Q long
  const int ntiles = (Q + kT - 1) / kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        uint8_t *st = smem + s * stage_bytes;
        mbar_expect_tx(&full[s], b_bytes + C::X_BYTES);
        const int row = (int)(c0 + t * kT);
        for (int a = 0; a < natoms; ++a)
          tma_load_3d(st + a * kT * C::SWN, &bmap, &full[s], a * NA, row,
                      (int)b);
        tma_load_4d(st + b_bytes, &xmap, &full[s], 0, h, row, (int)b);
      }
    }
    return;
  }

  const int tid = threadIdx.x, wi = warp;
  const double last = seg[(b * S + c0 + Q - 1) * H + h];
  float acc[4][NA / 2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NA / 2; ++i) acc[a][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    uint8_t *bt = smem + s * stage_bytes;
    uint8_t *xt = bt + b_bytes;
    // x rows scaled by w_j = dt_j exp(seg_last - seg_j), hi in place and
    // lo into xlo at the same offset; a swizzle permutes 16-byte pieces
    // within a row, so a piece's row is its offset / (P * 2)
    for (int piece = tid; piece < kT * P / 8; piece += 128) {
      const int r = piece / (P / 8);
      const int pos = t * kT + r;                 // chunk-relative
      float w = 0.f;
      if (pos < Q) {
        const int64_t gi = (b * S + c0 + pos) * H + h;
        w = dt[gi] * expf((float)(last - seg[gi]));
      }
      uint4 *p = reinterpret_cast<uint4 *>(xt) + piece;
      uint4 v = *p, vlo;
      uint32_t *u = reinterpret_cast<uint32_t *>(&v);
      uint32_t *ul = reinterpret_cast<uint32_t *>(&vlo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 x2 = *reinterpret_cast<__nv_bfloat162 *>(&u[k]);
        pack_split(__low2float(x2) * w, __high2float(x2) * w, u[k], ul[k]);
      }
      *p = v;
      reinterpret_cast<uint4 *>(xlo)[piece] = vlo;
    }
    fence_proxy_async();
    named_sync(1, 128);

#pragma unroll
    for (int a = 0; a < 4; ++a) fence_operand(acc[a]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // A = (w x)^T [P (M), 16 positions (K)], M-major; M = 64 > P = 32
      // re-reads the same atom (LBO 0): rows P.. are copies, not written
      const uint64_t da = desc_mn(xt + kk * 16 * C::SWP, 0, C::SWP);
      const uint64_t dl = desc_mn(xlo + kk * 16 * C::SWP, 0, C::SWP);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (a < natoms) {
          const uint64_t db =
              desc_mn(bt + a * kT * C::SWN + kk * 16 * C::SWN, 0, C::SWN);
          Wgmma<NA>::template ss<1, 1>(acc[a], da, db, 1);
          Wgmma<NA>::template ss<1, 1>(acc[a], dl, db, 1);
        }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int a = 0; a < 4; ++a) fence_operand(acc[a]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // states [B, nc - 1, H, P, N] fp32; acc row p, column n
  float *out = states + (bc * H + h) * (int64_t)P * N;
  const int p0 = 16 * wi + lane / 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (a >= natoms) continue;
#pragma unroll
    for (int j = 0; j < NA / 8; ++j) {
      const int n = a * NA + 8 * j + 2 * (lane % 4);
      if (p0 < P)
        *reinterpret_cast<float2 *>(out + (int64_t)p0 * N + n) =
            make_float2(acc[a][4 * j], acc[a][4 * j + 1]);
      if (p0 + 8 < P)
        *reinterpret_cast<float2 *>(out + (int64_t)(p0 + 8) * N + n) =
            make_float2(acc[a][4 * j + 2], acc[a][4 * j + 3]);
    }
  }
}

// ---- 2. the state entering each chunk, carried in fp32 ---------------------
// hs [2, B, nc - 1, H, P, N]: the hi and lo bf16 parts
__global__ void ssd_kernel_tc_pass(const float *__restrict__ states,
                                   const float *__restrict__ cdecay,
                                   __nv_bfloat16 *__restrict__ hs, int H,
                                   int PN, int nc, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;                  // total = B H P N
  const int e = (int)(idx % PN);
  const int64_t bh = idx / PN;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  float run = 0.f;
  for (int c = 0; c < nc - 1; ++c) {
    const int64_t at = ((b * (nc - 1) + c) * H + h) * PN + e;
    run = run * cdecay[(b * nc + c) * H + h] + states[at];
    const __nv_bfloat16 hi = __float2bfloat16(run);   // entering chunk c + 1
    hs[at] = hi;
    hs[at + total * (nc - 1)] = __float2bfloat16(run - __bfloat162float(hi));
  }
}

// ---- 3. y: the inter-chunk term, then the intra-chunk term --------------
template <int P>
__global__ void __launch_bounds__(160, 2)
    ssd_kernel_tc_out(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap cmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const float *__restrict__ dt,
                      const double *__restrict__ seg,
                      __nv_bfloat16 *__restrict__ y, int64_t B, int64_t S,
                      int H, int N, int Q, int nc, int groups, int nqt) {
  constexpr int SWP = P * 2;
  constexpr int X_BYTES = kT * P * 2;
  const int NA = N < 64 ? N : 64, SWN = NA * 2, natoms = N / NA;
  const int tile_bytes = kT * N * 2;                  // C_i or B_j
  const int hs_bytes = P * N * 2;        // one part of one head's state
  const int side_off = tile_bytes + kHeads * X_BYTES;
  const int stage_bytes = align1k(side_off + kHeads * kT * 12);
  extern __shared__ uint8_t smem_raw[];
  uint8_t *smem = reinterpret_cast<uint8_t *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t *cs = smem;
  uint8_t *hsm = cs + tile_bytes;
  uint8_t *ring = hsm + (nc > 1 ? 2 * kHeads * hs_bytes : 0);
  uint64_t *full = reinterpret_cast<uint64_t *>(ring + kStages * stage_bytes);
  uint64_t *empty = full + kStages;
  uint64_t *cbar = empty + kStages;

  // the query tile is the slowest index: the longest blocks go first
  const int64_t per = (int64_t)groups * B * nc;
  const int qt = nqt - 1 - (int)(blockIdx.x / per);
  const int64_t rest = blockIdx.x % per;
  const int grp = (int)(rest % groups);
  const int64_t bc = rest / groups;
  const int c = (int)(bc % nc);
  const int64_t b = bc / nc;
  const int64_t c0 = (int64_t)c * Q;
  const int L = (int)(S - c0 < Q ? S - c0 : Q);
  const int i0 = qt * kT;
  if (i0 >= L) return;                       // a short last chunk
  const int h0 = grp * kHeads;
  const int nh = H - h0 < kHeads ? H - h0 : kHeads;
  const int ntiles = qt + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);           // the TMA arrival + the warp
      mbar_init(&empty[s], 4);
    }
    mbar_init(cbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer --------------------------------------------------------
    if (lane == 0) {
      mbar_expect_tx(cbar, tile_bytes + (c > 0 ? 2 * nh * hs_bytes : 0));
      for (int a = 0; a < natoms; ++a)
        tma_load_3d(cs + a * kT * SWN, &cmap, cbar, a * NA, (int)(c0 + i0),
                    (int)b);
      // the state entering chunk c, hi and lo parts: [2, B(nc - 1)H, P, N]
      const int64_t parts = B * (nc - 1) * H;
      if (c > 0)
        for (int hh = 0; hh < nh; ++hh)
          for (int part = 0; part < 2; ++part)
            for (int a = 0; a < natoms; ++a)
              tma_load_3d(hsm + (2 * hh + part) * hs_bytes + a * P * SWN,
                          &hmap, cbar, a * NA, 0,
                          (int)(part * parts + (b * (nc - 1) + c - 1) * H +
                                h0 + hh));
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
      uint8_t *st = ring + s * stage_bytes;
      double *segk = reinterpret_cast<double *>(st + side_off);
      float *dtk = reinterpret_cast<float *>(segk + kHeads * kT);
      for (int e = lane; e < kHeads * kT; e += 32) {
        const int hh = e / kT, k = e % kT;
        const int pos = t * kT + k;
        double sv = 0.0;
        float dv = 0.f;
        if (hh < nh && pos < L) {
          const int64_t gi = (b * S + c0 + pos) * H + h0 + hh;
          sv = seg[gi];
          dv = dt[gi];
        }
        segk[e] = sv;
        dtk[e] = dv;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], tile_bytes + nh * X_BYTES);
        const int row = (int)(c0 + t * kT);
        for (int a = 0; a < natoms; ++a)
          tma_load_3d(st + a * kT * SWN, &bmap, &full[s], a * NA, row, (int)b);
        for (int hh = 0; hh < nh; ++hh)
          tma_load_4d(st + tile_bytes + hh * X_BYTES, &xmap, &full[s], 0,
                      h0 + hh, row, (int)b);
      }
      mbar_arrive(&full[s]);                 // this lane's side writes
    }
    return;
  }

  // ---- consumers: one warpgroup, query rows i0 .. i0 + 63 ---------------
  const int wi = warp;
  const int qa = i0 + 16 * wi + lane / 4, qb = qa + 8;   // chunk-relative
  double sq[kHeads][2];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    sq[hh][0] = hh < nh && qa < L ? seg[(b * S + c0 + qa) * H + h0 + hh] : 0.0;
    sq[hh][1] = hh < nh && qb < L ? seg[(b * S + c0 + qb) * H + h0 + hh] : 0.0;
  }
  float yacc[kHeads][P / 2];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
    for (int i = 0; i < P / 2; ++i) yacc[hh][i] = 0.f;

  mbar_wait(cbar, 0);
  if (c > 0) {
    // inter-chunk: y = exp(seg_i) C_i state^T, state^T K-major [P][N]
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= nh) continue;
      fence_operand(yacc[hh]);
      wg_fence();
      for (int kk = 0; kk < N / 16; ++kk) {
        const int a = kk * 16 / NA, off = (kk * 16 % NA) * 2;
        const uint64_t dc = desc_k(cs + a * kT * SWN + off, SWN);
        const uint8_t *st = hsm + 2 * hh * hs_bytes + a * P * SWN + off;
        Wgmma<P>::template ss<0, 0>(yacc[hh], dc, desc_k(st, SWN), kk > 0);
        Wgmma<P>::template ss<0, 0>(yacc[hh], dc,
                                    desc_k(st + hs_bytes, SWN), 1);
      }
      wg_commit();
      wg_wait0();
      fence_operand(yacc[hh]);
      const float ea = expf((float)sq[hh][0]), eb = expf((float)sq[hh][1]);
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        yacc[hh][4 * j] *= ea;
        yacc[hh][4 * j + 1] *= ea;
        yacc[hh][4 * j + 2] *= eb;
        yacc[hh][4 * j + 3] *= eb;
      }
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t *bt = ring + s * stage_bytes;
    const double *segk = reinterpret_cast<const double *>(bt + side_off);
    const float *dtk = reinterpret_cast<const float *>(segk + kHeads * kT);
    // the score tile C_i B_j^T, once for the group's heads
    float g[kT / 2];
    fence_operand(g);
    wg_fence();
    for (int kk = 0; kk < N / 16; ++kk) {
      const int a = kk * 16 / NA, off = (kk * 16 % NA) * 2;
      Wgmma<kT>::template ss<0, 0>(g, desc_k(cs + a * kT * SWN + off, SWN),
                                   desc_k(bt + a * kT * SWN + off, SWN),
                                   kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_operand(g);
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= nh) continue;
      // scores x exp(seg_i - seg_j) dt_j, masked before the exp, split into
      // bf16 hi and lo: the A fragments of the two products with x_j
      uint32_t fa[kT / 16][4], fl[kT / 16][4];
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * j + 2 * (lane % 4) + e;
          const int pos = t * kT + k;
          const double sk = segk[hh * kT + k];
          const float dk = dtk[hh * kT + k];
          v[e] = pos <= qa ? g[4 * j + e] * expf((float)(sq[hh][0] - sk)) * dk
                           : 0.f;
          v[2 + e] = pos <= qb
                         ? g[4 * j + 2 + e] * expf((float)(sq[hh][1] - sk)) * dk
                         : 0.f;
        }
        pack_split(v[0], v[1], fa[j / 2][(j % 2) * 2], fl[j / 2][(j % 2) * 2]);
        pack_split(v[2], v[3], fa[j / 2][(j % 2) * 2 + 1],
                   fl[j / 2][(j % 2) * 2 + 1]);
      }
      const uint8_t *xt = bt + tile_bytes + hh * X_BYTES;
      fence_operand(yacc[hh]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const uint64_t dx = desc_mn(xt + kk * 16 * SWP, 0, SWP);
        Wgmma<P>::template rs<1>(yacc[hh], fa[kk], dx, 1);
        Wgmma<P>::template rs<1>(yacc[hh], fl[kk], dx, 1);
      }
      wg_commit();
      wg_wait0();
      fence_operand(yacc[hh]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (hh >= nh) continue;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int p = 8 * j + 2 * (lane % 4);
      if (qa < L)
        *reinterpret_cast<__nv_bfloat162 *>(
            y + ((b * S + c0 + qa) * H + h0 + hh) * P + p) =
            __floats2bfloat162_rn(yacc[hh][4 * j], yacc[hh][4 * j + 1]);
      if (qb < L)
        *reinterpret_cast<__nv_bfloat162 *>(
            y + ((b * S + c0 + qb) * H + h0 + hh) * P + p) =
            __floats2bfloat162_rn(yacc[hh][4 * j + 2], yacc[hh][4 * j + 3]);
    }
  }
}

struct Args {
  const void *x, *Bc, *Cc;
  const float *dt, *A;
  void *y;
  double *seg;
  float *cdecay, *states;
  void *hs;
  int64_t B, S;
  int H, P, N, Q, nc;
  cudaStream_t stream;
};

template <int P, int NA>
int launch_states(const Args &a, const CUtensorMap &xm, const CUtensorMap &bm) {
  const size_t smem = states_smem<P>(a.N);
  static size_t opted = 0;
  int err = opt_in_smem(ssd_kernel_tc_states<P, NA>, smem, &opted);
  if (err) return err;
  ssd_kernel_tc_states<P, NA>
      <<<(unsigned)(a.B * (a.nc - 1) * a.H), 160, smem, a.stream>>>(
          xm, bm, a.dt, a.seg, a.states, a.S, a.H, a.N, a.Q, a.nc);
  return (int)cudaGetLastError();
}

template <int P>
int launch(const Args &a) {
  const int NA = a.N < 64 ? a.N : 64;
  CUtensorMap xm, bm, cm, hm;
  // x: (P, H, S, B); Bc/Cc: (N, S, B); states' operand copy: (N, P, B(nc-1)H)
  const int64_t xdims[4] = {P, a.H, a.S, a.B};
  const int64_t xstr[3] = {P, (int64_t)a.H * P, a.S * a.H * P};
  const uint32_t xbox[4] = {P, 1, kT, 1};
  const int64_t bdims[3] = {a.N, a.S, a.B};
  const int64_t bstr[2] = {a.N, a.S * a.N};
  const uint32_t bbox[3] = {(uint32_t)NA, kT, 1};
  int err = make_map(&xm, a.x, 4, xdims, xstr, xbox);
  if (!err) err = make_map(&bm, a.Bc, 3, bdims, bstr, bbox);
  if (!err) err = make_map(&cm, a.Cc, 3, bdims, bstr, bbox);
  if (err) return err;
  hm = cm;                                   // unused for one chunk
  if (a.nc > 1) {
    const int64_t hdims[3] = {a.N, P, 2 * a.B * (a.nc - 1) * a.H};
    const int64_t hstr[2] = {a.N, (int64_t)P * a.N};
    const uint32_t hbox[3] = {(uint32_t)NA, P, 1};
    err = make_map(&hm, a.hs, 3, hdims, hstr, hbox);
    if (err) return err;
  }

  // 0. seg and the chunk decays
  const int64_t nwarps = a.B * a.nc * a.H;
  ssd_kernel_tc_seg<<<(unsigned)((nwarps * 32 + 255) / 256), 256, 0,
                      a.stream>>>(a.dt, a.A, a.seg, a.cdecay, a.S, a.H, a.Q,
                                  a.nc, nwarps);
  if (a.nc > 1) {
    // 1. chunk states, 2. the pass over chunks
    err = NA == 16   ? launch_states<P, 16>(a, xm, bm)
          : NA == 32 ? launch_states<P, 32>(a, xm, bm)
                     : launch_states<P, 64>(a, xm, bm);
    if (err) return err;
    const int64_t total = a.B * a.H * (int64_t)P * a.N;
    ssd_kernel_tc_pass<<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
        a.states, a.cdecay, static_cast<__nv_bfloat16 *>(a.hs), a.H,
        P * a.N, a.nc, total);
  }
  // 3. y
  const int tile = kT * a.N * 2;
  const int stage = align1k(tile + kHeads * kT * P * 2 + kHeads * kT * 12);
  const size_t smem = (size_t)tile + (a.nc > 1 ? 2 * kHeads * P * a.N * 2 : 0) +
                      (size_t)kStages * stage + 64 + 1024;
  static size_t opted = 0;
  err = opt_in_smem(ssd_kernel_tc_out<P>, smem, &opted);
  if (err) return err;
  const int groups = (a.H + kHeads - 1) / kHeads;
  const int nqt = (a.Q + kT - 1) / kT;
  ssd_kernel_tc_out<P>
      <<<(unsigned)((int64_t)nqt * groups * a.B * a.nc), 160, smem,
         a.stream>>>(xm, bm, cm, hm, a.dt, a.seg,
                     static_cast<__nv_bfloat16 *>(a.y), a.B, a.S, a.H, a.N, a.Q,
                     a.nc, groups, nqt);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, S, H, P], Bc/Cc [B, S, N] and y bf16, dt [B, S, H] and A [H]
// fp32, all contiguous with 16-byte aligned bases; chunk >= 1 (Q =
// min(chunk, S)).  Scratch from the caller: seg [B, S, H] fp64, cdecay
// [B, nc, H] fp32, and for nc > 1 states [B, nc - 1, H, P, N] fp32 and hs
// [2, B, nc - 1, H, P, N] bf16, the hi and lo parts (else NULL).  Returns a cudaError_t (0 = ok),
// -1 for a shape it does not take, -2/-3 when a TMA map cannot be made.
extern "C" int repro_ssd_scan_tc(const void *x, const void *dt, const void *A,
                                 const void *Bc, const void *Cc, void *y,
                                 void *seg, void *cdecay, void *states,
                                 void *hs, int64_t B, int64_t S, int64_t H,
                                 int64_t P, int64_t N, int64_t chunk,
                                 void *stream) {
  if (B < 0 || S < 0 || H < 1 || chunk < 1) return -1;
  if (P != 32 && P != 64) return -1;
  if (N != 16 && N != 32 && N != 64 && N != 128) return -1;
  if (B == 0 || S == 0) return 0;
  if (S > ((int64_t)1 << 30) || B * H > ((int64_t)1 << 24)) return -1;
  Args a;
  a.x = x; a.Bc = Bc; a.Cc = Cc; a.y = y;
  a.dt = static_cast<const float *>(dt);
  a.A = static_cast<const float *>(A);
  a.seg = static_cast<double *>(seg);
  a.cdecay = static_cast<float *>(cdecay);
  a.states = static_cast<float *>(states);
  a.hs = hs;
  a.B = B; a.S = S; a.H = (int)H; a.P = (int)P; a.N = (int)N;
  a.Q = (int)(chunk < S ? chunk : S);
  a.nc = (int)((S + a.Q - 1) / a.Q);
  a.stream = static_cast<cudaStream_t>(stream);
  if (a.nc > 1 && (states == nullptr || hs == nullptr)) return -1;
  return P == 32 ? launch<32>(a) : launch<64>(a);
}
