// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/transformer/flash.py
// `_dq_kernel_resident` (:258) and `_dkv_kernel_resident` (:292) and their
// streaming forms `_dq_kernel` (:120) and `_dkv_kernel` (:159). As there,
// the score matrix is recomputed tile by tile from q, k and the forward's
// fp32 log-sum-exp, never stored:
//   s = q k^T * sm_scale (offset causal mask), p = exp(s - lse),
//   dp = do v^T, ds = p (dp - delta) sm_scale,
//   dq = ds k,  dk = ds^T q,  dv = p^T do,
// with delta = rowsum(do * o) - g_lse. The dq kernel computes delta for
// its rows (it holds do already and reads o once) and writes it to the
// fp32 [B, H, Sq] buffer the dk/dv kernel, launched after it on the same
// stream, reads; g_lse is the lse cotangent, null when there is none. The
// JAX split is kept: the dq kernel owns query tiles and loops over key
// tiles, the dk/dv kernel owns key tiles and loops over query tiles, so
// neither needs atomics and the gradients are bit-identical from run to
// run. A loop inside the CTA takes the place of the TPU's sequential grid
// axis, so one kernel covers both TPU forms. A row with no visible key
// (lse at the -1e30 masking value: Sq > Sk, causal) gets p = 0.
//
// Bound on the H100 at GPT-2 medium training (B 8, H 16, S 1024, D 64,
// causal, bf16; 67.2 M visible (query, key) pairs): the dq kernel does
// 6 D flops a pair (s, dp, dq: 25.8 GFLOP, 0.0261 ms at 989 TFLOP/s) and
// moves 101.7 MB (q, k, v, o, do and lse read, dq and delta written:
// 0.0304 ms at 3.35 TB/s); the dk/dv kernel does 8 D (s, dp, dv, dk: 34.4
// GFLOP, 0.0348 ms) and moves 101.7 MB. The products set the pace, so the
// design keeps the tensor cores fed and the bytes read once a CTA:
// * bf16, design: one warpgroup (four warps, 16 rows each) owns 64 rows a
//   CTA. Its own rows (q, do, o for dq; k, v for dk/dv) are staged once;
//   q, do (k, v) are held as A fragments in registers. The other side
//   streams through a ring of 3 stages in dynamic shared memory (above
//   48 KB): 64-row K|V tiles for dq, Q|dO tiles with their lse and delta
//   for dk/dv (32 rows at D 128, for the registers), filled by 16-byte
//   cp.async with zero fill, so tiles j+1 and j+2 are in flight while tile
//   j's products run. One barrier a tile.
// * Tiles are stored row-major in the XOR swizzle of hopper_common.cuh, no
//   padding; at D 16, 32 and 64 that is the 32-, 64- and 128-byte swizzle
//   the hardware reads, so the products are warpgroup MMAs
//   (wgmma.mma_async, sm_90a): A from registers, B from the tile through a
//   matrix descriptor, K-major for s = q k^T and dp = do v^T, MN-major
//   (the transpose bit) for dq += ds k; the dk/dv kernel computes s^T =
//   k q^T and dp^T = v do^T, so p^T and ds^T come out of the accumulators
//   as the A operands of dv += p^T do and dk += ds^T q. At D 128 (256-byte
//   rows, no hardware swizzle) the same tiles feed mma.sync m16n8k16
//   through ldmatrix and ldmatrix.trans. Neither form writes a transposed
//   copy.
// * The mask is applied only on the tiles where it bites: the causal
//   diagonal (and, for dq, the ragged key tail); the other tiles run
//   without mask arithmetic. Rows past the ends are zero-filled, so their
//   products vanish. Loop bounds kv_end / q_begin skip the tiles above the
//   diagonal; the dq grid runs the heavy causal tiles first.
// * p is rounded to bf16 before p^T do and ds before ds k and ds^T q,
//   where the JAX kernels cast (flash.py:317-325). Every head dim 1..128
//   takes this design, padded with zeros in shared memory to 16, 32, 64 or
//   128; rows that are not 16-byte aligned (D % 8 != 0) stage through the
//   registers into the same layout.
// * fp32: FMA pipes, no TF32 (fp32 parity holds); four neighbouring
//   threads own a row and split the head dim as float4 groups, and the
//   dot products are reduced with two xor-shuffles.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2;
using hopper::hold_regs;
using hopper::kLog2e;
using hopper::ldsm_a;
using hopper::ldsm_b;
using hopper::ldsm_bt;
using hopper::stage_tile;
using hopper::store_rows;
using hopper::use_wgmma;
using hopper::wgmma_commit;
using hopper::wgmma_desc;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_wait;

// 64 rows a CTA (one warpgroup) and a ring of 3 stages: 128-row CTAs and
// 2 stages were no faster on the H100
constexpr int kRows = 64;  // rows a CTA owns (queries for dq, keys for dkv)
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *g_lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk, D;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float sm_scale;
  int causal, vec;
  cudaStream_t stream;
};

// rows of the streamed side in one ring stage
template <int DP>
__host__ __device__ constexpr int inner_tile() { return DP <= 64 ? 64 : 32; }

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * kRows * DP + kStages * 2 * inner_tile<DP>() * DP) * 2;
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return (2 * kRows * DP + kStages * 2 * inner_tile<DP>() * DP) * 2 +
         kStages * 2 * inner_tile<DP>() * 4;
}

// lse of a query row for exp(): +inf (p = 0) past Sq and for a row with no
// visible key
__device__ __forceinline__ float row_lse(const float* lse, long long i,
                                         bool live) {
  if (!live) return INFINITY;
  const float l = lse[i];
  return l <= kNegInf * 0.5f ? INFINITY : l;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// ------------------------------------------------------------ bf16: dq
// One key tile of the dq kernel: s = q k^T, dp = do v^T, ds, dq += ds k.
// MASK: the causal diagonal or the ragged key tail.
template <int DP, int BN, bool MASK>
__device__ __forceinline__ void dq_tile(
    float (&acc)[DP / 8][4], uint32_t (&qa)[DP / 16][4],
    uint32_t (&da)[DP / 16][4], const bf16* ks, const bf16* vs, int kt,
    int r0, int Sk, int offset, bool causal, float scale, float scale2,
    float ls0, float ls1, float dl0, float dl1, int lane) {
  constexpr int NK = DP / 16, NS = BN / 8, NO = DP / 8;
  const int t = lane % 4;
  float s[NS][4], dp[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  }
  if constexpr (use_wgmma<DP>()) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      wgmma_rs<BN, 0>(s, qa[kk], wgmma_desc(ks + kk * 16, DP * 2));
      wgmma_rs<BN, 0>(dp, da[kk], wgmma_desc(vs + kk * 16, DP * 2));
    }
    wgmma_commit();
    wgmma_wait();
    hopper::reg_fence(s);
    hopper::reg_fence(dp);
  } else {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bk[4], bv[4];
        ldsm_b<DP>(bk, ks, j2 * 16, kk, lane);
        ldsm_b<DP>(bv, vs, j2 * 16, kk, lane);
        mma_bf16(s[2 * j2], qa[kk], bk);
        mma_bf16(s[2 * j2 + 1], qa[kk], bk + 2);
        mma_bf16(dp[2 * j2], da[kk], bv);
        mma_bf16(dp[2 * j2 + 1], da[kk], bv + 2);
      }
    }
  }
  // s <- ds = p (dp - delta) sm_scale
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[nt][e] * scale2 - (e < 2 ? ls0 : ls1));
      if (MASK) {
        const int key = kt + nt * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? r0 : r0 + 8;
        if (key >= Sk || (causal && key > row + offset)) p = 0.f;
      }
      s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * scale;
    }
  }
  // dq += ds k: ds rounded to bf16 in the A fragments, k read transposed
  // (wgmma's transpose bit, or ldmatrix.trans)
  if constexpr (use_wgmma<DP>()) {
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DP, 1>(acc, pa[kk], wgmma_desc(ks + kk * 16 * DP, DP * 2));
    wgmma_commit();
    wgmma_wait();
    hopper::reg_fence(acc);
    hold_regs(pa);
  } else {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_bt<DP>(b, ks, kk * 16, np, lane);
        mma_bf16(acc[2 * np], pa, b);
        mma_bf16(acc[2 * np + 1], pa, b + 2);
      }
    }
  }
}

// dq and delta: one CTA per (batch*head, 64-query tile), heavy causal tiles
// first; the kv loop stops at the tile's last visible key
// (flash.py:266-269).
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(Args a) {
  constexpr int BN = inner_tile<DP>();
  constexpr int NK = DP / 16, NO = DP / 8;
  constexpr int TILE = BN * DP;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kRows * DP;
  bf16* ring = do_s + kRows * DP;  // kStages x [K tile | V tile]
  static_assert(2 * TILE >= kRows * DP, "o shares one ring stage");
  bf16* o_s = ring + (kStages - 1) * 2 * TILE;  // free until the loop

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = q_tile * kRows;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const bool vec = a.vec;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h;
  const bf16* db = static_cast<const bf16*>(a.dout) + b * a.dos.b +
                   h * a.dos.h;

  int kv_end = Sk, full_end = Sk;
  if (a.causal) {
    kv_end = min(Sk, q0 + kRows + offset);
    full_end = max(0, min(Sk, q0 + offset + 1));  // visible to every row
  }
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
  const int n_full = full_end / BN;  // tiles that need no mask

  stage_tile<DP, kRows, kThreads>(q_s, qb, a.qs.s, q0, Sq, D, vec);
  stage_tile<DP, kRows, kThreads>(do_s, db, a.dos.s, q0, Sq, D, vec);
  stage_tile<DP, kRows, kThreads>(o_s, ob, a.os.s, q0, Sq, D, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      bf16* slot = ring + st * 2 * TILE;
      stage_tile<DP, BN, kThreads>(slot, kb, a.ks.s, st * BN, Sk, D, vec);
      stage_tile<DP, BN, kThreads>(slot + TILE, vb, a.vs.s, st * BN, Sk, D,
                                   vec);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the resident rows
  if (use_wgmma<DP>()) hopper::fence_async_smem();
  __syncthreads();

  uint32_t qa[NK][4], da[NK][4];
  ldsm_a<DP, NK>(qa, q_s, warp * 16, lane);
  ldsm_a<DP, NK>(da, do_s, warp * 16, lane);
  // delta = rowsum(do * o) - g_lse: fp32 sums of the bf16 products
  float dl0 = 0.f, dl1 = 0.f;
  {
    uint32_t oa[NK][4];
    ldsm_a<DP, NK>(oa, o_s, warp * 16, lane);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const float2 x = unpack_bf16(da[kk][reg]);
        const float2 y = unpack_bf16(oa[kk][reg]);
        const float part = x.x * y.x + x.y * y.y;
        if (reg & 1) dl1 += part; else dl0 += part;
      }
    }
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long row0 = (long long)bh * Sq;
  if (a.g_lse != nullptr) {
    if (r0 < Sq) dl0 -= a.g_lse[row0 + r0];
    if (r1 < Sq) dl1 -= a.g_lse[row0 + r1];
  }
  if (t == 0) {
    if (r0 < Sq) a.delta[row0 + r0] = dl0;
    if (r1 < Sq) a.delta[row0 + r1] = dl1;
  }
  // in the log2 domain of ex2
  const float ls0 = row_lse(a.lse, row0 + r0, r0 < Sq) * kLog2e;
  const float ls1 = row_lse(a.lse, row0 + r1, r1 < Sq) * kLog2e;
  const float scale = a.sm_scale, scale2 = scale * kLog2e;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int slot = 0;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j has landed
    if (use_wgmma<DP>()) hopper::fence_async_smem();
    __syncthreads();               // and tile j - 1's stage is free
    const int jn = j + kStages - 1;
    if (jn < n_tiles) {
      bf16* next = ring + (jn % kStages) * 2 * TILE;
      stage_tile<DP, BN, kThreads>(next, kb, a.ks.s, jn * BN, Sk, D, vec);
      stage_tile<DP, BN, kThreads>(next + TILE, vb, a.vs.s, jn * BN, Sk, D,
                                   vec);
    }
    cp_async_commit();
    const bf16* ks = ring + slot * 2 * TILE;
    if (j < n_full)
      dq_tile<DP, BN, false>(acc, qa, da, ks, ks + TILE, j * BN, r0, Sk,
                             offset, a.causal, scale, scale2, ls0, ls1, dl0,
                             dl1, lane);
    else
      dq_tile<DP, BN, true>(acc, qa, da, ks, ks + TILE, j * BN, r0, Sk,
                            offset, a.causal, scale, scale2, ls0, ls1, dl0,
                            dl1, lane);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  store_rows<NO>(static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h,
                 a.dqs.s, acc, r0, Sq, D, t);
}

// ------------------------------------------------------------ bf16: dk/dv
// One query tile of the dk/dv kernel: s^T = k q^T, dp^T = v do^T, p^T,
// ds^T, dv += p^T do, dk += ds^T q. MASK: the causal diagonal (the only
// tiles where a query row can have no visible key).
template <int DP, int BQ, bool MASK>
__device__ __forceinline__ void dkv_tile(
    float (&dk)[DP / 8][4], float (&dv)[DP / 8][4],
    uint32_t (&ka)[DP / 16][4], uint32_t (&va)[DP / 16][4], const bf16* qs,
    const bf16* ds_, const float* lse_t, const float* dl_t, int qt, int r0,
    int offset, float scale, float scale2, int lane) {
  constexpr int NK = DP / 16, NS = BQ / 8, NO = DP / 8;
  const int t = lane % 4;
  float st[NS][4], dpt[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
  }
  if constexpr (use_wgmma<DP>()) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      wgmma_rs<BQ, 0>(st, ka[kk], wgmma_desc(qs + kk * 16, DP * 2));
      wgmma_rs<BQ, 0>(dpt, va[kk], wgmma_desc(ds_ + kk * 16, DP * 2));
    }
    wgmma_commit();
    wgmma_wait();
    hopper::reg_fence(st);
    hopper::reg_fence(dpt);
  } else {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bq[4], bd[4];
        ldsm_b<DP>(bq, qs, j2 * 16, kk, lane);
        ldsm_b<DP>(bd, ds_, j2 * 16, kk, lane);
        mma_bf16(st[2 * j2], ka[kk], bq);
        mma_bf16(st[2 * j2 + 1], ka[kk], bq + 2);
        mma_bf16(dpt[2 * j2], va[kk], bd);
        mma_bf16(dpt[2 * j2 + 1], va[kk], bd + 2);
      }
    }
  }
  // st <- p^T, dpt <- ds^T (rows are keys, columns queries)
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    const int col = nt * 8 + t * 2;
    const float2 L = *reinterpret_cast<const float2*>(lse_t + col);
    const float2 Dl = *reinterpret_cast<const float2*>(dl_t + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float l = (e & 1) ? L.y : L.x;
      if (MASK && l <= kNegInf * 0.5f) l = INFINITY;  // no visible key
      float p = ex2(st[nt][e] * scale2 - l * kLog2e);
      if (MASK) {
        const int key = e < 2 ? r0 : r0 + 8;
        if (key > qt + col + (e & 1) + offset) p = 0.f;
      }
      st[nt][e] = p;
      dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? Dl.y : Dl.x)) * scale;
    }
  }
  // dv += p^T do, dk += ds^T q: p, ds rounded to bf16 in the A fragments;
  // do and q read transposed (wgmma's transpose bit, or ldmatrix.trans)
  if constexpr (use_wgmma<DP>()) {
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pa[kk][0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[kk][1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[kk][2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[kk][0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[kk][1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[kk][2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[kk][3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<DP, 1>(dv, pa[kk], wgmma_desc(ds_ + kk * 16 * DP, DP * 2));
      wgmma_rs<DP, 1>(dk, sa[kk], wgmma_desc(qs + kk * 16 * DP, DP * 2));
    }
    wgmma_commit();
    wgmma_wait();
    hopper::reg_fence(dv);
    hopper::reg_fence(dk);
    hold_regs(pa);
    hold_regs(sa);
  } else {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bd[4], bq[4];
        ldsm_bt<DP>(bd, ds_, kk * 16, np, lane);
        ldsm_bt<DP>(bq, qs, kk * 16, np, lane);
        mma_bf16(dv[2 * np], pa, bd);
        mma_bf16(dv[2 * np + 1], pa, bd + 2);
        mma_bf16(dk[2 * np], sa, bq);
        mma_bf16(dk[2 * np + 1], sa, bq + 2);
      }
    }
  }
}

// dk, dv: one CTA per (batch*head, 64-key tile), heavy causal tiles first;
// the q loop starts at the first tile that sees the CTA's first key
// (flash.py:299-303) and runs the diagonal tiles first.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(Args a) {
  constexpr int BQ = inner_tile<DP>();
  constexpr int NK = DP / 16, NO = DP / 8;
  constexpr int TILE = BQ * DP;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kRows * DP;
  bf16* ring = v_s + kRows * DP;  // kStages x [Q tile | dO tile]
  float* lse_r = reinterpret_cast<float*>(ring + kStages * 2 * TILE);
  float* dl_r = lse_r + kStages * BQ;

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kRows;
  const int r0 = k0 + warp * 16 + g;  // this thread's keys: r0, r0 + 8
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const bool vec = a.vec;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* db = static_cast<const bf16*>(a.dout) + b * a.dos.b +
                   h * a.dos.h;
  const float* lse_b = a.lse + (long long)bh * Sq;
  const float* dl_b = a.delta + (long long)bh * Sq;

  int q_begin = 0, n_masked = 0;
  if (a.causal) q_begin = (max(k0 - offset, 0) / BQ) * BQ;
  const int n_tiles = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  if (a.causal) {
    // tile qt is masked while its first query sees fewer keys than the
    // CTA's last: qt + offset < k0 + kRows - 1
    const int span = k0 + kRows - 1 - offset - q_begin;
    n_masked = span <= 0 ? 0 : min(n_tiles, (span + BQ - 1) / BQ);
  }

  auto stage_q = [&](int j, int st) {
    const int qt = q_begin + j * BQ;
    bf16* slot = ring + st * 2 * TILE;
    stage_tile<DP, BQ, kThreads>(slot, qb, a.qs.s, qt, Sq, D, vec);
    stage_tile<DP, BQ, kThreads>(slot + TILE, db, a.dos.s, qt, Sq, D, vec);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool live = qt + i < Sq;
      cp_async4(lse_r + st * BQ + i, live ? lse_b + qt + i : lse_b,
                live ? 4 : 0);
      cp_async4(dl_r + st * BQ + i, live ? dl_b + qt + i : dl_b,
                live ? 4 : 0);
    }
  };

  stage_tile<DP, kRows, kThreads>(k_s, kb, a.ks.s, k0, Sk, D, vec);
  stage_tile<DP, kRows, kThreads>(v_s, vb, a.vs.s, k0, Sk, D, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) stage_q(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the resident rows
  if (use_wgmma<DP>()) hopper::fence_async_smem();
  __syncthreads();

  uint32_t ka[NK][4], va[NK][4];
  ldsm_a<DP, NK>(ka, k_s, warp * 16, lane);
  ldsm_a<DP, NK>(va, v_s, warp * 16, lane);
  const float scale = a.sm_scale, scale2 = scale * kLog2e;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  int slot = 0;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    if (use_wgmma<DP>()) hopper::fence_async_smem();
    __syncthreads();
    const int jn = j + kStages - 1;
    if (jn < n_tiles) stage_q(jn, jn % kStages);
    cp_async_commit();
    const bf16* qs = ring + slot * 2 * TILE;
    const int qt = q_begin + j * BQ;
    if (j < n_masked)
      dkv_tile<DP, BQ, true>(dk, dv, ka, va, qs, qs + TILE, lse_r + slot * BQ,
                             dl_r + slot * BQ, qt, r0, offset, scale, scale2,
                             lane);
    else
      dkv_tile<DP, BQ, false>(dk, dv, ka, va, qs, qs + TILE,
                              lse_r + slot * BQ, dl_r + slot * BQ, qt, r0,
                              offset, scale, scale2, lane);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  store_rows<NO>(static_cast<bf16*>(a.dk) + b * a.dks.b + h * a.dks.h,
                 a.dks.s, dk, r0, Sk, D, t);
  store_rows<NO>(static_cast<bf16*>(a.dv) + b * a.dvs.b + h * a.dvs.h,
                 a.dvs.s, dv, r0, Sk, D, t);
}

// ------------------------------------------------------------ fp32: FMA
constexpr int kTPR = 4;  // threads per row
constexpr int kThreads32 = kRows * kTPR;

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads32)
flash_bwd_dq_f32_kernel(Args a) {
  constexpr int NV = DP / 16;
  __shared__ float4 k_tile[BK][DP / 4];
  __shared__ float4 v_tile[BK][DP / 4];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int q0 = q_tile * kRows;
  const int r = q0 + row;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const float scale = a.sm_scale;

  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* ob = static_cast<const float*>(a.o) + b * a.os.b + h * a.os.h;
  const float* db = static_cast<const float*>(a.dout) + b * a.dos.b +
                    h * a.dos.h;

  float4 qr[NV], dr[NV], acc[NV];
  load_row_f32<NV>(qr, qb, a.qs.s, r, Sq, D, t);
  load_row_f32<NV>(dr, db, a.dos.s, r, Sq, D, t);
  // delta = rowsum(do * o) - g_lse, written for the dk/dv kernel
  float delta = 0.f;
  {
    float4 orow[NV];
    load_row_f32<NV>(orow, ob, a.os.s, r, Sq, D, t);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      delta += dr[i].x * orow[i].x + dr[i].y * orow[i].y +
               dr[i].z * orow[i].z + dr[i].w * orow[i].w;
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  const long long ri = (long long)bh * Sq + r;
  if (a.g_lse != nullptr && r < Sq) delta -= a.g_lse[ri];
  if (t == 0 && r < Sq) a.delta[ri] = delta;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = row_lse(a.lse, ri, r < Sq);

  int kv_end = Sk;
  if (a.causal) kv_end = min(Sk, q0 + kRows + offset);

  for (int kt = 0; kt < kv_end; kt += BK) {
    __syncthreads();
    stage_f32<DP>(&k_tile[0][0], kb + (long long)kt * a.ks.s, a.ks.s, Sk - kt,
                  BK, D);
    stage_f32<DP>(&v_tile[0][0], vb + (long long)kt * a.vs.s, a.vs.s, Sk - kt,
                  BK, D);
    __syncthreads();
    const int tile_n = min(BK, kv_end - kt);
    for (int j = 0; j < tile_n; ++j) {
      const float s = dot4<NV>(qr, k_tile[j], t);
      const float dp = dot4<NV>(dr, v_tile[j], t);
      float x = s * scale;
      if (a.causal && kt + j > r + offset) x = kNegInf;
      const float p = expf(x - lse);
      axpy4<NV>(acc, p * (dp - delta) * scale, k_tile[j], t);
    }
  }
  if (r < Sq)
    store_row_f32<NV>(static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h,
                      a.dqs.s, r, D, t, acc);
}

template <int DP, int BQ>
__global__ void __launch_bounds__(kThreads32)
flash_bwd_dkv_f32_kernel(Args a) {
  constexpr int NV = DP / 16;
  __shared__ float4 q_tile[BQ][DP / 4];
  __shared__ float4 d_tile[BQ][DP / 4];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int k0 = blockIdx.x * kRows;
  const int key = k0 + row;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const float scale = a.sm_scale;

  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* db = static_cast<const float*>(a.dout) + b * a.dos.b +
                    h * a.dos.h;

  float4 kr[NV], vr[NV], dk[NV], dv[NV];
  load_row_f32<NV>(kr, kb, a.ks.s, key, Sk, D, t);
  load_row_f32<NV>(vr, vb, a.vs.s, key, Sk, D, t);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    dk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int q_begin = 0;
  if (a.causal) q_begin = (max(k0 - offset, 0) / BQ) * BQ;

  for (int qt = q_begin; qt < Sq; qt += BQ) {
    __syncthreads();
    stage_f32<DP>(&q_tile[0][0], qb + (long long)qt * a.qs.s, a.qs.s, Sq - qt,
                  BQ, D);
    stage_f32<DP>(&d_tile[0][0], db + (long long)qt * a.dos.s, a.dos.s,
                  Sq - qt, BQ, D);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const int qi = qt + i;
      lse_s[i] = row_lse(a.lse, (long long)bh * Sq + qi, qi < Sq);
      delta_s[i] = qi < Sq ? a.delta[(long long)bh * Sq + qi] : 0.f;
    }
    __syncthreads();
    const int tile_n = min(BQ, Sq - qt);
    for (int i = 0; i < tile_n; ++i) {
      const float s = dot4<NV>(kr, q_tile[i], t);
      const float dp = dot4<NV>(vr, d_tile[i], t);
      float x = s * scale;
      if (a.causal && key > qt + i + offset) x = kNegInf;
      const float p = key < Sk ? expf(x - lse_s[i]) : 0.f;
      axpy4<NV>(dv, p, d_tile[i], t);
      axpy4<NV>(dk, p * (dp - delta_s[i]) * scale, q_tile[i], t);
    }
  }
  if (key < Sk) {
    store_row_f32<NV>(static_cast<float*>(a.dk) + b * a.dks.b + h * a.dks.h,
                      a.dks.s, key, D, t, dk);
    store_row_f32<NV>(static_cast<float*>(a.dv) + b * a.dvs.b + h * a.dvs.h,
                      a.dvs.s, key, D, t, dv);
  }
}

// ------------------------------------------------------------ launch
// the fp32 kernels' inner tile: 64 rows, 32 at D = 128 (static 48 KB)
template <int DP>
constexpr int f32_tile() { return DP <= 64 ? 64 : 32; }

template <typename Kernel>
cudaError_t launch_bf16(Kernel kernel, dim3 grid, int smem, const Args& a) {
  // above 48 KB of dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq_launch(const Args& a, int dtype) {
  dim3 grid((a.Sq + kRows - 1) / kRows, a.B * a.H);
  if (dtype == 1)
    return launch_bf16(flash_bwd_dq_bf16_kernel<DP>, grid,
                       dq_smem_bytes<DP>(), a);
  flash_bwd_dq_f32_kernel<DP, f32_tile<DP>()>
      <<<grid, kThreads32, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_launch(const Args& a, int dtype) {
  dim3 grid((a.Sk + kRows - 1) / kRows, a.B * a.H);
  if (dtype == 1)
    return launch_bf16(flash_bwd_dkv_bf16_kernel<DP>, grid,
                       dkv_smem_bytes<DP>(), a);
  flash_bwd_dkv_f32_kernel<DP, f32_tile<DP>()>
      <<<grid, kThreads32, 0, a.stream>>>(a);
  return cudaGetLastError();
}

typedef cudaError_t (*Launch)(const Args&, int);

cudaError_t by_head_dim(const Args& a, int dtype, Launch l16, Launch l32,
                        Launch l64, Launch l128) {
  if (a.D <= 16) return l16(a, dtype);
  if (a.D <= 32) return l32(a, dtype);
  if (a.D <= 64) return l64(a, dtype);
  return l128(a, dtype);
}

bool make_args(Args* a, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               const float* g_lse, float* delta, void* dq, void* dk,
               void* dv, int dtype, int B, int H, int Sq, int Sk, int D,
               const long long* st, float sm_scale, int causal, int vec,
               void* stream) {
  if (D < 1 || D > 128 || B * H == 0 || Sq == 0 || Sk == 0) return false;
  if (dtype != 0 && dtype != 1) return false;
  *a = Args{q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, B, H, Sq, Sk, D,
            Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
            Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
            Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
            Strides{st[18], st[19], st[20]}, Strides{st[21], st[22], st[23]},
            sm_scale, causal, vec, static_cast<cudaStream_t>(stream)};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 24 element strides,
// (batch, head, seq) of q, k, v, o, do, dq, dk, dv in that order; every
// head dim must be contiguous. lse, g_lse (null: no lse cotangent) and
// delta are contiguous fp32 [B, H, Sq]. vec = 1 when D % 8 == 0 and the
// rows of q, k, v, o and do are 16-byte aligned. 1 <= D <= 128.
// ds_flash_bwd_dq writes dq and delta = rowsum(do * o) - g_lse (dk, dv
// unused); ds_flash_bwd_dkv reads that delta and writes dk and dv (dq, o
// and g_lse unused): launch it after ds_flash_bwd_dq on the same stream.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, const float* g_lse,
                               float* delta, void* dq, void* dk, void* dv,
                               int dtype, int B, int H, int Sq, int Sk, int D,
                               const long long* strides, float sm_scale,
                               int causal, int vec, void* stream) {
  Args a;
  if (!make_args(&a, q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, dtype,
                 B, H, Sq, Sk, D, strides, sm_scale, causal, vec, stream))
    return cudaErrorInvalidValue;
  return by_head_dim(a, dtype, dq_launch<16>, dq_launch<32>, dq_launch<64>,
                     dq_launch<128>);
}

extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, const float* g_lse,
                                float* delta, void* dq, void* dk, void* dv,
                                int dtype, int B, int H, int Sq, int Sk,
                                int D, const long long* strides,
                                float sm_scale, int causal, int vec,
                                void* stream) {
  Args a;
  if (!make_args(&a, q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, dtype,
                 B, H, Sq, Sk, D, strides, sm_scale, causal, vec, stream))
    return cudaErrorInvalidValue;
  return by_head_dim(a, dtype, dkv_launch<16>, dkv_launch<32>,
                     dkv_launch<64>, dkv_launch<128>);
}
