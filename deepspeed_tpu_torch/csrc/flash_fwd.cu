// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/transformer/flash.py
// `_fwd_kernel_resident` (:211) and its streaming form `_fwd_kernel` (:67):
// softmax(q k^T * sm_scale) v with an online softmax, so the [Sq, Sk] score
// matrix never reaches device memory, plus the fp32 log-sum-exp per row.
// A loop inside the CTA takes the place of the TPU's sequential kv grid
// axis, so one kernel covers both TPU forms. Causal attention stops the kv
// loop at the tile's last visible key (offset = Sk - Sq, the decode-suffix
// convention); a ragged tail is masked, never padded. A row that sees no
// key at all (Sq > Sk, causal) gets o = 0 and lse at the -1e30 masking
// value, so the backward's "p = 0" rule holds for it.
//
// Bound on the H100: at GPT-2 prefill (B 8, H 16, S 896, D 64, causal)
// the q/k/v/o bytes take 17.7 us at 3.35 TB/s and the bf16 work 13.3 us at
// 989 TFLOP/s; at BERT's B 64, S 128 (non-causal) the bytes take 20.2 us.
// Bytes and products weigh about the same, so the design keeps both the
// loads and the tensor cores busy:
// * bf16, design (the dq kernel of flash_bwd.cu with a softmax in place
//   of ds): a warpgroup (four warps, 16 query rows each) owns 64 rows; a
//   CTA holds two warpgroups (128 rows) at D <= 64, one at D 128; grid
//   (batch*head, query tile), the heavy causal tiles first. Q is staged
//   once by cp.async and held as A fragments (ldmatrix). K and V tiles of
//   64 keys stream through a ring of 3 stages in dynamic shared memory (16
//   KB a stage at D 64), filled by 16-byte cp.async with zero fill past
//   Sk, so tiles j+1 and j+2 are in flight while tile j's products run;
//   both warpgroups read each tile, which halves the K/V traffic a row
//   against 64-row CTAs (on an H100 80GB HBM3 at 700 W: 0.065 against
//   0.072 ms at the prefill shape, 0.034 against 0.040 at BERT's, device
//   time). Q is staged into the last stage, free until the loop's first
//   issue. One barrier a tile; a warpgroup skips the tiles past its own
//   diagonal. Each tile's products are waited for in turn: overlapping
//   them with the warpgroup's own softmax (wgmma.wait_group 1) measured
//   slower, as ptxas serialized the wgmmas around the skip.
// * Tiles are stored row-major in the XOR swizzle of hopper_common.cuh.
//   At D 16, 32 and 64 the products are warpgroup MMAs with A from
//   registers: s = q k^T with K as the K-major B operand, o += p v with V
//   row-major as the MN-major B operand (the transpose bit), so no
//   transposed copy of V is written. At D 128 (256-byte rows, no hardware
//   swizzle) the same tiles feed mma.sync through ldmatrix (K) and
//   ldmatrix.trans (V).
// * p leaves the score accumulators as the bf16 A fragments of p v
//   without touching shared memory (p rounded to bf16, as the TPU kernel
//   does); the row sum l keeps the fp32 p. sm_scale * log2(e) is folded
//   into ex2; the row max and sum are reduced over the quad by two
//   shuffles. The causal mask and the ragged key tail are applied only on
//   the tiles where they bite (the diagonal and the last tile); the
//   others carry no mask arithmetic.
// * Every head dim 1..256 takes this design, padded with zeros in shared
//   memory to 16, 32, 64, 128 or 256; rows that are not 16-byte aligned
//   (D % 8 != 0, or unaligned views) stage through the registers into the
//   same layout.
// * D 256 (GPT-J): one warpgroup a CTA on mma.sync, as at D 128, but Q
//   stays in shared memory and is read one k-step at a time: the o
//   accumulator alone is 128 fp32 registers a thread, and Q's A fragments
//   would be 64 more. Q gets its own 32 KB after the ring (it is read in
//   every tile), so the 3-stage ring of 64-key K|V tiles (64 KB a stage)
//   and Q take 224 KB of the 227 KB a CTA may have: one CTA an SM. The
//   D <= 128 kernels are unchanged.
// * fp32: the FMA pipes (no TF32, so results keep fp32 accuracy). Four
//   neighbouring threads own a query row and split the head dim as float4
//   groups interleaved by 16, so a warp's shared-memory reads of a key row
//   are 64 contiguous bytes broadcast to its 8 rows; scores are reduced
//   over the 4 threads with two xor-shuffles.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using hopper::AFrags;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2;
using hopper::hold_regs;
using hopper::kLog2e;
using hopper::load_a;
using hopper::ldsm_a1;
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

constexpr int kBQ = 64;  // query rows per CTA (one warpgroup)
constexpr int kBK = 64;  // keys per ring stage
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, Sq, Sk, D;
  Strides qs, ks, vs, os;
  float sm_scale;
  int causal, vec;
  cudaStream_t stream;
};

// DP 256: Q is read from shared memory in every tile (AFrags), so it gets
// its own region after the ring
template <int DP>
constexpr bool q_in_smem() {
  return DP > 128;
}

template <int DP>
constexpr int fwd_smem_bytes() {
  // K | V tiles; Q shares a stage up to DP 128
  return kStages * 2 * kBK * DP * 2 + (q_in_smem<DP>() ? kBQ * DP * 2 : 0);
}

// The running row max of one thread's two rows (scores in the log2
// domain), and the rescale of the earlier tiles' sums. MASK: the tile may
// leave a row with no visible key so far (max -inf); its ex2 offset is
// then 0, so every p is ex2(-inf) = 0, and nothing is rescaled.
template <bool MASK>
__device__ __forceinline__ float row_step(float& m, float mx, float& off) {
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (MASK && mx == -INFINITY) {
    off = 0.f;
    return 1.f;
  }
  const float alpha = ex2(m - mx);  // 0 while m is -inf
  m = off = mx;
  return alpha;
}

// One key tile: s = q k^T, the online softmax, o += p v. MASK: the causal
// diagonal or the ragged key tail.
template <int DP, bool MASK>
__device__ __forceinline__ void fwd_tile(
    float (&acc)[DP / 8][4], AFrags<DP>& qa, const bf16* ks,
    const bf16* vs, int kt, int r0, int Sk, int offset, bool causal,
    float scale2, float& m0, float& m1, float& l0, float& l1, int lane) {
  constexpr int NK = DP / 16, NS = kBK / 8, NO = DP / 8;
  const int t = lane % 4;
  float s[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  if constexpr (use_wgmma<DP>()) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_rs<kBK, 0>(s, qa[kk], wgmma_desc(ks + kk * 16, DP * 2));
    wgmma_commit();
    wgmma_wait();
    hopper::reg_fence(s);
  } else if constexpr (q_in_smem<DP>()) {
#pragma unroll 4
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      ldsm_a1<DP>(a, qa.tile, qa.r0, kk, lane);
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bk[4];
        ldsm_b<DP>(bk, ks, j2 * 16, kk, lane);
        mma_bf16(s[2 * j2], a, bk);
        mma_bf16(s[2 * j2 + 1], a, bk + 2);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bk[4];
        ldsm_b<DP>(bk, ks, j2 * 16, kk, lane);
        mma_bf16(s[2 * j2], qa[kk], bk);
        mma_bf16(s[2 * j2 + 1], qa[kk], bk + 2);
      }
    }
  }
  // s <- s * sm_scale * log2(e), masked to -inf where the mask bites
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] *= scale2;
      if (MASK) {
        const int key = kt + nt * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? r0 : r0 + 8;
        if (key >= Sk || (causal && key > row + offset)) s[nt][e] = -INFINITY;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  float off0, off1;
  const float alpha0 = row_step<MASK>(m0, mx0, off0);
  const float alpha1 = row_step<MASK>(m1, mx1, off1);
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= alpha0; acc[n][1] *= alpha0;
    acc[n][2] *= alpha1; acc[n][3] *= alpha1;
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    s[nt][0] = ex2(s[nt][0] - off0);
    s[nt][1] = ex2(s[nt][1] - off0);
    s[nt][2] = ex2(s[nt][2] - off1);
    s[nt][3] = ex2(s[nt][3] - off1);
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
  // o += p v: p rounded to bf16 in the A fragments (the C-to-A layout
  // step), v read transposed (wgmma's transpose bit, or ldmatrix.trans)
  if constexpr (use_wgmma<DP>()) {
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<DP, 1>(acc, pa[kk], wgmma_desc(vs + kk * 16 * DP, DP * 2));
    wgmma_commit();
    wgmma_wait();
    hopper::reg_fence(acc);
    hold_regs(pa);
  } else {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_bt<DP>(b, vs, kk * 16, np, lane);
        mma_bf16(acc[2 * np], pa, b);
        mma_bf16(acc[2 * np + 1], pa, b + 2);
      }
    }
  }
}

// ------------------------------------------------------------ bf16
// DP: head dim padded to 16, 32, 64, 128 or 256 (zeros beyond D). WG
// warpgroups a CTA, 64 query rows each, sharing the K/V ring.
template <int DP, int WG>
__global__ void __launch_bounds__(kThreads * WG)
flash_fwd_bf16_kernel(Args a) {
  constexpr int NO = DP / 8;
  constexpr int TILE = kBK * DP;
  constexpr int NT = kThreads * WG;
  static_assert(kBQ == kBK && WG <= 2, "Q is staged into one ring stage");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // kStages x [K tile | V tile]
  // Q: in the last stage, free until the loop; after the ring at DP 256
  bf16* q_s = ring + (q_in_smem<DP>() ? kStages : kStages - 1) * 2 * TILE;

  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int b = bh / a.H, h = bh % a.H;
  const int wg = threadIdx.x / kThreads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0 = q_tile * kBQ * WG;  // the CTA's first row
  const int w0 = q0 + wg * kBQ;      // this warpgroup's first row
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;  // this thread's rows
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const bool vec = a.vec;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;

  // key tiles of the CTA (its last warpgroup's) and of this warpgroup
  int kv_end = Sk, kv_end_w = Sk, full_end = Sk;
  if (a.causal) {
    kv_end = min(Sk, q0 + kBQ * WG + offset);
    kv_end_w = min(Sk, w0 + kBQ + offset);
    full_end = max(0, min(Sk, w0 + offset + 1));  // visible to every row
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int n_tiles_w = kv_end_w > 0 ? (kv_end_w + kBK - 1) / kBK : 0;
  const int n_full = full_end / kBK;  // tiles that need no mask

  stage_tile<DP, kBQ * WG, NT>(q_s, qb, a.qs.s, q0, Sq, D, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      bf16* slot = ring + st * 2 * TILE;
      stage_tile<DP, kBK, NT>(slot, kb, a.ks.s, st * kBK, Sk, D, vec);
      stage_tile<DP, kBK, NT>(slot + TILE, vb, a.vs.s, st * kBK, Sk, D, vec);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q
  __syncthreads();

  AFrags<DP> qa;
  load_a<DP>(qa, q_s, warp * 16, lane);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale2 = a.sm_scale * kLog2e;

  int slot = 0;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j has landed
    if (use_wgmma<DP>()) hopper::fence_async_smem();
    __syncthreads();               // and tile j - 1's stage (or Q) is free
    const int jn = j + kStages - 1;
    if (jn < n_tiles) {
      bf16* next = ring + (jn % kStages) * 2 * TILE;
      stage_tile<DP, kBK, NT>(next, kb, a.ks.s, jn * kBK, Sk, D, vec);
      stage_tile<DP, kBK, NT>(next + TILE, vb, a.vs.s, jn * kBK, Sk, D, vec);
    }
    cp_async_commit();
    const bf16* ks = ring + slot * 2 * TILE;
    // warpgroup-uniform: tiles past this warpgroup's diagonal are skipped
    if (j < n_full)
      fwd_tile<DP, false>(acc, qa, ks, ks + TILE, j * kBK, r0, Sk, offset,
                          a.causal, scale2, m0, m1, l0, l1, lane);
    else if (j < n_tiles_w)
      fwd_tile<DP, true>(acc, qa, ks, ks + TILE, j * kBK, r0, Sk, offset,
                         a.causal, scale2, m0, m1, l0, l1, lane);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // l = 0: the row saw no key (o = 0, lse at the masking value)
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= inv0; acc[n][1] *= inv0;
    acc[n][2] *= inv1; acc[n][3] *= inv1;
  }
  store_rows<NO>(static_cast<bf16*>(a.o) + b * a.os.b + h * a.os.h, a.os.s,
                 acc, r0, Sq, D, t);
  if (t == 0) {
    float* lse = a.lse + (long long)bh * Sq;
    if (r0 < Sq) lse[r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kNegInf;
    if (r1 < Sq) lse[r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kNegInf;
  }
}

// ------------------------------------------------------------ fp32: FMA
constexpr int kTPR = 4;  // threads per query row
constexpr int kThreads32 = kBQ * kTPR;
constexpr int kChunk = 16;  // keys per online-softmax update

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float sm_scale, int causal) {
  constexpr int NV = DP / 16;  // float4 groups per thread
  __shared__ float4 k_tile[BK][DP / 4];
  __shared__ float4 v_tile[BK][DP / 4];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / kTPR, t = tid % kTPR;
  const int r = q_tile * kBQ + row;
  const int offset = Sk - Sq;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * i + 4 * t + c;
      e[c] = (r < Sq && d < D) ? qb[r * qs.s + d] : 0.f;
    }
    qr[i] = make_float4(e[0], e[1], e[2], e[3]);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q_tile * kBQ + kBQ + offset);

  for (int kt = 0; kt < kv_end; kt += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DP; idx += kThreads32) {
      const int j = idx / DP, d = idx % DP;
      const int key = kt + j;
      const bool in = key < Sk && d < D;
      reinterpret_cast<float*>(k_tile)[idx] = in ? kb[key * ks.s + d] : 0.f;
      reinterpret_cast<float*>(v_tile)[idx] = in ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    const int tile_n = min(BK, kv_end - kt);
    for (int c0 = 0; c0 < tile_n; c0 += kChunk) {
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 kk = k_tile[j][4 * i + t];
          part += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z +
                  qr[i].w * kk.w;
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        float sc = part * sm_scale;
        const int key = kt + j;
        if (key >= Sk)
          sc = -INFINITY;
        else if (causal && key > r + offset)
          sc = kNegInf;
        s[jj] = sc;
        m_new = fmaxf(m_new, sc);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha;
        acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const float4 vv = v_tile[c0 + jj][4 * i + t];
          acc[i].x += p * vv.x; acc[i].y += p * vv.y;
          acc[i].z += p * vv.z; acc[i].w += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (r >= Sq) return;
  // a row that sees no key: o = 0, lse at the masking value
  const bool keyless = causal && r + offset < 0;
  const float l_safe = (l == 0.f || keyless) ? 1.f : l;
  const float inv = keyless ? 0.f : 1.f / l_safe;
  if (keyless) m = kNegInf;
  float* ob = o + b * os.b + h * os.h + r * os.s;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * i + 4 * t + c;
      if (d < D) ob[d] = e[c] * inv;
    }
  }
  if (t == 0) lse[(long long)bh * Sq + r] = m + logf(l_safe);
}

template <int DP, int WG>
cudaError_t launch_bf16_wg(const Args& a) {
  const int q_tiles = (a.Sq + kBQ * WG - 1) / (kBQ * WG);
  if (q_tiles > 65535) return cudaErrorInvalidValue;  // grid.y
  constexpr int smem = fwd_smem_bytes<DP>();
  // above 48 KB of dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP, WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<DP, WG>
      <<<dim3(a.B * a.H, q_tiles), kThreads * WG, smem, a.stream>>>(a);
  return cudaGetLastError();
}

// two warpgroups a CTA where wgmma runs (D <= 64; measured faster on the
// H100 than one: the K/V tiles serve 128 rows), one at D 128 (178
// registers a thread on mma.sync) and 256
template <int DP>
cudaError_t launch_bf16(const Args& a) {
  return launch_bf16_wg<DP, use_wgmma<DP>() ? 2 : 1>(a);
}

template <int DP>
cudaError_t launch_f32(const Args& a) {
  // K+V tiles within 32 KB of static shared memory
  constexpr int BK = DP <= 64 ? 64 : DP <= 128 ? 32 : 16;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_f32_kernel<DP, BK><<<grid, kThreads32, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H,
      a.Sq, a.Sk, a.D, a.qs, a.ks, a.vs, a.os, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <cudaError_t (*L16)(const Args&), cudaError_t (*L32)(const Args&),
          cudaError_t (*L64)(const Args&), cudaError_t (*L128)(const Args&),
          cudaError_t (*L256)(const Args&)>
cudaError_t by_head_dim(const Args& a) {
  if (a.D <= 16) return L16(a);
  if (a.D <= 32) return L32(a);
  if (a.D <= 64) return L64(a);
  if (a.D <= 128) return L128(a);
  return L256(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per tensor
// (batch, head, seq); the head dim must be contiguous. lse is a contiguous
// fp32 [B, H, Sq]. vec = 1 when D % 8 == 0 and the rows of q, k and v are
// 16-byte aligned (16-byte cp.async staging). Requires 1 <= D <= 256.
extern "C" int ds_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float sm_scale, int causal, int vec, void* stream) {
  if (D < 1 || D > 256 || B * H == 0 || Sq == 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, B, H, Sq, Sk, D,
               Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
               Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
               sm_scale, causal, vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return by_head_dim<launch_f32<16>, launch_f32<32>, launch_f32<64>,
                       launch_f32<128>, launch_f32<256>>(a);
  if (dtype == 1)
    return by_head_dim<launch_bf16<16>, launch_bf16<32>, launch_bf16<64>,
                       launch_bf16<128>, launch_bf16<256>>(a);
  return cudaErrorInvalidValue;
}
