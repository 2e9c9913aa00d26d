// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/transformer/flash.py
// `_dq_kernel_resident` (:258) and `_dkv_kernel_resident` (:292) and their
// streaming forms `_dq_kernel` (:120) and `_dkv_kernel` (:159). As there,
// the score matrix is recomputed tile by tile from q, k and the forward's
// fp32 log-sum-exp, never stored:
//   s = q k^T * sm_scale (offset causal mask, -1e30), p = exp(s - lse),
//   dp = do v^T, ds = p (dp - delta) sm_scale,
//   dq = ds k,  dk = ds^T q,  dv = p^T do,
// with delta = rowsum(do * o) computed by the caller (the JAX package
// computes it outside its kernels too, flash.py:461-464). The JAX split
// is kept: the dq kernel owns query tiles and loops over key tiles, the
// dkv kernel owns key tiles and loops over query tiles, so neither needs
// atomics and the gradients are the same from run to run. A loop inside
// the CTA takes the place of the TPU's sequential grid axis, so one kernel
// covers both TPU forms. Ragged tails are masked, never padded.
//
// * bf16: mma.sync m16n8k16 with fp32 accumulation; four warps own 16
//   rows each. The dkv kernel computes the transposed products s^T =
//   k q^T and dp^T = v do^T, so p^T and ds^T come out of the accumulators
//   already in the A-operand orientation of dv += p^T do and dk += ds^T q;
//   q and do are staged row-major (B of the score products) and
//   transposed (B of the gradient products) in shared memory with rows
//   padded by 8. p is rounded to bf16 before p^T do and ds before ds k and
//   ds^T q, where the JAX kernels cast (flash.py:317-325).
// * fp32: FMA pipes, no TF32 (fp32 parity holds); four neighbouring
//   threads own a row and split the head dim as float4 groups, and the
//   dot products are reduced with two xor-shuffles.
//
// Bound on the H100: at GPT-2 medium training (B 8, H 16, S 1024, D 64,
// causal, bf16) the two kernels move ~67 MB (q, k, v, o, do read, dq, dk,
// dv written, lse and delta) in 20 us at 3.35 TB/s, and do ~2.5x the
// forward's flops, ~55 us at 989 TFLOP/s: the least time is set by
// operations. This first form issues synchronous loads and mma.sync without
// pipelining (no TMA, no wgmma), so it runs well above that.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kRows = 64;  // rows a CTA owns (queries for dq, keys for dkv)

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk, D;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float sm_scale;
  int causal, vec;
  cudaStream_t stream;
};

// ------------------------------------------------------------ bf16: mma
// dq: one CTA per (batch*head, 64-query tile); the kv loop stops at the
// tile's last visible key (flash.py:266-269).
template <int DP, int BK>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(Args a) {
  constexpr int KP = DP + 8;   // padded K / V row
  constexpr int TP = BK + 8;   // padded K^T row
  constexpr int NQ = DP / 16;  // k-steps over the head dim
  constexpr int NS = BK / 8;   // score n-tiles
  constexpr int NO = DP / 8;   // dq n-tiles
  __shared__ __align__(16) bf16 k_tile[BK * KP];
  __shared__ __align__(16) bf16 v_tile[BK * KP];
  __shared__ __align__(16) bf16 kt_tile[DP * TP];

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = q_tile * kRows;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const float scale = a.sm_scale;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* db = static_cast<const bf16*>(a.dout) + b * a.dos.b +
                   h * a.dos.h;

  uint32_t qa[NQ][4], da[NQ][4];
  load_a_frags<NQ>(qa, qb, a.qs.s, warp * 16 + g + q0, Sq, D, t);
  load_a_frags<NQ>(da, db, a.dos.s, warp * 16 + g + q0, Sq, D, t);
  // rows past Sq: lse = +inf makes p = 0
  const float lse0 = r0 < Sq ? a.lse[(long long)bh * Sq + r0] : INFINITY;
  const float lse1 = r1 < Sq ? a.lse[(long long)bh * Sq + r1] : INFINITY;
  const float dl0 = r0 < Sq ? a.delta[(long long)bh * Sq + r0] : 0.f;
  const float dl1 = r1 < Sq ? a.delta[(long long)bh * Sq + r1] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int kv_end = Sk;
  if (a.causal) kv_end = min(Sk, q0 + kRows + offset);

  for (int kt = 0; kt < kv_end; kt += BK) {
    __syncthreads();  // the previous tiles are no longer read
    stage_bf16<DP, BK>(k_tile, kt_tile, kb + (long long)kt * a.ks.s, a.ks.s, 0,
                       Sk - kt, D, a.vec);
    stage_bf16<DP, BK>(v_tile, nullptr, vb + (long long)kt * a.vs.s, a.vs.s, 0,
                       Sk - kt, D, a.vec);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t bk[2], bv[2];
        load_b_frag(bk, k_tile, KP, nt * 8, kk * 16, g, t);
        load_b_frag(bv, v_tile, KP, nt * 8, kk * 16, g, t);
        mma_bf16(s[nt], qa[kk], bk);
        mma_bf16(dp[nt], da[kk], bv);
      }
    }
    // s <- ds = p (dp - delta) sm_scale
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + t * 2 + (e & 1);
        const int row = (e < 2) ? r0 : r1;
        float p = 0.f;
        if (key < Sk) {
          float x = s[nt][e] * scale;
          if (a.causal && key > row + offset) x = kNegInf;
          p = __expf(x - ((e < 2) ? lse0 : lse1));
        }
        s[nt][e] = p * (dp[nt][e] - ((e < 2) ? dl0 : dl1)) * scale;
      }
    }
    // dq += ds k (ds rounded to bf16 in the A fragments)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bfrag[2];
        load_b_frag(bfrag, kt_tile, TP, n * 8, kk * 16, g, t);
        mma_bf16(acc[n], pa, bfrag);
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e < 2) ? r0 : r1;
      const int c = n * 8 + t * 2 + (e & 1);
      if (row < Sq && c < D) out[row * a.dqs.s + c] = __float2bfloat16(acc[n][e]);
    }
  }
}

// dk, dv: one CTA per (batch*head, 64-key tile); the q loop starts at the
// first tile that sees the CTA's first key (flash.py:299-303).
template <int DP, int BQ>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16_kernel(Args a) {
  constexpr int KP = DP + 8;   // padded Q / dO row
  constexpr int TP = BQ + 8;   // padded Q^T / dO^T row
  constexpr int NQ = DP / 16;  // k-steps over the head dim
  constexpr int NS = BQ / 8;   // score n-tiles (queries)
  constexpr int NO = DP / 8;   // dk / dv n-tiles
  __shared__ __align__(16) bf16 q_tile[BQ * KP];
  __shared__ __align__(16) bf16 d_tile[BQ * KP];
  __shared__ __align__(16) bf16 qt_tile[DP * TP];
  __shared__ __align__(16) bf16 dt_tile[DP * TP];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int k_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = k_tile * kRows;
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;  // this thread's keys
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, offset = Sk - Sq;
  const float scale = a.sm_scale;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* db = static_cast<const bf16*>(a.dout) + b * a.dos.b +
                   h * a.dos.h;

  uint32_t ka[NQ][4], va[NQ][4];
  load_a_frags<NQ>(ka, kb, a.ks.s, r0, Sk, D, t);
  load_a_frags<NQ>(va, vb, a.vs.s, r0, Sk, D, t);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  int q_begin = 0;
  if (a.causal) q_begin = (max(k0 - offset, 0) / BQ) * BQ;

  for (int qt = q_begin; qt < Sq; qt += BQ) {
    __syncthreads();
    stage_bf16<DP, BQ>(q_tile, qt_tile, qb + (long long)qt * a.qs.s, a.qs.s, 0,
                       Sq - qt, D, a.vec);
    stage_bf16<DP, BQ>(d_tile, dt_tile, db + (long long)qt * a.dos.s, a.dos.s,
                       0, Sq - qt, D, a.vec);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const int qi = qt + i;
      lse_s[i] = qi < Sq ? a.lse[(long long)bh * Sq + qi] : INFINITY;
      delta_s[i] = qi < Sq ? a.delta[(long long)bh * Sq + qi] : 0.f;
    }
    __syncthreads();

    // st = k q^T, dpt = v do^T: rows are keys, columns queries
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t bq[2], bd[2];
        load_b_frag(bq, q_tile, KP, nt * 8, kk * 16, g, t);
        load_b_frag(bd, d_tile, KP, nt * 8, kk * 16, g, t);
        mma_bf16(st[nt], ka[kk], bq);
        mma_bf16(dpt[nt], va[kk], bd);
      }
    }
    // st <- p^T, dpt <- ds^T
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int query = qt + col;
        const int key = (e < 2) ? r0 : r1;
        float p = 0.f;
        if (query < Sq && key < Sk) {
          float x = st[nt][e] * scale;
          if (a.causal && key > query + offset) x = kNegInf;
          p = __expf(x - lse_s[col]);
        }
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[col]) * scale;
      }
    }
    // dv += p^T do, dk += ds^T q (p, ds rounded to bf16 in the A fragments)
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
      for (int n = 0; n < NO; ++n) {
        uint32_t bd[2], bq[2];
        load_b_frag(bd, dt_tile, TP, n * 8, kk * 16, g, t);
        load_b_frag(bq, qt_tile, TP, n * 8, kk * 16, g, t);
        mma_bf16(dv[n], pa, bd);
        mma_bf16(dk[n], sa, bq);
      }
    }
  }

  bf16* dko = static_cast<bf16*>(a.dk) + b * a.dks.b + h * a.dks.h;
  bf16* dvo = static_cast<bf16*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = (e < 2) ? r0 : r1;
      const int c = n * 8 + t * 2 + (e & 1);
      if (key < Sk && c < D) {
        dko[key * a.dks.s + c] = __float2bfloat16(dk[n][e]);
        dvo[key * a.dvs.s + c] = __float2bfloat16(dv[n][e]);
      }
    }
  }
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
  const float* db = static_cast<const float*>(a.dout) + b * a.dos.b +
                    h * a.dos.h;

  float4 qr[NV], dr[NV], acc[NV];
  load_row_f32<NV>(qr, qb, a.qs.s, r, Sq, D, t);
  load_row_f32<NV>(dr, db, a.dos.s, r, Sq, D, t);
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = r < Sq ? a.lse[(long long)bh * Sq + r] : INFINITY;
  const float delta = r < Sq ? a.delta[(long long)bh * Sq + r] : 0.f;

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
      lse_s[i] = qi < Sq ? a.lse[(long long)bh * Sq + qi] : INFINITY;
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
// tiles of the inner loop: 64 rows, 32 at D = 128 (shared memory and
// registers stay within the static 48 KB and 255 a thread)
template <int DP>
constexpr int inner_tile() { return DP <= 64 ? 64 : 32; }

template <int DP>
cudaError_t dq_launch(const Args& a, int dtype) {
  dim3 grid((a.Sq + kRows - 1) / kRows, a.B * a.H);
  if (dtype == 1)
    flash_bwd_dq_bf16_kernel<DP, inner_tile<DP>()><<<grid, 128, 0, a.stream>>>(a);
  else
    flash_bwd_dq_f32_kernel<DP, inner_tile<DP>()>
        <<<grid, kThreads32, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_launch(const Args& a, int dtype) {
  dim3 grid((a.Sk + kRows - 1) / kRows, a.B * a.H);
  if (dtype == 1)
    flash_bwd_dkv_bf16_kernel<DP, inner_tile<DP>()>
        <<<grid, 128, 0, a.stream>>>(a);
  else
    flash_bwd_dkv_f32_kernel<DP, inner_tile<DP>()>
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
               const void* dout, const float* lse, const float* delta,
               void* dq, void* dk, void* dv, int dtype, int B, int H, int Sq,
               int Sk, int D, const long long* st, float sm_scale, int causal,
               int vec, void* stream) {
  if (D < 1 || D > 128 || B * H == 0 || Sq == 0 || Sk == 0) return false;
  if (dtype != 0 && dtype != 1) return false;
  *a = Args{q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D,
            Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
            Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
            Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
            Strides{st[18], st[19], st[20]}, sm_scale, causal, vec,
            static_cast<cudaStream_t>(stream)};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 21 element strides,
// (batch, head, seq) of q, k, v, do, dq, dk, dv in that order; every head
// dim must be contiguous. lse and delta are contiguous fp32 [B, H, Sq].
// vec = 1 when D % 8 == 0 and the rows the kernel stages in shared memory
// (k and v for dq; q and do for dkv) are 16-byte aligned. 1 <= D <= 128.
// ds_flash_bwd_dq writes dq (dk, dv unused); ds_flash_bwd_dkv writes dk
// and dv (dq unused).
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, void* dk,
                               void* dv, int dtype, int B, int H, int Sq,
                               int Sk, int D, const long long* strides,
                               float sm_scale, int causal, int vec,
                               void* stream) {
  Args a;
  if (!make_args(&a, q, k, v, dout, lse, delta, dq, dk, dv, dtype, B, H, Sq,
                 Sk, D, strides, sm_scale, causal, vec, stream))
    return cudaErrorInvalidValue;
  return by_head_dim(a, dtype, dq_launch<16>, dq_launch<32>, dq_launch<64>,
                     dq_launch<128>);
}

extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, void* dk,
                                void* dv, int dtype, int B, int H, int Sq,
                                int Sk, int D, const long long* strides,
                                float sm_scale, int causal, int vec,
                                void* stream) {
  Args a;
  if (!make_args(&a, q, k, v, dout, lse, delta, dq, dk, dv, dtype, B, H, Sq,
                 Sk, D, strides, sm_scale, causal, vec, stream))
    return cudaErrorInvalidValue;
  return by_head_dim(a, dtype, dkv_launch<16>, dkv_launch<32>,
                     dkv_launch<64>, dkv_launch<128>);
}
