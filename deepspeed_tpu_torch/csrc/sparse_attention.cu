// Block-sparse flash attention for Hopper (sm_90a): forward, dq and dk/dv
// over lists of live 64 x 64 tiles.
//
// Replaces the Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/fused_kernels.py, `_fwd_kernel`
// (:192), `_dq_kernel` (:239) and `_dkv_kernel` (:279), which walk a
// flattened work list of live (q-tile, kv-tile) pairs, and of
// deepspeed_tpu/ops/sparse_attention/kernels.py, `_fwd_kernel` (:35),
// `_dq_kernel` (:88) and `_dkv_kernel` (:129), which sweep every block and
// predicate it on the layout. On this card one kernel family covers both:
// the host turns either layout into lists of live tile pairs.
//
// What they compute, per (batch*head), over the pairs of a layout:
//   s = q k^T * sm_scale, -1e30 where the pair's fine-block bit is 0, the
//       key lies past the sequence, or (on tiles of the real region, when
//       causal) the key lies after the query; then + bias[key];
//   forward: online softmax with the clamp p = 0 while a row's running max
//       is still -1e30 (a row whose live keys so far are all masked), out =
//       acc / l (l = 0 -> out = 0), lse = m + log(l) (-1e30 for a row with
//       no live key), exactly fused_kernels.py:214-236;
//   dq: p = exp(s - lse) (0 where lse is -1e30), ds = p (do v^T - delta)
//       sm_scale, dq = ds k;
//   dk/dv: dv = p^T do, dk = ds^T q and, with a bias, the bias cotangent
//       dbias[key] = sum_rows p (dp - delta) before sm_scale
//       (fused_kernels.py:320-326). A CTA owns its key tile, so no atomics.
//
// Design against the TPU's: the TPU carries its accumulators in VMEM from
// one grid step to the next along a sequential work list with BEGIN/LIVE/
// END flags. Hopper blocks run in no order and share nothing, so each CTA
// owns one (batch*head, output tile) and loops over its own segment of a
// CSR list built once per layout on the host: `ptr` [H * n_out + 1]
// offsets, `idx` the streamed tile of each pair, `bits` a 64-bit word of
// fine-block liveness inside the pair (fine blocks of 8, 16 or 32 keys; a
// fine block of 64 or more is one bit). The forward and dq walk the
// row-major list (output = query tile), dk/dv the column-major one (output
// = key tile). An output tile with no pair writes zeros (lse -1e30), as the
// JAX dummy items and `l_safe` do. Tiles are 64 query rows by 64 keys:
// four warps of mma.sync m16n8k16 (bf16, fp32 accumulation) own 16 rows
// each, as in flash_fwd.cu and flash_bwd.cu; fp32 runs on the FMA pipes
// (no TF32), four threads a row.
//
// Bound on the H100: at the BERT-large path (B 4, H 16, S 2048, D 64, Fixed
// block 64 with 8 packed global columns, Skv 2560, 352 live 64 x 64 tiles
// a head) the forward moves q, o and the packed k, v (~76 MB) in ~23 us
// at 3.35 TB/s and does 4 * 64 flops on each of 92 M live (query, key)
// pairs, ~24 us at 989 TFLOP/s: operations bound it, by a little, and dq
// and dk/dv (1.5x and 2x the forward's flops) by more. This first form
// stages each streamed tile with synchronous loads and runs mma.sync
// without pipelining (no cp.async, TMA or wgmma), so it runs well above
// that bound.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kT = 64;             // tile: query rows and keys
constexpr int kTPR = 4;            // fp32: threads a row
constexpr int kThreads32 = kT * kTPR;
constexpr int kChunk = 16;         // fp32 forward: keys an online update

struct Args {
  const void *q, *k, *v;
  void* o;
  const void* dout;
  float* lse;
  const float* delta;
  void *dq, *dk, *dv;
  const float* bias;   // [B, Skv] additive key bias, or null
  float* dbias;        // [B*H, Skv] bias cotangent (dk/dv), or null
  const int* ptr;      // [H * n_out + 1] segment offsets
  const int* idx;      // streamed tile of each pair
  const unsigned long long* bits;  // fine-block bits of each pair
  int B, H, Sq, Skv, D;
  int n_out;           // output tiles a (batch, head)
  int causal, causal_ntiles;
  int lf, nshift;      // log2(fine block), log2(fine blocks a tile edge)
  int vec;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float sm_scale;
  cudaStream_t stream;
};

// Liveness of (tile-local query row, tile-local key) in one pair
struct PairMask {
  unsigned long long bits;
  bool full, tri;
  int lf, nshift, q0, k0, Skv;

  __device__ __forceinline__ bool operator()(int rl, int cl) const {
    const int key = k0 + cl;
    if (key >= Skv) return false;
    if (tri && key > q0 + rl) return false;
    if (full) return true;
    return (bits >> (((rl >> lf) << nshift) + (cl >> lf))) & 1ull;
  }
};

__device__ __forceinline__ PairMask pair_mask(const Args& a, int e, int qt,
                                              int kt) {
  PairMask m;
  m.bits = a.bits[e];
  const int nb = 1 << (2 * a.nshift);  // fine blocks in a tile
  m.full = nb == 64 ? m.bits == ~0ull : m.bits == (1ull << nb) - 1ull;
  m.tri = a.causal && kt < a.causal_ntiles;
  m.lf = a.lf;
  m.nshift = a.nshift;
  m.q0 = qt * kT;
  m.k0 = kt * kT;
  m.Skv = a.Skv;
  return m;
}

template <typename T>
__device__ __forceinline__ const T* head(const void* p, const Strides& s,
                                         int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* head_out(void* p, const Strides& s, int b,
                                       int h) {
  return static_cast<T*>(p) + b * s.b + h * s.h;
}

// ------------------------------------------------------------ bf16: mma
// Forward: one CTA per (query tile, batch*head).
template <int DP>
__global__ void __launch_bounds__(128) sparse_fwd_bf16(Args a) {
  constexpr int KP = DP + 8;   // padded K row
  constexpr int VP = kT + 8;   // padded V^T row
  constexpr int NQ = DP / 16;  // k-steps of the score product
  constexpr int NS = kT / 8;   // score n-tiles a warp
  constexpr int NO = DP / 8;   // output n-tiles a warp
  __shared__ __align__(16) bf16 k_tile[kT * KP];
  __shared__ __align__(16) bf16 vt_tile[DP * VP];

  const int it = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl0 = warp * 16 + g, rl1 = rl0 + 8;  // this thread's rows
  const int r0 = it * kT + rl0, r1 = r0 + 8;
  const int D = a.D, Skv = a.Skv;
  const float scale = a.sm_scale;
  const bf16* kb = head<bf16>(a.k, a.ks, b, h);
  const bf16* vb = head<bf16>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  uint32_t qa[NQ][4];
  load_a_frags<NQ>(qa, head<bf16>(a.q, a.qs, b, h), a.qs.s, r0, a.Sq, D, t);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  const int seg = h * a.n_out + it;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int kt = a.idx[e];
    const PairMask pm = pair_mask(a, e, it, kt);
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kT * (DP / 8); i += 128) {
      const int j = i / (DP / 8), c8 = (i % (DP / 8)) * 8;
      const int key = k0 + j;
      const int n = key < Skv ? D - c8 : 0;
      *reinterpret_cast<uint4*>(&k_tile[j * KP + c8]) =
          load8_bf16(kb + key * a.ks.s + c8, n, a.vec);
      const uint4 vr = load8_bf16(vb + key * a.vs.s + c8, n, a.vec);
      const bf16* ve = reinterpret_cast<const bf16*>(&vr);
#pragma unroll
      for (int c = 0; c < 8; ++c) vt_tile[(c8 + c) * VP + j] = ve[c];
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t bfrag[2];
        load_b_frag(bfrag, k_tile, KP, nt * 8, kk * 16, g, t);
        mma_bf16(s[nt], qa[kk], bfrag);
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cl = nt * 8 + t * 2 + (c & 1);
        float x = pm((c < 2) ? rl0 : rl1, cl) ? s[nt][c] * scale : kNegInf;
        if (brow != nullptr && k0 + cl < Skv) x += brow[k0 + cl];
        s[nt][c] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
    // a row whose keys so far are all masked keeps its max at -1e30: its
    // weights are 0, not exp(0)
    const bool dead0 = mx0 <= kNegInf * 0.5f, dead1 = mx1 <= kNegInf * 0.5f;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha0; acc[n][1] *= alpha0;
      acc[n][2] *= alpha1; acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = dead0 ? 0.f : __expf(s[nt][0] - mx0);
      s[nt][1] = dead0 ? 0.f : __expf(s[nt][1] - mx0);
      s[nt][2] = dead1 ? 0.f : __expf(s[nt][2] - mx1);
      s[nt][3] = dead1 ? 0.f : __expf(s[nt][3] - mx1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bfrag[2];
        load_b_frag(bfrag, vt_tile, VP, n * 8, kk * 16, g, t);
        mma_bf16(acc[n], pa, bfrag);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0, ls1 = (l1 == 0.f) ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  bf16* ob = head_out<bf16>(a.o, a.os, b, h);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = (c < 2) ? r0 : r1;
      const int col = n * 8 + t * 2 + (c & 1);
      if (row < a.Sq && col < D)
        ob[row * a.os.s + col] =
            __float2bfloat16(acc[n][c] * ((c < 2) ? inv0 : inv1));
    }
  }
  if (t == 0) {
    if (r0 < a.Sq) a.lse[(long long)bh * a.Sq + r0] = m0 + logf(ls0);
    if (r1 < a.Sq) a.lse[(long long)bh * a.Sq + r1] = m1 + logf(ls1);
  }
}

// dq: one CTA per (query tile, batch*head), over the row-major list.
template <int DP>
__global__ void __launch_bounds__(128) sparse_dq_bf16(Args a) {
  constexpr int KP = DP + 8;   // padded K / V row
  constexpr int TP = kT + 8;   // padded K^T row
  constexpr int NQ = DP / 16;
  constexpr int NS = kT / 8;
  constexpr int NO = DP / 8;
  __shared__ __align__(16) bf16 k_tile[kT * KP];
  __shared__ __align__(16) bf16 v_tile[kT * KP];
  __shared__ __align__(16) bf16 kt_tile[DP * TP];

  const int it = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl0 = warp * 16 + g, rl1 = rl0 + 8;
  const int r0 = it * kT + rl0, r1 = r0 + 8;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const bf16* kb = head<bf16>(a.k, a.ks, b, h);
  const bf16* vb = head<bf16>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  uint32_t qa[NQ][4], da[NQ][4];
  load_a_frags<NQ>(qa, head<bf16>(a.q, a.qs, b, h), a.qs.s, r0, Sq, D, t);
  load_a_frags<NQ>(da, head<bf16>(a.dout, a.dos, b, h), a.dos.s, r0, Sq, D,
                   t);
  // rows past Sq: lse = -1e30 makes p = 0
  const float lse0 = r0 < Sq ? a.lse[(long long)bh * Sq + r0] : kNegInf;
  const float lse1 = r1 < Sq ? a.lse[(long long)bh * Sq + r1] : kNegInf;
  const float dl0 = r0 < Sq ? a.delta[(long long)bh * Sq + r0] : 0.f;
  const float dl1 = r1 < Sq ? a.delta[(long long)bh * Sq + r1] : 0.f;
  const bool dead0 = lse0 <= kNegInf * 0.5f, dead1 = lse1 <= kNegInf * 0.5f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int seg = h * a.n_out + it;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int kt = a.idx[e];
    const PairMask pm = pair_mask(a, e, it, kt);
    const int k0 = kt * kT;
    __syncthreads();
    stage_bf16<DP, kT>(k_tile, kt_tile, kb + (long long)k0 * a.ks.s, a.ks.s,
                       0, Skv - k0, D, a.vec);
    stage_bf16<DP, kT>(v_tile, nullptr, vb + (long long)k0 * a.vs.s, a.vs.s,
                       0, Skv - k0, D, a.vec);
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
      for (int c = 0; c < 4; ++c) {
        const int cl = nt * 8 + t * 2 + (c & 1);
        const bool lo = c < 2;
        float x = pm(lo ? rl0 : rl1, cl) ? s[nt][c] * scale : kNegInf;
        if (brow != nullptr && k0 + cl < Skv) x += brow[k0 + cl];
        const float p = (lo ? dead0 : dead1) ? 0.f
                                             : __expf(x - (lo ? lse0 : lse1));
        s[nt][c] = p * (dp[nt][c] - (lo ? dl0 : dl1)) * scale;
      }
    }
    // dq += ds k (ds rounded to bf16 in the A fragments)
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
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

  bf16* out = head_out<bf16>(a.dq, a.dqs, b, h);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = (c < 2) ? r0 : r1;
      const int col = n * 8 + t * 2 + (c & 1);
      if (row < Sq && col < D) out[row * a.dqs.s + col] = __float2bfloat16(acc[n][c]);
    }
  }
}

// dk, dv (and dbias): one CTA per (key tile, batch*head), over the
// column-major list. The score products are computed transposed (k q^T,
// v do^T), so p^T and ds^T come out of the accumulators already in the A
// orientation of dv += p^T do and dk += ds^T q (as in flash_bwd.cu).
template <int DP>
__global__ void __launch_bounds__(128) sparse_dkv_bf16(Args a) {
  constexpr int KP = DP + 8;   // padded Q / dO row
  constexpr int TP = kT + 8;   // padded Q^T / dO^T row
  constexpr int NQ = DP / 16;
  constexpr int NS = kT / 8;   // score n-tiles (queries)
  constexpr int NO = DP / 8;
  __shared__ __align__(16) bf16 q_tile[kT * KP];
  __shared__ __align__(16) bf16 d_tile[kT * KP];
  __shared__ __align__(16) bf16 qt_tile[DP * TP];
  __shared__ __align__(16) bf16 dt_tile[DP * TP];
  __shared__ float lse_s[kT], delta_s[kT];

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kl0 = warp * 16 + g, kl1 = kl0 + 8;  // this thread's keys
  const int k0 = kt * kT;
  const int r0 = k0 + kl0, r1 = r0 + 8;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const bf16* qb = head<bf16>(a.q, a.qs, b, h);
  const bf16* db = head<bf16>(a.dout, a.dos, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;
  const float bias0 = (brow != nullptr && r0 < Skv) ? brow[r0] : 0.f;
  const float bias1 = (brow != nullptr && r1 < Skv) ? brow[r1] : 0.f;

  uint32_t ka[NQ][4], va[NQ][4];
  load_a_frags<NQ>(ka, head<bf16>(a.k, a.ks, b, h), a.ks.s, r0, Skv, D, t);
  load_a_frags<NQ>(va, head<bf16>(a.v, a.vs, b, h), a.vs.s, r0, Skv, D, t);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  float db0 = 0.f, db1 = 0.f;  // this thread's part of the bias cotangent

  const int seg = h * a.n_out + kt;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int qt = a.idx[e];
    const PairMask pm = pair_mask(a, e, qt, kt);
    const int q0 = qt * kT;
    __syncthreads();
    stage_bf16<DP, kT>(q_tile, qt_tile, qb + (long long)q0 * a.qs.s, a.qs.s,
                       0, Sq - q0, D, a.vec);
    stage_bf16<DP, kT>(d_tile, dt_tile, db + (long long)q0 * a.dos.s,
                       a.dos.s, 0, Sq - q0, D, a.vec);
    for (int i = threadIdx.x; i < kT; i += blockDim.x) {
      const int qi = q0 + i;
      lse_s[i] = qi < Sq ? a.lse[(long long)bh * Sq + qi] : kNegInf;
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
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + t * 2 + (c & 1);  // tile-local query
        const bool lo = c < 2;
        float x = pm(col, lo ? kl0 : kl1) ? st[nt][c] * scale : kNegInf;
        if (brow != nullptr) x += lo ? bias0 : bias1;
        const float L = lse_s[col];
        const float p = L <= kNegInf * 0.5f ? 0.f : __expf(x - L);
        const float dsig = p * (dpt[nt][c] - delta_s[col]);
        if (lo) db0 += dsig; else db1 += dsig;
        st[nt][c] = p;
        dpt[nt][c] = dsig * scale;
      }
    }
    // dv += p^T do, dk += ds^T q (p, ds rounded to bf16 in the A fragments)
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
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

  db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
  db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
  db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
  db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
  if (a.dbias != nullptr && t == 0) {
    if (r0 < Skv) a.dbias[(long long)bh * Skv + r0] = db0;
    if (r1 < Skv) a.dbias[(long long)bh * Skv + r1] = db1;
  }
  bf16* dko = head_out<bf16>(a.dk, a.dks, b, h);
  bf16* dvo = head_out<bf16>(a.dv, a.dvs, b, h);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = (c < 2) ? r0 : r1;
      const int col = n * 8 + t * 2 + (c & 1);
      if (key < Skv && col < D) {
        dko[key * a.dks.s + col] = __float2bfloat16(dk[n][c]);
        dvo[key * a.dvs.s + col] = __float2bfloat16(dv[n][c]);
      }
    }
  }
}

// ------------------------------------------------------------ fp32: FMA
template <int DP>
__global__ void __launch_bounds__(kThreads32) sparse_fwd_f32(Args a) {
  constexpr int NV = DP / 16;  // float4 groups a thread
  __shared__ float4 k_tile[kT][DP / 4];
  __shared__ float4 v_tile[kT][DP / 4];

  const int it = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int r = it * kT + row;
  const int Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const float* kb = head<float>(a.k, a.ks, b, h);
  const float* vb = head<float>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  float4 qr[NV], acc[NV];
  load_row_f32<NV>(qr, head<float>(a.q, a.qs, b, h), a.qs.s, r, a.Sq, D, t);
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  const int seg = h * a.n_out + it;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int kt = a.idx[e];
    const PairMask pm = pair_mask(a, e, it, kt);
    const int k0 = kt * kT;
    __syncthreads();
    stage_f32<DP>(&k_tile[0][0], kb + (long long)k0 * a.ks.s, a.ks.s,
                  Skv - k0, kT, D);
    stage_f32<DP>(&v_tile[0][0], vb + (long long)k0 * a.vs.s, a.vs.s,
                  Skv - k0, kT, D);
    __syncthreads();
    for (int c0 = 0; c0 < kT; c0 += kChunk) {
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        const float dot = dot4<NV>(qr, k_tile[j], t);
        float x = pm(row, j) ? dot * scale : kNegInf;
        if (brow != nullptr && k0 + j < Skv) x += brow[k0 + j];
        s[jj] = x;
        m_new = fmaxf(m_new, x);
      }
      const float alpha = expf(m - m_new);
      const bool dead = m_new <= kNegInf * 0.5f;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha;
        acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = dead ? 0.f : expf(s[jj] - m_new);
        l += p;
        axpy4<NV>(acc, p, v_tile[c0 + jj], t);
      }
      m = m_new;
    }
  }

  if (r >= a.Sq) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  const float inv = 1.f / l_safe;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i].x *= inv; acc[i].y *= inv; acc[i].z *= inv; acc[i].w *= inv;
  }
  store_row_f32<NV>(head_out<float>(a.o, a.os, b, h), a.os.s, r, D, t, acc);
  if (t == 0) a.lse[(long long)bh * a.Sq + r] = m + logf(l_safe);
}

template <int DP>
__global__ void __launch_bounds__(kThreads32) sparse_dq_f32(Args a) {
  constexpr int NV = DP / 16;
  __shared__ float4 k_tile[kT][DP / 4];
  __shared__ float4 v_tile[kT][DP / 4];

  const int it = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int r = it * kT + row;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const float* kb = head<float>(a.k, a.ks, b, h);
  const float* vb = head<float>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  float4 qr[NV], dr[NV], acc[NV];
  load_row_f32<NV>(qr, head<float>(a.q, a.qs, b, h), a.qs.s, r, Sq, D, t);
  load_row_f32<NV>(dr, head<float>(a.dout, a.dos, b, h), a.dos.s, r, Sq, D,
                   t);
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = r < Sq ? a.lse[(long long)bh * Sq + r] : kNegInf;
  const float delta = r < Sq ? a.delta[(long long)bh * Sq + r] : 0.f;
  const bool dead = lse <= kNegInf * 0.5f;

  const int seg = h * a.n_out + it;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int kt = a.idx[e];
    const PairMask pm = pair_mask(a, e, it, kt);
    const int k0 = kt * kT;
    __syncthreads();
    stage_f32<DP>(&k_tile[0][0], kb + (long long)k0 * a.ks.s, a.ks.s,
                  Skv - k0, kT, D);
    stage_f32<DP>(&v_tile[0][0], vb + (long long)k0 * a.vs.s, a.vs.s,
                  Skv - k0, kT, D);
    __syncthreads();
    for (int j = 0; j < kT; ++j) {
      const float s = dot4<NV>(qr, k_tile[j], t);
      const float dp = dot4<NV>(dr, v_tile[j], t);
      float x = pm(row, j) ? s * scale : kNegInf;
      if (brow != nullptr && k0 + j < Skv) x += brow[k0 + j];
      const float p = dead ? 0.f : expf(x - lse);
      axpy4<NV>(acc, p * (dp - delta) * scale, k_tile[j], t);
    }
  }
  if (r < Sq)
    store_row_f32<NV>(head_out<float>(a.dq, a.dqs, b, h), a.dqs.s, r, D, t,
                      acc);
}

template <int DP>
__global__ void __launch_bounds__(kThreads32) sparse_dkv_f32(Args a) {
  constexpr int NV = DP / 16;
  __shared__ float4 q_tile[kT][DP / 4];
  __shared__ float4 d_tile[kT][DP / 4];
  __shared__ float lse_s[kT], delta_s[kT];

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int key = kt * kT + row;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const float* qb = head<float>(a.q, a.qs, b, h);
  const float* db = head<float>(a.dout, a.dos, b, h);
  const float bias = (a.bias != nullptr && key < Skv)
                         ? a.bias[(long long)b * Skv + key] : 0.f;

  float4 kr[NV], vr[NV], dk[NV], dv[NV];
  load_row_f32<NV>(kr, head<float>(a.k, a.ks, b, h), a.ks.s, key, Skv, D, t);
  load_row_f32<NV>(vr, head<float>(a.v, a.vs, b, h), a.vs.s, key, Skv, D, t);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    dk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float dbias = 0.f;

  const int seg = h * a.n_out + kt;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int qt = a.idx[e];
    const PairMask pm = pair_mask(a, e, qt, kt);
    const int q0 = qt * kT;
    __syncthreads();
    stage_f32<DP>(&q_tile[0][0], qb + (long long)q0 * a.qs.s, a.qs.s, Sq - q0,
                  kT, D);
    stage_f32<DP>(&d_tile[0][0], db + (long long)q0 * a.dos.s, a.dos.s,
                  Sq - q0, kT, D);
    for (int i = threadIdx.x; i < kT; i += blockDim.x) {
      const int qi = q0 + i;
      lse_s[i] = qi < Sq ? a.lse[(long long)bh * Sq + qi] : kNegInf;
      delta_s[i] = qi < Sq ? a.delta[(long long)bh * Sq + qi] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kT; ++i) {
      const float s = dot4<NV>(kr, q_tile[i], t);
      const float dp = dot4<NV>(vr, d_tile[i], t);
      float x = pm(i, row) ? s * scale : kNegInf;
      x += bias;
      const float L = lse_s[i];
      const float p = L <= kNegInf * 0.5f ? 0.f : expf(x - L);
      const float dsig = p * (dp - delta_s[i]);
      dbias += dsig;
      axpy4<NV>(dv, p, d_tile[i], t);
      axpy4<NV>(dk, dsig * scale, q_tile[i], t);
    }
  }
  if (key < Skv) {
    store_row_f32<NV>(head_out<float>(a.dk, a.dks, b, h), a.dks.s, key, D, t,
                      dk);
    store_row_f32<NV>(head_out<float>(a.dv, a.dvs, b, h), a.dvs.s, key, D, t,
                      dv);
    if (a.dbias != nullptr && t == 0)
      a.dbias[(long long)bh * Skv + key] = dbias;
  }
}

// ------------------------------------------------------------ launch
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int DP>
cudaError_t launch(const Args& a, int dtype, int which) {
  const dim3 grid(a.n_out, a.B * a.H);
  const bool bf = dtype == 1;
  const int threads = bf ? 128 : kThreads32;
  if (which == kFwd) {
    if (bf) sparse_fwd_bf16<DP><<<grid, threads, 0, a.stream>>>(a);
    else sparse_fwd_f32<DP><<<grid, threads, 0, a.stream>>>(a);
  } else if (which == kDq) {
    if (bf) sparse_dq_bf16<DP><<<grid, threads, 0, a.stream>>>(a);
    else sparse_dq_f32<DP><<<grid, threads, 0, a.stream>>>(a);
  } else {
    if (bf) sparse_dkv_bf16<DP><<<grid, threads, 0, a.stream>>>(a);
    else sparse_dkv_f32<DP><<<grid, threads, 0, a.stream>>>(a);
  }
  return cudaGetLastError();
}

int run(int which, void* const* p, const long long* st, const int* d,
        float sm_scale, void* stream) {
  // d: dtype, B, H, Sq, Skv, D, n_out, causal, causal_ntiles, fine, vec
  const int dtype = d[0], D = d[5], fine = d[9];
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (D < 1 || D > 64 || d[1] * d[2] == 0 || d[3] == 0 || d[4] == 0 ||
      d[6] == 0 || d[1] * d[2] > 65535)
    return cudaErrorInvalidValue;
  if (fine < 8 || fine > kT || (fine & (fine - 1)) != 0)
    return cudaErrorInvalidValue;
  int lf = 0;
  while ((1 << lf) < fine) ++lf;
  Args a;
  a.q = p[0]; a.k = p[1]; a.v = p[2]; a.o = p[3]; a.dout = p[4];
  a.lse = static_cast<float*>(p[5]);
  a.delta = static_cast<const float*>(p[6]);
  a.dq = p[7]; a.dk = p[8]; a.dv = p[9];
  a.bias = static_cast<const float*>(p[10]);
  a.dbias = static_cast<float*>(p[11]);
  a.ptr = static_cast<const int*>(p[12]);
  a.idx = static_cast<const int*>(p[13]);
  a.bits = static_cast<const unsigned long long*>(p[14]);
  a.B = d[1]; a.H = d[2]; a.Sq = d[3]; a.Skv = d[4]; a.D = D;
  a.n_out = d[6]; a.causal = d[7]; a.causal_ntiles = d[8];
  a.lf = lf; a.nshift = 6 - lf; a.vec = d[10];
  Strides* s[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(a, dtype, which);
  if (D <= 32) return launch<32>(a, dtype, which);
  return launch<64>(a, dtype, which);
}

}  // namespace

// `ptrs`: q, k, v, o, dout, lse, delta, dq, dk, dv, bias, dbias, ptr, idx,
// bits (null where a kernel does not use one; bias and dbias may be null).
// `strides`: (batch, head, seq) element strides of q, k, v, o, dout, dq,
// dk, dv (24 values); every head dim is contiguous. lse and delta are
// contiguous fp32 [B, H, Sq]; bias is a contiguous fp32 [B, Skv]; dbias a
// contiguous fp32 [B*H, Skv]. `dims`: dtype (0 float32, 1 bfloat16), B, H,
// Sq, Skv, D (1..64), n_out (output tiles a head), causal, causal_ntiles
// (key tiles of the real region), fine block (8..64, a power of two), vec
// (1 when D % 8 == 0 and the rows a kernel stages are 16-byte aligned).
extern "C" int ds_sparse_fwd(void* const* ptrs, const long long* strides,
                             const int* dims, float sm_scale, void* stream) {
  return run(kFwd, ptrs, strides, dims, sm_scale, stream);
}

extern "C" int ds_sparse_dq(void* const* ptrs, const long long* strides,
                            const int* dims, float sm_scale, void* stream) {
  return run(kDq, ptrs, strides, dims, sm_scale, stream);
}

extern "C" int ds_sparse_dkv(void* const* ptrs, const long long* strides,
                             const int* dims, float sm_scale, void* stream) {
  return run(kDkv, ptrs, strides, dims, sm_scale, stream);
}
