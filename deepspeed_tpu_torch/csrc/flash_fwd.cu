// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/transformer/flash.py
// `_fwd_kernel_resident` (:211) and its streaming form `_fwd_kernel` (:67):
// softmax(q k^T * sm_scale) v with an online softmax, so the [Sq, Sk] score
// matrix never reaches device memory, plus the fp32 log-sum-exp per row.
//
// Both forms here give one CTA to each (batch*head, 64-row query tile) and
// stream K/V through shared memory one tile at a time: a loop inside the
// CTA takes the place of the TPU's sequential kv grid axis, so one kernel
// covers both TPU forms (resident and streaming). Causal attention stops
// the kv loop at the tile's last visible key (offset = Sk - Sq, the
// decode-suffix convention); a ragged tail (S not a multiple of the tile)
// is masked, never padded. Masked scores are -1e30 as in the JAX kernels.
//
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
//   fp32 accumulation. Four warps own 16 query rows each; Q stays in
//   registers as A fragments, K is staged row-major and V transposed in
//   shared memory with rows padded by 8 elements, so every fragment load
//   is one conflict-free 32-bit read. The score accumulators become the
//   P operand of the P.V product in registers (P rounded to bf16, as the
//   TPU kernel does), and m and l stay per row in registers.
// * fp32: the same tiling on the fp32 FMA pipes (no TF32, so results keep
//   fp32 accuracy). Four neighbouring threads own a query row and split
//   the head dim as float4 groups interleaved by 16, so a warp's shared-
//   memory reads of a key row are 64 contiguous bytes broadcast to its 8
//   rows; scores are reduced over the 4 threads with two xor-shuffles.
//
// Bound on the H100: at GPT-2 prefill (B 8, H 16, S 896, D 64, causal)
// the q/k/v/o bytes take 17.7 us at 3.35 TB/s and the bf16 work 13.3 us at
// 989 TFLOP/s, so the least time is set by bytes. This form issues
// synchronous loads and mma.sync without pipelining (no TMA, no wgmma),
// so it runs well above that; pipelining is the next step.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per shared-memory tile

// ------------------------------------------------------------ bf16: mma
// DP: head dim padded to a multiple of 16 (zeros beyond D).
template <int DP>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk, int D,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      float sm_scale, int causal, int vec) {
  constexpr int KP = DP + 8;   // padded K row (bf16 elements)
  constexpr int VP = kBK + 8;  // padded V^T row
  constexpr int NQ = DP / 16;  // k-steps of the score product
  constexpr int NS = kBK / 8;  // score n-tiles per warp
  constexpr int NO = DP / 8;   // output n-tiles per warp
  __shared__ __align__(16) bf16 k_tile[kBK * KP];
  __shared__ __align__(16) bf16 vt_tile[DP * VP];

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = q_tile * kBQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int offset = Sk - Sq;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  uint32_t qa[NQ][4];
  load_a_frags<NQ>(qa, qb, qs.s, r0, Sq, D, t);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q0 + kBQ + offset);

  for (int kt = 0; kt < kv_end; kt += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBK * (DP / 8); idx += 128) {
      const int j = idx / (DP / 8), c8 = (idx % (DP / 8)) * 8;
      const int key = kt + j;
      const int n = key < Sk ? D - c8 : 0;
      const uint4 kr = load8_bf16(kb + key * ks.s + c8, n, vec);
      *reinterpret_cast<uint4*>(&k_tile[j * KP + c8]) = kr;
      const uint4 vr = load8_bf16(vb + key * vs.s + c8, n, vec);
      const bf16* ve = reinterpret_cast<const bf16*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_tile[(c8 + e) * VP + j] = ve[e];
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
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + t * 2 + (e & 1);
        const int row = (e < 2) ? r0 : r1;
        float x = s[nt][e] * sm_scale;
        if (key >= Sk)
          x = -INFINITY;  // the ragged tail holds no key at all
        else if (causal && key > row + offset)
          x = kNegInf;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha0; acc[n][1] *= alpha0;
      acc[n][2] *= alpha1; acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx0);
      s[nt][1] = __expf(s[nt][1] - mx0);
      s[nt][2] = __expf(s[nt][2] - mx1);
      s[nt][3] = __expf(s[nt][3] - mx1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    m0 = mx0;
    m1 = mx1;

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
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
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e < 2) ? r0 : r1;
      const int c = n * 8 + t * 2 + (e & 1);
      if (row < Sq && c < D)
        o[b * os.b + h * os.h + row * os.s + c] =
            __float2bfloat16(acc[n][e] * ((e < 2) ? inv0 : inv1));
    }
  }
  if (t == 0) {
    if (r0 < Sq) lse[(long long)bh * Sq + r0] = m0 + logf(ls0);
    if (r1 < Sq) lse[(long long)bh * Sq + r1] = m1 + logf(ls1);
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
  const float l_safe = (l == 0.f) ? 1.f : l;
  const float inv = 1.f / l_safe;
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

template <int DP>
cudaError_t launch_bf16(const Args& a) {
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_bf16_kernel<DP><<<grid, 128, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.H,
      a.Sq, a.Sk, a.D, a.qs, a.ks, a.vs, a.os, a.sm_scale, a.causal, a.vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const Args& a) {
  constexpr int BK = DP <= 64 ? 64 : 32;  // K+V tiles stay within 32 KB
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_f32_kernel<DP, BK><<<grid, kThreads32, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H,
      a.Sq, a.Sk, a.D, a.qs, a.ks, a.vs, a.os, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <cudaError_t (*L16)(const Args&), cudaError_t (*L32)(const Args&),
          cudaError_t (*L64)(const Args&), cudaError_t (*L128)(const Args&)>
cudaError_t by_head_dim(const Args& a) {
  if (a.D <= 16) return L16(a);
  if (a.D <= 32) return L32(a);
  if (a.D <= 64) return L64(a);
  return L128(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, per tensor
// (batch, head, seq); the head dim must be contiguous. lse is a contiguous
// fp32 [B, H, Sq]. vec = 1 when D % 8 == 0 and the k/v rows are 16-byte
// aligned (bf16 vector loads). Requires 1 <= D <= 128.
extern "C" int ds_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float sm_scale, int causal, int vec, void* stream) {
  if (D < 1 || D > 128 || B * H == 0 || Sq == 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, B, H, Sq, Sk, D,
               Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
               Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
               sm_scale, causal, vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return by_head_dim<launch_f32<16>, launch_f32<32>, launch_f32<64>,
                       launch_f32<128>>(a);
  if (dtype == 1)
    return by_head_dim<launch_bf16<16>, launch_bf16<32>, launch_bf16<64>,
                       launch_bf16<128>>(a);
  return cudaErrorInvalidValue;
}
