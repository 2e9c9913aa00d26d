// Decode attention over a KV cache for Hopper (sm_90a): one query token per
// (batch, head) against the live prefix of a [B, H, T, D] cache.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/transformer/decode.py
// `_decode_kernel` (:54), both its fp form and its int8-KV form
// (QUANTIZED): K/V int8 with one fp32 scale per cached row; the k-scale is
// folded into the score, the v-scale into p before the P.V sum.
//
// Design. One CTA per (batch, head). The single query row stays a single
// row (the TPU kernel replicated it to 8 sublanes): each cached key row is
// read by G = DP/8 neighbouring threads holding 8 head-dim elements each
// (one 16-byte load of bf16), so a warp reads 32/G key rows per load, and
// the CTA's 256 threads form 256/G key groups that walk the live length
// with stride 256/G, four keys per group in flight before any arithmetic.
// Each group keeps its own online-softmax state (m, l, acc[8]); a final
// shared-memory pass merges the groups. The loop ends at the sequence's
// live length (cache_len, a device scalar or a per-sequence [B] vector),
// so the work follows the live cache, not the allocation; the tail is a
// mask, never a pad copy. l == 0 (no live key) writes zeros, as the TPU
// kernel's guard does.
//
// Bound on the H100: bytes. One step streams len * D * 2 elements of K/V
// and does 4 flops per element: far below the card's ops/byte balance.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // keys per group loaded before they are used

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements starting at p, as floats. `vec` (uniform): the
// row is 8-element aligned and full, so one vector load serves.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, bool vec,
                                      float out[8]);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     int n, bool vec,
                                                     float out[8]) {
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, int n, bool vec,
                                             float out[8]) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < n ? p[i] : 0.f;
  }
}

template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p, int n,
                                              bool vec, float out[8]) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

// T: query/output type; KT: cache type (T, or int8_t when QUANTIZED).
// DP: head dim rounded up to a power of two >= 16.
template <typename T, typename KT, int DP, bool QUANTIZED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lens, int per_seq, T* __restrict__ o,
              int H, int T_alloc, int D, long long q_sb, long long q_sh,
              long long o_sb, long long o_sh, float sm_scale, int vec) {
  constexpr int G = DP / 8;            // threads per key row
  constexpr int KG = kThreads / G;     // key groups per CTA
  __shared__ float sm_m[KG], sm_l[KG];
  __shared__ float sm_acc[KG][DP];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = threadIdx.x / G;       // key group
  const int d0 = (threadIdx.x % G) * 8;
  const int n = D - d0;                // live elements of this thread's 8
  const bool vec_ok = vec && n >= 8;

  int len = lens[per_seq ? b : 0];
  len = max(0, min(len, T_alloc));

  float qv[8];
  {
    const T* qp = q + b * q_sb + h * q_sh + d0;
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = i < n ? to_f(qp[i]) : 0.f;
  }
  const long long row0 = (long long)bh * T_alloc;
  const KT* kb = k + row0 * D + d0;
  const KT* vb = v + row0 * D + d0;

  float m = kNegInf, l = 0.f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < len; c0 += kUnroll * KG) {
    float kf[kUnroll][8], vf[kUnroll][8];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * KG + g;
      live[u] = c < len;
      if (live[u] && n > 0) {
        load8(kb + (long long)c * D, n, vec_ok, kf[u]);
        load8(vb + (long long)c * D, n, vec_ok, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) part += qv[i] * kf[u][i];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      float sc = part * sm_scale;
      if (QUANTIZED && live[u]) sc *= k_scale[row0 + c0 + u * KG + g];
      s[u] = live[u] ? sc : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const float p = expf(s[u] - m_new);
      l += p;
      const float pv = QUANTIZED ? p * v_scale[row0 + c0 + u * KG + g] : p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += pv * vf[u][i];
    }
    m = m_new;
  }

  if (threadIdx.x % G == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sm_acc[g][d0 + i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = kNegInf;
    for (int j = 0; j < KG; ++j) mx = fmaxf(mx, sm_m[j]);
    float lt = 0.f, at = 0.f;
    for (int j = 0; j < KG; ++j) {
      const float w = expf(sm_m[j] - mx);
      lt += sm_l[j] * w;
      at += sm_acc[j][d] * w;
    }
    const float l_safe = (lt == 0.f) ? 1.f : lt;
    o[b * o_sb + h * o_sh + d] = from_f<T>(at / l_safe);
  }
}

template <typename T, typename KT, bool QUANTIZED, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* lens,
                   int per_seq, void* o, int B, int H, int T_alloc, int D,
                   long long q_sb, long long q_sh, long long o_sb,
                   long long o_sh, float sm_scale, int vec,
                   cudaStream_t stream) {
  decode_kernel<T, KT, DP, QUANTIZED><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, lens, per_seq, static_cast<T*>(o),
      H, T_alloc, D, q_sb, q_sh, o_sb, o_sh, sm_scale, vec);
  return cudaGetLastError();
}

template <typename T, typename KT, bool QUANTIZED>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* lens,
                       int per_seq, void* o, int B, int H, int T_alloc, int D,
                       long long q_sb, long long q_sh, long long o_sb,
                       long long o_sh, float sm_scale, int vec,
                       cudaStream_t stream) {
#define DS_DECODE_LAUNCH(DP)                                                \
  return launch<T, KT, QUANTIZED, DP>(q, k, v, ks, vs, lens, per_seq, o, B, \
                                      H, T_alloc, D, q_sb, q_sh, o_sb,      \
                                      o_sh, sm_scale, vec, stream)
  if (D <= 16) DS_DECODE_LAUNCH(16);
  if (D <= 32) DS_DECODE_LAUNCH(32);
  if (D <= 64) DS_DECODE_LAUNCH(64);
  DS_DECODE_LAUNCH(128);
#undef DS_DECODE_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the query and output; the cache too
// unless quantized, where it is int8 with fp32 scales [B, H, T]). The cache
// is a contiguous [B, H, T, D]; q and o are [B, H, D] views with the given
// element strides and a contiguous head dim. lens: device int32, one value
// (per_seq = 0) or one per sequence. vec = 1 when D % 8 == 0 and the cache
// rows and q are aligned for vector loads. Requires 1 <= D <= 128.
extern "C" int ds_decode_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* lens, int per_seq, void* o, int dtype,
    int quantized, int B, int H, int T_alloc, int D, long long q_sb,
    long long q_sh, long long o_sb, long long o_sh, float sm_scale, int vec,
    void* stream) {
  if (D < 1 || D > 128 || B * H == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    if (dtype == 0)
      return dispatch_d<float, int8_t, true>(q, k, v, k_scale, v_scale, lens,
                                             per_seq, o, B, H, T_alloc, D,
                                             q_sb, q_sh, o_sb, o_sh, sm_scale,
                                             vec, st);
    if (dtype == 1)
      return dispatch_d<__nv_bfloat16, int8_t, true>(
          q, k, v, k_scale, v_scale, lens, per_seq, o, B, H, T_alloc, D,
          q_sb, q_sh, o_sb, o_sh, sm_scale, vec, st);
  } else {
    if (dtype == 0)
      return dispatch_d<float, float, false>(q, k, v, k_scale, v_scale, lens,
                                             per_seq, o, B, H, T_alloc, D,
                                             q_sb, q_sh, o_sb, o_sh, sm_scale,
                                             vec, st);
    if (dtype == 1)
      return dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(
          q, k, v, k_scale, v_scale, lens, per_seq, o, B, H, T_alloc, D,
          q_sb, q_sh, o_sb, o_sh, sm_scale, vec, st);
  }
  return cudaErrorInvalidValue;
}
