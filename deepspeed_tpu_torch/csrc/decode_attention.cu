// Decode attention over a KV cache for Hopper (sm_90a): one query token per
// (batch, head) against the live prefix of a [B, H, T, D] cache.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/transformer/decode.py
// `_decode_kernel` (:54), both its fp form and its int8-KV form
// (QUANTIZED): K/V int8 with one fp32 scale per cached row; the k-scale is
// folded into the score, the v-scale into p before the P.V sum.
//
// Bound on the H100: bytes. One step streams len * D * 2 elements of K/V
// and does 4 flops per element, far below the card's ops/byte balance. At
// the generation path's B 8 x H 16 there are 128 (batch, head) rows, fewer
// than the card's 132 SMs, and at B 1 only 16: one CTA per row leaves the
// card mostly empty and each CTA's loads wait on its own arithmetic.
//
// Design (split over the cache, as flash-decoding). The grid is
// (B * H) x splits: split s of a row walks keys [s * chunk, (s + 1) *
// chunk) of its live length. The host picks splits and chunk (a multiple
// of 64 keys) from T, B * H and the SM count alone, so the launch never
// reads the live length on the host and stays capturable in a CUDA graph.
// A CTA whose chunk starts at or past its sequence's length exits at once.
//
// Inside a CTA, G = DP / EPT neighbouring threads share a key row, each
// holding EPT head-dim elements of it as one 16-byte vector (EPT = 8 bf16,
// 4 fp32, 16 int8), so 256 / G rows are read side by side. The walk is a
// register double buffer: the 16-byte K and V vectors (and the int8 form's
// row scales) of the next step are issued before the current step's
// scores, so the loads of step i + 1 are in flight while step i computes.
// Each key group keeps its own online-softmax state (m, l, acc) in the
// log2 domain (exp2 of scores prescaled by log2 e); the groups of a warp
// merge by shuffles, then the 8 warps through shared memory after one
// barrier, all in a fixed order. int8 values become floats by the
// exponent trick (the byte placed into the mantissa of 2^23, then one
// subtraction), full-rate integer and add instructions instead of the
// quarter-rate I2F conversion.
//
// Merge in the same launch. With one live split (always so when splits is
// 1) the CTA writes o itself. Otherwise each live split writes its fp32
// partial (m, l, acc[D]) to a scratch buffer, fences, and takes a ticket
// from an atomic per-row counter; the CTA that draws the last ticket
// merges the live splits in split-index order, writes o and resets the
// counter to 0 for the next launch. The fixed order makes reruns bit-equal
// whichever CTA finishes last. l == 0 (no live key) writes zeros, as the
// TPU kernel's guard does; the tail is a mask, never a pad copy.
//
// Plain C interface (loaded with ctypes): the arguments come packed in one
// struct (DecodeArgs, mirrored by ops/transformer/decode.py), so the host
// converts two ctypes arguments a call rather than twenty; returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The arguments of ds_decode_attention, packed by the wrapper
// (struct.Struct("<9Q4q10ifi"): 9 pointers, 4 strides, 10 ints, the
// softmax scale and a pad word); outside the anonymous namespace, so the C
// entry keeps external linkage.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lens;
  void* o;
  float* part;    // [B * H, splits, 2 + D] fp32: m, l, acc (splits > 1)
  int* counters;  // [B * H] int32, zero between launches (splits > 1)
  long long q_sb, q_sh, o_sb, o_sh;
  int B, H, T, D, chunk, splits, per_seq, dtype, quantized, vec;
  float sm_scale;
  int pad;
};
static_assert(sizeof(DecodeArgs) == 152, "DecodeArgs must match the wrapper");

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;


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

// The 16 bytes at p (VEC: an aligned, whole vector), or the first n of its
// EPT elements one by one with the rest zero.
template <typename KT, bool VEC>
__device__ __forceinline__ uint4 load_raw(const KT* p, int n) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    constexpr int EPT = 16 / sizeof(KT);
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    KT* e = reinterpret_cast<KT*>(&r);
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      if (i < n) e[i] = p[i];
    return r;
  }
}

template <typename KT>
__device__ __forceinline__ void raw_to_f(const uint4& r, float* out);

template <>
__device__ __forceinline__ void raw_to_f<__nv_bfloat16>(const uint4& r,
                                                        float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void raw_to_f<float>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

// int8 -> float without I2F: byte b + 128 (the sign bit flipped) becomes
// the low mantissa byte of 2^23, so the float is 2^23 + 128 + b exactly
template <>
__device__ __forceinline__ void raw_to_f<int8_t>(const uint4& r, float* out) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                         r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | j)) -
          8388736.0f;
  }
}

// T: query/output type; KT: cache type (T, or int8_t when QUANTIZED).
// DP: head dim rounded up to a power of two >= 16. VEC: every row is
// whole 16-byte vectors, aligned.
template <typename T, typename KT, int DP, bool QUANTIZED, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeArgs a) {
  constexpr int EPT = 16 / sizeof(KT);  // elements a thread of a row
  constexpr int G = DP / EPT;           // threads a key row
  constexpr int R = kThreads / G;       // key rows side by side
  // rows a thread a step: 128 rows a CTA a step, up to 8 a thread
  constexpr int U = R >= 128 ? 1 : (128 / R > 8 ? 8 : 128 / R);
  constexpr int STEP = U * R;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 1..32");
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][DP];
  __shared__ int sm_last;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int start = split * a.chunk;
  const int tid = threadIdx.x;
  const int g = tid / G;               // key group
  const int d0 = (tid % G) * EPT;
  const int n = a.D - d0;              // live elements of this thread's EPT
  const float scale2 = a.sm_scale * kLog2e;
  const long long row0 = (long long)bh * a.T;
  const KT* kb = static_cast<const KT*>(a.k) + row0 * a.D + d0;
  const KT* vb = static_cast<const KT*>(a.v) + row0 * a.D + d0;
  const float* ksb = QUANTIZED ? a.k_scale + row0 : nullptr;
  const float* vsb = QUANTIZED ? a.v_scale + row0 : nullptr;

  float m = kNegInf, l = 0.f, acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;

  int len = a.lens[a.per_seq ? b : 0];
  len = max(0, min(len, a.T));
  const int n_live =
      a.splits == 1 ? 1 : max(1, (len + a.chunk - 1) / a.chunk);
  if (split >= n_live) return;  // the chunk starts past the live length
  const int end = min(len, start + a.chunk);
  float qf[EPT];
  {
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + d0;
#pragma unroll
    for (int i = 0; i < EPT; ++i) qf[i] = i < n ? to_f(qp[i]) : 0.f;
  }

  // issue one step's loads (rows c0 + u * R + g below end) into
  // registers; rows past end read as zeros
  auto fetch = [&](int c0, uint4 (&kr)[U], uint4 (&vr)[U], float (&ksr)[U],
                   float (&vsr)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * R + g;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksr[u] = vsr[u] = 0.f;
      if (c < end) {
        if (n > 0) {
          kr[u] = load_raw<KT, VEC>(kb + (long long)c * a.D, n);
          vr[u] = load_raw<KT, VEC>(vb + (long long)c * a.D, n);
        }
        if (QUANTIZED) {
          ksr[u] = __ldg(ksb + c);
          vsr[u] = __ldg(vsb + c);
        }
      }
    }
  };
  // fold one step's rows into (m, l, acc)
  auto consume = [&](int c0, const uint4 (&kr)[U], const uint4 (&vr)[U],
                     const float (&ksr)[U], const float (&vsr)[U]) {
    float s[U];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPT];
      raw_to_f<KT>(kr[u], kf);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) part = fmaf(qf[i], kf[i], part);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      float sc = part * scale2;
      if (QUANTIZED) sc *= ksr[u];
      s[u] = c0 + u * R + g < end ? sc : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < EPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = exp2f(s[u] - m_new);  // 0 for a row past end
      l += p;
      const float pv = QUANTIZED ? p * vsr[u] : p;
      float vf[EPT];
      raw_to_f<KT>(vr[u], vf);
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i] = fmaf(pv, vf[i], acc[i]);
    }
    m = m_new;
  };

  if (start < end) {
    uint4 ka[U], va[U], kc[U], vc[U];
    float ksa[U], vsa[U], ksc[U], vsc[U];
    int c0 = start;
    fetch(c0, ka, va, ksa, vsa);
    for (;;) {
      if (c0 + STEP < end) fetch(c0 + STEP, kc, vc, ksc, vsc);
      consume(c0, ka, va, ksa, vsa);
      c0 += STEP;
      if (c0 >= end) break;
      if (c0 + STEP < end) fetch(c0 + STEP, ka, va, ksa, vsa);
      consume(c0, kc, vc, ksc, vsc);
      c0 += STEP;
      if (c0 >= end) break;
    }
  }

  // merge the key groups in a fixed order: the 32 / G groups of a warp by
  // shuffles (xor over the group bits of the lane), then the warps through
  // shared memory after one barrier
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    const float ws = exp2f(m - mn), wo = exp2f(mo - mn);
    l = l * ws + lo * wo;
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      acc[i] = acc[i] * ws + __shfl_xor_sync(0xffffffffu, acc[i], off) * wo;
    m = mn;
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < G) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) sm_acc[warp][d0 + i] = acc[i];
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();
  float mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kWarps], lt = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = exp2f(sm_m[w] - mx);
    lt = fmaf(sm_l[w], wgt[w], lt);
  }
  auto merged = [&](int d) {
    float at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) at = fmaf(sm_acc[w][d], wgt[w], at);
    return at;
  };

  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  if (n_live == 1) {
    for (int d = tid; d < a.D; d += kThreads)
      o[d] = from_f<T>(lt == 0.f ? 0.f : merged(d) / lt);
    return;
  }

  // this split's partial, then a ticket; the last CTA of the row merges
  const int S = 2 + a.D;
  float* rowp = a.part + (long long)bh * a.splits * S;
  float* pp = rowp + split * S;
  for (int d = tid; d < a.D; d += kThreads) pp[2 + d] = merged(d);
  if (tid == 0) {
    pp[0] = mx;
    pp[1] = lt;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(a.counters + bh, 1) == n_live - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  if (tid == 0) a.counters[bh] = 0;
  float M = kNegInf;
  for (int s = 0; s < n_live; ++s) M = fmaxf(M, __ldcg(rowp + s * S));
  for (int d = tid; d < a.D; d += kThreads) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float w = exp2f(__ldcg(rowp + s * S) - M);
      L = fmaf(__ldcg(rowp + s * S + 1), w, L);
      A = fmaf(__ldcg(rowp + s * S + 2 + d), w, A);
    }
    o[d] = from_f<T>(A / L);  // a live split has l > 0
  }
}

template <typename T, typename KT, bool QUANTIZED, int DP>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, a.splits);
  if (a.vec)
    decode_kernel<T, KT, DP, QUANTIZED, true><<<grid, kThreads, 0, stream>>>(a);
  else
    decode_kernel<T, KT, DP, QUANTIZED, false><<<grid, kThreads, 0, stream>>>(
        a);
  return cudaGetLastError();
}

template <typename T, typename KT, bool QUANTIZED>
cudaError_t dispatch_d(const DecodeArgs& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, KT, QUANTIZED, 16>(a, stream);
  if (a.D <= 32) return launch<T, KT, QUANTIZED, 32>(a, stream);
  if (a.D <= 64) return launch<T, KT, QUANTIZED, 64>(a, stream);
  return launch<T, KT, QUANTIZED, 128>(a, stream);
}

}  // namespace

// The fields of DecodeArgs: dtype 0 = float32, 1 = bfloat16 (the query
// and output; the cache too unless quantized, where it is int8 with fp32
// scales [B, H, T]). The cache is a contiguous [B, H, T, D]; q and o are
// [B, H, D] views with the given element strides and a contiguous head
// dim. lens: device int32, one value (per_seq = 0) or one per sequence.
// vec = 1 when D is a whole number of 16-byte vectors of the cache type
// and both caches are 16-byte aligned. splits * chunk >= T; with splits >
// 1, part holds B * H * splits * (2 + D) floats and counters B * H zeros.
// Requires 1 <= D <= 128.
extern "C" int ds_decode_attention(const DecodeArgs* args, void* stream) {
  const DecodeArgs& a = *args;
  if (a.D < 1 || a.D > 128 || a.B < 1 || a.H < 1 || a.T < 0 ||
      a.splits < 1 || a.splits > 65535 || a.chunk < 1 ||
      (long long)a.splits * a.chunk < a.T ||
      (a.splits > 1 && (a.part == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.quantized) {
    if (a.dtype == 0) return dispatch_d<float, int8_t, true>(a, st);
    if (a.dtype == 1) return dispatch_d<__nv_bfloat16, int8_t, true>(a, st);
  } else {
    if (a.dtype == 0) return dispatch_d<float, float, false>(a, st);
    if (a.dtype == 1)
      return dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(a, st);
  }
  return cudaErrorInvalidValue;
}
