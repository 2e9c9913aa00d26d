// Adam / AdamW update for Hopper (sm_90a): one elementwise kernel.
//
// Replaces the Pallas TPU kernels deepspeed_tpu/ops/adam/fused_adam.py
// `_adam_kernel` (:35, one tensor) and `_adam_sweep_kernel` (:130, the
// whole flattened state with the global-norm clip coefficient and an
// optional cast of p + u). Template flags select the form:
// * READ_P: p is read (the per-tensor form always reads it, as the TPU
//   kernel does; the sweep only for weight decay or the cast);
// * CAST: also write (p + u) in bf16.
// The clip coefficient is a device fp32 scalar (null means 1), so a clip
// computed on the card never makes the host wait; lr and the bias
// corrections come by value from the host, which knows the applied-step
// count. Each thread walks a grid-stride loop of float4 vectors.
//
// The arithmetic keeps the JAX kernel's order exactly,
//   g' = g cc (+ wd p, L2 mode); m' = b1 m + (1-b1) g'; v' = b2 v + (1-b2) g' g';
//   u = -lr (m'/bc1) / (sqrt(v'/bc2) + eps) (- lr wd p, AdamW mode),
// with round-to-nearest intrinsics so that no multiply-add is contracted
// and the result is the plain PyTorch version's to the last bit or two.
//
// Bound on the H100: memory. At GPT-2 medium (354.9 M parameters) the sweep
// with wd 0 and no cast moves 24 B a parameter (g, m, v in; u, m, v out),
// 8.5 GB, 2.5 ms at 3.35 TB/s; the per-tensor form 28 B a parameter. The
// kernel issues 16-byte loads and stores and does ~20 flops a parameter.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b (host fp32)
  int adam_w_mode;
};

__device__ __forceinline__ float adam_one(float p, float g, float& m,
                                          float& v, float cc,
                                          const Hyper& h) {
  float gg = __fmul_rn(g, cc);
  if (!h.adam_w_mode && h.wd > 0.f) gg = __fadd_rn(gg, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gg));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, gg), gg));
  float u = __fdiv_rn(__fmul_rn(-h.lr, __fdiv_rn(m, h.bc1)),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.adam_w_mode && h.wd > 0.f)
    u = __fsub_rn(u, __fmul_rn(__fmul_rn(h.lr, h.wd), p));
  return u;
}

template <bool READ_P, bool CAST>
__global__ void __launch_bounds__(256)
adam_kernel(const float* __restrict__ p, const float* __restrict__ g,
            const float* __restrict__ m, const float* __restrict__ v,
            float* __restrict__ u, float* __restrict__ mo,
            float* __restrict__ vo, __nv_bfloat16* __restrict__ cast,
            long long n, const float* __restrict__ clip_coef, Hyper h,
            int vec) {
  const float cc = clip_coef != nullptr ? *clip_coef : 1.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = first; i < n4; i += stride) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      float4 m4 = reinterpret_cast<const float4*>(m)[i];
      float4 v4 = reinterpret_cast<const float4*>(v)[i];
      float4 p4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (READ_P) p4 = reinterpret_cast<const float4*>(p)[i];
      float4 u4;
      u4.x = adam_one(p4.x, g4.x, m4.x, v4.x, cc, h);
      u4.y = adam_one(p4.y, g4.y, m4.y, v4.y, cc, h);
      u4.z = adam_one(p4.z, g4.z, m4.z, v4.z, cc, h);
      u4.w = adam_one(p4.w, g4.w, m4.w, v4.w, cc, h);
      reinterpret_cast<float4*>(u)[i] = u4;
      reinterpret_cast<float4*>(mo)[i] = m4;
      reinterpret_cast<float4*>(vo)[i] = v4;
      if (CAST) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(__fadd_rn(p4.x, u4.x),
                                                  __fadd_rn(p4.y, u4.y));
        __nv_bfloat162 hi = __floats2bfloat162_rn(__fadd_rn(p4.z, u4.z),
                                                  __fadd_rn(p4.w, u4.w));
        uint2 packed = make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                                  *reinterpret_cast<uint32_t*>(&hi));
        reinterpret_cast<uint2*>(cast)[i] = packed;
      }
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    float mm = m[i], vv = v[i];
    const float pp = READ_P ? p[i] : 0.f;
    const float uu = adam_one(pp, g[i], mm, vv, cc, h);
    u[i] = uu;
    mo[i] = mm;
    vo[i] = vv;
    if (CAST) cast[i] = __float2bfloat16_rn(__fadd_rn(pp, uu));
  }
}

}  // namespace

// p, g, m, v: fp32 vectors of n elements (p may be null when read_p = 0);
// u, mo, vo: fp32 outputs (distinct from the inputs); cast: bf16 output
// of p + u or null. clip_coef: a device fp32 scalar or null (1). vec = 1
// when every vector is 16-byte aligned (float4 loads; the tail past a
// multiple of 4 runs scalar). adam_w_mode: 1 = decoupled weight decay,
// 0 = L2 decay folded into the gradient. omb1, omb2 = 1 - b1, 1 - b2,
// rounded to fp32 on the host.
extern "C" int ds_adam(const float* p, const float* g, const float* m,
                       const float* v, float* u, float* mo, float* vo,
                       void* cast, long long n, const float* clip_coef,
                       float lr, float bc1, float bc2, float b1, float omb1,
                       float b2, float omb2, float eps, float wd,
                       int adam_w_mode, int read_p, int vec, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  if (read_p && p == nullptr) return cudaErrorInvalidValue;
  const Hyper h{lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd, adam_w_mode};
  const long long work = vec ? (n + 3) / 4 : n;
  const int threads = 256;
  // a few waves over the 132 SMs; the grid-stride loop covers the rest
  const long long blocks_needed = (work + threads - 1) / threads;
  const int blocks = (int)(blocks_needed < 132 * 16 ? blocks_needed : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* c = static_cast<__nv_bfloat16*>(cast);
  if (read_p && c != nullptr)
    adam_kernel<true, true><<<blocks, threads, 0, s>>>(
        p, g, m, v, u, mo, vo, c, n, clip_coef, h, vec);
  else if (read_p)
    adam_kernel<true, false><<<blocks, threads, 0, s>>>(
        p, g, m, v, u, mo, vo, c, n, clip_coef, h, vec);
  else if (c == nullptr)
    adam_kernel<false, false><<<blocks, threads, 0, s>>>(
        p, g, m, v, u, mo, vo, c, n, clip_coef, h, vec);
  else
    return cudaErrorInvalidValue;  // the cast needs p
  return cudaGetLastError();
}
