// LAMB pass 1 for Hopper (sm_90a), over all of a step's tensors at once.
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/lamb/fused_lamb.py
// `_lamb_pass1_kernel` (:28). For every element of every tensor:
//   m' = b1 m + (1-b1) g;  v' = b2 v + (1-b2) g g;
//   u = (m'/bc1) / (sqrt(v'/bc2) + eps) (+ wd p),
// written to u, m' and v' (fp32), and per tensor the two squared norms
// sum(p^2) and sum(u^2) that the trust ratio needs. The ratio and the
// update -lr * ratio * u are left to the caller, as the JAX package leaves
// them to XLA.
//
// The TPU kernel runs once per tensor and carries the norm sums across its
// sequential grid. Here one launch takes every tensor: a device table holds
// each tensor's pointers, length and the index of its first chunk, and the
// grid is the concatenation of all tensors' chunks of kChunk elements.
// (Calling a kernel once per tensor costs more host time than device time:
// BERT-large has 298 tensors.) A block finds its tensor by binary search
// over the table, runs the elementwise update over its chunk (float4 when
// the tensor's seven buffers are 16-byte aligned, then a scalar tail) and
// writes its two partial sums; a second kernel reduces each tensor's
// partials in a fixed order, so the norms are the same on every run (no
// float atomics).
//
// The elementwise arithmetic keeps the JAX kernel's order with
// round-to-nearest intrinsics, so no multiply-add is contracted and u, m',
// v' equal the plain PyTorch version's to the last bit or two.
//
// Bound on the H100: memory. It reads p, g, m, v and writes u, m', v':
// 28 B a parameter, 9.39 GB for BERT-large's 335.2 M, 2.80 ms at 3.35 TB/s.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;  // elements a block updates

// one row of the table (int64 each): p, g, m, v, u, m_out, v_out, n, chunk0
constexpr int kCols = 9;

struct Hyper {
  float bc1, bc2, b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b (host fp32)
};

__device__ __forceinline__ float lamb_one(float p, float g, float& m,
                                          float& v, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.wd > 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  return u;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__global__ void __launch_bounds__(kThreads)
lamb_pass1_kernel(const long long* __restrict__ table, int n_tensors,
                  float* __restrict__ partial, Hyper hp) {
  const long long chunk = blockIdx.x;
  // the last tensor whose first chunk is <= this chunk
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * kCols + 8] <= chunk) lo = mid;
    else hi = mid - 1;
  }
  const long long* t = table + lo * kCols;
  const float* p = reinterpret_cast<const float*>(t[0]);
  const float* g = reinterpret_cast<const float*>(t[1]);
  const float* m = reinterpret_cast<const float*>(t[2]);
  const float* v = reinterpret_cast<const float*>(t[3]);
  float* u = reinterpret_cast<float*>(t[4]);
  float* mo = reinterpret_cast<float*>(t[5]);
  float* vo = reinterpret_cast<float*>(t[6]);
  const long long n = t[7];
  const long long begin = (chunk - t[8]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;

  float wsq = 0.f, usq = 0.f;
  long long done = begin;
  uintptr_t any = 0;
  for (int c = 0; c < 7; ++c) any |= (uintptr_t)t[c];
  if ((any & 15) == 0) {  // begin is a multiple of 4, so float4 is aligned
    const long long n4 = (end - begin) / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const long long e = begin / 4 + i;
      const float4 p4 = reinterpret_cast<const float4*>(p)[e];
      const float4 g4 = reinterpret_cast<const float4*>(g)[e];
      float4 m4 = reinterpret_cast<const float4*>(m)[e];
      float4 v4 = reinterpret_cast<const float4*>(v)[e];
      float4 u4;
      u4.x = lamb_one(p4.x, g4.x, m4.x, v4.x, hp);
      u4.y = lamb_one(p4.y, g4.y, m4.y, v4.y, hp);
      u4.z = lamb_one(p4.z, g4.z, m4.z, v4.z, hp);
      u4.w = lamb_one(p4.w, g4.w, m4.w, v4.w, hp);
      reinterpret_cast<float4*>(u)[e] = u4;
      reinterpret_cast<float4*>(mo)[e] = m4;
      reinterpret_cast<float4*>(vo)[e] = v4;
      wsq += p4.x * p4.x + p4.y * p4.y + p4.z * p4.z + p4.w * p4.w;
      usq += u4.x * u4.x + u4.y * u4.y + u4.z * u4.z + u4.w * u4.w;
    }
    done = begin + n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < end; i += kThreads) {
    float mm = m[i], vv = v[i];
    const float pp = p[i];
    const float uu = lamb_one(pp, g[i], mm, vv, hp);
    u[i] = uu;
    mo[i] = mm;
    vo[i] = vv;
    wsq += pp * pp;
    usq += uu * uu;
  }

  // block sum in a fixed order: warps, then warp 0 over the warps' sums
  __shared__ float red[2][kThreads / 32];
  wsq = warp_sum(wsq);
  usq = warp_sum(usq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = wsq;
    red[1][warp] = usq;
  }
  __syncthreads();
  if (warp == 0) {
    wsq = lane < kThreads / 32 ? red[0][lane] : 0.f;
    usq = lane < kThreads / 32 ? red[1][lane] : 0.f;
    wsq = warp_sum(wsq);
    usq = warp_sum(usq);
    if (lane == 0) {
      partial[2 * chunk] = wsq;
      partial[2 * chunk + 1] = usq;
    }
  }
}

// one warp per tensor: the sum of its chunks' partials, lane-strided, then
// a butterfly; a fixed order for a given table
__global__ void __launch_bounds__(kThreads)
lamb_norms_kernel(const long long* __restrict__ table, int n_tensors,
                  long long n_chunks, const float* __restrict__ partial,
                  float* __restrict__ wsq_out, float* __restrict__ usq_out) {
  const int tensor = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (tensor >= n_tensors) return;
  const int lane = threadIdx.x & 31;
  const long long first = table[tensor * kCols + 8];
  const long long last =
      tensor + 1 < n_tensors ? table[(tensor + 1) * kCols + 8] : n_chunks;
  float w = 0.f, s = 0.f;
  for (long long c = first + lane; c < last; c += 32) {
    w += partial[2 * c];
    s += partial[2 * c + 1];
  }
  w = warp_sum(w);
  s = warp_sum(s);
  if (lane == 0) {
    wsq_out[tensor] = w;
    usq_out[tensor] = s;
  }
}

}  // namespace

// table: device int64 [n_tensors, 9] = (p, g, m, v, u, m_out, v_out
// pointers, n, first chunk), the first chunks the running sum of
// ceil(n / 16384); n_chunks their total. All buffers fp32; the outputs
// distinct from the inputs. partial: device fp32 [2 n_chunks] scratch.
// wsq, usq: device fp32 [n_tensors], each tensor's sum(p^2) and sum(u^2).
// omb1, omb2 = 1 - b1, 1 - b2 rounded to fp32 on the host.
extern "C" int ds_lamb(const long long* table, int n_tensors,
                       long long n_chunks, float* partial, float* wsq,
                       float* usq, float bc1, float bc2, float b1,
                       float omb1, float b2, float omb2, float eps, float wd,
                       void* stream) {
  if (n_tensors <= 0 || n_chunks < 0 || n_chunks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Hyper hp{bc1, bc2, b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    lamb_pass1_kernel<<<(unsigned)n_chunks, kThreads, 0, s>>>(
        table, n_tensors, partial, hp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int per_block = kThreads / 32;
  lamb_norms_kernel<<<(n_tensors + per_block - 1) / per_block, kThreads, 0,
                      s>>>(table, n_tensors, n_chunks, partial, wsq, usq);
  return cudaGetLastError();
}
