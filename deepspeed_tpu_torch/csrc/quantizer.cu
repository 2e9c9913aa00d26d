// Grouped fake-quantization (MoQ) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_quant_kernel` of
// deepspeed_tpu/ops/quantizer/quantizer.py:68 (pallas_call at :106): the
// tensor is viewed as [groups, L] rows in the reference (flax) layout; each
// row gets one scale, symmetric (absmax / qmax, levels -qmax-1 .. qmax) or
// asymmetric (min/max affine, levels 0 .. 2^bits - 1); every element is
// rounded (to nearest even, or stochastically: floor(q + u)) and at once
// dequantized, in the input's dtype. The arithmetic is the reference's
// `_quantize_rows` (quantizer.py:40-65) in fp32 with round-to-nearest
// intrinsics and no contracted multiply-adds, so the nearest-rounding
// result equals the plain PyTorch version bit for bit.
//
// Bound on the H100: memory. Each element must be read once and written
// once: BERT-large's 100 quantized fp32 masters (334.9 M elements) move
// 2.68 GB a MoQ step, 0.80 ms at 3.35 TB/s. This kernel reads each element
// twice (12 bytes an fp32 element, ~1.2 ms); the second read of a small
// tensor may come from the 50 MB L2.
//
// Design. A row spans up to millions of elements (the word embeddings:
// 3.9 M a group at groups 8), and Hopper's blocks run in no order with
// nothing carried between them, so the TPU's one grid step a row becomes
// two launches over blocks of kChunk elements of one row:
//  1. `quant_stats`: each block writes its chunk's absmax (or min and max)
//     to a partial buffer;
//  2. `quant_apply`: each block reduces its row's partials (max and min
//     are exact in any order, so the scale is deterministic), then
//     quantizes and dequantizes its chunk; in place when y == x (each
//     element is read and written by one thread).
// Layouts. `transposed` = 0: the buffer is the reference layout (group g is
// elements [g L, (g+1) L)). `transposed` = 1: the buffer is [R, C] and the
// reference layout is its transpose [C, R] (the port stores dense weights
// [out, in], flax [in, out]); with C % groups == 0 group g is the column
// strip [0, R) x [g w, (g+1) w), w = C / groups, walked row by row so the
// loads stay coalesced. Lanes read 16-byte vectors (4 fp32 or 8 bf16) when
// the row (or strip) width is a multiple of the vector and the buffers are
// aligned, else single elements.
// Stochastic rounding draws one Philox4x32-10 word a element, keyed by the
// 64-bit seed, with the element's index in the reference layout as the
// counter; the noise is (word >> 8) 2^-24, the TPU kernel's 24-bit form.
// NaN inputs are out of scope: fmaxf/fminf drop them from the scale.
//
// Plain C interface (loaded with ctypes); the function returns the
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // elements of one row a block takes

template <typename T>
struct VecWidth;  // elements in one 16-byte vector
template <>
struct VecWidth<float> {
  static constexpr int N = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int W>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  if (W == 1) {
    out[0] = to_f(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < W; ++i) out[i] = to_f(e[i]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_n(T* p, const float* in) {
  if (W == 1) {
    p[0] = from_f<T>(in[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < W; ++i) e[i] = from_f<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Where the j-th element of group g lies, in the buffer and in the
// reference layout.
struct Layout {
  long long L;  // elements a group
  long long S;  // blocks a group
  long long R, C, w;  // transposed: the buffer is [R, C], strips of width w
  int transposed;

  __device__ long long phys(int g, long long j) const {
    if (!transposed) return (long long)g * L + j;
    return (j / w) * C + (long long)g * w + j % w;
  }
  __device__ long long logical(int g, long long j) const {
    if (!transposed) return (long long)g * L + j;
    return ((long long)g * w + j % w) * R + j / w;
  }
};

// Philox4x32-10 (Salmon et al., SC'11), first output word, counter
// (index_lo, index_hi, 0, 0), key (seed_lo, seed_hi)
__device__ __forceinline__ uint32_t philox_word(unsigned long long index,
                                                unsigned long long seed) {
  uint32_t c0 = (uint32_t)index, c1 = (uint32_t)(index >> 32), c2 = 0,
           c3 = 0;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? fmaxf(a, b) : fminf(a, b);
}

// the block's max (or min) of v, returned to every thread
template <bool MAX>
__device__ float block_reduce(float v, float* sh) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine<MAX>(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = combine<MAX>(v, sh[i]);
  __syncthreads();
  return v;
}

// Pass 1: partial[b] = the chunk's absmax (SYM) or min, and
// partial[nblocks + b] its max (asymmetric).
template <typename T, int W, bool SYM>
__global__ void __launch_bounds__(kThreads)
quant_stats(const T* __restrict__ x, float* __restrict__ partial,
            Layout lay) {
  __shared__ float sh[kThreads / 32];
  const long long b = blockIdx.x;
  const int g = (int)(b / lay.S);
  const long long j0 = (b % lay.S) * kChunk;
  const long long j1 = min(lay.L, j0 + kChunk);
  float lo = SYM ? 0.f : INFINITY, hi = -INFINITY;
  for (long long j = j0 + (long long)threadIdx.x * W; j < j1;
       j += (long long)kThreads * W) {
    float v[W];
    load_n<T, W>(x + lay.phys(g, j), v);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (SYM) {
        lo = fmaxf(lo, fabsf(v[e]));
      } else {
        lo = fminf(lo, v[e]);
        hi = fmaxf(hi, v[e]);
      }
    }
  }
  if (SYM) {
    lo = block_reduce<true>(lo, sh);
  } else {
    lo = block_reduce<false>(lo, sh);
    hi = block_reduce<true>(hi, sh);
  }
  if (threadIdx.x == 0) {
    partial[b] = lo;
    if (!SYM) partial[gridDim.x + b] = hi;
  }
}

// Pass 2: the row's scale from its partials, then quantize + dequantize.
template <typename T, int W, bool SYM, bool SR>
__global__ void __launch_bounds__(kThreads)
quant_apply(const T* x, T* y, const float* __restrict__ partial, Layout lay,
            float qmax, unsigned long long seed) {
  __shared__ float sh[kThreads / 32];
  const long long b = blockIdx.x;
  const int g = (int)(b / lay.S);
  const long long j0 = (b % lay.S) * kChunk;
  const long long j1 = min(lay.L, j0 + kChunk);
  const float* row = partial + (long long)g * lay.S;
  float lo = SYM ? 0.f : INFINITY, hi = -INFINITY;
  for (long long k = threadIdx.x; k < lay.S; k += kThreads) {
    if (SYM) {
      lo = fmaxf(lo, row[k]);
    } else {
      lo = fminf(lo, row[k]);
      hi = fmaxf(hi, row[gridDim.x + k]);
    }
  }
  float scale;
  if (SYM) {
    lo = block_reduce<true>(lo, sh);
    scale = __fdiv_rn(lo, qmax);
  } else {
    lo = block_reduce<false>(lo, sh);
    hi = block_reduce<true>(hi, sh);
    scale = __fdiv_rn(__fsub_rn(hi, lo), qmax);
  }
  if (scale == 0.f) scale = 1.f;
  const float qlo = SYM ? -qmax - 1.f : 0.f;

  for (long long j = j0 + (long long)threadIdx.x * W; j < j1;
       j += (long long)kThreads * W) {
    const long long p = lay.phys(g, j);
    float v[W];
    load_n<T, W>(x + p, v);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float q = SYM ? __fdiv_rn(v[e], scale)
                    : __fdiv_rn(__fsub_rn(v[e], lo), scale);
      if (SR) {
        const uint32_t word = philox_word(
            (unsigned long long)lay.logical(g, j + e), seed);
        const float u = (float)(word >> 8) * (1.f / 16777216.f);
        q = floorf(__fadd_rn(q, u));
      } else {
        q = rintf(q);  // half to even, as jnp.round
      }
      q = q < qlo ? qlo : (q > qmax ? qmax : q);  // NaN passes, as jnp.clip
      v[e] = SYM ? __fmul_rn(q, scale) : __fadd_rn(__fmul_rn(q, scale), lo);
    }
    store_n<T, W>(y + p, v);
  }
}

template <typename T, int W, bool SYM, bool SR>
cudaError_t run(const void* x, void* y, float* partial, Layout lay,
                long long blocks, float qmax, unsigned long long seed,
                cudaStream_t s) {
  quant_stats<T, W, SYM><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), partial, lay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quant_apply<T, W, SYM, SR><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), partial, lay, qmax,
      seed);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t dispatch_mode(int symmetric, int stochastic, const void* x,
                          void* y, float* partial, Layout lay,
                          long long blocks, float qmax,
                          unsigned long long seed, cudaStream_t s) {
  if (symmetric)
    return stochastic
               ? run<T, W, true, true>(x, y, partial, lay, blocks, qmax, seed,
                                       s)
               : run<T, W, true, false>(x, y, partial, lay, blocks, qmax,
                                        seed, s);
  return stochastic
             ? run<T, W, false, true>(x, y, partial, lay, blocks, qmax, seed,
                                      s)
             : run<T, W, false, false>(x, y, partial, lay, blocks, qmax, seed,
                                       s);
}

}  // namespace

// y = fake-quantized x (y may be x). n elements of dtype 0 = fp32 or
// 1 = bf16, viewed as `groups` rows in the reference layout: the buffer
// itself (transposed = 0), or the transpose of the buffer [R, C]
// (transposed = 1; R * C = n, C % groups == 0). num_bits 1..16; symmetric
// and stochastic are 0/1; seed keys the Philox noise. vec = 1 when every
// group (rows) or strip (transposed) width is a multiple of the 16-byte
// vector and x and y are 16-byte aligned. partial: partial_len floats of
// scratch, at least 2 * groups * ceil((n / groups) / 8192).
extern "C" int ds_quantize(const void* x, void* y, float* partial,
                           long long partial_len, long long n, int groups,
                           int transposed, long long R, long long C,
                           int num_bits, int symmetric, int stochastic,
                           unsigned long long seed, int dtype, int vec,
                           void* stream) {
  if (n <= 0 || groups <= 0 || n % groups != 0 || num_bits < 1 ||
      num_bits > 16 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Layout lay;
  lay.L = n / groups;
  lay.S = (lay.L + kChunk - 1) / kChunk;
  lay.transposed = transposed ? 1 : 0;
  lay.R = R;
  lay.C = C;
  lay.w = 1;
  if (transposed) {
    if (R <= 0 || C <= 0 || R * C != n || C % groups != 0)
      return cudaErrorInvalidValue;
    lay.w = C / groups;
  }
  const long long blocks = lay.S * groups;
  if (blocks > 0x7fffffffLL || partial_len < 2 * blocks)
    return cudaErrorInvalidValue;
  const int width = dtype == 0 ? 4 : 8;
  if (vec && ((transposed ? lay.w : lay.L) % width != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return cudaErrorInvalidValue;
  const float qmax = symmetric ? (float)((1 << (num_bits - 1)) - 1)
                               : (float)((1 << num_bits) - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? dispatch_mode<float, 4>(symmetric, stochastic, x, y, partial,
                                         lay, blocks, qmax, seed, s)
               : dispatch_mode<float, 1>(symmetric, stochastic, x, y, partial,
                                         lay, blocks, qmax, seed, s);
  return vec ? dispatch_mode<__nv_bfloat16, 8>(symmetric, stochastic, x, y,
                                               partial, lay, blocks, qmax,
                                               seed, s)
             : dispatch_mode<__nv_bfloat16, 1>(symmetric, stochastic, x, y,
                                               partial, lay, blocks, qmax,
                                               seed, s);
}
