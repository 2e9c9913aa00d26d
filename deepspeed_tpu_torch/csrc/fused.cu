// LayerNorm forward and backward, bias + GeLU, and the scaled softmax, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/fused.py:
// * `_ln_fwd_kernel` (:43): y = (x - mu) rstd gamma + beta over the last dim,
//   with mu and rstd (fp32) kept for the backward;
// * `_ln_bwd_kernel` (:55): dx = (g dy - c1 xhat - c2) rstd, with
//   xhat = (x - mu) rstd, c1 = mean(xhat g dy), c2 = mean(g dy);
// * `_bias_gelu_kernel` (:147): y = gelu_tanh(x + b);
// * `_softmax_kernel` (:226): y = softmax(x * scale) over the last dim.
// x, gamma, beta, dy and the outputs are fp32 or bf16 (one type per call;
// the softmax also takes fp16); the arithmetic is fp32 throughout, as in
// the TPU kernels.
//
// Bound on the H100: memory, all three. At BERT-large's shapes (bf16):
// LN forward over [8192, 1024] reads x and writes y, 33.6 MB (10.0 us at
// 3.35 TB/s); the backward reads x and dy and writes dx, 50.4 MB (15.0 us);
// bias-GeLU over [8192, 4096] reads x and writes y, 134 MB (40.1 us); the
// softmax reads x and writes y, 67 MB at [131072, 128] bf16 (BERT-large's
// attention scores, 20.0 us) and 537 MB at [131072, 1024] (GPT-2 medium's,
// 160 us).
//
// Design. The TPU kernels take blocks of rows through VMEM; here one warp
// owns one row and holds it in registers (NPL values a lane, NPL * 32 >= h),
// so the row is read from device memory once: the mean, then the mean of the
// squared deviations (two passes over the registers, not E[x^2] - mu^2,
// which loses digits when eps is 1e-12 and the row is near constant), then
// the output. Lanes read 16-byte vectors (4 fp32 or 8 bf16) when the row
// length is a multiple of the vector and the buffers are aligned, else
// single elements; both layouts are coalesced. Warp sums use a butterfly
// of shuffles, so every lane holds the same total and the order is fixed.
// Rows up to 2048 wide fit (NPL = 64; the backward keeps two such arrays).
// Bias-GeLU is a grid-stride elementwise pass; tanhf (not tanh.approx.f32,
// whose ~5e-4 relative error is far above the fp32 tolerance).
//
// The softmax reads each row once and writes it once, with the row held in
// registers between its max, its sum and the store. Lanes read 16-byte
// vectors (8 bf16/fp16, 4 fp32 columns a vector, vector i of a lane at
// column 8 lane + 256 i for bf16) when the row is whole vectors and both
// buffers are aligned, else single elements (a view offset by one element
// takes this path). Rows of fewer than 32 vectors share a warp: at h 128
// bf16, 16 lanes a row and two rows a warp, the reductions butterflies
// over the 16-lane group. Every load of a row is issued before its first
// reduction; blocks of 8 warps. Arithmetic: x * scale rounded once
// (__fmul_rn), so the max is the plain version's; exp2f of (x * scale -
// m) log2 e; one IEEE reciprocal of the row sum, then a multiply. Rows up
// to 2048 take the warp kernel (64 values a lane at most); wider rows one
// block of 512 threads a row, still held in registers, up to 32768; wider
// still, a block of 256 threads and three passes over the row in device
// memory.
//
// Plain C interface (loaded with ctypes); each function returns the
// cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

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

// Load / store W consecutive elements starting at p (W = 1, or one aligned
// 16-byte vector).
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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The part of a row a lane owns: NPL values as CHUNKS groups of W
// consecutive elements; group i starts at column (lane + 32 i) W.
template <typename T, int NPL, bool VEC>
struct Row {
  static constexpr int W = VEC ? VecWidth<T>::N : 1;
  static constexpr int CHUNKS = NPL / W;
  static_assert(NPL % W == 0, "NPL must be a multiple of the vector width");

  __device__ static int col(int lane, int i) { return (lane + 32 * i) * W; }

  // loads the lane's values of row r (zeros past h)
  __device__ static void load(const T* r, int h, int lane, float (&v)[NPL]) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = col(lane, i);
      if (c < h) {
        load_n<T, W>(r + c, &v[i * W]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[i * W + e] = 0.f;
      }
    }
  }
};

template <typename T, int NPL, bool VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              long long n, int h, float eps) {
  using R = Row<T, NPL, VEC>;
  constexpr int W = R::W;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * h;
  float v[NPL];
  R::load(xr, h, lane, v);

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) s += v[i];
  const float mu = warp_sum(s) / (float)h;

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < R::CHUNKS; ++i) {
    if (R::col(lane, i) < h) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float d = v[i * W + e] - mu;
        ss += d * d;
      }
    }
  }
  const float rstd = __frsqrt_rn(warp_sum(ss) / (float)h + eps);

  T* yr = y + row * h;
#pragma unroll
  for (int i = 0; i < R::CHUNKS; ++i) {
    const int c = R::col(lane, i);
    if (c < h) {
      float g[W], b[W], out[W];
      load_n<T, W>(gamma + c, g);
      load_n<T, W>(beta + c, b);
#pragma unroll
      for (int e = 0; e < W; ++e)
        out[e] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[i * W + e], mu), rstd), g[e]),
            b[e]);
      store_n<T, W>(yr + c, out);
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, int NPL, bool VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const float* __restrict__ mu_in,
              const float* __restrict__ rstd_in, const T* __restrict__ dy,
              T* __restrict__ dx, long long n, int h) {
  using R = Row<T, NPL, VEC>;
  constexpr int W = R::W;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const float mu = mu_in[row], rstd = rstd_in[row];
  float xhat[NPL], wdy[NPL];
  R::load(x + row * h, h, lane, xhat);
  R::load(dy + row * h, h, lane, wdy);

  // xhat = (x - mu) rstd and wdy = dy g; both are 0 past h
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < R::CHUNKS; ++i) {
    const int c = R::col(lane, i);
    float g[W];
    if (c < h) {
      load_n<T, W>(gamma + c, g);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) g[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int k = i * W + e;
      xhat[k] = c < h ? __fmul_rn(__fsub_rn(xhat[k], mu), rstd) : 0.f;
      wdy[k] = __fmul_rn(wdy[k], g[e]);
      s1 += xhat[k] * wdy[k];
      s2 += wdy[k];
    }
  }
  const float c1 = warp_sum(s1) / (float)h;
  const float c2 = warp_sum(s2) / (float)h;

  T* dxr = dx + row * h;
#pragma unroll
  for (int i = 0; i < R::CHUNKS; ++i) {
    const int c = R::col(lane, i);
    if (c < h) {
      float out[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int k = i * W + e;
        out[e] = __fmul_rn(
            __fsub_rn(__fsub_rn(wdy[k], __fmul_rn(c1, xhat[k])), c2), rstd);
      }
      store_n<T, W>(dxr + c, out);
    }
  }
}

// gelu_tanh(t) = 0.5 t (1 + tanh(0.79788456 (t + 0.044715 t^3))), in the
// order of the TPU kernel's expression, without contracted multiply-adds
__device__ __forceinline__ float gelu_tanh(float t) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, t), t), t);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(t, cube));
  return __fmul_rn(__fmul_rn(0.5f, t), __fadd_rn(1.f, tanhf(inner)));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
bias_gelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                 T* __restrict__ y, long long total, int h) {
  constexpr int W = VEC ? VecWidth<T>::N : 1;
  const long long groups = total / W;  // VEC: h % W == 0, so total % W == 0
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < groups; i += stride) {
    const long long off = i * W;
    const int c = (int)(off % h);  // a group never crosses a row
    float v[W], b[W];
    load_n<T, W>(x + off, v);
    load_n<T, W>(bias + c, b);
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = gelu_tanh(__fadd_rn(v[e], b[e]));
    store_n<T, W>(y + off, v);
  }
}

// elements a lane holds for a row of h: the smallest of 8, 16, 32, 64
// with NPL * 32 >= h; 0 when h > 2048
int npl_for(int h) {
  for (int npl = 8; npl <= 64; npl *= 2)
    if (npl * 32 >= h) return npl;
  return 0;
}

template <typename T, int NPL, bool VEC>
cudaError_t launch_fwd(const void* x, const void* g, const void* b, void* y,
                       float* mu, float* rstd, long long n, int h, float eps,
                       cudaStream_t s) {
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_fwd_kernel<T, NPL, VEC><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), mu, rstd, n, h, eps);
  return cudaGetLastError();
}

template <typename T, int NPL, bool VEC>
cudaError_t launch_bwd(const void* x, const void* g, const float* mu,
                       const float* rstd, const void* dy, void* dx,
                       long long n, int h, cudaStream_t s) {
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_bwd_kernel<T, NPL, VEC><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), n, h);
  return cudaGetLastError();
}

// Calls F<T, NPL, VEC>::run(args...) for the runtime (dtype, npl, vec).
template <template <typename, int, bool> class F, typename... A>
cudaError_t dispatch(int dtype, int npl, int vec, A... args) {
#define DS_LN_CASE(T, NPL)                                        \
  if (npl == NPL)                                                 \
    return vec ? F<T, NPL, true>::run(args...)                    \
               : F<T, NPL, false>::run(args...);
  if (dtype == 0) {
    DS_LN_CASE(float, 8) DS_LN_CASE(float, 16) DS_LN_CASE(float, 32)
    DS_LN_CASE(float, 64)
  } else if (dtype == 1) {
    DS_LN_CASE(__nv_bfloat16, 8) DS_LN_CASE(__nv_bfloat16, 16)
    DS_LN_CASE(__nv_bfloat16, 32) DS_LN_CASE(__nv_bfloat16, 64)
  }
#undef DS_LN_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int NPL, bool VEC>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... a) {
    return launch_fwd<T, NPL, VEC>(a...);
  }
};
template <typename T, int NPL, bool VEC>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... a) {
    return launch_bwd<T, NPL, VEC>(a...);
  }
};

bool vec_ok(int dtype, int h, int vec) {
  const int w = dtype == 0 ? 4 : 8;
  return !vec || h % w == 0;
}

// ---------------------------------------------------------------------------
// Scaled softmax over the last dim

__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSoftmaxWarps = 8;          // rows kernel: warps a block
constexpr int kSoftmaxWideThreads = 512;  // wide kernel: one row a block
constexpr int kSoftmaxMaxValues = 64;     // values a thread holds at most

template <>
struct VecWidth<__half> {
  static constexpr int N = 8;
};

// The part of a row one thread holds: CH groups of W consecutive columns
// (W = 1, or one 16-byte vector), group i at column (t + P i) W for the
// thread's index t among the P threads of the row. All CH loads are issued
// before the first value is used; columns past h read as -inf (scaled).
template <typename T, int W, int CH, int P>
__device__ __forceinline__ void softmax_load(const T* __restrict__ xr, int h,
                                             int t, bool live, float scale,
                                             float (&v)[CH * W]) {
  if constexpr (W == 1) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = t + P * i;
      v[i] = live && c < h ? __fmul_rn(to_f(xr[c]), scale) : -INFINITY;
    }
  } else {
    uint4 raw[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = (t + P * i) * W;
      raw[i] = live && c < h ? *reinterpret_cast<const uint4*>(xr + c)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool in = (t + P * i) * W < h;
      const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < W; ++j)
        v[i * W + j] = in ? __fmul_rn(to_f(e[j]), scale) : -INFINITY;
    }
  }
}

template <typename T, int W, int CH, int P>
__device__ __forceinline__ void softmax_store(T* __restrict__ yr, int h, int t,
                                              bool live,
                                              const float (&v)[CH * W]) {
  if (!live) return;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = (t + P * i) * W;
    if (c < h) store_n<T, W>(yr + c, &v[i * W]);
  }
}

// exp2 of (x * scale - m) log2 e in place; returns the thread's sum
template <int N>
__device__ __forceinline__ float softmax_exp(float (&v)[N], float m) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = exp2f(__fsub_rn(v[i], m) * kLog2e);
    s += v[i];
  }
  return s;
}

// LPR lanes a row (32 / LPR rows a warp, aligned lane groups), CH groups
// of W columns a lane; the row stays in registers from the load to the
// store: one read, one write
template <typename T, int W, int LPR, int CH>
__global__ void __launch_bounds__(32 * kSoftmaxWarps)
softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                    int h, float scale) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int t = lane % LPR;
  const long long row =
      ((long long)blockIdx.x * kSoftmaxWarps + (threadIdx.x >> 5)) * RPW +
      lane / LPR;
  const bool live = row < n;  // dead lanes still join the shuffles
  const long long r0 = live ? row * h : 0;
  float v[CH * W];
  softmax_load<T, W, CH, LPR>(x + r0, h, t, live, scale, v);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < CH * W; ++i) m = fmaxf(m, v[i]);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = softmax_exp(v, m);
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const float r = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < CH * W; ++i) v[i] *= r;
  softmax_store<T, W, CH, LPR>(y + r0, h, t, live, v);
}

template <bool MAX, int THREADS>
__device__ float softmax_block_reduce(float v, float* sh) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) v = MAX ? fmaxf(v, sh[i]) : v + sh[i];
  __syncthreads();
  return v;
}

// one block a row, held in registers (CH groups of W a thread): rows
// wider than a warp holds, up to kSoftmaxWideThreads * kSoftmaxMaxValues
template <typename T, int W, int CH>
__global__ void __launch_bounds__(kSoftmaxWideThreads)
softmax_wide_kernel(const T* __restrict__ x, T* __restrict__ y, int h,
                    float scale) {
  __shared__ float sh[kSoftmaxWideThreads / 32];
  const long long r0 = (long long)blockIdx.x * h;
  float v[CH * W];
  softmax_load<T, W, CH, kSoftmaxWideThreads>(x + r0, h, threadIdx.x, true,
                                              scale, v);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < CH * W; ++i) m = fmaxf(m, v[i]);
  m = softmax_block_reduce<true, kSoftmaxWideThreads>(m, sh);
  const float s =
      softmax_block_reduce<false, kSoftmaxWideThreads>(softmax_exp(v, m), sh);
  const float r = __frcp_rn(s);
#pragma unroll
  for (int i = 0; i < CH * W; ++i) v[i] *= r;
  softmax_store<T, W, CH, kSoftmaxWideThreads>(y + r0, h, threadIdx.x, true,
                                               v);
}

constexpr int kSoftmaxThreads = 256;

// one block a row and three passes over it in device memory: rows wider
// than the wide kernel holds
template <typename T>
__global__ void __launch_bounds__(kSoftmaxThreads)
softmax_block_kernel(const T* __restrict__ x, T* __restrict__ y, int h,
                     float scale) {
  __shared__ float sh[kSoftmaxThreads / 32];
  const T* xr = x + (long long)blockIdx.x * h;
  T* yr = y + (long long)blockIdx.x * h;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < h; c += kSoftmaxThreads)
    m = fmaxf(m, __fmul_rn(to_f(xr[c]), scale));
  m = softmax_block_reduce<true, kSoftmaxThreads>(m, sh);
  float s = 0.f;
  for (int c = threadIdx.x; c < h; c += kSoftmaxThreads)
    s += expf(__fsub_rn(__fmul_rn(to_f(xr[c]), scale), m));
  s = softmax_block_reduce<false, kSoftmaxThreads>(s, sh);
  for (int c = threadIdx.x; c < h; c += kSoftmaxThreads)
    yr[c] = from_f<T>(
        __fdiv_rn(expf(__fsub_rn(__fmul_rn(to_f(xr[c]), scale), m)), s));
}

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

template <typename T, int W, int LPR, int CH>
cudaError_t launch_rows(const T* x, T* y, long long n, int h, float scale,
                        cudaStream_t s) {
  constexpr long long rows_per_block = kSoftmaxWarps * (32 / LPR);
  const unsigned blocks =
      (unsigned)((n + rows_per_block - 1) / rows_per_block);
  softmax_rows_kernel<T, W, LPR, CH><<<blocks, 32 * kSoftmaxWarps, 0, s>>>(
      x, y, n, h, scale);
  return cudaGetLastError();
}

// rows up to 32 * kSoftmaxMaxValues wide: LPR lanes a row for rows of
// fewer than 32 groups of W, else 32 lanes and CH groups a lane
template <typename T, int W>
cudaError_t dispatch_rows(const T* x, T* y, long long n, int h, float scale,
                          cudaStream_t s) {
  const int groups = h / W;  // W divides h
  if (groups <= 16) {
    switch (pow2_at_least(groups)) {
      case 1: return launch_rows<T, W, 1, 1>(x, y, n, h, scale, s);
      case 2: return launch_rows<T, W, 2, 1>(x, y, n, h, scale, s);
      case 4: return launch_rows<T, W, 4, 1>(x, y, n, h, scale, s);
      case 8: return launch_rows<T, W, 8, 1>(x, y, n, h, scale, s);
      default: return launch_rows<T, W, 16, 1>(x, y, n, h, scale, s);
    }
  }
  switch (pow2_at_least((groups + 31) / 32)) {
    case 1: return launch_rows<T, W, 32, 1>(x, y, n, h, scale, s);
    case 2: return launch_rows<T, W, 32, 2>(x, y, n, h, scale, s);
    case 4: return launch_rows<T, W, 32, 4>(x, y, n, h, scale, s);
    case 8: return launch_rows<T, W, 32, 8>(x, y, n, h, scale, s);
    case 16:
      if constexpr (16 * W <= kSoftmaxMaxValues)
        return launch_rows<T, W, 32, 16>(x, y, n, h, scale, s);
      break;
    case 32:
      if constexpr (32 * W <= kSoftmaxMaxValues)
        return launch_rows<T, W, 32, 32>(x, y, n, h, scale, s);
      break;
    case 64:
      if constexpr (64 * W <= kSoftmaxMaxValues)
        return launch_rows<T, W, 32, 64>(x, y, n, h, scale, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T, int W, int CH>
cudaError_t launch_wide(const T* x, T* y, long long n, int h, float scale,
                        cudaStream_t s) {
  softmax_wide_kernel<T, W, CH><<<(unsigned)n, kSoftmaxWideThreads, 0, s>>>(
      x, y, h, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_softmax(const void* x, void* y, long long n, int h,
                           float scale, cudaStream_t s) {
  constexpr int VW = VecWidth<T>::N;
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  // 16-byte vectors where every row is whole vectors and both buffers are
  // aligned (a view offset by an element is not): else one element a load
  const bool vec = h % VW == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (h <= 32 * kSoftmaxMaxValues)
    return vec ? dispatch_rows<T, VW>(xx, yy, n, h, scale, s)
               : dispatch_rows<T, 1>(xx, yy, n, h, scale, s);
  if (vec && h <= kSoftmaxWideThreads * kSoftmaxMaxValues) {
    switch (pow2_at_least((h / VW + kSoftmaxWideThreads - 1) /
                          kSoftmaxWideThreads)) {
      case 1: return launch_wide<T, VW, 1>(xx, yy, n, h, scale, s);
      case 2: return launch_wide<T, VW, 2>(xx, yy, n, h, scale, s);
      case 4: return launch_wide<T, VW, 4>(xx, yy, n, h, scale, s);
      case 8: return launch_wide<T, VW, 8>(xx, yy, n, h, scale, s);
      case 16:
        if constexpr (16 * VW <= kSoftmaxMaxValues)
          return launch_wide<T, VW, 16>(xx, yy, n, h, scale, s);
        break;
    }
    return cudaErrorInvalidValue;
  }
  softmax_block_kernel<T><<<(unsigned)n, kSoftmaxThreads, 0, s>>>(xx, yy, h,
                                                                  scale);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, h] row-major; gamma, beta: [h]; all of one type (dtype 0 =
// fp32, 1 = bf16). mu, rstd: fp32 [n]. vec = 1 when h is a multiple of the
// 16-byte vector and every buffer is 16-byte aligned. h <= 2048.
extern "C" int ds_ln_fwd(const void* x, const void* gamma, const void* beta,
                         void* y, float* mu, float* rstd, long long n, int h,
                         float eps, int dtype, int vec, void* stream) {
  const int npl = npl_for(h);
  if (n <= 0 || h <= 0 || npl == 0 || !vec_ok(dtype, h, vec))
    return cudaErrorInvalidValue;
  return dispatch<Fwd>(dtype, npl, vec, x, gamma, beta, y, mu, rstd, n, h,
                       eps, static_cast<cudaStream_t>(stream));
}

// dx from x, gamma, the forward's mu and rstd, and dy; the layouts and
// types of ds_ln_fwd (dx like x).
extern "C" int ds_ln_bwd(const void* x, const void* gamma, const float* mu,
                         const float* rstd, const void* dy, void* dx,
                         long long n, int h, int dtype, int vec,
                         void* stream) {
  const int npl = npl_for(h);
  if (n <= 0 || h <= 0 || npl == 0 || !vec_ok(dtype, h, vec))
    return cudaErrorInvalidValue;
  return dispatch<Bwd>(dtype, npl, vec, x, gamma, mu, rstd, dy, dx, n, h,
                       static_cast<cudaStream_t>(stream));
}

// y = gelu_tanh(x + bias[col]) over x [total / h, h]; bias [h]; one type
// (dtype 0 = fp32, 1 = bf16); vec as for ds_ln_fwd.
extern "C" int ds_bias_gelu(const void* x, const void* bias, void* y,
                            long long total, int h, int dtype, int vec,
                            void* stream) {
  if (total <= 0 || h <= 0 || total % h != 0 || !vec_ok(dtype, h, vec))
    return cudaErrorInvalidValue;
  const int w = vec ? (dtype == 0 ? 4 : 8) : 1;
  const int threads = 256;
  const long long need = (total / w + threads - 1) / threads;
  // a few waves over the 132 SMs; the grid-stride loop covers the rest
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* xx = static_cast<const float*>(x);
    const float* bb = static_cast<const float*>(bias);
    float* yy = static_cast<float*>(y);
    if (vec)
      bias_gelu_kernel<float, true><<<blocks, threads, 0, s>>>(xx, bb, yy,
                                                               total, h);
    else
      bias_gelu_kernel<float, false><<<blocks, threads, 0, s>>>(xx, bb, yy,
                                                                total, h);
  } else if (dtype == 1) {
    const __nv_bfloat16* xx = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(bias);
    __nv_bfloat16* yy = static_cast<__nv_bfloat16*>(y);
    if (vec)
      bias_gelu_kernel<__nv_bfloat16, true><<<blocks, threads, 0, s>>>(
          xx, bb, yy, total, h);
    else
      bias_gelu_kernel<__nv_bfloat16, false><<<blocks, threads, 0, s>>>(
          xx, bb, yy, total, h);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


// y = softmax(x * scale) over the last dim of x [n, h] (row-major); x and
// y of one type: dtype 0 = fp32, 1 = bf16, 2 = fp16. n < 2^31.
extern "C" int ds_softmax(const void* x, void* y, long long n, int h,
                          float scale, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_softmax<float>(x, y, n, h, scale, s);
  if (dtype == 1) return launch_softmax<__nv_bfloat16>(x, y, n, h, scale, s);
  if (dtype == 2) return launch_softmax<__half>(x, y, n, h, scale, s);
  return cudaErrorInvalidValue;
}
