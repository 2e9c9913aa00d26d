// Pieces shared by the attention kernels (flash_fwd.cu, flash_bwd.cu,
// sparse_attention.cu): strides of a [B, H, S, D] view, the masking value,
// the bf16 tensor-core helpers (mma.sync m16n8k16, fp32 accumulation; the
// sparse forward's fragment loads from global and padded shared tiles),
// and the fp32 row helpers.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 "col" (stored N x K): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8: c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// So two neighbouring C tiles (n-tiles 2kk, 2kk+1) of a product become the
// A fragment of k-step kk of the next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the JAX kernels' masking value

struct Strides {  // element strides of a [B, H, S, D] view (D contiguous)
  long long b, h, s;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragment from a shared-memory tile stored N x K (row n, k contiguous):
// rows n0 + g, k elements k0 + 2t (+1) and k0 + 2t + 8 (+9)
__device__ __forceinline__ void load_b_frag(uint32_t b[2], const bf16* tile,
                                            int row_stride, int n0, int k0,
                                            int g, int t) {
  const bf16* p = tile + (n0 + g) * row_stride + k0 + t * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// A fragments of a 16-row slab of a [S, D] bf16 matrix in global memory,
// rows r0 and r0 + 8 (zeros past `rows` live rows or `D` columns)
template <int NQ>
__device__ __forceinline__ void load_a_frags(uint32_t a[NQ][4], const bf16* base,
                                             long long row_stride, int r0,
                                             int rows, int D, int t) {
#pragma unroll
  for (int kk = 0; kk < NQ; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int r = (reg & 1) ? r0 + 8 : r0;
      const int c = kk * 16 + t * 2 + ((reg & 2) ? 8 : 0);
      float lo = 0.f, hi = 0.f;
      if (r < rows) {
        if (c < D) lo = __bfloat162float(base[r * row_stride + c]);
        if (c + 1 < D) hi = __bfloat162float(base[r * row_stride + c + 1]);
      }
      a[kk][reg] = pack_bf16(lo, hi);
    }
  }
}

// 8 consecutive bf16 of a row from global memory (zeros past `n` live
// elements); `vec`: the 8 are whole and 16-byte aligned.
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, int n, bool vec) {
  if (vec && n >= 8) return *reinterpret_cast<const uint4*>(p);
  uint4 out;
  uint16_t* e = reinterpret_cast<uint16_t*>(&out);
  const uint16_t* src = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < n ? src[i] : 0;
  return out;
}

// ------------------------------------------------------------ fp32 rows
// The fp32 kernels give four neighbouring threads (t = 0..3) one row each
// and split the head dim as float4 groups interleaved by 16.

// `NV` float4 groups of row `r` (head dim interleaved by 16 over the 4
// threads of the row), zeros past `rows` or D
template <int NV>
__device__ __forceinline__ void load_row_f32(float4 x[NV], const float* base,
                                             long long stride, int r, int rows,
                                             int D, int t) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * i + 4 * t + c;
      e[c] = (r < rows && d < D) ? base[r * stride + d] : 0.f;
    }
    x[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

template <int DP>
__device__ __forceinline__ void stage_f32(float4* tile, const float* src,
                                          long long stride, int rows, int n,
                                          int D) {
  float* out = reinterpret_cast<float*>(tile);
  for (int idx = threadIdx.x; idx < n * DP; idx += blockDim.x) {
    const int j = idx / DP, d = idx % DP;
    out[idx] = (j < rows && d < D) ? src[j * stride + d] : 0.f;
  }
}

template <int NV>
__device__ __forceinline__ float dot4(const float4 x[NV], const float4* y,
                                      int t) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 w = y[4 * i + t];
    part += x[i].x * w.x + x[i].y * w.y + x[i].z * w.z + x[i].w * w.w;
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

template <int NV>
__device__ __forceinline__ void axpy4(float4 acc[NV], float c, const float4* y,
                                      int t) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 w = y[4 * i + t];
    acc[i].x += c * w.x; acc[i].y += c * w.y;
    acc[i].z += c * w.z; acc[i].w += c * w.w;
  }
}

template <int NV>
__device__ __forceinline__ void store_row_f32(float* base, long long stride,
                                              int r, int D, int t,
                                              const float4 x[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float e[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 16 * i + 4 * t + c;
      if (d < D) base[r * stride + d] = e[c];
    }
  }
}

}  // namespace flash
