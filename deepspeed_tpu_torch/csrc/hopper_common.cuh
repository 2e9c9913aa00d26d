// Hopper (sm_90a) building blocks of the redesigned attention kernels
// (flash_fwd.cu, flash_bwd.cu, the bf16 kernels of
// sparse_attention.cu): asynchronous 16- and 4-byte copies into
// shared memory (cp.async, zero fill past the live bytes) with their
// commit/wait groups, the swizzled layout of a [rows, DP] bf16 tile,
// ldmatrix fragment loads, plain and transposed, warpgroup MMA (wgmma:
// matrix descriptors, fences, m64n16/32/64k16 with A from registers),
// exp2, and the bf16 row store of an accumulator.
//
// Swizzle. A tile row of DP bf16 is DP / 8 chunks of 16 bytes, stored
// without padding; chunk c of row r lands at chunk position swz(r, c) of
// the tile. The XOR spreads the 8 consecutive rows that one ldmatrix
// matrix reads (one chunk column) over 8 distinct 16-byte bank groups:
// at DP 64 (128-byte rows) it is the 128-byte swizzle TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads; at DP 32 and 16, where 2
// or 4 rows share a 128-byte line, the XOR takes the row bits above those:
// the 64- and 32-byte swizzles. At DP 128 it is the 128-byte pattern on
// each 128-byte half row, which ldmatrix reads without conflicts but no
// wgmma descriptor describes.
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4; layouts in
// flash_common.cuh). ldmatrix.x4 loads four 8 x 8 matrices, lane l giving
// the address of row l % 8 of matrix l / 8; each thread receives row g,
// columns 2t and 2t + 1 of each (with .trans: row 2t and 2t + 1, column
// g). So, for tiles stored row-major in shared memory:
//   ldsm_a  A (16 rows x 16 k, k contiguous): matrices (rows 0-7, k 0-7),
//           (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15);
//   ldsm_b  B of two n-tiles from an [N, K] tile (k contiguous, the "col"
//           operand as stored): (n 0-7, k 0-7), (n 0-7, k 8-15),
//           (n 8-15, k 0-7), (n 8-15, k 8-15) -> b0 b1 of each n-tile;
//   ldsm_bt B of two n-tiles from a [K, N] tile (n contiguous), .trans:
//           (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
//           (k 8-15, n 8-15).
// ldsm_bt reads K^T, Q^T and dO^T from the row-major tiles themselves, so
// no transposed copy is ever written.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// chunk position of chunk c (8 bf16) of row r in a swizzled [rows, DP] tile
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int NC = DP / 8;
  static_assert(NC == 2 || NC == 4 || NC % 8 == 0, "DP: 16, 32 or 64k");
  if constexpr (NC >= 8) {
    return r * NC + (c ^ (r & 7));
  } else if constexpr (NC == 4) {
    return r * 4 + (c ^ ((r >> 1) & 3));
  } else {
    return r * 2 + (c ^ ((r >> 2) & 1));
  }
}

template <int DP>
__device__ __forceinline__ uint32_t tile_addr(const bf16* tile, int r, int c) {
  return smem_u32(tile + swz<DP>(r, c) * 8);
}

// 16 bytes global -> shared without the registers; bytes past src_bytes
// (0 or 16) are written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (zero when src_bytes is 0)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragments (NK k-steps over the head dim) of rows r0 .. r0 + 15 of a
// swizzled [*, DP] tile
template <int DP, int NK>
__device__ __forceinline__ void ldsm_a(uint32_t a[NK][4], const bf16* tile,
                                       int r0, int lane) {
  const int m = lane >> 3;
  const int r = r0 + (lane & 7) + ((m & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    ldsm_x4(a[kk], tile_addr<DP>(tile, r, 2 * kk + (m >> 1)));
}

// B fragments of the n-tiles of rows n0 .. n0 + 15 of an [N, DP] tile, at
// k-step kk of the head dim: b[0..1] n-tile n0 / 8, b[2..3] the next
template <int DP>
__device__ __forceinline__ void ldsm_b(uint32_t b[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  const int m = lane >> 3;
  ldsm_x4(b, tile_addr<DP>(tile, n0 + (lane & 7) + ((m >> 1) << 3),
                           2 * kk + (m & 1)));
}

// B fragments of head-dim n-tiles 2np and 2np + 1 at the k-step of rows
// k0 .. k0 + 15 of a [K, DP] tile, read transposed
template <int DP>
__device__ __forceinline__ void ldsm_bt(uint32_t b[4], const bf16* tile,
                                        int k0, int np, int lane) {
  const int m = lane >> 3;
  ldsm_x4_trans(b, tile_addr<DP>(tile, k0 + (lane & 7) + ((m & 1) << 3),
                                 2 * np + (m >> 1)));
}

// 8 bf16 of a row from global memory through the registers, zeros past
// the first n
__device__ __forceinline__ uint4 load8_sync(const bf16* p, int n) {
  uint4 out;
  uint16_t* e = reinterpret_cast<uint16_t*>(&out);
  const uint16_t* src = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < n ? src[i] : 0;
  return out;
}

// Stage rows row0 .. row0 + N - 1 of a [rows, D] bf16 view (row stride
// `stride` elements, D contiguous) into a swizzled [N, DP] tile, zeros past
// `rows` and past D. vec (D % 8 == 0, 16-byte aligned rows): 16-byte
// cp.async, in flight until the caller's commit and wait; else loads
// through the registers.
template <int DP, int N, int NT>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* src,
                                           long long stride, int row0,
                                           int rows, int D, bool vec) {
  constexpr int NC = DP / 8;
  for (int i = threadIdx.x; i < N * NC; i += NT) {
    const int r = i / NC, c = i % NC;
    const int row = row0 + r;
    const bool live = row < rows && c * 8 < D;
    const bf16* p = src + (long long)row * stride + c * 8;
    bf16* dst = tile + swz<DP>(r, c) * 8;
    if (vec)
      cp_async16(dst, live ? p : src, live ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) = load8_sync(p, live ? D - c * 8 : 0);
  }
}

// rows r0 and r0 + 8 of an [S, D] bf16 output from an m16n8 accumulator
template <int NO>
__device__ __forceinline__ void store_rows(bf16* out, long long stride,
                                           float acc[NO][4], int r0,
                                           int rows, int D, int t) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      const int c = n * 8 + t * 2;
      if (row >= rows || c >= D) continue;
      bf16* p = out + row * stride + c;
      if (D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
      } else {
        p[0] = __float2bfloat16(acc[n][2 * half]);
        if (c + 1 < D) p[1] = __float2bfloat16(acc[n][2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ wgmma
// Warpgroup MMA (sm_90a): four warps issue one asynchronous 64-row
// product; A from registers in the mma.sync A-fragment layout (warp w holds
// rows 16w .. 16w + 15), B from a swizzled tile in shared memory through a
// matrix descriptor, fp32 accumulators in the m16n8 C layout of each
// warp's 16 rows (d[i] = columns 8i .. 8i + 7).

// Descriptor of a swizzled tile whose rows are `row_bytes` (32, 64 or 128:
// the 32-, 64- or 128-byte swizzle of swz()) long. SBO: the stride between
// groups of 8 rows. K-major B (k contiguous in a row): the rows are the N
// dim; MN-major B (n contiguous, read transposed): the rows are the K dim.
// The tile must start on a 1024-byte boundary (offsets inside it move the
// start address only).
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile,
                                               int row_bytes) {
  const uint64_t mode = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t((8 * row_bytes) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of in-flight accumulators
// across the issue and the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}

// keep A registers of in-flight wgmmas alive and unchanged until the wait
template <int N>
__device__ __forceinline__ void hold_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// the products are warpgroup MMAs where the tile rows are a hardware
// swizzle (DP 16, 32, 64), mma.sync at DP 128
template <int DP>
__host__ __device__ constexpr bool use_wgmma() {
  return DP <= 64;
}

// make this thread's generic-proxy shared-memory writes (cp.async, st)
// visible to wgmma's async-proxy reads; then a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, fp32) += a (64 x 16, bf16 registers) * B (16 x N, shared);
// TRANS_B: B is MN-major (n contiguous: a row-major [K, N] tile)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                const uint32_t a[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4][4],
                                                const uint32_t a[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[2][4],
                                                const uint32_t a[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %13;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "n"(TRANS_B), "r"(1));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t a[4], uint64_t desc) {
  if constexpr (N == 64) {
    wgmma_m64n64k16<TRANS_B>(d, a, desc);
  } else if constexpr (N == 32) {
    wgmma_m64n32k16<TRANS_B>(d, a, desc);
  } else {
    static_assert(N == 16, "wgmma_rs: N 16, 32 or 64");
    wgmma_m64n16k16<TRANS_B>(d, a, desc);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper
