// Grouped fake-quantization (MoQ) for Hopper (sm_90a): every tensor of a
// MoQ step in one call.
//
// Replaces the Pallas TPU kernel `_quant_kernel` of
// deepspeed_tpu/ops/quantizer/quantizer.py:68 (pallas_call at :106): a
// tensor is viewed as [groups, L] rows in the reference (flax) layout; each
// row gets one scale, symmetric (absmax / qmax, levels -qmax-1 .. qmax) or
// asymmetric (min/max affine, levels 0 .. 2^bits - 1); every element is
// rounded (to nearest even, or stochastically: floor(q + u)) and at once
// dequantized, in the input's dtype. The arithmetic is the reference's
// `_quantize_rows` (quantizer.py:40-65) in fp32 with round-to-nearest
// intrinsics and no contracted multiply-adds, so the result equals the
// plain PyTorch version bit for bit.
//
// Bound on the H100: memory. Each element must be read once and written
// once: BERT-large's 100 quantized fp32 masters (334.9 M elements) move
// 2.68 GB a MoQ step, 0.80 ms at 3.35 TB/s.
//
// Design. A row spans up to millions of elements (the word embeddings:
// 3.9 M a group at groups 8) and Hopper's blocks share nothing, so a group
// is cut into chunks of kChunk elements; the scale needs every chunk's
// statistics before any chunk is rounded. One call takes a table of up to
// kMaxTensors tensors by value in the kernels' parameters (pointers,
// group length, the transposed view, bits and seed per tensor), so a MoQ
// step is one call for all its masters, and two launches of a block a
// chunk:
//  1. `quant_stats_multi`: each chunk's absmax (or min and max) into a
//     partial buffer, then a ticket on the group's arrival counter; the
//     block that takes the last ticket reduces the group's partials in
//     chunk order (deterministic), writes the scale and resets the
//     counter to 0, so every call finds it so (the call can be captured);
//  2. `quant_apply_multi`: each chunk rounded with its group's scale, last
//     chunk first (the first launch's tail may still lie in L2).
// Each element is read twice from HBM (12 bytes an fp32 element where 8
// are needed): 91% of that traffic's bound on an H100 80GB HBM3 at 700 W.
// Every single-launch form that read each element once measured level or
// slower there (PERF.md): a cooperative launch re-reading chunks
// from L2 in windows of whole groups, and one holding each chunk in
// registers or in shared memory from its statistics to its rounding; in
// each, a chunk's fence, ticket and wait for its group cost about what the
// second read saves. Each thread issues the loads of kUnroll vectors
// before it uses any.
// Layouts. A plain entry's group g is elements [g L, (g+1) L) of its
// buffer. A transposed entry is a buffer [R, C] whose reference layout is
// its transpose [C, R] (the port stores dense weights [out, in], flax
// [in, out]); with C % groups == 0 group g is the column strip [0, R) x
// [g w, (g+1) w), w = C / groups, walked row by row so the loads stay
// coalesced, with row and column counters (no division in the loop).
// Lanes read 16-byte vectors (4 fp32 or 8 bf16) when the entry's group or
// strip width is a multiple of the vector and its buffers are aligned,
// else single elements.
// Stochastic rounding draws one Philox4x32-10 word an element, keyed by
// the tensor's 64-bit seed, with the element's index in the reference
// layout as the counter; the noise is (word >> 8) 2^-24, the TPU kernel's
// 24-bit form. NaN inputs are out of scope: fmaxf/fminf drop them from the
// scale.
//
// Plain C interface (loaded with ctypes); the function returns the
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;      // elements of one group a chunk
constexpr int kUnroll = 4;         // vectors a thread loads before it uses them
constexpr int kMaxTensors = 320;   // the table stays well within 32 KB

enum { kBf16 = 1, kTransposed = 2, kVec = 4 };  // Entry::flags

struct Entry {
  const void* x;
  void* y;
  unsigned long long seed;
  long long L;     // elements a group
  long long R, C;  // transposed: the buffer [R, C]
  int w;           // transposed: the strip width C / groups
  int chunk0;      // the entry's first chunk in the launch
  int cpg;         // chunks a group
  int group0;      // the entry's first group in the launch
  float qmax;
  int flags;
};

struct Table {
  Entry e[kMaxTensors];
  int n;
  int chunks, groups;  // in the call
  float* partial;      // [2, chunks] absmax or min | max of each chunk
  float* scale;        // [2, groups] scale | lo of each group
  int* count;          // [groups] arrivals
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
__device__ __forceinline__ float block_reduce(float v, float* sh) {
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

// Chunk c of the launch: its entry, its group (in the entry and in the
// launch) and its elements [j0, j1) of the group.
struct Where {
  int ent, g, gg;
  long long j0, j1;
};

__device__ __forceinline__ Where locate(const Table& t, int c) {
  int lo = 0, hi = t.n - 1;  // the last entry whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.e[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  const Entry& e = t.e[lo];
  const int k = c - e.chunk0;
  Where w;
  w.ent = lo;
  w.g = k / e.cpg;
  w.gg = e.group0 + w.g;
  w.j0 = (long long)(k - w.g * e.cpg) * kChunk;
  w.j1 = min(e.L, w.j0 + kChunk);
  return w;
}

// This thread's vectors of elements [j0, j1) of group g, kUnroll at a
// time (their loads are all issued before any is used): the buffer offset
// and the reference index of each. A transposed strip [0, R) x [g w,
// (g+1) w) is walked with row and column counters (element j at (j / w,
// j % w); no division in the loop).
template <int W, bool TR>
struct Walk {
  static constexpr long long kStep = (long long)kThreads * W;
  long long j, j1, base, row, col, w, gw, drow, dcol, R, C;

  __device__ __forceinline__ Walk(const Entry& e, int g, long long j0,
                                  long long end)
      : j(j0 + (long long)threadIdx.x * W), j1(end), R(e.R), C(e.C) {
    base = (long long)g * e.L;
    if (TR) {
      w = e.w;
      gw = (long long)g * w;
      drow = kStep / w;
      dcol = kStep % w;
      row = j / w;
      col = j % w;
    }
  }

  // the next vectors: returns how many (0 at the end)
  __device__ __forceinline__ int next(long long (&p)[kUnroll],
                                      long long (&li)[kUnroll]) {
    int n = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j >= j1) break;
      if (TR) {
        p[u] = row * C + gw + col;
        li[u] = (gw + col) * R + row;
        row += drow;
        col += dcol;
        if (col >= w) {
          col -= w;
          ++row;
        }
      } else {
        p[u] = li[u] = base + j;
      }
      j += kStep;
      ++n;
    }
    return n;
  }
};

template <typename T, int W, bool TR, bool SYM>
__device__ __forceinline__ void chunk_stats(const Entry& e, const Where& w,
                                            float& lo, float& hi) {
  const T* x = static_cast<const T*>(e.x);
  Walk<W, TR> walk(e, w.g, w.j0, w.j1);
  long long p[kUnroll], li[kUnroll];
  for (int n; (n = walk.next(p, li)) > 0;) {
    float v[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n) load_n<T, W>(x + p[u], v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u >= n) break;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (SYM) {
          lo = fmaxf(lo, fabsf(v[u][i]));
        } else {
          lo = fminf(lo, v[u][i]);
          hi = fmaxf(hi, v[u][i]);
        }
      }
    }
  }
}

// Fake-quantize one vector's W values in place, as the reference does:
// li is the reference index of its first element, ls the reference
// stride between its elements (the Philox counters).
template <int W, bool SYM, bool SR>
__device__ __forceinline__ void round_vector(float (&v)[W], float scale,
                                             float lo, float qmax, float qlo,
                                             long long li, long long ls,
                                             unsigned long long seed) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float q = SYM ? __fdiv_rn(v[i], scale)
                  : __fdiv_rn(__fsub_rn(v[i], lo), scale);
    if (SR) {
      const uint32_t word =
          philox_word((unsigned long long)(li + i * ls), seed);
      const float r = (float)(word >> 8) * (1.f / 16777216.f);
      q = floorf(__fadd_rn(q, r));
    } else {
      q = rintf(q);  // half to even, as jnp.round
    }
    q = q < qlo ? qlo : (q > qmax ? qmax : q);  // NaN passes, as jnp.clip
    v[i] = SYM ? __fmul_rn(q, scale) : __fadd_rn(__fmul_rn(q, scale), lo);
  }
}

template <typename T, int W, bool TR, bool SYM, bool SR>
__device__ __forceinline__ void chunk_apply(const Entry& e, const Where& w,
                                            float scale, float lo) {
  const T* x = static_cast<const T*>(e.x);
  T* y = static_cast<T*>(e.y);
  const float qmax = e.qmax, qlo = SYM ? -qmax - 1.f : 0.f;
  const long long ls = TR ? e.R : 1;  // reference stride in a vector
  Walk<W, TR> walk(e, w.g, w.j0, w.j1);
  long long p[kUnroll], li[kUnroll];
  for (int n; (n = walk.next(p, li)) > 0;) {
    float v[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < n) load_n<T, W>(x + p[u], v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u >= n) break;
      round_vector<W, SYM, SR>(v[u], scale, lo, qmax, qlo, li[u], ls,
                               e.seed);
      store_n<T, W>(y + p[u], v[u]);
    }
  }
}

// the entry's dtype, vector width and layout, uniform over the block
template <bool SYM>
__device__ void stats_any(const Entry& e, const Where& w, float& lo,
                          float& hi) {
  typedef __nv_bfloat16 bf;
  const bool tr = e.flags & kTransposed, vec = e.flags & kVec;
  if (e.flags & kBf16) {
    if (vec && tr) chunk_stats<bf, 8, true, SYM>(e, w, lo, hi);
    else if (vec) chunk_stats<bf, 8, false, SYM>(e, w, lo, hi);
    else if (tr) chunk_stats<bf, 1, true, SYM>(e, w, lo, hi);
    else chunk_stats<bf, 1, false, SYM>(e, w, lo, hi);
  } else {
    if (vec && tr) chunk_stats<float, 4, true, SYM>(e, w, lo, hi);
    else if (vec) chunk_stats<float, 4, false, SYM>(e, w, lo, hi);
    else if (tr) chunk_stats<float, 1, true, SYM>(e, w, lo, hi);
    else chunk_stats<float, 1, false, SYM>(e, w, lo, hi);
  }
}

template <bool SYM, bool SR>
__device__ void apply_any(const Entry& e, const Where& w, float scale,
                          float lo) {
  typedef __nv_bfloat16 bf;
  const bool tr = e.flags & kTransposed, vec = e.flags & kVec;
  if (e.flags & kBf16) {
    if (vec && tr) chunk_apply<bf, 8, true, SYM, SR>(e, w, scale, lo);
    else if (vec) chunk_apply<bf, 8, false, SYM, SR>(e, w, scale, lo);
    else if (tr) chunk_apply<bf, 1, true, SYM, SR>(e, w, scale, lo);
    else chunk_apply<bf, 1, false, SYM, SR>(e, w, scale, lo);
  } else {
    if (vec && tr) chunk_apply<float, 4, true, SYM, SR>(e, w, scale, lo);
    else if (vec) chunk_apply<float, 4, false, SYM, SR>(e, w, scale, lo);
    else if (tr) chunk_apply<float, 1, true, SYM, SR>(e, w, scale, lo);
    else chunk_apply<float, 1, false, SYM, SR>(e, w, scale, lo);
  }
}

struct Shared {
  float red[kThreads / 32];
  int last;
};

// The scale of chunk w's group (and its minimum, asymmetric): its
// partials reduced by the block in chunk order, for every thread.
template <bool SYM>
__device__ __forceinline__ void group_scale(const Table& t, const Entry& e,
                                            const Where& w, Shared& sh,
                                            float& scale, float& lo) {
  const int c0 = e.chunk0 + w.g * e.cpg;  // the group's first chunk
  float a = SYM ? 0.f : INFINITY, b = -INFINITY;
  for (int k = threadIdx.x; k < e.cpg; k += kThreads) {
    if (SYM) {
      a = fmaxf(a, __ldcg(t.partial + c0 + k));
    } else {
      a = fminf(a, __ldcg(t.partial + c0 + k));
      b = fmaxf(b, __ldcg(t.partial + t.chunks + c0 + k));
    }
  }
  if (SYM) {
    a = block_reduce<true>(a, sh.red);
    scale = __fdiv_rn(a, e.qmax);
    lo = 0.f;
  } else {
    a = block_reduce<false>(a, sh.red);
    b = block_reduce<true>(b, sh.red);
    scale = __fdiv_rn(__fsub_rn(b, a), e.qmax);
    lo = a;
  }
  if (scale == 0.f) scale = 1.f;
}

// Chunk blockIdx.x's statistics into the partial buffer, then a ticket on
// its group's arrival counter: the last arrival reduces the group's
// partials, writes its scale and resets the counter.
template <bool SYM>
__global__ void __launch_bounds__(kThreads)
quant_stats_multi(const __grid_constant__ Table t) {
  __shared__ Shared sh;
  const int c = blockIdx.x;
  const Where w = locate(t, c);
  const Entry& e = t.e[w.ent];
  float lo = SYM ? 0.f : INFINITY, hi = -INFINITY;
  stats_any<SYM>(e, w, lo, hi);
  if (SYM) {
    lo = block_reduce<true>(lo, sh.red);
  } else {
    lo = block_reduce<false>(lo, sh.red);
    hi = block_reduce<true>(hi, sh.red);
  }
  if (threadIdx.x == 0) {
    t.partial[c] = lo;
    if (!SYM) t.partial[t.chunks + c] = hi;
    __threadfence();  // the partial before the ticket
    sh.last = atomicAdd(t.count + w.gg, 1) == e.cpg - 1;
  }
  __syncthreads();
  if (!sh.last) return;  // uniform over the block
  __threadfence();
  float scale, lo0;
  group_scale<SYM>(t, e, w, sh, scale, lo0);
  if (threadIdx.x == 0) {
    t.scale[w.gg] = scale;
    t.scale[t.groups + w.gg] = lo0;
    t.count[w.gg] = 0;  // every arrival is in
  }
}

// One chunk's rounding with its group's scale, the last chunk first.
template <bool SYM, bool SR>
__global__ void __launch_bounds__(kThreads)
quant_apply_multi(const __grid_constant__ Table t) {
  const Where w = locate(t, t.chunks - 1 - blockIdx.x);
  apply_any<SYM, SR>(t.e[w.ent], w, __ldg(t.scale + w.gg),
                     __ldg(t.scale + t.groups + w.gg));
}

template <bool SYM, bool SR>
cudaError_t launch(const Table& t, cudaStream_t s) {
  quant_stats_multi<SYM><<<t.chunks, kThreads, 0, s>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quant_apply_multi<SYM, SR><<<t.chunks, kThreads, 0, s>>>(t);
  return cudaGetLastError();
}

}  // namespace

// One call (two launches) fake-quantizing n_tensors tensors. table: host
// int64 [n_tensors, 9] = (x, y, n, groups, R, C, bits, flags, seed) a
// tensor: y = fake-quantized x (y may be x) of n > 0 elements viewed as
// `groups` rows in the reference layout; flags bit 0: bf16 (else fp32),
// bit 1: transposed (the buffer is [R, C], R * C = n, C % groups == 0; R
// and C are ignored otherwise), bit 2: 16-byte vectors (the group or
// strip width is a multiple of the vector, x and y 16-byte aligned); bits
// 1..16; seed keys the tensor's Philox noise. Chunks of kChunk elements a
// group are numbered tensor by tensor: `chunks` and `groups` are the
// call's totals. partial: device fp32 [2 chunks]; scale: device fp32 [2
// groups]; count: device int32 [groups], all 0 on the first call (each
// call leaves them at 0). 1 <= n_tensors <= kMaxTensors (320).
extern "C" int ds_quantize_multi(const long long* table, int n_tensors,
                                 float* partial, float* scale, int* count,
                                 int chunks, int groups, int symmetric,
                                 int stochastic, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return cudaErrorInvalidValue;
  Table t;
  long long n_chunks = 0, n_groups = 0;
  for (int i = 0; i < n_tensors; ++i) {
    const long long* r = table + 9 * i;
    const long long n = r[2], g = r[3], bits = r[6], flags = r[7];
    if (n <= 0 || g <= 0 || n % g != 0 || bits < 1 || bits > 16 ||
        (flags & ~7ll) != 0)
      return cudaErrorInvalidValue;
    Entry& e = t.e[i];
    e.x = reinterpret_cast<const void*>(r[0]);
    e.y = reinterpret_cast<void*>(r[1]);
    e.L = n / g;
    e.R = r[4];
    e.C = r[5];
    e.w = 1;
    e.flags = (int)flags;
    if (flags & kTransposed) {
      if (e.R <= 0 || e.C <= 0 || e.R * e.C != n || e.C % g != 0 ||
          e.C / g > 0x7fffffffll)
        return cudaErrorInvalidValue;
      e.w = (int)(e.C / g);
    }
    if (flags & kVec) {
      const long long width = (flags & kTransposed) ? e.w : e.L;
      if (width % ((flags & kBf16) ? 8 : 4) != 0 ||
          reinterpret_cast<uintptr_t>(e.x) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(e.y) % 16 != 0)
        return cudaErrorInvalidValue;
    }
    e.seed = (unsigned long long)r[8];
    e.qmax = symmetric ? (float)((1 << (bits - 1)) - 1)
                       : (float)((1 << bits) - 1);
    e.cpg = (int)((e.L + kChunk - 1) / kChunk);
    e.chunk0 = (int)n_chunks;
    e.group0 = (int)n_groups;
    n_chunks += g * e.cpg;
    n_groups += g;
    if (n_chunks > 0x7fffffffll || n_groups > 0x7fffffffll)
      return cudaErrorInvalidValue;
  }
  if (n_chunks != chunks || n_groups != groups) return cudaErrorInvalidValue;
  t.n = n_tensors;
  t.chunks = chunks;
  t.groups = groups;
  t.partial = partial;
  t.scale = scale;
  t.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (symmetric)
    return stochastic ? launch<true, true>(t, s) : launch<true, false>(t, s);
  return stochastic ? launch<false, true>(t, s) : launch<false, false>(t, s);
}
