// Block-sparse flash attention for Hopper (sm_90a): forward, dq and dk/dv
// over lists of live 64 x 64 tiles.
//
// Replaces the Pallas TPU kernels of
// deepspeed_tpu/ops/sparse_attention/fused_kernels.py, `_fwd_kernel`
// (:192), `_dq_kernel` (:239) and `_dkv_kernel` (:279), which walk a
// flattened work list of live (q-tile, kv-tile) pairs, and of
// deepspeed_tpu/ops/sparse_attention/kernels.py, `_fwd_kernel` (:35),
// `_dq_kernel` (:88) and `_dkv_kernel` (:129), which sweep every block and
// predicate it on the layout. On this card one kernel family covers both:
// the host turns either layout into lists of live tile pairs.
//
// What they compute, per (batch*head), over the pairs of a layout:
//   s = q k^T * sm_scale, -1e30 where the pair's fine-block bit is 0, the
//       key lies past the sequence, or (on tiles of the real region, when
//       causal) the key lies after the query; then + bias[key];
//   forward: online softmax with the clamp p = 0 while a row's running max
//       is still -1e30 (a row whose live keys so far are all masked), out =
//       acc / l (l = 0 -> out = 0), lse = m + log(l) (-1e30 for a row with
//       no live key), exactly fused_kernels.py:214-236;
//   dq: delta = rowsum(do * o) - g_lse (written for dk/dv), p = exp(s -
//       lse) (0 where lse is -1e30), ds = p (do v^T - delta) sm_scale,
//       dq = ds k;
//   dk/dv: dv = p^T do, dk = ds^T q and, with a bias, the bias cotangent
//       dbias[key] = sum_rows p (dp - delta) before sm_scale
//       (fused_kernels.py:320-326). A CTA owns its key tile, so no atomics.
//
// Design against the TPU's: the TPU carries its accumulators in VMEM from
// one grid step to the next along a sequential work list with BEGIN/LIVE/
// END flags. Hopper blocks run in no order and share nothing, so each CTA
// owns one (batch*head, output tile) and loops over its own segment of a
// CSR list built once per layout on the host: `ptr` [H * n_out + 1]
// offsets, `idx` the streamed tile of each pair, `bits` a 64-bit word of
// fine-block liveness inside the pair (fine blocks of 8, 16 or 32 keys; a
// fine block of 64 or more is one bit). The forward and dq walk the
// row-major list (output = query tile), dk/dv the column-major one (output
// = key tile). An output tile with no pair writes zeros (lse -1e30), as the
// JAX dummy items and `l_safe` do.
//
// Bound on the H100: at the BERT-large path (B 4, H 16, S 2048, D 64, Fixed
// block 64 with 8 packed global columns, Skv 2560, 352 live 64 x 64 tiles
// a head, 92.3 M live (query, key) pairs) the forward does 4 D flops a
// pair (24 us at 989 TFLOP/s) against ~76 MB of q, o and the packed k, v
// (23 us at 3.35 TB/s); dq does 6 D (36 us), dk/dv 8 D (48 us), both
// above their bytes: the products set the pace. At the causal GPT-2
// path (B 2, S 4096, Skv 5504) the forward's bytes lead (24 us).
// * fp32 forward, dq and dk/dv: the first form. A row of four threads on
//   the FMA pipes (no TF32); streamed tiles are staged synchronously.
// * bf16 forward, dq and dk/dv: the flash kernels' design (flash_fwd.cu,
//   flash_bwd.cu) with the CSR walk in place of the dense kv / q loop. One
//   warpgroup owns a 64-row output tile; its own rows (q for the forward;
//   q, do and o for dq, which computes delta from them; k, v for dk/dv) are
//   staged once by cp.async and held as A fragments. The segment's streamed
//   tiles (K|V with the 64 bias values for the forward and dq; Q|dO with
//   their 64 lse and 64 delta values for dk/dv) come through a 3-stage
//   cp.async ring in dynamic shared memory, stored in the XOR swizzle of
//   hopper_common.cuh (no padding, no transposed copy). Every product is a
//   warpgroup MMA at D <= 64 (DP 16/32/64): s = q k^T and dp = do v^T
//   (dk/dv: s^T = k q^T, dp^T = v do^T) K-major, o += p v, dq += ds k,
//   dv += p^T do and dk += ds^T q through the transpose bit. The forward's
//   online softmax runs in the log2 domain: sm_scale log2e and the key
//   bias times log2e enter one fma, exp is ex2, lse = m ln2 + log(l).
// * Mask arithmetic runs only on the pairs the host flags (`flags`: the
//   fine-block word is not all-ones, a causal diagonal tile of the real
//   region, or the pair holds the key tail). The flag is read once a pair,
//   so the branch is uniform over the warpgroup; as in flash_bwd.cu it
//   picks one of two instantiations of the pair's work (fwd_pair, dq_pair,
//   dkv_pair with and without the mask). Keep it so: the pair's work
//   inlined into the loop, with the mask under a branch between the
//   wgmmas, compiled without a warning and gave wrong dq and dk/dv at DP 64
//   from a segment's second pair on. Query rows past Sq are zero-filled
//   (forward: not written; backward: lse +inf, p = 0).
// * Each grid walks its output tiles in `order` (segment length
//   descending, across heads; batch elements side by side), so no long
//   list starts in the last wave.
// * p is rounded to bf16 before p v and p^T do and ds before ds k and ds^T
//   q, where the JAX kernels cast (the row sums keep the fp32 p). The sums
//   run in a fixed order: outputs and gradients are bit-identical from run
//   to run.
//
// Plain C interface (loaded with ctypes); each entry point returns the
// cudaError_t of its launch.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2;
using hopper::hold_regs;
using hopper::kLog2e;
using hopper::ldsm_a;
using hopper::stage_tile;
using hopper::store_rows;
using hopper::wgmma_commit;
using hopper::wgmma_desc;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_wait;

constexpr int kT = 64;             // tile: query rows and keys
constexpr int kThreads = 128;      // bf16: one warpgroup a CTA
constexpr int kStages = 3;         // bf16: the ring of streamed tiles
constexpr int kTPR = 4;            // fp32: threads a row
constexpr int kThreads32 = kT * kTPR;
constexpr int kChunk = 16;         // fp32 forward: keys an online update
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void *q, *k, *v;
  void* o;
  const void* dout;
  float* lse;
  float* delta;        // written by dq, read by dk/dv
  void *dq, *dk, *dv;
  const float* bias;   // [B, Skv] additive key bias, or null
  float* dbias;        // [B*H, Skv] bias cotangent (dk/dv), or null
  const int* ptr;      // [H * n_out + 1] segment offsets
  const int* idx;      // streamed tile of each pair
  const unsigned long long* bits;  // fine-block bits of each pair
  const unsigned char* flags;      // bf16: 1 where a pair needs the mask
  const int* order;                // bf16: the segments, longest first
  const float* g_lse;              // dq: the lse cotangent [B*H, Sq], or null
  int B, H, Sq, Skv, D;
  int n_out;           // output tiles a (batch, head)
  int causal, causal_ntiles;
  int lf, nshift;      // log2(fine block), log2(fine blocks a tile edge)
  int vec;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float sm_scale;
  cudaStream_t stream;
};

// Liveness of (tile-local query row, tile-local key) in one pair
struct PairMask {
  unsigned long long bits;
  bool full, tri;
  int lf, nshift, q0, k0, Skv;

  __device__ __forceinline__ bool operator()(int rl, int cl) const {
    const int key = k0 + cl;
    if (key >= Skv) return false;
    if (tri && key > q0 + rl) return false;
    if (full) return true;
    return (bits >> (((rl >> lf) << nshift) + (cl >> lf))) & 1ull;
  }
};

__device__ __forceinline__ PairMask pair_mask(const Args& a, int e, int qt,
                                              int kt) {
  PairMask m;
  m.bits = a.bits[e];
  const int nb = 1 << (2 * a.nshift);  // fine blocks in a tile
  m.full = nb == 64 ? m.bits == ~0ull : m.bits == (1ull << nb) - 1ull;
  m.tri = a.causal && kt < a.causal_ntiles;
  m.lf = a.lf;
  m.nshift = a.nshift;
  m.q0 = qt * kT;
  m.k0 = kt * kT;
  m.Skv = a.Skv;
  return m;
}

template <typename T>
__device__ __forceinline__ const T* head(const void* p, const Strides& s,
                                         int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* head_out(void* p, const Strides& s, int b,
                                       int h) {
  return static_cast<T*>(p) + b * s.b + h * s.h;
}

// ------------------------------------------------------------ bf16: wgmma
// The forward, dq and dk/dv on the flash kernels' pieces (flash_fwd.cu,
// flash_bwd.cu): one warpgroup a CTA, a 3-stage cp.async ring of swizzled
// tiles, wgmma.

template <int DP>
constexpr int fwd_smem_bytes() {  // ring of K|V (q in its last stage) | bias
  return kStages * 2 * kT * DP * 2 + kStages * kT * 4;
}

template <int DP>
constexpr int dq_smem_bytes() {  // q, do | ring of K|V (o in its last stage) | bias
  return (2 * kT * DP + kStages * 2 * kT * DP) * 2 + kStages * kT * 4;
}

template <int DP>
constexpr int dkv_smem_bytes() {  // k, v | ring of Q|dO | lse, delta
  return (2 * kT * DP + kStages * 2 * kT * DP) * 2 + 2 * kStages * kT * 4;
}

// lse of a row for exp(): +inf (p = 0) for a row with no live key
__device__ __forceinline__ float row_lse(float l) {
  return l <= kNegInf * 0.5f ? INFINITY : l;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// the A fragment of k-step kk from two neighbouring m16n8 accumulator tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The grid: one CTA per (output tile, batch element), output tiles in
// `order` (longest segment first), batch elements side by side.
struct Cta {
  int b, h, tile, bh, e0, n;
};

__device__ __forceinline__ Cta cta_of(const Args& a) {
  Cta c;
  c.b = blockIdx.x % a.B;
  const int seg = a.order[blockIdx.x / a.B];
  c.h = seg / a.n_out;
  c.tile = seg % a.n_out;
  c.bh = c.b * a.H + c.h;
  c.e0 = a.ptr[seg];
  c.n = a.ptr[seg + 1] - c.e0;
  return c;
}

// One pair of the forward: s = q k^T, the online softmax in the log2
// domain (sm_scale log2e and bias log2e folded into one fma), o += p v.
// m0, m1: the running row maxima (log2 domain), l0, l1: this thread's
// parts of the row sums. MASK: as dq_pair; masked scores are -1e30, and a
// row whose live keys so far are all masked keeps its max at -1e30 and
// takes p = 0 (the clamp of fused_kernels.py:220).
template <int DP, bool MASK>
__device__ __forceinline__ void fwd_pair(
    float (&acc)[DP / 8][4], uint32_t (&qa)[DP / 16][4], const bf16* ks,
    const bf16* vs, const float* bias_t, const Args& a, int e, int it,
    int rl0, float scale2, float& m0, float& m1, float& l0, float& l1,
    int t) {
  constexpr int NK = DP / 16, NS = kT / 8, NO = DP / 8;
  float s[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_rs<kT, 0>(s, qa[kk], wgmma_desc(ks + kk * 16, DP * 2));
  wgmma_commit();
  wgmma_wait();
  hopper::reg_fence(s);
  PairMask pm;
  if (MASK) pm = pair_mask(a, e, it, a.idx[e]);
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    float2 bb = make_float2(0.f, 0.f);
    if (bias_t != nullptr)
      bb = *reinterpret_cast<const float2*>(bias_t + nt * 8 + 2 * t);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float y = fmaf(s[nt][x], scale2, ((x & 1) ? bb.y : bb.x) * kLog2e);
      if (MASK && !pm(x < 2 ? rl0 : rl0 + 8, nt * 8 + 2 * t + (x & 1)))
        y = kNegInf;
      s[nt][x] = y;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // 0 while the old max is -1e30; 1 for a row still dead (acc, l are 0)
  const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
  const bool dead0 = MASK && mx0 <= kNegInf * 0.5f;
  const bool dead1 = MASK && mx1 <= kNegInf * 0.5f;
  m0 = mx0;
  m1 = mx1;
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= alpha0; acc[n][1] *= alpha0;
    acc[n][2] *= alpha1; acc[n][3] *= alpha1;
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    s[nt][0] = dead0 ? 0.f : ex2(s[nt][0] - mx0);
    s[nt][1] = dead0 ? 0.f : ex2(s[nt][1] - mx0);
    s[nt][2] = dead1 ? 0.f : ex2(s[nt][2] - mx1);
    s[nt][3] = dead1 ? 0.f : ex2(s[nt][3] - mx1);
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
  // o += p v: p rounded to bf16 in the A fragments (l keeps the fp32 p),
  // v read through the transpose bit
  uint32_t pa[kT / 16][4];
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
    wgmma_rs<DP, 1>(acc, pa[kk], wgmma_desc(vs + kk * 16 * DP, DP * 2));
  wgmma_commit();
  wgmma_wait();
  hopper::reg_fence(acc);
  hold_regs(pa);
}

// The forward over the row-major list: o and lse of one query tile.
template <int DP>
// Four CTAs an SM (at most 128 registers): 10% faster than three at the
// BERT and GPT-2 paths (tests/perf/torch_sparse_fwd_quant_variants.py).
__global__ void __launch_bounds__(kThreads, 4) sparse_fwd_bf16(Args a) {
  constexpr int NK = DP / 16, NO = DP / 8;
  constexpr int TILE = kT * DP;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // kStages x [K tile | V tile]
  float* bias_r = reinterpret_cast<float*>(ring + kStages * 2 * TILE);
  bf16* q_s = ring + (kStages - 1) * 2 * TILE;  // free until the loop

  const Cta c = cta_of(a);
  const int b = c.b, h = c.h, it = c.tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int rl0 = warp * 16 + lane / 4;  // this thread's rows: rl0, rl0 + 8
  const int q0 = it * kT, r0 = q0 + rl0, r1 = r0 + 8;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const bool vec = a.vec;
  const bf16* kb = head<bf16>(a.k, a.ks, b, h);
  const bf16* vb = head<bf16>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  // pair j of the segment: its K and V tiles and the keys' bias
  auto stage_kv = [&](int j, int st) {
    const int k0 = a.idx[c.e0 + j] * kT;
    bf16* slot = ring + st * 2 * TILE;
    stage_tile<DP, kT, kThreads>(slot, kb, a.ks.s, k0, Skv, D, vec);
    stage_tile<DP, kT, kThreads>(slot + TILE, vb, a.vs.s, k0, Skv, D, vec);
    const int i = threadIdx.x;
    if (brow != nullptr && i < kT) {
      const bool live = k0 + i < Skv;
      cp_async4(bias_r + st * kT + i, live ? brow + k0 + i : brow,
                live ? 4 : 0);
    }
  };

  stage_tile<DP, kT, kThreads>(q_s, head<bf16>(a.q, a.qs, b, h), a.qs.s, q0,
                               Sq, D, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < c.n) stage_kv(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // q
  hopper::fence_async_smem();
  __syncthreads();

  uint32_t qa[NK][4];
  ldsm_a<DP, NK>(qa, q_s, warp * 16, lane);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale2 = a.sm_scale * kLog2e;

  int slot = 0;
  for (int j = 0; j < c.n; ++j) {
    const int e = c.e0 + j;
    const bool masked = a.flags[e] != 0;
    cp_async_wait<kStages - 2>();  // pair j has landed
    hopper::fence_async_smem();
    __syncthreads();               // and pair j - 1's stage (or q) is free
    const int jn = j + kStages - 1;
    if (jn < c.n) stage_kv(jn, jn % kStages);
    cp_async_commit();
    const bf16* ks = ring + slot * 2 * TILE;
    const float* bias_t = brow != nullptr ? bias_r + slot * kT : nullptr;
    if (masked)  // uniform over the CTA: one flag a pair
      fwd_pair<DP, true>(acc, qa, ks, ks + TILE, bias_t, a, e, it, rl0,
                         scale2, m0, m1, l0, l1, t);
    else
      fwd_pair<DP, false>(acc, qa, ks, ks + TILE, bias_t, a, e, it, rl0,
                          scale2, m0, m1, l0, l1, t);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // l = 0: the row has no live key (o = 0, lse -1e30)
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= inv0; acc[n][1] *= inv0;
    acc[n][2] *= inv1; acc[n][3] *= inv1;
  }
  store_rows<NO>(head_out<bf16>(a.o, a.os, b, h), a.os.s, acc, r0, Sq, D, t);
  if (t == 0) {
    const long long row0 = (long long)c.bh * Sq;
    if (r0 < Sq) a.lse[row0 + r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kNegInf;
    if (r1 < Sq) a.lse[row0 + r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kNegInf;
  }
}

// One pair of the dq kernel: s = q k^T, dp = do v^T, p, ds, dq += ds k.
// MASK: the pair's fine-block bits, causal diagonal or key tail bite.
template <int DP, bool MASK>
__device__ __forceinline__ void dq_pair(
    float (&acc)[DP / 8][4], uint32_t (&qa)[DP / 16][4],
    uint32_t (&da)[DP / 16][4], const bf16* ks, const bf16* vs,
    const float* bias_t, const Args& a, int e, int it, int rl0, float scale,
    float scale2, float ls0, float ls1, float dl0, float dl1, int t) {
  constexpr int NK = DP / 16, NS = kT / 8;
  float s[NS][4], dp[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s[nt][x] = dp[nt][x] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    wgmma_rs<kT, 0>(s, qa[kk], wgmma_desc(ks + kk * 16, DP * 2));
    wgmma_rs<kT, 0>(dp, da[kk], wgmma_desc(vs + kk * 16, DP * 2));
  }
  wgmma_commit();
  wgmma_wait();
  hopper::reg_fence(s);
  hopper::reg_fence(dp);
  // s <- ds = p (dp - delta) sm_scale, p = 2^(s sm_scale log2e + bias
  // log2e - lse log2e)
  PairMask pm;
  if (MASK) pm = pair_mask(a, e, it, a.idx[e]);
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    float2 bb = make_float2(0.f, 0.f);
    if (bias_t != nullptr)
      bb = *reinterpret_cast<const float2*>(bias_t + nt * 8 + 2 * t);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float p = ex2(fmaf(s[nt][x], scale2,
                         ((x & 1) ? bb.y : bb.x) * kLog2e -
                             (x < 2 ? ls0 : ls1)));
      if (MASK && !pm(x < 2 ? rl0 : rl0 + 8, nt * 8 + 2 * t + (x & 1)))
        p = 0.f;
      s[nt][x] = p * (dp[nt][x] - (x < 2 ? dl0 : dl1)) * scale;
    }
  }
  // dq += ds k: ds rounded to bf16 in the A fragments, k read through the
  // transpose bit
  uint32_t pa[kT / 16][4];
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
    wgmma_rs<DP, 1>(acc, pa[kk], wgmma_desc(ks + kk * 16 * DP, DP * 2));
  wgmma_commit();
  wgmma_wait();
  hopper::reg_fence(acc);
  hold_regs(pa);
}

// dq and delta over the row-major list.
template <int DP>
__global__ void __launch_bounds__(kThreads) sparse_dq_bf16(Args a) {
  constexpr int NK = DP / 16, NO = DP / 8;
  constexpr int TILE = kT * DP;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + TILE;
  bf16* ring = do_s + TILE;  // kStages x [K tile | V tile]
  float* bias_r = reinterpret_cast<float*>(ring + kStages * 2 * TILE);
  bf16* o_s = ring + (kStages - 1) * 2 * TILE;  // free until the loop

  const Cta c = cta_of(a);
  const int b = c.b, h = c.h, it = c.tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl0 = warp * 16 + g;  // this thread's rows: rl0, rl0 + 8
  const int q0 = it * kT, r0 = q0 + rl0, r1 = r0 + 8;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const bool vec = a.vec;
  const bf16* kb = head<bf16>(a.k, a.ks, b, h);
  const bf16* vb = head<bf16>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  // pair j of the segment: its K and V tiles and the keys' bias
  auto stage_kv = [&](int j, int st) {
    const int k0 = a.idx[c.e0 + j] * kT;
    bf16* slot = ring + st * 2 * TILE;
    stage_tile<DP, kT, kThreads>(slot, kb, a.ks.s, k0, Skv, D, vec);
    stage_tile<DP, kT, kThreads>(slot + TILE, vb, a.vs.s, k0, Skv, D, vec);
    const int i = threadIdx.x;
    if (brow != nullptr && i < kT) {
      const bool live = k0 + i < Skv;
      cp_async4(bias_r + st * kT + i, live ? brow + k0 + i : brow,
                live ? 4 : 0);
    }
  };

  stage_tile<DP, kT, kThreads>(q_s, head<bf16>(a.q, a.qs, b, h), a.qs.s, q0,
                               Sq, D, vec);
  stage_tile<DP, kT, kThreads>(do_s, head<bf16>(a.dout, a.dos, b, h),
                               a.dos.s, q0, Sq, D, vec);
  stage_tile<DP, kT, kThreads>(o_s, head<bf16>(a.o, a.os, b, h), a.os.s, q0,
                               Sq, D, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < c.n) stage_kv(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the CTA's own rows
  hopper::fence_async_smem();
  __syncthreads();

  uint32_t qa[NK][4], da[NK][4];
  ldsm_a<DP, NK>(qa, q_s, warp * 16, lane);
  ldsm_a<DP, NK>(da, do_s, warp * 16, lane);
  // delta = rowsum(do * o) - g_lse: fp32 sums of the bf16 products
  float dl0 = 0.f, dl1 = 0.f;
  {
    uint32_t oa[NK][4];
    ldsm_a<DP, NK>(oa, o_s, warp * 16, lane);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const float2 x = unpack_bf16(da[kk][reg]);
        const float2 y = unpack_bf16(oa[kk][reg]);
        const float part = x.x * y.x + x.y * y.y;
        if (reg & 1) dl1 += part; else dl0 += part;
      }
    }
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long row0 = (long long)c.bh * Sq;
  if (a.g_lse != nullptr) {
    if (r0 < Sq) dl0 -= a.g_lse[row0 + r0];
    if (r1 < Sq) dl1 -= a.g_lse[row0 + r1];
  }
  if (t == 0) {
    if (r0 < Sq) a.delta[row0 + r0] = dl0;
    if (r1 < Sq) a.delta[row0 + r1] = dl1;
  }
  // in the log2 domain of ex2; +inf past Sq
  const float ls0 = (r0 < Sq ? row_lse(a.lse[row0 + r0]) : INFINITY) * kLog2e;
  const float ls1 = (r1 < Sq ? row_lse(a.lse[row0 + r1]) : INFINITY) * kLog2e;
  const float scale = a.sm_scale, scale2 = scale * kLog2e;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int slot = 0;
  for (int j = 0; j < c.n; ++j) {
    const int e = c.e0 + j;
    const bool masked = a.flags[e] != 0;
    cp_async_wait<kStages - 2>();  // pair j has landed
    hopper::fence_async_smem();
    __syncthreads();               // and pair j - 1's stage is free
    const int jn = j + kStages - 1;
    if (jn < c.n) stage_kv(jn, jn % kStages);
    cp_async_commit();
    const bf16* ks = ring + slot * 2 * TILE;
    const float* bias_t = brow != nullptr ? bias_r + slot * kT : nullptr;
    if (masked)  // uniform over the CTA: one flag a pair
      dq_pair<DP, true>(acc, qa, da, ks, ks + TILE, bias_t, a, e, it, rl0,
                        scale, scale2, ls0, ls1, dl0, dl1, t);
    else
      dq_pair<DP, false>(acc, qa, da, ks, ks + TILE, bias_t, a, e, it, rl0,
                         scale, scale2, ls0, ls1, dl0, dl1, t);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  store_rows<NO>(head_out<bf16>(a.dq, a.dqs, b, h), a.dqs.s, acc, r0, Sq, D,
                 t);
}

// One pair of the dk/dv kernel: s^T = k q^T, dp^T = v do^T, p^T, ds^T,
// the bias cotangent's part, dv += p^T do, dk += ds^T q. MASK: as dq_pair.
template <int DP, bool MASK>
__device__ __forceinline__ void dkv_pair(
    float (&dk)[DP / 8][4], float (&dv)[DP / 8][4], float& db0, float& db1,
    uint32_t (&ka)[DP / 16][4], uint32_t (&va)[DP / 16][4], const bf16* qs,
    const bf16* ds_, const float* lse_t, const float* dl_t, const Args& a,
    int e, int kt, int kl0, float scale, float scale2, float bias0,
    float bias1, int t) {
  constexpr int NK = DP / 16, NS = kT / 8;
  float st[NS][4], dpt[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) st[nt][x] = dpt[nt][x] = 0.f;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    wgmma_rs<kT, 0>(st, ka[kk], wgmma_desc(qs + kk * 16, DP * 2));
    wgmma_rs<kT, 0>(dpt, va[kk], wgmma_desc(ds_ + kk * 16, DP * 2));
  }
  wgmma_commit();
  wgmma_wait();
  hopper::reg_fence(st);
  hopper::reg_fence(dpt);
  // st <- p^T, dpt <- ds^T (rows are keys, columns queries); the bias
  // cotangent sums p (dp - delta) over the queries
  PairMask pm;
  if (MASK) pm = pair_mask(a, e, a.idx[e], kt);
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float2 L = *reinterpret_cast<const float2*>(lse_t + col);
    const float2 Dl = *reinterpret_cast<const float2*>(dl_t + col);
    const float l0 = row_lse(L.x) * kLog2e;
    const float l1 = row_lse(L.y) * kLog2e;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float p = ex2(fmaf(st[nt][x], scale2,
                         (x < 2 ? bias0 : bias1) - ((x & 1) ? l1 : l0)));
      if (MASK && !pm(col + (x & 1), x < 2 ? kl0 : kl0 + 8)) p = 0.f;
      const float dsig = p * (dpt[nt][x] - ((x & 1) ? Dl.y : Dl.x));
      if (x < 2) db0 += dsig; else db1 += dsig;
      st[nt][x] = p;
      dpt[nt][x] = dsig * scale;
    }
  }
  // dv += p^T do, dk += ds^T q: p, ds rounded to bf16 in the A fragments;
  // do and q read through the transpose bit
  uint32_t pa[kT / 16][4], sa[kT / 16][4];
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    pack_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
    pack_a(sa[kk], dpt[2 * kk], dpt[2 * kk + 1]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    wgmma_rs<DP, 1>(dv, pa[kk], wgmma_desc(ds_ + kk * 16 * DP, DP * 2));
    wgmma_rs<DP, 1>(dk, sa[kk], wgmma_desc(qs + kk * 16 * DP, DP * 2));
  }
  wgmma_commit();
  wgmma_wait();
  hopper::reg_fence(dv);
  hopper::reg_fence(dk);
  hold_regs(pa);
  hold_regs(sa);
}

// dk, dv (and dbias) over the column-major list: s^T = k q^T and dp^T =
// v do^T, so p^T and ds^T come out of the accumulators as the A operands
// of dv += p^T do and dk += ds^T q.
template <int DP>
__global__ void __launch_bounds__(kThreads) sparse_dkv_bf16(Args a) {
  constexpr int NK = DP / 16, NO = DP / 8;
  constexpr int TILE = kT * DP;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + TILE;
  bf16* ring = v_s + TILE;  // kStages x [Q tile | dO tile]
  float* lse_r = reinterpret_cast<float*>(ring + kStages * 2 * TILE);
  float* dl_r = lse_r + kStages * kT;

  const Cta c = cta_of(a);
  const int b = c.b, h = c.h, kt = c.tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kl0 = warp * 16 + g;  // this thread's keys: kl0, kl0 + 8
  const int k0 = kt * kT, r0 = k0 + kl0, r1 = r0 + 8;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const bool vec = a.vec;
  const bf16* qb = head<bf16>(a.q, a.qs, b, h);
  const bf16* db = head<bf16>(a.dout, a.dos, b, h);
  const float* lse_b = a.lse + (long long)c.bh * Sq;
  const float* dl_b = a.delta + (long long)c.bh * Sq;
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;
  // the keys' bias in the log2 domain
  const float bias0 = (brow != nullptr && r0 < Skv) ? brow[r0] * kLog2e : 0.f;
  const float bias1 = (brow != nullptr && r1 < Skv) ? brow[r1] * kLog2e : 0.f;

  // pair j of the segment: its Q and dO tiles, the rows' lse and delta
  // (lse +inf past Sq: p = 0 there)
  auto stage_q = [&](int j, int st) {
    const int q0 = a.idx[c.e0 + j] * kT;
    bf16* slot = ring + st * 2 * TILE;
    stage_tile<DP, kT, kThreads>(slot, qb, a.qs.s, q0, Sq, D, vec);
    stage_tile<DP, kT, kThreads>(slot + TILE, db, a.dos.s, q0, Sq, D, vec);
    const int i = threadIdx.x;
    if (i < kT) {
      if (q0 + i < Sq) {
        cp_async4(lse_r + st * kT + i, lse_b + q0 + i, 4);
        cp_async4(dl_r + st * kT + i, dl_b + q0 + i, 4);
      } else {
        lse_r[st * kT + i] = INFINITY;
        dl_r[st * kT + i] = 0.f;
      }
    }
  };

  stage_tile<DP, kT, kThreads>(k_s, head<bf16>(a.k, a.ks, b, h), a.ks.s, k0,
                               Skv, D, vec);
  stage_tile<DP, kT, kThreads>(v_s, head<bf16>(a.v, a.vs, b, h), a.vs.s, k0,
                               Skv, D, vec);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < c.n) stage_q(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the CTA's own rows
  hopper::fence_async_smem();
  __syncthreads();

  uint32_t ka[NK][4], va[NK][4];
  ldsm_a<DP, NK>(ka, k_s, warp * 16, lane);
  ldsm_a<DP, NK>(va, v_s, warp * 16, lane);
  const float scale = a.sm_scale, scale2 = scale * kLog2e;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  float db0 = 0.f, db1 = 0.f;  // this thread's part of the bias cotangent

  int slot = 0;
  for (int j = 0; j < c.n; ++j) {
    const int e = c.e0 + j;
    const bool masked = a.flags[e] != 0;
    cp_async_wait<kStages - 2>();
    hopper::fence_async_smem();
    __syncthreads();
    const int jn = j + kStages - 1;
    if (jn < c.n) stage_q(jn, jn % kStages);
    cp_async_commit();
    const bf16* qs = ring + slot * 2 * TILE;
    const float* lse_t = lse_r + slot * kT;
    const float* dl_t = dl_r + slot * kT;
    if (masked)  // uniform over the CTA: one flag a pair
      dkv_pair<DP, true>(dk, dv, db0, db1, ka, va, qs, qs + TILE, lse_t,
                         dl_t, a, e, kt, kl0, scale, scale2, bias0, bias1, t);
    else
      dkv_pair<DP, false>(dk, dv, db0, db1, ka, va, qs, qs + TILE, lse_t,
                          dl_t, a, e, kt, kl0, scale, scale2, bias0, bias1,
                          t);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
  db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
  db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
  db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
  if (a.dbias != nullptr && t == 0) {
    if (r0 < Skv) a.dbias[(long long)c.bh * Skv + r0] = db0;
    if (r1 < Skv) a.dbias[(long long)c.bh * Skv + r1] = db1;
  }
  store_rows<NO>(head_out<bf16>(a.dk, a.dks, b, h), a.dks.s, dk, r0, Skv, D,
                 t);
  store_rows<NO>(head_out<bf16>(a.dv, a.dvs, b, h), a.dvs.s, dv, r0, Skv, D,
                 t);
}

// ------------------------------------------------------------ fp32: FMA
template <int DP>
__global__ void __launch_bounds__(kThreads32) sparse_fwd_f32(Args a) {
  constexpr int NV = DP / 16;  // float4 groups a thread
  __shared__ float4 k_tile[kT][DP / 4];
  __shared__ float4 v_tile[kT][DP / 4];

  const int it = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int r = it * kT + row;
  const int Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const float* kb = head<float>(a.k, a.ks, b, h);
  const float* vb = head<float>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  float4 qr[NV], acc[NV];
  load_row_f32<NV>(qr, head<float>(a.q, a.qs, b, h), a.qs.s, r, a.Sq, D, t);
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  const int seg = h * a.n_out + it;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int kt = a.idx[e];
    const PairMask pm = pair_mask(a, e, it, kt);
    const int k0 = kt * kT;
    __syncthreads();
    stage_f32<DP>(&k_tile[0][0], kb + (long long)k0 * a.ks.s, a.ks.s,
                  Skv - k0, kT, D);
    stage_f32<DP>(&v_tile[0][0], vb + (long long)k0 * a.vs.s, a.vs.s,
                  Skv - k0, kT, D);
    __syncthreads();
    for (int c0 = 0; c0 < kT; c0 += kChunk) {
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        const float dot = dot4<NV>(qr, k_tile[j], t);
        float x = pm(row, j) ? dot * scale : kNegInf;
        if (brow != nullptr && k0 + j < Skv) x += brow[k0 + j];
        s[jj] = x;
        m_new = fmaxf(m_new, x);
      }
      const float alpha = expf(m - m_new);
      const bool dead = m_new <= kNegInf * 0.5f;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha;
        acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = dead ? 0.f : expf(s[jj] - m_new);
        l += p;
        axpy4<NV>(acc, p, v_tile[c0 + jj], t);
      }
      m = m_new;
    }
  }

  if (r >= a.Sq) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  const float inv = 1.f / l_safe;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i].x *= inv; acc[i].y *= inv; acc[i].z *= inv; acc[i].w *= inv;
  }
  store_row_f32<NV>(head_out<float>(a.o, a.os, b, h), a.os.s, r, D, t, acc);
  if (t == 0) a.lse[(long long)bh * a.Sq + r] = m + logf(l_safe);
}

template <int DP>
__global__ void __launch_bounds__(kThreads32) sparse_dq_f32(Args a) {
  constexpr int NV = DP / 16;
  __shared__ float4 k_tile[kT][DP / 4];
  __shared__ float4 v_tile[kT][DP / 4];

  const int it = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int r = it * kT + row;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const float* kb = head<float>(a.k, a.ks, b, h);
  const float* vb = head<float>(a.v, a.vs, b, h);
  const float* brow = a.bias ? a.bias + (long long)b * Skv : nullptr;

  float4 qr[NV], dr[NV], acc[NV];
  load_row_f32<NV>(qr, head<float>(a.q, a.qs, b, h), a.qs.s, r, Sq, D, t);
  load_row_f32<NV>(dr, head<float>(a.dout, a.dos, b, h), a.dos.s, r, Sq, D,
                   t);
  // delta = rowsum(do * o) - g_lse, written for the dk/dv kernel
  float delta = 0.f;
  {
    float4 orow[NV];
    load_row_f32<NV>(orow, head<float>(a.o, a.os, b, h), a.os.s, r, Sq, D,
                     t);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      delta += dr[i].x * orow[i].x + dr[i].y * orow[i].y +
               dr[i].z * orow[i].z + dr[i].w * orow[i].w;
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  const long long ri = (long long)bh * Sq + r;
  if (a.g_lse != nullptr && r < Sq) delta -= a.g_lse[ri];
  if (t == 0 && r < Sq) a.delta[ri] = delta;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = r < Sq ? a.lse[ri] : kNegInf;
  const bool dead = lse <= kNegInf * 0.5f;

  const int seg = h * a.n_out + it;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int kt = a.idx[e];
    const PairMask pm = pair_mask(a, e, it, kt);
    const int k0 = kt * kT;
    __syncthreads();
    stage_f32<DP>(&k_tile[0][0], kb + (long long)k0 * a.ks.s, a.ks.s,
                  Skv - k0, kT, D);
    stage_f32<DP>(&v_tile[0][0], vb + (long long)k0 * a.vs.s, a.vs.s,
                  Skv - k0, kT, D);
    __syncthreads();
    for (int j = 0; j < kT; ++j) {
      const float s = dot4<NV>(qr, k_tile[j], t);
      const float dp = dot4<NV>(dr, v_tile[j], t);
      float x = pm(row, j) ? s * scale : kNegInf;
      if (brow != nullptr && k0 + j < Skv) x += brow[k0 + j];
      const float p = dead ? 0.f : expf(x - lse);
      axpy4<NV>(acc, p * (dp - delta) * scale, k_tile[j], t);
    }
  }
  if (r < Sq)
    store_row_f32<NV>(head_out<float>(a.dq, a.dqs, b, h), a.dqs.s, r, D, t,
                      acc);
}

template <int DP>
__global__ void __launch_bounds__(kThreads32) sparse_dkv_f32(Args a) {
  constexpr int NV = DP / 16;
  __shared__ float4 q_tile[kT][DP / 4];
  __shared__ float4 d_tile[kT][DP / 4];
  __shared__ float lse_s[kT], delta_s[kT];

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int row = threadIdx.x / kTPR, t = threadIdx.x % kTPR;
  const int key = kt * kT + row;
  const int Sq = a.Sq, Skv = a.Skv, D = a.D;
  const float scale = a.sm_scale;
  const float* qb = head<float>(a.q, a.qs, b, h);
  const float* db = head<float>(a.dout, a.dos, b, h);
  const float bias = (a.bias != nullptr && key < Skv)
                         ? a.bias[(long long)b * Skv + key] : 0.f;

  float4 kr[NV], vr[NV], dk[NV], dv[NV];
  load_row_f32<NV>(kr, head<float>(a.k, a.ks, b, h), a.ks.s, key, Skv, D, t);
  load_row_f32<NV>(vr, head<float>(a.v, a.vs, b, h), a.vs.s, key, Skv, D, t);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    dk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float dbias = 0.f;

  const int seg = h * a.n_out + kt;
  for (int e = a.ptr[seg]; e < a.ptr[seg + 1]; ++e) {
    const int qt = a.idx[e];
    const PairMask pm = pair_mask(a, e, qt, kt);
    const int q0 = qt * kT;
    __syncthreads();
    stage_f32<DP>(&q_tile[0][0], qb + (long long)q0 * a.qs.s, a.qs.s, Sq - q0,
                  kT, D);
    stage_f32<DP>(&d_tile[0][0], db + (long long)q0 * a.dos.s, a.dos.s,
                  Sq - q0, kT, D);
    for (int i = threadIdx.x; i < kT; i += blockDim.x) {
      const int qi = q0 + i;
      lse_s[i] = qi < Sq ? a.lse[(long long)bh * Sq + qi] : kNegInf;
      delta_s[i] = qi < Sq ? a.delta[(long long)bh * Sq + qi] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kT; ++i) {
      const float s = dot4<NV>(kr, q_tile[i], t);
      const float dp = dot4<NV>(vr, d_tile[i], t);
      float x = pm(i, row) ? s * scale : kNegInf;
      x += bias;
      const float L = lse_s[i];
      const float p = L <= kNegInf * 0.5f ? 0.f : expf(x - L);
      const float dsig = p * (dp - delta_s[i]);
      dbias += dsig;
      axpy4<NV>(dv, p, d_tile[i], t);
      axpy4<NV>(dk, dsig * scale, q_tile[i], t);
    }
  }
  if (key < Skv) {
    store_row_f32<NV>(head_out<float>(a.dk, a.dks, b, h), a.dks.s, key, D, t,
                      dk);
    store_row_f32<NV>(head_out<float>(a.dv, a.dvs, b, h), a.dvs.s, key, D, t,
                      dv);
    if (a.dbias != nullptr && t == 0)
      a.dbias[(long long)bh * Skv + key] = dbias;
  }
}

// ------------------------------------------------------------ launch
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename Kernel>
cudaError_t launch_smem(Kernel kernel, int blocks, int smem, const Args& a) {
  // above 48 KB of dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Args& a, int dtype, int which) {
  const dim3 grid(a.n_out, a.B * a.H);
  const int ctas = a.B * a.H * a.n_out;  // bf16: in `order`
  const bool bf = dtype == 1;
  if (which == kFwd) {
    if (bf)
      return launch_smem(sparse_fwd_bf16<DP>, ctas, fwd_smem_bytes<DP>(), a);
    sparse_fwd_f32<DP><<<grid, kThreads32, 0, a.stream>>>(a);
  } else if (which == kDq) {
    if (bf)
      return launch_smem(sparse_dq_bf16<DP>, ctas, dq_smem_bytes<DP>(), a);
    sparse_dq_f32<DP><<<grid, kThreads32, 0, a.stream>>>(a);
  } else {
    if (bf)
      return launch_smem(sparse_dkv_bf16<DP>, ctas, dkv_smem_bytes<DP>(), a);
    sparse_dkv_f32<DP><<<grid, kThreads32, 0, a.stream>>>(a);
  }
  return cudaGetLastError();
}

int run(int which, void* const* p, const long long* st, const int* d,
        float sm_scale, void* stream) {
  // d: dtype, B, H, Sq, Skv, D, n_out, causal, causal_ntiles, fine, vec
  const int dtype = d[0], D = d[5], fine = d[9];
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (D < 1 || D > 64 || d[1] * d[2] == 0 || d[3] == 0 || d[4] == 0 ||
      d[6] == 0 || d[1] * d[2] > 65535)
    return cudaErrorInvalidValue;
  if (fine < 8 || fine > kT || (fine & (fine - 1)) != 0)
    return cudaErrorInvalidValue;
  int lf = 0;
  while ((1 << lf) < fine) ++lf;
  Args a;
  a.q = p[0]; a.k = p[1]; a.v = p[2]; a.o = p[3]; a.dout = p[4];
  a.lse = static_cast<float*>(p[5]);
  a.delta = static_cast<float*>(p[6]);
  a.dq = p[7]; a.dk = p[8]; a.dv = p[9];
  a.bias = static_cast<const float*>(p[10]);
  a.dbias = static_cast<float*>(p[11]);
  a.ptr = static_cast<const int*>(p[12]);
  a.idx = static_cast<const int*>(p[13]);
  a.bits = static_cast<const unsigned long long*>(p[14]);
  a.flags = static_cast<const unsigned char*>(p[15]);
  a.order = static_cast<const int*>(p[16]);
  a.g_lse = static_cast<const float*>(p[17]);
  a.B = d[1]; a.H = d[2]; a.Sq = d[3]; a.Skv = d[4]; a.D = D;
  a.n_out = d[6]; a.causal = d[7]; a.causal_ntiles = d[8];
  a.lf = lf; a.nshift = 6 - lf; a.vec = d[10];
  Strides* s[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(a, dtype, which);
  if (D <= 32) return launch<32>(a, dtype, which);
  return launch<64>(a, dtype, which);
}

}  // namespace

// `ptrs`: q, k, v, o, dout, lse, delta, dq, dk, dv, bias, dbias, ptr, idx,
// bits, flags, order, g_lse (null where a kernel does not use one; bias,
// dbias and g_lse may be null). flags (uint8, one a pair: the pair needs
// the mask) and order (int32 [H * n_out]: the segments, longest first)
// are read by the bf16 kernels. ds_sparse_dq writes dq and
// delta = rowsum(do * o) - g_lse; ds_sparse_dkv reads that delta: launch
// it after ds_sparse_dq on the same stream.
// `strides`: (batch, head, seq) element strides of q, k, v, o, dout, dq,
// dk, dv (24 values); every head dim is contiguous. lse and delta are
// contiguous fp32 [B, H, Sq]; bias is a contiguous fp32 [B, Skv]; dbias a
// contiguous fp32 [B*H, Skv]; g_lse a contiguous fp32 [B, H, Sq]. `dims`: dtype (0 float32, 1 bfloat16), B, H,
// Sq, Skv, D (1..64), n_out (output tiles a head), causal, causal_ntiles
// (key tiles of the real region), fine block (8..64, a power of two), vec
// (1 when D % 8 == 0 and the rows a kernel stages are 16-byte aligned).
extern "C" int ds_sparse_fwd(void* const* ptrs, const long long* strides,
                             const int* dims, float sm_scale, void* stream) {
  return run(kFwd, ptrs, strides, dims, sm_scale, stream);
}

extern "C" int ds_sparse_dq(void* const* ptrs, const long long* strides,
                            const int* dims, float sm_scale, void* stream) {
  return run(kDq, ptrs, strides, dims, sm_scale, stream);
}

extern "C" int ds_sparse_dkv(void* const* ptrs, const long long* strides,
                             const int* dims, float sm_scale, void* stream) {
  return run(kDkv, ptrs, strides, dims, sm_scale, stream);
}
