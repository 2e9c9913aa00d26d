// CPU Adam/Adagrad: the AVX2/FMA host optimizer of the optimizer offload
// (counterpart of the JAX package's csrc/cpu_adam.cpp, the same source).
//
// The reference's csrc/adam/cpu_adam.cpp (AVX intrinsics in
// csrc/includes/simd.h) and csrc/adagrad/cpu_adagrad.cpp, exposed as a
// plain C ABI for ctypes (no torch header, no pybind11): the Python
// wrappers (deepspeed_tpu_torch/ops/adam/cpu_adam.py) pass the
// data_ptr() of fp32 host tensors, pinned where they feed a copy to or
// from the card.
//
// Built by deepspeed_tpu_torch/ops/op_builder.py with the host compiler:
// g++ -O3 -std=c++17 -march=native -fopenmp -shared -fPIC cpu_adam.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

struct AdamConfig {
  float betta1;
  float betta2;
  float eps;
  float weight_decay;
  int adamw_mode;
};

static std::map<int, AdamConfig> g_adam_optimizers;
static std::mutex g_mu;

int ds_adam_create(int optimizer_id, float betta1, float betta2, float eps,
                   float weight_decay, int adamw_mode) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_adam_optimizers[optimizer_id] = {betta1, betta2, eps, weight_decay,
                                     adamw_mode};
  return 0;
}

int ds_adam_destroy(int optimizer_id) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_adam_optimizers.erase(optimizer_id);
  return 0;
}

// One fused Adam step over a contiguous shard. Matches the reference
// kernel's math order: bias correction folded into step size; AdamW
// decoupled decay vs L2 fold-in (cpu_adam.h Step_1).
int ds_adam_step(int optimizer_id, int64_t step, float lr, float* params,
                 const float* grads, float* exp_avg, float* exp_avg_sq,
                 int64_t n) {
  AdamConfig cfg;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_adam_optimizers.find(optimizer_id);
    if (it == g_adam_optimizers.end()) return -1;
    cfg = it->second;
  }
  const float b1 = cfg.betta1, b2 = cfg.betta2, eps = cfg.eps;
  const float wd = cfg.weight_decay;
  const float bc1 = 1.0f - std::pow(b1, (float)step);
  const float bc2 = 1.0f - std::pow(b2, (float)step);
  const float step_size = lr / bc1;
  const float bc2_sqrt = std::sqrt(bc2);
  const bool adamw = cfg.adamw_mode != 0;

  int64_t i = 0;
#if defined(__AVX2__) && defined(__FMA__)
  const __m256 vb1 = _mm256_set1_ps(b1);
  const __m256 vb2 = _mm256_set1_ps(b2);
  const __m256 v1mb1 = _mm256_set1_ps(1.0f - b1);
  const __m256 v1mb2 = _mm256_set1_ps(1.0f - b2);
  const __m256 veps = _mm256_set1_ps(eps);
  const __m256 vstep = _mm256_set1_ps(-step_size);
  const __m256 vbc2s = _mm256_set1_ps(1.0f / bc2_sqrt);
  const __m256 vwd = _mm256_set1_ps(wd);
  const __m256 vlrwd = _mm256_set1_ps(-lr * wd);
#pragma omp parallel for
  for (int64_t blk = 0; blk < n / 8; ++blk) {
    int64_t j = blk * 8;
    __m256 g = _mm256_loadu_ps(grads + j);
    __m256 p = _mm256_loadu_ps(params + j);
    if (wd > 0.0f && !adamw) g = _mm256_fmadd_ps(vwd, p, g);
    __m256 m = _mm256_loadu_ps(exp_avg + j);
    __m256 v = _mm256_loadu_ps(exp_avg_sq + j);
    m = _mm256_fmadd_ps(vb1, m, _mm256_mul_ps(v1mb1, g));
    v = _mm256_fmadd_ps(vb2, v, _mm256_mul_ps(v1mb2, _mm256_mul_ps(g, g)));
    // denom = sqrt(v)/sqrt(bc2) + eps
    __m256 denom =
        _mm256_add_ps(_mm256_mul_ps(_mm256_sqrt_ps(v), vbc2s), veps);
    __m256 upd = _mm256_div_ps(m, denom);
    __m256 p_orig = p;  // decoupled decay uses the pre-update param
    p = _mm256_fmadd_ps(vstep, upd, p);
    if (wd > 0.0f && adamw) p = _mm256_fmadd_ps(vlrwd, p_orig, p);
    _mm256_storeu_ps(params + j, p);
    _mm256_storeu_ps(exp_avg + j, m);
    _mm256_storeu_ps(exp_avg_sq + j, v);
  }
  i = (n / 8) * 8;
#endif
  for (; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    if (wd > 0.0f && !adamw) g += wd * p;
    float m = exp_avg[i] = b1 * exp_avg[i] + (1.0f - b1) * g;
    float v = exp_avg_sq[i] = b2 * exp_avg_sq[i] + (1.0f - b2) * g * g;
    float denom = std::sqrt(v) / bc2_sqrt + eps;
    float p_orig = p;
    p -= step_size * (m / denom);
    if (wd > 0.0f && adamw) p -= lr * wd * p_orig;
    params[i] = p;
  }
  return 0;
}

// ---------------------------------------------------------------- adagrad
int ds_adagrad_step(float lr, float eps, float weight_decay, float* params,
                    const float* grads, float* exp_avg_sq, int64_t n) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    if (weight_decay > 0.0f) g += weight_decay * params[i];
    exp_avg_sq[i] += g * g;
    params[i] -= lr * g / (std::sqrt(exp_avg_sq[i]) + eps);
  }
  return 0;
}

int ds_has_avx2() {
#if defined(__AVX2__) && defined(__FMA__)
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
