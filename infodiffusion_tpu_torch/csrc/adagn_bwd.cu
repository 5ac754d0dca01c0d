// K1 backward: the gradient of GroupNorm + K FiLMs (AdaGN) over x
// [B, HW, C], C fastest.
//
// The JAX package has no Pallas backward for K1 (the XLA autodiff of
// infodiffusion_tpu/ops/norm.py adagn runs there); this kernel is that
// gradient. Like the forward it moves bytes and does little arithmetic:
// it reads x and dy twice and writes dx once, so memory bandwidth bounds
// it. It keeps the forward's (row split, batch) grid and per-split f32
// partials (no atomics, results identical from run to run), and reuses
// the forward's statistics partials [B, S, 2, C] (sum x, sum x^2) instead
// of recomputing them.
//
// With x^ = (x - mean) * rstd, P = prod_k (1 + s_k), a_c = gamma * P:
//
//   1. adagn_bwd_reduce, grid (S', B): per channel and split,
//      S1 = sum_hw dy and S2 = sum_hw dy * x^, as partials [B, S', 2, C].
//   2. adagn_bwd_film, grid B: folds the partials; dbeta/dgamma rows
//      P*S1 and P*S2 per batch element; each FiLM's db_k = q_k S1 and
//      ds_k = q_k (alpha_{k-1} S2 + beta_{k-1} S1), where q_k is the
//      product of the later FiLMs' (1 + s) and alpha/beta the affine
//      coefficients of h_{k-1}; per group m1 = mean_g(a_c S1) / HW and
//      m2 = mean_g(a_c S2) / HW (0 where the var clamp binds: JAX's
//      gradient through max(var, 0) is 0 there).
//   3. adagn_bwd_apply, grid (S', B): dx = rstd * (a_c dy - m1 - x^ m2).
//   4. adagn_bwd_params, one thread per channel: dgamma, dbeta summed over
//      the batch in order.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-5f;
constexpr int kMaxFilms = 2;

// Fold the forward's statistics partials [S, 2, C] of one batch element
// into per-group mean, rstd and the clamp flag (1 where var >= 0).
// Uses ch[2C] as scratch; every thread of the block must call it.
__device__ void fold_stats(const float* __restrict__ pb, int S, int C, int G,
                           int HW, float* ch, float* gmean, float* grstd,
                           float* gkeep) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < S; ++j) {
      t1 += pb[(size_t)j * 2 * C + c];
      t2 += pb[(size_t)j * 2 * C + C + c];
    }
    ch[c] = t1;
    ch[C + c] = t2;
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < gs; ++j) {
      t1 += ch[g * gs + j];
      t2 += ch[C + g * gs + j];
    }
    const float n = (float)HW * (float)gs;
    const float mean = t1 / n;
    const float var = t2 / n - mean * mean;
    gmean[g] = mean;
    grstd[g] = rsqrtf(fmaxf(var, 0.f) + kEps);
    gkeep[g] = var >= 0.f ? 1.f : 0.f;
  }
  __syncthreads();
}

template <typename T>
__global__ void adagn_bwd_reduce_kernel(const T* __restrict__ x,
                                        const T* __restrict__ dy,
                                        const float* __restrict__ stats,
                                        float* __restrict__ partial, int HW,
                                        int C, int G, int stat_splits,
                                        int rows_per_split) {
  // ch[2C], mean[G], rstd[G], keep[G], red[2 * blockDim]
  extern __shared__ float sm[];
  float* gmean = sm + 2 * C;
  float* grstd = gmean + G;
  float* gkeep = grstd + G;
  float* red = gkeep + G;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  fold_stats(stats + (size_t)b * stat_splits * 2 * C, stat_splits, C, G, HW,
             sm, gmean, grstd, gkeep);
  const int R = blockDim.x / C;
  const int c = threadIdx.x % C, lane = threadIdx.x / C;
  const int g = c / (C / G);
  const float mean = gmean[g], rstd = grstd[g];
  const int r0 = s * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  const size_t base = (size_t)b * HW * C;
  float s1 = 0.f, s2 = 0.f;
  for (int r = r0 + lane; r < r1; r += R) {
    const size_t i = base + (size_t)r * C + c;
    const float d = to_f32(dy[i]);
    s1 += d;
    s2 = fmaf(d, (to_f32(x[i]) - mean) * rstd, s2);
  }
  red[threadIdx.x] = s1;
  red[blockDim.x + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < R; ++l) {
      t1 += red[l * C + threadIdx.x];
      t2 += red[blockDim.x + l * C + threadIdx.x];
    }
    float* p = partial + ((size_t)b * S + s) * 2 * C;
    p[threadIdx.x] = t1;
    p[C + threadIdx.x] = t2;
  }
}

// One block per batch element, one thread per channel (blockDim == C).
__global__ void adagn_bwd_film_kernel(
    const float* __restrict__ stats, const float* __restrict__ partial,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ films, float* __restrict__ dfilms,
    float* __restrict__ gpart, float* __restrict__ rows, int HW, int C,
    int G, int K, int stat_splits, int S) {
  // ch[2C], mean[G], rstd[G], keep[G], t1[C], t2[C]
  extern __shared__ float sm[];
  float* gmean = sm + 2 * C;
  float* grstd = gmean + G;
  float* gkeep = grstd + G;
  float* t1 = gkeep + G;
  float* t2 = t1 + C;
  const int b = blockIdx.x, c = threadIdx.x;
  fold_stats(stats + (size_t)b * stat_splits * 2 * C, stat_splits, C, G, HW,
             sm, gmean, grstd, gkeep);
  const float* pb = partial + (size_t)b * S * 2 * C;
  float S1 = 0.f, S2 = 0.f;
  for (int j = 0; j < S; ++j) {
    S1 += pb[(size_t)j * 2 * C + c];
    S2 += pb[(size_t)j * 2 * C + C + c];
  }
  float fs[kMaxFilms] = {0.f, 0.f}, fb[kMaxFilms] = {0.f, 0.f};
  float P = 1.f;
  for (int k = 0; k < K; ++k) {
    fs[k] = 1.f + films[((size_t)b * 2 * K + 2 * k) * C + c];
    fb[k] = films[((size_t)b * 2 * K + 2 * k + 1) * C + c];
    P *= fs[k];
  }
  // h_{k-1} = alpha * x^ + beta_k; walk the chain forward
  float alpha = gamma[c], bet = beta[c];
  for (int k = 0; k < K; ++k) {
    float q = 1.f;  // product of the later FiLMs' scales
    for (int j = k + 1; j < K; ++j) q *= fs[j];
    float* d = dfilms + ((size_t)b * 2 * K + 2 * k) * C + c;
    d[0] = q * (alpha * S2 + bet * S1);
    d[C] = q * S1;
    alpha *= fs[k];
    bet = fmaf(bet, fs[k], fb[k]);
  }
  gpart[((size_t)b * 2) * C + c] = P * S2;
  gpart[((size_t)b * 2 + 1) * C + c] = P * S1;
  const float a = gamma[c] * P;
  t1[c] = a * S1;
  t2[c] = a * S2;
  __syncthreads();
  const int gs = C / G;
  for (int g = c; g < G; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int j = 0; j < gs; ++j) {
      m1 += t1[g * gs + j];
      m2 += t2[g * gs + j];
    }
    const float n = (float)HW * (float)gs;
    float* r = rows + (size_t)b * 4 * G;
    r[g] = gmean[g];
    r[G + g] = grstd[g];
    r[2 * G + g] = m1 / n;
    r[3 * G + g] = gkeep[g] * m2 / n;
  }
}

template <typename T>
__global__ void adagn_bwd_apply_kernel(const T* __restrict__ x,
                                       const T* __restrict__ dy,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ films,
                                       const float* __restrict__ rows,
                                       T* __restrict__ dx, int HW, int C,
                                       int G, int K, int rows_per_split) {
  const int b = blockIdx.y, s = blockIdx.x;
  const int R = blockDim.x / C;
  const int c = threadIdx.x % C, lane = threadIdx.x / C;
  const int g = c / (C / G);
  const float* rb = rows + (size_t)b * 4 * G;
  const float mean = rb[g], rstd = rb[G + g], m1 = rb[2 * G + g],
              m2 = rb[3 * G + g];
  float a = gamma[c];
  for (int k = 0; k < K; ++k)
    a *= 1.f + films[((size_t)b * 2 * K + 2 * k) * C + c];
  const int r0 = s * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  const size_t base = (size_t)b * HW * C;
  for (int r = r0 + lane; r < r1; r += R) {
    const size_t i = base + (size_t)r * C + c;
    const float xh = (to_f32(x[i]) - mean) * rstd;
    dx[i] = from_f32<T>(rstd * (a * to_f32(dy[i]) - m1 - xh * m2));
  }
}

__global__ void adagn_bwd_params_kernel(const float* __restrict__ gpart,
                                        float* __restrict__ dgamma,
                                        float* __restrict__ dbeta, int B,
                                        int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float g = 0.f, bb = 0.f;
  for (int b = 0; b < B; ++b) {
    g += gpart[((size_t)b * 2) * C + c];
    bb += gpart[((size_t)b * 2 + 1) * C + c];
  }
  dgamma[c] = g;
  dbeta[c] = bb;
}

template <typename T>
int launch(const void* x, const void* dy, const float* stats,
           const float* gamma, const float* beta, const float* films,
           float* partial, float* gpart, float* rows, void* dx,
           float* dgamma, float* dbeta, float* dfilms, int B, int HW, int C,
           int G, int K, int stat_splits, int S, int rows_per_split,
           int threads, cudaStream_t stream) {
  const dim3 grid(S, B);
  const size_t fold = (2 * C + 3 * G) * sizeof(float);
  adagn_bwd_reduce_kernel<T><<<grid, threads,
                               fold + 2 * threads * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), stats, partial, HW,
      C, G, stat_splits, rows_per_split);
  adagn_bwd_film_kernel<<<B, C, fold + 2 * C * sizeof(float), stream>>>(
      stats, partial, gamma, beta, films, dfilms, gpart, rows, HW, C, G, K,
      stat_splits, S);
  adagn_bwd_apply_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, films, rows,
      static_cast<T*>(dx), HW, C, G, K, rows_per_split);
  adagn_bwd_params_kernel<<<(C + 127) / 128, 128, 0, stream>>>(
      gpart, dgamma, dbeta, B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: [B, HW, C] of `dtype`; stats: the forward's partials
// [B, stat_splits, 2, C] f32; gamma, beta: [C] f32; films: [B, 2K, C] f32
// (unused when K == 0). Scratch: partial [B, S, 2, C], gpart [B, 2, C],
// rows [B, 4, G], all f32. Outputs dgamma, dbeta [C] and dfilms [B, 2K, C]
// (ds_k, db_k interleaved like films) in f32. `threads` must be a multiple
// of C, C <= 1024, and S * rows_per_split >= HW.
INFODIFF_EXPORT int infodiff_adagn_bwd(
    const void* x, const void* dy, const float* stats, const float* gamma,
    const float* beta, const float* films, float* partial, float* gpart,
    float* rows, void* dx, float* dgamma, float* dbeta, float* dfilms, int B,
    int HW, int C, int G, int K, int stat_splits, int S, int rows_per_split,
    int threads, int dtype, cudaStream_t stream) {
  if (K > kMaxFilms || C > 1024 || C % G) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, dy, stats, gamma, beta, films, partial,
                                 gpart, rows, dx, dgamma, dbeta, dfilms, B,
                                 HW, C, G, K, stat_splits, S, rows_per_split,
                                 threads, stream);
  return launch<float>(x, dy, stats, gamma, beta, films, partial, gpart, rows,
                       dx, dgamma, dbeta, dfilms, B, HW, C, G, K, stat_splits,
                       S, rows_per_split, threads, stream);
}
