// K1: GroupNorm + K FiLMs (AdaGN) over x [B, HW, C], C fastest.
//
// Replaces infodiffusion_tpu/ops/pallas/adagn.py (adagn_pallas / _kernel).
// The op moves bytes and does almost no arithmetic, so the card's memory
// bandwidth bounds it. A batch element at the flagship's first level is
// 512 KB in bf16 (HW 4096 x C 64), far beyond one SM's shared memory, so
// the TPU kernel's one-block-per-batch-element design does not carry
// over. Instead, two passes over a (split, batch) grid:
//
//   1. adagn_stats: each block sums x and x^2 in f32 per channel over its
//      slice of HW rows and writes the partials [B, S, 2, C].
//   2. adagn_apply: each block folds the S partials into per-group mean and
//      rstd = rsqrt(max(E[x^2] - mean^2, 0) + 1e-5) (the XLA form's clamp,
//      ops/norm.py), then writes ((x - mean) * rstd * gamma + beta), then
//      h * (1 + s_k) + b_k for each FiLM, in x's dtype.
//
// A thread owns one channel (t % C) and walks rows with stride R = T / C,
// so a warp reads consecutive channels of a row: coalesced for any C, the
// upblocks' 192 channels included (group size 6). The grid has B * S
// blocks, enough to fill the card at small batches. No atomics: partials
// are summed in a fixed order, so results do not vary from run to run.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-5f;

template <typename T>
__global__ void adagn_stats_kernel(const T* __restrict__ x,
                                   float* __restrict__ partial, int HW, int C,
                                   int rows_per_split) {
  extern __shared__ float sm[];  // [2][blockDim]
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int R = blockDim.x / C;
  const int c = threadIdx.x % C, lane = threadIdx.x / C;
  const int r0 = s * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  const T* xb = x + (size_t)b * HW * C;
  float s1 = 0.f, s2 = 0.f;
  for (int r = r0 + lane; r < r1; r += R) {
    const float v = to_f32(xb[(size_t)r * C + c]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  sm[threadIdx.x] = s1;
  sm[blockDim.x + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < R; ++l) {
      t1 += sm[l * C + threadIdx.x];
      t2 += sm[blockDim.x + l * C + threadIdx.x];
    }
    float* p = partial + ((size_t)b * S + s) * 2 * C;
    p[threadIdx.x] = t1;
    p[C + threadIdx.x] = t2;
  }
}

template <typename T>
__global__ void adagn_apply_kernel(const T* __restrict__ x,
                                   const float* __restrict__ partial,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ films,
                                   T* __restrict__ out, int HW, int C, int G,
                                   int K, int rows_per_split) {
  extern __shared__ float sm[];  // ch1[C], ch2[C], mean[G], rstd[G]
  float* ch1 = sm;
  float* ch2 = sm + C;
  float* gmean = sm + 2 * C;
  float* grstd = gmean + G;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const float* pb = partial + (size_t)b * S * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < S; ++j) {
      t1 += pb[(size_t)j * 2 * C + c];
      t2 += pb[(size_t)j * 2 * C + C + c];
    }
    ch1[c] = t1;
    ch2[c] = t2;
  }
  __syncthreads();
  const int gs = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < gs; ++j) {
      t1 += ch1[g * gs + j];
      t2 += ch2[g * gs + j];
    }
    const float n = (float)HW * (float)gs;
    const float mean = t1 / n;
    const float var = fmaxf(t2 / n - mean * mean, 0.f);
    gmean[g] = mean;
    grstd[g] = rsqrtf(var + kEps);
  }
  __syncthreads();

  const int R = blockDim.x / C;
  const int c = threadIdx.x % C, lane = threadIdx.x / C;
  const int g = c / gs;
  const float mean = gmean[g];
  const float a = grstd[g] * gamma[c];
  const float bb = beta[c];
  float fs[2] = {0.f, 0.f}, fb[2] = {0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    fs[k] = 1.f + films[((size_t)b * 2 * K + 2 * k) * C + c];
    fb[k] = films[((size_t)b * 2 * K + 2 * k + 1) * C + c];
  }
  const int r0 = s * rows_per_split;
  const int r1 = min(HW, r0 + rows_per_split);
  const size_t base = (size_t)b * HW * C;
  for (int r = r0 + lane; r < r1; r += R) {
    const size_t i = base + (size_t)r * C + c;
    float h = fmaf(to_f32(x[i]) - mean, a, bb);
    for (int k = 0; k < K; ++k) h = fmaf(h, fs[k], fb[k]);
    out[i] = from_f32<T>(h);
  }
}

template <typename T>
int launch(const void* x, float* partial, const float* gamma,
           const float* beta, const float* films, void* out, int B, int HW,
           int C, int G, int K, int S, int rows_per_split, int threads,
           cudaStream_t stream) {
  const dim3 grid(S, B);
  adagn_stats_kernel<T><<<grid, threads, 2 * threads * sizeof(float),
                          stream>>>(static_cast<const T*>(x), partial, HW, C,
                                    rows_per_split);
  adagn_apply_kernel<T><<<grid, threads, (2 * C + 2 * G) * sizeof(float),
                          stream>>>(static_cast<const T*>(x), partial, gamma,
                                    beta, films, static_cast<T*>(out), HW, C,
                                    G, K, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [B, HW, C] of `dtype`; partial: [B, S, 2, C] f32 scratch;
// gamma, beta: [C] f32; films: [B, 2K, C] f32 (unused when K == 0).
// `threads` must be a multiple of C, and S * rows_per_split >= HW.
INFODIFF_EXPORT int infodiff_adagn(const void* x, float* partial,
                                   const float* gamma, const float* beta,
                                   const float* films, void* out, int B,
                                   int HW, int C, int G, int K, int S,
                                   int rows_per_split, int threads, int dtype,
                                   cudaStream_t stream) {
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, partial, gamma, beta, films, out, B, HW,
                                 C, G, K, S, rows_per_split, threads, stream);
  return launch<float>(x, partial, gamma, beta, films, out, B, HW, C, G, K, S,
                       rows_per_split, threads, stream);
}
