// K2: single-head attention out = softmax(q k^T * C^-1/2) v, per batch
// element, for q/k/v/out [B, N, C] with C = 128.
//
// Replaces infodiffusion_tpu/ops/pallas/attention.py (attention_pallas /
// _kernel). The contract is ops/attention.py _attention_xla, the form the
// JAX main path runs: logits and softmax in f32, the weights w rounded to
// v's dtype before PV, PV accumulated in f32, the output stored in v's
// dtype. (The Pallas kernel keeps w in f32; the two differ only in bf16.)
//
// The TPU kernel holds a whole [N, N] row block in VMEM. Here one block
// owns 16 query rows and walks k/v in tiles of 32 rows through shared
// memory, so any N runs in 43 KB of static shared memory. Rounding w
// needs the final row max and sum before any PV product, so the block
// makes two passes over k: the first keeps a running max and sum, the
// second recomputes the logits, forms w = exp(s - max) / sum exactly as
// the contract does and accumulates w v. That doubles the q k^T work. At
// the flagship's N = 256 and 64 the kernel is bound by issue rate, not by
// bytes; the products are plain f32 FMAs (no tensor cores yet).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kC = 128;       // channels
constexpr int kQT = 16;       // query rows per block
constexpr int kKT = 32;       // key rows per tile (one warp lane each)
constexpr int kThreads = 128; // 4 warps
constexpr int kRowsPerGroup = kQT / (kThreads / kKT);  // 4

template <typename T>
__device__ void load_tile(float (*dst)[kC + 1], const T* src, int row0, int N) {
  for (int i = threadIdx.x; i < kKT * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    dst[r][c] = (row0 + r < N) ? to_f32(src[(size_t)(row0 + r) * kC + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int N,
                     float scale) {
  __shared__ float qs[kQT][kC];
  __shared__ float ks[kKT][kC + 1];  // +1: lanes read different rows
  __shared__ float vs[kKT][kC + 1];
  __shared__ float ps[kQT][kKT];
  __shared__ float row_m[kQT], row_l[kQT];

  const int b = blockIdx.y, q0 = blockIdx.x * kQT, tid = threadIdx.x;
  const size_t off = (size_t)b * N * kC;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;
  for (int i = tid; i < kQT * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    qs[r][c] = (q0 + r < N) ? to_f32(qb[(size_t)(q0 + r) * kC + c]) : 0.f;
  }
  if (tid < kQT) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();

  // logits: thread (j, rg) computes rows rg*4 .. rg*4+3 against key j
  const int j = tid % kKT, rg = tid / kKT;
  const int warp = tid / 32, lane = tid % 32;
  auto logits = [&](int k0, float (&s)[kRowsPerGroup]) {
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r) s[r] = 0.f;
    for (int c = 0; c < kC; ++c) {
      const float kv = ks[j][c];
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r)
        s[r] = fmaf(qs[rg * kRowsPerGroup + r][c], kv, s[r]);
    }
    const bool valid = k0 + j < N;
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r)
      s[r] = valid ? s[r] * scale : -INFINITY;
  };

  // pass 1: running row max and sum of exp
  for (int k0 = 0; k0 < N; k0 += kKT) {
    load_tile(ks, kb, k0, N);
    __syncthreads();
    float s[kRowsPerGroup];
    logits(k0, s);
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r) ps[rg * kRowsPerGroup + r][j] = s[r];
    __syncthreads();
    // warp w updates rows w*4 .. w*4+3; lane = key column
    for (int r = warp * kRowsPerGroup; r < (warp + 1) * kRowsPerGroup; ++r) {
      const float sv = ps[r][lane];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float e = warp_sum(sv == -INFINITY ? 0.f : expf(sv - m_new));
      __syncwarp();
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + e;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
  }

  // pass 2: w = exp(s - max) / sum in f32, rounded to T, then w v in f32
  float o[kQT];
#pragma unroll
  for (int r = 0; r < kQT; ++r) o[r] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kKT) {
    load_tile(ks, kb, k0, N);
    load_tile(vs, vb, k0, N);
    __syncthreads();
    float s[kRowsPerGroup];
    logits(k0, s);
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r) {
      const int row = rg * kRowsPerGroup + r;
      const float w = s[r] == -INFINITY
                          ? 0.f
                          : expf(s[r] - row_m[row]) / row_l[row];
      ps[row][j] = round_to<T>(w);
    }
    __syncthreads();
    for (int jj = 0; jj < kKT; ++jj) {
      const float vv = vs[jj][tid];
#pragma unroll
      for (int r = 0; r < kQT; ++r) o[r] = fmaf(ps[r][jj], vv, o[r]);
    }
    __syncthreads();
  }
  T* ob = out + off;
#pragma unroll
  for (int r = 0; r < kQT; ++r)
    if (q0 + r < N) ob[(size_t)(q0 + r) * kC + tid] = from_f32<T>(o[r]);
}

}  // namespace

// q, k, v, out: [B, N, 128] of `dtype`, contiguous.
INFODIFF_EXPORT int infodiff_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int N,
                                       int C, int dtype, cudaStream_t stream) {
  if (C != kC) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kQT - 1) / kQT, B);
  const float scale = 1.0f / sqrtf((float)C);
  if (dtype == kBF16)
    attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), N, scale);
  else
    attention_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), N, scale);
  return (int)cudaGetLastError();
}
