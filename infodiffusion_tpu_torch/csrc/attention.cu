// K2: single-head attention out = softmax(q k^T * C^-1/2) v, per batch
// element, for q/k/v/out [B, N, C] with C = 128, 256 or 512.
//
// Replaces infodiffusion_tpu/ops/pallas/attention.py (attention_pallas /
// _kernel). The contract is ops/attention.py _attention_xla, the form the
// JAX main path runs: logits and softmax in f32, the weights w rounded to
// v's dtype before PV, PV accumulated in f32, the output stored in v's
// dtype. (The Pallas kernel keeps w in f32; the two differ only in bf16.)
//
// The TPU kernel holds a whole [N, N] row block in VMEM. Here one block
// owns 16 query rows and walks k/v in tiles of 32 rows through shared
// memory, so any N runs. Rounding w needs the final row max and sum before
// any PV product, so the block makes two passes over k: the first keeps a
// running max and sum, the second recomputes the logits, forms
// w = exp(s - max) / sum exactly as the contract does and accumulates w v.
// That doubles the q k^T work. At the models' N = 256 and 64 the kernel
// is bound by issue rate, not by bytes; the products are plain f32 FMAs
// (no tensor cores yet).
//
// C is a template parameter: the InfoDiff UNet attends at C = 128, the
// vanilla UNet and the VAE (ch_mult (1, 2, 4, 8)) at C = 256 (N = 256) and
// C = 512 (N = 64, the first middle block). The tiles are f32 in dynamic
// shared memory (43 KB at C = 128, 164 KB at C = 512, above the 48 KB
// static limit); in the PV product each of the 128 threads owns C / 128
// channels.
//
// K2' is the same kernel instantiated without the rounding of w: it
// replaces tools/microbench_attention.py (attention_pallas_tiled /
// _tiled_kernel), attention all in f32 (q, k, v upcast, f32 logits and
// softmax, w unrounded in PV, the output in v's dtype) with TB batch
// elements per grid step. Here a block owns the same 16 query rows of tb
// consecutive batch elements and walks them in turn. w stays f32, so PV
// stays on f32 FMAs (TF32 tensor cores would round it).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kQT = 16;       // query rows per block
constexpr int kKT = 32;       // key rows per tile (one warp lane each)
constexpr int kThreads = 128; // 4 warps
constexpr int kRowsPerGroup = kQT / (kThreads / kKT);  // 4

template <int C>
constexpr size_t smem_bytes() {
  // qs [kQT][C], ks and vs [kKT][C + 1], ps [kQT][kKT], row_m, row_l
  return sizeof(float) * (kQT * C + 2 * kKT * (C + 1) + kQT * kKT + 2 * kQT);
}

template <int C, typename T>
__device__ void load_tile(float* dst, const T* src, int row0, int N) {
  for (int i = threadIdx.x; i < kKT * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dst[r * (C + 1) + c] =
        (row0 + r < N) ? to_f32(src[(size_t)(row0 + r) * C + c]) : 0.f;
  }
}

// One batch element's 16 query rows from q0; kRoundW rounds w to T (K2)
// or keeps it f32 (K2').
template <int C, typename T, bool kRoundW>
__device__ void attend(const T* __restrict__ qb, const T* __restrict__ kb,
                       const T* __restrict__ vb, T* __restrict__ ob, int q0,
                       int N, float scale) {
  constexpr int kCPT = C / kThreads;  // output channels per thread
  extern __shared__ float sm[];
  float* qs = sm;                      // [kQT][C]
  float* ks = qs + kQT * C;            // [kKT][C + 1]: lanes read other rows
  float* vs = ks + kKT * (C + 1);      // [kKT][C + 1]
  float* ps = vs + kKT * (C + 1);      // [kQT][kKT]
  float* row_m = ps + kQT * kKT;       // [kQT]
  float* row_l = row_m + kQT;          // [kQT]

  const int tid = threadIdx.x;
  for (int i = tid; i < kQT * C; i += kThreads) {
    const int r = i / C, c = i % C;
    qs[r * C + c] = (q0 + r < N) ? to_f32(qb[(size_t)(q0 + r) * C + c]) : 0.f;
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
    for (int c = 0; c < C; ++c) {
      const float kv = ks[j * (C + 1) + c];
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r)
        s[r] = fmaf(qs[(rg * kRowsPerGroup + r) * C + c], kv, s[r]);
    }
    const bool valid = k0 + j < N;
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r)
      s[r] = valid ? s[r] * scale : -INFINITY;
  };

  // pass 1: running row max and sum of exp
  for (int k0 = 0; k0 < N; k0 += kKT) {
    load_tile<C>(ks, kb, k0, N);
    __syncthreads();
    float s[kRowsPerGroup];
    logits(k0, s);
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r)
      ps[(rg * kRowsPerGroup + r) * kKT + j] = s[r];
    __syncthreads();
    // warp w updates rows w*4 .. w*4+3; lane = key column
    for (int r = warp * kRowsPerGroup; r < (warp + 1) * kRowsPerGroup; ++r) {
      const float sv = ps[r * kKT + lane];
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
  float o[kQT][kCPT];
#pragma unroll
  for (int r = 0; r < kQT; ++r)
#pragma unroll
    for (int cc = 0; cc < kCPT; ++cc) o[r][cc] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kKT) {
    load_tile<C>(ks, kb, k0, N);
    load_tile<C>(vs, vb, k0, N);
    __syncthreads();
    float s[kRowsPerGroup];
    logits(k0, s);
#pragma unroll
    for (int r = 0; r < kRowsPerGroup; ++r) {
      const int row = rg * kRowsPerGroup + r;
      const float w = s[r] == -INFINITY
                          ? 0.f
                          : expf(s[r] - row_m[row]) / row_l[row];
      ps[row * kKT + j] = kRoundW ? round_to<T>(w) : w;
    }
    __syncthreads();
    for (int jj = 0; jj < kKT; ++jj) {
#pragma unroll
      for (int cc = 0; cc < kCPT; ++cc) {
        const float vv = vs[jj * (C + 1) + cc * kThreads + tid];
#pragma unroll
        for (int r = 0; r < kQT; ++r)
          o[r][cc] = fmaf(ps[r * kKT + jj], vv, o[r][cc]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kQT; ++r)
    if (q0 + r < N)
#pragma unroll
      for (int cc = 0; cc < kCPT; ++cc)
        ob[(size_t)(q0 + r) * C + cc * kThreads + tid] = from_f32<T>(o[r][cc]);
}

// grid (query tiles, B / tb): batch elements blockIdx.y * tb .. + tb - 1
template <int C, typename T, bool kRoundW>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int N,
                     float scale, int tb) {
  const int q0 = blockIdx.x * kQT;
  // K2 owns one element a block: a loop the compiler sees to run once
  const int n = kRoundW ? 1 : tb;
  for (int i = 0; i < n; ++i) {
    // the previous element's last pass ended at a barrier
    const size_t off = (size_t)(blockIdx.y * tb + i) * N * C;
    attend<C, T, kRoundW>(q + off, k + off, v + off, out + off, q0, N, scale);
  }
}

template <int C, typename T, bool kRoundW>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int tb, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  auto kernel = attention_kernel<C, T, kRoundW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kQT - 1) / kQT, B / tb);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N,
      1.0f / sqrtf((float)C), tb);
  return (int)cudaGetLastError();
}

template <typename T, bool kRoundW>
int dispatch_c(const void* q, const void* k, const void* v, void* out, int B,
               int N, int C, int tb, cudaStream_t stream) {
  switch (C) {
    case 128:
      return launch<128, T, kRoundW>(q, k, v, out, B, N, tb, stream);
    case 256:
      return launch<256, T, kRoundW>(q, k, v, out, B, N, tb, stream);
    case 512:
      return launch<512, T, kRoundW>(q, k, v, out, B, N, tb, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kRoundW>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int N, int C, int dtype, int tb, cudaStream_t stream) {
  if (B < 1 || N < 1 || tb < 1 || B % tb) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return dispatch_c<__nv_bfloat16, kRoundW>(q, k, v, out, B, N, C, tb,
                                              stream);
  return dispatch_c<float, kRoundW>(q, k, v, out, B, N, C, tb, stream);
}

}  // namespace

// K2. q, k, v, out: [B, N, C] of `dtype`, contiguous; C in {128, 256, 512}.
INFODIFF_EXPORT int infodiff_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int N,
                                       int C, int dtype, cudaStream_t stream) {
  return dispatch<true>(q, k, v, out, B, N, C, dtype, 1, stream);
}

// K2': the same shapes; tb divides B.
INFODIFF_EXPORT int infodiff_attention_tiled(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int N, int C, int dtype, int tb,
                                             cudaStream_t stream) {
  return dispatch<false>(q, k, v, out, B, N, C, dtype, tb, stream);
}
