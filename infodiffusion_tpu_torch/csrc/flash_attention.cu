// K3a: flash-attention forward out = softmax(q k^T * C^-1/2) v for
// q/k/v/out [B, N, C], C = 128, any N.
//
// Replaces infodiffusion_tpu/ops/pallas/flash_attention.py (_kernel /
// _fwd_call), the route the JAX package takes for N >= 512 tokens (the
// 128px model's N = 1024 attention). Contract, line by line that of
// _kernel: f32 logits times C^-1/2, f32 row max and sum, the weights w
// rounded to v's dtype before PV, PV accumulated in f32, the output in
// v's dtype.
//
// The TPU kernel holds the whole [N, C] k and v and a [BQ, N] f32 strip
// in VMEM. Here a block owns 64 query rows and streams k/v in 64-row
// tiles through shared memory, so any N runs. Rounding w needs each row's
// final max and sum before any PV product, so the block walks k twice:
// pass 1 keeps a running row max and sum, pass 2 recomputes the logits,
// forms w = exp(s - max) / sum and accumulates w v. At N = 1024 that is
// 6 B N^2 C FLOPs (PV and q k^T twice) on 8 B N C bytes: the products,
// not memory, bound it.
//
// bf16 (the training path) runs the products on the tensor cores
// (mma.sync m16n8k16, f32 accumulation; flash_mma.cuh): 4 warps of 16
// query rows, k/v tiles of bf16 in 52 KB, the rounded weights fed to PV
// straight from the accumulators. f32 runs them as f32 FMAs on f32 tiles
// (flash_common.cuh), 256 threads and 85 KB per block.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

namespace fma_fwd {

using namespace flash;

constexpr size_t kSmemBytes = (2 * kTileFloats + kPFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int N, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][kLD]
  float* kv = qs + kTileFloats;                 // [64][kLD]: k, then v
  float* ps = kv + kTileFloats;                 // [64][kLDP]: weights
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t off = (size_t)b * N * kC;
  load_tile(qs, q + off, q0, N);

  float m[4], l[4];
  row_stats(qs, kv, k + off, N, scale, m, l);

  float o[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(kv, k + off, k0, N);
    __syncthreads();
    float s[4][4];
    mm_nt(qs, kv, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float w = k0 + s_col(bb) < N
                            ? expf(s[a][bb] * scale - m[a]) / l[a]
                            : 0.f;
        ps[s_row(a) * kLDP + s_col(bb)] = w;
      }
    __syncthreads();
    load_tile(kv, v + off, k0, N);
    __syncthreads();
    mm_nn_acc(ps, kv, o);
  }
  float* ob = out + off;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (q0 + o_row(r) < N)
      store4(ob + (size_t)(q0 + o_row(r)) * kC + o_col(), o[r]);
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N,
      1.0f / sqrtf((float)kC));
  return (int)cudaGetLastError();
}

}  // namespace fma_fwd

namespace mma_fwd {

using namespace flash_mma;

constexpr size_t kSmemBytes = 3 * kTileElems * sizeof(bf16);

__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int N, float scale) {
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* ks = qs + kTileElems;
  bf16* vs = ks + kTileElems;
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int m0 = (threadIdx.x / 32) * 16;
  const int g = lane() / 4, t = lane() % 4;
  const size_t off = (size_t)b * N * kC;
  load_tile(qs, q + off, q0, N);

  float m[2], l[2];
  row_stats(qs, ks, k + off, N, scale, m, l);

  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, k + off, k0, N);
    load_tile(vs, v + off, k0, N);
    __syncthreads();
    float s[8][4];
    mm_abt(s, qs, m0, ks);
    // w = exp(s - max) / sum in f32, rounded to bf16 as A fragments
    unsigned p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = k0 + acc_col(n, e) < N
                     ? expf(s[n][e] * scale - m[e / 2]) / l[e / 2]
                     : 0.f;
        p[kk][2 * half] = pack(w[0], w[1]);
        p[kk][2 * half + 1] = pack(w[2], w[3]);
      }
    mm_px(o, p, vs);
  }
  bf16* ob = out + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * kC + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  flash_fwd_mma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N,
      1.0f / sqrtf((float)kC));
  return (int)cudaGetLastError();
}

}  // namespace mma_fwd

}  // namespace

// q, k, v, out: [B, N, 128] of `dtype`, contiguous, 16-byte aligned.
INFODIFF_EXPORT int infodiff_flash_attention(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int N, int C, int dtype,
                                             cudaStream_t stream) {
  if (C != flash::kC || N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) return mma_fwd::launch(q, k, v, out, B, N, stream);
  return fma_fwd::launch(q, k, v, out, B, N, stream);
}
