// K3a: flash-attention forward out = softmax(q k^T * C^-1/2) v for
// q/k/v/out [B, N, C], C = 64, 128, 256 or 512, any N.
//
// Replaces infodiffusion_tpu/ops/pallas/flash_attention.py (_kernel /
// _fwd_call), the route the JAX package takes from N = 512 tokens while
// its whole-k/v plan fits (the 128px model's N = 1024 attention, N = 4096
// at 512px, the vanilla UNet's C = 256 / 512 at 256px). Contract, line by
// line that of _kernel: f32 logits times C^-1/2, f32 row max and sum, the
// weights w rounded to v's dtype before PV, PV accumulated in f32, the
// output in v's dtype.
//
// The TPU kernel holds the whole [N, C] k and v and a [BQ, N] f32 strip
// in VMEM. Here a block owns BQ query rows and streams k/v through shared
// memory, so any N runs. Rounding w needs each row's final max and sum
// before any PV product, so the block walks k twice: pass 1 keeps a
// running row max and sum, pass 2 recomputes the logits, forms
// w = exp(s - max) / sum and accumulates w v. At the model's shapes that
// is 6 B N^2 C FLOPs (q k^T twice and PV) on 4 B N C elements: the
// products, not memory, bound it.
//
// bf16 (every main path) runs flash_wgmma.cuh's body: whole-C q tiles,
// the output accumulator over all C (the logits are computed once a pass),
// k/v through a TMA ring, wgmma for both products; flash_launch_plan
// (ops/cuda/flash_attention.py) picks BQ, and the launch checks that the
// plan's shared memory is the kernel's. f32 runs f32 FMAs on f32 tiles
// (flash_common.cuh), 256 threads and 116 KB per block, 128-channel
// chunks at C = 256 and 512. K2 beyond its resident logit strip keeps its
// own two-pass bodies (forward_two_pass in flash_mma.cuh and
// flash_common.cuh; attention.cu).
#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(flash::kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int N, float scale) {
  extern __shared__ float4 smem4[];
  const size_t off = (size_t)blockIdx.y * N * C;
  flash::forward_two_pass<C>(reinterpret_cast<float*>(smem4), q + off,
                             k + off, v + off, out + off,
                             blockIdx.x * flash::kTile, N, scale);
}

template <int C>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int N, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)flash::kTwoPassSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + flash::kTile - 1) / flash::kTile, B);
  kernel<<<grid, flash::kThreads, flash::kTwoPassSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N,
      1.0f / sqrtf((float)C));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, N, C] of `dtype`, contiguous, 16-byte aligned;
// C in {64, 128, 256, 512}; bf16: bq and smem from flash_launch_plan
// (ignored in f32).
INFODIFF_EXPORT int infodiff_flash_attention(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int N, int C, int dtype, int bq,
                                             int smem, cudaStream_t stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return flash_wgmma::dispatch<true>(q, k, v, out, B, N, C, bq, smem,
                                       stream);
  switch (C) {
    case 64:
      return launch_f32<64>(q, k, v, out, B, N, stream);
    case 128:
      return launch_f32<128>(q, k, v, out, B, N, stream);
    case 256:
      return launch_f32<256>(q, k, v, out, B, N, stream);
    case 512:
      return launch_f32<512>(q, k, v, out, B, N, stream);
  }
  return (int)cudaErrorInvalidValue;
}
