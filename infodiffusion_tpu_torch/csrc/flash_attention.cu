// K3a: flash-attention forward out = softmax(q k^T * C^-1/2) v for
// q/k/v/out [B, N, C], C = 64, 128, 256 or 512, any N.
//
// Replaces infodiffusion_tpu/ops/pallas/flash_attention.py (_kernel /
// _fwd_call), the route the JAX package takes from N = 512 tokens while
// its whole-k/v plan fits (the 128px model's N = 1024 attention, N = 4096
// at 512px). Contract, line by line that of _kernel: f32 logits times
// C^-1/2, f32 row max and sum, the weights w rounded to v's dtype before
// PV, PV accumulated in f32, the output in v's dtype.
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
// C is a template parameter. The tiles hold 128 channels: at C = 128 the
// q tile stays resident; at C = 256 and 512 q k^T sums over 128-channel
// chunks of q and k, and each 128-channel slice of the output is a pass of
// its own over k (recomputing the logits), so shared memory and registers
// are those of C = 128 at the cost of (C / 128 + 1) q k^T products. At
// C = 64 the tiles' channels 64-127 are zero and not stored.
//
// bf16 (the training path) runs the products on the tensor cores
// (mma.sync m16n8k16, f32 accumulation; flash_mma.cuh): 4 warps of 16
// query rows, three bf16 tiles in 52 KB, the rounded weights fed to PV
// straight from the accumulators. f32 runs them as f32 FMAs on f32 tiles
// (flash_common.cuh), 256 threads and 116 KB per block. The block bodies
// (forward_two_pass in both headers) are also K2's beyond its resident
// logit strip (attention.cu).
#include "flash_common.cuh"
#include "flash_mma.cuh"

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
__global__ void __launch_bounds__(flash_mma::kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int N, float scale) {
  extern __shared__ uint4 smem_u4[];
  const size_t off = (size_t)blockIdx.y * N * C;
  flash_mma::forward_two_pass<C>(
      reinterpret_cast<__nv_bfloat16*>(smem_u4), q + off, k + off, v + off,
      out + off, blockIdx.x * flash_mma::kTile, N, scale);
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* out, int B, int N, int C,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + 63) / 64, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N,
      1.0f / sqrtf((float)C));
  return (int)cudaGetLastError();
}

template <int C>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int N, int dtype, cudaStream_t stream) {
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(flash_fwd_mma_kernel<C>, flash_mma::kThreads,
                                 flash_mma::kTwoPassSmem, q, k, v, out, B, N,
                                 C, stream);
  return launch<float>(flash_fwd_kernel<C>, flash::kThreads,
                       flash::kTwoPassSmem, q, k, v, out, B, N, C, stream);
}

}  // namespace

// q, k, v, out: [B, N, C] of `dtype`, contiguous, 16-byte aligned;
// C in {64, 128, 256, 512}.
INFODIFF_EXPORT int infodiff_flash_attention(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int N, int C, int dtype,
                                             cudaStream_t stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 64:
      return dispatch<64>(q, k, v, out, B, N, dtype, stream);
    case 128:
      return dispatch<128>(q, k, v, out, B, N, dtype, stream);
    case 256:
      return dispatch<256>(q, k, v, out, B, N, dtype, stream);
    case 512:
      return dispatch<512>(q, k, v, out, B, N, dtype, stream);
  }
  return (int)cudaErrorInvalidValue;
}
