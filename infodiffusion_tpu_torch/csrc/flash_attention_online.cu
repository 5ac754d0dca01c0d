// K3c: the online-softmax flash-attention forward
// out = softmax(q k^T * C^-1/2) v for q/k/v/out [B, N, C], C = 64, 128,
// 256 or 512, any N.
//
// Replaces infodiffusion_tpu/ops/pallas/flash_attention.py
// (_online_kernel / _online_fwd_call / flash_attention_online), the route
// the JAX package takes where the primary kernel's whole-k/v plan does not
// fit (at C = 128 bf16 from N = 16384: the 512px model's level-2
// attention). Contract, line by line that of _online_kernel, per k tile:
//   s    = (q k^T, f32 accumulation) * C^-1/2
//   m'   = max(m, rowmax s);  p = exp(s - m') in f32;  corr = exp(m - m')
//   l'   = l corr + rowsum(p)                     (the f32 p)
//   acc' = acc corr + (p rounded to v's dtype) v  (f32 accumulation)
// and out = acc / l in v's dtype. m starts at -inf, so the first tile's
// corr is 0. Unlike K3a, p is rounded unnormalised, after subtracting the
// running max; the k tile here is flash_launch_plan's BK (32 to 128 keys;
// JAX: up to 1024), so in bf16 the two differ by the rounding of p, not
// in f32.
//
// One pass over k: a block owns BQ query rows and streams k/v through
// shared memory, 4 B N^2 C FLOPs on 4 B N C elements, so the products
// bound it at the model's shapes. bf16 (every main path) runs
// flash_wgmma.cuh's body: whole-C q tiles and an output accumulator over
// all C, so the logits are computed once; k/v through a TMA ring; wgmma
// for q k^T and for PV, p fed from the S accumulators (from shared memory
// to the second warpgroup at C = 512); the running max and sum of a row
// live in the four lanes that hold it. f32 runs f32 FMAs on 128-channel
// chunks (flash_common.cuh); its output rows are laid out across the
// threads differently from its logit rows, so corr and l pass through
// shared memory. No backward: the JAX online VJP is the primary's (K3b).
#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

namespace fma_online {

using namespace flash;

constexpr size_t kSmemBytes =
    (3 * kTileFloats + kPFloats + 2 * kTile) * sizeof(float);

template <int C>
__global__ void __launch_bounds__(kThreads)
    flash_online_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int N, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][kLD]
  float* ks = qs + kTileFloats;                 // [64][kLD]
  float* vs = ks + kTileFloats;                 // [64][kLD]
  float* ps = vs + kTileFloats;                 // [64][kLDP]: p
  float* cs = ps + kPFloats;                    // [64]: corr per row
  float* ls = cs + kTile;                       // [64]: final l per row
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t off = (size_t)b * N * C;
  const float *qb = q + off, *kb = k + off, *vb = v + off;
  if (C <= kC) load_chunk<C>(qs, qb, q0, N, 0);

#pragma unroll 1
  for (int oc = 0; oc < C; oc += kC) {
    float m[4], l[4], o[8][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      m[a] = -INFINITY;
      l[a] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kTile) {
      float s[4][4];
      s_tile<C>(s, qs, ks, qb, q0, kb, k0, N, vs, vb, oc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float mx = -INFINITY;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          s[a][bb] = k0 + s_col(bb) < N ? s[a][bb] * scale : -INFINITY;
          mx = fmaxf(mx, s[a][bb]);
        }
        // key k0 is valid, so m_new is finite; the first tile's corr is 0
        const float m_new = fmaxf(m[a], row_max(mx));
        const float corr = expf(m[a] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float p = expf(s[a][bb] - m_new);
          sum += p;
          ps[s_row(a) * kLDP + s_col(bb)] = p;
        }
        l[a] = l[a] * corr + row_sum(sum);
        m[a] = m_new;
        if (threadIdx.x % 16 == 0) cs[s_row(a)] = corr;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float corr = cs[o_row(r)];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] *= corr;
      }
      mm_nn_acc(ps, vs, o);
    }
    if (threadIdx.x % 16 == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a) ls[s_row(a)] = l[a];
    }
    __syncthreads();
    float div[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) div[r] = ls[o_row(r)];
    store_rows<C>(out + off, o, q0, N, oc, div);
  }
}

template <int C>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, cudaStream_t stream) {
  auto kernel = flash_online_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N,
      1.0f / sqrtf((float)C));
  return (int)cudaGetLastError();
}

}  // namespace fma_online

}  // namespace

// q, k, v, out: [B, N, C] of `dtype`, contiguous, 16-byte aligned;
// C in {64, 128, 256, 512}; bf16: bq and smem from flash_launch_plan
// (ignored in f32).
INFODIFF_EXPORT int infodiff_flash_attention_online(
    const void* q, const void* k, const void* v, void* out, int B, int N,
    int C, int dtype, int bq, int smem, cudaStream_t stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return flash_wgmma::dispatch<false>(q, k, v, out, B, N, C, bq, smem,
                                        stream);
  switch (C) {
    case 64:
      return fma_online::launch<64>(q, k, v, out, B, N, stream);
    case 128:
      return fma_online::launch<128>(q, k, v, out, B, N, stream);
    case 256:
      return fma_online::launch<256>(q, k, v, out, B, N, stream);
    case 512:
      return fma_online::launch<512>(q, k, v, out, B, N, stream);
  }
  return (int)cudaErrorInvalidValue;
}
