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
// running max; the k tile here is 64 keys (JAX: up to 1024), so in bf16
// the two differ by the rounding of p, not in f32.
//
// One pass over k (FA2-style): a block owns 64 query rows and streams k/v
// in 64-row tiles through shared memory, 4 B N^2 C FLOPs on 4 B N C
// elements at C = 128, so the products bound it. At C = 256 and 512 the
// tiles hold 128-channel chunks as in K3a (flash_attention.cu): q k^T sums
// over the chunks and each 128-channel slice of the output is a pass over
// k of its own, which recomputes the logits and the identical running
// statistics. At C = 64 the tiles' channels 64-127 are zero and not
// stored.
//
// bf16 runs the products on the tensor cores (mma.sync m16n8k16,
// flash_mma.cuh): the running statistics of a row live in the four lanes
// that hold it, and p goes to PV from the accumulators. f32 runs f32 FMAs
// (flash_common.cuh); its output rows are laid out across the threads
// differently from its logit rows, so corr and l pass through shared
// memory. No backward: the JAX online VJP is the primary's (K3b).
#include "flash_common.cuh"
#include "flash_mma.cuh"

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

namespace mma_online {

using namespace flash_mma;

constexpr size_t kSmemBytes = 3 * kTileElems * sizeof(bf16);

template <int C>
__global__ void __launch_bounds__(kThreads)
    flash_online_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ out, int N, float scale) {
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* ks = qs + kTileElems;
  bf16* vs = ks + kTileElems;
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t off = (size_t)b * N * C;
  const bf16 *qb = q + off, *kb = k + off, *vb = v + off;
  if (C <= kC) load_chunk<C>(qs, qb, q0, N, 0);

#pragma unroll 1
  for (int oc = 0; oc < C; oc += kC) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kTile) {
      float s[8][4];
      s_tile<C>(s, qs, ks, qb, q0, kb, k0, N, vs, vb, oc);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = k0 + acc_col(n, e) < N ? s[n][e] * scale : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // key k0 is valid, so m_new is finite; the first tile's corr is 0
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
      // p = exp(s - m') in f32 for l; rounded to bf16 as A fragments for PV
      float sum[2] = {0.f, 0.f};
      unsigned p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 2 * kk + half;
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pe[e] = expf(s[n][e] - m[e / 2]);
            sum[e / 2] += pe[e];
          }
          p[kk][2 * half] = pack(pe[0], pe[1]);
          p[kk][2 * half + 1] = pack(pe[2], pe[3]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(sum[h]);
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
      mm_px<width<C>()>(o, p, vs);
    }
    store_rows<C>(out + off, o, q0, N, oc, l);
  }
}

template <int C>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, cudaStream_t stream) {
  auto kernel = flash_online_mma_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N,
      1.0f / sqrtf((float)C));
  return (int)cudaGetLastError();
}

}  // namespace mma_online

template <int C>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int N, int dtype, cudaStream_t stream) {
  if (dtype == kBF16)
    return mma_online::launch<C>(q, k, v, out, B, N, stream);
  return fma_online::launch<C>(q, k, v, out, B, N, stream);
}

}  // namespace

// q, k, v, out: [B, N, C] of `dtype`, contiguous, 16-byte aligned;
// C in {64, 128, 256, 512}.
INFODIFF_EXPORT int infodiff_flash_attention_online(const void* q,
                                                    const void* k,
                                                    const void* v, void* out,
                                                    int B, int N, int C,
                                                    int dtype,
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
