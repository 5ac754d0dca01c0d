// K3b: flash-attention backward for q/k/v/do [B, N, C], C = 64, 128, 256
// or 512, any N.
//
// Replaces infodiffusion_tpu/ops/pallas/flash_attention.py (_bwd_kernel /
// _bwd_call), the JAX package's one backward kernel (also the online
// forward's: its VJP delegates to the primary's). Contract 0, line by line
// that of _bwd_kernel: recompute w in f32 from the full row;
// dp = do v^T (f32 accumulation); delta = rowsum(w * dp);
// ds = w (dp - delta) scale; ds_c = ds in q's dtype and w_c = w in v's
// dtype; dq = ds_c k, dk = ds_c^T q, dv = w_c^T do, accumulated in f32;
// dq in q's dtype, dk and dv in k's and v's. Contract 1 (dense) is XLA's
// autodiff of the dense attention, the gradient the JAX package takes below
// its flash gate and wherever _bwd_call's plan refuses the shape: dp is
// rounded to bf16 right after do v^T, delta = rowsum(w bf16(dp)), and ds
// stays f32 into dq and dk. In f32 the two contracts are one function.
//
// The TPU kernel walks q tiles in order on one core and accumulates dk/dv
// in VMEM across them. Blocks on the card run in no order, so the backward
// is two launches, deterministic and free of atomics: (i) per query tile,
// the row statistics and dq; (ii) per key tile, dk and dv from the saved
// statistics. The products bound it (2 B N^2 C FLOPs each).
//
// bf16 (every training path) runs flash_bwd_wgmma.cuh's body on Hopper's
// warpgroup products: resident whole-C tiles, the streamed operand through
// a TMA ring, the statistics of (i) in one online pass, 9 products (11 on
// the dense contract, which carries ds as hi + lo); flash_bwd_launch_plan
// (ops/cuda/flash_attention.py) picks each launch's tiles, and the entry
// checks the plan against the kernels' own sizes. f32 runs plain FMAs on
// f32 tiles (flash_common.cuh), rows scratch [B, N, 3]: (i) takes a pass
// over k for each row's max and sum, one for delta and one for dq; (ii)
// loops over all q tiles for its 64 keys; C = 256 and 512 through
// 128-channel chunks, C = 64 as C = 128 with channels 64-127 zero.
#include "flash_bwd_wgmma.cuh"
#include "flash_common.cuh"

namespace {

namespace fma_bwd {

using namespace flash;

constexpr size_t kRowsSmem = (4 * kTileFloats + kPFloats) * sizeof(float);
constexpr size_t kColsSmem = (4 * kTileFloats + 2 * kPFloats) * sizeof(float);

template <int C>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_rows_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          float* __restrict__ dq, float* __restrict__ rowstats,
                          int N, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;  // ds
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t off = (size_t)b * N * C;
  const float *qb = q + off, *kb = k + off, *vb = v + off, *dob = dout + off;
  if (C <= kC) {
    load_chunk<C>(qs, qb, q0, N, 0);
    load_chunk<C>(dos, dob, q0, N, 0);
  }

  float m[4], l[4];
  row_stats<C>(qs, ks, qb, q0, kb, N, scale, m, l);

  // delta = rowsum(w * dp), w in f32
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += kTile) {
    float s[4][4], dp[4][4];
    s_tile<C>(s, qs, ks, qb, q0, kb, k0, N);
    s_tile<C>(dp, dos, vs, dob, q0, vb, k0, N);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        if (k0 + s_col(bb) < N)
          delta[a] = fmaf(expf(s[a][bb] * scale - m[a]) / l[a], dp[a][bb],
                          delta[a]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) delta[a] = row_sum(delta[a]);

  // dq = sum over key tiles of ds_c k, one 128-channel slice at a time
  const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
#pragma unroll 1
  for (int oc = 0; oc < C; oc += kC) {
    float o[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kTile) {
      float s[4][4], dp[4][4];
      s_tile<C>(s, qs, ks, qb, q0, kb, k0, N);
      // at C <= kC ks still holds k's rows; else its slice oc comes here
      s_tile<C>(dp, dos, vs, dob, q0, vb, k0, N, C <= kC ? nullptr : ks, kb,
                oc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float ds = 0.f;
          if (k0 + s_col(bb) < N) {
            const float w = expf(s[a][bb] * scale - m[a]) / l[a];
            ds = w * (dp[a][bb] - delta[a]) * scale;
          }
          ps[s_row(a) * kLDP + s_col(bb)] = ds;
        }
      __syncthreads();
      mm_nn_acc(ps, ks, o);
    }
    store_rows<C>(dq + off, o, q0, N, oc, one);
  }
  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + s_row(a);
      if (row < N) {
        float* st = rowstats + ((size_t)b * N + row) * 3;
        st[0] = m[a];
        st[1] = l[a];
        st[2] = delta[a];
      }
    }
  }
}

// (ii) in f32: the block's 64 keys are the rows of s^T = k q^T and
// dp^T = v do^T, so w^T and ds^T land in shared memory as [key][query]
// and dv += w^T do, dk += ds^T q are row-major products.
template <int C>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_cols_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ rowstats,
                          float* __restrict__ dk, float* __restrict__ dv, int N,
                          float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* pw = dos + kTileFloats;  // w^T
  float* pds = pw + kPFloats;     // ds^T
  const int b = blockIdx.y, j0 = blockIdx.x * kTile;
  const size_t off = (size_t)b * N * C;
  const float *qb = q + off, *kb = k + off, *vb = v + off, *dob = dout + off;
  if (C <= kC) {
    load_chunk<C>(ks, kb, j0, N, 0);
    load_chunk<C>(vs, vb, j0, N, 0);
  }

  const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
#pragma unroll 1
  for (int oc = 0; oc < C; oc += kC) {
    float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
    for (int i0 = 0; i0 < N; i0 += kTile) {
      float s[4][4], dp[4][4];
      s_tile<C>(s, ks, qs, kb, j0, qb, i0, N);
      s_tile<C>(dp, vs, dos, vb, j0, dob, i0, N);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int row = i0 + s_col(bb);  // the query
        float m = 0.f, l = 1.f, delta = 0.f;
        if (row < N) {
          const float* st = rowstats + ((size_t)b * N + row) * 3;
          m = st[0];
          l = st[1];
          delta = st[2];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float w = 0.f, ds = 0.f;
          if (row < N && j0 + s_row(a) < N) {
            w = expf(s[a][bb] * scale - m) / l;
            ds = w * (dp[a][bb] - delta) * scale;
          }
          pw[s_row(a) * kLDP + s_col(bb)] = w;
          pds[s_row(a) * kLDP + s_col(bb)] = ds;
        }
      }
      __syncthreads();
      if (C > kC) {  // slice oc of the queries' q and do
        load_chunk<C>(qs, qb, i0, N, oc);
        load_chunk<C>(dos, dob, i0, N, oc);
        __syncthreads();
      }
      mm_nn_acc(pw, dos, dv_acc);
      mm_nn_acc(pds, qs, dk_acc);
    }
    store_rows<C>(dk + off, dk_acc, j0, N, oc, one);
    store_rows<C>(dv + off, dv_acc, j0, N, oc, one);
  }
}

template <int C>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* rowstats, int B, int N,
           cudaStream_t stream) {
  auto rows = flash_bwd_rows_kernel<C>;
  auto cols = flash_bwd_cols_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRowsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kColsSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  const float scale = 1.0f / sqrtf((float)C);
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  rows<<<grid, kThreads, kRowsSmem, stream>>>(q_, k_, v_, do_,
                                              static_cast<float*>(dq), rowstats,
                                              N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols<<<grid, kThreads, kColsSmem, stream>>>(q_, k_, v_, do_, rowstats,
                                              static_cast<float*>(dk),
                                              static_cast<float*>(dv), N, scale);
  return (int)cudaGetLastError();
}

}  // namespace fma_bwd

}  // namespace

// q, k, v, dout, dq, dk, dv: [B, N, C] of `dtype`, contiguous, 16-byte
// aligned, C in {64, 128, 256, 512}; contract 0 the Pallas backward's, 1
// the dense attention's autodiff. bf16: stats is f32 [B][2][stat_rows]
// scratch (stat_rows = N rounded up to 128) and (rows_bq, rows_smem,
// cols_bk, cols_smem, stat_rows) what flash_bwd_launch_plan gives; f32:
// stats is [B, N, 3] and the plan is ignored.
INFODIFF_EXPORT int infodiff_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* stats, int B, int N, int C, int dtype,
    int contract, int rows_bq, int rows_smem, int cols_bk, int cols_smem,
    int stat_rows, cudaStream_t stream) {
  if (B < 1 || N < 1 || contract < 0 || contract > 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    const int plan[5] = {rows_bq, rows_smem, cols_bk, cols_smem, stat_rows};
    return contract == 1
               ? flash_bwd::dispatch<true>(q, k, v, dout, dq, dk, dv, stats,
                                           B, N, C, plan, stream)
               : flash_bwd::dispatch<false>(q, k, v, dout, dq, dk, dv, stats,
                                            B, N, C, plan, stream);
  }
  switch (C) {
    case 64:
      return fma_bwd::launch<64>(q, k, v, dout, dq, dk, dv, stats, B, N,
                                 stream);
    case 128:
      return fma_bwd::launch<128>(q, k, v, dout, dq, dk, dv, stats, B, N,
                                  stream);
    case 256:
      return fma_bwd::launch<256>(q, k, v, dout, dq, dk, dv, stats, B, N,
                                  stream);
    case 512:
      return fma_bwd::launch<512>(q, k, v, dout, dq, dk, dv, stats, B, N,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}
