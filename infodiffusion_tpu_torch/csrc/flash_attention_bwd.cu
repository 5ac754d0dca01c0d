// K3b: flash-attention backward for q/k/v/do [B, N, C], C = 128, any N.
//
// Replaces infodiffusion_tpu/ops/pallas/flash_attention.py (_bwd_kernel /
// _bwd_call), the JAX package's one backward kernel. Contract, line by
// line that of _bwd_kernel: recompute w in f32 from the full row;
// dp = do v^T (f32 accumulation); delta = rowsum(w * dp);
// ds = w (dp - delta) scale; ds_c = ds in q's dtype and w_c = w in v's
// dtype; dq = ds_c k, dk = ds_c^T q, dv = w_c^T do, accumulated in f32;
// dq in q's dtype, dk and dv in k's and v's.
//
// The TPU kernel walks q tiles in order on one core and accumulates dk/dv
// in VMEM across them. Blocks on the card run in no order, so the
// backward is two launches, deterministic and free of atomics:
//
//   (i)  flash_bwd_rows, grid (q tile, batch): each row's max m and sum l
//        (one pass over k), then delta (a pass over k and v), then
//        dq = sum over key tiles of ds_c k (a third pass); writes dq and
//        the row statistics [B, N, 3] = (m, l, delta) in f32.
//   (ii) flash_bwd_cols, grid (k/v tile, batch): loops over all q tiles,
//        recomputes w and ds from the saved row statistics and
//        accumulates dk and dv for its 64 keys in f32 registers.
//
// That is 10 matrix products of 2 B N^2 C FLOPs each per call (q k^T three
// times and do v^T twice in (i), both once more and the two accumulations
// in (ii)); the products bound it. bf16 (the training path) runs them on
// the tensor cores (mma.sync m16n8k16, f32 accumulation; flash_mma.cuh),
// with w and ds fed to the next product from the accumulators; in (ii) a
// warp computes s^T and dp^T for its 16 keys directly, so w^T and ds^T are
// A fragments too. f32 runs plain FMAs on f32 tiles (flash_common.cuh).
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

namespace fma_bwd {

using namespace flash;

constexpr size_t kRowsSmem = (4 * kTileFloats + kPFloats) * sizeof(float);
constexpr size_t kColsSmem = (4 * kTileFloats + 2 * kPFloats) * sizeof(float);

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
  const size_t off = (size_t)b * N * kC;
  load_tile(qs, q + off, q0, N);
  load_tile(dos, dout + off, q0, N);

  float m[4], l[4];
  row_stats(qs, ks, k + off, N, scale, m, l);

  // delta = rowsum(w * dp), w in f32
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, k + off, k0, N);
    load_tile(vs, v + off, k0, N);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt(qs, ks, s);
    mm_nt(dos, vs, dp);
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

  // dq = sum over key tiles of ds_c k
  float o[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, k + off, k0, N);
    load_tile(vs, v + off, k0, N);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt(qs, ks, s);
    mm_nt(dos, vs, dp);
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
  float* dqb = dq + off;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (q0 + o_row(r) < N)
      store4(dqb + (size_t)(q0 + o_row(r)) * kC + o_col(), o[r]);
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
  float* pw = dos + kTileFloats;  // w
  float* pds = pw + kPFloats;     // ds
  const int b = blockIdx.y, j0 = blockIdx.x * kTile;
  const size_t off = (size_t)b * N * kC;
  load_tile(ks, k + off, j0, N);
  load_tile(vs, v + off, j0, N);

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    load_tile(qs, q + off, i0, N);
    load_tile(dos, dout + off, i0, N);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt(qs, ks, s);
    mm_nt(dos, vs, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i0 + s_row(a);
      float m = 0.f, l = 1.f, delta = 0.f;
      if (row < N) {
        const float* st = rowstats + ((size_t)b * N + row) * 3;
        m = st[0];
        l = st[1];
        delta = st[2];
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        float w = 0.f, ds = 0.f;
        if (row < N && j0 + s_col(bb) < N) {
          w = expf(s[a][bb] * scale - m) / l;
          ds = w * (dp[a][bb] - delta) * scale;
        }
        pw[s_row(a) * kLDP + s_col(bb)] = w;
        pds[s_row(a) * kLDP + s_col(bb)] = ds;
      }
    }
    __syncthreads();
    mm_tn_acc(pw, dos, dv_acc);
    mm_tn_acc(pds, qs, dk_acc);
  }
  float* dkb = dk + off;
  float* dvb = dv + off;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (j0 + o_row(r) < N) {
      const size_t i = (size_t)(j0 + o_row(r)) * kC + o_col();
      store4(dkb + i, dk_acc[r]);
      store4(dvb + i, dv_acc[r]);
    }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* rowstats, int B, int N,
           cudaStream_t stream) {
  auto rows = flash_bwd_rows_kernel;
  auto cols = flash_bwd_cols_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRowsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kColsSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  const float scale = 1.0f / sqrtf((float)kC);
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

namespace mma_bwd {

using namespace flash_mma;

constexpr size_t kRowsSmem = 4 * kTileElems * sizeof(bf16);
constexpr size_t kColsSmem = 4 * kTileElems * sizeof(bf16) +
                             3 * kTile * sizeof(float);

// s = q k^T and dp = do v^T for the warp's 16 rows against one k/v tile
__device__ __forceinline__ void s_and_dp(const bf16* qs, const bf16* dos,
                                         const bf16* ks, const bf16* vs,
                                         int m0, float (&s)[8][4],
                                         float (&dp)[8][4]) {
  mm_abt(s, qs, m0, ks);
  mm_abt(dp, dos, m0, vs);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_rows_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              bf16* __restrict__ dq,
                              float* __restrict__ rowstats, int N,
                              float scale) {
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dos = qs + kTileElems;
  bf16* ks = dos + kTileElems;
  bf16* vs = ks + kTileElems;
  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int m0 = (threadIdx.x / 32) * 16;
  const int g = lane() / 4, t = lane() % 4;
  const size_t off = (size_t)b * N * kC;
  load_tile(qs, q + off, q0, N);
  load_tile(dos, dout + off, q0, N);

  float m[2], l[2];
  row_stats(qs, ks, k + off, N, scale, m, l);

  // delta = rowsum(w * dp), w in f32
  float delta[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, k + off, k0, N);
    load_tile(vs, v + off, k0, N);
    __syncthreads();
    float s[8][4], dp[8][4];
    s_and_dp(qs, dos, ks, vs, m0, s, dp);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + acc_col(n, e) < N)
          delta[e / 2] = fmaf(expf(s[n][e] * scale - m[e / 2]) / l[e / 2],
                              dp[n][e], delta[e / 2]);
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  // dq = sum over key tiles of ds_c k
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
    float s[8][4], dp[8][4];
    s_and_dp(qs, dos, ks, vs, m0, s, dp);
    unsigned p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = 0.f;
          if (k0 + acc_col(n, e) < N) {
            const float w = expf(s[n][e] * scale - m[e / 2]) / l[e / 2];
            ds[e] = w * (dp[n][e] - delta[e / 2]) * scale;
          }
        }
        p[kk][2 * half] = pack(ds[0], ds[1]);
        p[kk][2 * half + 1] = pack(ds[2], ds[3]);
      }
    mm_px(o, p, ks);
  }
  bf16* dqb = dq + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row * kC + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
    if (t == 0) {
      float* st = rowstats + ((size_t)b * N + row) * 3;
      st[0] = m[h];
      st[1] = l[h];
      st[2] = delta[h];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_cols_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ rowstats,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int N, float scale) {
  extern __shared__ uint4 smem_u4[];
  bf16* ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* vs = ks + kTileElems;
  bf16* qs = vs + kTileElems;
  bf16* dos = qs + kTileElems;
  float* st = reinterpret_cast<float*>(dos + kTileElems);  // [64][3]
  const int b = blockIdx.y, j0 = blockIdx.x * kTile;
  const int m0 = (threadIdx.x / 32) * 16;  // the warp's 16 keys
  const int g = lane() / 4, t = lane() % 4;
  const size_t off = (size_t)b * N * kC;
  load_tile(ks, k + off, j0, N);
  load_tile(vs, v + off, j0, N);

  float dk_acc[16][4], dv_acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    load_tile(qs, q + off, i0, N);
    load_tile(dos, dout + off, i0, N);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool valid = i0 + i < N;
      const float* src = rowstats + ((size_t)b * N + i0 + i) * 3;
      st[3 * i] = valid ? src[0] : 0.f;
      st[3 * i + 1] = valid ? src[1] : 1.f;
      st[3 * i + 2] = valid ? src[2] : 0.f;
    }
    __syncthreads();
    // 16 queries at a time: s^T = k q^T and dp^T = v do^T for the warp's
    // keys (rows) against queries qc .. qc + 15 (columns)
#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += 16) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        unsigned a[4], bq[4];
        load_a(a, ks, m0, kk * 16);
        load_b_nk(bq, qs, qc, kk * 16);
        mma(s[0], a, bq[0], bq[1]);
        mma(s[1], a, bq[2], bq[3]);
        load_a(a, vs, m0, kk * 16);
        load_b_nk(bq, dos, qc, kk * 16);
        mma(dp[0], a, bq[0], bq[1]);
        mma(dp[1], a, bq[2], bq[3]);
      }
      unsigned pw[4], pds[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float w[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc + acc_col(n, e);           // query in the tile
          const int key = j0 + m0 + g + 8 * (e / 2);   // key of this row
          w[e] = ds[e] = 0.f;
          if (i0 + qi < N && key < N) {
            w[e] = expf(s[n][e] * scale - st[3 * qi]) / st[3 * qi + 1];
            ds[e] = w[e] * (dp[n][e] - st[3 * qi + 2]) * scale;
          }
        }
        pw[2 * n] = pack(w[0], w[1]);
        pw[2 * n + 1] = pack(w[2], w[3]);
        pds[2 * n] = pack(ds[0], ds[1]);
        pds[2 * n + 1] = pack(ds[2], ds[3]);
      }
      // dv += w_c^T do and dk += ds_c^T q over these 16 queries
#pragma unroll
      for (int n2 = 0; n2 < 8; ++n2) {
        unsigned bx[4];
        load_b_kn(bx, dos, qc, n2 * 16);
        mma(dv_acc[2 * n2], pw, bx[0], bx[1]);
        mma(dv_acc[2 * n2 + 1], pw, bx[2], bx[3]);
        load_b_kn(bx, qs, qc, n2 * 16);
        mma(dk_acc[2 * n2], pds, bx[0], bx[1]);
        mma(dk_acc[2 * n2 + 1], pds, bx[2], bx[3]);
      }
    }
  }
  bf16* dkb = dk + off;
  bf16* dvb = dv + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = j0 + m0 + g + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const size_t i = (size_t)row * kC + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + i) =
          __floats2bfloat162_rn(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + i) =
          __floats2bfloat162_rn(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* rowstats, int B, int N,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kRowsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_cols_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kColsSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, B);
  const float scale = 1.0f / sqrtf((float)kC);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  flash_bwd_rows_mma_kernel<<<grid, kThreads, kRowsSmem, stream>>>(
      q_, k_, v_, do_, static_cast<bf16*>(dq), rowstats, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_cols_mma_kernel<<<grid, kThreads, kColsSmem, stream>>>(
      q_, k_, v_, do_, rowstats, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), N, scale);
  return (int)cudaGetLastError();
}

}  // namespace mma_bwd

}  // namespace

// q, k, v, dout, dq, dk, dv: [B, N, 128] of `dtype`, contiguous, 16-byte
// aligned; rowstats: [B, N, 3] f32 scratch.
INFODIFF_EXPORT int infodiff_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* rowstats, int B, int N, int C, int dtype,
    cudaStream_t stream) {
  if (C != flash::kC || N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return mma_bwd::launch(q, k, v, dout, dq, dk, dv, rowstats, B, N, stream);
  return fma_bwd::launch(q, k, v, dout, dq, dk, dv, rowstats, B, N,
                                stream);
}
