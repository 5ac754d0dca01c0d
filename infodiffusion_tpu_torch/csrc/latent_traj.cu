// K4: the whole latent DDIM/DDPM/reverse trajectory in one launch.
//
// Replaces infodiffusion_tpu/ops/pallas/latent_traj.py
// (latent_trajectory_pallas / _kernel), the bf16/f32 weight stream. Each
// of the S steps runs the packed LatentUNet: 10 layers of
// [rows, 5d] x [5d, 4d] + bias (layer 0 reads only x @ W[0][:d]), times the
// precomputed 1 + FiLM row c_all[i, j], LayerNorm over the 4d hidden
// columns (two-pass mean and variance in f32, eps 1e-5), gamma/beta and
// SiLU; layer 9 emits eps = z[:, :d]. Then
//     x = coef[i,0] * x + coef[i,1] * eps + coef[i,2] * noise[i].
//
// What bounds it: every step streams all of W (26.2 MB in bf16 at
// d = 256, 52 MB in f32) while the arithmetic per weight byte is a few
// FMAs per batch row, so the weight stream bounds it: from L2 when W fits
// the H100's 50 MB L2 (bf16), from HBM when it does not (f32).
//
// Design: a block owns BT batch rows for the whole trajectory and never
// talks to another block, so no grid-wide synchronisation is needed; the
// step loop and the layer loop both run inside the kernel, which removes
// the ~40 launches per step of the plain version. The block keeps its
// rows' state x and the layer input [h, x] in shared memory; thread t owns
// the 4 output columns 4t .. 4t+3 of every layer, reads W row by row with
// one 8- or 16-byte load per row (a warp reads 256 or 512 contiguous
// bytes), and accumulates BT x 4 sums in registers. The wrapper picks BT
// so the grid covers the SMs: more blocks means more of W in flight.
// Matmul inputs are rounded to W's dtype with f32 accumulation, as the
// TPU kernel does.
//
// Limits: d <= 1024 (one thread per 4 hidden columns, h = 4d); BT in
// {1, 2, 4, 8}; W is f32 or bf16 (the int8 weight stream is not ported).
#include "common.cuh"

namespace {

constexpr float kEps = 1e-5f;

__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  w[0] = t.x;
  w[1] = t.y;
  w[2] = t.z;
  w[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// Sum v[r] over the block for each of the BT rows; every thread gets the
// totals. red holds [BT][32] per-warp partials, stat [BT] the totals.
template <int BT>
__device__ void block_sum(float (&v)[BT], float* red, float* stat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const float s = warp_sum(v[r]);
    if (lane == 0) red[r * 32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float s = warp_sum(lane < nw ? red[r * 32 + lane] : 0.f);
      if (lane == 0) stat[r] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BT; ++r) v[r] = stat[r];
}

template <typename WT, int BT>
__global__ void __launch_bounds__(1024)
    latent_traj_kernel(const float* __restrict__ xT,
                       const float* __restrict__ coef,
                       const WT* __restrict__ W,
                       const float* __restrict__ c_all,
                       const float* __restrict__ noise,
                       const float* __restrict__ bias,
                       const float* __restrict__ gam,
                       const float* __restrict__ bet, float* __restrict__ out,
                       int B, int S, int L, int d) {
  const int h = 4 * d, win = h + d;
  extern __shared__ float sm[];
  float* inp = sm;               // [BT][win] layer input [h, x], rounded to WT
  float* xs = inp + BT * win;    // [BT][d] f32 state
  float* red = xs + BT * d;      // [BT][32]
  float* stat = red + BT * 32;   // [BT]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BT;
  const bool active = tid < d;
  const int col = 4 * tid;

  for (int i = tid; i < BT * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    const float v = (row0 + r < B) ? xT[(size_t)(row0 + r) * d + c] : 0.f;
    xs[i] = v;
    inp[r * win + h + c] = round_to<WT>(v);
  }
  __syncthreads();

  for (int i = 0; i < S; ++i) {
    const float cx = coef[3 * i], ce = coef[3 * i + 1], cn = coef[3 * i + 2];
    for (int j = 0; j < L; ++j) {
      const bool last = j == L - 1;
      const int K = j == 0 ? d : win;
      const int in_off = j == 0 ? h : 0;
      const bool work = active && (!last || col < d);
      float z[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) z[r][c] = 0.f;
      if (work) {
        const WT* Wj = W + (size_t)j * win * h + col;
#pragma unroll 8
        for (int k = 0; k < K; ++k) {
          float w[4];
          load4(Wj + (size_t)k * h, w);
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float a = inp[r * win + in_off + k];
#pragma unroll
            for (int c = 0; c < 4; ++c) z[r][c] = fmaf(a, w[c], z[r][c]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bc = bias[j * h + col + c];
#pragma unroll
          for (int r = 0; r < BT; ++r) z[r][c] += bc;
        }
      }
      if (!last) {
        float g[4] = {0.f, 0.f, 0.f, 0.f}, be[4] = {0.f, 0.f, 0.f, 0.f};
        if (active) {
          const float* crow = c_all + ((size_t)i * L + j) * h + col;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            g[c] = gam[j * h + col + c];
            be[c] = bet[j * h + col + c];
#pragma unroll
            for (int r = 0; r < BT; ++r) z[r][c] *= crow[c];
          }
        }
        float mean[BT], var[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r)
          mean[r] = z[r][0] + z[r][1] + z[r][2] + z[r][3];
        block_sum<BT>(mean, red, stat);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          mean[r] /= (float)h;
          var[r] = 0.f;
          if (active) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float t = z[r][c] - mean[r];
              var[r] = fmaf(t, t, var[r]);
            }
          }
        }
        block_sum<BT>(var, red, stat);
        // every thread has left this layer's matmul: inp may be rewritten
        if (active) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float rstd = rsqrtf(var[r] / (float)h + kEps);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float t = fmaf((z[r][c] - mean[r]) * rstd, g[c], be[c]);
              inp[r * win + col + c] = round_to<WT>(t / (1.f + expf(-t)));
            }
          }
        }
      } else {
        __syncthreads();  // layer 9's matmul read the x part of inp
        if (work) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const int row = row0 + r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (col + c >= d) continue;
              const float n =
                  row < B ? noise[((size_t)i * B + row) * d + col + c] : 0.f;
              const float xn =
                  cx * xs[r * d + col + c] + ce * z[r][c] + cn * n;
              xs[r * d + col + c] = xn;
              inp[r * win + h + col + c] = round_to<WT>(xn);
            }
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < BT * d; i += blockDim.x) {
    const int r = i / d;
    if (row0 + r < B) out[(size_t)(row0 + r) * d + i % d] = xs[i];
  }
}

template <typename WT, int BT>
int launch(const float* xT, const float* coef, const void* W,
           const float* c_all, const float* noise, const float* bias,
           const float* gam, const float* bet, float* out, int B, int S,
           int L, int d, cudaStream_t stream) {
  const int threads = (d + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (BT * (5 * d) + BT * d + BT * 32 + BT);
  auto kernel = latent_traj_kernel<WT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + BT - 1) / BT;
  kernel<<<blocks, threads, smem, stream>>>(xT, coef,
                                            static_cast<const WT*>(W), c_all,
                                            noise, bias, gam, bet, out, B, S,
                                            L, d);
  return (int)cudaGetLastError();
}

template <typename WT>
int dispatch_bt(int bt, const float* xT, const float* coef, const void* W,
                const float* c_all, const float* noise, const float* bias,
                const float* gam, const float* bet, float* out, int B, int S,
                int L, int d, cudaStream_t stream) {
  switch (bt) {
    case 1:
      return launch<WT, 1>(xT, coef, W, c_all, noise, bias, gam, bet, out, B,
                           S, L, d, stream);
    case 2:
      return launch<WT, 2>(xT, coef, W, c_all, noise, bias, gam, bet, out, B,
                           S, L, d, stream);
    case 4:
      return launch<WT, 4>(xT, coef, W, c_all, noise, bias, gam, bet, out, B,
                           S, L, d, stream);
    case 8:
      return launch<WT, 8>(xT, coef, W, c_all, noise, bias, gam, bet, out, B,
                           S, L, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xT, out: [B, d] f32; coef: [S, 3] f32; W: [L, 5d, 4d] f32 or bf16
// (`dtype`); c_all: [S, L, 4d] f32; noise: [S, B, d] f32;
// bias, gam, bet: [L, 4d] f32. All contiguous.
INFODIFF_EXPORT int infodiff_latent_traj(const float* xT, const float* coef,
                                         const void* W, const float* c_all,
                                         const float* noise, const float* bias,
                                         const float* gam, const float* bet,
                                         float* out, int B, int S, int L,
                                         int d, int bt, int dtype,
                                         cudaStream_t stream) {
  if (d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return dispatch_bt<__nv_bfloat16>(bt, xT, coef, W, c_all, noise, bias,
                                      gam, bet, out, B, S, L, d, stream);
  return dispatch_bt<float>(bt, xT, coef, W, c_all, noise, bias, gam, bet, out,
                            B, S, L, d, stream);
}
