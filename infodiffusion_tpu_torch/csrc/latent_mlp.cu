// K5: one forward of the packed LatentUNet, eps = MLP(x, s), per launch.
//
// Replaces infodiffusion_tpu/ops/pallas/latent_mlp.py
// (latent_unet_forward_pallas / _kernel). For each batch row, with
// s = silu(time embedding) of that row's own timestep:
//     layer i:  z = [h, x] W[i] + B[i]          (layer 0 reads x @ W[0][:d])
//     i < 9:    c = s Wc[i] + Bc[i];  z *= 1 + c
//               LayerNorm over the 4d columns (two-pass mean and variance
//               in f32, eps 1e-5), gamma/beta, SiLU -> h
//     i = 9:    eps = z[:, :d]
// The products take their inputs rounded to W's dtype (x, h and s) with f32
// accumulation, as the TPU kernel does.
//
// Against K4 (latent_traj.cu), which runs a whole trajectory: here t, and
// so the FiLM row s Wc[i] + Bc[i], differs per batch row, so that product
// runs inside the kernel, per layer, over Wc [L, d, 4d] (K4 takes the
// precomputed rows of a trajectory whose batch shares t). The time
// embedding MLP (two small Dense layers) stays outside, as in the JAX
// package. One launch per sampler step: 1000 for a full-grid sample, 998
// for a reverse encoding.
//
// What bounds it: every block streams the W it needs (layer 0's x rows,
// the last layer's eps columns: 22.2 MB in bf16 at d = 256) and Wc of
// layers 0-8 (4.7 MB) per forward for a few FMAs per weight per batch
// row, so, like K4, it is bound by that stream and by issue, from L2 in
// bf16. The row tiling, the column ownership and the product loop are K4's
// (latent_common.cuh); the wrapper picks BT so the grid covers the SMs.
//
// Limits: d <= 1024; BT in {1, 2, 4, 8}; W and Wc f32 or bf16.
#include "latent_common.cuh"

namespace {

using namespace latent_common;

template <typename WT, int BT>
__global__ void __launch_bounds__(1024)
    latent_mlp_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const WT* __restrict__ W, const WT* __restrict__ Wc,
                      const float* __restrict__ bias,
                      const float* __restrict__ bc,
                      const float* __restrict__ gam,
                      const float* __restrict__ bet, float* __restrict__ out,
                      int B, int L, int d) {
  const int h = 4 * d, win = h + d;
  extern __shared__ float sm[];
  float* inp = sm;             // [BT][win] layer input [h, x], rounded to WT
  float* ss = inp + BT * win;  // [BT][d] s, rounded to WT
  float* red = ss + BT * d;    // [BT][32]
  float* stat = red + BT * 32; // [BT]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BT;
  const bool active = tid < d;
  const int col = 4 * tid;

  for (int i = tid; i < BT * d; i += blockDim.x) {
    const int r = i / d, c = i % d, row = row0 + r;
    inp[r * win + h + c] = round_to<WT>(row < B ? x[(size_t)row * d + c] : 0.f);
    ss[i] = round_to<WT>(row < B ? s[(size_t)row * d + c] : 0.f);
  }
  __syncthreads();

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
      rows_times_columns<WT, BT>(W + (size_t)j * win * h + col, inp, win,
                                 in_off, K, h, z);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = bias[j * h + col + c];
#pragma unroll
        for (int r = 0; r < BT; ++r) z[r][c] += b;
      }
    }
    if (last) {
      if (work) {
#pragma unroll
        for (int r = 0; r < BT; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (row0 + r < B && col + c < d)
              out[(size_t)(row0 + r) * d + col + c] = z[r][c];
      }
      break;
    }
    float g[4] = {0.f, 0.f, 0.f, 0.f}, be[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      // this layer's FiLM rows, per batch row: c = s Wc[j] + Bc[j]
      float cz[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cz[r][c] = 0.f;
      rows_times_columns<WT, BT>(Wc + (size_t)j * d * h + col, ss, d, 0, d,
                                 h, cz);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        g[c] = gam[j * h + col + c];
        be[c] = bet[j * h + col + c];
        const float bcc = bc[j * h + col + c];
#pragma unroll
        for (int r = 0; r < BT; ++r) z[r][c] *= 1.f + (cz[r][c] + bcc);
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
    // every thread has left this layer's products: inp may be rewritten
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
    __syncthreads();
  }
}

template <typename WT, int BT>
int launch(const float* x, const float* s, const void* W, const void* Wc,
           const float* bias, const float* bc, const float* gam,
           const float* bet, float* out, int B, int L, int d,
           cudaStream_t stream) {
  const int threads = (d + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (BT * (5 * d) + BT * d + BT * 32 + BT);
  auto kernel = latent_mlp_kernel<WT, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + BT - 1) / BT, threads, smem, stream>>>(
      x, s, static_cast<const WT*>(W), static_cast<const WT*>(Wc), bias, bc,
      gam, bet, out, B, L, d);
  return (int)cudaGetLastError();
}

template <typename WT>
int dispatch_bt(int bt, const float* x, const float* s, const void* W,
                const void* Wc, const float* bias, const float* bc,
                const float* gam, const float* bet, float* out, int B, int L,
                int d, cudaStream_t stream) {
  switch (bt) {
    case 1:
      return launch<WT, 1>(x, s, W, Wc, bias, bc, gam, bet, out, B, L, d,
                           stream);
    case 2:
      return launch<WT, 2>(x, s, W, Wc, bias, bc, gam, bet, out, B, L, d,
                           stream);
    case 4:
      return launch<WT, 4>(x, s, W, Wc, bias, bc, gam, bet, out, B, L, d,
                           stream);
    case 8:
      return launch<WT, 8>(x, s, W, Wc, bias, bc, gam, bet, out, B, L, d,
                           stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, s, out: [B, d] f32; W: [L, 5d, 4d] and Wc: [L, d, 4d] of `dtype`
// (0 f32, 1 bf16); bias, bc, gam, bet: [L, 4d] f32. All contiguous.
INFODIFF_EXPORT int infodiff_latent_mlp(const float* x, const float* s,
                                        const void* W, const void* Wc,
                                        const float* bias, const float* bc,
                                        const float* gam, const float* bet,
                                        float* out, int B, int L, int d,
                                        int bt, int dtype,
                                        cudaStream_t stream) {
  if (d < 1 || d > 1024 || L < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return dispatch_bt<__nv_bfloat16>(bt, x, s, W, Wc, bias, bc, gam, bet, out,
                                      B, L, d, stream);
  if (dtype == kF32)
    return dispatch_bt<float>(bt, x, s, W, Wc, bias, bc, gam, bet, out, B, L,
                              d, stream);
  return (int)cudaErrorInvalidValue;
}
