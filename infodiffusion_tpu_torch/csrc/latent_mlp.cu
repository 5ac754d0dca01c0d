// K5: one forward of the packed LatentUNet, eps = MLP(x, s), per launch.
//
// Replaces infodiffusion_tpu/ops/pallas/latent_mlp.py
// (latent_unet_forward_pallas / _kernel). For each batch row, with
// s = silu(time embedding) of that row's own timestep:
//     layer i:  z = [h, x] W[i] + B[i]          (layer 0 reads x @ W[0][:d])
//     i < 9:    c = s Wc[i] + Bc[i];  z *= 1 + c
//               LayerNorm over the 4d columns (mean and variance in f32,
//               eps 1e-5), gamma/beta, SiLU -> h
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
// What bounds it: the W it needs (layer 0's x rows, the last layer's eps
// columns: 22.1 MB in bf16 at d = 256) and Wc of layers 0-8 (4.7 MB) for a
// few operations per weight per batch row, read from the L2, plus the
// chain of 10 layers' exchanges. It runs K4's cluster core
// (latent_common.cuh) with S = 1: each rank streams its columns of W and
// of Wc once for its row group, the FiLM product on the same tensor-core
// path over the s chunks of the panel. Nothing stays on chip across
// launches.
//
// Limits: d a multiple of 16 up to 1024; W and Wc f32 or bf16.
#include "latent_common.cuh"

namespace {

using latent::Args;

#define LATENT_MLP_KERNEL(NAME, WT)                                         \
  template <int G>                                                          \
  __global__ void __launch_bounds__(latent::kThreads, 1)                    \
      NAME(const __grid_constant__ Args a,                                  \
           const __grid_constant__ CUtensorMap tw,                          \
           const __grid_constant__ CUtensorMap tc) {                        \
    latent::body<latent::kMlp, WT, G>(a, &tw, &tc);                         \
  }

LATENT_MLP_KERNEL(latent_mlp_f32_kernel, kF32)
LATENT_MLP_KERNEL(latent_mlp_bf16_kernel, kBF16)

// the kernel for W's type and G rows
template <int G>
auto kernel_for(int dtype) {
  if constexpr (G > 16)  // f32 takes 8 or 16 rows
    return latent_mlp_bf16_kernel<G>;
  else
    return dtype == kBF16 ? latent_mlp_bf16_kernel<G>
                          : latent_mlp_f32_kernel<G>;
}

template <int G>
int launch_rows(const Args& a, int dtype, const CUtensorMap* maps,
                cudaStream_t stream) {
  auto kernel = kernel_for<G>(dtype);
  static bool ready[2] = {false, false};  // attributes set, per type
  if (!ready[dtype]) {
    const int err = latent::prepare(kernel);
    if (err) return err;
    ready[dtype] = true;
  }
  return latent::launch(kernel, a, maps, stream);
}

}  // namespace

// x, s, out: [B, d] f32; W: [L, 5d, 4d] and Wc: [L, d, 4d] of `dtype`
// (0 f32, 1 bf16); bias, bc, gam, bet: [L, 4d] f32; scratch: the plan's
// scratch_bytes. All contiguous.
// Launches the caller's plan (latent_launch_plan), which must be this
// entry's own for (B, d, dtype, sms, max_active).
INFODIFF_EXPORT int infodiff_latent_mlp(
    const float* x, const float* s, const void* W, const void* Wc,
    const float* bias, const float* bc, const float* gam, const float* bet,
    float* out, void* scratch, int B, int L, int d, int dtype, int sms,
    int max_active, int ranks, int rows, int clusters, int stages, int smem,
    cudaStream_t stream) {
  latent::Args a = {};
  if (L != latent::kLayers || (dtype != kF32 && dtype != kBF16) ||
      scratch == nullptr ||
      !latent::make_plan(latent::kMlp, dtype, B, d, sms, max_active, a.p) ||
      a.p.ranks != ranks || a.p.rows != rows || a.p.clusters != clusters ||
      a.p.stages != stages || a.p.smem != smem)
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.film = s;
  a.W = W;
  a.bias = bias;
  a.bc = bc;
  a.gam = gam;
  a.bet = bet;
  a.out = out;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.B = B;
  a.S = 1;
  a.d = d;
  CUtensorMap maps[2] = {};
  const bool f32 = dtype == kF32;
  if (!latent::layer_map(&maps[0], W, L, 5 * d, 4 * d, f32) ||
      !latent::layer_map(&maps[1], Wc, L, d, 4 * d, f32))
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch_rows<8>(a, dtype, maps, stream);
    case 16: return launch_rows<16>(a, dtype, maps, stream);
    case 32: return launch_rows<32>(a, dtype, maps, stream);
    case 64: return launch_rows<64>(a, dtype, maps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// *out: clusters of `ranks` K5 blocks of W's `dtype` the card co-schedules
// (cudaOccupancyMaxActiveClusters at the most shared memory)
INFODIFF_EXPORT int infodiff_latent_mlp_clusters(int dtype, int ranks,
                                                 int* out) {
  if (ranks < 1 || ranks > latent::kMaxRanks ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  return latent::max_clusters(kernel_for<8>(dtype), ranks, out);
}
