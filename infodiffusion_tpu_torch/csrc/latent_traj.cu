// K4: the whole latent DDIM/DDPM/reverse trajectory in one launch.
//
// Replaces infodiffusion_tpu/ops/pallas/latent_traj.py
// (latent_trajectory_pallas / _kernel): the bf16/f32 weight stream and the
// int8 one of the turbo tier (quantize_packed_weights). Each of the S
// steps runs the packed LatentUNet: 10 layers of [rows, 5d] x [5d, 4d] +
// bias (layer 0 reads only x @ W[0][:d]), times the precomputed 1 + FiLM
// row c_all[i, j], LayerNorm over the 4d hidden columns (mean and variance
// in f32, eps 1e-5), gamma/beta and SiLU; layer 9 emits eps = z[:, :d].
// Then
//     x = coef[i,0] * x + coef[i,1] * eps + coef[i,2] * noise[i].
// Matmul inputs are rounded to W's dtype (bf16 for int8 W) with f32
// accumulation, as the TPU kernel does.
//
// What bounds it: every step streams the weights (22.1 MB read of the
// 26.2 MB packed W in bf16 at d = 256) for a few operations per weight per
// batch row, and the 10 S layers form a chain of dependent exchanges. The
// design is the cluster core of latent_common.cuh: a cluster of up to 16
// blocks owns a row group for the whole trajectory and each of its ranks
// streams only its columns of W, so each weight byte is read once per row
// group per step (the TPU kernel's one read per step for the batch), from
// the L2, where W stays (evict-last) while the FiLM rows and the noise
// stream through (evict-first). The step loop and the layer loop run
// inside the kernel; the rank that owns an eps slice keeps those columns
// of x in f32 and sends their rounded copy to every peer's panel.
//
// The int8 weight stream: W int8 with a per-(layer, column) f32 scale
// table Wsc [L, 4d], pre-tiled by the wrapper (latent_int8_tiles) so each
// 64 x 64 tile is one bulk copy and each thread's A fragments one 16-byte
// load a row. It halves the bytes of bf16's stream; the weights convert to
// bf16 in registers (exact: |w| <= 127), the inputs are rounded to bf16,
// the f32 sum is scaled by Wsc[j] per column before the bias.
//
// Limits: d a multiple of 16 up to 1024; W f32, bf16 or int8 (with Wsc).
#include "latent_common.cuh"

namespace {

using latent::Args;

#define LATENT_TRAJ_KERNEL(NAME, WT)                                        \
  template <int G>                                                          \
  __global__ void __launch_bounds__(latent::kThreads, 1)                    \
      NAME(const __grid_constant__ Args a,                                  \
           const __grid_constant__ CUtensorMap tw,                          \
           const __grid_constant__ CUtensorMap tc) {                        \
    latent::body<latent::kTraj, WT, G>(a, &tw, &tc);                        \
  }

LATENT_TRAJ_KERNEL(latent_traj_f32_kernel, kF32)
LATENT_TRAJ_KERNEL(latent_traj_bf16_kernel, kBF16)
LATENT_TRAJ_KERNEL(latent_traj_int8_kernel, kInt8)

// the kernel for W's type and G rows
template <int G>
auto kernel_for(int dtype) {
  if constexpr (G > 16)  // f32 takes 8 or 16 rows
    return dtype == kInt8 ? latent_traj_int8_kernel<G>
                          : latent_traj_bf16_kernel<G>;
  else
    return dtype == kInt8   ? latent_traj_int8_kernel<G>
           : dtype == kBF16 ? latent_traj_bf16_kernel<G>
                            : latent_traj_f32_kernel<G>;
}

template <int G>
int launch_rows(const Args& a, int dtype, const CUtensorMap* maps,
                cudaStream_t stream) {
  auto kernel = kernel_for<G>(dtype);
  static bool ready[3] = {false, false, false};  // attributes set, per type
  if (!ready[dtype]) {
    const int err = latent::prepare(kernel);
    if (err) return err;
    ready[dtype] = true;
  }
  return latent::launch(kernel, a, maps, stream);
}

// the exchange latency probe: `rounds` rounds of what a hidden layer's
// statistics exchange does (mode 1: every rank st.async's 8 bytes to every
// peer and waits for its own R), or of barrier.cluster (mode 0). Rounds
// alternate between two barriers: a fast peer's next round may land before
// this rank's current one has completed.
__global__ void __launch_bounds__(32) cluster_exchange_probe(int rounds,
                                                             int mode) {
  using namespace flash_wgmma;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ __align__(8) float2 slots[2][latent::kMaxRanks];
  uint32_t R;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(R));
  const uint32_t rank = latent::cluster_rank();
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    mbar_expect_tx(smem_addr(&bar[0]), R * 8);
    mbar_expect_tx(smem_addr(&bar[1]), R * 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  latent::cluster_sync();
  for (int r = 0; r < rounds; ++r) {
    if (mode == 0) {
      latent::cluster_sync();
      continue;
    }
    const uint32_t b = smem_addr(&bar[r & 1]);
    if (threadIdx.x < R)
      latent::st_async2(latent::peer(smem_addr(&slots[r & 1][rank]),
                                     threadIdx.x),
                        (float)r, 1.f, latent::peer(b, threadIdx.x));
    latent::wait_cluster(b, (r >> 1) & 1);
    if (threadIdx.x == 0) mbar_expect_tx(b, R * 8);  // round r + 2
  }
  latent::cluster_sync();
}

}  // namespace

// xT, out: [B, d] f32; coef: [S, 3] f32; W: [L, 5d, 4d] f32 or bf16
// (`dtype` 0, 1), or for int8 (2) the pre-tiled stream of
// latent_int8_tiles ([L, d/16, kt, 64, 64]) with wsc [L, 4d] f32 (else
// null); c_all: [S, L, 4d] f32; noise: [S, B, d] f32; bias, gam, bet:
// [L, 4d] f32; scratch: the plan's scratch_bytes. All contiguous. Launches
// the caller's plan (latent_launch_plan: ranks, rows, clusters, stages,
// shared bytes), which must be this entry's own for (B, d, dtype, sms,
// max_active).
INFODIFF_EXPORT int infodiff_latent_traj(
    const float* xT, const float* coef, const void* W, const float* c_all,
    const float* noise, const float* bias, const float* gam,
    const float* bet, const float* wsc, float* out, void* scratch, int B,
    int S, int L,
    int d, int dtype, int sms, int max_active, int ranks,
    int rows, int clusters, int stages, int smem, cudaStream_t stream) {
  Args a = {};
  if (S < 1 || L != latent::kLayers || (dtype == kInt8) != (wsc != nullptr) ||
      scratch == nullptr ||
      !latent::make_plan(latent::kTraj, dtype, B, d, sms, max_active, a.p) ||
      a.p.ranks != ranks || a.p.rows != rows || a.p.clusters != clusters ||
      a.p.stages != stages || a.p.smem != smem)
    return (int)cudaErrorInvalidValue;
  a.x = xT;
  a.coef = coef;
  a.W = W;
  a.film = c_all;
  a.noise = noise;
  a.bias = bias;
  a.gam = gam;
  a.bet = bet;
  a.wsc = wsc;
  a.out = out;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.B = B;
  a.S = S;
  a.d = d;
  CUtensorMap maps[2] = {};
  if (dtype != kInt8 &&
      !latent::layer_map(&maps[0], W, L, 5 * d, 4 * d, dtype == kF32))
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch_rows<8>(a, dtype, maps, stream);
    case 16: return launch_rows<16>(a, dtype, maps, stream);
    case 32: return launch_rows<32>(a, dtype, maps, stream);
    case 64: return launch_rows<64>(a, dtype, maps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// *out: clusters of `ranks` K4 blocks of W's `dtype` the card co-schedules
// (cudaOccupancyMaxActiveClusters at the most shared memory)
INFODIFF_EXPORT int infodiff_latent_traj_clusters(int dtype, int ranks,
                                                  int* out) {
  if (ranks < 1 || ranks > latent::kMaxRanks || dtype < kF32 ||
      dtype > kInt8)
    return (int)cudaErrorInvalidValue;
  return latent::max_clusters(kernel_for<8>(dtype), ranks, out);
}

// `rounds` exchange rounds in one cluster of `ranks` blocks (mode 1:
// st.async to every peer and wait, as a layer's statistics exchange;
// mode 0: barrier.cluster)
INFODIFF_EXPORT int infodiff_cluster_exchange_probe(int ranks, int rounds,
                                                    int mode,
                                                    cudaStream_t stream) {
  if (ranks < 1 || ranks > latent::kMaxRanks || rounds < 0)
    return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_exchange_probe,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks);
  cfg.blockDim = dim3(32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, cluster_exchange_probe, rounds, mode);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}



