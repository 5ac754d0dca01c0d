// K1: GroupNorm + K FiLMs (AdaGN) over x [B, HW, C], C fastest.
//
// Replaces infodiffusion_tpu/ops/pallas/adagn.py:90 (adagn_pallas; its
// body _kernel). Statistics in f32, one pass: mean = E[x], var = E[x^2] -
// mean^2 clamped at 0 (the XLA form of ops/norm.py; the Pallas kernel
// lacks the clamp), rstd = rsqrt(var + 1e-5); then
// ((x - mean) * rstd * gamma + beta), then h * (1 + s_k) + b_k for each
// FiLM, all in f32, rounded once to x's dtype. The kernels fold the
// affine and the FiLMs into per-channel rows first, h = (x - mean) * A + Bc
// with A = rstd * gamma * prod_k (1 + s_k) and Bc the FiLM chain on beta:
// the same function, in another f32 association.
//
// What bounds it: bytes. A few operations an element, so the least the
// card can take is x read once and written once at the memory rate. The
// TPU kernel holds one batch element in VMEM; an SM's 227 KB cannot, but
// a thread-block cluster's distributed shared memory can (up to 16 x
// 227 KB), so (adagn_common.cuh's plan):
//
// - resident (every 64px site, bf16 and f32): each rank bulk-copies its
//   contiguous slab of the element's rows into shared memory (chunks on
//   mbarriers, summed as they land), sums each channel in f32, folds its
//   channels into per-group partials, and the ranks exchange those through
//   distributed shared memory, each folding them in rank order (so every
//   run gives the same bits). Then it applies from shared memory with
//   16-byte stores: x crosses HBM once, one launch a site.
// - stream (elements beyond 16 ranks: the 512px levels 0-2): a (split,
//   batch) grid of about 16 blocks an SM at any batch, 16-byte loads;
//   per-split group partials, folded once per (b, g) by a small kernel,
//   then the apply pass. x is read twice.
//
// Both may save per-(b, g) mean, rstd and the clamp flag (1 where var >=
// 0) [B, 3, G] for the backward (adagn_bwd.cu).
#include "adagn_common.cuh"

namespace adagn {
namespace {

struct FwdArgs {
  const void* x;
  void* out;
  const float* gamma;
  const float* beta;
  Films f;
  float* stats;    // [B, 3, G] or null (resident)
  float* partial;  // stream: [B, splits, 2, G]
  int B, HW, C, G;
  Plan p;
};

// The apply of V channels (c0 .. c0 + V - 1) of batch element b in
// registers: gamma P and Bc from the parameters and FiLM rows (loaded at
// once, while x is in flight), then mean and A from the group statistics.
template <int V, int K>
struct Apply {
  float gP[V], Bc[V], mean[V], A[V];

  __device__ __forceinline__ Apply(const FwdArgs& p, int b, int c0) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = c0 + u;
      float P = 1.f, Bv = p.beta[c];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float s = 1.f + p.f.at(2 * k, b, c);
        Bv = fmaf(Bv, s, p.f.at(2 * k + 1, b, c));
        P *= s;
      }
      gP[u] = p.gamma[c] * P;
      Bc[u] = Bv;
    }
  }
  // the group statistics rows gm[G] (mean), gr[G] (rstd)
  __device__ __forceinline__ void stats(const float* gm, const float* gr,
                                        int c0, int gs) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int g = (c0 + u) / gs;
      mean[u] = gm[g];
      A[u] = gr[g] * gP[u];
    }
  }
  __device__ __forceinline__ void operator()(float (&v)[V]) const {
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = fmaf(v[u] - mean[u], A[u], Bc[u]);
  }
};

// mean, rstd and the clamp flag of a group from its sums over n elements
__device__ __forceinline__ void group_stats(float t1, float t2, float n,
                                            float& mean, float& rstd,
                                            float& keep) {
  mean = t1 / n;
  const float var = t2 / n - mean * mean;
  rstd = rsqrtf(fmaxf(var, 0.f) + kEps);
  keep = var >= 0.f ? 1.f : 0.f;
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
    resident_kernel(const FwdArgs a) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, G = a.G, HW = a.HW, vpr = C / V;
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % vpr, lane = t / vpr, lanes = nt / vpr;
  const int ranks = a.p.ranks;
  const int rank = ranks > 1 ? cluster_rank() : 0;
  const int b = blockIdx.y;
  const int r0 = rank * a.p.rows;
  const int nrows = max(0, min(a.p.rows, HW - r0));
  const int row_bytes = C * (int)sizeof(T);
  const int slab_bytes = (a.p.rows * row_bytes + 127) / 128 * 128;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  unsigned char* slab = sm + kBarBytes;
  float* red = reinterpret_cast<float*>(slab + slab_bytes);  // [2][rows][C]
  float* ch = red + 2 * sum_rows(nt, vpr) * C;               // [2][C]
  float* part = ch + 2 * C;                                  // [2][G]
  float* gst = part + 2 * G;                                 // [2][G]
  const size_t base = ((size_t)b * HW + r0) * C;
  const Chunks chunks(nrows, row_bytes);
  if (t == 0) {
    const unsigned char* src =
        static_cast<const unsigned char*>(a.x) + base * sizeof(T);
    load_slabs(bars, chunks, slab, &src, 1, nrows, row_bytes, slab_bytes);
  }
  Apply<V, K> ap(a, b, j * V);
  __syncthreads();

  const uint4* sv = reinterpret_cast<const uint4*>(slab);
  float s1[V], s2[V];
#pragma unroll
  for (int u = 0; u < V; ++u) s1[u] = s2[u] = 0.f;
  for (int i = 0; i < chunks.n; ++i) {
    wait_bar(smem_addr(&bars[i]), 0);
    const int e1 = min(nrows, (i + 1) * chunks.crows);
    for (int r = i * chunks.crows + lane; r < e1; r += lanes) {
      float v[V];
      unpack(sv[r * vpr + j], v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        s1[u] += v[u];
        s2[u] = fmaf(v[u], v[u], s2[u]);
      }
    }
  }
  const int rows = put_sums<V>(red, s1, s2, C, vpr);
  __syncthreads();
  fold_lanes(red, ch, C, rows);
  __syncthreads();
  const int gs = C / G;
  for (int g = t; g < G; g += nt) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < gs; ++i) {
      t1 += ch[g * gs + i];
      t2 += ch[C + g * gs + i];
    }
    part[g] = t1;
    part[G + g] = t2;
  }
  // every rank's partials written; then each folds them in rank order
  if (ranks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int i = t; i < 2 * G; i += nt) ch[i] = sum_ranks(part + i, ranks);
  // this rank has read its peers: they may leave once all have (the wait
  // is at the end, behind the apply)
  if (ranks > 1) cluster_arrive();
  __syncthreads();
  for (int g = t; g < G; g += nt) {
    float mean, rstd, keep;
    group_stats(ch[g], ch[G + g], (float)HW * (float)gs, mean, rstd, keep);
    gst[g] = mean;
    gst[G + g] = rstd;
    if (rank == 0 && a.stats != nullptr) {
      float* s = a.stats + (size_t)b * 3 * G;
      s[g] = mean;
      s[G + g] = rstd;
      s[2 * G + g] = keep;
    }
  }
  __syncthreads();

  ap.stats(gst, gst + G, j * V, gs);
  uint4* ov = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + base);
  for (int r = lane; r < nrows; r += lanes) {
    float v[V];
    unpack(sv[r * vpr + j], v);
    ap(v);
    ov[r * vpr + j] = pack(v);
  }
  if (ranks > 1) cluster_wait();
}

// ------------------------------------------------------------ stream

// per-split group sums [B, splits, 2, G]
template <typename T>
__global__ void __launch_bounds__(256) stream_stats_kernel(const FwdArgs a) {
  constexpr int V = Vec<T>::V;
  extern __shared__ float smf[];
  const int C = a.C, G = a.G, HW = a.HW, vpr = C / V;
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % vpr, lane = t / vpr, lanes = nt / vpr;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  float* red = smf;
  float* ch = red + 2 * sum_rows(nt, vpr) * C;
  const int r0 = s * a.p.rows, r1 = min(HW, r0 + a.p.rows);
  const uint4* xv = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) +
                                                   (size_t)b * HW * C);
  float s1[V], s2[V];
#pragma unroll
  for (int u = 0; u < V; ++u) s1[u] = s2[u] = 0.f;
  int r = r0 + lane;
  for (; r + 3 * lanes < r1; r += 4 * lanes) {
    uint4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = __ldg(xv + (size_t)(r + i * lanes) * vpr + j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[V];
      unpack(q[i], v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        s1[u] += v[u];
        s2[u] = fmaf(v[u], v[u], s2[u]);
      }
    }
  }
  for (; r < r1; r += lanes) {
    float v[V];
    unpack(__ldg(xv + (size_t)r * vpr + j), v);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      s1[u] += v[u];
      s2[u] = fmaf(v[u], v[u], s2[u]);
    }
  }
  const int rows = put_sums<V>(red, s1, s2, C, vpr);
  __syncthreads();
  fold_lanes(red, ch, C, rows);
  __syncthreads();
  const int gs = C / G;
  float* p = a.partial + ((size_t)b * S + s) * 2 * G;
  for (int g = t; g < G; g += nt) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < gs; ++i) {
      t1 += ch[g * gs + i];
      t2 += ch[C + g * gs + i];
    }
    p[g] = t1;
    p[G + g] = t2;
  }
}

// each (b, g)'s split partials folded once, by a warp: lane l sums splits
// l, l + 32, ... in order, then the lanes in a fixed tree
__global__ void __launch_bounds__(256) stream_fold_kernel(const FwdArgs a,
                                                          int S) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int l = threadIdx.x % 32, G = a.G;
  if (w >= a.B * G) return;  // the whole warp
  const int b = w / G, g = w % G;
  const float* p = a.partial + (size_t)b * S * 2 * G;
  float t1 = 0.f, t2 = 0.f;
  for (int s = l; s < S; s += 32) {
    t1 += p[(size_t)s * 2 * G + g];
    t2 += p[(size_t)s * 2 * G + G + g];
  }
  t1 = warp_sum(t1);
  t2 = warp_sum(t2);
  if (l) return;
  float mean, rstd, keep;
  group_stats(t1, t2, (float)a.HW * (float)(a.C / G), mean, rstd, keep);
  float* st = a.stats + (size_t)b * 3 * G;
  st[g] = mean;
  st[G + g] = rstd;
  st[2 * G + g] = keep;
}

template <typename T, int K>
__global__ void __launch_bounds__(256) stream_apply_kernel(const FwdArgs a) {
  constexpr int V = Vec<T>::V;
  const int C = a.C, G = a.G, HW = a.HW, vpr = C / V;
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % vpr, lane = t / vpr, lanes = nt / vpr;
  // the statistics pass's blocks in reverse: its last rows, still in the
  // L2, are read again first
  const int b = gridDim.y - 1 - blockIdx.y, s = gridDim.x - 1 - blockIdx.x;
  const float* st = a.stats + (size_t)b * 3 * G;
  Apply<V, K> ap(a, b, j * V);
  ap.stats(st, st + G, j * V, C / G);
  const int r0 = s * a.p.rows, r1 = min(HW, r0 + a.p.rows);
  const size_t base = (size_t)b * HW * C;
  const uint4* xv =
      reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + base);
  uint4* ov = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + base);
  int r = r0 + lane;
  for (; r + 3 * lanes < r1; r += 4 * lanes) {
    uint4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = __ldg(xv + (size_t)(r + i * lanes) * vpr + j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[V];
      unpack(q[i], v);
      ap(v);
      ov[(size_t)(r + i * lanes) * vpr + j] = pack(v);
    }
  }
  for (; r < r1; r += lanes) {
    float v[V];
    unpack(__ldg(xv + (size_t)r * vpr + j), v);
    ap(v);
    ov[(size_t)r * vpr + j] = pack(v);
  }
}

// ------------------------------------------------------------ launches

template <typename T, int K>
int launch_k(const FwdArgs& a, cudaStream_t stream) {
  static int ready = -1;
  if (ready < 0) {
    ready = prepare(resident_kernel<T, K>, true);
    if (ready == 0) ready = prepare(stream_apply_kernel<T, K>, false);
    if (ready == 0) ready = prepare(stream_stats_kernel<T>, false);
  }
  if (ready) return ready;
  const Plan& p = a.p;
  if (p.body == kResident) return launch_resident(resident_kernel<T, K>, a,
                                                  stream);
  const dim3 grid(p.splits, a.B);
  stream_stats_kernel<T><<<grid, p.threads, p.smem, stream>>>(a);
  stream_fold_kernel<<<cdiv(a.B * a.G, 8), 256, 0, stream>>>(a, p.splits);
  stream_apply_kernel<T, K><<<grid, p.threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const FwdArgs& a, cudaStream_t stream) {
  switch (a.f.K) {
    case 0: return launch_k<T, 0>(a, stream);
    case 1: return launch_k<T, 1>(a, stream);
    case 2: return launch_k<T, 2>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace adagn

// x, out: [B, HW, C] of `dtype`; gamma, beta: [C] f32; f0..f3: the FiLM
// rows s_1, b_1, s_2, b_2 ([B, C], the first 2K used). stats: [B, 3, G]
// f32 (mean, rstd, clamp flag), written where not null (the stream body
// needs it); scratch: the stream body's [B, splits, 2, G] f32. `config`:
// the adagn::Config ints, whose plan must be make_plan's.
INFODIFF_EXPORT int infodiff_adagn(const void* x, const float* gamma,
                                   const float* beta, const void* f0,
                                   const void* f1, const void* f2,
                                   const void* f3, void* out, float* stats,
                                   float* scratch, const int* config,
                                   cudaStream_t stream) {
  using namespace adagn;
  const Config& c = *reinterpret_cast<const Config*>(config);
  if (!config_ok(c, false) ||
      (c.p.body == kStream && (stats == nullptr || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(c.device);
  const FwdArgs a = {x, out, gamma, beta, make_films(f0, f1, f2, f3, c),
                     stats, scratch, c.B, c.HW, c.C, c.G, c.p};
  if (c.dtype == kBF16) return launch<bf16>(a, stream);
  return launch<float>(a, stream);
}

// *out: clusters of 16 resident K1 blocks of `dtype` the card co-schedules
// at the most shared memory (cudaOccupancyMaxActiveClusters)
INFODIFF_EXPORT int infodiff_adagn_clusters(int dtype, int* out) {
  using namespace adagn;
  return max_clusters(dtype == kBF16 ? resident_kernel<bf16, 2>
                                     : resident_kernel<float, 2>,
                      out);
}
