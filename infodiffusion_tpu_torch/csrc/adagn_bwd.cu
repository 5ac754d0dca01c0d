// K1 backward: the gradient of GroupNorm + K FiLMs (AdaGN) over x
// [B, HW, C], C fastest.
//
// Replaces XLA's autodiff of infodiffusion_tpu/ops/norm.py:293 (adagn):
// the JAX package has no Pallas backward for K1. With the forward's saved
// per-(b, g) mean, rstd and clamp flag, x^ = (x - mean) * rstd,
// P = prod_k (1 + s_k), a_c = gamma * P, per channel S1 = sum_hw dy and
// S2 = sum_hw dy * x^:
//
//   dx = rstd * (a_c dy - m1 - x^ m2), m1 = mean_g(a_c S1) / HW,
//        m2 = mean_g(a_c S2) / HW (0 where the var clamp binds: JAX's
//        gradient through max(var, 0) is 0 there);
//   dbeta/dgamma rows P S1, P S2 per batch element, summed over the batch
//   in order (no float atomics); each FiLM's db_k = q_k S1 and
//   ds_k = q_k (alpha_{k-1} S2 + beta_{k-1} S1), q_k the product of the
//   later FiLMs' (1 + s), alpha/beta the affine coefficients of h_{k-1}.
//
// What bounds it: bytes, x and dy read once and dx written once. On
// adagn_common.cuh's plan (x and dy both resident):
//
// - resident (every 64px site in bf16): each rank bulk-copies its slab of
//   x and of dy into shared memory, forms its channels' S1 and S2, and the
//   ranks exchange those through distributed shared memory, each folding
//   them in rank order; every rank then has the FiLM rows, m1 and m2 and
//   writes dx from shared memory with 16-byte stores; rank 0 writes the
//   element's rows ([B, 2, C] and the FiLM gradients [2K, B, C]). One
//   launch, then a small one sums dgamma and dbeta over the batch.
// - stream (elsewhere, e.g. the 128px level 0 and the 512px levels): the
//   reduce pass over a (split, batch) grid that fills the card, the FiLM
//   rows per element, the dx pass, both with 16-byte accesses, and the
//   batch sum.
#include "adagn_common.cuh"

namespace adagn {
namespace {

struct BwdArgs {
  const void* x;
  const void* dy;
  const float* stats;  // [B, 3, G]: mean, rstd, clamp flag
  const float* gamma;
  const float* beta;
  Films f;
  void* dx;
  void* dfilms;    // [2K, B, C] of the films' dtype
  float* gpart;    // [B, 2, C]: P S2, P S1
  float* partial;  // stream: [B, splits, 2, C]
  float* rows;     // stream: [B, 2, G]: m1, m2
  float* dgamma;
  float* dbeta;
  int B, HW, C, G;
  Plan p;
};

// The FiLM gradients and the dgamma/dbeta rows of (b, c) from its S1, S2
// (written where `write`); returns a_c = gamma * P.
__device__ __forceinline__ float film_rows(const BwdArgs& a, int b, int c,
                                          float S1, float S2, bool write) {
  const int K = a.f.K;
  float fs[kMaxFilms], fb[kMaxFilms];
  float P = 1.f;
  for (int k = 0; k < K; ++k) {
    fs[k] = 1.f + a.f.at(2 * k, b, c);
    fb[k] = a.f.at(2 * k + 1, b, c);
    P *= fs[k];
  }
  if (write) {
    // h_{k-1} = alpha * x^ + bet; walk the chain forward
    float alpha = a.gamma[c], bet = a.beta[c];
    const long long BC = (long long)a.B * a.C, o = (long long)b * a.C + c;
    for (int k = 0; k < K; ++k) {
      float q = 1.f;
      for (int i = k + 1; i < K; ++i) q *= fs[i];
      store_as(a.f.dtype, a.dfilms, 2 * k * BC + o,
               q * (alpha * S2 + bet * S1));
      store_as(a.f.dtype, a.dfilms, (2 * k + 1) * BC + o, q * S1);
      alpha *= fs[k];
      bet = fmaf(bet, fs[k], fb[k]);
    }
    a.gpart[(size_t)b * 2 * a.C + c] = P * S2;
    a.gpart[((size_t)b * 2 + 1) * a.C + c] = P * S1;
  }
  return a.gamma[c] * P;
}

// m1, m2 of each group from the per-channel a_c S1, a_c S2 (tt[2][C]),
// into out1[G], out2[G] (clamp flags keep[G])
__device__ __forceinline__ void group_means(const float* tt, const float* keep,
                                           float* out1, float* out2, int C,
                                           int G, int HW) {
  const int gs = C / G;
  const float n = (float)HW * (float)gs;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int i = 0; i < gs; ++i) {
      m1 += tt[g * gs + i];
      m2 += tt[C + g * gs + i];
    }
    out1[g] = m1 / n;
    out2[g] = keep[g] * m2 / n;
  }
}

// dx of V channels: rstd (a dy - m1 - x^ m2), as
// (a rstd) dy - ((x - mean) (rstd^2 m2) + rstd m1)
template <int V>
struct Dx {
  float mean[V], c1[V], c2[V], c0[V];

  // rows of mean, rstd, m1, m2 by group (each read at g), a by channel
  __device__ __forceinline__ void set(const float* gmean, const float* grstd,
                                     const float* gm1, const float* gm2,
                                     const float* a, int c0_, int gs) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int g = (c0_ + u) / gs;
      const float r = grstd[g];
      mean[u] = gmean[g];
      c1[u] = a[u] * r;
      c2[u] = r * r * gm2[g];
      c0[u] = r * gm1[g];
    }
  }
  __device__ __forceinline__ void operator()(const float (&x)[V],
                                             float (&d)[V]) const {
#pragma unroll
    for (int u = 0; u < V; ++u)
      d[u] = fmaf(c1[u], d[u], -fmaf(x[u] - mean[u], c2[u], c0[u]));
  }
};

template <int V>
__device__ __forceinline__ void accumulate(const float (&x)[V],
                                           const float (&d)[V],
                                           const float (&mean)[V],
                                           const float (&rstd)[V],
                                           float (&s1)[V], float (&s2)[V]) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    s1[u] += d[u];
    s2[u] = fmaf(d[u], (x[u] - mean[u]) * rstd[u], s2[u]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) resident_bwd_kernel(const BwdArgs a) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char sm[];
  const int C = a.C, G = a.G, HW = a.HW, vpr = C / V, gs = C / G;
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % vpr, lane = t / vpr, lanes = nt / vpr;
  const int ranks = a.p.ranks;
  const int rank = ranks > 1 ? cluster_rank() : 0;
  const int b = blockIdx.y;
  const int r0 = rank * a.p.rows;
  const int nrows = max(0, min(a.p.rows, HW - r0));
  const int row_bytes = C * (int)sizeof(T);
  // x's slab, then dy's: each a multiple of 64 bytes
  const int slab_bytes = a.p.rows * row_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  unsigned char* slab = sm + kBarBytes;
  float* red = reinterpret_cast<float*>(
      slab + (2 * slab_bytes + 127) / 128 * 128);  // [2][lanes][C]
  float* part = red + 2 * sum_rows(nt, vpr) * C;   // [2][C], peers read
  float* tt = part + 2 * C;  // [2][C]: S1, S2, then a_c S1, a_c S2
  float* ac = tt + 2 * C;                          // [C]
  float* grp = ac + C;  // [5][G]: mean, rstd, keep, m1, m2
  const size_t base = ((size_t)b * HW + r0) * C;
  const Chunks chunks(nrows, row_bytes);
  if (t == 0) {
    const unsigned char* src[2] = {
        static_cast<const unsigned char*>(a.x) + base * sizeof(T),
        static_cast<const unsigned char*>(a.dy) + base * sizeof(T)};
    load_slabs(bars, chunks, slab, src, 2, nrows, row_bytes, slab_bytes);
  }
  for (int i = t; i < 3 * G; i += nt) grp[i] = a.stats[(size_t)b * 3 * G + i];
  for (int c = t; c < C; c += nt) {  // what the FiLM rows read, into L1
    prefetch_l1(a.gamma + c);
    prefetch_l1(a.beta + c);
    for (int i = 0; i < 2 * a.f.K; ++i)
      prefetch_l1(static_cast<const char*>(a.f.p[i]) +
                  ((long long)b * a.f.stride[i] + c) *
                      (a.f.dtype == kBF16 ? 2 : 4));
  }
  __syncthreads();

  float mean[V], rstd[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int g = (j * V + u) / gs;
    mean[u] = grp[g];
    rstd[u] = grp[G + g];
  }
  const uint4* xs = reinterpret_cast<const uint4*>(slab);
  const uint4* ds = reinterpret_cast<const uint4*>(slab + slab_bytes);
  float s1[V], s2[V];
#pragma unroll
  for (int u = 0; u < V; ++u) s1[u] = s2[u] = 0.f;
  for (int i = 0; i < chunks.n; ++i) {
    wait_bar(smem_addr(&bars[i]), 0);
    const int e1 = min(nrows, (i + 1) * chunks.crows);
    for (int r = i * chunks.crows + lane; r < e1; r += lanes) {
      float x[V], d[V];
      unpack(xs[r * vpr + j], x);
      unpack(ds[r * vpr + j], d);
      accumulate<V>(x, d, mean, rstd, s1, s2);
    }
  }
  const int rows = put_sums<V>(red, s1, s2, C, vpr);
  __syncthreads();
  fold_lanes(red, part, C, rows);
  if (ranks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int i = t; i < 2 * C; i += nt) tt[i] = sum_ranks(part + i, ranks);
  if (ranks > 1) cluster_arrive();
  __syncthreads();
  for (int c = t; c < C; c += nt) {
    const float S1 = tt[c], S2 = tt[C + c];
    const float a_c = film_rows(a, b, c, S1, S2, rank == 0);
    ac[c] = a_c;
    tt[c] = a_c * S1;
    tt[C + c] = a_c * S2;
  }
  __syncthreads();
  group_means(tt, grp + 2 * G, grp + 3 * G, grp + 4 * G, C, G, HW);
  __syncthreads();
  Dx<V> dx;
  dx.set(grp, grp + G, grp + 3 * G, grp + 4 * G, ac + j * V, j * V, gs);
  uint4* ov = reinterpret_cast<uint4*>(static_cast<T*>(a.dx) + base);
  for (int r = lane; r < nrows; r += lanes) {
    float x[V], d[V];
    unpack(xs[r * vpr + j], x);
    unpack(ds[r * vpr + j], d);
    dx(x, d);
    ov[r * vpr + j] = pack(d);
  }
  if (ranks > 1) cluster_wait();
}

// ------------------------------------------------------------ stream

// per-split channel sums [B, splits, 2, C]
template <typename T>
__global__ void __launch_bounds__(256)
    stream_reduce_kernel(const BwdArgs a) {
  constexpr int V = Vec<T>::V;
  extern __shared__ float smf[];
  const int C = a.C, G = a.G, HW = a.HW, vpr = C / V, gs = C / G;
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % vpr, lane = t / vpr, lanes = nt / vpr;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  float mean[V], rstd[V];
  const float* st = a.stats + (size_t)b * 3 * G;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int g = (j * V + u) / gs;
    mean[u] = st[g];
    rstd[u] = st[G + g];
  }
  const int r0 = s * a.p.rows, r1 = min(HW, r0 + a.p.rows);
  const size_t base = (size_t)b * HW * C;
  const uint4* xv =
      reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + base);
  const uint4* dv =
      reinterpret_cast<const uint4*>(static_cast<const T*>(a.dy) + base);
  float s1[V], s2[V];
#pragma unroll
  for (int u = 0; u < V; ++u) s1[u] = s2[u] = 0.f;
  int r = r0 + lane;
  for (; r + 1 * lanes < r1; r += 2 * lanes) {
    uint4 qx[2], qd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qx[i] = __ldg(xv + (size_t)(r + i * lanes) * vpr + j);
      qd[i] = __ldg(dv + (size_t)(r + i * lanes) * vpr + j);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[V], d[V];
      unpack(qx[i], x);
      unpack(qd[i], d);
      accumulate<V>(x, d, mean, rstd, s1, s2);
    }
  }
  for (; r < r1; r += lanes) {
    float x[V], d[V];
    unpack(__ldg(xv + (size_t)r * vpr + j), x);
    unpack(__ldg(dv + (size_t)r * vpr + j), d);
    accumulate<V>(x, d, mean, rstd, s1, s2);
  }
  const int rows = put_sums<V>(smf, s1, s2, C, vpr);
  __syncthreads();
  fold_lanes(smf, a.partial + ((size_t)b * S + s) * 2 * C, C, rows);
}

// per batch element: each channel's S1, S2 folded over the splits (with
// parts = threads / C threads a channel, part p summing splits p, p +
// parts, ... in order, then the parts in order), the FiLM gradients and
// dgamma/dbeta rows, and m1, m2 [B, 2, G]
__global__ void __launch_bounds__(256) stream_film_kernel(const BwdArgs a) {
  extern __shared__ float smf[];
  const int C = a.C, G = a.G, S = a.p.splits, nt = blockDim.x;
  const int b = blockIdx.x, t = threadIdx.x, parts = max(1, nt / C);
  float* sums = smf;                 // [2][parts][C]
  float* tt = smf + 2 * parts * C;   // [2][C]
  const float* pb = a.partial + (size_t)b * S * 2 * C;
  for (int i = t; i < parts * C; i += nt) {
    const int c = i % C, part = i / C;
    float S1 = 0.f, S2 = 0.f;
#pragma unroll 8
    for (int s = part; s < S; s += parts) {
      S1 += pb[(size_t)s * 2 * C + c];
      S2 += pb[(size_t)s * 2 * C + C + c];
    }
    sums[part * C + c] = S1;
    sums[(parts + part) * C + c] = S2;
  }
  __syncthreads();
  for (int c = t; c < C; c += nt) {
    float S1 = 0.f, S2 = 0.f;
    for (int part = 0; part < parts; ++part) {
      S1 += sums[part * C + c];
      S2 += sums[(parts + part) * C + c];
    }
    const float a_c = film_rows(a, b, c, S1, S2, true);
    tt[c] = a_c * S1;
    tt[C + c] = a_c * S2;
  }
  __syncthreads();
  float* rb = a.rows + (size_t)b * 2 * G;
  group_means(tt, a.stats + (size_t)b * 3 * G + 2 * G, rb, rb + G, C, G,
              a.HW);
}

template <typename T>
__global__ void __launch_bounds__(256) stream_dx_kernel(const BwdArgs a) {
  constexpr int V = Vec<T>::V;
  const int C = a.C, G = a.G, HW = a.HW, vpr = C / V, gs = C / G;
  const int t = threadIdx.x, nt = blockDim.x;
  const int j = t % vpr, lane = t / vpr, lanes = nt / vpr;
  // the reduce pass's blocks in reverse: its last rows, still in the L2,
  // are read again first
  const int b = gridDim.y - 1 - blockIdx.y, s = gridDim.x - 1 - blockIdx.x;
  const float* st = a.stats + (size_t)b * 3 * G;
  const float* rb = a.rows + (size_t)b * 2 * G;
  float ac[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = j * V + u;
    float P = 1.f;
    for (int k = 0; k < a.f.K; ++k) P *= 1.f + a.f.at(2 * k, b, c);
    ac[u] = a.gamma[c] * P;
  }
  Dx<V> dx;
  dx.set(st, st + G, rb, rb + G, ac, j * V, gs);
  const int r0 = s * a.p.rows, r1 = min(HW, r0 + a.p.rows);
  const size_t base = (size_t)b * HW * C;
  const uint4* xv =
      reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + base);
  const uint4* dv =
      reinterpret_cast<const uint4*>(static_cast<const T*>(a.dy) + base);
  uint4* ov = reinterpret_cast<uint4*>(static_cast<T*>(a.dx) + base);
  int r = r0 + lane;
  for (; r + 1 * lanes < r1; r += 2 * lanes) {
    uint4 qx[2], qd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qx[i] = __ldg(xv + (size_t)(r + i * lanes) * vpr + j);
      qd[i] = __ldg(dv + (size_t)(r + i * lanes) * vpr + j);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[V], d[V];
      unpack(qx[i], x);
      unpack(qd[i], d);
      dx(x, d);
      ov[(size_t)(r + i * lanes) * vpr + j] = pack(d);
    }
  }
  for (; r < r1; r += lanes) {
    float x[V], d[V];
    unpack(__ldg(xv + (size_t)r * vpr + j), x);
    unpack(__ldg(dv + (size_t)r * vpr + j), d);
    dx(x, d);
    ov[(size_t)r * vpr + j] = pack(d);
  }
}

// dgamma, dbeta: the rows [B, 2, C] summed over the batch, each (lane, c)
// over b = lane, lane + 8, ... in order, then the 8 lanes in order
__global__ void __launch_bounds__(256) params_kernel(const BwdArgs a) {
  __shared__ float red[2][8][32];
  const int cl = threadIdx.x % 32, l = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cl, C = a.C;
  float g = 0.f, bb = 0.f;
  if (c < C)
    for (int b = l; b < a.B; b += 8) {
      g += a.gpart[(size_t)b * 2 * C + c];
      bb += a.gpart[((size_t)b * 2 + 1) * C + c];
    }
  red[0][l][cl] = g;
  red[1][l][cl] = bb;
  __syncthreads();
  if (l == 0 && c < C) {
    for (int i = 1; i < 8; ++i) {
      g += red[0][i][cl];
      bb += red[1][i][cl];
    }
    a.dgamma[c] = g;
    a.dbeta[c] = bb;
  }
}

// ------------------------------------------------------------ launches

template <typename T>
int launch(const BwdArgs& a, cudaStream_t stream) {
  static int ready = -1;
  if (ready < 0) {
    ready = prepare(resident_bwd_kernel<T>, true);
    if (ready == 0) ready = prepare(stream_reduce_kernel<T>, false);
    if (ready == 0) ready = prepare(stream_film_kernel, false);
  }
  if (ready) return ready;
  const Plan& p = a.p;
  if (p.body == kResident) {
    const int err = launch_resident(resident_bwd_kernel<T>, a, stream);
    if (err) return err;
  } else {
    const dim3 grid(p.splits, a.B);
    stream_reduce_kernel<T><<<grid, p.threads, p.smem, stream>>>(a);
    const int parts = std::max(1, 256 / a.C);
    stream_film_kernel<<<a.B, 256, 2 * (parts + 1) * a.C * sizeof(float),
                         stream>>>(a);
    stream_dx_kernel<T><<<grid, p.threads, 0, stream>>>(a);
  }
  params_kernel<<<cdiv(a.C, 32), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace adagn

// x, dy, dx: [B, HW, C] of `dtype`; stats: the forward's [B, 3, G] f32
// (mean, rstd, clamp flag); gamma, beta: [C] f32; f0..f3: the FiLM rows as
// for infodiff_adagn. Outputs: dfilms [2K, B, C] of the films' dtype (ds_1,
// db_1, ds_2, db_2), dgamma, dbeta [C] f32. Scratch: gpart [B, 2, C] f32;
// the stream body's [B, splits, 2, C] then [B, 2, G] f32 in `scratch`.
// `config`: the adagn::Config ints, whose plan must be make_plan's for the
// backward.
INFODIFF_EXPORT int infodiff_adagn_bwd(
    const void* x, const void* dy, const float* stats, const float* gamma,
    const float* beta, const void* f0, const void* f1, const void* f2,
    const void* f3, void* dx, void* dfilms, float* gpart, float* scratch,
    float* dgamma, float* dbeta, const int* config, cudaStream_t stream) {
  using namespace adagn;
  const Config& c = *reinterpret_cast<const Config*>(config);
  if (!config_ok(c, true) || (c.p.body == kStream && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(c.device);
  float* rows = c.p.body == kStream
                    ? scratch + (size_t)c.B * c.p.splits * 2 * c.C
                    : nullptr;
  const BwdArgs a = {x,      dy,    stats,   gamma, beta,
                     make_films(f0, f1, f2, f3, c),
                     dx,     dfilms, gpart,  scratch, rows,
                     dgamma, dbeta, c.B,     c.HW,  c.C,
                     c.G,    c.p};
  if (c.dtype == kBF16) return launch<bf16>(a, stream);
  return launch<float>(a, stream);
}

// *out: clusters of 16 resident K1-backward blocks of `dtype` the card
// co-schedules at the most shared memory
INFODIFF_EXPORT int infodiff_adagn_bwd_clusters(int dtype, int* out) {
  using namespace adagn;
  return max_clusters(
      dtype == kBF16 ? resident_bwd_kernel<bf16> : resident_bwd_kernel<float>,
      out);
}
