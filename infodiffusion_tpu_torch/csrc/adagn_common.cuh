// What K1 (adagn.cu) and its backward (adagn_bwd.cu) share: the launch
// plan, the FiLM rows as the caller hands them, 16-byte vectors of x, the
// bulk loads of a batch element's rows into shared memory and the
// cluster's exchange through distributed shared memory.
//
// The plan (make_plan here, adagn_launch_plan in ops/cuda/adagn.py: one
// arithmetic; the entries refuse a plan that is not their own) picks one
// of two bodies for an x [B, HW, C] (C fastest, C % 32 == 0, C <= 1024):
//
// - resident: a thread-block cluster of `ranks` (1, 2, 4, 8 or 16) blocks
//   holds one batch element; rank q owns rows [q * rows, (q + 1) * rows),
//   one contiguous slab, loaded by bulk copies (cp.async.bulk) into its
//   shared memory. The most blocks an SM (4, 3, 2, then 1: 57,344, 76,800,
//   115,712 or 232,448 bytes of shared memory each) at which some rank
//   count holds the element, then the fewest ranks at that; 16 ranks need
//   the non-portable cluster size and a card that co-schedules such a
//   cluster at the most shared memory (max_active_clusters > 0).
// - stream: a (split, batch) grid of `splits` splits of `rows` rows each
//   (a multiple of the block's row lanes), about kStreamBlocks blocks an SM
//   at any batch, each thread holding at least kMinRows rows a lane.
//
// In both, a block of `threads` threads walks 16-byte vectors: a row is
// vpr = C / V vectors (V = 8 bf16 or 4 f32 elements), thread t owns vector
// column t % vpr (so always the same V channels) and row lane t / vpr of
// threads / vpr lanes; threads is the multiple of vpr nearest under 256
// that is a multiple of 32 where one is.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "wgmma_common.cuh"

namespace adagn {
// internal linkage: a process may load two builds of the library
namespace {

using flash_wgmma::bf16;
using flash_wgmma::bulk_load;
using flash_wgmma::mbar_expect_tx;
using flash_wgmma::mbar_init;
using flash_wgmma::smem_addr;

constexpr float kEps = 1e-5f;
constexpr int kMaxFilms = 2;
constexpr int kMaxC = 1024;
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use
constexpr int kSmSmem = 233472;      // an SM's, of which 1 KB a block is kept
constexpr int kMaxRanks = 16;
constexpr int kThreadTarget = 256;
constexpr int kMaxChunks = 16;       // bulk copies (each on its mbarrier)
constexpr int kChunkBytes = 16384;   // at least, a chunk
constexpr int kBarBytes = 8 * kMaxChunks;
constexpr int kStreamBlocks = 16;    // stream blocks an SM, at any batch
constexpr int kMinRows = 4;          // rows a lane, at least, in a split
enum Body { kResident = 0, kStream = 1 };

struct Plan {
  int body, ranks, rows, splits, threads, smem;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }
inline int vec_elems(int dtype) { return dtype == kBF16 ? 8 : 4; }

inline int plan_threads(int C, int dtype) {
  const int vpr = C / vec_elems(dtype);
  const int step = 32 / gcd(vpr, 32);
  return std::max(step, kThreadTarget / vpr / step * step) * vpr;
}

// rows of the per-thread channel sums a block folds (put_sums): one a
// warp where a warp holds several row lanes of each vector column, else
// one a row lane
__host__ __device__ inline int sum_rows(int threads, int vpr) {
  return vpr < 32 && 32 % vpr == 0 ? threads / 32 : threads / vpr;
}

// bytes of shared memory beside the slabs: the channel sums
// [2][sum_rows][C]; forward per-channel [2][C] and per-group [4][G] rows,
// backward [5][C] and [5][G]
inline int extra_bytes(int C, int G, int threads, int dtype, bool backward) {
  const int rows = sum_rows(threads, C / vec_elems(dtype));
  return 4 * (2 * rows * C + (backward ? 5 * C + 5 * G : 2 * C + 4 * G));
}

inline Plan make_plan(int B, int HW, int C, int G, int K, int dtype, int sms,
                      int max_active_clusters, bool backward) {
  (void)K;
  Plan p = {};
  p.threads = plan_threads(C, dtype);
  const int e = dtype == kBF16 ? 2 : 4;
  const int extra = kBarBytes + extra_bytes(C, G, p.threads, dtype, backward);
  for (int per_sm = 4; per_sm >= 1; --per_sm) {
    const long long limit = (kSmSmem - per_sm * 1024) / per_sm;
    for (int r = 1; r <= kMaxRanks; r *= 2) {
      if (r == kMaxRanks && max_active_clusters < 1) break;
      const int rows = cdiv(HW, r);
      const long long slab = (long long)rows * C * e * (backward ? 2 : 1);
      const long long smem = extra + (slab + 127) / 128 * 128;
      if (smem <= limit) {
        p.body = kResident;
        p.ranks = r;
        p.rows = rows;
        p.splits = 1;
        p.smem = (int)smem;
        return p;
      }
    }
  }
  p.body = kStream;
  p.ranks = 1;
  const int lanes = p.threads / (C / vec_elems(dtype));
  const int want = cdiv(kStreamBlocks * sms, B);
  const int most = std::max(1, HW / (kMinRows * lanes));
  const int s0 = std::max(1, std::min(want, most));
  p.rows = cdiv(cdiv(HW, s0), lanes) * lanes;
  p.splits = cdiv(HW, p.rows);
  p.smem = extra_bytes(C, G, p.threads, dtype, backward);
  return p;
}

inline bool same_plan(const Plan& a, const Plan& b) {
  return a.body == b.body && a.ranks == b.ranks && a.rows == b.rows &&
         a.splits == b.splits && a.threads == b.threads && a.smem == b.smem;
}

// the shapes both kernels take
inline bool shape_ok(int B, int HW, int C, int G, int K, int dtype,
                     int film_dtype) {
  return B >= 1 && B <= 65535 && HW >= 1 && C >= 32 && C <= kMaxC &&
         C % 32 == 0 && G >= 1 && C % G == 0 && K >= 0 && K <= kMaxFilms &&
         (dtype == kF32 || dtype == kBF16) &&
         (K == 0 || film_dtype == kF32 || film_dtype == kBF16);
}

// The FiLM rows (s_1, b_1, ..., s_K, b_K), each [B, C] with its row stride
// (in elements; unit column stride), all of one dtype (f32 or bf16).
struct Films {
  const void* p[2 * kMaxFilms];
  int stride[2 * kMaxFilms];
  int K, dtype;

  __device__ __forceinline__ float at(int i, int b, int c) const {
    const long long o = (long long)b * stride[i] + c;
    return dtype == kBF16 ? __bfloat162float(static_cast<const bf16*>(p[i])[o])
                          : static_cast<const float*>(p[i])[o];
  }
};

// What the C entries take beside the pointers, as one host array of ints:
// the card, the shapes, the FiLM rows' strides and dtype, x's dtype, and
// the plan with what it was made from.
struct Config {
  int device, B, HW, C, G, K, fs[2 * kMaxFilms], film_dtype, dtype, sms,
      max_active_clusters;
  Plan p;
};

inline Films make_films(const void* f0, const void* f1, const void* f2,
                        const void* f3, const Config& c) {
  Films f = {{f0, f1, f2, f3}, {c.fs[0], c.fs[1], c.fs[2], c.fs[3]}, c.K,
             c.film_dtype};
  return f;
}

// the config's shapes are ones both kernels take and its plan is
// make_plan's for them
inline bool config_ok(const Config& c, bool backward) {
  return shape_ok(c.B, c.HW, c.C, c.G, c.K, c.dtype, c.film_dtype) &&
         same_plan(c.p, make_plan(c.B, c.HW, c.C, c.G, c.K, c.dtype, c.sms,
                                  c.max_active_clusters, backward));
}

// Launches on `device`, the current card restored after.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur = 0;
    cudaGetDevice(&cur);
    if (cur != device && cudaSetDevice(device) == cudaSuccess) prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// ----------------------------------------------------- 16-byte vectors

template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& q, float (&f)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
// rounded once to bf16 (round to nearest even), or the f32 values
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ void store_as(int dtype, void* p, long long i,
                                         float v) {
  if (dtype == kBF16)
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// ------------------------------------------------ the cluster, mbarriers

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The sum over the cluster's ranks 0, 1, ..., ranks - 1 in order of the
// f32 at p in each rank's shared memory (this block's alone when ranks ==
// 1): plain loads through generic addresses (mapa), all in flight at once.
__device__ __forceinline__ float sum_ranks(const float* p, int ranks) {
  if (ranks == 1) return *p;
  float v[kMaxRanks];
#pragma unroll
  for (int q = 0; q < kMaxRanks; ++q) {
    uint64_t a = 0;
    if (q < ranks)
      asm("mapa.u64 %0, %1, %2;\n"
          : "=l"(a)
          : "l"(reinterpret_cast<uint64_t>(p)), "r"(q));
    v[q] = q < ranks ? *reinterpret_cast<const float*>(a) : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxRanks; ++q)
    if (q < ranks) s += v[q];
  return s;
}

// A wait that outlasts ~10 s of cycles traps: the launch fails with an
// error instead of holding the card.
__device__ __forceinline__ void wait_bar(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Rows of a rank's slab, in chunks of `crows` rows, each chunk one bulk
// copy per source on its own mbarrier.
struct Chunks {
  int crows, n;

  __device__ __forceinline__ Chunks(int nrows, int row_bytes) {
    crows = max(cdiv_d(nrows, kMaxChunks), max(1, kChunkBytes / row_bytes));
    n = cdiv_d(nrows, crows);
  }
  __device__ __forceinline__ static int cdiv_d(int a, int b) {
    return (a + b - 1) / b;
  }
};

// Thread 0: set up the chunks' mbarriers and copy rows [0, nrows) of each
// of the `nsrc` sources (row_bytes a row) into its slab (`slab_bytes`
// apart in shared memory from `dst`).
__device__ __forceinline__ void load_slabs(uint64_t* bars, const Chunks& ch,
                                           unsigned char* dst,
                                           const unsigned char* const* src,
                                           int nsrc, int nrows, int row_bytes,
                                           int slab_bytes) {
  for (int i = 0; i < ch.n; ++i) mbar_init(smem_addr(&bars[i]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = 0; i < ch.n; ++i) {
    const int r0 = i * ch.crows;
    const uint32_t bytes = (uint32_t)(min(ch.crows, nrows - r0) * row_bytes);
    const uint32_t bar = smem_addr(&bars[i]);
    mbar_expect_tx(bar, bytes * nsrc);
    for (int s = 0; s < nsrc; ++s)
      bulk_load(smem_addr(dst + s * slab_bytes + (size_t)r0 * row_bytes),
                src[s] + (size_t)r0 * row_bytes, bytes, bar);
  }
}

// Fold the block's per-thread channel sums red[2][lanes][C] into
// out[2][C] (lanes in order); every thread calls it after a barrier.
__device__ __forceinline__ void fold_lanes(const float* red, float* out,
                                           int C, int lanes) {
  const int span = lanes * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      t1 += red[l * C + c];
      t2 += red[span + l * C + c];
    }
    out[c] = t1;
    out[C + c] = t2;
  }
}

// This thread's V channel sums into red[2][rows][C], one row per row lane
// or, where a warp holds several lanes of each vector column (vpr divides
// 32), one per warp, its lanes added first by a fixed xor tree; returns
// rows. Every thread of the block calls it.
template <int V>
__device__ __forceinline__ int put_sums(float* red, float (&s1)[V],
                                        float (&s2)[V], int C, int vpr) {
  const int t = threadIdx.x, nt = blockDim.x, j = t % vpr;
  int row = t / vpr, rows = nt / vpr;
  if (vpr < 32 && 32 % vpr == 0) {
    for (int o = vpr; o < 32; o <<= 1) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        s1[u] += __shfl_xor_sync(0xffffffffu, s1[u], o);
        s2[u] += __shfl_xor_sync(0xffffffffu, s2[u], o);
      }
    }
    row = t / 32;
    rows = nt / 32;
    if (t % 32 >= vpr) return rows;
  }
  float* p1 = red + row * C + j * V;
  float* p2 = p1 + rows * C;
#pragma unroll
  for (int u = 0; u < V; u += 4) {
    *reinterpret_cast<float4*>(p1 + u) =
        make_float4(s1[u], s1[u + 1], s1[u + 2], s1[u + 3]);
    *reinterpret_cast<float4*>(p2 + u) =
        make_float4(s2[u], s2[u + 1], s2[u + 2], s2[u + 3]);
  }
  return rows;
}

// ------------------------------------------------------------ launches

// the attributes a launch of `kernel` may need (up to kSmemLimit of
// shared memory; clusters of 16 where `cluster`)
template <typename Kernel>
int prepare(Kernel kernel, bool cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)err;
}

inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem,
                                         int ranks, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  return cfg;
}

// the resident body: one cluster of p.ranks blocks a batch element
template <typename Args>
int launch_resident(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(a.p.ranks, a.B), a.p.threads, a.p.smem, a.p.ranks, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// clusters of 16 blocks of `kernel` the card co-schedules at the most
// shared memory (cudaOccupancyMaxActiveClusters), into *out
template <typename Args>
int max_clusters(void (*kernel)(Args), int* out) {
  const int err = prepare(kernel, true);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(kMaxRanks), kThreadTarget, kSmemLimit, kMaxRanks, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

}  // namespace
}  // namespace adagn
