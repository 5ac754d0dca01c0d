// K2: single-head attention out = softmax(q k^T * C^-1/2) v, per batch
// element, for q/k/v/out [B, N, C] with C = 64, 128, 256 or 512.
//
// Replaces infodiffusion_tpu/ops/pallas/attention.py (attention_pallas /
// _kernel). The contract is ops/attention.py _attention_xla, the form the
// JAX main path runs: logits and softmax in f32, the weights w rounded to
// v's dtype before PV, PV accumulated in f32, the output stored in v's
// dtype. (The Pallas kernel keeps w in f32; the two differ only in bf16.)
//
// K2' is the same function with w left unrounded: it replaces
// tools/microbench_attention.py (attention_pallas_tiled / _tiled_kernel),
// attention all in f32 with TB batch elements per grid step. TB is the TPU
// tool's grid blocking and does not change the function, so here it is a
// checked argument (it must divide B) and K2' launches K2's kernels with
// kSplitW.
//
// Like the TPU kernel, a block holds its query rows' whole f32 logit strip
// S [BQ, N] on chip, so q k^T is computed once and the softmax is exact
// before any PV product. The models' N (16 to 256 at 32px/64px, below the
// 512-token flash gate on the route) are small, so at these shapes the
// bytes (q, k, v read once, out written once) bound the function and what
// matters is not re-reading k and v: one block owns BQ query rows of one
// batch element and streams its k and v once each through shared memory.
//
// bf16, every main path: one pass over k on the tensor cores (mma.sync
// m16n8k16, f32 accumulation, ldmatrix; flash_mma.cuh). A block is BQ / 16
// warps, each owning 16 query rows; BQ (16, 32 or 64) shrinks at small N
// and small grids so the card has a block per SM. Phase 1 walks k in
// 64-key tiles and C in chunks of at most 128 channels (k and, at C > 128,
// q staged by cp.async; q stays resident at C <= 128) and writes the
// scaled logits into the strip. Phase 2 is warp-local (a warp owns its
// rows, so max and sum take shuffles, not block barriers): w = exp(s - max)
// / sum in f32 (e = exp(s - max) overwrites s, one exp an element, then
// e times 1 / sum), rounded to bf16 in place, tile by tile into the first
// half of the tile's own 256 bytes of the row. Phase 3 runs PV from the strip
// through ldmatrix as A fragments, one output slice of at most 128
// channels at a time against v staged the same way. K2' writes
// hi = bf16(w) into the first half and lo = bf16(w - hi) into the second
// and runs PV on both (about 2^-17 relative to f32 w); TF32 would round w.
// The strip is BQ (N + 4) f32. The plan keeps it on chip while an SM
// still holds 4 warps: up to N = 768 at BQ = 64, 640 at BQ = 32, 512 at
// BQ = 16 (C >= 128); beyond that (the route's K2 under
// INFODIFF_DISABLE_FLASH_ATTENTION=1, or where the online tiles do not
// divide N) the block makes K3a's two passes over k on the tensor cores
// instead (forward_two_pass, flash_mma.cuh), which recompute q k^T once.
//
// f32 (the card-against-CPU checks, f32 tool runs): K3a's two passes with
// exact f32 FMAs (flash_common.cuh, 256 threads, 64 query rows), which
// compute q k^T twice. In f32 K2 and K2' are one function.
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kKT = 64;  // keys per tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   flash_mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

namespace strip_mma {

using namespace flash_mma;

// rows [row0, row0 + rows) and channels [c0, c0 + width<C>()) of src
// [N, C] into dst (row stride width + 8) by cp.async; rows at or beyond N
// are zero
template <int C>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int N, int c0) {
  constexpr int kVec = width<C>() / 8, LD = width<C>() + 8;
  for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool ok = row0 + r < N;
    cp_async16(dst + r * LD + c,
               src + (size_t)(ok ? row0 + r : 0) * C + c0 + c, ok);
  }
}

// smem: the strip [BQ][NP + 4] f32, q [BQ][LD] and k / v [64][LD] bf16
size_t smem_bytes(int C, int bq, int np) {
  const int ld = (C < kC ? C : kC) + 8;
  return (size_t)bq * (np + 4) * sizeof(float) +
         (size_t)(bq + kKT) * ld * sizeof(bf16);
}

// grid (ceil(N / BQ), B), BQ = 16 kWarps; NP = N rounded up to 64 keys
template <int C, int kWarps, bool kSplitW>
__global__ void __launch_bounds__(32 * kWarps)
    strip_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int N,
                 int NP, float scale) {
  constexpr int W = width<C>(), LD = W + 8, BQ = 16 * kWarps;
  extern __shared__ uint4 smem_u4[];
  const int P = NP + 4;  // f32 row pitch: ldmatrix rows in distinct banks
  float* strip = reinterpret_cast<float*>(smem_u4);
  bf16* qs = reinterpret_cast<bf16*>(strip + BQ * P);
  bf16* ks = qs + BQ * LD;  // k, then v
  const int m0 = (threadIdx.x / 32) * 16, g = lane() / 4, t = lane() % 4;
  const int q0 = blockIdx.x * BQ;
  const size_t off = (size_t)blockIdx.y * N * C;
  const bf16 *qb = q + off, *kb = k + off, *vb = v + off;
  float* const srow[2] = {strip + (m0 + g) * P, strip + (m0 + g + 8) * P};

  // 1. s = q k^T * scale into the strip, once; each row's max on the way
  if (C <= kC) load_rows<C>(qs, qb, q0, BQ, N, 0);
  float mx[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < N; k0 += kKT) {
    float s[8][4];
    zero(s);
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += W) {
      __syncthreads();  // the last readers of qs / ks are done
      if (C > kC) load_rows<C>(qs, qb, q0, BQ, N, c0);
      load_rows<C>(ks, kb, k0, kKT, N, c0);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        unsigned a[4];
        load_a<LD>(a, qs, m0, kk * 16);
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          unsigned b[4];
          load_b_nk<LD>(b, ks, n2 * 16, kk * 16);
          mma(s[2 * n2], a, b[0], b[1]);
          mma(s[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = k0 + n * 8 + 2 * t;
        float2 x;
        x.x = col < N ? s[n][2 * h] * scale : -INFINITY;
        x.y = col + 1 < N ? s[n][2 * h + 1] * scale : -INFINITY;
        mx[h] = fmaxf(mx[h], fmaxf(x.x, x.y));
        *reinterpret_cast<float2*>(srow[h] + col) = x;
      }
  }

  // v's first tile lands while the warps take their softmax
  __syncthreads();  // the last readers of ks are done
  load_rows<C>(ks, vb, 0, kKT, N, 0);

  // 2. the warp's own rows: max, then e = exp(s - max) in place of s (a
  // thread rewrites what it wrote) and its sum, then w = e / sum in f32,
  // as e times the correctly rounded 1 / sum (within 1.5 ulp of e / sum;
  // an IEEE division an element is a long instruction sequence)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(mx[h]);  // key 0 is valid, so m is finite
    float sum = 0.f;
    for (int k0 = 0; k0 < NP; k0 += kKT)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float2* p = reinterpret_cast<float2*>(srow[h] + k0 + n * 8 + 2 * t);
        const float2 e = make_float2(expf(p->x - m), expf(p->y - m));
        sum += e.x + e.y;
        *p = e;
      }
    inv[h] = __frcp_rn(quad_sum(sum));
  }
  // w rounded to bf16 in place: a tile's 64 values of a row (256 bytes)
  // become its 64 bf16 weights (and, for K2', the 64 lo parts after them),
  // so the warp reads a tile whole before it writes it
  for (int k0 = 0; k0 < NP; k0 += kKT) {
    float2 x[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        x[n][h] =
            *reinterpret_cast<const float2*>(srow[h] + k0 + n * 8 + 2 * t);
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float w0 = x[n][h].x * inv[h], w1 = x[n][h].y * inv[h];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(w0, w1);
        bf16* dst = reinterpret_cast<bf16*>(srow[h]) + 2 * k0 + n * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dst) = hi;
        if (kSplitW)
          *reinterpret_cast<__nv_bfloat162*>(dst + kKT) =
              __floats2bfloat162_rn(w0 - __low2float(hi),
                                    w1 - __high2float(hi));
      }
  }

  // 3. out = w v, one output slice of W channels at a time; a warp reads
  // only its own rows of the strip
  const bf16* wrows = reinterpret_cast<const bf16*>(strip) +
                      (m0 + lane() % 16) * 2 * P + (lane() / 16) * 8;
  const float one[2] = {1.f, 1.f};
#pragma unroll 1
  for (int oc = 0; oc < C; oc += W) {
    float o[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kKT) {
      if (oc + k0 > 0) {
        __syncthreads();  // the last readers of ks are done
        load_rows<C>(ks, vb, k0, kKT, N, oc);
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned a[4], lo[4];
        ldsm_x4(a, wrows + 2 * k0 + kk * 16);
        if (kSplitW) ldsm_x4(lo, wrows + 2 * k0 + kKT + kk * 16);
#pragma unroll
        for (int n2 = 0; n2 < W / 16; ++n2) {
          unsigned b[4];
          load_b_kn<LD>(b, ks, kk * 16, n2 * 16);
          mma(o[2 * n2], a, b[0], b[1]);
          mma(o[2 * n2 + 1], a, b[2], b[3]);
          if (kSplitW) {
            mma(o[2 * n2], lo, b[0], b[1]);
            mma(o[2 * n2 + 1], lo, b[2], b[3]);
          }
        }
      }
    }
    store_rows<C>(out + off, o, q0, N, oc, one);
  }
}

// beyond the strip: K3a's two passes, 64 query rows a block
template <int C, bool kSplitW>
__global__ void __launch_bounds__(kThreads)
    two_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int N,
                    int, float scale) {
  extern __shared__ uint4 smem_u4[];
  const size_t off = (size_t)blockIdx.y * N * C;
  forward_two_pass<C, kSplitW>(reinterpret_cast<bf16*>(smem_u4), q + off,
                               k + off, v + off, out + off,
                               blockIdx.x * kTile, N, scale);
}

}  // namespace strip_mma

namespace fma_f32 {

using namespace flash;

// f32: K3a's two passes with exact f32 FMAs, 64 query rows a block
template <int C>
__global__ void __launch_bounds__(kThreads)
    two_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int N, int, float scale) {
  extern __shared__ float4 smem4[];
  const size_t off = (size_t)blockIdx.y * N * C;
  forward_two_pass<C>(reinterpret_cast<float*>(smem4), q + off, k + off,
                      v + off, out + off, blockIdx.x * kTile, N, scale);
}

}  // namespace fma_f32

// A launch's shape: query rows a block (BQ), threads, shared memory, and
// whether the strip is resident (else the two-pass body runs)
struct Plan {
  int bq, threads;
  size_t smem;
  bool strip;
};

Plan make_plan(int B, int N, int C, int dtype) {
  if (dtype != kBF16)
    return {flash::kTile, flash::kThreads, flash::kTwoPassSmem, false};
  int dev = 0, sms = 132, max_smem = 232448;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int np = (N + kKT - 1) / kKT * kKT;
  int bq = 16;  // the fewest rows that hold N, up to 64 ...
  while (bq < 64 && bq < N) bq *= 2;
  // ... then fewer while the grid leaves SMs idle
  while (bq > 16 && (long)B * ((N + bq - 1) / bq) < sms) bq /= 2;
  // the strip where its shared memory leaves an SM 4 warps or more (one or
  // two warps cannot hide the tile loads; the two passes run 4 blocks of 4
  // warps an SM)
  for (; bq >= 16; bq /= 2) {
    const size_t smem = strip_mma::smem_bytes(C, bq, np);
    if (bq / 16 * (max_smem / smem) >= 4) return {bq, 2 * bq, smem, true};
  }
  return {flash_mma::kTile, flash_mma::kThreads, flash_mma::kTwoPassSmem,
          false};
}

// Launch `kernel` with the plan, or with `info` fill in what it would
// take: BQ, blocks, threads, shared bytes, strip (1) or two passes (0),
// resident blocks per SM
template <typename T, typename Kernel>
int go(Kernel kernel, const Plan& p, const void* q, const void* k,
       const void* v, void* out, int B, int N, int C, int* info,
       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + p.bq - 1) / p.bq, B);
  if (info != nullptr) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        p.threads, p.smem);
    const int vals[6] = {p.bq, (int)(grid.x * grid.y), p.threads,
                         (int)p.smem, p.strip ? 1 : 0, per_sm};
    for (int i = 0; i < 6; ++i) info[i] = vals[i];
    return (int)err;
  }
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N,
      (N + kKT - 1) / kKT * kKT, 1.0f / sqrtf((float)C));
  return (int)cudaGetLastError();
}

template <int C, bool kSplitW>
int dispatch_c(const void* q, const void* k, const void* v, void* out, int B,
               int N, int dtype, int* info, cudaStream_t stream) {
  const Plan p = make_plan(B, N, C, dtype);
  if (dtype != kBF16)
    return go<float>(fma_f32::two_pass_kernel<C>, p, q, k, v, out, B, N, C,
                     info, stream);
  using namespace strip_mma;
  if (!p.strip)
    return go<bf16>(two_pass_kernel<C, kSplitW>, p, q, k, v, out, B, N, C,
                    info, stream);
  switch (p.bq) {
    case 16:
      return go<bf16>(strip_kernel<C, 1, kSplitW>, p, q, k, v, out, B, N, C,
                      info, stream);
    case 32:
      return go<bf16>(strip_kernel<C, 2, kSplitW>, p, q, k, v, out, B, N, C,
                      info, stream);
  }
  return go<bf16>(strip_kernel<C, 4, kSplitW>, p, q, k, v, out, B, N, C, info,
                  stream);
}

template <bool kSplitW>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int N, int C, int dtype, int* info, cudaStream_t stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 64:
      return dispatch_c<64, kSplitW>(q, k, v, out, B, N, dtype, info, stream);
    case 128:
      return dispatch_c<128, kSplitW>(q, k, v, out, B, N, dtype, info,
                                      stream);
    case 256:
      return dispatch_c<256, kSplitW>(q, k, v, out, B, N, dtype, info,
                                      stream);
    case 512:
      return dispatch_c<512, kSplitW>(q, k, v, out, B, N, dtype, info,
                                      stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K2. q, k, v, out: [B, N, C] of `dtype`, contiguous, 16-byte aligned;
// C in {64, 128, 256, 512}.
INFODIFF_EXPORT int infodiff_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int N,
                                       int C, int dtype, cudaStream_t stream) {
  return dispatch<false>(q, k, v, out, B, N, C, dtype, nullptr, stream);
}

// K2': the same shapes; tb divides B.
INFODIFF_EXPORT int infodiff_attention_tiled(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int N, int C, int dtype, int tb,
                                             cudaStream_t stream) {
  if (tb < 1 || B % tb) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, out, B, N, C, dtype, nullptr, stream);
}

// What K2 (split = 0) or K2' (split = 1) would launch for [B, N, C] of
// `dtype` on the current device: info[6] = BQ, blocks, threads, shared
// bytes, strip (1) or two passes (0), resident blocks per SM.
INFODIFF_EXPORT int infodiff_attention_plan(int B, int N, int C, int dtype,
                                            int split, int* info) {
  return split ? dispatch<true>(nullptr, nullptr, nullptr, nullptr, B, N, C,
                                dtype, info, nullptr)
               : dispatch<false>(nullptr, nullptr, nullptr, nullptr, B, N, C,
                                 dtype, info, nullptr);
}
