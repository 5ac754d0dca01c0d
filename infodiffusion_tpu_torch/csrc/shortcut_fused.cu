// K6: the fused ResBlock epilogue out = h + bias + sum_i p_i W_i^T, where
// the pieces p_i [M, C_i] are the channel slices of the block input (one
// piece, or the skip concat's two) and W_i = W[:, o_i : o_i + C_i] the
// matching columns of the 1x1 shortcut's weight W [N, sum C_i] (the Linear
// layout, read as it is stored). Rows are NHWC pixels (M = B H W); h, the
// pieces and out are contiguous [rows, channels].
//
// Replaces infodiffusion_tpu/ops/pallas/shortcut_fused.py
// (fused_shortcut_add / _kernel). Contract: the product inputs in h's
// dtype, f32 accumulation, h and the bias added in f32, the output in h's
// dtype rounded once. The pieces are read in place: the concat never
// exists. The TPU kernel's physical-order transpose (an XLA layout
// workaround) and its VMEM tile picker are not ported.
//
// What bounds it: the products have depth C_i <= 1024 and width N <= 512,
// a few hundred operations per byte at most, so at the model's shapes
// (M up to 64 x 4096 rows) the bytes bound it: h, the pieces and out cross
// device memory once each.
//
// bf16, on Hopper (shortcut_launch_plan in ops/cuda/shortcut_fused.py is
// the same arithmetic; the entry refuses a plan that is not its own):
// - A persistent block walks tiles of 128 rows; two consumer warpgroups
//   run wgmma m64nNk16 (bf16 in, f32 accumulate) on 64 rows each. Where W
//   fits in shared memory (N <= 256, padded to 64 / 128 / 256) every
//   output column is in one product, so each piece row is read once. Else
//   (the vanilla UNet's deep sites, whose M is small) the tiles are a
//   GEMM's, 128 rows x 128 columns.
// - The pieces stream as [rows, 64-channel] K tiles through a ring of
//   full/empty mbarriers, in the 128-byte swizzle wgmma's descriptors read
//   (zeros past M and past the channels): with W resident, three producer
//   warps copy them with cp.async (a K tile may straddle the two pieces)
//   and arrive on the stage's full barrier when they have landed, which
//   costs the host no tensor map; with W streamed, one lane issues each
//   stage's piece and W tiles by TMA (where no K tile straddles the
//   pieces; else cp.async as above).
// - W [N, sum C_i] is K-major as stored: resident in shared memory, in the
//   same swizzled 64-channel panels, where it fits beside the ring (every
//   flagship site), loaded once by the consumer warpgroups, which round an
//   f32 W (the parameter as the model keeps it) to bf16, so the call needs
//   no cast; else its tile's 128 rows stream in each stage beside the
//   piece tile.
// - h's tile is fetched by one TMA bulk copy (its rows are contiguous)
//   during the tile's main loop, so the epilogue does not wait on it.
// - Epilogue f32(h) + bias + acc, rounded once to bf16; lanes pair up (one
//   shuffle) so each writes four consecutive channels.
// f32 runs as FMAs (TF32 would change the function), a thread owning 4
// columns of several rows, staged synchronously through shared memory.
#include <algorithm>

#include "common.cuh"
#include "wgmma_common.cuh"

namespace {

using flash_wgmma::bf16;

// --------------------------------------------------------- the bf16 body

constexpr int kSMs = 132;  // H100 SXM
constexpr int kSmemLimit = 232448;
constexpr int kAlign = 1024;  // the swizzle's atoms
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 8 * (2 * kMaxStages + 2);
constexpr int kLoaders = 96;  // producer threads copying tiles
constexpr int kThreads = 384;
constexpr int kRows = 128;      // rows a tile

// One launch: a block's columns (nw, the W rows it holds) and column
// tiles (nsplit), K tiles of 64 channels (kt), W resident or streamed
// (then by TMA where tma), the ring's stages, the stage, W and h bytes,
// h's row stride, shared bytes, tiles, blocks. Tiles are kRows rows.
struct Plan {
  int nw, nsplit, kt, resident, tma, stages, a_bytes, w_panel, w_bytes,
      h_ld, h_bytes, stage_bytes, smem, tiles, blocks;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// W resident where a block can hold all of N (up to 256) and W fits beside
// the ring: each piece row is read once. Else a GEMM's tiling: 128 rows x
// 128 columns a block, W streamed beside the pieces.
inline bool make_plan(int M, int c0, int c1, int N, Plan& p) {
  if (M < 1 || N < 8 || N % 8 || c0 < 8 || c0 % 8 || c1 < 0 || c1 % 8)
    return false;
  p.kt = cdiv(c0 + c1, 64);
  p.stages = 0;
  for (int res = 1; res >= 0 && p.stages == 0; --res) {
    if (res && N > 256) continue;
    p.resident = res;
    p.nw = N <= 64 ? 64 : N <= 128 || !res ? 128 : 256;
    p.nsplit = cdiv(N, p.nw);
    p.a_bytes = kRows * 128;
    p.w_panel = p.nw * 128;
    p.w_bytes = p.kt * p.w_panel;
    p.h_ld = p.nsplit == 1 ? N : p.nw;
    p.h_bytes = kRows * p.h_ld * 2;
    const int fixed = kAlign + p.h_bytes + kBarBytes;
    p.stage_bytes = p.a_bytes + (res ? 0 : p.w_panel);
    for (int s = kMaxStages; s >= 2; --s)
      if (fixed + (res ? p.w_bytes : 0) + s * p.stage_bytes <= kSmemLimit) {
        p.stages = s;
        p.smem = fixed + (res ? p.w_bytes : 0) + s * p.stage_bytes;
        break;
      }
  }
  if (p.stages == 0) return false;
  // streamed tiles by TMA where no K tile straddles the two pieces
  p.tma = !p.resident && c0 % 64 == 0;
  p.tiles = cdiv(M, kRows) * p.nsplit;
  p.blocks = std::min(p.tiles, kSMs);
  return true;
}

struct Args {
  const bf16* h;
  const bf16* p0;
  const bf16* p1;
  const void* W;  // bf16, or f32 where it stays resident (w_f32)
  int w_f32;
  const float* bias;
  bf16* out;
  int M, N, c0, c1;
  Plan p;
};

// 16 bytes: channels kc .. kc + 7 of row `row` of the concat, or false
// where that lies past M or past the channels
__device__ __forceinline__ bool piece_chunk(const Args& a, int row, int kc,
                                            const bf16*& src) {
  if (row >= a.M || kc >= a.c0 + a.c1) return false;
  src = kc < a.c0 ? a.p0 + (size_t)row * a.c0 + kc
                  : a.p1 + (size_t)row * a.c1 + (kc - a.c0);
  return true;
}

// rows x 64 channels from K tile kt into a swizzled [rows][128 B] tile:
// W rows (col0 + r) when `weights`, else piece rows (row0 + r)
__device__ __forceinline__ void load_tile(const Args& a, uint32_t dst,
                                          int rows, int first, int kt,
                                          bool weights, int lt) {
  const int ctot = a.c0 + a.c1;
  for (int i = lt; i < rows * 8; i += kLoaders) {
    const int r = i >> 3, c = i & 7, kc = kt * 64 + c * 8;
    const bf16* src = static_cast<const bf16*>(a.W);
    bool valid;
    if (weights) {
      valid = first + r < a.N && kc < ctot;
      if (valid) src += (size_t)(first + r) * ctot + kc;
    } else {
      valid = piece_chunk(a, first + r, kc, src);
    }
    flash_wgmma::cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src,
                            valid);
  }
}

// The resident W into its swizzled 64-channel panels at wsm (nw rows each,
// zeros past N and past the channels), by the 256 consumer threads, four
// 16-byte chunks' loads in flight a thread; an f32 W rounded to bf16.
template <bool F32>
__device__ __forceinline__ void resident_w(const Args& a, unsigned char* wsm,
                                           int nw) {
  const int ctot = a.c0 + a.c1, chunks = a.p.kt * nw * 8;
  for (int i0 = threadIdx.x; i0 < chunks; i0 += 4 * 256) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * 256, r = (i >> 3) % nw;
      const int kc = (i / (nw * 8)) * 64 + (i & 7) * 8;
      const bool in = i < chunks && r < a.N && kc < ctot;
      const size_t o = in ? (size_t)r * ctot + kc : 0;
      if (F32) {
        const float4* src =
            reinterpret_cast<const float4*>(static_cast<const float*>(a.W) + o);
        const float4 x0 = in ? src[0] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 x1 = in ? src[1] : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u] = make_uint4(flash_wgmma::pack(x0.x, x0.y),
                          flash_wgmma::pack(x0.z, x0.w),
                          flash_wgmma::pack(x1.x, x1.y),
                          flash_wgmma::pack(x1.z, x1.w));
      } else {
        v[u] = in ? *reinterpret_cast<const uint4*>(
                        static_cast<const bf16*>(a.W) + o)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * 256, r = (i >> 3) % nw, c = i & 7;
      if (i < chunks)
        *reinterpret_cast<uint4*>(wsm + (i / (nw * 8)) * a.p.w_panel +
                                  r * 128 + ((c ^ (r & 7)) << 4)) = v[u];
    }
  }
}

// tp0, tp1, tw: the pieces' and W's tensor maps (used where p.tma)
template <int NR>
__global__ void __launch_bounds__(kThreads, 1)
    shortcut_wgmma_kernel(const __grid_constant__ Args a,
                          const __grid_constant__ CUtensorMap tp0,
                          const __grid_constant__ CUtensorMap tp1,
                          const __grid_constant__ CUtensorMap tw) {
  using namespace flash_wgmma;
  constexpr int NW = 2 * NR;  // the block's columns
  const Plan& p = a.p;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sring = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t sw = sring + p.stages * p.stage_bytes;  // resident W
  const uint32_t sh = sw + (p.resident ? p.w_bytes : 0);  // h tile
  const uint32_t sbar = sh + p.h_bytes;
  const auto full = [&](int s) { return sbar + 8 * s; };
  const auto empty = [&](int s) { return sbar + 8 * (kMaxStages + s); };
  const uint32_t hfull = sbar + 8 * 2 * kMaxStages, hempty = hfull + 8;
  const bf16* hsm = reinterpret_cast<const bf16*>(smem_raw + (sh - raw));

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), p.tma ? 1 : kLoaders);
      mbar_init(empty(s), 8);  // one per consumer warp
    }
    mbar_init(hfull, 1);
    mbar_init(hempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - 256;
    if (pt == 0) {  // h's tiles, one bulk copy (a row each in column tiles)
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
        const int row0 = (tile / p.nsplit) * kRows;
        const int col0 = (tile % p.nsplit) * p.nw;
        const int rows = min(kRows, a.M - row0);
        const int cols = min(p.h_ld, a.N - col0);
        if (it >= 1) mbar_wait(hempty, (it - 1) & 1);
        mbar_expect_tx(hfull, rows * cols * 2);
        if (p.nsplit == 1) {
          bulk_load(sh, a.h + (size_t)row0 * a.N, rows * cols * 2, hfull);
        } else {
          for (int r = 0; r < rows; ++r)
            bulk_load(sh + r * p.h_ld * 2,
                      a.h + (size_t)(row0 + r) * a.N + col0, cols * 2, hfull);
        }
      }
      return;
    }
    if (pt < 32) return;
    const int lt = pt - 32;  // tile loader 0 .. 95
    int g = 0;  // stages issued
    if (p.tma) {  // each stage's piece and W tiles, by one lane
      if (lt != 0) return;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int row0 = (tile / p.nsplit) * kRows;
        const int col0 = (tile % p.nsplit) * p.nw;
        for (int kt = 0; kt < p.kt; ++kt, ++g) {
          const int s = g % p.stages;
          if (g >= p.stages) mbar_wait(empty(s), (g / p.stages - 1) & 1);
          const uint32_t st = sring + s * p.stage_bytes;
          mbar_expect_tx(full(s), p.a_bytes + p.w_panel);
          if (kt * 64 < a.c0)
            tma_load_2d(st, &tp0, full(s), kt * 64, row0);
          else
            tma_load_2d(st, &tp1, full(s), kt * 64 - a.c0, row0);
          tma_load_2d(st + p.a_bytes, &tw, full(s), kt * 64, col0);
        }
      }
      return;
    }
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int row0 = (tile / p.nsplit) * kRows;
      const int col0 = (tile % p.nsplit) * p.nw;
      for (int kt = 0; kt < p.kt; ++kt, ++g) {
        const int s = g % p.stages;
        if (g >= p.stages) mbar_wait(empty(s), (g / p.stages - 1) & 1);
        const uint32_t st = sring + s * p.stage_bytes;
        load_tile(a, st, kRows, row0, kt, false, lt);
        if (!p.resident)
          load_tile(a, st + p.a_bytes, p.nw, col0, kt, true, lt);
        cp_async_arrive(full(s));
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rw = 64 * wg;  // this warpgroup's rows in the tile
  if (p.resident) {  // W, once, by the consumers (idle until a tile lands)
    if (a.w_f32)
      resident_w<true>(a, smem_raw + (sw - raw), NW);
    else
      resident_w<false>(a, smem_raw + (sw - raw), NW);
    fence_proxy_async();  // the stores, before wgmma reads them
    bar_sync(1, 256);
  }
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;  // each tile's first product
  // overwrites them (scale_d 0)
  int it = 0, gs = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int row0 = (tile / p.nsplit) * kRows;
    const int col0 = (tile % p.nsplit) * p.nw;
    for (int kt = 0; kt < p.kt; ++kt, ++gs) {
      const int s = gs % p.stages;
      mbar_wait(full(s), (gs / p.stages) & 1);
      fence_proxy_async();  // the cp.async writes, before wgmma reads them
      const uint32_t st = sring + s * p.stage_bytes;
      const uint32_t wp = p.resident ? sw + kt * p.w_panel : st + p.a_bytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(acc, desc(st + rw * 128 + kk * 32, 16, 1024, kSwizzle128),
                    desc(wp + kk * 32, 16, 1024, kSwizzle128),
                    kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // out = bf16(f32(h) + bias + acc). Accumulator i: row g + 8 ((i >> 1)
    // & 1), column (i / 4) * 8 + 2t + i % 2; lanes t, t ^ 1 swap halves so
    // each holds four consecutive columns: even t of tile j, odd t of j + 1
    mbar_wait(hfull, it & 1);
    const bool odd = t4 & 1;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rw + 16 * warp + g8 + 8 * hh;  // row in the tile
      const bool valid_row = row0 + r < a.M;
#pragma unroll
      for (int j = 0; j < NW / 8; j += 2) {
        const float l0 = acc[4 * j + 2 * hh], l1 = acc[4 * j + 2 * hh + 1];
        const float h0 = acc[4 * j + 4 + 2 * hh], h1 = acc[4 * j + 5 + 2 * hh];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? l0 : h0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? l1 : h1, 1);
        const float v[4] = {odd ? r0 : l0, odd ? r1 : l1, odd ? h0 : r0,
                            odd ? h1 : r1};
        const int c = odd ? 8 * (j + 1) + 2 * (t4 - 1) : 8 * j + 2 * t4;
        const int n = col0 + c;  // N % 8 == 0: n + 3 < N as well
        if (!valid_row || n >= a.N) continue;
        const uint2 hv = *reinterpret_cast<const uint2*>(hsm + r * p.h_ld + c);
        const float2 h01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hv.x));
        const float2 h23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hv.y));
        const float4 b = __ldg(reinterpret_cast<const float4*>(a.bias + n));
        uint2 o;
        o.x = pack(h01.x + b.x + v[0], h01.y + b.y + v[1]);
        o.y = pack(h23.x + b.z + v[2], h23.y + b.w + v[3]);
        *reinterpret_cast<uint2*>(a.out + (size_t)(row0 + r) * a.N + n) = o;
      }
    }
    if (lane == 0) mbar_arrive(hempty);
  }
}

template <int NR>
int launch_wgmma(const Args& a, const CUtensorMap* maps,
                 cudaStream_t stream) {
  auto kernel = shortcut_wgmma_kernel<NR>;
  static bool attr = false;  // the shared memory limit, set once
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  kernel<<<a.p.blocks, kThreads, a.p.smem, stream>>>(a, maps[0], maps[1],
                                                       maps[2]);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const Args& a, cudaStream_t stream) {
  // the tensor maps, encoded only for the TMA tiles (host time a call)
  CUtensorMap maps[3] = {};
  if (a.p.tma &&
      (!flash_wgmma::tensor_map_2d(&maps[0], a.p0, a.M, a.c0, kRows) ||
       (a.c1 && !flash_wgmma::tensor_map_2d(&maps[1], a.p1, a.M, a.c1,
                                            kRows)) ||
       !flash_wgmma::tensor_map_2d(&maps[2], a.W, a.N, a.c0 + a.c1,
                                   a.p.nw)))
    return (int)cudaErrorInvalidValue;
  switch (a.p.nw) {
    case 64: return launch_wgmma<32>(a, maps, stream);
    case 128: return launch_wgmma<64>(a, maps, stream);
    case 256: return launch_wgmma<128>(a, maps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------- the f32 body

constexpr int kBM = 64;        // rows per block
constexpr int kBK = 32;        // channels per step

template <int BN>
__global__ void __launch_bounds__(256)
    shortcut_f32_kernel(const float* __restrict__ h,
                        const float* __restrict__ p0,
                        const float* __restrict__ p1, int c0, int c1,
                        const float* __restrict__ W,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int M, int N) {
  constexpr int kCG = BN / 4;       // column groups of 4
  constexpr int kRG = 256 / kCG;    // row groups
  constexpr int kRPT = kBM / kRG;   // rows per thread
  __shared__ float As[kBK][kBM + 4];  // transposed: As[k][row]
  __shared__ __align__(16) float Bs[kBK][BN + 4];  // transposed: Bs[k][n]
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN;
  const int ctot = c0 + c1;
  const int cg = threadIdx.x % kCG, rg = threadIdx.x / kCG;
  float acc[kRPT][4];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int piece = 0; piece < 2; ++piece) {
    const float* P = piece == 0 ? p0 : p1;
    const int C = piece == 0 ? c0 : c1;
    if (C == 0) break;
    const float* Wp = W + (piece == 0 ? 0 : c0);
    for (int k0 = 0; k0 < C; k0 += kBK) {
      __syncthreads();
      for (int i = threadIdx.x; i < kBM * kBK / 4; i += 256) {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < M && k0 + c < C)
          v = *reinterpret_cast<const float4*>(P + (size_t)(row0 + r) * C +
                                               k0 + c);
        As[c][r] = v.x;
        As[c + 1][r] = v.y;
        As[c + 2][r] = v.z;
        As[c + 3][r] = v.w;
      }
      for (int i = threadIdx.x; i < BN * kBK / 4; i += 256) {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col0 + r < N && k0 + c < C)
          v = *reinterpret_cast<const float4*>(Wp + (size_t)(col0 + r) * ctot +
                                               k0 + c);
        Bs[c][r] = v.x;
        Bs[c + 1][r] = v.y;
        Bs[c + 2][r] = v.z;
        Bs[c + 3][r] = v.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * cg]);
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const float a = As[k][rg * kRPT + i];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
  }

  const int col = col0 + 4 * cg;
  if (col >= N) return;  // N % 8 == 0: all 4 columns are in range
  const float4 bv = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int row = row0 + rg * kRPT + i;
    if (row >= M) continue;
    const size_t o = (size_t)row * N + col;
    const float4 hv = *reinterpret_cast<const float4*>(h + o);
    *reinterpret_cast<float4*>(out + o) =
        make_float4(hv.x + bv.x + acc[i][0], hv.y + bv.y + acc[i][1],
                    hv.z + bv.z + acc[i][2], hv.w + bv.w + acc[i][3]);
  }
}

template <int BN>
int launch_f32(const void* h, const void* p0, const void* p1, int c0, int c1,
               const void* W, const float* bias, void* out, int M, int N,
               cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  shortcut_f32_kernel<BN><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(p0),
      static_cast<const float*>(p1), c0, c1, static_cast<const float*>(W),
      bias, static_cast<float*>(out), M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// h, out: [M, N]; p0: [M, c0]; p1: [M, c1] or null with c1 = 0; W:
// [N, c0 + c1]; all of `dtype` (0 f32, 1 bf16) and contiguous; bias: [N]
// f32. N, c0 and c1 multiples of 8. bf16 launches the caller's plan
// (shortcut_launch_plan: stages, shared bytes, blocks), which must be this
// entry's own; there W may be f32 (w_f32) where the plan keeps it
// resident: the kernel rounds it to bf16 as it loads it.
INFODIFF_EXPORT int infodiff_shortcut_fused(const void* h, const void* p0,
                                            const void* p1, int c0, int c1,
                                            const void* W, const float* bias,
                                            void* out, int M, int N, int dtype,
                                            int w_f32, int stages, int smem,
                                            int blocks, cudaStream_t stream) {
  if (M < 1 || N < 8 || N % 8 || c0 < 8 || c0 % 8 || c1 < 0 || c1 % 8 ||
      (c1 > 0) != (p1 != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    Args a = {};
    if (!make_plan(M, c0, c1, N, a.p) || a.p.stages != stages ||
        a.p.smem != smem || a.p.blocks != blocks ||
        (w_f32 && !a.p.resident))
      return (int)cudaErrorInvalidValue;
    a.h = static_cast<const bf16*>(h);
    a.p0 = static_cast<const bf16*>(p0);
    a.p1 = static_cast<const bf16*>(p1);
    a.W = W;
    a.w_f32 = w_f32;
    a.bias = bias;
    a.out = static_cast<bf16*>(out);
    a.M = M; a.N = N; a.c0 = c0; a.c1 = c1;
    return dispatch_bf16(a, stream);
  }
  if (N <= 64)
    return launch_f32<64>(h, p0, p1, c0, c1, W, bias, out, M, N, stream);
  return launch_f32<128>(h, p0, p1, c0, c1, W, bias, out, M, N, stream);
}
