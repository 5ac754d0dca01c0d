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
// device memory once each. Design: a block owns 64 rows and BN = 64 or 128
// output columns (all of them when N <= 128, so each piece is read once;
// wider N is split into column tiles) and walks the pieces' channels in
// steps of 32 through shared memory. bf16 runs on the tensor cores
// (mma.sync m16n8k16, the helpers of flash_mma.cuh): 4 warps of 16 rows
// each; f32 runs as FMAs, a thread owning 4 columns of several rows. The
// staging is synchronous (no cp.async ring yet): a first kernel that is
// right, not yet one at the bound.
#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;

constexpr int kBM = 64;        // rows per block
constexpr int kBK = 32;        // channels per step
constexpr int kLDA = kBK + 8;  // bf16 row stride of the A tile (80 bytes)

template <int BN>
__global__ void __launch_bounds__(128)
    shortcut_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ p0,
                         const bf16* __restrict__ p1, int c0, int c1,
                         const bf16* __restrict__ W,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         int M, int N) {
  constexpr int kNT = BN / 8;  // accumulator tiles of a warp
  __shared__ __align__(16) bf16 As[kBM * kLDA];
  __shared__ __align__(16) bf16 Bs[BN * kLDA];  // [n][k]: rows of W
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN;
  const int ctot = c0 + c1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int piece = 0; piece < 2; ++piece) {
    const bf16* P = piece == 0 ? p0 : p1;
    const int C = piece == 0 ? c0 : c1;
    if (C == 0) break;
    const bf16* Wp = W + (piece == 0 ? 0 : c0);
    for (int k0 = 0; k0 < C; k0 += kBK) {
      __syncthreads();  // the previous step's fragments are read
      for (int i = threadIdx.x; i < kBM * kBK / 8; i += 128) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < M && k0 + c < C)
          v = *reinterpret_cast<const uint4*>(P + (size_t)(row0 + r) * C +
                                              k0 + c);
        *reinterpret_cast<uint4*>(As + r * kLDA + c) = v;
      }
      for (int i = threadIdx.x; i < BN * kBK / 8; i += 128) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col0 + r < N && k0 + c < C)
          v = *reinterpret_cast<const uint4*>(Wp + (size_t)(col0 + r) * ctot +
                                              k0 + c);
        *reinterpret_cast<uint4*>(Bs + r * kLDA + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned a[4];
        flash_mma::ldsm_x4(
            a, As + (warp * 16 + lane % 16) * kLDA + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int n2 = 0; n2 < BN / 16; ++n2) {
          // B[k][n] = Bs[n][k] (flash_mma::load_b_nk at this tile's stride)
          unsigned b[4];
          flash_mma::ldsm_x4(b, Bs + (n2 * 16 + (lane / 16) * 8 + lane % 8) *
                                         kLDA +
                                     kk * 16 + ((lane / 8) % 2) * 8);
          flash_mma::mma(acc[2 * n2], a, b[0], b[1]);
          flash_mma::mma(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // accumulator element e of tile n: row g (+8 for e >= 2), columns 2t, 2t+1
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + warp * 16 + g + half * 8;
      if (row >= M) continue;
      const size_t o = (size_t)row * N + col;
      const float2 hv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(h + o));
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(
          hv.x + b0 + acc[n][2 * half], hv.y + b1 + acc[n][2 * half + 1]);
    }
  }
}

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

template <typename T, int BN>
int launch(const void* h, const void* p0, const void* p1, int c0, int c1,
           const void* W, const float* bias, void* out, int M, int N,
           cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  if constexpr (sizeof(T) == 2)
    shortcut_bf16_kernel<BN><<<grid, 128, 0, stream>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(p0),
        static_cast<const bf16*>(p1), c0, c1, static_cast<const bf16*>(W),
        bias, static_cast<bf16*>(out), M, N);
  else
    shortcut_f32_kernel<BN><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(h), static_cast<const float*>(p0),
        static_cast<const float*>(p1), c0, c1, static_cast<const float*>(W),
        bias, static_cast<float*>(out), M, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bn(const void* h, const void* p0, const void* p1, int c0, int c1,
                const void* W, const float* bias, void* out, int M, int N,
                cudaStream_t stream) {
  if (N <= 64)
    return launch<T, 64>(h, p0, p1, c0, c1, W, bias, out, M, N, stream);
  return launch<T, 128>(h, p0, p1, c0, c1, W, bias, out, M, N, stream);
}

}  // namespace

// h, out: [M, N]; p0: [M, c0]; p1: [M, c1] or null with c1 = 0; W:
// [N, c0 + c1]; all of `dtype` (0 f32, 1 bf16) and contiguous; bias: [N]
// f32. N, c0 and c1 multiples of 8.
INFODIFF_EXPORT int infodiff_shortcut_fused(const void* h, const void* p0,
                                            const void* p1, int c0, int c1,
                                            const void* W, const float* bias,
                                            void* out, int M, int N, int dtype,
                                            cudaStream_t stream) {
  if (M < 1 || N < 8 || N % 8 || c0 < 8 || c0 % 8 || c1 < 0 || c1 % 8 ||
      (c1 > 0) != (p1 != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return dispatch_bn<__nv_bfloat16>(h, p0, p1, c0, c1, W, bias, out, M, N,
                                      stream);
  return dispatch_bn<float>(h, p0, p1, c0, c1, W, bias, out, M, N, stream);
}
