// Device code shared by the latent MLP kernels: K4 (latent_traj.cu, the
// whole trajectory) and K5 (latent_mlp.cu, one forward).
//
// Both run the packed LatentUNet (ops/cuda/latent_mlp.py): 10 layers of
// [rows, 5d] x [5d, 4d] over W [L, 5d, 4d] in [in, out] layout. A block
// owns BT batch rows (the row tiling: the wrapper picks BT in {1, 2, 4, 8}
// so the grid covers the SMs) and keeps each row's layer input [h, x] in
// shared memory, rounded to the product input type; thread t owns the 4
// output columns 4t .. 4t+3 of every layer (the column ownership), reads
// the weight matrix row by row with one 8- or 16-byte load per row (a warp
// reads 256 or 512 contiguous bytes) and accumulates BT x 4 sums in
// registers.
#pragma once

#include "common.cuh"

namespace latent_common {

constexpr float kEps = 1e-5f;  // the LayerNorm's

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

__device__ __forceinline__ void load4(const int8_t* p, float (&w)[4]) {
  const char4 t = *reinterpret_cast<const char4*>(p);
  w[0] = (float)t.x;
  w[1] = (float)t.y;
  w[2] = (float)t.z;
  w[3] = (float)t.w;
}

// The type the matmul inputs are rounded to: W's own, bf16 for int8 W.
template <typename WT>
struct InputType {
  using type = WT;
};
template <>
struct InputType<int8_t> {
  using type = __nv_bfloat16;
};

// z[r][c] += sum_k inp[r * ld + in_off + k] * Wj[k * h + c] for the block's
// BT rows and the thread's 4 columns (Wj already offset to them), k
// ascending, one f32 FMA per term.
template <typename WT, int BT>
__device__ __forceinline__ void rows_times_columns(const WT* __restrict__ Wj,
                                                   const float* inp, int ld,
                                                   int in_off, int K, int h,
                                                   float (&z)[BT][4]) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float w[4];
    load4(Wj + (size_t)k * h, w);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float a = inp[r * ld + in_off + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) z[r][c] = fmaf(a, w[c], z[r][c]);
    }
  }
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

}  // namespace latent_common
