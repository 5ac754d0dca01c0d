// f32 tiles and micro-products of the flash-attention forward (K3a,
// flash_attention.cu) and backward (K3b, flash_attention_bwd.cu) for f32
// inputs (bf16 runs on the tensor cores, flash_mma.cuh).
//
// C = 128 channels (every attention site of the model). A block of 256
// threads works on 64-row f32 tiles in shared memory; every product is an
// f32 FMA. Rows are padded (132 and 68 floats) so that the 16-byte loads
// of a quarter warp fall in distinct banks.
#pragma once

#include <math.h>

#include "common.cuh"

namespace flash {

constexpr int kC = 128;         // channels
constexpr int kTile = 64;       // rows of a q tile and of a k/v tile
constexpr int kThreads = 256;
constexpr int kLD = kC + 4;     // row stride of a [64][128] tile
constexpr int kLDP = kTile + 4; // row stride of a [64][64] tile
constexpr int kTileFloats = kTile * kLD;
constexpr int kPFloats = kTile * kLDP;

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rows [row0, row0 + 64) of src [N, 128] into dst [64][kLD]; rows at or
// beyond N are zero
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int N) {
  for (int i = threadIdx.x; i < kTile * kC / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    const float4 v = row0 + r < N
                         ? *reinterpret_cast<const float4*>(
                               src + (size_t)(row0 + r) * kC + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * kLD + c) = v;
  }
}

// The [64 x 64] layout of a thread's 4x4 block of S = A B^T: rows
// ty + 16 a, columns tx + 16 b, with ty = tid / 16 and tx = tid % 16, so
// the 16 lanes that share a row are one half of a warp.
__device__ __forceinline__ int s_row(int a) { return threadIdx.x / 16 + 16 * a; }
__device__ __forceinline__ int s_col(int b) { return threadIdx.x % 16 + 16 * b; }

// s = A B^T over the 128 channels; A, B: [64][kLD]
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < kC; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(A + s_row(a) * kLD + c);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      y[b] = *reinterpret_cast<const float4*>(B + s_col(b) * kLD + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float t = s[a][b];
        t = fmaf(x[a].x, y[b].x, t);
        t = fmaf(x[a].y, y[b].y, t);
        t = fmaf(x[a].z, y[b].z, t);
        t = fmaf(x[a].w, y[b].w, t);
        s[a][b] = t;
      }
  }
}

// The [64 x 128] layout of a thread's 8x4 accumulator: rows
// (tid / 32) * 8 + r, columns (tid % 32) * 4 + c.
__device__ __forceinline__ int o_row(int r) { return (threadIdx.x / 32) * 8 + r; }
__device__ __forceinline__ int o_col() { return (threadIdx.x % 32) * 4; }

__device__ __forceinline__ void fma4(float (&o)[4], float p, const float4& v) {
  o[0] = fmaf(p, v.x, o[0]);
  o[1] = fmaf(p, v.y, o[1]);
  o[2] = fmaf(p, v.z, o[2]);
  o[3] = fmaf(p, v.w, o[3]);
}

// o += P V; P: [64][kLDP], V: [64][kLD]
__device__ __forceinline__ void mm_nn_acc(const float* P, const float* V,
                                          float (&o)[8][4]) {
  const int c0 = o_col();
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 p[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      p[r] = *reinterpret_cast<const float4*>(P + o_row(r) * kLDP + j);
    const float4 v0 = *reinterpret_cast<const float4*>(V + (j + 0) * kLD + c0);
    const float4 v1 = *reinterpret_cast<const float4*>(V + (j + 1) * kLD + c0);
    const float4 v2 = *reinterpret_cast<const float4*>(V + (j + 2) * kLD + c0);
    const float4 v3 = *reinterpret_cast<const float4*>(V + (j + 3) * kLD + c0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      fma4(o[r], p[r].x, v0);
      fma4(o[r], p[r].y, v1);
      fma4(o[r], p[r].z, v2);
      fma4(o[r], p[r].w, v3);
    }
  }
}

// o += P^T X; P: [64][kLDP] (rows of P are the sum index), X: [64][kLD]
__device__ __forceinline__ void mm_tn_acc(const float* P, const float* X,
                                          float (&o)[8][4]) {
  const int c0 = o_col(), r0 = o_row(0);
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    const float4 p0 = *reinterpret_cast<const float4*>(P + i * kLDP + r0);
    const float4 p1 = *reinterpret_cast<const float4*>(P + i * kLDP + r0 + 4);
    const float4 x = *reinterpret_cast<const float4*>(X + i * kLD + c0);
    fma4(o[0], p0.x, x);
    fma4(o[1], p0.y, x);
    fma4(o[2], p0.z, x);
    fma4(o[3], p0.w, x);
    fma4(o[4], p1.x, x);
    fma4(o[5], p1.y, x);
    fma4(o[6], p1.z, x);
    fma4(o[7], p1.w, x);
  }
}

// max and sum over the 16 lanes that share a row of S
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Running row max m and sum l of exp(s * scale - m) over all N keys for
// the 64 query rows in qs (the thread's rows s_row(a)); ks is scratch.
__device__ inline void row_stats(const float* qs, float* ks, const float* kb,
                                 int N, float scale, float (&m)[4],
                                 float (&l)[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, kb, k0, N);
    __syncthreads();
    float s[4][4];
    mm_nt(qs, ks, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = k0 + s_col(b) < N ? s[a][b] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][b]);
      }
      // key k0 is valid, so m_new is finite
      const float m_new = fmaxf(m[a], row_max(mx));
      float e = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) e += expf(s[a][b] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + row_sum(e);
      m[a] = m_new;
    }
  }
}

}  // namespace flash
