// f32 tiles and micro-products of the flash-attention forwards (K3a,
// flash_attention.cu; K3c, flash_attention_online.cu) and backward (K3b,
// flash_attention_bwd.cu) for f32 inputs (bf16 runs on the tensor cores,
// flash_mma.cuh).
//
// A block of 256 threads works on 64-row f32 tiles of 128 channels in
// shared memory; every product is an f32 FMA. Rows are padded (132 and 68
// floats) so that the 16-byte loads of a quarter warp fall in distinct
// banks. At C = 256 and 512 the channels go through the tiles in
// 128-wide chunks, and at C = 64 channels 64-127 of a tile are zero and
// not stored, as in flash_mma.cuh.
#pragma once

#include <math.h>

#include "common.cuh"

namespace flash {

constexpr int kC = 128;         // channels of a tile: one chunk of C
constexpr int kTile = 64;       // rows of a q tile and of a k/v tile
constexpr int kThreads = 256;
constexpr int kLD = kC + 4;     // row stride of a [64][128] tile
constexpr int kLDP = kTile + 4; // row stride of a [64][64] tile
constexpr int kTileFloats = kTile * kLD;
constexpr int kPFloats = kTile * kLDP;

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rows [row0, row0 + 64) and channels [c0, c0 + 128) of src [N, C] into
// dst [64][kLD]; rows at or beyond N and channels at or beyond C are zero
template <int C>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int row0, int N, int c0) {
  for (int i = threadIdx.x; i < kTile * kC / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    const float4 v = row0 + r < N && (C >= kC || c < C)
                         ? *reinterpret_cast<const float4*>(
                               src + (size_t)(row0 + r) * C + c0 + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * kLD + c) = v;
  }
}

// The [64 x 64] layout of a thread's 4x4 block of S = A B^T: rows
// ty + 16 a, columns tx + 16 b, with ty = tid / 16 and tx = tid % 16, so
// the 16 lanes that share a row are one half of a warp.
__device__ __forceinline__ int s_row(int a) { return threadIdx.x / 16 + 16 * a; }
__device__ __forceinline__ int s_col(int b) { return threadIdx.x % 16 + 16 * b; }

// s += A B^T over the tiles' 128 channels; A, B: [64][kLD]
__device__ __forceinline__ void mm_nt_acc(const float* A, const float* B,
                                          float (&s)[4][4]) {
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

// s = A B^T for the 64 rows at a0 of A [N, C] against the 64 rows at b0 of
// B [N, C], over all C channels, 128 at a time through the tiles `as` and
// `bs`. When C <= kC the caller has loaded A's rows into `as` once and
// only B's are loaded here. If `xs` is given, channels [xc0, xc0 + 128) of
// X's rows b0 .. b0 + 63 land there with the first chunk. Starts with a
// barrier, so the tiles may still be in use when it is called.
template <int C>
__device__ inline void s_tile(float (&s)[4][4], float* as, float* bs,
                              const float* A, int a0, const float* B, int b0,
                              int N, float* xs = nullptr,
                              const float* X = nullptr, int xc0 = 0) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += kC) {
    __syncthreads();
    if (C > kC) load_chunk<C>(as, A, a0, N, c0);
    load_chunk<C>(bs, B, b0, N, c0);
    if (xs != nullptr && c0 == 0) load_chunk<C>(xs, X, b0, N, xc0);
    __syncthreads();
    mm_nt_acc(as, bs, s);
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
// the 64 rows at q0 of qb [N, C] (the thread's rows s_row(a)); qs holds
// them when C <= kC (else it is scratch), ks is scratch.
template <int C>
__device__ inline void row_stats(float* qs, float* ks, const float* qb,
                                 int q0, const float* kb, int N, float scale,
                                 float (&m)[4], float (&l)[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kTile) {
    float s[4][4];
    s_tile<C>(s, qs, ks, qb, q0, kb, k0, N);
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

// a thread's rows o_row(r) of a 64 x 128 f32 accumulator, each divided by
// div[r], to channels [c0, c0 + 128) (at C = 64: [0, 64)) of rows
// row0 + o_row(r) of dst [N, C]
template <int C>
__device__ __forceinline__ void store_rows(float* dst, const float (&o)[8][4],
                                           int row0, int N, int c0,
                                           const float (&div)[8]) {
  if (C < kC && o_col() >= C) return;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (row0 + o_row(r) < N) {
      const float v[4] = {o[r][0] / div[r], o[r][1] / div[r],
                          o[r][2] / div[r], o[r][3] / div[r]};
      store4(dst + (size_t)(row0 + o_row(r)) * C + c0 + o_col(), v);
    }
}

constexpr size_t kTwoPassSmem = (3 * kTileFloats + kPFloats) * sizeof(float);

// The two-pass forward for the 64 query rows at q0 of qb/kb/vb/ob [N, C]
// in f32 (K3a's body, and K2's beyond its resident strip): pass 1 keeps
// each row's running max and sum, pass 2 recomputes the logits, forms
// w = exp(s - max) / sum and accumulates w v per 128-channel output slice.
// smem: kTwoPassSmem bytes.
template <int C>
__device__ inline void forward_two_pass(float* smem, const float* qb,
                                        const float* kb, const float* vb,
                                        float* ob, int q0, int N,
                                        float scale) {
  float* qs = smem;              // [64][kLD]
  float* ks = qs + kTileFloats;  // [64][kLD]
  float* vs = ks + kTileFloats;  // [64][kLD]
  float* ps = vs + kTileFloats;  // [64][kLDP]: weights
  if (C <= kC) load_chunk<C>(qs, qb, q0, N, 0);

  float m[4], l[4];
  row_stats<C>(qs, ks, qb, q0, kb, N, scale, m, l);

  const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
#pragma unroll 1
  for (int oc = 0; oc < C; oc += kC) {
    float o[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kTile) {
      float s[4][4];
      s_tile<C>(s, qs, ks, qb, q0, kb, k0, N, vs, vb, oc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float w = k0 + s_col(bb) < N
                              ? expf(s[a][bb] * scale - m[a]) / l[a]
                              : 0.f;
          ps[s_row(a) * kLDP + s_col(bb)] = w;
        }
      __syncthreads();
      mm_nn_acc(ps, vs, o);
    }
    store_rows<C>(ob, o, q0, N, oc, one);
  }
}

}  // namespace flash
