// bf16 tensor-core building blocks of the flash-attention kernels (K3a,
// K3b): mma.sync m16n8k16 with f32 accumulation and ldmatrix fragment
// loads from bf16 tiles in shared memory.
//
// A block of 128 threads (4 warps) works on 64-row tiles; a warp owns 16
// rows (the m16 of the product). Tiles keep C = 128 bf16 channels per row
// with rows padded to 136 elements (272 bytes), so the eight 16-byte rows
// one ldmatrix reads fall in distinct banks.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4 and
// t = lane % 4: an accumulator holds rows g and g + 8, columns 2t and
// 2t + 1 of a 16 x 8 tile; an A fragment holds rows g and g + 8, k = 2t,
// 2t + 1 and 2t + 8, 2t + 9 of a 16 x 16 tile. Two neighbouring
// accumulator tiles, rounded to bf16 and packed in pairs, are therefore
// one A fragment: the softmax weights and ds feed the next product from
// registers.
#pragma once

#include <math.h>

#include "common.cuh"

namespace flash_mma {

typedef __nv_bfloat16 bf16;

constexpr int kC = 128;
constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kLD = kC + 8;  // bf16 row stride of a tile
constexpr int kTileElems = kTile * kLD;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// d += a b for one m16n8k16 tile
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ int lane() { return threadIdx.x % 32; }

// A fragment of rows [m0, m0 + 16), k [k0, k0 + 16) of a row-major tile
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile,
                                       int m0, int k0) {
  ldsm_x4(a, tile + (m0 + lane() % 16) * kLD + k0 + (lane() / 16) * 8);
}

// B fragments of two n tiles [n0, n0 + 16), k [k0, k0 + 16), where
// B[k][n] = tile[n][k] (the tile holds B's columns as rows): b[0], b[1]
// for n0 and b[2], b[3] for n0 + 8
__device__ __forceinline__ void load_b_nk(unsigned (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  ldsm_x4(b, tile + (n0 + (lane() / 16) * 8 + lane() % 8) * kLD + k0 +
                 ((lane() / 8) % 2) * 8);
}

// the same where B[k][n] = tile[k][n] (the tile holds B's rows)
__device__ __forceinline__ void load_b_kn(unsigned (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  ldsm_x4_trans(b, tile + (k0 + lane() % 16) * kLD + n0 + (lane() / 16) * 8);
}

// rows [row0, row0 + 64) of src [N, 128] into a tile; rows at or beyond N
// are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int N) {
  for (int i = threadIdx.x; i < kTile * kC / 8; i += kThreads) {
    const int r = i / (kC / 8), c = (i % (kC / 8)) * 8;
    const uint4 v = row0 + r < N
                        ? *reinterpret_cast<const uint4*>(
                              src + (size_t)(row0 + r) * kC + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * kLD + c) = v;
  }
}

// s = A B^T for the warp's 16 rows of `a_tile` (from m0) against the 64
// rows of `b_tile`, over the 128 channels: 8 accumulator tiles
__device__ __forceinline__ void mm_abt(float (&s)[8][4], const bf16* a_tile,
                                       int m0, const bf16* b_tile) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    unsigned a[4];
    load_a(a, a_tile, m0, kk * 16);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      unsigned b[4];
      load_b_nk(b, b_tile, n2 * 16, kk * 16);
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// o += P X, P given as four A fragments (64 keys), X a [64][128] tile:
// 16 accumulator tiles over the channels
__device__ __forceinline__ void mm_px(float (&o)[16][4],
                                      const unsigned (&p)[4][4],
                                      const bf16* x_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) {
      unsigned b[4];
      load_b_kn(b, x_tile, kk * 16, n2 * 16);
      mma(o[2 * n2], p[kk], b[0], b[1]);
      mma(o[2 * n2 + 1], p[kk], b[2], b[3]);
    }
}

// key index of accumulator element e of tile n within a 64-key tile
__device__ __forceinline__ int acc_col(int n, int e) {
  return n * 8 + (lane() % 4) * 2 + (e & 1);
}

// reductions over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Running max m and sum l of exp(s * scale - m) over all N keys for the
// warp's rows g and g + 8 (index 0 and 1) of the q tile `qs`; ks is
// scratch for the k tiles.
__device__ inline void row_stats(const bf16* qs, bf16* ks, const bf16* kb,
                                 int N, float scale, float (&m)[2],
                                 float (&l)[2]) {
  const int m0 = (threadIdx.x / 32) * 16;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, kb, k0, N);
    __syncthreads();
    float s[8][4];
    mm_abt(s, qs, m0, ks);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = k0 + acc_col(n, e) < N ? s[n][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // key k0 is valid, so the new max is finite
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sum += expf(s[n][2 * h] - m_new) + expf(s[n][2 * h + 1] - m_new);
      l[h] = l[h] * expf(m[h] - m_new) + quad_sum(sum);
      m[h] = m_new;
    }
  }
}

}  // namespace flash_mma
