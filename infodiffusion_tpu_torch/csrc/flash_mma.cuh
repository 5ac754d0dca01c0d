// bf16 tensor-core building blocks of K2's and K2''s two-pass body beyond
// their resident strip (forward_two_pass; attention.cu), whose fragment
// helpers K2's strip body also uses: mma.sync
// m16n8k16 with f32 accumulation and ldmatrix fragment loads from bf16
// tiles in shared memory. The bf16 flash forwards K3a / K3c and the
// backward K3b run on Hopper's warpgroup products instead
// (flash_wgmma.cuh, flash_bwd_wgmma.cuh).
//
// A block of 128 threads (4 warps) works on 64-row tiles; a warp owns 16
// rows (the m16 of the product). A tile holds 128 bf16 channels per row
// (one chunk of C) with rows padded to 136 elements (272 bytes), so the
// eight 16-byte rows one ldmatrix reads fall in distinct banks. At C = 256
// and 512 the kernels walk the channels in 128-wide chunks: q k^T sums over
// the chunks, and each 128-channel slice of the output is its own pass, so
// shared memory and the accumulators stay those of C = 128. At C = 64 a
// chunk load fills channels 64-127 with zeros and the products and stores
// stop at channel 64 (width<C>()), so the function is exactly that of the
// 64 channels: the zeros add nothing to q k^T, the scale stays C^-1/2, and
// the output's channels 64-127 are not stored.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4 and
// t = lane % 4: an accumulator holds rows g and g + 8, columns 2t and
// 2t + 1 of a 16 x 8 tile; an A fragment holds rows g and g + 8, k = 2t,
// 2t + 1 and 2t + 8, 2t + 9 of a 16 x 16 tile. Two neighbouring
// accumulator tiles, rounded to bf16 and packed in pairs, are therefore
// one A fragment: the softmax weights feed the next product from
// registers.
#pragma once

#include <math.h>

#include "common.cuh"

namespace flash_mma {

typedef __nv_bfloat16 bf16;

constexpr int kC = 128;  // channels of a tile: one chunk of C
constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr int kLD = kC + 8;  // bf16 row stride of a tile
constexpr int kTileElems = kTile * kLD;

// the channels of a tile that hold data: all 128, or C's 64
template <int C>
__host__ __device__ constexpr int width() {
  return C < kC ? C : kC;
}

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
// of row stride LD
template <int LD = kLD>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile,
                                       int m0, int k0) {
  ldsm_x4(a, tile + (m0 + lane() % 16) * LD + k0 + (lane() / 16) * 8);
}

// B fragments of two n tiles [n0, n0 + 16), k [k0, k0 + 16), where
// B[k][n] = tile[n][k] (the tile holds B's columns as rows): b[0], b[1]
// for n0 and b[2], b[3] for n0 + 8
template <int LD = kLD>
__device__ __forceinline__ void load_b_nk(unsigned (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  ldsm_x4(b, tile + (n0 + (lane() / 16) * 8 + lane() % 8) * LD + k0 +
                 ((lane() / 8) % 2) * 8);
}

// the same where B[k][n] = tile[k][n] (the tile holds B's rows)
template <int LD = kLD>
__device__ __forceinline__ void load_b_kn(unsigned (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  ldsm_x4_trans(b, tile + (k0 + lane() % 16) * LD + n0 + (lane() / 16) * 8);
}

// rows [row0, row0 + 64) and channels [c0, c0 + 128) of src [N, C] into
// a tile; rows at or beyond N and channels at or beyond C are zero
template <int C>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           int row0, int N, int c0) {
  for (int i = threadIdx.x; i < kTile * kC / 8; i += kThreads) {
    const int r = i / (kC / 8), c = (i % (kC / 8)) * 8;
    const uint4 v = row0 + r < N && (C >= kC || c < C)
                        ? *reinterpret_cast<const uint4*>(
                              src + (size_t)(row0 + r) * C + c0 + c)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * kLD + c) = v;
  }
}

// s += A B^T for the warp's 16 rows of `a_tile` (from m0) against the 64
// rows of `b_tile`, over the tiles' first W channels: 8 accumulator tiles
template <int W = kC>
__device__ __forceinline__ void mm_abt_acc(float (&s)[8][4],
                                           const bf16* a_tile, int m0,
                                           const bf16* b_tile) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
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

__device__ __forceinline__ void zero(float (&s)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
}

// s = A B^T for the warp's 16 of the 64 rows at a0 of A [N, C] against the
// 64 rows at b0 of B [N, C], over all C channels, 128 at a time through
// the tiles `as` and `bs`. When C <= kC the caller has loaded A's rows
// into `as` once and only B's are loaded here. If `xs` is given, channels
// [xc0, xc0 + 128) of X's rows b0 .. b0 + 63 land there with the first
// chunk (the next product's operand, loaded in the same window). Starts
// with a barrier, so the tiles may still be in use when it is called.
template <int C>
__device__ inline void s_tile(float (&s)[8][4], bf16* as, bf16* bs,
                              const bf16* A, int a0, const bf16* B, int b0,
                              int N, bf16* xs = nullptr,
                              const bf16* X = nullptr, int xc0 = 0) {
  const int m0 = (threadIdx.x / 32) * 16;
  zero(s);
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += kC) {
    __syncthreads();
    if (C > kC) load_chunk<C>(as, A, a0, N, c0);
    load_chunk<C>(bs, B, b0, N, c0);
    if (xs != nullptr && c0 == 0) load_chunk<C>(xs, X, b0, N, xc0);
    __syncthreads();
    mm_abt_acc<width<C>()>(s, as, m0, bs);
  }
}

// o += P X, P given as four A fragments (64 keys), X a [64][128] tile:
// 16 accumulator tiles over the channels, the first W / 8 of them written
template <int W = kC>
__device__ __forceinline__ void mm_px(float (&o)[16][4],
                                      const unsigned (&p)[4][4],
                                      const bf16* x_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < W / 16; ++n2) {
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
// warp's rows g and g + 8 (index 0 and 1) of the 64 rows at q0 of qb
// [N, C]; qs holds them when C <= kC (else it is scratch), ks is scratch.
template <int C>
__device__ inline void row_stats(bf16* qs, bf16* ks, const bf16* qb, int q0,
                                 const bf16* kb, int N, float scale,
                                 float (&m)[2], float (&l)[2]) {
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    float s[8][4];
    s_tile<C>(s, qs, ks, qb, q0, kb, k0, N);
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

// The warp's 16 rows of a 64 x 128 f32 accumulator o, rounded to bf16, to
// channels [c0, c0 + width) of rows row0 + m0 + g (+ 8) of dst [N, C],
// each row divided by div[h] first
template <int C>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&o)[16][4],
                                           int row0, int N, int c0,
                                           const float (&div)[2]) {
  const int m0 = (threadIdx.x / 32) * 16, g = lane() / 4, t = lane() % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + m0 + g + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < width<C>() / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * C + c0 + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(o[n][2 * h] / div[h],
                                o[n][2 * h + 1] / div[h]);
  }
}

constexpr size_t kTwoPassSmem = 3 * kTileElems * sizeof(bf16);

// The two-pass forward for the 64 query rows at q0 of qb/kb/vb/ob [N, C]
// (K2's and K2''s beyond their resident strip): pass 1 keeps each
// row's running max and sum over all keys, pass 2 recomputes the logits,
// forms w = exp(s - max) / sum in f32 and accumulates w v per 128-channel
// output slice. w goes to PV rounded to bf16 (K2) or, with kSplitW,
// unrounded as hi = bf16(w) plus lo = bf16(w - hi), two products (K2').
// smem: kTwoPassSmem bytes.
template <int C, bool kSplitW = false>
__device__ inline void forward_two_pass(bf16* smem, const bf16* qb,
                                        const bf16* kb, const bf16* vb,
                                        bf16* ob, int q0, int N,
                                        float scale) {
  bf16* qs = smem;
  bf16* ks = qs + kTileElems;
  bf16* vs = ks + kTileElems;
  if (C <= kC) load_chunk<C>(qs, qb, q0, N, 0);

  float m[2], l[2];
  row_stats<C>(qs, ks, qb, q0, kb, N, scale, m, l);

  const float one[2] = {1.f, 1.f};
#pragma unroll 1
  for (int oc = 0; oc < C; oc += kC) {
    float o[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int k0 = 0; k0 < N; k0 += kTile) {
      float s[8][4];
      s_tile<C>(s, qs, ks, qb, q0, kb, k0, N, vs, vb, oc);
      // w = exp(s - max) / sum in f32, rounded to bf16 as A fragments
      unsigned p[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 2 * kk + half;
          float w[4], r[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            w[e] = k0 + acc_col(n, e) < N
                       ? expf(s[n][e] * scale - m[e / 2]) / l[e / 2]
                       : 0.f;
            r[e] = w[e] - __bfloat162float(__float2bfloat16(w[e]));
          }
          p[kk][2 * half] = pack(w[0], w[1]);
          p[kk][2 * half + 1] = pack(w[2], w[3]);
          lo[kk][2 * half] = pack(r[0], r[1]);
          lo[kk][2 * half + 1] = pack(r[2], r[3]);
        }
      mm_px<width<C>()>(o, p, vs);
      if (kSplitW) mm_px<width<C>()>(o, lo, vs);
    }
    store_rows<C>(ob, o, q0, N, oc, one);
  }
}

}  // namespace flash_mma
