// bf16 flash-attention backward on Hopper: the block bodies of K3b
// (flash_attention_bwd.cu) on both contracts, at C = 64, 128, 256, 512 and
// any N.
//
// What bounds it: per batch element 9 products of 2 N^2 C FLOPs (11 on the
// dense contract) against 7 N C elements of memory, so the products. The
// design is the forwards' (flash_wgmma.cuh), on the same building blocks
// (wgmma_common.cuh): whole-C tiles resident in shared memory, the streamed
// operand through a TMA ring with full/empty mbarriers kept by one producer
// warp, warpgroup products (wgmma m64nNk16, bf16 in, f32 accumulate), and
// each product's bf16 operand taken straight from the previous product's
// accumulators, whose layout is wgmma's A fragment. Blocks run in no
// order, so the backward is two launches, deterministic and free of
// atomics; dq is written only by the first, dk and dv only by the second.
//
// (i) rows_kernel, grid (query tile, batch): a block owns BQ query rows and
//     keeps their q and do tiles resident; k and v tiles [BK, C] stream
//     through the ring twice.
//     - Pass 1, the row statistics in one online pass: S = q k^T and
//       dP = do v^T (SS wgmma), a running max m, and the sums
//       l = sum exp(s - m) and dl = sum exp(s - m) dp rescaled together
//       whenever m grows. At the end delta = dl / l, the contract's
//       rowsum(w dp) up to f32 rounding (the TPU kernel and the f32 body
//       take a pass for m and l and another for delta: one product more).
//     - Pass 2: S and dP again, w = exp2(s2 - lse2), ds = w (dp - delta)
//       C^-1/2 in f32, and dq += ds k as an RS wgmma with ds packed from
//       the accumulators and k read MN-major (the descriptor's transpose
//       bit, as the forwards' PV reads v). S and dP of tile j are issued
//       ahead of dq of tile j - 1, so the exponentials of tile j run while
//       that product is on the tensor cores.
//     Writes dq and the statistics (lse2 = m + log2 l in base 2, delta) to
//     an f32 scratch [B][2][Npad], Npad = N rounded up to 128, so that the
//     second launch bulk-copies a tile's statistics with its q and do.
// (ii) cols_kernel, grid (key tile, batch): a block owns BK keys and keeps
//     their k and v tiles resident; q and do tiles [BQ, C] and their
//     statistics stream through the ring. S^T = k q^T and dP^T = v do^T
//     (SS wgmma); their accumulators become the A fragments of
//     w^T (rounded to bf16 under both contracts) and ds^T, which feed
//     dv += w^T do and dk += ds^T q as RS wgmma with do and q read
//     MN-major. dk and dv for all C stay in registers (at C = 128 that is
//     128 of a thread's 240, which leaves no room for a second S^T / dP^T
//     set, so a warpgroup's tiles run in order; two warpgroups per block
//     keep the tensor cores fed while either computes its exponentials).
//
// Widths. C = 64 and 128: each consumer warpgroup owns 64 rows (keys in
// (ii)) and all C channels; a block has one or two (BQ or BK = 64 or 128,
// flash_bwd_launch_plan). C = 256 and 512: [64, C] f32 accumulators do not
// fit one warpgroup, so two warpgroups share 64 rows and split the output
// channels; the first computes S and dP (once, over all C), uses its
// fragments for its half and hands them to the second through shared
// memory (no-swizzle K-major core matrices, named barriers 1 and 2), which
// runs its half as SS wgmma. At C = 512 (ii) runs dv and dk as two passes
// over the q tiles (two [64, 256] accumulators would not fit either); the
// logits are computed once per pass, never once per channel slice.
//
// The dense contract (kDense; XLA's autodiff of the dense attention): dp
// is rounded to bf16 where do v^T lands and delta sums the rounded dp; ds
// stays f32 into dq and dk, carried as hi = bf16(ds) plus
// lo = bf16(ds - hi), two products into the same accumulator.
//
// Rows and columns beyond N: TMA fills k, v, q and do rows past N with
// zeros; keys past N are masked to -inf in (i) and queries past N to
// w = ds = 0 in (ii); rows past N are computed and not stored.
#pragma once

#include <type_traits>

#include "wgmma_common.cuh"

namespace flash_bwd {

using namespace flash_wgmma;

// x rounded to bf16 and back
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr int kStatAlign = 128;  // Npad: N rounded up to this

// ------------------------------------------------------------ the plans

// (i): C, consumer warpgroups, the k/v tile BK, the ring's stages and the
// contract. C >= 256: two warpgroups share 64 rows and split dq's channels.
template <int C_, int kWG_, int BK_, int kStages_, bool kDense_>
struct RowsPlan {
  static constexpr int C = C_, kWG = kWG_, BK = BK_, kStages = kStages_;
  static constexpr bool kDense = kDense_;
  static constexpr bool kSplit = C >= 256;
  static constexpr int kCW = kSplit ? C / 2 : C;  // dq's channels a warpgroup
  static constexpr int BQ = kSplit ? 64 : 64 * kWG;
  static constexpr int kPanels = C / 64;          // 64-channel tiles
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = BQ * C * 2;      // q, and do again
  static constexpr int kKVBytes = BK * C * 2;     // one k or v tile
  static constexpr int kFragBytes = kSplit ? 64 * BK * 2 : 0;  // ds handed
  // hi and lo (lo only under kDense; one plan serves both contracts)
  static constexpr int kFrags = 2;
  static constexpr int kBarBytes = 64;            // 2 kStages + 1 mbarriers
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes +
                               kFrags * kFragBytes + kBarBytes;
  static_assert(!kSplit || kWG == 2, "C >= 256 takes two warpgroups");
  static_assert(kSplit || kStages >= 2, "pass 2 holds two stages");
  static_assert(2 * kStages + 1 <= kBarBytes / 8, "barrier space");
  static_assert(kSmem <= 232448, "shared memory");
};

// (ii): C, consumer warpgroups, the q/do tile BQ, stages, contract. C >= 256:
// two warpgroups share 64 keys and split dk's and dv's channels; C = 512
// runs dv and dk as two passes.
template <int C_, int kWG_, int BQ_, int kStages_, bool kDense_>
struct ColsPlan {
  static constexpr int C = C_, kWG = kWG_, BQ = BQ_, kStages = kStages_;
  static constexpr bool kDense = kDense_;
  static constexpr bool kSplit = C >= 256;
  static constexpr bool kTwoPass = C == 512;
  static constexpr int kCW = kSplit ? C / 2 : C;
  static constexpr int BK = kSplit ? 64 : 64 * kWG;  // keys a block
  static constexpr int kPanels = C / 64;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kKBytes = BK * C * 2;     // k, and v again
  static constexpr int kQBytes = BQ * C * 2;     // one q or do tile
  static constexpr int kStatBytes = 2 * BQ * 4;  // lse2 and delta of a tile
  static constexpr int kFragBytes = kSplit ? 64 * BQ * 2 : 0;
  static constexpr int kFrags = 3;  // w^T, ds^T hi and lo (as in RowsPlan)
  static constexpr int kBarBytes = 64;
  static constexpr int kSmem = 1024 + 2 * kKBytes + 2 * kStages * kQBytes +
                               kStages * kStatBytes + kFrags * kFragBytes +
                               kBarBytes;
  static_assert(!kSplit || kWG == 2, "C >= 256 takes two warpgroups");
  static_assert(2 * kStages + 1 <= kBarBytes / 8, "barrier space");
  static_assert(kSmem <= 232448, "shared memory");
};

// ------------------------------------------------------------ shared parts

// accumulator element i of a thread: row 16 warp + g + 8 acc_h(i), column
// acc_col(i, t) of the m64nN tile
__device__ __forceinline__ int acc_h(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int t) {
  return (i / 4) * 8 + 2 * t + (i & 1);
}

// x (an accumulator of KT columns) as A fragments, KT / 16 of them; with
// kLo the rounding error x - bf16(x) as a second set
template <bool kLo, int KT>
__device__ __forceinline__ void pack_frags(const float (&x)[KT / 2],
                                           unsigned (&hi)[KT / 16][4],
                                           unsigned (&lo)[KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      hi[kk][r] = pack(a, b);
      if constexpr (kLo) lo[kk][r] = pack(a - rbf(a), b - rbf(b));
    }
}

// A fragments of a [64, KT] operand into shared memory at buf as no-swizzle
// K-major core matrices of 8 rows x 8 columns, which an SS wgmma reads with
// desc(buf + kk * 256, 128, KT * 16, 0)
template <int KT>
__device__ __forceinline__ void store_frags(unsigned* buf,
                                            const unsigned (&a)[KT / 16][4],
                                            int warp, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1);
      const int col = 16 * kk + 8 * (r >> 1) + 2 * t;
      buf[((row / 8) * KT * 16 + (col / 8) * 128 + (row % 8) * 16 +
           (col % 8) * 2) / 4] = a[kk][r];
    }
}

// a thread's rows of a [64, W] f32 accumulator, rounded to bf16, to rows
// row0 + 16 warp + g (+ 8) and channels c0 .. c0 + W of dst [N, C]
template <int C, int W>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[W / 2],
                                          int row0, int N, int c0, int warp,
                                          int g, int t) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int row = row0 + 16 * warp + g + 8 * acc_h(i);
    if (row < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * C + c0 +
                                         acc_col(i, t)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// d = A B^T over all C channels, A the 64 rows at a_row of a resident
// [R, C] tile (panels of R rows), B the [NT, C] tile at b (panels of NT
// rows); both K-major, 128-byte swizzled. Issued, not committed.
template <int C, int R, int NT, int D>
__device__ __forceinline__ void issue_abt(float (&d)[D], uint32_t a,
                                          int a_row, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    wgmma_ss<0>(d, desc(a + (kk / 4) * R * 128 + a_row * 128 + (kk % 4) * 32,
                        16, 1024, 1),
                desc(b + (kk / 4) * NT * 128 + (kk % 4) * 32, 16, 1024, 1),
                kk > 0);
}

// descriptor of the 16 rows from 16 kk of an [NT, C] tile at b read
// MN-major (the B of a product over its rows), from channel c0
__device__ __forceinline__ uint64_t mn_desc(uint32_t b, int NT, int c0,
                                            int kk) {
  return desc(b + (c0 / 64) * NT * 128 + kk * 16 * 128, NT * 128, 1024, 1);
}

// ------------------------------------------------------- (i) dq, statistics

// Query rows of [B, N, C] for this block: blockIdx.x * BQ; batch
// blockIdx.y. scale2 = C^-1/2 log2(e), scale = C^-1/2.
template <class P>
__global__ void __launch_bounds__(P::kThreads, 1)
    rows_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                bf16* __restrict__ dq, float* __restrict__ stats, int N,
                int n_pad, float scale2, float scale) {
  constexpr int C = P::C, BK = P::BK, S = P::kStages, BQ = P::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // q [panel][BQ][64]
  const uint32_t sdo = sq + P::kQBytes;         // do, the same
  const uint32_t sring = sdo + P::kQBytes;      // stage s: k, then v
  const uint32_t sp = sring + 2 * S * P::kKVBytes;  // split: ds hi, lo
  const uint32_t sbar = sp + P::kFrags * P::kFragBytes;
  unsigned* pbuf = reinterpret_cast<unsigned*>(smem_raw + (sp - raw));
  const auto kst = [&](int s) { return sring + 2 * s * P::kKVBytes; };
  const auto vst = [&](int s) { return kst(s) + P::kKVBytes; };
  const auto full = [&](int s) { return sbar + 8 * s; };
  const auto empty = [&](int s) { return sbar + 8 * (S + s); };
  const uint32_t qfull = sbar + 16 * S;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int nk = (N + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * P::kWG);  // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == P::kWG) {
    // ------------------------------------------------ producer warpgroup
    if (P::kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(qfull, 2 * P::kQBytes);
    for (int r = 0; r < BQ / 64; ++r)
      for (int p = 0; p < P::kPanels; ++p) {
        tma_load(sq + p * BQ * 128 + r * 8192, &tq, qfull, 64 * p,
                 q0 + 64 * r, b);
        tma_load(sdo + p * BQ * 128 + r * 8192, &tdo, qfull, 64 * p,
                 q0 + 64 * r, b);
      }
    for (int it = 0; it < 2 * nk; ++it) {  // both passes
      const int s = it % S, key0 = (it % nk) * BK;
      if (it >= S) mbar_wait(empty(s), (it / S - 1) & 1);
      mbar_expect_tx(full(s), 2 * P::kKVBytes);
      for (int p = 0; p < P::kPanels; ++p) {
        tma_load(kst(s) + p * BK * 128, &tk, full(s), 64 * p, key0, b);
        tma_load(vst(s) + p * BK * 128, &tv, full(s), 64 * p, key0, b);
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  if (P::kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this warpgroup's rows (from 64 rw) and dq channels (from c0)
  const int rw = P::kSplit ? 0 : wg, c0 = P::kSplit ? wg * P::kCW : 0;
  float acc[P::kCW / 2];
#pragma unroll
  for (int i = 0; i < P::kCW / 2; ++i) acc[i] = 0.f;
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  mbar_wait(qfull, 0);

  if (P::kSplit && wg == 1) {
    // the second warpgroup: pass 1 only keeps the ring's count; in pass 2
    // dq on its channels with ds from shared memory
    for (int it = 0; it < nk; ++it) {
      mbar_wait(full(it % S), (it / S) & 1);
      if (lane == 0) mbar_arrive(empty(it % S));
    }
    bar_arrive(2, 256);  // ds's buffer starts free
    for (int j = 0; j < nk; ++j) {
      const int it = nk + j, st = it % S;
      bar_sync(1, 256);  // ds of tile j is in
      mbar_wait(full(st), (it / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_ss<1>(acc, desc(sp + kk * 256, 128, BK * 16, 0),
                    mn_desc(kst(st), BK, c0, kk), 1);
        if constexpr (P::kDense)
          wgmma_ss<1>(acc, desc(sp + P::kFragBytes + kk * 256, 128, BK * 16, 0),
                      mn_desc(kst(st), BK, c0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(st));
      if (j + 1 < nk) bar_arrive(2, 256);
    }
  } else {
    float s[BK / 2], dp[BK / 2];
    unsigned hi[BK / 16][4], lo[BK / 16][4];  // ds as A fragments
    // S = q k^T and dP = do v^T of the tile in stage st, committed
    const auto issue_sdp = [&](int st) {
      wgmma_fence();
      issue_abt<C, BQ, BK>(s, sq, 64 * rw, kst(st));
      issue_abt<C, BQ, BK>(dp, sdo, 64 * rw, vst(st));
      wgmma_commit();
    };
    // dq += ds k for the tile in stage st, committed
    const auto issue_dq = [&](int st) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_rs<1>(acc, hi[kk], mn_desc(kst(st), BK, c0, kk));
        if constexpr (P::kDense)
          wgmma_rs<1>(acc, lo[kk], mn_desc(kst(st), BK, c0, kk));
      }
      wgmma_commit();
    };
    const auto dpv = [&](float x) { return P::kDense ? rbf(x) : x; };
    // ds = w (dp - delta) C^-1/2 in f32 into s, for key tile j
    const auto ds_math = [&](int j) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = acc_h(i);
        float ds = 0.f;
        if (j * BK + acc_col(i, t) < N) {
          const float w = exp2f(s[i] * scale2 - lse[h]);
          ds = w * (dpv(dp[i]) - delta[h]) * scale;
        }
        s[i] = ds;
      }
    };
    const auto hand = [&]() {  // ds to the second warpgroup
      if constexpr (P::kSplit) {
        bar_sync(2, 256);
        store_frags<BK>(pbuf, hi, warp, g, t);
        if constexpr (P::kDense)
          store_frags<BK>(pbuf + P::kFragBytes / 4, lo, warp, g, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(1, 256);
      }
    };

    // pass 1: each row's max m, l = sum exp(s - m), dl = sum exp(s - m) dp
    // (per thread, rescaled together; summed over the quad at the end)
    float m[2] = {-INFINITY, -INFINITY}, lp[2] = {0.f, 0.f},
          dlp[2] = {0.f, 0.f};
    for (int it = 0; it < nk; ++it) {
      const int st = it % S;
      mbar_wait(full(st), (it / S) & 1);
      issue_sdp(st);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(empty(st));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = it * BK + acc_col(i, t) < N ? s[i] * scale2 : -INFINITY;
        mx[acc_h(i)] = fmaxf(mx[acc_h(i)], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // key it * BK is valid, so the new max is finite; the first tile's
        // factor is exp2(-inf) = 0
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        const float corr = exp2f(m[h] - m_new);
        m[h] = m_new;
        lp[h] *= corr;
        dlp[h] *= corr;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = acc_h(i);
        const float e = exp2f(s[i] - m[h]);
        lp[h] += e;
        dlp[h] = fmaf(e, dpv(dp[i]), dlp[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l = quad_sum(lp[h]);
      delta[h] = quad_sum(dlp[h]) / l;
      lse[h] = m[h] + log2f(l);
    }

    // pass 2: dq
    if constexpr (!P::kSplit) {
      // S and dP of tile j are issued ahead of dq of tile j - 1
      mbar_wait(full(nk % S), (nk / S) & 1);
      issue_sdp(nk % S);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      ds_math(0);
      pack_frags<P::kDense, BK>(s, hi, lo);
      for (int j = 1; j < nk; ++j) {
        const int it = nk + j, st = it % S, prev = (it - 1) % S;
        mbar_wait(full(st), (it / S) & 1);
        issue_sdp(st);
        issue_dq(prev);
        wgmma_wait<1>();  // S, dP of tile j; dq of tile j - 1 may still run
        fence_regs(s);
        fence_regs(dp);
        ds_math(j);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(hi);
        fence_regs(lo);
        if (lane == 0) mbar_arrive(empty(prev));
        pack_frags<P::kDense, BK>(s, hi, lo);
      }
      issue_dq((2 * nk - 1) % S);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      if (lane == 0) mbar_arrive(empty((2 * nk - 1) % S));
    } else {
      for (int j = 0; j < nk; ++j) {
        const int it = nk + j, st = it % S;
        mbar_wait(full(st), (it / S) & 1);
        issue_sdp(st);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        ds_math(j);
        pack_frags<P::kDense, BK>(s, hi, lo);
        hand();
        issue_dq(st);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(hi);
        fence_regs(lo);
        if (lane == 0) mbar_arrive(empty(st));
      }
    }
  }

  const int row0 = q0 + 64 * rw;
  store_acc<C, P::kCW>(dq + (size_t)b * N * C, acc, row0, N, c0, warp, g, t);
  if ((!P::kSplit || wg == 0) && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * warp + g + 8 * h;
      if (row < N) {
        stats[(size_t)b * 2 * n_pad + row] = lse[h];
        stats[(size_t)b * 2 * n_pad + n_pad + row] = delta[h];
      }
    }
  }
}

// ------------------------------------------------------------ (ii) dk, dv

// Keys of [B, N, C] for this block: blockIdx.x * BK; batch blockIdx.y.
template <class P>
__global__ void __launch_bounds__(P::kThreads, 1)
    cols_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ stats, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int N, int n_pad, float scale2,
                float scale) {
  constexpr int C = P::C, BK = P::BK, S = P::kStages, BQ = P::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;  // k [panel][BK][64]
  const uint32_t sv = sk + P::kKBytes;          // v, the same
  const uint32_t sring = sv + P::kKBytes;       // stage s: q, then do
  const uint32_t sstat = sring + 2 * S * P::kQBytes;  // stage s: lse2, delta
  const uint32_t sp = sstat + S * P::kStatBytes;  // split: w^T, ds^T hi, lo
  const uint32_t sbar = sp + P::kFrags * P::kFragBytes;
  unsigned* pbuf = reinterpret_cast<unsigned*>(smem_raw + (sp - raw));
  const auto qst = [&](int s) { return sring + 2 * s * P::kQBytes; };
  const auto dost = [&](int s) { return qst(s) + P::kQBytes; };
  const auto full = [&](int s) { return sbar + 8 * s; };
  const auto empty = [&](int s) { return sbar + 8 * (S + s); };
  const uint32_t kvfull = sbar + 16 * S;

  const int b = blockIdx.y, k0 = blockIdx.x * BK;
  const int nq = (N + BQ - 1) / BQ;
  const int n_iter = (P::kTwoPass ? 2 : 1) * nq;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * P::kWG);
    }
    mbar_init(kvfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == P::kWG) {
    // ------------------------------------------------ producer warpgroup
    if (P::kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(kvfull, 2 * P::kKBytes);
    for (int r = 0; r < BK / 64; ++r)
      for (int p = 0; p < P::kPanels; ++p) {
        tma_load(sk + p * BK * 128 + r * 8192, &tk, kvfull, 64 * p,
                 k0 + 64 * r, b);
        tma_load(sv + p * BK * 128 + r * 8192, &tv, kvfull, 64 * p,
                 k0 + 64 * r, b);
      }
    const float* st_b = stats + (size_t)b * 2 * n_pad;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % S, i0 = (it % nq) * BQ;
      if (it >= S) mbar_wait(empty(s), (it / S - 1) & 1);
      mbar_expect_tx(full(s), 2 * P::kQBytes + P::kStatBytes);
      for (int p = 0; p < P::kPanels; ++p) {
        tma_load(qst(s) + p * BQ * 128, &tq, full(s), 64 * p, i0, b);
        tma_load(dost(s) + p * BQ * 128, &tdo, full(s), 64 * p, i0, b);
      }
      const uint32_t ss = sstat + s * P::kStatBytes;
      bulk_load(ss, st_b + i0, BQ * 4, full(s));
      bulk_load(ss + BQ * 4, st_b + n_pad + i0, BQ * 4, full(s));
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  if (P::kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this warpgroup's keys (from 64 rw) and dk / dv channels (from c0)
  const int rw = P::kSplit ? 0 : wg, c0 = P::kSplit ? wg * P::kCW : 0;
  const int row0 = k0 + 64 * rw;
  bf16* dkb = dk + (size_t)b * N * C;
  bf16* dvb = dv + (size_t)b * N * C;
  float acc_v[P::kCW / 2], acc_k[P::kCW / 2];
  const auto zero = [&](float (&a)[P::kCW / 2]) {
#pragma unroll
    for (int i = 0; i < P::kCW / 2; ++i) a[i] = 0.f;
  };
  // What a walk over the q tiles computes: 1 dv, 2 dk, 3 both. C = 512
  // walks twice (dv, then dk), else once for both.
  typedef std::integral_constant<int, 1> DV;
  typedef std::integral_constant<int, 2> DK;
  typedef std::integral_constant<int, 3> BOTH;
  const auto walks = [&](auto tile) {
    if constexpr (P::kTwoPass) {
      zero(acc_v);
      for (int j = 0; j < nq; ++j) tile(DV(), j);
      store_acc<C, P::kCW>(dvb, acc_v, row0, N, c0, warp, g, t);
      zero(acc_k);
      for (int j = 0; j < nq; ++j) tile(DK(), nq + j);
      store_acc<C, P::kCW>(dkb, acc_k, row0, N, c0, warp, g, t);
    } else {
      zero(acc_v);
      zero(acc_k);
      for (int j = 0; j < nq; ++j) tile(BOTH(), j);
      store_acc<C, P::kCW>(dvb, acc_v, row0, N, c0, warp, g, t);
      store_acc<C, P::kCW>(dkb, acc_k, row0, N, c0, warp, g, t);
    }
  };
  mbar_wait(kvfull, 0);

  if (P::kSplit && wg == 1) {
    // the second warpgroup: dv and dk on its channels with w^T and ds^T
    // from shared memory
    bar_arrive(2, 256);  // the fragments' buffers start free
    walks([&](auto kind, int it) {
      constexpr int K = decltype(kind)::value;
      const int st = it % S;
      bar_sync(1, 256);  // the fragments of this tile are in
      mbar_wait(full(st), (it / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr ((K & 1) != 0)
          wgmma_ss<1>(acc_v, desc(sp + kk * 256, 128, BQ * 16, 0),
                      mn_desc(dost(st), BQ, c0, kk), 1);
        if constexpr ((K & 2) != 0) {
          wgmma_ss<1>(acc_k,
                      desc(sp + P::kFragBytes + kk * 256, 128, BQ * 16, 0),
                      mn_desc(qst(st), BQ, c0, kk), 1);
          if constexpr (P::kDense)
            wgmma_ss<1>(
                acc_k, desc(sp + 2 * P::kFragBytes + kk * 256, 128, BQ * 16, 0),
                mn_desc(qst(st), BQ, c0, kk), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      if (lane == 0) mbar_arrive(empty(st));
      if (it + 1 < n_iter) bar_arrive(2, 256);
    });
  } else {
    float s[BQ / 2], dp[BQ / 2];
    unsigned fw[BQ / 16][4], fh[BQ / 16][4], fl[BQ / 16][4];
    walks([&](auto kind, int it) {
      constexpr int K = decltype(kind)::value;
      const int st = it % S, i0 = (it % nq) * BQ;
      mbar_wait(full(st), (it / S) & 1);
      // S^T = k q^T (and dP^T = v do^T for dk)
      wgmma_fence();
      issue_abt<C, BK, BQ>(s, sk, 64 * rw, qst(st));
      if constexpr ((K & 2) != 0) issue_abt<C, BK, BQ>(dp, sv, 64 * rw, dost(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // w^T and ds^T, a query (column) at a time: its lse2 and delta
      const float* lse =
          reinterpret_cast<const float*>(smem_raw + (sstat - raw)) +
          st * 2 * BQ;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = acc_col(i, t);
        const bool valid = i0 + col < N;
        const float w = valid ? exp2f(s[i] * scale2 - lse[col]) : 0.f;
        if constexpr ((K & 2) != 0) {
          const float dpv = P::kDense ? rbf(dp[i]) : dp[i];
          dp[i] = valid ? w * (dpv - lse[BQ + col]) * scale : 0.f;
        }
        s[i] = w;
      }
      if constexpr ((K & 1) != 0) pack_frags<false, BQ>(s, fw, fw);
      if constexpr ((K & 2) != 0) pack_frags<P::kDense, BQ>(dp, fh, fl);
      if constexpr (P::kSplit) {  // to the second warpgroup
        bar_sync(2, 256);
        if constexpr ((K & 1) != 0) store_frags<BQ>(pbuf, fw, warp, g, t);
        if constexpr ((K & 2) != 0) {
          store_frags<BQ>(pbuf + P::kFragBytes / 4, fh, warp, g, t);
          if constexpr (P::kDense)
            store_frags<BQ>(pbuf + P::kFragBytes / 2, fl, warp, g, t);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(1, 256);
      }
      // dv += w^T do, dk += ds^T q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr ((K & 1) != 0)
          wgmma_rs<1>(acc_v, fw[kk], mn_desc(dost(st), BQ, c0, kk));
        if constexpr ((K & 2) != 0) {
          wgmma_rs<1>(acc_k, fh[kk], mn_desc(qst(st), BQ, c0, kk));
          if constexpr (P::kDense)
            wgmma_rs<1>(acc_k, fl[kk], mn_desc(qst(st), BQ, c0, kk));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(fw);
      fence_regs(fh);
      fence_regs(fl);
      if (lane == 0) mbar_arrive(empty(st));
    });
  }
}

// ------------------------------------------------------------ the host

inline int n_pad_of(int N) {
  return (N + kStatAlign - 1) / kStatAlign * kStatAlign;
}

// Both launches for one plan pair; `plan` = (rows BQ, rows shared bytes,
// cols BK, cols shared bytes, the scratch's rows) from
// flash_bwd_launch_plan, checked against the kernels' own. stats: f32
// [B][2][n_pad_of(N)] scratch.
template <class R, class K>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int B, int N,
           const int (&plan)[5], cudaStream_t stream) {
  static_assert(R::C == K::C && R::kDense == K::kDense, "one C, one contract");
  if (plan[0] != R::BQ || plan[1] != R::kSmem || plan[2] != K::BK ||
      plan[3] != K::kSmem || plan[4] != n_pad_of(N))
    return (int)cudaErrorInvalidValue;
  constexpr int C = R::C;
  // boxes of 64 rows (the resident tiles), R::BK (rows' k / v) and K::BQ
  // (cols' q / do)
  CUtensorMap q64, k64, v64, do64, kr, vr, qc, doc;
  if (!tensor_map(&q64, q, B, N, C, 64) || !tensor_map(&k64, k, B, N, C, 64) ||
      !tensor_map(&v64, v, B, N, C, 64) ||
      !tensor_map(&do64, dout, B, N, C, 64))
    return (int)cudaErrorInvalidValue;
  kr = k64, vr = v64, qc = q64, doc = do64;
  if (R::BK != 64 && (!tensor_map(&kr, k, B, N, C, R::BK) ||
                      !tensor_map(&vr, v, B, N, C, R::BK)))
    return (int)cudaErrorInvalidValue;
  if (K::BQ != 64 && (!tensor_map(&qc, q, B, N, C, K::BQ) ||
                      !tensor_map(&doc, dout, B, N, C, K::BQ)))
    return (int)cudaErrorInvalidValue;
  auto rows = rows_kernel<R>;
  auto cols = cols_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        cols, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_pad = n_pad_of(N);
  const float scale = 1.0f / sqrtf((float)C);
  const float scale2 = 1.4426950408889634f * scale;
  rows<<<dim3((N + R::BQ - 1) / R::BQ, B), R::kThreads, R::kSmem, stream>>>(
      q64, kr, vr, do64, static_cast<bf16*>(dq), stats, N, n_pad, scale2,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols<<<dim3((N + K::BK - 1) / K::BK, B), K::kThreads, K::kSmem, stream>>>(
      qc, k64, v64, doc, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      N, n_pad, scale2, scale);
  return (int)cudaGetLastError();
}

// The plans flash_bwd_launch_plan (ops/cuda/flash_attention.py) picks, per
// C: C = 64 / 128 one or two warpgroups (two while the grid of 128-row
// blocks has at least as many blocks as SMs), BK = BQ = 64 and three
// stages; C = 256 two warpgroups splitting 64 rows, 64-row tiles, two
// stages; C = 512 the same with 32-row tiles and one stage.
template <bool kDense>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, float* stats, int B, int N, int C,
             const int (&plan)[5], cudaStream_t stream) {
  const bool two = plan[0] == 128;
#define K3B_LAUNCH(C_, WG, T, S)                                             \
  launch<RowsPlan<C_, WG, T, S, kDense>, ColsPlan<C_, WG, T, S, kDense>>(    \
      q, k, v, dout, dq, dk, dv, stats, B, N, plan, stream)
  switch (C) {
    case 64:
      return two ? K3B_LAUNCH(64, 2, 64, 3) : K3B_LAUNCH(64, 1, 64, 3);
    case 128:
      return two ? K3B_LAUNCH(128, 2, 64, 3) : K3B_LAUNCH(128, 1, 64, 3);
    case 256:
      return K3B_LAUNCH(256, 2, 64, 2);
    case 512:
      return K3B_LAUNCH(512, 2, 32, 1);
  }
#undef K3B_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_bwd
