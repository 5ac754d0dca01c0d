// bf16 flash-attention forwards on Hopper: the block bodies of K3a (the
// two-pass primary, flash_attention.cu) and K3c (the online forward,
// flash_attention_online.cu). Their building blocks (wgmma, descriptors,
// mbarriers, TMA, tensor maps) are in wgmma_common.cuh, which the backward
// K3b shares.
//
// What bounds them: at the model's shapes (N = 1024 to 16384, C = 64 to
// 512) the products, q k^T and PV, 2 N^2 C FLOPs each per batch element
// (K3a computes q k^T twice), against 4 N C elements of memory. So the
// design feeds Hopper's warpgroup products (wgmma m64nNk16, bf16 in, f32
// accumulate) from shared memory that TMA fills asynchronously:
//
// - A block owns BQ query rows and holds their q tile [BQ, C] in shared
//   memory for its whole life; the output accumulator covers all C, so
//   the logits are computed once per pass (K3a: a statistics pass and an
//   output pass; K3c: one pass), never once per channel slice.
// - One producer warp keeps TMA loads of [BK, C] k and v tiles in flight
//   through two rings of kStages stages with full/empty mbarriers; the
//   consumers release a k stage as soon as q k^T has read it, so the next
//   tiles load under the softmax and PV.
// - Consumer warpgroups of 64 query rows each (BQ = 64 or 128): S = q k^T
//   with A and B from shared memory; the softmax in registers, where a row
//   lives in the four lanes of a quad; PV with A (p or w, rounded to bf16)
//   straight from the S accumulators, whose layout is wgmma's A fragment,
//   and B the v tile (MN-major, transposed by the descriptor). In the
//   output pass q k^T of tile j is issued ahead of PV of tile j - 1, so
//   the softmax of tile j runs while that PV is on the tensor cores.
// - C = 512: [64, 512] f32 does not fit one warpgroup's registers, so two
//   warpgroups share the 64 rows and split O's channels (256 each). The
//   first computes S and the softmax, writes the rounded [64, BK] p or w
//   (and the rescale factors) to shared memory once, and runs PV from
//   registers; the second runs PV with A from shared memory. q k^T is
//   computed once.
// - Tiles are 64 channels wide (128 bytes, TMA's 128-byte swizzle, which
//   the wgmma descriptors read); C = 64 is one native tile, no padding.
// - Rows of k and v beyond N arrive as zeros from TMA and their logits are
//   masked to -inf; query rows beyond N are computed and not stored.
//
// The softmax runs in base 2: s2 = (q k^T) C^-1/2 log2(e), so
// exp2(s2 - m2) = exp(s - m) of the contracts.
#pragma once

#include "wgmma_common.cuh"

namespace flash_wgmma {

constexpr int kSMs = 132;  // H100 SXM

// ------------------------------------------------------------ the plan

// One launch shape: C, consumer warpgroups, the k/v tile BK and the ring's
// stages, and whether the block makes K3a's two passes (else K3c's one).
// At C = 512 the two warpgroups share 64 rows and split O's channels.
template <int C_, int kWG_, int BK_, int kStages_, bool kTwoPass_>
struct Plan {
  static constexpr int C = C_, kWG = kWG_, BK = BK_, kStages = kStages_;
  static constexpr bool kTwoPass = kTwoPass_;
  static constexpr bool kSplit = C == 512;
  static constexpr int kCW = kSplit ? C / 2 : C;  // O's channels a warpgroup
  static constexpr int BQ = kSplit ? 64 : 64 * kWG;
  static constexpr int kPanels = C / 64;          // 64-channel tiles
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = BQ * C * 2;
  static constexpr int kKVBytes = BK * C * 2;     // one k or v stage
  static constexpr int kPBytes = kSplit ? 64 * BK * 2 : 0;
  static constexpr int kStatBytes = kSplit ? 2 * 64 * 4 : 0;
  static constexpr int kBarBytes = 128;           // 4 kStages + 1 mbarriers
  // 1024 bytes of slack align the tiles to the swizzle's 1024-byte atoms
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes +
                               kPBytes + kStatBytes + kBarBytes;
  static_assert(!kSplit || kWG == 2, "C = 512 takes two warpgroups");
  static_assert(4 * kStages + 1 <= kBarBytes / 8, "barrier space");
  static_assert(kSmem <= 232448, "shared memory");
};

// ------------------------------------------------------------ the kernel

// Output rows of [B, N, C] for this block: blockIdx.x * BQ; batch
// blockIdx.y. scale2 = C^-1/2 log2(e).
template <class P>
__global__ void __launch_bounds__(P::kThreads, 1)
    forward_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, int N, float scale2) {
  constexpr int C = P::C, BK = P::BK, S = P::kStages, BQ = P::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;       // q [panel][BQ][64]
  const uint32_t sk = sq + P::kQBytes;              // k ring
  const uint32_t sv = sk + S * P::kKVBytes;         // v ring
  const uint32_t sp = sv + S * P::kKVBytes;         // C = 512: p or w
  const uint32_t sstat = sp + P::kPBytes;           // C = 512: corr, l
  const uint32_t sbar = sstat + P::kStatBytes;
  float* stat = reinterpret_cast<float*>(smem_raw + (sstat - raw));
  unsigned* pbuf = reinterpret_cast<unsigned*>(smem_raw + (sp - raw));
  // mbarriers: k full / empty, v full / empty per stage, then q
  const auto kfull = [&](int s) { return sbar + 8 * s; };
  const auto kempty = [&](int s) { return sbar + 8 * (S + s); };
  const auto vfull = [&](int s) { return sbar + 8 * (2 * S + s); };
  const auto vempty = [&](int s) { return sbar + 8 * (3 * S + s); };
  const uint32_t qfull = sbar + 8 * 4 * S;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int nk = (N + BK - 1) / BK;
  const int n_iter = P::kTwoPass ? 2 * nk : nk;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(kempty(s), 4 * (P::kSplit ? 1 : P::kWG));  // one per warp
      mbar_init(vfull(s), 1);
      mbar_init(vempty(s), 4 * P::kWG);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == P::kWG) {
    // ------------------------------------------------ producer warpgroup
    if (P::kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(qfull, P::kQBytes);
    for (int r = 0; r < BQ / 64; ++r)
      for (int p = 0; p < P::kPanels; ++p)
        tma_load(sq + p * BQ * 128 + r * 8192, &tq, qfull, 64 * p,
                 q0 + 64 * r, b);
    int j = 0;  // v tiles issued
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % S, key0 = (it % nk) * BK;
      if (it >= S) mbar_wait(kempty(s), (it / S - 1) & 1);
      mbar_expect_tx(kfull(s), P::kKVBytes);
      for (int p = 0; p < P::kPanels; ++p)
        tma_load(sk + s * P::kKVBytes + p * BK * 128, &tk, kfull(s), 64 * p,
                 key0, b);
      if (P::kTwoPass && it < nk) continue;  // K3a's statistics pass
      const int sv_ = j % S;
      if (j >= S) mbar_wait(vempty(sv_), (j / S - 1) & 1);
      mbar_expect_tx(vfull(sv_), P::kKVBytes);
      for (int p = 0; p < P::kPanels; ++p)
        tma_load(sv + sv_ * P::kKVBytes + p * BK * 128, &tv, vfull(sv_),
                 64 * p, key0, b);
      ++j;
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  if (P::kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this warpgroup's rows (from 64 * rw) and output channels (from c0)
  const int rw = P::kSplit ? 0 : wg, c0 = P::kSplit ? wg * P::kCW : 0;
  const bool computes_s = !P::kSplit || wg == 0;
  float o[P::kCW / 2];
#pragma unroll
  for (int i = 0; i < P::kCW / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  unsigned pa[BK / 16][4];  // p or w as PV's A fragments, 16 keys each
  mbar_wait(qfull, 0);

  if (!computes_s) {
    // C = 512, the second warpgroup: PV on its 256 channels with p from
    // shared memory, once the first has handed it over
    bar_arrive(2, 256);  // p's buffer starts free
    for (int j = 0; j < nk; ++j) {
      bar_sync(1, 256);  // p and the factors of tile j are in
      if (!P::kTwoPass) {
        const float corr[2] = {stat[16 * warp + g], stat[16 * warp + g + 8]};
#pragma unroll
        for (int i = 0; i < P::kCW / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      const int sv_ = j % S;
      mbar_wait(vfull(sv_), (j / S) & 1);
      const uint32_t vbase = sv + sv_ * P::kKVBytes + (c0 / 64) * BK * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<1>(o, desc(sp + kk * 256, 128, BK * 16, 0),
                    desc(vbase + kk * 16 * 128, BK * 128, 1024, 1), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(vempty(sv_));
      if (j + 1 < nk) bar_arrive(2, 256);
    }
  } else {
    // S = q k^T for iteration it's k tile, issued and committed
    const auto issue_s = [&](int it) {
      const int st = it % S;
      mbar_wait(kfull(st), (it / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        wgmma_ss<0>(s,
                    desc(sq + (kk / 4) * BQ * 128 + rw * 8192 + (kk % 4) * 32,
                         16, 1024, 1),
                    desc(sk + st * P::kKVBytes + (kk / 4) * BK * 128 +
                             (kk % 4) * 32,
                         16, 1024, 1),
                    kk > 0);
      wgmma_commit();
    };
    // O += p v for v tile j, from pa, issued and committed
    const auto issue_pv = [&](int j) {
      const int sv_ = j % S;
      mbar_wait(vfull(sv_), (j / S) & 1);
      const uint32_t vbase = sv + sv_ * P::kKVBytes + (c0 / 64) * BK * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1>(o, pa[kk], desc(vbase + kk * 16 * 128, BK * 128, 1024, 1));
      wgmma_commit();
    };
    // once S of iteration it is done: free its k stage, then the softmax.
    // kStats: fold the tile into the running max and sum (K3a's pass 1);
    // else K3c's p = exp2(s2 - m2') with corr, or K3a's w = p / l, into s
    // and pa (and to the other warpgroup at C = 512)
    const auto softmax = [&](int it, bool stats_only, float (&corr)[2]) {
      fence_regs(s);
      if (lane == 0) mbar_arrive(kempty(it % S));
      const int key0 = (it % nk) * BK;
      // accumulator i: row g + 8 ((i >> 1) & 1), key (i / 4) * 8 + 2t + i % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = key0 + (i / 4) * 8 + 2 * t + (i & 1);
        s[i] = key < N ? s[i] * scale2 : -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      const bool normalised = P::kTwoPass && !stats_only;
      float add[2];  // the exponent's offset per row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        corr[h] = 1.f;
        if (normalised) {
          add[h] = m[h];
          continue;
        }
        // key key0 is valid, so the new max is finite; the first tile's
        // corr is exp2(-inf) = 0
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        add[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        const float e = exp2f(s[i] - add[h]);
        sum[h] += e;
        s[i] = normalised ? e * inv_l[h] : e;
      }
      if (!normalised) {
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(sum[h]);
      }
    };
    // s's p or w as A fragments into pa; at C = 512 also to the other
    // warpgroup through shared memory (no-swizzle K-major core matrices of
    // 8 rows x 8 keys), with the rescale factors and l
    const auto hand_p = [&](const float (&corr)[2]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      if (!P::kSplit) return;
      bar_sync(2, 256);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * warp + g + 8 * (r & 1);
          const int key = 16 * kk + 8 * (r >> 1) + 2 * t;
          pbuf[((row / 8) * BK * 16 + (key / 8) * 128 + (row % 8) * 16 +
                (key % 8) * 2) / 4] = pa[kk][r];
        }
      if (!P::kTwoPass && t == 0) {  // l for the end of the last tile
        stat[16 * warp + g] = corr[0];
        stat[16 * warp + g + 8] = corr[1];
        stat[64 + 16 * warp + g] = l[0];
        stat[64 + 16 * warp + g + 8] = l[1];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(1, 256);
    };
    const auto rescale = [&](const float (&corr)[2]) {
      if (P::kTwoPass) return;
#pragma unroll
      for (int i = 0; i < P::kCW / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    };

    float corr[2];
    if (P::kTwoPass) {  // pass 1: each row's max and sum over all keys
      for (int it = 0; it < nk; ++it) {
        issue_s(it);
        wgmma_wait<0>();
        softmax(it, true, corr);
      }
      inv_l[0] = 1.f / l[0];
      inv_l[1] = 1.f / l[1];
    }
    // the output pass: q k^T of tile j is issued ahead of PV of tile j - 1,
    // so the softmax of tile j runs while that PV is on the tensor cores
    const int it0 = P::kTwoPass ? nk : 0;
    issue_s(it0);
    wgmma_wait<0>();
    softmax(it0, false, corr);
    hand_p(corr);  // O is zero: no rescale
    for (int j = 1; j < nk; ++j) {
      issue_s(it0 + j);
      issue_pv(j - 1);
      wgmma_wait<1>();  // S of tile j; PV of tile j - 1 may still run
      softmax(it0 + j, false, corr);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(vempty((j - 1) % S));
      rescale(corr);
      hand_p(corr);
    }
    issue_pv(nk - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(vempty((nk - 1) % S));
  }

  float div[2] = {1.f, 1.f};
  if (!P::kTwoPass) {
    if (!computes_s) {  // the first warpgroup's l, handed with the last p
      l[0] = stat[64 + 16 * warp + g];
      l[1] = stat[64 + 16 * warp + g + 8];
    }
    div[0] = 1.f / l[0];
    div[1] = 1.f / l[1];
  }
  bf16* ob = out + (size_t)b * N * C;
#pragma unroll
  for (int i = 0; i < P::kCW / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = q0 + 64 * rw + 16 * warp + g + 8 * h;
    if (row < N)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + (size_t)row * C + c0 + (i / 4) * 8 + 2 * t) =
          __floats2bfloat162_rn(o[i] * div[h], o[i + 1] * div[h]);
  }
}


template <class P>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int smem, cudaStream_t stream) {
  if (smem != P::kSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, N, P::C, 64) ||
      !tensor_map(&tk, k, B, N, P::C, P::BK) ||
      !tensor_map(&tv, v, B, N, P::C, P::BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = forward_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + P::BQ - 1) / P::BQ, B);
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), N,
      1.4426950408889634f / sqrtf((float)P::C));
  return (int)cudaGetLastError();
}

// The plans flash_launch_plan (ops/cuda/flash_attention.py) picks: per C
// the tile BK and the stages; BQ = 128 (two warpgroups) while the grid
// has at least as many blocks as SMs, else 64 (one); C = 512 always 64
// rows on two warpgroups.
template <bool kTwoPass>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int N, int C, int bq, int smem, cudaStream_t stream) {
  const bool two = bq == 128;
  if (bq != 64 && bq != 128) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 64:
      return two ? launch<Plan<64, 2, 128, 3, kTwoPass>>(q, k, v, out, B, N,
                                                         smem, stream)
                 : launch<Plan<64, 1, 128, 3, kTwoPass>>(q, k, v, out, B, N,
                                                         smem, stream);
    case 128:
      return two ? launch<Plan<128, 2, 128, 2, kTwoPass>>(q, k, v, out, B, N,
                                                          smem, stream)
                 : launch<Plan<128, 1, 128, 2, kTwoPass>>(q, k, v, out, B, N,
                                                          smem, stream);
    case 256:
      return two ? launch<Plan<256, 2, 64, 2, kTwoPass>>(q, k, v, out, B, N,
                                                         smem, stream)
                 : launch<Plan<256, 1, 64, 2, kTwoPass>>(q, k, v, out, B, N,
                                                         smem, stream);
    case 512:
      if (two) return (int)cudaErrorInvalidValue;
      return launch<Plan<512, 2, 32, 2, kTwoPass>>(q, k, v, out, B, N, smem,
                                                   stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_wgmma
