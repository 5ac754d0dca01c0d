// The chainless int8 conv on Hopper: int8 x int8 -> int32 3x3 convolution
// (padding 1, stride 1 or 2) as an implicit GEMM on the warpgroup tensor
// cores, with the tier's dequant epilogue. Replaces the XLA int8 conv of
// infodiffusion_tpu/ops/quant.py (int8_conv); qconv.cu binds it.
//
// The GEMM: M = output pixels, N = Cout, K = 9 taps x Cin. What bounds it:
// at the flagship's large sites (64x64, Cin 128 -> 128, B = 128) 2 x 9 x
// Cin operations per input byte put it at the int8 ridge, so only wgmma
// (m64nNk32, s8 in, s32 accumulate) reaches the rate; the small and
// stride-2 sites are launch-bound. The design (int8_conv_launch_plan in
// ops/cuda/qconv.py is the same arithmetic, and the entry refuses a plan
// that is not its own):
//
// - A persistent block walks output tiles of BM = 128 pixels: a run of
//   whole output rows of one image, or at small images (Ho x Wo <= 128)
//   `ipt` whole images, so no warpgroup idles at 8x8. Two consumer
//   warpgroups own 64 pixels each; N (Cout up to 256, padded to 64 / 128
//   / 256) is whole in each, so each input window is read once for all of
//   Cout. Cout > 256 splits into 256-wide tiles.
// - The input window (the tile plus a one-pixel halo, zeros outside the
//   image) lives in shared memory as rows of Cin + 16 bytes (ldmatrix's
//   eight rows land on distinct banks). Three producer warps copy it with
//   cp.async, zero-filling the halo, and arrive on a full barrier when it
//   has landed; the window is double-buffered, so tile i + 1's window
//   loads while tile i computes.
// - A from registers: ldmatrix from the window, each lane giving its own
//   pixel's row address, so the tap shift (dh, dw), the stride and tiles
//   that span image rows or images are plain address arithmetic. The next
//   stage's fragments load while the current stage's products run.
// - B: the weights, laid out by the wrapper as the no-swizzle K-major core
//   matrices wgmma reads ([9 taps][Cin / KP panels][N / 8][KP / 16][8][16]
//   s8 per N tile), one stage per (tap, panel) fetched by a TMA bulk copy
//   from one producer lane. Where all 9 x Cin / KP stages fit beside the
//   two windows (every flagship site but two) they are loaded once and
//   stay resident; else they stream through a ring of full/empty
//   mbarriers one stage ahead of the consumers.
// - Epilogue from the accumulators: s32 out, or f32(acc) [+ bf16 partial]
//   [* scale + bias] to f32 / bf16, each operation rounded once; lanes
//   pair up (one shuffle) so each stores four consecutive channels.
//
// The consumer warpgroups (consumer_role) and the walk over a block's
// tiles (Walker) are shared with K7 (qconv_wgmma.cuh), whose producers
// fill the window with the chain instead of copying it. A walk is a run of consecutive row tiles of one
// image column strip that one block takes in order; here every walk is one
// tile (the plan's segs = row_tiles, rps = 1), so the order is the tile
// order above, and the window is the two buffers of win_bytes (ring = 0).
#pragma once

#include <algorithm>

#include "wgmma_common.cuh"

namespace int8_wgmma {
// internal linkage: a process may load two builds of the library
namespace {

using flash_wgmma::bf16;

constexpr int BM = 128;            // output pixels a tile
constexpr int kThreads = 384;      // two consumer warpgroups, one producer
constexpr int kLoaders = 96;       // producer threads copying windows
constexpr int kRowPad = 16;        // bytes of padding per window row
constexpr int kSMs = 132;          // H100 SXM
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 36;    // weight stages the barriers allow
constexpr int kBarBytes = 640;     // mbarriers (2 x 36 ring + 4 window)
constexpr int kAlign = 128;        // slack to align the dynamic base

enum OutCode : int { kOutF32 = 0, kOutBF16 = 1, kOutS32 = 2 };

// One launch: the tile (ipt images of th x tw output pixels), N tile n and
// its split, the K panel kp, the window and weight-stage bytes, the ring's
// stages (all of them when the weights are resident), shared bytes, tiles
// and blocks. make_plan is int8_conv_launch_plan's arithmetic.
struct Plan {
  int kp, n, nsplit, ipt, th, tw, win_rows, win_cols, win_bytes, w_stage,
      n_stages, stages, resident, smem, groups, row_tiles, col_tiles, tiles,
      blocks;
  // the walks: segs row segments of rps row tiles per image column strip,
  // walks in all; ring: window row slots (K7), 0 for the two buffers of
  // win_bytes; raw_rows / raw_row_bytes: K7 v2's staging ring of raw rows
  int segs, rps, walks, ring, raw_rows, raw_row_bytes;
  // N tiles a tile's consumers run one after another from its window
  // (here 1: the N split is a tile's; K7 runs all of Cout so)
  int npass;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool make_plan(int B, int H, int W, int Cin, int Cout, int stride,
                      Plan& p) {
  if (B < 1 || H < 1 || W < 1 || Cout < 1 || (stride != 1 && stride != 2))
    return false;
  if (!(Cin == 32 || Cin == 64 || (Cin >= 128 && Cin % 128 == 0)))
    return false;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int rs = Cin + kRowPad;
  p.kp = Cin < 128 ? Cin : 128;
  p.n = Cout <= 64 ? 64 : Cout <= 128 ? 128 : 256;
  p.nsplit = cdiv(Cout, p.n);
  if (Ho * Wo <= BM) {
    p.th = Ho;
    p.tw = Wo;
    p.ipt = std::min(B, BM / (Ho * Wo));
  } else {
    p.tw = std::min(Wo, BM);
    p.th = BM / p.tw;
    p.ipt = 1;
  }
  p.w_stage = p.n * p.kp;
  p.n_stages = 9 * (Cin / p.kp);
  for (;;) {
    p.win_rows = (p.th - 1) * stride + 3;
    p.win_cols = (p.tw - 1) * stride + 3;
    p.win_bytes = cdiv(p.ipt * p.win_rows * p.win_cols * rs, 128) * 128;
    const int fixed = kAlign + 2 * p.win_bytes + kBarBytes;
    p.resident = p.nsplit == 1 && p.n_stages <= kMaxStages &&
                 fixed + p.n_stages * p.w_stage <= kSmemLimit;
    p.stages = p.resident ? p.n_stages : 0;
    for (int s = 4; !p.resident && s >= 2; --s)
      if (fixed + s * p.w_stage <= kSmemLimit) {
        p.stages = s;
        break;
      }
    if (p.stages > 0) {
      p.smem = fixed + p.stages * p.w_stage;
      break;
    }
    if (p.ipt > 1)
      p.ipt = cdiv(p.ipt, 2);
    else if (p.th > 1)
      p.th = cdiv(p.th, 2);
    else if (p.tw > 8)
      p.tw = cdiv(p.tw, 2);
    else
      return false;
  }
  p.groups = cdiv(B, p.ipt);
  p.row_tiles = cdiv(Ho, p.th);
  p.col_tiles = cdiv(Wo, p.tw);
  const long long tiles =
      (long long)p.nsplit * p.groups * p.row_tiles * p.col_tiles;
  if (tiles > (1LL << 30)) return false;
  p.tiles = (int)tiles;
  p.blocks = std::min(p.tiles, kSMs);
  p.segs = p.row_tiles;  // a walk is one tile
  p.rps = 1;
  p.walks = p.tiles;
  p.ring = p.raw_rows = p.raw_row_bytes = 0;
  p.npass = 1;
  return true;
}

struct Args {
  const int8_t* x;       // [B, H, W, Cin]
  const int8_t* w;       // [nsplit][n_stages][N/8][KP/16][8][16]
  const float* scale;    // [Cout] or null
  const float* bias;     // [Cout] or null (given with scale)
  const bf16* partial;   // [B, Ho, Wo, Cout] or null
  void* out;             // [B, Ho, Wo, Cout]
  int out_code;
  int B, H, W, Cin, Cout, Ho, Wo, stride;
  Plan p;
  // K7's chain (qconv_wgmma.cuh): pieces [B, H, W, C0] and [B, H, W, C1]
  // (C1 = 0: one piece), Ctot = C0 + C1 <= Cin; rows A, Bv [B, Ctot] f32;
  // the pieces' act scales s_act [n]
  const void* x0;
  const void* x1;
  int C0, C1, ctot;
  const float* A;
  const float* Bv;
  const float* s_act;
};

// the epilogue of four consecutive channels n .. n + 3 (n % 4 == 0, n <
// Cout) of the output element at `row` (its flat NHWC pixel times Cout):
// 16-byte (s32, f32) or 8-byte (bf16) stores where Cout % 4 == 0, else
// one channel at a time up to Cout
__device__ __forceinline__ void store4(const Args& a, size_t row, int n,
                                       const int (&v)[4]) {
  const size_t o = row + n;
  if ((a.Cout & 3) == 0) {
    if (a.out_code == kOutS32) {
      *reinterpret_cast<int4*>(static_cast<int*>(a.out) + o) =
          make_int4(v[0], v[1], v[2], v[3]);
      return;
    }
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __int2float_rn(v[e]);
    if (a.partial) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(a.partial + o));
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      f[0] = __fadd_rn(lo.x, f[0]);
      f[1] = __fadd_rn(lo.y, f[1]);
      f[2] = __fadd_rn(hi.x, f[2]);
      f[3] = __fadd_rn(hi.y, f[3]);
    }
    if (a.scale) {
      // read-only loads: the output's stores do not order them
      const float4 sc = __ldg(reinterpret_cast<const float4*>(a.scale + n));
      const float4 bi = __ldg(reinterpret_cast<const float4*>(a.bias + n));
      f[0] = __fadd_rn(__fmul_rn(f[0], sc.x), bi.x);
      f[1] = __fadd_rn(__fmul_rn(f[1], sc.y), bi.y);
      f[2] = __fadd_rn(__fmul_rn(f[2], sc.z), bi.z);
      f[3] = __fadd_rn(__fmul_rn(f[3], sc.w), bi.w);
    }
    if (a.out_code == kOutBF16) {
      uint2 u;
      u.x = flash_wgmma::pack(f[0], f[1]);
      u.y = flash_wgmma::pack(f[2], f[3]);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + o) = u;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (n + e >= a.Cout) break;
    if (a.out_code == kOutS32) {
      static_cast<int*>(a.out)[o + e] = v[e];
      continue;
    }
    float f = __int2float_rn(v[e]);
    if (a.partial) f = __fadd_rn(__bfloat162float(a.partial[o + e]), f);
    if (a.scale) f = __fadd_rn(__fmul_rn(f, a.scale[n + e]), a.bias[n + e]);
    if (a.out_code == kOutBF16)
      static_cast<bf16*>(a.out)[o + e] = __float2bfloat16(f);
    else
      static_cast<float*>(a.out)[o + e] = f;
  }
}

// where a tile starts: N split, first image, output row and column
struct Tile {
  int ns, b0, oh0, ow0;
};

// A block's tiles in order: walks blockIdx.x, + gridDim.x, ...; a walk is
// the row tiles [rt, rt_end) of one (N split, image group, column strip).
// `it` counts the block's tiles, `first` marks a walk's first tile, and
// `base` is the window ring's slot of the tile's window row 0: the next
// tile of a walk reuses the last two rows (stride 1), so it starts
// ipt * win_rows - 2 slots on, a new walk ipt * win_rows on.
struct Walker {
  Tile t;
  int it, walk, rt, rt_end, base;
  bool first;

  __device__ explicit Walker(const Plan& p)
      : it(0), walk(blockIdx.x), base(0) {
    enter(p);
  }
  __device__ bool valid(const Plan& p) const { return walk < p.walks; }
  __device__ void enter(const Plan& p) {
    first = true;
    if (walk >= p.walks) return;
    int w = walk;
    t.ow0 = (w % p.col_tiles) * p.tw;
    w /= p.col_tiles;
    const int seg = w % p.segs;
    w /= p.segs;
    t.b0 = (w % p.groups) * p.ipt;
    t.ns = w / p.groups;
    rt = seg * p.rps;
    rt_end = min(p.row_tiles, rt + p.rps);
    t.oh0 = rt * p.th;
  }
  __device__ void next(const Plan& p) {
    const int wr = p.ipt * p.win_rows;
    int adv = wr;
    ++it;
    if (++rt < rt_end) {
      t.oh0 = rt * p.th;
      first = false;
      adv = wr - 2;
    } else {
      walk += gridDim.x;
      enter(p);
    }
    if (p.ring) {
      base += adv;
      if (base >= p.ring) base -= p.ring;
    }
  }
};

// pixel m of a tile: image, output row and column in the tile; false
// where m lies past the tile or the output
__device__ __forceinline__ bool pixel_at(const Args& a, const Tile& t, int m,
                                         int& img, int& ohl, int& owl) {
  const Plan& p = a.p;
  const int per = p.th * p.tw;
  img = m / per;
  ohl = (m % per) / p.tw;
  owl = m % p.tw;
  return m < p.ipt * per && t.b0 + img < a.B && t.oh0 + ohl < a.Ho &&
         t.ow0 + owl < a.Wo;
}

// the shared-memory address of K7's window row r (image img's row r %
// win_rows) of the walker's tile: ring slot base + r
__device__ __forceinline__ uint32_t ring_row(const Plan& p, uint32_t swin,
                                             const Walker& w, int r,
                                             int row_bytes) {
  int s = w.base + r;
  if (s >= p.ring) s -= p.ring;
  return swin + s * row_bytes;
}

// the mbarriers: weight ring full / empty (ms weight stages at most),
// window full / empty (by tile parity), and K7 v2's raw rows landed
constexpr int kMaxRaw = 64;
struct Bars {
  uint32_t base;
  int ms;
  __device__ uint32_t wfull(int s) const { return base + 8 * s; }
  __device__ uint32_t wempty(int s) const { return base + 8 * (ms + s); }
  __device__ uint32_t winfull(int b) const {
    return base + 8 * (2 * ms + b);
  }
  __device__ uint32_t winempty(int b) const {
    return base + 8 * (2 * ms + 2 + b);
  }
  __device__ uint32_t rawfull(int k) const {
    return base + 8 * (2 * ms + 4 + k);
  }
  // by one thread: the weight ring's and the windows' barriers, `fillers`
  // arrivals filling a window
  __device__ void init(const Plan& p, int fillers) const {
    using namespace flash_wgmma;
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), 8);  // one per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(winfull(b), fillers);
      mbar_init(winempty(b), 8);
    }
  }
};

// the weight stages, by one lane: once where they stay resident, else
// n_stages a tile through the ring, one stage ahead of the consumers
__device__ __forceinline__ void weight_lane(const Args& a, uint32_t sw,
                                            const Bars& bars) {
  using namespace flash_wgmma;
  const Plan& p = a.p;
  int g = 0;  // stages issued
  for (Walker w(p); w.valid(p); w.next(p)) {
    for (int j = 0; j < p.n_stages; ++j, ++g) {
      const int s = g % p.stages;
      if (!p.resident && g >= p.stages)
        mbar_wait(bars.wempty(s), (g / p.stages - 1) & 1);
      mbar_expect_tx(bars.wfull(s), p.w_stage);
      bulk_load(sw + s * p.w_stage,
                a.w + ((size_t)w.t.ns * p.n_stages + j) * p.w_stage,
                p.w_stage, bars.wfull(s));
    }
    if (p.resident) break;  // loaded once, for every tile
  }
}

// weight stages that a producer lane refills, not the consumers
struct NoRefill {
  __device__ void operator()(int, int) const {}
};

// Consumer warpgroup wg (0 or 1) over the block's tiles: wait for the
// tile's window; for each of its npass N tiles run the 9 x Cin / KP weight
// stages on wgmma with A from the window by ldmatrix, then the epilogue;
// release the window after the last pass's products. `refill(s, g)` runs
// after the warp has released ring slot s of the block's stage g (a
// consumer that refills the ring itself; reconverged after it). kRing: the
// window is K7's ring of rows, else the two buffers of win_bytes.
template <int NR, int KP, bool kRing, class Refill>
__device__ __forceinline__ void consumer_role(const Args& a, uint32_t swin,
                                              uint32_t sw, const Bars& bars,
                                              int wg, const Refill& refill) {
  using namespace flash_wgmma;
  constexpr int N = 2 * NR, KS = KP / 32;
  const Plan& p = a.p;
  const int rs = a.Cin + kRowPad, row_bytes = p.win_cols * rs;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this lane's ldmatrix row among the warp's 16, and its 16-byte half
  const int lrow = 64 * wg + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = (lane >> 4) * 16;
  int acc[NR];
  int gs = 0;  // weight stages consumed
  for (Walker w(p); w.valid(p); w.next(p)) {
    const Tile& t = w.t;
    const int buf = w.it & 1;
    int img, ohl, owl;
    const bool mine = pixel_at(a, t, lrow, img, ohl, owl);
    const int r0 = mine ? img * p.win_rows + ohl * a.stride : 0;
    const uint32_t col = (mine ? owl * a.stride * rs : 0) + khalf;
    // the lane's window row at each tap row dh (a ring's rows wrap; the
    // buffers' follow one another)
    const uint32_t ar0 =
        (kRing ? ring_row(p, swin, w, r0, row_bytes)
               : swin + buf * p.win_bytes + r0 * row_bytes) + col;
    const uint32_t ar1 = kRing ? ring_row(p, swin, w, r0 + 1, row_bytes) + col
                               : ar0 + row_bytes;
    const uint32_t ar2 = kRing ? ring_row(p, swin, w, r0 + 2, row_bytes) + col
                               : ar0 + 2 * row_bytes;
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0;
    mbar_wait(bars.winfull(buf), (w.it >> 1) & 1);
    const int panels = a.Cin / KP;
    // A fragments of stage j (tap, panel) from the window, by ldmatrix
    const auto load_a = [&](unsigned (&af)[KS][4], int j) {
      const int tap = j / panels, panel = j - tap * panels;
      const int dh = tap / 3, dw = tap - 3 * dh;
      const uint32_t at =
          (kRing ? (dh == 0 ? ar0 : dh == 1 ? ar1 : ar2) : ar0 + dh * row_bytes)
          + dw * rs + panel * KP;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(af[kk], at + kk * 32);
    };
    for (int pass = 0; pass < p.npass; ++pass) {
      const int ns = t.ns + pass;
      // stage j's products from af, issued and committed; returns its
      // ring slot
      const auto issue = [&](int j, unsigned (&af)[KS][4]) {
        const int g = gs + j;
        const int s = p.resident ? pass * p.n_stages + j : g % p.stages;
        mbar_wait(bars.wfull(s), p.resident ? 0 : (g / p.stages) & 1);
        const uint32_t wb = sw + s * p.w_stage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_s8_rs(acc, af[kk],
                      desc(wb + kk * 256, 128, KP * 8, kNoSwizzle), 1);
        wgmma_commit();
        return s;
      };
      const auto release = [&](int s, int g) {
        if (!p.resident && lane == 0) mbar_arrive(bars.wempty(s));
        refill(s, g);
      };
      // stages in pairs: j + 1's products queue behind j's, j + 2's
      // fragments load while j + 1's run, and no group is in flight
      // across the loop's back edge
      unsigned af0[KS][4], af1[KS][4];
      load_a(af0, 0);
      const int pairs = p.n_stages / 2;
      for (int q = 0; q < pairs; ++q) {
        const int j = 2 * q;
        const int s0 = issue(j, af0);
        load_a(af1, j + 1);
        const int s1 = issue(j + 1, af1);
        wgmma_wait<1>();  // stage j's products are done: af0 is free
        fence_regs(af0);
        release(s0, gs + j);
        if (j + 2 < p.n_stages) load_a(af0, j + 2);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(af1);
        release(s1, gs + j + 1);
      }
      if (p.n_stages & 1) {  // the last, odd stage
        const int s = issue(p.n_stages - 1, af0);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(af0);
        release(s, gs + p.n_stages - 1);
      }
      gs += p.n_stages;
      if (pass == p.npass - 1 && lane == 0)
        mbar_arrive(bars.winempty(buf));  // the window is read

      // accumulator i: row g + 8 ((i >> 1) & 1), channel (i / 4) * 8 + 2t
      // + i % 2. Lanes t, t ^ 1 swap halves so each holds four consecutive
      // channels: even t of tile j, odd t of tile j + 1.
      const bool odd = t4 & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * wg + 16 * warp + g + 8 * h;
        const bool valid = pixel_at(a, t, m, img, ohl, owl);
        const size_t row =
            valid ? ((((size_t)(t.b0 + img) * a.Ho + t.oh0 + ohl) * a.Wo +
                      t.ow0 + owl) *
                     a.Cout)
                  : 0;
#pragma unroll
        for (int j = 0; j < N / 8; j += 2) {
          const int l0 = acc[4 * j + 2 * h], l1 = acc[4 * j + 2 * h + 1];
          const int h0 = acc[4 * j + 4 + 2 * h], h1 = acc[4 * j + 5 + 2 * h];
          const int r0 = __shfl_xor_sync(0xffffffffu, odd ? l0 : h0, 1);
          const int r1 = __shfl_xor_sync(0xffffffffu, odd ? l1 : h1, 1);
          const int v[4] = {odd ? r0 : l0, odd ? r1 : l1, odd ? h0 : r0,
                            odd ? h1 : r1};
          const int n = ns * N + (odd ? 8 * (j + 1) + 2 * (t4 - 1)
                                      : 8 * j + 2 * t4);
          if (valid && n < a.Cout) store4(a, row, n, v);
        }
      }
      if (pass + 1 < p.npass) {
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = 0;
      }
    }
  }
}

// NR accumulator registers per thread: N = 2 NR output channels a tile;
// KP input channels a weight stage (KS = KP / 32 k steps)
template <int NR, int KP>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const __grid_constant__ Args a) {
  using namespace flash_wgmma;
  const Plan& p = a.p;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t swin = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t sw = swin + 2 * p.win_bytes;  // weight stages
  const Bars bars{sw + p.stages * p.w_stage, kMaxStages};
  const int rs = a.Cin + kRowPad;

  if (threadIdx.x == 0) {
    bars.init(p, kLoaders);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - 256;
    if (pt == 0) {  // the weight stages, by one lane
      weight_lane(a, sw, bars);
      return;
    }
    if (pt < 32) return;
    const int lt = pt - 32;  // window loader 0 .. 95
    // a window row (win_cols positions of one image row) is contiguous in
    // x where it lies inside the image: the loaders take consecutive
    // 16-byte chunks of it
    const int cpr = a.Cin / 16;  // chunks a position
    const bool pow2 = (cpr & (cpr - 1)) == 0;
    const int shift = __ffs(cpr) - 1;
    const int row_chunks = p.win_cols * cpr;
    for (Walker w(p); w.valid(p); w.next(p)) {
      const int buf = w.it & 1;
      if (w.it >= 2) mbar_wait(bars.winempty(buf), ((w.it - 2) >> 1) & 1);
      const Tile& t = w.t;
      const int ih0 = t.oh0 * a.stride - 1, iw0 = t.ow0 * a.stride - 1;
      uint32_t dst = swin + buf * p.win_bytes;  // the row's first position
      for (int img = 0; img < p.ipt; ++img) {
        const int b = t.b0 + img;
        for (int r = 0; r < p.win_rows; ++r, dst += p.win_cols * rs) {
          const int ih = ih0 + r;
          const bool row_in = b < a.B && ih >= 0 && ih < a.H;
          const int8_t* xrow = a.x + ((size_t)b * a.H + ih) * a.W * a.Cin;
          for (int q = lt; q < row_chunks; q += kLoaders) {
            const int col = pow2 ? q >> shift : q / cpr;
            const int c = q - col * cpr, iw = iw0 + col;
            const bool valid = row_in && iw >= 0 && iw < a.W;
            cp_async16(dst + col * rs + c * 16,
                       valid ? xrow + (size_t)iw * a.Cin + c * 16 : a.x,
                       valid);
          }
        }
      }
      cp_async_arrive(bars.winfull(buf));
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  consumer_role<NR, KP, false>(a, swin, sw, bars, wg, NoRefill{});
}

template <int NR, int KP>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = conv_kernel<NR, KP>;
  static bool attr = false;  // the shared memory limit, set once
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  kernel<<<a.p.blocks, kThreads, a.p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KP>
int dispatch_n(const Args& a, cudaStream_t stream) {
  switch (a.p.n) {
    case 64: return launch<32, KP>(a, stream);
    case 128: return launch<64, KP>(a, stream);
    case 256: return launch<128, KP>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

inline int dispatch(const Args& a, cudaStream_t stream) {
  switch (a.p.kp) {
    case 32: return dispatch_n<32>(a, stream);
    case 64: return dispatch_n<64>(a, stream);
    case 128: return dispatch_n<128>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace int8_wgmma
