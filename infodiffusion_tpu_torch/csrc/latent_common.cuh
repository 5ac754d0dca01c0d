// The latent MLP core on Hopper, shared by K4 (latent_traj.cu, the whole
// trajectory) and K5 (latent_mlp.cu, one forward). Both run the packed
// LatentUNet (ops/cuda/latent_mlp.py): L = 10 layers of
// [rows, 5d] x [5d, 4d] over W [L, 5d, 4d] in [in, out] layout (layer 0
// reads x @ W[0][:d], the last layer emits eps = z[:, :d]), each hidden
// layer followed by 1 + FiLM, LayerNorm over its 4d columns (mean and
// variance in f32, eps 1e-5), gamma/beta and SiLU.
//
// What bounds it: every layer streams its weights for a few operations per
// weight per batch row, and the layers form a chain (S x 10 in a
// trajectory) of exchanges between the blocks that share a row group. The
// design reads each weight once per row group, not once per batch row,
// and keeps each layer's exchanges to one round trip each.
//
// - Row groups on thread-block clusters. A cluster of R blocks (up to 16,
//   one per SM) owns G rows of the batch; clusters never talk to each
//   other, and a cluster walks its row groups one after another, so every
//   cluster is resident at once. Rank r owns `per` units of 64 output
//   columns of each hidden layer and one of the last layer's (or none);
//   it alone streams those columns of W (and, in K5, of Wc) through a
//   ring of stages of `tiles` 64-row K tiles (bf16, f32: a TMA box a
//   tile; int8: a bulk copy a tile of the wrapper's pre-tiled stream, all
//   of a stage's in flight at once) filled by a producer warp.
// - Every rank holds the cluster's layer input, the panel [G, 5d] in the
//   product input type, in 64-column chunks (bf16: K-major with the
//   128-byte swizzle wgmma reads): the hidden chunks, then x twice (K4
//   writes step i + 1's x into the buffer step i does not read), K5's s in
//   the second x buffer.
// - Products on the tensor cores: Z^T[cols, G] = W^T[cols, K] panel^T[K, G]
//   with W's columns on wgmma's M (64 a warpgroup) and the row group on N:
//   bf16 A MN-major from the ring, int8 A from registers (its bytes
//   converted to bf16, exact: |w| <= 127), B the panel; f32 W runs the
//   same fragments as FMAs. A stage's products are one group, waited for
//   before the next: nothing in flight across the loop's edge.
// - Two exchanges a hidden layer, on mbarriers that count bytes. The
//   statistics: each rank sends its per-row (mean, M2) over its columns to
//   every peer (st.async into distributed shared memory); each merges the
//   R partials by Chan's formula and normalises its columns. The hidden
//   slice: each rank writes it, in the panel's chunk layout, to its slot
//   of a global scratch and one multicast bulk load puts it into every
//   rank's panel, one L2 write and read where a push through distributed
//   shared memory would cross the SM's port R times. A rank sends its
//   slice only after it has every peer's statistics of the layer, so only
//   after every peer's product has read the panel. The last layer: the
//   eps slice updates the owner's f32 x (K4), whose rounded copy goes the
//   same way to every panel's other x buffer; K5 writes eps out.
// - W streams with an evict-last L2 policy, the FiLM rows and the noise
//   with evict-first, so the weights stay in the L2 across steps.
//
// Limits: d a multiple of 16, 16 <= d <= 1024; G in {8, 16, 32, 64}
// (f32: 8, 16); W f32, bf16 or int8 (K4, with Wsc). The launch plan
// (make_plan here, latent_launch_plan in ops/cuda/latent_mlp.py) is one
// arithmetic; the entries refuse a plan that is not their own.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "wgmma_common.cuh"

namespace latent {
// internal linkage: a process may load two builds of the library
namespace {

using flash_wgmma::bf16;

constexpr float kEps = 1e-5f;        // the LayerNorm's
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use
constexpr int kThreads = 160;        // a consumer warpgroup and a producer warp
constexpr int kMaxRanks = 16;
constexpr int kMaxStages = 16;
constexpr int kAlign = 1024;         // the swizzle's atoms
constexpr int kBarBytes = 8 * (2 * kMaxStages + 4);
constexpr int kF32Pitch = 68;        // floats a row of an f32 chunk
constexpr int kLayers = 10;          // the packed LatentUNet's
enum Kind { kTraj = 0, kMlp = 1 };

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One launch: ranks R and their column units (of 64 output columns) per
// layer, rows G per cluster, row groups and clusters, K tiles of 64, the
// ring's stages, the chunk and stage bytes, the shared memory layout
// (offsets from the 1024-aligned base) and bytes.
struct Plan {
  int ranks, units, per, eps_units, rows, groups, clusters;
  int kt_h, kt_x, chunk, tiles, stage, stages, zpitch, nparams;
  int o_panel, o_z, o_x, o_params, o_stats, o_bar, smem;
};

// bytes of one 64 x 64 K tile of W
inline int tile_bytes(int dtype) {
  return dtype == kF32 ? 64 * 64 * 4 : dtype == kBF16 ? 64 * 64 * 2 : 64 * 64;
}

// The shared memory layout at G rows (the ring, the panel, z [G, the
// rank's columns] f32, the owner's x [G, 64] f32 (K4), the rank's
// columns of bias, gamma, beta and Wsc (int8) or Bc (K5) for every layer,
// the statistics [R, G] (mean, M2), the mbarriers); false where the ring
// gets < 2 stages.
inline bool layout(Plan& p, int kind, int dtype, int G) {
  p.rows = G;
  p.chunk = dtype == kF32 ? G * kF32Pitch * 4 : G * 128;
  // K tiles a stage (one batch of products): 4 where they divide every
  // layer's K tiles (kt_x | kt_h), f32 one
  p.tiles = dtype == kF32 ? 1 : p.kt_x % 4 == 0 ? 4 : p.kt_x % 2 == 0 ? 2 : 1;
  p.stage = p.tiles * tile_bytes(dtype);
  p.zpitch = 64 * p.per + 4;
  p.nparams = dtype == kInt8 || kind == kMlp ? 4 : 3;
  const int panel = (p.kt_h + 2 * p.kt_x) * p.chunk;
  const int xstate = kind == kTraj ? G * 64 * 4 : 0;
  const int params = p.nparams * kLayers * 64 * p.per * 4;
  const int rest = panel + G * p.zpitch * 4 + xstate + params +
                   p.ranks * G * 8 + kBarBytes;
  p.stages = std::min(kMaxStages, (kSmemLimit - kAlign - rest) / p.stage);
  if (p.stages < 2) return false;
  p.o_panel = p.stages * p.stage;
  p.o_z = p.o_panel + panel;
  p.o_x = p.o_z + G * p.zpitch * 4;
  p.o_params = p.o_x + xstate;
  p.o_stats = p.o_params + params;
  p.o_bar = p.o_stats + p.ranks * G * 8;
  p.smem = kAlign + p.o_bar + kBarBytes;
  return true;
}

inline bool rows_allowed(int dtype, int G) {
  return G == 8 || G == 16 || (dtype != kF32 && (G == 32 || G == 64));
}

// R from d: the fewest units a rank (at most 16 ranks), then the fewest
// ranks at that; G: among the row counts that fit, the fewest rounds of
// clusters, then the fewest row groups, then the fewest rows.
inline bool make_plan(int kind, int dtype, int B, int d, int sms,
                      int max_active, Plan& p) {
  if (B < 1 || d < 16 || d > 1024 || d % 16) return false;
  if (dtype != kF32 && dtype != kBF16 && !(dtype == kInt8 && kind == kTraj))
    return false;
  p.units = d / 16;  // 4d / 64
  p.per = cdiv(p.units, kMaxRanks);
  p.ranks = cdiv(p.units, p.per);
  p.eps_units = cdiv(d, 64);  // rank r < eps_units owns eps unit r
  p.kt_h = p.units;
  p.kt_x = p.eps_units;
  const int cmax = std::min(max_active, sms / p.ranks);
  if (cmax < 1) return false;
  bool found = false;
  int best_rounds = 0, best_groups = 0;
  for (int G = 8; G <= 64; G *= 2) {
    Plan q = p;
    if (!rows_allowed(dtype, G) || !layout(q, kind, dtype, G))
      continue;
    q.groups = cdiv(B, G);
    q.clusters = std::min(q.groups, cmax);
    const int rounds = cdiv(q.groups, q.clusters);
    if (!found || rounds < best_rounds ||
        (rounds == best_rounds && q.groups < best_groups)) {
      p = q;
      best_rounds = rounds;
      best_groups = q.groups;
      found = true;
    }
  }
  return found;
}

// ------------------------------------------------------------ the device

// ------------------------------------------------------ warpgroup products

// d[4] (+)= A B, m64n8k16: A MN-major from shared memory (the W tile
// as stored, columns contiguous), B K-major from shared memory (the panel)
__device__ __forceinline__ void wgmma_tn(float (&d)[4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[4] (+)= A B, m64n8k16: A from registers, B K-major from shared
// memory
__device__ __forceinline__ void wgmma_rk(float (&d)[4],
                                         const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[8] (+)= A B, m64n16k16: A MN-major from shared memory (the W tile
// as stored, columns contiguous), B K-major from shared memory (the panel)
__device__ __forceinline__ void wgmma_tn(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[8] (+)= A B, m64n16k16: A from registers, B K-major from shared
// memory
__device__ __forceinline__ void wgmma_rk(float (&d)[8],
                                         const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[16] (+)= A B, m64n32k16: A MN-major from shared memory (the W tile
// as stored, columns contiguous), B K-major from shared memory (the panel)
__device__ __forceinline__ void wgmma_tn(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[16] (+)= A B, m64n32k16: A from registers, B K-major from shared
// memory
__device__ __forceinline__ void wgmma_rk(float (&d)[16],
                                         const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[32] (+)= A B, m64n64k16: A MN-major from shared memory (the W tile
// as stored, columns contiguous), B K-major from shared memory (the panel)
__device__ __forceinline__ void wgmma_tn(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A B, m64n64k16: A from registers, B K-major from shared
// memory
__device__ __forceinline__ void wgmma_rk(float (&d)[32],
                                         const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// the address of shared memory address `addr` in rank `rank`'s block
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// every thread of the cluster, with release / acquire semantics
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// A wait that outlasts kWatchdog cycles (~10 s) traps: the launch fails
// with an error instead of holding the card (no wait of a correct run
// comes near it: every cluster is resident).
constexpr long long kWatchdog = 1ll << 34;

// wait for the phase of parity `parity` of a local mbarrier: with
// acquire.cluster semantics (peers complete it: their writes are visible
// after it) or, cluster = false, the CTA's (the ring's TMA)
template <bool cluster>
__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    if (cluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if (clock64() - t0 > kWatchdog) __trap();
  }
}
__device__ __forceinline__ void wait_cluster(uint32_t bar, int parity) {
  wait_phase<true>(bar, parity);
}
__device__ __forceinline__ void wait_local(uint32_t bar, int parity) {
  wait_phase<false>(bar, parity);
}
// 8 bytes into a peer's shared memory, counted on the peer's mbarrier
__device__ __forceinline__ void st_async2(uint32_t dst, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
// `bytes` from global src into the shared memory at dst of every block of
// the cluster in `mask`, each counted on its mbarrier at bar
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}
// a streamed f32 (read once): no L1 line, evict first from the L2
__device__ __forceinline__ float ld_stream(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;\n"
               : "=f"(v)
               : "l"(p), "l"(pol));
  return v;
}
// box {64 columns, 64 rows, layer} of a [L, rows, cols] tensor map at
// (column c, row r, layer l), completing on bar, evict-last
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int r, int l,
                                         uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(l),
      "l"(pol)
      : "memory");
}
// `bytes` from global src into shared memory at dst, completing on bar,
// evict-last
__device__ __forceinline__ void bulk_tile(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

// four int8 (the bytes of w) as two bf16x2 (bytes 0, 1 in lo; 2, 3 in
// hi), exactly and without the quarter-rate I2F: byte v + 128 into the
// mantissa of 2^23 gives 2^23 + 128 + v, one FADD takes 2^23 + 128 off,
// and v (8 significant bits) is its float's upper half
__device__ __forceinline__ void s8x4(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

struct Args {
  const float* x;      // xT (K4) or x (K5): [B, d]
  const float* coef;   // K4: [S, 3]
  const void* W;       // int8: the pre-tiled stream (latent_int8_tiles)
  const float* film;   // K4: c_all [S, L, 4d]; K5: s [B, d]
  const float* noise;  // K4: [S, B, d]
  const float* bias;   // [L, 4d]
  const float* gam;
  const float* bet;
  const float* wsc;    // int8: [L, 4d]
  const float* bc;     // K5: [L, 4d]
  float* out;          // [B, d]
  unsigned char* scratch;  // [clusters, R, per + 1, chunk]: exchange slots
  int B, S, d;
  Plan p;
};

// The product input type's chunk: element (row n, column c < 64) of a
// chunk at byte offset n * 128 + ((c / 8) ^ (n % 8)) * 16 + (c % 8) * 2
// (bf16, the 128-byte swizzle), or n * 272 + c * 4 (f32).
template <int WT>
__device__ __forceinline__ int chunk_offset(int n, int c) {
  if (WT == kF32) return n * kF32Pitch * 4 + c * 4;
  return n * 128 + ((((c >> 3) ^ n) & 7) << 4) + (c & 7) * 2;
}

// v at columns c .. c + N - 1 (c % N == 0) of row `row` of a chunk in
// global memory at `chunk`, packed as the panel stores it (bf16 pairs or
// f32)
template <int WT, int N>
__device__ __forceinline__ void put_global(const float (&v)[N],
                                           unsigned char* chunk, int row,
                                           int c) {
  uint4 w[N == 8 && WT == kF32 ? 2 : 1];
  if constexpr (WT == kF32) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      w[k] = make_uint4(__float_as_uint(v[4 * k]), __float_as_uint(v[4 * k + 1]),
                        __float_as_uint(v[4 * k + 2]),
                        __float_as_uint(v[4 * k + 3]));
  } else if constexpr (N == 8) {
    w[0] = make_uint4(flash_wgmma::pack(v[0], v[1]), flash_wgmma::pack(v[2], v[3]),
                      flash_wgmma::pack(v[4], v[5]), flash_wgmma::pack(v[6], v[7]));
  } else {
    w[0] = make_uint4(flash_wgmma::pack(v[0], v[1]), flash_wgmma::pack(v[2], v[3]),
                      0u, 0u);
  }
  unsigned char* at = chunk + chunk_offset<WT>(row, c);
  if constexpr (WT != kF32 && N == 4) {
    *reinterpret_cast<uint2*>(at) = make_uint2(w[0].x, w[0].y);
  } else {
#pragma unroll
    for (int k = 0; k < (WT == kF32 ? N / 4 : 1); ++k)
      *reinterpret_cast<uint4*>(at + 16 * k) = w[k];
  }
}

// The consumer warpgroup's products over `nt` K tiles from the ring
// (`tiles` a stage), into acc (wgmma's D fragment: acc[i] is output column
// 16 warp + g + 8 ((i >> 1) & 1), row 8 (i >> 2) + 2 t + (i & 1) of the
// group). B chunk of tile t at chunk_of(t). g counts the ring's stages.
// A stage's products go in one group, waited for before the next stage:
// nothing in flight across the loop's edge.
template <int WT, int G, typename ChunkOf>
__device__ __forceinline__ void product(float (&acc)[G / 2], int nt,
                                        ChunkOf chunk_of, uint32_t ring,
                                        const unsigned char* ring_ptr,
                                        uint32_t bars, const Plan& p, int& g) {
  using namespace flash_wgmma;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };
  if constexpr (WT == kF32) {  // one tile a stage
#pragma unroll
    for (int i = 0; i < G / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < nt; ++t, ++g) {
      const int s = g % p.stages;
      wait_local(full(s), (g / p.stages) & 1);
      const float* wt =
          reinterpret_cast<const float*>(ring_ptr + (size_t)s * p.stage);
      const float* pn = chunk_of.ptr(t);
#pragma unroll 4
      for (int k = 0; k < 64; ++k) {
        const float a0 = wt[k * 64 + 16 * warp + g8];
        const float a1 = wt[k * 64 + 16 * warp + g8 + 8];
#pragma unroll
        for (int q = 0; q < G / 8; ++q) {
          const float b0 = pn[(8 * q + 2 * t4) * kF32Pitch + k];
          const float b1 = pn[(8 * q + 2 * t4 + 1) * kF32Pitch + k];
          acc[4 * q] = fmaf(a0, b0, acc[4 * q]);
          acc[4 * q + 1] = fmaf(a0, b1, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a1, b0, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a1, b1, acc[4 * q + 3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
  } else {
    unsigned a[4][4][4];  // int8: A fragments of the stage's tiles
    for (int t0 = 0; t0 < nt; t0 += p.tiles, ++g) {
      const int s = g % p.stages;
      wait_local(full(s), (g / p.stages) & 1);
      if constexpr (WT == kInt8) {
        // the thread's rows g, g + 8 of its warp's 16 columns: 16 bytes a
        // row, bytes 4 kk .. 4 kk + 3 holding k = 16 kk + 2t, 2t + 1,
        // 2t + 8, 2t + 9 (latent_int8_tiles)
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) {
          if (sub >= p.tiles) break;
          const unsigned char* tp = ring_ptr + (size_t)s * p.stage + sub * 4096;
          const uint4 r0 = *reinterpret_cast<const uint4*>(
              tp + (16 * warp + g8) * 64 + 16 * t4);
          const uint4 r1 = *reinterpret_cast<const uint4*>(
              tp + (16 * warp + g8 + 8) * 64 + 16 * t4);
          const unsigned w0[4] = {r0.x, r0.y, r0.z, r0.w};
          const unsigned w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            s8x4(w0[kk], a[sub][kk][0], a[sub][kk][2]);
            s8x4(w1[kk], a[sub][kk][1], a[sub][kk][3]);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        if (sub >= p.tiles) break;
        const uint32_t b = chunk_of.addr(t0 + sub);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int sc = t0 + sub == 0 && kk == 0 ? 0 : 1;
          const uint64_t db = desc(b + kk * 32, 16, 1024, kSwizzle128);
          if constexpr (WT == kBF16)
            wgmma_tn(acc,
                     desc(ring + s * p.stage + sub * 8192 + kk * 2048, 1024,
                          1024, kSwizzle128),
                     db, sc);
          else
            wgmma_rk(acc, a[sub][kk], db, sc);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (WT == kInt8)
#pragma unroll
        for (int sub = 0; sub < 4; ++sub) fence_regs(a[sub]);
      if (lane == 0) mbar_arrive(empty(s));
    }
  }
}

// Where tile t of a layer's K reads the panel: layer 0 the x chunks, the
// others the hidden chunks then the x chunks (x buffer xb); K5's FiLM
// products the s chunks (in the second x buffer's place).
template <int WT>
struct Chunks {
  uint32_t panel;              // shared address of the panel
  const unsigned char* ptr0;   // and its generic pointer
  int chunk, kt_h, kt_x, first_x;  // first_x: the x buffer's first chunk
  bool x_only;                 // layer 0, or the FiLM product
  __device__ __forceinline__ int index(int t) const {
    return x_only ? first_x + t : t < kt_h ? t : first_x + (t - kt_h);
  }
  __device__ __forceinline__ uint32_t addr(int t) const {
    return panel + index(t) * chunk;
  }
  __device__ __forceinline__ const float* ptr(int t) const {
    return reinterpret_cast<const float*>(ptr0 + (size_t)index(t) * chunk);
  }
};

// The kernel's body; KIND kTraj (K4: S steps, the x update) or kMlp (K5:
// one forward with per-row FiLM products), W's type WT, G rows a cluster.
template <int KIND, int WT, int G>
__device__ __forceinline__ void body(const Args& a, const CUtensorMap* tw,
                                     const CUtensorMap* tc) {
  using namespace flash_wgmma;
  const Plan& p = a.p;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  unsigned char* bp = smem_raw + (base - raw);
  const uint32_t s_panel = base + p.o_panel;
  unsigned char* panel = bp + p.o_panel;
  float* zb = reinterpret_cast<float*>(bp + p.o_z);
  float* xs = reinterpret_cast<float*>(bp + p.o_x);
  float* prm = reinterpret_cast<float*>(bp + p.o_params);
  const float2* stats = reinterpret_cast<const float2*>(bp + p.o_stats);
  const uint32_t bars = base + p.o_bar;
  const uint32_t bar_s = bars + 8 * 2 * kMaxStages;  // statistics in
  const uint32_t bar_h = bar_s + 8;                  // hidden chunks in
  const uint32_t bar_x = bar_s + 16;                 // x chunks in (K4)

  const int tid = threadIdx.x;
  const int rank = (int)cluster_rank();
  const int R = p.ranks, h = 4 * a.d, d = a.d, L = kLayers;
  const int u0 = rank * p.per, nu = max(0, min(p.per, p.units - u0));
  const int e0 = rank, ne = rank < p.eps_units ? 1 : 0;  // its eps unit
  const int kt_all = p.kt_h + p.kt_x;
  const float inv_h = 1.f / (float)h, inv_c = nu > 0 ? 1.f / (64.f * nu) : 0.f;
  const int CP = 64 * p.per;  // the parameter table's row
  // parameter k (bias, gamma, beta, Wsc or Bc) of layer j at the rank's
  // column c
  const auto param = [&](int k, int j, int c) {
    return prm[(k * kLayers + j) * CP + c];
  };

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                 // full: the TMA's bytes
      mbar_init(bars + 8 * (kMaxStages + s), 4);  // empty: a consumer warp each
    }
    mbar_init(bar_s, 1);
    mbar_init(bar_h, 1);
    mbar_init(bar_x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every peer's barriers exist before any remote write

  if (tid >= 128) {
    // ------------------------------------------------ producer: one lane
    if (tid == 128) {
      const uint64_t pol = evict_last();
      int g = 0;
      // stage: K tiles t .. t + tiles - 1 of unit u of layer j
      const auto load = [&](const CUtensorMap* map, int j, int u, int t) {
        const int s = g % p.stages;
        if (g >= p.stages) wait_local(bars + 8 * (kMaxStages + s),
                                     (g / p.stages - 1) & 1);
        const uint32_t dst = base + s * p.stage, full = bars + 8 * s;
        mbar_expect_tx(full, p.stage);
        // one copy a tile, all in flight at once
        for (int sub = 0; sub < p.tiles; ++sub) {
          const uint32_t at = dst + sub * (p.stage / p.tiles);
          if constexpr (WT == kInt8)
            bulk_tile(at,
                      static_cast<const int8_t*>(a.W) +
                          (((size_t)j * p.units + u) * kt_all + t + sub) * 4096,
                      4096, full, pol);
          else
            tma_tile(at, map, full, 64 * u, 64 * (t + sub), j, pol);
        }
        ++g;
      };
      for (int grp = (int)cluster_index(); grp < p.groups;
           grp += (int)cluster_count())
        for (int i = 0; i < a.S; ++i)
          for (int j = 0; j < L; ++j) {
            const bool last = j == L - 1;
            const int n_units = last ? ne : nu, ub = last ? e0 : u0;
            const int nt = j == 0 ? p.kt_x : kt_all;
            for (int ui = 0; ui < n_units; ++ui) {
              for (int t = 0; t < nt; t += p.tiles) load(tw, j, ub + ui, t);
              if (KIND == kMlp && !last)
                for (int t = 0; t < p.kt_x; t += p.tiles)
                  load(tc, j, ub + ui, t);
            }
          }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while a peer may still write
    return;
  }

  // -------------------------------------------------- consumer warpgroup
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  constexpr int TPR = 128 / G;     // threads a row in the epilogues
  const int en = tid / TPR, part = tid % TPR;  // the epilogue's row, part
  const uint64_t stream = evict_first();
  int g = 0, ps = 0, ph = 0, px = 0;
  if (tid == 0) {  // the first phase of each exchange
    mbar_expect_tx(bar_s, R * G * 8);
    mbar_expect_tx(bar_h, p.units * p.chunk);
    mbar_expect_tx(bar_x, p.eps_units * p.chunk);
  }
  // the rank's columns of the per-layer parameters, once
  for (int e = tid; e < p.nparams * kLayers * CP; e += 128) {
    const int k = e / (kLayers * CP), j = (e / CP) % kLayers, c = e % CP;
    const bool last = j == kLayers - 1;
    const int col = 64 * (last ? e0 : u0) + c;
    const float* src = k == 0   ? a.bias
                       : k == 1 ? a.gam
                       : k == 2 ? a.bet
                                : (WT == kInt8 ? a.wsc : a.bc);
    prm[e] = c < 64 * (last ? ne : nu) && col < h ? src[j * h + col] : 0.f;
  }
  const int xwidth = 64 * p.kt_x;  // x's columns in the panel
  // a sum over the TPR threads of row `en`
  const auto row_sum = [&](float v) {
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  // the epilogue thread's columns of the rank's eps slice (K4: its noise)
  const int ecw = 64 * ne / TPR, ec0 = part * ecw;

  for (int grp = (int)cluster_index(); grp < p.groups;
       grp += (int)cluster_count()) {
    const int r0 = grp * G, row = r0 + en;
    // this rank's slot of the exchanges' scratch: its hidden units, x
    unsigned char* scratch_slot =
        a.scratch +
        ((size_t)cluster_index() * R + rank) * (p.per + 1) * p.chunk;
    // x (and K5's s) into this block's panel, rounded; zeros past B and d
    for (int e = tid; e < G * xwidth; e += 128) {
      const int n = e / xwidth, c = e % xwidth, r = r0 + n;
      const bool in = r < a.B && c < d;
      const float xv = in ? a.x[(size_t)r * d + c] : 0.f;
      unsigned char* dst = panel + (size_t)(p.kt_h + c / 64) * p.chunk +
                           chunk_offset<WT>(n, c % 64);
      if (WT == kF32)
        *reinterpret_cast<float*>(dst) = xv;
      else
        *reinterpret_cast<bf16*>(dst) = __float2bfloat16(xv);
      if (KIND == kMlp) {
        const float sv = in ? a.film[(size_t)r * d + c] : 0.f;
        unsigned char* sd = dst + (size_t)p.kt_x * p.chunk;
        if (WT == kF32)
          *reinterpret_cast<float*>(sd) = sv;
        else
          *reinterpret_cast<bf16*>(sd) = __float2bfloat16(sv);
      }
      if (KIND == kTraj && c >= 64 * e0 && c < 64 * (e0 + ne))
        xs[n * 64 + c - 64 * e0] = xv;
    }
    fence_proxy_async();
    bar_sync(1, 128);

    for (int i = 0; i < a.S; ++i) {
      const int xb = KIND == kTraj ? (i & 1) : 0;
      float cx = 0.f, ce = 0.f, cn = 0.f;
      float nz[G / 2];  // this step's noise at the thread's eps columns
      if constexpr (KIND == kTraj) {
        cx = a.coef[3 * i];
        ce = a.coef[3 * i + 1];
        cn = a.coef[3 * i + 2];
#pragma unroll
        for (int k = 0; k < G / 2; ++k) {
          const int col = 64 * e0 + ec0 + k;
          nz[k] = k < ecw && row < a.B && col < d
                      ? ld_stream(a.noise + ((size_t)i * a.B + row) * d + col,
                                  stream)
                      : 0.f;
        }
      }
      for (int j = 0; j < L; ++j) {
        const bool last = j == L - 1;
        if (j == 0) {
          if (KIND == kTraj && i > 0) {
            wait_cluster(bar_x, px);
            px ^= 1;
            if (tid == 0) mbar_expect_tx(bar_x, p.eps_units * p.chunk);
          }
        } else {
          wait_cluster(bar_h, ph);
          ph ^= 1;
          if (tid == 0) mbar_expect_tx(bar_h, p.units * p.chunk);
        }
        // ---- products over the rank's units, z into zb[row][column]
        const int n_units = last ? ne : nu, ub = last ? e0 : u0;
        const Chunks<WT> chunks{s_panel, panel, p.chunk, p.kt_h, p.kt_x,
                                p.kt_h + xb * p.kt_x, j == 0};
        const Chunks<WT> schunks{s_panel, panel, p.chunk, p.kt_h, p.kt_x,
                                 p.kt_h + p.kt_x, true};
        for (int ui = 0; ui < n_units; ++ui) {
          float film[2] = {1.f, 1.f};  // K4: 1 + FiLM at the two columns
          if (KIND == kTraj && !last)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              film[hh] = ld_stream(a.film + ((size_t)i * L + j) * h +
                                       64 * (ub + ui) + 16 * warp + g8 + 8 * hh,
                                   stream);
          float acc[G / 2];
          product<WT, G>(acc, j == 0 ? p.kt_x : kt_all, chunks, base, bp,
                         bars, p, g);
          float accc[G / 2];  // K5: the FiLM product s Wc[j]
          if constexpr (KIND == kMlp) {
            if (!last)
              product<WT, G>(accc, p.kt_x, schunks, base, bp, bars, p, g);
          }
          // the thread's two columns' bias and Wsc or Bc
          float pb[2], p3[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = 64 * ui + 16 * warp + g8 + 8 * hh;
            pb[hh] = param(0, j, c);
            p3[hh] = WT == kInt8 || KIND == kMlp ? param(3, j, c) : 0.f;
          }
#pragma unroll
          for (int q = 0; q < G / 2; ++q) {
            const int hh = (q >> 1) & 1;
            const int m = 16 * warp + g8 + 8 * hh;
            const int n = 8 * (q >> 2) + 2 * t4 + (q & 1);
            float v = acc[q];
            if (WT == kInt8) v = __fmul_rn(v, p3[hh]);
            v = __fadd_rn(v, pb[hh]);
            if (!last) {
              if constexpr (KIND == kTraj)
                v *= film[hh];
              else
                v *= 1.f + (accc[q] + p3[hh]);
            }
            zb[n * p.zpitch + 64 * ui + m] = v;  // the rank's column
          }
        }
        bar_sync(1, 128);
        if (!last) {
          // ---- statistics: mean and M2 over the rank's columns of a row
          const int C = 64 * nu, cw = C / TPR, c0 = part * cw;
          const float* zr = zb + en * p.zpitch;
          float sum = 0.f;
          for (int c = c0; c < c0 + cw; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(zr + c);
            sum += (v.x + v.y) + (v.z + v.w);
          }
          sum = row_sum(sum);
          const float mean_r = sum * inv_c;
          float m2 = 0.f;
          for (int c = c0; c < c0 + cw; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(zr + c);
            const float d0 = v.x - mean_r, d1 = v.y - mean_r,
                        d2 = v.z - mean_r, d3 = v.w - mean_r;
            m2 = fmaf(d0, d0, m2);
            m2 = fmaf(d1, d1, m2);
            m2 = fmaf(d2, d2, m2);
            m2 = fmaf(d3, d3, m2);
          }
          m2 = row_sum(m2);
          const uint32_t slot =
              base + p.o_stats + (uint32_t)(rank * G + en) * 8;
          for (int q = part; q < R; q += TPR)
            st_async2(peer(slot, q), mean_r, m2, peer(bar_s, q));
          wait_local(bar_s, ps);  // st.async completes on it, as TMA does
          ps ^= 1;
          if (tid == 0) mbar_expect_tx(bar_s, R * G * 8);
          // Chan's merge of the R partials (rank q has 64 x its units),
          // the ranks split over the row's TPR threads
          const auto count = [&](int q) {
            return (float)(64 * max(0, min(p.per, p.units - q * p.per)));
          };
          float mean = 0.f;
          for (int q = part; q < R; q += TPR)
            mean = fmaf(count(q), stats[q * G + en].x, mean);
          mean = row_sum(mean) * inv_h;
          float M2 = 0.f;
          for (int q = part; q < R; q += TPR) {
            const float2 st = stats[q * G + en];
            const float dm = st.x - mean;
            M2 += fmaf(count(q) * dm, dm, st.y);
          }
          const float rstd = rsqrtf(row_sum(M2) * inv_h + kEps);
          // ---- LayerNorm, gamma/beta, SiLU, rounded, into every panel
          const float* gam_j = prm + (kLayers + j) * CP;
          const float* bet_j = prm + (2 * kLayers + j) * CP;
          // SiLU: f32 exact to the plain version's rounding; bf16 and int8
          // (inputs rounded to bf16 next) by the branch-free intrinsics, so
          // a thread's columns interleave
          const auto norm = [&](int c) {
            const float t = fmaf((zr[c] - mean) * rstd, gam_j[c], bet_j[c]);
            if constexpr (WT == kF32)
              return t / (1.f + expf(-t));
            else
              return __fdividef(t, 1.f + __expf(-t));
          };
          // into the rank's slot of the scratch, in the panel's chunk
          // layout; then one multicast bulk load a unit puts it into every
          // rank's panel: one write and one read of the L2 where a push
          // through distributed shared memory would send it R times
          unsigned char* slot_g = scratch_slot;
          if (cw % 8 == 0) {
            for (int c = c0; c < c0 + cw; c += 8) {
              float o[8];
#pragma unroll
              for (int k = 0; k < 8; ++k) o[k] = norm(c + k);
              put_global<WT, 8>(o, slot_g + (size_t)(c / 64) * p.chunk, en,
                                c % 64);
            }
          } else {
            for (int c = c0; c < c0 + cw; c += 4) {
              float o[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) o[k] = norm(c + k);
              put_global<WT, 4>(o, slot_g + (size_t)(c / 64) * p.chunk, en,
                                c % 64);
            }
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          bar_sync(1, 128);
          if (tid < nu)
            bulk_multicast(s_panel + (u0 + tid) * p.chunk,
                           slot_g + (size_t)tid * p.chunk, p.chunk, bar_h,
                           (uint16_t)((1u << R) - 1));
        } else if (KIND == kTraj) {
          // ---- the owner's x update over its eps columns (G / 2 a thread:
          // the rank owns one eps unit, or none), into every panel's other
          // x buffer (the next step's)
          if (ne > 0) {
            constexpr int EW = G / 2, N = EW % 8 == 0 ? 8 : 4;
            const bool final_step = i == a.S - 1;
            unsigned char* xslot = scratch_slot + (size_t)p.per * p.chunk;
            // all loads before any store: the stores to xs could alias
            float xn[EW];
#pragma unroll
            for (int k = 0; k < EW; ++k) {
              const int c = ec0 + k;
              xn[k] = 64 * e0 + c < d
                          ? cx * xs[en * 64 + c] + ce * zb[en * p.zpitch + c] +
                                cn * nz[k]
                          : 0.f;
            }
            if (final_step) {
              if (row < a.B)
#pragma unroll
                for (int k = 0; k < EW; ++k)
                  if (64 * e0 + ec0 + k < d)
                    a.out[(size_t)row * d + 64 * e0 + ec0 + k] = xn[k];
            } else {
#pragma unroll
              for (int k = 0; k < EW; ++k) xs[en * 64 + ec0 + k] = xn[k];
#pragma unroll
              for (int k = 0; k < EW; k += N) {
                float o[N];
#pragma unroll
                for (int k2 = 0; k2 < N; ++k2) o[k2] = xn[k + k2];
                put_global<WT, N>(o, xslot, en, ec0 + k);
              }
            }
            if (!final_step) {
              asm volatile("fence.proxy.async.global;\n" ::: "memory");
              bar_sync(1, 128);
              if (tid == 0)
                bulk_multicast(
                    s_panel + (p.kt_h + (xb ^ 1) * p.kt_x + e0) * p.chunk,
                    xslot, p.chunk, bar_x, (uint16_t)((1u << R) - 1));
            }
          }
        } else {
          // ---- K5: eps out over the rank's eps columns
          for (int k = 0; k < ecw; ++k) {
            const int c = ec0 + k, col = 64 * e0 + c;
            if (row < a.B && col < d)
              a.out[(size_t)row * d + col] = zb[en * p.zpitch + c];
          }
        }
      }
    }
    bar_sync(1, 128);  // the group's last reads of zb and xs, before the next
  }
  cluster_sync();  // no block leaves while a peer may still write
}

// ------------------------------------------------------------- the host

// a [L, rows, cols] tensor map of `type` whose box is one 64 x 64 K tile
// of a layer (bf16: the 128-byte swizzle); rows past `rows` read as zeros
inline bool layer_map(CUtensorMap* map, const void* ptr, int L, int rows,
                      int cols, bool f32) {
  flash_wgmma::EncodeTiled fn = flash_wgmma::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)L};
  const cuuint64_t strides[2] = {cols * es, (cuuint64_t)rows * cols * es};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cluster launch of `kernel` over the plan's clusters
template <typename Kernel>
int launch(Kernel kernel, const Args& a, const CUtensorMap* maps,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.clusters * a.p.ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.p.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, maps[0], maps[1]);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the attributes a cluster launch of `kernel` needs, set once
template <typename Kernel>
int prepare(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)err;
}

// clusters of `ranks` blocks of `kernel` the card co-schedules at the
// most shared memory (one block an SM), into *out
template <typename Kernel>
int max_clusters(Kernel kernel, int ranks, int* out) {
  const int err = prepare(kernel);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

}  // namespace
}  // namespace latent
