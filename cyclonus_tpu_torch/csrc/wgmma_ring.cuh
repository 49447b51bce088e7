// The main loop that the counts kernels share on Hopper (sm_90a): one
// persistent or per-item block of three warpgroups, a producer thread
// keeping TMA loads in a ring of shared memory under full/empty mbarriers,
// and two consumer warpgroups that contract each 128 x 256-cell work item
// with wgmma m64n256, both operands K-major in the swizzle TMA writes, into
// 128 s32 accumulators a thread.  dense_counts.cu (K4, K5, K6: int8
// products, wgmma k32) and packed_counts.cu (K1, K2, K3: single-bit
// products, wgmma k256 .and.popc) include it; each has its own epilogue.
//
// The pieces: the item decode (Params, Item, item_at, fast division),
// mbarrier, TMA and wgmma wrappers, the ring (Ring, produce, contract),
// the per-thread counts held in shared memory and their flush, and the
// tensor maps.  See dense_counts.cu for the loop's design and what it
// learned (no side effect before the products, no item fields held across
// them: ptxas spills the accumulators otherwise).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 128;                 // src rows per item: two consumer warpgroups
constexpr int kN = 256;                 // dst cols per item
constexpr int kPieces = kN / 64;        // 64-pod dst blocks (ingress flags) per item
constexpr int kGroup = 16;              // src row blocks per raster group
constexpr int kRingBytes = 4 * (kM + kN) * 128;  // 192 KB of stages
constexpr int kSmem = kRingBytes + 1024;  // + the 1,024-byte alignment of the swizzle
constexpr int kMaxStages = 16;
constexpr int kBlockThreads = 384;      // warpgroups 0, 1: consumers; 2: producer
constexpr int kConsumers = 256;
constexpr int kAcc = kN / 2;            // s32 accumulators per thread (m64n256)

// The ring at a stage depth of kK bytes, one row of the kK-byte swizzle
// per pod row: 4 stages of 48 KB at 128 bytes (K4, K5), 8 of 24 KB at 64
// (K6, whose window is 32 to 160 bytes deep), 16 of 12 KB at 32 (K1-K3:
// one k256 single-bit product a stage).
template <int kK>
struct Geo {
  static constexpr int kBox = 64 * kK;            // one 64-row box
  static constexpr int kABytes = 2 * kBox;        // src rows of a stage
  static constexpr int kBBytes = kPieces * kBox;  // dst rows of a stage
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static_assert(kK == 32 || kK == 64 || kK == 128,
                "a stage is one 32-, 64- or 128-byte swizzle row deep");
  static_assert(kStages <= kMaxStages, "barrier arrays");
};

// Division by a divisor fixed at launch, for dividends below 2^31: a
// multiply-high and a shift (the round-up method of Granlund and
// Montgomery) instead of the dozens of instructions of `/`.
struct FastDiv {
  uint32_t div, mul, shr;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;
    while ((1u << l) < d) ++l;  // ceil(log2 d)
    f.mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return f.div == 1 ? n : (int)(__umulhi((uint32_t)n, f.mul) >> f.shr);
}

struct Params {
  const int32_t* nz_e;  // K5 only: [ns_pad / 64, nk_e] egress (src block, chunk) flags
  const int32_t* nz_i;  // K5 only: [nd_pad / 64, nk_i] ingress (dst block, chunk) flags
  int32_t* counts;      // [q, n_seg, 3]: ingress, egress, combined
  int n_i, n_j;         // src and dst tiles (one each but for K6)
  int tile_rows, tile_cols;
  int n_seg;            // partial counts (src segments) per q
  int ns_pad, nd_pad;   // n_i * tile_rows, n_j * tile_cols
  int live_e, live_i, kt_e, kt_i, nk_e, nk_i;  // bytes of depth loaded, chunk bytes, chunks
  int nr, nc;           // 128-row and 256-col blocks per tile
  int per_pair, per_q;  // items per tile pair (nr * nc) and per port case
  int items;            // q * per_q, below 2^30
  // divisors: per_q, per_pair, n_j, kGroup * nc, and the src rows per
  // partial count
  FastDiv by_per_q, by_per_pair, by_n_j, by_group, by_seg_rows;
};

// The loop's geometry: q port cases over n_i x n_j tiles of tile_rows x
// tile_cols cells, counts per seg_rows src rows, each direction loaded to
// its live depth (bytes) in chunks of kt bytes (kt = live: one chunk).
// False when the items do not fit below 2^30.
bool init_params(Params& p, int q, int n_i, int n_j, int tile_rows, int tile_cols, int seg_rows,
                 int live_e, int live_i, int kt_e, int kt_i, int nk_e, int nk_i) {
  p.n_i = n_i;
  p.n_j = n_j;
  p.tile_rows = tile_rows;
  p.tile_cols = tile_cols;
  p.ns_pad = n_i * tile_rows;
  p.nd_pad = n_j * tile_cols;
  p.n_seg = p.ns_pad / seg_rows;
  p.live_e = live_e;
  p.live_i = live_i;
  p.kt_e = kt_e;
  p.kt_i = kt_i;
  p.nk_e = nk_e;
  p.nk_i = nk_i;
  p.nr = (tile_rows + kM - 1) / kM;
  p.nc = (tile_cols + kN - 1) / kN;
  const long long per_q = (long long)n_i * n_j * p.nr * p.nc;
  if (per_q * q >= (1ll << 30)) return false;
  p.per_pair = p.nr * p.nc;
  p.per_q = (int)per_q;
  p.items = (int)(per_q * q);
  p.by_per_q = fast_div(p.per_q);
  p.by_per_pair = fast_div(p.per_pair);
  p.by_n_j = fast_div(n_j);
  p.by_group = fast_div(kGroup * p.nc);
  p.by_seg_rows = fast_div(seg_rows);
  return true;
}

// One work item: port case, src and dst tile, first src row and dst col.
struct Item {
  int q, i, j, row0, col0;
};

__device__ __forceinline__ Item item_at(const Params& p, int it) {
  Item x;
  x.q = it / p.by_per_q;
  const int rem = it - x.q * p.per_q;
  const int pair = rem / p.by_per_pair;
  const int local = rem - pair * p.per_pair;
  x.i = pair / p.by_n_j;
  x.j = pair - x.i * p.n_j;
  // grouped raster within the tile pair: kGroup row blocks at a time (the
  // last group of a tile may hold fewer)
  const int group = local / p.by_group;
  const int first_r = group * kGroup;
  const int in_group = local - group * (kGroup * p.nc);
  int r, c;
  if (p.nr - first_r >= kGroup) {
    r = in_group % kGroup;
    c = in_group / kGroup;
  } else {
    const int rows_here = p.nr - first_r;
    r = in_group % rows_here;
    c = in_group / rows_here;
  }
  x.row0 = x.i * p.tile_rows + (first_r + r) * kM;
  x.col0 = x.j * p.tile_cols + c * kN;
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the kK-byte swizzle
// (rows of kK bytes, 8-row groups 8 kK bytes apart; layout type 1 is the
// 128-byte swizzle, 2 the 64-byte one, 3 the 32-byte one), starting `p`;
// a step of 32 bytes of depth inside the swizzle row adds 32 to `p`.
template <int kK>
__device__ __forceinline__ uint64_t sw_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  const uint64_t layout = kK == 128 ? 1 : (kK == 64 ? 2 : 3);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * kK >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
__device__ __forceinline__ void fence_acc(int32_t (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(o)                                                                  \
  "+r"(d[(o) + 0]), "+r"(d[(o) + 1]), "+r"(d[(o) + 2]), "+r"(d[(o) + 3]),        \
      "+r"(d[(o) + 4]), "+r"(d[(o) + 5]), "+r"(d[(o) + 6]), "+r"(d[(o) + 7])
#define ACC128                                                                            \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64), \
      ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
#define REGS128                                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "    \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "      \
  "%125, %126, %127"

// d += A (64 rows x 32 bytes, K-major, shared) . B (256 x 32 bytes,
// K-major, shared)^T, s32: the warpgroup's 64 src rows against the item's
// 256 dst cols, 128 accumulators a thread.  kBits = false: int8 products
// over 32 bytes (m64n256k32 .s8.s8); true: single-bit AND then popc over
// 256 bits (m64n256k256 .b1.b1.and.popc), so each accumulator gains
// popc(a & b) of the 32 bytes, which is nonzero exactly where a & b is.
// scale_d = 0 overwrites d instead (d = A . B^T).
template <bool kBits>
__device__ __forceinline__ void wgmma_n256(int32_t (&d)[kAcc], uint64_t da, uint64_t db,
                                           uint32_t scale_d) {
  if constexpr (kBits) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc {" REGS128
        "}, %128, %129, p;\n}\n"
        : ACC128
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" REGS128 "}, %128, %129, p;\n}\n"
        : ACC128
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

#undef ACC8
#undef ACC128
#undef REGS128

// The skip flags, the same for every thread that asks: egress per src
// block (consumer warpgroup w), ingress per dst block (j of the item's
// four); a block past the pod axis is never kept.
__device__ __forceinline__ bool eg_flag(const Params& p, int row0, int w, int c) {
  const int b = row0 / 64 + w;
  return b < p.ns_pad / 64 && __ldg(p.nz_e + (size_t)b * p.nk_e + c) != 0;
}
__device__ __forceinline__ bool in_flag(const Params& p, int col0, int j, int c) {
  const int b = col0 / 64 + j;
  return b < p.nd_pad / 64 && __ldg(p.nz_i + (size_t)b * p.nk_i + c) != 0;
}

// Which consumer warpgroups contract chunk c of one direction of an item
// (bit w for warpgroup w), the same in every role: without the skip both;
// with it, egress by the flag of each warpgroup's src block, ingress both
// when any of the item's four dst blocks' flags is set.
template <bool kSkip, bool kIngress>
__device__ __forceinline__ uint32_t chunk_mine(const Params& p, const Item& x, int c) {
  if (!kSkip) return 3u;
  if (kIngress) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) any = any || in_flag(p, x.col0, j, c);
    return any ? 3u : 0u;
  }
  return (uint32_t)eg_flag(p, x.row0, 0, c) | (uint32_t)eg_flag(p, x.row0, 1, c) << 1;
}

// A position in the ring: the stage and the parity of its round.  Every
// role advances through the same sequence of stages: the chunks that some
// consumer needs, each cut into stages of kK bytes of depth below the live
// depth.
struct Ring {
  int stage;
  uint32_t phase;
};

template <int kK>
__device__ __forceinline__ void advance(Ring& r) {
  if (++r.stage == Geo<kK>::kStages) {
    r.stage = 0;
    r.phase ^= 1;
  }
}

// The producer's loads of one direction of an item: egress stages the
// warpgroups' a_e rows (those that contract) and the item's b_e rows,
// ingress its b_i and a_i rows.
template <bool kSkip, bool kIngress, int kK>
__device__ __forceinline__ void produce(const Params& p, const Item& x, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty, Ring& r,
                                        const CUtensorMap* tm_src, const CUtensorMap* tm_dst) {
  const int live = kIngress ? p.live_i : p.live_e;
  const int kt = kIngress ? p.kt_i : p.kt_e;
  for (int c0 = 0, c = 0; c0 < live; c0 += kt, ++c) {
    const uint32_t mine = chunk_mine<kSkip, kIngress>(p, x, c);
    if (mine == 0) continue;
    const int c1 = min(c0 + kt, live);
    for (int k0 = c0; k0 < c1; k0 += kK) {
      mbar_wait(&empty[r.stage], r.phase ^ 1);
      using G = Geo<kK>;
      uint8_t* a = smem + r.stage * G::kStageBytes;
      uint64_t* bar = &full[r.stage];
      if (kIngress) {
        mbar_expect_tx(bar, G::kABytes + G::kBBytes);
        tma_4d(a, tm_src, k0, x.row0, x.j, x.q, bar);
        tma_2d(a + G::kABytes, tm_dst, k0, x.col0, bar);
      } else {
        mbar_expect_tx(bar, __popc(mine) * G::kBox + G::kBBytes);
        if (mine & 1) tma_2d(a, tm_src, k0, x.row0, bar);
        if (mine & 2) tma_2d(a + G::kBox, tm_src, k0, x.row0 + 64, bar);
        tma_4d(a + G::kABytes, tm_dst, k0, x.col0, x.i, x.q, bar);
      }
      advance<kK>(r);
    }
  }
}

// A consumer warpgroup's products of one direction of an item into acc:
// per stage, wait for its data, run this warpgroup's wgmmas on it (one
// per 32 bytes of depth) if it contracts the chunk, release it.  The
// wgmmas sit under no branch in the instances without the skip: ptxas
// serializes every wgmma of a kernel once one depends on a data-dependent
// branch (C7520).  The packed instances (kBits) let their first product
// overwrite the accumulators (scale-d 0) instead of adding to zeros
// (measured faster, PERF.md); the dense ones zero them first (K5 may
// contract nothing at all).
template <bool kSkip, bool kIngress, int kK, bool kBits>
__device__ __forceinline__ void contract(const Params& p, const Item& x, const uint8_t* smem,
                                         uint64_t* full, uint64_t* empty, Ring& r, int wg,
                                         int32_t (&acc)[kAcc]) {
  constexpr bool kOverwrite = kBits;
  static_assert(!(kOverwrite && kSkip), "a skipped chunk would leave the accumulators stale");
  const int live = kIngress ? p.live_i : p.live_e;
  const int kt = kIngress ? p.kt_i : p.kt_e;
  using G = Geo<kK>;
  const int off_a = wg * G::kBox;  // this warpgroup's 64 src rows in the stage
  uint32_t scale = kOverwrite ? 0u : 1u;
  if constexpr (!kOverwrite) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  }
  for (int c0 = 0, c = 0; c0 < live; c0 += kt, ++c) {
    const uint32_t mine = chunk_mine<kSkip, kIngress>(p, x, c);
    if (mine == 0) continue;
    const bool own = kSkip ? ((mine >> wg) & 1u) != 0 : true;
    const int c1 = min(c0 + kt, live);
    for (int k0 = c0; k0 < c1; k0 += kK) {
      mbar_wait(&full[r.stage], r.phase);
      if (own) {
        const uint8_t* a = smem + r.stage * G::kStageBytes + off_a;
        const uint8_t* b = smem + r.stage * G::kStageBytes + G::kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kK / 32; ++s) {
          wgmma_n256<kBits>(acc, sw_desc<kK>(a + 32 * s), sw_desc<kK>(b + 32 * s), scale);
          scale = 1;
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
      }
      mbar_arrive(&empty[r.stage]);
      advance<kK>(r);
    }
  }
}

// Shared memory beside the ring: per consumer thread (index ct = 0..255)
// its counts of the segment it holds and the egress verdict bits of the
// current item, kept out of the registers that the accumulators fill.
struct Held {
  int32_t counts[3][kConsumers];  // ingress, egress, combined
  uint32_t eg_bits[kAcc / 32][kConsumers];
  int32_t red[2][3][4];           // per warpgroup and verdict, per warp
};

// The warpgroup's counts of segment `seg` into `counts`: warp shuffles,
// one partial per warp, one atomicAdd per verdict; then zeroed.  Every
// thread of the warpgroup calls it; `last` when the block has no more
// items (nothing reuses the partials then).
__device__ __forceinline__ void flush(const Params& p, int seg, int wg, int ct, Held& h,
                                      bool last) {
  const int t = ct & 127, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    int32_t c = h.counts[v][ct];
    h.counts[v][ct] = 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) h.red[wg][v][warp] = c;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  if (t < 3) {
    const int32_t total = h.red[wg][t][0] + h.red[wg][t][1] + h.red[wg][t][2] + h.red[wg][t][3];
    if (total != 0) atomicAdd(&p.counts[seg * 3 + t], total);
  }
  if (!last) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // red is read
}

// The segment (partial count) of warpgroup wg's rows of item x: rows past
// the tile, which the epilogue masks, count toward the tile's last one.
__device__ __forceinline__ int segment(const Params& p, const Item& x, int wg) {
  const int last = (x.i + 1) * p.tile_rows - 1;
  return x.q * p.n_seg + min(x.row0 + 64 * wg, last) / p.by_seg_rows;
}

// The `acc > 0` verdicts of a warpgroup's 64 x 256 tile as 128 bits a
// thread: bit b of word j is accumulator register 32 j + b, the cell (row
// 16 warp + lane / 4 + 8 ((b / 2) % 2), col 64 j + 8 (b / 4) + 2 (lane % 4)
// + b % 2) of the tile, the same cell in both directions.
__device__ __forceinline__ void verdict_bits(const int32_t (&acc)[kAcc],
                                             uint32_t (&bits)[kAcc / 32]) {
#pragma unroll
  for (int j = 0; j < kAcc / 32; ++j) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) m |= (uint32_t)(acc[32 * j + b] > 0) << b;
    bits[j] = m;
  }
}

// The item index, opaque to the compiler: each use decodes the item anew
// (a few multiply-highs) instead of holding its fields in registers across
// the products, where the accumulators leave none to spare (ptxas spills
// them otherwise).
__device__ __forceinline__ int opaque(int it) {
  asm volatile("" : "+r"(it));
  return it;
}

// The shared memory and barriers of a block, set up by every thread:
// returns the ring (1,024-byte aligned for the swizzle); counts zeroed when
// `zero_counts`.
template <int kK>
__device__ __forceinline__ uint8_t* block_setup(uint8_t* smem_raw, uint64_t* full,
                                                uint64_t* empty, Held& held, bool zero_counts) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Geo<kK>::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (zero_counts && threadIdx.x < kConsumers) {
#pragma unroll
    for (int v = 0; v < 3; ++v) held.counts[v][threadIdx.x] = 0;
  }
  __syncthreads();
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
}

// cuTensorMapEncodeTiled, fetched from the driver at run time, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A byte tensor map of `rank` (2 or 4) dims, innermost first, in the
// kK-byte swizzle; reads past `dims` fill with zeros.
template <int kK>
bool make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
              const uint64_t* strides, const uint32_t* box) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t gbox[4], estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) gstride[i] = strides[i];
  const CUtensorMapSwizzle swizzle = kK == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), gdim, gstride,
                gbox, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// returned when a tensor map cannot be encoded (no cudaError_t has it)
constexpr int kErrTensorMap = -1;

// The four tensor maps of the loop, each direction's ending at its live
// depth: a_e [ns_pad, de] and a_i [nd_pad, di] bytes (2-D), b_e [q, n_i,
// nd_pad, de] and b_i [q, n_j, ns_pad, di] (4-D: depth, pod, tile, q);
// de, di the row pitches in bytes.
template <int kK>
bool encode_maps(CUtensorMap (&maps)[4], const void* a_e, const void* b_e, const void* b_i,
                 const void* a_i, int q, int de, int di, const Params& p) {
  const uint64_t ae_dims[2] = {(uint64_t)p.live_e, (uint64_t)p.ns_pad};
  const uint64_t ae_strides[1] = {(uint64_t)de};
  const uint32_t box_64[2] = {kK, 64};
  const uint64_t be_dims[4] = {(uint64_t)p.live_e, (uint64_t)p.nd_pad, (uint64_t)p.n_i,
                               (uint64_t)q};
  const uint64_t be_strides[3] = {(uint64_t)de, (uint64_t)p.nd_pad * de,
                                  (uint64_t)p.n_i * p.nd_pad * de};
  const uint32_t box_n[4] = {kK, kN, 1, 1};
  const uint64_t bi_dims[4] = {(uint64_t)p.live_i, (uint64_t)p.ns_pad, (uint64_t)p.n_j,
                               (uint64_t)q};
  const uint64_t bi_strides[3] = {(uint64_t)di, (uint64_t)p.ns_pad * di,
                                  (uint64_t)p.n_j * p.ns_pad * di};
  const uint32_t box_m[4] = {kK, kM, 1, 1};
  const uint64_t ai_dims[2] = {(uint64_t)p.live_i, (uint64_t)p.nd_pad};
  const uint64_t ai_strides[1] = {(uint64_t)di};
  return make_map<kK>(&maps[0], a_e, 2, ae_dims, ae_strides, box_64) &&
         make_map<kK>(&maps[1], b_e, 4, be_dims, be_strides, box_n) &&
         make_map<kK>(&maps[2], b_i, 4, bi_dims, bi_strides, box_m) &&
         make_map<kK>(&maps[3], a_i, 2, ai_dims, ai_strides, box_n);
}

// The persistent grid: one block per SM, or one per item when there are
// fewer items.
cudaError_t persistent_grid(int items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *grid = items < sms ? items : sms;
  return err;
}

}  // namespace
