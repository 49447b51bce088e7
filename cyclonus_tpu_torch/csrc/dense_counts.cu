// Dense (int8) verdict-count kernels for Hopper (sm_90a): K4, K5 and K6 on
// one main loop.
//
// Replaces the TPU kernels of the reference's dense dtype plan
// (CYCLONUS_PACK=0) in cyclonus_tpu/engine/pallas_kernel.py:
//   * K4 single-chunk: _make_verdict_counts_kernel_1chunk, launched by
//        _verdict_counts_pallas_rect when both directions' augmented target
//        axes fit one chunk -- here dense_counts_kernel<false, 128> over
//        one src tile and one dst tile (the whole pod axes);
//   * K5 chunked: _make_verdict_counts_kernel, the same contraction over
//        several target chunks, skipping a (64-pod block, chunk) pair whose
//        match operand is all zero (the reference's nz maps) -- here
//        dense_counts_kernel<true, 128>, which reads the nz maps;
//   * K6 target slabs: _make_verdict_counts_kernel_slab via
//        verdict_counts_pallas_slab_from_ops, the contraction over each
//        (src tile, dst tile) pair's w_aug-row target window -- here
//        dense_counts_kernel<false, 64> over n_i x n_j slab tiles.
//
// Per cell (s, d) of port case q, all operands 0/1 int8 with the target
// (contraction) axis innermost:
//   acc_e = sum_t a_e[s, t] * b_e[q, d, t]      egress
//   acc_i = sum_t b_i[q, s, t] * a_i[d, t]      ingress
//   egress = acc_e > 0, ingress = acc_i > 0, combined = egress && ingress
// The wrapper (engine/dense_kernel.py) puts one pseudo-target row per
// direction right after the target rows that can hold data; it matches the
// valid pods without a target and allows the valid pods, and invalid pod
// columns are zero in every operand, so `acc > 0` is the whole verdict and
// an invalid pod counts nothing.  K6's operands are the same rows gathered
// per slab tile: b_e depends on the src tile as well as q, b_i on the dst
// tile.  Counts reduce into one int32 partial per (q, src segment): K4/K5
// segments are `bs` rows, K6 segments its slab src tiles.
//
// What bounds them: the reference contracts on the TPU's int8 matrix unit;
// on Hopper the least time for the multiply-adds over the live pods and
// the target rows that hold data (not the rows that pad a chunk or a
// window) is the int8 tensor-core rate (1.979e15 operations/s dense, two
// per multiply-add, reached only by wgmma), against the operand bytes over
// 3.35e12 B/s.  The operands (gigabytes at 100k pods) do not fit the 50 MB
// L2, and each block re-reads its tiles from L2, so what the kernels
// really wait on is the bytes a block stages per multiply-add and, at a
// shallow depth (K6's window is 64 bytes: one stage per direction), the
// latency of filling and draining the pipeline once per output tile.
//
// The design, shared by the three:
//   * one work item per (q, src tile, dst tile, 128 src rows, 256 dst
//     cols): 85 multiply-adds per staged byte.  An item never straddles
//     two tiles (K6's windows differ per tile); a tile narrower than the
//     item, or not a multiple of 128 rows or 256 columns, masks the cells
//     past its end in the epilogue (TMA's box reads the neighbouring
//     tile's rows there, so zero fill would not mask them).  K4/K5 have
//     one tile per axis, whose rows past the pod axes TMA fills with zeros;
//   * items in raster order: tile pairs outermost, 16 src row blocks to a
//     raster group within, so the tiles a wave of items shares stay in L2.
//     K4 and K6 run persistent blocks: a grid of one block per SM walks the
//     items with a stride of the grid; the producer walks the same item
//     sequence and runs up to the ring's depth ahead of the consumers,
//     across items, so one item's epilogue overlaps the next item's loads.
//     K5 launches one block per item instead: its items' work varies with
//     the skip, and persistent blocks drift apart in the item order until
//     the tiles they share fall out of L2 (measured: PERF.md);
//   * two consumer warpgroups own 64 src rows each, one wgmma m64n256k32
//     s8 -> s32 per 32 bytes of a stage's depth, both operands read from
//     shared memory in the swizzle TMA writes; one producer thread keeps
//     TMA loads in flight in a ring of 192 KB guarded by full/empty
//     mbarriers: 4 stages 128 bytes deep (K4, K5: the 128-byte swizzle) or,
//     for K6's shallow windows, 8 stages 64 bytes deep (the 64-byte
//     swizzle), so a 64-byte window is one stage a direction with no
//     products over zero fill; setmaxnreg moves registers from the
//     producer warpgroup to the consumers.  Every role walks the same
//     (item, direction, stage) sequence, and a consumer that contracts
//     nothing in a stage still waits for it and releases it, so the
//     barriers' phases agree across items;
//   * no loads past the live depth: each direction's tensor maps end at
//     it (K4/K5: the target rows up to the last one that matches a pod,
//     plus the pseudo row, rounded up to 32 bytes, read by the wrapper from
//     the operands; K6: the window, w_aug bytes), the walk stops at it,
//     and TMA fills the rest of the last box with zeros (a box may be
//     wider than the tensor: a 32-byte window is one 64-byte stage);
//   * K5's skip (the <true, 128> instance) reads the nz maps at their 64-pod
//     geometry: egress is keyed on (src block, chunk), one block per
//     consumer warpgroup, so a warpgroup whose block is all zero neither
//     loads nor contracts the chunk; ingress on (dst block, chunk), and a
//     chunk is loaded and contracted for the whole 256-column block when
//     any of its four dst blocks is kept.  ptxas serializes every wgmma of
//     a kernel once one of them sits under a data-dependent branch (its
//     note C7520), so K4 and K6 run <false, ...> instances, whose wgmmas
//     sit under no branch at all;
//   * one direction's accumulators live at a time (128 registers a
//     thread): egress folds into 128 verdict bits before ingress starts;
//     the item's verdicts count with popc into per-thread counts (in
//     shared memory, beside the ring) that stay there while the
//     warpgroup's items fall in one (q, src segment), and reach `counts`
//     with warp shuffles and one atomicAdd per verdict when the block's
//     next item falls in another segment or there is none.  The
//     accumulators leave no registers to spare: the persistent loop
//     decodes its item anew at each use rather than hold its fields across
//     the products, and flushes at the end of the item's body; either the
//     fields held or a flush before the products made ptxas spill the
//     accumulators (its note C7512, 2-4x slower; measured).  Integer sums
//     are exact in any order.
// The kernels allocate nothing and run on the caller's stream.

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
constexpr int kMaxStages = 8;
constexpr int kBlockThreads = 384;      // warpgroups 0, 1: consumers; 2: producer
constexpr int kConsumers = 256;
constexpr int kAcc = kN / 2;            // s32 accumulators per thread (m64n256)

// The ring at a stage depth of kK bytes, one row of the kK-byte swizzle
// per pod row: 4 stages of 48 KB at 128 bytes (K4, K5), 8 of 24 KB at 64
// (K6, whose window is 32 to 160 bytes deep).
template <int kK>
struct Geo {
  static constexpr int kBox = 64 * kK;            // one 64-row box
  static constexpr int kABytes = 2 * kBox;        // src rows of a stage
  static constexpr int kBBytes = kPieces * kBox;  // dst rows of a stage
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static_assert(kK == 64 || kK == 128, "a stage is one 64- or 128-byte swizzle row deep");
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
  const int32_t* nz_e;  // <true> only: [ns_pad / 64, nk_e] egress (src block, chunk) flags
  const int32_t* nz_i;  // <true> only: [nd_pad / 64, nk_i] ingress (dst block, chunk) flags
  int32_t* counts;      // [q, n_seg, 3]: ingress, egress, combined
  int n_i, n_j;         // src and dst tiles (K4/K5: one each)
  int tile_rows, tile_cols;
  int n_seg;            // partial counts (src segments) per q
  int ns_pad, nd_pad;   // n_i * tile_rows, n_j * tile_cols
  int live_e, live_i, kt_e, kt_i, nk_e, nk_i;
  int nr, nc;           // 128-row and 256-col blocks per tile
  int per_pair, per_q;  // items per tile pair (nr * nc) and per port case
  int items;            // q * per_q, below 2^30
  // divisors: per_q, per_pair, n_j, kGroup * nc, and the src rows per
  // partial count
  FastDiv by_per_q, by_per_pair, by_n_j, by_group, by_seg_rows;
};

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
// 128-byte swizzle, 2 the 64-byte one), starting `p`; a step of 32 bytes
// of depth inside the swizzle row adds 32 to `p`.
template <int kK>
__device__ __forceinline__ uint64_t sw_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  const uint64_t layout = kK == 128 ? 1 : 2;
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

// d += A (64 x 32 int8, K-major, shared) . B (256 x 32, K-major,
// shared)^T, s32: the warpgroup's 64 src rows against the item's 256 dst
// cols, 128 accumulators a thread.
__device__ __forceinline__ void wgmma_n256(int32_t (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64),
        ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(1));
}

#undef ACC8

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
// per 32 bytes of depth) if it contracts the chunk, release it.  The wgmmas sit under no branch in
// the instance without the skip: ptxas serializes every wgmma of a kernel
// once one depends on a data-dependent branch (C7520).
template <bool kSkip, bool kIngress, int kK>
__device__ __forceinline__ void contract(const Params& p, const Item& x, const uint8_t* smem,
                                         uint64_t* full, uint64_t* empty, Ring& r, int wg,
                                         int32_t (&acc)[kAcc]) {
  const int live = kIngress ? p.live_i : p.live_e;
  const int kt = kIngress ? p.kt_i : p.kt_e;
  using G = Geo<kK>;
  const int off_a = wg * G::kBox;  // this warpgroup's 64 src rows in the stage
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
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
          wgmma_n256(acc, sw_desc<kK>(a + 32 * s), sw_desc<kK>(b + 32 * s));
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
// thread: bit b of word j is accumulator register 32 j + b.
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

// This thread's counts of item x: ingress from acc, egress from eg_bits,
// combined from both.  Accumulator register 32 j + b of the thread holds
// the cell (row 16 warp + lane / 4 + 8 ((b / 2) % 2), col 64 j + 8 (b / 4)
// + 2 (lane % 4) + b % 2) of the warpgroup's 64 x 256 tile in both
// directions, so the verdicts combine bit by bit.  Cells past the item's
// tiles are masked; those past the pod axes hold zero sums.
__device__ __forceinline__ void count_cells(const Params& p, const Item& x, int wg, int ct,
                                            const int32_t (&acc)[kAcc],
                                            const uint32_t (&eg_bits)[kAcc / 32], int& c_in,
                                            int& c_eg, int& c_co) {
  const int lane = ct & 31, warp = (ct >> 5) & 3;
  const int rows_ok = (x.i + 1) * p.tile_rows - (x.row0 + 64 * wg);
  const int cols_ok = (x.j + 1) * p.tile_cols - x.col0;
  const int r0 = 16 * warp + (lane >> 2);
  const uint32_t row_mask =
      (r0 < rows_ok ? 0x33333333u : 0u) | (r0 + 8 < rows_ok ? 0xCCCCCCCCu : 0u);
  c_in = c_eg = c_co = 0;
#pragma unroll
  for (int j = 0; j < kAcc / 32; ++j) {
    uint32_t in = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) in |= (uint32_t)(acc[32 * j + b] > 0) << b;
    uint32_t live = row_mask;
    if (cols_ok < kN) {
      uint32_t col_mask = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const int col = 64 * j + 8 * (b >> 2) + 2 * (lane & 3) + (b & 1);
        col_mask |= (uint32_t)(col < cols_ok) << b;
      }
      live &= col_mask;
    }
    in &= live;
    const uint32_t eg = eg_bits[j] & live;
    c_in += __popc(in);
    c_eg += __popc(eg);
    c_co += __popc(in & eg);
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

template <bool kSkip, int kK>
__global__ void __launch_bounds__(kBlockThreads, 1)
    dense_counts_kernel(const __grid_constant__ CUtensorMap tm_ae,
                        const __grid_constant__ CUtensorMap tm_be,
                        const __grid_constant__ CUtensorMap tm_bi,
                        const __grid_constant__ CUtensorMap tm_ai, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ Held held;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Geo<kK>::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kSkip && threadIdx.x < kConsumers) {
#pragma unroll
    for (int v = 0; v < 3; ++v) held.counts[v][threadIdx.x] = 0;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  Ring ring{0, 0};
  if (wg == 2) {
    // producer: one thread issues every load, for every item of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
        const Item x = item_at(p, it);
        produce<kSkip, false, kK>(p, x, smem, full, empty, ring, &tm_ae, &tm_be);
        produce<kSkip, true, kK>(p, x, smem, full, empty, ring, &tm_bi, &tm_ai);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  int32_t acc[kAcc];
  uint32_t eg_bits[kAcc / 32];
  const int ct = threadIdx.x;
  int c_in, c_eg, c_co;
  if (kSkip) {
    // K5: the block's one item in one pass, its fields held in registers
    const Item x = item_at(p, blockIdx.x);
    const int seg = segment(p, x, wg);
    contract<kSkip, false, kK>(p, x, smem, full, empty, ring, wg, acc);
    verdict_bits(acc, eg_bits);
    contract<kSkip, true, kK>(p, x, smem, full, empty, ring, wg, acc);
    count_cells(p, x, wg, ct, acc, eg_bits, c_in, c_eg, c_co);
    held.counts[0][ct] = c_in;
    held.counts[1][ct] = c_eg;
    held.counts[2][ct] = c_co;
    flush(p, seg, wg, ct, held, true);
    return;
  }
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    contract<kSkip, false, kK>(p, item_at(p, opaque(it)), smem, full, empty, ring, wg, acc);
    verdict_bits(acc, eg_bits);
#pragma unroll
    for (int j = 0; j < kAcc / 32; ++j) held.eg_bits[j][ct] = eg_bits[j];
    contract<kSkip, true, kK>(p, item_at(p, opaque(it)), smem, full, empty, ring, wg, acc);
#pragma unroll
    for (int j = 0; j < kAcc / 32; ++j) eg_bits[j] = held.eg_bits[j][ct];
    const Item x = item_at(p, opaque(it));
    count_cells(p, x, wg, ct, acc, eg_bits, c_in, c_eg, c_co);
    held.counts[0][ct] += c_in;
    held.counts[1][ct] += c_eg;
    held.counts[2][ct] += c_co;

    // flush when the block's next item falls in another segment for this
    // warpgroup, or there is none.  (Here, at the end of the body: with a
    // flush before the products ptxas spills the accumulators, C7512.)
    const int seg = segment(p, x, wg);
    const int next = opaque(it) + gridDim.x;
    const bool last = next >= p.items;
    if (last || segment(p, item_at(p, next), wg) != seg) flush(p, seg, wg, ct, held, last);
  }
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

// An int8 tensor map of `rank` (2 or 4) dims, innermost first, in the
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
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), gdim, gstride,
                gbox, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                kK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// returned when a tensor map cannot be encoded (no cudaError_t has it)
constexpr int kErrTensorMap = -1;

// Encode the four tensor maps (each direction's ends at its live depth)
// and launch.  K5 takes one block per item: its items' work varies with
// the skip, and persistent blocks striding through them drift apart in the
// item order until the tiles they share no longer fit in L2 (measured on
// the H100: PERF.md).  K4 and K6, whose items are alike, run persistent.
template <bool kSkip, int kK>
int launch(const void* a_e, const void* b_e, const void* b_i, const void* a_i, int q,
           int de, int di, const Params& p, cudaStream_t stream) {
  CUtensorMap maps[4];
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
  if (!make_map<kK>(&maps[0], a_e, 2, ae_dims, ae_strides, box_64) ||
      !make_map<kK>(&maps[1], b_e, 4, be_dims, be_strides, box_n) ||
      !make_map<kK>(&maps[2], b_i, 4, bi_dims, bi_strides, box_m) ||
      !make_map<kK>(&maps[3], a_i, 2, ai_dims, ai_strides, box_n)) {
    return kErrTensorMap;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_counts_kernel<kSkip, kK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int grid = p.items;
  if (!kSkip) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    grid = p.items < sms ? p.items : sms;
  }
  dense_counts_kernel<kSkip, kK><<<grid, kBlockThreads, kSmem, stream>>>(maps[0], maps[1],
                                                                        maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch `kind` on `stream`: 0 = K4, 1 = K5, 2 = K6.  The src axis is n_i
// tiles of tile_rows rows (ns_pad), the dst axis n_j tiles of tile_cols
// (nd_pad); K4 and K5 pass one tile per axis.  a_e [ns_pad, de] and a_i
// [nd_pad, di] int8 (K6: its [n_i, bs, w_aug] and [n_j, bd, w_aug]
// operands, flattened); b_e [q, n_i, nd_pad, de] and b_i [q, n_j, ns_pad,
// di] int8 (K4/K5: n_i = n_j = 1); all 16-byte aligned.  de, di are the
// row pitches (multiples of 16); live_e <= de and live_i <= di the depths
// that can hold data, multiples of 32: nothing past them is read.
// Partials go to counts [q, ns_pad / seg_rows, 3], which the caller
// zero-fills; seg_rows is the tile (K6) or a multiple of 64 that divides
// it (K4/K5: bs).  K5 only: nz_e [ns_pad / 64, de / kt_e] and nz_i [nd_pad
// / 64, di / kt_i] int32 flags, one tile per axis, both a multiple of 64,
// chunks kt_e, kt_i multiples of 128 that divide the pitches; K4 and K6
// pass null flags.  Returns 0, a cudaError_t code or -1 (a tensor map
// could not be encoded).
extern "C" int cyclonus_dense_counts(const void* a_e, const void* b_e, const void* b_i,
                                     const void* a_i, const void* nz_e, const void* nz_i,
                                     void* counts, int kind, int q, int n_i, int n_j,
                                     int tile_rows, int tile_cols, int seg_rows, int de, int di,
                                     int live_e, int live_i, int kt_e, int kt_i, void* stream) {
  const bool skip = kind == 1;
  const long long ns_pad = (long long)n_i * tile_rows, nd_pad = (long long)n_j * tile_cols;
  if (kind < 0 || kind > 2 || skip != (nz_e != nullptr) || skip != (nz_i != nullptr) ||
      q < 1 || q > 65535 || n_i < 1 || n_j < 1 || tile_rows < 1 || tile_cols < 1 ||
      seg_rows < 1 || ns_pad >= (1ll << 30) || nd_pad >= (1ll << 30) ||
      !(seg_rows == tile_rows || (seg_rows % 64 == 0 && tile_rows % seg_rows == 0)) ||
      de % 16 != 0 || di % 16 != 0 || live_e < 32 || live_i < 32 || live_e % 32 != 0 ||
      live_i % 32 != 0 || live_e > de || live_i > di) {
    return (int)cudaErrorInvalidValue;
  }
  if (skip && (n_i != 1 || n_j != 1 || tile_rows % 64 != 0 || tile_cols % 64 != 0 ||
               kt_e < 128 || kt_i < 128 || kt_e % 128 != 0 || kt_i % 128 != 0 ||
               de % kt_e != 0 || di % kt_i != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* operands[4] = {a_e, b_e, b_i, a_i};
  for (const void* ptr : operands) {
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  Params p{};
  p.nz_e = static_cast<const int32_t*>(nz_e);
  p.nz_i = static_cast<const int32_t*>(nz_i);
  p.counts = static_cast<int32_t*>(counts);
  p.n_i = n_i;
  p.n_j = n_j;
  p.tile_rows = tile_rows;
  p.tile_cols = tile_cols;
  p.n_seg = (int)(ns_pad / seg_rows);
  p.ns_pad = (int)ns_pad;
  p.nd_pad = (int)nd_pad;
  p.live_e = live_e;
  p.live_i = live_i;
  p.kt_e = skip ? kt_e : live_e;  // without the skip, one chunk of the live depth
  p.kt_i = skip ? kt_i : live_i;
  p.nk_e = skip ? de / kt_e : 0;
  p.nk_i = skip ? di / kt_i : 0;
  p.nr = (tile_rows + kM - 1) / kM;
  p.nc = (tile_cols + kN - 1) / kN;
  const long long per_q = (long long)n_i * n_j * p.nr * p.nc;
  if (per_q * q >= (1ll << 30)) return (int)cudaErrorInvalidValue;
  p.per_pair = p.nr * p.nc;
  p.per_q = (int)per_q;
  p.items = (int)(per_q * q);
  p.by_per_q = fast_div(p.per_q);
  p.by_per_pair = fast_div(p.per_pair);
  p.by_n_j = fast_div(n_j);
  p.by_group = fast_div(kGroup * p.nc);
  p.by_seg_rows = fast_div(seg_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch<false, 128>(a_e, b_e, b_i, a_i, q, de, di, p, s);
  if (kind == 1) return launch<true, 128>(a_e, b_e, b_i, a_i, q, de, di, p, s);
  return launch<false, 64>(a_e, b_e, b_i, a_i, q, de, di, p, s);
}

// Registers, static and dynamic shared memory and local (spill) bytes per
// thread of the instance `kind` launches (as cyclonus_dense_counts):
// dense_counts_kernel<false, 128> (K4), <true, 128> (K5), <false, 64>
// (K6).  Returns 0 or a cudaError_t code.
extern "C" int cyclonus_dense_kernel_attrs(int kind, int* regs, int* smem_static,
                                           int* smem_dynamic, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (kind == 0) {
    err = cudaFuncGetAttributes(&attr, dense_counts_kernel<false, 128>);
  } else if (kind == 1) {
    err = cudaFuncGetAttributes(&attr, dense_counts_kernel<true, 128>);
  } else if (kind == 2) {
    err = cudaFuncGetAttributes(&attr, dense_counts_kernel<false, 64>);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_static = (int)attr.sharedSizeBytes;
  *smem_dynamic = kSmem;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* cyclonus_dense_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed or is unavailable";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
