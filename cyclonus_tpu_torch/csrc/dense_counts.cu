// Dense (int8) verdict-count kernels for Hopper (sm_90a): K4, K5 and K6.
//
// Replaces the TPU kernels of the reference's dense dtype plan
// (CYCLONUS_PACK=0) in cyclonus_tpu/engine/pallas_kernel.py:
//   * K4 single-chunk (the mma.sync template, kSlab = false):
//        _make_verdict_counts_kernel_1chunk, launched by
//        _verdict_counts_pallas_rect when both directions' augmented target
//        axes fit one chunk;
//   * K5 chunked (chunked_counts_kernel, its own kernel on wgmma and TMA):
//        _make_verdict_counts_kernel, the same contraction over several
//        target chunks, skipping a (64-pod block, chunk) pair whose match
//        operand is all zero (the reference's nz maps);
//   * K6 target slabs (the mma.sync template, kSlab = true):
//        _make_verdict_counts_kernel_slab via
//        verdict_counts_pallas_slab_from_ops, the contraction over each
//        (src tile, dst tile) pair's w_aug-row target window.
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
// really wait on is the bytes a block stages per multiply-add.
//
// K5 (chunked_counts_kernel) is built for that:
//   * one block per (q, 128 src rows, 256 dst cols): 85 multiply-adds per
//     staged byte, 2.7x the 64 x 64 block's 32; blocks are issued in groups
//     of 16 src row tiles, so the tiles that a wave of blocks shares stay
//     in L2;
//   * two consumer warpgroups own 64 src rows each, four wgmma m64n256k32
//     s8 -> s32 per stage of 128 bytes of depth, both operands read from
//     shared memory in the 128-byte swizzle TMA writes; one producer
//     thread keeps TMA loads in flight in a ring of 4 stages (48 KB each)
//     guarded by full/empty mbarriers; setmaxnreg moves registers from the
//     producer warpgroup to the consumers;
//   * the skip reads the nz maps at their 64-pod geometry: egress is keyed
//     on (src block, chunk), one block per consumer warpgroup, so a
//     warpgroup whose block is all zero neither loads nor contracts the
//     chunk; ingress on (dst block, chunk), and a chunk is loaded and
//     contracted for the whole 256-column block when any of its four dst
//     blocks is kept (the others are zero in memory, so they add nothing).
//     Issuing the ingress product as m64n64 pieces, each on its own flag,
//     was measured slower: ptxas serializes every wgmma of the kernel once
//     one of them sits under a data-dependent branch (its note C7520), and
//     that costs more than the pieces save (measured on the H100: PERF.md);
//   * no loads past the live depth: each direction's tensor maps end at
//     it (the target rows up to the last one that matches a pod, plus the
//     pseudo row, rounded up to 32 bytes; the wrapper reads it from the
//     operands), the walk stops at it, and TMA fills
//     the ragged last box (and any row past the pod axes) with zeros, which
//     the last stage of a chunk contracts (at most 96 bytes);
//   * one direction's accumulators live at a time (128 registers a
//     thread): egress folds into 128 verdict bits before ingress starts;
//     counts reduce with popc, warp shuffles and one atomicAdd per
//     warpgroup and verdict.
//
// K4 and K6 (dense_counts_kernel) are simple and right, not fast: the
// warp-level mma.sync m16n8k32 s8 -> s32, fed from shared memory that a
// plain load/store loop fills, with no copy/compute overlap:
//   * one block per (q, 64 src rows, 64 dst cols), 256 threads = 8 warps;
//     warp w owns rows 16 (w % 4) .. +16 and cols 32 (w / 4) .. +32 of the
//     block as four m16n8 accumulator tiles per direction (16 registers);
//   * each direction loops over its own depth, staging 32 words (128 int8
//     values) per row of the block's src and dst rows in shared memory per
//     pass with 16-byte loads and stores, target axis innermost, so each
//     fragment register is one 32-bit shared load (row stride 36 words: the
//     32 lanes of a fragment load hit 32 different banks);
//   * K6's blocks never straddle two slab tiles (their windows differ): a
//     tile narrower than 64 rows or columns leaves the rest of the block
//     masked, so the kernel takes any tile width;
//   * counts reduce with warp shuffles, then one atomicAdd per block and
//     verdict; integer sums are exact in any order.
// The kernels allocate nothing and run on the caller's stream.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- K4 / K6: mma.sync ------------------------------------------------------

constexpr int kTile = 64;              // src rows and dst cols per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNTiles = 4;             // m16n8 accumulator tiles per warp and direction
constexpr int kPass = 32;              // contraction words staged per pass (4 k32 steps)
constexpr int kStride = kPass + 4;     // shared-memory row stride, in words
constexpr int kVec = 4;                // words per 16-byte load
constexpr int kLoads = kTile * kPass / kVec / kThreads;  // 16-byte loads per thread and operand

struct Args {
  const int8_t* a_e;    // [ns_pad, de]               (K6: [n_i, bs, de])
  const int8_t* b_e;    // [q, nd_pad, de]            (K6: [q, n_i, nd_pad, de])
  const int8_t* b_i;    // [q, ns_pad, di]            (K6: [q, n_j, ns_pad, di])
  const int8_t* a_i;    // [nd_pad, di]               (K6: [n_j, bd, di])
  int32_t* counts;      // [q, ns_pad / bs, 3]: ingress, egress, combined
  int q, ns_pad, nd_pad, de, di, bs, bd;
};

__device__ __forceinline__ int4 load_vec(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// d += a (16 x 32 int8, row-major) . b (32 x 8 int8, column-major), int32
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], int32_t a0, int32_t a1, int32_t a2,
                                       int32_t a3, int32_t b0, int32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The accumulator fragment layout of mma.sync m16n8 within the block:
// register c of tile j in lane 4 g + t of warp w holds the cell
// (frag_row, frag_col).
__device__ __forceinline__ int frag_row(int warp, int lane, int c) {
  return (warp & 3) * 16 + (lane >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int frag_col(int warp, int lane, int j, int c) {
  return (warp >> 2) * 32 + 8 * j + 2 * (lane & 3) + (c & 1);
}

// acc += src rows . dst rows over the depth (int8, 4 per word) for this
// warp's fragment tiles.  `src` points at the block's first src row, `dst`
// at its first dst row, both with `depth` bytes per row (a multiple of 32).
__device__ __forceinline__ void contract(const int8_t* __restrict__ src,
                                         const int8_t* __restrict__ dst, int depth, int rows,
                                         int cols, int32_t (*s_src)[kStride],
                                         int32_t (*s_dst)[kStride], int32_t (&acc)[kNTiles][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ar = (warp & 3) * 16 + g;  // A fragment rows ar, ar + 8
  const int bc = (warp >> 2) * 32 + g;  // B fragment cols bc + 8 j
  const int words = depth / 4;
  for (int k0 = 0; k0 < words; k0 += kPass) {
    const int nw = min(kPass, words - k0);  // a multiple of 8 words
    int4 vs[kLoads], vd[kLoads];
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int idx = tid + m * kThreads;
      const int r = idx / (kPass / kVec), v = idx % (kPass / kVec);
      vs[m] = vd[m] = make_int4(0, 0, 0, 0);
      if (v * kVec < nw) {
        const size_t off = (size_t)r * depth + 4 * (size_t)(k0 + v * kVec);
        if (r < rows) vs[m] = load_vec(src + off);
        if (r < cols) vd[m] = load_vec(dst + off);
      }
    }
    __syncthreads();  // every read of the previous pass is done
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int idx = tid + m * kThreads;
      const int r = idx / (kPass / kVec), v = idx % (kPass / kVec);
      *reinterpret_cast<int4*>(&s_src[r][v * kVec]) = vs[m];
      *reinterpret_cast<int4*>(&s_dst[r][v * kVec]) = vd[m];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPass; k += 8) {  // one k32 step
      if (k >= nw) break;  // the same for every thread
      const int32_t a0 = s_src[ar][k + t], a1 = s_src[ar + 8][k + t];
      const int32_t a2 = s_src[ar][k + 4 + t], a3 = s_src[ar + 8][k + 4 + t];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        mma_s8(acc[j], a0, a1, a2, a3, s_dst[bc + 8 * j][k + t], s_dst[bc + 8 * j][k + 4 + t]);
      }
    }
  }
}

template <bool kSlab>
__global__ void __launch_bounds__(kThreads) dense_counts_kernel(const Args a) {
  __shared__ __align__(16) int32_t s_src[kTile][kStride];
  __shared__ __align__(16) int32_t s_dst[kTile][kStride];
  __shared__ int32_t red[3][kWarps];

  const int q = blockIdx.z;
  // blocks per segment: a segment (K4: bs src rows; K6: a slab tile) is
  // covered by whole blocks, the last one masked where the segment ends
  const int nbs = (a.bs + kTile - 1) / kTile;
  const int nbd = (a.bd + kTile - 1) / kTile;
  const int seg_i = blockIdx.y / nbs;
  const int seg_j = blockIdx.x / nbd;
  const int row0 = seg_i * a.bs + (blockIdx.y - seg_i * nbs) * kTile;
  const int col0 = seg_j * a.bd + (blockIdx.x - seg_j * nbd) * kTile;
  const int rows = min(kTile, (seg_i + 1) * a.bs - row0);
  const int cols = min(kTile, (seg_j + 1) * a.bd - col0);

  const size_t be_mat = kSlab ? (size_t)q * (a.ns_pad / a.bs) + seg_i : (size_t)q;
  const size_t bi_mat = kSlab ? (size_t)q * (a.nd_pad / a.bd) + seg_j : (size_t)q;
  const int8_t* ae = a.a_e + (size_t)row0 * a.de;
  const int8_t* be = a.b_e + (be_mat * a.nd_pad + col0) * a.de;
  const int8_t* bi = a.b_i + (bi_mat * a.ns_pad + row0) * a.di;
  const int8_t* ai = a.a_i + (size_t)col0 * a.di;

  int32_t acc_e[kNTiles][4], acc_i[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_e[j][c] = acc_i[j][c] = 0;
  }
  // egress: the src block is the target side (a_e); ingress: the dst block
  contract(ae, be, a.de, rows, cols, s_src, s_dst, acc_e);
  contract(bi, ai, a.di, rows, cols, s_src, s_dst, acc_i);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int c_in = 0, c_eg = 0, c_co = 0;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = frag_row(warp, lane, c) < rows && frag_col(warp, lane, j, c) < cols;
      const bool eg = live && acc_e[j][c] > 0;
      const bool in = live && acc_i[j][c] > 0;
      c_in += in;
      c_eg += eg;
      c_co += in && eg;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c_in += __shfl_down_sync(0xffffffffu, c_in, off);
    c_eg += __shfl_down_sync(0xffffffffu, c_eg, off);
    c_co += __shfl_down_sync(0xffffffffu, c_co, off);
  }
  if (lane == 0) {
    red[0][warp] = c_in;
    red[1][warp] = c_eg;
    red[2][warp] = c_co;
  }
  __syncthreads();
  if (tid < 3) {
    int32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[tid][w];
    if (total != 0) {
      atomicAdd(&a.counts[((size_t)q * (a.ns_pad / a.bs) + seg_i) * 3 + tid], total);
    }
  }
}

template <bool kSlab>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.nd_pad / a.bd) * ((a.bd + kTile - 1) / kTile),
                  (a.ns_pad / a.bs) * ((a.bs + kTile - 1) / kTile), a.q);
  if (grid.x > 2147483647u || grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  dense_counts_kernel<kSlab><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// --- K5: wgmma fed by TMA ----------------------------------------------------

namespace k5 {

constexpr int kM = 128;                 // src rows per block: two consumer warpgroups
constexpr int kN = 256;                 // dst cols per block
constexpr int kPieces = kN / 64;        // 64-pod dst blocks (ingress flags) per block
constexpr int kK = 128;                 // bytes of depth per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kGroup = 16;              // src row tiles per raster group
constexpr int kBox = 64 * kK;           // one 64-row box, 8 KB
constexpr int kABytes = 2 * kBox;       // src rows of a stage
constexpr int kBBytes = kPieces * kBox; // dst rows of a stage
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + the 1,024-byte alignment of the swizzle
constexpr int kBlockThreads = 384;      // warpgroups 0, 1: consumers; 2: producer
constexpr int kConsumers = 256;
constexpr int kAcc = kN / 2;            // s32 accumulators per thread (m64n256)

struct Params {
  const int32_t* nz_e;  // [ns_pad / 64, nk_e] egress (src block, chunk) flags
  const int32_t* nz_i;  // [nd_pad / 64, nk_i] ingress (dst block, chunk) flags
  int32_t* counts;      // [q, ns_pad / bs, 3]
  int ns_pad, nd_pad, live_e, live_i, kt_e, kt_i, nk_e, nk_i, bs, n_x, n_y;
};

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

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 128 bytes, 8-row groups 1,024 bytes apart), starting `p`; a
// step of 32 bytes of depth inside the swizzle row adds 32 to `p`.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
// shared)^T, s32: the warpgroup's 64 src rows against the block's 256 dst
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
// block (consumer warpgroup w), ingress per dst block (j of the block's
// four); a block past the pod axis is never kept.
__device__ __forceinline__ bool eg_flag(const Params& p, int row0, int w, int c) {
  const int b = row0 / 64 + w;
  return b < p.ns_pad / 64 && __ldg(p.nz_e + (size_t)b * p.nk_e + c) != 0;
}
__device__ __forceinline__ bool in_flag(const Params& p, int col0, int j, int c) {
  const int b = col0 / 64 + j;
  return b < p.nd_pad / 64 && __ldg(p.nz_i + (size_t)b * p.nk_i + c) != 0;
}

// One direction's walk over its kept stages, identical in every role:
// calls stage(k0, mine) for each stage of 128 bytes of depth [k0, k0 +
// 128) below the live depth in a chunk that some consumer needs, where
// bit w of `mine` says whether consumer warpgroup w contracts it (egress:
// its src block's flag; ingress: both, when any of the four dst blocks'
// flags is set).
template <bool kIngress, typename F>
__device__ __forceinline__ void walk(const Params& p, int row0, int col0, F&& stage) {
  const int live = kIngress ? p.live_i : p.live_e;
  const int kt = kIngress ? p.kt_i : p.kt_e;
  for (int c0 = 0, c = 0; c0 < live; c0 += kt, ++c) {
    uint32_t mine;
    if (kIngress) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPieces; ++j) any = any || in_flag(p, col0, j, c);
      mine = any ? 3u : 0u;
    } else {
      mine = (uint32_t)eg_flag(p, row0, 0, c) | (uint32_t)eg_flag(p, row0, 1, c) << 1;
    }
    if (mine == 0) continue;
    const int c1 = min(c0 + kt, live);
    for (int k0 = c0; k0 < c1; k0 += kK) stage(k0, mine);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    chunked_counts_kernel(const __grid_constant__ CUtensorMap tm_ae,
                          const __grid_constant__ CUtensorMap tm_be,
                          const __grid_constant__ CUtensorMap tm_bi,
                          const __grid_constant__ CUtensorMap tm_ai, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int32_t red[2][3][4];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  // grouped raster: kGroup src row tiles at a time, dst tiles within
  const int q = blockIdx.z;
  const int per_group = kGroup * p.n_x;
  const int group = blockIdx.x / per_group;
  const int first_y = group * kGroup;
  const int rows_here = min(p.n_y - first_y, kGroup);
  const int in_group = blockIdx.x - group * per_group;
  const int row0 = (first_y + in_group % rows_here) * kM;
  const int col0 = (in_group / rows_here) * kN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      auto next = [&]() {
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      walk<false>(p, row0, col0, [&](int k0, uint32_t mine) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], __popc(mine) * kBox + kBBytes);
        if (mine & 1) tma_2d(a, &tm_ae, k0, row0, &full[stage]);
        if (mine & 2) tma_2d(a + kBox, &tm_ae, k0, row0 + 64, &full[stage]);
        tma_3d(a + kABytes, &tm_be, k0, col0, q, &full[stage]);
        next();
      });
      walk<true>(p, row0, col0, [&](int k0, uint32_t) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], kABytes + kBBytes);
        tma_3d(a, &tm_bi, k0, row0, q, &full[stage]);
        tma_2d(a + kABytes, &tm_ai, k0, col0, &full[stage]);
        next();
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int stage = 0;
    uint32_t phase = 0;
    int32_t acc[kAcc];
    uint32_t eg_bits[kAcc / 32];
    const int off_a = wg * kBox;  // this warpgroup's 64 src rows in the stage

    // one stage: wait for its data, run this warpgroup's products on it,
    // release it.  The four wgmmas sit under no branch of their own: ptxas
    // serializes every wgmma of a kernel once one depends on a
    // data-dependent branch (C7520)
    auto consume = [&](bool mine) {
      mbar_wait(&full[stage], phase);
      if (mine) {
        const uint8_t* a = smem + stage * kStageBytes + off_a;
        const uint8_t* b = smem + stage * kStageBytes + kABytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kK / 32; ++s) {
          wgmma_n256(acc, sw128_desc(a + 32 * s), sw128_desc(b + 32 * s));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    walk<false>(p, row0, col0, [&](int, uint32_t mine) { consume(mine >> wg & 1); });
#pragma unroll
    for (int j = 0; j < kAcc / 32; ++j) {
      uint32_t m = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) m |= (uint32_t)(acc[32 * j + b] > 0) << b;
      eg_bits[j] = m;
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    walk<true>(p, row0, col0, [&](int, uint32_t mine) { consume(mine >> wg & 1); });

    // accumulator register i of thread t holds the cell (row 16 (t / 32) +
    // (t % 32) / 4 + 8 ((i / 2) % 2), col 8 (i / 4) + 2 (t % 4) + i % 2) of
    // the warpgroup's 64 x 256 tile in both directions, so the verdicts
    // combine bit by bit; cells past the pod axes hold zero sums
    int c_in = 0, c_eg = 0, c_co = 0;
#pragma unroll
    for (int j = 0; j < kAcc / 32; ++j) {
      uint32_t in = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) in |= (uint32_t)(acc[32 * j + b] > 0) << b;
      c_in += __popc(in);
      c_eg += __popc(eg_bits[j]);
      c_co += __popc(in & eg_bits[j]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c_in += __shfl_down_sync(0xffffffffu, c_in, off);
      c_eg += __shfl_down_sync(0xffffffffu, c_eg, off);
      c_co += __shfl_down_sync(0xffffffffu, c_co, off);
    }
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    if (lane == 0) {
      red[wg][0][warp] = c_in;
      red[wg][1][warp] = c_eg;
      red[wg][2][warp] = c_co;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
    const int r = row0 + 64 * wg;
    if ((threadIdx.x & 127) < 3 && r < p.ns_pad) {
      const int v = threadIdx.x & 127;
      const int32_t total = red[wg][v][0] + red[wg][v][1] + red[wg][v][2] + red[wg][v][3];
      if (total != 0) {
        atomicAdd(&p.counts[((size_t)q * (p.ns_pad / p.bs) + r / p.bs) * 3 + v], total);
      }
    }
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

// An int8 tensor map of `rank` (2 or 3) dims, innermost first, with the
// 128-byte swizzle; reads past `dims` fill with zeros.
bool make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
              const uint64_t* strides, const uint32_t* box) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t gbox[3], estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) gstride[i] = strides[i];
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), gdim, gstride,
                gbox, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace k5

// returned when a tensor map cannot be encoded (no cudaError_t has it)
constexpr int kErrTensorMap = -1;

}  // namespace

// Launch K4 (slab == 0) or K6 (slab != 0) on `stream`.  Depths de, di are
// in bytes, multiples of 32.  K4: bs and bd multiples of 64.  Operands
// 16-byte aligned.  `counts` must be zero-filled by the caller.  Returns 0
// or a cudaError_t code.
extern "C" int cyclonus_dense_counts(const void* a_e, const void* b_e, const void* b_i,
                                     const void* a_i, void* counts, int q, int ns_pad, int nd_pad,
                                     int de, int di, int bs, int bd, int slab, void* stream) {
  if (q < 1 || q > 65535 || ns_pad < 1 || nd_pad < 1 || bs < 1 || bd < 1 || ns_pad % bs != 0 ||
      nd_pad % bd != 0 || de < 32 || di < 32 || de % 32 != 0 || di % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (!slab && (bs % kTile != 0 || bd % kTile != 0)) return (int)cudaErrorInvalidValue;
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const Args a{i8(a_e), i8(b_e), i8(b_i), i8(a_i), static_cast<int32_t*>(counts),
               q, ns_pad, nd_pad, de, di, bs, bd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return slab ? launch<true>(a, s) : launch<false>(a, s);
}

// Launch K5 on `stream`.  a_e [ns_pad, de], b_e [q, nd_pad, de], b_i [q,
// ns_pad, di], a_i [nd_pad, di] int8, 16-byte aligned; nz_e [ns_pad / 64,
// de / kt_e] and nz_i [nd_pad / 64, di / kt_i] int32 flags.  de, di are
// the row pitches (multiples of the chunks kt_e, kt_i, themselves
// multiples of 128); live_e <= de and live_i <= di the depths that can
// hold data, multiples of 32: nothing past them is read.  ns_pad a
// multiple of bs, bs and nd_pad multiples of 64.  `counts` [q, ns_pad /
// bs, 3] must be zero-filled by the caller.  Returns 0, a cudaError_t code
// or -1 (a tensor map could not be encoded).
extern "C" int cyclonus_dense_counts_chunked(const void* a_e, const void* b_e, const void* b_i,
                                             const void* a_i, const void* nz_e,
                                             const void* nz_i, void* counts, int q, int ns_pad,
                                             int nd_pad, int de, int di, int live_e, int live_i,
                                             int kt_e, int kt_i, int bs, void* stream) {
  using namespace k5;
  if (q < 1 || q > 65535 || ns_pad < 64 || nd_pad < 64 || bs < 64 || bs % 64 != 0 ||
      ns_pad % bs != 0 || nd_pad % 64 != 0 || kt_e < 128 || kt_i < 128 || kt_e % 128 != 0 ||
      kt_i % 128 != 0 || de % kt_e != 0 || di % kt_i != 0 || live_e < 32 || live_i < 32 ||
      live_e % 32 != 0 || live_i % 32 != 0 || live_e > de || live_i > di ||
      nz_e == nullptr || nz_i == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const void* operands[4] = {a_e, b_e, b_i, a_i};
  for (const void* ptr : operands) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tm_ae, tm_be, tm_bi, tm_ai;
  const uint64_t ae_dims[2] = {(uint64_t)live_e, (uint64_t)ns_pad};
  const uint64_t ae_strides[1] = {(uint64_t)de};
  const uint32_t box_64[3] = {kK, 64, 1};
  const uint64_t be_dims[3] = {(uint64_t)live_e, (uint64_t)nd_pad, (uint64_t)q};
  const uint64_t be_strides[2] = {(uint64_t)de, (uint64_t)nd_pad * de};
  const uint32_t box_n[3] = {kK, kN, 1};
  const uint64_t bi_dims[3] = {(uint64_t)live_i, (uint64_t)ns_pad, (uint64_t)q};
  const uint64_t bi_strides[2] = {(uint64_t)di, (uint64_t)ns_pad * di};
  const uint32_t box_m[3] = {kK, kM, 1};
  const uint64_t ai_dims[2] = {(uint64_t)live_i, (uint64_t)nd_pad};
  const uint64_t ai_strides[1] = {(uint64_t)di};
  if (!make_map(&tm_ae, a_e, 2, ae_dims, ae_strides, box_64) ||
      !make_map(&tm_be, b_e, 3, be_dims, be_strides, box_n) ||
      !make_map(&tm_bi, b_i, 3, bi_dims, bi_strides, box_m) ||
      !make_map(&tm_ai, a_i, 2, ai_dims, ai_strides, box_n)) {
    return kErrTensorMap;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunked_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_x = (nd_pad + kN - 1) / kN, n_y = (ns_pad + kM - 1) / kM;
  const Params p{static_cast<const int32_t*>(nz_e), static_cast<const int32_t*>(nz_i),
                 static_cast<int32_t*>(counts), ns_pad, nd_pad, live_e, live_i, kt_e, kt_i,
                 de / kt_e, di / kt_i, bs, n_x, n_y};
  const dim3 grid((unsigned)n_x * (unsigned)n_y, 1, q);
  chunked_counts_kernel<<<grid, kBlockThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_ae, tm_be, tm_bi, tm_ai, p);
  return (int)cudaGetLastError();
}

// Registers, static and dynamic shared memory and local (spill) bytes per
// thread of each kernel instance: 0 = K4, 1 = K5, 2 = K6.  Returns 0 or a
// cudaError_t code.
extern "C" int cyclonus_dense_kernel_attrs(int which, int* regs, int* smem_static,
                                           int* smem_dynamic, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  int dynamic = 0;
  if (which == 0) {
    err = cudaFuncGetAttributes(&attr, dense_counts_kernel<false>);
  } else if (which == 1) {
    err = cudaFuncGetAttributes(&attr, k5::chunked_counts_kernel);
    dynamic = k5::kSmem;
  } else if (which == 2) {
    err = cudaFuncGetAttributes(&attr, dense_counts_kernel<true>);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_static = (int)attr.sharedSizeBytes;
  *smem_dynamic = dynamic;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

extern "C" const char* cyclonus_dense_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed or is unavailable";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
