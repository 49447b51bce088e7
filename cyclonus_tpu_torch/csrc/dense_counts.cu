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

#include "wgmma_ring.cuh"

namespace {

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
  uint8_t* smem = block_setup<kK>(smem_raw, full, empty, held, !kSkip);

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
    contract<kSkip, false, kK, false>(p, x, smem, full, empty, ring, wg, acc);
    verdict_bits(acc, eg_bits);
    contract<kSkip, true, kK, false>(p, x, smem, full, empty, ring, wg, acc);
    count_cells(p, x, wg, ct, acc, eg_bits, c_in, c_eg, c_co);
    held.counts[0][ct] = c_in;
    held.counts[1][ct] = c_eg;
    held.counts[2][ct] = c_co;
    flush(p, seg, wg, ct, held, true);
    return;
  }
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    contract<kSkip, false, kK, false>(p, item_at(p, opaque(it)), smem, full, empty, ring, wg, acc);
    verdict_bits(acc, eg_bits);
#pragma unroll
    for (int j = 0; j < kAcc / 32; ++j) held.eg_bits[j][ct] = eg_bits[j];
    contract<kSkip, true, kK, false>(p, item_at(p, opaque(it)), smem, full, empty, ring, wg, acc);
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

// Encode the four tensor maps (each direction's ends at its live depth)
// and launch.  K5 takes one block per item: its items' work varies with
// the skip, and persistent blocks striding through them drift apart in the
// item order until the tiles they share no longer fit in L2 (measured on
// the H100: PERF.md).  K4 and K6, whose items are alike, run persistent.
template <bool kSkip, int kK>
int launch(const void* a_e, const void* b_e, const void* b_i, const void* a_i, int q,
           int de, int di, const Params& p, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_maps<kK>(maps, a_e, b_e, b_i, a_i, q, de, di, p)) return kErrTensorMap;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_counts_kernel<kSkip, kK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int grid = p.items;
  if (!kSkip) {
    const cudaError_t err = persistent_grid(p.items, &grid);
    if (err != cudaSuccess) return (int)err;
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
  // without the skip, one chunk of the live depth
  if (!init_params(p, q, n_i, n_j, tile_rows, tile_cols, seg_rows, live_e, live_i,
                   skip ? kt_e : live_e, skip ? kt_i : live_i, skip ? de / kt_e : 0,
                   skip ? di / kt_i : 0)) {
    return (int)cudaErrorInvalidValue;
  }
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
