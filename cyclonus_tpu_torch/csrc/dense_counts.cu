// Dense (int8) verdict-count kernels for Hopper (sm_90a): K4, K5 and K6.
//
// Replaces the TPU kernels of the reference's dense dtype plan
// (CYCLONUS_PACK=0) in cyclonus_tpu/engine/pallas_kernel.py:
//   * K4 single-chunk (kSkip = false, kSlab = false):
//        _make_verdict_counts_kernel_1chunk, launched by
//        _verdict_counts_pallas_rect when both directions' augmented target
//        axes fit one chunk;
//   * K5 chunked (kSkip = true): _make_verdict_counts_kernel, the same
//        contraction over several target chunks, skipping a (pod block,
//        chunk) pair whose match operand is all zero (the reference's nz
//        maps);
//   * K6 target slabs (kSlab = true): _make_verdict_counts_kernel_slab via
//        verdict_counts_pallas_slab_from_ops, the contraction over each
//        (src tile, dst tile) pair's w_aug-row target window.
//
// Per cell (s, d) of port case q, all operands 0/1 int8 with the target
// (contraction) axis innermost:
//   acc_e = sum_t a_e[s, t] * b_e[q, d, t]      egress
//   acc_i = sum_t b_i[q, s, t] * a_i[d, t]      ingress
//   egress = acc_e > 0, ingress = acc_i > 0, combined = egress && ingress
// The wrapper (engine/dense_kernel.py) appends one pseudo-target row per
// direction that matches the valid pods without a target and allows the
// valid pods, and zeroes invalid pod columns, so `acc > 0` is the whole
// verdict and an invalid pod counts nothing.  K6's operands are the same
// rows gathered per slab tile: b_e depends on the src tile as well as q,
// b_i on the dst tile.  Counts reduce into one int32 partial per (q, src
// segment): K4/K5 segments are `bs` rows, K6 segments its slab src tiles.
//
// What bounds it: the reference contracts on the TPU's int8 matrix unit; on
// Hopper the least time for its multiply-adds over the live pods and the
// target rows that hold data (not the rows that pad a chunk or a window) is
// the int8 tensor-core rate (1.979e15 operations/s dense, two per
// multiply-add, reached only by wgmma), against the operand bytes over
// 3.35e12 B/s.  This version is
// simple and right, not fast: the tensor cores through the warp-level
// mma.sync m16n8k32 s8 -> s32 instruction, fed from shared memory that a
// plain load/store loop fills, with no copy/compute overlap.
//   * one block per (q, 64 src rows, 64 dst cols), 256 threads = 8 warps;
//     warp w owns rows 16 (w % 4) .. +16 and cols 32 (w / 4) .. +32 of the
//     block as four m16n8 accumulator tiles per direction (16 registers);
//   * each direction loops over its own depth, staging 32 words (128 int8
//     values) per row of the block's src and dst rows in shared memory per
//     pass with 16-byte loads and stores, target axis innermost, so each
//     fragment register is one 32-bit shared load (row stride 36 words: the
//     32 lanes of a fragment load hit 32 different banks);
//   * K5 reads its own nz flag for each (block, target chunk) and skips the
//     staging and the math of an all-zero chunk; the flags come from the
//     augmented operand, so the chunk that holds the pseudo row is kept
//     whenever the row is not all zero;
//   * K6's blocks never straddle two slab tiles (their windows differ): a
//     tile narrower than 64 rows or columns leaves the rest of the block
//     masked, so the kernel takes any tile width;
//   * counts reduce with warp shuffles, then one atomicAdd per block and
//     verdict; integer sums are exact in any order.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  const int32_t* nz_e;  // K5: [ns_pad / 64, de / kt_e] egress block flags
  const int32_t* nz_i;  // K5: [nd_pad / 64, di / kt_i] ingress block flags
  int32_t* counts;      // [q, ns_pad / bs, 3]: ingress, egress, combined
  int q, ns_pad, nd_pad, de, di, kt_e, kt_i, bs, bd;
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
// With kSkip, `nz` holds one flag per chunk of `kt` bytes (a multiple of
// 128) and a zero flag skips that chunk.
template <bool kSkip>
__device__ __forceinline__ void contract(const int8_t* __restrict__ src,
                                         const int8_t* __restrict__ dst, int depth, int kt,
                                         const int32_t* __restrict__ nz, int rows, int cols,
                                         int32_t (*s_src)[kStride], int32_t (*s_dst)[kStride],
                                         int32_t (&acc)[kNTiles][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ar = (warp & 3) * 16 + g;  // A fragment rows ar, ar + 8
  const int bc = (warp >> 2) * 32 + g;  // B fragment cols bc + 8 j
  const int words = depth / 4;
  const int chunk = kSkip ? kt / 4 : words;
  for (int c0 = 0; c0 < words; c0 += chunk) {
    if (kSkip && nz[c0 / chunk] == 0) continue;  // the same flag for every thread
    const int c1 = min(c0 + chunk, words);
    for (int k0 = c0; k0 < c1; k0 += kPass) {
      const int nw = min(kPass, c1 - k0);  // a multiple of 8 words
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
}

template <bool kSkip, bool kSlab>
__global__ void __launch_bounds__(kThreads) dense_counts_kernel(const Args a) {
  __shared__ __align__(16) int32_t s_src[kTile][kStride];
  __shared__ __align__(16) int32_t s_dst[kTile][kStride];
  __shared__ int32_t red[3][kWarps];

  const int q = blockIdx.z;
  // blocks per segment: a segment (K4/K5: bs src rows; K6: a slab tile) is
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
  // egress: the src block is the target side (a_e), skip keyed on it
  contract<kSkip>(ae, be, a.de, a.kt_e,
                  kSkip ? a.nz_e + (size_t)(row0 / kTile) * (a.de / a.kt_e) : nullptr, rows,
                  cols, s_src, s_dst, acc_e);
  // ingress: the dst block is the target side (a_i), skip keyed on it
  contract<kSkip>(bi, ai, a.di, a.kt_i,
                  kSkip ? a.nz_i + (size_t)(col0 / kTile) * (a.di / a.kt_i) : nullptr, rows,
                  cols, s_src, s_dst, acc_i);

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

template <bool kSkip, bool kSlab>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.nd_pad / a.bd) * ((a.bd + kTile - 1) / kTile),
                  (a.ns_pad / a.bs) * ((a.bs + kTile - 1) / kTile), a.q);
  if (grid.x > 2147483647u || grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  dense_counts_kernel<kSkip, kSlab><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K4 (slab == 0, nz_e == nz_i == null), K5 (slab == 0, both nz maps
// set) or K6 (slab != 0) on `stream`.  Depths de, di are in bytes, multiples
// of 32; K5's chunks kt_e, kt_i are multiples of 128 that divide them.
// K4/K5: bs and bd multiples of 64.  Operands 16-byte aligned.  `counts`
// must be zero-filled by the caller.  Returns 0 or a cudaError_t code.
extern "C" int cyclonus_dense_counts(const void* a_e, const void* b_e, const void* b_i,
                                     const void* a_i, const void* nz_e, const void* nz_i,
                                     void* counts, int q, int ns_pad, int nd_pad, int de, int di,
                                     int kt_e, int kt_i, int bs, int bd, int slab,
                                     void* stream) {
  const bool skip = nz_e != nullptr || nz_i != nullptr;
  if (q < 1 || q > 65535 || ns_pad < 1 || nd_pad < 1 || bs < 1 || bd < 1 || ns_pad % bs != 0 ||
      nd_pad % bd != 0 || de < 32 || di < 32 || de % 32 != 0 || di % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (!slab && (bs % kTile != 0 || bd % kTile != 0)) return (int)cudaErrorInvalidValue;
  if (skip && (slab || nz_e == nullptr || nz_i == nullptr || kt_e < 128 || kt_i < 128 ||
               kt_e % 128 != 0 || kt_i % 128 != 0 || de % kt_e != 0 || di % kt_i != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const Args a{i8(a_e), i8(b_e), i8(b_i), i8(a_i), static_cast<const int32_t*>(nz_e),
               static_cast<const int32_t*>(nz_i), static_cast<int32_t*>(counts),
               q, ns_pad, nd_pad, de, di, kt_e, kt_i, bs, bd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab) return launch<false, true>(a, s);
  return skip ? launch<true, false>(a, s) : launch<false, false>(a, s);
}

extern "C" const char* cyclonus_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
