// Packed verdict-count kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel cyclonus_tpu/engine/pallas_kernel.py
// _make_packed_kernel (launched by _verdict_counts_pallas_packed) in its
// four variants, epilogue x tiers:
//   * plain    (K1): validity-masked allow counts of ingress / egress /
//                    combined, one int32 partial per (port case, src tile
//                    of `bs` rows) -> out [Q, ns_pad / bs, 3] int32;
//   * weighted (K2): per-src-row sums of each verdict weighted by w[dst]
//                    (class sizes) -> out [Q, ns_pad, 3] float32;
//   * tiered   (K3): either of the two, with each direction's verdict first
//                    resolved through the AdminNetworkPolicy -> NetworkPolicy
//                    -> BaselineAdminNetworkPolicy precedence lattice.
//
// Per cell (s, d) of port case q, with the target axis packed 32 per word:
//   acc_e = OR_w (a_e[s, w] & b_e[q, w, d])     egress contraction
//   acc_i = OR_w (b_i[q, s, w] & a_i[w, d])     ingress contraction
//   egress  = !has_s || acc_e != 0
//   ingress = !has_d || acc_i != 0
//   combined = egress && ingress
// Flags words (bit 0 = has_target, bit 1 = valid) sit at a_e[s, we] and
// a_i[wi, d].
//
// Tiered: the tier rows are packed 32 per word too, laid out like the
// contraction operand of the same side (egress subject = src pod, peer =
// dst pod; ingress the other way round).  Per cell and direction
//   anp  = min over rows g with subject[g] & peer[g, q] of keys[0][g]
//   banp = the same over keys[1][g]      (kKeyNone when no row matches)
// where a key is rank * 4 + action, so key & 3 is the winning action; then
//   verdict = ANP Allow/Deny if anp decides, else the NetworkPolicy verdict
//             where a target selects the subject, else BANP Allow/Deny,
//             else allow                             (resolve_tier below).
// Pad rows carry kKeyNone in both key vectors, so a pad row that matches
// changes nothing.
//
// What bounds it: the operands are small (about 10 MB at 100k pods) and
// are re-read from L2, so the card is bound by 32-bit integer logic on
// the CUDA cores: one LOP3 (AND then OR) per word per cell and direction,
// plus a few epilogue ops per cell, all on the integer pipe (64 lanes per
// clock and SM on Hopper, half the float32 lane count).  The design keeps
// that loop tight:
//   * one block per (q, 64-src-row tile, 128-dst-col tile), 256 threads;
//   * the tile's src-side and dst-side words are staged in shared memory
//     word-major, kChunk words per side at a time, so a warp reads one src
//     word as a broadcast and 32 consecutive dst words without bank
//     conflicts, and shared memory stays at a fixed 25 KB however deep the
//     word axis is (the accumulators carry across the chunks);
//   * each thread keeps an 8 x 4 cell block of both OR-accumulators in
//     registers, so each shared-memory load feeds 4 or 8 LOP3s; tiered,
//     the verdicts then fold into one 32-bit mask per direction, which
//     frees the accumulators before the tier epilogue;
//   * the tier epilogue (K3) spends its work where a tier row can change a
//     verdict.  When both directions' tier words fit one pass (kTierPass
//     words, 256 rows, per direction) they and both key vectors are
//     staged in their own shared memory once per block, before the main
//     loop, with facts per word computed once (one warp each): the rows
//     with a real anp / banp key, whether each vector's real keys are
//     non-decreasing in bit order, their least and greatest key, and the
//     real rows that some subject and some peer of the block hold.  A
//     direction with no such row in the block is skipped whole (the
//     benchmark lattice's egress pads).  Where a direction's keys are in
//     order across its words (the engine emits rows rank by rank, ANP
//     before BANP, so its keys always are), a cell's min key is its first
//     matching row's, so the lattice runs bit-parallel over the thread's
//     32 cells: each live row, in order, decides the cells it matches that
//     no earlier row of its tier decided (one AND of a row mask and a
//     column mask per row, no per-cell work).  Otherwise each cell takes
//     its min key per word — for a sorted word the key of the first set
//     bit of subject & peer & real (O(1), __ffs), for an unsorted one a
//     walk over the set bits with keys read from shared memory (uniform
//     per word) — and a cell that no real row matches keeps its
//     NetworkPolicy bit with no lattice.  No barrier in either.  Past one
//     pass, each src row walks every pass, staging it again, so any row
//     count launches;
//   * counts reduce with warp shuffles, then one atomic per block (K1) or
//     one atomic per src row and verdict (K2).  Integer counts are exact
//     in any order; K2's float partials are integers below 2^24 (the
//     caller's gate), so they are exact in any order too.
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSrcTile = 64;
constexpr int kDstTile = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kSrcTile / kWarps;  // src rows per thread
constexpr int kCols = kDstTile / 32;      // dst cols per thread
constexpr int kChunk = 16;                // words per side staged per pass

// tier lattice codes (engine/encoding.py TIER_ACT_*, TIER_KEY_NONE)
constexpr int kActNone = 0;
constexpr int kActAllow = 1;
constexpr int kActPass = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kKeyNone = 1 << 30;

__device__ __forceinline__ bool resolve_tier(bool np_allowed, bool has, int32_t anp,
                                             int32_t banp) {
  const int anp_act = anp < kKeyNone ? (anp & 3) : kActNone;
  const int banp_act = banp < kKeyNone ? (banp & 3) : kActNone;
  const bool below = has ? np_allowed : (banp_act == kActNone || banp_act == kActAllow);
  return (anp_act == kActNone || anp_act == kActPass) ? below : anp_act == kActAllow;
}

// ---- the tier epilogue (K3) ----

constexpr int kTierPass = 8;  // tier words per direction staged at a time (256 rows)

// One pass of tier words and their keys in shared memory, with facts per
// word computed once per block (tier_meta).  Direction index 0 = egress
// (subject = src row, peer = dst col), 1 = ingress (subject = dst col,
// peer = src row); key vector 0 = anp, 1 = banp.
struct TierSmem {
  int32_t se[kTierPass][kSrcTile];    // egress subjects by src row
  int32_t pi[kTierPass][kSrcTile];    // ingress peers by src row
  int32_t pe[kTierPass][kDstTile];    // egress peers by dst col
  int32_t si[kTierPass][kDstTile];    // ingress subjects by dst col
  int32_t key[2][2][32 * kTierPass];  // [direction][anp, banp][row of the pass]
  uint32_t real[2][2][kTierPass];     // rows whose anp / banp key is real
  uint32_t live[2][kTierPass];        // real rows held by a subject and a peer of the block
  uint32_t sorted[2][kTierPass];      // bit v: key vector v non-decreasing over its real rows
  int32_t lo[2][2][kTierPass];        // first and last real key of each vector (its
  int32_t hi[2][2][kTierPass];        // least and greatest where it is sorted)
};

// Declared here, not in the kernel, so only the tiered instances hold it.
__device__ __forceinline__ TierSmem& tier_smem() {
  __shared__ TierSmem s;
  return s;
}

struct TierArgs {
  const int32_t* se;  // block's first src row of t_se [ns_pad, wge]
  const int32_t* pe;  // block's first dst col of t_pe[q] [wge, nd_pad]
  const int32_t* si;  // block's first dst col of t_si [wgi, nd_pad]
  const int32_t* pi;  // block's first src row of t_pi[q] [ns_pad, wgi]
  const int32_t* keys_e;  // [2, 32 * wge]
  const int32_t* keys_i;  // [2, 32 * wgi]
  int wge, wgi, nd_pad;
};

// 4-byte copy global -> shared that does not wait for the load: the copies
// of one stage_tier complete at cp_async_wait
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the tier words [k0, k0 + kTierPass) of both directions and
// their keys into shared memory (every thread takes part); they are there
// for every thread after cp_async_wait and a barrier.
__device__ __forceinline__ void stage_tier(TierSmem& ts, const TierArgs& t, int k0) {
  const int tid = threadIdx.x;
  const int ne = min(kTierPass, max(t.wge - k0, 0));
  const int ni = min(kTierPass, max(t.wgi - k0, 0));
  for (int idx = tid; idx < kSrcTile * ne; idx += kThreads) {
    const int r = idx / ne, k = idx - r * ne;
    cp_async4(&ts.se[k][r], t.se + (size_t)r * t.wge + k0 + k);
  }
  for (int idx = tid; idx < kSrcTile * ni; idx += kThreads) {
    const int r = idx / ni, k = idx - r * ni;
    cp_async4(&ts.pi[k][r], t.pi + (size_t)r * t.wgi + k0 + k);
  }
  for (int idx = tid; idx < kDstTile * ne; idx += kThreads) {
    const int k = idx / kDstTile, c = idx - k * kDstTile;
    cp_async4(&ts.pe[k][c], t.pe + (size_t)(k0 + k) * t.nd_pad + c);
  }
  for (int idx = tid; idx < kDstTile * ni; idx += kThreads) {
    const int k = idx / kDstTile, c = idx - k * kDstTile;
    cp_async4(&ts.si[k][c], t.si + (size_t)(k0 + k) * t.nd_pad + c);
  }
  for (int idx = tid; idx < 64 * ne; idx += kThreads) {
    const int v = idx / (32 * ne), g = idx - v * 32 * ne;
    cp_async4(&ts.key[0][v][g], t.keys_e + (size_t)v * 32 * t.wge + 32 * k0 + g);
  }
  for (int idx = tid; idx < 64 * ni; idx += kThreads) {
    const int v = idx / (32 * ni), g = idx - v * 32 * ni;
    cp_async4(&ts.key[1][v][g], t.keys_i + (size_t)v * 32 * t.wgi + 32 * k0 + g);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Per staged word (one warp each): the rows with a real key per key
// vector, whether each vector's real keys are non-decreasing in bit order
// (then the min over any set of rows is the key of its first row) with
// its first and last real key, and the real rows that some subject and
// some peer of the block hold (a row outside them matches no cell of the
// block).  After the staged words are visible to every thread.
__device__ __forceinline__ void tier_meta(TierSmem& ts, int ne, int ni) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int task = warp; task < ne + ni; task += kWarps) {
    const int d = task < ne ? 0 : 1;
    const int k = task < ne ? task : task - ne;
    uint32_t real[2], sorted = 0;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int32_t key = ts.key[d][v][32 * k + lane];
      const bool is_real = key < kKeyNone;
      real[v] = __ballot_sync(kFull, is_real);
      // each real key against the nearest real key below it
      const uint32_t below = real[v] & ((1u << lane) - 1);
      const int32_t prev = __shfl_sync(kFull, key, below ? 31 - __clz(below) : lane);
      sorted |= (uint32_t)__all_sync(kFull, !is_real || prev <= key) << v;
      const int32_t lo = __shfl_sync(kFull, key, real[v] ? __ffs(real[v]) - 1 : 0);
      const int32_t hi = __shfl_sync(kFull, key, real[v] ? 31 - __clz(real[v]) : 0);
      if (lane == 0) {
        ts.lo[d][v][k] = lo;
        ts.hi[d][v][k] = hi;
      }
    }
    const int32_t(*rows)[kSrcTile] = d == 0 ? ts.se : ts.pi;
    const int32_t(*cols)[kDstTile] = d == 0 ? ts.pe : ts.si;
    const uint32_t r_or = __reduce_or_sync(kFull, (uint32_t)(rows[k][lane] | rows[k][lane + 32]));
    const uint32_t c_or = __reduce_or_sync(
        kFull, (uint32_t)(cols[k][lane] | cols[k][lane + 32] | cols[k][lane + 64] |
                          cols[k][lane + 96]));
    if (lane == 0) {
      ts.real[d][0][k] = real[0];
      ts.real[d][1][k] = real[1];
      ts.live[d][k] = r_or & c_or & (real[0] | real[1]);
      ts.sorted[d][k] = sorted;
    }
  }
}

// True when each key vector of direction d is non-decreasing over its
// real rows across the n staged words, in word then bit order: then the
// first matching row of a cell holds its min key.
__device__ __forceinline__ bool keys_in_order(const TierSmem& ts, int d, int n) {
  bool ok = true;
  int32_t top[2] = {INT32_MIN, INT32_MIN};
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (ts.real[d][v][k] == 0) continue;
      ok = ok && (ts.sorted[d][k] >> v & 1) && ts.lo[d][v][k] >= top[v];
      top[v] = ts.hi[d][v][k];
    }
  }
  return ok;
}

// Direction kDir of the thread's 32 cells (bit r * kCols + c) when its
// keys are in order (keys_in_order): each live row, in order, decides the
// cells it matches that no earlier row of its tier has decided — the
// lattice bit-parallel over the cells, with no per-cell min.  `np` holds
// the NetworkPolicy verdicts, `has` the cells whose subject some target
// selects; returns the lattice's verdicts.
template <int kDir>
__device__ __forceinline__ uint32_t tier_in_order(const TierSmem& ts, int n, int r0, int lane,
                                                  uint32_t np, uint32_t has) {
  uint32_t dec_a = 0, allow_a = 0, deny_a = 0, dec_b = 0, deny_b = 0;
  for (int k = 0; k < n; ++k) {
    const uint32_t live = ts.live[kDir][k];
    if (live == 0) continue;
    // lane g: the thread's src rows that hold row g, as nibbles of cells
    uint32_t rows_of = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t w = (uint32_t)(kDir == 0 ? ts.se[k][r0 + r] : ts.pi[k][r0 + r]);
      rows_of |= ((w >> lane) & 1u) * (((1u << kCols) - 1) << (kCols * r));
    }
    uint32_t col_w[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      col_w[c] = (uint32_t)(kDir == 0 ? ts.pe[k][lane + 32 * c] : ts.si[k][lane + 32 * c]);
    }
    const uint32_t ra = ts.real[kDir][0][k], rb = ts.real[kDir][1][k];
    for (uint32_t m = live; m; m &= m - 1) {
      const int g = __ffs(m) - 1;
      const uint32_t rows = __shfl_sync(kFull, rows_of, g);
      if (rows == 0) continue;  // the same for the whole warp
      uint32_t cols = 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) cols |= ((col_w[c] >> g) & 1u) * (0x11111111u << c);
      const uint32_t hit = rows & cols;
      if (ra >> g & 1) {
        const uint32_t first = hit & ~dec_a;
        const int act = ts.key[kDir][0][32 * k + g] & 3;
        dec_a |= hit;
        if (act == kActAllow) {
          allow_a |= first;
        } else if (act != kActPass && act != kActNone) {
          deny_a |= first;
        }
      }
      if (rb >> g & 1) {
        const uint32_t first = hit & ~dec_b;
        const int act = ts.key[kDir][1][32 * k + g] & 3;
        dec_b |= hit;
        if (act != kActNone && act != kActAllow) deny_b |= first;
      }
    }
  }
  // resolve_tier on every cell at once: an ANP Allow / Deny decides; else
  // the NetworkPolicy verdict where a target selects the subject, else
  // the BANP verdict (allow unless its first matching row denies)
  return allow_a | (~(allow_a | deny_a) & ((has & np) | (~has & ~deny_b)));
}

// Bit k set: staged word k of direction d has a live row.
__device__ __forceinline__ uint32_t live_words(const TierSmem& ts, int d, int n) {
  uint32_t m = 0;
  for (int k = 0; k < n; ++k) m |= (uint32_t)(ts.live[d][k] != 0) << k;
  return m;
}

// min of keys[b] over the set bits b of m; sorted: the keys are
// non-decreasing over the bits that m can hold, so the first bit's key
__device__ __forceinline__ int32_t min_key(uint32_t m, const int32_t* keys, bool sorted) {
  if (m == 0) return kKeyNone;
  if (sorted) return keys[__ffs(m) - 1];
  int32_t best = kKeyNone;
  while (m) {
    best = min(best, keys[__ffs(m) - 1]);
    m &= m - 1;
  }
  return best;
}

// Fold the staged words in `words` into the min keys of src row `row`
// (shared by the warp) and this lane's kCols dst cols, direction kDir.
template <int kDir>
__device__ __forceinline__ void tier_accumulate(const TierSmem& ts, uint32_t words, int row,
                                                int lane, int32_t (&anp)[kCols],
                                                int32_t (&banp)[kCols]) {
  for (; words; words &= words - 1) {
    const int k = __ffs(words) - 1;
    const uint32_t rbits = (uint32_t)(kDir == 0 ? ts.se[k][row] : ts.pi[k][row]) & ts.live[kDir][k];
    if (rbits == 0) continue;  // the same for the whole warp
    const uint32_t ra = ts.real[kDir][0][k], rb = ts.real[kDir][1][k];
    const uint32_t sorted = ts.sorted[kDir][k];
    const int32_t* ka = &ts.key[kDir][0][32 * k];
    const int32_t* kb = &ts.key[kDir][1][32 * k];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const uint32_t m =
          rbits & (uint32_t)(kDir == 0 ? ts.pe[k][lane + 32 * c] : ts.si[k][lane + 32 * c]);
      anp[c] = min(anp[c], min_key(m & ra, ka, sorted & 1));
      banp[c] = min(banp[c], min_key(m & rb, kb, sorted & 2));
    }
  }
}

// A cell that no real row matches (both keys kKeyNone) keeps its
// NetworkPolicy bit: resolve_tier would return !has || np_allowed, which
// is that bit already.
__device__ __forceinline__ uint32_t resolve_bits(uint32_t bits, int bit, bool has, int32_t anp,
                                                 int32_t banp) {
  if (anp == kKeyNone && banp == kKeyNone) return bits;
  const uint32_t v = resolve_tier((bits >> bit) & 1u, has, anp, banp);
  return (bits & ~(1u << bit)) | (v << bit);
}

// Direction kDir of the thread's 32 cells, any key order: per src row,
// each cell's min keys over the words in `words`, then the lattice where
// a real row matched (`has`: the cells whose subject some target selects).
template <int kDir>
__device__ __forceinline__ uint32_t tier_per_cell(const TierSmem& ts, uint32_t words, int r0,
                                                  int lane, uint32_t bits, uint32_t has) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int32_t anp[kCols], banp[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) anp[c] = banp[c] = kKeyNone;
    tier_accumulate<kDir>(ts, words, r0 + r, lane, anp, banp);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int bit = r * kCols + c;
      bits = resolve_bits(bits, bit, has >> bit & 1, anp[c], banp[c]);
    }
  }
  return bits;
}

template <bool kWeighted, bool kTiered>
__global__ void __launch_bounds__(kThreads)
packed_counts_kernel(const int32_t* __restrict__ a_e,  // [ns_pad, we + 1]
                     const int32_t* __restrict__ b_e,  // [q, we, nd_pad]
                     const int32_t* __restrict__ b_i,  // [q, ns_pad, wi]
                     const int32_t* __restrict__ a_i,  // [wi + 1, nd_pad]
                     const float* __restrict__ w,      // [nd_pad] (K2)
                     int32_t* __restrict__ counts,     // [q, ns_pad / bs, 3] (K1)
                     float* __restrict__ rowsums,      // [q, ns_pad, 3] (K2)
                     const int32_t* __restrict__ t_se,  // [ns_pad, wge] egress subjects (K3)
                     const int32_t* __restrict__ t_pe,  // [q, wge, nd_pad] egress peers
                     const int32_t* __restrict__ t_si,  // [wgi, nd_pad] ingress subjects
                     const int32_t* __restrict__ t_pi,  // [q, ns_pad, wgi] ingress peers
                     const int32_t* __restrict__ keys_e,  // [2, 32 * wge] anp, banp
                     const int32_t* __restrict__ keys_i,  // [2, 32 * wgi]
                     int ns_pad, int nd_pad, int we, int wi, int wge, int wgi, int bs) {
  __shared__ int32_t s_ae[kChunk][kSrcTile];  // egress tmatch (tier: subject) words by src row
  __shared__ int32_t s_bi[kChunk][kSrcTile];  // ingress tallow (tier: peer) words by src row
  __shared__ int32_t s_be[kChunk][kDstTile];  // egress tallow (tier: peer) words by dst col
  __shared__ int32_t s_ai[kChunk][kDstTile];  // ingress tmatch (tier: subject) words by dst col
  __shared__ int32_t s_fs[kSrcTile];          // src flags words
  __shared__ int32_t s_fd[kDstTile];          // dst flags words

  const int q = blockIdx.z;
  const int row0 = blockIdx.y * kSrcTile;
  const int col0 = blockIdx.x * kDstTile;
  const int tid = threadIdx.x;

  const int32_t* ae_t = a_e + (size_t)row0 * (we + 1);
  const int32_t* bi_t = b_i + ((size_t)q * ns_pad + row0) * wi;
  const int32_t* be_q = b_e + (size_t)q * we * nd_pad + col0;
  const int32_t* ai_t = a_i + col0;
  if (tid < kSrcTile) s_fs[tid] = ae_t[(size_t)tid * (we + 1) + we];
  if (tid < kDstTile) s_fd[tid] = ai_t[(size_t)wi * nd_pad + tid];

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = warp * kRows;  // this thread's rows r0 .. r0 + kRows - 1
                                // and columns lane + 32 * c

  // tiered: the block's tier operands (built where used, so nothing of
  // them stays live across the main loop)
  auto tier_args = [&]() {
    return TierArgs{t_se + (size_t)row0 * wge, t_pe + (size_t)q * wge * nd_pad + col0,
                    t_si + col0, t_pi + ((size_t)q * ns_pad + row0) * wgi,
                    keys_e, keys_i, wge, wgi, nd_pad};
  };
  // when both directions' tier words fit one pass, their copies into
  // shared memory start here, once, and land while the main loop runs
  if constexpr (kTiered) {
    if (wge <= kTierPass && wgi <= kTierPass) stage_tier(tier_smem(), tier_args(), 0);
  }

  int32_t acc_e[kRows][kCols];
  int32_t acc_i[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc_e[r][c] = 0;
      acc_i[r][c] = 0;
    }
  }

  const int depth = we > wi ? we : wi;
  for (int k0 = 0; k0 < depth; k0 += kChunk) {
    const int ne = min(kChunk, max(we - k0, 0));  // egress words this pass
    const int ni = min(kChunk, max(wi - k0, 0));  // ingress words this pass
    if (k0 > 0) __syncthreads();  // every read of the previous chunk is done
    for (int idx = tid; idx < kSrcTile * ne; idx += kThreads) {
      const int r = idx / ne, k = idx - r * ne;
      s_ae[k][r] = ae_t[(size_t)r * (we + 1) + k0 + k];
    }
    for (int idx = tid; idx < kSrcTile * ni; idx += kThreads) {
      const int r = idx / ni, k = idx - r * ni;
      s_bi[k][r] = bi_t[(size_t)r * wi + k0 + k];
    }
    for (int idx = tid; idx < kDstTile * ne; idx += kThreads) {
      const int k = idx / kDstTile, c = idx - k * kDstTile;
      s_be[k][c] = be_q[(size_t)(k0 + k) * nd_pad + c];
    }
    for (int idx = tid; idx < kDstTile * ni; idx += kThreads) {
      const int k = idx / kDstTile, c = idx - k * kDstTile;
      s_ai[k][c] = ai_t[(size_t)(k0 + k) * nd_pad + c];
    }
    __syncthreads();

    for (int k = 0; k < ne; ++k) {
      int32_t bd[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bd[c] = s_be[k][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t as = s_ae[k][r0 + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc_e[r][c] |= as & bd[c];
      }
    }
    for (int k = 0; k < ni; ++k) {
      int32_t ad[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) ad[c] = s_ai[k][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t bs_ = s_bi[k][r0 + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc_i[r][c] |= bs_ & ad[c];
      }
    }
  }

  int32_t flags_s[kRows];
  int32_t flags_d[kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) flags_s[r] = s_fs[r0 + r];
#pragma unroll
  for (int c = 0; c < kCols; ++c) flags_d[c] = s_fd[lane + 32 * c];

  // tiered: the verdicts of the thread's 32 cells as one mask per
  // direction (bit r * kCols + c), which frees the accumulators for the
  // tier epilogue; untiered, the epilogue reads the accumulators
  uint32_t eg_bits = 0, in_bits = 0;
  auto verdicts = [&](int r, int c, bool& eg, bool& in) {
    if constexpr (kTiered) {
      eg = (eg_bits >> (r * kCols + c)) & 1u;
      in = (in_bits >> (r * kCols + c)) & 1u;
    } else {
      eg = !(flags_s[r] & 1) || acc_e[r][c] != 0;
      in = !(flags_d[c] & 1) || acc_i[r][c] != 0;
    }
  };

  // tiered: per thread, masks over its cells of the src rows / dst cols
  // with a target (has) and of the valid ones
  uint32_t has_s = 0, has_d = 0, valid_s = 0, valid_d = 0;
  if constexpr (kTiered) {
    uint32_t nz_e = 0, nz_i = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      has_s |= (flags_s[r] & 1) ? 0xFu << (kCols * r) : 0u;
      valid_s |= (flags_s[r] & 2) ? 0xFu << (kCols * r) : 0u;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        nz_e |= (uint32_t)(acc_e[r][c] != 0) << (r * kCols + c);
        nz_i |= (uint32_t)(acc_i[r][c] != 0) << (r * kCols + c);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      has_d |= (flags_d[c] & 1) ? 0x11111111u << c : 0u;
      valid_d |= (flags_d[c] & 2) ? 0x11111111u << c : 0u;
    }
    eg_bits = nz_e | ~has_s;
    in_bits = nz_i | ~has_d;

    TierSmem& ts = tier_smem();
    if (wge <= kTierPass && wgi <= kTierPass) {
      cp_async_wait();
      __syncthreads();
      tier_meta(ts, wge, wgi);
      __syncthreads();
      // the words (copied while the main loop ran) and their facts are
      // in place: a direction with no live word in the block is skipped
      // whole, one whose keys are in order takes the bit-parallel
      // lattice, any other the per-cell min; no barrier in either
      const uint32_t lw_e = live_words(ts, 0, wge), lw_i = live_words(ts, 1, wgi);
      if (lw_e) {
        eg_bits = keys_in_order(ts, 0, wge) ? tier_in_order<0>(ts, wge, r0, lane, eg_bits, has_s)
                                            : tier_per_cell<0>(ts, lw_e, r0, lane, eg_bits, has_s);
      }
      if (lw_i) {
        in_bits = keys_in_order(ts, 1, wgi) ? tier_in_order<1>(ts, wgi, r0, lane, in_bits, has_d)
                                            : tier_per_cell<1>(ts, lw_i, r0, lane, in_bits, has_d);
      }
    } else {
      // past one pass: each src row walks every pass, staging it again
      // (any row count launches); not unrolled, since it stages and syncs
      const int tdepth = wge > wgi ? wge : wgi;
      for (int r = 0; r < kRows; ++r) {
        int32_t anp_e[kCols], banp_e[kCols], anp_i[kCols], banp_i[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) anp_e[c] = banp_e[c] = anp_i[c] = banp_i[c] = kKeyNone;
        for (int k0 = 0; k0 < tdepth; k0 += kTierPass) {
          __syncthreads();  // every read of the previous words is done
          stage_tier(ts, tier_args(), k0);
          cp_async_wait();
          __syncthreads();
          const int ne = min(kTierPass, max(wge - k0, 0));
          const int ni = min(kTierPass, max(wgi - k0, 0));
          tier_meta(ts, ne, ni);
          __syncthreads();
          tier_accumulate<0>(ts, live_words(ts, 0, ne), r0 + r, lane, anp_e, banp_e);
          tier_accumulate<1>(ts, live_words(ts, 1, ni), r0 + r, lane, anp_i, banp_i);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int bit = r * kCols + c;
          eg_bits = resolve_bits(eg_bits, bit, has_s >> bit & 1, anp_e[c], banp_e[c]);
          in_bits = resolve_bits(in_bits, bit, has_d >> bit & 1, anp_i[c], banp_i[c]);
        }
      }
    }
  }

  if constexpr (!kWeighted) {
    int c_in = 0, c_eg = 0, c_co = 0;
    if constexpr (kTiered) {
      const uint32_t valid = valid_s & valid_d;
      c_in = __popc(in_bits & valid);
      c_eg = __popc(eg_bits & valid);
      c_co = __popc(in_bits & eg_bits & valid);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          bool eg, in;
          verdicts(r, c, eg, in);
          const bool valid = (flags_s[r] & 2) && (flags_d[c] & 2);
          c_in += valid && in;
          c_eg += valid && eg;
          c_co += valid && in && eg;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c_in += __shfl_down_sync(0xffffffffu, c_in, off);
      c_eg += __shfl_down_sync(0xffffffffu, c_eg, off);
      c_co += __shfl_down_sync(0xffffffffu, c_co, off);
    }
    __shared__ int32_t red[3][kWarps];
    if (lane == 0) {
      red[0][warp] = c_in;
      red[1][warp] = c_eg;
      red[2][warp] = c_co;
    }
    __syncthreads();
    if (tid < 3) {
      int32_t total = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) total += red[tid][i];
      if (total != 0) {
        atomicAdd(&counts[((size_t)q * (ns_pad / bs) + row0 / bs) * 3 + tid], total);
      }
    }
  } else {
    float wd[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) wd[c] = w[col0 + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s_in = 0.f, s_eg = 0.f, s_co = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        bool eg, in;
        verdicts(r, c, eg, in);
        s_in += in ? wd[c] : 0.f;
        s_eg += eg ? wd[c] : 0.f;
        s_co += (in && eg) ? wd[c] : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s_in += __shfl_down_sync(0xffffffffu, s_in, off);
        s_eg += __shfl_down_sync(0xffffffffu, s_eg, off);
        s_co += __shfl_down_sync(0xffffffffu, s_co, off);
      }
      if (lane == 0) {
        float* out = rowsums + ((size_t)q * ns_pad + row0 + r0 + r) * 3;
        if (s_in != 0.f) atomicAdd(out + 0, s_in);
        if (s_eg != 0.f) atomicAdd(out + 1, s_eg);
        if (s_co != 0.f) atomicAdd(out + 2, s_co);
      }
    }
  }
}

struct Args {
  const void *a_e, *b_e, *b_i, *a_i, *w;
  void* out;
  const void *t_se, *t_pe, *t_si, *t_pi, *keys_e, *keys_i;
  int q, ns_pad, nd_pad, we, wi, wge, wgi, bs;
};

template <bool kWeighted, bool kTiered>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.nd_pad / kDstTile, a.ns_pad / kSrcTile, a.q);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  packed_counts_kernel<kWeighted, kTiered><<<grid, kThreads, 0, stream>>>(
      i32(a.a_e), i32(a.b_e), i32(a.b_i), i32(a.a_i), static_cast<const float*>(a.w),
      kWeighted ? nullptr : static_cast<int32_t*>(a.out),
      kWeighted ? static_cast<float*>(a.out) : nullptr, i32(a.t_se), i32(a.t_pe),
      i32(a.t_si), i32(a.t_pi), i32(a.keys_e), i32(a.keys_i), a.ns_pad, a.nd_pad, a.we,
      a.wi, a.wge, a.wgi, a.bs);
  return (int)cudaGetLastError();
}

}  // namespace

// Registers, static shared memory and local (spill) bytes per thread of
// each instance: which = weighted + 2 * tiered (0 = K1, 1 = K2, 2 =
// K3-plain, 3 = K3-weighted).  Returns 0 or a cudaError_t code.
extern "C" int cyclonus_packed_kernel_attrs(int which, int* regs, int* smem_static,
                                            int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (which) {
    case 0: err = cudaFuncGetAttributes(&attr, packed_counts_kernel<false, false>); break;
    case 1: err = cudaFuncGetAttributes(&attr, packed_counts_kernel<true, false>); break;
    case 2: err = cudaFuncGetAttributes(&attr, packed_counts_kernel<false, true>); break;
    case 3: err = cudaFuncGetAttributes(&attr, packed_counts_kernel<true, true>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem_static = (int)attr.sharedSizeBytes;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Launch K1 (weighted == 0) or K2 (weighted != 0) on `stream`, tiered (K3)
// when t_se is not null: then all six tier pointers must be set and wge,
// wgi >= 1.  `out` must be zero-filled by the caller.  Returns 0 or a
// cudaError_t code.
extern "C" int cyclonus_packed_counts(const void* a_e, const void* b_e, const void* b_i,
                                      const void* a_i, const void* w, void* out,
                                      const void* t_se, const void* t_pe, const void* t_si,
                                      const void* t_pi, const void* keys_e,
                                      const void* keys_i, int q, int ns_pad, int nd_pad,
                                      int we, int wi, int wge, int wgi, int bs, int weighted,
                                      void* stream) {
  const bool tiered = t_se != nullptr;
  if (q < 1 || q > 65535 || we < 1 || wi < 1 || bs < kSrcTile || bs % kSrcTile != 0 ||
      ns_pad < 1 || ns_pad % bs != 0 || ns_pad / kSrcTile > 65535 || nd_pad < 1 ||
      nd_pad % kDstTile != 0 || (weighted && w == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiered && (t_pe == nullptr || t_si == nullptr || t_pi == nullptr ||
                 keys_e == nullptr || keys_i == nullptr || wge < 1 || wgi < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{a_e,  b_e,    b_i,    a_i,    w,  out, t_se, t_pe, t_si, t_pi, keys_e,
               keys_i, q,    ns_pad, nd_pad, we, wi,  wge,  wgi,  bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiered) {
    return weighted ? launch<true, true>(a, s) : launch<false, true>(a, s);
  }
  return weighted ? launch<true, false>(a, s) : launch<false, false>(a, s);
}

extern "C" const char* cyclonus_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
