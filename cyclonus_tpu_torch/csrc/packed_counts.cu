// Packed verdict-count kernels for Hopper (sm_90a): K1, K2 and K3 on the
// counts kernels' shared tensor-core main loop (wgmma_ring.cuh).
//
// Replaces the TPU kernel cyclonus_tpu/engine/pallas_kernel.py
// _make_packed_kernel (launched by _verdict_counts_pallas_packed) in its
// four variants, epilogue x tiers, as packed_counts_kernel<weighted,
// tiered>:
//   * plain    (K1, <false, false>): validity-masked allow counts of
//                    ingress / egress / combined, one int32 partial per
//                    (port case, src segment of `bs` rows) -> out [Q,
//                    ns_pad / bs, 3] int32;
//   * weighted (K2, <true, false>): per-src-row sums of each verdict
//                    weighted by w[dst] (class sizes) -> out [Q, ns_pad, 3]
//                    float32;
//   * tiered   (K3, <*, true>): either of the two, with each direction's
//                    verdict first resolved through the AdminNetworkPolicy
//                    -> NetworkPolicy -> BaselineAdminNetworkPolicy lattice.
//
// Per cell (s, d) of port case q, with the target axis packed 32 per int32
// word, both contraction operands K-major (words innermost, zero-padded to
// a multiple of 8 words: 32 bytes, one k256 step):
//   acc_e = sum_w popc(a_e[s, w] & b_e[q, d, w])     egress contraction
//   acc_i = sum_w popc(b_i[q, s, w] & a_i[d, w])     ingress contraction
//   egress  = !has_s || acc_e != 0
//   ingress = !has_d || acc_i != 0
//   combined = egress && ingress
// The popc sum is nonzero exactly where OR_w(a & b) is, and stays below
// 2^31 at any depth that fits the int32 operands.  The flags (bit 0 =
// has_target, bit 1 = valid) are their own vectors f_s [ns_pad] and f_d
// [nd_pad]; invalid pods are zero in every operand.
//
// Tiered: per cell and direction
//   anp  = min over rows g with subject[g] & peer[g, q] of keys[0][g]
//   banp = the same over keys[1][g]      (none when no row matches)
// where a key is rank * 4 + action; then
//   verdict = ANP Allow/Deny if anp decides, else the NetworkPolicy verdict
//             where a target selects the subject, else BANP Allow/Deny,
//             else allow.
// A cell's min key is the key of the first row that matches it when the
// rows are walked by non-decreasing key, so the wrapper lists each
// direction's rows as one walk (the ANP rows by key, then the BANP rows by
// key) and lays the tier bits out in walk order: the lattice runs over the
// thread's 128 cells as 32-bit masks, each position deciding the cells it
// matches that no earlier position of its tier decided, for any key order
// and any number of rows.  Egress subjects are src pods and peers dst pods,
// ingress the other way round.
//
// What bounds them: the contraction is 1 bit x 1 bit, and the least time
// for it is the single-bit tensor-core rate (measured 7.88e15 bit
// multiply-adds/s on the H100 by torch_tools/mma_probe.py, 8x the int8
// rate) over the target bits that hold data, against the operand bytes
// over 3.35e12 B/s (chip_smoke.bound).  The products are far from binding:
// what the kernels wait on is the rest of each item, the stage round trips
// between producer and consumers, the fold of 2 x 128 accumulators a
// thread into verdict bits, and the epilogue (the tier walk above all).
//
// The design: the dense kernels' loop over the same byte geometry (an int32
// word row is a byte row to TMA and wgmma), at 32-byte stages (the 32-byte
// swizzle, 16 stages of 12 KB), one k256 product a stage, so any depth is
// whole stages and no product runs over zero fill; persistent blocks, one
// per SM, walking 128 x 256-cell items in raster order; one producer
// thread, two consumer warpgroups of 64 src rows.  A direction's products
// queue back to back (the first overwrites the accumulators, each stage is
// released once its product is done: wgmma_ring.cuh's contract).  Egress
// first, folded into 128 verdict bits a thread (min(acc, 1) shifted into
// place) and parked in shared memory, then ingress, so one direction's
// accumulators are live at a time.  The epilogue works on 32-bit masks in
// the accumulators' bit order (bit b of word j is the cell (row 16 warp +
// lane / 4 + 8 ((b / 2) % 2), col 64 j + 8 (b / 4) + 2 (lane % 4) + b % 2)
// of the warpgroup's 64 x 256 tile): row-side facts are two bits a thread,
// and every dst-side fact (the dst flags, each tier row's dst-side subjects
// or peers) comes precomputed by the wrapper in that order, 16 words per
// 256 columns (one 16-byte load per word kind and item).  The tier walk
// stages kPass positions a pass in shared memory, one round trip to device
// memory a pass (the first pass's in flight with the flags' loads), and
// visits only the positions that some row of the warp holds, so its cost
// grows with the rows by their mask work.
// K1/K3-plain hold their counts per thread in shared memory while a
// warpgroup stays in one (q, src segment) and flush them with one atomicAdd
// per verdict (wgmma_ring.cuh's flush); K2/K3-weighted reduce each row's
// sums over its four lanes and add them with one atomicAdd per row and
// verdict.  Integer counts are exact in any order; the weighted partials
// are integers below 2^24 (the caller's gate), so they are exact in any
// order too.
// Before each launch the live-target pass (live_or_kernel,
// live_gather_kernel, below) may cut each direction's depth to the targets
// that select a pod.
// The kernels allocate nothing and run on the caller's stream.

#include <algorithm>
#include <type_traits>

#include "wgmma_ring.cuh"

namespace {

constexpr int kStage = 32;  // bytes of depth a stage: one k256 product
constexpr int kWords = kAcc / 32;  // verdict mask words a thread

// tier lattice action codes (engine/encoding.py TIER_ACT_*)
constexpr int kActNone = 0;
constexpr int kActAllow = 1;
constexpr int kActPass = 3;
constexpr unsigned kFull = 0xffffffffu;

// Row pattern of a thread's cells: bits of its first row (r0) or its
// second (r0 + 8) in every mask word.
constexpr uint32_t kRow0 = 0x33333333u;
constexpr uint32_t kRow8 = 0xCCCCCCCCu;

// The epilogue's operands beside the loop's (pointers to device memory;
// the tier ones null when untiered).  Fragment tables hold, per 256-column
// block cb and lane class l = lane % 4, the four mask words j of the
// thread's columns (int4: j = 0..3).
struct Epi {
  const int32_t* f_s;   // [ns_pad] src flags
  const int4* fd;       // [2, nb, 4]: dst valid, then dst has, as fragments
  const float* w;       // [nd_pad] dst weights (weighted)
  float* rowsums;       // [q, ns_pad, 3] (weighted)
  int nb;               // 256-column blocks: nd_pad / 256 rounded up
  // tiered, per direction (0 = egress, 1 = ingress), over the walk's
  // positions (tier_lattice), lp of them padded to a multiple of kPass:
  const int32_t* rows[2];  // src-side position words: [ns_pad, lp / 32] egress
                           // subjects, [q, ns_pad, lp / 32] ingress peers
  const int4* frag[2];     // dst-side fragments: [q, nb, lp, 4] egress peers,
                           // [nb, lp, 4] ingress subjects
  const int32_t* key[2];   // [lp] the key of each position
  const int32_t* real[2];  // [2] real ANP, then BANP positions
  int lp[2];
};

// The `acc != 0` verdicts of a warpgroup's 64 x 256 tile as 128 bits a
// thread, in verdict_bits' order: min(acc, 1) shifted into place and
// added, which compiles to fewer instructions a cell than verdict_bits'
// compare-select-or.
// The popc sums are never negative.
__device__ __forceinline__ void nonzero_bits(const int32_t (&acc)[kAcc],
                                             uint32_t (&bits)[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) m += min((uint32_t)acc[32 * j + b], 1u) << b;
    bits[j] = m;
  }
}

// The tier walk of one direction: the wrapper lists each direction's rows
// with a real ANP key by non-decreasing key, then those with a real BANP
// key the same way (positions 0 .. real[0] - 1 and real[0] .. real[0] +
// real[1] - 1), and lays each row's dst-side bits out as fragments in that
// order, kPass positions of a 256-column block contiguous, and its src-side
// bits as position words per src row.  A consumer warpgroup stages kPass
// positions at a time in its own shared memory (one round trip to device
// memory a pass, every load of it in flight together), then walks them
// from there.
constexpr int kPass = 128;

struct TierStage {
  int4 frag[kPass * 4];  // [position][lane class]: the dst-side mask words
  int32_t key[kPass];    // the key of each position
};

struct TierSmem {
  TierStage stage[2];  // one per consumer warpgroup
  int32_t real[2][2];  // per direction: the walk's real ANP, then BANP positions
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Stage positions i0 .. i0 + n - 1 of direction kDir's walk for 256-column
// block cb of port case q: their fragments and keys, with cp.async (the
// caller waits and syncs the warpgroup before reading them).
template <int kDir>
__device__ __forceinline__ void stage_pass(const Epi& e, TierStage& ts, int q, int cb, int t,
                                           int i0, int n) {
  const int lp = e.lp[kDir];
  const int4* frag =
      e.frag[kDir] + (((size_t)(kDir == 0 ? q * e.nb : 0) + cb) * lp + i0) * 4;
  for (int k = t; k < 4 * n; k += 128) cp_async16(&ts.frag[k], frag + k);
  if (t < (n + 3) / 4) cp_async16(&ts.key[4 * t], e.key[kDir] + i0 + 4 * t);
}

// The lattice's masks over a walk: per tier the cells some position has
// decided, and the cells decided into ANP allow / ANP deny / BANP deny.
struct Lattice {
  uint32_t dec[kWords], allow[kWords], deny[kWords], deny_b[kWords];
  bool banp;  // past the ANP positions (dec then holds the BANP tier's)
};

// The staged positions base .. base + 31 of a pass (bit b of w0 / w8: the
// thread's rows r0 / r0 + 8 hold position base + b), the first `n` of them
// in the walk; pos0 is the pass's first position.  Only the positions that
// some row of the warp holds are visited, in order (warp-uniform).
__device__ __forceinline__ void walk_word(const TierStage& ts, uint32_t w0, uint32_t w8, int base,
                                          int n, int pos0, int real_a, int l, Lattice& z) {
  uint32_t need = __reduce_or_sync(kFull, w0 | w8);
  if (n < 32) need &= n > 0 ? (1u << n) - 1 : 0u;
  while (need != 0) {
    const int b = __ffs(need) - 1;
    need &= need - 1;
    const int i = base + b;
    if (!z.banp && pos0 + i >= real_a) {
      z.banp = true;
#pragma unroll
      for (int j = 0; j < kWords; ++j) z.dec[j] = 0;
    }
    const uint32_t rmask = (kRow0 & (0u - ((w0 >> b) & 1))) | (kRow8 & (0u - ((w8 >> b) & 1)));
    const int4 c = ts.frag[4 * i + l];
    const int act = ts.key[i] & 3;
    const uint32_t cw[kWords] = {(uint32_t)c.x, (uint32_t)c.y, (uint32_t)c.z, (uint32_t)c.w};
    if (!z.banp) {
      const uint32_t am = act == kActAllow ? kFull : 0u;
      const uint32_t dm = act != kActAllow && act != kActPass && act != kActNone ? kFull : 0u;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const uint32_t first = rmask & cw[j] & ~z.dec[j];
        z.dec[j] |= rmask & cw[j];
        z.allow[j] |= first & am;
        z.deny[j] |= first & dm;
      }
    } else {
      const uint32_t bm = act != kActNone && act != kActAllow ? kFull : 0u;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const uint32_t first = rmask & cw[j] & ~z.dec[j];
        z.dec[j] |= rmask & cw[j];
        z.deny_b[j] |= first & bm;
      }
    }
  }
}

// Direction kDir of the thread's cells through the tier lattice: each
// position of the walk, in order, decides the cells it matches that no
// earlier position of its tier decided, as 32-bit masks over the thread's
// 128 cells (the first match holds the min key).  `np` holds the
// NetworkPolicy verdicts, `has` the cells whose subject some target
// selects; np becomes the lattice's.  Every thread of the warpgroup calls
// it (named barrier 1 + wg, as the flush); `staged`: the caller has staged
// the first pass already.
template <int kDir>
__device__ __forceinline__ void tier_lattice(const Epi& e, TierStage& ts, int real_a, int n_all,
                                             int q, int r0, int ns_pad, int cb, int t, int wg,
                                             bool staged, const uint32_t (&has)[kWords],
                                             uint32_t (&np)[kWords]) {
  const int wq = e.lp[kDir] / kPass, l = t & 3;
  const int4* rows = reinterpret_cast<const int4*>(e.rows[kDir]) +
                     (kDir == 1 ? (size_t)q * ns_pad * wq : 0);
  const int4* row0 = r0 < ns_pad ? rows + (size_t)r0 * wq : nullptr;
  const int4* row8 = r0 + 8 < ns_pad ? rows + (size_t)(r0 + 8) * wq : nullptr;
  Lattice z;
  z.banp = false;
#pragma unroll
  for (int j = 0; j < kWords; ++j) z.dec[j] = z.allow[j] = z.deny[j] = z.deny_b[j] = 0;
  for (int i0 = 0; i0 < n_all; i0 += kPass) {
    const int n = min(kPass, n_all - i0);
    if (!staged || i0 > 0) {
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the stage is read
      stage_pass<kDir>(e, ts, q, cb, t, i0, n);
    }
    const int4 s0 = row0 ? __ldg(row0 + i0 / kPass) : make_int4(0, 0, 0, 0);
    const int4 s8 = row8 ? __ldg(row8 + i0 / kPass) : make_int4(0, 0, 0, 0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the stage is written
    walk_word(ts, (uint32_t)s0.x, (uint32_t)s8.x, 0, n, i0, real_a, l, z);
    walk_word(ts, (uint32_t)s0.y, (uint32_t)s8.y, 32, n - 32, i0, real_a, l, z);
    walk_word(ts, (uint32_t)s0.z, (uint32_t)s8.z, 64, n - 64, i0, real_a, l, z);
    walk_word(ts, (uint32_t)s0.w, (uint32_t)s8.w, 96, n - 96, i0, real_a, l, z);
  }
  // the lattice on every cell at once: an ANP Allow / Deny decides; else
  // the NetworkPolicy verdict where a target selects the subject, else the
  // BANP verdict (allow unless its first matching row denies)
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    np[j] = z.allow[j] |
            (~(z.allow[j] | z.deny[j]) & ((has[j] & np[j]) | (~has[j] & ~z.deny_b[j])));
  }
}

// The item's verdicts of this thread's cells (egress nz bits parked in
// held, ingress nz bits in nz_i) into its counts (plain: held.counts) or the
// row sums (weighted: atomics).
template <bool kWeighted, bool kTiered>
__device__ __forceinline__ void epilogue(const Params& p, const Epi& e, const Item& x, int wg,
                                         int ct, const uint32_t (&nz_i)[kWords], Held& held,
                                         TierSmem* tsm) {
  const int t = ct & 127, lane = t & 31, warp = t >> 5, l = lane & 3;
  const int r0 = x.row0 + 64 * wg + 16 * warp + (lane >> 2);
  const int cb = x.col0 / kN;
  int ae = 0, ne = 0, ai = 0, ni = 0;
  if constexpr (kTiered) {
    // the first pass of the first walked direction, its loads in flight
    // with the flags' (the stage is free: the warpgroup has left the last
    // item's walk)
    ae = tsm->real[0][0];
    ne = ae + tsm->real[0][1];
    ai = tsm->real[1][0];
    ni = ai + tsm->real[1][1];
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (ne > 0) {
      stage_pass<0>(e, tsm->stage[wg], x.q, cb, t, 0, min(kPass, ne));
    } else if (ni > 0) {
      stage_pass<1>(e, tsm->stage[wg], x.q, cb, t, 0, min(kPass, ni));
    }
  }
  const int f0 = r0 < p.ns_pad ? __ldg(e.f_s + r0) : 0;
  const int f8 = r0 + 8 < p.ns_pad ? __ldg(e.f_s + r0 + 8) : 0;
  const uint32_t has_s = ((f0 & 1) ? kRow0 : 0u) | ((f8 & 1) ? kRow8 : 0u);
  const int4 vd4 = __ldg(e.fd + (size_t)cb * 4 + l);
  const int4 hd4 = __ldg(e.fd + ((size_t)e.nb + cb) * 4 + l);
  const uint32_t has_d[kWords] = {(uint32_t)hd4.x, (uint32_t)hd4.y, (uint32_t)hd4.z,
                                  (uint32_t)hd4.w};
  uint32_t eg[kWords], in[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    eg[j] = held.eg_bits[j][ct] | ~has_s;
    in[j] = nz_i[j] | ~has_d[j];
  }
  if constexpr (kTiered) {
    // a direction whose walk holds no real position is skipped whole (the
    // benchmark lattice's egress rows are all pads)
    TierStage& ts = tsm->stage[wg];
    const uint32_t has_e[kWords] = {has_s, has_s, has_s, has_s};
    if (ne > 0) tier_lattice<0>(e, ts, ae, ne, x.q, r0, p.ns_pad, cb, t, wg, true, has_e, eg);
    if (ni > 0) {
      tier_lattice<1>(e, ts, ai, ni, x.q, r0, p.ns_pad, cb, t, wg, ne == 0, has_d, in);
    }
  }
  if constexpr (!kWeighted) {
    const uint32_t valid_s = ((f0 & 2) ? kRow0 : 0u) | ((f8 & 2) ? kRow8 : 0u);
    const uint32_t valid_d[kWords] = {(uint32_t)vd4.x, (uint32_t)vd4.y, (uint32_t)vd4.z,
                                      (uint32_t)vd4.w};
    int c_in = 0, c_eg = 0, c_co = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t valid = valid_s & valid_d[j];
      c_in += __popc(in[j] & valid);
      c_eg += __popc(eg[j] & valid);
      c_co += __popc(in[j] & eg[j] & valid);
    }
    held.counts[0][ct] += c_in;
    held.counts[1][ct] += c_eg;
    held.counts[2][ct] += c_co;
  } else {
    // row h (r0 + 8 h) of the thread: cells b = 4 m + 2 h + e of word j,
    // col 64 j + 8 m + 2 l + e; its four lanes hold the row's 256 cols
    float s[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t co = in[j] & eg[j];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int col = x.col0 + 64 * j + 8 * m + 2 * l;
        const float2 wd = col < p.nd_pad ? __ldg(reinterpret_cast<const float2*>(e.w + col))
                                         : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = 4 * m + 2 * h;
          s[h][0] += ((in[j] >> b) & 1 ? wd.x : 0.f) + ((in[j] >> (b + 1)) & 1 ? wd.y : 0.f);
          s[h][1] += ((eg[j] >> b) & 1 ? wd.x : 0.f) + ((eg[j] >> (b + 1)) & 1 ? wd.y : 0.f);
          s[h][2] += ((co >> b) & 1 ? wd.x : 0.f) + ((co >> (b + 1)) & 1 ? wd.y : 0.f);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        s[h][v] += __shfl_xor_sync(kFull, s[h][v], 1);
        s[h][v] += __shfl_xor_sync(kFull, s[h][v], 2);
      }
      const int r = r0 + 8 * h;
      if (l == 0 && r < p.ns_pad) {
        float* out = e.rowsums + ((size_t)x.q * p.ns_pad + r) * 3;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          if (s[h][v] != 0.f) atomicAdd(out + v, s[h][v]);
        }
      }
    }
  }
}

template <bool kWeighted, bool kTiered>
__global__ void __launch_bounds__(kBlockThreads, 1)
    packed_counts_kernel(const __grid_constant__ CUtensorMap tm_ae,
                         const __grid_constant__ CUtensorMap tm_be,
                         const __grid_constant__ CUtensorMap tm_bi,
                         const __grid_constant__ CUtensorMap tm_ai, const Params p,
                         const Epi e) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ Held held;
  __shared__ std::conditional_t<kTiered, TierSmem, int> tier_smem;
  TierSmem* tsm = nullptr;
  if constexpr (kTiered) {
    tsm = &tier_smem;
    if (threadIdx.x < 4) {
      // a select, not an index into the parameter (which would copy it to
      // local memory)
      const int32_t* real = threadIdx.x < 2 ? e.real[0] : e.real[1];
      tsm->real[threadIdx.x >> 1][threadIdx.x & 1] = __ldg(real + (threadIdx.x & 1));
    }
  }
  uint8_t* smem = block_setup<kStage>(smem_raw, full, empty, held, !kWeighted);

  const int wg = threadIdx.x / 128;
  Ring ring{0, 0};
  if (wg == 2) {
    // producer: one thread issues every load, for every item of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
        const Item x = item_at(p, it);
        produce<false, false, kStage>(p, x, smem, full, empty, ring, &tm_ae, &tm_be);
        produce<false, true, kStage>(p, x, smem, full, empty, ring, &tm_bi, &tm_ai);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  int32_t acc[kAcc];
  uint32_t bits[kWords];
  const int ct = threadIdx.x;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    contract<false, false, kStage, true>(p, item_at(p, opaque(it)), smem, full, empty, ring, wg,
                                         acc);
    nonzero_bits(acc, bits);
#pragma unroll
    for (int j = 0; j < kWords; ++j) held.eg_bits[j][ct] = bits[j];
    contract<false, true, kStage, true>(p, item_at(p, opaque(it)), smem, full, empty, ring, wg,
                                        acc);
    nonzero_bits(acc, bits);
    const Item x = item_at(p, opaque(it));
    epilogue<kWeighted, kTiered>(p, e, x, wg, opaque(ct), bits, held, tsm);
    if constexpr (!kWeighted) {
      // flush when the block's next item falls in another segment for this
      // warpgroup, or there is none (at the end of the body: with a flush
      // before the products ptxas spills the accumulators, C7512)
      const int seg = segment(p, x, wg);
      const int next = opaque(it) + gridDim.x;
      const bool last = next >= p.items;
      if (last || segment(p, item_at(p, next), wg) != seg) flush(p, seg, wg, ct, held, last);
    }
  }
}

template <bool kWeighted, bool kTiered>
int launch(const void* a_e, const void* b_e, const void* b_i, const void* a_i, int q, int de,
           int di, const Params& p, const Epi& e, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!encode_maps<kStage>(maps, a_e, b_e, b_i, a_i, q, de, di, p)) return kErrTensorMap;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(packed_counts_kernel<kWeighted, kTiered>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int grid = 0;
  const cudaError_t err = persistent_grid(p.items, &grid);
  if (err != cudaSuccess) return (int)err;
  packed_counts_kernel<kWeighted, kTiered>
      <<<grid, kBlockThreads, kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], p, e);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// ---------------------------------------------------------------------------
// The live-target pass before a launch: live_or_kernel, then
// live_gather_kernel (engine/packed_kernel.py live_targets).
//
// Replaces no TPU kernel.  The verdict service encodes its rules at
// compact=False (compaction at encode time would bake pod state into the
// rule tensors, and a pod delta can invalidate it), so K1/K3 contract over
// every encoded target, and most of them select no pod.  A target whose
// tmatch bit is zero in every row adds 0 to every popc sum, whatever its
// tallow bits hold, so each direction's contraction may keep its live
// targets alone, the same on both of its operands:
//   live_or_kernel:     live = the OR over the rows of a_e (egress tmatch by
//                       src row), then of a_i (ingress tmatch by dst row);
//   live_gather_kernel: each row of a direction's two operands packed again
//                       over the set bits of its live words: bit k of output
//                       word j is the row's bit at the (32 j + k)-th set bit,
//                       zero past the live count.
// The counts keep their exact values, and K1/K3 walk the live depth.
// What bounds them: bytes (the OR reads a_e and a_i once, the gather the
// four operands once and writes their compacted copies, a tenth of their
// size or less).  The OR reads rows as 16-byte words, a warp on one row's
// consecutive words, ORs a block's rows in registers and shared memory and
// adds them with one atomicOr a word; the gather builds its map in shared
// memory from the live words (prefix popcounts by one warp's scan, then the
// first source word of each output word), stages a tile of rows with
// 16-byte loads, and each thread writes one output word, the OR of the live
// bits of each source word that overlaps it, extracted and shifted to their
// rank.

constexpr int kLiveThreads = 256;
constexpr int kOrRows = 256;          // rows a block of live_or_kernel ORs
constexpr int kMaxLiveDepth = 8192;   // words: the deepest operand the gather maps
constexpr int kTileWords = 8192;      // staged row words a gather block aims for
constexpr int kMaxTileRows = 64;

struct OrOperand {
  const int4* src;  // [rows, d4]
  int32_t* live;    // [4 d4], zero-filled
  int rows, d4;
};

struct OrArgs {
  OrOperand op[2];  // egress (a_e), then ingress (a_i): blockIdx.z
};

__global__ void __launch_bounds__(kLiveThreads)
    live_or_kernel(const __grid_constant__ OrArgs args) {
  const OrOperand& o = args.op[blockIdx.z];
  if ((int)blockIdx.y * 32 >= o.d4) return;  // block-uniform
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.y * 32 + lane;
  const int r_hi = min(o.rows, (int)(blockIdx.x + 1) * kOrRows);
  int4 acc = make_int4(0, 0, 0, 0);
  if (col < o.d4) {
    for (int r = blockIdx.x * kOrRows + warp; r < r_hi; r += kLiveThreads / 32) {
      const int4 v = __ldg(o.src + (size_t)r * o.d4 + col);
      acc.x |= v.x;
      acc.y |= v.y;
      acc.z |= v.z;
      acc.w |= v.w;
    }
  }
  __shared__ int4 part[kLiveThreads / 32][32];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < o.d4) {
#pragma unroll
    for (int k = 1; k < kLiveThreads / 32; ++k) {
      const int4 v = part[k][lane];
      acc.x |= v.x;
      acc.y |= v.y;
      acc.z |= v.z;
      acc.w |= v.w;
    }
    int32_t* out = o.live + 4 * col;
    if (acc.x) atomicOr(out + 0, acc.x);
    if (acc.y) atomicOr(out + 1, acc.y);
    if (acc.z) atomicOr(out + 2, acc.z);
    if (acc.w) atomicOr(out + 3, acc.w);
  }
}

struct GatherOperand {
  const int32_t* src;   // [rows, d]
  int32_t* dst;         // [rows, dc]
  const int32_t* live;  // [d]: the direction's live words
  int rows, d, dc, tile_rows;
};

struct GatherArgs {
  GatherOperand op[4];  // blockIdx.y
};

// Shared memory words of a gather block's map: live [d], the exclusive
// prefix popcounts [d + 1] and the first source word of each output word
// with live bits, then the last live word [dc + 1], rounded up to 16 bytes
// (the row tile follows).
__host__ __device__ constexpr int map_words(int d, int dc) { return (2 * d + 2 + dc + 3) / 4 * 4; }

// The bits of v under the set bits of m, packed low (a parallel bit
// extract); m holds a few bits.
__device__ __forceinline__ uint32_t extract_bits(uint32_t v, uint32_t m) {
  uint32_t r = 0;
  for (int k = 0; m != 0; ++k, m &= m - 1) r |= ((v >> (__ffs(m) - 1)) & 1u) << k;
  return r;
}

constexpr int kGatherSmemMax = 4 * (map_words(kMaxLiveDepth, kMaxLiveDepth) + kTileWords);
static_assert(kGatherSmemMax <= 227 * 1024, "the gather's shared memory");

__global__ void __launch_bounds__(kLiveThreads)
    live_gather_kernel(const __grid_constant__ GatherArgs args) {
  const GatherOperand& o = args.op[blockIdx.y];
  extern __shared__ int4 gather_smem[];
  int32_t* live = reinterpret_cast<int32_t*>(gather_smem);
  int32_t* pre = live + o.d;
  int32_t* first = pre + o.d + 1;
  int32_t* tile = live + map_words(o.d, o.dc);
  const int t = threadIdx.x, lane = t & 31;
  for (int w = t; w < o.d; w += kLiveThreads) live[w] = __ldg(o.live + w);
  __syncthreads();
  if (t < 32) {
    int carry = 0;
    for (int base = 0; base < o.d; base += 32) {
      const int w = base + lane;
      const int c = w < o.d ? __popc(live[w]) : 0;
      int x = c;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int up = __shfl_up_sync(kFull, x, s);
        if (lane >= s) x += up;
      }
      if (w < o.d) pre[w] = carry + x - c;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) pre[o.d] = carry;
  }
  __syncthreads();
  const int n_live = pre[o.d];
  const int words = (n_live + 31) / 32;  // output words that hold live bits
  for (int w = t; w < o.d; w += kLiveThreads) {
    for (int j = (pre[w] + 31) / 32; 32 * j < pre[w + 1] && j < o.dc; ++j) first[j] = w;
    if (pre[w] < n_live && pre[w + 1] == n_live) first[words] = w;
  }
  __syncthreads();
  for (int r0 = blockIdx.x * o.tile_rows; r0 < o.rows; r0 += gridDim.x * o.tile_rows) {
    const int nr = min(o.tile_rows, o.rows - r0);
    const int4* src = reinterpret_cast<const int4*>(o.src + (size_t)r0 * o.d);
    int4* tile4 = reinterpret_cast<int4*>(tile);
    for (int k = t; k < nr * o.d / 4; k += kLiveThreads) tile4[k] = __ldg(src + k);
    __syncthreads();
    for (int k = t; k < nr * o.dc; k += kLiveThreads) {
      const int r = k / o.dc, j = k - r * o.dc;
      uint32_t out = 0;
      if (j < words) {
        // the source words whose live bits overlap ranks 32 j .. 32 j + 31,
        // each one's bits placed at its rank: independent terms
        const int32_t* row = tile + r * o.d;
        const int w1 = first[j + 1];
#pragma unroll 4
        for (int w = first[j]; w <= w1; ++w) {
          const uint32_t e = extract_bits((uint32_t)row[w], (uint32_t)live[w]);
          const int sh = pre[w] - 32 * j;
          out |= sh >= 0 ? (sh < 32 ? e << sh : 0u) : e >> -sh;
        }
      }
      o.dst[(size_t)r0 * o.dc + k] = (int32_t)out;
    }
    __syncthreads();
  }
}

}  // namespace

// Registers, static and dynamic shared memory and local (spill) bytes per
// thread of each instance: which = weighted + 2 * tiered (0 = K1, 1 = K2,
// 2 = K3-plain, 3 = K3-weighted).  Returns 0 or a cudaError_t code.
extern "C" int cyclonus_packed_kernel_attrs(int which, int* regs, int* smem_static,
                                            int* smem_dynamic, int* local_bytes) {
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
  *smem_dynamic = kSmem;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Launch K1 (weighted == 0) or K2 (weighted != 0) on `stream`, tiered (K3)
// when t_rows_e is not null.  Operands (int32 unless said, contiguous):
// a_e [ns_pad, de], b_e [q, nd_pad, de], b_i [q, ns_pad, di], a_i [nd_pad,
// di] packed words, de and di multiples of 8; f_s [ns_pad] and f_d_frag
// [2, nb, 16] (nb = nd_pad / 256 rounded up); w [nd_pad] float32
// (weighted); out [q, ns_pad / bs, 3] int32 or [q, ns_pad, 3] float32,
// zero-filled by the caller.  Tiered (tier_lattice), all of, over lpe and
// lpi walk positions (multiples of 128): rows_e [ns_pad, lpe / 32], rows_i
// [q, ns_pad, lpi / 32], frag_e [q, nb, lpe, 16], frag_i [nb, lpi, 16],
// key_e [lpe], key_i [lpi], real_e and real_i [2].  bs a multiple of 64
// that divides ns_pad, nd_pad a multiple of 128; the four contraction
// operands, the fragment tables, the position words and keys 16-byte
// aligned.
// Returns 0, a cudaError_t code or -1 (a tensor map could not be encoded).
extern "C" int cyclonus_packed_counts(const void* a_e, const void* b_e, const void* b_i,
                                      const void* a_i, const void* f_s, const void* f_d_frag,
                                      const void* w, void* out, const void* rows_e,
                                      const void* rows_i, const void* frag_e,
                                      const void* frag_i, const void* key_e, const void* key_i,
                                      const void* real_e, const void* real_i, int q, int ns_pad,
                                      int nd_pad, int de, int di, int lpe, int lpi, int bs,
                                      int weighted, void* stream) {
  const bool tiered = rows_e != nullptr;
  if (q < 1 || q > 65535 || de < 8 || di < 8 || de % 8 != 0 || di % 8 != 0 || bs < 64 ||
      bs % 64 != 0 || ns_pad < 1 || ns_pad % bs != 0 || ns_pad >= (1 << 30) || nd_pad < 1 ||
      nd_pad % 128 != 0 || nd_pad >= (1 << 30) || f_s == nullptr || !aligned16(f_d_frag) ||
      out == nullptr || (weighted && w == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiered && (!aligned16(rows_e) || !aligned16(rows_i) || !aligned16(frag_e) ||
                 !aligned16(frag_i) || !aligned16(key_e) || !aligned16(key_i) ||
                 real_e == nullptr || real_i == nullptr || lpe < kPass || lpe % kPass != 0 ||
                 lpi < kPass || lpi % kPass != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* operands[4] = {a_e, b_e, b_i, a_i};
  for (const void* ptr : operands) {
    if (!aligned16(ptr)) return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.counts = weighted ? nullptr : static_cast<int32_t*>(out);
  // one tile per axis; each direction one chunk of its whole depth, in bytes
  if (!init_params(p, q, 1, 1, ns_pad, nd_pad, bs, 4 * de, 4 * di, 4 * de, 4 * di, 0, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  auto i32 = [](const void* ptr) { return static_cast<const int32_t*>(ptr); };
  auto v4 = [](const void* ptr) { return static_cast<const int4*>(ptr); };
  Epi e{};
  e.f_s = i32(f_s);
  e.fd = v4(f_d_frag);
  e.w = static_cast<const float*>(w);
  e.rowsums = weighted ? static_cast<float*>(out) : nullptr;
  e.nb = (nd_pad + kN - 1) / kN;
  if (tiered) {
    e.rows[0] = i32(rows_e);
    e.rows[1] = i32(rows_i);
    e.frag[0] = v4(frag_e);
    e.frag[1] = v4(frag_i);
    e.key[0] = i32(key_e);
    e.key[1] = i32(key_i);
    e.real[0] = i32(real_e);
    e.real[1] = i32(real_i);
    e.lp[0] = lpe;
    e.lp[1] = lpi;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dbe = 4 * de, dbi = 4 * di;  // row pitches in bytes
  if (tiered) {
    return weighted ? launch<true, true>(a_e, b_e, b_i, a_i, q, dbe, dbi, p, e, s)
                    : launch<false, true>(a_e, b_e, b_i, a_i, q, dbe, dbi, p, e, s);
  }
  return weighted ? launch<true, false>(a_e, b_e, b_i, a_i, q, dbe, dbi, p, e, s)
                  : launch<false, false>(a_e, b_e, b_i, a_i, q, dbe, dbi, p, e, s);
}

// The live-target pass's OR on `stream`: live [de + di] int32 (written
// here, no fill needed) = the OR over the rows of a_e [ns_pad, de], then of
// a_i [nd_pad, di]; de and di multiples of 8, both operands 16-byte
// aligned.  Returns 0 or a cudaError_t code.
extern "C" int cyclonus_live_targets_or(const void* a_e, const void* a_i, int ns_pad, int nd_pad,
                                        int de, int di, void* live, void* stream) {
  if (!aligned16(a_e) || !aligned16(a_i) || live == nullptr || ns_pad < 1 || nd_pad < 1 ||
      de < 8 || di < 8 || de % 8 != 0 || di % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(live);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * ((size_t)de + di), s);
  if (err != cudaSuccess) return (int)err;
  const OrArgs args{{OrOperand{static_cast<const int4*>(a_e), out, ns_pad, de / 4},
                      OrOperand{static_cast<const int4*>(a_i), out + de, nd_pad, di / 4}}};
  const int rows = ns_pad > nd_pad ? ns_pad : nd_pad;
  const int d4 = (de > di ? de : di) / 4;
  const dim3 grid((rows + kOrRows - 1) / kOrRows, (d4 + 31) / 32, 2);
  live_or_kernel<<<grid, kLiveThreads, 0, s>>>(args);
  return (int)cudaGetLastError();
}

// The live-target pass's gather on `stream`, over n_ops (1 to 4) operands:
// operand k packs src[k] [rows, d] again into dst[k] [rows, dc] over the
// set bits of live[k] [d] (dims[3 k .. 3 k + 2] = rows, d, dc), dc at least
// the live count over 32; d and dc multiples of 8, d at most kMaxLiveDepth,
// src and dst 16-byte aligned.  Returns 0 or a cudaError_t code.
extern "C" int cyclonus_live_targets_gather(const void* const* src, void* const* dst,
                                            const void* const* live, const int* dims, int n_ops,
                                            void* stream) {
  if (n_ops < 1 || n_ops > 4) return (int)cudaErrorInvalidValue;
  GatherArgs args{};
  GatherOperand* o = args.op;
  size_t smem = 0;
  int tiles = 0;
  for (int k = 0; k < n_ops; ++k) {
    const int rows = dims[3 * k], d = dims[3 * k + 1], dc = dims[3 * k + 2];
    if (rows < 1 || d < 8 || d % 8 != 0 || d > kMaxLiveDepth || dc < 8 || dc % 8 != 0 ||
        dc > d || !aligned16(src[k]) || !aligned16(dst[k]) || live[k] == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    const int tile_rows = std::max(1, std::min(kMaxTileRows, kTileWords / d));
    o[k] = GatherOperand{static_cast<const int32_t*>(src[k]), static_cast<int32_t*>(dst[k]),
                         static_cast<const int32_t*>(live[k]), rows, d, dc, tile_rows};
    const size_t bytes = 4 * ((size_t)map_words(d, dc) + (size_t)tile_rows * d);
    if (bytes > smem) smem = bytes;
    const int n = (rows + tile_rows - 1) / tile_rows;
    if (n > tiles) tiles = n;
  }
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(live_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGatherSmemMax);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles < 8 * sms ? tiles : 8 * sms, n_ops);
  live_gather_kernel<<<grid, kLiveThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

extern "C" const char* cyclonus_cuda_error_string(int err) {
  if (err == kErrTensorMap) return "cuTensorMapEncodeTiled failed or is unavailable";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
