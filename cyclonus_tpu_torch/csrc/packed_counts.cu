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
//   * the tier epilogue reuses the same staging buffers, kChunk tier words
//     per side at a time.  It walks one src row of the thread's block at a
//     time, keeping the min keys of that row's 4 cells in registers (16
//     values), ANDs subject and peer words and walks the set bits with
//     __ffs, reading keys through the read-only cache.  A warp shares its
//     src row, so an all-zero subject word skips the word for the whole
//     warp.  With at most kChunk tier words per side (512 rows) the words
//     are staged once per block; past that they are staged again for each
//     of the 8 rows, which keeps the registers bounded for any row count;
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
constexpr int32_t kKeyNone = 1 << 30;

__device__ __forceinline__ bool resolve_tier(bool np_allowed, bool has, int32_t anp,
                                             int32_t banp) {
  const int anp_act = anp < kKeyNone ? (anp & 3) : kActNone;
  const int banp_act = banp < kKeyNone ? (banp & 3) : kActNone;
  const bool below = has ? np_allowed : (banp_act == kActNone || banp_act == kActAllow);
  return (anp_act == kActNone || anp_act == kActPass) ? below : anp_act == kActAllow;
}

// min of the anp / banp keys over the set bits of m (rows 32 * word + bit)
__device__ __forceinline__ void min_keys(uint32_t m, int word, const int32_t* __restrict__ keys,
                                         int stride, int32_t& anp, int32_t& banp) {
  while (m) {
    const int g = 32 * word + __ffs(m) - 1;
    m &= m - 1;
    anp = min(anp, __ldg(keys + g));
    banp = min(banp, __ldg(keys + stride + g));
  }
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

  if constexpr (kTiered) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t eg = !(flags_s[r] & 1) || acc_e[r][c] != 0;
        const uint32_t in = !(flags_d[c] & 1) || acc_i[r][c] != 0;
        eg_bits |= eg << (r * kCols + c);
        in_bits |= in << (r * kCols + c);
      }
    }

    const int32_t* se_t = t_se + (size_t)row0 * wge;
    const int32_t* pe_q = t_pe + (size_t)q * wge * nd_pad + col0;
    const int32_t* si_t = t_si + col0;
    const int32_t* pi_t = t_pi + ((size_t)q * ns_pad + row0) * wgi;
    const int tdepth = wge > wgi ? wge : wgi;
    const bool restage = tdepth > kChunk;
    // not unrolled (it stages and syncs): it reads the src flags from
    // shared memory, since indexing flags_s[r] here would move the
    // register array to the stack
    for (int r = 0; r < kRows; ++r) {
      int32_t anp_e[kCols], banp_e[kCols], anp_i[kCols], banp_i[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        anp_e[c] = banp_e[c] = anp_i[c] = banp_i[c] = kKeyNone;
      }
      for (int k0 = 0; k0 < tdepth; k0 += kChunk) {
        const int ne = min(kChunk, max(wge - k0, 0));
        const int ni = min(kChunk, max(wgi - k0, 0));
        if (r == 0 || restage) {
          __syncthreads();  // every read of the buffers' previous words is done
          for (int idx = tid; idx < kSrcTile * ne; idx += kThreads) {
            const int rr = idx / ne, k = idx - rr * ne;
            s_ae[k][rr] = se_t[(size_t)rr * wge + k0 + k];
          }
          for (int idx = tid; idx < kSrcTile * ni; idx += kThreads) {
            const int rr = idx / ni, k = idx - rr * ni;
            s_bi[k][rr] = pi_t[(size_t)rr * wgi + k0 + k];
          }
          for (int idx = tid; idx < kDstTile * ne; idx += kThreads) {
            const int k = idx / kDstTile, c = idx - k * kDstTile;
            s_be[k][c] = pe_q[(size_t)(k0 + k) * nd_pad + c];
          }
          for (int idx = tid; idx < kDstTile * ni; idx += kThreads) {
            const int k = idx / kDstTile, c = idx - k * kDstTile;
            s_ai[k][c] = si_t[(size_t)(k0 + k) * nd_pad + c];
          }
          __syncthreads();
        }
        for (int k = 0; k < ne; ++k) {
          const uint32_t subj = s_ae[k][r0 + r];  // one src row per warp
          if (subj == 0) continue;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            min_keys(subj & (uint32_t)s_be[k][lane + 32 * c], k0 + k, keys_e, 32 * wge,
                     anp_e[c], banp_e[c]);
          }
        }
        for (int k = 0; k < ni; ++k) {
          const uint32_t peer = s_bi[k][r0 + r];
          if (peer == 0) continue;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            min_keys(peer & (uint32_t)s_ai[k][lane + 32 * c], k0 + k, keys_i, 32 * wgi,
                     anp_i[c], banp_i[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int bit = r * kCols + c;
        const uint32_t eg =
            resolve_tier((eg_bits >> bit) & 1u, s_fs[r0 + r] & 1, anp_e[c], banp_e[c]);
        const uint32_t in =
            resolve_tier((in_bits >> bit) & 1u, flags_d[c] & 1, anp_i[c], banp_i[c]);
        eg_bits = (eg_bits & ~(1u << bit)) | (eg << bit);
        in_bits = (in_bits & ~(1u << bit)) | (in << bit);
      }
    }
  }

  if constexpr (!kWeighted) {
    int c_in = 0, c_eg = 0, c_co = 0;
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
