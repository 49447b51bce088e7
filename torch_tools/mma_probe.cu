// Probe of the tensor-core instructions that could carry the packed counts'
// boolean contraction on Hopper (sm_90a): acc = sum_k popc(a[k] & b[k]) is
// nonzero exactly where OR_k(a[k] & b[k]) is.  Built three times, one
// instruction each (-DPROBE=n), so that ptxas's verdict on one does not stop
// the others:
//   1: wgmma.mma_async m64n256k256 .s32.b1.b1.and.popc, both operands
//      K-major in shared memory;
//   2: mma.sync m16n8k256 .row.col .s32.b1.b1.s32.and.popc, fragments
//      loaded from shared memory;
//   3: wgmma.mma_async m64n256k32 .s32.s8.s8 (the dense kernels' product),
//      the yardstick over bits unpacked to int8.
// Each has a rate kernel: persistent blocks, a tight loop of products on
// tiles already in shared memory (no global loads), accumulators kept live.
// Probe 1 also has a check kernel: TMA loads 64 rows of A and 256 rows of B
// in the 32-, 64- or 128-byte swizzle, the kernel runs one product per 32
// bytes of depth and writes each thread's accumulators, and the host holds
// them against popc(a & b) (mma_probe.py beside it).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PROBE
#define PROBE 1
#endif

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// fill shared memory with a fixed pseudo-random pattern
__device__ __forceinline__ void fill(uint8_t* s, int bytes) {
  for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) {
    reinterpret_cast<uint32_t*>(s)[i] = (uint32_t)i * 2654435761u ^ 0x5bd1e995u;
  }
  __syncthreads();
}

#if PROBE == 1 || PROBE == 3

constexpr int kAcc = 128;

// wgmma descriptor of a K-major tile in the kK-byte swizzle (layout type 1:
// 128 bytes, 2: 64, 3: 32); 8-row groups 8 kK bytes apart
template <int kK>
__device__ __forceinline__ uint64_t sw_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  const uint64_t layout = kK == 128 ? 1 : (kK == 64 ? 2 : 3);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * kK >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void fence_acc(int32_t (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(o)                                                                  \
  "+r"(d[(o) + 0]), "+r"(d[(o) + 1]), "+r"(d[(o) + 2]), "+r"(d[(o) + 3]),        \
      "+r"(d[(o) + 4]), "+r"(d[(o) + 5]), "+r"(d[(o) + 6]), "+r"(d[(o) + 7])
#define REGS128                                                                                \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "           \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "           \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "           \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "     \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "       \
  "%125, %126, %127"
#define ACC128                                                                            \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64), \
      ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)

#if PROBE == 1
constexpr int kStep = 32;  // bytes of depth per product: k256 bits
__device__ __forceinline__ void product(int32_t (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc {" REGS128
      "}, %128, %129, p;\n}\n"
      : ACC128
      : "l"(da), "l"(db), "r"(1));
}
constexpr double kMacs = 64.0 * 256 * 256;  // bit multiply-adds per product
#else
constexpr int kStep = 32;  // bytes of depth per product: k32 int8
__device__ __forceinline__ void product(int32_t (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" REGS128 "}, %128, %129, p;\n}\n"
      : ACC128
      : "l"(da), "l"(db), "r"(1));
}
constexpr double kMacs = 64.0 * 256 * 32;
#endif

// Rate: three warpgroups a block, each running 4 products a round (128
// bytes of depth in the 128-byte swizzle) on one A tile (64 x 128 bytes)
// and one B tile (256 x 128 bytes), then waiting for them.
__global__ void __launch_bounds__(384, 1) rate_kernel(int rounds, int32_t* sink) {
  extern __shared__ uint8_t raw[];
  uint8_t* s =
      reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x / 128;
  uint8_t* a = s + wg * 64 * 128;
  uint8_t* b = s + 3 * 64 * 128;
  fill(s, 3 * 64 * 128 + 256 * 128);
  int32_t acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  for (int r = 0; r < rounds; ++r) {
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 128 / kStep; ++k) {
      product(acc, sw_desc<128>(a + k * kStep), sw_desc<128>(b + k * kStep));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  int32_t x = 0;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) x ^= acc[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

constexpr int kRateThreads = 384;
constexpr int kRateSmem = 3 * 64 * 128 + 256 * 128 + 1024;
constexpr double kProductsPerRound = 3.0 * 128 / kStep;  // per block

#if PROBE == 1
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Check: one warpgroup, A [64, kK] and B [256, kK] bytes through TMA in the
// kK-byte swizzle, kK / 32 products, each thread's accumulators to out.
template <int kK>
__global__ void __launch_bounds__(128, 1) check_kernel(const __grid_constant__ CUtensorMap ta,
                                                       const __grid_constant__ CUtensorMap tb,
                                                       int32_t* out) {
  extern __shared__ uint8_t raw[];
  uint8_t* s =
      reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t bar;
  uint8_t* a = s;
  uint8_t* b = s + 64 * kK;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(&bar)),
                 "r"(320 * kK)
                 : "memory");
    tma_2d(a, &ta, 0, 0, &bar);
    tma_2d(b, &tb, 0, 0, &bar);
  }
  mbar_wait(&bar, 0);
  int32_t acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < kK / 32; ++k) product(acc, sw_desc<kK>(a + 32 * k), sw_desc<kK>(b + 32 * k));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) out[threadIdx.x * kAcc + i] = acc[i];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

bool make_map(CUtensorMap* map, const void* base, int rows, int kK) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess) {
    return false;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kK, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kK};
  const cuuint32_t box[2] = {(cuuint32_t)kK, (cuuint32_t)rows};
  const cuuint32_t es[2] = {1, 1};
  const CUtensorMapSwizzle sw = kK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : (kK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B);
  return reinterpret_cast<EncodeTiled>(ptr)(
             map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
             es, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kK>
int check_launch(const void* a, const void* b, void* out, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!make_map(&ta, a, 64, kK) || !make_map(&tb, b, 256, kK)) return -1;
  const int smem = 320 * kK + 1024;
  cudaError_t err = cudaFuncSetAttribute(check_kernel<kK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  check_kernel<kK><<<1, 128, smem, s>>>(ta, tb, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
#endif  // PROBE == 1

#else  // PROBE == 2

constexpr int kRateThreads = 256;
constexpr int kRateSmem = 8 * 1024 * 4;
constexpr int kTiles = 8;  // independent m16n8 accumulators a warp
constexpr double kMacs = 16.0 * 8 * 256;
constexpr double kProductsPerRound = 8.0 * kTiles;  // per block: 8 warps

// Rate: 8 warps a block, each round loading A (4 words) and kTiles B
// fragments (2 words each) from shared memory and running kTiles products
// into independent accumulators.
__global__ void __launch_bounds__(256) rate_kernel(int rounds, int32_t* sink) {
  extern __shared__ uint8_t raw[];
  uint32_t* s = reinterpret_cast<uint32_t*>(raw);
  fill(raw, kRateSmem);
  const int lane = threadIdx.x & 31;
  int32_t acc[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
  for (int r = 0; r < rounds; ++r) {
    const uint32_t* p = s + 1024 * (r & 7);
    const uint4 a = reinterpret_cast<const uint4*>(p)[lane];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const uint2 b = reinterpret_cast<const uint2*>(p + 128)[(lane + 32 * t) & 255];
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[t][0]), "+r"(acc[t][1]), "+r"(acc[t][2]), "+r"(acc[t][3])
          : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
    }
  }
  int32_t x = 0;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) x ^= acc[t][0] ^ acc[t][1] ^ acc[t][2] ^ acc[t][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

#endif

}  // namespace

// Launch the rate kernel: `blocks` blocks of `rounds` rounds each.  Returns
// 0 or a cudaError_t code.
extern "C" int probe_rate(int blocks, int rounds, void* sink, void* stream) {
  static bool set = false;
  if (!set) {
    const cudaError_t err =
        cudaFuncSetAttribute(rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRateSmem);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  rate_kernel<<<blocks, kRateThreads, kRateSmem, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<int32_t*>(sink));
  return (int)cudaGetLastError();
}

// Bit (or int8) multiply-adds of one round of one block.
extern "C" double probe_macs_per_round() { return kMacs * kProductsPerRound; }

extern "C" int probe_threads() { return kRateThreads; }

// Probe 1 only: the check kernel at a depth of kk bytes (32, 64 or 128);
// a [64, kk] and b [256, kk] uint8, out [128, 128] int32.  Returns 0, a
// cudaError_t code, -1 (no tensor map) or -2 (no such probe or depth).
extern "C" int probe_check(int kk, const void* a, const void* b, void* out, void* stream) {
#if PROBE == 1
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk == 32) return check_launch<32>(a, b, out, s);
  if (kk == 64) return check_launch<64>(a, b, out, s);
  if (kk == 128) return check_launch<128>(a, b, out, s);
#endif
  return -2;
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
