// Hopper building blocks shared by the flash-attention kernels on wgmma
// and TMA (flash_attention.cu, the forward at D = 64, 128 and 256; flash_attention_bwd.cu,
// the backward; both in bf16 and fp16): mbarriers, TMA and bulk copies, the
// turn counters' acquire / release, named barriers, the wgmma wrappers and
// shared-memory matrix descriptors, and the host-side tensor maps of a
// strided [B, S, H, D] view. Each .cu file includes it and builds into a
// library of its own (cuda_build.py hashes every csrc/*.cuh with each
// source).
//
// Layout rule of every tile these kernels read through TMA: a box is
// min(D, 64) columns of 16-bit elements, so a box row is 32, 64 or 128
// bytes and the box is swizzled by its row width (the tensor map's
// CU_TENSOR_MAP_SWIZZLE_* and the descriptor's layout type agree). At
// D = 128 a row is 256 bytes, wider than the largest swizzle, so a tile is
// two boxes of 64 columns (the "d-boxes"), one after the other (four at
// D = 256): a K-major operand steps to the next box after every 4 of its
// k16 steps, and an MN-major operand spans two boxes through the
// descriptor's leading byte offset (the stride from one 64-column swizzle
// atom to the next; a product of N = 128 columns starts at box 0 or 2).

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace {

// -- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a wait that lasts this many SM clocks (~10 s) traps: a fault the caller
// sees, where a lost arrival or turn would otherwise hang the card
constexpr long long kWatchdogClocks = 1ll << 34;

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogClocks) __trap();
}

// wait until the barrier's phase with this parity has completed, with no
// watchdog: for the compute warpgroups of a kernel whose every wait they
// can block on is also awaited, with the watchdog, by a producer warp (its
// trap ends the grid). A trap on their path makes ptxas hold their
// registers well below what setmaxnreg gives, and it spills the
// accumulators.
__device__ __forceinline__ void mbar_spin(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// -- TMA and bulk copies -------------------------------------------------

// a box of a 4-d (d, head, row, batch) tensor map into shared memory,
// swizzled as the map says; completes `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at named barrier `id` without waiting; `threads` counts the
// arriving and the waiting threads together
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma operands, bulk copies out)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers an asynchronous wgmma writes: no read moves above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// register A operands an asynchronous wgmma reads: kept (not reused for
// other values) until this point, which follows the wait
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// shared memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the layout (swizzle) type in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// wgmma m64nNk16, 16-bit inputs (bf16 or fp16: T), float32 accumulators:
// d[4 j + r] of a thread (lane = 4 g + t, warp w of the warpgroup) is row
// 16 w + g + 8 (r >> 1), column 8 j + 2 t + (r & 1); the register A
// fragment of a k16 step is the mma.m16n8k16 one, so an accumulator's
// columns 16 kk .. 16 kk + 15, packed in pairs, are the A operand of the
// next product's step kk. The instruction text of each width, its input
// type (TY: "bf16" or "f16") left open, and the accumulators as operands:
#define SWTPU_WGMMA_SS_16(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
#define SWTPU_WGMMA_RS_16(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
#define SWTPU_WGMMA_SS_32(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
#define SWTPU_WGMMA_RS_32(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
#define SWTPU_WGMMA_SS_64(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
#define SWTPU_WGMMA_RS_64(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
#define SWTPU_WGMMA_SS_128(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
#define SWTPU_WGMMA_RS_128(TY)                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
#define SWTPU_ACC8(o) \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
  "+f"(d[o + 6]), "+f"(d[o + 7])
#define SWTPU_ACC_16 SWTPU_ACC8(0)
#define SWTPU_ACC_32 SWTPU_ACC8(0), SWTPU_ACC8(8)
#define SWTPU_ACC_64 SWTPU_ACC8(0), SWTPU_ACC8(8), SWTPU_ACC8(16), SWTPU_ACC8(24)
#define SWTPU_ACC_128 SWTPU_ACC8(0), SWTPU_ACC8(8), SWTPU_ACC8(16), SWTPU_ACC8(24), SWTPU_ACC8(32), SWTPU_ACC8(40), SWTPU_ACC8(48), SWTPU_ACC8(56)
// the asm of one product with T's input type; the operands follow
#define SWTPU_WGMMA_ASM(TEXT, ACC, ...)                         \
  if constexpr (std::is_same_v<T, __half>)                      \
    asm volatile(TEXT("f16") : ACC : __VA_ARGS__);              \
  else                                                          \
    asm volatile(TEXT("bf16") : ACC : __VA_ARGS__)

template <int N>
struct Wgmma {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N must be 16, 32, 64 or 128");
  // d [64, N] (+)= A (shared, descriptor a) B (shared, descriptor b)
  template <int kTransA, int kTransB, typename T = __nv_bfloat16>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int accumulate) {
    if constexpr (N == 16) {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_SS_16, SWTPU_ACC_16, "l"(a), "l"(b), "r"(accumulate),
                      "n"(kTransA), "n"(kTransB));
    } else if constexpr (N == 32) {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_SS_32, SWTPU_ACC_32, "l"(a), "l"(b), "r"(accumulate),
                      "n"(kTransA), "n"(kTransB));
    } else if constexpr (N == 64) {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_SS_64, SWTPU_ACC_64, "l"(a), "l"(b), "r"(accumulate),
                      "n"(kTransA), "n"(kTransB));
    } else {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_SS_128, SWTPU_ACC_128, "l"(a), "l"(b), "r"(accumulate),
                      "n"(kTransA), "n"(kTransB));
    }
  }
  // d [64, N] += A (registers, the m64k16 fragment) B (shared, descriptor b)
  template <int kTransB, typename T = __nv_bfloat16>
  static __device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    if constexpr (N == 16) {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_RS_16, SWTPU_ACC_16, "r"(a[0]), "r"(a[1]), "r"(a[2]),
                      "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
    } else if constexpr (N == 32) {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_RS_32, SWTPU_ACC_32, "r"(a[0]), "r"(a[1]), "r"(a[2]),
                      "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
    } else if constexpr (N == 64) {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_RS_64, SWTPU_ACC_64, "r"(a[0]), "r"(a[1]), "r"(a[2]),
                      "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
    } else {
      SWTPU_WGMMA_ASM(SWTPU_WGMMA_RS_128, SWTPU_ACC_128, "r"(a[0]), "r"(a[1]), "r"(a[2]),
                      "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
    }
  }
};

// the accumulator's 16 kk .. 16 kk + 15 columns as A fragments of T
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&c)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack2<T>(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
  }
}

// -- tensor maps (host) ---------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, S, H, D] view of T (bf16 or fp16; element strides st, unit stride
// on D) as a 4-d (d, head, row, batch) tensor map whose box is `rows` rows
// of one head and min(D, 64) columns (a d-box), swizzled by the box's row
// width; rows past S read as zeros
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int b, int s, int h, int d,
                Strides st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int cols = d < 64 ? d : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type = std::is_same_v<T, __half>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 4, const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
