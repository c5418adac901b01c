// Building blocks shared by the flash-attention kernels
// (flash_attention.cu, the forward; flash_attention_bwd.cu, the backward):
// the (batch, row, head) strides of a [B, S, H, D] view, the constants, the
// shared-memory address, the exp2 and 16-bit pack helpers (both), and the
// cp.async copies, ldmatrix and the bf16 / fp16 mma.sync m16n8k16 product
// (the forward's mma.sync kernel), and the float32 kernels' tiling past
// D = 256.
// Each .cu file includes it and builds into a library of its own
// (cuda_build.py hashes this header with it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr float kLog2e = 1.442695040888963407f;

struct Strides {  // in elements; the stride of D is 1
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronous; zeros where !valid
// (nothing is read then, but src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: a row-major [16, 16], b column-major
// [16, 8], both of T (bf16 or fp16), c float32 [16, 8]
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats as a pair of T (bf16 or fp16), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// one element of float32, bf16 or fp16 as a float
template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (std::is_same_v<T, __half>) {
    return __half2float(x);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(x);
  } else {
    return x;
  }
}

// ------------------------------------------------ float32 past D = 256
//
// The float32 kernels past D = 256 (flash_attention_f32_wide_kernel,
// flash_bwd_*_f32_wide_kernel) split a row among kF32WideSplit adjacent
// threads and the output's columns into chunks of kF32Chunk (a grid
// axis); a dot over the whole D is summed in pieces of kF32Chunk columns,
// each thread's share first, across the row's threads once all pieces are
// in.
constexpr int kF32WideThreads = 128;                  // threads a block
constexpr int kF32Chunk = 128;                        // columns a chunk and a piece
constexpr int kF32WideSplit = 8;                      // threads a row
constexpr int kF32WideCols = kF32Chunk / kF32WideSplit;  // columns a thread
constexpr int kF32WideRows = kF32WideThreads / kF32WideSplit;  // rows a block or tile

// column c of a thread's kF32WideCols: its float4 chunk c / 4 is the
// piece's chunk (c / 4) 8 + part, so a row's threads read neighbouring 16
// bytes of a shared row
__device__ __forceinline__ int f32_wide_col(int c, int part) {
  return 4 * ((c / 4) * kF32WideSplit + part) + c % 4;
}

// the thread's kF32WideCols columns of one row's piece from global memory,
// times mul (zeros for a row past S)
__device__ __forceinline__ void f32_wide_row(const float* p, int part, bool live, float mul,
                                             float (&r)[kF32WideCols]) {
#pragma unroll
  for (int c = 0; c < kF32WideCols; ++c) r[c] = live ? p[f32_wide_col(c, part)] * mul : 0.0f;
}

// the thread's share of a dot over one piece: x (its columns) . row
// `tile`'s float4 chunks
__device__ __forceinline__ float f32_wide_dot(const float (&x)[kF32WideCols], const float* tile,
                                              int part, float acc) {
  const float4* r = reinterpret_cast<const float4*>(tile);
#pragma unroll
  for (int c = 0; c < kF32WideCols / 4; ++c) {
    const float4 y = r[c * kF32WideSplit + part];
    acc = fmaf(x[4 * c], y.x, acc);
    acc = fmaf(x[4 * c + 1], y.y, acc);
    acc = fmaf(x[4 * c + 2], y.z, acc);
    acc = fmaf(x[4 * c + 3], y.w, acc);
  }
  return acc;
}

// acc += w (the thread's columns of row `tile`)
__device__ __forceinline__ void f32_wide_axpy(float w, const float* tile, int part,
                                              float (&acc)[kF32WideCols]) {
  const float4* r = reinterpret_cast<const float4*>(tile);
#pragma unroll
  for (int c = 0; c < kF32WideCols / 4; ++c) {
    const float4 y = r[c * kF32WideSplit + part];
    acc[4 * c] = fmaf(w, y.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, y.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, y.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, y.w, acc[4 * c + 3]);
  }
}

// rows [r0, r0 + n) (zeros past n) of two [.., d] matrices, the piece of
// columns from col0, into two shared tiles [kF32WideRows][kF32Chunk]
__device__ __forceinline__ void f32_wide_load(float (*ta)[kF32Chunk], float (*tb)[kF32Chunk],
                                              const float* a, int64_t as, const float* b,
                                              int64_t bs, int r0, int n, int col0) {
  __syncthreads();  // the previous tiles are no longer read
  for (int e = threadIdx.x; e < kF32WideRows * kF32Chunk; e += kF32WideThreads) {
    const int r = e / kF32Chunk, c = e % kF32Chunk;
    const bool ok = r < n;
    const int64_t row = r0 + r;
    ta[r][c] = ok ? a[row * as + col0 + c] : 0.0f;
    if (tb != nullptr) tb[r][c] = ok ? b[row * bs + col0 + c] : 0.0f;
  }
  __syncthreads();
}

}  // namespace
