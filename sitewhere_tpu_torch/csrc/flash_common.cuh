// Building blocks shared by the flash-attention kernels
// (flash_attention.cu, the forward; flash_attention_bwd.cu, the backward):
// the (batch, row, head) strides of a [B, S, H, D] view, the constants, the
// shared-memory address, the exp2 and 16-bit pack helpers (both), and the
// cp.async copies, ldmatrix and the bf16 / fp16 mma.sync m16n8k16 product
// (the forward's mma.sync kernel), and the register-tiled float32 kernels'
// copies and products.
// Each .cu file includes it and builds into a library of its own
// (cuda_build.py hashes this header with it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>
#include <utility>

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

// ------------------------------------------------ float32, register-tiled
//
// The float32 kernels from D = 128 on (the forward's
// flash_attention_f32_tiled_kernel and split kernel; the backward's one-pass
// kernel at D = 128 and flash_bwd_*_f32_tiled_kernel from 256 on) run
// float32 FMAs on the CUDA cores from shared memory: a thread keeps a small
// block of scores (4 rows by 4 or 8 rows of the other side) and of its
// outputs in registers, so each float4 it reads from shared memory feeds
// several independent FMA chains, and the tiles come through cp.async.

// (host) whether every row of the (batch, row, head)-strided views starts
// 16-byte aligned: the float32 kernels' cp.async copies are then 16 bytes
inline bool rows_aligned16(std::initializer_list<std::pair<const void*, Strides>> views) {
  for (const auto& [p, st] : views)
    if (reinterpret_cast<uintptr_t>(p) % 16 || st.b % 4 || st.s % 4 || st.h % 4) return false;
  return true;
}

// 4 bytes from global to shared memory, asynchronous; zero where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

// rows [r0, r0 + kRows) of a float32 matrix (row stride `stride` elements,
// unit stride along a row), columns [c0, c0 + kCols), into shared memory at
// dst (a row every `pitch` floats), asynchronously, by the block's
// kThreads threads; rows at or past n are zero-filled (nothing is read
// there). aligned: every row starts 16-byte aligned, so 16-byte copies,
// else 4-byte ones (float32 takes any alignment)
template <int kThreads, int kRows, int kCols>
__device__ __forceinline__ void f32_copy_rows(float* dst, int pitch, const float* src,
                                              int64_t stride, int r0, int n, int c0,
                                              bool aligned) {
  constexpr int kPerRow = kCols / 4;
  static_assert(kRows * kPerRow % kThreads == 0, "whole copies a thread");
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int i = 0; i < kRows * kPerRow / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kPerRow, c = (e % kPerRow) * 4;
    const bool ok = r0 + r < n;
    const float* g = src + (ok ? static_cast<int64_t>(r0 + r) * stride : 0) + c0 + c;
    const uint32_t d = base + (r * pitch + c) * 4;
    if (aligned) {
      cp_async16(d, g, ok);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) cp_async4(d + 4 * x, g + x, ok);
    }
  }
}

// acc[i][j] += a_i . b_j over kCols columns (i < kI, j < kJ): a_i the
// shared row a + i a_step, b_j the shared row b + j b_step, read a float4
// at a time: kI + kJ float4 reads feed 4 kI kJ FMAs in kI kJ independent
// chains. Each chain starts at 0 and runs over the columns in order, then
// adds to acc: a dot over a long D taken a piece of kCols at a time rounds
// like a sum of kCols terms plus one of D / kCols, not one of D terms
template <int kI, int kJ, int kCols>
__device__ __forceinline__ void f32_dots(float (&acc)[kI][kJ], const float* a, int a_step,
                                         const float* b, int b_step) {
  float part[kI][kJ] = {};
#pragma unroll 4
  for (int c = 0; c < kCols; c += 4) {
    float4 x[kI], y[kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i) x[i] = *reinterpret_cast<const float4*>(a + i * a_step + c);
#pragma unroll
    for (int j = 0; j < kJ; ++j) y[j] = *reinterpret_cast<const float4*>(b + j * b_step + c);
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        part[i][j] = fmaf(x[i].x, y[j].x, part[i][j]);
        part[i][j] = fmaf(x[i].y, y[j].y, part[i][j]);
        part[i][j] = fmaf(x[i].z, y[j].z, part[i][j]);
        part[i][j] = fmaf(x[i].w, y[j].w, part[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] += part[i][j];
}

// acc[r][m][c] += w[r] x_m[c]: 4 weights (w, a float4 in shared memory
// at the same address across a warp: one broadcast read) by kG float4s
// x_m of a shared row, x + 4 (lane + 32 m) (a warp's read of each is 512
// contiguous bytes)
template <int kG>
__device__ __forceinline__ void f32_outer(float (&acc)[4][kG][4], const float* w, const float* x,
                                          int lane) {
  const float4 ww = *reinterpret_cast<const float4*>(w);
  const float wr[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
  for (int m = 0; m < kG; ++m) {
    const float4 xx = *reinterpret_cast<const float4*>(x + 4 * (lane + 32 * m));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float (&a)[4] = acc[r][m];
      a[0] = fmaf(wr[r], xx.x, a[0]);
      a[1] = fmaf(wr[r], xx.y, a[1]);
      a[2] = fmaf(wr[r], xx.z, a[2]);
      a[3] = fmaf(wr[r], xx.w, a[3]);
    }
  }
}

}  // namespace
