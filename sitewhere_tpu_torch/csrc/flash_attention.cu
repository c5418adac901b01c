// Blockwise (flash) multi-head attention, forward: q, k, v [B, S, H, D] ->
// out [B, S, H, D], softmax(q k^T * scale) v with an optional causal mask,
// float32 math on float32 or bfloat16 inputs, output in the input type.
//
// Replaces the TPU kernel sitewhere_tpu/ops/attention.py:_flash_kernel
// (driven by flash_attention). On the TPU the key-block axis is a sequential
// grid dimension that carries the running softmax state (m, l, acc) in VMEM
// scratch from one grid step to the next. Blocks of a CUDA grid run in no
// order, so here one block owns one (batch, head, tile of kBlockQ query
// rows) and walks the key tiles itself; each thread owns one query row and
// keeps its m, l and acc[D] in registers. K and V tiles are staged in shared
// memory, converted to float32 on load, and read by every thread of the
// block (one broadcast read per element for the whole warp).
//
// The TPU wrapper transposes to [B*H, S, D] and pads D to 128 lanes; both
// are lane artifacts of the TPU and would cost copies here. This kernel
// reads q, k and v in place through base pointers and (batch, row, head)
// strides with unit stride on D, so the three strided views of one fused
// [B, S, 3, H, D] qkv product are read as they lie. The output is written
// contiguous [B, S, H, D].
//
// Semantics kept from the TPU kernel and its oracle (mha_reference):
//   * causal: key tiles wholly above the diagonal are skipped; inside the
//     diagonal tile each row stops at its own column. A masked entry of the
//     oracle (-1e30) contributes exp(-1e30 - m) = 0 once a real maximum is
//     known, which is what skipping it gives; m starts at -1e30, not -inf,
//     so a state that has seen no key never computes exp(-inf - -inf).
//   * a row that has seen no key (l == 0) writes 0;
//   * any S: the tail tile of keys and of query rows is masked by bounds.
// The scale is folded into q together with log2(e), so each probability is
// one exp2 of (score - running max).
//
// Bound: operations. At the transformer's shape (B=8, S=16384, H=8, D=32,
// bf16, causal) the kernel moves 268 MB (0.08 ms at 3.35 TB/s) but does
// 4*D float operations and one exponential per live (query, key) pair:
// 8.6e9 exponentials are ~2 ms at the SFU rate (16 per SM per clock), and
// the products, done here in float32 on the CUDA cores (not the tensor
// cores), need ~16 ms at the 67 TFLOP/s FP32 peak. Tensor cores (mma.sync /
// wgmma), TMA and warp specialisation are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per block, one per thread
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

struct Strides {  // in elements; the stride of D is 1
  int64_t b, s, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
                       int h, int num_q_tiles, int num_bh, Strides qs,
                       Strides ks, Strides vs, float scale_log2e, int causal) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  __shared__ __align__(16) float k_tile[kBlockK][D];
  __shared__ __align__(16) float v_tile[kBlockK][D];

  // query tiles with the most causal work are launched first
  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int row = qt * kBlockQ + threadIdx.x;
  const bool live_row = row < s;

  const T* kb = k + b * ks.b + hd * ks.h;
  const T* vb = v + b * vs.b + hd * vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = acc[c] = 0.0f;
  if (live_row) {
    const T* qp = q + b * qs.b + static_cast<int64_t>(row) * qs.s + hd * qs.h;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = to_float(qp[c]) * scale_log2e;
  }
  float m = kNegInf, l = 0.0f;

  // keys past the last row of this tile are masked for every row of it
  const int kv_end = causal ? min(s, (qt + 1) * kBlockQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    const int tile = min(kBlockK, kv_end - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kBlockK * D; e += kBlockQ) {
      const int r = e / D, c = e - (e / D) * D;
      float kx = 0.0f, vx = 0.0f;  // zeros past the tail: p = 0 times 0
      if (r < tile) {
        const int64_t off = static_cast<int64_t>(k0 + r);
        kx = to_float(kb[off * ks.s + c]);
        vx = to_float(vb[off * vs.s + c]);
      }
      k_tile[r][c] = kx;
      v_tile[r][c] = vx;
    }
    __syncthreads();

    const int n = causal ? min(tile, row + 1 - k0) : tile;  // live keys
    if (!live_row || n <= 0) continue;

    float p[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      p[j] = j < n ? dot : kNegInf;
      tile_max = fmaxf(tile_max, p[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = j < n ? exp2f(p[j] - m_new) : 0.0f;
      l += pj;
      const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(pj, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pj, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pj, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pj, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!live_row) return;
  const float denom = l == 0.0f ? 1.0f : l;  // acc is 0 too when l == 0
  T* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) store(op + c, acc[c] / denom);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int s, int h, int num_q_tiles, int num_bh, Strides qs,
                   Strides ks, Strides vs, float scale_log2e, int causal,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(num_q_tiles) * num_bh;
  flash_attention_kernel<T, D><<<blocks, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, num_q_tiles,
      num_bh, qs, ks, vs, scale_log2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* out, int s, int h, int num_q_tiles, int num_bh,
                     Strides qs, Strides ks, Strides vs, float scale_log2e,
                     int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, s, h, num_q_tiles, num_bh, qs, ks,
                           vs, scale_log2e, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, s, h, num_q_tiles, num_bh, qs, ks,
                           vs, scale_log2e, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, s, h, num_q_tiles, num_bh, qs, ks,
                           vs, scale_log2e, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [b, s, h, d] of float32 (is_bf16 == 0) or bfloat16 (is_bf16 ==
// 1) with element strides (*_sb, *_ss, *_sh) and unit stride on d; out:
// contiguous [b, s, h, d] of the same type; all on the device of
// ``stream``. d is 16, 32 or 64. scale_log2e = sm_scale * log2(e).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim or grid the kernel does not take).
extern "C" int swtpu_flash_attention(
    const void* q, const void* k, const void* v, void* out, int b, int s,
    int h, int d, int is_bf16, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale_log2e, int causal, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  const int64_t num_q_tiles = (static_cast<int64_t>(s) + kBlockQ - 1) / kBlockQ;
  const int64_t num_bh = static_cast<int64_t>(b) * h;
  if (num_bh > INT32_MAX || num_q_tiles * num_bh > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, out, s, h,
                                        static_cast<int>(num_q_tiles),
                                        static_cast<int>(num_bh), qs, ks, vs,
                                        scale_log2e, causal, st)
              : dispatch<float>(d, q, k, v, out, s, h,
                                static_cast<int>(num_q_tiles),
                                static_cast<int>(num_bh), qs, ks, vs,
                                scale_log2e, causal, st);
  return static_cast<int>(err);
}
