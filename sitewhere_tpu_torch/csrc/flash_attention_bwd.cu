// Blockwise (flash) multi-head attention, backward: from q, k, v [B, S, H,
// D], the forward's output o, its gradient dO and each row's log-sum-exp
// lse [B, H, S] (flash_attention.cu writes it), the gradients dq, dk, dv
// [B, S, H, D] in the input type, with an optional causal mask.
//
// Replaces: no TPU kernel. The JAX package's trainer
// (sitewhere_tpu/models/transformer.py:153) takes jax.value_and_grad
// through flash_attention, which off the TPU is the oracle
// sitewhere_tpu/ops/attention.py:40 mha_reference; its Pallas kernel has no
// gradient of its own. This is the gradient of exact softmax attention,
// FA2's backward:
//
//   delta_i = sum_d dO_id O_id                 (a small pass, float32)
//   P_ij    = exp(scale q_i.k_j - lse_i)       (recomputed, never stored)
//   dV_j    = sum_i P_ij dO_i
//   dP_ij   = dO_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dK_j    = scale sum_i dS_ij q_i
//   dQ_i    = scale sum_j dS_ij k_j
//
// Three launches on the caller's stream: the delta pass (which also turns
// lse into base 2 for exp2), a dK/dV kernel and a dQ kernel. Each block of
// the dK/dV kernel owns (batch, head, 64 keys) and walks the query tiles;
// each block of the dQ kernel owns (batch, head, 64 query rows) and walks
// the key tiles. Two kernels and not one with atomic adds into dQ: every
// element is summed by one thread in a fixed order, so the result is the
// same from run to run, which the card-against-card checks need. Causal:
// the dK/dV kernel starts at the query tile of its first key, the dQ
// kernel stops at the key tile of its last row, and the tiles on the
// diagonal are masked per element. Masked (query, key) pairs have P = 0,
// as the oracle's -1e30 scores give once the softmax is taken.
//
// * bfloat16 (the transformer's path): tensor cores, mma.sync m16n8k16
//   (bf16 in, float32 accumulate), the forward's building blocks
//   (flash_common.cuh). A warp owns 16 rows (keys in dK/dV, queries in dQ)
//   whose operands stay in registers as A fragments; the other side's
//   64-row tiles come through a 2-stage cp.async ring in padded shared
//   memory and reach the tensor cores through ldmatrix (.trans where the
//   tile is the k dimension). dK/dV computes S^T = K Q^T and dP^T = V dO^T
//   so that P^T and dS^T come out in the accumulator layout, which is the
//   A layout of dV += P^T dO and dK += dS^T Q: P and dS never go through
//   shared memory; they are rounded to bf16 before those products, as the
//   forward rounds P. dQ computes S = Q K^T, dP = dO V^T and dQ += dS K
//   the same way. lse and delta come along as float32 rows of the tile.
// * float32: CUDA cores, float32 products (tensor cores would mean TF32,
//   about 3 decimal digits): one thread per key (dK/dV) or per query (dQ)
//   with its own row and accumulators in registers, the other side's
//   tiles of 32 rows in shared memory. At D = 64 the dK/dV thread holds
//   4 x 64 floats and spills; it is not on the transformer's path.
//
// q, k and v are read in place through (batch, row, head) strides with unit
// stride on D (the strided views of one fused qkv product); o and dO are
// contiguous [B, S, H, D]; dq, dk and dv are written contiguous. Any S;
// head dims 16, 32, 64. bf16 needs 16-byte aligned base pointers and
// strides that are a multiple of 8 elements.
//
// Bound: operations. At the transformer's shape (B=8, S=16384, H=8, D=32,
// bf16, causal) there are 8.6e9 live (query, key) pairs. The backward does
// five products a pair (S, dP, dV, dK, dQ; S is computed twice, once in
// each kernel, which the bound does not count), 2.5x the forward's 1.1e12
// operations: 2.75e12 at 989 TFLOP/s is 2.78 ms. It takes one exponential
// a live pair (2.05 ms at 16 per SM per clock; the two kernels each take
// one, 4.1 ms as written) and moves about 0.55 GB (0.16 ms). The design
// keeps every [S, S] intermediate in registers; what it leaves on the
// table is the second exponential and S product, and mma.sync instead of
// wgmma.

#include "flash_common.cuh"

namespace {

// ------------------------------------------------------------ delta pass

// delta[bh][i] = sum_d dO[b, i, h, d] O[b, i, h, d] and lse2[bh][i] =
// lse[bh][i] log2(e), one thread a (b, i, h) row
template <typename T, int D>
__global__ void flash_bwd_prep_kernel(const T* __restrict__ o,
                                      const T* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ delta,
                                      float* __restrict__ lse2, int64_t rows,
                                      int s, int h) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* op = o + r * D;
  const T* dp = dout + r * D;
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    if constexpr (sizeof(T) == 2) {
      acc = fmaf(__bfloat162float(op[c]), __bfloat162float(dp[c]), acc);
    } else {
      acc = fmaf(op[c], dp[c], acc);
    }
  }
  // r = (b s + i) h + hd  ->  (b h + hd) s + i
  const int64_t hd = r % h;
  const int64_t bi = r / h;
  const int64_t i = bi % s;
  const int64_t b = bi / s;
  const int64_t idx = (b * h + hd) * s + i;
  delta[idx] = acc;
  lse2[idx] = lse[idx] * kLog2e;
}

// ---------------------------------------------------------------- float32

constexpr int kF32Threads = 128;  // keys (dK/dV) or query rows (dQ) a block
constexpr int kF32Tile = 32;      // rows of the other side a shared tile

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s, int h, int num_bh, Strides qs, Strides ks,
                          Strides vs, float scale_log2e, float scale,
                          int causal) {
  __shared__ __align__(16) float q_tile[kF32Tile][D];
  __shared__ __align__(16) float do_tile[kF32Tile][D];
  __shared__ float lse_tile[kF32Tile], delta_tile[kF32Tile];

  const int bh = blockIdx.x % num_bh;
  const int kt = blockIdx.x / num_bh;  // the first key tiles have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const int key0 = kt * kF32Threads;
  const int key = key0 + threadIdx.x;
  const bool live_key = key < s;

  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) kr[c] = vr[c] = dkr[c] = dvr[c] = 0.0f;
  if (live_key) {
    const float* kp = k + b * ks.b + static_cast<int64_t>(key) * ks.s + hd * ks.h;
    const float* vp = v + b * vs.b + static_cast<int64_t>(key) * vs.s + hd * vs.h;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      kr[c] = kp[c] * scale_log2e;
      vr[c] = vp[c];
    }
  }
  const float* qb = q + b * qs.b + hd * qs.h;
  const float* db = dout + (static_cast<int64_t>(b) * s * h + hd) * D;
  const float* lb = lse2 + static_cast<int64_t>(bh) * s;
  const float* eb = delta + static_cast<int64_t>(bh) * s;

  // queries before the block's first key see none of its keys
  const int q_begin = causal ? (key0 / kF32Tile) * kF32Tile : 0;
  for (int q0 = q_begin; q0 < s; q0 += kF32Tile) {
    const int tile = min(kF32Tile, s - q0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kF32Tile * D; e += kF32Threads) {
      const int r = e / D, c = e - (e / D) * D;
      float qx = 0.0f, dx = 0.0f;
      if (r < tile) {
        const int64_t row = q0 + r;
        qx = qb[row * qs.s + c];
        dx = db[row * h * D + c];
      }
      q_tile[r][c] = qx;
      do_tile[r][c] = dx;
    }
    if (threadIdx.x < kF32Tile) {
      const bool ok = static_cast<int>(threadIdx.x) < tile;
      lse_tile[threadIdx.x] = ok ? lb[q0 + threadIdx.x] : 0.0f;
      delta_tile[threadIdx.x] = ok ? eb[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    if (!live_key) continue;
    for (int i = 0; i < tile; ++i) {
      if (causal && q0 + i < key) continue;  // masked: P = 0
      const float4* qr = reinterpret_cast<const float4*>(q_tile[i]);
      const float4* dr = reinterpret_cast<const float4*>(do_tile[i]);
      float sc = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 qq = qr[c], dd = dr[c];
        sc = fmaf(qq.x, kr[4 * c], sc);
        sc = fmaf(qq.y, kr[4 * c + 1], sc);
        sc = fmaf(qq.z, kr[4 * c + 2], sc);
        sc = fmaf(qq.w, kr[4 * c + 3], sc);
        dp = fmaf(dd.x, vr[4 * c], dp);
        dp = fmaf(dd.y, vr[4 * c + 1], dp);
        dp = fmaf(dd.z, vr[4 * c + 2], dp);
        dp = fmaf(dd.w, vr[4 * c + 3], dp);
      }
      const float p = exp2f(sc - lse_tile[i]);
      const float ds = p * (dp - delta_tile[i]);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 qq = qr[c], dd = dr[c];
        dvr[4 * c] = fmaf(p, dd.x, dvr[4 * c]);
        dvr[4 * c + 1] = fmaf(p, dd.y, dvr[4 * c + 1]);
        dvr[4 * c + 2] = fmaf(p, dd.z, dvr[4 * c + 2]);
        dvr[4 * c + 3] = fmaf(p, dd.w, dvr[4 * c + 3]);
        dkr[4 * c] = fmaf(ds, qq.x, dkr[4 * c]);
        dkr[4 * c + 1] = fmaf(ds, qq.y, dkr[4 * c + 1]);
        dkr[4 * c + 2] = fmaf(ds, qq.z, dkr[4 * c + 2]);
        dkr[4 * c + 3] = fmaf(ds, qq.w, dkr[4 * c + 3]);
      }
    }
  }
  if (!live_key) return;
  const int64_t off = ((static_cast<int64_t>(b) * s + key) * h + hd) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dk[off + c] = dkr[c] * scale;
    dv[off + c] = dvr[c];
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int s, int h, int num_q_tiles,
                        int num_bh, Strides qs, Strides ks, Strides vs,
                        float scale_log2e, float scale, int causal) {
  __shared__ __align__(16) float k_tile[kF32Tile][D];
  __shared__ __align__(16) float v_tile[kF32Tile][D];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;  // most work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int row = qt * kF32Threads + threadIdx.x;
  const bool live_row = row < s;

  float qr[D], dr[D], dqr[D];
  float l2 = 0.0f, dl = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = dr[c] = dqr[c] = 0.0f;
  if (live_row) {
    const float* qp = q + b * qs.b + static_cast<int64_t>(row) * qs.s + hd * qs.h;
    const float* dp = dout + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qr[c] = qp[c] * scale_log2e;
      dr[c] = dp[c];
    }
    l2 = lse2[static_cast<int64_t>(bh) * s + row];
    dl = delta[static_cast<int64_t>(bh) * s + row];
  }
  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;

  // keys past the block's last row are masked for every row of it
  const int kv_end = causal ? min(s, (qt + 1) * kF32Threads) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kF32Tile) {
    const int tile = min(kF32Tile, kv_end - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kF32Tile * D; e += kF32Threads) {
      const int r = e / D, c = e - (e / D) * D;
      float kx = 0.0f, vx = 0.0f;
      if (r < tile) {
        const int64_t off = static_cast<int64_t>(k0 + r);
        kx = kb[off * ks.s + c];
        vx = vb[off * vs.s + c];
      }
      k_tile[r][c] = kx;
      v_tile[r][c] = vx;
    }
    __syncthreads();
    if (!live_row) continue;
    const int n = causal ? min(tile, row + 1 - k0) : tile;  // live keys
    for (int j = 0; j < n; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
      const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
      float sc = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 kk = kr[c], vv = vr[c];
        sc = fmaf(qr[4 * c], kk.x, sc);
        sc = fmaf(qr[4 * c + 1], kk.y, sc);
        sc = fmaf(qr[4 * c + 2], kk.z, sc);
        sc = fmaf(qr[4 * c + 3], kk.w, sc);
        dp = fmaf(dr[4 * c], vv.x, dp);
        dp = fmaf(dr[4 * c + 1], vv.y, dp);
        dp = fmaf(dr[4 * c + 2], vv.z, dp);
        dp = fmaf(dr[4 * c + 3], vv.w, dp);
      }
      const float ds = exp2f(sc - l2) * (dp - dl);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 kk = kr[c];
        dqr[4 * c] = fmaf(ds, kk.x, dqr[4 * c]);
        dqr[4 * c + 1] = fmaf(ds, kk.y, dqr[4 * c + 1]);
        dqr[4 * c + 2] = fmaf(ds, kk.z, dqr[4 * c + 2]);
        dqr[4 * c + 3] = fmaf(ds, kk.w, dqr[4 * c + 3]);
      }
    }
  }
  if (!live_row) return;
  float* out = dq + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) out[c] = dqr[c] * scale;
}

// --------------------------------------------------------------- bfloat16

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // a block's own rows, 16 a warp
constexpr int kTileN = 64;          // rows of the other side a shared tile
constexpr int kNT = kTileN / 8;     // 8-wide column tiles of S (or S^T)
constexpr int kStages = 2;          // cp.async ring depth
constexpr int kPad = 8;             // bf16 of padding a shared row

template <int D>
struct BwdTile {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static constexpr int kRow = D + kPad;          // shared row, elements
  static constexpr int kChunks = D / 8;          // 16-byte chunks a row
  static constexpr int kElems = kTileN * kRow;   // one tile
  static constexpr int kCopies = kTileN * kChunks;
};

// A fragments (m16n8k16, row-major A) of 16 rows x D of a strided [., S, .,
// D] view: the forward's Q load. Rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* base,
                                             int64_t row_stride, int row0,
                                             int s, int g, int t,
                                             uint32_t (&f)[D / 16][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool live = row < s;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(
        base + static_cast<int64_t>(live ? row : 0) * row_stride);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      f[kk][r] = live ? __ldg(p + kk * 8 + t) : 0u;
      f[kk][r + 2] = live ? __ldg(p + kk * 8 + 4 + t) : 0u;
    }
  }
}

// c[nt] += A (16 x D, registers) times tile^T (tile: kTileN rows x D in
// shared memory): [16, kTileN] in the accumulator layout
template <int D>
__device__ __forceinline__ void mma_a_tile_t(const uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int lane, float (&c)[kNT][4]) {
  constexpr int kRow = BwdTile<D>::kRow;
#pragma unroll
  for (int p = 0; p < kNT / 2; ++p) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // matrices: rows 16p + 0..7 / 8..15 x d 16kk + 0..7 / 8..15
      const int row = 16 * p + (lane & 7) + ((lane >> 4) << 3);
      const int col = 16 * kk + ((lane >> 3) & 1) * 8;
      uint32_t bf[4];
      ldmatrix_x4(smem_addr(tile + row * kRow + col), bf);
      mma_bf16(c[2 * p], a[kk], bf[0], bf[1]);
      mma_bf16(c[2 * p + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// acc[i] += A (16 x kTileN, bf16 fragments from the accumulator layout)
// times tile (kTileN rows x D in shared memory): [16, D]
template <int D>
__device__ __forceinline__ void mma_frags_tile(const uint32_t (&a)[kNT / 2][4],
                                               const __nv_bfloat16* tile,
                                               int lane,
                                               float (&acc)[D / 8][4]) {
  constexpr int kRow = BwdTile<D>::kRow;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      // matrices: rows 16kk + 0..7 / 8..15 x d 16p + 0..7 / 8..15,
      // transposed on the way to the registers
      const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = 16 * p + (lane >> 4) * 8;
      uint32_t bf[4];
      ldmatrix_x4_trans(smem_addr(tile + row * kRow + col), bf);
      mma_bf16(acc[2 * p], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * p + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// accumulator tiles as A fragments of the next product: the m16n8
// accumulator layout is the m16n8k16 A layout
__device__ __forceinline__ void pack_frags(const float (&c)[kNT][4],
                                           uint32_t (&f)[kNT / 2][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    f[nt / 2][(nt & 1) * 2] = pack_bf16(c[nt][0], c[nt][1]);
    f[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// a warp's [16, D] float32 accumulator, times mul, as bf16 rows of a
// contiguous [B, S, H, D] tensor (rows past S are not written)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float mul, __nv_bfloat16* out,
                                           int b, int row0, int s, int h,
                                           int hd, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* p = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(p + i * 8 + 2 * t) =
          pack_bf16(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t;
// accumulator c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1). In this
// kernel the 16 rows of a warp are keys and the columns queries.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse2,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int s, int h,
                           int num_bh, Strides qs, Strides ks, Strides vs,
                           float scale_log2e, float scale, int causal) {
  using Tile = BwdTile<D>;
  constexpr int kRow = Tile::kRow, kChunks = Tile::kChunks;
  // [stage][0: Q, 1: dO][query][kRow]; [stage][0: lse2, 1: delta][query]
  __shared__ __align__(128) __nv_bfloat16 smem[kStages][2][Tile::kElems];
  __shared__ __align__(16) float rows[kStages][2][kTileN];

  const int bh = blockIdx.x % num_bh;
  const int kt = blockIdx.x / num_bh;  // the first key tiles have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = kt * kRows;
  const int warp_key = key0 + 16 * warp;  // the warp's first key

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(k + b * ks.b + hd * ks.h, ks.s, warp_key, s, g, t, kf);
  load_a_frags<D>(v + b * vs.b + hd * vs.h, vs.s, warp_key, s, g, t, vf);

  const __nv_bfloat16* qb = q + b * qs.b + hd * qs.h;
  const __nv_bfloat16* db = dout + (static_cast<int64_t>(b) * s * h + hd) * D;
  const float* lb = lse2 + static_cast<int64_t>(bh) * s;
  const float* eb = delta + static_cast<int64_t>(bh) * s;

  auto load_tile = [&](int tile, int stage) {
#pragma unroll
    for (int i = 0; i < (Tile::kCopies + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (Tile::kCopies % kThreads != 0 && e >= Tile::kCopies) break;
      const int r = e / kChunks, c = e % kChunks;
      const int row = tile * kTileN + r;
      const bool valid = row < s;
      const int64_t src = valid ? row : 0;
      cp_async16(smem_addr(&smem[stage][0][r * kRow + c * 8]),
                 qb + src * qs.s + c * 8, valid);
      cp_async16(smem_addr(&smem[stage][1][r * kRow + c * 8]),
                 db + src * h * D + c * 8, valid);
    }
    if (threadIdx.x < 2 * kTileN) {
      const int which = threadIdx.x / kTileN, r = threadIdx.x % kTileN;
      const int row = tile * kTileN + r;
      const bool valid = row < s;
      cp_async4(smem_addr(&rows[stage][which][r]),
                (which == 0 ? lb : eb) + (valid ? row : 0), valid);
    }
  };

  float dkc[D / 8][4], dvc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkc[i][e] = dvc[i][e] = 0.0f;

  // queries before the block's first key see none of its keys
  const int first = causal ? key0 / kTileN : 0;
  const int n_tiles = (s + kTileN - 1) / kTileN;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (first + st < n_tiles) load_tile(first + st, st);
    cp_async_commit();  // one group per slot, empty or not, keeps the count
  }

  for (int j = first; j < n_tiles; ++j) {
    const int it = j - first;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    __syncthreads();  // ... everyone's; and tile j-1's slot is free again
    if (j + kStages - 1 < n_tiles)
      load_tile(j + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int q0 = j * kTileN;
    // a causal tile wholly before this warp's keys adds nothing to them
    if (causal && q0 + kTileN - 1 < warp_key) continue;
    const __nv_bfloat16* qt = smem[it % kStages][0];
    const __nv_bfloat16* dt = smem[it % kStages][1];
    const float* lt = rows[it % kStages][0];
    const float* et = rows[it % kStages][1];

    float sc[kNT][4], dp[kNT][4];  // S^T, dP^T: [16 keys, 64 queries]
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.0f;
    mma_a_tile_t<D>(kf, qt, lane, sc);
    mma_a_tile_t<D>(vf, dt, lane, dp);

    const bool edge = (causal && q0 < warp_key + 15) || q0 + kTileN > s;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = exp2_approx(fmaf(sc[nt][e], scale_log2e, -lt[col]));
        if (edge) {
          const int query = q0 + col, key = warp_key + g + 8 * (e >> 1);
          if (query >= s || (causal && query < key)) p = 0.0f;
        }
        sc[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - et[col]);
      }
    }
    uint32_t pf[kNT / 2][4], sf[kNT / 2][4];
    pack_frags(sc, pf);
    pack_frags(dp, sf);
    mma_frags_tile<D>(pf, dt, lane, dvc);  // dV += P^T dO
    mma_frags_tile<D>(sf, qt, lane, dkc);  // dK += dS^T Q
  }
  cp_async_wait<0>();

  store_rows<D>(dkc, scale, dk, b, warp_key, s, h, hd, g, t);
  store_rows<D>(dvc, 1.0f, dv, b, warp_key, s, h, hd, g, t);
}

// The rows of a warp are queries and the columns keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int s, int h,
                         int num_q_tiles, int num_bh, Strides qs, Strides ks,
                         Strides vs, float scale_log2e, float scale,
                         int causal) {
  using Tile = BwdTile<D>;
  constexpr int kRow = Tile::kRow, kChunks = Tile::kChunks;
  // [stage][0: K, 1: V][key][kRow]
  __shared__ __align__(128) __nv_bfloat16 smem[kStages][2][Tile::kElems];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;  // most work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_row = qt * kRows + 16 * warp;  // the warp's first row

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D>(q + b * qs.b + hd * qs.h, qs.s, warp_row, s, g, t, qf);
  load_a_frags<D>(dout + (static_cast<int64_t>(b) * s * h + hd) * D,
                  static_cast<int64_t>(h) * D, warp_row, s, g, t, df);
  float l2[2], dl[2];  // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp_row + g + 8 * r;
    const int64_t idx = static_cast<int64_t>(bh) * s + (row < s ? row : 0);
    l2[r] = row < s ? __ldg(lse2 + idx) : 0.0f;
    dl[r] = row < s ? __ldg(delta + idx) : 0.0f;
  }

  const __nv_bfloat16* kb = k + b * ks.b + hd * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hd * vs.h;
  auto load_tile = [&](int tile, int stage) {
#pragma unroll
    for (int i = 0; i < (Tile::kCopies + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (Tile::kCopies % kThreads != 0 && e >= Tile::kCopies) break;
      const int r = e / kChunks, c = e % kChunks;
      const int key = tile * kTileN + r;
      const bool valid = key < s;
      const int64_t src = valid ? key : 0;
      cp_async16(smem_addr(&smem[stage][0][r * kRow + c * 8]),
                 kb + src * ks.s + c * 8, valid);
      cp_async16(smem_addr(&smem[stage][1][r * kRow + c * 8]),
                 vb + src * vs.s + c * 8, valid);
    }
  };

  float dqc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqc[i][e] = 0.0f;

  // keys past the block's last row are masked for every row of it
  const int kv_len = causal ? min(s, (qt + 1) * kRows) : s;
  const int n_tiles = (kv_len + kTileN - 1) / kTileN;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n_tiles)
      load_tile(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();

    const int k0 = j * kTileN;
    // a causal tile wholly after this warp's rows adds nothing to them
    if (causal && k0 > warp_row + 15) continue;
    const __nv_bfloat16* kt = smem[j % kStages][0];
    const __nv_bfloat16* vt = smem[j % kStages][1];

    float sc[kNT][4], dp[kNT][4];  // S, dP: [16 rows, 64 keys]
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.0f;
    mma_a_tile_t<D>(qf, kt, lane, sc);
    mma_a_tile_t<D>(df, vt, lane, dp);

    const bool edge = (causal && k0 + kTileN - 1 > warp_row) || k0 + kTileN > s;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2_approx(fmaf(sc[nt][e], scale_log2e, -l2[r]));
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = warp_row + g + 8 * r;
          if (key >= s || (causal && key > row)) p = 0.0f;
        }
        dp[nt][e] = p * (dp[nt][e] - dl[r]);
      }
    }
    uint32_t sf[kNT / 2][4];
    pack_frags(dp, sf);
    mma_frags_tile<D>(sf, kt, lane, dqc);  // dQ += dS K
  }
  cp_async_wait<0>();

  store_rows<D>(dqc, scale, dq, b, warp_row, s, h, hd, g, t);
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *delta, *lse2;
  int s, h, num_bh;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int64_t rows = static_cast<int64_t>(a.num_bh) * a.s;
  const int64_t prep_blocks = (rows + 255) / 256;
  if (prep_blocks > INT32_MAX) return cudaErrorInvalidValue;
  flash_bwd_prep_kernel<T, D><<<static_cast<unsigned>(prep_blocks), 256, 0,
                                a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.lse2, rows, a.s, a.h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int rows_a_block = kBf16 ? kRows : kF32Threads;
  const int64_t num_tiles = (static_cast<int64_t>(a.s) + rows_a_block - 1) / rows_a_block;
  if (num_tiles * a.num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(num_tiles * a.num_bh);
  const float scale_log2e = a.scale * kLog2e;
  if constexpr (kBf16) {
    using B = __nv_bfloat16;
    flash_bwd_dkdv_bf16_kernel<D><<<blocks, kThreads, 0, a.stream>>>(
        static_cast<const B*>(a.q), static_cast<const B*>(a.k),
        static_cast<const B*>(a.v), static_cast<const B*>(a.dout), a.lse2,
        a.delta, static_cast<B*>(a.dk), static_cast<B*>(a.dv), a.s, a.h,
        a.num_bh, a.qs, a.ks, a.vs, scale_log2e, a.scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D><<<blocks, kThreads, 0, a.stream>>>(
        static_cast<const B*>(a.q), static_cast<const B*>(a.k),
        static_cast<const B*>(a.v), static_cast<const B*>(a.dout), a.lse2,
        a.delta, static_cast<B*>(a.dq), a.s, a.h, static_cast<int>(num_tiles),
        a.num_bh, a.qs, a.ks, a.vs, scale_log2e, a.scale, a.causal);
  } else {
    flash_bwd_dkdv_f32_kernel<D><<<blocks, kF32Threads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse2, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.s, a.h, a.num_bh, a.qs, a.ks, a.vs, scale_log2e, a.scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D><<<blocks, kF32Threads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse2, a.delta, static_cast<float*>(a.dq), a.s, a.h,
        static_cast<int>(num_tiles), a.num_bh, a.qs, a.ks, a.vs, scale_log2e,
        a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const Args& a) {
  switch (d) {
    case 16:
      return launch<T, 16>(a);
    case 32:
      return launch<T, 32>(a);
    case 64:
      return launch<T, 64>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [b, s, h, d] of float32 (is_bf16 == 0) or bfloat16 (is_bf16 ==
// 1) with element strides (*_sb, *_ss, *_sh) and unit stride on d; o and
// dout: contiguous [b, s, h, d] of that type (the forward's output and its
// gradient); lse: [b, h, s] float32, the forward's log-sum-exp (natural
// log); dq, dk, dv: contiguous [b, s, h, d] of that type, written whole;
// scratch: 2 b h s float32 (delta, then lse in base 2); all on the device
// of ``stream``. d is 16, 32 or 64; bfloat16 also needs every base pointer
// 16-byte aligned and every stride a multiple of 8. sm_scale is the
// forward's scale (any sign). Returns the first cudaGetLastError() that is
// not cudaSuccess after each of the three launches
// (cudaErrorInvalidValue for a head dim or grid the kernels do not take).
extern "C" int swtpu_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, int b, int s, int h, int d, int is_bf16, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float sm_scale, int causal,
    void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  const int64_t num_bh = static_cast<int64_t>(b) * h;
  if (num_bh > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = num_bh * s;
  Args a{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + rows, s, h,
         static_cast<int>(num_bh), Strides{q_sb, q_ss, q_sh},
         Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, sm_scale,
         causal, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(d, a) : dispatch<float>(d, a);
  return static_cast<int>(err);
}
