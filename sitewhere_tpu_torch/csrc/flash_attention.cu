// Blockwise (flash) multi-head attention, forward: q, k, v [B, S, H, D] ->
// out [B, S, H, D], softmax(q k^T * scale) v with an optional causal mask,
// output in the input type.
//
// Replaces the TPU kernel sitewhere_tpu/ops/attention.py:_flash_kernel
// (driven by flash_attention). On the TPU the key-block axis is a sequential
// grid dimension that carries the running softmax state (m, l, acc) in VMEM
// scratch from one grid step to the next. Blocks of a CUDA grid run in no
// order, so here one block owns one (batch, head, tile of query rows) and
// walks the key tiles itself, with the running state in registers. Query
// tiles with the most causal work are launched first.
//
// Two kernels, chosen by dtype in swtpu_flash_attention:
//
// * bfloat16 (the transformer's path): tensor cores, FA2-style. A block of
//   4 warps owns 128 query rows, 32 per warp as two m16 row tiles that
//   share every K and V fragment the warp reads from shared memory (with
//   16 rows a warp, shared-memory reads per score matched the exponential
//   rate, and 64-row blocks read K/V from L2 twice as often). Q stays in
//   registers as the A fragments of mma.sync.m16n8k16 (bf16 in, float32
//   accumulate). K and V tiles of 64 keys go through a cp.async ring in
//   shared memory (3 stages at D <= 32, 2 at D = 64), so the next tiles'
//   copies overlap this tile's math; rows are padded by 16 bytes, so the
//   ldmatrix reads of 8 rows hit 8 different bank groups. A register cap
//   keeps 3 blocks (12 warps) an SM at D <= 32 to hide the dependent
//   product -> max -> exp -> product chain of each warp. S = Q K^T takes K
//   fragments from ldmatrix.x4; the
//   float32 scores get sm_scale*log2(e) inside the exp2 argument (one FFMA:
//   p = exp2(s*c - m*c)), as the TPU kernel scales float32 scores and not a
//   rounded q. That takes the running max over unscaled scores, so it needs
//   c > 0: a negative scale runs as its magnitude on -q (negating bf16 is
//   exact, done once on the Q fragments), and a zero scale as the smallest
//   normal float, which gives every live key p = exp2(~0) = 1 as zero does
//   while a masked (-inf) score keeps p = 0 (-inf * 0 would be NaN). The
//   running max and sum are per row in registers, the max
//   reduced across the 4 threads of a row with __shfl_xor_sync. P is
//   rounded to bf16 in registers and used directly as the A operand of the
//   P V mma (the m16n8 accumulator layout is the m16n8k16 A layout), with V
//   fragments from ldmatrix.x4.trans: P never goes through shared memory.
//   The output goes out through shared memory as 16-byte stores.
// * float32: one thread per query row on the CUDA cores, float32 products,
//   K/V tiles of 32 keys in shared memory. Tensor cores would mean TF32
//   (about 3 decimal digits), which the float32 contract (1e-5) does not
//   allow. Not on the transformer's path.
//
// q, k and v are read in place through base pointers and (batch, row, head)
// strides with unit stride on D, so the three strided views of one fused
// [B, S, 3, H, D] qkv product are read as they lie; the bf16 path needs each
// row 16-byte aligned (the wrapper checks). The output is written contiguous
// [B, S, H, D].
//
// Semantics kept from the TPU kernel and its oracle (mha_reference):
//   * causal: key tiles wholly above a block's rows are never loaded, a
//     warp skips a loaded tile wholly above its own rows, and the tiles on
//     the diagonal are masked per element. A masked entry of the oracle
//     (-1e30) contributes exp(-1e30 - m) = 0 once a real maximum is known,
//     which is what p = 0 gives; m starts at -1e30, not -inf, so a state
//     that has seen no key never computes exp(-inf - -inf);
//   * a row that has seen no key (l == 0) writes 0;
//   * any S: the tail of keys is zero-filled by the copy and masked (p = 0),
//     query rows past S load zeros and write nothing.
//
// Bound: operations. At the transformer's shape (B=8, S=16384, H=8, D=32,
// bf16, causal) there are 8.6e9 live (query, key) pairs: the kernel moves
// 268 MB (0.08 ms at 3.35 TB/s), does 1.1e12 product operations (1.1 ms at
// the 989 TFLOP/s bf16 tensor-core peak) and 8.6e9 exponentials (2.05 ms at
// 16 per SM per clock): the exponentials bind. The tensor cores take the
// products off the CUDA cores, leaving them the softmax: one FFMA, one max,
// one ex2.approx and one add per pair, half a bf16 pack and half a rescale
// multiply. With the mma and ldmatrix instructions that is about 6.7 warp
// instructions per 32 pairs, so the 4 schedulers of an SM dispatch about
// 19 pairs a clock against the 16 exponentials: instruction dispatch and
// the exponential unit bind together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {  // in elements; the stride of D is 1
  int64_t b, s, h;
};

// ------------------------------------------------------------------ float32

constexpr int kF32BlockQ = 128;  // query rows per block, one per thread
constexpr int kF32BlockK = 32;   // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kF32BlockQ)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int s, int h, int num_q_tiles, int num_bh,
                           Strides qs, Strides ks, Strides vs,
                           float scale_log2e, int causal) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  __shared__ __align__(16) float k_tile[kF32BlockK][D];
  __shared__ __align__(16) float v_tile[kF32BlockK][D];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int row = qt * kF32BlockQ + threadIdx.x;
  const bool live_row = row < s;

  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) qr[c] = acc[c] = 0.0f;
  if (live_row) {
    const float* qp = q + b * qs.b + static_cast<int64_t>(row) * qs.s + hd * qs.h;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = qp[c] * scale_log2e;
  }
  float m = kNegInf, l = 0.0f;

  // keys past the last row of this tile are masked for every row of it
  const int kv_end = causal ? min(s, (qt + 1) * kF32BlockQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kF32BlockK) {
    const int tile = min(kF32BlockK, kv_end - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kF32BlockK * D; e += kF32BlockQ) {
      const int r = e / D, c = e - (e / D) * D;
      float kx = 0.0f, vx = 0.0f;  // zeros past the tail: p = 0 times 0
      if (r < tile) {
        const int64_t off = static_cast<int64_t>(k0 + r);
        kx = kb[off * ks.s + c];
        vx = vb[off * vs.s + c];
      }
      k_tile[r][c] = kx;
      v_tile[r][c] = vx;
    }
    __syncthreads();

    const int n = causal ? min(tile, row + 1 - k0) : tile;  // live keys
    if (!live_row || n <= 0) continue;

    float p[kF32BlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
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
    for (int j = 0; j < kF32BlockK; ++j) {
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
  float* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = acc[c] / denom;
}

// ----------------------------------------------------------------- bfloat16

constexpr int kWarps = 4;
constexpr int kMTiles = 2;                     // m16 row tiles a warp
constexpr int kWarpRows = 16 * kMTiles;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = kWarpRows * kWarps;    // query rows per block
constexpr int kBlockN = 64;                    // keys per shared-memory tile
constexpr int kPad = 8;                        // bf16 of padding a shared row

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

// c += a b for one m16n8k16 tile: a row-major bf16 [16, 16], b column-major
// bf16 [16, 8], c float32 [16, 8]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int D>
struct Bf16Tile {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static constexpr int kRow = D + kPad;            // shared row, elements
  static constexpr int kStages = D <= 32 ? 3 : 2;  // cp.async ring depth
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  static constexpr int kElems = kBlockN * kRow;    // one K or V tile
  static constexpr int kCopies = kBlockN * kChunks;  // 16-byte copies a tile
  // blocks an SM must hold: at D <= 32 a cap of 168 registers keeps 3 (12
  // warps); at D = 64 that cap spills, so it runs uncapped (2 blocks)
  static constexpr int kMinBlocks = D <= 32 ? 3 : 1;
  static_assert(kBlockM <= 2 * kStages * kBlockN, "the output fits the ring");
};

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
// (g, 8+2t..), a[3] = (g+8, 8+2t..). B (16x8, col-major): b0 = (2t..2t+1,
// g), b1 = (8+2t.., g). C (16x8): c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8,
// 2t..2t+1). A warp owns kMTiles tiles of 16 rows, which share every K and
// V fragment it reads from shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, Bf16Tile<D>::kMinBlocks)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int s, int h,
                            int num_q_tiles, int num_bh, Strides qs,
                            Strides ks, Strides vs, float scale_log2e,
                            uint32_t q_sign, int causal) {
  using Tile = Bf16Tile<D>;
  constexpr int kRow = Tile::kRow, kStages = Tile::kStages;
  constexpr int kChunks = Tile::kChunks;
  constexpr int kNT = kBlockN / 8;  // 8-key column tiles of S
  constexpr int kDT = D / 8;        // 8-wide column tiles of O
  // [stage][0: K, 1: V][key][kRow]
  __shared__ __align__(128) __nv_bfloat16 smem[kStages][2][Tile::kElems];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_row = qt * kBlockM + warp * kWarpRows;  // the warp's first row

  const __nv_bfloat16* kb = k + b * ks.b + hd * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hd * vs.h;

  // Q as A fragments, loaded once (zeros for rows past S); q_sign flips
  // the sign of both bf16 halves of each register for a negative scale
  uint32_t qf[kMTiles][D / 16][4];
  {
    const __nv_bfloat16* qb = q + b * qs.b + hd * qs.h;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp_row + 16 * mt + g + 8 * r;
        const bool live = row < s;
        const uint32_t* qp = reinterpret_cast<const uint32_t*>(
            qb + static_cast<int64_t>(live ? row : 0) * qs.s);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          qf[mt][kk][r] = live ? __ldg(qp + kk * 8 + t) ^ q_sign : 0u;
          qf[mt][kk][r + 2] = live ? __ldg(qp + kk * 8 + 4 + t) ^ q_sign : 0u;
        }
      }
    }
  }

  // keys past the last row of this tile are masked for every row of it
  const int kv_len = causal ? min(s, (qt + 1) * kBlockM) : s;
  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;

  auto load_tile = [&](int tile, int stage) {
#pragma unroll
    for (int i = 0; i < (Tile::kCopies + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (Tile::kCopies % kThreads != 0 && e >= Tile::kCopies) break;
      const int r = e / kChunks, c = e % kChunks;
      const int key = tile * kBlockN + r;
      const bool valid = key < s;
      const int64_t src = valid ? key : 0;
      cp_async16(smem_addr(&smem[stage][0][r * kRow + c * 8]),
                 kb + src * ks.s + c * 8, valid);
      cp_async16(smem_addr(&smem[stage][1][r * kRow + c * 8]),
                 vb + src * vs.s + c * 8, valid);
    }
  };

  float o[kMTiles][kDT][4];
  float m[kMTiles][2], l[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int i = 0; i < kDT; ++i)
      o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.0f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();  // one group per slot, empty or not, keeps the count
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    __syncthreads();  // ... everyone's; and tile j-1's slot is free again
    if (j + kStages - 1 < n_tiles)
      load_tile(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();

    const int k0 = j * kBlockN;
    // a causal tile wholly above this warp's rows adds nothing to them
    if (causal && k0 > warp_row + kWarpRows - 1) continue;
    const __nv_bfloat16* kt = smem[j % kStages][0];
    const __nv_bfloat16* vt = smem[j % kStages][1];

    // S = Q K^T, [16 kMTiles, 64] a warp
    float sc[kMTiles][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        sc[mt][i][0] = sc[mt][i][1] = sc[mt][i][2] = sc[mt][i][3] = 0.0f;
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // matrices: keys 16p + 0..7 / 8..15 x d 16kk + 0..7 / 8..15
        const int key = 16 * p + (lane & 7) + ((lane >> 4) << 3);
        const int col = 16 * kk + ((lane >> 3) & 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4(smem_addr(kt + key * kRow + col), bf);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma_bf16(sc[mt][2 * p], qf[mt][kk], bf[0], bf[1]);
          mma_bf16(sc[mt][2 * p + 1], qf[mt][kk], bf[2], bf[3]);
        }
      }
    }

    // mask the diagonal tiles and the tail of keys
    if ((causal && k0 + kBlockN - 1 > warp_row) || k0 + kBlockN > s) {
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nt * 8 + 2 * t + (e & 1);
            const int row = warp_row + 16 * mt + g + 8 * (e >> 1);
            if (col >= s || (causal && col > row)) sc[mt][nt][e] = -INFINITY;
          }
    }

    uint32_t pf[kMTiles][kNT / 2][4];  // P as A fragments of the P V product
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      // streaming softmax: row maxima across the quad, rescale, p = exp2
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[mt][nt][0], sc[mt][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[mt][nt][2], sc[mt][nt][3]));
      }
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx((m[mt][r] - mx[r]) * scale_log2e);
        m[mt][r] = mx[r];
        mc[r] = mx[r] * scale_log2e;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float p0 = exp2_approx(fmaf(sc[mt][nt][0], scale_log2e, -mc[0]));
        const float p1 = exp2_approx(fmaf(sc[mt][nt][1], scale_log2e, -mc[0]));
        const float p2 = exp2_approx(fmaf(sc[mt][nt][2], scale_log2e, -mc[1]));
        const float p3 = exp2_approx(fmaf(sc[mt][nt][3], scale_log2e, -mc[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[mt][nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
        pf[mt][nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        o[mt][i][0] *= alpha[0];
        o[mt][i][1] *= alpha[0];
        o[mt][i][2] *= alpha[1];
        o[mt][i][3] *= alpha[1];
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        // matrices: keys 16kk + 0..7 / 8..15 x d 16p + 0..7 / 8..15,
        // transposed on the way to the registers
        const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = 16 * p + (lane >> 4) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(smem_addr(vt + key * kRow + col), bf);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma_bf16(o[mt][2 * p], pf[mt][kk], bf[0], bf[1]);
          mma_bf16(o[mt][2 * p + 1], pf[mt][kk], bf[2], bf[3]);
        }
      }
    }
  }

  // out = O / l, through shared memory (the ring's first slots, one
  // region) as 16-byte stores
  cp_async_wait<0>();
  __syncthreads();  // no warp reads a K/V tile any more
  __nv_bfloat16* ot = &smem[0][0][0] + warp * kWarpRows * kRow;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);  // o is 0 too
      const int srow = 16 * mt + g + 8 * r;
#pragma unroll
      for (int i = 0; i < kDT; ++i)
        *reinterpret_cast<uint32_t*>(&ot[srow * kRow + i * 8 + 2 * t]) =
            pack_bf16(o[mt][i][2 * r] * inv, o[mt][i][2 * r + 1] * inv);
    }
  }
  __syncwarp();  // each warp copies out its own rows
#pragma unroll
  for (int i = 0; i < kWarpRows * kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / kChunks, c = e % kChunks;
    const int row = warp_row + r;
    if (row < s)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D + c * 8) =
          *reinterpret_cast<const uint4*>(&ot[r * kRow + c * 8]);
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int s, int h, int num_bh, Strides qs, Strides ks,
                   Strides vs, float scale_log2e, int causal,
                   cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int block_q = kBf16 ? kBlockM : kF32BlockQ;
  const int64_t num_q_tiles = (static_cast<int64_t>(s) + block_q - 1) / block_q;
  if (num_q_tiles * num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(num_q_tiles * num_bh);
  if constexpr (kBf16) {
    // the kernel's scale must be > 0 (see the note at the top)
    const uint32_t q_sign = scale_log2e < 0.0f ? 0x80008000u : 0u;
    const float c = scale_log2e == 0.0f ? FLT_MIN : fabsf(scale_log2e);
    flash_attention_bf16_kernel<D><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        s, h, static_cast<int>(num_q_tiles), num_bh, qs, ks, vs, c, q_sign,
        causal);
  } else {
    flash_attention_f32_kernel<D><<<blocks, kF32BlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, h,
        static_cast<int>(num_q_tiles), num_bh, qs, ks, vs, scale_log2e,
        causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* out, int s, int h, int num_bh, Strides qs,
                     Strides ks, Strides vs, float scale_log2e, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, s, h, num_bh, qs, ks, vs,
                           scale_log2e, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, s, h, num_bh, qs, ks, vs,
                           scale_log2e, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, s, h, num_bh, qs, ks, vs,
                           scale_log2e, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [b, s, h, d] of float32 (is_bf16 == 0) or bfloat16 (is_bf16 ==
// 1) with element strides (*_sb, *_ss, *_sh) and unit stride on d; out:
// contiguous [b, s, h, d] of the same type; all on the device of
// ``stream``. d is 16, 32 or 64. bfloat16 also needs every base pointer
// 16-byte aligned and every stride a multiple of 8. scale_log2e = sm_scale
// * log2(e). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim or grid the kernels do not take).
extern "C" int swtpu_flash_attention(
    const void* q, const void* k, const void* v, void* out, int b, int s,
    int h, int d, int is_bf16, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale_log2e, int causal, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  const int64_t num_bh = static_cast<int64_t>(b) * h;
  if (num_bh > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(num_bh);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, out, s, h, bh, qs, ks, vs,
                                        scale_log2e, causal, st)
              : dispatch<float>(d, q, k, v, out, s, h, bh, qs, ks, vs,
                                scale_log2e, causal, st);
  return static_cast<int>(err);
}
