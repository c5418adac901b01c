// Blockwise (flash) multi-head attention, forward: q, k, v [B, S, H, D] ->
// out [B, S, H, D], softmax(q k^T * scale) v with an optional causal mask,
// output in the input type; optionally also each row's log-sum-exp of its
// scaled scores, lse [B, H, S] float32 in the natural log, which the
// backward (flash_attention_bwd.cu) recomputes P from.
//
// Replaces the TPU kernel sitewhere_tpu/ops/attention.py:_flash_kernel
// (driven by flash_attention). On the TPU the key-block axis is a sequential
// grid dimension that carries the running softmax state (m, l, acc) in VMEM
// scratch from one grid step to the next. Blocks of a CUDA grid run in no
// order, so here one block owns one (batch, head, tile of query rows) and
// walks the key tiles itself, with the running state in registers. Query
// tiles with the most causal work are launched first.
//
// Three kernels, chosen by dtype and head dim in swtpu_flash_attention:
//
// * bfloat16 and float16 at D = 64, 128 and 256: FA3's forward on wgmma
//   and TMA, warp-specialised, with the softmax of one compute warpgroup
//   running under the other's products and, within a warpgroup, under its
//   own P V product of the tile before (flash_attention_wgmma_kernel<T, D>
//   below; the note there; 64-key tiles at D = 256). At D = 128 and 256
//   the products bind (at [8, 16384, 2, 128] causal 1.112 ms of products
//   against 0.51 ms of exponentials; at [8, 16384, 1, 256] 1.112 against
//   0.257); at D = 64 the two cost about the same (at [8, 16384, 4, 64]
//   causal 1.112 ms and 1.028 ms), so only a kernel that overlaps them
//   comes near the bound, and only wgmma reaches the tensor cores' full
//   rate.
// * bfloat16 and float16 at D = 16 and 32 (bf16 is the default
//   transformer's path; the same kernel on float16 fragments and the
//   float16 mma): tensor cores, FA2-style on mma.sync. A block of
//   4 warps owns 128 query rows, 32 per warp as two m16 row tiles that
//   share every K and V fragment the warp reads from shared memory (with
//   16 rows a warp, shared-memory reads per score matched the exponential
//   rate, and 64-row blocks read K/V from L2 twice as often). Q stays in
//   registers as the A fragments of mma.sync.m16n8k16 (bf16 in, float32
//   accumulate). K and V tiles of 64 keys go through a 3-stage cp.async
//   ring in shared memory, so the next tiles'
//   copies overlap this tile's math; rows are padded by 16 bytes, so the
//   ldmatrix reads of 8 rows hit 8 different bank groups. A register cap
//   keeps 3 blocks (12 warps) an SM to hide the dependent
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
// * float32: one thread per query row on the CUDA cores (at D = 256 four
//   threads a row, 64 columns each), float32 products, K/V tiles of 32 keys
//   (16 at D = 256) in shared memory. Tensor cores would mean TF32 (about 3
//   decimal digits), which the float32 contract (1e-5) does not allow. Not
//   on the transformer's path.
//
// q, k and v are read in place through base pointers and (batch, row, head)
// strides with unit stride on D, so the three strided views of one fused
// [B, S, 3, H, D] qkv product are read as they lie; the 16-bit path needs each
// row 16-byte aligned (the wrapper checks). The output is written contiguous
// [B, S, H, D]. Head dims 16, 32, 64, 128 and 256; the wrapper pads any
// other D up to 256 with zero lanes (ops/attention.py:padded_head_dim).
//
// Semantics kept from the TPU kernel and its oracle (mha_reference):
//   * causal: key tiles wholly above a block's rows are never loaded, a
//     warp skips a loaded tile wholly above its own rows, and the tiles on
//     the diagonal are masked per element. A masked entry of the oracle
//     (-1e30) contributes exp(-1e30 - m) = 0 once a real maximum is known,
//     which is what p = 0 gives; m starts at -1e30, not -inf, so a state
//     that has seen no key never computes exp(-inf - -inf);
//   * a row that has seen no key (l == 0) writes 0 (and lse = +inf);
//   * lse = ln sum_j exp(scale q.k_j) over the row's live keys, from the
//     running max and sum the kernel already holds: (m c + log2 l) ln 2
//     with m and c in each kernel's own units (below). A null lse pointer
//     writes nothing and leaves the scoring path as it was;
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

#include "hopper_common.cuh"

namespace {

// ------------------------------------------------------------------ float32

constexpr int kF32BlockQ = 128;  // threads a block

// The float32 kernel's tiling at head dim D: up to D = 128 one thread a
// query row (q and the accumulator in its registers) and K/V tiles of 32
// keys; past 128 a row's D columns are split among kSplit adjacent threads
// (its float4 chunks part, part + kSplit, ..., so the threads of a row read
// neighbouring 16 bytes of a shared K or V row), each dot product summed
// across them by warp shuffles, and K/V tiles of 16 keys, which keeps q and
// the accumulator at 64 registers each and the static tiles at 32 KB
template <int D>
struct F32Tile {
  static constexpr int kSplit = D > 128 ? 4 : 1;      // threads a query row
  static constexpr int kCols = D / kSplit;            // columns a thread
  static constexpr int kRows = kF32BlockQ / kSplit;   // query rows a block
  static constexpr int kKeys = D > 128 ? 16 : 32;     // keys a shared tile
  static_assert(kCols % 4 == 0, "a thread's columns are float4 chunks");
  static_assert(2 * kKeys * D * 4 <= 48 * 1024, "past 48 KB of static shared memory");
};

template <int D>
__global__ void __launch_bounds__(kF32BlockQ)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int s, int h,
                           int num_q_tiles, int num_bh,
                           Strides qs, Strides ks, Strides vs,
                           float scale_log2e, int causal) {
  using Tile = F32Tile<D>;
  constexpr int kSplit = Tile::kSplit, kCols = Tile::kCols, kKeys = Tile::kKeys;
  __shared__ __align__(16) float k_tile[kKeys][D];
  __shared__ __align__(16) float v_tile[kKeys][D];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int row = qt * Tile::kRows + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;  // the thread's share of the row
  const bool live_row = row < s;
  // the lanes of this row: they agree on every branch, and sum each dot
  // product among themselves
  const unsigned row_lanes = kSplit == 1 ? 0xffffffffu
                                         : ((1u << kSplit) - 1) << ((threadIdx.x & 31) & ~(kSplit - 1));

  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;

  float qr[kCols], acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) qr[c] = acc[c] = 0.0f;
  if (live_row) {
    const float* qp = q + b * qs.b + static_cast<int64_t>(row) * qs.s + hd * qs.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) qr[c] = qp[4 * ((c / 4) * kSplit + part) + c % 4] * scale_log2e;
  }
  float m = kNegInf, l = 0.0f;

  // keys past the last row of this tile are masked for every row of it
  const int kv_end = causal ? min(s, (qt + 1) * Tile::kRows) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    const int tile = min(kKeys, kv_end - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kKeys * D; e += kF32BlockQ) {
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

    float p[kKeys];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        const float4 kk = kr[c * kSplit + part];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int o = 1; o < kSplit; o <<= 1) dot += __shfl_xor_sync(row_lanes, dot, o);
      p[j] = j < n ? dot : kNegInf;
      tile_max = fmaxf(tile_max, p[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float pj = j < n ? exp2f(p[j] - m_new) : 0.0f;
      l += pj;
      const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        const float4 vv = vr[c * kSplit + part];
        acc[4 * c] = fmaf(pj, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pj, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pj, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pj, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!live_row) return;
  // m and the scores are in log2 units (q carries scale * log2(e))
  if (lse != nullptr && part == 0)
    lse[static_cast<int64_t>(bh) * s + row] =
        l == 0.0f ? INFINITY : (m + log2f(l)) * kLn2;
  const float denom = l == 0.0f ? 1.0f : l;  // acc is 0 too when l == 0
  float* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
  for (int c = 0; c < kCols; ++c) op[4 * ((c / 4) * kSplit + part) + c % 4] = acc[c] / denom;
}

// ------------------------------------------------------- bfloat16 / fp16

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                        // 16-bit elements of padding a shared row

template <int D>
struct Bf16Tile {
  static_assert(D == 16 || D == 32, "D must be 16 or 32");
  // two m16 row tiles a warp share every K/V fragment; Q stays in
  // registers as A fragments
  static constexpr int kMTiles = 2;
  static constexpr int kWarpRows = 16 * kMTiles;
  static constexpr int kBlockM = kWarpRows * kWarps;  // query rows a block
  static constexpr int kBlockN = 64;               // keys a shared-memory tile
  static constexpr int kRow = D + kPad;            // shared row, elements
  static constexpr int kStages = 3;                // cp.async ring depth
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  static constexpr int kElems = kBlockN * kRow;    // one K or V tile
  static constexpr int kCopies = kBlockN * kChunks;  // 16-byte copies a tile
  // blocks an SM must hold: a cap of 168 registers keeps 3 (12 warps)
  static constexpr int kMinBlocks = 3;
  static_assert(kBlockM <= 2 * kStages * kBlockN, "the output fits the ring");
};

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] =
// (g, 8+2t..), a[3] = (g+8, 8+2t..). B (16x8, col-major): b0 = (2t..2t+1,
// g), b1 = (8+2t.., g). C (16x8): c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8,
// 2t..2t+1). A warp owns kMTiles tiles of 16 rows, which share every K and
// V fragment it reads from shared memory. T is __nv_bfloat16 or __half:
// only the mma's input type and the pack of P and O differ.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Bf16Tile<D>::kMinBlocks)
flash_attention_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ lse, int s, int h,
                            int num_q_tiles, int num_bh, Strides qs,
                            Strides ks, Strides vs, float scale_log2e,
                            uint32_t q_sign, int causal) {
  using Tile = Bf16Tile<D>;
  constexpr int kRow = Tile::kRow, kStages = Tile::kStages;
  constexpr int kChunks = Tile::kChunks;
  constexpr int kMTiles = Tile::kMTiles, kWarpRows = Tile::kWarpRows;
  constexpr int kBlockM = Tile::kBlockM, kBlockN = Tile::kBlockN;
  constexpr int kNT = kBlockN / 8;  // 8-key column tiles of S
  constexpr int kDT = D / 8;        // 8-wide column tiles of O
  // [stage][0: K, 1: V][key][kRow]
  __shared__ __align__(128) T smem[kStages][2][Tile::kElems];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_row = qt * kBlockM + warp * kWarpRows;  // the warp's first row

  const T* kb = k + b * ks.b + hd * ks.h;
  const T* vb = v + b * vs.b + hd * vs.h;

  // Q as A fragments, loaded once (zeros for rows past S); q_sign flips
  // the sign of both 16-bit halves of each register for a negative scale
  uint32_t qf[kMTiles][D / 16][4];
  {
    const T* qb = q + b * qs.b + hd * qs.h;
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
    const T* kt = smem[j % kStages][0];
    const T* vt = smem[j % kStages][1];

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
          mma_16816<T>(sc[mt][2 * p], qf[mt][kk], bf[0], bf[1]);
          mma_16816<T>(sc[mt][2 * p + 1], qf[mt][kk], bf[2], bf[3]);
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
        pf[mt][nt / 2][(nt & 1) * 2] = pack2<T>(p0, p1);
        pf[mt][nt / 2][(nt & 1) * 2 + 1] = pack2<T>(p2, p3);
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
          mma_16816<T>(o[mt][2 * p], pf[mt][kk], bf[0], bf[1]);
          mma_16816<T>(o[mt][2 * p + 1], pf[mt][kk], bf[2], bf[3]);
        }
      }
    }
  }

  // out = O / l, through shared memory (the ring's first slots, one
  // region) as 16-byte stores
  cp_async_wait<0>();
  __syncthreads();  // no warp reads a K/V tile any more
  T* ot = &smem[0][0][0] + warp * kWarpRows * kRow;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);  // o is 0 too
      const int srow = 16 * mt + g + 8 * r;
      // m is the max of the unscaled (sign-adjusted) scores, c > 0 scales it
      if (lse != nullptr && t == 0 && warp_row + srow < s)
        lse[static_cast<int64_t>(bh) * s + warp_row + srow] =
            lr == 0.0f ? INFINITY : (m[mt][r] * scale_log2e + log2f(lr)) * kLn2;
#pragma unroll
      for (int i = 0; i < kDT; ++i)
        *reinterpret_cast<uint32_t*>(&ot[srow * kRow + i * 8 + 2 * t]) =
            pack2<T>(o[mt][i][2 * r] * inv, o[mt][i][2 * r + 1] * inv);
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

// --------------------- bfloat16 and float16 at D = 64, 128 and 256: wgmma

// FA3's forward: warp-specialised, wgmma and TMA. A block owns (batch,
// head, 64 kWGs query rows): compute warpgroups 0 .. kWGs-1 take 64 rows
// each (kWGs = 2 at D = 128 and 256, 3 at D = 64); in the last warpgroup
// one thread issues the TMA loads (Q once, then K and V tiles of kBN keys
// into rings guarded by mbarriers, K and V each its own so a K tile is
// freed as soon as S has read it), and setmaxnreg moves registers from it
// to the compute warpgroups (232 a thread at D = 128 and 256, 160 at
// D = 64). A tile row is D / 64 d-boxes of 64 columns (128-byte swizzle).
// Each key tile j, a compute warpgroup runs
// * S_j = Q K_j^T by wgmma from shared memory (64 x kBN float32, kBN / 2
//   registers; D / 16 k16 steps over the d-boxes, K-major);
// * the online softmax of S_j in registers, the scale folded into one FMA
//   before ex2.approx as in the mma.sync kernel (c > 0: a negative scale
//   negates the warpgroup's Q tile in shared memory once, negation of a
//   16-bit float being exact; a zero scale runs as the smallest normal
//   float);
// * O += P_j V_j by wgmma with P, rounded to T (bf16 or fp16: P <= 1), as
//   the register A operand (D / 2 registers of O) and V MN-major; at
//   D = 256 as two products of 128 columns each (wgmma's N of 256 would
//   take all 128 accumulators in one instruction), the second on d-boxes
//   2 and 3.
// At D = 256 a tile is 64 keys, not 128: Q takes 64 KB and a 128-key K or
// V tile 64 KB, so two-stage rings of 128 keys (256 KB) would not fit in
// the 227 KB a block may take; with 64 keys they take 128 KB (192 KB in
// all), and a thread holds O (128 registers), S (32) and P (16) under
// setmaxnreg's 232. Bound there (causal [8, 16384, 1, 256]): the products,
// 1.112 ms, the exponentials 0.257.
// Bound (at D = 64, causal [8, 16384, 4, 64]: 4.3e9 live pairs): the
// products (1.11 ms at 989 TFLOP/s) and the exponentials (1.03 ms at 16 per
// SM per clock) cost about the same, and the softmax's other instructions
// (a max, an FMA, an add, half a pack and half a rescale a pair) nearly as
// much issue time, so the kernel must keep all three going at once:
// * within a warpgroup, P_{j-1} V_{j-1} is issued once S_j and its row max
//   are in, and runs while the warpgroup takes the exponentials of S_j (O
//   is rescaled by tile j-1's factor under S_j, and P_j packed after the
//   product, so O, S and P take 32 + 64 + 32 registers at D = 64; the row
//   max comes first because its warp shuffles cannot run under a
//   register-operand wgmma);
// * between the warpgroups, a turn (named barriers kFwdTurn + wg, passed
//   round as soon as S is issued) orders their products on the tensor
//   cores, so one's softmax runs under another's wgmma;
// * at D = 64 a third compute warpgroup gives each scheduler three warps to
//   issue from: with two, the kernel ran at SDPA's time with the
//   exponentials or half the products taken out alike, bound by the
//   latency of each warp's instruction stream, not by a unit.
// The arithmetic and its order per element are those of the serial chain
// (O *= alpha_j, then O += P_j V_j), so the outputs do not depend on the
// overlap. Under a causal mask the key tiles past the block's last row are
// never loaded and the last kMaskTiles tiles (those that can hold the
// diagonal or the ragged tail of keys) are masked per element (TMA
// zero-fills keys and rows past S; padded rows are never stored). The
// output goes out through the warpgroup's Q boxes (16-byte chunks
// XOR-swizzled by row) as 16-byte stores; lse as in the mma.sync kernel.
constexpr int kFwdTurn = 4;       // named barriers 4 + wg: warpgroup wg's turn (1 + wg: its own)

// the block at head dim D: kWGs compute warpgroups of 64 query rows and
// one producer warpgroup, setmaxnreg's registers for each (the register
// file's 65,536 at most), and the shared memory layout, byte offsets from
// a 1024-byte aligned base
template <int D>
struct FwdSmem {
  static_assert(D == 64 || D == 128 || D == 256, "the wgmma forward takes D = 64, 128 or 256");
  static constexpr int kWGs = D == 64 ? 3 : 2;       // compute warpgroups
  static constexpr int kBM = 64 * kWGs;              // query rows a block
  static constexpr int kBN = D == 256 ? 64 : 128;    // keys a tile
  // the output's columns a P V product (wgmma's N, 128 at most here) and
  // the products a tile
  static constexpr int kON = D < 128 ? D : 128;
  static constexpr int kOParts = D / kON;
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kComputeRegs = D == 64 ? 160 : 232;
  static constexpr int kProducerRegs = D == 64 ? 32 : 40;
  static_assert(128 * (kWGs * kComputeRegs + kProducerRegs) <= 65536, "past the register file");
  // the key tiles that can hold the diagonal or the tail of keys: the last
  // ceil(kBM / kBN)
  static constexpr int kMaskTiles = (kBM + kBN - 1) / kBN;
  static constexpr int kBoxes = D / 64;              // 64-column d-boxes a row
  static constexpr int kStages = D == 64 ? 4 : 2;    // K ring and V ring depth
  static constexpr int kRowB = 128;                  // a d-box row: 64 elements
  static constexpr int kQBox = 64 * kRowB;           // a d-box of a warpgroup's rows
  static constexpr int kKVBox = kBN * kRowB;         // a d-box of a K or V tile
  static constexpr int kKVTile = kBoxes * kKVBox;
  static constexpr int kQ = 0;                       // Q [kWGs][kBoxes][64][64]
  static constexpr int kK = kQ + kWGs * kBoxes * kQBox;  // K [kStages][kBoxes][kBN][64]
  static constexpr int kV = kK + kStages * kKVTile;
  // k full, k empty, v full, v empty [kStages] each, q
  static constexpr int kBar = kV + kStages * kKVTile;
  static constexpr int kBytes = kBar + (4 * kStages + 1) * 8;
  static_assert(kBytes + 1024 <= 232448, "past the 227 KB a block may take");
};

// The online softmax of one S tile [64 rows, 2 N keys] in a thread's
// wgmma layout (N of its float32 accumulators) (warp_row the warp's first row; lane = 4 g + t), in two
// parts. fwd_max: with kMask (the last key tile, the only one that can
// hold the diagonal or the tail of keys) masks per element, then takes
// the running max m of the thread's two rows across the quad and gives
// alpha, the factor O must be scaled by, and mc = m c. fwd_exp: turns sc
// into p = exp2(s c - m c) and updates the running sum l (the thread's
// own columns; the quad's sum is taken at the end). The parts are apart
// because ptxas waits for a register-operand wgmma in flight before any
// warp shuffle: the max runs before P V is issued, the exponentials under
// it. The mask is a template argument so the other tiles' code has no
// branch (ptxas also waits at the first merge point after one).
template <bool kMask, int N>
__device__ __forceinline__ void fwd_max(float (&sc)[N], float (&m)[2], float (&alpha)[2],
                                        float (&mc)[2], int k0, int warp_row, int g, int t,
                                        int s, int causal, float scale_log2e) {
  if constexpr (kMask) {
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * jj + 2 * t + (e & 1);
        const int row = warp_row + g + 8 * (e >> 1);
        if (col >= s || (causal && col > row)) sc[4 * jj + e] = -INFINITY;
      }
  }
  // each row's max in 4 chains (max is exact in any order): 9 dependent
  // steps rather than 33 at N = 64, in 4 registers a row
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]);
#pragma unroll
    for (int jj = 4; jj < N / 4; ++jj)
      v[jj & 3] = fmaxf(v[jj & 3], fmaxf(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]));
    mx[r] = fmaxf(m[r], fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_approx((m[r] - mx[r]) * scale_log2e);
    m[r] = mx[r];
    mc[r] = mx[r] * scale_log2e;
  }
}

template <int N>
__device__ __forceinline__ void fwd_exp(float (&sc)[N], float (&l)[2], const float (&alpha)[2],
                                        const float (&mc)[2], float scale_log2e) {
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int jj = 0; jj < N / 4; ++jj) {
    sc[4 * jj] = exp2_approx(fmaf(sc[4 * jj], scale_log2e, -mc[0]));
    sc[4 * jj + 1] = exp2_approx(fmaf(sc[4 * jj + 1], scale_log2e, -mc[0]));
    sc[4 * jj + 2] = exp2_approx(fmaf(sc[4 * jj + 2], scale_log2e, -mc[1]));
    sc[4 * jj + 3] = exp2_approx(fmaf(sc[4 * jj + 3], scale_log2e, -mc[1]));
    rs[0] += sc[4 * jj] + sc[4 * jj + 1];
    rs[1] += sc[4 * jj + 2] + sc[4 * jj + 3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <typename T, int D>
__global__ void __launch_bounds__(FwdSmem<D>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             T* __restrict__ out, float* __restrict__ lse,
                             int s, int h, int num_q_tiles, int num_bh, float scale_log2e,
                             int q_neg, int causal) {
  using L = FwdSmem<D>;
  constexpr int kB = L::kBoxes, kStages = L::kStages, kWGs = L::kWGs, kBM = L::kBM;
  constexpr int kBN = L::kBN, kON = L::kON, kOParts = L::kOParts;
  constexpr int kSbo = 8 * L::kRowB;  // 8 rows of a d-box
  constexpr int kChunks = D / 8;      // 16-byte chunks an output row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t k_full = base + L::kBar;
  const uint32_t k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;
  const uint32_t bar_q = v_empty + 8 * kStages;

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;  // most causal work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  // keys past the block's last row are masked for every row of it
  const int kv_len = causal ? min(s, (qt + 1) * kBM) : s;
  const int n_tiles = (kv_len + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 4 * kWGs);  // lane 0 of each compute warp
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 4 * kWGs);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWGs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs));
    if (warp == 4 * kWGs && lane == 0) {  // ----------------------------- loader
      mbar_expect_tx(bar_q, kWGs * kB * L::kQBox);
#pragma unroll
      for (int w = 0; w < kWGs; ++w)
#pragma unroll
        for (int c = 0; c < kB; ++c)
          tma_load_4d(base + L::kQ + (kB * w + c) * L::kQBox, &tm_q, bar_q, 64 * c, hd,
                      qt * kBM + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t phase = (j / kStages) & 1;
        mbar_wait(k_empty + 8 * st, phase ^ 1);
        mbar_expect_tx(k_full + 8 * st, L::kKVTile);
#pragma unroll
        for (int c = 0; c < kB; ++c)
          tma_load_4d(base + L::kK + st * L::kKVTile + c * L::kKVBox, &tm_k, k_full + 8 * st,
                      64 * c, hd, j * kBN, b);
        mbar_wait(v_empty + 8 * st, phase ^ 1);
        mbar_expect_tx(v_full + 8 * st, L::kKVTile);
#pragma unroll
        for (int c = 0; c < kB; ++c)
          tma_load_4d(base + L::kV + st * L::kKVTile + c * L::kKVBox, &tm_v, v_full + 8 * st,
                      64 * c, hd, j * kBN, b);
      }
      // the compute warpgroups wait without the watchdog (a trap on their
      // path would cost them registers): it fires here if a load never lands
      mbar_wait(bar_q, 0);
      for (int j = max(0, n_tiles - kStages); j < n_tiles; ++j) {
        mbar_wait(k_full + 8 * (j % kStages), (j / kStages) & 1);
        mbar_wait(v_full + 8 * (j % kStages), (j / kStages) & 1);
      }
    }
  } else {  // ------------------------------------------ compute warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kComputeRegs));
    const int wt = threadIdx.x & 127;  // thread of the warpgroup
    const int w4 = wt >> 5;            // warp of the warpgroup
    const int g = lane >> 2, t = lane & 3;
    const int row0 = qt * kBM + 64 * wg;     // the warpgroup's first query row
    const int warp_row = row0 + 16 * w4;     // the warp's first query row
    const uint32_t q_tile = base + L::kQ + wg * kB * L::kQBox;
    uint8_t* const q_mem = sm + L::kQ + wg * kB * L::kQBox;

    mbar_spin(bar_q, 0);
    if (q_neg) {  // a negative scale runs as its magnitude on -q
#pragma unroll
      for (int i = 0; i < kB * L::kQBox / 16 / 128; ++i) {
        uint4* p = reinterpret_cast<uint4*>(q_mem) + i * 128 + wt;
        uint4 x = *p;
        x.x ^= 0x80008000u;
        x.y ^= 0x80008000u;
        x.z ^= 0x80008000u;
        x.w ^= 0x80008000u;
        *p = x;
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
    }

    // O: kOParts blocks of kON columns, the accumulators of one P V product each
    float o[kOParts][kON / 2];
#pragma unroll
    for (int p = 0; p < kOParts; ++p)
#pragma unroll
      for (int i = 0; i < kON / 2; ++i) o[p][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2], mc[2];
    float sc[kBN / 2];        // S_j, then P_j in float32
    uint32_t pa[kBN / 16][4];  // P_{j-1} as the A fragments of the P V product

    // the warpgroup's turn to issue S: warpgroup 0 takes the first, then
    // they go round, each turn passed to the next warpgroup right after S
    // is issued (so the tensor cores take the warpgroups' S products in
    // turn, each one's P V behind its S); every barrier phase gets one
    // warpgroup's wait and the one before's arrival, none is left open at
    // the end
    auto turn_wait = [&](int j) {
      if (wg > 0 || j > 0) named_sync(kFwdTurn + wg, 256);
    };
    auto turn_pass = [&](int j) {
      if (wg < kWGs - 1 || j < n_tiles - 1)
        named_arrive(kFwdTurn + (wg + 1) % kWGs, 256);
    };
    auto issue_s = [&](int j) {  // S_j = Q K_j^T: both K-major over the d-boxes
      const uint32_t k_tile = base + L::kK + (j % kStages) * L::kKVTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kBN>::template ss<0, 0, T>(
            sc, smem_desc(q_tile + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16, kSbo, 1),
            smem_desc(k_tile + (kk >> 2) * L::kKVBox + (kk & 3) * 32, 16, kSbo, 1), kk);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {  // O += P_j V_j: V [keys, d] MN-major across the d-boxes
      const uint32_t v_tile = base + L::kV + (j % kStages) * L::kKVTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < kOParts; ++p)
          Wgmma<kON>::template rs<1, T>(
              o[p], pa[kk],
              smem_desc(v_tile + p * (kON / 64) * L::kKVBox + kk * 16 * L::kRowB, L::kKVBox,
                        kSbo, 1),
              1);
      wgmma_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int p = 0; p < kOParts; ++p)
#pragma unroll
        for (int i = 0; i < kON / 8; ++i) {
          o[p][4 * i] *= alpha[0];
          o[p][4 * i + 1] *= alpha[0];
          o[p][4 * i + 2] *= alpha[1];
          o[p][4 * i + 3] *= alpha[1];
        }
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int p = 0; p < kOParts; ++p) fence_regs(o[p]);
    };
    auto pack = [&]() {
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
        pa[jj / 2][(jj & 1) * 2] = pack2<T>(sc[4 * jj], sc[4 * jj + 1]);
        pa[jj / 2][(jj & 1) * 2 + 1] = pack2<T>(sc[4 * jj + 2], sc[4 * jj + 3]);
      }
    };
    auto release = [&](uint32_t bar, int j) {  // this warp has read the tile
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 8 * (j % kStages));
    };

    auto v_wait = [&](int j) { mbar_spin(v_full + 8 * (j % kStages), (j / kStages) & 1); };

    // tile 0: S alone
    mbar_spin(k_full, 0);
    turn_wait(0);
    issue_s(0);
    turn_pass(0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty, 0);
    if (n_tiles <= L::kMaskTiles)
      fwd_max<true>(sc, m, alpha, mc, 0, warp_row, g, t, s, causal, scale_log2e);
    else
      fwd_max<false>(sc, m, alpha, mc, 0, warp_row, g, t, s, causal, scale_log2e);
    fwd_exp(sc, l, alpha, mc, scale_log2e);
    pack();
    // tile j: S_j, its row max, then P_{j-1} V_{j-1} issued and the
    // exponentials of S_j under it; the last kMaskTiles (`masked`) masked
    auto step = [&](int j, auto masked) {
      mbar_spin(k_full + 8 * (j % kStages), (j / kStages) & 1);
      v_wait(j - 1);
      turn_wait(j);
      issue_s(j);
      turn_pass(j);
      fence_regs(sc);
      rescale();  // O (P_{j-2} V_{j-2} done) by tile j-1's factor
      wgmma_wait<0>();  // S_j
      fence_regs(sc);
      release(k_empty, j);
      fwd_max<decltype(masked)::value>(sc, m, alpha, mc, j * kBN, warp_row, g, t, s, causal,
                                       scale_log2e);
      issue_pv(j - 1);
      fwd_exp(sc, l, alpha, mc, scale_log2e);
      fence_regs(sc);  // the exponentials stay above the wait, not sunk to pack()
      fence_regs(l);
      wgmma_wait<0>();  // P_{j-1} V_{j-1}
      fence_o();
      fence_regs(pa);
      release(v_empty, j - 1);
      pack();
    };
    const int first_masked = max(1, n_tiles - L::kMaskTiles);
    for (int j = 1; j < first_masked; ++j) step(j, std::false_type{});
    for (int j = first_masked; j < n_tiles; ++j) step(j, std::true_type{});
    rescale();
    v_wait(n_tiles - 1);
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_o();
    fence_regs(pa);

    // out = O / l through the warpgroup's Q boxes (no longer read): rows of
    // 2 D bytes, chunk c of row r at c ^ (r & 7) (8 rows of a quad's stores
    // in 8 bank groups), then 16-byte stores of the rows inside S
    fence_async_shared();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);  // o is 0 too
      const int srow = 16 * w4 + g + 8 * r;
      if (lse != nullptr && t == 0 && row0 + srow < s)
        lse[static_cast<int64_t>(bh) * s + row0 + srow] =
            lr == 0.0f ? INFINITY : (m[r] * scale_log2e + log2f(lr)) * kLn2;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float* op = o[i / (kON / 8)] + 4 * (i % (kON / 8)) + 2 * r;
        *reinterpret_cast<uint32_t*>(q_mem + srow * 2 * D + ((i ^ (srow & 7)) * 16) + 4 * t) =
            pack2<T>(op[0] * inv, op[1] * inv);
      }
    }
    named_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < 64 * kChunks / 128; ++i) {
      const int e = wt + 128 * i;
      const int r = e / kChunks, c = e % kChunks;
      if (row0 + r < s)
        *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * s + row0 + r) * h + hd) * D +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(q_mem + r * 2 * D + ((c ^ (r & 7)) * 16));
    }
  }
}

// the wgmma kernel for T (bf16 or fp16) at D = 64, 128 or 256
template <typename T, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int b, int s, int h, int num_bh, Strides qs, Strides ks,
                         Strides vs, float scale_log2e, int causal, cudaStream_t stream) {
  const int64_t num_q_tiles = (static_cast<int64_t>(s) + FwdSmem<D>::kBM - 1) / FwdSmem<D>::kBM;
  if (num_q_tiles * num_bh > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map<T>(&tm_q, q, b, s, h, D, qs, 64) ||
      !tensor_map<T>(&tm_k, k, b, s, h, D, ks, FwdSmem<D>::kBN) ||
      !tensor_map<T>(&tm_v, v, b, s, h, D, vs, FwdSmem<D>::kBN))
    return cudaErrorInvalidValue;
  const int smem = FwdSmem<D>::kBytes + 1024;  // + the 1024-byte alignment
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the kernel's scale must be > 0 (as the mma.sync kernel's)
  const float c = scale_log2e == 0.0f ? FLT_MIN : fabsf(scale_log2e);
  flash_attention_wgmma_kernel<T, D><<<static_cast<unsigned>(num_q_tiles * num_bh),
                                       FwdSmem<D>::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), lse, s, h,
      static_cast<int>(num_q_tiles), num_bh, c, scale_log2e < 0.0f ? 1 : 0, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int s, int h, int num_bh, Strides qs, Strides ks,
                   Strides vs, float scale_log2e, int causal,
                   cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && D >= 64) {  // bf16 and fp16 at D = 64, 128 and 256
    return launch_wgmma<T, D>(q, k, v, out, lse, b, s, h, num_bh, qs, ks, vs, scale_log2e,
                              causal, stream);
  } else if constexpr (sizeof(T) == 2) {
    const int64_t num_q_tiles =
        (static_cast<int64_t>(s) + Bf16Tile<D>::kBlockM - 1) / Bf16Tile<D>::kBlockM;
    if (num_q_tiles * num_bh > INT32_MAX) return cudaErrorInvalidValue;
    // the kernel's scale must be > 0 (see the note at the top)
    const uint32_t q_sign = scale_log2e < 0.0f ? 0x80008000u : 0u;
    const float c = scale_log2e == 0.0f ? FLT_MIN : fabsf(scale_log2e);
    flash_attention_bf16_kernel<T, D><<<static_cast<unsigned>(num_q_tiles * num_bh), kThreads,
                                        0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, s, h, static_cast<int>(num_q_tiles), num_bh, qs, ks, vs, c,
        q_sign, causal);
    return cudaGetLastError();
  } else {
    const int64_t num_q_tiles =
        (static_cast<int64_t>(s) + F32Tile<D>::kRows - 1) / F32Tile<D>::kRows;
    if (num_q_tiles * num_bh > INT32_MAX) return cudaErrorInvalidValue;
    flash_attention_f32_kernel<D><<<static_cast<unsigned>(num_q_tiles * num_bh), kF32BlockQ,
                                    0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, s, h,
        static_cast<int>(num_q_tiles), num_bh, qs, ks, vs, scale_log2e, causal);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* out, float* lse, int b, int s, int h, int num_bh, Strides qs,
                     Strides ks, Strides vs, float scale_log2e, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, b, s, h, num_bh, qs, ks, vs,
                           scale_log2e, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, b, s, h, num_bh, qs, ks, vs,
                           scale_log2e, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, b, s, h, num_bh, qs, ks, vs,
                           scale_log2e, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, b, s, h, num_bh, qs, ks, vs,
                            scale_log2e, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, b, s, h, num_bh, qs, ks, vs,
                            scale_log2e, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [b, s, h, d] of float32 (dtype 0), bfloat16 (1) or float16 (2)
// with element strides (*_sb, *_ss, *_sh) and unit stride on d; out:
// contiguous [b, s, h, d] of the same type; lse: null, or [b, h, s]
// float32 for each row's log-sum-exp (natural log); all on the device of
// ``stream``. d is 16, 32, 64, 128 or 256 (the wrapper pads any other d up
// to one of these). The 16-bit types also need every base pointer 16-byte
// aligned and every stride a multiple of 8. scale_log2e = sm_scale *
// log2(e). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim, type or grid the kernels do not
// take).
extern "C" int swtpu_flash_attention(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int b, int s,
    int h, int d, int dtype, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale_log2e, int causal, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  const int64_t num_bh = static_cast<int64_t>(b) * h;
  if (num_bh > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(num_bh);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = dispatch<float>(d, q, k, v, out, lse, b, s, h, bh, qs, ks, vs,
                            scale_log2e, causal, st);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(d, q, k, v, out, lse, b, s, h, bh, qs, ks,
                                    vs, scale_log2e, causal, st);
      break;
    case 2:
      err = dispatch<__half>(d, q, k, v, out, lse, b, s, h, bh, qs, ks, vs,
                             scale_log2e, causal, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
