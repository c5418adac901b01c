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
// * bfloat16 and float16 at D > 256 (any multiple of 128): the same
//   wgmma/TMA design split over column chunks of O (the wide kernel,
//   flash_attention_wide_kernel<T, DC> below; the note there): a grid axis
//   over chunks of DC = 256 columns (128 where D is not a multiple of 256),
//   S reduced over the whole D in 64-column boxes streamed with each key
//   tile, so any D runs in the D = 256 kernel's registers and shared memory.
// * float32: float32 FMAs on the CUDA cores, which bound it (4 D
//   operations a live pair at 67 TFLOP/s). Tensor cores would mean TF32
//   (about 3 decimal digits), which the float32 contract (1e-5) does not
//   allow. Not on the transformer's path. Up to D = 64 one thread per
//   query row, K/V tiles of 32 keys in shared memory. At D = 128 and 256
//   the register-tiled kernel (flash_attention_f32_tiled_kernel<D>, the
//   note there): at D = 256 32 rows a block and a lane's 4 x 4 of S, at
//   D = 128 64 rows a block and a lane's 4 x 8 of S, fed by broadcast
//   float4 reads, K and V through a cp.async ring. Past
//   D = 256 the same lane tiles over two groups of 4 warps
//   (flash_attention_f32_split_kernel<C, kStreamQ>, the note there): each
//   group sums a partial S over half of D and holds half of O's columns,
//   and the two partial tiles are added through shared memory, so S is
//   summed once a key tile at D = 384 and 512 (past 512 once a chunk of
//   512 columns of O).
//
// q, k and v are read in place through base pointers and (batch, row, head)
// strides with unit stride on D, so the three strided views of one fused
// [B, S, 3, H, D] qkv product are read as they lie; the 16-bit path needs each
// row 16-byte aligned (the wrapper checks). The output is written contiguous
// [B, S, H, D]. Head dims 16, 32, 64, 128 and 256 and every multiple of
// 128 past 256; the wrapper pads any other D with zero lanes to the next
// of them (ops/attention.py:padded_head_dim).
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

// The float32 kernel's tiling at head dim D <= 64: one thread a query
// row (q and the accumulator in its registers), K/V tiles of 32 keys
template <int D>
struct F32Tile {
  static constexpr int kRows = kF32BlockQ;  // query rows a block
  static constexpr int kKeys = 32;          // keys a shared tile
  static_assert(D <= 64, "D = 128 and 256 have the register-tiled kernel");
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
  constexpr int kKeys = Tile::kKeys;
  __shared__ __align__(16) float k_tile[kKeys][D];
  __shared__ __align__(16) float v_tile[kKeys][D];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int row = qt * Tile::kRows + threadIdx.x;
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
    for (int j = 0; j < kKeys; ++j) {
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
  // m and the scores are in log2 units (q carries scale * log2(e))
  if (lse != nullptr)
    lse[static_cast<int64_t>(bh) * s + row] =
        l == 0.0f ? INFINITY : (m + log2f(l)) * kLn2;
  const float denom = l == 0.0f ? 1.0f : l;  // acc is 0 too when l == 0
  float* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = acc[c] / denom;
}

// float32 at D = 256 (129-255 padded) and D = 128 (65-127 padded),
// register-tiled on the CUDA cores. Bound by its float32 FMAs (4 D
// operations a live pair at 67 TFLOP/s; the one-row-per-thread kernel it
// replaced at D = 128 ran at 16 % of that, q and the accumulator 256
// registers of a thread, spilled, each score one 128-long FMA chain and
// every shared float4 feeding one row). A block of 4 warps owns kRW query
// rows a warp (8 at D = 256, 16 at 128) and walks key tiles of 64 keys; Q
// stays in shared memory for the whole walk (unscaled: each score is
// multiplied by scale log2(e) once, any sign or zero, before its max).
// Each key tile comes through a ring of dynamic shared memory filled by
// cp.async: K in pieces of 64 columns, then V in pieces of 4096 / D keys (a
// slot holds either), so the next pieces' copies run under this piece's
// math and one __syncthreads a piece hands a slot on. A lane holds 4 of its
// warp's rows by kKJ keys of S (keys kg, kg + kKG, ...: 4 x 4 at D = 256,
// 4 x 8 at 128), summed by 64-column pieces in column order from float4
// reads that each feed 4 or 8 FMA chains; a row's max and sum are reduced
// over the kKG lanes that share it; P goes through the warp's own shared
// tile [64 keys][kRW rows] (broadcast reads) into O += P V, where a lane
// holds kRW rows x D / 32 columns of O (128 m + 4 lane + c). At D = 256 a
// 4-slot ring, 108.5 KB of shared memory and up to 255 registers: two
// blocks an SM. At D = 128 O is 64 registers a lane at 16 rows a warp
// (twice the FMAs a shared read of the 8-row layout: 2.19 against 2.01-2.05
// ms at [8, 4096, 2, 128] on an H100), a slot 17 KB, a 2-slot ring (84.6
// KB): two blocks an SM. The block order below shares out the work under a
// causal mask.
template <int D>
struct F32T {
  static_assert(D == 128 || D == 256, "the register-tiled forward's head dims");
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRW = D == 256 ? 8 : 16;  // query rows a warp
  static constexpr int kRows = kRW * kWarps;     // query rows a block
  static constexpr int kKG = 128 / kRW;          // lanes along a tile's keys: 16 or 8
  static constexpr int kKeys = 64;          // keys a tile
  static constexpr int kPiece = 64;         // columns of a K piece
  static constexpr int kVKeys = 4096 / D;   // keys of a V piece
  static constexpr int kQPitch = D + 4;     // padded rows: the lanes' rows fall in other banks
  static constexpr int kKPitch = kPiece + 4;
  static constexpr int kKPieces = D / kPiece, kVPieces = kKeys / kVKeys;
  static constexpr int kPieces = kKPieces + kVPieces;  // ring pieces a key tile
  static constexpr int kStages = D == 256 ? 4 : 2;
  static constexpr int kBlocksPerSM = 2;
  static constexpr int kSlot = kKeys * kKPitch > kVKeys * D ? kKeys * kKPitch : kVKeys * D;
  static constexpr int kQFloats = kRows * kQPitch;
  static constexpr int kPFloats = kKeys * kRW;  // a warp's P tile
  static constexpr int kCols = D / 32;        // a lane's columns of O
  static constexpr int kBytes = 4 * (kQFloats + kStages * kSlot + kWarps * kPFloats);
  static_assert(kBytes <= 227 * 1024, "past the shared memory a block may take");
};

template <int D>
__global__ void __launch_bounds__(F32T<D>::kThreads, F32T<D>::kBlocksPerSM)
flash_attention_f32_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ out,
                                 float* __restrict__ lse, int s, int h, int num_q_tiles,
                                 int num_bh, Strides qs, Strides ks, Strides vs,
                                 float scale_log2e, int causal, int aligned, int first_wave) {
  using L = F32T<D>;
  constexpr int kThreads = L::kThreads, kRows = L::kRows, kKeys = L::kKeys;
  constexpr int kPiece = L::kPiece, kVKeys = L::kVKeys, kStages = L::kStages;
  constexpr int kQPitch = L::kQPitch, kKPitch = L::kKPitch, kSlot = L::kSlot;
  constexpr int kKPieces = L::kKPieces, kPieces = L::kPieces, kG = L::kCols / 4;
  constexpr int kRW = L::kRW, kKG = L::kKG, kKJ = kKeys / kKG;
  // a lane's 4 rows of S, rg its group: rows 4 rg + i at 8 a warp, rg + 4 i
  // at 16 (the 4 groups' rows of one read then fall in other banks)
  constexpr int kGStep = kRW == 16 ? 1 : 4, kIStep = kRW == 16 ? 4 : 1;
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);
  float* const ring = q_s + L::kQFloats;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* const p_s = ring + kStages * kSlot + warp * L::kPFloats;

  // the work list runs from the most causal work down; when the whole grid
  // is resident at once (kBlocksPerSM blocks an SM), the blocks past the
  // first wave take it from the light end, so an SM's blocks share out the
  // work
  const int x = blockIdx.x < first_wave ? blockIdx.x : gridDim.x - 1 + first_wave - blockIdx.x;
  const int bh = x % num_bh;
  const int qt = num_q_tiles - 1 - x / num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int q0 = qt * kRows;
  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;
  // keys past the block's last row are masked for every row of it
  const int kv_end = causal ? min(s, q0 + kRows) : s;
  const int n_pieces = (kv_end + kKeys - 1) / kKeys * kPieces;

  // piece g of the walk into its slot: K's columns or V's keys of tile g / kPieces
  auto issue = [&](int g) {
    float* slot = ring + (g % kStages) * kSlot;
    const int k0 = g / kPieces * kKeys, p = g % kPieces;
    if (p < kKPieces)
      f32_copy_rows<kThreads, kKeys, kPiece>(slot, kKPitch, kb, ks.s, k0, kv_end, p * kPiece,
                                             aligned);
    else
      f32_copy_rows<kThreads, kVKeys, D>(slot, D, vb, vs.s, k0 + (p - kKPieces) * kVKeys,
                                         kv_end, 0, aligned);
  };
  f32_copy_rows<kThreads, kRows, D>(q_s, kQPitch, q + b * qs.b + hd * qs.h, qs.s, q0, s, 0,
                                    aligned);
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < n_pieces) issue(g);
    cp_async_commit();
  }

  // S: rows kRW warp + kGStep rg + kIStep i, keys kg + kKG j of the tile;
  // P's tile and O take them in the order 4 rg + i
  const int rg = lane / kKG, kg = lane % kKG;
  const float* q_rows = q_s + (kRW * warp + kGStep * rg) * kQPitch;
  float sc[4][kKJ], m[4], l[4];
  float o[kRW][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) o[r][c] = 0.0f;

  for (int g = 0; g < n_pieces; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // piece g is in; every thread is done with piece g - 1's slot
    if (g + kStages - 1 < n_pieces) issue(g + kStages - 1);
    cp_async_commit();
    const float* slot = ring + (g % kStages) * kSlot;
    const int k0 = g / kPieces * kKeys, p = g % kPieces;
    if (p < kKPieces) {
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kKJ; ++j) sc[i][j] = 0.0f;
      }
      f32_dots<4, kKJ, kPiece>(sc, q_rows + p * kPiece, kIStep * kQPitch, slot + kg * kKPitch,
                               kKG * kKPitch);
      if (p == kKPieces - 1) {
        // the online softmax of the tile, in log2 units
        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + kRW * warp + kGStep * rg + kIStep * i;
          bool live[kKJ];
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < kKJ; ++j) {
            const int key = k0 + kg + kKG * j;
            live[j] = key < kv_end && (!causal || key <= row);
            sc[i][j] *= scale_log2e;
            if (live[j]) mx = fmaxf(mx, sc[i][j]);
          }
#pragma unroll
          for (int x = 1; x < kKG; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
          const float m_new = fmaxf(m[i], mx);
          alpha[i] = exp2f(m[i] - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < kKJ; ++j) {
            sc[i][j] = live[j] ? exp2f(sc[i][j] - m_new) : 0.0f;  // masked: p = 0
            sum += sc[i][j];
          }
          l[i] = l[i] * alpha[i] + sum;
          m[i] = m_new;
        }
        // P to the warp's tile (read back after the next piece's barrier)
#pragma unroll
        for (int j = 0; j < kKJ; ++j)
          *reinterpret_cast<float4*>(p_s + (kg + kKG * j) * kRW + 4 * rg) =
              make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
#pragma unroll
        for (int r = 0; r < kRW; ++r) {  // row r's alpha is lane kKG (r / 4)'s
          const float a = __shfl_sync(0xffffffffu, alpha[r % 4], (r / 4) * kKG);
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) o[r][c] *= a;
        }
      }
    } else {
      // O += P V over the piece's keys, in key order
      const float* pk = p_s + (p - kKPieces) * kVKeys * kRW;
#pragma unroll 4
      for (int j = 0; j < kVKeys; ++j) {
        float4 vv[kG];
#pragma unroll
        for (int m = 0; m < kG; ++m)
          vv[m] = *reinterpret_cast<const float4*>(slot + j * D + 128 * m + 4 * lane);
        float pr[kRW];
#pragma unroll
        for (int x = 0; x < kRW / 4; ++x) {
          const float4 px = *reinterpret_cast<const float4*>(pk + j * kRW + 4 * x);
          pr[4 * x] = px.x, pr[4 * x + 1] = px.y, pr[4 * x + 2] = px.z, pr[4 * x + 3] = px.w;
        }
#pragma unroll
        for (int r = 0; r < kRW; ++r)
#pragma unroll
          for (int m = 0; m < kG; ++m) {
            o[r][4 * m] = fmaf(pr[r], vv[m].x, o[r][4 * m]);
            o[r][4 * m + 1] = fmaf(pr[r], vv[m].y, o[r][4 * m + 1]);
            o[r][4 * m + 2] = fmaf(pr[r], vv[m].z, o[r][4 * m + 2]);
            o[r][4 * m + 3] = fmaf(pr[r], vv[m].w, o[r][4 * m + 3]);
          }
      }
    }
  }
  cp_async_wait<0>();

  // each row's sum over its kKG lanes; out = O / l, lse from (m, l)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int x = 1; x < kKG; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
  if (lse != nullptr && kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + kRW * warp + kGStep * rg + kIStep * i;
      if (row < s)
        lse[static_cast<int64_t>(bh) * s + row] =
            l[i] == 0.0f ? INFINITY : (m[i] + log2f(l[i])) * kLn2;
    }
  }
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const float lr = __shfl_sync(0xffffffffu, l[r % 4], (r / 4) * kKG);
    const int row = q0 + kRW * warp + kGStep * (r / 4) + kIStep * (r % 4);
    if (row >= s) continue;
    const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);  // o is 0 too when l == 0
    float* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * D + 4 * lane;
#pragma unroll
    for (int m = 0; m < kG; ++m)
      *reinterpret_cast<float4*>(op + 128 * m) =
          make_float4(o[r][4 * m] * inv, o[r][4 * m + 1] * inv, o[r][4 * m + 2] * inv,
                      o[r][4 * m + 3] * inv);
  }
}

// float32 past D = 256 (any multiple of 128; others padded), register-tiled
// on the CUDA cores: the D = 256 kernel's lane layout over two groups of 4
// warps, so that S is summed once a key tile at D = 384 and 512. Bound by
// its float32 FMAs (4 D operations a live pair at 67 TFLOP/s); the kernel it
// replaced recomputed S for every 128-column chunk of O (2.5x the products
// at D = 512), summed each score across 8 threads of a row by shuffles and
// fed one FMA chain a shared float4. A block of 8 warps owns 32 query rows
// and C columns of O (C = D at 384 and 512; past 512 a grid axis over
// chunks of 512 columns, the last one masked where D is not a multiple of
// 512, each chunk recomputing S: (D / 512 + 1) / 2 of the one-pass
// products past 512, 1.5x at 1024). Group g (warps 4 g .. 4 g + 3) holds O
// over C / 2 of the block's columns, a lane 8 rows x C / 64 columns (4 lane
// + c, then 128 + (C / 64 - 4) lane + c of the group's), and sums a partial
// S over its half of D (columns g D / 2 ..), by 64-column pieces in column
// order, in the D = 256 kernel's 4 x 4 lane tiles. The two partial tiles
// meet in shared memory and each group adds the other's to its own: the
// same bits in both (a + b == b + a), so both run the same online softmax
// (the exponentials twice, which the FMAs dwarf) and need no barrier of
// their own: the partial goes out at the tile's last S-piece and comes in
// after the next piece's barrier. Q stays resident in shared memory at
// D = 384 and 512 (66 KB at 512); past 512 (kStreamQ) its 64-column pieces
// come with K's. The ring: 3 slots of cp.async pieces, each S-piece both
// groups' 64 columns of K (and Q) for the 64-key tile, then V in pieces of
// 16 keys by the chunk's columns; one __syncthreads a piece. 199 KB of
// shared memory at D = 512: one block an SM, launched most causal work
// first.
namespace f32s {
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;              // query rows a block, 8 a warp of a group
constexpr int kKeys = 64;              // keys a tile
constexpr int kPiece = 64;             // columns of a group's S-piece
constexpr int kVKeys = 16;             // keys of a V piece
constexpr int kKPitch = kPiece + 4;    // padded rows: the lanes' rows fall in other banks
constexpr int kStages = 3;
constexpr int kPFloats = kKeys * 8;    // a warp's P tile
constexpr int kXFloats = 2 * 4 * 128 * 4;  // both groups' partial S tiles, float4 [4][128] each
template <int C, bool kStreamQ>
struct Layout {
  static constexpr int kQPitch = C + 4;
  static constexpr int kKPair = 2 * kKeys * kKPitch;             // both groups' K piece
  static constexpr int kQPair = kStreamQ ? 2 * kRows * kKPitch : 0;
  static constexpr int kSlot =
      kKPair + kQPair > kVKeys * C ? kKPair + kQPair : kVKeys * C;
  static constexpr int kQFloats = kStreamQ ? 0 : kRows * kQPitch;
  static constexpr int kBytes = 4 * (kQFloats + kStages * kSlot + kWarps * kPFloats + kXFloats);
  static_assert(kBytes <= 227 * 1024, "past the shared memory a block may take");
};
}  // namespace f32s

template <int C, bool kStreamQ>
__global__ void __launch_bounds__(f32s::kThreads, 1)
flash_attention_f32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ out,
                                 float* __restrict__ lse, int s, int h, int d, int num_q_tiles,
                                 int num_bh, int n_chunks, Strides qs, Strides ks, Strides vs,
                                 float scale_log2e, int causal, int aligned) {
  using namespace f32s;
  using L = Layout<C, kStreamQ>;
  constexpr int kHalf = C / 2;               // O columns a group
  constexpr int kHi = (kHalf - 128) / 32;    // a lane's columns past the group's first 128
  static_assert(kHi == 4 || kHi == 2, "C = 512 or 384");
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);
  float* const ring = q_s + L::kQFloats;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 4, wq = warp % 4;   // the group, the warp's rows in it
  float* const p_s = ring + kStages * L::kSlot + warp * kPFloats;
  float4* const x_s = reinterpret_cast<float4*>(ring + kStages * L::kSlot + kWarps * kPFloats);

  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int bh = rest % num_bh;
  const int qt = num_q_tiles - 1 - rest / num_bh;  // most causal work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int q0 = qt * kRows;
  const float* qb = q + b * qs.b + hd * qs.h;
  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;
  // keys past the block's last row are masked for every row of it
  const int kv_end = causal ? min(s, q0 + kRows) : s;
  const int half_d = d / 2;                  // S columns a group sums
  const int n_s = half_d / kPiece;           // S-pieces a tile
  const int n_tile = n_s + kKeys / kVKeys;   // ring pieces a tile
  const int n_pieces = (kv_end + kKeys - 1) / kKeys * n_tile;
  const int col0 = chunk * C + grp * kHalf;  // the group's first O column

  // piece g of the walk into its slot: both groups' columns of K (and Q),
  // or V's keys by the chunk's columns (past D: not copied, never stored)
  auto issue = [&](int g) {
    float* slot = ring + (g % kStages) * L::kSlot;
    const int k0 = g / n_tile * kKeys, p = g % n_tile;
    if (p < n_s) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int c = x * half_d + p * kPiece;
        f32_copy_rows<kThreads, kKeys, kPiece>(slot + x * kKeys * kKPitch, kKPitch, kb, ks.s, k0,
                                               kv_end, c, aligned);
        if constexpr (kStreamQ)
          f32_copy_rows<kThreads, kRows, kPiece>(slot + L::kKPair + x * kRows * kKPitch, kKPitch,
                                                 qb, qs.s, q0, s, c, aligned);
      }
    } else if constexpr (kStreamQ) {
#pragma unroll
      for (int x = 0; x < C / 128; ++x)
        if (chunk * C + 128 * x < d)
          f32_copy_rows<kThreads, kVKeys, 128>(slot + 128 * x, C, vb, vs.s,
                                               k0 + (p - n_s) * kVKeys, kv_end,
                                               chunk * C + 128 * x, aligned);
    } else {
      f32_copy_rows<kThreads, kVKeys, C>(slot, C, vb, vs.s, k0 + (p - n_s) * kVKeys, kv_end, 0,
                                         aligned);
    }
  };
  if constexpr (!kStreamQ)
    f32_copy_rows<kThreads, kRows, C>(q_s, L::kQPitch, qb, qs.s, q0, s, 0, aligned);
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < n_pieces) issue(g);
    cp_async_commit();
  }

  // S: rows 8 wq + 4 rg + i, keys kg + 16 j of the tile
  const int rg = lane / 16, kg = lane % 16;
  float sc[4][4], m[4], l[4];
  float o[8][4 + kHi];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4 + kHi; ++c) o[r][c] = 0.0f;
  // this lane's partial S tile in x_s, and its partner's in the other group
  float4* const x_own = x_s + grp * 512 + threadIdx.x % 128;
  const float4* const x_other = x_s + (1 - grp) * 512 + threadIdx.x % 128;

  for (int g = 0; g < n_pieces; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // piece g is in; every thread is done with piece g - 1's slot
    if (g + kStages - 1 < n_pieces) issue(g + kStages - 1);
    cp_async_commit();
    const float* slot = ring + (g % kStages) * L::kSlot;
    const int k0 = g / n_tile * kKeys, p = g % n_tile;
    if (p < n_s) {
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      }
      const float* qa = kStreamQ ? slot + L::kKPair + (grp * kRows + 8 * wq + 4 * rg) * kKPitch
                                 : q_s + (8 * wq + 4 * rg) * L::kQPitch + grp * half_d + p * kPiece;
      f32_dots<4, 4, kPiece>(sc, qa, kStreamQ ? kKPitch : L::kQPitch,
                             slot + (grp * kKeys + kg) * kKPitch, 16 * kKPitch);
      if (p == n_s - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x_own[i * 128] = make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
      }
    } else {
      if (p == n_s) {
        // S = the two groups' partial sums, then the online softmax of the
        // tile in log2 units (both groups alike)
        float alpha[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 y = x_other[i * 128];
          sc[i][0] += y.x;
          sc[i][1] += y.y;
          sc[i][2] += y.z;
          sc[i][3] += y.w;
          const int row = q0 + 8 * wq + 4 * rg + i;
          bool live[4];
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = k0 + kg + 16 * j;
            live[j] = key < kv_end && (!causal || key <= row);
            sc[i][j] *= scale_log2e;
            if (live[j]) mx = fmaxf(mx, sc[i][j]);
          }
#pragma unroll
          for (int x = 1; x < 16; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
          const float m_new = fmaxf(m[i], mx);
          alpha[i] = exp2f(m[i] - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = live[j] ? exp2f(sc[i][j] - m_new) : 0.0f;  // masked: p = 0
            sum += sc[i][j];
          }
          l[i] = l[i] * alpha[i] + sum;
          m[i] = m_new;
        }
        // P to the warp's own tile, read back below by the whole warp
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(p_s + (kg + 16 * j) * 8 + 4 * rg) =
              make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 8; ++r) {  // row r's alpha is lane 16 (r / 4)'s
          const float a = __shfl_sync(0xffffffffu, alpha[r % 4], (r / 4) * 16);
#pragma unroll
          for (int c = 0; c < 4 + kHi; ++c) o[r][c] *= a;
        }
      }
      // O += P V over the piece's 16 keys, in key order
      const float* pk = p_s + (p - n_s) * kVKeys * 8;
      const float* vr = slot + grp * kHalf;
#pragma unroll 4
      for (int j = 0; j < kVKeys; ++j) {
        const float4 v0 = *reinterpret_cast<const float4*>(vr + j * C + 4 * lane);
        float vh[kHi];
        if constexpr (kHi == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr + j * C + 128 + 4 * lane);
          vh[0] = x.x, vh[1] = x.y, vh[2] = x.z, vh[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vr + j * C + 128 + 2 * lane);
          vh[0] = x.x, vh[1] = x.y;
        }
        const float4 p0 = *reinterpret_cast<const float4*>(pk + j * 8);
        const float4 p1 = *reinterpret_cast<const float4*>(pk + j * 8 + 4);
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          o[r][0] = fmaf(pr[r], v0.x, o[r][0]);
          o[r][1] = fmaf(pr[r], v0.y, o[r][1]);
          o[r][2] = fmaf(pr[r], v0.z, o[r][2]);
          o[r][3] = fmaf(pr[r], v0.w, o[r][3]);
#pragma unroll
          for (int c = 0; c < kHi; ++c) o[r][4 + c] = fmaf(pr[r], vh[c], o[r][4 + c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // each row's sum over its 16 lanes; out = O / l, lse from (m, l) (group
  // 0 of chunk 0)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int x = 1; x < 16; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
  if (lse != nullptr && chunk == 0 && grp == 0 && kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 8 * wq + 4 * rg + i;
      if (row < s)
        lse[static_cast<int64_t>(bh) * s + row] =
            l[i] == 0.0f ? INFINITY : (m[i] + log2f(l[i])) * kLn2;
    }
  }
  // the group's two column runs, each 128 columns (D is a multiple of 128)
  const bool lo_live = col0 < d, hi_live = col0 + 128 < d;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float lr = __shfl_sync(0xffffffffu, l[r % 4], (r / 4) * 16);
    const int row = q0 + 8 * wq + r;
    if (row >= s) continue;
    const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);  // o is 0 too when l == 0
    float* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * d + col0;
    if (lo_live)
      *reinterpret_cast<float4*>(op + 4 * lane) =
          make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv);
    if (!hi_live) continue;
    if constexpr (kHi == 4)
      *reinterpret_cast<float4*>(op + 128 + 4 * lane) =
          make_float4(o[r][4] * inv, o[r][5] * inv, o[r][6] * inv, o[r][7] * inv);
    else
      *reinterpret_cast<float2*>(op + 128 + 2 * lane) = make_float2(o[r][4] * inv, o[r][5] * inv);
  }
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

// ----------------------- bfloat16 and float16 at D > 256: column chunks

// The wide kernel: FA3's forward past D = 256, where one warpgroup's O for
// 64 rows (D / 2 float32 registers a thread: 192 at D = 384, 256 at 512)
// and a resident Q (256 D bytes for 128 rows: 128 KB at D = 512) no longer
// fit beside S and P. A grid axis splits O by columns: a block owns (batch,
// head, 128 query rows, one chunk of DC columns of the output), DC = 256
// where D is a multiple of 256, else 128. Its two compute warpgroups (64
// rows each) run, per key tile of kBN = 64 keys,
// * S_j = Q K_j^T reduced over the whole D: the loader brings each
//   64-column d-box of both warpgroups' Q rows and of K_j into one stage of
//   a ring (kSKStages stages of 24 KB), and a warpgroup issues the box's 4
//   k16 steps as soon as it lands, freeing the box before once its
//   products are done; boxes in column order, so the sum's order is fixed;
// * the online softmax of S_j (fwd_max and fwd_exp, as the D <= 256 kernel),
//   a negative scale taken by negating S (exact: each product of -q and k
//   is the negated product, and sums of negated terms round to the
//   negated sum), a zero one as the smallest normal float;
// * O_c += P_j V_j[:, chunk] with P (in T) as the register A operand, V's
//   chunk (DC / 64 boxes) through a ring of its own, kOParts products of
//   N = 128 columns, as the D = 256 kernel takes its two.
// One serial chain a tile (no overlap of the softmax with the products): a
// simple kernel first. So O (DC / 2 registers), S (32) and P (16) take the
// D = 256 kernel's registers at any D, and shared memory stays under
// 227 KB (208 KB at DC = 256). Only chunk 0's blocks write lse. S and its
// exponentials are computed once a chunk: the products a pair are D / DC
// times S's and once P V's, (D / DC + 1) / 2 times the one-pass products
// (1.5 at D = 512, 2 at D = 384, 2.5 at D = 1024). Q comes from L2 once a
// key tile (the bytes bound it before the products at this design; a
// later kernel may keep Q resident where it fits). The output is stored
// from the registers, 4 bytes a thread a column pair.
template <int DC>
struct WideSmem {
  static_assert(DC == 128 || DC == 256, "the wide forward takes chunks of 128 or 256 columns");
  static constexpr int kWGs = 2;                     // compute warpgroups
  static constexpr int kBM = 64 * kWGs;              // query rows a block
  static constexpr int kBN = 64;                     // keys a tile
  static constexpr int kON = 128;                    // columns a P V product
  static constexpr int kOParts = DC / kON;
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kComputeRegs = 232;
  static constexpr int kProducerRegs = 40;
  static_assert(128 * (kWGs * kComputeRegs + kProducerRegs) <= 65536, "past the register file");
  static constexpr int kMaskTiles = (kBM + kBN - 1) / kBN;
  static constexpr int kRowB = 128;                  // a d-box row: 64 elements
  static constexpr int kBox = 64 * kRowB;            // a d-box of 64 rows or keys
  static constexpr int kSKStages = 6;                // ring of (Q boxes, K box) stages
  static constexpr int kVStages = 2;                 // ring of V chunk tiles
  static constexpr int kSKStage = (kWGs + 1) * kBox; // [Q box wg 0][Q box wg 1][K box]
  static constexpr int kVTile = DC / 64 * kBox;      // V's chunk [DC / 64][kBN][64]
  static constexpr int kSK = 0;
  static constexpr int kV = kSK + kSKStages * kSKStage;
  // sk full, sk empty [kSKStages] each, v full, v empty [kVStages] each
  static constexpr int kBar = kV + kVStages * kVTile;
  static constexpr int kBytes = kBar + (2 * kSKStages + 2 * kVStages) * 8;
  static_assert(kBytes + 1024 <= 232448, "past the 227 KB a block may take");
};

template <typename T, int DC>
__global__ void __launch_bounds__(WideSmem<DC>::kThreads, 1)
flash_attention_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            T* __restrict__ out, float* __restrict__ lse, int s, int h, int d,
                            int num_q_tiles, int num_bh, int n_chunks, float scale_log2e,
                            int q_neg, int causal) {
  using L = WideSmem<DC>;
  constexpr int kWGs = L::kWGs, kBM = L::kBM, kBN = L::kBN;
  constexpr int kSKS = L::kSKStages, kVS = L::kVStages, kON = L::kON, kOParts = L::kOParts;
  constexpr int kSbo = 8 * L::kRowB;  // 8 rows of a d-box
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk_full = base + L::kBar;
  const uint32_t sk_empty = sk_full + 8 * kSKS;
  const uint32_t v_full = sk_empty + 8 * kSKS;
  const uint32_t v_empty = v_full + 8 * kVS;

  const int chunk = blockIdx.x % n_chunks;  // the chunks of a query tile run together
  const int rest = blockIdx.x / n_chunks;
  const int bh = rest % num_bh;
  const int qt = num_q_tiles - 1 - rest / num_bh;  // most causal work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_boxes = d / 64;
  // keys past the block's last row are masked for every row of it
  const int kv_len = causal ? min(s, (qt + 1) * kBM) : s;
  const int n_tiles = (kv_len + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kSKS; ++st) {
      mbar_init(sk_full + 8 * st, 1);
      mbar_init(sk_empty + 8 * st, 4 * kWGs);  // lane 0 of each compute warp
    }
#pragma unroll
    for (int st = 0; st < kVS; ++st) {
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 4 * kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWGs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs));
    if (warp == 4 * kWGs && lane == 0) {  // ----------------------------- loader
      int it = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int e = 0; e < n_boxes; ++e, ++it) {
          const int st = it % kSKS;
          const uint32_t stage = base + L::kSK + st * L::kSKStage;
          mbar_wait(sk_empty + 8 * st, ((it / kSKS) & 1) ^ 1);
          mbar_expect_tx(sk_full + 8 * st, L::kSKStage);
#pragma unroll
          for (int w = 0; w < kWGs; ++w)
            tma_load_4d(stage + w * L::kBox, &tm_q, sk_full + 8 * st, 64 * e, hd,
                        qt * kBM + 64 * w, b);
          tma_load_4d(stage + kWGs * L::kBox, &tm_k, sk_full + 8 * st, 64 * e, hd, j * kBN, b);
        }
        const int vst = j % kVS;
        mbar_wait(v_empty + 8 * vst, ((j / kVS) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * vst, L::kVTile);
#pragma unroll
        for (int c = 0; c < DC / 64; ++c)
          tma_load_4d(base + L::kV + vst * L::kVTile + c * L::kBox, &tm_v, v_full + 8 * vst,
                      chunk * DC + 64 * c, hd, j * kBN, b);
      }
      // the compute warpgroups wait without the watchdog: it fires here if
      // a load never lands
      for (int i = max(0, it - kSKS); i < it; ++i)
        mbar_wait(sk_full + 8 * (i % kSKS), (i / kSKS) & 1);
      for (int j = max(0, n_tiles - kVS); j < n_tiles; ++j)
        mbar_wait(v_full + 8 * (j % kVS), (j / kVS) & 1);
    }
  } else {  // ------------------------------------------ compute warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kComputeRegs));
    const int wt = threadIdx.x & 127;  // thread of the warpgroup
    const int w4 = wt >> 5;            // warp of the warpgroup
    const int g = lane >> 2, t = lane & 3;
    const int row0 = qt * kBM + 64 * wg;  // the warpgroup's first query row
    const int warp_row = row0 + 16 * w4;  // the warp's first query row

    float o[kOParts][kON / 2];
#pragma unroll
    for (int p = 0; p < kOParts; ++p)
#pragma unroll
      for (int i = 0; i < kON / 2; ++i) o[p][i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2], mc[2];
    float sc[kBN / 2];         // S_j, then P_j in float32
    uint32_t pa[kBN / 16][4];  // P_j as the A fragments of the P V product

    auto release = [&](uint32_t bar) {  // this warp has read the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int it = 0;  // the (Q, K) box stages taken so far
    auto step = [&](int j, auto masked) {
      // S_j over the d-boxes in order, each box's stage freed once the
      // next box's products are issued and its own are done; the first
      // box's products start the sum (a constant flag, so no accumulator
      // is read before it is written)
      auto issue_box = [&](auto first) {
        const int st = it % kSKS;
        const uint32_t stage = base + L::kSK + st * L::kSKStage;
        mbar_spin(sk_full + 8 * st, (it / kSKS) & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<kBN>::template ss<0, 0, T>(
              sc, smem_desc(stage + wg * L::kBox + kk * 32, 16, kSbo, 1),
              smem_desc(stage + kWGs * L::kBox + kk * 32, 16, kSbo, 1),
              decltype(first)::value ? kk : 1);
        wgmma_commit();
        ++it;
      };
      wgmma_fence();
      issue_box(std::true_type{});
      for (int e = 1; e < n_boxes; ++e) {
        issue_box(std::false_type{});
        wgmma_wait<1>();
        release(sk_empty + 8 * ((it - 2) % kSKS));
      }
      wgmma_wait<0>();
      fence_regs(sc);
      release(sk_empty + 8 * ((it - 1) % kSKS));
      if (q_neg) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] = -sc[i];
      }
      fwd_max<decltype(masked)::value>(sc, m, alpha, mc, j * kBN, warp_row, g, t, s, causal,
                                       scale_log2e);
      fwd_exp(sc, l, alpha, mc, scale_log2e);
#pragma unroll
      for (int p = 0; p < kOParts; ++p)
#pragma unroll
        for (int i = 0; i < kON / 8; ++i) {
          o[p][4 * i] *= alpha[0];
          o[p][4 * i + 1] *= alpha[0];
          o[p][4 * i + 2] *= alpha[1];
          o[p][4 * i + 3] *= alpha[1];
        }
      pack_a<T>(sc, pa);
      // O_c += P_j V_j[:, chunk]: V MN-major across the chunk's d-boxes
      const int vst = j % kVS;
      const uint32_t v_tile = base + L::kV + vst * L::kVTile;
      mbar_spin(v_full + 8 * vst, (j / kVS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < kOParts; ++p)
          Wgmma<kON>::template rs<1, T>(
              o[p], pa[kk],
              smem_desc(v_tile + p * (kON / 64) * L::kBox + kk * 16 * L::kRowB, L::kBox, kSbo,
                        1),
              1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < kOParts; ++p) fence_regs(o[p]);
      fence_regs(pa);
      release(v_empty + 8 * vst);
    };
    const int first_masked = max(0, n_tiles - L::kMaskTiles);
    for (int j = 0; j < first_masked; ++j) step(j, std::false_type{});
    for (int j = first_masked; j < n_tiles; ++j) step(j, std::true_type{});

    // out = O / l, the chunk's columns of the warpgroup's rows inside S
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.0f / (lr == 0.0f ? 1.0f : lr);  // o is 0 too
      const int row = warp_row + g + 8 * r;
      if (row >= s) continue;
      if (lse != nullptr && chunk == 0 && t == 0)
        lse[static_cast<int64_t>(bh) * s + row] =
            lr == 0.0f ? INFINITY : (m[r] * scale_log2e + log2f(lr)) * kLn2;
      T* op = out + ((static_cast<int64_t>(b) * s + row) * h + hd) * d + chunk * DC;
#pragma unroll
      for (int i = 0; i < DC / 8; ++i) {
        const float* x = o[i / (kON / 8)] + 4 * (i % (kON / 8)) + 2 * r;
        *reinterpret_cast<uint32_t*>(op + 8 * i + 2 * t) = pack2<T>(x[0] * inv, x[1] * inv);
      }
    }
  }
}

// the wide kernel for T (bf16 or fp16) at a head dim d past 256, a
// multiple of DC
template <typename T, int DC>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out, float* lse,
                        int b, int s, int h, int d, int num_bh, Strides qs, Strides ks,
                        Strides vs, float scale_log2e, int causal, cudaStream_t stream) {
  using L = WideSmem<DC>;
  const int64_t num_q_tiles = (static_cast<int64_t>(s) + L::kBM - 1) / L::kBM;
  const int n_chunks = d / DC;
  if (num_q_tiles * num_bh * n_chunks > INT32_MAX) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map<T>(&tm_q, q, b, s, h, d, qs, 64) ||
      !tensor_map<T>(&tm_k, k, b, s, h, d, ks, L::kBN) ||
      !tensor_map<T>(&tm_v, v, b, s, h, d, vs, L::kBN))
    return cudaErrorInvalidValue;
  const int smem = L::kBytes + 1024;  // + the 1024-byte alignment
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the kernel's scale must be > 0 (as the mma.sync kernel's)
  const float c = scale_log2e == 0.0f ? FLT_MIN : fabsf(scale_log2e);
  flash_attention_wide_kernel<T, DC>
      <<<static_cast<unsigned>(num_q_tiles * num_bh * n_chunks), L::kThreads, smem, stream>>>(
          tm_q, tm_k, tm_v, static_cast<T*>(out), lse, s, h, d, static_cast<int>(num_q_tiles),
          num_bh, n_chunks, c, scale_log2e < 0.0f ? 1 : 0, causal);
  return cudaGetLastError();
}

// float32 past D = 256: the split kernel, Q resident and one chunk at
// D = C (384, 512), else chunks of 512 columns with Q streamed
template <int C, bool kStreamQ>
cudaError_t launch_f32_split(const void* q, const void* k, const void* v, void* out, float* lse,
                             int s, int h, int d, int num_bh, Strides qs, Strides ks, Strides vs,
                             float scale_log2e, int causal, cudaStream_t stream) {
  using L = f32s::Layout<C, kStreamQ>;
  const int64_t num_q_tiles = (static_cast<int64_t>(s) + f32s::kRows - 1) / f32s::kRows;
  const int n_chunks = (d + C - 1) / C;
  if (num_q_tiles * num_bh * n_chunks > INT32_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_split_kernel<C, kStreamQ>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               L::kBytes);
  if (err != cudaSuccess) return err;
  const bool aligned = rows_aligned16({{q, qs}, {k, ks}, {v, vs}});
  flash_attention_f32_split_kernel<C, kStreamQ>
      <<<static_cast<unsigned>(num_q_tiles * num_bh * n_chunks), f32s::kThreads, L::kBytes,
         stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(out), lse, s, h, d,
                   static_cast<int>(num_q_tiles), num_bh, n_chunks, qs, ks, vs, scale_log2e,
                   causal, aligned ? 1 : 0);
  return cudaGetLastError();
}

// a head dim past 256: the wide kernels (bf16 and fp16 by chunks of 256
// columns where d is a multiple of 256, else 128; float32 the split kernel)
template <typename T>
cudaError_t launch_wide_d(const void* q, const void* k, const void* v, void* out, float* lse,
                          int b, int s, int h, int d, int num_bh, Strides qs, Strides ks,
                          Strides vs, float scale_log2e, int causal, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (d % 256 == 0)
      return launch_wide<T, 256>(q, k, v, out, lse, b, s, h, d, num_bh, qs, ks, vs, scale_log2e,
                                 causal, stream);
    return launch_wide<T, 128>(q, k, v, out, lse, b, s, h, d, num_bh, qs, ks, vs, scale_log2e,
                               causal, stream);
  } else if (d == 384) {
    return launch_f32_split<384, false>(q, k, v, out, lse, s, h, d, num_bh, qs, ks, vs,
                                        scale_log2e, causal, stream);
  } else if (d == 512) {
    return launch_f32_split<512, false>(q, k, v, out, lse, s, h, d, num_bh, qs, ks, vs,
                                        scale_log2e, causal, stream);
  } else {
    return launch_f32_split<512, true>(q, k, v, out, lse, s, h, d, num_bh, qs, ks, vs,
                                       scale_log2e, causal, stream);
  }
}

// ------------------------------------------------------------------ launch

// float32 at D = 128 and 256: the register-tiled CUDA-core kernel
template <int D>
cudaError_t launch_f32_tiled(const void* q, const void* k, const void* v, void* out, float* lse,
                             int s, int h, int num_bh, Strides qs, Strides ks, Strides vs,
                             float scale_log2e, int causal, cudaStream_t stream) {
  using L = F32T<D>;
  const int64_t num_q_tiles = (static_cast<int64_t>(s) + L::kRows - 1) / L::kRows;
  if (num_q_tiles * num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_tiled_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const bool aligned = rows_aligned16({{q, qs}, {k, ks}, {v, vs}});
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return cudaGetLastError();
  const int64_t grid = num_q_tiles * num_bh;
  const int first_wave = grid <= L::kBlocksPerSM * n_sm ? n_sm : static_cast<int>(grid);
  flash_attention_f32_tiled_kernel<D><<<static_cast<unsigned>(grid), L::kThreads, L::kBytes,
                                        stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, s, h, static_cast<int>(num_q_tiles), num_bh, qs, ks, vs,
      scale_log2e, causal, aligned ? 1 : 0, first_wave);
  return cudaGetLastError();
}

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
  } else if constexpr (D >= 128) {
    return launch_f32_tiled<D>(q, k, v, out, lse, s, h, num_bh, qs, ks, vs, scale_log2e, causal,
                               stream);
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
    default:  // past 256: any multiple of 128
      if (d > 256 && d % 128 == 0)
        return launch_wide_d<T>(q, k, v, out, lse, b, s, h, d, num_bh, qs, ks, vs, scale_log2e,
                                causal, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [b, s, h, d] of float32 (dtype 0), bfloat16 (1) or float16 (2)
// with element strides (*_sb, *_ss, *_sh) and unit stride on d; out:
// contiguous [b, s, h, d] of the same type; lse: null, or [b, h, s]
// float32 for each row's log-sum-exp (natural log); all on the device of
// ``stream``. d is 16, 32, 64, 128 or 256 or a multiple of 128 past 256
// (the wrapper pads any other d up to one of these). The 16-bit types also need every base pointer 16-byte
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
