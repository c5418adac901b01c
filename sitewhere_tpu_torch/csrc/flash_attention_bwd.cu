// Blockwise (flash) multi-head attention, backward: from q, k, v [B, S, H,
// D], the forward's output o, its gradient dO and each row's log-sum-exp
// lse [B, H, S] (flash_attention.cu writes it), the gradients dq, dk, dv
// [B, S, H, D] in the input type, with an optional causal mask.
//
// Replaces: no TPU kernel. The JAX package's trainer
// (sitewhere_tpu/models/transformer.py:153) takes jax.value_and_grad
// through flash_attention, which off the TPU is the oracle
// sitewhere_tpu/ops/attention.py:40 mha_reference; its Pallas kernel has no
// gradient of its own. This is the gradient of exact softmax attention:
//
//   delta_i = sum_d dO_id O_id                 (a small pass, float32)
//   P_ij    = exp(scale q_i.k_j - lse_i)       (recomputed, never stored)
//   dV_j    = sum_i P_ij dO_i
//   dP_ij   = dO_i . v_j
//   dS_ij   = P_ij (dP_ij - delta_i)
//   dK_j    = scale sum_i dS_ij q_i
//   dQ_i    = scale sum_j dS_ij k_j
//
// * bfloat16 at every head dim (D = 32 on the transformer's path, D = 128
//   on the d_model=256, heads=2 model's): one pass over the
//   (query, key) pairs, FA3's backward for Hopper, in three launches on the caller's
//   stream: a prep pass (delta; lse in base 2; the turn counters zeroed),
//   the main kernel and a pass that scales the float32 dQ and rounds it to
//   bf16. A block of the main kernel owns (batch, head, 128 keys) and walks
//   the 64-row query tiles; its K and V tiles stay in shared memory.
//   - Warp-specialised: warpgroups 0 and 1 (64 keys each) compute; in
//     warpgroup 2 one warp issues the TMA loads (cp.async.bulk.tensor of
//     the Q and dO tiles through 4-d tensor maps that describe the strided
//     q/k/v views in place, and bulk copies of the tile's lse and delta)
//     into a 2-stage ring guarded by mbarriers, and three warps hand dQ on
//     (below). setmaxnreg asks 232 registers a thread for the compute
//     warpgroups and gives warpgroup 2 40.
//   - Five wgmma products a tile, one exponential a pair: S^T = K Q^T and
//     dP^T = V dO^T from shared memory; P^T = exp2(S^T scale log2e -
//     lse2) (ex2.approx, the scale folded into one FMA) and dS^T = P^T
//     (dP^T - delta) in the accumulator registers, which, rounded to bf16,
//     are the register A operands of dV += P^T dO and dK += dS^T Q (dO
//     and Q read transposed from the same tiles); dS^T also goes to shared
//     memory (128-byte swizzle, written by hand) as the transposed A of
//     dQ_tile = dS K against the block's own K tile. Causal: the block
//     starts at the query tile of its first key; the diagonal and the
//     ragged last key block are masked per element. Masked (query, key)
//     pairs have P = 0, as the oracle's -1e30 scores give once the
//     softmax is taken; padded query rows carry lse2 = +inf, so P = 0.
//   - The swizzle of each tile is its row width: 32, 64 or 128 bytes for
//     D = 16, 32, 64, the same in the tensor map and in every wgmma
//     descriptor (K-major for the S and dP products, MN-major for the
//     others); each tile starts on a 1024-byte boundary. At D = 128 a row
//     (256 bytes) is wider than the largest swizzle, so every tile is two
//     64-column d-boxes of 128-byte swizzle (hopper_common.cuh), and the
//     compute warpgroups split dQ by columns (bwd_compute_d128).
//   - dQ, deterministic: warpgroup 0 stores its dQ_tile in shared memory
//     (two buffers, one a tile in turn) and warpgroup 1 adds its own; the
//     writer warp hands the sum to a bulk copy into a float32 [B H, S, D]
//     accumulator: key block 0 stores, every later block adds
//     (cp.reduce.async.bulk) once the turn counter of that (batch, head,
//     query tile) says that every earlier key block has added. A watcher
//     warp polls the next tiles' counters ahead of the writer and a passer
//     warp bumps a tile's counter once its add is complete, mbarriers
//     between the three (with the poll and the release fence on its own
//     path the writer set the pace of the whole kernel). So each element is summed in the same order on
//     every run, and the gradient is bitwise identical from run to run; no
//     block waits on a later one (blockIdx.x = key block x B H + (batch,
//     head), so earlier key blocks are dispatched first, and they have
//     the most query tiles under a causal mask). A wait that outlasts ~10
//     s traps instead of hanging the card.
// * float16 at every head dim: the mma.sync kernels below (MmaBwdTile), a
//   dK/dV kernel (a block owns 64 keys) and a dQ kernel (a block owns 64
//   query rows) after the prep pass, each output element summed by one
//   thread in a fixed order, so bitwise the same from run to run. Their
//   rows of P^T and dS^T are scaled by a power of two each (RowScale),
//   which the one-pass kernel's dQ, a sum over a block's keys, could not
//   undo.
// * float32: CUDA cores, float32 products (tensor cores would mean TF32,
//   about 3 decimal digits), two kernels after the prep pass: one thread
//   per key (dK/dV) or per query (dQ) with its own row and accumulators in
//   registers, the other side's tiles of 32 rows in shared memory. At
//   D = 64 the dK/dV thread holds 4 x 64 floats and spills, at D = 128 far
//   more; it is not on the transformer's path.
//
// q, k and v are read in place through (batch, row, head) strides with unit
// stride on D (the strided views of one fused qkv product); o and dO are
// contiguous [B, S, H, D]; dq, dk and dv are written contiguous. Any S;
// head dims 16, 32, 64 and 128. The 16-bit types need 16-byte aligned base
// pointers and strides that are a multiple of 8 elements (TMA and cp.async
// take 16-byte strides).
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no link against libcuda).
//
// Bound: operations. At the transformer's shape (B=8, S=16384, H=8, D=32,
// bf16, causal) there are 8.6e9 live (query, key) pairs. The backward does
// five products a pair (S, dP, dV, dK, dQ), 2.5x the forward's 1.1e12
// operations: 2.75e12 at 989 TFLOP/s is 2.78 ms. It takes one exponential
// a live pair (2.05 ms at 16 per SM per clock) and moves about 0.55 GB
// (0.16 ms) plus the float32 dQ accumulator's traffic through L2. At
// [8, 16384, 2, 128] the products take the same 2.78 ms and the
// exponentials a quarter of it (0.51 ms): the tensor cores set the pace.

#include "hopper_common.cuh"

namespace {

// ------------------------------------------------------------- prep pass

// delta[bh][i] = sum_d dO[b, i, h, d] O[b, i, h, d] and lse2[bh][i] =
// lse[bh][i] log2(e), one thread a (b, i, h) row, rows `pitch` apart; then
// the padded rows i in [s, pitch) of every bh (lse2 = +inf, so P = 0
// there; delta = 0) and n_turns turn counters set to 0
template <typename T, int D>
__global__ void flash_bwd_prep_kernel(const T* __restrict__ o,
                                      const T* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ delta,
                                      float* __restrict__ lse2,
                                      int* __restrict__ turns, int64_t rows,
                                      int s, int h, int pitch,
                                      int64_t pad_rows, int64_t n_turns) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) {
    r -= rows;
    if (r < pad_rows) {
      const int64_t pad = pitch - s;
      const int64_t idx = (r / pad) * pitch + s + r % pad;
      delta[idx] = 0.0f;
      lse2[idx] = INFINITY;
    } else if (r - pad_rows < n_turns) {
      turns[r - pad_rows] = 0;
    }
    return;
  }
  const T* op = o + r * D;
  const T* dp = dout + r * D;
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc = fmaf(to_float(op[c]), to_float(dp[c]), acc);
  // r = (b s + i) h + hd  ->  (b h + hd) pitch + i
  const int64_t hd = r % h;
  const int64_t bi = r / h;
  const int64_t i = bi % s;
  const int64_t b = bi / s;
  const int64_t idx = (b * h + hd) * pitch + i;
  delta[idx] = acc;
  lse2[idx] = lse[(b * h + hd) * s + i] * kLog2e;
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

// ------------------------------------------------- mma.sync (16-bit types)

// The backward of float16 at every head dim, where the wgmma kernel below
// does not reach (its dQ sums dS over a block's keys, and a per-row float16
// scale of dS^T cannot be undone in that sum). Two
// kernels after the prep pass, each output element summed by one thread in
// a fixed order (deterministic), on mma.sync m16n8k16 (float32
// accumulators) with the forward's fragment layouts:
// * dK/dV: a block of 4 warps owns 64 keys, 16 a warp, with its K and V
//   tiles in shared memory; it walks the query tiles (kBQ rows of Q and dO
//   through a 2-stage cp.async ring): S^T = K Q^T and dP^T = V dO^T,
//   P^T = exp2(S^T scale log2e - lse2), dS^T = P^T (dP^T - delta), then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T, rounded to T, as the
//   A operands straight from the accumulators;
// * dQ: a block of 4 warps owns 64 query rows, 16 a warp, Q and dO as A
//   fragments in registers; it walks the key tiles (kBK keys of K and V
//   through the ring): S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ +=
//   dS K.
// A causal tile wholly masked for a warp is skipped; the diagonal and the
// ragged edge are masked per element. Rows past S load as zeros and are
// masked (P = 0).

constexpr int kPad16 = 8;  // 16-bit elements of padding a shared row

// float16 keeps 5 exponent bits: a P or dS entry below 2^-14 is subnormal
// and one below 2^-24 is lost, where bfloat16 keeps float32's range. So
// the float16 kernels round each row of P^T and dS^T (dS in the dQ
// kernel) to float16 times 2^e, e the row's own exponent: at most
// RowScale::kTop for the row's largest entry so far (2^15 < 65504, no
// overflow), lowered as a larger entry arrives, the row's accumulator
// rescaled by the same power of two (exact in float32) and 2^-e taken off
// at the end. A row's tiny entries then keep float16's 11 bits relative
// to the row's largest, as bfloat16's 8 bits keep them.
struct RowScale {
  static constexpr int kTop = 15;
  static constexpr int kStart = 127;  // above any exponent a row takes
  int e[2] = {kStart, kStart};        // rows g and g + 8 of the thread

  // lower the exponents for this tile's entries v[nt][4] (rows by e >> 1)
  // and rescale acc[.][4] with them; quad-wide, as a row lies in 4 lanes
  template <int kNT, int kDT>
  __device__ __forceinline__ void update(const float (&v)[kNT][4], float (&acc)[kDT][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mx = fmaxf(mx, fmaxf(fabsf(v[nt][2 * r]), fabsf(v[nt][2 * r + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (mx > 0.0f) {
        // mx < 2^x (x of frexp; a subnormal mx takes the clamp below)
        const int x = ((__float_as_int(mx) >> 23) & 0xff) - 126;
        const int want = min(kTop - x, 126);
        if (want < e[r]) {
          const float f = e[r] == kStart ? 1.0f : ldexpf(1.0f, want - e[r]);
#pragma unroll
          for (int i = 0; i < kDT; ++i) {
            acc[i][2 * r] *= f;
            acc[i][2 * r + 1] *= f;
          }
          e[r] = want;
        }
      }
    }
  }

  __device__ __forceinline__ float up(int r) const {
    return e[r] == kStart ? 1.0f : ldexpf(1.0f, e[r]);
  }
  __device__ __forceinline__ float down(int r) const {
    return e[r] == kStart ? 1.0f : ldexpf(1.0f, -e[r]);
  }
};

template <int D>
struct MmaBwdTile {
  static_assert(D % 16 == 0 && D <= 128, "D must be 16, 32, 64 or 128");
  static constexpr int kRows = 64;                 // keys (dK/dV) or queries (dQ) a block
  static constexpr int kOther = D <= 64 ? 64 : 32; // rows of the other side a tile
  static constexpr int kRow = D + kPad16;          // shared row, elements
  static constexpr int kChunks = D / 8;            // 16-byte chunks a row
  // dK/dV: K, V [kRows][kRow] then the Q/dO ring [2][2][kOther][kRow];
  // dQ: the K/V ring [2][2][kOther][kRow]
  static constexpr int kDkdvBytes = (2 * kRows + 4 * kOther) * kRow * 2;
  static constexpr int kDqBytes = 4 * kOther * kRow * 2;
};

// rows [row0, row0 + n) of a strided [.., D] view of T into a shared tile
// [n][kRow] as 16-byte cp.async copies; rows at or past s read as zeros
template <typename T, int D, int kRowE, int kN, int kThreadsN>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t stride,
                                          int row0, int s, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < (kN * kChunks + kThreadsN - 1) / kThreadsN; ++i) {
    const int e = tid + i * kThreadsN;
    if ((kN * kChunks) % kThreadsN != 0 && e >= kN * kChunks) break;
    const int r = e / kChunks, c = e % kChunks;
    const int row = row0 + r;
    const bool valid = row < s;
    cp_async16(smem_addr(dst + r * kRowE + c * 8),
               src + static_cast<int64_t>(valid ? row : 0) * stride + c * 8, valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int s, int h, int num_bh, Strides qs,
                          Strides ks, Strides vs, float scale_log2e, float scale,
                          int causal) {
  using Tile = MmaBwdTile<D>;
  constexpr int kRow = Tile::kRow, kBQ = Tile::kOther, kRows = Tile::kRows;
  constexpr int kNT = kBQ / 8;  // 8-query column tiles of S^T
  constexpr int kDT = D / 8;    // 8-wide column tiles of dK, dV
  extern __shared__ uint8_t smem_raw[];
  T* const k_s = reinterpret_cast<T*>(smem_raw);
  T* const v_s = k_s + kRows * kRow;
  T* const ring = v_s + kRows * kRow;  // [stage][0: Q, 1: dO][kBQ][kRow]

  const int bh = blockIdx.x % num_bh;
  const int kt = blockIdx.x / num_bh;  // the first key tiles have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = kt * kRows;
  const int wkey = key0 + 16 * warp;  // the warp's first key

  const T* qb = q + b * qs.b + hd * qs.h;
  const T* db = dout + (static_cast<int64_t>(b) * s * h + hd) * D;
  const float* lb = lse2 + static_cast<int64_t>(bh) * s;
  const float* eb = delta + static_cast<int64_t>(bh) * s;

  load_rows<T, D, kRow, kRows, 128>(k_s, k + b * ks.b + hd * ks.h, ks.s, key0, s,
                                    threadIdx.x);
  load_rows<T, D, kRow, kRows, 128>(v_s, v + b * vs.b + hd * vs.h, vs.s, key0, s,
                                    threadIdx.x);
  // queries before the block's first key see none of its keys
  const int m_first = causal ? key0 / kBQ : 0;
  const int m_tiles = (s + kBQ - 1) / kBQ;
  auto load_tile = [&](int m, int stage) {
    T* dst = ring + stage * 2 * kBQ * kRow;
    load_rows<T, D, kRow, kBQ, 128>(dst, qb, qs.s, m * kBQ, s, threadIdx.x);
    load_rows<T, D, kRow, kBQ, 128>(dst + kBQ * kRow, db, static_cast<int64_t>(h) * D,
                                    m * kBQ, s, threadIdx.x);
  };
  if (m_first < m_tiles) load_tile(m_first, 0);
  cp_async_commit();  // K, V and the first tile: one group

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;
  RowScale p_scale, s_scale;   // float16 only

  for (int m = m_first, it = 0; m < m_tiles; ++m, ++it) {
    if (m + 1 < m_tiles) load_tile(m + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile m (and K, V) landed
    __syncthreads();     // ... everyone's
    const int q0 = m * kBQ;
    // a causal tile wholly before this warp's keys adds nothing to them
    if (!(causal && q0 + kBQ - 1 < wkey)) {
      const T* q_t = ring + (it & 1) * 2 * kBQ * kRow;
      const T* d_t = q_t + kBQ * kRow;
      // S^T = K Q^T and dP^T = V dO^T: [16 keys, kBQ queries] a warp
      float st[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // A: the warp's 16 keys x d 16 kk.., from K and V
        const int arow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int acol = 16 * kk + (lane >> 4) * 8;
        uint32_t ka[4], va[4];
        ldmatrix_x4(smem_addr(k_s + arow * kRow + acol), ka);
        ldmatrix_x4(smem_addr(v_s + arow * kRow + acol), va);
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          // B: queries 16 p + 0..7 / 8..15 x d 16 kk + 0..7 / 8..15
          const int row = 16 * p + (lane & 7) + ((lane >> 4) << 3);
          const int col = 16 * kk + ((lane >> 3) & 1) * 8;
          uint32_t qf[4], df[4];
          ldmatrix_x4(smem_addr(q_t + row * kRow + col), qf);
          ldmatrix_x4(smem_addr(d_t + row * kRow + col), df);
          mma_16816<T>(st[2 * p], ka, qf[0], qf[1]);
          mma_16816<T>(st[2 * p + 1], ka, qf[2], qf[3]);
          mma_16816<T>(dpt[2 * p], va, df[0], df[1]);
          mma_16816<T>(dpt[2 * p + 1], va, df[2], df[3]);
        }
      }
      // P^T and dS^T in place of S^T and dP^T, then as A fragments (the
      // accumulator's column pairs), float16 rows scaled (RowScale)
      const bool edge = (causal && q0 < wkey + 15) || q0 + kBQ > s;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int qc = q0 + 8 * nt + 2 * t;
        const float l0 = qc < s ? lb[qc] : 0.0f, l1 = qc + 1 < s ? lb[qc + 1] : 0.0f;
        const float e0 = qc < s ? eb[qc] : 0.0f, e1 = qc + 1 < s ? eb[qc + 1] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(st[nt][e], scale_log2e, -((e & 1) ? l1 : l0)));
          if (edge) {
            const int key = wkey + g + 8 * (e >> 1);
            const int query = qc + (e & 1);
            if (query >= s || (causal && key > query)) p = 0.0f;
          }
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? e1 : e0));
        }
      }
      float pu[2] = {1.0f, 1.0f}, su[2] = {1.0f, 1.0f};
      if constexpr (std::is_same_v<T, __half>) {
        p_scale.update(st, dv_acc);
        s_scale.update(dpt, dk_acc);
        pu[0] = p_scale.up(0), pu[1] = p_scale.up(1);
        su[0] = s_scale.up(0), su[1] = s_scale.up(1);
      }
      uint32_t pa[kNT / 2][4], sa[kNT / 2][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        pa[nt / 2][(nt & 1) * 2] = pack2<T>(st[nt][0] * pu[0], st[nt][1] * pu[0]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack2<T>(st[nt][2] * pu[1], st[nt][3] * pu[1]);
        sa[nt / 2][(nt & 1) * 2] = pack2<T>(dpt[nt][0] * su[0], dpt[nt][1] * su[0]);
        sa[nt / 2][(nt & 1) * 2 + 1] = pack2<T>(dpt[nt][2] * su[1], dpt[nt][3] * su[1]);
      }
      // dV += P^T dO, dK += dS^T Q: B from the [query][d] tiles, transposed
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = 16 * p + (lane >> 4) * 8;
          uint32_t df[4], qf[4];
          ldmatrix_x4_trans(smem_addr(d_t + row * kRow + col), df);
          ldmatrix_x4_trans(smem_addr(q_t + row * kRow + col), qf);
          mma_16816<T>(dv_acc[2 * p], pa[kk], df[0], df[1]);
          mma_16816<T>(dv_acc[2 * p + 1], pa[kk], df[2], df[3]);
          mma_16816<T>(dk_acc[2 * p], sa[kk], qf[0], qf[1]);
          mma_16816<T>(dk_acc[2 * p + 1], sa[kk], qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // the slot of tile m may be written again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wkey + g + 8 * r;
    if (key >= s) continue;
    const int64_t row = ((static_cast<int64_t>(b) * s + key) * h + hd) * D;
    const float ks = scale * s_scale.down(r), vs = p_scale.down(r);
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int c = 8 * i + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + row + c) =
          pack2<T>(dk_acc[i][2 * r] * ks, dk_acc[i][2 * r + 1] * ks);
      *reinterpret_cast<uint32_t*>(dv + row + c) =
          pack2<T>(dv_acc[i][2 * r] * vs, dv_acc[i][2 * r + 1] * vs);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta, T* __restrict__ dq, int s,
                        int h, int num_q_tiles, int num_bh, Strides qs, Strides ks,
                        Strides vs, float scale_log2e, float scale, int causal) {
  using Tile = MmaBwdTile<D>;
  constexpr int kRow = Tile::kRow, kBK = Tile::kOther, kRows = Tile::kRows;
  constexpr int kNT = kBK / 8;  // 8-key column tiles of S
  constexpr int kDT = D / 8;
  extern __shared__ uint8_t smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [stage][0: K, 1: V][kBK][kRow]

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;  // most work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = qt * kRows + 16 * warp;  // the warp's first query row

  const T* kb = k + b * ks.b + hd * ks.h;
  const T* vb = v + b * vs.b + hd * vs.h;

  // Q and dO as A fragments (zeros past S), lse2 and delta of the rows
  uint32_t qa[D / 16][4], da[D / 16][4];
  float l2[2], dl[2];
  {
    const T* qbase = q + b * qs.b + hd * qs.h;
    const T* dbase = dout + (static_cast<int64_t>(b) * s * h + hd) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      const bool live = row < s;
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          qbase + static_cast<int64_t>(live ? row : 0) * qs.s);
      const uint32_t* dp = reinterpret_cast<const uint32_t*>(
          dbase + static_cast<int64_t>(live ? row : 0) * h * D);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qa[kk][r] = live ? __ldg(qp + kk * 8 + t) : 0u;
        qa[kk][r + 2] = live ? __ldg(qp + kk * 8 + 4 + t) : 0u;
        da[kk][r] = live ? __ldg(dp + kk * 8 + t) : 0u;
        da[kk][r + 2] = live ? __ldg(dp + kk * 8 + 4 + t) : 0u;
      }
      l2[r] = live ? lse2[static_cast<int64_t>(bh) * s + row] : 0.0f;
      dl[r] = live ? delta[static_cast<int64_t>(bh) * s + row] : 0.0f;
    }
  }

  // keys past the block's last row are masked for every row of it
  const int kv_len = causal ? min(s, (qt + 1) * kRows) : s;
  const int n_tiles = (kv_len + kBK - 1) / kBK;
  auto load_tile = [&](int j, int stage) {
    T* dst = ring + stage * 2 * kBK * kRow;
    load_rows<T, D, kRow, kBK, 128>(dst, kb, ks.s, j * kBK, s, threadIdx.x);
    load_rows<T, D, kRow, kBK, 128>(dst + kBK * kRow, vb, vs.s, j * kBK, s,
                                    threadIdx.x);
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dq_acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.0f;
  RowScale s_scale;   // float16 only

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = j * kBK;
    if (!(causal && k0 > wrow + 15)) {
      const T* k_t = ring + (j & 1) * 2 * kBK * kRow;
      const T* v_t = k_t + kBK * kRow;
      float sc[kNT][4], dp[kNT][4];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.0f;
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int key = 16 * p + (lane & 7) + ((lane >> 4) << 3);
          const int col = 16 * kk + ((lane >> 3) & 1) * 8;
          uint32_t kf[4], vf[4];
          ldmatrix_x4(smem_addr(k_t + key * kRow + col), kf);
          ldmatrix_x4(smem_addr(v_t + key * kRow + col), vf);
          mma_16816<T>(sc[2 * p], qa[kk], kf[0], kf[1]);
          mma_16816<T>(sc[2 * p + 1], qa[kk], kf[2], kf[3]);
          mma_16816<T>(dp[2 * p], da[kk], vf[0], vf[1]);
          mma_16816<T>(dp[2 * p + 1], da[kk], vf[2], vf[3]);
        }
      }
      // dS in place of dP, then as A fragments, float16 rows scaled
      const bool edge = (causal && k0 + kBK - 1 > wrow) || k0 + kBK > s;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2_approx(fmaf(sc[nt][e], scale_log2e, -l2[r]));
          if (edge) {
            const int key = k0 + 8 * nt + 2 * t + (e & 1);
            const int row = wrow + g + 8 * r;
            if (key >= s || (causal && key > row)) p = 0.0f;
          }
          dp[nt][e] = p * (dp[nt][e] - dl[r]);
        }
      }
      float su[2] = {1.0f, 1.0f};
      if constexpr (std::is_same_v<T, __half>) {
        s_scale.update(dp, dq_acc);
        su[0] = s_scale.up(0), su[1] = s_scale.up(1);
      }
      uint32_t sa[kNT / 2][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        sa[nt / 2][(nt & 1) * 2] = pack2<T>(dp[nt][0] * su[0], dp[nt][1] * su[0]);
        sa[nt / 2][(nt & 1) * 2 + 1] = pack2<T>(dp[nt][2] * su[1], dp[nt][3] * su[1]);
      }
      // dQ += dS K: B from the [key][d] tile, transposed
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
        for (int p = 0; p < D / 16; ++p) {
          const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = 16 * p + (lane >> 4) * 8;
          uint32_t kf[4];
          ldmatrix_x4_trans(smem_addr(k_t + key * kRow + col), kf);
          mma_16816<T>(dq_acc[2 * p], sa[kk], kf[0], kf[1]);
          mma_16816<T>(dq_acc[2 * p + 1], sa[kk], kf[2], kf[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= s) continue;
    T* out = dq + ((static_cast<int64_t>(b) * s + row) * h + hd) * D;
    const float qs = scale * s_scale.down(r);
#pragma unroll
    for (int i = 0; i < kDT; ++i)
      *reinterpret_cast<uint32_t*>(out + 8 * i + 2 * t) =
          pack2<T>(dq_acc[i][2 * r] * qs, dq_acc[i][2 * r + 1] * qs);
  }
}

// --------------------------------------------------------------- bfloat16

constexpr int kBM = 64;         // query rows a tile
constexpr int kBN = 128;        // keys a block: two compute warpgroups of 64
constexpr int kStages = 2;      // Q / dO ring depth
constexpr int kThreads = 384;   // compute warpgroups 0, 1; loader/writer 2
constexpr int kComputeRegs = 232;
constexpr int kLoaderRegs = 40;

template <int D>
struct BwdSmem {  // byte offsets from a 1024-byte aligned base
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "D must be 16, 32, 64 or 128");
  // a tile is kBoxes d-boxes of kBoxCols columns, one after the other
  // (hopper_common.cuh): one box up to D = 64, two at D = 128
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowB = 2 * kBoxCols;      // a box row; = its swizzle
  static constexpr int kTileB = kBM * 2 * D;      // a Q or dO tile
  static constexpr int kTileBox = kBM * kRowB;    // one d-box of it
  static constexpr int kKVBox = kBN * kRowB;      // one d-box of the K or V tile
  static constexpr int kK = 0;                    // K [kBoxes][kBN][kBoxCols]
  static constexpr int kV = kK + kBN * 2 * D;     // V [kBoxes][kBN][kBoxCols]
  static constexpr int kQ = kV + kBN * 2 * D;     // Q [kStages][kBoxes][kBM][kBoxCols]
  static constexpr int kDO = kQ + kStages * kTileB;
  // dS^T [128 keys][64 queries] bf16, a buffer; two at D = 128, where
  // each warpgroup's dQ product reads both warpgroups' rows
  static constexpr int kDSBufs = D == 128 ? 2 : 1;
  static constexpr int kDSBuf = 2 * 64 * 128;
  static constexpr int kDS = kDO + kStages * kTileB;
  static constexpr int kDQ = kDS + kDSBufs * kDSBuf;  // dQ [2][kBM * D] float
  static constexpr int kRows = kDQ + 2 * kBM * D * 4; // [kStages][lse2, delta][kBM]
  static constexpr int kBar = kRows + kStages * 2 * kBM * 4;
  // mbarriers: full[kStages], empty[kStages], kv, then two each of
  // dq_half, dq_full, dq_empty, turn, done, passed
  static constexpr int kBytes = kBar + (2 * kStages + 13) * 8;
  static_assert(kTileBox % 1024 == 0, "boxes start on 1024 bytes");
  static_assert(kBytes + 1024 <= 232448, "past the 227 KB a block may take");
  // wgmma descriptor layout type of a box: 1 = 128 B swizzle, 2 = 64 B,
  // 3 = 32 B (the tensor map's CU_TENSOR_MAP_SWIZZLE_* match)
  static constexpr int kSwizzle = kRowB == 128 ? 1 : (kRowB == 64 ? 2 : 3);
  // k16 step kk of a K-major operand over D: 32 bytes along a box row,
  // the next d-box after kBoxCols / 16 steps
  static __device__ __forceinline__ uint32_t k_step(uint32_t tile, int kk, int box) {
    return tile + (kk / (kBoxCols / 16)) * box + (kk % (kBoxCols / 16)) * 32;
  }
};

// One compute warpgroup's walk over the query tiles at D = 128 (warpgroup
// wg owns keys kw0 .. kw0 + 63 of the block). The same five products as at
// D <= 64; what differs:
// * S^T and dP^T take 8 k16 steps over the two d-boxes of K (V) and Q (dO);
//   dV and dK are [64 keys, 128] (64 registers each), with dO and Q read
//   MN-major across both d-boxes;
// * dQ_tile = dS K is split by columns, not by keys: warpgroup wg computes
//   columns 64 wg .. 64 wg + 63 over all 128 keys of the block, from both
//   warpgroups' dS^T rows (a 256-thread barrier once both are written;
//   two dS^T buffers, so a warpgroup that runs ahead never overwrites rows
//   the other still reads) and d-box wg of K. So a thread holds 32 dQ
//   registers, not 64, the block's sum over its keys happens inside the
//   wgmma, and each warpgroup stores its own columns of the tile's buffer
//   (no add between warpgroups);
// * the accumulators of S^T, dP^T and dQ are declared inside the loop and
//   never initialised (each product's first step does not accumulate), so
//   no value of theirs is carried from one tile to the next; the live set
//   peaks near 128 (dK, dV) + 64 (S^T, dP^T) registers;
// * the waits of these warpgroups spin without the watchdog (mbar_spin):
//   with a trap on their path ptxas held the region well below the 232
//   registers setmaxnreg gives, spilled dK and serialised the wgmmas.
__device__ __forceinline__ void bwd_compute_d128(
    const uint32_t base, uint8_t* const sm, const int wg, const int lane, const int m_first,
    const int m_tiles, const int key0, const int b, const int hd, const int s, const int h,
    const float scale_log2e, const float scale, const int causal, const uint32_t bar_full,
    const uint32_t bar_empty, const uint32_t bar_kv, const uint32_t bar_dq_full,
    const uint32_t bar_dq_empty, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv) {
  using L = BwdSmem<128>;
  constexpr int kSbo = 8 * L::kRowB;  // 8 rows of a box
  const int wt = threadIdx.x & 127;   // thread of the warpgroup
  const int w4 = wt >> 5;             // warp of the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = key0 + 64 * wg;     // the warpgroup's first key
  const uint32_t k_tile = base + L::kK + wg * kBM * L::kRowB;  // its keys, d-box 0
  const uint32_t v_tile = base + L::kV + wg * kBM * L::kRowB;
  const uint32_t k_box = base + L::kK + wg * L::kKVBox;        // all keys, d-box wg
  float4* const dq_bufs = reinterpret_cast<float4*>(sm + L::kDQ);

  float dv_acc[64], dk_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv_acc[i] = dk_acc[i] = 0.0f;

  mbar_spin(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int m = m_first, it = 0; m < m_tiles; ++m, ++it) {
    mbar_spin(bar_full + 8 * stage, phase);
    const uint32_t q_tile = base + L::kQ + stage * L::kTileB;
    const uint32_t do_tile = base + L::kDO + stage * L::kTileB;
    const uint32_t ds_buf = base + L::kDS + (it & 1) * L::kDSBuf;
    const float* lse_s = reinterpret_cast<const float*>(sm + L::kRows) + stage * 2 * kBM;
    const float* del_s = lse_s + kBM;

    // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries], K-major
    float sacc[32], pacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t a = smem_desc(L::k_step(k_tile, kk, L::kKVBox), 16, kSbo, 1);
      const uint64_t b = smem_desc(L::k_step(q_tile, kk, L::kTileBox), 16, kSbo, 1);
      Wgmma<64>::ss<0, 0>(sacc, a, b, kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t a = smem_desc(L::k_step(v_tile, kk, L::kKVBox), 16, kSbo, 1);
      const uint64_t b = smem_desc(L::k_step(do_tile, kk, L::kTileBox), 16, kSbo, 1);
      Wgmma<64>::ss<0, 0>(pacc, a, b, kk);
    }
    wgmma_commit();

    // P^T = exp2(S^T scale log2e - lse2), masked on the diagonal and past
    // the last key (overlaps the dP^T product)
    wgmma_wait<1>();
    fence_regs(sacc);
    const int q0 = m * kBM;
    const bool edge = (causal && q0 <= kw0) || kw0 + 64 > s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2_approx(fmaf(sacc[4 * j + r], scale_log2e, -((r & 1) ? l2.y : l2.x)));
        if (edge) {
          const int key = kw0 + 16 * w4 + g + 8 * (r >> 1);
          const int query = q0 + 8 * j + 2 * t + (r & 1);
          if (key >= s || (causal && key > query)) p = 0.0f;
        }
        sacc[4 * j + r] = p;
      }
    }
    // dS^T = P^T (dP^T - delta)
    wgmma_wait<0>();
    fence_regs(pacc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pacc[4 * j + r] = sacc[4 * j + r] * (pacc[4 * j + r] - ((r & 1) ? dl.y : dl.x));
    }
    uint32_t pa[4][4], sa[4][4];
    pack_a(sacc, pa);
    pack_a(pacc, sa);
    // dS^T rows of this warpgroup's keys to shared memory: row = key (128
    // bytes of 64 queries), its 16-byte chunks swizzled by the row's low 3
    // bits (128 B swizzle)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 64 * wg + 16 * w4 + g + 8 * half;
        const uint32_t addr = ds_buf + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                     "r"(sa[j >> 1][(j & 1) * 2 + half])
                     : "memory");
      }
    }
    fence_async_shared();

    // dV += P^T dO, dK += dS^T Q (dO and Q MN-major across both d-boxes),
    // then, once both warpgroups' dS^T rows are in shared memory, this
    // warpgroup's columns of dQ_tile = dS K (dS^T and K MN-major)
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1>(dv_acc, pa[kk],
                        smem_desc(do_tile + kk * 16 * L::kRowB, L::kTileBox, kSbo, 1), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1>(dk_acc, sa[kk],
                        smem_desc(q_tile + kk * 16 * L::kRowB, L::kTileBox, kSbo, 1), 1);
    named_sync(1, 256);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t a = smem_desc(ds_buf + kk * 16 * 128, 16, 1024, 1);
      const uint64_t b = smem_desc(k_box + kk * 16 * L::kRowB, 16, kSbo, 1);
      Wgmma<64>::ss<1, 1>(dq, a, b, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);
    fence_regs(pa);
    fence_regs(sa);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);  // Q, dO read
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }

    // this warpgroup's columns of the tile's dQ into buffer it & 1: float4
    // (i, wt) at (8 wg + i) 128 + wt holds rows 16 w4 + g (+ 8), columns
    // 64 wg + 8 i + 2 t (+ 1); the buffer's previous tile (it - 2) was read
    const int slot = it & 1;
    float4* dq_buf = dq_bufs + slot * (kBM * 128 / 4);
    if (it >= 2) mbar_spin(bar_dq_empty + 8 * slot, ((it - 2) >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dq_buf[(8 * wg + i) * 128 + wt] =
          make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
    fence_async_shared();
    named_sync(2 + wg, 128);
    if (wt == 0) mbar_arrive(bar_dq_full + 8 * slot);
  }

  // dK (times scale) and dV of the warpgroup's 64 keys, bf16
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kw0 + 16 * w4 + g + 8 * half;
    if (key >= s) continue;
    const int64_t row = ((static_cast<int64_t>(b) * s + key) * h + hd) * 128;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * i + 2 * t, e = 4 * i + 2 * half;
      *reinterpret_cast<uint32_t*>(dk + row + c) =
          pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + c) = pack_bf16(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse2,   // [bh][m_tiles kBM]
                      const float* __restrict__ delta,  // [bh][m_tiles kBM]
                      float* __restrict__ dq_acc,       // [bh][m_tiles][kBM D]
                      int* __restrict__ turns,          // [bh][m_tiles]
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      int s, int h, int num_bh, int m_tiles, float scale_log2e,
                      float scale, int causal) {
  using L = BwdSmem<D>;
  constexpr int kRowB = L::kRowB;
  constexpr int kSbo = 8 * kRowB;  // 8 rows of a box
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::kBar;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;
  // [2] each, slot i & 1 for the i-th query tile of the block
  const uint32_t bar_dq_half = bar_kv + 8;        // warpgroup 0 -> 1
  const uint32_t bar_dq_full = bar_dq_half + 16;  // warpgroup 1 -> writer
  const uint32_t bar_dq_empty = bar_dq_full + 16; // writer -> warpgroups
  const uint32_t bar_turn = bar_dq_empty + 16;    // [2] watcher -> writer
  const uint32_t bar_done = bar_turn + 16;       // [2] writer -> passer
  const uint32_t bar_passed = bar_done + 16;     // [2] passer -> watcher

  const int bh = blockIdx.x % num_bh;
  const int nb = blockIdx.x / num_bh;  // key block; the first have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const int key0 = nb * kBN;
  const int m_first = causal ? key0 / kBM : 0;  // earlier queries see none of its keys
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);  // lane 0 of each compute warp
    }
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(bar_dq_half + 8 * slot, 1);
      mbar_init(bar_dq_full + 8 * slot, D == 128 ? 2 : 1);
      mbar_init(bar_dq_empty + 8 * slot, 1);
      mbar_init(bar_turn + 8 * slot, 1);
      mbar_init(bar_done + 8 * slot, 1);
      mbar_init(bar_passed + 8 * slot, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    if (warp == 8 && lane == 0) {  // ------------------------------ loader
      mbar_expect_tx(bar_kv, 2 * kBN * 2 * D);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          const uint32_t off = box * L::kKVBox + half * kBM * kRowB;
          tma_load_4d(base + L::kK + off, &tm_k, bar_kv, box * L::kBoxCols, hd,
                      key0 + half * kBM, b);
          tma_load_4d(base + L::kV + off, &tm_v, bar_kv, box * L::kBoxCols, hd,
                      key0 + half * kBM, b);
        }
      }
      const int64_t row_base = static_cast<int64_t>(bh) * m_tiles * kBM;
      int stage = 0;
      uint32_t phase = 0;
      for (int m = m_first; m < m_tiles; ++m) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * L::kTileB + 2 * kBM * 4);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          const uint32_t off = stage * L::kTileB + box * L::kTileBox;
          tma_load_4d(base + L::kQ + off, &tm_q, full, box * L::kBoxCols, hd, m * kBM, b);
          tma_load_4d(base + L::kDO + off, &tm_do, full, box * L::kBoxCols, hd, m * kBM, b);
        }
        const uint32_t rows = base + L::kRows + stage * 2 * kBM * 4;
        bulk_load(rows, lse2 + row_base + m * kBM, kBM * 4, full);
        bulk_load(rows + kBM * 4, delta + row_base + m * kBM, kBM * 4, full);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (warp == 9 && lane == 0) {  // --------------------- dQ writer
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        float* dst = dq_acc + (static_cast<int64_t>(bh) * m_tiles + m) * kBM * D;
        const uint32_t buf = base + L::kDQ + (i & 1) * kBM * D * 4;
        mbar_wait(bar_dq_full + 8 * (i & 1), (i >> 1) & 1);
        mbar_wait(bar_turn + 8 * (i & 1), (i >> 1) & 1);  // earlier key blocks added
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        if (nb == 0)  // the first contributor to every query tile
          bulk_store(dst, buf, kBM * D * 4);
        else
          bulk_reduce_add(dst, buf, kBM * D * 4);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(bar_dq_empty + 8 * (i & 1));  // the buffer may be written again
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        mbar_arrive(bar_done + 8 * (i & 1));  // the add is complete
      }
    } else if (warp == 10 && lane == 0) {  // -------------- turn watcher
      // waits for key block nb - 1 to finish each query tile, at most two
      // tiles ahead of the writer: slot i & 1 is free again once tile
      // i - 2's turn was passed on
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        if (i >= 2) mbar_wait(bar_passed + 8 * (i & 1), ((i - 2) >> 1) & 1);
        if (nb > 0) {
          const int* turn = turns + static_cast<int64_t>(bh) * m_tiles + m;
          const long long t0 = clock64();
          while (load_acquire(turn) != nb)
            if (clock64() - t0 > kWatchdogClocks) __trap();
        }
        mbar_arrive(bar_turn + 8 * (i & 1));
      }
    } else if (warp == 11 && lane == 0) {  // ----------- turn passer
      // a completed add passes the tile's turn on to key block nb + 1 (the
      // release fence is this warp's wait, not the writer's)
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        mbar_wait(bar_done + 8 * (i & 1), (i >> 1) & 1);
        add_release(turns + static_cast<int64_t>(bh) * m_tiles + m, 1);
        mbar_arrive(bar_passed + 8 * (i & 1));
      }
    }
  } else if constexpr (D == 128) {  // ------------------ compute warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kComputeRegs));
    bwd_compute_d128(base, sm, wg, lane, m_first, m_tiles, key0, b, hd, s, h, scale_log2e,
                     scale, causal, bar_full, bar_empty, bar_kv, bar_dq_full, bar_dq_empty,
                     dk, dv);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kComputeRegs));
    const int wt = threadIdx.x & 127;  // thread of the warpgroup
    const int w4 = wt >> 5;            // warp of the warpgroup
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = key0 + 64 * wg;    // the warpgroup's first key
    const uint32_t k_tile = base + L::kK + wg * kBM * kRowB;
    const uint32_t v_tile = base + L::kV + wg * kBM * kRowB;
    const uint32_t ds_tile = base + L::kDS + wg * 64 * 128;
    float4* const dq_bufs = reinterpret_cast<float4*>(sm + L::kDQ);

    float dv_acc[D / 2], dk_acc[D / 2], dq[D / 2], sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = dq[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.0f;

    mbar_wait(bar_kv, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int m = m_first, it = 0; m < m_tiles; ++m, ++it) {
      mbar_wait(bar_full + 8 * stage, phase);
      const uint32_t q_tile = base + L::kQ + stage * L::kTileB;
      const uint32_t do_tile = base + L::kDO + stage * L::kTileB;
      const float* lse_s = reinterpret_cast<const float*>(sm + L::kRows) + stage * 2 * kBM;
      const float* del_s = lse_s + kBM;

      // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries], K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss<0, 0>(sacc, smem_desc(k_tile + 32 * kk, 16, kSbo, L::kSwizzle),
                            smem_desc(q_tile + 32 * kk, 16, kSbo, L::kSwizzle), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss<0, 0>(pacc, smem_desc(v_tile + 32 * kk, 16, kSbo, L::kSwizzle),
                            smem_desc(do_tile + 32 * kk, 16, kSbo, L::kSwizzle), kk);
      wgmma_commit();

      // P^T = exp2(S^T scale log2e - lse2), masked on the diagonal and
      // past the last key (overlaps the dP^T product)
      wgmma_wait<1>();
      fence_regs(sacc);
      const int q0 = m * kBM;
      const bool edge = (causal && q0 <= kw0) || kw0 + 64 > s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = exp2_approx(fmaf(sacc[4 * j + r], scale_log2e, -((r & 1) ? l2.y : l2.x)));
          if (edge) {
            const int key = kw0 + 16 * w4 + g + 8 * (r >> 1);
            const int query = q0 + 8 * j + 2 * t + (r & 1);
            if (key >= s || (causal && key > query)) p = 0.0f;
          }
          sacc[4 * j + r] = p;
        }
      }
      // dS^T = P^T (dP^T - delta)
      wgmma_wait<0>();
      fence_regs(pacc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pacc[4 * j + r] = sacc[4 * j + r] * (pacc[4 * j + r] - ((r & 1) ? dl.y : dl.x));
      }
      uint32_t pa[4][4], sa[4][4];
      pack_a(sacc, pa);
      pack_a(pacc, sa);
      // dS^T to shared memory: row = key (128 bytes of 64 queries), its
      // 16-byte chunks swizzled by the row's low 3 bits (128 B swizzle)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * w4 + g + 8 * half;
          const uint32_t addr = ds_tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(sa[j >> 1][(j & 1) * 2 + half])
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major: the same tiles read
      // transposed), then, once every warp's dS^T is in shared memory,
      // dQ_tile = dS K (dS^T and K MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::template rs<1>(dv_acc, pa[kk],
                        smem_desc(do_tile + kk * 16 * kRowB, 16, kSbo, L::kSwizzle), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::template rs<1>(dk_acc, sa[kk],
                        smem_desc(q_tile + kk * 16 * kRowB, 16, kSbo, L::kSwizzle), 1);
      named_sync(1 + wg, 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::template ss<1, 1>(dq, smem_desc(ds_tile + kk * 16 * 128, 16, 1024, 1),
                           smem_desc(k_tile + kk * 16 * kRowB, 16, kSbo, L::kSwizzle), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);  // Q, dO read
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }

      // the block's dQ_tile into buffer it & 1, float4 (i, wt) at i 128 +
      // wt: warpgroup 0 stores its part, then warpgroup 1 adds its own (a
      // fixed order); the buffer's previous tile (it - 2) was read
      const int slot = it & 1;
      float4* dq_buf = dq_bufs + slot * (kBM * D / 4);
      if (it >= 2) mbar_wait(bar_dq_empty + 8 * slot, ((it - 2) >> 1) & 1);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          dq_buf[i * 128 + wt] =
              make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
        named_sync(1, 128);
        if (wt == 0) mbar_arrive(bar_dq_half + 8 * slot);
      } else {
        mbar_wait(bar_dq_half + 8 * slot, (it >> 1) & 1);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          float4 x = dq_buf[i * 128 + wt];
          x.x += dq[4 * i];
          x.y += dq[4 * i + 1];
          x.z += dq[4 * i + 2];
          x.w += dq[4 * i + 3];
          dq_buf[i * 128 + wt] = x;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(2, 128);
        if (wt == 0) mbar_arrive(bar_dq_full + 8 * slot);
      }
    }

    // dK (times scale) and dV of the warpgroup's 64 keys, bf16
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kw0 + 16 * w4 + g + 8 * half;
      if (key >= s) continue;
      const int64_t row = ((static_cast<int64_t>(b) * s + key) * h + hd) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int c = 8 * i + 2 * t, e = 4 * i + 2 * half;
        *reinterpret_cast<uint32_t*>(dk + row + c) =
            pack_bf16(dk_acc[e] * scale, dk_acc[e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + c) = pack_bf16(dv_acc[e], dv_acc[e + 1]);
      }
    }
  }
}

// dq = scale dq_acc in bf16: one thread a float4 (i, wt) of a tile's
// accumulator, which holds rows 16 w + g and + 8, columns 8 i + 2 t, + 1
// (wt = 32 w + 4 g + t, the compute thread that wrote it)
template <int D>
__global__ void flash_bwd_dq_kernel(const float4* __restrict__ dq_acc,
                                    __nv_bfloat16* __restrict__ dq, int s, int h,
                                    int m_tiles, int64_t total, float scale) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int wt = static_cast<int>(e % 128);
  const int i = static_cast<int>((e / 128) % (D / 8));
  const int64_t tile = e / (128 * (D / 8));
  const int m = static_cast<int>(tile % m_tiles);
  const int64_t bh = tile / m_tiles;
  const int64_t b = bh / h, hd = bh % h;
  const int lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int row = m * kBM + 16 * (wt >> 5) + g;
  const int c = 8 * i + 2 * t;
  const float4 x = dq_acc[e];
  if (row < s)
    *reinterpret_cast<uint32_t*>(dq + ((b * s + row) * h + hd) * D + c) =
        pack_bf16(x.x * scale, x.y * scale);
  if (row + 8 < s)
    *reinterpret_cast<uint32_t*>(dq + ((b * s + row + 8) * h + hd) * D + c) =
        pack_bf16(x.z * scale, x.w * scale);
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  void* scratch;
  int b, s, h, num_bh;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

// scratch layout (bytes): delta and lse2 [num_bh][pitch] float32 each;
// the wgmma kernel only: the dQ accumulator [num_bh][pitch][D] float32 and
// the turn counters [num_bh][pitch / kBM] int32. pitch is S for the other
// kernels and S rounded up to kBM for the wgmma kernel.
struct Scratch {
  int64_t pitch, m_tiles, n_turns, delta, lse2, dq_acc, turns, bytes;
  Scratch(int64_t num_bh, int64_t s, int64_t d, bool wgmma) {
    m_tiles = (s + kBM - 1) / kBM;
    pitch = wgmma ? m_tiles * kBM : s;
    n_turns = wgmma ? num_bh * m_tiles : 0;
    const int64_t rows = num_bh * pitch * 4;
    delta = 0;
    lse2 = rows;
    dq_acc = 2 * rows;
    turns = dq_acc + (wgmma ? rows * d : 0);
    bytes = turns + n_turns * 4;
  }
};

// the wgmma kernel takes bfloat16 at every instantiated head dim; dtype 0
// float32, 1 bfloat16, 2 float16
bool takes_wgmma(int dtype, int d) { return dtype == 1 && d <= 128; }

template <typename T, int D>
cudaError_t launch_prep(const Args& a, const Scratch& sc) {
  char* base = static_cast<char*>(a.scratch);
  const int64_t rows = static_cast<int64_t>(a.num_bh) * a.s;
  const int64_t pad_rows = static_cast<int64_t>(a.num_bh) * (sc.pitch - a.s);
  const int64_t blocks = (rows + pad_rows + sc.n_turns + 255) / 256;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  flash_bwd_prep_kernel<T, D><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
      reinterpret_cast<float*>(base + sc.delta), reinterpret_cast<float*>(base + sc.lse2),
      reinterpret_cast<int*>(base + sc.turns), rows, a.s, a.h, static_cast<int>(sc.pitch),
      pad_rows, sc.n_turns);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using B = __nv_bfloat16;
  const Scratch sc(a.num_bh, a.s, D, true);
  cudaError_t err = launch_prep<B, D>(a, sc);
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int64_t bsh = static_cast<int64_t>(a.s) * a.h * D;
  const Strides os{bsh, static_cast<int64_t>(a.h) * D, D};
  if (!tensor_map(&tm_q, a.q, a.b, a.s, a.h, D, a.qs, kBM) ||
      !tensor_map(&tm_k, a.k, a.b, a.s, a.h, D, a.ks, kBM) ||
      !tensor_map(&tm_v, a.v, a.b, a.s, a.h, D, a.vs, kBM) ||
      !tensor_map(&tm_do, a.dout, a.b, a.s, a.h, D, os, kBM))
    return cudaErrorInvalidValue;
  const int64_t n_blocks = (static_cast<int64_t>(a.s) + kBN - 1) / kBN;
  if (n_blocks * a.num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = BwdSmem<D>::kBytes + 1024;  // + the 1024-byte alignment
  err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  char* base = static_cast<char*>(a.scratch);
  float* dq_acc = reinterpret_cast<float*>(base + sc.dq_acc);
  flash_bwd_bf16_kernel<D><<<static_cast<unsigned>(n_blocks * a.num_bh), kThreads, smem,
                             a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, reinterpret_cast<const float*>(base + sc.lse2),
      reinterpret_cast<const float*>(base + sc.delta), dq_acc,
      reinterpret_cast<int*>(base + sc.turns), static_cast<B*>(a.dk), static_cast<B*>(a.dv),
      a.s, a.h, a.num_bh, static_cast<int>(sc.m_tiles), a.scale * kLog2e, a.scale,
      a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t total = static_cast<int64_t>(a.num_bh) * sc.m_tiles * (D / 8) * 128;
  if ((total + 255) / 256 > INT32_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<D><<<static_cast<unsigned>((total + 255) / 256), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<B*>(a.dq), a.s, a.h,
      static_cast<int>(sc.m_tiles), total, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  const Scratch sc(a.num_bh, a.s, D, false);
  cudaError_t err = launch_prep<float, D>(a, sc);
  if (err != cudaSuccess) return err;
  const char* base = static_cast<const char*>(a.scratch);
  const float* delta = reinterpret_cast<const float*>(base + sc.delta);
  const float* lse2 = reinterpret_cast<const float*>(base + sc.lse2);
  const int64_t num_tiles = (static_cast<int64_t>(a.s) + kF32Threads - 1) / kF32Threads;
  if (num_tiles * a.num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(num_tiles * a.num_bh);
  const float scale_log2e = a.scale * kLog2e;
  flash_bwd_dkdv_f32_kernel<D><<<blocks, kF32Threads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse2, delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.s, a.h, a.num_bh, a.qs, a.ks,
      a.vs, scale_log2e, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D><<<blocks, kF32Threads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse2, delta,
      static_cast<float*>(a.dq), a.s, a.h, static_cast<int>(num_tiles), a.num_bh, a.qs,
      a.ks, a.vs, scale_log2e, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args& a) {
  using Tile = MmaBwdTile<D>;
  const Scratch sc(a.num_bh, a.s, D, false);
  cudaError_t err = launch_prep<T, D>(a, sc);
  if (err != cudaSuccess) return err;
  const char* base = static_cast<const char*>(a.scratch);
  const float* delta = reinterpret_cast<const float*>(base + sc.delta);
  const float* lse2 = reinterpret_cast<const float*>(base + sc.lse2);
  const int64_t num_tiles = (static_cast<int64_t>(a.s) + Tile::kRows - 1) / Tile::kRows;
  if (num_tiles * a.num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(num_tiles * a.num_bh);
  const float scale_log2e = a.scale * kLog2e;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile::kDkdvBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma_kernel<T, D><<<blocks, 128, Tile::kDkdvBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), lse2, delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.s, a.h, a.num_bh, a.qs, a.ks, a.vs, scale_log2e, a.scale,
      a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kDqBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<T, D><<<blocks, 128, Tile::kDqBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), lse2, delta, static_cast<T*>(a.dq), a.s, a.h,
      static_cast<int>(num_tiles), a.num_bh, a.qs, a.ks, a.vs, scale_log2e, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_d(int dtype, const Args& a) {
  switch (dtype) {
    case 0:
      return launch_f32<D>(a);
    case 1:  // takes_wgmma(1, D)
      return launch_bf16<D>(a);
    case 2:
      return launch_mma<__half, D>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int d, int dtype, const Args& a) {
  switch (d) {
    case 16:
      return dispatch_d<16>(dtype, a);
    case 32:
      return dispatch_d<32>(dtype, a);
    case 64:
      return dispatch_d<64>(dtype, a);
    case 128:
      return dispatch_d<128>(dtype, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of scratch that swtpu_flash_attention_bwd needs for these sizes
// (dtype as there); 0 when there is nothing to compute.
extern "C" int64_t swtpu_flash_attention_bwd_scratch_bytes(int b, int s, int h, int d,
                                                           int dtype) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  return Scratch(static_cast<int64_t>(b) * h, s, d, takes_wgmma(dtype, d)).bytes;
}

// q, k, v: [b, s, h, d] of float32 (dtype 0), bfloat16 (1) or float16 (2)
// with element strides (*_sb, *_ss, *_sh) and unit stride on d; o and
// dout: contiguous [b, s, h, d] of that type (the forward's output and its
// gradient); lse: [b, h, s] float32, the forward's log-sum-exp (natural
// log); dq, dk, dv: contiguous [b, s, h, d] of that type, written whole;
// scratch: swtpu_flash_attention_bwd_scratch_bytes(b, s, h, d, dtype)
// bytes, 16-byte aligned, contents ignored; all on the device of
// ``stream``. d is 16, 32, 64 or 128; the 16-bit types also need every
// base pointer 16-byte aligned and every stride a multiple of 8. sm_scale
// is the forward's scale (any sign). Returns the first cudaGetLastError()
// that is not cudaSuccess after each of the three launches
// (cudaErrorInvalidValue for a head dim, type or grid the kernels do not
// take, or a view that no tensor map describes).
extern "C" int swtpu_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    void* scratch, int b, int s, int h, int d, int dtype, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float sm_scale, int causal,
    void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  const int64_t num_bh = static_cast<int64_t>(b) * h;
  if (num_bh > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, dout, lse, dq, dk, dv, scratch, b, s, h,
         static_cast<int>(num_bh), Strides{q_sb, q_ss, q_sh},
         Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, sm_scale,
         causal, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(d, dtype, a));
}
