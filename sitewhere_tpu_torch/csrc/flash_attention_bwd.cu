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
// * bfloat16 and float16 at every head dim (D = 32 on the transformer's
//   path, D = 128 on the d_model=256, heads=2 model's, D = 256 on the
//   d_model=256, heads=1 model's): one pass over the
//   (query, key) pairs, FA3's backward for Hopper, in three launches on the
//   caller's stream (four in float16, below): a prep pass (delta; lse in
//   base 2; the turn counters zeroed), the main kernel
//   (flash_bwd_wgmma_kernel<T, D>) and a pass that scales the float32 dQ
//   and rounds it to the input type. A block of the main kernel owns
//   (batch, head, 128 keys; 64 at D = 256) and walks the 64-row query
//   tiles; its K and V tiles stay in shared memory.
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
//     (dP^T - delta) in the accumulator registers, which, rounded to the
//     input type, are the register A operands of dV += P^T dO and dK +=
//     dS^T Q (dO and Q read transposed from the same tiles); dS^T also goes
//     to shared memory (128-byte swizzle, written by hand) as the
//     transposed A of dQ_tile = dS K against the block's own K tile. Causal: the block
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
//   - At D = 256 (four d-boxes) a block owns 64 keys, which both compute
//     warpgroups take, each 128 columns of dK, dV and dQ; each computes
//     S^T and dP^T whole for itself, and a tile's dQ goes out through the
//     Q and dO tiles of its stage, which the writer frees
//     (bwd_compute_d256): [64 keys, 256] of dK and dV is 256 registers a
//     thread for one warpgroup, and a dQ staging buffer beside the
//     two-stage ring would pass the 227 KB a block may take.
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
//   - Past D = 256 (any multiple of 128) the wide kernel
//     (flash_bwd_wide_kernel<T>, the note there) splits dK, dV and dQ into
//     chunks of 128 columns, a grid axis: a block owns 128 keys and one
//     chunk, streams the 64-column d-boxes of Q, K, dO and V to reduce S^T
//     and dP^T over the whole D each query tile, and keeps D = 128's
//     registers and dQ split at any D; the dQ turn counters run per chunk.
// * float16 keeps 5 exponent bits: an entry of P or dS below 2^-14 is
//   subnormal and one below 2^-24 is lost, where bfloat16 keeps float32's
//   range. So each of the three products that take float16 operands scales
//   them by powers of two of its own, chosen so that the float32 sums can
//   take them off exactly:
//   - dV += P^T dO and dK += dS^T Q: a row of P^T or dS^T is a key's, and
//     so is the accumulator's row, which the thread holds (rows g and
//     g + 8 of its warp's 16, as in mma.sync m16n8). RowScale keeps a
//     power of two a row, lowered as larger entries arrive (the float32
//     accumulator rescaled by the same power), and the end takes it off.
//   - dQ_tile = dS K sums over the block's keys, where a key's scale could
//     not be taken back out; so a query's row of dS is scaled by 2^e_i
//     fixed before the kernel runs, the same for every key block and both
//     warpgroups. It commutes with the sum in key-block order: the float32
//     dQ accumulator stays in scaled units (still bitwise the same run to
//     run, no extra barrier) and the dQ pass takes 2^-e_i off. e_i comes
//     from the bound |dS_ij| = P_ij |dO_i . (v_j - o_i)| <= ||dO_i||
//     (max_j ||v_j|| + ||o_i||): a fourth launch before the prep pass
//     (flash_bwd_vnorm_kernel) takes the largest norm of v's rows a part
//     of each (batch, head) (a max, order-free), and the prep pass, which
//     reads dO_i and o_i anyway, writes 2^e_i with the bound times it
//     below 2^14 (ops/attention.py f16_dq_scale_exponents is its plain
//     version). The loose bound (P <= 1) costs nothing measurable: a row's
//     error stays at one float16 step of its largest element (the CPU
//     emulation in tests/test_torch_attention.py).
// * float32: CUDA cores, float32 products (tensor cores would mean TF32,
//   about 3 decimal digits); not on the transformer's path. Up to D = 64
//   two kernels after the prep pass (dK/dV, then dQ: FA2's split, each
//   gradient element summed by one thread), one thread per key (dK/dV) or
//   per query (dQ) with its own row and accumulators in registers, the
//   other side's tiles of 32 rows in shared memory (F32BwdTile); at D = 64
//   the dK/dV thread holds 4 x 64 floats and spills. At D = 128 (65-127
//   padded) one pass after the prep pass (flash_bwd_f32_onepass_kernel,
//   the note there): a block owns 64 keys, K and V resident, and walks the
//   64-row query tiles from the last one down; a lane holds 4 x 8 of S or
//   dP and 64 floats of dV or dK; five products a pair, dQ summed in the
//   dq output in key-block order by the 16-bit kernels' turn counters.
//   At D = 256 and past it the register-tiled pair
//   (flash_bwd_{dkdv,dq}_f32_tiled_kernel, the note there), bound by the
//   CUDA cores' FMAs: a lane holds 4 x 4 of S or dP and up to 128
//   gradient floats, fed by broadcast float4 reads; the tiles come through a 3-slot
//   cp.async ring, and the gradients are split into column chunks of C =
//   512, 384, 256 or 128 (the widest that divides D; D = 256 is one chunk),
//   each recomputing S and dP in both kernels: 4 n + 3 D-long products a
//   live pair for n = D / C (7 at D = 256, 384 and 512, 11 at 768 and
//   1024), against the one-pass 5.
//
// q, k and v are read in place through (batch, row, head) strides with unit
// stride on D (the strided views of one fused qkv product); o and dO are
// contiguous [B, S, H, D]; dq, dk and dv are written contiguous. Any S;
// head dims 16, 32, 64, 128 and 256 and every multiple of 128 past 256.
// The 16-bit types need 16-byte aligned base
// pointers and strides that are a multiple of 8 elements (TMA takes
// 16-byte strides).
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
// exponentials a quarter of it (0.51 ms): the tensor cores set the pace;
// at [8, 16384, 1, 256] the same 2.78 ms of products, of which the D = 256
// kernel issues 7/5 (S^T and dP^T in both warpgroups).
// float16's range costs a few instructions a pair more (the row maxima
// and the scaled packs) and one pass over v.

#include "hopper_common.cuh"

namespace {

// ------------------------------------------------------------- prep pass

// float16's range (the note at the top): 2^e, e <= 126, with bound 2^e <
// 2^kDqTop (the largest scaled |dS| then stays below 2^15 < 65504); 1 for
// a bound that is 0 (its row of dS is 0) or not finite. ops/attention.py
// F16_DQ_TOP and f16_dq_scale_exponents are the same rule.
constexpr int kDqTop = 14;
constexpr int kVRows = 1024;  // rows of v a block of the norm pass takes

__device__ __forceinline__ float pow2(int e) {  // e in [-126, 127]
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float dq_scale_factor(float bound) {
  if (!(bound > 0.0f) || isinf(bound)) return 1.0f;
  // bound < 2^x (x of frexp; a subnormal bound takes the clamp)
  const int x = ((__float_as_int(bound) >> 23) & 0xff) - 126;
  return pow2(min(kDqTop - x, 126));
}

// float16 only: v_norms[bh][part] = the largest ||v_j|| over rows j of
// part (kVRows rows) of each (batch, head); one block a (bh, part). D = 0
// takes the head dim d at run time (the wide kernel's)
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_vnorm_kernel(const __half* __restrict__ v, Strides vs, int s, int h, int n_parts,
                       float* __restrict__ v_norms, int d) {
  const int dd = D > 0 ? D : d;
  const int bh = blockIdx.x / n_parts;
  const int part = blockIdx.x - bh * n_parts;
  const int b = bh / h;
  const int hd = bh - b * h;
  const __half* vb = v + b * vs.b + hd * vs.h;
  const int end = min(s, (part + 1) * kVRows);
  float mx = 0.0f;  // of the squared norms: a max, in no particular order
  for (int r = part * kVRows + threadIdx.x; r < end; r += 256) {
    const uint4* row = reinterpret_cast<const uint4*>(vb + static_cast<int64_t>(r) * vs.s);
    float n2 = 0.0f;
#pragma unroll
    for (int c = 0; c < dd / 8; ++c) {
      const uint4 x = __ldg(row + c);
      const __half2* hx = reinterpret_cast<const __half2*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __half22float2(hx[i]);
        n2 = fmaf(f.x, f.x, fmaf(f.y, f.y, n2));
      }
    }
    mx = fmaxf(mx, n2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float warp_max[8];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < 8; ++w) mx = fmaxf(mx, warp_max[w]);
    v_norms[blockIdx.x] = sqrtf(mx);
  }
}

// delta[bh][i] = sum_d dO[b, i, h, d] O[b, i, h, d] and lse2[bh][i] =
// lse[bh][i] log2(e), one thread a (b, i, h) row, rows `pitch` apart; then
// the padded rows i in [s, pitch) of every bh (lse2 = +inf, so P = 0
// there; delta = 0) and n_turns turn counters set to 0. float16 also
// writes dq_scale[bh][i] = 2^e_i from ||dO_i||, ||O_i|| and the largest of
// the bh's n_parts v_norms (1 on the padded rows). D = 0 takes the head
// dim d at run time (the wide kernel's): delta and the norms run over the
// whole of it.
template <typename T, int D>
__global__ void flash_bwd_prep_kernel(const T* __restrict__ o,
                                      const T* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ delta,
                                      float* __restrict__ lse2,
                                      float* __restrict__ dq_scale,
                                      const float* __restrict__ v_norms, int n_parts,
                                      int* __restrict__ turns, int64_t rows,
                                      int s, int h, int pitch,
                                      int64_t pad_rows, int64_t n_turns, int d) {
  constexpr bool kHalf = std::is_same_v<T, __half>;
  const int dd = D > 0 ? D : d;
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) {
    r -= rows;
    if (r < pad_rows) {
      const int64_t pad = pitch - s;
      const int64_t idx = (r / pad) * pitch + s + r % pad;
      delta[idx] = 0.0f;
      lse2[idx] = INFINITY;
      if constexpr (kHalf) dq_scale[idx] = 1.0f;
    } else if (r - pad_rows < n_turns) {
      turns[r - pad_rows] = 0;
    }
    return;
  }
  const T* op = o + r * dd;
  const T* dp = dout + r * dd;
  float acc = 0.0f, dn2 = 0.0f, on2 = 0.0f;
#pragma unroll
  for (int c = 0; c < dd; ++c) {
    const float x = to_float(op[c]), y = to_float(dp[c]);
    acc = fmaf(x, y, acc);
    if constexpr (kHalf) {
      dn2 = fmaf(y, y, dn2);
      on2 = fmaf(x, x, on2);
    }
  }
  // r = (b s + i) h + hd  ->  (b h + hd) pitch + i
  const int64_t hd = r % h;
  const int64_t bi = r / h;
  const int64_t i = bi % s;
  const int64_t b = bi / s;
  const int64_t idx = (b * h + hd) * pitch + i;
  delta[idx] = acc;
  lse2[idx] = lse[(b * h + hd) * s + i] * kLog2e;
  if constexpr (kHalf) {
    const float* vn = v_norms + (b * h + hd) * n_parts;
    float vmax = 0.0f;
    for (int p = 0; p < n_parts; ++p) vmax = fmaxf(vmax, vn[p]);
    dq_scale[idx] = dq_scale_factor(sqrtf(dn2) * (vmax + sqrtf(on2)));
  }
}

// float16's scale of the rows of P^T or dS^T (the note at the top): each
// row (a key's) is rounded to float16 times 2^e, e the row's own exponent:
// at most kTop for the row's largest entry so far (2^15 < 65504, no
// overflow), lowered as a larger entry arrives, the row's accumulator
// rescaled by the same power of two (exact in float32) and 2^-e taken off
// at the end. A row's tiny entries then keep float16's 11 bits relative
// to the row's largest, as bfloat16's 8 bits keep them. A thread holds
// rows g and g + 8 of its warp's 16 (elements 4 i + 2 r and 4 i + 2 r + 1
// of a wgmma accumulator are row r's), a row's columns over the 4 lanes of
// a quad.
struct RowScale {
  static constexpr int kTop = 15;
  static constexpr int kStart = 127;  // above any exponent a row takes
  int e[2] = {kStart, kStart};

  // lower the exponents for this tile's entries v and rescale acc with them
  template <int N, int M>
  __device__ __forceinline__ void update(const float (&v)[N], float (&acc)[M]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = 0.0f;
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        mx = fmaxf(mx, fmaxf(fabsf(v[4 * i + 2 * r]), fabsf(v[4 * i + 2 * r + 1])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (mx > 0.0f) {
        // mx < 2^x (x of frexp; a subnormal mx takes the clamp below)
        const int x = ((__float_as_int(mx) >> 23) & 0xff) - 126;
        const int want = min(kTop - x, 126);
        if (want < e[r]) {
          // (below 2^-126 the old entries are nothing beside the new ones)
          const float f = e[r] == kStart ? 1.0f : pow2(max(want - e[r], -126));
#pragma unroll
          for (int i = 0; i < M / 4; ++i) {
            acc[4 * i + 2 * r] *= f;
            acc[4 * i + 2 * r + 1] *= f;
          }
          e[r] = want;
        }
      }
    }
  }

  __device__ __forceinline__ float up(int r) const { return e[r] == kStart ? 1.0f : pow2(e[r]); }
  __device__ __forceinline__ float down(int r) const {
    return e[r] == kStart ? 1.0f : pow2(-e[r]);
  }

  // the accumulator c's columns 16 kk .. 16 kk + 15, each row times its
  // 2^e, as float16 A fragments (pack_a's layout: element e of a fragment
  // is row e & 1's)
  template <int N>
  __device__ __forceinline__ void pack(const float (&c)[N], uint32_t (&a)[N / 8][4]) const {
    const float u[2] = {up(0), up(1)};
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        a[kk][x] = pack2<__half>(c[8 * kk + 2 * x] * u[x & 1], c[8 * kk + 2 * x + 1] * u[x & 1]);
    }
  }
};

// the thread's dS^T to shared memory: words(j, w) gives w[half], columns
// 8 j + 2 t, + 1 of row row0 + g + 8 half; a row (a key) is 128 bytes of
// 64 queries, its 16-byte chunks swizzled by the row's low 3 bits (128 B
// swizzle)
template <typename Words>
__device__ __forceinline__ void store_ds(uint32_t tile, int row0, int g, int t, Words words) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t w[2];
    words(j, w);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      const uint32_t addr = tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(w[half]) : "memory");
    }
  }
}

// dK (times scale) and dV of the thread's keys key + 8 half, half = 0, 1
// (its rows of the accumulators, N columns from col0) into the contiguous
// [B, S, H, d] outputs (float16: 2^-e of each row's RowScale off)
template <typename T, int N>
__device__ __forceinline__ void store_dkdv(T* __restrict__ dk, T* __restrict__ dv,
                                           const float (&dk_acc)[N / 2],
                                           const float (&dv_acc)[N / 2],
                                           const RowScale& p_scale, const RowScale& s_scale,
                                           int key, int t, int b, int s, int h, int hd,
                                           float scale, int d, int col0 = 0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key + 8 * half >= s) continue;
    const int64_t row = ((static_cast<int64_t>(b) * s + key + 8 * half) * h + hd) * d + col0;
    float ks = scale, vs = 1.0f;
    if constexpr (std::is_same_v<T, __half>) {
      ks = scale * s_scale.down(half);
      vs = p_scale.down(half);
    }
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int c = 8 * i + 2 * t, e = 4 * i + 2 * half;
      *reinterpret_cast<uint32_t*>(dk + row + c) = pack2<T>(dk_acc[e] * ks, dk_acc[e + 1] * ks);
      if constexpr (std::is_same_v<T, __half>)
        *reinterpret_cast<uint32_t*>(dv + row + c) = pack2<T>(dv_acc[e] * vs, dv_acc[e + 1] * vs);
      else
        *reinterpret_cast<uint32_t*>(dv + row + c) = pack2<T>(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

// A tile's P^T (sacc) and dS^T (pacc) of a compute warpgroup as the A
// fragments of dV += P^T dO (pa) and dK += dS^T Q (sa), and dS^T to the
// shared tile of dQ = dS K (rows row0 + g, + 8 of ds_tile). float16: a
// key's rows of P^T and dS^T scaled by its RowScale (dv_acc and dk_acc
// rescaled with them), the dS^T for dQ by each query's dq_scale (dqs_s,
// the tile's 64).
template <typename T, int M>
__device__ __forceinline__ void tile_operands(const float (&sacc)[32], const float (&pacc)[32],
                                              float (&dv_acc)[M], float (&dk_acc)[M],
                                              RowScale& p_scale, RowScale& s_scale,
                                              const float* dqs_s, uint32_t ds_tile, int row0,
                                              int g, int t, uint32_t (&pa)[4][4],
                                              uint32_t (&sa)[4][4]) {
  if constexpr (std::is_same_v<T, __half>) {
    p_scale.update(sacc, dv_acc);
    s_scale.update(pacc, dk_acc);
    p_scale.pack(sacc, pa);
    // loaded before the stores, whose memory clobber would hold each load
    // behind the previous store
    float2 qs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[j] = *reinterpret_cast<const float2*>(dqs_s + 8 * j + 2 * t);
    store_ds(ds_tile, row0, g, t, [&](int j, uint32_t (&w)[2]) {
      w[0] = pack2<T>(pacc[4 * j] * qs[j].x, pacc[4 * j + 1] * qs[j].y);
      w[1] = pack2<T>(pacc[4 * j + 2] * qs[j].x, pacc[4 * j + 3] * qs[j].y);
    });
    s_scale.pack(pacc, sa);
  } else {
    pack_a<T>(sacc, pa);
    pack_a<T>(pacc, sa);
    store_ds(ds_tile, row0, g, t, [&](int j, uint32_t (&w)[2]) {
      w[0] = sa[j >> 1][(j & 1) * 2];
      w[1] = sa[j >> 1][(j & 1) * 2 + 1];
    });
  }
}

// ---------------------------------------------------------------- float32

constexpr int kF32Threads = 128;  // threads a block

// The float32 kernels' tiling at head dim D <= 64 (D = 128 takes the
// one-pass kernel, D = 256 and past it the register-tiled pair below): one
// thread a key (dK/dV) or a query (dQ) with its own row and accumulators in
// registers, the other side's tiles of 32 rows in shared memory
template <int D>
struct F32BwdTile {
  static constexpr int kRows = kF32Threads;  // keys or queries a block
  static constexpr int kTile = 32;           // rows of the other side a tile
  static_assert(D <= 64, "D = 128 takes the one-pass kernel, 256 and past it the tiled pair");
  static_assert(D % 4 == 0, "rows are float4 chunks");
  static_assert(2 * kTile * D * 4 <= 48 * 1024, "past 48 KB of static shared memory");
};

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
  using Tile = F32BwdTile<D>;
  constexpr int kTile = Tile::kTile;
  __shared__ __align__(16) float q_tile[kTile][D];
  __shared__ __align__(16) float do_tile[kTile][D];
  __shared__ float lse_tile[kTile], delta_tile[kTile];

  const int bh = blockIdx.x % num_bh;
  const int kt = blockIdx.x / num_bh;  // the first key tiles have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const int key0 = kt * Tile::kRows;
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
  const int q_begin = causal ? (key0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < s; q0 += kTile) {
    const int tile = min(kTile, s - q0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kTile * D; e += kF32Threads) {
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
    if (threadIdx.x < kTile) {
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
  using Tile = F32BwdTile<D>;
  constexpr int kTile = Tile::kTile;
  __shared__ __align__(16) float k_tile[kTile][D];
  __shared__ __align__(16) float v_tile[kTile][D];

  const int bh = blockIdx.x % num_bh;
  const int qt = num_q_tiles - 1 - blockIdx.x / num_bh;  // most work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const int row = qt * Tile::kRows + threadIdx.x;
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
  const int kv_end = causal ? min(s, (qt + 1) * Tile::kRows) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    const int tile = min(kTile, kv_end - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kTile * D; e += kF32Threads) {
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

// float32 at D = 256 (129-255 padded) and past it (any multiple of 128):
// FA2's pair on the CUDA cores, register-tiled, with a cp.async ring. Bound
// by the float32 FMAs (5 D-long products a live pair in one pass, at 67
// TFLOP/s). A block of 256 threads owns 32 rows of one side (dK/dV: 32
// keys; dQ: 32 queries) and one chunk of C columns of its gradients (a
// grid axis: 512, 384, 256 or 128, the widest that divides D, so that a
// lane's share of dK and dV is 128 floats at most), and walks tiles of 64
// rows of the other side.
// Each tile is a run of ring pieces:
//   * D / 64 S-pieces: 64 columns of the block's rows and of the tile's
//     rows of the two products' operands (K, V and Q, dO for dK/dV; Q, dO
//     and K, V for dQ). Warps 0-3 sum X = S^T (or S), warps 4-7 Y = dP^T
//     (or dP), by 64-column pieces in column order: a lane holds 4 x 4 of
//     them, each float4 read feeding 4 FMA chains. After the last one,
//     P = exp2(S scale log2(e) - lse2) (masked 0) and dP - delta go to two
//     shared tiles [64 other rows][32 own rows], and dS = P (dP - delta)
//     is taken in place.
//   * the chunk's columns of the other side: dK/dV a piece of 8 to 32
//     query rows of Q and dO (dV_c += P^T dO_c, dK_c += dS^T Q_c), dQ of
//     16 to 64 keys of K (dQ_c += dS K_c). A warp holds 4 of the block's
//     rows of each gradient, a lane their columns 4 (lane + 32 m), m <
//     C / 128: the rows' P and dS are one broadcast float4 a row of the
//     other side, and each float4 of it feeds 4 FMA chains.
// S and dP are computed once a chunk in each kernel: 4 D / C + 3 D-long
// products a live pair (7 at D = 256, 384 and 512, 11 at 768 and 1024),
// against the one-pass 5. The block's own rows come again with each
// tile's S-pieces (from L2): resident they would take 256 D bytes, 128 KB
// at D = 512, beside the ring. A ring of 3 slots, one __syncthreads a piece;
// each gradient element is summed by one thread in a fixed order (no
// atomics), so two calls give the same bits. 171 KB of shared memory and
// up to 255 registers: one block an SM. At D = 256 neither two blocks an SM
// (S-pieces of 32 columns, 128 registers: dK/dV spilled 156 B and ran 25 %
// slower), a 4-slot ring, own rows resident, nor 8 rows a warp in the
// chunk phase moved its time beyond the run-to-run spread.
namespace f32b {
constexpr int kThreads = 256;
constexpr int kOwn = 32;               // the block's rows
constexpr int kOth = 64;               // the other side's rows a tile
constexpr int kPiece = 64;             // columns of an S-piece
constexpr int kPitch = kPiece + 4;     // padded rows: the lanes' rows fall in other banks
constexpr int kStages = 3;
constexpr int kSlot = (kOwn + kOth) * 2 * kPitch;  // floats a slot: an S-piece's four tiles
constexpr int kTP = kOwn + 4;                      // pitch of the P and dS tiles
constexpr int kTile = kOth * kTP;                  // floats of P (or dS)
constexpr int kBytes = 4 * (kStages * kSlot + 2 * kTile);
static_assert(kBytes <= 227 * 1024, "past the shared memory a block may take");
}  // namespace f32b

// what the two kernels share: an S-piece's four tiles in a slot, the
// lanes' rows, the products and the softmax's gradient; own row o and
// other row t of X and Y (S-like and dP-like) are a key and a query in the
// order of kOwnIsKey
struct F32Bwd {
  static constexpr int kOwn = f32b::kOwn, kOth = f32b::kOth, kTP = f32b::kTP;
  static constexpr int kOthG = kOth / 4;  // lanes along the other side
  static_assert((kOwn / 16) * kOthG == 32, "4 x 4 a lane over 4 warps");
  float* own_a;  // the slot's four S-piece tiles
  float* own_b;
  float* oth_a;
  float* oth_b;

  // the S-piece tiles of a slot
  __device__ __forceinline__ explicit F32Bwd(float* slot)
      : own_a(slot),
        own_b(slot + kOwn * f32b::kPitch),
        oth_a(slot + 2 * kOwn * f32b::kPitch),
        oth_b(slot + (2 * kOwn + kOth) * f32b::kPitch) {}

  // the four tiles' columns [col, col + kPiece) of rows own0.. and oth0..
  __device__ __forceinline__ void load(const float* oa, const float* ob, int64_t osa_s,
                                       int64_t osb_s, int own0, const float* ta,
                                       const float* tb, int64_t tsa_s, int64_t tsb_s,
                                       int oth0, int s, int col, bool aligned) const {
    using namespace f32b;
    f32_copy_rows<kThreads, kOwn, kPiece>(own_a, kPitch, oa, osa_s, own0, s, col, aligned);
    f32_copy_rows<kThreads, kOwn, kPiece>(own_b, kPitch, ob, osb_s, own0, s, col, aligned);
    f32_copy_rows<kThreads, kOth, kPiece>(oth_a, kPitch, ta, tsa_s, oth0, s, col, aligned);
    f32_copy_rows<kThreads, kOth, kPiece>(oth_b, kPitch, tb, tsb_s, oth0, s, col, aligned);
  }

  // the lane's own rows (first of 4) and other rows (first of 4, kOthG apart)
  static __device__ __forceinline__ int own_row(int warp, int lane) {
    return (kOwn / 4) * (warp % 4) + 4 * (lane / kOthG);
  }
  static __device__ __forceinline__ int oth_row(int lane) { return lane % kOthG; }

  // acc += this piece's products: warps 0-3 X (the a tiles), 4-7 Y (b)
  __device__ __forceinline__ void dots(float (&acc)[4][4], int warp, int lane) const {
    using namespace f32b;
    const float* a = (warp < 4 ? own_a : own_b) + own_row(warp, lane) * kPitch;
    const float* b = (warp < 4 ? oth_a : oth_b) + oth_row(lane) * kPitch;
    f32_dots<4, 4, kPiece>(acc, a, kPitch, b, kOthG * kPitch);
  }

  // the tile's P (warps 0-3, from X and lse2) and dP - delta (4-7, from Y
  // and delta) into p_s and ds_s [kOth][kTP], then dS = P (dP - delta) in
  // ds_s; keys[i][j] / queries: the element's key and query, stat[.]: the
  // query's lse2 (warps 0-3) or delta (4-7)
  template <bool kOwnIsKey>
  static __device__ __forceinline__ void softmax_grad(const float (&acc)[4][4],
                                                      const float (&stat)[4], float* p_s,
                                                      float* ds_s, int own0, int oth0,
                                                      int warp, int lane, int s, int causal,
                                                      float scale_log2e) {
    const int o = own_row(warp, lane), t = oth_row(lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kOwnIsKey ? own0 + o + i : oth0 + t + kOthG * j;
        const int query = kOwnIsKey ? oth0 + t + kOthG * j : own0 + o + i;
        const float st = stat[kOwnIsKey ? j : i];
        if (warp < 4) {
          const bool live = key < s && query < s && (!causal || key <= query);
          x[i] = live ? exp2f(fmaf(acc[i][j], scale_log2e, -st)) : 0.0f;  // masked: P = 0
        } else {
          x[i] = acc[i][j] - st;
        }
      }
      *reinterpret_cast<float4*>((warp < 4 ? p_s : ds_s) + (t + kOthG * j) * kTP + o) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kOth * kTP; e += f32b::kThreads) ds_s[e] *= p_s[e];
  }
};

// dK and dV: a block owns 32 keys and a chunk of C columns; tiles of 64
// queries from the block's first key (causal) or 0
template <int C>
__global__ void __launch_bounds__(f32b::kThreads, 1)
flash_bwd_dkdv_f32_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse2, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int s, int h,
                                int d, int num_bh, int n_chunks, Strides qs, Strides ks,
                                Strides vs, float scale_log2e, float scale, int causal,
                                int aligned) {
  using namespace f32b;
  using B = F32Bwd;
  constexpr int kCRows = 4096 / (C == 384 ? 512 : C);  // query rows a chunk piece
  constexpr int kG = C / 128;  // a lane's float4 columns of the chunk: 4 (lane + 32 m)
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const p_s = ring + kStages * kSlot;
  float* const ds_s = p_s + kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int bh = rest % num_bh;
  const int key0 = rest / num_bh * 32;  // the first key blocks have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const float* qb = q + b * qs.b + hd * qs.h;
  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;
  const int64_t do_rs = static_cast<int64_t>(h) * d;  // dO's row stride
  const float* db = dout + static_cast<int64_t>(b) * s * do_rs + static_cast<int64_t>(hd) * d;
  const float* lb = lse2 + static_cast<int64_t>(bh) * s;
  const float* eb = delta + static_cast<int64_t>(bh) * s;

  // queries before the block's first key see none of its keys
  const int q_begin = causal ? key0 : 0;
  const int n_s = d / kPiece, n_pieces_tile = n_s + 64 / kCRows;
  const int n_pieces = (s - q_begin + 63) / 64 * n_pieces_tile;
  const int col0 = chunk * C;

  auto issue = [&](int g) {
    float* slot = ring + (g % kStages) * kSlot;
    const int q0 = q_begin + g / n_pieces_tile * 64, p = g % n_pieces_tile;
    if (p < n_s) {
      B(slot).load(kb, vb, ks.s, vs.s, key0, qb, db, qs.s, do_rs, q0, s, p * kPiece, aligned);
    } else {
      const int r0 = q0 + (p - n_s) * kCRows;
      f32_copy_rows<kThreads, kCRows, C>(slot, C, qb, qs.s, r0, s, col0, aligned);
      f32_copy_rows<kThreads, kCRows, C>(slot + kCRows * C, C, db, do_rs, r0, s, col0, aligned);
    }
  };
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < n_pieces) issue(g);
    cp_async_commit();
  }

  // a lane's share of dK and dV: the warp's 4 keys by its kG float4 columns
  float acc[4][4], stat[4];
  float dkr[4][kG][4] = {}, dvr[4][kG][4] = {};

  for (int g = 0; g < n_pieces; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // piece g is in; every thread is done with piece g - 1's slot
    if (g + kStages - 1 < n_pieces) issue(g + kStages - 1);
    cp_async_commit();
    float* slot = ring + (g % kStages) * kSlot;
    const int q0 = q_begin + g / n_pieces_tile * 64, p = g % n_pieces_tile;
    if (p < n_s) {
      if (p == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int query = q0 + B::oth_row(lane) + B::kOthG * j;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = 0.0f;
          // padded queries: lse2 = +inf gives P = 0
          stat[j] = warp < 4 ? (query < s ? lb[query] : INFINITY) : (query < s ? eb[query] : 0.0f);
        }
      }
      B(slot).dots(acc, warp, lane);
      if (p == n_s - 1)
        B::softmax_grad<true>(acc, stat, p_s, ds_s, key0, q0, warp, lane, s, causal,
                              scale_log2e);
    } else {
      // dV_c += P^T dO_c, dK_c += dS^T Q_c over the piece's queries, in order
      const int t0 = (p - n_s) * kCRows;
      const float* dc = slot + kCRows * C;
#pragma unroll 2
      for (int i = 0; i < kCRows; ++i) {
        f32_outer<kG>(dvr, p_s + (t0 + i) * kTP + 4 * warp, dc + i * C, lane);
        f32_outer<kG>(dkr, ds_s + (t0 + i) * kTP + 4 * warp, slot + i * C, lane);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = key0 + 4 * warp + r;
    if (key >= s) continue;
    const int64_t row = ((static_cast<int64_t>(b) * s + key) * h + hd) * d + col0;
#pragma unroll
    for (int m = 0; m < kG; ++m) {
      const float* x = dkr[r][m];
      const float* y = dvr[r][m];
      const int64_t off = row + 4 * (lane + 32 * m);
      *reinterpret_cast<float4*>(dk + off) =
          make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
      *reinterpret_cast<float4*>(dv + off) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// dQ: a block owns 32 queries and a chunk of C columns; tiles of 64 keys
// up to the block's last query (causal) or S
template <int C>
__global__ void __launch_bounds__(f32b::kThreads, 1)
flash_bwd_dq_f32_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse2, const float* __restrict__ delta,
                              float* __restrict__ dq, int s, int h, int d, int num_q_tiles,
                              int num_bh, int n_chunks, Strides qs, Strides ks, Strides vs,
                              float scale_log2e, float scale, int causal, int aligned) {
  using namespace f32b;
  using B = F32Bwd;
  constexpr int kCKeys = 8192 / (C == 384 ? 512 : C);  // keys a chunk piece
  constexpr int kG = C / 128;  // a lane's float4 columns of the chunk: 4 (lane + 32 m)
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const p_s = ring + kStages * kSlot;
  float* const ds_s = p_s + kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int bh = rest % num_bh;
  const int q0 = (num_q_tiles - 1 - rest / num_bh) * 32;  // most work first
  const int b = bh / h;
  const int hd = bh - b * h;
  const float* qb = q + b * qs.b + hd * qs.h;
  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;
  const int64_t do_rs = static_cast<int64_t>(h) * d;  // dO's row stride
  const float* db = dout + static_cast<int64_t>(b) * s * do_rs + static_cast<int64_t>(hd) * d;

  // keys past the block's last query are masked for every query of it
  const int kv_end = causal ? min(s, q0 + 32) : s;
  const int n_s = d / kPiece, n_pieces_tile = n_s + 64 / kCKeys;
  const int n_pieces = (kv_end + 63) / 64 * n_pieces_tile;
  const int col0 = chunk * C;

  auto issue = [&](int g) {
    float* slot = ring + (g % kStages) * kSlot;
    const int k0 = g / n_pieces_tile * 64, p = g % n_pieces_tile;
    if (p < n_s)
      B(slot).load(qb, db, qs.s, do_rs, q0, kb, vb, ks.s, vs.s, k0, s, p * kPiece, aligned);
    else
      f32_copy_rows<kThreads, kCKeys, C>(slot, C, kb, ks.s, k0 + (p - n_s) * kCKeys, s, col0,
                                         aligned);
  };
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < n_pieces) issue(g);
    cp_async_commit();
  }

  // the lane's queries' lse2 (warps 0-3) or delta (4-7); padded queries:
  // lse2 = +inf gives P = 0
  float acc[4][4], stat[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int query = q0 + B::own_row(warp, lane) + i;
    const float* src = warp < 4 ? lse2 : delta;
    stat[i] = query < s ? src[static_cast<int64_t>(bh) * s + query] : (warp < 4 ? INFINITY : 0.0f);
  }
  // a lane's share of dQ: the warp's 4 queries by its kG float4 columns
  float dqr[4][kG][4] = {};

  for (int g = 0; g < n_pieces; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // piece g is in; every thread is done with piece g - 1's slot
    if (g + kStages - 1 < n_pieces) issue(g + kStages - 1);
    cp_async_commit();
    float* slot = ring + (g % kStages) * kSlot;
    const int k0 = g / n_pieces_tile * 64, p = g % n_pieces_tile;
    if (p < n_s) {
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      B(slot).dots(acc, warp, lane);
      if (p == n_s - 1)
        B::softmax_grad<false>(acc, stat, p_s, ds_s, q0, k0, warp, lane, s, causal,
                               scale_log2e);
    } else {
      // dQ_c += dS K_c over the piece's keys, in order
      const int t0 = (p - n_s) * kCKeys;
#pragma unroll 4
      for (int j = 0; j < kCKeys; ++j)
        f32_outer<kG>(dqr, ds_s + (t0 + j) * kTP + 4 * warp, slot + j * C, lane);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int query = q0 + 4 * warp + r;
    if (query >= s) continue;
    const int64_t row = ((static_cast<int64_t>(b) * s + query) * h + hd) * d + col0;
#pragma unroll
    for (int m = 0; m < kG; ++m) {
      const float* x = dqr[r][m];
      *reinterpret_cast<float4*>(dq + row + 4 * (lane + 32 * m)) =
          make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
    }
  }
}

// float32 at D = 128 (65-127 padded): one pass over the (query, key) pairs
// on the CUDA cores, register-tiled. Bound by the float32 FMAs: 5 D-long
// products a live pair (S, dP, dV, dK, dQ) at 67 TFLOP/s. The FA2 pair it
// replaced held a whole row and its accumulators in one thread (4 x 128
// floats; 255 registers and 2.2-3.9 KB of spills, each FMA through local
// memory) and computed S and dP twice (7 products a pair). A block of 8
// warps owns 64 keys, their K and V resident in shared memory, and walks
// the query tiles of 64 rows from the last one down (causal: to the tile of
// its first key). Per tile, from Q and dO in shared memory:
//   * S^T (warps 0-3) and dP^T (4-7) [64 keys][64 queries]: a lane holds
//     4 keys (kq + 4 i of its warp's 16) by 8 queries (qg + 8 j), summed by
//     64-column pieces in column order, each float4 read feeding 4 or 8
//     FMA chains; then dP - delta goes to a shared tile [query][key], and
//     the S warps take P = exp2(S scale log2(e) - lse2) (masked 0) and
//     dS = P (dP - delta) into the tiles P and dS;
//   * dV += P^T dO (warps 0-3) and dK += dS^T Q (4-7): a warp's 16 keys by
//     the lane's 4 columns 4 lane + c, 64 registers of one gradient a lane,
//     over the tile's queries in order; the weights one broadcast float4 of
//     4 keys, each dO or Q float4 feeding 16 FMA chains;
//   * dQ_tile = dS K: a lane 8 queries (16 (warp / 2) + 2 r + lane / 16) by
//     4 columns (64 (warp % 2) + 4 (lane % 16) + c) over the block's keys in
//     order, while the next tile's Q and dO come in (one buffer: its copies
//     are issued once dV and dK have read this tile's).
// dQ is summed over key blocks in key-block order in the float32 dq output
// itself: a turn counter per (batch, head, query tile), zeroed by the prep
// pass, says how many key blocks have added; key block 0 stores, each later
// one waits for its turn, adds, and passes the turn on, and the last one
// for the tile writes the sum times the scale. The walk from the last tile
// down brings the key blocks that run together to a tile one add apart, not
// one tile apart (no block waits on a later one: the grid puts key block 0
// of every (batch, head) first). So every gradient element is summed in a
// fixed order, the same bits from run to run. 183 KB of shared memory: one
// block an SM.
namespace f32o {
constexpr int kThreads = 256;
constexpr int kD = 128;
constexpr int kKeys = 64;                 // keys a block
constexpr int kQ = 64;                    // queries a tile
constexpr int kPitch = kD + 4;            // padded rows: the lanes' rows fall in other banks
constexpr int kTP = kKeys + 4;            // pitch of the P and dS tiles [query][key]
constexpr int kRowsF = kKeys * kPitch;    // floats of a [64][128] tile
constexpr int kBytes = 4 * (4 * kRowsF + 2 * kQ * kTP);  // K, V, Q, dO; P, dS
static_assert(kKeys == kQ, "a key block a query tile: the turn counters' tiles");
static_assert(kBytes <= 227 * 1024, "past the shared memory a block may take");
}  // namespace f32o

__global__ void __launch_bounds__(f32o::kThreads, 1)
flash_bwd_f32_onepass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse2, const float* __restrict__ delta,
                             float* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, int* __restrict__ turns, int s, int h,
                             int num_bh, int m_tiles, Strides qs, Strides ks, Strides vs,
                             float scale_log2e, float scale, int causal, int aligned) {
  using namespace f32o;
  extern __shared__ float4 smem4[];
  float* const k_s = reinterpret_cast<float*>(smem4);
  float* const v_s = k_s + kRowsF;
  float* const q_s = v_s + kRowsF;
  float* const do_s = q_s + kRowsF;
  float* const p_s = do_s + kRowsF;
  float* const ds_s = p_s + kQ * kTP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int bh = blockIdx.x % num_bh;
  const int nb = blockIdx.x / num_bh;  // key block; the first have most work
  const int b = bh / h;
  const int hd = bh - b * h;
  const int key0 = nb * kKeys;
  const float* qb = q + b * qs.b + hd * qs.h;
  const float* kb = k + b * ks.b + hd * ks.h;
  const float* vb = v + b * vs.b + hd * vs.h;
  const int64_t do_rs = static_cast<int64_t>(h) * kD;  // dO's (and dq's) row stride
  const float* db = dout + static_cast<int64_t>(b) * s * do_rs + static_cast<int64_t>(hd) * kD;
  float* const dqb = dq + static_cast<int64_t>(b) * s * do_rs + static_cast<int64_t>(hd) * kD;
  const float* lb = lse2 + static_cast<int64_t>(bh) * s;
  const float* eb = delta + static_cast<int64_t>(bh) * s;
  // queries before the block's first key see none of its keys
  const int t_first = causal ? nb : 0;

  auto load_tile = [&](int t) {
    f32_copy_rows<kThreads, kQ, kD>(q_s, kPitch, qb, qs.s, t * kQ, s, 0, aligned);
    f32_copy_rows<kThreads, kQ, kD>(do_s, kPitch, db, do_rs, t * kQ, s, 0, aligned);
  };
  f32_copy_rows<kThreads, kKeys, kD>(k_s, kPitch, kb, ks.s, key0, s, 0, aligned);
  f32_copy_rows<kThreads, kKeys, kD>(v_s, kPitch, vb, vs.s, key0, s, 0, aligned);
  load_tile(m_tiles - 1);
  cp_async_commit();

  // S and dP: warp % 4's 16 keys, the lane's keys ka + 4 i and queries qg + 8 j
  const bool sw = warp < 4;  // S, P and dV; else dP, dS and dK
  const int wk = warp % 4;
  const int kq = lane / 8, qg = lane % 8;
  const int ka = 16 * wk + kq;
  // dQ: the lane's queries qd + 2 r, columns cd + c
  const int qd = 16 * (warp / 2) + lane / 16, cd = 64 * (warp % 2) + 4 * (lane % 16);
  // the warp's gradient (dV or dK): keys 16 wk + kk by columns 4 lane + c
  float g[16][4] = {};

  for (int t = m_tiles - 1; t >= t_first; --t) {
    const int q0 = t * kQ;
    // the lane's queries' lse2 (S warps) or delta (dP warps); padded
    // queries: lse2 = +inf gives P = 0
    float stat[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int query = q0 + qg + 8 * j;
      stat[j] = sw ? (query < s ? lb[query] : INFINITY) : (query < s ? eb[query] : 0.0f);
    }
    cp_async_wait<0>();
    __syncthreads();  // the tile (and at the first one K and V) is in

    float acc[4][8] = {};
    {
      const float* a = (sw ? k_s : v_s) + ka * kPitch;
      const float* x = (sw ? q_s : do_s) + qg * kPitch;
      f32_dots<4, 8, 64>(acc, a, 4 * kPitch, x, 8 * kPitch);
      f32_dots<4, 8, 64>(acc, a + 64, 4 * kPitch, x + 64, 8 * kPitch);
    }
    if (!sw) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) ds_s[(qg + 8 * j) * kTP + ka + 4 * i] = acc[i][j] - stat[j];
    }
    __syncthreads();
    if (sw) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = key0 + ka + 4 * i, query = q0 + qg + 8 * j;
          const bool live = key < s && query < s && (!causal || key <= query);
          const float pv = live ? exp2f(fmaf(acc[i][j], scale_log2e, -stat[j])) : 0.0f;
          const int e = (qg + 8 * j) * kTP + ka + 4 * i;
          p_s[e] = pv;  // masked: P = 0
          ds_s[e] = pv * ds_s[e];
        }
    }
    __syncthreads();

    // dV += P^T dO or dK += dS^T Q over the tile's queries, in order
    {
      const float* w = (sw ? p_s : ds_s) + 16 * wk;
      const float* x = (sw ? do_s : q_s) + 4 * lane;
#pragma unroll 2
      for (int i = 0; i < kQ; ++i) {
        const float4 xx = *reinterpret_cast<const float4*>(x + i * kPitch);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 ww = *reinterpret_cast<const float4*>(w + i * kTP + 4 * m);
          const float wr[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float (&a)[4] = g[4 * m + r];
            a[0] = fmaf(wr[r], xx.x, a[0]);
            a[1] = fmaf(wr[r], xx.y, a[1]);
            a[2] = fmaf(wr[r], xx.z, a[2]);
            a[3] = fmaf(wr[r], xx.w, a[3]);
          }
        }
      }
    }
    __syncthreads();  // Q and dO are read: the next tile's copies go in under dQ
    if (t > t_first) load_tile(t - 1);
    cp_async_commit();

    // dQ_tile = dS K over the block's keys, in order
    float dqr[8][4] = {};
#pragma unroll 2
    for (int j0 = 0; j0 < kKeys; j0 += 4) {
      float4 kk[4], dd[8];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        kk[x] = *reinterpret_cast<const float4*>(k_s + (j0 + x) * kPitch + cd);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        dd[r] = *reinterpret_cast<const float4*>(ds_s + (qd + 2 * r) * kTP + j0);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float kx[4] = {kk[x].x, kk[x].y, kk[x].z, kk[x].w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float w = x == 0 ? dd[r].x : x == 1 ? dd[r].y : x == 2 ? dd[r].z : dd[r].w;
#pragma unroll
          for (int c = 0; c < 4; ++c) dqr[r][c] = fmaf(w, kx[c], dqr[r][c]);
        }
      }
    }

    // into dq in key-block order: block 0 stores, a later one adds once
    // the earlier ones have; the tile's last contributor scales
    const int last = causal ? t : m_tiles - 1;
    int* const turn = turns + static_cast<int64_t>(bh) * m_tiles + t;
    if (nb > 0) {
      if (threadIdx.x == 0) {
        const long long c0 = clock64();
        while (load_acquire(turn) != nb)
          if (clock64() - c0 > kWatchdogClocks) __trap();
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int query = q0 + qd + 2 * r;
      if (query >= s) continue;
      float4* const dst = reinterpret_cast<float4*>(dqb + query * do_rs + cd);
      float4 x = make_float4(dqr[r][0], dqr[r][1], dqr[r][2], dqr[r][3]);
      if (nb > 0) {
        const float4 y = __ldcg(dst);
        x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
      }
      if (nb == last) x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      __stcg(dst, x);
    }
    if (nb < last) {
      __syncthreads();  // every thread's part of the tile is written
      if (threadIdx.x == 0) {
        __threadfence();
        add_release(turn, 1);
      }
    }
  }
  cp_async_wait<0>();

  // dV (warps 0-3) or dK times the scale (4-7) of the warp's 16 keys
  float* const out = sw ? dv : dk;
  const float f = sw ? 1.0f : scale;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int key = key0 + 16 * wk + kk;
    if (key >= s) continue;
    *reinterpret_cast<float4*>(out + ((static_cast<int64_t>(b) * s + key) * h + hd) * kD +
                               4 * lane) =
        make_float4(g[kk][0] * f, g[kk][1] * f, g[kk][2] * f, g[kk][3] * f);
  }
}

// ------------------------------------------------ bfloat16 and float16

constexpr int kBM = 64;         // query rows a tile
constexpr int kStages = 2;      // Q / dO ring depth
constexpr int kThreads = 384;   // compute warpgroups 0, 1; loader/writer 2
constexpr int kComputeRegs = 232;
constexpr int kLoaderRegs = 40;

template <typename T, int D>
struct BwdSmem {  // byte offsets from a 1024-byte aligned base
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "D must be 16, 32, 64, 128 or 256");
  // keys a block: two compute warpgroups of 64 up to D = 128; at D = 256
  // both warpgroups take the same 64 keys (bwd_compute_d256)
  static constexpr int kBN = D == 256 ? 64 : 128;
  // per-row values a query tile brings: lse2 and delta, and float16's
  // dQ scale
  static constexpr int kRowArrays = std::is_same_v<T, __half> ? 3 : 2;
  // a tile is kBoxes d-boxes of kBoxCols columns, one after the other
  // (hopper_common.cuh): one box up to D = 64, two at D = 128, four at 256
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
  // dS^T [kBN keys][64 queries] of T, a buffer; two at D = 128, where
  // each warpgroup's dQ product reads both warpgroups' rows, and at D =
  // 256, one a warpgroup (each computes the same dS^T)
  static constexpr int kDSBufs = D >= 128 ? 2 : 1;
  static constexpr int kDSBuf = 2 * 64 * kBN;
  static constexpr int kDS = kDO + kStages * kTileB;
  // dQ [2][kBM * D] float; none at D = 256, where a tile's dQ goes out
  // through the Q and dO tiles of its stage (bwd_compute_d256)
  static constexpr int kDQ = kDS + kDSBufs * kDSBuf;
  // [kStages][lse2, delta (, dq_scale)][kBM]
  static constexpr int kRows = kDQ + (D == 256 ? 0 : 2 * kBM * D * 4);
  static constexpr int kBar = kRows + kStages * kRowArrays * kBM * 4;
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
template <typename T>
__device__ __forceinline__ void bwd_compute_d128(
    const uint32_t base, uint8_t* const sm, const int wg, const int lane, const int m_first,
    const int m_tiles, const int key0, const int b, const int hd, const int s, const int h,
    const float scale_log2e, const float scale, const int causal, const uint32_t bar_full,
    const uint32_t bar_empty, const uint32_t bar_kv, const uint32_t bar_dq_full,
    const uint32_t bar_dq_empty, T* __restrict__ dk, T* __restrict__ dv) {
  using L = BwdSmem<T, 128>;
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
  RowScale p_scale, s_scale;  // float16 only

  mbar_spin(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int m = m_first, it = 0; m < m_tiles; ++m, ++it) {
    mbar_spin(bar_full + 8 * stage, phase);
    const uint32_t q_tile = base + L::kQ + stage * L::kTileB;
    const uint32_t do_tile = base + L::kDO + stage * L::kTileB;
    const uint32_t ds_buf = base + L::kDS + (it & 1) * L::kDSBuf;
    const float* lse_s =
        reinterpret_cast<const float*>(sm + L::kRows) + stage * L::kRowArrays * kBM;
    const float* del_s = lse_s + kBM;
    const float* dqs_s = lse_s + 2 * kBM;  // float16 only

    // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries], K-major
    float sacc[32], pacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t a = smem_desc(L::k_step(k_tile, kk, L::kKVBox), 16, kSbo, 1);
      const uint64_t b = smem_desc(L::k_step(q_tile, kk, L::kTileBox), 16, kSbo, 1);
      Wgmma<64>::ss<0, 0, T>(sacc, a, b, kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t a = smem_desc(L::k_step(v_tile, kk, L::kKVBox), 16, kSbo, 1);
      const uint64_t b = smem_desc(L::k_step(do_tile, kk, L::kTileBox), 16, kSbo, 1);
      Wgmma<64>::ss<0, 0, T>(pacc, a, b, kk);
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
    // P^T and dS^T as A fragments, dS^T rows of this warpgroup's keys to
    // shared memory
    uint32_t pa[4][4], sa[4][4];
    tile_operands<T>(sacc, pacc, dv_acc, dk_acc, p_scale, s_scale, dqs_s, ds_buf,
                     64 * wg + 16 * w4, g, t, pa, sa);
    fence_async_shared();

    // dV += P^T dO, dK += dS^T Q (dO and Q MN-major across both d-boxes),
    // then, once both warpgroups' dS^T rows are in shared memory, this
    // warpgroup's columns of dQ_tile = dS K (dS^T and K MN-major)
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1, T>(dv_acc, pa[kk],
                           smem_desc(do_tile + kk * 16 * L::kRowB, L::kTileBox, kSbo, 1), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1, T>(dk_acc, sa[kk],
                           smem_desc(q_tile + kk * 16 * L::kRowB, L::kTileBox, kSbo, 1), 1);
    named_sync(1, 256);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t a = smem_desc(ds_buf + kk * 16 * 128, 16, 1024, 1);
      const uint64_t b = smem_desc(k_box + kk * 16 * L::kRowB, 16, kSbo, 1);
      Wgmma<64>::ss<1, 1, T>(dq, a, b, kk);
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

  // dK (times scale) and dV of the warpgroup's 64 keys
  store_dkdv<T, 128>(dk, dv, dk_acc, dv_acc, p_scale, s_scale, kw0 + 16 * w4 + g, t, b, s, h,
                     hd, scale, 128);
}

// One compute warpgroup's walk over the query tiles at D = 256. Both
// warpgroups take the block's 64 keys; warpgroup wg owns columns 128 wg ..
// 128 wg + 127 of dK, dV and dQ. What differs from D = 128:
// * each warpgroup computes S^T = K Q^T and dP^T = V dO^T whole ([64 keys,
//   64 queries], 16 k16 steps over the four d-boxes): the two compute the
//   same values (P^T, dS^T and float16's RowScale exponents alike), so
//   nothing of them is exchanged, at the cost of those two products twice
//   (seven products a pair where D <= 128 takes five);
// * dV and dK [64 keys, 128 columns] (64 registers each) against d-boxes
//   2 wg and 2 wg + 1 of dO and Q (MN-major);
// * dQ_tile's columns 128 wg .. = dS K over the block's 64 keys, from the
//   warpgroup's own copy of dS^T and d-boxes 2 wg, 2 wg + 1 of K (64
//   registers), issued once the dV and dK products are done: their A
//   fragments and all three accumulators would not fit in 232 registers;
// * shared memory holds K and V (64 KB), the two-stage Q/dO ring (128 KB)
//   and the dS^T copies (16 KB), and no dQ staging: once both warpgroups
//   are done with a tile (a 256-thread barrier), warpgroup 0 writes its
//   dQ columns over the stage's Q tile and warpgroup 1 over its dO tile
//   (32 KB each), and the writer warp, which bulk-adds both, frees the
//   stage for the loader once they are read.
template <typename T>
__device__ __forceinline__ void bwd_compute_d256(
    const uint32_t base, uint8_t* const sm, const int wg, const int lane, const int m_first,
    const int m_tiles, const int key0, const int b, const int hd, const int s, const int h,
    const float scale_log2e, const float scale, const int causal, const uint32_t bar_full,
    const uint32_t bar_kv, const uint32_t bar_dq_full, T* __restrict__ dk, T* __restrict__ dv) {
  using L = BwdSmem<T, 256>;
  constexpr int kSbo = 8 * L::kRowB;  // 8 rows of a box
  const int wt = threadIdx.x & 127;   // thread of the warpgroup
  const int w4 = wt >> 5;             // warp of the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const uint32_t k_tile = base + L::kK;
  const uint32_t v_tile = base + L::kV;
  const uint32_t ds_tile = base + L::kDS + wg * L::kDSBuf;

  float dv_acc[64], dk_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv_acc[i] = dk_acc[i] = 0.0f;
  RowScale p_scale, s_scale;  // float16 only

  mbar_spin(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int m = m_first; m < m_tiles; ++m) {
    mbar_spin(bar_full + 8 * stage, phase);
    const uint32_t q_tile = base + L::kQ + stage * L::kTileB;
    const uint32_t do_tile = base + L::kDO + stage * L::kTileB;
    const float* lse_s =
        reinterpret_cast<const float*>(sm + L::kRows) + stage * L::kRowArrays * kBM;
    const float* del_s = lse_s + kBM;
    const float* dqs_s = lse_s + 2 * kBM;  // float16 only

    // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries], K-major
    float sacc[32], pacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      Wgmma<64>::ss<0, 0, T>(sacc, smem_desc(L::k_step(k_tile, kk, L::kKVBox), 16, kSbo, 1),
                             smem_desc(L::k_step(q_tile, kk, L::kTileBox), 16, kSbo, 1), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      Wgmma<64>::ss<0, 0, T>(pacc, smem_desc(L::k_step(v_tile, kk, L::kKVBox), 16, kSbo, 1),
                             smem_desc(L::k_step(do_tile, kk, L::kTileBox), 16, kSbo, 1), kk);
    wgmma_commit();

    // P^T = exp2(S^T scale log2e - lse2), masked on the diagonal and past
    // the last key (overlaps the dP^T product)
    wgmma_wait<1>();
    fence_regs(sacc);
    const int q0 = m * kBM;
    const bool edge = (causal && q0 <= key0) || key0 + 64 > s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2_approx(fmaf(sacc[4 * j + r], scale_log2e, -((r & 1) ? l2.y : l2.x)));
        if (edge) {
          const int key = key0 + 16 * w4 + g + 8 * (r >> 1);
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
    // P^T and dS^T as A fragments, dS^T to the warpgroup's own buffer
    uint32_t pa[4][4], sa[4][4];
    tile_operands<T>(sacc, pacc, dv_acc, dk_acc, p_scale, s_scale, dqs_s, ds_tile, 16 * w4, g,
                     t, pa, sa);
    fence_async_shared();

    // dV += P^T dO, dK += dS^T Q on the warpgroup's 128 columns (dO and Q
    // MN-major across d-boxes 2 wg and 2 wg + 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1, T>(dv_acc, pa[kk],
                           smem_desc(do_tile + 2 * wg * L::kTileBox + kk * 16 * L::kRowB,
                                     L::kTileBox, kSbo, 1),
                           1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1, T>(dk_acc, sa[kk],
                           smem_desc(q_tile + 2 * wg * L::kTileBox + kk * 16 * L::kRowB,
                                     L::kTileBox, kSbo, 1),
                           1);
    wgmma_commit();
    named_sync(2 + wg, 128);  // every warp's dS^T rows are in shared memory
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(sa);

    // the warpgroup's columns of dQ_tile = dS K (dS^T and K MN-major)
    float dq[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::ss<1, 1, T>(dq, smem_desc(ds_tile + kk * 16 * 128, 16, 1024, 1),
                              smem_desc(k_tile + 2 * wg * L::kKVBox + kk * 16 * L::kRowB,
                                        L::kKVBox, kSbo, 1),
                              kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);

    // both warpgroups are done with the stage's Q and dO: warpgroup wg's
    // columns of dQ over its Q (wg 0) or dO (wg 1) tile, float4 (i, wt) at
    // i 128 + wt holding rows 16 w4 + g (+ 8), columns 128 wg + 8 i + 2 t
    // (+ 1): the tile's accumulator is the two halves one after the other
    named_sync(1, 256);
    float4* const dq_buf =
        reinterpret_cast<float4*>(sm + (wg == 0 ? L::kQ : L::kDO) + stage * L::kTileB);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dq_buf[i * 128 + wt] = make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
    fence_async_shared();
    named_sync(2 + wg, 128);
    if (wt == 0) mbar_arrive(bar_dq_full + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dK (times scale) and dV of the block's 64 keys, the warpgroup's columns
  store_dkdv<T, 128>(dk, dv, dk_acc, dv_acc, p_scale, s_scale, key0 + 16 * w4 + g, t, b, s, h,
                     hd, scale, 256, 128 * wg);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse2,      // [bh][m_tiles kBM]
                       const float* __restrict__ delta,     // [bh][m_tiles kBM]
                       const float* __restrict__ dq_scale,  // float16: [bh][m_tiles kBM]
                       float* __restrict__ dq_acc,          // [bh][m_tiles][kBM D]
                       int* __restrict__ turns,             // [bh][m_tiles]
                       T* __restrict__ dk, T* __restrict__ dv, int s, int h, int num_bh,
                       int m_tiles, float scale_log2e, float scale, int causal) {
  using L = BwdSmem<T, D>;
  constexpr bool kHalf = std::is_same_v<T, __half>;
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
  const int key0 = nb * L::kBN;
  const int m_first = causal ? key0 / kBM : 0;  // earlier queries see none of its keys
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      // lane 0 of each compute warp; at D = 256 the writer, once it has read
      // the tile's dQ out of the stage
      mbar_init(bar_empty + 8 * st, D == 256 ? 1 : 8);
    }
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(bar_dq_half + 8 * slot, 1);
      mbar_init(bar_dq_full + 8 * slot, D >= 128 ? 2 : 1);
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
      mbar_expect_tx(bar_kv, 2 * L::kBN * 2 * D);
#pragma unroll
      for (int half = 0; half < L::kBN / kBM; ++half) {
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
        mbar_expect_tx(full, 2 * L::kTileB + L::kRowArrays * kBM * 4);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          const uint32_t off = stage * L::kTileB + box * L::kTileBox;
          tma_load_4d(base + L::kQ + off, &tm_q, full, box * L::kBoxCols, hd, m * kBM, b);
          tma_load_4d(base + L::kDO + off, &tm_do, full, box * L::kBoxCols, hd, m * kBM, b);
        }
        const uint32_t rows = base + L::kRows + stage * L::kRowArrays * kBM * 4;
        bulk_load(rows, lse2 + row_base + m * kBM, kBM * 4, full);
        bulk_load(rows + kBM * 4, delta + row_base + m * kBM, kBM * 4, full);
        if constexpr (kHalf)
          bulk_load(rows + 2 * kBM * 4, dq_scale + row_base + m * kBM, kBM * 4, full);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (warp == 9 && lane == 0) {  // --------------------- dQ writer
      // (slot i & 1 is also the stage of the i-th tile: kStages is 2)
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        float* dst = dq_acc + (static_cast<int64_t>(bh) * m_tiles + m) * kBM * D;
        mbar_wait(bar_dq_full + 8 * (i & 1), (i >> 1) & 1);
        mbar_wait(bar_turn + 8 * (i & 1), (i >> 1) & 1);  // earlier key blocks added
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        // at D = 256 the two halves of the tile lie over its stage's Q and
        // dO tiles, elsewhere the whole tile in dQ buffer i & 1
        constexpr int kParts = D == 256 ? 2 : 1;
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          const uint32_t buf = D == 256 ? base + (part == 0 ? L::kQ : L::kDO) + (i & 1) * L::kTileB
                                        : base + L::kDQ + (i & 1) * kBM * D * 4;
          float* const to = dst + part * (kBM * D / kParts);
          if (nb == 0)  // the first contributor to every query tile
            bulk_store(to, buf, kBM * D * 4 / kParts);
          else
            bulk_reduce_add(to, buf, kBM * D * 4 / kParts);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        // the buffer may be written again (at D = 256: the stage loaded again)
        mbar_arrive((D == 256 ? bar_empty : bar_dq_empty) + 8 * (i & 1));
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
    bwd_compute_d128<T>(base, sm, wg, lane, m_first, m_tiles, key0, b, hd, s, h, scale_log2e,
                        scale, causal, bar_full, bar_empty, bar_kv, bar_dq_full, bar_dq_empty,
                        dk, dv);
  } else if constexpr (D == 256) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kComputeRegs));
    bwd_compute_d256<T>(base, sm, wg, lane, m_first, m_tiles, key0, b, hd, s, h, scale_log2e,
                        scale, causal, bar_full, bar_kv, bar_dq_full, dk, dv);
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
    RowScale p_scale, s_scale;  // float16 only

    mbar_wait(bar_kv, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int m = m_first, it = 0; m < m_tiles; ++m, ++it) {
      mbar_wait(bar_full + 8 * stage, phase);
      const uint32_t q_tile = base + L::kQ + stage * L::kTileB;
      const uint32_t do_tile = base + L::kDO + stage * L::kTileB;
      const float* lse_s =
          reinterpret_cast<const float*>(sm + L::kRows) + stage * L::kRowArrays * kBM;
      const float* del_s = lse_s + kBM;
      const float* dqs_s = lse_s + 2 * kBM;  // float16 only

      // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries], K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss<0, 0, T>(sacc, smem_desc(k_tile + 32 * kk, 16, kSbo, L::kSwizzle),
                               smem_desc(q_tile + 32 * kk, 16, kSbo, L::kSwizzle), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss<0, 0, T>(pacc, smem_desc(v_tile + 32 * kk, 16, kSbo, L::kSwizzle),
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
      // P^T and dS^T as A fragments, dS^T to shared memory
      uint32_t pa[4][4], sa[4][4];
      tile_operands<T>(sacc, pacc, dv_acc, dk_acc, p_scale, s_scale, dqs_s, ds_tile, 16 * w4,
                       g, t, pa, sa);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major: the same tiles read
      // transposed), then, once every warp's dS^T is in shared memory,
      // dQ_tile = dS K (dS^T and K MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::template rs<1, T>(dv_acc, pa[kk],
                                    smem_desc(do_tile + kk * 16 * kRowB, 16, kSbo, L::kSwizzle), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::template rs<1, T>(dk_acc, sa[kk],
                                    smem_desc(q_tile + kk * 16 * kRowB, 16, kSbo, L::kSwizzle), 1);
      named_sync(1 + wg, 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<D>::template ss<1, 1, T>(dq, smem_desc(ds_tile + kk * 16 * 128, 16, 1024, 1),
                                       smem_desc(k_tile + kk * 16 * kRowB, 16, kSbo, L::kSwizzle),
                                       kk);
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

    // dK (times scale) and dV of the warpgroup's 64 keys
    store_dkdv<T, D>(dk, dv, dk_acc, dv_acc, p_scale, s_scale, kw0 + 16 * w4 + g, t, b, s, h,
                     hd, scale, D);
  }
}

// ------------------------- bfloat16 and float16 at D > 256: column chunks

// The wide kernel (flash_bwd_wide_kernel<T>): the one-pass backward past
// D = 256, where K and V of a block's keys (256 D bytes for 64 keys: 128
// KB at D = 512) and a Q/dO ring no longer fit in shared memory and dK and
// dV over the whole D no longer fit in registers. bwd_compute_d256's split
// of the columns is carried into a grid axis: a block owns (batch, head,
// 128 keys, one chunk of kDC = 128 columns of dK, dV and dQ), warpgroup wg
// keys kw0 = key0 + 64 wg .. kw0 + 63, as bwd_compute_d128 splits them.
// Per 64-row query tile each warpgroup
// * reduces S^T = K Q^T and dP^T = V dO^T over the whole D: the loader
//   streams, for each 64-column d-box e in column order, a stage (Q_e, K_e)
//   and a stage (dO_e, V_e) of the block's 128 keys through ring A (4
//   stages of 24 KB), and the warpgroup issues each stage's 4 k16 steps
//   (its own 64 keys' rows of K_e or V_e) as it lands, freeing the box
//   before once its products are done (so K and V, re-read from L2 each
//   query tile, never stay whole in shared memory);
// * takes P^T, dS^T and float16's scales as at every D (tile_operands;
//   each row's lse2, delta and dq_scale come with the tile's chunk in ring
//   B), since S^T and dP^T are the whole sums, so every chunk computes the
//   same P^T, dS^T and RowScale exponents;
// * dV_c += P^T dO_c and dK_c += dS^T Q_c ([64 keys, 128], 64 registers
//   each) against the chunk's Q_c and dO_c (two d-boxes each, ring B:
//   two stages of 32 KB);
// * dQ_c = dS K_c split by columns as at D = 128: warpgroup wg takes 64 of
//   the chunk's columns over the block's 128 keys from both warpgroups'
//   dS^T rows (a 256-thread barrier) and d-box wg of K_c, which stays in
//   shared memory (32 KB); once both warpgroups are done with the stage, a
//   tile's dQ_c goes out over the stage's Q_c (warpgroup 0) and dO_c (1)
//   tiles as at D = 256, and the writer bulk-adds it into the float32
//   accumulator in key-block order, with a turn counter per (batch, head,
//   query tile, chunk), then frees the stage.
// So the registers are bwd_compute_d128's and shared memory 210 KB at any
// D; the products a pair are 2 D / kDC times S^T's and dP^T's and once the
// three others', (2 D / 128 + 3) / 5 times the one-pass products (1.8 at
// D = 384, 2.2 at 512, 3.8 at 1024). A gradient is bitwise the same from
// run to run, as at every D: each sum in one fixed order.
struct WideBwdSmem {  // byte offsets from a 1024-byte aligned base
  static constexpr int kBN = 128;                  // keys a block
  static constexpr int kDC = 128;                  // columns a chunk
  static constexpr int kRowB = 128;                // a d-box row: 64 elements
  static constexpr int kQBox = kBM * kRowB;        // 64 query rows of a d-box: 8 KB
  static constexpr int kKBox = kBN * kRowB;        // the block's keys of a d-box: 16 KB
  static constexpr int kAStages = 4;               // ring A: (Q_e, K_e) or (dO_e, V_e)
  static constexpr int kAStage = kQBox + kKBox;
  static constexpr int kCTile = 2 * kQBox;         // Q_c or dO_c: the chunk's two d-boxes
  static constexpr int kKC = 0;                    // K_c [2][kBN][64]
  static constexpr int kA = kKC + 2 * kKBox;       // ring A [kAStages][query box][key box]
  static constexpr int kB = kA + kAStages * kAStage;  // ring B [kStages][Q_c, dO_c]
  static constexpr int kDS = kB + kStages * 2 * kCTile;  // dS^T [kBN keys][64 queries] of T
  static constexpr int kRows = kDS + kBN * kBM * 2;  // [kStages][lse2, delta, dq_scale][kBM]
  // mbarriers: a full, a empty [kAStages]; b full, b empty [kStages]; kv;
  // dq_full, turn, done, passed [2] each
  static constexpr int kBar = kRows + kStages * 3 * kBM * 4;
  static constexpr int kBytes = kBar + (2 * kAStages + 2 * kStages + 1 + 8) * 8;
  static_assert(kBytes + 1024 <= 232448, "past the 227 KB a block may take");
};

// One compute warpgroup's walk over the query tiles in the wide kernel
// (the note above)
template <typename T>
__device__ __forceinline__ void bwd_compute_wide(
    const uint32_t base, uint8_t* const sm, const int wg, const int lane, const int m_first,
    const int m_tiles, const int key0, const int chunk, const int n_boxes, const int b,
    const int hd, const int s, const int h, const int d, const float scale_log2e,
    const float scale, const int causal, const uint32_t a_full, const uint32_t a_empty,
    const uint32_t b_full, const uint32_t bar_kv, const uint32_t bar_dq_full,
    T* __restrict__ dk, T* __restrict__ dv) {
  using L = WideBwdSmem;
  constexpr int kSbo = 8 * L::kRowB;  // 8 rows of a box
  const int wt = threadIdx.x & 127;   // thread of the warpgroup
  const int w4 = wt >> 5;             // warp of the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = key0 + 64 * wg;     // the warpgroup's first key
  const uint32_t ds_tile = base + L::kDS;
  const uint32_t k_box = base + L::kKC + wg * L::kKBox;  // all keys, d-box wg of K_c

  float dv_acc[64], dk_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv_acc[i] = dk_acc[i] = 0.0f;
  RowScale p_scale, s_scale;  // float16 only

  auto release = [&](int a) {  // this warp has read ring A's stage of item a
    __syncwarp();
    if (lane == 0) mbar_arrive(a_empty + 8 * (a % L::kAStages));
  };
  mbar_spin(bar_kv, 0);
  int stage = 0, a = 0;
  uint32_t phase = 0;
  for (int m = m_first; m < m_tiles; ++m) {
    // S^T = K Q^T and dP^T = V dO^T over the d-boxes in order: [64 keys, 64
    // queries], K-major; each box's stages freed once the next box's
    // products are issued and its own are done
    float sacc[32], pacc[32];
    // box e's two stages: S^T's (Q_e, K_e), then dP^T's (dO_e, V_e); the
    // first box's products start the sums (kFirst: a constant flag, so no
    // accumulator is read before it is written)
    auto issue_box = [&](auto first) {
#pragma unroll
      for (int which = 0; which < 2; ++which, ++a) {
        const int st = a % L::kAStages;
        const uint32_t x = base + L::kA + st * L::kAStage;  // Q_e or dO_e
        const uint32_t y = x + L::kQBox + wg * kBM * L::kRowB;  // the warpgroup's rows of K_e or V_e
        mbar_spin(a_full + 8 * st, (a / L::kAStages) & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = smem_desc(y + 32 * kk, 16, kSbo, 1);
          const uint64_t db = smem_desc(x + 32 * kk, 16, kSbo, 1);
          const int acc = decltype(first)::value ? kk : 1;
          if (which == 0)
            Wgmma<64>::ss<0, 0, T>(sacc, da, db, acc);
          else
            Wgmma<64>::ss<0, 0, T>(pacc, da, db, acc);
        }
        wgmma_commit();
      }
    };
    wgmma_fence();
    issue_box(std::true_type{});
    for (int e = 1; e < n_boxes; ++e) {
      issue_box(std::false_type{});
      wgmma_wait<2>();
      release(a - 4);
      release(a - 3);
    }
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);
    release(a - 2);
    release(a - 1);

    mbar_spin(b_full + 8 * stage, phase);
    const uint32_t q_tile = base + L::kB + stage * 2 * L::kCTile;
    const uint32_t do_tile = q_tile + L::kCTile;
    const float* lse_s = reinterpret_cast<const float*>(sm + L::kRows) + stage * 3 * kBM;
    const float* del_s = lse_s + kBM;
    const float* dqs_s = lse_s + 2 * kBM;  // float16 only

    // P^T = exp2(S^T scale log2e - lse2), masked on the diagonal and past
    // the last key
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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pacc[4 * j + r] = sacc[4 * j + r] * (pacc[4 * j + r] - ((r & 1) ? dl.y : dl.x));
    }
    // P^T and dS^T as A fragments, dS^T rows of this warpgroup's keys to
    // shared memory
    uint32_t pa[4][4], sa[4][4];
    tile_operands<T>(sacc, pacc, dv_acc, dk_acc, p_scale, s_scale, dqs_s, ds_tile,
                     64 * wg + 16 * w4, g, t, pa, sa);
    fence_async_shared();

    // dV_c += P^T dO_c, dK_c += dS^T Q_c (dO_c and Q_c MN-major across their
    // two d-boxes), then, once both warpgroups' dS^T rows are in shared
    // memory, this warpgroup's columns of dQ_c = dS K_c
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1, T>(dv_acc, pa[kk],
                           smem_desc(do_tile + kk * 16 * L::kRowB, L::kQBox, kSbo, 1), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<128>::rs<1, T>(dk_acc, sa[kk],
                           smem_desc(q_tile + kk * 16 * L::kRowB, L::kQBox, kSbo, 1), 1);
    named_sync(1, 256);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      Wgmma<64>::ss<1, 1, T>(dq, smem_desc(ds_tile + kk * 16 * 128, 16, 1024, 1),
                             smem_desc(k_box + kk * 16 * L::kRowB, 16, kSbo, 1), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);
    fence_regs(pa);
    fence_regs(sa);

    // both warpgroups are done with the stage's Q_c, dO_c and with dS^T:
    // warpgroup wg's columns of dQ_c over its Q_c (wg 0) or dO_c (wg 1)
    // tile, float4 (i, wt) at i 128 + wt holding rows 16 w4 + g (+ 8),
    // columns 128 chunk + 64 wg + 8 i + 2 t (+ 1)
    named_sync(4, 256);
    float4* const dq_buf = reinterpret_cast<float4*>(sm + L::kB + stage * 2 * L::kCTile +
                                                     wg * L::kCTile);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dq_buf[i * 128 + wt] = make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
    fence_async_shared();
    named_sync(2 + wg, 128);
    if (wt == 0) mbar_arrive(bar_dq_full + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dK (times scale) and dV of the warpgroup's 64 keys, the chunk's columns
  store_dkdv<T, 128>(dk, dv, dk_acc, dv_acc, p_scale, s_scale, kw0 + 16 * w4 + g, t, b, s, h,
                     hd, scale, d, chunk * L::kDC);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse2,      // [bh][m_tiles kBM]
                      const float* __restrict__ delta,     // [bh][m_tiles kBM]
                      const float* __restrict__ dq_scale,  // float16: [bh][m_tiles kBM]
                      float* __restrict__ dq_acc,          // [bh][m_tiles][kBM d]
                      int* __restrict__ turns,             // [bh][m_tiles][n_chunks]
                      T* __restrict__ dk, T* __restrict__ dv, int s, int h, int d, int num_bh,
                      int n_chunks, int m_tiles, float scale_log2e, float scale, int causal) {
  using L = WideBwdSmem;
  constexpr bool kHalf = std::is_same_v<T, __half>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t a_full = base + L::kBar;
  const uint32_t a_empty = a_full + 8 * L::kAStages;
  const uint32_t b_full = a_empty + 8 * L::kAStages;
  const uint32_t b_empty = b_full + 8 * kStages;
  const uint32_t bar_kv = b_empty + 8 * kStages;
  // [2] each, slot i & 1 (the ring B stage) for the i-th query tile
  const uint32_t bar_dq_full = bar_kv + 8;        // warpgroups -> writer
  const uint32_t bar_turn = bar_dq_full + 16;     // watcher -> writer
  const uint32_t bar_done = bar_turn + 16;        // writer -> passer
  const uint32_t bar_passed = bar_done + 16;      // passer -> watcher

  // key block outermost, so earlier key blocks are dispatched first
  const int per_block = n_chunks * num_bh;
  const int nb = blockIdx.x / per_block;
  const int chunk = (blockIdx.x % per_block) / num_bh;
  const int bh = blockIdx.x % num_bh;
  const int b = bh / h;
  const int hd = bh - b * h;
  const int key0 = nb * L::kBN;
  const int m_first = causal ? key0 / kBM : 0;  // earlier queries see none of its keys
  const int n_boxes = d / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < L::kAStages; ++st) {
      mbar_init(a_full + 8 * st, 1);
      mbar_init(a_empty + 8 * st, 8);  // lane 0 of each compute warp
    }
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(b_full + 8 * st, 1);
      mbar_init(b_empty + 8 * st, 1);  // the writer, once it has read dQ_c out
    }
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(bar_dq_full + 8 * slot, 2);
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
      mbar_expect_tx(bar_kv, 2 * L::kKBox);
#pragma unroll
      for (int box = 0; box < 2; ++box)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load_4d(base + L::kKC + box * L::kKBox + half * kBM * L::kRowB, &tm_k, bar_kv,
                      chunk * L::kDC + 64 * box, hd, key0 + half * kBM, b);
      const int64_t row_base = static_cast<int64_t>(bh) * m_tiles * kBM;
      const uint32_t row_bytes = (kHalf ? 3 : 2) * kBM * 4;
      int stage = 0, a = 0;
      uint32_t phase = 0;
      for (int m = m_first; m < m_tiles; ++m) {
        for (int e = 0; e < n_boxes; ++e) {
#pragma unroll
          for (int which = 0; which < 2; ++which, ++a) {
            const int st = a % L::kAStages;
            const uint32_t full = a_full + 8 * st;
            const uint32_t x = base + L::kA + st * L::kAStage;
            mbar_wait(a_empty + 8 * st, ((a / L::kAStages) & 1) ^ 1);
            mbar_expect_tx(full, L::kAStage);
            tma_load_4d(x, which == 0 ? &tm_q : &tm_do, full, 64 * e, hd, m * kBM, b);
#pragma unroll
            for (int half = 0; half < 2; ++half)
              tma_load_4d(x + L::kQBox + half * kBM * L::kRowB, which == 0 ? &tm_k : &tm_v, full,
                          64 * e, hd, key0 + half * kBM, b);
          }
        }
        mbar_wait(b_empty + 8 * stage, phase ^ 1);
        const uint32_t full = b_full + 8 * stage;
        mbar_expect_tx(full, 2 * L::kCTile + row_bytes);
        const uint32_t c_tile = base + L::kB + stage * 2 * L::kCTile;
#pragma unroll
        for (int box = 0; box < 2; ++box) {
          tma_load_4d(c_tile + box * L::kQBox, &tm_q, full, chunk * L::kDC + 64 * box, hd,
                      m * kBM, b);
          tma_load_4d(c_tile + L::kCTile + box * L::kQBox, &tm_do, full,
                      chunk * L::kDC + 64 * box, hd, m * kBM, b);
        }
        const uint32_t rows = base + L::kRows + stage * 3 * kBM * 4;
        bulk_load(rows, lse2 + row_base + m * kBM, kBM * 4, full);
        bulk_load(rows + kBM * 4, delta + row_base + m * kBM, kBM * 4, full);
        if constexpr (kHalf)
          bulk_load(rows + 2 * kBM * 4, dq_scale + row_base + m * kBM, kBM * 4, full);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (warp == 9 && lane == 0) {  // --------------------- dQ writer
      // (slot i & 1 is also the ring B stage of the i-th tile: kStages is 2)
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        float* dst = dq_acc + (static_cast<int64_t>(bh) * m_tiles + m) * kBM * d +
                     chunk * kBM * L::kDC;
        mbar_wait(bar_dq_full + 8 * (i & 1), (i >> 1) & 1);
        mbar_wait(bar_turn + 8 * (i & 1), (i >> 1) & 1);  // earlier key blocks added
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const uint32_t buf = base + L::kB + (i & 1) * 2 * L::kCTile + part * L::kCTile;
          float* const to = dst + part * (kBM * L::kDC / 2);
          if (nb == 0)  // the first contributor to every query tile
            bulk_store(to, buf, L::kCTile);
          else
            bulk_reduce_add(to, buf, L::kCTile);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(b_empty + 8 * (i & 1));  // the stage may be loaded again
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        mbar_arrive(bar_done + 8 * (i & 1));  // the add is complete
      }
    } else if (warp == 10 && lane == 0) {  // -------------- turn watcher
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        if (i >= 2) mbar_wait(bar_passed + 8 * (i & 1), ((i - 2) >> 1) & 1);
        if (nb > 0) {
          const int* turn = turns + (static_cast<int64_t>(bh) * m_tiles + m) * n_chunks + chunk;
          const long long t0 = clock64();
          while (load_acquire(turn) != nb)
            if (clock64() - t0 > kWatchdogClocks) __trap();
        }
        mbar_arrive(bar_turn + 8 * (i & 1));
      }
    } else if (warp == 11 && lane == 0) {  // ----------- turn passer
      for (int m = m_first, i = 0; m < m_tiles; ++m, ++i) {
        mbar_wait(bar_done + 8 * (i & 1), (i >> 1) & 1);
        add_release(turns + (static_cast<int64_t>(bh) * m_tiles + m) * n_chunks + chunk, 1);
        mbar_arrive(bar_passed + 8 * (i & 1));
      }
    }
  } else {  // ------------------------------------------ compute warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kComputeRegs));
    bwd_compute_wide<T>(base, sm, wg, lane, m_first, m_tiles, key0, chunk, n_boxes, b, hd, s, h,
                        d, scale_log2e, scale, causal, a_full, a_empty, b_full, bar_kv,
                        bar_dq_full, dk, dv);
  }
}

// dq = scale dq_acc in T: one thread a float4 (i, wt) of a tile's
// accumulator, which holds rows 16 w + g and + 8, columns 8 i + 2 t, + 1
// (wt = 32 w + 4 g + t, the compute thread that wrote it); float16 takes
// each row's 2^e_i (dq_scale, [bh][m_tiles kBM]) off first. D = 0 takes the
// head dim d at run time (the wide kernel's)
template <typename T, int D>
__global__ void flash_bwd_dq_kernel(const float4* __restrict__ dq_acc,
                                    const float* __restrict__ dq_scale, T* __restrict__ dq,
                                    int s, int h, int m_tiles, int64_t total, float scale, int d) {
  const int dd = D > 0 ? D : d;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int wt = static_cast<int>(e % 128);
  const int i = static_cast<int>((e / 128) % (dd / 8));
  const int64_t tile = e / (128 * (dd / 8));
  const int m = static_cast<int>(tile % m_tiles);
  const int64_t bh = tile / m_tiles;
  const int64_t b = bh / h, hd = bh % h;
  const int lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int row = m * kBM + 16 * (wt >> 5) + g;
  const int c = 8 * i + 2 * t;
  float4 x = dq_acc[e];
  if constexpr (std::is_same_v<T, __half>) {
    // 1 / 2^e_i, exact: the exponent field of 2^e_i mirrored about 2^0
    const float* rs = dq_scale + bh * m_tiles * kBM;
    const float d0 = __int_as_float(0x7f000000 - __float_as_int(rs[row]));
    const float d1 = __int_as_float(0x7f000000 - __float_as_int(rs[row + 8]));
    x = make_float4(x.x * d0, x.y * d0, x.z * d1, x.w * d1);
  }
  if (row < s)
    *reinterpret_cast<uint32_t*>(dq + ((b * s + row) * h + hd) * dd + c) =
        pack2<T>(x.x * scale, x.y * scale);
  if (row + 8 < s)
    *reinterpret_cast<uint32_t*>(dq + ((b * s + row + 8) * h + hd) * dd + c) =
        pack2<T>(x.z * scale, x.w * scale);
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
  int d;  // the head dim (the template's at D <= 256)
};

// a head dim past 256 that the wide kernels take: any multiple of 128
bool wide(int d) { return d > 256 && d % 128 == 0; }

// the wgmma kernels (flash_bwd_wgmma_kernel up to 256, flash_bwd_wide_kernel
// past it) take both 16-bit types at every head dim; dtype 0 float32, 1
// bfloat16, 2 float16
bool takes_wgmma(int dtype, int d) { return (dtype == 1 || dtype == 2) && (d <= 256 || wide(d)); }

// float32 at this head dim runs the one-pass kernel (launch_f32_onepass),
// which needs the scratch's turn counters
constexpr bool f32_onepass(int d) { return d == 128; }

// scratch layout (bytes): delta and lse2 [num_bh][pitch] float32 each;
// float16 only: dq_scale [num_bh][pitch] float32; the wgmma kernel only:
// the dQ accumulator [num_bh][pitch][D] float32; the wgmma kernel and the
// float32 one-pass kernel (D = 128): the turn counters [num_bh][m_tiles]
// int32 (past D = 256 one a chunk of 128 columns: [num_bh][m_tiles][D /
// 128]); float16 only: v_norms [num_bh][n_parts] float32. pitch is S for
// the float32 kernels and S rounded up to kBM for the wgmma kernels;
// m_tiles is S over kBM, rounded up.
struct Scratch {
  int64_t pitch, m_tiles, n_turns, n_parts, delta, lse2, dq_scale, dq_acc, turns, v_norms,
      bytes;
  Scratch(int64_t num_bh, int64_t s, int64_t d, int dtype) {
    const bool wgmma = takes_wgmma(dtype, static_cast<int>(d)), f16 = dtype == 2;
    const bool onepass = dtype == 0 && f32_onepass(static_cast<int>(d));
    m_tiles = (s + kBM - 1) / kBM;
    pitch = wgmma ? m_tiles * kBM : s;
    n_turns = wgmma ? num_bh * m_tiles * (wide(static_cast<int>(d)) ? d / 128 : 1)
                    : onepass ? num_bh * m_tiles : 0;
    n_parts = f16 ? (s + kVRows - 1) / kVRows : 0;
    const int64_t rows = num_bh * pitch * 4;
    delta = 0;
    lse2 = rows;
    dq_scale = 2 * rows;
    dq_acc = dq_scale + (f16 ? rows : 0);
    turns = dq_acc + (wgmma ? rows * d : 0);
    v_norms = turns + n_turns * 4;
    bytes = v_norms + num_bh * n_parts * 4;
  }
};

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
      reinterpret_cast<float*>(base + sc.dq_scale),
      reinterpret_cast<const float*>(base + sc.v_norms), static_cast<int>(sc.n_parts),
      reinterpret_cast<int*>(base + sc.turns), rows, a.s, a.h, static_cast<int>(sc.pitch),
      pad_rows, sc.n_turns, a.d);
  return cudaGetLastError();
}

// the 16-bit kernels' first launches: float16's norm pass (the largest
// norm of v's rows, a part of each bh), then the prep pass (D = 0: a.d at
// run time)
template <typename T, int D>
cudaError_t launch_prologue(const Args& a, const Scratch& sc) {
  if constexpr (std::is_same_v<T, __half>) {
    const int64_t blocks = sc.n_parts * a.num_bh;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
    flash_bwd_vnorm_kernel<D><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
        static_cast<const __half*>(a.v), a.vs, a.s, a.h, static_cast<int>(sc.n_parts),
        reinterpret_cast<float*>(static_cast<char*>(a.scratch) + sc.v_norms), a.d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_prep<T, D>(a, sc);
}

// the dQ pass: scale (float16: 2^-e_i) and round the float32 accumulator
template <typename T, int D>
cudaError_t launch_dq(const Args& a, const Scratch& sc) {
  const char* base = static_cast<const char*>(a.scratch);
  const int64_t total = static_cast<int64_t>(a.num_bh) * sc.m_tiles * (a.d / 8) * 128;
  if ((total + 255) / 256 > INT32_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, D><<<static_cast<unsigned>((total + 255) / 256), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(base + sc.dq_acc),
      reinterpret_cast<const float*>(base + sc.dq_scale), static_cast<T*>(a.dq), a.s, a.h,
      static_cast<int>(sc.m_tiles), total, a.scale, a.d);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_wgmma(const Args& a) {
  constexpr bool kHalf = std::is_same_v<T, __half>;
  const Scratch sc(a.num_bh, a.s, D, kHalf ? 2 : 1);
  char* base = static_cast<char*>(a.scratch);
  cudaError_t err = launch_prologue<T, D>(a, sc);
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int64_t bsh = static_cast<int64_t>(a.s) * a.h * D;
  const Strides os{bsh, static_cast<int64_t>(a.h) * D, D};
  if (!tensor_map<T>(&tm_q, a.q, a.b, a.s, a.h, D, a.qs, kBM) ||
      !tensor_map<T>(&tm_k, a.k, a.b, a.s, a.h, D, a.ks, kBM) ||
      !tensor_map<T>(&tm_v, a.v, a.b, a.s, a.h, D, a.vs, kBM) ||
      !tensor_map<T>(&tm_do, a.dout, a.b, a.s, a.h, D, os, kBM))
    return cudaErrorInvalidValue;
  constexpr int kBN = BwdSmem<T, D>::kBN;  // keys a block
  const int64_t n_blocks = (static_cast<int64_t>(a.s) + kBN - 1) / kBN;
  if (n_blocks * a.num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = BwdSmem<T, D>::kBytes + 1024;  // + the 1024-byte alignment
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* dq_acc = reinterpret_cast<float*>(base + sc.dq_acc);
  const float* dq_scale = reinterpret_cast<const float*>(base + sc.dq_scale);
  flash_bwd_wgmma_kernel<T, D><<<static_cast<unsigned>(n_blocks * a.num_bh), kThreads, smem,
                                 a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, reinterpret_cast<const float*>(base + sc.lse2),
      reinterpret_cast<const float*>(base + sc.delta), dq_scale, dq_acc,
      reinterpret_cast<int*>(base + sc.turns), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.s, a.h, a.num_bh, static_cast<int>(sc.m_tiles), a.scale * kLog2e, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dq<T, D>(a, sc);
}

// the wide kernel for T (bf16 or fp16) at a head dim a.d past 256, a
// multiple of 128: the norm and prep passes over the whole D, the main
// kernel over (key block, chunk, bh), the dQ pass
template <typename T>
cudaError_t launch_wide(const Args& a) {
  using L = WideBwdSmem;
  constexpr bool kHalf = std::is_same_v<T, __half>;
  const Scratch sc(a.num_bh, a.s, a.d, kHalf ? 2 : 1);
  char* base = static_cast<char*>(a.scratch);
  cudaError_t err = launch_prologue<T, 0>(a, sc);
  if (err != cudaSuccess) return err;

  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int64_t bsh = static_cast<int64_t>(a.s) * a.h * a.d;
  const Strides os{bsh, static_cast<int64_t>(a.h) * a.d, a.d};
  if (!tensor_map<T>(&tm_q, a.q, a.b, a.s, a.h, a.d, a.qs, kBM) ||
      !tensor_map<T>(&tm_k, a.k, a.b, a.s, a.h, a.d, a.ks, kBM) ||
      !tensor_map<T>(&tm_v, a.v, a.b, a.s, a.h, a.d, a.vs, kBM) ||
      !tensor_map<T>(&tm_do, a.dout, a.b, a.s, a.h, a.d, os, kBM))
    return cudaErrorInvalidValue;
  const int n_chunks = a.d / L::kDC;
  const int64_t n_blocks = (static_cast<int64_t>(a.s) + L::kBN - 1) / L::kBN;
  if (n_blocks * a.num_bh * n_chunks > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = L::kBytes + 1024;  // + the 1024-byte alignment
  err = cudaFuncSetAttribute(flash_bwd_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_wide_kernel<T><<<static_cast<unsigned>(n_blocks * a.num_bh * n_chunks), kThreads,
                             smem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, reinterpret_cast<const float*>(base + sc.lse2),
      reinterpret_cast<const float*>(base + sc.delta),
      reinterpret_cast<const float*>(base + sc.dq_scale),
      reinterpret_cast<float*>(base + sc.dq_acc), reinterpret_cast<int*>(base + sc.turns),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.h, a.d, a.num_bh, n_chunks,
      static_cast<int>(sc.m_tiles), a.scale * kLog2e, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dq<T, 0>(a, sc);
}

// float32 at D = 256 and past it: the prep pass over the whole D, then the
// two register-tiled CUDA-core kernels by chunks of C columns
template <int C>
cudaError_t launch_f32_tiled(const Args& a) {
  const Scratch sc(a.num_bh, a.s, a.d, 0);
  cudaError_t err = launch_prep<float, 0>(a, sc);
  if (err != cudaSuccess) return err;
  const char* base = static_cast<const char*>(a.scratch);
  const float* delta = reinterpret_cast<const float*>(base + sc.delta);
  const float* lse2 = reinterpret_cast<const float*>(base + sc.lse2);
  const int64_t row_blocks = (static_cast<int64_t>(a.s) + 31) / 32;  // of keys, of queries
  if (row_blocks * a.num_bh * (a.d / 128) > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t os = static_cast<int64_t>(a.h) * a.d;  // dO, contiguous [B, S, H, D]
  const bool aligned = rows_aligned16(
      {{a.q, a.qs}, {a.k, a.ks}, {a.v, a.vs}, {a.dout, Strides{a.s * os, os, a.d}}});
  const float scale_log2e = a.scale * kLog2e;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_tiled_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, f32b::kBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_f32_tiled_kernel<C><<<static_cast<unsigned>(row_blocks * a.num_bh * (a.d / C)),
                                       f32b::kThreads, f32b::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse2, delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.s, a.h, a.d, a.num_bh, a.d / C,
      a.qs, a.ks, a.vs, scale_log2e, a.scale, a.causal, aligned ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_tiled_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, f32b::kBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_tiled_kernel<C><<<static_cast<unsigned>(row_blocks * a.num_bh * (a.d / C)),
                                      f32b::kThreads, f32b::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse2, delta,
      static_cast<float*>(a.dq), a.s, a.h, a.d, static_cast<int>(row_blocks), a.num_bh,
      a.d / C, a.qs, a.ks, a.vs, scale_log2e, a.scale, a.causal, aligned ? 1 : 0);
  return cudaGetLastError();
}

// float32 at D = 128: the prep pass (delta, lse2, the turn counters
// zeroed), then the one-pass kernel over (key block, bh)
cudaError_t launch_f32_onepass(const Args& a) {
  static_assert(f32o::kQ == kBM, "the one-pass kernel's query tiles are the scratch's");
  const Scratch sc(a.num_bh, a.s, f32o::kD, 0);
  cudaError_t err = launch_prep<float, f32o::kD>(a, sc);
  if (err != cudaSuccess) return err;
  const char* base = static_cast<const char*>(a.scratch);
  if (sc.m_tiles * a.num_bh > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t os = static_cast<int64_t>(a.h) * f32o::kD;  // dO, contiguous [B, S, H, D]
  const bool aligned = rows_aligned16(
      {{a.q, a.qs}, {a.k, a.ks}, {a.v, a.vs}, {a.dout, Strides{a.s * os, os, f32o::kD}}});
  err = cudaFuncSetAttribute(flash_bwd_f32_onepass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, f32o::kBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_f32_onepass_kernel<<<static_cast<unsigned>(sc.m_tiles * a.num_bh), f32o::kThreads,
                                 f32o::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      reinterpret_cast<const float*>(base + sc.lse2),
      reinterpret_cast<const float*>(base + sc.delta), static_cast<float*>(a.dq),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      reinterpret_cast<int*>(static_cast<char*>(a.scratch) + sc.turns), a.s, a.h, a.num_bh,
      static_cast<int>(sc.m_tiles), a.qs, a.ks, a.vs, a.scale * kLog2e, a.scale, a.causal,
      aligned ? 1 : 0);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  const Scratch sc(a.num_bh, a.s, D, 0);
  cudaError_t err = launch_prep<float, D>(a, sc);
  if (err != cudaSuccess) return err;
  const char* base = static_cast<const char*>(a.scratch);
  const float* delta = reinterpret_cast<const float*>(base + sc.delta);
  const float* lse2 = reinterpret_cast<const float*>(base + sc.lse2);
  constexpr int kRows = F32BwdTile<D>::kRows;  // keys or queries a block
  const int64_t num_tiles = (static_cast<int64_t>(a.s) + kRows - 1) / kRows;
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

template <int D>
cudaError_t dispatch_d(int dtype, const Args& a) {
  switch (dtype) {
    case 0:  // at D = 128 the one-pass kernel, at 256 the register-tiled
             // pair (one chunk of 256 columns), below 128 the one-thread-a-row pair
      if constexpr (D == 256)
        return launch_f32_tiled<256>(a);
      else if constexpr (f32_onepass(D))
        return launch_f32_onepass(a);
      else
        return launch_f32<D>(a);
    case 1:  // takes_wgmma(dtype, D) for the 16-bit types
      return launch_wgmma<__nv_bfloat16, D>(a);
    case 2:
      return launch_wgmma<__half, D>(a);
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
    case 256:
      return dispatch_d<256>(dtype, a);
    default:  // past 256: any multiple of 128, in each type
      if (!wide(d)) return cudaErrorInvalidValue;
      switch (dtype) {
        case 0:  // the widest chunks that divide d
          if (a.d % 512 == 0) return launch_f32_tiled<512>(a);
          if (a.d % 384 == 0) return launch_f32_tiled<384>(a);
          if (a.d % 256 == 0) return launch_f32_tiled<256>(a);
          return launch_f32_tiled<128>(a);
        case 1:
          return launch_wide<__nv_bfloat16>(a);
        case 2:
          return launch_wide<__half>(a);
        default:
          return cudaErrorInvalidValue;
      }
  }
}

}  // namespace

// Bytes of scratch that swtpu_flash_attention_bwd needs for these sizes
// (dtype as there); 0 when there is nothing to compute.
extern "C" int64_t swtpu_flash_attention_bwd_scratch_bytes(int b, int s, int h, int d,
                                                           int dtype) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  return Scratch(static_cast<int64_t>(b) * h, s, d, dtype).bytes;
}

// q, k, v: [b, s, h, d] of float32 (dtype 0), bfloat16 (1) or float16 (2)
// with element strides (*_sb, *_ss, *_sh) and unit stride on d; o and
// dout: contiguous [b, s, h, d] of that type (the forward's output and its
// gradient); lse: [b, h, s] float32, the forward's log-sum-exp (natural
// log); dq, dk, dv: contiguous [b, s, h, d] of that type, written whole;
// scratch: swtpu_flash_attention_bwd_scratch_bytes(b, s, h, d, dtype)
// bytes, 16-byte aligned, contents ignored; all on the device of
// ``stream``. d is 16, 32, 64, 128 or 256 or a multiple of 128 past 256;
// the 16-bit types also need every
// base pointer 16-byte aligned and every stride a multiple of 8. sm_scale
// is the forward's scale (any sign). Returns the first cudaGetLastError()
// that is not cudaSuccess after each launch (three; four in float16)
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
         causal, static_cast<cudaStream_t>(stream), d};
  return static_cast<int>(dispatch(d, dtype, a));
}
