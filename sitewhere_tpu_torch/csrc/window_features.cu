// Per-(device, channel) window features over [M, W, C] float32 telemetry
// windows -> [M, C, 6] float32: mean, population std, min, max, last,
// last - first.
//
// Replaces the TPU kernel sitewhere_tpu/ops/window_features.py:
// _features_kernel (driven by window_features). That kernel transposes the
// windows to [M, C, W] so W lies on the TPU's 128-wide lanes; on the GPU
// that transpose would be one more full copy of the windows, so this kernel
// reads [M, W, C] as it lies.
//
// Bound: bytes. The kernel reads M*W*C*4 bytes once and writes M*C*24; it
// does ~10 float operations per element read, far below the card's FP32
// rate per byte. So the design is about keeping enough bytes in flight:
//   * a thread owns a unit of 4 neighbouring channels and reads them as one
//     16-byte float4 (C % 4 == 0 and a 16-byte aligned pointer, as on the
//     scoring path's C = 100); any other C takes the same kernel with one
//     channel a unit and 4-byte loads;
//   * kSegments = 8 threads split each unit's W timesteps into contiguous
//     segments (16 steps each at W = 128), and each starts kBatch = 8
//     loads before it uses the first, so a thread has 8 independent
//     16-byte loads in flight. A warp is 8 segments x 4 units: at each step
//     the 4 threads of a segment read 4 neighbouring units, one contiguous
//     run of 64 bytes (two runs where a device's channels end);
//   * the variance is Welford's single-pass recurrence in registers, with
//     the division by the count replaced by a multiply with a reciprocal
//     that does not depend on the data (off the dependent chain); the
//     segments' (n, mean, M2, min, max) are merged with Chan's parallel
//     formula through __shfl_xor_sync; first and last come from the
//     segment owners. No shared memory and no second pass over device
//     memory. The TPU kernel computes E[x^2] - mean^2, which cancels
//     catastrophically on windows with a large offset and a small spread;
//     Welford and Chan do not.
//
// min / max propagate NaN like the plain version (torch.amin / amax).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFeatures = 6;
constexpr int kThreads = 256;
constexpr int kSegments = 8;               // threads that split one unit's W
constexpr int kUnitsPerWarp = 32 / kSegments;  // lane = segment * 4 + unit
constexpr int kUnitsPerBlock = kThreads / kSegments;
constexpr int kBatch = 8;                  // loads in flight a thread

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = __ldg(p + j);
  }
}

// NaN, once seen, sticks
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// V channels a unit (4: float4 loads, 1: scalar loads)
template <int V>
__global__ void __launch_bounds__(kThreads)
window_features_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int m, int w, int c) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / kUnitsPerWarp;
  const int units = c / V;  // units a device
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kUnitsPerBlock +
                       (threadIdx.x >> 5) * kUnitsPerWarp + lane % kUnitsPerWarp;
  // no early return: every lane takes part in the shuffles
  const bool live = unit < static_cast<int64_t>(m) * units;
  const int64_t dev = live ? unit / units : 0;
  const int ch = live ? static_cast<int>(unit - dev * units) * V : 0;
  const float* p = x + dev * static_cast<int64_t>(w) * c + ch;
  const int begin = static_cast<int>(static_cast<int64_t>(w) * seg / kSegments);
  const int end = static_cast<int>(static_cast<int64_t>(w) * (seg + 1) / kSegments);

  float mean[V], m2[V], mn[V], mx[V], last[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = m2[j] = last[j] = 0.0f;
    mn[j] = INFINITY;
    mx[j] = -INFINITY;
  }
  for (int t0 = begin; t0 < end; t0 += kBatch) {
    float buf[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (live && t0 + u < end) {
        load<V>(p + static_cast<int64_t>(t0 + u) * c, buf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) buf[u][j] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t0 + u < end) {
        const float r = __frcp_rn(static_cast<float>(t0 + u - begin + 1));
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float val = buf[u][j];
          const float d = val - mean[j];
          mean[j] = fmaf(d, r, mean[j]);
          m2[j] = fmaf(d, val - mean[j], m2[j]);
          mn[j] = nan_min(mn[j], val);
          mx[j] = nan_max(mx[j], val);
          last[j] = val;
        }
      }
    }
  }

  // Chan's merge of the segments: partners seg ^ 1, then ^ 2, then ^ 4
  float n = static_cast<float>(end - begin);
#pragma unroll
  for (int off = kUnitsPerWarp; off < 32; off <<= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float n_ab = n + nb;
    const float wb = nb > 0.0f ? nb / n_ab : 0.0f;  // B's share of the count
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float mean_b = __shfl_xor_sync(0xffffffffu, mean[j], off);
      const float m2_b = __shfl_xor_sync(0xffffffffu, m2[j], off);
      mn[j] = nan_min(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], off));
      mx[j] = nan_max(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
      const float delta = mean_b - mean[j];
      mean[j] = fmaf(delta, wb, mean[j]);
      m2[j] = m2[j] + m2_b + delta * delta * (n * wb);
    }
    n = n_ab;
  }
  // the last segment always holds t = W - 1 (W >= 1)
  const int last_lane = (kSegments - 1) * kUnitsPerWarp + lane % kUnitsPerWarp;
#pragma unroll
  for (int j = 0; j < V; ++j)
    last[j] = __shfl_sync(0xffffffffu, last[j], last_lane);
  if (seg != 0 || !live) return;

  float first[V];  // t = 0, which segment 0 read (or, for W < 8, skipped)
  load<V>(p, first);
  float res[V * kFeatures];
  const float inv_w = 1.0f / static_cast<float>(w);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    res[j * kFeatures + 0] = mean[j];
    res[j * kFeatures + 1] = sqrtf(m2[j] * inv_w);
    res[j * kFeatures + 2] = mn[j];
    res[j * kFeatures + 3] = mx[j];
    res[j * kFeatures + 4] = last[j];
    res[j * kFeatures + 5] = last[j] - first[j];
  }
  float* o = out + (dev * c + ch) * kFeatures;
  if constexpr (V == 4) {  // 96 contiguous bytes, 16-byte aligned
#pragma unroll
    for (int i = 0; i < V * kFeatures / 4; ++i)
      reinterpret_cast<float4*>(o)[i] =
          make_float4(res[4 * i], res[4 * i + 1], res[4 * i + 2], res[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V * kFeatures; ++i) o[i] = res[i];
  }
}

template <int V>
cudaError_t launch(const float* x, float* out, int m, int w, int c,
                   cudaStream_t stream) {
  const int64_t units = static_cast<int64_t>(m) * (c / V);
  const int64_t blocks = (units + kUnitsPerBlock - 1) / kUnitsPerBlock;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  window_features_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(x, out, m, w, c);
  return cudaGetLastError();
}

}  // namespace

// x: float32[m, w, c] contiguous, out: float32[m, c, 6] contiguous, both on
// the device of ``stream``. Takes the float4 path where c % 4 == 0 and both
// pointers are 16-byte aligned, the scalar path otherwise. Returns
// cudaGetLastError() after the launch.
extern "C" int swtpu_window_features(const float* x, float* out, int m, int w,
                                     int c, void* stream) {
  if (static_cast<int64_t>(m) * c == 0 || w == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool wide = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t err = wide ? launch<4>(x, out, m, w, c, st)
                               : launch<1>(x, out, m, w, c, st);
  return static_cast<int>(err);
}
