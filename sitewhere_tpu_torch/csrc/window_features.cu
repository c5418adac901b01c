// Per-(device, channel) window features over [M, W, C] float32 telemetry
// windows -> [M, C, 6] float32: mean, population std, min, max, last,
// last - first.
//
// Replaces the TPU kernel sitewhere_tpu/ops/window_features.py:
// _features_kernel (driven by window_features). That kernel transposes the
// windows to [M, C, W] so W lies on the TPU's 128-wide lanes; on the GPU
// that transpose would be one more full copy of the windows, so this kernel
// reads [M, W, C] as it lies. One thread owns one (m, c) pair and walks the
// W timesteps: at every step the threads of a warp read neighbouring
// channels (and, past the end of a device's C channels, the next device's
// first channels), so each warp load is one or two contiguous runs.
//
// Bound: bytes. The kernel reads M*W*C*4 bytes once and writes M*C*24;
// it does ~10 float operations per element read, far below the card's
// FP32 rate per byte. No shared memory and no second pass over device
// memory: the variance is Welford's single-pass recurrence in registers.
// The TPU kernel computes E[x^2] - mean^2, which cancels catastrophically
// on windows with a large offset and a small spread; Welford does not.
//
// min / max propagate NaN like the plain version (torch.amin / amax).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFeatures = 6;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_features_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int m, int w, int c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = static_cast<int64_t>(m) * c;
  if (i >= total) return;
  const int64_t dev = i / c;
  const int64_t ch = i - dev * c;
  const float* p = x + dev * static_cast<int64_t>(w) * c + ch;

  const float first = __ldg(p);
  float mean = 0.0f, m2 = 0.0f, mn = first, mx = first, last = first;
#pragma unroll 4
  for (int t = 0; t < w; ++t) {
    const float v = __ldg(p + static_cast<int64_t>(t) * c);
    const float d = v - mean;
    mean += d / static_cast<float>(t + 1);
    m2 += d * (v - mean);
    mn = (v < mn || v != v) ? v : mn;   // a NaN, once seen, sticks
    mx = (v > mx || v != v) ? v : mx;
    last = v;
  }
  float* o = out + i * kFeatures;
  o[0] = mean;
  o[1] = sqrtf(m2 / static_cast<float>(w));
  o[2] = mn;
  o[3] = mx;
  o[4] = last;
  o[5] = last - first;
}

}  // namespace

// x: float32[m, w, c] contiguous, out: float32[m, c, 6] contiguous, both on
// the device of ``stream``. Returns cudaGetLastError() after the launch.
extern "C" int swtpu_window_features(const float* x, float* out, int m, int w,
                                     int c, void* stream) {
  const int64_t total = static_cast<int64_t>(m) * c;
  if (total == 0 || w == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  window_features_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, out, m, w,
                                                                c);
  return static_cast<int>(cudaGetLastError());
}
