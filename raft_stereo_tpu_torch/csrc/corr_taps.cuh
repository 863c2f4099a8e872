// The correlation lookup's per-pixel tap gather and lerp, shared by the
// standalone lookup (corr_lookup.cu) and the resident iteration
// (resident.cu), as the JAX package shares gather_level_taps between its
// two kernels: one body, so the two routes give the same bits.
//
// Per pixel and level l (raft_stereo_tpu/corr/pallas_reg.py, plain mode):
//   cl = x / 2^l, i0 = floor(cl), frac = cl - i0
//   tap t = row[i0 - r + t] for t in [0, 2r + 1], zero where the position
//           is < 0 or >= the level's true width
//   out[t] = tap[t] * (1 - frac) + tap[t + 1] * frac   (fp32, one downcast)
// The lerp uses explicit round-to-nearest multiplies and adds so no fused
// multiply-add changes its rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rst {

constexpr int kMaxLevels = 8;

template <typename T>
struct Levels {
  const T* row[kMaxLevels];  // [npix][width[l]] per level, unpadded
  int width[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The 2r+1 taps of pixel p at level l, written to o[0 .. 2r].
template <typename T>
__device__ __forceinline__ void gather_level_taps(const Levels<T>& lv, int l, int p, float x,
                                                  int radius, T* o) {
  const int k = 2 * radius + 1;
  const int w = lv.width[l];
  const T* row = lv.row[l] + (size_t)p * w;
  const float cl = x * (1.0f / (float)(1 << l));
  const float i0f = floorf(cl);
  const float frac = cl - i0f;
  const float omf = 1.0f - frac;
  // Positions this far outside the row give all-zero taps either way; the
  // clamp only keeps the integer conversion in range.
  const int i0 = (int)fminf(fmaxf(i0f, (float)(-radius - 2)), (float)(w + radius + 1));
  int pos = i0 - radius;
  float prev = (pos >= 0 && pos < w) ? to_f32(row[pos]) : 0.0f;
  for (int t = 0; t < k; ++t) {
    ++pos;
    const float next = (pos >= 0 && pos < w) ? to_f32(row[pos]) : 0.0f;
    o[t] = from_f32<T>(__fadd_rn(__fmul_rn(prev, omf), __fmul_rn(next, frac)));
    prev = next;
  }
}

}  // namespace rst
