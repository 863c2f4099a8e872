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
//
// int8 levels (RAFT_CORR_PACK8; pallas_reg.py:gather_lerp_taps_packed8):
// a tap inside the row is q * scale in fp32, scale the (sample, level)
// dequant scale; the mask comes first, so a tap outside the row is an exact
// zero. The lerp and the bf16 downcast are as above.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rst {

constexpr int kMaxLevels = 8;

template <typename T>
struct Levels {
  const T* row[kMaxLevels];  // [npix][width[l]] per level, unpadded
  int width[kMaxLevels];
  // int8 levels only: scale[b * nlev + l] for a pixel p of sample
  // b = p / sample_pixels.
  const float* scale;
  int sample_pixels;
  int nlev;
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A tap inside the row as fp32.
__device__ __forceinline__ float tap_f32(float v, float) { return v; }
__device__ __forceinline__ float tap_f32(__nv_bfloat16 v, float) { return __bfloat162float(v); }
__device__ __forceinline__ float tap_f32(int8_t q, float scale) {
  return __fmul_rn((float)q, scale);
}

template <typename T>
__device__ __forceinline__ float level_scale(const Levels<T>&, int, int) { return 1.0f; }
__device__ __forceinline__ float level_scale(const Levels<int8_t>& lv, int l, int p) {
  return lv.scale[(p / lv.sample_pixels) * lv.nlev + l];
}

// The 2r+1 taps of pixel p at level l, written to o[0 .. 2r] (the levels'
// own type, bf16 for int8 levels).
template <typename T, typename O>
__device__ __forceinline__ void gather_level_taps(const Levels<T>& lv, int l, int p, float x,
                                                  int radius, O* o) {
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
  const float scale = level_scale(lv, l, p);
  const int pos = i0 - radius;
  float prev = (pos >= 0 && pos < w) ? tap_f32(row[pos], scale) : 0.0f;
  // Eight taps' loads in flight at a time, then their lerps in order.
  for (int t0 = 0; t0 < k; t0 += 8) {
    float next[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = pos + 1 + t0 + u;
      next[u] = (t0 + u < k && q >= 0 && q < w) ? tap_f32(row[q], scale) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (t0 + u >= k) break;
      o[t0 + u] = from_f32<O>(__fadd_rn(__fmul_rn(prev, omf), __fmul_rn(next[u], frac)));
      prev = next[u];
    }
  }
}

}  // namespace rst
