// The correlation lookup's per-pixel tap arithmetic, shared by the
// standalone lookup (corr_lookup.cu) and the resident iteration
// (resident.cu), as the JAX package shares gather_level_taps between its
// two kernels: one tap_coord, tap_f32 and lerp_tap, so the two routes give
// the same bits. The two load their taps differently: the lookup a vector
// window a (pixel, level), the resident kernel's stage 1 one scalar a tap
// (gather_level_taps).
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

// Where pixel p's taps sit on level l of width w: the first tap's position
// and the lerp's weights. Positions this far outside the row give all-zero
// taps either way; the clamp only keeps the integer conversion in range.
struct TapCoord {
  int pos;          // position of tap 0: floor(x / 2^l) - r
  float frac, omf;  // frac and 1 - frac
};

__device__ __forceinline__ TapCoord tap_coord(float x, int l, int w, int radius) {
  const float cl = x * (1.0f / (float)(1 << l));
  const float i0f = floorf(cl);
  TapCoord c;
  c.frac = cl - i0f;
  c.omf = 1.0f - c.frac;
  c.pos = (int)fminf(fmaxf(i0f, (float)(-radius - 2)), (float)(w + radius + 1)) - radius;
  return c;
}

// One output tap from its two row taps: the one lerp of every route (the
// standalone lookup, corr_lookup.cu, and gather_level_taps below).
__device__ __forceinline__ float lerp_tap(float prev, float next, const TapCoord& c) {
  return __fadd_rn(__fmul_rn(prev, c.omf), __fmul_rn(next, c.frac));
}

// The 2r+1 taps of pixel p at level l, written to o[0 .. 2r] (the levels'
// own type, bf16 for int8 levels), with one scalar load a tap (the resident
// iteration's stage 1).
template <typename T, typename O>
__device__ __forceinline__ void gather_level_taps(const Levels<T>& lv, int l, int p, float x,
                                                  int radius, O* o) {
  const int k = 2 * radius + 1;
  const int w = lv.width[l];
  const T* row = lv.row[l] + (size_t)p * w;
  const TapCoord c = tap_coord(x, l, w, radius);
  const float scale = level_scale(lv, l, p);
  const int pos = c.pos;
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
      o[t0 + u] = from_f32<O>(lerp_tap(prev, next[u], c));
      prev = next[u];
    }
  }
}

}  // namespace rst
