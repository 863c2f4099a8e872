// The quantize-on-exit epilogue of RAFT_LANE_PACK8, shared by the 3x3 pass
// (enc_pass.cu) and the point2 exit (enc_point.cu): a map's bf16-rounded
// exit values become int8 q with one fp32 scale. The point2 exit never
// writes the bf16 map; the pass writes it once, to a scratch map that the
// L2 cache holds at the KITTI widths, since on this card a second conv costs
// more than that map (the TPU kernel wrote none for want of VMEM).
//
// What the TPU kernels compute (ops/pallas_encoder.py:_pass_q8_kernel,
// _point2_q8_kernel), and the host quantization of the port
// (corr/reg_cuda.py:quantize_feature8) on the bf16 map, bit for bit:
//   amax  = max |v| over the map's real pixels and channels (B = 1)
//   scale = max(amax, 1e-30) / 127                       (IEEE fp32 division)
//   q     = clip(round_half_even(v / scale), -127, 127)  (IEEE fp32 division)
// Two phases, as the TPU kernel's: phase 0 folds |v| into one maximum
// (the pass folds its block's first; point2 a block's), phase 1 quantizes v
// with the maximum's scale (the pass: a light kernel over its scratch map;
// point2: the same launch after a grid-wide barrier). The maximum is an
// atomicMax on the bit pattern of |v|: non-negative floats order as their
// unsigned bit patterns, and a maximum does not depend on the order it is
// taken in, so it is exact.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rst {

// The scale from the phase-0 maximum's bit pattern.
__device__ __forceinline__ float quant_scale(unsigned int amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-30f), 127.0f);
}

__device__ __forceinline__ int8_t quant8(float v, float scale) {
  const float t = rintf(__fdiv_rn(v, scale));
  return (int8_t)(int)fminf(fmaxf(t, -127.0f), 127.0f);
}

// quant8(v, scale) with a multiply by rcp = 1 / scale in place of the IEEE
// division where that cannot change the result: for a quotient under 128,
// v * rcp and v / scale, each rounded, differ by at most 3 * 2^-24 * 128 =
// 2.3e-5, so their rounded integers differ only within that of a
// half-integer; within 6.2e-5 of one the exact division decides.
__device__ __forceinline__ int8_t quant8_fast(float v, float scale, float rcp) {
  const float t = __fmul_rn(v, rcp);
  const float frac = fabsf(__fsub_rn(t, truncf(t)));
  if (fabsf(t) < 127.0f && fabsf(__fsub_rn(frac, 0.5f)) > 6.2e-5f) return (int8_t)(int)rintf(t);
  return quant8(v, scale);  // also a NaN, as quant8 clips it
}

}  // namespace rst
