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
// (amax_fold; the pass folds its block's first), phase 1 quantizes v with
// the maximum's scale (point2: a
// second launch that recomputes v; the pass: a light kernel over its
// scratch map). The maximum is an atomicMax on the bit pattern of |v|:
// non-negative floats order as their unsigned bit patterns, and a maximum
// does not depend on the order it is taken in, so it is exact.
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

// Folds a thread's maximum of |v| (>= 0) into *amax: a warp's maximum by
// shuffles, then one atomicMax a warp. Every thread of the warp calls it.
__device__ __forceinline__ void amax_fold(float m, unsigned int* amax) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(amax, __float_as_uint(m));
}

}  // namespace rst
