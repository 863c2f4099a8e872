// The bf16 rounding points that several kernels must share bit for bit: a
// value computed in fp32 and rounded once to bf16, and the transform of a
// raw conv output that the fused encoders apply where the next kernel loads
// it (enc_pass.cu builds a conv's input with it, enc_point.cu the exits). One
// copy, so the pass and the exits cannot drift apart.
#pragma once

#include <cuda_bf16.h>

namespace rst {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Instance norm and relu of a raw conv output: (x - mean) * inv in fp32, relu,
// one rounding (normed_f: before it, for callers that round two at a time).
__device__ __forceinline__ float normed_f(float x, float m, float inv) {
  return fmaxf(__fmul_rn(__fsub_rn(x, m), inv), 0.0f);
}
__device__ __forceinline__ float normed(bf16 x, float m, float inv) {
  return bf16r(normed_f(__bfloat162float(x), m, inv));
}

// The transform where frozen BatchNorm is folded into the conv: relu alone.
__device__ __forceinline__ float relu(bf16 x) { return fmaxf(__bfloat162float(x), 0.0f); }

}  // namespace rst
