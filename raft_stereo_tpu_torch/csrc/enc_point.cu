// The pointwise exits of the fused encoders: layer1's double residual exit
// (point3) and a residual block's exit (point2).
//
// Replaces raft_stereo_tpu/ops/pallas_encoder.py:_point3_kernel and
// _point2_kernel. With t the transform of a raw conv output (enc_pass.cu),
// on (H, W, C) bf16 maps:
//   point3, instance norm: o1 = relu(t(s) + t(y2)) kept in fp32,
//                          out = bf16(relu(o1 + t(y4)))
//   point3, folded BN:     o1 = relu(relu(s) + relu(y2)) in bf16,
//                          out = relu(o1 + relu(y4)) in bf16
//   point2, instance norm: out = bf16(relu(x + t(y)))       (the sum in fp32)
//   point2, folded BN:     out = bf16(relu(x + relu(y)))    (the sum in fp32)
// point2's x is the block's input, an activation already, and takes no
// transform. (The same s + y2 sum is rounded to bf16 where enc_pass.cu's
// mid2 builds conv3's input; here it is not, as in the TPU kernels.)
//
// point2 has a quantize-on-exit variant too (RAFT_LANE_PACK8, replacing
// ops/pallas_encoder.py:_point2_q8_kernel): the same exit values, written as
// int8 q and one fp32 scale (quant8.cuh), in two launches: the first takes
// the maximum of |out|, the second recomputes and quantizes.
//
// What bounds it on an H100: bytes. point3 reads three maps and writes one
// (245 MB at 384x1248x64), for a handful of operations a value.
//
// Design: a grid-stride loop of 16-byte vectors (8 channels of one pixel a
// thread and step), the per-channel means and inverse deviations in shared
// memory. Nothing of the TPU kernels' row blocks and width strips remains.
#include <cstdint>
#include <cuda_runtime.h>

#include "quant8.cuh"
#include "rounding.cuh"

namespace rst {

constexpr int kPointThreads = 256;
constexpr int kPointBlocks = 132 * 8;

__device__ __forceinline__ uint4 load16(const bf16* p, size_t vec) {
  return *(reinterpret_cast<const uint4*>(p) + vec);
}

// Copies n per-channel rows of C floats into shared memory.
__device__ __forceinline__ void stage_rows(float* sm, const float* const* rows, int n, int C) {
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) sm[i] = rows[i / C][i % C];
  __syncthreads();
}

template <bool NORM>
__global__ void __launch_bounds__(kPointThreads)
    point3_kernel(const bf16* s, const float* ms, const float* vs, const bf16* y2, const float* m2,
                  const float* v2, const bf16* y4, const float* m4, const float* v4, size_t nvec,
                  int C, bf16* out) {
  extern __shared__ float sm[];  // NORM: [6][C] ms, vs, m2, v2, m4, v4
  if (NORM) {
    const float* rows[6] = {ms, vs, m2, v2, m4, v4};
    stage_rows(sm, rows, 6, C);
  }
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int c0 = (int)((i * 8) % C);
    const uint4 qs = load16(s, i), q2 = load16(y2, i), q4 = load16(y4, i);
    const bf16* xs = reinterpret_cast<const bf16*>(&qs);
    const bf16* x2 = reinterpret_cast<const bf16*>(&q2);
    const bf16* x4 = reinterpret_cast<const bf16*>(&q4);
    uint4 res;
    bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      if (NORM) {
        const float o1 = fmaxf(__fadd_rn(normed(xs[k], sm[c], sm[C + c]),
                                         normed(x2[k], sm[2 * C + c], sm[3 * C + c])),
                               0.0f);
        o[k] = __float2bfloat16(
            fmaxf(__fadd_rn(o1, normed(x4[k], sm[4 * C + c], sm[5 * C + c])), 0.0f));
      } else {
        const float o1 = bf16r(__fadd_rn(relu(xs[k]), relu(x2[k])));
        o[k] = __float2bfloat16(__fadd_rn(o1, relu(x4[k])));
      }
    }
    *(reinterpret_cast<uint4*>(out) + i) = res;
  }
}

// What point2 does with its exit values: write them (kWrite), fold their
// maximum into *amax (kAmax, phase 0) or quantize them (kQuant, phase 1).
enum ExitMode { kWrite, kAmax, kQuant };

template <bool NORM, int MODE>
__global__ void __launch_bounds__(kPointThreads)
    point2_kernel(const bf16* x, const bf16* y, const float* m, const float* v, size_t nvec, int C,
                  bf16* out, int8_t* q, float* scale, unsigned int* amax) {
  extern __shared__ float sm[];  // NORM: [2][C] m, v
  if (NORM) {
    const float* rows[2] = {m, v};
    stage_rows(sm, rows, 2, C);
  }
  float s = 0.0f, mx = 0.0f;
  if (MODE == kQuant) {
    s = quant_scale(*amax);
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  }
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int c0 = (int)((i * 8) % C);
    const uint4 qx = load16(x, i), qy = load16(y, i);
    const bf16* xx = reinterpret_cast<const bf16*>(&qx);
    const bf16* xy = reinterpret_cast<const bf16*>(&qy);
    uint4 res;
    bf16* o = reinterpret_cast<bf16*>(&res);
    uint2 packed;
    int8_t* o8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float t = NORM ? normed(xy[k], sm[c0 + k], sm[C + c0 + k]) : relu(xy[k]);
      o[k] = __float2bfloat16(fmaxf(__fadd_rn(__bfloat162float(xx[k]), t), 0.0f));
      if (MODE == kAmax) mx = fmaxf(mx, fabsf(__bfloat162float(o[k])));
      if (MODE == kQuant) o8[k] = quant8(__bfloat162float(o[k]), s);
    }
    if (MODE == kWrite) *(reinterpret_cast<uint4*>(out) + i) = res;
    if (MODE == kQuant) *(reinterpret_cast<uint2*>(q) + i) = packed;
  }
  if (MODE == kAmax) amax_fold(mx, amax);
}

template <bool NORM>
inline int launch_point2(const bf16* x, const bf16* y, const float* m, const float* v, size_t nvec,
                         int C, bf16* out, int8_t* q, float* scale, unsigned int* amax,
                         int blocks, size_t smem, cudaStream_t stream) {
  if (q == nullptr) {
    point2_kernel<NORM, kWrite><<<blocks, kPointThreads, smem, stream>>>(x, y, m, v, nvec, C, out,
                                                                         q, scale, amax);
    return (int)cudaGetLastError();
  }
  int err = (int)cudaMemsetAsync(amax, 0, sizeof(unsigned int), stream);
  if (err) return err;
  point2_kernel<NORM, kAmax><<<blocks, kPointThreads, smem, stream>>>(x, y, m, v, nvec, C, out, q,
                                                                      scale, amax);
  err = (int)cudaGetLastError();
  if (err) return err;
  point2_kernel<NORM, kQuant><<<blocks, kPointThreads, smem, stream>>>(x, y, m, v, nvec, C, out,
                                                                       q, scale, amax);
  return (int)cudaGetLastError();
}

}  // namespace rst

using rst::bf16;

// kind 3: point3 over a = s, b = y2, c = y4 with (ma, va), (mb, vb),
// (mc, vc); kind 2: point2 over a = x (no transform), b = y with (mb, vb).
// Maps are [npix][C] bf16, C a multiple of 8; means and inverse deviations
// [C] fp32, read only when norm != 0. With q != null (point2 only), the
// quantize-on-exit variant: q: [npix][C] int8 and scale: [1] fp32 in place
// of out, amax: one unsigned scratch word. Returns the first non-zero
// cudaError_t.
extern "C" int rst_enc_point(int kind, int norm, const bf16* a, const float* ma, const float* va,
                             const bf16* b, const float* mb, const float* vb, const bf16* c,
                             const float* mc, const float* vc, int npix, int C, bf16* out,
                             int8_t* q, float* scale, unsigned int* amax, cudaStream_t stream) {
  const size_t nvec = (size_t)npix * C / 8;
  const size_t want = (nvec + rst::kPointThreads - 1) / rst::kPointThreads;
  const int blocks = (int)(want < (size_t)rst::kPointBlocks ? want : rst::kPointBlocks);
  const int nrows = kind == 3 ? 6 : 2;
  const size_t smem = norm ? (size_t)nrows * C * sizeof(float) : 0;
  if (q != nullptr && (kind != 2 || scale == nullptr || amax == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kind == 3 && norm)
    rst::point3_kernel<true><<<blocks, rst::kPointThreads, smem, stream>>>(
        a, ma, va, b, mb, vb, c, mc, vc, nvec, C, out);
  else if (kind == 3)
    rst::point3_kernel<false><<<blocks, rst::kPointThreads, smem, stream>>>(
        a, ma, va, b, mb, vb, c, mc, vc, nvec, C, out);
  else if (norm)
    return rst::launch_point2<true>(a, b, mb, vb, nvec, C, out, q, scale, amax, blocks, smem,
                                    stream);
  else
    return rst::launch_point2<false>(a, b, mb, vb, nvec, C, out, q, scale, amax, blocks, smem,
                                     stream);
  return (int)cudaGetLastError();
}
