// Motion encoder (the reference BasicMotionEncoder) for the refinement loop.
//
// Replaces raft_stereo_tpu/ops/pallas_stream.py:_motion_kernel (driven by
// fused_motion_fwd_impl), with its rounding points:
//   c1    = bf16(relu(corr . wc1 + bc1))                 1x1 over the corr taps
//   f1    = bf16(relu(conv7x7(flow_x, convf1.w[:, :, 0]) + bf1))
//   [c2|f2] = bf16(relu(blockdiag conv3x3([c1|f1]) + [bc2|bf2]))
//   out[..., :126] = bf16(relu(conv3x3([c2|f2], conv.w) + conv.b))
//   out[..., 126:128] = flow
// convf1's flow-y weights are dropped: the model's flow y is identically 0
// (the epipolar projection zeroes every y delta), so callers with a
// caller-supplied flow_init use the plain torch motion encoder instead.
//
// What bounds it on an H100: tensor-core operations, about 224 k MAC per
// pixel (13.4 GFLOP at 96x312) against ~100 bytes of input per pixel.
//
// Design: the TPU kernel builds a 49-tap patches tensor of the flow so the
// 7x7 conv becomes a pointwise dot, and streams rows with ring windows. Here
// stage 1 computes the 1x1 and the 7x7 convs directly with fp32 FMAs, one
// thread per (pixel, channel), and the two 3x3 stages are launches of the
// shared implicit-GEMM engine (conv3x3.cuh): the block-diagonal stage reads
// only its own branch's 64 channels per output tile. The intermediates
// [c1|f1] and [c2|f2] (bf16, 128 channels each) go through device memory.
#include "conv3x3.cuh"

namespace rst {

// One thread per (pixel, stage-1 channel): channels [0, n1) are the 1x1
// conv over the corr taps, [n1, n1 + nf) the 7x7 conv over flow x.
__global__ void motion_stage1_kernel(const bf16* corr, int ccorr, const bf16* flow,
                                     const bf16* wc1, const bf16* wf1, const float* b1,
                                     int n1, int nf, int B, int H, int W, bf16* s1) {
  const int ns = n1 + nf;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * H * W * ns;
  if (idx >= total) return;
  const int p = (int)(idx / ns);
  const int n = (int)(idx % ns);
  float acc = 0.0f;
  if (n < n1) {
    const bf16* c = corr + (size_t)p * ccorr;
    for (int k = 0; k < ccorr; ++k)
      acc = fmaf(__bfloat162float(c[k]), __bfloat162float(wc1[k * n1 + n]), acc);
  } else {
    const int m = n - n1;
    const int x = p % W;
    const int y = (p / W) % H;
    const int img = (p / W) / H;
    for (int dy = 0; dy < 7; ++dy) {
      const int sy = y + dy - 3;
      if (sy < 0 || sy >= H) continue;
      for (int dx = 0; dx < 7; ++dx) {
        const int sx = x + dx - 3;
        if (sx < 0 || sx >= W) continue;
        const float f = __bfloat162float(flow[((size_t)(img * H + sy) * W + sx) * 2]);
        acc = fmaf(f, __bfloat162float(wf1[(dy * 7 + dx) * nf + m]), acc);
      }
    }
  }
  s1[(size_t)p * ns + n] = __float2bfloat16(fmaxf(acc + b1[n], 0.0f));
}

struct FusionEpi {
  const float* bias;
  const bf16* flow;  // [P][2]
  bf16* out;         // [P][cf + 2]
  int cf;
  __device__ void operator()(int p, int n, float acc) const {
    const int cout = cf + 2;
    if (n < cf)
      out[(size_t)p * cout + n] = __float2bfloat16(fmaxf(acc + bias[n], 0.0f));
    else if (n < cout)
      out[(size_t)p * cout + n] = flow[(size_t)p * 2 + n - cf];
  }
};

struct StageReluEpi {
  const float* bias;
  bf16* out;
  int n_out;
  __device__ void operator()(int p, int n, float acc) const {
    if (n < n_out) out[(size_t)p * n_out + n] = __float2bfloat16(fmaxf(acc + bias[n], 0.0f));
  }
};

}  // namespace rst

using rst::bf16;

// corr: [P][ccorr]; flow: [P][2]; wc1: [ccorr][n1]; wf1: [49][nf]; b1: [n1+nf];
// w2: [9][n1+nf][pad64(n1+nf)] block-diagonal; b2: [n1+nf];
// wf: [9][n1+nf][pad64(cf+2)]; bf: [cf]; s1, s2: [P][n1+nf] scratch;
// out: [P][cf+2]. n1 and nf are multiples of 64 (the engine's tile width).
extern "C" int rst_motion(const bf16* corr, int ccorr, const bf16* flow, int B, int H, int W,
                          const bf16* wc1, const bf16* wf1, const float* b1, int n1, int nf,
                          const bf16* w2, const float* b2, const bf16* wf, const float* bf,
                          int cf, bf16* s1, bf16* s2, bf16* out, cudaStream_t stream) {
  const int ns = n1 + nf;
  const long long total = (long long)B * H * W * ns;
  const int threads = 256;
  rst::motion_stage1_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                              stream>>>(corr, ccorr, flow, wc1, wf1, b1, n1, nf, B, H, W, s1);
  int err = (int)cudaGetLastError();
  if (err) return err;

  rst::ConvIn a{};
  a.ptr[0] = s1;
  a.cin[0] = ns;
  a.nparts = 1;
  a.B = B;
  a.H = H;
  a.W = W;
  a.w = w2;
  a.ctot = ns;
  a.npad = rst::pad64(ns);
  a.n_split = n1;
  a.k0a = 0;
  a.k1a = n1;
  a.k0b = n1;
  a.k1b = ns;
  err = rst::launch_conv3x3<64>(a, rst::StageReluEpi{b2, s2, ns}, stream);
  if (err) return err;

  rst::ConvIn b = a;
  b.ptr[0] = s2;
  b.w = wf;
  b.npad = rst::pad64(cf + 2);
  b.n_split = b.npad;
  b.k0a = 0;
  b.k1a = ns;
  return rst::launch_conv3x3<64>(b, rst::FusionEpi{bf, flow, out, cf}, stream);
}
