// Motion encoder (the reference BasicMotionEncoder) for the refinement loop.
//
// Replaces raft_stereo_tpu/ops/pallas_stream.py:_motion_kernel (driven by
// fused_motion_fwd_impl), with its rounding points:
//   c1    = bf16(relu(corr . wc1 + bc1))                 1x1 over the corr taps
//   f1    = bf16(relu(conv7x7(flow_x, convf1.w[:, :, 0]) + bf1))
//   [c2|f2] = bf16(relu(blockdiag conv3x3([c1|f1]) + [bc2|bf2]))
//   out[..., :126] = bf16(relu(conv3x3([c2|f2], conv.w) + conv.b))
//   out[..., 126:128] = flow
// (stage 1: motion_stage1.cuh; stages 2-3: stages.cuh).
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
#include "motion_stage1.cuh"
#include "stages.cuh"

namespace {

__global__ void motion_stage1_kernel(const rst::bf16* corr, rst::MotionStage1 s1fn, int npix,
                                     rst::bf16* s1) {
  const int ns = s1fn.n1 + s1fn.nf;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)npix * ns) return;
  const int p = (int)(idx / ns);
  const int n = (int)(idx % ns);
  s1[(size_t)p * ns + n] = s1fn(corr + (size_t)p * s1fn.ccorr, p, n);
}

}  // namespace

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
  const int npix = B * H * W;
  const long long total = (long long)npix * ns;
  const int threads = 256;
  const rst::MotionStage1 s1fn{flow, wc1, wf1, b1, ccorr, n1, nf, H, W};
  motion_stage1_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      corr, s1fn, npix, s1);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = rst::launch_conv3x3<64>(rst::motion_s2_in(s1, B, H, W, n1, nf, w2),
                                rst::ReluBiasEpi{b2, s2, ns}, stream);
  if (err) return err;
  return rst::launch_conv3x3<64>(rst::motion_fusion_in(s2, B, H, W, ns, cf, wf),
                                 rst::FusionEpi{bf, flow, out, cf}, stream);
}
