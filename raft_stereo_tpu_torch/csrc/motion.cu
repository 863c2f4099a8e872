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
// stage 1 computes the 1x1 and the 7x7 convs directly with fp32 FMAs, a
// block per tile of up to 64 pixels of an image row with its taps, flow
// rows and weights in shared memory, a thread per 4 pixels and 8 channels
// (motion_stage1.cuh), and the two 3x3 stages are launches of the Hopper
// engine (loop_conv_sm90.cuh: TMA halo patches, ldmatrix A, wgmma, the
// epilogue from registers), the stages the resident iteration runs: the
// block-diagonal stage in column tiles of 64,
// each reading only its own branch's 64-channel chunk, the fusion stage in
// one tile of 128 columns over both chunks. The intermediates [c1|f1] and
// [c2|f2] (bf16, 128 channels each) go through device memory.
#include "motion_stage1.cuh"
#include "stages.cuh"

namespace {

// One stage-1 tile a block, up to 64 pixels of one image row: the tile's
// corr taps into shared memory, then the tile routine of motion_stage1.cuh.
__global__ void __launch_bounds__(256) motion_stage1_kernel(const rst::bf16* corr,
                                                            rst::MotionStage1 s1fn,
                                                            rst::bf16* s1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const rst::Stage1Smem s = s1fn.smem(smem);
  s1fn.load_weights(s);
  const int segs = (s1fn.W + rst::kS1Pixels - 1) / rst::kS1Pixels;
  const int row = blockIdx.x / segs, x0 = (blockIdx.x % segs) * rst::kS1Pixels;
  const int count = min(rst::kS1Pixels, s1fn.W - x0);
  const int ntaps = count * s1fn.ccorr;
  const rst::bf16* src = corr + ((size_t)row * s1fn.W + x0) * s1fn.ccorr;
  for (int i = threadIdx.x; i < ntaps; i += blockDim.x) s.taps[i] = src[i];
  s1fn.tile(s, row, x0, count, s1);
}

}  // namespace

using rst::bf16;

// corr: [P][ccorr]; flow: [P][2]; wc1: [ccorr][n1]; wf1: [49][nf]; b1: [n1+nf];
// w2: [9][n1+nf][n1+nf] block-diagonal, K-major (output channel, then input
// channel); b2: [n1+nf]; wf: [9][cf][n1+nf] K-major; bf: [cf]; s1, s2:
// [P][n1+nf] scratch; out: [P][cf+2]. n1 and nf are multiples of 64.
extern "C" int rst_motion(const bf16* corr, int ccorr, const bf16* flow, int B, int H, int W,
                          const bf16* wc1, const bf16* wf1, const float* b1, int n1, int nf,
                          const bf16* w2, const float* b2, const bf16* wf, const float* bf,
                          int cf, bf16* s1, bf16* s2, bf16* out, cudaStream_t stream) {
  if (n1 % 64 || nf % 64 || n1 < 64 || nf < 64) return (int)cudaErrorInvalidValue;
  const int ns = n1 + nf;
  const rst::MotionStage1 s1fn{flow, wc1, wf1, b1, ccorr, n1, nf, H, W};
  const int smem = rst::stage1_smem_bytes(ccorr, n1, nf);
  int err = (int)cudaFuncSetAttribute(motion_stage1_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const int segs = (W + rst::kS1Pixels - 1) / rst::kS1Pixels;
  motion_stage1_kernel<<<B * H * segs, 256, smem, stream>>>(corr, s1fn, s1);
  if ((err = (int)cudaGetLastError())) return err;
  rst::loop::LoopConv c;
  CUtensorMap maps[rst::loop::kMaxMaps];
  int nmaps = 0, n = 0;
  if ((err = rst::motion_s2_loop(c, maps, &nmaps, s1, B, H, W, n1, nf, w2))) return err;
  err = rst::loop::launch_loop_conv<64>(c, maps, nmaps, rst::ReluBiasEpi{b2, s2, ns}, stream);
  if (err) return err;
  nmaps = 0;
  if ((err = rst::motion_fusion_loop(c, maps, &nmaps, s2, B, H, W, ns, cf, wf, &n))) return err;
  const rst::FusionEpi epi{bf, flow, out, cf};
  return rst::loop::launch_loop_conv_n(n, c, maps, nmaps, epi, stream);
}
