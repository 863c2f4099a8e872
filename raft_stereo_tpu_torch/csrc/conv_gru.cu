// ConvGRU step, optionally with the FlowHead chained on the new state.
//
// Replaces raft_stereo_tpu/ops/pallas_stream.py:_gru_kernel (driven by
// _gru_pallas / fused_conv_gru_fwd_impl). The arithmetic and its rounding
// points are the stages of stages.cuh: gates, update, head conv1, head
// conv2. czrq is the context with the gate biases folded in, rounded once
// to bf16 (prepare_gru_context), or under RAFT_LANE_PACK8 its int8 values
// with a scale per sample (replacing _gru_lane8_kernel: the gate stage's
// epilogue is instantiated for int8 czrq, no runtime branch in it). h' and
// f1 are zero outside the image: conv zero padding.
//
// What bounds it on an H100: tensor-core operations. gru08 with the head is
// about 1.62 M MAC per pixel (97 GFLOP at 96x312), against a few MB of
// activations, far above the card's ~295 FLOP/byte balance point.
//
// Design: the TPU kernel streams row blocks through VMEM ring windows on a
// sequential grid so each intermediate row is computed once. Here blocks run
// in parallel, and each stage is one launch of the shared implicit-GEMM
// engine (conv3x3.cuh) over the whole map. The intermediates z, rh (bf16, ch
// channels), aqx (fp32, ch channels) and, with the head, f1 (bf16, 256
// channels) go through device memory between the stages instead of staying
// on chip; keeping them in shared memory with halo recompute is later work.
#include "stages.cuh"

using rst::bf16;

namespace {

template <typename Q>
int launch_gates(const rst::ConvIn& a, const void* czrq, const float* scale, const bf16* h,
                 bf16* z, bf16* rh, float* aqx, int ch, cudaStream_t stream) {
  const rst::GateEpi<Q> epi{static_cast<const Q*>(czrq), scale, a.H * a.W, h, z, rh, aqx, ch};
  return rst::launch_conv3x3<64>(a, epi, stream);
}

}  // namespace

// x parts: up to three NHWC tensors of cx0/cx1/cx2 channels (0 = absent).
// Weight output columns are zero-padded to a multiple of 64 (pad64):
// w_gate: [9][ch + cx][pad64(3ch)]; w_q: [9][ch][pad64(ch)]. With the head
// (f1 != null): w1: [9][ch][pad64(nh)], b1: [nh] fp32, w2: [9][nh][16]
// (column 0 used), dx: [P]. ch, cx0..cx2 and nh are multiples of 32.
// czrq: [P][3ch] bf16, or int8 with lane8 != 0 and scale: [B] fp32.
// Returns the first non-zero cudaError_t of the chain's launches.
extern "C" int rst_conv_gru(const bf16* h, const void* czrq, int lane8, const float* scale,
                            const bf16* x0, int cx0,
                            const bf16* x1, int cx1, const bf16* x2, int cx2, int B, int H,
                            int W, int ch, const bf16* w_gate, const bf16* w_q, bf16* z,
                            bf16* rh, float* aqx, bf16* h_out, const bf16* w1, const float* b1,
                            const bf16* w2, int nh, bf16* f1, float* dx, cudaStream_t stream) {
  const bf16* xs[3] = {x0, x1, x2};
  const int cxs[3] = {cx0, cx1, cx2};
  if (lane8 && scale == nullptr) return (int)cudaErrorInvalidValue;
  const rst::ConvIn gates = rst::gru_gate_in(h, xs, cxs, 3, B, H, W, ch, w_gate);
  int err = lane8 ? launch_gates<int8_t>(gates, czrq, scale, h, z, rh, aqx, ch, stream)
                  : launch_gates<bf16>(gates, czrq, nullptr, h, z, rh, aqx, ch, stream);
  if (err) return err;
  err = rst::launch_conv3x3<64>(rst::gru_update_in(rh, B, H, W, ch, w_q),
                                rst::UpdateEpi{aqx, z, h, h_out, ch}, stream);
  if (err || f1 == nullptr) return err;
  err = rst::launch_conv3x3<64>(rst::head1_in(h_out, B, H, W, ch, w1, nh),
                                rst::ReluBiasEpi{b1, f1, nh}, stream);
  if (err) return err;
  return rst::launch_conv3x3<16>(rst::head2_in(f1, B, H, W, nh, w2), rst::FirstChannelEpi{dx},
                                 stream);
}
