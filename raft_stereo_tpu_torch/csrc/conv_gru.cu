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
// about 1.62 M MAC per pixel (97 GFLOP at 96x312), gru16 1.33 M and gru32
// 0.88 M at 128 channels, against a few MB of activations, far above the
// card's ~295 FLOP/byte balance point.
//
// Design: the TPU kernel streams row blocks through VMEM ring windows on a
// sequential grid so each intermediate row is computed once. Here blocks run
// in parallel and each stage is one launch over the whole map, on the loop
// engine (loop_conv_sm90.cuh): a block stages each 64-channel chunk of an
// 8 x 16 output patch once as a TMA halo patch and reads it for all 9 taps
// and up to 128 output columns (the gates in column tiles z, r and q, q over
// the x parts only), with wgmma and the epilogue straight from the
// accumulators. The stages are the ones the persistent kernels run: gru08 +
// head is the resident iteration's stages 4-7 (resident.cu), the head-less
// gru32 and gru16 steps are the gru16+32 kernel's (gru1632.cu). The
// intermediates z, rh (bf16, ch channels), aqx (fp32, ch channels) and, with
// the head, f1 (bf16, 256 channels) go through device memory between the
// stages.
#include "stages.cuh"

using rst::bf16;

namespace {

// The gates and the update, then with a head (f1 != null) its two convs.
template <typename Q>
int launch_chain(const bf16* h, const void* czrq, const float* scale, const bf16* const* xs,
                 const int* cxs, int B, int H, int W, int ch, const bf16* w_gate,
                 const bf16* w_q, bf16* z, bf16* rh, float* aqx, bf16* h_out, const bf16* w1,
                 const float* b1, const bf16* w2, int nh, bf16* f1, float* dx,
                 cudaStream_t stream) {
  using rst::loop::launch_loop_conv_n;
  rst::loop::LoopConv c;
  CUtensorMap maps[rst::loop::kMaxMaps];
  int nmaps = 0, n = 0, sms = 0;
  // The head-less steps take the gru16+32 kernel's tile widths, the chain
  // with the head the resident iteration's.
  int err = f1 == nullptr ? rst::loop::sm_count(&sms) : 0;
  if (!err) err = rst::gate_loop(c, maps, &nmaps, h, xs, cxs, 3, B, H, W, ch, w_gate, &n, sms);
  if (err) return err;
  const rst::GateEpi<Q> gate{static_cast<const Q*>(czrq), scale, H * W, h, z, rh, aqx, ch};
  if ((err = launch_loop_conv_n(n, c, maps, nmaps, gate, stream))) return err;
  nmaps = 0;
  if ((err = rst::update_loop(c, maps, &nmaps, rh, B, H, W, ch, w_q, &n, sms))) return err;
  if ((err = launch_loop_conv_n(n, c, maps, nmaps, rst::UpdateEpi{aqx, z, h, h_out, ch},
                                stream)))
    return err;
  if (f1 == nullptr) return 0;
  nmaps = 0;
  if ((err = rst::head1_loop(c, maps, &nmaps, h_out, B, H, W, ch, w1, nh, &n))) return err;
  if ((err = launch_loop_conv_n(n, c, maps, nmaps, rst::ReluBiasEpi{b1, f1, nh}, stream)))
    return err;
  nmaps = 0;
  if ((err = rst::head2_loop(c, maps, &nmaps, f1, B, H, W, nh, w2))) return err;
  return rst::loop::launch_loop_conv<8>(c, maps, nmaps, rst::FirstChannelEpi{dx}, stream);
}

}  // namespace

// x parts: up to three NHWC tensors of cx0/cx1/cx2 channels (0 = absent).
// czrq: [P][3ch] bf16, or int8 with lane8 != 0 and scale: [B] fp32. Every
// matrix K-major (output channel, then input channel): w_gate: [9][3ch][ch +
// cx] over [h; x parts], w_q: [9][ch][ch]; with the head (f1 != null) w1:
// [9][nh][ch], b1: [nh] fp32, w2: [9][1][nh] (conv2's x output), dx: [P]. ch,
// cx0..cx2 and nh are multiples of 32. Returns the first non-zero
// cudaError_t of the chain's launches.
extern "C" int rst_conv_gru(const bf16* h, const void* czrq, int lane8, const float* scale,
                            const bf16* x0, int cx0, const bf16* x1, int cx1, const bf16* x2,
                            int cx2, int B, int H, int W, int ch, const bf16* w_gate,
                            const bf16* w_q, bf16* z, bf16* rh, float* aqx, bf16* h_out,
                            const bf16* w1, const float* b1, const bf16* w2, int nh, bf16* f1,
                            float* dx, cudaStream_t stream) {
  const bf16* xs[3] = {x0, x1, x2};
  const int cxs[3] = {cx0, cx1, cx2};
  if (lane8 && scale == nullptr) return (int)cudaErrorInvalidValue;
  return lane8 ? launch_chain<int8_t>(h, czrq, scale, xs, cxs, B, H, W, ch, w_gate, w_q, z, rh,
                                      aqx, h_out, w1, b1, w2, nh, f1, dx, stream)
               : launch_chain<bf16>(h, czrq, nullptr, xs, cxs, B, H, W, ch, w_gate, w_q, z, rh,
                                    aqx, h_out, w1, b1, w2, nh, f1, dx, stream);
}
