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
// in parallel and each stage is one launch over the whole map. With the head
// (gru08, the serial twin of the resident iteration's stages 4-7) the four
// stages run on the Hopper engine (loop_conv_sm90.cuh): a block stages each
// 64-channel chunk of an 8 x 16 output patch once as a TMA halo patch and
// reads it for all 9 taps and up to 128 output columns (the gates in three
// column tiles: z, r and q, q over the x parts only), with wgmma and the
// epilogue straight from the accumulators. Without the head (gru16, gru32)
// the gates and the update stay on the WMMA engine (conv3x3.cuh), which the
// gru16+32 kernel shares and is pinned against. The intermediates z, rh
// (bf16, ch channels), aqx (fp32, ch channels) and, with the head, f1 (bf16,
// 256 channels) go through device memory between the stages.
#include "stages.cuh"

using rst::bf16;

namespace {

template <typename Q>
int launch_gates(const rst::ConvIn& a, const void* czrq, const float* scale, const bf16* h,
                 bf16* z, bf16* rh, float* aqx, int ch, cudaStream_t stream) {
  const rst::GateEpi<Q> epi{static_cast<const Q*>(czrq), scale, a.H * a.W, h, z, rh, aqx, ch};
  return rst::launch_conv3x3<64>(a, epi, stream);
}

template <class Epi>
int launch_n(int n, const rst::loop::LoopConv& c, const CUtensorMap* maps, int nmaps,
             const Epi& epi, cudaStream_t stream) {
  return n == 128 ? rst::loop::launch_loop_conv<128>(c, maps, nmaps, epi, stream)
                  : rst::loop::launch_loop_conv<64>(c, maps, nmaps, epi, stream);
}

// The gru08 + FlowHead chain on the Hopper engine.
template <typename Q>
int launch_head_chain(const bf16* h, const void* czrq, const float* scale,
                      const bf16* const* xs, const int* cxs, int B, int H, int W, int ch,
                      const bf16* w_gate_k, const bf16* w_q_k, bf16* z, bf16* rh, float* aqx,
                      bf16* h_out, const bf16* w1, const float* b1, const bf16* w2, int nh,
                      bf16* f1, float* dx, cudaStream_t stream) {
  rst::loop::LoopConv c;
  CUtensorMap maps[rst::loop::kMaxMaps];
  int nmaps = 0, n = 0;
  int err = rst::gate_loop(c, maps, &nmaps, h, xs, cxs, 3, B, H, W, ch, w_gate_k, &n);
  if (err) return err;
  const rst::GateEpi<Q> gate{static_cast<const Q*>(czrq), scale, H * W, h, z, rh, aqx, ch};
  if ((err = launch_n(n, c, maps, nmaps, gate, stream))) return err;
  nmaps = 0;
  if ((err = rst::update_loop(c, maps, &nmaps, rh, B, H, W, ch, w_q_k, &n))) return err;
  if ((err = launch_n(n, c, maps, nmaps, rst::UpdateEpi{aqx, z, h, h_out, ch}, stream)))
    return err;
  nmaps = 0;
  if ((err = rst::head1_loop(c, maps, &nmaps, h_out, B, H, W, ch, w1, nh, &n))) return err;
  if ((err = launch_n(n, c, maps, nmaps, rst::ReluBiasEpi{b1, f1, nh}, stream))) return err;
  nmaps = 0;
  if ((err = rst::head2_loop(c, maps, &nmaps, f1, B, H, W, nh, w2))) return err;
  return rst::loop::launch_loop_conv<8>(c, maps, nmaps, rst::FirstChannelEpi{dx}, stream);
}

}  // namespace

// x parts: up to three NHWC tensors of cx0/cx1/cx2 channels (0 = absent).
// czrq: [P][3ch] bf16, or int8 with lane8 != 0 and scale: [B] fp32.
// Without the head (f1 == null), on the WMMA engine: w_gate: [9][ch +
// cx][pad64(3ch)], w_q: [9][ch][pad64(ch)], output columns zero-padded to a
// multiple of 64 (pad64); w_gate_k and w_q_k unused. With the head, on the
// Hopper engine, every matrix K-major (output channel, then input channel):
// w_gate_k: [9][3ch][ch + cx], w_q_k: [9][ch][ch], w1: [9][nh][ch], b1: [nh]
// fp32, w2: [9][1][nh] (conv2's x output), dx: [P]; w_gate and w_q unused.
// ch, cx0..cx2 and nh are multiples of 32. Returns the first non-zero
// cudaError_t of the chain's launches.
extern "C" int rst_conv_gru(const bf16* h, const void* czrq, int lane8, const float* scale,
                            const bf16* x0, int cx0,
                            const bf16* x1, int cx1, const bf16* x2, int cx2, int B, int H,
                            int W, int ch, const bf16* w_gate, const bf16* w_q,
                            const bf16* w_gate_k, const bf16* w_q_k, bf16* z,
                            bf16* rh, float* aqx, bf16* h_out, const bf16* w1, const float* b1,
                            const bf16* w2, int nh, bf16* f1, float* dx, cudaStream_t stream) {
  const bf16* xs[3] = {x0, x1, x2};
  const int cxs[3] = {cx0, cx1, cx2};
  if (lane8 && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (f1 != nullptr)
    return lane8 ? launch_head_chain<int8_t>(h, czrq, scale, xs, cxs, B, H, W, ch, w_gate_k,
                                             w_q_k, z, rh, aqx, h_out, w1, b1, w2, nh, f1, dx,
                                             stream)
                 : launch_head_chain<bf16>(h, czrq, nullptr, xs, cxs, B, H, W, ch, w_gate_k,
                                           w_q_k, z, rh, aqx, h_out, w1, b1, w2, nh, f1, dx,
                                           stream);
  const rst::ConvIn gates = rst::gru_gate_in(h, xs, cxs, 3, B, H, W, ch, w_gate);
  int err = lane8 ? launch_gates<int8_t>(gates, czrq, scale, h, z, rh, aqx, ch, stream)
                  : launch_gates<bf16>(gates, czrq, nullptr, h, z, rh, aqx, ch, stream);
  if (err) return err;
  return rst::launch_conv3x3<64>(rst::gru_update_in(rh, B, H, W, ch, w_q),
                                 rst::UpdateEpi{aqx, z, h, h_out, ch}, stream);
}
