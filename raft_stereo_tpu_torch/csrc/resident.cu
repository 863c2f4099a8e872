// The resident iteration: correlation gather, motion encoder, gru08 and the
// FlowHead in one launch.
//
// Replaces raft_stereo_tpu/ops/pallas_resident.py:_resident_kernel (driven
// by fused_iter_fwd_impl), with its corr gather in the plain mode (bf16
// levels) and the packed8 mode (int8 levels, RAFT_CORR_PACK8; _corr_rows),
// and its gate stage on bf16 czrq or on int8 czrq (RAFT_LANE_PACK8,
// _resident_lane8_kernel): four instantiations, resident_kernel<T, Q> with T
// the level type and Q czrq's. It computes what the serial route does with the
// corr_lookup.cu, motion.cu and conv_gru.cu (+head) launches and gives the
// same bits:
//   corr      = lookup(pyramid, coords_x)                 (never written)
//   motion    = motion_encoder(flow, corr)
//   h', dx    = gru08(h, czrq, motion, x2...) + FlowHead  (dx without conv2.b[0])
//
// What bounds it on an H100: tensor-core operations, about 1.85 M MAC a
// pixel at 128 channels (~0.11 ms of bf16 peak at 96x312), against ~25 MB
// of pyramid, state and context. The serial route spends eight launches on
// it and writes and rereads the corr taps.
//
// Design: the TPU kernel streams row blocks down a sequential grid, with
// gru08 one block behind the motion stages and every intermediate in VMEM
// windows. Here one cooperative launch, at most as many blocks as the card
// holds at once (grid.cuh), runs seven stages as grid-stride loops with a
// grid barrier between them:
//   1. gather + motion stage 1: a block gathers the taps of 32 pixels into
//      shared memory once (gather_level_taps, the lookup's own body) and
//      runs the 1x1 convc1 from there and the 7x7 convf1 from the flow
//      (MotionStage1, the serial kernel's own body); the taps never reach
//      device memory;
//   2. the block-diagonal 3x3, 3. the fusion 3x3 ([cf fused | 2 flow]),
//   4. the gru08 gates, 5. the update (h'), 6. head conv1, 7. head conv2:
//      the serial stages of stages.cuh on the shared engine.
// The motion features and the GRU intermediates go through device scratch
// between the barriers (a few MB each at 96x312, mostly L2-resident on the
// card's 50 MB); keeping them on chip is later work. Registers are capped
// at 80 so that three blocks fit an SM, as for the serial engine launches:
// a few bytes spill, and the engine stages, latency-bound, run faster than
// at two blocks.
#include <type_traits>

#include "corr_taps.cuh"
#include "grid.cuh"
#include "motion_stage1.cuh"
#include "stages.cuh"

namespace rst {

constexpr int kTapPixels = 32;  // pixels per gather tile of stage 1

template <typename Q>
struct ResidentParams {
  Levels<bf16> lv;      // the pyramid's levels, or
  Levels<int8_t> lv8;   // its int8 levels with their scales
  int nlev, radius, npix;
  const float* coords;  // [P] x positions
  MotionStage1 stage1;
  bf16* s1;             // [P][n1 + nf]
  ConvIn s2, fusion, gate, update, head1, head2;
  ReluBiasEpi s2_epi;
  FusionEpi fusion_epi;
  GateEpi<Q> gate_epi;
  UpdateEpi update_epi;
  ReluBiasEpi head1_epi;
  FirstChannelEpi head2_epi;
  unsigned int* bar;
};

template <typename T, typename Q>
__device__ __forceinline__ const Levels<T>& levels_of(const ResidentParams<Q>& p) {
  if constexpr (std::is_same_v<T, int8_t>) {
    return p.lv8;
  } else {
    return p.lv;
  }
}

template <typename T, typename Q>
__device__ __forceinline__ void gather_stage1(const ResidentParams<Q>& p, unsigned char* smem) {
  const Levels<T>& lv = levels_of<T>(p);
  bf16* taps = reinterpret_cast<bf16*>(smem);  // [kTapPixels][ccorr]
  const int ccorr = p.stage1.ccorr;
  const int k = 2 * p.radius + 1;
  const int ns = p.stage1.n1 + p.stage1.nf;
  const int ntiles = (p.npix + kTapPixels - 1) / kTapPixels;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int p0 = t * kTapPixels;
    for (int i = threadIdx.x; i < kTapPixels * p.nlev; i += blockDim.x) {
      const int px = i / p.nlev;
      const int l = i % p.nlev;
      if (p0 + px < p.npix)
        gather_level_taps(lv, l, p0 + px, p.coords[p0 + px], p.radius,
                          taps + px * ccorr + l * k);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTapPixels * ns; i += blockDim.x) {
      const int px = i / ns;
      const int n = i % ns;
      if (p0 + px < p.npix)
        p.s1[(size_t)(p0 + px) * ns + n] = p.stage1(taps + px * ccorr, p0 + px, n);
    }
    __syncthreads();
  }
}

template <typename T, typename Q>
__global__ void __launch_bounds__(THREADS, 3) resident_kernel(ResidentParams<Q> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  GridBarrier grid{p.bar};
  gather_stage1<T>(p, smem);
  grid.sync();
  conv3x3_stage<64>(p.s2, p.s2_epi, smem, p.bar + 1);
  grid.sync();
  conv3x3_stage<64>(p.fusion, p.fusion_epi, smem, p.bar + 2);
  grid.sync();
  conv3x3_stage<64>(p.gate, p.gate_epi, smem, p.bar + 3);
  grid.sync();
  conv3x3_stage<64>(p.update, p.update_epi, smem, p.bar + 4);
  grid.sync();
  conv3x3_stage<64>(p.head1, p.head1_epi, smem, p.bar + 5);
  grid.sync();
  conv3x3_stage<16>(p.head2, p.head2_epi, smem, p.bar + 6);
}

template <typename Q>
int launch_resident(const float* coords, const void* const* rows, const int* widths, int nlev,
                    int radius, int int8_levels, const float* scales, const bf16* flow,
                    const bf16* h, const void* czrq, const float* czrq_scale, const bf16* xa,
                    int cxa, const bf16* xb, int cxb, int B, int H, int W, int ch,
                    const bf16* wc1, const bf16* wf1, const float* b1, int n1, int nf,
                    const bf16* w2, const float* b2, const bf16* wf, const float* bf, int cf,
                    const bf16* w_gate, const bf16* w_q, const bf16* w1, const float* bh1,
                    const bf16* w2h, int nh, bf16* s1, bf16* s2, bf16* mot, bf16* z, bf16* rh,
                    float* aqx, bf16* f1, bf16* h_out, float* dx, unsigned int* bar,
                    cudaStream_t stream) {
  const size_t smem = TileSmem<64>::BYTES;
  ResidentParams<Q> p{};
  for (int l = 0; l < nlev; ++l) {
    p.lv.row[l] = static_cast<const bf16*>(rows[l]);
    p.lv8.row[l] = static_cast<const int8_t*>(rows[l]);
    p.lv.width[l] = p.lv8.width[l] = widths[l];
  }
  p.lv8.scale = scales;
  p.lv8.sample_pixels = H * W;
  p.lv8.nlev = nlev;
  p.nlev = nlev;
  p.radius = radius;
  p.npix = B * H * W;
  p.coords = coords;
  const int ccorr = nlev * (2 * radius + 1);
  p.stage1 = MotionStage1{flow, wc1, wf1, b1, ccorr, n1, nf, H, W};
  p.s1 = s1;
  const int ns = n1 + nf;
  p.s2 = motion_s2_in(s1, B, H, W, n1, nf, w2);
  p.s2_epi = ReluBiasEpi{b2, s2, ns};
  p.fusion = motion_fusion_in(s2, B, H, W, ns, cf, wf);
  p.fusion_epi = FusionEpi{bf, flow, mot, cf};
  const bf16* xs[3] = {mot, xa, xb};
  const int cxs[3] = {cf + 2, cxa, cxb};
  p.gate = gru_gate_in(h, xs, cxs, 3, B, H, W, ch, w_gate);
  p.gate_epi = GateEpi<Q>{static_cast<const Q*>(czrq), czrq_scale, H * W, h, z, rh, aqx, ch};
  p.update = gru_update_in(rh, B, H, W, ch, w_q);
  p.update_epi = UpdateEpi{aqx, z, h, h_out, ch};
  p.head1 = head1_in(h_out, B, H, W, ch, w1, nh);
  p.head1_epi = ReluBiasEpi{bh1, f1, nh};
  p.head2 = head2_in(f1, B, H, W, nh, w2h);
  p.head2_epi = FirstChannelEpi{dx};
  p.bar = bar;
  int tiles = (p.npix + kTapPixels - 1) / kTapPixels;
  const ConvIn* stages[5] = {&p.s2, &p.fusion, &p.gate, &p.update, &p.head1};
  for (const ConvIn* a : stages) {
    const int t = conv3x3_tiles(*a, 64);
    if (t > tiles) tiles = t;
  }
  if (int8_levels)
    return launch_persistent(resident_kernel<int8_t, Q>, p, bar, tiles, smem, THREADS, stream);
  return launch_persistent(resident_kernel<bf16, Q>, p, bar, tiles, smem, THREADS, stream);
}

}  // namespace rst

using rst::bf16;

// Pyramid: rows[l]: [P][widths[l]], bf16, or int8 when int8_levels (then
// scales: [B][nlev] fp32); coords: [P] fp32, nlev levels of radius r
// (ccorr = nlev (2r+1) taps). flow: [P][2]. h: [P][ch], czrq: [P][3ch],
// bf16, or int8 with lane8 != 0 and czrq_scale: [B] fp32; xa/xb: gru08's x
// parts after the motion features ([P][cxa], [P][cxb], 0 channels = absent).
// Motion weights as rst_motion's (wc1: [ccorr][n1], wf1: [49][nf], b1, w2,
// b2, wf, bf, cf); GRU weights as rst_conv_gru's over [h; motion; xa; xb];
// head w1/bh1/w2h of width nh. s1, s2: [P][n1+nf], mot: [P][cf+2], z, rh:
// [P][ch] bf16, aqx: [P][ch] fp32, f1: [P][nh]: scratch. Outputs h_out:
// [P][ch], dx: [P] fp32. bar: rst::kCounters counters. Returns the first
// non-zero cudaError_t.
extern "C" int rst_resident(const float* coords, const void* const* rows, const int* widths,
                            int nlev, int radius, int int8_levels, const float* scales,
                            const bf16* flow, const bf16* h, const void* czrq, int lane8,
                            const float* czrq_scale, const bf16* xa, int cxa, const bf16* xb,
                            int cxb, int B, int H, int W, int ch, const bf16* wc1,
                            const bf16* wf1, const float* b1, int n1, int nf, const bf16* w2,
                            const float* b2, const bf16* wf, const float* bf, int cf,
                            const bf16* w_gate, const bf16* w_q, const bf16* w1,
                            const float* bh1, const bf16* w2h, int nh, bf16* s1, bf16* s2,
                            bf16* mot, bf16* z, bf16* rh, float* aqx, bf16* f1, bf16* h_out,
                            float* dx, unsigned int* bar, cudaStream_t stream) {
  if (nlev < 1 || nlev > rst::kMaxLevels) return (int)cudaErrorInvalidValue;
  const int ccorr = nlev * (2 * radius + 1);
  if ((size_t)rst::kTapPixels * ccorr * sizeof(bf16) > rst::TileSmem<64>::BYTES)
    return (int)cudaErrorInvalidValue;
  if (int8_levels && scales == nullptr) return (int)cudaErrorInvalidValue;
  if (lane8 && czrq_scale == nullptr) return (int)cudaErrorInvalidValue;
  if (lane8)
    return rst::launch_resident<int8_t>(
        coords, rows, widths, nlev, radius, int8_levels, scales, flow, h, czrq, czrq_scale, xa,
        cxa, xb, cxb, B, H, W, ch, wc1, wf1, b1, n1, nf, w2, b2, wf, bf, cf, w_gate, w_q, w1,
        bh1, w2h, nh, s1, s2, mot, z, rh, aqx, f1, h_out, dx, bar, stream);
  return rst::launch_resident<bf16>(
      coords, rows, widths, nlev, radius, int8_levels, scales, flow, h, czrq, nullptr, xa, cxa,
      xb, cxb, B, H, W, ch, wc1, wf1, b1, n1, nf, w2, b2, wf, bf, cf, w_gate, w_q, w1, bh1, w2h,
      nh, s1, s2, mot, z, rh, aqx, f1, h_out, dx, bar, stream);
}
