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
// windows. Here one cooperative launch, one block an SM (grid.cuh), runs
// seven stages:
//   1. gather + motion stage 1, in tiles of 64 pixels of one image row: a
//      block gathers the tile's taps into shared memory once
//      (gather_level_taps, the lookup's own body) and runs the 1x1 convc1
//      from there and the 7x7 convf1 from the flow (MotionStage1::tile, the
//      serial kernel's own body, every operand in shared memory); the taps
//      never reach device memory;
//   2. the block-diagonal 3x3, 3. the fusion 3x3 ([cf fused | 2 flow]),
//   4. the gru08 gates, 5. the update (h'), 6. head conv1, 7. head conv2:
//      the serial launches' stages (stages.cuh) on the Hopper engine
//      (loop_conv_sm90.cuh), tiles dealt to blocks in the serial launch's
//      order.
// What bounds the design, and what it does about each cost of the WMMA
// implicit GEMM (mma.sync tiles of 128 pixels by 64 columns fed by cp.async)
// that ran these stages before:
//   1. wgmma m64nNk16 (N up to 128), the card's full tensor-core path, in
//      place of mma.sync fragments with a __syncthreads every K step;
//   2. each 64-channel input chunk of an 8 x 16 output patch is staged once,
//      as a TMA halo patch of 10 x 18 pixels, and the 9 taps read it at
//      shifted ldmatrix addresses, in place of 9 copies of the A tile;
//   3. a block computes up to 128 output columns of a patch at once (the
//      gates in three tiles: z, r and q), so a patch is staged once per 128
//      columns, not per 64; larger pixel tiles (256 pixels, two m64 blocks a
//      warpgroup) spilled at ptxas's 168 registers and ran slower;
//   4. the accumulators stay in registers: shuffles within a quad hand each
//      lane 8 consecutive columns, and the epilogue functors (stages.cuh,
//      the one definition of every rounding point) load and store 16 bytes
//      at a time (put8), with no fp32 staging through shared memory; the
//      scattered 2-byte accesses of a value-by-value epilogue had cost more
//      than the products;
//   5. a producer warp (one thread issues every TMA load), a signal warp and
//      two consumer warpgroups, one block an SM, 168 registers a thread and
//      no spill, in place of three blocks capped at 80 registers that
//      spilled;
//   6. no grid barrier: the stages form a dataflow. A tile's producer waits
//      until the three patch rows its halo reads count as done in the stage
//      before (a counter a patch row, `bar`), then orders its TMA reads
//      after them with a proxy fence; the signal warp counts each finished
//      tile after the consumer warps' stores. A block goes on to the next
//      stage's first rows while others finish this stage's last, so the
//      stages' tails overlap. s1, s2, mot, z, rh, aqx (fp32) and f1 still go
//      through device scratch (7.7-15 MB each at 96x312, in the 50 MB L2).
#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "corr_taps.cuh"
#include "grid.cuh"
#include "motion_stage1.cuh"
#include "stages.cuh"

namespace rst {

// The dataflow's counters: stage 1 and the five conv stages before the
// last, one a patch row of each image.
inline int resident_counters(int B, int H) { return 6 * B * ((H + loop::kTH - 1) / loop::kTH); }

template <typename Q>
struct ResidentParams {
  CUtensorMap maps[loop::kLaunchMaps];  // the conv stages' inputs and weights
  Levels<bf16> lv;      // the pyramid's levels, or
  Levels<int8_t> lv8;   // its int8 levels with their scales
  int nlev, radius, npix;
  const float* coords;  // [P] x positions
  MotionStage1 stage1;
  bf16* s1;             // [P][n1 + nf]
  unsigned* s1_done;    // stage 1's count a patch row (the dataflow, loop::LoopConv)
  loop::LoopConv s2, fusion, gate, update, head1, head2;
  int fusion_n, gate_n, update_n, head1_n;  // column tile widths, 64 or 128
  ReluBiasEpi s2_epi;
  FusionEpi fusion_epi;
  GateEpi<Q> gate_epi;
  UpdateEpi update_epi;
  ReluBiasEpi head1_epi;
  FirstChannelEpi head2_epi;
};

template <typename T, typename Q>
__device__ __forceinline__ const Levels<T>& levels_of(const ResidentParams<Q>& p) {
  if constexpr (std::is_same_v<T, int8_t>) {
    return p.lv8;
  } else {
    return p.lv;
  }
}

// Stage 1 in tiles of up to 64 pixels of one image row, so each tile counts
// toward one patch row of stage 2 (s1_done).
template <typename T, typename Q>
__device__ __forceinline__ void gather_stage1(const ResidentParams<Q>& p, unsigned char* smem) {
  const Levels<T>& lv = levels_of<T>(p);
  const Stage1Smem s = p.stage1.smem(smem);
  p.stage1.load_weights(s);
  const int k = 2 * p.radius + 1;
  const int H = p.stage1.H, W = p.stage1.W;
  const int segs = (W + kS1Pixels - 1) / kS1Pixels;
  const int ntiles = p.npix / W * segs;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int row = t / segs;  // img * H + y
    const int x0 = (t % segs) * kS1Pixels;
    const int count = min(kS1Pixels, W - x0);
    const int p0 = row * W + x0;
    for (int i = threadIdx.x; i < kS1Pixels * p.nlev; i += blockDim.x) {
      const int px = i / p.nlev;
      const int l = i % p.nlev;
      if (px < count)
        gather_level_taps(lv, l, p0 + px, p.coords[p0 + px], p.radius,
                          s.taps + px * p.stage1.ccorr + l * k);
    }
    p.stage1.tile(s, row, x0, count, p.s1);
    // s1 is read by TMA in other blocks once the count says so (tile()
    // ends in a block barrier; the fence is cumulative).
    sm90::fence_proxy_async_global();
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(p.s1_done + (row / H) * p.s2.tiles_y + (row % H) / loop::kTH, 1u);
    }
  }
  sm90::fence_proxy_async();  // TMA overwrites this shared memory next
}

template <typename T, typename Q>
__global__ void __launch_bounds__(loop::kThreads, loop::kBlocksPerSM)
    resident_kernel(const __grid_constant__ ResidentParams<Q> p) {
  extern __shared__ unsigned char smem_raw[];
  const loop::LoopSmem s = loop::loop_smem(smem_raw);
  loop::loop_init(s);
  gather_stage1<T>(p, s.a);
  __syncthreads();  // the block's stage 1 is done with the rings' memory
  loop::Ring r;
  const int t0 = blockIdx.x;
  loop::conv_stage<64>(p.s2, p.maps, p.s2_epi, s, r, t0);
  loop::conv_stage_n(p.fusion_n, p.fusion, p.maps, p.fusion_epi, s, r, t0);
  loop::conv_stage_n(p.gate_n, p.gate, p.maps, p.gate_epi, s, r, t0);
  loop::conv_stage_n(p.update_n, p.update, p.maps, p.update_epi, s, r, t0);
  loop::conv_stage_n(p.head1_n, p.head1, p.maps, p.head1_epi, s, r, t0);
  loop::conv_stage<8>(p.head2, p.maps, p.head2_epi, s, r, t0);
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
  static_assert(sizeof(ResidentParams<Q>) <= 4096, "kernel parameters over 4 KB");
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
  int nmaps = 0;
  const bf16* xs[3] = {mot, xa, xb};
  const int cxs[3] = {cf + 2, cxa, cxb};
  int err = motion_s2_loop(p.s2, p.maps, &nmaps, s1, B, H, W, n1, nf, w2);
  if (!err) err = motion_fusion_loop(p.fusion, p.maps, &nmaps, s2, B, H, W, ns, cf, wf,
                                     &p.fusion_n);
  if (!err) err = gate_loop(p.gate, p.maps, &nmaps, h, xs, cxs, 3, B, H, W, ch, w_gate, &p.gate_n);
  if (!err) err = update_loop(p.update, p.maps, &nmaps, rh, B, H, W, ch, w_q, &p.update_n);
  if (!err) err = head1_loop(p.head1, p.maps, &nmaps, h_out, B, H, W, ch, w1, nh, &p.head1_n);
  if (!err) err = head2_loop(p.head2, p.maps, &nmaps, f1, B, H, W, nh, w2h);
  if (err) return err;
  p.s2_epi = ReluBiasEpi{b2, s2, ns};
  p.fusion_epi = FusionEpi{bf, flow, mot, cf};
  p.gate_epi = GateEpi<Q>{static_cast<const Q*>(czrq), czrq_scale, H * W, h, z, rh, aqx, ch};
  p.update_epi = UpdateEpi{aqx, z, h, h_out, ch};
  p.head1_epi = ReluBiasEpi{bh1, f1, nh};
  p.head2_epi = FirstChannelEpi{dx};
  // The dataflow: stage k's tiles wait on stage k - 1's counts a patch row.
  const int patch_rows = B * p.s2.tiles_y;
  const int segs = (W + kS1Pixels - 1) / kS1Pixels;
  p.s1_done = bar;
  loop::LoopConv* chain[6] = {&p.s2, &p.fusion, &p.gate, &p.update, &p.head1, &p.head2};
  for (int i = 0; i < 6; ++i) {
    loop::LoopConv& c = *chain[i];
    c.wait_on = bar + i * patch_rows;
    if (i == 0) {
      c.wait_full = loop::kTH * segs;
      c.wait_last = (H - (c.tiles_y - 1) * loop::kTH) * segs;
    } else {
      c.wait_full = c.wait_last = chain[i - 1]->tiles_x * chain[i - 1]->ncol;
    }
    c.signal = i < 5 ? bar + (i + 1) * patch_rows : nullptr;
  }
  int tiles = (p.npix + kS1Pixels - 1) / kS1Pixels;
  for (const loop::LoopConv* c : {&p.s2, &p.fusion, &p.gate, &p.update, &p.head1, &p.head2})
    tiles = std::max(tiles, loop::tiles_of(*c));
  void (*kernel)(ResidentParams<Q>) =
      int8_levels ? &resident_kernel<int8_t, Q> : &resident_kernel<bf16, Q>;
  int grid = 0;
  if ((err = loop::loop_grid(kernel, tiles, &grid))) return err;
  return launch_persistent(kernel, p, bar, resident_counters(B, H), grid, loop::kSmemBytes,
                           loop::kThreads, stream);
}

}  // namespace rst

using rst::bf16;

// Pyramid: rows[l]: [P][widths[l]], bf16, or int8 when int8_levels (then
// scales: [B][nlev] fp32); coords: [P] fp32, nlev levels of radius r
// (ccorr = nlev (2r+1) taps). flow: [P][2]. h: [P][ch], czrq: [P][3ch],
// bf16, or int8 with lane8 != 0 and czrq_scale: [B] fp32; xa/xb: gru08's x
// parts after the motion features ([P][cxa], [P][cxb], 0 channels = absent).
// Motion weights as rst_motion's (wc1: [ccorr][n1], wf1: [49][nf], b1, w2,
// b2, wf, bf, cf); GRU and head weights as rst_conv_gru's with the head,
// over [h; motion; xa; xb], the head of width nh; every 3x3 matrix K-major (output channel,
// then input channel): w2: [9][ns][ns] block-diagonal, wf: [9][cf][ns],
// w_gate: [9][3ch][ch + cf + 2 + cxa + cxb], w_q: [9][ch][ch], w1:
// [9][nh][ch], w2h: [9][1][nh] (conv2's x output). s1, s2: [P][n1+nf],
// mot: [P][cf+2], z, rh: [P][ch] bf16, aqx: [P][ch] fp32, f1: [P][nh]:
// scratch. Outputs h_out:
// [P][ch], dx: [P] fp32. bar: rst_resident_counters(B, H) counters, zeroed
// here (the dataflow between the stages). Returns the first
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
  if (rst::stage1_smem_bytes(ccorr, n1, nf) > rst::loop::kBarOffset)
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

// The counters rst_resident needs at bar for B images of H rows.
extern "C" int rst_resident_counters(int B, int H) { return rst::resident_counters(B, H); }

// The loop engine's block on this card: plan[0] its dynamic shared memory in
// bytes, plan[1] its threads, plan[2] the resident kernel's blocks an SM.
// Returns 0 or a cudaError_t.
extern "C" int rst_resident_plan(int* plan) {
  void (*kernel)(rst::ResidentParams<bf16>) = &rst::resident_kernel<bf16, bf16>;
  plan[0] = rst::loop::kSmemBytes;
  plan[1] = rst::loop::kThreads;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rst::loop::kSmemBytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[2], kernel, plan[1], plan[0]);
}
