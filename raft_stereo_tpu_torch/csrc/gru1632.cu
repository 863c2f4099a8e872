// The two coarse ConvGRU steps, gru32 then gru16, in one launch.
//
// Replaces raft_stereo_tpu/ops/pallas_stream.py:_gru1632_kernel and its lane8
// form _gru1632_lane8_kernel (driven by fused_gru1632_fwd_impl). It computes
// what the serial route does with two head-less conv_gru.cu launches and the
// aligned-corners resize between them:
//   h32' = gru32(h32, czrq32, pool2x(h16))
//   up   = interp_align_corners(h32', (H16, W16))
//   h16' = gru16(h16, czrq16, pool2x(h08), up)
// and gives the same bits (the pools stay outside, as in the JAX package).
// Given gru08's size it also builds gru08's x2 input,
//   up08 = interp_align_corners(h16', (H08, W08)),
// which the serial route and the JAX package build outside, with the same
// bits.
//
// What bounds it on an H100: tensor-core operations, 1.33 M MAC a gru16
// pixel and 0.88 M a gru32 one at 128 channels (0.023 ms of bf16 peak at
// 48x156 + 24x78, 0.29 ms at 252x372 + 126x186), against ~5 MB of inputs and
// outputs at 48x156. At the smaller size the maps barely fill the card: 15
// gru32 and 60 gru16 output patches of 8 x 16 pixels (tiles: 90 gru32 gate,
// 30 gru32 update, 60 upsample, 360 gru16 gate, 120 gru16 update, on 132
// SMs; at 252x372, 576, 384, 768, 2304 and 768; stage 6, 240 at 96x312 and
// 2961 at 504x744).
//
// Design: the TPU kernel runs gru16 one row block behind gru32 on its
// sequential grid and builds the upsampled x part once a row block in VMEM.
// Here one cooperative launch, one block an SM, runs five or six stages on
// the loop engine (loop_conv_sm90.cuh), the serial launches' own stages
// (stages.cuh) with their tiles, so the bits are theirs:
//   1. gru32 gates, 2. gru32 update (h32'),
//   3. the upsample: each value of up built once, from four h32' values (the
//      H lerp in fp32 rounded to bf16, then the W lerp rounded to bf16, as
//      the resize's two contractions round), into a bf16 scratch map (1.9 MB
//      at 48x156, in the 50 MB L2), a tile of it an 8 x 16 patch of gru16's,
//   4. gru16 gates over [h16; x0p; up], up read by TMA like any other part,
//   5. gru16 update (h16'),
//   6. with gru08's size only: the upsample of h16' to gru08's size, stage 3
//      again, a tile of it an 8 x 16 patch of gru08's, into a bf16 map the
//      caller keeps (the resident kernel reads it by TMA as its x2 part).
//      It is a two-tap lerp, a read of h16' and a write of 2 bytes a value
//      (96 MB at 504x744x128); the dense fp32 einsums it replaces are 48
//      GFLOP of SIMT sgemm an iteration at that size.
// No grid barrier: each stage's tiles wait on counts a patch row of the
// stage before (the loop engine's dataflow). An upsample tile waits on the
// gru32 patch rows that hold its source rows, a range read from the resize's
// own row taps, so gru16 starts a row block behind gru32, as on the TPU (and
// a stage 6 tile on the gru16 update's rows of its source, likewise). The
// upsample runs on the consumer warpgroups; the producer warp goes on to
// gru16's first loads meanwhile. At these sizes the chain of stages, not the
// card's rate, is the cost, and three choices shorten it:
//   - a gru16 gate tile loads its h16 and x0p chunks at once and waits for
//     the upsample only before its up chunks;
//   - the upsample's tiles run on the blocks that ran gru32's, and the gru16
//     gates' first tiles on the others, so those chunks overlap gru32;
//   - a stage whose 128-column tiles would number fewer than two an SM runs
//     tiles of 64 columns (stages.cuh tile_cols; the serial launches too).
// z, rh and aqx of each level go through device scratch, as in the serial
// launches.
#include "grid.cuh"
#include "stages.cuh"

namespace rst {

// Stages 3 and 6: the aligned-corners upsample of a state written earlier in
// the launch (h32' to gru16's size; h16' to gru08's). Per output row y the
// two source rows yi[2y], yi[2y+1] and their weights yw[2y], yw[2y+1] (per
// column likewise) are the nonzeros of the resize's lerp matrices, already
// rounded to bf16 (ops/resize.py:lerp_taps). Each lerp sums two products of
// bf16 values, which fp32 holds exactly, so its one rounding is the
// contraction's.
struct UpsampleStage {
  const bf16* src;  // h32' or h16': [B][Hs][Ws][C]
  bf16* dst;        // up or up08: [B][H][W][C]
  int Hs, Ws, H, W, C;
  const int* yi;
  const float* yw;
  const int* xi;
  const float* xw;
  int tiles_x, tiles_y, patches, first;  // the output's patch grid, as LoopConv's
  const unsigned* wait_on;  // the source's update counts a patch row, [B][src_tiles_y]
  int src_tiles_y;
  unsigned wait_full;
  unsigned* signal;  // this stage's counts an output patch row, [B][tiles_y], or null

  // Channels c .. c + 7 of output pixel (img, y, x). The source was written
  // in this launch by other SMs: read through L2 (ld.cg), never a stale L1
  // line.
  __device__ void put8(int img, int y, int x, int c) const {
    const int y0 = yi[2 * y], y1 = yi[2 * y + 1];
    const int x0 = xi[2 * x], x1 = xi[2 * x + 1];
    const float wy0 = yw[2 * y], wy1 = yw[2 * y + 1];
    const float wx0 = xw[2 * x], wx1 = xw[2 * x + 1];
    const bf16* base = src + (size_t)img * Hs * Ws * C + c;
    const uint4 q00 = __ldcg(reinterpret_cast<const uint4*>(base + ((size_t)y0 * Ws + x0) * C));
    const uint4 q10 = __ldcg(reinterpret_cast<const uint4*>(base + ((size_t)y1 * Ws + x0) * C));
    const uint4 q01 = __ldcg(reinterpret_cast<const uint4*>(base + ((size_t)y0 * Ws + x1) * C));
    const uint4 q11 = __ldcg(reinterpret_cast<const uint4*>(base + ((size_t)y1 * Ws + x1) * C));
    const bf16* v00 = reinterpret_cast<const bf16*>(&q00);
    const bf16* v10 = reinterpret_cast<const bf16*>(&q10);
    const bf16* v01 = reinterpret_cast<const bf16*>(&q01);
    const bf16* v11 = reinterpret_cast<const bf16*>(&q11);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float left = bf16r(__fadd_rn(__fmul_rn(wy0, __bfloat162float(v00[i])),
                                         __fmul_rn(wy1, __bfloat162float(v10[i]))));
      const float right = bf16r(__fadd_rn(__fmul_rn(wy0, __bfloat162float(v01[i])),
                                          __fmul_rn(wy1, __bfloat162float(v11[i]))));
      o[i] = __float2bfloat16(__fadd_rn(__fmul_rn(wx0, left), __fmul_rn(wx1, right)));
    }
    *reinterpret_cast<uint4*>(dst + (((size_t)img * H + y) * W + x) * C + c) = out;
  }
};

// An upsample's tiles, on the consumer warpgroups (named barrier 1): one
// thread waits for the source's patch rows a tile's source rows lie in, all
// build the tile's values, and once they are written one thread counts the
// tile for its output patch row (where a later stage reads the output).
__device__ void upsample_stage(const UpsampleStage& u) {
  const int groups = u.C / 8;
  const int per_img = u.tiles_y * u.tiles_x;
  for (int t = loop::first_tile(u.first); t < u.patches; t += gridDim.x) {
    const int img = t / per_img, r = t % per_img;
    const int ty = r / u.tiles_x;
    const int y0 = ty * loop::kTH, x0 = (r % u.tiles_x) * loop::kTW;
    if (threadIdx.x == 0) {
      const int ylast = min(y0 + loop::kTH, u.H) - 1;
      const unsigned* counts = u.wait_on + img * u.src_tiles_y;
      for (int row = u.yi[2 * y0] / loop::kTH; row <= u.yi[2 * ylast + 1] / loop::kTH; ++row)
        loop::spin_until(counts + row, u.wait_full);
      __threadfence();
    }
    sm90::named_sync(1, loop::kConsumers);
    for (int i = threadIdx.x; i < loop::kTH * loop::kTW * groups; i += loop::kConsumers) {
      const int px = i / groups;
      const int y = y0 + px / loop::kTW, x = x0 + px % loop::kTW;
      if (y < u.H && x < u.W) u.put8(img, y, x, (i % groups) * 8);
    }
    if (u.signal == nullptr) continue;  // stage 6: read after the launch
    sm90::fence_proxy_async_global();  // these stores before gru16's TMA reads, in any block
    sm90::named_sync(1, loop::kConsumers);
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(u.signal + img * u.tiles_y + ty, 1u);
    }
  }
}

// Q: czrq's element type, bf16 or int8 (RAFT_LANE_PACK8, replacing
// _gru1632_lane8_kernel): one instantiation each.
template <typename Q>
struct Gru1632Params {
  CUtensorMap maps[loop::kLaunchMaps];  // the conv stages' inputs and weights
  loop::LoopConv gate32, update32, gate16, update16;
  int gate32_n, update32_n, gate16_n, update16_n;  // column tile widths, 64 or 128
  GateEpi<Q> gate32_epi, gate16_epi;
  UpdateEpi update32_epi, update16_epi;
  UpsampleStage up, up08;  // up08.patches is 0 without gru08's size
};

template <typename Q>
__global__ void __launch_bounds__(loop::kThreads, loop::kBlocksPerSM)
    gru1632_kernel(const __grid_constant__ Gru1632Params<Q> p) {
  extern __shared__ unsigned char smem_raw[];
  const loop::LoopSmem s = loop::loop_smem(smem_raw);
  loop::loop_init(s);
  __syncthreads();
  loop::Ring r;
  using loop::first_tile;
  loop::conv_stage_n(p.gate32_n, p.gate32, p.maps, p.gate32_epi, s, r, first_tile(p.gate32.first));
  loop::conv_stage_n(p.update32_n, p.update32, p.maps, p.update32_epi, s, r,
                     first_tile(p.update32.first));
  if (threadIdx.x < loop::kConsumers) upsample_stage(p.up);
  loop::conv_stage_n(p.gate16_n, p.gate16, p.maps, p.gate16_epi, s, r, first_tile(p.gate16.first));
  loop::conv_stage_n(p.update16_n, p.update16, p.maps, p.update16_epi, s, r,
                     first_tile(p.update16.first));
  if (threadIdx.x < loop::kConsumers) upsample_stage(p.up08);
}

inline int patch_rows(int B, int H) { return B * ((H + loop::kTH - 1) / loop::kTH); }

// The dataflow's counters: the gru32 gates' and update's a gru32 patch row,
// the upsample's, the gru16 gates' and the gru16 update's a gru16 patch row
// (the last for stage 6 alone).
inline int gru1632_counters(int B, int H16, int H32) {
  return 2 * patch_rows(B, H32) + 3 * patch_rows(B, H16);
}

template <typename Q>
int launch_gru1632(const bf16* h16, const bf16* h32, const void* czrq16, const void* czrq32,
                   const float* s16, const float* s32, const bf16* x0p, int cx0, const bf16* x1p,
                   int B, int H16, int W16, int H32, int W32, int ch, const bf16* wg16,
                   const bf16* wq16, const bf16* wg32, const bf16* wq32, const int* yi,
                   const float* yw, const int* xi, const float* xw, int H08, int W08,
                   const int* yi08, const float* yw08, const int* xi08, const float* xw08,
                   bf16* z16, bf16* rh16, float* aqx16, bf16* z32, bf16* rh32, float* aqx32,
                   bf16* up, bf16* up08, bf16* h16_out, bf16* h32_out, unsigned int* bar,
                   cudaStream_t stream) {
  static_assert(sizeof(Gru1632Params<Q>) <= 4096, "kernel parameters over 4 KB");
  Gru1632Params<Q> p{};
  int nmaps = 0;
  const bf16* xs32[1] = {x1p};
  const int cxs32[1] = {ch};
  const bf16* xs16[2] = {x0p, up};
  const int cxs16[2] = {cx0, ch};
  int sms = 0;
  int err = loop::sm_count(&sms);
  if (!err) err = gate_loop(p.gate32, p.maps, &nmaps, h32, xs32, cxs32, 1, B, H32, W32, ch, wg32,
                            &p.gate32_n, sms);
  if (!err) err = update_loop(p.update32, p.maps, &nmaps, rh32, B, H32, W32, ch, wq32,
                              &p.update32_n, sms);
  if (!err) err = gate_loop(p.gate16, p.maps, &nmaps, h16, xs16, cxs16, 2, B, H16, W16, ch,
                            wg16, &p.gate16_n, sms);
  if (!err) err = update_loop(p.update16, p.maps, &nmaps, rh16, B, H16, W16, ch, wq16,
                              &p.update16_n, sms);
  if (err) return err;
  p.gate32_epi = GateEpi<Q>{static_cast<const Q*>(czrq32), s32, H32 * W32, h32, z32, rh32,
                            aqx32, ch};
  p.update32_epi = UpdateEpi{aqx32, z32, h32, h32_out, ch};
  p.gate16_epi = GateEpi<Q>{static_cast<const Q*>(czrq16), s16, H16 * W16, h16, z16, rh16,
                            aqx16, ch};
  p.update16_epi = UpdateEpi{aqx16, z16, h16, h16_out, ch};
  UpsampleStage& u = p.up;
  u = UpsampleStage{h32_out, up, H32, W32, H16, W16, ch, yi, yw, xi, xw};
  u.tiles_x = p.gate16.tiles_x;
  u.tiles_y = p.gate16.tiles_y;
  u.patches = p.gate16.patches;
  // The dataflow: each stage waits on the counts of the one before.
  const int rows32 = patch_rows(B, H32), rows16 = patch_rows(B, H16);
  unsigned* const gate32_done = bar;
  unsigned* const update32_done = bar + rows32;
  unsigned* const up_done = bar + 2 * rows32;
  unsigned* const gate16_done = up_done + rows16;
  unsigned* const update16_done = gate16_done + rows16;
  p.gate32.signal = gate32_done;
  p.update32.wait_on = gate32_done;
  p.update32.wait_full = p.update32.wait_last = p.gate32.tiles_x * p.gate32.ncol;
  p.update32.signal = update32_done;
  u.wait_on = update32_done;
  u.src_tiles_y = p.update32.tiles_y;
  u.wait_full = p.update32.tiles_x * p.update32.ncol;
  u.signal = up_done;
  p.gate16.wait_on = up_done;
  p.gate16.wait_full = p.gate16.wait_last = u.tiles_x;
  p.gate16.wait_map = p.gate16.map_w - 1;  // up, the last part: h16 and x0p load at once
  p.gate16.signal = gate16_done;
  p.update16.wait_on = gate16_done;
  p.update16.wait_full = p.update16.wait_last = p.gate16.tiles_x * p.gate16.ncol;
  UpsampleStage& u8 = p.up08;  // stays empty (0 patches) without up08
  if (up08 != nullptr) {
    u8 = UpsampleStage{h16_out, up08, H16, W16, H08, W08, ch, yi08, yw08, xi08, xw08};
    u8.tiles_x = (W08 + loop::kTW - 1) / loop::kTW;
    u8.tiles_y = (H08 + loop::kTH - 1) / loop::kTH;
    u8.patches = B * u8.tiles_x * u8.tiles_y;
    p.update16.signal = update16_done;
    u8.wait_on = update16_done;
    u8.src_tiles_y = p.update16.tiles_y;
    u8.wait_full = p.update16.tiles_x * p.update16.ncol;
  }
  const int tiles[6] = {loop::tiles_of(p.gate32), loop::tiles_of(p.update32), u.patches,
                        loop::tiles_of(p.gate16), loop::tiles_of(p.update16), u8.patches};
  int most = 0;
  for (int t : tiles) most = t > most ? t : most;
  void (*kernel)(Gru1632Params<Q>) = &gru1632_kernel<Q>;
  int grid = 0;
  if ((err = loop::loop_grid(kernel, most, &grid))) return err;
  // Where each stage's tile 0 runs: the gru32 update after the gru32 gates'
  // blocks, the upsample from block 0 again (its tiles wait on gru32
  // anyway), the gru16 gates after the upsample's blocks (their h16 and x0p
  // chunks run while gru32 computes), the gru16 update after those, and
  // stage 6 after the gru16 update's blocks (those with the fewest tiles of
  // it start first).
  p.update32.first = tiles[0] % grid;
  p.gate16.first = tiles[2] % grid;
  p.update16.first = (tiles[2] + tiles[3]) % grid;
  u8.first = (tiles[2] + tiles[3] + tiles[4]) % grid;
  return launch_persistent(kernel, p, bar, gru1632_counters(B, H16, H32), grid,
                           loop::kSmemBytes, loop::kThreads, stream);
}

}  // namespace rst

using rst::bf16;

// h16: [B][H16][W16][ch], h32: [B][H32][W32][ch]; czrq16/32: [..][3ch], bf16,
// or int8 with lane8 != 0 and s16/s32: [B] fp32 scales; x0p: pool2x of the
// gru08 state, [B][H16][W16][cx0]; x1p: pool2x(h16), [B][H32][W32][ch].
// Weights K-major (output channel, then input channel): wg16: [9][3ch][ch +
// cx0 + ch] over [h16; x0p; up], wq16: [9][ch][ch]; wg32: [9][3ch][2ch] over
// [h32; x1p], wq32: [9][ch][ch]. yi/yw: [H16][2] source rows and weights of
// the upsample, xi/xw: [W16][2] columns. up08: null, or gru08's x2 input,
// [B][H08][W08][ch], built by stage 6 with yi08/yw08: [H08][2] and xi08/xw08:
// [W08][2] (H08, W08 and those ignored when null). z*/rh*/aqx*: scratch of
// each level's shape, up: [B][H16][W16][ch] scratch; bar:
// rst_gru1632_counters(B, H16, H32) counters, zeroed here. ch and cx0 are
// multiples of 32. Returns the first non-zero cudaError_t.
extern "C" int rst_gru1632(const bf16* h16, const bf16* h32, const void* czrq16,
                           const void* czrq32, int lane8, const float* s16, const float* s32,
                           const bf16* x0p, int cx0, const bf16* x1p, int B, int H16, int W16,
                           int H32, int W32, int ch, const bf16* wg16, const bf16* wq16,
                           const bf16* wg32, const bf16* wq32, const int* yi, const float* yw,
                           const int* xi, const float* xw, int H08, int W08, const int* yi08,
                           const float* yw08, const int* xi08, const float* xw08, bf16* z16,
                           bf16* rh16, float* aqx16, bf16* z32, bf16* rh32, float* aqx32,
                           bf16* up, bf16* up08, bf16* h16_out, bf16* h32_out, unsigned int* bar,
                           cudaStream_t stream) {
  if (lane8 && (s16 == nullptr || s32 == nullptr)) return (int)cudaErrorInvalidValue;
  if (up08 != nullptr && (H08 < 1 || W08 < 1 || yi08 == nullptr || yw08 == nullptr ||
                          xi08 == nullptr || xw08 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (lane8)
    return rst::launch_gru1632<int8_t>(h16, h32, czrq16, czrq32, s16, s32, x0p, cx0, x1p, B, H16,
                                       W16, H32, W32, ch, wg16, wq16, wg32, wq32, yi, yw, xi, xw,
                                       H08, W08, yi08, yw08, xi08, xw08, z16, rh16, aqx16, z32,
                                       rh32, aqx32, up, up08, h16_out, h32_out, bar, stream);
  return rst::launch_gru1632<bf16>(h16, h32, czrq16, czrq32, s16, s32, x0p, cx0, x1p, B, H16, W16,
                                   H32, W32, ch, wg16, wq16, wg32, wq32, yi, yw, xi, xw, H08, W08,
                                   yi08, yw08, xi08, xw08, z16, rh16, aqx16, z32, rh32, aqx32, up,
                                   up08, h16_out, h32_out, bar, stream);
}

// The counters rst_gru1632 needs at bar.
extern "C" int rst_gru1632_counters(int B, int H16, int H32) {
  return rst::gru1632_counters(B, H16, H32);
}

// The gru16+32 kernel's block on this card (lane8: its int8-czrq
// instantiation): plan[0] its dynamic shared memory in bytes, plan[1] its
// threads, plan[2] its blocks an SM. Returns 0 or a cudaError_t.
extern "C" int rst_gru1632_plan(int lane8, int* plan) {
  void (*bf16_kernel)(rst::Gru1632Params<bf16>) = &rst::gru1632_kernel<bf16>;
  void (*int8_kernel)(rst::Gru1632Params<int8_t>) = &rst::gru1632_kernel<int8_t>;
  const void* kernel = lane8 ? reinterpret_cast<const void*>(int8_kernel)
                             : reinterpret_cast<const void*>(bf16_kernel);
  plan[0] = rst::loop::kSmemBytes;
  plan[1] = rst::loop::kThreads;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, rst::loop::kSmemBytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[2], kernel, plan[1], plan[0]);
}
