// The two coarse ConvGRU steps, gru32 then gru16, in one launch.
//
// Replaces raft_stereo_tpu/ops/pallas_stream.py:_gru1632_kernel (driven by
// fused_gru1632_fwd_impl). It computes what the serial route does with two
// conv_gru.cu launches and the aligned-corners resize between them:
//   h32' = gru32(h32, czrq32, pool2x(h16))
//   up   = interp_align_corners(h32', (H16, W16))
//   h16' = gru16(h16, czrq16, pool2x(h08), up)
// and gives the same bits (the pools stay outside, as in the JAX package).
//
// What bounds it on an H100: tensor-core operations, about 1.2 M MAC a
// gru16 pixel and a quarter as many a gru32 one at 128 channels (~23 us of
// bf16 peak at 48x156 + 24x78), against ~5 MB of inputs and outputs. At
// these sizes the serial route is latency-bound instead: eight engine
// launches and two resize contractions an iteration, each with a ramp and
// a tail on an SM count the small maps barely fill.
//
// Design: the TPU kernel runs gru16 one row block behind gru32 on its
// sequential grid and builds gru16's upsampled x part in VMEM. Here one
// cooperative launch, at most as many blocks as the card holds at once,
// runs the four engine stages (gru32 gates, gru32 update, gru16 gates,
// gru16 update) as grid-stride loops over the serial launches' tiles, with
// a grid barrier between stages (grid.cuh). The gru16 gate stage builds the
// up channels while loading its A tiles, from four h32' values per output
// (UpsampleSrc), so the upsampled tensor is never written; each of its
// values is built once for each of the 9 taps that read it, which makes
// that stage slower than the serial gru16 gates and the resize together.
// The gate and update intermediates still go through device memory
// (L2-resident at these sizes); keeping them on chip is later work. At 128
// registers two blocks fit an SM; capping them at 80 for three spills.
#include "grid.cuh"
#include "stages.cuh"

namespace rst {

// The aligned-corners upsample of an NHWC map as a computed A-tile part.
// Per output row y the two source rows yi[2y], yi[2y+1] and their weights
// yw[2y], yw[2y+1] (per column likewise) are the nonzeros of the resize's
// lerp matrices, already rounded to bf16 (ops/resize.py:lerp_taps). As the
// two contractions do: the H lerp in fp32, rounded to bf16, then the W lerp
// in fp32, rounded to bf16. Each lerp sums two products of bf16 values,
// which fp32 holds exactly, so its one rounding is the contraction's.
struct UpsampleSrc {
  static constexpr bool kComputed = true;
  int part;
  const bf16* src;  // [B][Hs][Ws][C]
  int Hs, Ws, C;
  const int* yi;
  const float* yw;
  const int* xi;
  const float* xw;

  __device__ void load8(bf16* dst, int img, int y, int x, int c) const {
    const int y0 = yi[2 * y], y1 = yi[2 * y + 1];
    const int x0 = xi[2 * x], x1 = xi[2 * x + 1];
    const float wy0 = yw[2 * y], wy1 = yw[2 * y + 1];
    const float wx0 = xw[2 * x], wx1 = xw[2 * x + 1];
    const bf16* base = src + (size_t)img * Hs * Ws * C + c;
    const uint4 q00 = *reinterpret_cast<const uint4*>(base + ((size_t)y0 * Ws + x0) * C);
    const uint4 q10 = *reinterpret_cast<const uint4*>(base + ((size_t)y1 * Ws + x0) * C);
    const uint4 q01 = *reinterpret_cast<const uint4*>(base + ((size_t)y0 * Ws + x1) * C);
    const uint4 q11 = *reinterpret_cast<const uint4*>(base + ((size_t)y1 * Ws + x1) * C);
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
    *reinterpret_cast<uint4*>(dst) = out;
  }
};

// Q: czrq's element type, bf16 or int8 (RAFT_LANE_PACK8, replacing
// _gru1632_lane8_kernel): one instantiation each.
template <typename Q>
struct Gru1632Params {
  ConvIn gate32, update32, gate16, update16;
  GateEpi<Q> gate32_epi, gate16_epi;
  UpdateEpi update32_epi, update16_epi;
  UpsampleSrc up;
  unsigned int* bar;
};

template <typename Q>
__global__ void __launch_bounds__(THREADS, 2) gru1632_kernel(Gru1632Params<Q> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  GridBarrier grid{p.bar};
  conv3x3_stage<64>(p.gate32, p.gate32_epi, smem, p.bar + 1);
  grid.sync();
  conv3x3_stage<64>(p.update32, p.update32_epi, smem, p.bar + 2);
  grid.sync();
  conv3x3_stage<64>(p.gate16, p.gate16_epi, smem, p.bar + 3, p.up);
  grid.sync();
  conv3x3_stage<64>(p.update16, p.update16_epi, smem, p.bar + 4);
}

template <typename Q>
int launch_gru1632(const bf16* h16, const bf16* h32, const void* czrq16, const void* czrq32,
                   const float* s16, const float* s32, const bf16* x0p, int cx0, const bf16* x1p,
                   int B, int H16, int W16, int H32, int W32, int ch, const bf16* wg16,
                   const bf16* wq16, const bf16* wg32, const bf16* wq32, const int* yi,
                   const float* yw, const int* xi, const float* xw, bf16* z16, bf16* rh16,
                   float* aqx16, bf16* z32, bf16* rh32, float* aqx32, bf16* h16_out,
                   bf16* h32_out, unsigned int* bar, cudaStream_t stream) {
  Gru1632Params<Q> p{};
  const bf16* xs32[1] = {x1p};
  const int cxs32[1] = {ch};
  p.gate32 = gru_gate_in(h32, xs32, cxs32, 1, B, H32, W32, ch, wg32);
  p.gate32_epi = GateEpi<Q>{static_cast<const Q*>(czrq32), s32, H32 * W32, h32, z32, rh32, aqx32,
                            ch};
  p.update32 = gru_update_in(rh32, B, H32, W32, ch, wq32);
  p.update32_epi = UpdateEpi{aqx32, z32, h32, h32_out, ch};
  const bf16* xs16[2] = {x0p, h32_out};
  const int cxs16[2] = {cx0, ch};
  p.gate16 = gru_gate_in(h16, xs16, cxs16, 2, B, H16, W16, ch, wg16);
  p.gate16_epi = GateEpi<Q>{static_cast<const Q*>(czrq16), s16, H16 * W16, h16, z16, rh16, aqx16,
                            ch};
  p.update16 = gru_update_in(rh16, B, H16, W16, ch, wq16);
  p.update16_epi = UpdateEpi{aqx16, z16, h16, h16_out, ch};
  p.up = UpsampleSrc{p.gate16.nparts - 1, h32_out, H32, W32, ch, yi, yw, xi, xw};
  p.bar = bar;
  const ConvIn* stages[4] = {&p.gate32, &p.update32, &p.gate16, &p.update16};
  int tiles = 0;
  for (const ConvIn* a : stages) {
    const int t = conv3x3_tiles(*a, 64);
    if (t > tiles) tiles = t;
  }
  return launch_persistent(gru1632_kernel<Q>, p, bar, tiles, TileSmem<64>::BYTES, THREADS,
                           stream);
}

}  // namespace rst

using rst::bf16;

// h16: [B][H16][W16][ch], h32: [B][H32][W32][ch] with H16 = 2 H32 and
// W16 = 2 W32; czrq16/32: [..][3ch], bf16, or int8 with lane8 != 0 and
// s16/s32: [B] fp32 scales; x0p: pool2x of the gru08 state,
// [B][H16][W16][cx0]; x1p: pool2x(h16), [B][H32][W32][ch]. wg16:
// [9][ch + cx0 + ch][pad64(3ch)] over [h16; x0p; up], wq16: [9][ch][pad64(ch)];
// wg32: [9][2ch][pad64(3ch)], wq32 likewise. yi/yw: [H16][2] source rows and
// weights of the upsample, xi/xw: [W16][2] columns. z*/rh*/aqx*: scratch
// of each level's shape; bar: rst::kCounters counters. Returns the first
// non-zero cudaError_t.
extern "C" int rst_gru1632(const bf16* h16, const bf16* h32, const void* czrq16,
                           const void* czrq32, int lane8, const float* s16, const float* s32,
                           const bf16* x0p, int cx0, const bf16* x1p, int B,
                           int H16, int W16, int H32, int W32, int ch, const bf16* wg16,
                           const bf16* wq16, const bf16* wg32, const bf16* wq32, const int* yi,
                           const float* yw, const int* xi, const float* xw, bf16* z16,
                           bf16* rh16, float* aqx16, bf16* z32, bf16* rh32, float* aqx32,
                           bf16* h16_out, bf16* h32_out, unsigned int* bar,
                           cudaStream_t stream) {
  if (lane8 && (s16 == nullptr || s32 == nullptr)) return (int)cudaErrorInvalidValue;
  if (lane8)
    return rst::launch_gru1632<int8_t>(h16, h32, czrq16, czrq32, s16, s32, x0p, cx0, x1p, B, H16,
                                       W16, H32, W32, ch, wg16, wq16, wg32, wq32, yi, yw, xi, xw,
                                       z16, rh16, aqx16, z32, rh32, aqx32, h16_out, h32_out, bar,
                                       stream);
  return rst::launch_gru1632<bf16>(h16, h32, czrq16, czrq32, s16, s32, x0p, cx0, x1p, B, H16, W16,
                                   H32, W32, ch, wg16, wq16, wg32, wq32, yi, yw, xi, xw, z16,
                                   rh16, aqx16, z32, rh32, aqx32, h16_out, h32_out, bar, stream);
}
