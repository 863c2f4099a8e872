// The stages of the refinement loop's kernels: the epilogue of each stage
// and the loop engine's input it runs on (loop_conv_sm90.cuh: TMA halo
// patches, wgmma), for the serial launches (conv_gru.cu with and without the
// head, motion.cu) and the persistent kernels (resident.cu, gru1632.cu). A
// stage of a persistent kernel is the serial launch's stage built by the
// same function here, so the two routes cannot drift apart.
//
// ConvGRU step (raft_stereo_tpu/ops/pallas_stream.py:_gru_kernel), with
// its rounding points (czrq: bf16, or int8 q times the sample's scale):
//   acc  = conv3x3([h; x parts], [wz | wr]) + czrq[:2ch]         (fp32)
//   z    = bf16(sigmoid(acc_z)),  r = bf16(sigmoid(acc_r)),  rh = bf16(r * h)
//   aqx  = conv3x3(x parts, wq[x rows]) + czrq[2ch:]               (fp32)
//   q    = bf16(tanh(conv3x3(rh, wq[h rows]) + aqx))
//   h'   = (1 - z) * h + z * q                                     (bf16 ops)
// FlowHead chained on h':
//   f1   = bf16(relu(conv3x3(h', w1) + b1))
//   dx   = conv3x3(f1, w2[..., :1])                                (fp32, no conv2.b[0])
// Motion encoder stages 2-3 (pallas_stream.py:_motion_kernel):
//   [c2|f2] = bf16(relu(blockdiag conv3x3([c1|f1]) + [bc2|bf2]))
//   out[..., :cf] = bf16(relu(conv3x3([c2|f2], conv.w) + conv.b)), out[..., cf:] = flow
// No epilogue multiplies into a sum, so no contraction into a fused
// multiply-add can move a rounding; the sources are built with
// -fmad=false besides.
#pragma once

#include <cstdint>
#include <type_traits>

#include "loop_conv_sm90.cuh"

namespace rst {

// 8 bf16 at a 16-byte aligned address, to fp32 and back (round to nearest,
// as __float2bfloat16).
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(b[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Each epilogue takes columns n .. n + 7 of a pixel at once (put8: n a
// multiple of 8, the output rows 16-byte aligned), the FlowHead's one-column
// conv its column alone (operator()); each value is computed by one function,
// which holds its rounding points.

// The gate stage's epilogue. Q is czrq's element type: bf16, or int8 under
// RAFT_LANE_PACK8 (pallas_stream.py:_gru_lane8_kernel), where the context is
// q * scale[sample] in fp32, the product rounded before the add.
template <typename Q>
struct GateEpi {
  const Q* czrq;       // [P][3ch]
  const float* scale;  // [B], int8 czrq only
  int sample_pixels;   // H * W: p / sample_pixels is the sample
  const bf16* h;       // [P][ch]
  bf16* z;             // [P][ch]
  bf16* rh;            // [P][ch]
  float* aqx;          // [P][ch]
  int ch;
  // v = acc + context: z, and r times h (each then rounded once to bf16).
  static __device__ float z_of(float v) { return 1.0f / (1.0f + expf(-v)); }
  static __device__ float rh_of(float v, float hv) { return bf16r(z_of(v)) * hv; }
  __device__ void put8(int p, int n, const float (&acc)[8]) const {
    if (n >= 3 * ch) return;
    float v[8];
    if constexpr (std::is_same_v<Q, int8_t>) {
      const uint2 u = *reinterpret_cast<const uint2*>(czrq + (size_t)p * 3 * ch + n);
      const int8_t* q = reinterpret_cast<const int8_t*>(&u);
      const float sc = scale[p / sample_pixels];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn((float)q[e], sc);
    } else {
      load8(czrq + (size_t)p * 3 * ch + n, v);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = acc[e] + v[e];
    const size_t base = (size_t)p * ch;
    if (n < ch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = z_of(v[e]);
      store8(z + base + n, v);
    } else if (n < 2 * ch) {
      float hv[8];
      load8(h + base + n - ch, hv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rh_of(v[e], hv[e]);
      store8(rh + base + n - ch, v);
    } else {
      store8(aqx + base + n - 2 * ch, v);
    }
  }
};

struct UpdateEpi {
  const float* aqx;
  const bf16* z;
  const bf16* h;
  bf16* out;
  int ch;
  // h' before its rounding to bf16, from the accumulator and aqx, z, h.
  static __device__ float h_of(float acc, float a, float zz, float hv) {
    const float q = bf16r(tanhf(acc + a));
    const float keep = bf16r(bf16r(1.0f - zz) * hv);
    const float take = bf16r(zz * q);
    return keep + take;
  }
  __device__ void put8(int p, int n, const float (&acc)[8]) const {
    if (n >= ch) return;
    const size_t i = (size_t)p * ch + n;
    float a[8], zz[8], hh[8], o[8];
    load8(aqx + i, a);
    load8(z + i, zz);
    load8(h + i, hh);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = h_of(acc[e], a[e], zz[e], hh[e]);
    store8(out + i, o);
  }
};

// relu(acc + bias), before its rounding to bf16.
__device__ __forceinline__ float relu_bias(float acc, float b) { return fmaxf(acc + b, 0.0f); }

// relu(acc + bias) rounded to bf16: the head's conv1 and motion stage 2.
struct ReluBiasEpi {
  const float* bias;
  bf16* out;
  int n_out;
  __device__ void put8(int p, int n, const float (&acc)[8]) const {
    if (n >= n_out) return;
    float b[8];
    load8(bias + n, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = relu_bias(acc[e], b[e]);
    store8(out + (size_t)p * n_out + n, b);
  }
};

struct FirstChannelEpi {
  float* out;
  __device__ void operator()(int p, int n, float acc) const {
    if (n == 0) out[p] = acc;
  }
};

struct FusionEpi {
  const float* bias;
  const bf16* flow;  // [P][2]
  bf16* out;         // [P][cf + 2]
  int cf;
  __device__ void put1(int p, int n, float acc) const {
    const int cout = cf + 2;
    if (n < cf)
      out[(size_t)p * cout + n] = __float2bfloat16(relu_bias(acc, bias[n]));
    else if (n < cout)
      out[(size_t)p * cout + n] = flow[(size_t)p * 2 + n - cf];
  }
  // A group across the flow columns, or rows off 16 bytes, go value by value.
  __device__ void put8(int p, int n, const float (&acc)[8]) const {
    if (n + 8 > cf || (cf + 2) % 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) put1(p, n + e, acc[e]);
      return;
    }
    float b[8];
    load8(bias + n, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = relu_bias(acc[e], b[e]);
    store8(out + (size_t)p * (cf + 2) + n, b);
  }
};

// -- the stages' engine inputs --------------------------------------------------
// Weights K-major: [9][rows][K], K the input channels of the virtual concat.
// Each function here encodes its tensor maps into maps[*nmaps...] and returns 0 or
// a cudaError_t; the column tile width is the widest of 128 and 64 on which
// the stage's column split falls.

// That width for a stage of `cols` columns over a B x H x W map. Given the
// card's SM count `sms` (the head-less GRU steps: gru16 and gru32, in their
// serial launches and in the gru16+32 kernel alike), 64 also where the
// stage's 128-column tiles would number fewer than two an SM: at the coarse
// maps a stage's latency is its cost, and a tile of 64 columns takes about
// half as long.
inline int tile_cols(int split, int cols = 0, int B = 0, int H = 0, int W = 0, int sms = 0) {
  if (split % 128) return 64;
  const int patches = B * ((H + loop::kTH - 1) / loop::kTH) * ((W + loop::kTW - 1) / loop::kTW);
  return patches * ((cols + 127) / 128) < 2 * sms ? 64 : 128;
}

// GRU gates over [h; x parts]: z and r (columns [0, 2ch)) read every
// channel, q (from 2ch on) only the x parts. w_gate: [9][3ch][ch + cx].
// sms: as tile_cols'.
inline int gate_loop(loop::LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* h,
                     const bf16* const* xs, const int* cxs, int nx, int B, int H, int W, int ch,
                     const bf16* w_gate, int* n, int sms = 0) {
  loop::Part parts[loop::kParts];
  int np = 0, ctot = ch;
  parts[np++] = {h, ch};
  for (int i = 0; i < nx; ++i) {
    if (cxs[i] <= 0) continue;
    if (np == loop::kParts) return (int)cudaErrorInvalidValue;
    parts[np++] = {xs[i], cxs[i]};
    ctot += cxs[i];
  }
  *n = tile_cols(2 * ch, 3 * ch, B, H, W, sms);
  return loop::loop_conv(c, maps, nmaps, parts, np, B, H, W, w_gate, 3 * ch, 3 * ch, *n, 2 * ch,
                         0, ctot, ch, ctot);
}

// GRU update: q's h-side conv over r*h. w_q: [9][ch][ch]. sms: as tile_cols'.
inline int update_loop(loop::LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* rh, int B,
                       int H, int W, int ch, const bf16* w_q, int* n, int sms = 0) {
  *n = tile_cols(ch, ch, B, H, W, sms);
  return loop::loop_conv1(c, maps, nmaps, rh, ch, B, H, W, w_q, ch, ch, *n);
}

// FlowHead conv1 over h'. w1: [9][nh][ch].
inline int head1_loop(loop::LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* h, int B,
                      int H, int W, int ch, const bf16* w1, int nh, int* n) {
  *n = tile_cols(nh);
  return loop::loop_conv1(c, maps, nmaps, h, ch, B, H, W, w1, nh, nh, *n);
}

// FlowHead conv2 over f1, its x output alone: w2: [9][1][nh], 8 columns.
inline int head2_loop(loop::LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* f1, int B,
                      int H, int W, int nh, const bf16* w2) {
  return loop::loop_conv1(c, maps, nmaps, f1, nh, B, H, W, w2, 1, 1, 8);
}

// Motion stage 2, block-diagonal over [c1|f1]: the c2 columns read the
// first n1 channels, the f2 columns the rest, in tiles of 64. w2: [9][ns][ns].
inline int motion_s2_loop(loop::LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* s1,
                          int B, int H, int W, int n1, int nf, const bf16* w2) {
  const loop::Part part{s1, n1 + nf};
  const int ns = n1 + nf;
  return loop::loop_conv(c, maps, nmaps, &part, 1, B, H, W, w2, ns, ns, 64, n1, 0, n1, n1, ns);
}

// Motion fusion conv over [c2|f2] into [cf fused | 2 flow] columns (the
// flow columns are FusionEpi's). wf: [9][cf][ns].
inline int motion_fusion_loop(loop::LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* s2,
                              int B, int H, int W, int ns, int cf, const bf16* wf, int* n) {
  *n = cf + 2 > 64 ? 128 : 64;
  return loop::loop_conv1(c, maps, nmaps, s2, ns, B, H, W, wf, cf, cf + 2, *n);
}

}  // namespace rst
