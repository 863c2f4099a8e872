// The stages of the refinement loop's kernels on the conv engine: the
// epilogue of each stage and the engine input (ConvIn) it runs on.
//
// Shared by the serial kernels (conv_gru.cu, motion.cu: one launch per
// stage) and the persistent ones (gru1632.cu, resident.cu: every stage in
// one launch). A stage of a persistent kernel is the serial launch's stage
// built by the same function here, so the two routes cannot drift apart.
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

#include "conv3x3.cuh"

namespace rst {

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
  __device__ float context(int p, int n) const {
    const Q c = czrq[(size_t)p * 3 * ch + n];
    if constexpr (std::is_same_v<Q, int8_t>) {
      return __fmul_rn((float)c, scale[p / sample_pixels]);
    } else {
      return __bfloat162float(c);
    }
  }
  __device__ void operator()(int p, int n, float acc) const {
    if (n >= 3 * ch) return;
    const size_t base = (size_t)p * ch;
    const float v = acc + context(p, n);
    if (n < ch) {
      z[base + n] = __float2bfloat16(1.0f / (1.0f + expf(-v)));
    } else if (n < 2 * ch) {
      const int c = n - ch;
      const float r = bf16r(1.0f / (1.0f + expf(-v)));
      rh[base + c] = __float2bfloat16(r * __bfloat162float(h[base + c]));
    } else {
      aqx[base + n - 2 * ch] = v;
    }
  }
};

struct UpdateEpi {
  const float* aqx;
  const bf16* z;
  const bf16* h;
  bf16* out;
  int ch;
  __device__ void operator()(int p, int n, float acc) const {
    if (n >= ch) return;
    const size_t i = (size_t)p * ch + n;
    const float q = bf16r(tanhf(acc + aqx[i]));
    const float zz = __bfloat162float(z[i]);
    const float keep = bf16r(bf16r(1.0f - zz) * __bfloat162float(h[i]));
    const float take = bf16r(zz * q);
    out[i] = __float2bfloat16(keep + take);
  }
};

// relu(acc + bias) rounded to bf16: the head's conv1 and motion stage 2.
struct ReluBiasEpi {
  const float* bias;
  bf16* out;
  int n_out;
  __device__ void operator()(int p, int n, float acc) const {
    if (n < n_out) out[(size_t)p * n_out + n] = __float2bfloat16(fmaxf(acc + bias[n], 0.0f));
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
  __device__ void operator()(int p, int n, float acc) const {
    const int cout = cf + 2;
    if (n < cf)
      out[(size_t)p * cout + n] = __float2bfloat16(fmaxf(acc + bias[n], 0.0f));
    else if (n < cout)
      out[(size_t)p * cout + n] = flow[(size_t)p * 2 + n - cf];
  }
};

inline ConvIn conv_in(int B, int H, int W) {
  ConvIn a{};
  a.B = B;
  a.H = H;
  a.W = W;
  return a;
}

inline void add_part(ConvIn& a, const bf16* p, int c) {
  a.ptr[a.nparts] = p;
  a.cin[a.nparts] = c;
  ++a.nparts;
}

// One input part over all its channels, into `cols` output channels.
inline ConvIn single_in(const bf16* x, int c, int B, int H, int W, const bf16* w, int cols) {
  ConvIn a = conv_in(B, H, W);
  add_part(a, x, c);
  a.w = w;
  a.ctot = c;
  a.npad = cols;
  a.n_split = cols;
  a.k0a = a.k0b = 0;
  a.k1a = a.k1b = c;
  return a;
}

// GRU gates over [h; x parts]: z and r read every channel, the q columns
// (from 2ch on) only the x parts. nx x parts of cxs channels (0 skips one).
// w_gate: [9][ch + cx][pad64(3ch)].
inline ConvIn gru_gate_in(const bf16* h, const bf16* const* xs, const int* cxs, int nx, int B,
                          int H, int W, int ch, const bf16* w_gate) {
  ConvIn a = conv_in(B, H, W);
  add_part(a, h, ch);
  int cx = 0;
  for (int i = 0; i < nx; ++i) {
    if (cxs[i] > 0) {
      add_part(a, xs[i], cxs[i]);
      cx += cxs[i];
    }
  }
  a.w = w_gate;
  a.ctot = ch + cx;
  a.npad = pad64(3 * ch);
  a.n_split = 2 * ch;
  a.k0a = 0;
  a.k1a = ch + cx;
  a.k0b = ch;
  a.k1b = ch + cx;
  return a;
}

// GRU update: q's h-side conv over r*h. w_q: [9][ch][pad64(ch)].
inline ConvIn gru_update_in(const bf16* rh, int B, int H, int W, int ch, const bf16* w_q) {
  return single_in(rh, ch, B, H, W, w_q, pad64(ch));
}

// FlowHead conv1 over h'. w1: [9][ch][pad64(nh)].
inline ConvIn head1_in(const bf16* h, int B, int H, int W, int ch, const bf16* w1, int nh) {
  return single_in(h, ch, B, H, W, w1, pad64(nh));
}

// FlowHead conv2 over f1, x output in column 0. w2: [9][nh][16].
inline ConvIn head2_in(const bf16* f1, int B, int H, int W, int nh, const bf16* w2) {
  return single_in(f1, nh, B, H, W, w2, 16);
}

// Motion stage 2: block-diagonal over [c1|f1]; the c2 columns read the
// first n1 channels, the f2 columns the rest. w2: [9][ns][pad64(ns)].
inline ConvIn motion_s2_in(const bf16* s1, int B, int H, int W, int n1, int nf, const bf16* w2) {
  const int ns = n1 + nf;
  ConvIn a = single_in(s1, ns, B, H, W, w2, pad64(ns));
  a.n_split = n1;
  a.k1a = n1;
  a.k0b = n1;
  return a;
}

// Motion fusion conv over [c2|f2]. wf: [9][ns][pad64(cf + 2)].
inline ConvIn motion_fusion_in(const bf16* s2, int B, int H, int W, int ns, int cf,
                               const bf16* wf) {
  return single_in(s2, ns, B, H, W, wf, pad64(cf + 2));
}

}  // namespace rst
