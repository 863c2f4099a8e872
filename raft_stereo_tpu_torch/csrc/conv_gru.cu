// ConvGRU step, optionally with the FlowHead chained on the new state.
//
// Replaces raft_stereo_tpu/ops/pallas_stream.py:_gru_kernel (driven by
// _gru_pallas / fused_conv_gru_fwd_impl), with its rounding points:
//   acc  = conv3x3([h; x parts], [wz | wr]) + czrq[:2ch]         (fp32)
//   z    = bf16(sigmoid(acc_z)),  r = bf16(sigmoid(acc_r)),  rh = bf16(r * h)
//   aqx  = conv3x3(x parts, wq[x rows]) + czrq[2ch:]               (fp32)
//   q    = bf16(tanh(conv3x3(rh, wq[h rows]) + aqx))
//   h'   = (1 - z) * h + z * q                                     (bf16 ops)
// and with the head:
//   f1   = bf16(relu(conv3x3(h', w1) + b1))
//   dx   = conv3x3(f1, w2[..., :1])                                (fp32, no conv2.b[0])
// czrq is the context with the gate biases folded in, rounded once to bf16
// (prepare_gru_context). h' and f1 are zero outside the image: conv zero
// padding.
//
// What bounds it on an H100: tensor-core operations. gru08 with the head is
// about 1.62 M MAC per pixel (97 GFLOP at 96x312), against a few MB of
// activations, far above the card's ~295 FLOP/byte balance point.
//
// Design: the TPU kernel streams row blocks through VMEM ring windows on a
// sequential grid so each intermediate row is computed once. Here blocks run
// in parallel, and each stage is one launch of the shared implicit-GEMM
// engine (conv3x3.cuh) over the whole map: gates, update, head conv1, head
// conv2. The intermediates z, rh (bf16, ch channels), aqx (fp32, ch
// channels) and, with the head, f1 (bf16, 256 channels) go through device
// memory between the stages instead of staying on chip; keeping them in
// shared memory with halo recompute is later work.
#include "conv3x3.cuh"

namespace rst {

struct GateEpi {
  const bf16* czrq;  // [P][3ch]
  const bf16* h;     // [P][ch]
  bf16* z;           // [P][ch]
  bf16* rh;          // [P][ch]
  float* aqx;        // [P][ch]
  int ch;
  __device__ void operator()(int p, int n, float acc) const {
    if (n >= 3 * ch) return;
    const size_t base = (size_t)p * ch;
    const float v = acc + __bfloat162float(czrq[(size_t)p * 3 * ch + n]);
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

struct ReluBiasEpi {
  const float* bias;
  bf16* out;
  int n_out;
  __device__ void operator()(int p, int n, float acc) const {
    if (n >= n_out) return;
    out[(size_t)p * n_out + n] = __float2bfloat16(fmaxf(acc + bias[n], 0.0f));
  }
};

struct FirstChannelEpi {
  float* out;
  __device__ void operator()(int p, int n, float acc) const {
    if (n == 0) out[p] = acc;
  }
};

}  // namespace rst

using rst::bf16;

// x parts: up to three NHWC tensors of cx0/cx1/cx2 channels (0 = absent).
// Weight output columns are zero-padded to a multiple of 64 (pad64):
// w_gate: [9][ch + cx][pad64(3ch)]; w_q: [9][ch][pad64(ch)]. With the head
// (f1 != null): w1: [9][ch][pad64(nh)], b1: [nh] fp32, w2: [9][nh][16]
// (column 0 used), dx: [P]. ch, cx0..cx2 and nh are multiples of 32.
// Returns the first non-zero cudaError_t of the chain's launches.
extern "C" int rst_conv_gru(const bf16* h, const bf16* czrq, const bf16* x0, int cx0,
                            const bf16* x1, int cx1, const bf16* x2, int cx2, int B, int H,
                            int W, int ch, const bf16* w_gate, const bf16* w_q, bf16* z,
                            bf16* rh, float* aqx, bf16* h_out, const bf16* w1, const float* b1,
                            const bf16* w2, int nh, bf16* f1, float* dx, cudaStream_t stream) {
  const int cx = cx0 + cx1 + cx2;
  rst::ConvIn a{};
  a.ptr[0] = h;
  a.cin[0] = ch;
  a.nparts = 1;
  const bf16* xs[3] = {x0, x1, x2};
  const int cxs[3] = {cx0, cx1, cx2};
  for (int i = 0; i < 3; ++i) {
    if (cxs[i] > 0) {
      a.ptr[a.nparts] = xs[i];
      a.cin[a.nparts] = cxs[i];
      ++a.nparts;
    }
  }
  a.B = B;
  a.H = H;
  a.W = W;
  a.w = w_gate;
  a.ctot = ch + cx;
  a.npad = rst::pad64(3 * ch);
  a.n_split = 2 * ch;
  a.k0a = 0;
  a.k1a = ch + cx;
  a.k0b = ch;
  a.k1b = ch + cx;
  int err = rst::launch_conv3x3<64>(a, rst::GateEpi{czrq, h, z, rh, aqx, ch}, stream);
  if (err) return err;

  rst::ConvIn b{};
  b.ptr[0] = rh;
  b.cin[0] = ch;
  b.nparts = 1;
  b.B = B;
  b.H = H;
  b.W = W;
  b.w = w_q;
  b.ctot = ch;
  b.npad = rst::pad64(ch);
  b.n_split = ch;
  b.k0a = 0;
  b.k1a = ch;
  b.k0b = 0;
  b.k1b = ch;
  err = rst::launch_conv3x3<64>(b, rst::UpdateEpi{aqx, z, h, h_out, ch}, stream);
  if (err || f1 == nullptr) return err;

  rst::ConvIn c = b;
  c.ptr[0] = h_out;
  c.w = w1;
  c.npad = rst::pad64(nh);
  c.n_split = nh;
  err = rst::launch_conv3x3<64>(c, rst::ReluBiasEpi{b1, f1, nh}, stream);
  if (err) return err;

  rst::ConvIn d{};
  d.ptr[0] = f1;
  d.cin[0] = nh;
  d.nparts = 1;
  d.B = B;
  d.H = H;
  d.W = W;
  d.w = w2;
  d.ctot = nh;
  d.npad = 16;
  d.n_split = 16;
  d.k0a = 0;
  d.k1a = nh;
  d.k0b = 0;
  d.k1b = nh;
  return rst::launch_conv3x3<16>(d, rst::FirstChannelEpi{dx}, stream);
}
