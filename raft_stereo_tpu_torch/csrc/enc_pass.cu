// One 3x3 pad-1 convolution of the fused encoders, with the transform of its
// input built while the input is loaded and, for instance norm, the
// statistics of its output taken on the way out.
//
// Replaces raft_stereo_tpu/ops/pallas_encoder.py:_pass_kernel (driven by
// _run_pass). On one (H, W, C) bf16 map, B = 1, with `t` the transform of a
// raw conv output under instance norm, t(x) = bf16(relu((x - mean) * inv))
// in fp32 with one rounding, and t(x) = relu(x) where frozen BatchNorm has
// been folded into the weights:
//   raw1: v = x                                   (x is an activation already)
//   mid1: v = t(a)
//   mid2: v = bf16(relu(t(a) + t(b)))             (the sum in fp32; under
//         folded BN the bf16 sum of the two relus)
//   out  = bf16(conv3x3(v, w) + bias)             (fp32 accumulator and bias,
//         one rounding)
//   stats[0][c], stats[1][c] = sum, sum of squares of the fp32 (acc + bias)
//         over the H*W pixels, when asked for.
// The conv's zero padding comes after the transform: a tap outside the image
// reads 0, not t(0).
//
// What bounds it on an H100: at 64 channels and full resolution, bytes and
// tensor-core operations within a few percent of each other (a KITTI trunk
// pass moves 123 MB and does 35 GFLOP); at 96 and 128 channels in the tail,
// operations.
//
// With `q` set (RAFT_LANE_PACK8, raw1 without statistics: the zqr context
// convs), the pass is the quantize-on-exit variant instead, replacing
// ops/pallas_encoder.py:_pass_q8_kernel: the exit writes int8 q and one fp32
// scale (quant8.cuh) in place of `out`, in two launches of the same tiles,
// the first taking the maximum of |out|, the second quantizing.
//
// Design: the TPU kernel streams row blocks of a parity-packed, width-strip
// layout through a VMEM ring on a sequential grid and carries the statistics
// in scratch from step to step. Here the map is plain NHWC and the pass is
// one launch of the shared implicit-GEMM engine (conv3x3.cuh), a block per
// 128-pixel x 64-column tile; the transform is the engine's computed A-tile
// source, so every input value is transformed once for each of the 9 taps
// that read it and never written back. Statistics: the engine's epilogue
// visits a fixed channel per thread, so each thread keeps two running sums,
// the block adds them in thread order into its row of `partial`, and a
// second small launch adds the rows in fp64 (enc_stats.cuh): no atomics, the
// same bits every run. Output columns are padded to a multiple of 64, so a
// 96-channel pass computes 128 columns and throws a quarter away.
#include "enc_stats.cuh"
#include "quant8.cuh"
#include "stages.cuh"

namespace rst {

// Computed A-tile sources over one (H, W, C) map each (B = 1): load8 writes
// the 8 transformed channels [c, c + 8) of pixel (y, x).
struct Relu1Src {
  static constexpr bool kComputed = true;
  int part;
  const bf16* a;
  int W, C;
  __device__ void load8(bf16* dst, int, int y, int x, int c) const {
    const uint4 q = *reinterpret_cast<const uint4*>(a + ((size_t)y * W + x) * C + c);
    const bf16* v = reinterpret_cast<const bf16*>(&q);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16(relu(v[i]));
    *reinterpret_cast<uint4*>(dst) = out;
  }
};

struct Norm1Src {
  static constexpr bool kComputed = true;
  int part;
  const bf16* a;
  const float* m;
  const float* inv;
  int W, C;
  __device__ void load8(bf16* dst, int, int y, int x, int c) const {
    const uint4 q = *reinterpret_cast<const uint4*>(a + ((size_t)y * W + x) * C + c);
    const bf16* v = reinterpret_cast<const bf16*>(&q);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16(normed(v[i], m[c + i], inv[c + i]));
    *reinterpret_cast<uint4*>(dst) = out;
  }
};

struct Relu2Src {
  static constexpr bool kComputed = true;
  int part;
  const bf16* a;
  const bf16* b;
  int W, C;
  __device__ void load8(bf16* dst, int, int y, int x, int c) const {
    const size_t at = ((size_t)y * W + x) * C + c;
    const uint4 qa = *reinterpret_cast<const uint4*>(a + at);
    const uint4 qb = *reinterpret_cast<const uint4*>(b + at);
    const bf16* va = reinterpret_cast<const bf16*>(&qa);
    const bf16* vb = reinterpret_cast<const bf16*>(&qb);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16(__fadd_rn(relu(va[i]), relu(vb[i])));
    *reinterpret_cast<uint4*>(dst) = out;
  }
};

struct Norm2Src {
  static constexpr bool kComputed = true;
  int part;
  const bf16* a;
  const float* ma;
  const float* va;
  const bf16* b;
  const float* mb;
  const float* vb;
  int W, C;
  __device__ void load8(bf16* dst, int, int y, int x, int c) const {
    const size_t at = ((size_t)y * W + x) * C + c;
    const uint4 qa = *reinterpret_cast<const uint4*>(a + at);
    const uint4 qb = *reinterpret_cast<const uint4*>(b + at);
    const bf16* xa = reinterpret_cast<const bf16*>(&qa);
    const bf16* xb = reinterpret_cast<const bf16*>(&qb);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __float2bfloat16(fmaxf(__fadd_rn(normed(xa[i], ma[c + i], va[c + i]),
                                              normed(xb[i], mb[c + i], vb[c + i])),
                                    0.0f));
    *reinterpret_cast<uint4*>(dst) = out;
  }
};

// out = bf16(acc + bias); with s and s2 set, the thread's running sums of
// (acc + bias) and its square besides. The engine's epilogue loop gives
// thread t the columns n with n % 64 == t % 64, so one pair of sums a thread
// is one channel's.
struct PassEpi {
  const float* bias;
  bf16* out;
  int cout;
  float* s;
  float* s2;
  __device__ void operator()(int p, int n, float acc) const {
    if (n >= cout) return;
    const float v = __fadd_rn(acc, bias[n]);
    out[(size_t)p * cout + n] = __float2bfloat16(v);
    if (s != nullptr) {
      *s = __fadd_rn(*s, v);
      *s2 = __fadd_rn(*s2, __fmul_rn(v, v));
    }
  }
};

template <class Src>
__global__ void __launch_bounds__(THREADS) enc_pass_kernel(ConvIn a, PassEpi epi, Src src,
                                                           float* partial) {
  static_assert(THREADS % 64 == 0, "a thread's epilogue columns must share one channel");
  __shared__ __align__(128) unsigned char smem[TileSmem<64>::BYTES];
  float s = 0.0f, s2 = 0.0f;
  if (partial != nullptr) {
    epi.s = &s;
    epi.s2 = &s2;
  }
  conv3x3_tile<64>(a, epi, blockIdx.x, blockIdx.y, smem, src);
  if (partial != nullptr) {
    float* row = partial + (size_t)blockIdx.x * 2 * a.npad + blockIdx.y * 64;
    block_stats_store<64, THREADS>(s, s2, reinterpret_cast<float*>(smem), row, row + a.npad);
  }
}

// Phase 0 of the quantize-on-exit pass: the thread's maximum of
// |bf16(acc + bias)|.
struct AmaxEpi {
  const float* bias;
  int cout;
  float* m;
  __device__ void operator()(int p, int n, float acc) const {
    if (n < cout) *m = fmaxf(*m, fabsf(bf16r(__fadd_rn(acc, bias[n]))));
  }
};

// Phase 1: bf16(acc + bias) quantized with the map's scale.
struct QuantEpi {
  const float* bias;
  int cout;
  int8_t* q;
  float scale;
  __device__ void operator()(int p, int n, float acc) const {
    if (n < cout) q[(size_t)p * cout + n] = quant8(bf16r(__fadd_rn(acc, bias[n])), scale);
  }
};

__global__ void __launch_bounds__(THREADS) enc_pass_amax_kernel(ConvIn a, AmaxEpi epi,
                                                                unsigned int* amax) {
  __shared__ __align__(128) unsigned char smem[TileSmem<64>::BYTES];
  float m = 0.0f;
  epi.m = &m;
  conv3x3_tile<64>(a, epi, blockIdx.x, blockIdx.y, smem);
  amax_fold(m, amax);
}

__global__ void __launch_bounds__(THREADS) enc_pass_quant_kernel(ConvIn a, QuantEpi epi,
                                                                 const unsigned int* amax,
                                                                 float* scale) {
  __shared__ __align__(128) unsigned char smem[TileSmem<64>::BYTES];
  epi.scale = quant_scale(*amax);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *scale = epi.scale;
  conv3x3_tile<64>(a, epi, blockIdx.x, blockIdx.y, smem);
}

// The two phases: amax zeroed, taken, then the quantizing launch.
inline int launch_pass_q8(const ConvIn& a, const float* bias, int cout, int8_t* q, float* scale,
                          unsigned int* amax, cudaStream_t stream) {
  dim3 grid((a.H * a.W + BM - 1) / BM, a.npad / 64);
  int err = (int)cudaMemsetAsync(amax, 0, sizeof(unsigned int), stream);
  if (err) return err;
  enc_pass_amax_kernel<<<grid, THREADS, 0, stream>>>(a, AmaxEpi{bias, cout, nullptr}, amax);
  err = (int)cudaGetLastError();
  if (err) return err;
  enc_pass_quant_kernel<<<grid, THREADS, 0, stream>>>(a, QuantEpi{bias, cout, q, 0.0f}, amax,
                                                      scale);
  return (int)cudaGetLastError();
}

template <class Src>
inline int launch_pass(const ConvIn& a, const PassEpi& epi, const Src& src, float* partial,
                       cudaStream_t stream) {
  dim3 grid((a.H * a.W + BM - 1) / BM, a.npad / 64);
  enc_pass_kernel<Src><<<grid, THREADS, 0, stream>>>(a, epi, src, partial);
  return (int)cudaGetLastError();
}

}  // namespace rst

using rst::bf16;

// kind: 0 raw1, 1 mid1, 2 mid2. norm != 0: the instance-norm transform with
// per-channel mean/inv (ma, va and, for mid2, mb, vb: [cin] fp32); norm == 0:
// relu only, means unused. a, b: [H][W][cin] bf16 (b for mid2 only), cin a
// multiple of 32. w: [9][cin][pad64(cout)] bf16, bias: [cout] fp32, out:
// [H][W][cout] bf16. With partial != null ([ceil(H*W/128)][2][pad64(cout)]
// fp32 scratch) the sums land in stats ([2][cout] fp32). With q != null
// (raw1 without statistics only) the quantize-on-exit pass: q: [H][W][cout]
// int8 and scale: [1] fp32 in place of out, amax: one unsigned scratch
// word. Returns the first non-zero cudaError_t.
extern "C" int rst_enc_pass(int kind, int norm, const bf16* a, const float* ma, const float* va,
                            const bf16* b, const float* mb, const float* vb, int H, int W, int cin,
                            const bf16* w, const float* bias, int cout, bf16* out, float* partial,
                            float* stats, int8_t* q, float* scale, unsigned int* amax,
                            cudaStream_t stream) {
  const rst::ConvIn in = rst::single_in(a, cin, 1, H, W, w, rst::pad64(cout));
  if (q != nullptr) {
    if (kind != 0 || partial != nullptr || scale == nullptr || amax == nullptr)
      return (int)cudaErrorInvalidValue;
    return rst::launch_pass_q8(in, bias, cout, q, scale, amax, stream);
  }
  const rst::PassEpi epi{bias, out, cout, nullptr, nullptr};
  int err;
  if (kind == 0)
    err = rst::launch_pass(in, epi, rst::CopySrc{}, partial, stream);
  else if (kind == 1 && norm)
    err = rst::launch_pass(in, epi, rst::Norm1Src{0, a, ma, va, W, cin}, partial, stream);
  else if (kind == 1)
    err = rst::launch_pass(in, epi, rst::Relu1Src{0, a, W, cin}, partial, stream);
  else if (norm)
    err = rst::launch_pass(in, epi, rst::Norm2Src{0, a, ma, va, b, mb, vb, W, cin}, partial,
                           stream);
  else
    err = rst::launch_pass(in, epi, rst::Relu2Src{0, a, b, W, cin}, partial, stream);
  if (err || partial == nullptr) return err;
  const int rows = (H * W + rst::BM - 1) / rst::BM;
  return rst::launch_stats_reduce(partial, rows, in.npad, cout, stats, stream);
}
