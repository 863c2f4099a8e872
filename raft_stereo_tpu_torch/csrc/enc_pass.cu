// One 3x3 pad-1 convolution of the fused encoders, with the transform of its
// input built once per block in shared memory and, for instance norm, the
// statistics of its output taken on the way out.
//
// Replaces raft_stereo_tpu/ops/pallas_encoder.py:_pass_kernel (driven by
// _run_pass) and, with `q` set, :_pass_q8_kernel. On one (H, W, C) bf16 map,
// B = 1, with `t` the transform of a raw conv output under instance norm,
// t(x) = bf16(relu((x - mean) * inv)) in fp32 with one rounding, and
// t(x) = relu(x) where frozen BatchNorm has been folded into the weights:
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
// pass moves 123 MB and does 35 GFLOP: 37 and 35 us); at 96 and 128 channels
// in the tail and the 128 -> 384 zqr convs, operations.
//
// Design (enc_conv_sm90.cuh holds the Hopper building blocks). A block owns
// an 8 x 16 patch of output pixels and up to 192 output columns (N: 64, 96,
// 128 or 192; the 384 zqr columns are two blocks of 192). Warp-specialised:
// one producer thread starts the TMA loads, two consumer warpgroups of 64 pixels
// (4 output rows of 16) run wgmma. The K loop walks 64-channel chunks; per
// chunk the producer brings one 10 x 18 halo patch of the input (of both
// inputs for mid2) through a 4-D tensor map over the NHWC map, whose
// out-of-bounds fill is raw1's zero padding, then the chunk's 9 per-tap
// weight tiles (N x 64, K-major) through a 3-D map over [9][cout][cin];
// channels past cin and rows past cout read zeros. Rings: 1 patch stage (2
// where there are several chunks), 4 weight stages, one full and one empty
// mbarrier each. What that does to the costs of the WMMA implicit GEMM
// (mma.sync tiles fed by cp.async, one copy of the A tile a tap) this
// replaces:
//   1. the input is read once per block, not once per tap: the 9 taps read
//      the one staged patch at shifted addresses (ldmatrix, per-lane row
//      addresses, so a one-pixel shift costs nothing);
//   2. every load is asynchronous (TMA), the computed sources too: mid1/mid2
//      transform each staged element once per block in shared memory, after
//      it lands, and zero the halo outside the image there;
//   3. mean/inv sit in shared memory, read once per block;
//   4. wgmma m64nNk16 with A in registers (a one-pixel shift breaks wgmma's
//      shared-memory core-matrix layout, so A comes by ldmatrix from the
//      128B-swizzled patch, conflict-free) and B from swizzled shared memory
//      by descriptor;
//   5. a block computes all its columns at once: 96 as 96, not 128; the zqr
//      conv stages each patch twice (two column halves), not six times;
//   6. the epilogue works from registers: bias from shared memory, one
//      rounding, staged per warp in shared memory and written with 16-byte
//      stores; the statistics are per-column sums in registers, reduced by
//      shuffles and then across the 8 warps in a fixed order into one row
//      of `partial` per patch; no floating-point atomics, the same bits
//      every run; stats_reduce_kernel (enc_stats.cuh) adds the rows in
//      fp64, in up to 64 slices at once;
//   7. the quantize-on-exit pass runs the conv once: its epilogue writes
//      bf16(acc + bias) to a scratch map the wrapper allocates and folds
//      |v| into amax (atomicMax on the bit pattern, exact), then
//      quant_map_kernel quantizes the scratch with quant8.cuh as before.
// One block per patch and column tile, not persistent: at 64 and 96 columns
// two blocks share an SM (shared memory sized to the launch, 104 registers
// a consumer thread), so one block's loads, transform and epilogue overlap
// the other's products; at 128 and 192 columns a block runs alone. (A
// persistent block an SM holding the 9 weight tiles of a 64-channel pass
// measured slower: one block cannot hide its own transform and epilogue.)
#include <algorithm>

#include "enc_conv_sm90.cuh"
#include "enc_stats.cuh"
#include "quant8.cuh"
#include "rounding.cuh"

namespace rst {

constexpr int kTH = 8;    // output rows of a patch
constexpr int kTW = 16;   // output columns of a patch
constexpr int kPH = kTH + 2;
constexpr int kPW = kTW + 2;
constexpr int kPatch = kPH * kPW;           // halo pixels
constexpr int kABytes = kPatch * 128;       // one 64-channel patch, 23,040 bytes
constexpr int kASlot = 23 * 1024;           // rounded up to the swizzle's 1024 bytes
constexpr int kAStages = 2;                 // at most; one where there is one chunk
constexpr int kBStages = 4;
constexpr int kCMax = 256;                  // channels whose mean/inv fit in shared memory
constexpr int kConsumers = 256;
constexpr int kPassThreads = kConsumers + 128;

// Shared memory of a block: the patch ring (one 64-channel slot per input
// map a stage, one stage when there is one chunk, else two), the weight
// ring, the barriers, the bias and the mean/inv rows. Sized to the launch,
// so a 64-channel pass fits two blocks an SM.
struct PassLayout {
  int a_stage, a_stages, b, bar, bias, mv, bytes;
};

__host__ __device__ inline PassLayout pass_layout(int n, int kind, int nchunks) {
  PassLayout l;
  l.a_stage = (kind == 2 ? 2 : 1) * kASlot;
  l.a_stages = nchunks > 1 ? 2 : 1;
  l.b = l.a_stages * l.a_stage;
  l.bar = l.b + kBStages * n * 128;
  l.bias = l.bar + 128;
  l.mv = l.bias + 256 * 4;
  l.bytes = l.mv + 4 * kCMax * 4 + 1024;  // + alignment slack
  return l;
}

// Blocks an SM and the registers of the two roles (setmaxnreg): at 64 and 96
// columns two blocks share an SM, so one block's loads, transform and
// epilogue overlap the other's products; wider blocks hold more
// accumulators and run alone. Each pair of counts fits the register file:
// 128 x producer + 256 x consumer <= 65536 / blocks.
template <int N>
struct PassRegs {
  static constexpr int kBlocks = N <= 96 ? 2 : 1;
  static constexpr int kProducer = kBlocks == 2 ? 24 : 40;
  static constexpr int kConsumer = kBlocks == 2 ? 104 : 232;
  static_assert(256 * (N + 8) + 64 * N <= kASlot + kBStages * N * 128,
                "the epilogue's staging overflows the rings");
};

struct PassArgs {
  int H, W, cin, cout, nchunks, tiles_x;
  int kind;  // 0 raw1, 1 mid1, 2 mid2
  int norm;
  const float* ma;
  const float* va;
  const float* mb;
  const float* vb;
  const float* bias;
  bf16* out;         // the map; the bf16 scratch of the quantize-on-exit pass
  float* partial;    // [patches][2][cout] (then the reduction's scratch) or null
  unsigned* amax;    // quantize-on-exit only
};

// mid1/mid2: transform the staged patch of chunk kc in place; pixels outside
// the image become 0. Channels past cin arrive as 0 with mean and inv 0, so
// they stay 0.
__device__ __forceinline__ void transform_patch(unsigned char* A, const PassArgs& p,
                                                const float* mv, int kc, int y0, int x0) {
  for (int i = threadIdx.x; i < kPatch * 8; i += kConsumers) {
    const int r = i >> 3, c = i & 7;
    const int gy = y0 - 1 + r / kPW, gx = x0 - 1 + r % kPW;
    uint4* pa = reinterpret_cast<uint4*>(A + sm90::swz128(r, c));
    if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W) {
      *pa = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const int ch = kc * 64 + c * 8;
    const uint4 qa = *pa;
    uint4 qb = qa;
    if (p.kind == 2) qb = *reinterpret_cast<const uint4*>(A + kASlot + sm90::swz128(r, c));
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&qa);
    const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(&qb);
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
    // Channel pairs, converted and rounded two at a time; the arithmetic is
    // rounding.cuh's (normed_f, then one rounding; relu).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 ma, va, mb, vb;
      if (p.norm) {
        const int k = ch + 4 * h;
        ma = *reinterpret_cast<const float4*>(mv + k);
        va = *reinterpret_cast<const float4*>(mv + kCMax + k);
        if (p.kind == 2) {
          mb = *reinterpret_cast<const float4*>(mv + 2 * kCMax + k);
          vb = *reinterpret_cast<const float4*>(mv + 3 * kCMax + k);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * h + e;
        const float2 fa = __bfloat1622float2(xa[k]);
        float2 ta;
        if (p.norm) {
          const float m0 = e ? ma.z : ma.x, m1 = e ? ma.w : ma.y;
          const float v0 = e ? va.z : va.x, v1 = e ? va.w : va.y;
          ta = make_float2(normed_f(fa.x, m0, v0), normed_f(fa.y, m1, v1));
        } else {
          ta = make_float2(fmaxf(fa.x, 0.0f), fmaxf(fa.y, 0.0f));
        }
        if (p.kind == 1) {
          o[k] = __float22bfloat162_rn(ta);
          continue;
        }
        const float2 fb = __bfloat1622float2(xb[k]);
        float2 tb;
        if (p.norm) {
          const float m0 = e ? mb.z : mb.x, m1 = e ? mb.w : mb.y;
          const float v0 = e ? vb.z : vb.x, v1 = e ? vb.w : vb.y;
          tb = make_float2(normed_f(fb.x, m0, v0), normed_f(fb.y, m1, v1));
          // t(a) and t(b) are each rounded before their sum (rounding.cuh:normed).
          ta = __bfloat1622float2(__float22bfloat162_rn(ta));
          tb = __bfloat1622float2(__float22bfloat162_rn(tb));
          o[k] = __float22bfloat162_rn(make_float2(fmaxf(__fadd_rn(ta.x, tb.x), 0.0f),
                                                   fmaxf(__fadd_rn(ta.y, tb.y), 0.0f)));
        } else {
          tb = make_float2(fmaxf(fb.x, 0.0f), fmaxf(fb.y, 0.0f));
          o[k] = __float22bfloat162_rn(make_float2(__fadd_rn(ta.x, tb.x), __fadd_rn(ta.y, tb.y)));
        }
      }
    }
    *pa = out;
  }
}

template <int N>
__global__ void __launch_bounds__(kPassThreads, PassRegs<N>::kBlocks)
    pass_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tw, const PassArgs p) {
  constexpr int kBBytes = N * 128;
  const PassLayout L = pass_layout(N, p.kind, p.nchunks);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sA = smem;
  unsigned char* sB = smem + L.b;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty_a = full_a + kAStages;
  uint64_t* full_b = empty_a + kAStages;
  uint64_t* empty_b = full_b + kBStages;
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  float* mv_s = reinterpret_cast<float*>(smem + L.mv);

  const int ty = blockIdx.x / p.tiles_x, tx = blockIdx.x % p.tiles_x;
  const int y0 = ty * kTH, x0 = tx * kTW, n0 = blockIdx.y * N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      sm90::mbar_init(&full_a[s], 1);
      sm90::mbar_init(&empty_a[s], kConsumers / 32);
    }
    for (int s = 0; s < kBStages; ++s) {
      sm90::mbar_init(&full_b[s], 1);
      sm90::mbar_init(&empty_b[s], kConsumers / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup: one thread keeps the rings full.
    sm90::setmaxnreg_dec<PassRegs<N>::kProducer>();
    if (threadIdx.x == kConsumers) {
      const uint32_t a_bytes = (p.kind == 2 ? 2 : 1) * kABytes;
      uint32_t pa = 0, pb = 0;
      int sa = 0, sb = 0;
      for (int kc = 0; kc < p.nchunks; ++kc) {
        sm90::mbar_wait(&empty_a[sa], pa ^ 1);
        sm90::mbar_expect_tx(&full_a[sa], a_bytes);
        unsigned char* dst = sA + sa * L.a_stage;
        sm90::tma_load_4d(dst, &ta, &full_a[sa], kc * 64, x0 - 1, y0 - 1, 0);
        if (p.kind == 2)
          sm90::tma_load_4d(dst + kASlot, &tb, &full_a[sa], kc * 64, x0 - 1, y0 - 1, 0);
        if (++sa == L.a_stages) sa = 0, pa ^= 1;
        for (int tap = 0; tap < 9; ++tap) {
          sm90::mbar_wait(&empty_b[sb], pb ^ 1);
          sm90::mbar_expect_tx(&full_b[sb], kBBytes);
          sm90::tma_load_3d(sB + sb * kBBytes, &tw, &full_b[sb], kc * 64, n0, tap);
          if (++sb == kBStages) sb = 0, pb ^= 1;
        }
      }
    }
    return;
  }

  // The two consumer warpgroups: warp w computes output row w of the patch.
  sm90::setmaxnreg_inc<PassRegs<N>::kConsumer>();
  const int ct = threadIdx.x, warp = ct >> 5, lane = ct & 31;
  for (int i = ct; i < N; i += kConsumers) bias_s[i] = n0 + i < p.cout ? p.bias[n0 + i] : 0.0f;
  if (p.norm) {
    const int nparts = p.kind == 2 ? 4 : 2;
    const float* src[4] = {p.ma, p.va, p.mb, p.vb};
    for (int i = ct; i < nparts * p.nchunks * 64; i += kConsumers) {
      const int part = i / (p.nchunks * 64), c = i % (p.nchunks * 64);
      mv_s[part * kCMax + c] = c < p.cin ? src[part][c] : 0.0f;
    }
  }
  sm90::named_sync(1, kConsumers);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  // ldmatrix: lane l gives the address of pixel lx of the warp's row, the
  // low or high 8 channels of the k16 slice.
  const int lx = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  uint32_t pa = 0, pb = 0;
  int sa = 0, sb = 0;
  for (int kc = 0; kc < p.nchunks; ++kc) {
    sm90::mbar_wait(&full_a[sa], pa);
    unsigned char* A = sA + sa * L.a_stage;
    if (p.kind != 0) {
      transform_patch(A, p, mv_s, kc, y0, x0);
      sm90::named_sync(1, kConsumers);
    }
    const uint32_t abase = sm90::smem_u32(A);
    uint32_t a[2][4][4];
    int prev = 0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int r = (warp + tap / 3) * kPW + lx + tap % 3;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        sm90::ldsm_x4(abase + sm90::swz128(r, 2 * s + khalf), a[tap & 1][s]);
      sm90::mbar_wait(&full_b[sb], pb);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sm90::keep(acc[i]);
      sm90::wgmma_fence();
      const uint64_t bd = sm90::desc_sw128(sm90::smem_u32(sB + sb * kBBytes));
#pragma unroll
      for (int s = 0; s < 4; ++s) sm90::Wgmma<N>::mma(acc, a[tap & 1][s], bd + 2 * s);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous tap's products are done
      if (tap > 0) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) sm90::keep(a[(tap + 1) & 1][s][e]);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty_b[prev]);
      }
      prev = sb;
      if (++sb == kBStages) sb = 0, pb ^= 1;
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sm90::keep(acc[i]);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm90::keep(a[0][s][e]);
    sm90::fence_proxy_async();  // the transform's writes before the refill
    __syncwarp();
    if (lane == 0) {
      sm90::mbar_arrive(&empty_b[prev]);
      sm90::mbar_arrive(&empty_a[sa]);
    }
    if (++sa == L.a_stages) sa = 0, pa ^= 1;
  }

  // Epilogue. Every consumer warp is done with the rings before they are
  // reused for the staging tiles and the statistics.
  sm90::named_sync(1, kConsumers);
  constexpr int LD = N + 8;  // staging row in bf16, padded against bank conflicts
  bf16* stg = reinterpret_cast<bf16*>(smem) + warp * 16 * LD;
  float* red = reinterpret_cast<float*>(smem + 256 * LD);  // [2][8][N]
  const int g = lane >> 2, t = lane & 3;
  const int gy = y0 + warp;
  const bool in_a = gy < p.H && x0 + g < p.W;
  const bool in_b = gy < p.H && x0 + g + 8 < p.W;
  const bool stats = p.partial != nullptr;
  __nv_bfloat162 mx = __floats2bfloat162_rn(0.0f, 0.0f);  // the largest |out| seen
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = 8 * j + 2 * t;
    const float b0 = bias_s[n], b1 = bias_s[n + 1];
    const float v00 = __fadd_rn(acc[4 * j], b0), v01 = __fadd_rn(acc[4 * j + 1], b1);
    const float v10 = __fadd_rn(acc[4 * j + 2], b0), v11 = __fadd_rn(acc[4 * j + 3], b1);
    const __nv_bfloat162 oa = __floats2bfloat162_rn(v00, v01);
    const __nv_bfloat162 ob = __floats2bfloat162_rn(v10, v11);
    *reinterpret_cast<__nv_bfloat162*>(stg + g * LD + n) = oa;
    *reinterpret_cast<__nv_bfloat162*>(stg + (g + 8) * LD + n) = ob;
    if (stats) {
      float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
      if (in_a) {
        s0 = v00;
        s1 = v01;
        q0 = __fmul_rn(v00, v00);
        q1 = __fmul_rn(v01, v01);
      }
      if (in_b) {
        s0 = __fadd_rn(s0, v10);
        s1 = __fadd_rn(s1, v11);
        q0 = __fadd_rn(q0, __fmul_rn(v10, v10));
        q1 = __fadd_rn(q1, __fmul_rn(v11, v11));
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, o));
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
        q0 = __fadd_rn(q0, __shfl_xor_sync(0xffffffffu, q0, o));
        q1 = __fadd_rn(q1, __shfl_xor_sync(0xffffffffu, q1, o));
      }
      if (g == 0) {
        red[warp * N + n] = s0;
        red[warp * N + n + 1] = s1;
        red[(8 + warp) * N + n] = q0;
        red[(8 + warp) * N + n + 1] = q1;
      }
    }
    if (p.amax != nullptr && n0 + n < p.cout) {  // on the rounded values, as the host's
      if (in_a) mx = __hmax2(mx, __habs2(oa));
      if (in_b) mx = __hmax2(mx, __habs2(ob));
    }
  }
  __syncwarp();
  constexpr int CH = N / 8;  // 16-byte chunks of a staged pixel
  if (gy < p.H) {
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int px = idx / CH, q = idx % CH;
      const int x = x0 + px, n = n0 + 8 * q;
      if (x < p.W && n < p.cout)
        *reinterpret_cast<uint4*>(p.out + ((size_t)gy * p.W + x) * p.cout + n) =
            *reinterpret_cast<const uint4*>(stg + px * LD + 8 * q);
    }
  }
  if (p.amax != nullptr) {
    // The block's maximum, then one atomicMax a block (quant8.cuh): every
    // block's fold lands on one word, so fewer atomics queue there.
    float m = fmaxf(__low2float(mx), __high2float(mx));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[warp] = m;
    sm90::named_sync(1, kConsumers);
    if (ct == 0) {
      for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w]);
      atomicMax(p.amax, __float_as_uint(m));
    }
  }
  if (stats) {
    sm90::named_sync(1, kConsumers);
    float* row = p.partial + (size_t)blockIdx.x * 2 * p.cout;
    for (int n = ct; n < N && n0 + n < p.cout; n += kConsumers) {
      float s = 0.0f, q = 0.0f;
      for (int w = 0; w < 8; ++w) {
        s = __fadd_rn(s, red[w * N + n]);
        q = __fadd_rn(q, red[(8 + w) * N + n]);
      }
      row[n0 + n] = s;
      row[p.cout + n0 + n] = q;
    }
  }
}

// The quantize-on-exit pass's second kernel: the bf16 scratch map, 8 values a
// thread, quantized with the scale of the amax its first kernel folded.
__global__ void __launch_bounds__(256) quant_map_kernel(const bf16* v, int8_t* q, size_t n8,
                                                        const unsigned int* amax, float* scale) {
  const float s = quant_scale(*amax);
  const float rcp = __frcp_rn(s);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  // Four 16-byte loads in flight a thread.
  const size_t stride = (size_t)gridDim.x * 256;
  for (size_t i0 = (size_t)blockIdx.x * 256 + threadIdx.x; i0 < n8; i0 += 4 * stride) {
    uint4 u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t i = i0 + j * stride;
      if (i < n8) u[j] = reinterpret_cast<const uint4*>(v)[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t i = i0 + j * stride;
      if (i >= n8) break;
      const bf16* e = reinterpret_cast<const bf16*>(&u[j]);
      uint2 o;
      int8_t* b = reinterpret_cast<int8_t*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k) b[k] = quant8_fast(__bfloat162float(e[k]), s, rcp);
      reinterpret_cast<uint2*>(q)[i] = o;
    }
  }
}

inline int patches(int H, int W) { return ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW); }

// Output columns a block computes: the fewest column tiles of at most 192,
// then the narrowest instantiated width that holds a tile's share.
inline int pass_width(int cout) {
  const int tiles = (cout + 191) / 192;
  const int per = (cout + tiles - 1) / tiles;
  return per <= 64 ? 64 : per <= 96 ? 96 : per <= 128 ? 128 : 192;
}

template <int N>
inline int launch_width(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tw,
                        const PassArgs& p, cudaStream_t stream) {
  const int bytes = pass_layout(N, p.kind, p.nchunks).bytes;
  int err = (int)cudaFuncSetAttribute(pass_sm90_kernel<N>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid(patches(p.H, p.W), (p.cout + N - 1) / N);
  pass_sm90_kernel<N><<<grid, kPassThreads, bytes, stream>>>(ta, tb, tw, p);
  return (int)cudaGetLastError();
}

template <int N>
inline int blocks_per_sm(int bytes, int* blocks) {
  *blocks = 0;
  const int err = (int)cudaFuncSetAttribute(pass_sm90_kernel<N>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pass_sm90_kernel<N>,
                                                            kPassThreads, bytes);
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace rst

using rst::bf16;

// The launch plan of a pass of `kind` over an H x W x cin map into cout
// channels: plan[0] the rows of its `partial` scratch (one per 8 x 16 output
// patch, then the reduction's scratch, enc_stats.cuh), plan[1] the output
// columns a block computes, plan[2] its dynamic shared memory in bytes,
// plan[3] the blocks an SM holds. Returns 0 or a cudaError_t.
extern "C" int rst_enc_pass_plan(int kind, int H, int W, int cin, int cout, int* plan) {
  using namespace rst;
  const int n = pass_width(cout);
  plan[0] = patches(H, W) + stats_extra_rows(patches(H, W));
  plan[1] = n;
  plan[2] = pass_layout(n, kind, (cin + 63) / 64).bytes;
  // Blocks an SM: the register file's count, or fewer where shared memory
  // holds fewer (the runtime's occupancy calculator decides).
  switch (n) {
    case 64: return blocks_per_sm<64>(plan[2], &plan[3]);
    case 96: return blocks_per_sm<96>(plan[2], &plan[3]);
    case 128: return blocks_per_sm<128>(plan[2], &plan[3]);
    default: return blocks_per_sm<192>(plan[2], &plan[3]);
  }
}

// kind: 0 raw1, 1 mid1, 2 mid2. norm != 0: the instance-norm transform with
// per-channel mean/inv (ma, va and, for mid2, mb, vb: [cin] fp32, cin <= 256);
// norm == 0: relu only, means unused. a, b: [H][W][cin] bf16 (b for mid2
// only), cin a multiple of 8. w: [9][cout][cin] bf16 (tap-major, then output
// channel, input channels contiguous), bias: [cout] fp32, cout a multiple of
// 8, out: [H][W][cout] bf16; every pointer 16-byte aligned. With partial !=
// null ([plan[0]][2][cout] fp32 scratch, rst_enc_pass_plan) the sums land in
// stats ([2][cout] fp32). With q != null (raw1 without statistics only) the
// quantize-on-exit pass: out is a bf16 scratch map the caller frees after
// the call, q: [H][W][cout] int8 and scale: [1] fp32 the result, amax: one
// unsigned scratch word. Returns the first non-zero cudaError_t.
extern "C" int rst_enc_pass(int kind, int norm, const bf16* a, const float* ma, const float* va,
                            const bf16* b, const float* mb, const float* vb, int H, int W, int cin,
                            const bf16* w, const float* bias, int cout, bf16* out, float* partial,
                            float* stats, int8_t* q, float* scale, unsigned int* amax,
                            cudaStream_t stream) {
  using namespace rst;
  if (kind < 0 || kind > 2 || H < 1 || W < 1 || cin < 8 || cin % 8 || cout < 8 || cout % 8 ||
      out == nullptr || !aligned16(a) || !aligned16(w) || !aligned16(out) ||
      (kind == 2 && (b == nullptr || !aligned16(b))) || (norm && kind != 0 && cin > kCMax))
    return (int)cudaErrorInvalidValue;
  if (q != nullptr && (kind != 0 || partial != nullptr || scale == nullptr || amax == nullptr))
    return (int)cudaErrorInvalidValue;
  const int N = pass_width(cout);
  CUtensorMap ta, tb, tw;
  const cuuint64_t mdims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, 1};
  const cuuint64_t mstrides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2,
                                  (cuuint64_t)H * W * cin * 2};
  const cuuint32_t mbox[4] = {64, kPW, kPH, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)cin, (cuuint64_t)cout, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)cin * 2, (cuuint64_t)cout * cin * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)N, 1};
  int err = sm90::bf16_map(&ta, a, 4, mdims, mstrides, mbox);
  if (!err) err = sm90::bf16_map(&tb, kind == 2 ? b : a, 4, mdims, mstrides, mbox);
  if (!err) err = sm90::bf16_map(&tw, w, 3, wdims, wstrides, wbox);
  if (err) return err;
  PassArgs p{H, W, cin, cout, (cin + 63) / 64, (W + kTW - 1) / kTW, kind, kind != 0 && norm,
             ma, va, mb, vb, bias, out, partial, q != nullptr ? amax : nullptr};
  if (q != nullptr) {
    err = (int)cudaMemsetAsync(amax, 0, sizeof(unsigned int), stream);
    if (err) return err;
  }
  switch (N) {
    case 64: err = launch_width<64>(ta, tb, tw, p, stream); break;
    case 96: err = launch_width<96>(ta, tb, tw, p, stream); break;
    case 128: err = launch_width<128>(ta, tb, tw, p, stream); break;
    default: err = launch_width<192>(ta, tb, tw, p, stream); break;
  }
  if (err) return err;
  if (q != nullptr) {
    const size_t n8 = (size_t)H * W * cout / 8;
    const int blocks = (int)std::min<size_t>((n8 + 255) / 256, 132 * 8);
    quant_map_kernel<<<blocks, 256, 0, stream>>>(out, q, n8, amax, scale);
    return (int)cudaGetLastError();
  }
  if (partial == nullptr) return 0;
  return launch_stats_reduce(partial, patches(H, W), cout, cout, stats, stream);
}
