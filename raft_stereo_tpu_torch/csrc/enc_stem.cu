// The encoders' stem: a 7x7 stride-1 pad-3 convolution of the 3-channel
// image into 64 channels, as one 147-tap dot per pixel.
//
// Replaces raft_stereo_tpu/ops/pallas_encoder.py:_stem_kernel (driven by
// _run_stem). On one (H, W, 3) bf16 image, B = 1:
//   out = bf16(sum over (dy, dx, ci) of x[y + dy - 3][x + dx - 3][ci] * w + bias)
// with an fp32 accumulator, an fp32 bias and one rounding, zero outside the
// image; and, when asked for (instance norm), the per-channel sum and sum of
// squares of the fp32 (acc + bias) over the H*W pixels.
//
// What bounds it on an H100: bytes. It reads 6 bytes and writes 128 a pixel
// against 2 * 147 * 64 operations, a sixth of the card's balance point.
//
// Design (enc_conv_sm90.cuh holds the Hopper building blocks). A persistent
// block, one an SM, walks 8 x 64 output patches in a fixed stride. The
// patch's image halo, 14 rows of 70 pixels x 3 channels, arrives in shared
// memory by TMA, double-buffered: the next patch lands while this one
// computes. The map views each image row as 16-byte units ([H][3W/8][8],
// its out-of-bounds fill the conv's zero padding), so a halo row starts at
// a whole unit, 7 values before the patch's first. Where a row of the image
// is not a multiple of 16 bytes (W not a multiple of 8), TMA cannot address
// it and the block's threads load the halo instead. A pixel's tap row dy is
// 21 consecutive values of a halo row, so K runs dy-major, 22 a dy (the 21
// taps and a zero), 154 padded to 160; a pair of K values is then two
// consecutive values of one halo row. Beside the halo the block keeps a
// second copy one value later (shifted in shared memory, 64 bytes further
// so that the two copies fall on other banks), so every pair is one aligned
// 32-bit load from one copy or the other: the A operand of wgmma is built in
// registers straight from the halo, no gather from device memory.
// The weights stay in shared memory for the block's life, K-major in three
// 64-tap slabs (128B swizzle), as wgmma reads B. Two consumer warpgroups
// take alternate output rows of the patch: one wgmma m64n64k16 tile a row,
// 10 k16 steps. The epilogue works from registers: the fp32 bias, one
// rounding, staged a warp at a time in shared memory and written with
// 16-byte stores, each warp's 16 pixels one contiguous 2 KB run. Statistics:
// each thread sums its 16 channels over all its pixels in registers; the
// block reduces them in a fixed order into one row of partials, and a second
// launch adds the rows in fp64 (enc_stats.cuh). The grid is a constant, not
// the card's SM count, so the partial sums, and the bits of the statistics,
// are the same on every card. A block: 256 threads, 72 KB of shared memory
// (the weights 24 KB, two halo buffers of 12.4 KB, the staging 18 KB).
#include <cstdint>

#include "enc_conv_sm90.cuh"
#include "enc_stats.cuh"

namespace rst {
namespace stem {

using bf16 = __nv_bfloat16;

constexpr int kRows = 8;                   // output rows a patch
constexpr int kCols = 64;                  // output columns a patch: one wgmma tile a row
constexpr int kHaloRows = kRows + 6;
constexpr int kPitch = 224;                // a halo row, bf16: 28 units of 16 bytes
constexpr int kPitchW = kPitch / 2;        // the same in 32-bit words
constexpr int kLead = 7;                   // values before the patch's first in a halo row
constexpr int kCopyBytes = kHaloRows * kPitch * 2;
constexpr int kCopyB = kCopyBytes + 64;    // the shifted copy's place: 16 banks on
constexpr int kBufBytes = (kCopyB + kCopyBytes + 127) / 128 * 128;
constexpr int kTapRow = 22;                // K per dy: 7 x 3 taps and a zero
constexpr int kK = 160;                    // 7 x 22 = 154, padded to whole k16 steps
constexpr int kSteps = kK / 16;
constexpr int kPairs = 7 * kTapRow / 2;    // the K pairs that carry taps
constexpr int kN = 64;                     // output channels
constexpr int kSlabs = 3;                  // 64-tap weight slabs: 192 >= kK
constexpr int kSlabBytes = kN * 128;
constexpr int kThreads = 256;              // two consumer warpgroups
constexpr int kBlocks = 132;               // the grid, at most: rows of partial sums
constexpr int kLd = kN + 8;                // a staged output pixel, bf16

static_assert((3 * kCols) % 8 == 0 && (kLead + 9) % 8 == 0,
              "every patch's halo row starts kLead values before a 16-byte unit");
static_assert(kLead + 3 * (kCols - 1) + kTapRow - 1 < kPitch,
              "a halo row must hold every pair a pixel reads");

struct Layout {
  int halo, stage, bias, red, bar, bytes;
};

__host__ __device__ constexpr Layout layout() {
  Layout l{};
  l.halo = kSlabs * kSlabBytes;        // the weights first
  l.stage = l.halo + 2 * kBufBytes;
  l.bias = l.stage + 8 * 16 * kLd * 2;  // a warp's 16 pixels
  l.red = l.bias + kN * 4;
  l.bar = l.red + 2 * 8 * kN * 4;
  l.bytes = l.bar + 16 + 1024;  // + the barriers, + alignment slack
  return l;
}

struct StemArgs {
  const bf16* x;
  const bf16* w;
  const float* bias;
  int H, W, tiles_x, npatch, use_tma;
  bf16* out;
  float* partial;
};

// Patch `patch`'s halo into buffer `buf`: by TMA (one thread issues, the
// barrier counts the bytes; shift_copy then makes the second copy), or,
// both copies, by every thread of the block with plain loads (the caller's
// __syncthreads publishes them). Halo value j of row r is the image's value
// e0 - kLead + j of row y0 + r, e0 the patch's first (its pixel x0 - 3).
__device__ __forceinline__ void load_patch(unsigned char* buf, uint64_t* bar,
                                           const CUtensorMap* tx, const StemArgs& p, int patch) {
  const int y0 = (patch / p.tiles_x) * kRows - 3;
  const int e0 = ((patch % p.tiles_x) * kCols - 3) * 3 - kLead;
  if (p.use_tma) {
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(bar, kCopyBytes);
      sm90::tma_load_3d(buf, tx, bar, 0, e0 / 8, y0);
    }
    return;
  }
  const int row = 3 * p.W;
  for (int i = threadIdx.x; i < 2 * kHaloRows * kPitch; i += kThreads) {
    const int copy = i / (kHaloRows * kPitch), rem = i % (kHaloRows * kPitch);
    const int y = y0 + rem / kPitch;
    const int e = e0 + rem % kPitch + copy;
    bf16 v = __float2bfloat16(0.0f);
    if (y >= 0 && y < p.H && e >= 0 && e < row) v = p.x[(size_t)y * row + e];
    reinterpret_cast<bf16*>(buf + copy * kCopyB)[rem] = v;
  }
}

// The second copy of a halo that TMA brought: value j is the first copy's
// j + 1, a funnel of two words (the last word of a row reads past it, into
// a value no pair uses).
__device__ __forceinline__ void shift_copy(unsigned char* buf) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(buf);
  uint32_t* b = reinterpret_cast<uint32_t*>(buf + kCopyB);
  for (int k = threadIdx.x; k < kHaloRows * kPitchW; k += kThreads)
    b[k] = __byte_perm(a[k], a[k + 1], 0x5432);
}

template <bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
    stem_sm90_kernel(const __grid_constant__ CUtensorMap tx, const StemArgs p) {
  constexpr Layout L = layout();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* halo = smem + L.halo;
  bf16* stage = reinterpret_cast<bf16*>(smem + L.stage);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The weights, [kN][kK] in device memory, into K-major swizzled slabs,
  // zero past kK.
  for (int i = tid; i < kN * kSlabs * 8; i += kThreads) {
    const int n = i / (kSlabs * 8), c = i % (kSlabs * 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < kK / 8) v = *reinterpret_cast<const uint4*>(p.w + n * kK + 8 * c);
    *reinterpret_cast<uint4*>(smem + (c / 8) * kSlabBytes + sm90::swz128(n, c % 8)) = v;
  }
  sm90::fence_proxy_async();  // the weights' stores before wgmma reads them
  if (tid < kN) bias_s[tid] = p.bias[tid];
  if (tid == 0) {
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if ((int)blockIdx.x < p.npatch) {
    load_patch(halo, &full[0], &tx, p, blockIdx.x);
    if (p.use_tma) {
      sm90::mbar_wait(&full[0], 0);
      shift_copy(halo);
    }
  }
  __syncthreads();

  // Warpgroup q computes the patch's output rows q, q + 2, ...; warp wq of
  // it the pixels [16 wq, 16 wq + 16) of a row. Lane (g, t4) holds A rows g
  // and g + 8 (pixels xl and xl + 8, which read the same copy of the halo)
  // at K pairs 8s + t4 and 8s + t4 + 4 of step s. A pair of pixel xl starts
  // at halo value kLead + 3 xl + 2m: even, so in the first copy, for an odd
  // xl; in the shifted copy, one value earlier, for an even one.
  const int q = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int xl = 16 * wq + g;
  const int pix = (xl & 1) ? (kLead + 3 * xl) / 2 : kCopyB / 4 + (kLead - 1 + 3 * xl) / 2;
  int off[kSteps][2];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = 8 * s + 4 * hf + t4;  // a pair past the taps reads any finite pair
      off[s][hf] = m < kPairs ? (m / (kTapRow / 2)) * kPitchW + m % (kTapRow / 2) : 0;
    }
  float sum[16], sq[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) sum[j] = sq[j] = 0.0f;
  bf16* stg = stage + warp * 16 * kLd;
  const uint32_t wbase = sm90::smem_u32(smem);

  int i = 0;
  for (int patch = blockIdx.x; patch < p.npatch; patch += gridDim.x, ++i) {
    const int buf = i & 1;
    const bool next = patch + (int)gridDim.x < p.npatch;
    if (next) load_patch(halo + (buf ^ 1) * kBufBytes, &full[buf ^ 1], &tx, p, patch + gridDim.x);
    const int y0 = (patch / p.tiles_x) * kRows, x0 = (patch % p.tiles_x) * kCols;
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(halo + buf * kBufBytes) + pix;
    const bool va = x0 + xl < p.W, vb = x0 + xl + 8 < p.W;
    for (int r = q; r < kRows && y0 + r < p.H; r += 2) {
      uint32_t a[kSteps][4];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t* src = hw + r * kPitchW + off[s][hf];
          a[s][2 * hf] = src[0];
          a[s][2 * hf + 1] = src[12];  // pixel xl + 8: 24 values on
        }
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sm90::keep(acc[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        sm90::Wgmma<64>::mma(acc, a[s],
                             sm90::desc_sw128(wbase + (s / 4) * kSlabBytes) + 2 * (s % 4));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 32; ++j) sm90::keep(acc[j]);
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm90::keep(a[s][e]);

      // Epilogue: bias, one rounding, the statistics of the fp32 values.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * t4;
        const float b0 = bias_s[n], b1 = bias_s[n + 1];
        const float v00 = __fadd_rn(acc[4 * j], b0), v01 = __fadd_rn(acc[4 * j + 1], b1);
        const float v10 = __fadd_rn(acc[4 * j + 2], b0), v11 = __fadd_rn(acc[4 * j + 3], b1);
        *reinterpret_cast<__nv_bfloat162*>(stg + g * kLd + n) = __floats2bfloat162_rn(v00, v01);
        *reinterpret_cast<__nv_bfloat162*>(stg + (g + 8) * kLd + n) =
            __floats2bfloat162_rn(v10, v11);
        if (STATS) {
          if (va) {
            sum[2 * j] = __fadd_rn(sum[2 * j], v00);
            sum[2 * j + 1] = __fadd_rn(sum[2 * j + 1], v01);
            sq[2 * j] = __fadd_rn(sq[2 * j], __fmul_rn(v00, v00));
            sq[2 * j + 1] = __fadd_rn(sq[2 * j + 1], __fmul_rn(v01, v01));
          }
          if (vb) {
            sum[2 * j] = __fadd_rn(sum[2 * j], v10);
            sum[2 * j + 1] = __fadd_rn(sum[2 * j + 1], v11);
            sq[2 * j] = __fadd_rn(sq[2 * j], __fmul_rn(v10, v10));
            sq[2 * j + 1] = __fadd_rn(sq[2 * j + 1], __fmul_rn(v11, v11));
          }
        }
      }
      __syncwarp();
      bf16* dst = p.out + ((size_t)(y0 + r) * p.W + x0 + 16 * wq) * kN;
      for (int idx = lane; idx < 16 * (kN / 8); idx += 32) {
        const int px = idx / (kN / 8), c = idx % (kN / 8);
        if (x0 + 16 * wq + px < p.W)
          *reinterpret_cast<uint4*>(dst + px * kN + 8 * c) =
              *reinterpret_cast<const uint4*>(stg + px * kLd + 8 * c);
      }
      __syncwarp();
    }
    if (next && p.use_tma) {
      sm90::mbar_wait(&full[buf ^ 1], ((i + 1) >> 1) & 1);
      shift_copy(halo + (buf ^ 1) * kBufBytes);
    }
    // Both warpgroups are done with this buffer before it is refilled, and
    // the next one is whole.
    __syncthreads();
  }

  if (STATS) {
    // The 8 lanes of a t4 hold the same channels: shuffles, then one row of
    // the block's sums, the 8 warps added in order.
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], o));
        sq[j] = __fadd_rn(sq[j], __shfl_xor_sync(0xffffffffu, sq[j], o));
      }
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = 8 * (j / 2) + 2 * t4 + (j & 1);
        red[warp * kN + n] = sum[j];
        red[(8 + warp) * kN + n] = sq[j];
      }
    __syncthreads();
    if (tid < kN) {
      float s = 0.0f, s2 = 0.0f;
      for (int w = 0; w < 8; ++w) {
        s = __fadd_rn(s, red[w * kN + tid]);
        s2 = __fadd_rn(s2, red[(8 + w) * kN + tid]);
      }
      p.partial[(size_t)blockIdx.x * 2 * kN + tid] = s;
      p.partial[(size_t)blockIdx.x * 2 * kN + kN + tid] = s2;
    }
  }
}

inline int npatch(int H, int W) {
  return ((H + kRows - 1) / kRows) * ((W + kCols - 1) / kCols);
}
inline int blocks(int H, int W) { return npatch(H, W) < kBlocks ? npatch(H, W) : kBlocks; }
inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <bool STATS>
inline int launch(const CUtensorMap& tx, const StemArgs& p, int nblocks, cudaStream_t stream) {
  constexpr int bytes = layout().bytes;
  const int err = (int)cudaFuncSetAttribute(stem_sm90_kernel<STATS>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  stem_sm90_kernel<STATS><<<nblocks, kThreads, bytes, stream>>>(tx, p);
  return (int)cudaGetLastError();
}

}  // namespace stem
}  // namespace rst

using rst::stem::bf16;

// The stem's plan for an H x W image: plan[0] the rows of its `partial`
// scratch (one a block), plan[1] the K of its weight layout, plan[2] the K
// of one tap row dy. Returns 0.
extern "C" int rst_enc_stem_plan(int H, int W, int* plan) {
  using namespace rst::stem;
  plan[0] = blocks(H, W) + rst::stats_extra_rows(blocks(H, W));
  plan[1] = kK;
  plan[2] = kTapRow;
  return 0;
}

// x: [H][W][3] bf16; w: [64][160] bf16, row n holding tap (dy, dx, ci) at
// dy * 22 + dx * 3 + ci and zeros elsewhere (ops/encoder.py:_stem_layout);
// bias: [64] fp32; out: [H][W][64] bf16; w and out 16-byte aligned. With
// partial != null ([plan[0]][2][64] fp32 scratch, rst_enc_stem_plan) the
// sums land in stats ([2][64] fp32). Returns the first non-zero cudaError_t.
extern "C" int rst_enc_stem(const bf16* x, const bf16* w, const float* bias, int H, int W,
                            bf16* out, float* partial, float* stats, cudaStream_t stream) {
  using namespace rst::stem;
  if (H < 1 || W < 1 || !aligned16(w) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  StemArgs p{x, w, bias, H, W, (W + kCols - 1) / kCols, npatch(H, W),
             W % 8 == 0 && aligned16(x), out, partial};
  CUtensorMap tx;
  std::memset(&tx, 0, sizeof tx);
  if (p.use_tma) {
    const cuuint64_t dims[3] = {8, (cuuint64_t)3 * W / 8, (cuuint64_t)H};
    const cuuint64_t strides[2] = {16, (cuuint64_t)3 * W * 2};
    const cuuint32_t box[3] = {8, kPitch / 8, kHaloRows};
    const int err = rst::sm90::cached_map(&tx, x, 3, dims, strides, box,
                                          CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  const int nblocks = blocks(H, W);
  const int err = partial != nullptr ? launch<true>(tx, p, nblocks, stream)
                                     : launch<false>(tx, p, nblocks, stream);
  if (err || partial == nullptr) return err;
  return rst::launch_stats_reduce(partial, nblocks, kN, kN, stats, stream);
}
