// The alt correlation lookup: no volume, the taps computed from the features.
//
// Replaces raft_stereo_tpu/corr/pallas_alt.py:_alt_kernel (driven by
// _pallas_alt). Per pixel p (row r of its image) and level l:
//   cl = x / 2^l, i0 = floor(cl), frac = cl - i0
//   v[t] = (f1[p] . f2_l[r][i0 - R + t]) * scale   for t in [0, 2R + 1]
//          (fp32 sum of the D products, scale = 1/sqrt(D) in fp32), zero
//          where the position is outside [0, width[l])
//   out[t] = v[t] * (1 - frac) + v[t + 1] * frac   (fp32, one downcast)
// f2_l is the pooled fmap2 pyramid, built once a segment by the wrapper
// (corr/alt_cuda.py: level l pools level l-1 by pairs in fmap2's dtype, as
// the TPU kernel's _pool_rows does in the kernel).
//
// What bounds it on an H100: bytes. Each input is needed once (f1, the
// pyramid of 1.875x f2, the coords) and each output written once: ~0.58 GB
// at Middlebury-F features (504x744x256 bf16), 0.17 ms at 3.35 TB/s. The
// operations the taps need (2R+2 dots of D a level, ~7.7 GFLOP there) are
// far under that.
//
// Design: the TPU kernel builds each image row's whole (W1, W2) correlation
// block on the MXU and gathers the taps from it, because a TPU gathers
// badly; at Middlebury-F that block is 744x744 fp32 a level, more than an
// SM's shared memory, and ~36x the operations the taps need. A GPU gathers
// cheaply, so this samples first and dots second: one warp a pixel, its
// lanes across D with 16-byte loads (8 bf16 or 4 fp32 a lane), the pixel's
// f1 vector held in registers for all levels. Per level a lane sums its
// part of all 2r+2 dots (the loads independent of each other), then the
// warp reduces them together with a butterfly of shuffles (every lane ends
// with the same bits), and lane t writes tap t. Neighbouring pixels of a
// row read overlapping f2 vectors, which the caches serve.
// The volume is never rounded to the feature dtype; it differs from the
// row-product-then-gather only by fp32 association.
#include <cstdint>

#include "corr_taps.cuh"

namespace {

constexpr int kWarps = 8;      // pixels a block
constexpr int kMaxChunks = 4;  // 16-byte vectors a lane holds of f1
constexpr int kMaxTaps = 16;   // 2r+2 positions a level: radius <= 7

template <typename T>
struct Vec;  // the elements of 16 bytes of T
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
};

template <typename T>
struct AltLevels {
  const T* row[rst::kMaxLevels];  // [rows][width[l]][d] per level
  int width[rst::kMaxLevels];
};

// One warp a pixel; NCH 16-byte vectors of f1 a lane (D = 32 * N * NCH at
// most). Per level the lanes first sum their part of all 2r+2 dots, then
// reduce them together, so the loads and the shuffles of the taps overlap.
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32)
    corr_alt_kernel(const float* __restrict__ coords, const T* __restrict__ f1,
                    AltLevels<T> lv, int nlev, int radius, int npix, int w1, int d,
                    float scale, T* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= npix) return;  // the whole warp leaves together
  float a[NCH][N];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int off = (c * 32 + lane) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) a[c][j] = 0.0f;
    if (off < d) Vec<T>::load(f1 + p * d + off, a[c]);
  }
  const long long row = p / w1;
  const float x = coords[p];
  const int k = 2 * radius + 1;
  T* o = out + p * nlev * k;
  for (int l = 0; l < nlev; ++l) {
    const int w = lv.width[l];
    const T* f2 = lv.row[l] + row * w * d;
    const float cl = x * (1.0f / (float)(1 << l));
    const float i0f = floorf(cl);
    const float frac = cl - i0f;
    const float omf = 1.0f - frac;
    // As corr_taps.cuh: far positions give all-zero taps either way; the
    // clamp keeps the integer conversion in range.
    const int pos0 = (int)fminf(fmaxf(i0f, (float)(-radius - 2)), (float)(w + radius + 1)) -
                     radius;
    float v[kMaxTaps];
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      v[t] = 0.0f;
      const int pos = pos0 + t;
      if (t <= k && pos >= 0 && pos < w) {  // the same for every lane
        const T* f = f2 + (long long)pos * d;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int off = (c * 32 + lane) * N;
          if (off < d) {
            float b[N];
            Vec<T>::load(f + off, b);
#pragma unroll
            for (int j = 0; j < N; ++j) v[t] = fmaf(a[c][j], b[j], v[t]);
          }
        }
      }
    }
    // Butterfly sums: every lane ends with the same bits of each dot.
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t)
        if (t <= k) v[t] = __fadd_rn(v[t], __shfl_xor_sync(0xffffffffu, v[t], m));
    }
    // Lane t writes tap t: the lerp of the scaled dots t and t + 1 (a
    // position outside the row is an exact zero, scaled or not).
    float mine = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxTaps - 1; ++t) {
      const float lerp = __fadd_rn(__fmul_rn(__fmul_rn(v[t], scale), omf),
                                   __fmul_rn(__fmul_rn(v[t + 1], scale), frac));
      if (lane == t) mine = lerp;
    }
    if (lane < k) o[l * k + lane] = rst::from_f32<T>(mine);
  }
}

template <typename T, int NCH>
void launch_chunks(unsigned blocks, cudaStream_t stream, const float* coords, const void* f1,
                   const AltLevels<T>& lv, int nlev, int radius, int npix, int w1, int d,
                   float scale, void* out) {
  corr_alt_kernel<T, NCH><<<blocks, kWarps * 32, 0, stream>>>(
      coords, static_cast<const T*>(f1), lv, nlev, radius, npix, w1, d, scale,
      static_cast<T*>(out));
}

template <typename T>
int launch(const float* coords, const void* f1, const void* const* rows, const int* widths,
           int nlev, int radius, int npix, int w1, int d, float scale, void* out,
           cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (nlev < 1 || nlev > rst::kMaxLevels || d < N || d % N || d > 32 * N * kMaxChunks ||
      w1 < 1 || npix % w1 || radius < 0 || 2 * radius + 2 > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  AltLevels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.row[l] = static_cast<const T*>(rows[l]);
    lv.width[l] = widths[l];
  }
  const unsigned blocks = (unsigned)((npix + kWarps - 1) / kWarps);
  const int nch = (d + 32 * N - 1) / (32 * N);
  switch (nch) {
    case 1: launch_chunks<T, 1>(blocks, stream, coords, f1, lv, nlev, radius, npix, w1, d,
                                scale, out); break;
    case 2: launch_chunks<T, 2>(blocks, stream, coords, f1, lv, nlev, radius, npix, w1, d,
                                scale, out); break;
    case 3: launch_chunks<T, 3>(blocks, stream, coords, f1, lv, nlev, radius, npix, w1, d,
                                scale, out); break;
    default: launch_chunks<T, 4>(blocks, stream, coords, f1, lv, nlev, radius, npix, w1, d,
                                 scale, out); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// coords: [npix] fp32 x positions, npix = rows * w1; f1: [npix][d];
// rows[l]: [rows][widths[l]][d], the pooled fmap2 levels; all bf16 when
// is_bf16, else fp32, 16-byte aligned, d a multiple of 8 (bf16) or 4 (fp32)
// up to 1024 or 512; radius at most 7. out: [npix][nlev*(2r+1)] in the same
// dtype. Returns the launch's cudaError_t.
extern "C" int rst_corr_alt(const float* coords, const void* f1, const void* const* rows,
                            const int* widths, int nlev, int radius, int npix, int w1, int d,
                            float scale, int is_bf16, void* out, cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(coords, f1, rows, widths, nlev, radius, npix, w1, d, scale,
                                 out, stream);
  return launch<float>(coords, f1, rows, widths, nlev, radius, npix, w1, d, scale, out,
                       stream);
}
