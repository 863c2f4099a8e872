// Correlation-pyramid lookup for reg_cuda.
//
// Replaces raft_stereo_tpu/corr/pallas_reg.py:_lookup_kernel (plain mode,
// gather_lerp_taps; driven by _pallas_lookup). Per pixel and level l:
//   cl = x / 2^l, i0 = floor(cl), frac = cl - i0
//   tap t = row[i0 - r + t] for t in [0, 2r + 1], zero where the position
//           is < 0 or >= the level's true width
//   out[t] = tap[t] * (1 - frac) + tap[t + 1] * frac   (fp32, one downcast)
// Output channels are level-major, then offset -r..r.
//
// What bounds it on an H100: bytes, and at these sizes the launch itself.
// The useful traffic is small (the coords, 2r+2 taps per level and the
// outputs: ~160 B a pixel at 4 levels, radius 4), but every pixel's taps sit
// in a different volume row, so each level costs at least one 32-byte sector
// per pixel, a few times the useful bytes.
//
// Design: the TPU kernel streams whole pyramid rows through VMEM and selects
// the tap window with lane gathers. Here one thread handles one (pixel,
// level) and reads only its 2r+2 taps; threads are ordered pixel-major so a
// warp's outputs are contiguous. The lerp uses explicit round-to-nearest
// multiplies and adds so no fused multiply-add changes its rounding.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;

template <typename T>
struct Levels {
  const T* row[kMaxLevels];  // [npix][width[l]] per level, unpadded
  int width[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void corr_lookup_kernel(const float* __restrict__ coords, Levels<T> lv, int nlev,
                                   int radius, int npix, T* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)npix * nlev) return;
  const int p = (int)(idx / nlev);
  const int l = (int)(idx % nlev);
  const int k = 2 * radius + 1;
  const int w = lv.width[l];
  const T* row = lv.row[l] + (size_t)p * w;
  const float cl = coords[p] * (1.0f / (float)(1 << l));
  const float i0f = floorf(cl);
  const float frac = cl - i0f;
  const float omf = 1.0f - frac;
  // Positions this far outside the row give all-zero taps either way; the
  // clamp only keeps the integer conversion in range.
  const int i0 = (int)fminf(fmaxf(i0f, (float)(-radius - 2)), (float)(w + radius + 1));
  T* o = out + (size_t)p * nlev * k + (size_t)l * k;
  int pos = i0 - radius;
  float prev = (pos >= 0 && pos < w) ? to_f32(row[pos]) : 0.0f;
  for (int t = 0; t < k; ++t) {
    ++pos;
    const float next = (pos >= 0 && pos < w) ? to_f32(row[pos]) : 0.0f;
    o[t] = from_f32<T>(__fadd_rn(__fmul_rn(prev, omf), __fmul_rn(next, frac)));
    prev = next;
  }
}

template <typename T>
int launch(const float* coords, const void* const* rows, const int* widths, int nlev,
           int radius, int npix, void* out, cudaStream_t stream) {
  if (nlev < 1 || nlev > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.row[l] = static_cast<const T*>(rows[l]);
    lv.width[l] = widths[l];
  }
  const long long total = (long long)npix * nlev;
  const int threads = 256;
  corr_lookup_kernel<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      coords, lv, nlev, radius, npix, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// coords: [npix] fp32 x positions; rows[l]: [npix][widths[l]] in the
// volume's dtype (bf16 when is_bf16, else fp32); out: [npix][nlev*(2r+1)]
// in the same dtype. Returns the launch's cudaError_t.
extern "C" int rst_corr_lookup(const float* coords, const void* const* rows, const int* widths,
                               int nlev, int radius, int npix, int is_bf16, void* out,
                               cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(coords, rows, widths, nlev, radius, npix, out, stream);
  return launch<float>(coords, rows, widths, nlev, radius, npix, out, stream);
}
