// Correlation-pyramid lookup for reg_cuda.
//
// Replaces raft_stereo_tpu/corr/pallas_reg.py:_lookup_kernel in its plain
// mode (gather_lerp_taps) and its packed8 mode (gather_lerp_taps_packed8:
// int8 levels, RAFT_CORR_PACK8); driven by _pallas_lookup. The per-pixel
// arithmetic is gather_level_taps (corr_taps.cuh), shared with the
// resident iteration. Output channels are level-major, then offset -r..r.
//
// What bounds it on an H100: bytes, and at these sizes the launch itself.
// The useful traffic is small (the coords, 2r+2 taps per level and the
// outputs: ~160 B a pixel at 4 levels, radius 4), but every pixel's taps sit
// in a different volume row, so each level costs at least one 32-byte sector
// per pixel, a few times the useful bytes. int8 levels halve the taps'
// bytes against bf16, which at 10 taps a level mostly stay in one sector.
//
// Design: the TPU kernel streams whole pyramid rows through VMEM and selects
// the tap window with lane gathers. Here one thread handles one (pixel,
// level) and reads only its 2r+2 taps; threads are ordered pixel-major so a
// warp's outputs are contiguous.
#include <cstdint>

#include "corr_taps.cuh"

namespace {

template <typename T, typename O>
__global__ void corr_lookup_kernel(const float* __restrict__ coords, rst::Levels<T> lv,
                                   int nlev, int radius, int npix, O* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)npix * nlev) return;
  const int p = (int)(idx / nlev);
  const int l = (int)(idx % nlev);
  const int k = 2 * radius + 1;
  rst::gather_level_taps(lv, l, p, coords[p], radius, out + (size_t)p * nlev * k + (size_t)l * k);
}

template <typename T, typename O>
int launch(const float* coords, const void* const* rows, const int* widths, int nlev,
           int radius, int npix, const float* scales, int sample_pixels, void* out,
           cudaStream_t stream) {
  if (nlev < 1 || nlev > rst::kMaxLevels) return (int)cudaErrorInvalidValue;
  rst::Levels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.row[l] = static_cast<const T*>(rows[l]);
    lv.width[l] = widths[l];
  }
  lv.scale = scales;
  lv.sample_pixels = sample_pixels;
  lv.nlev = nlev;
  const long long total = (long long)npix * nlev;
  const int threads = 256;
  corr_lookup_kernel<T, O><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      coords, lv, nlev, radius, npix, static_cast<O*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// coords: [npix] fp32 x positions; rows[l]: [npix][widths[l]]; mode 0:
// fp32 levels, 1: bf16 levels, 2: int8 levels with scales [B][nlev] fp32
// (sample_pixels pixels a sample). out: [npix][nlev*(2r+1)] in the levels'
// dtype, bf16 for int8. Returns the launch's cudaError_t.
extern "C" int rst_corr_lookup(const float* coords, const void* const* rows, const int* widths,
                               int nlev, int radius, int npix, int mode, const float* scales,
                               int sample_pixels, void* out, cudaStream_t stream) {
  if (mode == 2) {
    if (scales == nullptr || sample_pixels < 1) return (int)cudaErrorInvalidValue;
    return launch<int8_t, __nv_bfloat16>(coords, rows, widths, nlev, radius, npix, scales,
                                         sample_pixels, out, stream);
  }
  if (mode == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(coords, rows, widths, nlev, radius, npix,
                                                nullptr, 1, out, stream);
  return launch<float, float>(coords, rows, widths, nlev, radius, npix, nullptr, 1, out,
                              stream);
}
