// Correlation-pyramid lookup for reg_cuda.
//
// Replaces raft_stereo_tpu/corr/pallas_reg.py:_lookup_kernel in its plain
// mode (gather_lerp_taps) and its packed8 mode (gather_lerp_taps_packed8:
// int8 levels, RAFT_CORR_PACK8); driven by _pallas_lookup. The per-tap
// arithmetic is corr_taps.cuh's (tap_coord, tap_f32, lerp_tap), shared with
// the resident iteration. Output channels are level-major, then offset
// -r..r.
//
// What bounds it on an H100: latency and sectors, not bandwidth. The useful
// traffic is small (the coords, 2r+2 taps a level and the outputs: ~156 B a
// pixel at 4 levels, radius 4, bf16), but every pixel's taps sit in a
// different volume row, so a level's window costs whole 32-byte sectors
// (1.56 on average for 20 bf16 bytes), and nothing is reused.
//
// Design: the TPU kernel streams whole pyramid rows through VMEM and selects
// the tap window with lane gathers. Here a block takes 64 pixels, one thread
// a (pixel, level), the levels of a pixel on neighbouring threads. A thread
// reads its coordinate (the levels of a pixel ask for the same word, one
// request), then its 2r+2 taps as a window of aligned 16-byte units, all
// issued before the first lerp: bf16 takes at most 3 units, int8 2, fp32 4
// at radius 4, so one round trip brings them. The units are realigned in
// registers by the window's byte offset (word selects and a funnel shift)
// and the taps taken out at fixed places. A unit is rounded down to 16 bytes
// and may start before the row; one not wholly inside the level tensor's
// bytes is put together a byte at a time, so nothing outside the tensor is
// read. The block's 2r+1 outputs a (pixel, level) are staged in shared
// memory, and the block's span, which is contiguous, leaves as 16-byte
// stores.
#include <cstdint>

#include "corr_taps.cuh"

namespace {

using rst::Levels;
using rst::TapCoord;

constexpr int kPixels = 64;  // pixels a block; kPixels * sizeof(bf16) is a multiple of 16

// A window of NU 16-byte units of a level of type T: the taps it can hold
// from any starting byte (2r + 2 at most), and the 32-bit words they fill
// once realigned.
template <typename T, int NU>
struct Window {
  static constexpr int kTaps = (16 * NU - (16 - (int)sizeof(T))) / (int)sizeof(T);
  static constexpr int kWords = (kTaps * (int)sizeof(T) + 3) / 4;
};

// Units each level type reads at radius 4 or less, and for wider windows.
template <typename T>
constexpr int kNarrowUnits = sizeof(T) == 1 ? 2 : sizeof(T) == 2 ? 3 : 4;
constexpr int kWideUnits = 8;

// The 16-byte unit at u, its bytes outside [lo, hi) zero, a byte at a time.
__device__ __forceinline__ uint4 load_edge(uintptr_t u, uintptr_t lo, uintptr_t hi) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uintptr_t a = u + b;
    if (a >= lo && a < hi)
      w[b >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>(a) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Tap t's bits from the realigned words.
template <typename T>
__device__ __forceinline__ T tap_bits(const uint32_t* a, int t);
template <>
__device__ __forceinline__ __nv_bfloat16 tap_bits<__nv_bfloat16>(const uint32_t* a, int t) {
  return __ushort_as_bfloat16((unsigned short)(a[t >> 1] >> (16 * (t & 1))));
}
template <>
__device__ __forceinline__ int8_t tap_bits<int8_t>(const uint32_t* a, int t) {
  return (int8_t)(uint8_t)(a[t >> 2] >> (8 * (t & 3)));
}
template <>
__device__ __forceinline__ float tap_bits<float>(const uint32_t* a, int t) {
  return __uint_as_float(a[t]);
}

// A (pixel, level)'s window of taps as loaded: the NU units from the one
// that holds its first tap's byte, and what the lerp needs besides.
template <typename T, int NU>
struct TapWindow {
  uint32_t raw[4 * NU + 4];  // 4 zero words past the units, for the realign
  TapCoord c;
  int off;  // the first tap's byte in the first unit
  int w;
  float scale;
};

// Issues the loads of pixel p's window at level l.
template <typename T, int NU>
__device__ __forceinline__ void load_window(const Levels<T>& lv, int l, int p, float x,
                                            int radius, int npix, TapWindow<T, NU>& win) {
  constexpr int S = (int)sizeof(T);
  const int w = lv.width[l];
  win.w = w;
  win.scale = rst::level_scale(lv, l, p);
  win.c = rst::tap_coord(x, l, w, radius);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(lv.row[l]);
  const uintptr_t hi = lo + (size_t)npix * w * S;
  const uintptr_t start = lo + (uintptr_t)(((long long)p * w + win.c.pos) * S);
  const uintptr_t first = start & ~(uintptr_t)15;
  const int n = (int)((start + (2 * radius + 2) * S - 1 - first) >> 4) + 1;  // units with taps
  win.off = (int)(start & 15);
  if (first >= lo && first + 16 * n <= hi) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const uint4 v = u < n ? __ldg(reinterpret_cast<const uint4*>(first) + u)
                            : make_uint4(0u, 0u, 0u, 0u);
      win.raw[4 * u] = v.x, win.raw[4 * u + 1] = v.y;
      win.raw[4 * u + 2] = v.z, win.raw[4 * u + 3] = v.w;
    }
  } else {  // the window reaches past the tensor's first or last byte
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const uint4 v = u < n ? load_edge(first + 16 * u, lo, hi) : make_uint4(0u, 0u, 0u, 0u);
      win.raw[4 * u] = v.x, win.raw[4 * u + 1] = v.y;
      win.raw[4 * u + 2] = v.z, win.raw[4 * u + 3] = v.w;
    }
  }
#pragma unroll
  for (int j = 4 * NU; j < 4 * NU + 4; ++j) win.raw[j] = 0u;
}

// The window's 2r+1 lerped taps, written to o[0 .. 2r].
template <typename T, typename O, int NU>
__device__ __forceinline__ void lerp_window(const TapWindow<T, NU>& win, int radius, O* o) {
  using Win = Window<T, NU>;
  // Realign: word j of the window starts at byte off + 4j of the units.
  const int ws = win.off >> 2, shift = 8 * (win.off & 3);
  uint32_t a[Win::kWords];
#pragma unroll
  for (int j = 0; j < Win::kWords; ++j) {
    const uint32_t w0 = win.raw[j], w1 = win.raw[j + 1], w2 = win.raw[j + 2];
    const uint32_t w3 = win.raw[j + 3], w4 = win.raw[j + 4];
    const uint32_t lo_w = ws == 0 ? w0 : ws == 1 ? w1 : ws == 2 ? w2 : w3;
    const uint32_t hi_w = ws == 0 ? w1 : ws == 1 ? w2 : ws == 2 ? w3 : w4;
    a[j] = __funnelshift_r(lo_w, hi_w, shift);
  }
  const TapCoord& c = win.c;
  const int k = 2 * radius + 1;
  float prev =
      (c.pos >= 0 && c.pos < win.w) ? rst::tap_f32(tap_bits<T>(a, 0), win.scale) : 0.0f;
#pragma unroll
  for (int t = 0; t < Win::kTaps - 1; ++t) {
    if (t >= k) break;
    const int q = c.pos + t + 1;
    const float next =
        (q >= 0 && q < win.w) ? rst::tap_f32(tap_bits<T>(a, t + 1), win.scale) : 0.0f;
    o[t] = rst::from_f32<O>(rst::lerp_tap(prev, next, c));
    prev = next;
  }
}

// Writes the block's staged outputs, one contiguous span of out that starts
// 16-byte aligned (kPixels outputs of 2 or 4 bytes; out is), as 16-byte
// stores; a last block's span may end inside a 16-byte unit.
template <typename O>
__device__ __forceinline__ void store_span(const unsigned char* stage, int span, O* dst) {
  for (int i = threadIdx.x; i < span / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
  for (int i = (span & ~15) / (int)sizeof(O) + threadIdx.x; i < span / (int)sizeof(O);
       i += blockDim.x)
    dst[i] = reinterpret_cast<const O*>(stage)[i];
}

template <typename T, typename O, int NU>
__global__ void __launch_bounds__(kPixels* rst::kMaxLevels)
    corr_lookup_kernel(const float* __restrict__ coords, const __grid_constant__ Levels<T> lv,
                       int radius, int npix, O* __restrict__ out) {
  // lv is read where it lies (__grid_constant__): a copy indexed by each
  // thread's level would sit in local memory.
  extern __shared__ __align__(16) unsigned char stage[];
  const int nlev = lv.nlev;
  const int k = 2 * radius + 1;
  const int p0 = blockIdx.x * kPixels;
  const int count = min(kPixels, npix - p0);
  const int px = threadIdx.x / nlev;
  const int l = threadIdx.x % nlev;
  if (px < count) {
    TapWindow<T, NU> win;
    load_window(lv, l, p0 + px, coords[p0 + px], radius, npix, win);
    lerp_window<T, O, NU>(win, radius, reinterpret_cast<O*>(stage) + (px * nlev + l) * k);
  }
  __syncthreads();
  store_span(stage, count * nlev * k * (int)sizeof(O), out + (size_t)p0 * nlev * k);
}

template <typename T, typename O, int NU>
int launch_units(const float* coords, const Levels<T>& lv, int radius, int npix, O* out,
                 cudaStream_t stream) {
  const int threads = kPixels * lv.nlev;
  const size_t smem = (size_t)kPixels * lv.nlev * (2 * radius + 1) * sizeof(O);
  auto kernel = corr_lookup_kernel<T, O, NU>;
  if (smem > 48 * 1024) {
    const int err =
        (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  kernel<<<(unsigned)((npix + kPixels - 1) / kPixels), threads, smem, stream>>>(coords, lv, radius,
                                                                                npix, out);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch(const float* coords, const void* const* rows, const int* widths, int nlev,
           int radius, int npix, const float* scales, int sample_pixels, void* out,
           cudaStream_t stream) {
  if (nlev < 1 || nlev > rst::kMaxLevels || radius < 0 || npix < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels<T> lv{};
  for (int l = 0; l < nlev; ++l) {
    lv.row[l] = static_cast<const T*>(rows[l]);
    lv.width[l] = widths[l];
  }
  lv.scale = scales;
  lv.sample_pixels = sample_pixels;
  lv.nlev = nlev;
  O* o = static_cast<O*>(out);
  if (2 * radius + 2 <= Window<T, kNarrowUnits<T>>::kTaps)
    return launch_units<T, O, kNarrowUnits<T>>(coords, lv, radius, npix, o, stream);
  if (2 * radius + 2 <= Window<T, kWideUnits>::kTaps)
    return launch_units<T, O, kWideUnits>(coords, lv, radius, npix, o, stream);
  return (int)cudaErrorInvalidValue;  // wider than corr/reg_cuda.py MAX_RADIUS allows
}

}  // namespace

// coords: [npix] fp32 x positions; rows[l]: [npix][widths[l]]; mode 0:
// fp32 levels, 1: bf16 levels, 2: int8 levels with scales [B][nlev] fp32
// (sample_pixels pixels a sample). out: [npix][nlev*(2r+1)] in the levels'
// dtype, bf16 for int8, 16-byte aligned. radius: at most 13 (fp32's wide
// window). Returns the launch's cudaError_t.
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
