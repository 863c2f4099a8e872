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
// Design: a windowed row block. The TPU kernel computes each image row's
// whole (W1, W2) correlation block on the MXU and gathers the taps from it.
// This keeps the block but cuts it down to the window that a tile's
// coordinates reach. A block takes a tile of 64 consecutive pixels of one
// image row and reduces their x positions to [min, max]; at level l their
// taps lie in the positions [floor(min / 2^l) - R, floor(max / 2^l) + R + 1]
// of [0, width[l]), which the block walks in chunks.
//   bf16: a producer warp brings the tile's f1 rows into shared memory once
//   (TMA, 64-feature slabs, 128B swizzle) and streams each chunk of 64 f2
//   rows through a ring of slabs; one consumer warpgroup computes the
//   chunk's 64 x 64 dot block with wgmma m64n64k16 (A = f1, B = the chunk,
//   both from shared memory by descriptor; fp32 accumulators in registers),
//   stages it in shared memory, and each pixel takes the dots of its 2R+2
//   positions that fall in the chunk (a pixel whose positions straddle two
//   chunks takes them from both). A product of two bf16 values is exact in
//   fp32, so a dot differs from the plain version's only in the order of
//   its sum.
//   fp32: the same tiles and windows, staged in shared memory by plain
//   loads in chunks of 32 rows (16 where D > 256), each dot summed by one
//   thread with fp32 FMAs (the tensor cores would round the inputs to TF32).
// Then the scale, the lerp and one downcast, and the tile's outputs, which
// are contiguous in `out`, written at once. What that buys over a warp a
// pixel: every f2 vector of a tile's window is read once a tile, not once a
// pixel, and the reduction over D runs in the tensor cores, without
// shuffles. Nothing W^2-sized reaches device memory, and there are no
// atomics: two runs give the same bits. Its worst case is positions spread
// over the whole row: the window is then the row, and the block computes the
// TPU kernel's full row block.
#include <cstdint>

#include "corr_taps.cuh"
#include "enc_conv_sm90.cuh"

namespace rst {
namespace alt {

using bf16 = __nv_bfloat16;

constexpr int kTM = 64;                   // pixels a tile: consecutive, of one image row
constexpr int kTN = 64;                   // bf16: f2 positions a chunk
constexpr int kSlabBytes = 64 * 128;      // 64 rows of a 64-feature bf16 slab
constexpr int kStages = 6;                // f2 slabs in flight
constexpr int kMaxSlabs = 16;             // D <= 1024 (bf16)
constexpr int kMaxTaps = 16;              // 2R+2 positions a level: R <= 7
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kSLd = kTN + 8;             // a staged dot row, floats
constexpr int kF32Threads = 256;
constexpr int kMaxD32 = 512;              // fp32: D <= 512

// A tile's pixels and, per level, the window its taps reach; then, level by
// level, each pixel's first tap position, lerp weight and dots.
struct Tile {
  float x[kTM];
  int lo[kMaxLevels];     // the window's first position
  int nchunks[kMaxLevels];
  int pos0[kTM];
  float frac[kTM];
  float v[kTM][kMaxTaps];  // this level's dots, before the scale
};

struct AltArgs {
  const float* coords;  // [npix]
  int nlev, radius, w1, d;
  int width[kMaxLevels];
  float scale;
  void* out;  // [npix][nlev][2R+1], the features' dtype
};

// The first of a pixel's 2R+2 positions at level l, and its lerp weight.
// Far positions give all-zero taps either way; the clamp keeps the integer
// conversion in range (a NaN lands below the row).
__device__ __forceinline__ int first_pos(float x, int l, int w, int radius, float* frac) {
  const float cl = x * (1.0f / (float)(1 << l));
  const float i0f = floorf(cl);
  *frac = cl - i0f;
  return (int)fminf(fmaxf(i0f, (float)(-radius - 2)), (float)(w + radius + 1)) - radius;
}

// Every thread of the block: the tile's x positions into s.x (0 past the
// row's end) and each level's window, in chunks of `chunk` positions. The
// window is monotone in x, so the tile's smallest and largest positions
// bound it; NaN positions are left out of both (their taps are all zero).
__device__ __forceinline__ void tile_window(Tile& s, float* red, const AltArgs& a, long long p0,
                                            int nvalid, int chunk) {
  const int tid = threadIdx.x;
  if (tid < kTM) {
    const float x = tid < nvalid ? a.coords[p0 + tid] : 0.0f;
    s.x[tid] = x;
    float mn = tid < nvalid ? x : __int_as_float(0x7f800000);
    float mx = tid < nvalid ? x : -__int_as_float(0x7f800000);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if ((tid & 31) == 0) {
      red[tid >> 5] = mn;
      red[2 + (tid >> 5)] = mx;
    }
  }
  __syncthreads();
  if (tid < a.nlev) {
    const int l = tid, w = a.width[l];
    float f;
    const int first = first_pos(fminf(red[0], red[1]), l, w, a.radius, &f);
    const int last = first_pos(fmaxf(red[2], red[3]), l, w, a.radius, &f) + 2 * a.radius + 1;
    const int lo = max(first, 0), hi = min(last, w - 1);
    s.lo[l] = lo;
    s.nchunks[l] = hi >= lo ? (hi - lo) / chunk + 1 : 0;
  }
  __syncthreads();
}

// The pixels [i0, i0 + n) of the tile, by the threads [0, nthreads) of a
// group: their first positions and lerp weights at level l, and zero dots.
__device__ __forceinline__ void level_begin(Tile& s, const AltArgs& a, int l, int i0, int n,
                                            int t, int nthreads) {
  for (int i = t; i < n; i += nthreads)
    s.pos0[i0 + i] = first_pos(s.x[i0 + i], l, a.width[l], a.radius, &s.frac[i0 + i]);
  for (int e = t; e < n * kMaxTaps; e += nthreads) s.v[i0 + e / kMaxTaps][e % kMaxTaps] = 0.0f;
}

// The scaled lerp of the pixels [i0, i0 + n) at level l into the tile's
// output rows (each op rounded to nearest, no fused multiply-add; a
// position outside the row is an exact zero, scaled or not).
template <typename T>
__device__ __forceinline__ void level_end(const Tile& s, const AltArgs& a, int l, int i0, int n,
                                          int t, int nthreads, T* ostage) {
  const int k = 2 * a.radius + 1, row = a.nlev * k;
  for (int e = t; e < n * k; e += nthreads) {
    const int i = i0 + e / k, j = e % k;
    const float frac = s.frac[i], omf = 1.0f - frac;
    const float lerp = __fadd_rn(__fmul_rn(__fmul_rn(s.v[i][j], a.scale), omf),
                                 __fmul_rn(__fmul_rn(s.v[i][j + 1], a.scale), frac));
    ostage[i * row + l * k + j] = from_f32<T>(lerp);
  }
}

// The tile's outputs, contiguous in `out`, by all `nthreads` threads.
template <typename T>
__device__ __forceinline__ void tile_store(const T* ostage, const AltArgs& a, long long p0,
                                           int nvalid, int t, int nthreads) {
  const int row = a.nlev * (2 * a.radius + 1);
  T* out = static_cast<T*>(a.out) + p0 * row;
  for (int e = t; e < nvalid * row; e += nthreads) out[e] = ostage[e];
}

// -- bf16: TMA + wgmma ------------------------------------------------------------------

struct AltMaps {
  CUtensorMap f1;                // [rows][w1][d], box 64 features x 64 pixels
  CUtensorMap lv[kMaxLevels];    // [rows][width[l]][d], box 64 features x 64 positions
};

// Shared memory of a bf16 block: f1's slabs, the f2 ring, the staged dot
// blocks (16 rows a consumer warp), the tile, the outputs, the barriers.
struct Bf16Layout {
  int ring, stage, tile, out, bar, bytes;
};

__host__ __device__ inline Bf16Layout bf16_layout(int nslab, int nlev, int radius) {
  Bf16Layout L;
  L.ring = nslab * kSlabBytes;
  L.stage = L.ring + kStages * kSlabBytes;
  L.tile = L.stage + 4 * 16 * kSLd * 4;
  L.out = L.tile + (int)sizeof(Tile) + 16;  // + the min/max scratch
  L.bar = L.out + (kTM * nlev * (2 * radius + 1) * 2 + 15) / 16 * 16;
  L.bytes = L.bar + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
  return L;
}

// One slab of a chunk: wait for its f2 rows and issue its four k16
// products (A: f1's slab, B: the chunk's, both K-major in shared memory);
// then release the previous slab's stage once its products are done.
__device__ __forceinline__ void slab_step(float (&acc)[32], uint32_t f1base, uint32_t ringbase,
                                          uint64_t* full, uint64_t* empty, int s, int& st,
                                          uint32_t& ph, int& prev, int lane) {
  sm90::mbar_wait(&full[st], ph);
#pragma unroll
  for (int i = 0; i < 32; ++i) sm90::keep(acc[i]);
  sm90::wgmma_fence();
  const uint64_t ad = sm90::desc_sw128(f1base + s * kSlabBytes);
  const uint64_t bd = sm90::desc_sw128(ringbase + st * kSlabBytes);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) sm90::Wgmma<64>::mma(acc, ad + 2 * ks, bd + 2 * ks);
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();  // the previous slab's products are done
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[prev]);
  }
  prev = st;
  if (++st == kStages) st = 0, ph ^= 1;
}

__global__ void __launch_bounds__(kThreads, 2)
    corr_alt_bf16_kernel(const __grid_constant__ AltMaps maps, const AltArgs a, int tiles_x,
                         int nslab) {
  const Bf16Layout L = bf16_layout(nslab, a.nlev, a.radius);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* f1s = smem;
  unsigned char* ring = smem + L.ring;
  Tile& s = *reinterpret_cast<Tile*>(smem + L.tile);
  float* red = reinterpret_cast<float*>(smem + L.tile + sizeof(Tile));
  bf16* ostage = reinterpret_cast<bf16*>(smem + L.out);
  uint64_t* f1_full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* full = f1_full + 1;
  uint64_t* empty = full + kStages;

  const int row = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x % tiles_x) * kTM;
  const int nvalid = min(kTM, a.w1 - x0);
  const long long p0 = (long long)row * a.w1 + x0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sm90::mbar_init(f1_full, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kConsumers / 32);
    }
    sm90::mbar_init_fence();
  }
  tile_window(s, red, a, p0, nvalid, kTN);  // its __syncthreads also publish the barriers

  if (warp == kConsumers / 32) {
    // The producer: f1's slabs once, then every chunk's slabs in the order
    // the consumers take them.
    if (lane == 0) {
      sm90::mbar_expect_tx(f1_full, nslab * kSlabBytes);
      for (int sl = 0; sl < nslab; ++sl)
        sm90::tma_load_3d(f1s + sl * kSlabBytes, &maps.f1, f1_full, sl * 64, x0, row);
      int st = 0;
      uint32_t ph = 0;
      for (int l = 0; l < a.nlev; ++l)
        for (int c = 0; c < s.nchunks[l]; ++c)
          for (int sl = 0; sl < nslab; ++sl) {
            sm90::mbar_wait(&empty[st], ph ^ 1);
            sm90::mbar_expect_tx(&full[st], kSlabBytes);
            sm90::tma_load_3d(ring + st * kSlabBytes, &maps.lv[l], &full[st], sl * 64,
                              s.lo[l] + c * kTN, row);
            if (++st == kStages) st = 0, ph ^= 1;
          }
    }
    return;
  }

  // The consumer warpgroup: warp w owns the tile's pixels [16w, 16w + 16):
  // rows 16w.. of every dot block, their taps and their lerps.
  const int i0 = 16 * warp;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntap = 2 * a.radius + 2;
  float* stg = reinterpret_cast<float*>(smem + L.stage) + warp * 16 * kSLd;
  const uint32_t f1base = sm90::smem_u32(f1s), ringbase = sm90::smem_u32(ring);
  sm90::mbar_wait(f1_full, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int l = 0; l < a.nlev; ++l) {
    level_begin(s, a, l, i0, 16, lane, 32);
    __syncwarp();
    const int w = a.width[l];
    for (int c = 0; c < s.nchunks[l]; ++c) {
      const int c0 = s.lo[l] + c * kTN;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int sl = 0; sl < nslab; ++sl)
        slab_step(acc, f1base, ringbase, full, empty, sl, st, ph, prev, lane);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::keep(acc[i]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);
      // Stage the warp's 16 rows of the block, then take each pixel's taps
      // that fall in the chunk (positions past the row's end read zeros
      // from the TMA fill, but are skipped all the same).
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(stg + g * kSLd + 8 * j + 2 * t4) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(stg + (g + 8) * kSLd + 8 * j + 2 * t4) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();
      const int end = min(c0 + kTN, w);
      for (int e = lane; e < 16 * kMaxTaps; e += 32) {
        const int i = e / kMaxTaps, t = e % kMaxTaps;
        const int pos = s.pos0[i0 + i] + t;
        if (t < ntap && pos >= c0 && pos < end) s.v[i0 + i][t] = stg[i * kSLd + pos - c0];
      }
      __syncwarp();
    }
    level_end(s, a, l, i0, 16, lane, 32, ostage);
    __syncwarp();
  }
  sm90::named_sync(1, kConsumers);
  tile_store(ostage, a, p0, nvalid, threadIdx.x, kConsumers);
}

// -- fp32: CUDA-core FMAs from shared memory --------------------------------------------

// fp32: f2 positions a chunk, fewer for a wide D so that a block fits.
__host__ __device__ inline int f32_chunk(int d) { return d > 256 ? 16 : 32; }

struct F32Layout {
  int f2, tile, out, bytes;
};

__host__ __device__ inline F32Layout f32_layout(int d, int nlev, int radius) {
  F32Layout L;
  L.f2 = kTM * (d + 1) * 4;  // rows padded by a float: lanes on different rows, other banks
  L.tile = L.f2 + f32_chunk(d) * (d + 1) * 4;
  L.out = L.tile + (int)sizeof(Tile) + 16;
  L.bytes = L.out + kTM * nlev * (2 * radius + 1) * 4;
  return L;
}

struct F32Levels {
  const float* row[kMaxLevels];  // [rows][width[l]][d]
};

__global__ void __launch_bounds__(kF32Threads)
    corr_alt_f32_kernel(const float* __restrict__ f1, const F32Levels lv, const AltArgs a,
                        int tiles_x) {
  const F32Layout L = f32_layout(a.d, a.nlev, a.radius);
  extern __shared__ unsigned char smem_raw[];
  float* f1s = reinterpret_cast<float*>(smem_raw);
  float* f2s = reinterpret_cast<float*>(smem_raw + L.f2);
  Tile& s = *reinterpret_cast<Tile*>(smem_raw + L.tile);
  float* red = reinterpret_cast<float*>(smem_raw + L.tile + sizeof(Tile));
  float* ostage = reinterpret_cast<float*>(smem_raw + L.out);

  const int row = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x % tiles_x) * kTM;
  const int nvalid = min(kTM, a.w1 - x0);
  const long long p0 = (long long)row * a.w1 + x0;
  const int tid = threadIdx.x, d = a.d, ld = d + 1;
  const int ntap = 2 * a.radius + 2, chunk = f32_chunk(d);
  tile_window(s, red, a, p0, nvalid, chunk);
  for (int e = tid; e < kTM * d; e += kF32Threads) {
    const int i = e / d;
    f1s[i * ld + e % d] = i < nvalid ? f1[p0 * d + e] : 0.0f;
  }
  for (int l = 0; l < a.nlev; ++l) {
    const int w = a.width[l];
    level_begin(s, a, l, 0, kTM, tid, kF32Threads);
    for (int c = 0; c < s.nchunks[l]; ++c) {
      const int c0 = s.lo[l] + c * chunk;
      const int cnt = min(chunk, w - c0);
      __syncthreads();  // the previous chunk's dots are done with f2s
      const float* src = lv.row[l] + ((long long)row * w + c0) * d;
      for (int e = tid; e < cnt * d; e += kF32Threads) f2s[(e / d) * ld + e % d] = src[e];
      __syncthreads();
      for (int e = tid; e < kTM * kMaxTaps; e += kF32Threads) {
        const int i = e / kMaxTaps, t = e % kMaxTaps;
        const int pos = s.pos0[i] + t;
        if (t < ntap && pos >= c0 && pos < c0 + cnt) {
          const float* fa = f1s + i * ld;
          const float* fb = f2s + (pos - c0) * ld;
          float v = 0.0f;
          for (int k = 0; k < d; ++k) v = fmaf(fa[k], fb[k], v);
          s.v[i][t] = v;
        }
      }
    }
    __syncthreads();
    level_end(s, a, l, 0, kTM, tid, kF32Threads, ostage);
    __syncthreads();
  }
  tile_store(ostage, a, p0, nvalid, tid, kF32Threads);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch_bf16(const void* f1, const void* const* rows, const AltArgs& a, int nrows,
                cudaStream_t stream) {
  const int nslab = (a.d + 63) / 64;
  AltMaps maps;
  std::memset(&maps, 0, sizeof maps);
  const cuuint32_t box[3] = {64, kTM, 1};
  const cuuint64_t fdims[3] = {(cuuint64_t)a.d, (cuuint64_t)a.w1, (cuuint64_t)nrows};
  const cuuint64_t fstrides[2] = {(cuuint64_t)a.d * 2, (cuuint64_t)a.w1 * a.d * 2};
  int err = sm90::cached_map(&maps.f1, f1, 3, fdims, fstrides, box);
  for (int l = 0; l < a.nlev && !err; ++l) {
    if (a.width[l] < 1) continue;  // no position: every tap is zero, nothing is loaded
    const cuuint64_t dims[3] = {(cuuint64_t)a.d, (cuuint64_t)a.width[l], (cuuint64_t)nrows};
    const cuuint64_t strides[2] = {(cuuint64_t)a.d * 2, (cuuint64_t)a.width[l] * a.d * 2};
    err = sm90::cached_map(&maps.lv[l], rows[l], 3, dims, strides, box);
  }
  if (err) return err;
  const int bytes = bf16_layout(nslab, a.nlev, a.radius).bytes;
  err = (int)cudaFuncSetAttribute(corr_alt_bf16_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const int tiles_x = (a.w1 + kTM - 1) / kTM;
  corr_alt_bf16_kernel<<<(unsigned)nrows * tiles_x, kThreads, bytes, stream>>>(maps, a,
                                                                              tiles_x, nslab);
  return (int)cudaGetLastError();
}

int launch_f32(const float* f1, const void* const* rows, const AltArgs& a, int nrows,
               cudaStream_t stream) {
  F32Levels lv{};
  for (int l = 0; l < a.nlev; ++l) lv.row[l] = static_cast<const float*>(rows[l]);
  const int bytes = f32_layout(a.d, a.nlev, a.radius).bytes;
  int err = (int)cudaFuncSetAttribute(corr_alt_f32_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const int tiles_x = (a.w1 + kTM - 1) / kTM;
  corr_alt_f32_kernel<<<(unsigned)nrows * tiles_x, kF32Threads, bytes, stream>>>(
      f1, lv, a, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace alt
}  // namespace rst

// coords: [npix] fp32 x positions, npix = rows * w1; f1: [npix][d];
// rows[l]: [rows][widths[l]][d], the pooled fmap2 levels; all bf16 when
// is_bf16, else fp32, 16-byte aligned, d a multiple of 8 (bf16) or 4 (fp32)
// up to 1024 or 512; radius at most 7. out: [npix][nlev*(2r+1)] in the same
// dtype. Returns the launch's cudaError_t.
extern "C" int rst_corr_alt(const float* coords, const void* f1, const void* const* rows,
                            const int* widths, int nlev, int radius, int npix, int w1, int d,
                            float scale, int is_bf16, void* out, cudaStream_t stream) {
  using namespace rst::alt;
  const int vec = is_bf16 ? 8 : 4;
  const int dmax = is_bf16 ? 64 * kMaxSlabs : kMaxD32;
  if (nlev < 1 || nlev > rst::kMaxLevels || d < vec || d % vec || d > dmax || w1 < 1 ||
      npix < w1 || npix % w1 || radius < 0 || 2 * radius + 2 > kMaxTaps || !aligned16(f1))
    return (int)cudaErrorInvalidValue;
  AltArgs a{};
  a.coords = coords;
  a.nlev = nlev;
  a.radius = radius;
  a.w1 = w1;
  a.d = d;
  a.scale = scale;
  a.out = out;
  for (int l = 0; l < nlev; ++l) {
    if (widths[l] < 0 || (widths[l] > 0 && !aligned16(rows[l])))
      return (int)cudaErrorInvalidValue;
    a.width[l] = widths[l];
  }
  if (is_bf16) return launch_bf16(f1, rows, a, npix / w1, stream);
  return launch_f32(static_cast<const float*>(f1), rows, a, npix / w1, stream);
}
