// Shared 3x3 convolution engine for the GRU and motion-encoder kernels.
//
// An implicit GEMM over NHWC bf16 activations: one output tile is BM output
// pixels (flat over B*H*W) by BN output channels, computed by walking K = 9
// taps x the input channels in BK-wide steps. Each step's A tile (BM pixels
// x BK channels, zero where the tap falls outside the image: conv zero
// padding) and B tile (BK x BN weights) are copied into a ring of STAGES
// shared-memory tiles with cp.async, so the copies of the next steps overlap
// the current one's WMMA bf16 tiles (mma.sync on Hopper), which accumulate
// in fp32. The fp32 accumulators go through shared memory to an epilogue
// functor that applies the caller's bias, nonlinearity and rounding per
// (pixel, channel) and writes the outputs.
//
// The input is a virtual channel concat of up to four NHWC tensors, so a
// caller's parts are never concatenated in device memory. Output columns
// below `n_split` read input channels [k0a, k1a) of that concat, the others
// [k0b, k1b): the GRU's q gate skips the hidden-state channels, and the
// motion encoder's block-diagonal stage-2 conv reads only its own branch.
// One part may instead be computed while its A tiles are loaded (the `Src`
// policy): the gru16+32 kernel builds the upsampled gru32 state there.
//
// conv3x3_tile computes one (BM x BN) tile. conv3x3_kernel runs one tile
// per block (the serial kernels, one launch per stage); the persistent
// kernels (gru1632.cu, resident.cu) run conv3x3_stage, a grid-stride loop
// over the same tiles, between grid barriers. Both reach the same code, so
// the K-step order, the tile shape and the epilogue arithmetic are the same
// and the two routes agree bit for bit.
//
// TMA copies, wgmma and warp specialisation are later work.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "rounding.cuh"

namespace rst {

constexpr int kMaxParts = 4;

struct ConvIn {
  const bf16* ptr[kMaxParts];  // NHWC parts of the virtual input concat
  int cin[kMaxParts];          // channels of each part, multiples of BK
  int nparts;
  int B, H, W;         // geometry shared by the parts and the output
  const bf16* w;       // [9][ctot][npad]: tap-major, input channel, output channel
  int ctot, npad;      // npad: a multiple of the block's BN
  int n_split, k0a, k1a, k0b, k1b;
};

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 3;  // depth of the shared-memory ring of K steps

// Weight matrices carry their output columns zero-padded to this multiple.
inline int pad64(int n) { return (n + 63) / 64 * 64; }

// Shared memory of one tile at output width BN: the ring, reused for the
// fp32 accumulators once the K loop is done.
template <int BN>
struct TileSmem {
  static constexpr int LDA = BK + 8;  // bf16 elements; keeps rows 16 B aligned
  static constexpr int LDB = BN + 8;
  static constexpr int LDC = BN + 4;  // floats
  static constexpr int STAGE = BM * LDA + BK * LDB;  // bf16 elements per stage
  static constexpr int AB = STAGES * STAGE * 2;
  static constexpr int C = BM * LDC * 4;
  static constexpr int BYTES = AB > C ? AB : C;
};

// Asynchronous 16-byte global->shared copy; with pred false it writes
// zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The default A-tile source: every part is a tensor in device memory. A
// computed source (kComputed) writes the 8 bf16 values of one (pixel,
// 8-channel) slot of its part with load8.
struct CopySrc {
  static constexpr bool kComputed = false;
  int part = -1;
  __device__ void load8(bf16*, int, int, int, int) const {}
};

template <int BN, class Epi, class Src = CopySrc>
__device__ __forceinline__ void conv3x3_tile(const ConvIn& a, const Epi& epi, int mtile,
                                             int ntile, unsigned char* smem,
                                             const Src& src_policy = Src{}) {
  using namespace nvcuda;
  using S = TileSmem<BN>;
  constexpr int WARPS_N = BN >= 32 ? 2 : 1;
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int LDA = S::LDA;
  constexpr int LDB = S::LDB;
  constexpr int LDC = S::LDC;
  constexpr int STAGE = S::STAGE;
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int npix = a.B * a.H * a.W;
  const int m0 = mtile * BM;
  const int n0 = ntile * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const bool lower = n0 < a.n_split;
  const int kbeg = lower ? a.k0a : a.k0b;
  const int kend = lower ? a.k1a : a.k1b;
  const int nchunks = (kend - kbeg) / BK;
  const int nsteps = 9 * nchunks;

  // Each thread copies the same AVEC (pixel, 8-channel) slots of every A
  // tile, so its pixels' coordinates are decoded once.
  constexpr int AVEC = BM * BK / 8 / THREADS;
  int arow[AVEC], acol[AVEC], ay[AVEC], ax[AVEC], aimg[AVEC];
  bool aok[AVEC];
#pragma unroll
  for (int v = 0; v < AVEC; ++v) {
    const int idx = tid + v * THREADS;
    arow[v] = idx / (BK / 8);
    acol[v] = (idx % (BK / 8)) * 8;
    const int p = m0 + arow[v];
    aok[v] = p < npix;
    const int pp = aok[v] ? p : 0;
    ax[v] = pp % a.W;
    const int t = pp / a.W;
    ay[v] = t % a.H;
    aimg[v] = (t / a.H) * a.H;
  }

  // Queue the copies of K step `step` (tap, channel chunk) into a stage.
  auto load_step = [&](int step, int stage) {
    const int tap = step / nchunks;
    const int kc = kbeg + (step % nchunks) * BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    int part = 0, off = 0;
    while (part + 1 < a.nparts && kc >= off + a.cin[part]) {
      off += a.cin[part];
      ++part;
    }
    const bf16* src = a.ptr[part];
    const int cin = a.cin[part];
    const int cl = kc - off;
    bf16* As = stages + stage * STAGE;
    bf16* Bs = As + BM * LDA;
    if (Src::kComputed && part == src_policy.part) {
      // Built in registers and stored; the __syncthreads before the step
      // is consumed makes the stores visible, as it does the copies.
#pragma unroll
      for (int v = 0; v < AVEC; ++v) {
        const int sy = ay[v] + dy;
        const int sx = ax[v] + dx;
        const bool in = aok[v] && sy >= 0 && sy < a.H && sx >= 0 && sx < a.W;
        bf16* d = As + arow[v] * LDA + acol[v];
        if (in)
          src_policy.load8(d, aimg[v] / a.H, sy, sx, cl + acol[v]);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll
      for (int v = 0; v < AVEC; ++v) {
        const int sy = ay[v] + dy;
        const int sx = ax[v] + dx;
        const bool in = aok[v] && sy >= 0 && sy < a.H && sx >= 0 && sx < a.W;
        const bf16* g =
            in ? src + ((size_t)(aimg[v] + sy) * a.W + sx) * cin + cl + acol[v] : src;
        cp_async16(As + arow[v] * LDA + acol[v], g, in);
      }
    }
    for (int idx = tid; idx < BK * BN / 8; idx += THREADS) {
      const int r = idx / (BN / 8);
      const int c = (idx % (BN / 8)) * 8;
      cp_async16(Bs + r * LDB + c, a.w + ((size_t)tap * a.ctot + kc + r) * a.npad + n0 + c, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // A ring of STAGES tiles: the copies of the next STAGES-1 steps are in
  // flight while the tensor cores work on the current one. One commit group
  // per step (empty past the end) keeps the wait count uniform.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_step(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tile has landed; the stage refilled below is free
    const int next = step + STAGES - 1;
    if (next < nsteps) load_step(next, next % STAGES);
    cp_async_commit();
    const bf16* As = stages + (step % STAGES) * STAGE;
    const bf16* Bs = As + BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before Cs reuses it

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    const int p = m0 + r;
    if (p < npix) epi(p, n0 + c, Cs[r * LDC + c]);
  }
  __syncthreads();  // Cs is read out before a next tile refills the ring
}

template <int BN, class Epi>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(ConvIn a, Epi epi) {
  __shared__ __align__(128) unsigned char smem[TileSmem<BN>::BYTES];
  conv3x3_tile<BN>(a, epi, blockIdx.x, blockIdx.y, smem);
}

// Launches the engine on `stream`, one block per tile, and returns the
// launch's cudaError_t.
template <int BN, class Epi>
inline int launch_conv3x3(const ConvIn& a, const Epi& epi, cudaStream_t stream) {
  const int npix = a.B * a.H * a.W;
  dim3 grid((npix + BM - 1) / BM, a.npad / BN);
  conv3x3_kernel<BN, Epi><<<grid, THREADS, 0, stream>>>(a, epi);
  return (int)cudaGetLastError();
}

inline __host__ __device__ int conv3x3_tiles(const ConvIn& a, int bn) {
  return (a.B * a.H * a.W + BM - 1) / BM * (a.npad / bn);
}

// One stage of a persistent kernel: every tile of the launch above. Blocks
// take tiles in the launch's order (pixel tiles fastest) from a counter in
// device memory, zeroed before the launch, so a block that drew short tiles
// takes more, as the hardware's block scheduler would do for the launch.
template <int BN, class Epi, class Src = CopySrc>
__device__ __forceinline__ void conv3x3_stage(const ConvIn& a, const Epi& epi, unsigned char* smem,
                                              unsigned int* counter, const Src& src = Src{}) {
  __shared__ int tile;
  const int mt = (a.B * a.H * a.W + BM - 1) / BM;
  const int total = mt * (a.npad / BN);
  for (;;) {
    if (threadIdx.x == 0) tile = (int)atomicAdd(counter, 1u);
    __syncthreads();
    const int t = tile;
    if (t >= total) break;  // the tile ends in __syncthreads before `tile` is redrawn
    conv3x3_tile<BN>(a, epi, t % mt, t / mt, smem, src);
  }
}

}  // namespace rst
