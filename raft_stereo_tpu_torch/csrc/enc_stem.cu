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
// Design: the TPU kernel builds tap-major patches of two pixel parities in
// VMEM from even/odd column halves and contracts them row by row. Here a
// block holds the (160 x 64) weight matrix (147 taps, zero rows up to a
// multiple of 16) in shared memory for its whole life and walks over tiles
// of 64 consecutive pixels in grid stride: it gathers the tile's (64 x 160)
// patch matrix from the image (a tap row dy of a pixel is 21 consecutive
// values of an image row, so K runs dy-major, then dx, then channel), runs
// WMMA bf16 tiles over it, and writes bias-added, rounded outputs. Each
// input value is fetched 49 times, from L1/L2: the image is 6 bytes a pixel,
// the output 128. Statistics as in enc_pass.cu (enc_stats.cuh): a thread
// sums its one channel over all its tiles, the block writes one row of
// partials, a second launch adds the rows in fp64. The grid is a constant,
// not the card's SM count, so the partial sums, and the bits of the
// statistics, are the same on every card.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "enc_stats.cuh"

namespace rst {

using bf16 = __nv_bfloat16;

constexpr int kStemThreads = 256;
constexpr int kStemBM = 64;    // pixels a tile
constexpr int kStemTaps = 147;  // 7 * 7 * 3
constexpr int kStemK = 160;    // taps padded to the WMMA depth
constexpr int kStemN = 64;     // output channels
constexpr int kStemLDA = kStemK + 8;
constexpr int kStemLDB = kStemN + 8;
constexpr int kStemLDC = kStemN + 4;
constexpr int kStemBlocks = 528;  // 4 blocks on each of an H100's 132 SMs

__global__ void __launch_bounds__(kStemThreads)
    enc_stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, int H, int W, bf16* __restrict__ out,
                    float* partial) {
  using namespace nvcuda;
  static_assert(kStemBM * kStemLDA * 2 >= kStemBM * kStemLDC * 4, "Cs must fit in As");
  static_assert(kStemThreads % kStemN == 0, "a thread's outputs must share one channel");
  __shared__ __align__(128) bf16 As[kStemBM * kStemLDA];
  __shared__ __align__(128) bf16 Bs[kStemK * kStemLDB];
  __shared__ int py[kStemBM], px[kStemBM];
  float* Cs = reinterpret_cast<float*>(As);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 4 warps down the 64 pixels
  const int wn = warp % 2;  // 2 across the 64 channels
  for (int idx = tid; idx < kStemK * kStemN / 8; idx += kStemThreads) {
    const int r = idx / (kStemN / 8);
    const int c = (idx % (kStemN / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + r * kStemLDB + c) =
        *reinterpret_cast<const uint4*>(w + r * kStemN + c);
  }

  const int npix = H * W;
  const int ntiles = (npix + kStemBM - 1) / kStemBM;
  const int rowlen = W * 3;
  float s = 0.0f, s2 = 0.0f;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile * kStemBM;
    if (tid < kStemBM) {
      const int p = m0 + tid;
      py[tid] = p < npix ? p / W : -8;  // -8: every tap row falls outside the image
      px[tid] = p < npix ? p % W : 0;
    }
    __syncthreads();
    for (int idx = tid; idx < kStemBM * kStemK; idx += kStemThreads) {
      const int r = idx / kStemK;
      const int k = idx % kStemK;
      const int sy = py[r] + k / 21 - 3;
      const int sc = (px[r] - 3) * 3 + k % 21;
      bf16 v = __float2bfloat16(0.0f);
      if (k < kStemTaps && sy >= 0 && sy < H && sc >= 0 && sc < rowlen)
        v = x[(size_t)sy * rowlen + sc];
      As[r * kStemLDA + k] = v;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kStemK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, As + wm * 16 * kStemLDA + kk, kStemLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, Bs + kk * kStemLDB + wn * 32 + j * 16, kStemLDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();  // every warp has read As before Cs overwrites it
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + wm * 16 * kStemLDC + wn * 32 + j * 16, acc[j], kStemLDC,
                              wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < kStemBM * kStemN; idx += kStemThreads) {
      const int r = idx / kStemN;
      const int c = idx % kStemN;
      const int p = m0 + r;
      if (p < npix) {
        const float v = __fadd_rn(Cs[r * kStemLDC + c], bias[c]);
        out[(size_t)p * kStemN + c] = __float2bfloat16(v);
        s = __fadd_rn(s, v);
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
      }
    }
    __syncthreads();  // Cs is read out before the next tile's patches land
  }
  if (partial != nullptr) {
    float* row = partial + (size_t)blockIdx.x * 2 * kStemN;
    block_stats_store<kStemN, kStemThreads>(s, s2, Cs, row, row + kStemN);
  }
}

}  // namespace rst

using rst::bf16;

// x: [H][W][3] bf16; w: [160][64] bf16, row (dy * 7 + dx) * 3 + ci, rows from
// 147 on zero; bias: [64] fp32; out: [H][W][64] bf16. With partial != null
// ([min(ceil(H*W/64), 528)][2][64] fp32 scratch, a row a block) the sums
// land in stats ([2][64] fp32). Returns the first non-zero cudaError_t.
extern "C" int rst_enc_stem(const bf16* x, const bf16* w, const float* bias, int H, int W,
                            bf16* out, float* partial, float* stats, cudaStream_t stream) {
  const int ntiles = (H * W + rst::kStemBM - 1) / rst::kStemBM;
  const int blocks = ntiles < rst::kStemBlocks ? ntiles : rst::kStemBlocks;
  rst::enc_stem_kernel<<<blocks, rst::kStemThreads, 0, stream>>>(x, w, bias, H, W, out, partial);
  const int err = (int)cudaGetLastError();
  if (err || partial == nullptr) return err;
  return rst::launch_stats_reduce(partial, blocks, rst::kStemN, rst::kStemN, stats, stream);
}
