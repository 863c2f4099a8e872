// Per-channel sum and sum of squares of a conv's fp32 outputs, without
// floating-point atomics: the encoder kernels (enc_stem.cu, enc_pass.cu)
// feed instance norm with them, and two runs on the same input must give
// the same bits.
//
// Two steps, each in a fixed order. A block adds up what its threads
// summed over their own outputs and writes one row of partials,
// partial[row][0][c] (sum) and partial[row][1][c] (sum of squares), fp32.
// stats_reduce_kernel then adds the rows of each column in fp64 and writes
// stats[0][c], stats[1][c] in fp32.
#pragma once

#include <cuda_runtime.h>

namespace rst {

// Thread t of an NT-thread block holds the sums of channel (t % BN) over the
// outputs it wrote. Adds the NT / BN threads of each channel in thread order
// and stores the block's BN sums to dst_sum and dst_sq. `red` is 2 * NT
// floats of shared memory that nothing else is using.
template <int BN, int NT>
__device__ __forceinline__ void block_stats_store(float s, float s2, float* red, float* dst_sum,
                                                  float* dst_sq) {
  red[threadIdx.x] = s;
  red[NT + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < BN) {
    float a = 0.0f, b = 0.0f;
    for (int g = 0; g < NT / BN; ++g) {
      a += red[g * BN + threadIdx.x];
      b += red[NT + g * BN + threadIdx.x];
    }
    dst_sum[threadIdx.x] = a;
    dst_sq[threadIdx.x] = b;
  }
  __syncthreads();
}

// partial: [rows][2][ncols] fp32; stats: [2][cout] fp32, cout <= ncols.
// Block (32, 32): lane x is a column, y a group of rows taken in stride.
__global__ void __launch_bounds__(1024) stats_reduce_kernel(const float* partial, int rows,
                                                            int ncols, int cout, float* stats) {
  __shared__ double red[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int j = blockIdx.y;
  double acc = 0.0;
  if (c < ncols)
    for (int r = threadIdx.y; r < rows; r += 32)
      acc += (double)partial[((size_t)r * 2 + j) * ncols + c];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cout) {
    double t = 0.0;
    for (int g = 0; g < 32; ++g) t += red[g][threadIdx.x];
    stats[(size_t)j * cout + c] = (float)t;
  }
}

inline int launch_stats_reduce(const float* partial, int rows, int ncols, int cout, float* stats,
                               cudaStream_t stream) {
  stats_reduce_kernel<<<dim3((ncols + 31) / 32, 2), dim3(32, 32), 0, stream>>>(partial, rows, ncols,
                                                                               cout, stats);
  return (int)cudaGetLastError();
}

}  // namespace rst
