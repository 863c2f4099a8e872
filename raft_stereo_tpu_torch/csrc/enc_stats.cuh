// Per-channel sum and sum of squares of a conv's fp32 outputs, without
// floating-point atomics: the encoder kernels (enc_stem.cu, enc_pass.cu)
// feed instance norm with them, and two runs on the same input must give
// the same bits.
//
// Two steps, each in a fixed order. A block adds up what its threads
// summed over their own outputs and writes one row of partials,
// partial[row][0][c] (sum) and partial[row][1][c] (sum of squares), fp32.
// stats_reduce_kernel then adds the rows of each column in fp64 (in slices
// where there are many) and writes stats[0][c], stats[1][c] in fp32.
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

// Slices of rows a column's fp64 sum is split into: the 3x3 pass has a row
// per 8 x 16 patch, 46,872 at 2016x2976, which one block a column tile would
// walk one after another; the stem has at most 528 and takes one slice.
inline int stats_slices(int rows) { return rows / 512 < 1 ? 1 : rows / 512 > 64 ? 64 : rows / 512; }

// Rows of [2][ncols] floats that the reduction needs in the partial scratch
// past its `rows` data rows (none for one slice): the slices' fp64 sums,
// then a row that holds the counters.
inline int stats_extra_rows(int rows) {
  return stats_slices(rows) == 1 ? 0 : 2 * stats_slices(rows) + 1;
}

// partial: [rows][2][ncols] fp32; stats: [2][cout] fp32, cout <= ncols.
// Block (32, 32) of slice blockIdx.z: lane x is a column, y a group of the
// slice's rows taken in stride. One slice writes stats; several write their
// fp64 sums to `sums`, and the last block of a column tile to finish (a
// counter, the only atomic) adds them in slice order. Fixed orders
// throughout: the same bits every run.
__global__ void __launch_bounds__(1024)
    stats_reduce_kernel(const float* partial, int rows, int ncols, int cout, double* sums,
                        unsigned int* count, float* stats) {
  __shared__ double red[32][33];
  __shared__ bool last;
  const int slices = gridDim.z;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int j = blockIdx.y;
  const int s = blockIdx.z;
  const int r0 = (int)((long long)rows * s / slices);
  const int r1 = (int)((long long)rows * (s + 1) / slices);
  double acc = 0.0;
  if (c < ncols)
    for (int r = r0 + threadIdx.y; r < r1; r += 32)
      acc += (double)partial[((size_t)r * 2 + j) * ncols + c];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    double t = 0.0;
    for (int g = 0; g < 32; ++g) t += red[g][threadIdx.x];
    if (slices == 1) {
      if (c < cout) stats[(size_t)j * cout + c] = (float)t;
    } else {
      sums[((size_t)s * 2 + j) * ncols + c] = t;
    }
  }
  if (slices == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicAdd(&count[blockIdx.y * gridDim.x + blockIdx.x], 1u) == (unsigned)slices - 1;
  __syncthreads();
  if (last && threadIdx.y == 0 && c < cout) {
    double t = 0.0;
    for (int k = 0; k < slices; ++k) t += __ldcg(&sums[((size_t)k * 2 + j) * ncols + c]);
    stats[(size_t)j * cout + c] = (float)t;
  }
}

// partial: [rows + stats_extra_rows(rows)][2][ncols] fp32, the data rows
// first; the rest is the reduction's scratch.
inline int launch_stats_reduce(float* partial, int rows, int ncols, int cout, float* stats,
                               cudaStream_t stream) {
  const int slices = stats_slices(rows);
  double* sums = reinterpret_cast<double*>(partial + (size_t)rows * 2 * ncols);
  unsigned int* count =
      reinterpret_cast<unsigned int*>(partial + (size_t)(rows + 2 * slices) * 2 * ncols);
  const dim3 grid((ncols + 31) / 32, 2, slices);
  if (slices > 1) {
    const int err = (int)cudaMemsetAsync(count, 0, sizeof(unsigned int) * grid.x * 2, stream);
    if (err) return err;
  }
  stats_reduce_kernel<<<grid, dim3(32, 32), 0, stream>>>(partial, rows, ncols, cout, sums, count,
                                                        stats);
  return (int)cudaGetLastError();
}

}  // namespace rst
