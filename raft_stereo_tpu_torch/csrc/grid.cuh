// Grid-wide barrier (gru1632.cu) and cooperative launch for the persistent
// kernels (gru1632.cu, resident.cu, whose stages wait on counters of their
// own instead of a barrier).
//
// A persistent kernel runs the stages of one serial chain in one launch:
// each stage is a grid-stride loop over the tiles the serial launch would
// have run, and a grid barrier separates the stages, since a stage reads
// what every block wrote in the one before. The barrier needs every block
// resident at once, which cudaLaunchCooperativeKernel guarantees (it
// refuses a grid larger than the card holds; the launch then returns the
// error and nothing runs). The barrier is a counter in device memory that
// only grows: barrier number k waits until it reaches k * gridDim.x. It is
// the first of kCounters counters; the others hand out the stages' tiles
// (conv3x3_stage). The C entry zeroes them on the stream before each
// launch.
#pragma once

#include <cuda_runtime.h>

namespace rst {

constexpr int kCounters = 8;  // the barrier, then one per stage

struct GridBarrier {
  unsigned int* count;
  unsigned int arrived = 0;  // barriers passed by this block

  // Every thread's writes before the barrier are visible to every thread
  // of the grid after it.
  __device__ void sync() {
    ++arrived;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned int target = arrived * gridDim.x;
      atomicAdd(count, 1u);
      while (*reinterpret_cast<volatile unsigned int*>(count) < target) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
  }
};

// The grid of a persistent kernel: the co-resident block count (occupancy
// at `smem` dynamic bytes times the SM count), and no more than `tiles`,
// the largest stage's tile count. Returns 0 when no block fits.
template <class Kernel>
inline int persistent_grid(Kernel kernel, int threads, size_t smem, int tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm * sms < tiles ? per_sm * sms : tiles;
}

// Zeroes `counters` counters at `bar` and launches `kernel(params)`
// cooperatively on `stream`. Returns the first non-zero cudaError_t.
template <class Params>
inline int launch_persistent(void (*kernel)(Params), const Params& params, unsigned int* bar,
                             int tiles, size_t smem, int threads, cudaStream_t stream,
                             int counters = kCounters) {
  const int grid = persistent_grid(kernel, threads, smem, tiles);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int err = (int)cudaMemsetAsync(bar, 0, counters * sizeof(unsigned int), stream);
  if (err) return err;
  Params p = params;
  void* args[] = {&p};
  err = (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                         dim3(threads), args, smem, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace rst
