// Cooperative launch of the persistent kernels (resident.cu, gru1632.cu).
//
// A persistent kernel runs the stages of one serial chain in one launch,
// each stage a loop over the tiles the serial launch would have run. A
// stage's tiles wait on counters in device memory that the stage before
// adds to (loop_conv_sm90.cuh, LoopConv's dataflow fields), so every block
// of the grid must be resident at once: cudaLaunchCooperativeKernel
// guarantees that (it refuses a grid larger than the card holds; the launch
// then returns the error and nothing runs). The counters only grow within a
// launch; the launch zeroes them on the stream first.
#pragma once

#include <cuda_runtime.h>

namespace rst {

// Zeroes `counters` counters at `bar` and launches `kernel(params)`
// cooperatively on `stream` with `grid` blocks. Returns the first non-zero
// cudaError_t.
template <class Params>
inline int launch_persistent(void (*kernel)(Params), const Params& params, unsigned int* bar,
                             int counters, int grid, size_t smem, int threads,
                             cudaStream_t stream) {
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
