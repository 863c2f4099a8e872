// Motion encoder stage 1, one (pixel, channel) output, shared by the
// serial motion kernel (motion.cu) and the resident iteration
// (resident.cu):
//   c1 = bf16(relu(corr . wc1 + bc1))                 1x1 over the corr taps
//   f1 = bf16(relu(conv7x7(flow_x, convf1.w[:, :, 0]) + bf1))
// Channels [0, n1) are c1, [n1, n1 + nf) f1. The sums run over k (c1) or
// over the 7x7 window row-major (f1) with fmaf, in that order on both
// routes. convf1's flow-y weights are dropped: the model's flow y is
// identically 0 (the epipolar projection zeroes every y delta), so callers
// with a caller-supplied flow_init use the plain torch motion encoder.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rst {

using bf16 = __nv_bfloat16;

struct MotionStage1 {
  const bf16* flow;  // [P][2]
  const bf16* wc1;   // [ccorr][n1]
  const bf16* wf1;   // [49][nf]
  const float* b1;   // [n1 + nf]
  int ccorr, n1, nf, H, W;

  // corr: the ccorr taps of pixel p, wherever they are held.
  __device__ __forceinline__ bf16 operator()(const bf16* corr, int p, int n) const {
    float acc = 0.0f;
    if (n < n1) {
      for (int k = 0; k < ccorr; ++k)
        acc = fmaf(__bfloat162float(corr[k]), __bfloat162float(wc1[k * n1 + n]), acc);
    } else {
      const int m = n - n1;
      const int x = p % W;
      const int y = (p / W) % H;
      const int img = (p / W) / H;
      for (int dy = 0; dy < 7; ++dy) {
        const int sy = y + dy - 3;
        if (sy < 0 || sy >= H) continue;
        for (int dx = 0; dx < 7; ++dx) {
          const int sx = x + dx - 3;
          if (sx < 0 || sx >= W) continue;
          const float f = __bfloat162float(flow[((size_t)(img * H + sy) * W + sx) * 2]);
          acc = fmaf(f, __bfloat162float(wf1[(dy * 7 + dx) * nf + m]), acc);
        }
      }
    }
    return __float2bfloat16(fmaxf(acc + b1[n], 0.0f));
  }
};

}  // namespace rst
