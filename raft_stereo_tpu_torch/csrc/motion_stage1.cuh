// Motion encoder stage 1 over a tile of pixels, shared by the serial motion
// kernel (motion.cu) and the resident iteration (resident.cu):
//   c1 = bf16(relu(corr . wc1 + bc1))                 1x1 over the corr taps
//   f1 = bf16(relu(conv7x7(flow_x, convf1.w[:, :, 0]) + bf1))
// Channels [0, n1) are c1, [n1, n1 + nf) f1 (n1 and nf multiples of 8).
// The sums run over k (c1) or over the 7x7 window row-major (f1) with fmaf,
// in that order on both routes. A window tap outside the image adds
// fmaf(0, w, acc), which is acc exactly: the sum starts at +0 and is never
// -0, and the weights are finite. convf1's flow-y weights are dropped: the
// model's flow y is identically 0 (the epipolar projection zeroes every y
// delta), so callers with a caller-supplied flow_init use the plain torch
// motion encoder.
//
// A block runs a tile of up to kS1Pixels pixels of one image row out of
// shared memory: the corr taps (the caller fills them: loaded, or gathered
// from the pyramid), the flow rows the tile's 7x7 windows cover (a strip of
// 7 x (kS1Pixels + 6), 0 outside the image) and both weight matrices in
// fp32. A thread computes 8 channels of 4 pixels, each weight read once for
// the four; the c1 items come before the f1 items so a warp stays in one
// branch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rst {

using bf16 = __nv_bfloat16;

constexpr int kS1Pixels = 64;  // pixels of a stage-1 tile

// The stage's shared memory, carved from `base` (16-byte aligned).
struct Stage1Smem {
  bf16* taps;    // [kS1Pixels][ccorr]
  float* wc1;    // [ccorr][n1]
  float* wf1;    // [49][nf]
  float* flow;   // [7][kS1Strip]: flow x of rows y - 3 .. y + 3, columns x0 - 3 ..
};

constexpr int kS1Strip = kS1Pixels + 6;

__host__ __device__ inline int stage1_taps_bytes(int ccorr) {
  return (kS1Pixels * ccorr * 2 + 15) / 16 * 16;
}

__host__ __device__ inline int stage1_smem_bytes(int ccorr, int n1, int nf) {
  return stage1_taps_bytes(ccorr) + (ccorr * n1 + 49 * nf + 7 * kS1Strip) * 4;
}

struct MotionStage1 {
  const bf16* flow;  // [P][2]
  const bf16* wc1;   // [ccorr][n1]
  const bf16* wf1;   // [49][nf]
  const float* b1;   // [n1 + nf]
  int ccorr, n1, nf, H, W;

  __device__ __forceinline__ Stage1Smem smem(unsigned char* base) const {
    Stage1Smem s;
    s.taps = reinterpret_cast<bf16*>(base);
    s.wc1 = reinterpret_cast<float*>(base + stage1_taps_bytes(ccorr));
    s.wf1 = s.wc1 + ccorr * n1;
    s.flow = s.wf1 + 49 * nf;
    return s;
  }

  // The block copies both weight matrices into shared memory as fp32, 8
  // values a 16-byte load (both are 16-byte aligned, n1 and nf multiples
  // of 8).
  __device__ __forceinline__ void load_weights(const Stage1Smem& s) const {
    const int n8c = ccorr * n1 / 8, n8 = n8c + 49 * nf / 8;
    for (int i = threadIdx.x; i < n8; i += blockDim.x) {
      const bool c = i < n8c;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(c ? wc1 : wf1) + (c ? i : i - n8c));
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
      float4* d = reinterpret_cast<float4*>((c ? s.wc1 : s.wf1) + 8 * (c ? i : i - n8c));
      const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
      const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
      d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }

  // One tile: pixels x0 .. x0 + count - 1 of image row `row` (img * H + y)
  // into s1 ([P][n1 + nf]). The caller has filled s.taps (count pixels);
  // the block loads the flow strip, syncs, computes and syncs again, so s is
  // free on return.
  __device__ __forceinline__ void tile(const Stage1Smem& s, int row, int x0, int count,
                                       bf16* s1) const {
    const int img = row / H, y = row % H;
    for (int i = threadIdx.x; i < 7 * kS1Strip; i += blockDim.x) {
      const int sy = y + i / kS1Strip - 3, sx = x0 - 3 + i % kS1Strip;
      s.flow[i] = sy >= 0 && sy < H && sx >= 0 && sx < W
                      ? __bfloat162float(flow[((size_t)(img * H + sy) * W + sx) * 2])
                      : 0.0f;
    }
    __syncthreads();
    constexpr int kGroups = kS1Pixels / 4;
    const int g1 = n1 / 8, gf = nf / 8;
    for (int i = threadIdx.x; i < kGroups * (g1 + gf); i += blockDim.x) {
      const bool c = i < kGroups * g1;
      const int j = c ? i : i - kGroups * g1;
      const int groups = c ? g1 : gf;
      const int px0 = (j / groups) * 4, n = (j % groups) * 8;
      if (px0 >= count) continue;
      float acc[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[u][e] = 0.0f;
      // Operand k of the sums: 4 pixels' taps and the weights' row k.
      const auto step = [&](const float (&a)[4], const float* wrow) {
        const float4 w0 = reinterpret_cast<const float4*>(wrow)[0];
        const float4 w1 = reinterpret_cast<const float4*>(wrow)[1];
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[u][e] = fmaf(a[u], w[e], acc[u][e]);
      };
      if (c) {
#pragma unroll 4
        for (int k = 0; k < ccorr; ++k) {
          float a[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] = __bfloat162float(s.taps[(px0 + u) * ccorr + k]);
          step(a, s.wc1 + k * n1 + n);
        }
      } else {
#pragma unroll
        for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 7; ++dx) {
            float a[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) a[u] = s.flow[dy * kS1Strip + px0 + u + dx];
            step(a, s.wf1 + (dy * 7 + dx) * nf + n);
          }
        }
      }
      const int nb = c ? n : n1 + n;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (px0 + u >= count) break;
        uint4 o;
        bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) ob[e] = __float2bfloat16(fmaxf(acc[u][e] + b1[nb + e], 0.0f));
        *reinterpret_cast<uint4*>(s1 + ((size_t)row * W + x0 + px0 + u) * (n1 + nf) + nb) = o;
      }
    }
    __syncthreads();
  }
};

}  // namespace rst
