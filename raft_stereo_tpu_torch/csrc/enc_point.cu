// The pointwise exits of the fused encoders: layer1's double residual exit
// (point3) and a residual block's exit (point2).
//
// Replaces raft_stereo_tpu/ops/pallas_encoder.py:_point3_kernel and
// _point2_kernel. With t the transform of a raw conv output (enc_pass.cu),
// on (H, W, C) bf16 maps:
//   point3, instance norm: o1 = relu(t(s) + t(y2)) kept in fp32,
//                          out = bf16(relu(o1 + t(y4)))
//   point3, folded BN:     o1 = relu(relu(s) + relu(y2)) in bf16,
//                          out = relu(o1 + relu(y4)) in bf16
//   point2, instance norm: out = bf16(relu(x + t(y)))       (the sum in fp32)
//   point2, folded BN:     out = bf16(relu(x + relu(y)))    (the sum in fp32)
// point2's x is the block's input, an activation already, and takes no
// transform. (The same s + y2 sum is rounded to bf16 where enc_pass.cu's
// mid2 builds conv3's input; here it is not, as in the TPU kernels.)
//
// point2 has a quantize-on-exit variant too (RAFT_LANE_PACK8, replacing
// ops/pallas_encoder.py:_point2_q8_kernel): the same exit values, written as
// int8 q and one fp32 scale over the whole map (quant8.cuh).
//
// What bounds it on an H100: bytes. point3 reads three maps and writes one
// (245 MB at 384x1248x64), for a handful of operations a value.
//
// Design: a grid-stride loop of 16-byte vectors (8 channels of one pixel a
// thread and step), the per-channel means and inverse deviations in shared
// memory. Nothing of the TPU kernels' row blocks and width strips remains.
//
// point2 q8 needs the maximum of the whole map before its first q. The TPU
// kernel runs two passes over a (2, nb, 1) grid and carries the maximum in
// VMEM from one step to the next; blocks here run in no order, so one
// cooperative launch of a persistent grid (every block resident) does both
// phases around one grid-wide barrier. Phase 0: a block computes the exit
// values of its own span of the map and keeps them in shared memory (bf16);
// its warps then take chunks of the rest of the map until none is left;
// the block folds the maximum of all it computed into one word with one
// atomicMax. Phase 1: the rest again, recomputed from x and y from the last
// chunk down (the most recently read x and y are the likeliest still in the
// L2 cache), then the kept span. At 96x312x128 the grid's shared memory
// holds the whole exit, so x and y are read once; at 504x744x128 about 30%.
// The rest is handed out a chunk a warp from an atomic count because, with
// an equal share each, the last block to reach the barrier came 40% after
// the first at 504x744 (timestamps on an H100); handed out a few chunks a
// block, with a block barrier a grab, the blocks came level but every warp
// waited on the slowest one's loads. The maximum, the barrier's counts and
// the hand-out counts live in six words that start at zero; the last block
// past the barrier and the last to finish set them to zero again, so a call
// needs no memset.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "quant8.cuh"
#include "rounding.cuh"

namespace rst {

constexpr int kPointThreads = 256;
constexpr int kPointBlocks = 132 * 8;

__device__ __forceinline__ uint4 load16(const bf16* p, size_t vec) {
  return *(reinterpret_cast<const uint4*>(p) + vec);
}

// Copies n per-channel rows of C floats into shared memory.
__device__ __forceinline__ void stage_rows(float* sm, const float* const* rows, int n, int C) {
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) sm[i] = rows[i / C][i % C];
  __syncthreads();
}

template <bool NORM>
__global__ void __launch_bounds__(kPointThreads)
    point3_kernel(const bf16* s, const float* ms, const float* vs, const bf16* y2, const float* m2,
                  const float* v2, const bf16* y4, const float* m4, const float* v4, size_t nvec,
                  int C, bf16* out) {
  extern __shared__ float sm[];  // NORM: [6][C] ms, vs, m2, v2, m4, v4
  if (NORM) {
    const float* rows[6] = {ms, vs, m2, v2, m4, v4};
    stage_rows(sm, rows, 6, C);
  }
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int c0 = (int)((i * 8) % C);
    const uint4 qs = load16(s, i), q2 = load16(y2, i), q4 = load16(y4, i);
    const bf16* xs = reinterpret_cast<const bf16*>(&qs);
    const bf16* x2 = reinterpret_cast<const bf16*>(&q2);
    const bf16* x4 = reinterpret_cast<const bf16*>(&q4);
    uint4 res;
    bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      if (NORM) {
        const float o1 = fmaxf(__fadd_rn(normed(xs[k], sm[c], sm[C + c]),
                                         normed(x2[k], sm[2 * C + c], sm[3 * C + c])),
                               0.0f);
        o[k] = __float2bfloat16(
            fmaxf(__fadd_rn(o1, normed(x4[k], sm[4 * C + c], sm[5 * C + c])), 0.0f));
      } else {
        const float o1 = bf16r(__fadd_rn(relu(xs[k]), relu(x2[k])));
        o[k] = __float2bfloat16(__fadd_rn(o1, relu(x4[k])));
      }
    }
    *(reinterpret_cast<uint4*>(out) + i) = res;
  }
}

// The point2 exit of channels c0 .. c0+7 of one pixel: bf16(relu(x + t(y))),
// the sum in fp32; sm: the [2][C] means and inverse deviations (NORM), read
// as 16-byte units (a thread's 8 channels' means are 32 bytes from its
// neighbour's: scalar reads would meet 4 to a bank).
template <bool NORM>
__device__ __forceinline__ uint4 point2_exit8(uint4 qx, uint4 qy, const float* sm, int C, int c0) {
  const bf16* xx = reinterpret_cast<const bf16*>(&qx);
  const bf16* xy = reinterpret_cast<const bf16*>(&qy);
  float4 mv[4];
  if (NORM) {
    mv[0] = *reinterpret_cast<const float4*>(sm + c0);
    mv[1] = *reinterpret_cast<const float4*>(sm + c0 + 4);
    mv[2] = *reinterpret_cast<const float4*>(sm + C + c0);
    mv[3] = *reinterpret_cast<const float4*>(sm + C + c0 + 4);
  }
  const float* m = reinterpret_cast<const float*>(mv);
  const float* inv = m + 8;
  uint4 res;
  bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t = NORM ? normed(xy[k], m[k], inv[k]) : relu(xy[k]);
    o[k] = __float2bfloat16(fmaxf(__fadd_rn(__bfloat162float(xx[k]), t), 0.0f));
  }
  return res;
}

template <bool NORM>
__global__ void __launch_bounds__(kPointThreads)
    point2_kernel(const bf16* x, const bf16* y, const float* m, const float* v, size_t nvec, int C,
                  bf16* out) {
  extern __shared__ __align__(16) float sm[];  // NORM: [2][C] m, v
  if (NORM) {
    const float* rows[2] = {m, v};
    stage_rows(sm, rows, 2, C);
  }
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride)
    *(reinterpret_cast<uint4*>(out) + i) =
        point2_exit8<NORM>(load16(x, i), load16(y, i), sm, C, (int)((i * 8) % C));
}

constexpr int kQ8Threads = 512;
constexpr int kQ8BlocksPerSM = 2;
constexpr int kQ8Vectors = 2;  // x and y vectors a thread has in flight
constexpr int kQ8WarpChunk = 256;  // vectors of the rest a warp takes at a time

__device__ __forceinline__ float max8(uint4 v) {
  const bf16* o = reinterpret_cast<const bf16*>(&v);
  float mx = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) mx = fmaxf(mx, fabsf(__bfloat162float(o[k])));
  return mx;
}

__device__ __forceinline__ uint2 quant8x8(uint4 v, float s, float rcp) {
  const bf16* o = reinterpret_cast<const bf16*>(&v);
  uint2 packed;
  int8_t* o8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int k = 0; k < 8; ++k) o8[k] = quant8_fast(__bfloat162float(o[k]), s, rcp);
  return packed;
}

// Walks the rest of the map, vectors [rest0, nvec) in chunks of W, a chunk
// a warp: the warp's own chunk first (no burst of atomics when every warp
// starts at once), then whichever chunk *count hands it next (lane 0 asks
// before it starts on this one). Chunk g taken is index chunk(g); op(i, o)
// gets vector i's exit values, U vectors a thread in flight.
template <bool NORM, int U, int W, class Chunk, class Op>
__device__ __forceinline__ void walk_rest(const bf16* x, const bf16* y, const float* sm, int C,
                                          size_t rest0, size_t nvec, int rest_chunks,
                                          unsigned int* count, Chunk chunk, Op op) {
  const unsigned int warps = gridDim.x * (blockDim.x / 32);
  const int lane = threadIdx.x & 31;
  unsigned int next = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  for (;;) {
    const int c = chunk((int)__shfl_sync(0xffffffffu, next, 0));
    if (c < 0 || c >= rest_chunks) break;
    if (lane == 0) next = warps + atomicAdd(count, 1u);
    const size_t base = rest0 + (size_t)c * W + lane;
    for (int j0 = 0; j0 < W / 32; j0 += U) {
      uint4 xs[U], ys[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t i = base + 32 * (j0 + u);
        if (i < nvec) xs[u] = load16(x, i), ys[u] = load16(y, i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t i = base + 32 * (j0 + u);
        if (i < nvec) op(i, point2_exit8<NORM>(xs[u], ys[u], sm, C, (int)((i * 8) % C)));
      }
    }
  }
}

// One cooperative launch of kQ8BlocksPerSM blocks an SM at most. Block b
// keeps vectors [b * kept_span, (b + 1) * kept_span) in shared memory; the
// vectors after the grid's kept ones ("the rest") are cut into chunks of
// kQ8WarpChunk, and warp w takes chunk w, then whichever chunk the count
// hands it next (lane 0 asks for it before it starts on this one), in
// phase 0 from the first up and in phase 1 from the last down, so no block
// waits long on another at the barrier or at the end. smem: the
// [2][C] means and inverse deviations (NORM), then the kept vectors' exit
// values. words: [0] the maximum's bit pattern, [1] blocks arrived at the
// barrier, [2] blocks gone past it, [3] phase 0's and [4] phase 1's chunks
// handed out, [5] blocks finished; zero on entry, zero again on exit.
template <bool NORM>
__global__ void __launch_bounds__(kQ8Threads, kQ8BlocksPerSM)
    point2_q8_kernel(const bf16* x, const bf16* y, const float* m, const float* v, size_t nvec,
                     int C, int kept_span, int8_t* q, float* scale, unsigned int* words) {
  constexpr int T = kQ8Threads, U = kQ8Vectors, W = kQ8WarpChunk;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[T / 32];
  __shared__ unsigned int amax_bits;
  uint4* kept = reinterpret_cast<uint4*>(sm + (NORM ? 2 * C : 0));
  const int tid = threadIdx.x;
  const size_t span = (size_t)kept_span;  // a block's kept vectors
  const size_t k0 = blockIdx.x * span < nvec ? blockIdx.x * span : nvec;
  const size_t k1 = k0 + span < nvec ? k0 + span : nvec;
  const int own_chunks = (int)((k1 - k0 + T - 1) / T);
  const size_t rest0 = gridDim.x * span < nvec ? gridDim.x * span : nvec;
  const int rest_chunks = (int)((nvec - rest0 + W - 1) / W);
  const float* rows[2] = {m, v};
  bool staged = !NORM;
  float mx = 0.0f;
  // Phase 0, the kept span, U vectors a thread in flight; the means are
  // staged once the first loads are on their way.
  for (int j0 = 0; j0 < own_chunks; j0 += U) {
    uint4 xs[U], ys[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = k0 + (size_t)(j0 + u) * T + tid;
      if (i < k1) xs[u] = load16(x, i), ys[u] = load16(y, i);
    }
    if (!staged) {
      stage_rows(sm, rows, 2, C);
      staged = true;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = k0 + (size_t)(j0 + u) * T + tid;
      if (i >= k1) break;
      const uint4 o = point2_exit8<NORM>(xs[u], ys[u], sm, C, (int)((i * 8) % C));
      mx = fmaxf(mx, max8(o));
      kept[(j0 + u) * T + tid] = o;
    }
  }
  if (!staged) stage_rows(sm, rows, 2, C);
  // Phase 0, the rest, from the first chunk up.
  walk_rest<NORM, U, W>(x, y, sm, C, rest0, nvec, rest_chunks, words + 3,
                        [](int g) { return g; },
                        [&](size_t, uint4 o) { mx = fmaxf(mx, max8(o)); });
  // The block's maximum, one atomicMax, and the grid-wide barrier.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < T / 32; ++w) mx = fmaxf(mx, red[w]);
    atomicMax(words, __float_as_uint(mx));
    __threadfence();
    atomicAdd(words + 1, 1u);
    const volatile unsigned int* arrived = words + 1;
    for (unsigned spins = 0; *arrived < gridDim.x; ++spins)
      if (spins == (1u << 26)) __trap();  // a block that never arrives: fail, do not hang
    __threadfence();
    amax_bits = *reinterpret_cast<const volatile unsigned int*>(words);
    __threadfence();
    if (atomicAdd(words + 2, 1u) == gridDim.x - 1) {  // the last block out: phase 0's words
      words[0] = 0u;
      words[1] = 0u;
      words[2] = 0u;
      words[3] = 0u;
    }
  }
  __syncthreads();
  const float s = quant_scale(amax_bits);
  const float rcp = __frcp_rn(s);
  if (blockIdx.x == 0 && tid == 0) *scale = s;
  // Phase 1, the rest, from the last chunk down: the last read first.
  uint2* q8 = reinterpret_cast<uint2*>(q);
  walk_rest<NORM, U, W>(x, y, sm, C, rest0, nvec, rest_chunks, words + 4,
                        [=](int g) { return rest_chunks - 1 - g; },
                        [=](size_t i, uint4 o) { q8[i] = quant8x8(o, s, rcp); });
  // Phase 1, the kept span.
  for (int j = 0; j < own_chunks; ++j) {
    const size_t i = k0 + (size_t)j * T + tid;
    if (i < k1) q8[i] = quant8x8(kept[j * T + tid], s, rcp);
  }
  // Every grab of this block's warps is back (each read its last); the last
  // block to finish zeroes phase 1's words.
  __syncthreads();
  if (tid == 0 && atomicAdd(words + 5, 1u) == gridDim.x - 1) {
    words[4] = 0u;
    words[5] = 0u;
  }
}

// The q8 launch's grid and shared memory: kQ8BlocksPerSM blocks an SM,
// each with that share of the SM's shared memory; the vectors each keeps.
template <bool NORM>
inline int launch_point2_q8(const bf16* x, const bf16* y, const float* m, const float* v,
                            size_t nvec, int C, int8_t* q, float* scale, unsigned int* words,
                            cudaStream_t stream) {
  auto kernel = point2_q8_kernel<NORM>;
  int dev = 0, sms = 0, per_sm = 0, reserved = 0, fits = 0;
  cudaFuncAttributes attr{};
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (!err) err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  const size_t mv = NORM ? 2 * (size_t)C * sizeof(float) : 0;
  const size_t room = (size_t)per_sm / kQ8BlocksPerSM - reserved - attr.sharedSizeBytes;
  if (room < mv + 16 * kQ8Threads) return (int)cudaErrorInvalidValue;  // C too wide to stage
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)room);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kernel, kQ8Threads, room);
  if (err) return err;
  const size_t chunks = (nvec + kQ8Threads - 1) / kQ8Threads;
  const int blocks = (int)std::min<size_t>(chunks, (size_t)sms * fits);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  // As many vectors a block as its shared memory holds, and no more than an
  // even share of the map.
  const int kept_span = (int)std::min<size_t>((room - mv) / 16, (nvec + blocks - 1) / blocks);
  void* args[] = {(void*)&x, (void*)&y, (void*)&m, (void*)&v, (void*)&nvec, (void*)&C,
                  (void*)&kept_span, (void*)&q, (void*)&scale, (void*)&words};
  // A grid larger than the card holds is refused here, and nothing runs.
  err = (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                         dim3(kQ8Threads), args, room, stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace rst

using rst::bf16;

// kind 3: point3 over a = s, b = y2, c = y4 with (ma, va), (mb, vb),
// (mc, vc); kind 2: point2 over a = x (no transform), b = y with (mb, vb).
// Maps are [npix][C] bf16, C a multiple of 8; means and inverse deviations
// [C] fp32, read only when norm != 0. With q != null (point2 only), the
// quantize-on-exit variant: q: [npix][C] int8 and scale: [1] fp32 in place
// of out, words: six unsigned scratch words, zero before the first call
// (the call leaves them zero), which no other launch uses while it runs.
// Returns the first non-zero cudaError_t.
extern "C" int rst_enc_point(int kind, int norm, const bf16* a, const float* ma, const float* va,
                             const bf16* b, const float* mb, const float* vb, const bf16* c,
                             const float* mc, const float* vc, int npix, int C, bf16* out,
                             int8_t* q, float* scale, unsigned int* words, cudaStream_t stream) {
  const size_t nvec = (size_t)npix * C / 8;
  const size_t want = (nvec + rst::kPointThreads - 1) / rst::kPointThreads;
  const int blocks = (int)(want < (size_t)rst::kPointBlocks ? want : rst::kPointBlocks);
  const int nrows = kind == 3 ? 6 : 2;
  const size_t smem = norm ? (size_t)nrows * C * sizeof(float) : 0;
  if (q != nullptr && (kind != 2 || scale == nullptr || words == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kind == 3 && norm)
    rst::point3_kernel<true><<<blocks, rst::kPointThreads, smem, stream>>>(
        a, ma, va, b, mb, vb, c, mc, vc, nvec, C, out);
  else if (kind == 3)
    rst::point3_kernel<false><<<blocks, rst::kPointThreads, smem, stream>>>(
        a, ma, va, b, mb, vb, c, mc, vc, nvec, C, out);
  else if (q != nullptr && norm)
    return rst::launch_point2_q8<true>(a, b, mb, vb, nvec, C, q, scale, words, stream);
  else if (q != nullptr)
    return rst::launch_point2_q8<false>(a, b, mb, vb, nvec, C, q, scale, words, stream);
  else if (norm)
    rst::point2_kernel<true><<<blocks, rst::kPointThreads, smem, stream>>>(a, b, mb, vb, nvec, C,
                                                                            out);
  else
    rst::point2_kernel<false><<<blocks, rst::kPointThreads, smem, stream>>>(a, b, mb, vb, nvec, C,
                                                                             out);
  return (int)cudaGetLastError();
}
