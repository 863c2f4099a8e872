// The refinement loop's 3x3 convolution engine for Hopper: every 3x3 conv of
// the loop. The motion encoder's two 3x3 stages, the ConvGRU gates and
// update at every level and the FlowHead's two convs, in the serial launches
// (motion.cu, conv_gru.cu) and in the persistent kernels (resident.cu,
// gru1632.cu), which run the same tile code.
//
// An implicit GEMM over NHWC bf16 activations, built from the TMA, ldmatrix
// and wgmma pieces of enc_conv_sm90.cuh. A tile is an 8 x 16 patch of output
// pixels of one image by N output columns (N = 8, 64 or 128). A block has
// one producer warp, of which one thread issues every TMA load, and two
// consumer warpgroups of 64 pixels (4 output rows of 16) that run wgmma
// m64nNk16 with A in registers and B from shared memory by descriptor, fp32
// accumulators in registers. The K loop walks 64-channel chunks of the
// input; per chunk the producer brings one 10 x 18 halo patch through a 4-D
// tensor map over the chunk's input part (its out-of-bounds fill is the
// conv's zero padding), then the chunk's 9 per-tap weight tiles (N x 64,
// K-major) through a 3-D map over the [9][rows][K] weight matrix. The 9 taps
// read the one staged patch at shifted ldmatrix addresses.
//
// The input is a virtual channel concat of up to four NHWC parts, never
// concatenated in device memory. A chunk lies in one part: a part whose
// channels are not a multiple of 64 ends in a chunk whose upper channels
// arrive as zeros, and that chunk's weight tile starts at the part's first
// channel in the matrix (its rows past the part multiply those zeros).
// Output column tiles below `split` read the chunks of one channel range,
// the others those of another: the GRU's q columns skip h, and the motion
// encoder's block-diagonal stage reads only its own branch.
//
// The epilogue works on the fp32 accumulators in registers: shuffles within
// each quad of lanes give a lane 8 consecutive columns of a pixel, and the
// caller's functor (stages.cuh) takes them at once (put8: 16-byte loads and
// stores); every rounding point is the functor's. Tiles are dealt to blocks
// in a fixed order (a block's first tile, t0, then every gridDim.x-th: t0 is
// blockIdx.x, or in gru1632.cu the block's place after the stage's first
// block), and a tile's sums depend on nothing but its own loads, so a serial
// launch (loop_conv_kernel) and a stage of a persistent kernel give the same
// bits at any grid size. In a persistent kernel the stages follow
// each other without a grid barrier: a tile waits for counts of the patch
// rows its halo reads (LoopConv's dataflow fields).
//
// Rings: 2 patch slots (23 KB), 4 weight slots (16 KB), one full and one
// empty mbarrier each; shared memory 113 KB a block, one block an SM, 320
// threads (the consumers, the producer warp, the signal warp). ptxas holds
// such a block to 168 registers a thread; no stage spills. setmaxnreg is
// not used: ptxas ignores it where the roles rejoin, as they do between the
// persistent kernels' stages.
#pragma once

#include <cstdint>

#include "enc_conv_sm90.cuh"
#include "rounding.cuh"

namespace rst {
namespace sm90 {

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Orders this thread's generic-proxy accesses to global memory with later
// async-proxy ones (a TMA load, in any block, after a grid barrier).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

}  // namespace sm90

namespace loop {

constexpr int kTH = 8;   // output rows of a patch, one a consumer warp
constexpr int kTW = 16;  // output columns of a patch
constexpr int kPH = kTH + 2;
constexpr int kPW = kTW + 2;
constexpr int kABytes = kPH * kPW * 128;                // one 64-channel halo patch
constexpr int kASlot = (kABytes + 1023) / 1024 * 1024;  // rounded up to the swizzle's 1 KB
constexpr int kAStages = 2;
constexpr int kNMax = 128;
constexpr int kBSlot = kNMax * 128;  // one weight tile, N rows of 64 channels
constexpr int kBStages = 4;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kProducer = kConsumers;       // the producer warp's first thread
constexpr int kSignaler = kConsumers + 32;  // the signal warp's (the dataflow's counts)
constexpr int kThreads = kConsumers + 64;
constexpr int kBlocksPerSM = 1;
constexpr int kBarOffset = kAStages * kASlot + kBStages * kBSlot;
constexpr int kSmemBytes = kBarOffset + 128 + 1024;  // + the barriers, + alignment slack
constexpr int kParts = 4;
constexpr int kMaxChunks = 8;
constexpr int kMaxMaps = kParts + 1;  // a conv's input parts and its weights
constexpr int kLaunchMaps = 16;       // at most, in a launch's parameters

// One conv stage as the device runs it; its tensor maps live beside it in
// the launch's parameters (maps[map[..]], maps[map_w]).
struct LoopConv {
  int H, W, tiles_x, tiles_y, patches;  // patches: B * tiles_y * tiles_x
  int ncol, split;                      // column tiles; those below split read list 0
  int nchunk[2];
  unsigned char map[2][kMaxChunks];  // the part's tensor map
  short coff[2][kMaxChunks];         // the chunk's first channel within its part
  short wk[2][kMaxChunks];           // its first row in the weight matrix's K
  unsigned char map_w;
  // Dataflow between the stages of a persistent kernel (null in a serial
  // launch): before a tile's first chunk of a part whose tensor map is
  // maps[wait_map] or a later one (every part at 0; the chunks before load
  // at once), the producer waits until wait_on[img * tiles_y + ty'] reaches
  // wait_full (wait_last for the last patch row) for ty' = ty - 1 .. ty + 1,
  // the patch rows whose outputs of the stage before its halo reads. After a
  // tile's epilogue, signal[img * tiles_y + ty] gains one.
  const unsigned* wait_on;
  unsigned wait_full, wait_last;
  unsigned* signal;
  unsigned char wait_map;
  int first;  // the block that takes tile 0, where the caller deals from it (first_tile)
};

struct Ring {
  uint32_t a = 0, b = 0;  // patch and weight loads so far; slot = n % stages
  uint32_t d = 0;         // tiles handed to the signal warp so far (2 slots)
};

struct LoopSmem {
  unsigned char* a;
  unsigned char* b;
  uint64_t* full_a;
  uint64_t* empty_a;
  uint64_t* full_b;
  uint64_t* empty_b;
  uint64_t* done_full;   // [2]: a tile's outputs written (the consumer warps)
  uint64_t* done_empty;  // [2]: the tile counted (the signal warp)
};

__device__ __forceinline__ LoopSmem loop_smem(unsigned char* raw) {
  unsigned char* s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  LoopSmem m;
  m.a = s;
  m.b = s + kAStages * kASlot;
  m.full_a = reinterpret_cast<uint64_t*>(s + kBarOffset);
  m.empty_a = m.full_a + kAStages;
  m.full_b = m.empty_a + kAStages;
  m.empty_b = m.full_b + kBStages;
  m.done_full = m.empty_b + kBStages;
  m.done_empty = m.done_full + 2;
  return m;
}

// Thread 0 sets up the ring barriers; the caller syncs the block after.
__device__ __forceinline__ void loop_init(const LoopSmem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kAStages; ++i) {
      sm90::mbar_init(&s.full_a[i], 1);
      sm90::mbar_init(&s.empty_a[i], kConsumers / 32);
    }
    for (int i = 0; i < kBStages; ++i) {
      sm90::mbar_init(&s.full_b[i], 1);
      sm90::mbar_init(&s.empty_b[i], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&s.done_full[i], kConsumers / 32);
      sm90::mbar_init(&s.done_empty[i], 1);
    }
    sm90::mbar_init_fence();
  }
}

struct TileAt {
  int img, y0, x0, n0, list, row;  // row: img * tiles_y + the patch row
};

// Tiles run patch by patch, the column tiles of a patch one after another,
// so the patch rows complete in order and the next stage's first tiles can
// start (the dataflow) while this stage finishes the last rows. The column
// order rotates from patch to patch, so a block's tiles mix the column
// tiles (the q gate's has fewer chunks) whatever the grid size.
__device__ __forceinline__ TileAt tile_at(const LoopConv& c, int t, int n) {
  const int patch = t / c.ncol, col = (t % c.ncol + patch) % c.ncol;
  const int per_img = c.tiles_y * c.tiles_x;
  const int r = patch % per_img;
  return {patch / per_img, (r / c.tiles_x) * kTH, (r % c.tiles_x) * kTW, col * n,
          col >= c.split ? 1 : 0, patch / c.tiles_x};
}

// This block's first tile of a stage whose tile 0 runs in block `first`. The
// serial launches and the resident kernel start at blockIdx.x itself: an
// offset start costs their stages registers and time (the motion kernel's
// block-diagonal stage 20% slower, measured).
__device__ __forceinline__ int first_tile(int first) {
  return (int)((blockIdx.x + gridDim.x - (unsigned)first) % gridDim.x);
}

// Spins until a count reaches `want`. A count that does not arrive within
// seconds is a fault: the kernel traps, and the launch reports an error
// instead of hanging.
__device__ __forceinline__ void spin_until(const unsigned* count, unsigned want) {
  for (unsigned spins = 0; *reinterpret_cast<const volatile unsigned*>(count) < want; ++spins) {
    if (spins == (1u << 26)) __trap();
    __nanosleep(64);
  }
}

// Spins until the patch rows around `row` (one image's rows) have their
// inputs, then orders this thread's later TMA reads after them.
__device__ __forceinline__ void wait_rows(const LoopConv& c, int row) {
  const int ty = row % c.tiles_y;
  for (int d = -1; d <= 1; ++d) {
    if (ty + d < 0 || ty + d >= c.tiles_y) continue;
    spin_until(c.wait_on + row + d, ty + d == c.tiles_y - 1 ? c.wait_last : c.wait_full);
  }
  __threadfence();
  sm90::fence_proxy_async_global();
}

// The producer thread: every load of this block's tiles of one stage.
template <int N>
__device__ void produce(const LoopConv& c, const CUtensorMap* maps, const LoopSmem& s, Ring& r,
                        int t0) {
  sm90::fence_proxy_async_global();  // the stage before wrote these inputs
  const int ntiles = c.patches * c.ncol;
  for (int t = t0; t < ntiles; t += gridDim.x) {
    const TileAt at = tile_at(c, t, N);
    bool waited = c.wait_on == nullptr;
    for (int k = 0; k < c.nchunk[at.list]; ++k) {
      if (!waited && c.map[at.list][k] >= c.wait_map) {
        wait_rows(c, at.row);
        waited = true;
      }
      const uint32_t ia = r.a % kAStages, pa = (r.a / kAStages) & 1;
      ++r.a;
      sm90::mbar_wait(&s.empty_a[ia], pa ^ 1);
      sm90::mbar_expect_tx(&s.full_a[ia], kABytes);
      sm90::tma_load_4d(s.a + ia * kASlot, &maps[c.map[at.list][k]], &s.full_a[ia],
                        c.coff[at.list][k], at.x0 - 1, at.y0 - 1, at.img);
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t ib = r.b % kBStages, pb = (r.b / kBStages) & 1;
        ++r.b;
        sm90::mbar_wait(&s.empty_b[ib], pb ^ 1);
        sm90::mbar_expect_tx(&s.full_b[ib], N * 128);
        sm90::tma_load_3d(s.b + ib * kBSlot, &maps[c.map_w], &s.full_b[ib], c.wk[at.list][k],
                          at.n0, tap);
      }
    }
  }
}

// The consumer warpgroups: products and epilogue of this block's tiles.
// Warp w computes output row w of the patch.
template <int N, class Epi>
__device__ void consume(const LoopConv& c, const Epi& epi, const LoopSmem& s, Ring& r, int t0) {
  constexpr int NA = N / 2;  // accumulators a thread
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix: lane l gives the address of pixel lx of the warp's row, the
  // low or high 8 channels of the k16 slice.
  const int lx = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntiles = c.patches * c.ncol;
  for (int t = t0; t < ntiles; t += gridDim.x) {
    const TileAt at = tile_at(c, t, N);
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
    for (int k = 0; k < c.nchunk[at.list]; ++k) {
      const uint32_t ia = r.a % kAStages, pa = (r.a / kAStages) & 1;
      ++r.a;
      sm90::mbar_wait(&s.full_a[ia], pa);
      const uint32_t abase = sm90::smem_u32(s.a + ia * kASlot);
      uint32_t a[2][4][4];
      uint32_t prev = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int row = (warp + tap / 3) * kPW + lx + tap % 3;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sm90::ldsm_x4(abase + sm90::swz128(row, 2 * q + khalf), a[tap & 1][q]);
        const uint32_t ib = r.b % kBStages, pb = (r.b / kBStages) & 1;
        ++r.b;
        sm90::mbar_wait(&s.full_b[ib], pb);
#pragma unroll
        for (int i = 0; i < NA; ++i) sm90::keep(acc[i]);
        sm90::wgmma_fence();
        const uint64_t bd = sm90::desc_sw128(sm90::smem_u32(s.b + ib * kBSlot));
#pragma unroll
        for (int q = 0; q < 4; ++q) sm90::Wgmma<N>::mma(acc, a[tap & 1][q], bd + 2 * q);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous tap's products are done
        if (tap > 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) sm90::keep(a[(tap + 1) & 1][q][e]);
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&s.empty_b[prev]);
        }
        prev = ib;
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NA; ++i) sm90::keep(acc[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm90::keep(a[0][q][e]);
      __syncwarp();
      if (lane == 0) {
        sm90::mbar_arrive(&s.empty_b[prev]);
        sm90::mbar_arrive(&s.empty_a[ia]);
      }
    }
    // Thread (lane, warp) holds pixels x0 + g and x0 + g + 8 of row y0 +
    // warp, columns n0 + 8j + 2 t4 and + 1: acc[4j], [4j + 1] and [4j + 2],
    // [4j + 3]. The four lanes of a quad hold the 8 columns of a group j
    // between them: shuffles hand lane t4 all 8 of group j0 + t4, so the
    // functor's loads and stores are 16 bytes (put8). The head's one-column
    // conv takes its column alone.
    const int y = at.y0 + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = at.x0 + g + 8 * h;
      const bool in = y < c.H && x < c.W;
      const int p = (at.img * c.H + y) * c.W + x;
      if constexpr (N < 32) {
        if (in) {
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            epi(p, at.n0 + 8 * j + 2 * t4, acc[4 * j + 2 * h]);
            epi(p, at.n0 + 8 * j + 2 * t4 + 1, acc[4 * j + 2 * h + 1]);
          }
        }
      } else {
#pragma unroll
        for (int j0 = 0; j0 < N / 8; j0 += 4) {
          // Round r: this lane sends its pair of group j0 + ((t4 - r) & 3)
          // and receives, from lane s = (t4 + r) & 3, columns 2s, 2s + 1 of
          // group j0 + t4.
          float2 w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int sel = (t4 - r) & 3;
            float sx = acc[4 * j0 + 2 * h], sy = acc[4 * j0 + 2 * h + 1];
#pragma unroll
            for (int k = 1; k < 4; ++k) {
              if (sel == k) {
                sx = acc[4 * (j0 + k) + 2 * h];
                sy = acc[4 * (j0 + k) + 2 * h + 1];
              }
            }
            const int src = (lane & ~3) | ((t4 + r) & 3);
            w[r].x = __shfl_sync(0xffffffffu, sx, src);
            w[r].y = __shfl_sync(0xffffffffu, sy, src);
          }
          float v[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = (q - t4) & 3;
            float2 pv = w[0];
#pragma unroll
            for (int k = 1; k < 4; ++k)
              if (r == k) pv = w[k];
            v[2 * q] = pv.x;
            v[2 * q + 1] = pv.y;
          }
          if (in) epi.put8(p, at.n0 + 8 * (j0 + t4), v);
        }
      }
    }
    if (c.signal != nullptr) {
      // The signal warp counts the tile once every consumer warp's outputs
      // are written (signal()); the consumers go on, unless it is two tiles
      // behind.
      const uint32_t id = r.d % 2, pd = (r.d / 2) & 1;
      ++r.d;
      sm90::fence_proxy_async_global();
      sm90::mbar_wait(&s.done_empty[id], pd ^ 1);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&s.done_full[id]);
    }
  }
  sm90::fence_proxy_async_global();  // these outputs before a later stage's TMA reads
}

// The signal warp's first thread: after each of this block's tiles, once
// every consumer warp has arrived (the mbarrier orders their stores before
// its wait), one count for the tile's patch row, released at the scope of
// the grid (the fence is cumulative). Keeps the fence's latency off the
// consumers' path.
__device__ void signal(const LoopConv& c, int n, const LoopSmem& s, Ring& r, int t0) {
  const int ntiles = c.patches * c.ncol;
  for (int t = t0; t < ntiles; t += gridDim.x) {
    const uint32_t id = r.d % 2, pd = (r.d / 2) & 1;
    ++r.d;
    sm90::mbar_wait(&s.done_full[id], pd);
    __threadfence();
    atomicAdd(c.signal + tile_at(c, t, n).row, 1u);
    sm90::mbar_arrive(&s.done_empty[id]);
  }
}

// A conv stage run by the whole block from its first tile t0: the producer
// thread loads, the consumer warpgroups compute, the signal warp counts
// finished tiles (in a persistent kernel), the other lanes idle. Ring counts
// carry from stage to stage.
template <int N, class Epi>
__device__ __forceinline__ void conv_stage(const LoopConv& c, const CUtensorMap* maps,
                                           const Epi& epi, const LoopSmem& s, Ring& r, int t0) {
  if (threadIdx.x >= kSignaler) {
    if (threadIdx.x == kSignaler && c.signal != nullptr) signal(c, N, s, r, t0);
  } else if (threadIdx.x >= kProducer) {
    if (threadIdx.x == kProducer) produce<N>(c, maps, s, r, t0);
  } else {
    consume<N, Epi>(c, epi, s, r, t0);
  }
}

// A stage whose column tile width, 128 or 64, is known at run time.
template <class Epi>
__device__ __forceinline__ void conv_stage_n(int n, const LoopConv& c, const CUtensorMap* maps,
                                             const Epi& epi, const LoopSmem& s, Ring& r,
                                             int t0) {
  if (n == 128)
    conv_stage<128>(c, maps, epi, s, r, t0);
  else
    conv_stage<64>(c, maps, epi, s, r, t0);
}

template <class Epi>
struct LoopLaunch {
  CUtensorMap maps[kMaxMaps];
  LoopConv conv;
  Epi epi;
};

// One conv stage as a launch of its own (the serial kernels).
template <int N, class Epi>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    loop_conv_kernel(const __grid_constant__ LoopLaunch<Epi> p) {
  extern __shared__ unsigned char smem_raw[];
  const LoopSmem s = loop_smem(smem_raw);
  loop_init(s);
  __syncthreads();
  Ring r;
  conv_stage<N>(p.conv, p.maps, p.epi, s, r, blockIdx.x);
}

// -- host ------------------------------------------------------------------------------

using sm90::cached_map;

// An input part of a conv: an NHWC map of `c` channels (a multiple of 8).
struct Part {
  const bf16* ptr;
  int c;
};

// The chunks of channels [k0, k1) of the virtual concat of `parts`; false
// unless the range starts and ends on chunk boundaries.
inline bool chunk_list(LoopConv& c, int list, const unsigned char* maps, const Part* parts,
                       int nparts, int k0, int k1) {
  int n = 0, covered = 0, off = 0;
  for (int i = 0; i < nparts; ++i) {
    for (int lo = 0; lo < parts[i].c; lo += 64) {
      const int v = off + lo;
      if (v < k0 || v >= k1) continue;
      if (n == kMaxChunks) return false;
      c.map[list][n] = maps[i];
      c.coff[list][n] = (short)lo;
      c.wk[list][n] = (short)v;
      covered += parts[i].c - lo < 64 ? parts[i].c - lo : 64;
      ++n;
    }
    off += parts[i].c;
  }
  c.nchunk[list] = n;
  return n > 0 && covered == k1 - k0;
}

// Describes a conv over the virtual concat of `parts` (B x H x W each) with
// weights w: [9][rows][K] bf16, K-major (K = the parts' channels in order),
// `cols` output columns (the epilogue sees columns up to the tile's end; it
// ignores those it does not own) in tiles of n, the tiles below column
// `split` over channels [ka0, ka1), the others over [kb0, kb1). Encodes the
// tensor maps into maps[*nmaps...] and advances *nmaps. Returns 0 or a
// cudaError_t.
inline int loop_conv(LoopConv& c, CUtensorMap* maps, int* nmaps, const Part* parts, int nparts,
                     int B, int H, int W, const bf16* w, int rows, int cols, int n, int split,
                     int ka0, int ka1, int kb0, int kb1) {
  if (nparts < 1 || nparts > kParts || *nmaps + nparts + 1 > kLaunchMaps || split % n ||
      B < 1 || H < 1 || W < 1 || n > kNMax)
    return (int)cudaErrorInvalidValue;
  c = LoopConv{};
  c.H = H;
  c.W = W;
  c.tiles_x = (W + kTW - 1) / kTW;
  c.tiles_y = (H + kTH - 1) / kTH;
  c.patches = B * c.tiles_y * c.tiles_x;
  c.ncol = (cols + n - 1) / n;
  c.split = split / n;
  unsigned char idx[kParts];
  int ktot = 0;
  for (int i = 0; i < nparts; ++i) {
    const Part& p = parts[i];
    if (p.c < 8 || p.c % 8 || (reinterpret_cast<uintptr_t>(p.ptr) & 15))
      return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)p.c, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)p.c * 2, (cuuint64_t)W * p.c * 2,
                                   (cuuint64_t)H * W * p.c * 2};
    const cuuint32_t box[4] = {64, kPW, kPH, 1};
    idx[i] = (unsigned char)*nmaps;
    const int err = cached_map(&maps[(*nmaps)++], p.ptr, 4, dims, strides, box);
    if (err) return err;
    ktot += p.c;
  }
  if (!chunk_list(c, 0, idx, parts, nparts, ka0, ka1) ||
      (c.split < c.ncol && !chunk_list(c, 1, idx, parts, nparts, kb0, kb1)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) & 15) return (int)cudaErrorInvalidValue;
  const cuuint64_t wdims[3] = {(cuuint64_t)ktot, (cuuint64_t)rows, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)ktot * 2, (cuuint64_t)rows * ktot * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)n, 1};
  c.map_w = (unsigned char)*nmaps;
  return cached_map(&maps[(*nmaps)++], w, 3, wdims, wstrides, wbox);
}

// One part over all its channels into `cols` columns.
inline int loop_conv1(LoopConv& c, CUtensorMap* maps, int* nmaps, const bf16* x, int cin, int B,
                      int H, int W, const bf16* w, int rows, int cols, int n) {
  const Part part{x, cin};
  const int split = (cols + n - 1) / n * n;
  return loop_conv(c, maps, nmaps, &part, 1, B, H, W, w, rows, cols, n, split, 0, cin, 0, cin);
}

inline int tiles_of(const LoopConv& c) { return c.patches * c.ncol; }

// The card's SM count. Returns 0 or a cudaError_t.
inline int sm_count(int* sms) {
  int dev = 0;
  const int err = (int)cudaGetDevice(&dev);
  return err ? err : (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The launch's grid: one block an SM, no more than the tiles.
template <class Kernel>
inline int loop_grid(Kernel kernel, int tiles, int* grid) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemBytes);
  if (err) return err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                kSmemBytes)))
    return err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  return 0;
}

// Launches one conv stage on `stream`. Returns the launch's cudaError_t.
template <int N, class Epi>
inline int launch_loop_conv(const LoopConv& c, const CUtensorMap* maps, int nmaps,
                            const Epi& epi, cudaStream_t stream) {
  LoopLaunch<Epi> p{};
  if (nmaps > kMaxMaps) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nmaps; ++i) p.maps[i] = maps[i];
  p.conv = c;
  p.epi = epi;
  int grid = 0;
  const int err = loop_grid(loop_conv_kernel<N, Epi>, tiles_of(c), &grid);
  if (err) return err;
  loop_conv_kernel<N, Epi><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The same, at a column tile width of 128 or 64 known at run time.
template <class Epi>
inline int launch_loop_conv_n(int n, const LoopConv& c, const CUtensorMap* maps, int nmaps,
                              const Epi& epi, cudaStream_t stream) {
  return n == 128 ? launch_loop_conv<128>(c, maps, nmaps, epi, stream)
                  : launch_loop_conv<64>(c, maps, nmaps, epi, stream);
}

}  // namespace loop
}  // namespace rst
