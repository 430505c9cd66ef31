// Kernel 3 of the foveated frame: the dual-transmittance tile blend.
//
// Replaces fovsplat/ops/pallas/blend_fov.py:408 blend_fov_pallas. Each
// 16x16 tile walks its segment of the sorted pair list front to back with
// two chains per pixel, (T1, C1) and (T2, C2), as the reference's
// renderCUDA_blending. l1_active / l2_active mask each chain per pixel; a
// tile whose l2_active is all zero runs one chain. Rules (the per-pixel
// semantics of fovsplat/ops/foveated.py:315 _dual_blend):
//   alpha = min(0.99, op * exp(power)); skip when alpha < 1/255, power > 0
//   or power < power_cutoff; a chain freezes BEFORE blending the pair that
//   would take T below 1e-4; a tile stops once every pixel is frozen or
//   inactive in both chains.
// An L2-culled pair carries op2 = -1 (expand_fov.cu), which the alpha
// test rejects. expf, not __expf, and no fast math: the per-pair-pixel
// arithmetic is op for op that of blend_fov_plain, which keeps the freeze
// decisions, and so the images, within T_EPS of it.
//
// Bound: operations. The bound counts 25 FLOP a walked pair-pixel; the
// loop issues about 50-70 instructions for one pair and warp (the power,
// an accurate expf, two chain steps, the loop's tests), and a warp walks
// until its last pixel freezes, so the issue rate, not the pair list's
// bytes (read once per tile), is what limits the kernel. The design keeps
// the arithmetic and changes the data movement and the schedule; each
// change is measured against the others by tools/ablate_blend_fov.py
// (numbers in PERF.md). The tile order, the persistent grid, the cp.async
// copies and the pixel layout are common.cuh's, shared with kernels 5, 5q
// and 8:
//
// - Packed staging: each pair is staged as a 16-float record (the 13 rows
//   of ATTR_ROWS in order, padded), so a thread reads a pair with four
//   128-bit broadcast loads instead of 13 scalar ones.
// - Overlapped loads: a two-stage ring of BATCH records, filled with
//   cp.async, one barrier a batch. Batch k + 1 is in flight while batch k
//   blends; the barrier also counts the live pixels (the early exit).
//   Plain loads in the same ring were as fast at the centre gaze and up
//   to a tenth slower at a corner gaze; 64 or 256 records a stage are no
//   faster.
// - 8x4 pixel blocks a warp (pixel_of), not 16x2 rows: a Gaussian covers
//   a compact block whole more often, so fewer lanes idle and a warp's
//   pixels freeze closer together. It pays about a sixth over 16x2.
// - Heaviest tiles first: order_kernel sorts the tiles by segment length
//   (quarter-octave buckets, longest first) and a persistent grid of the
//   resident blocks takes the tiles in that order from an atomic counter,
//   so the foveal tiles start first instead of ending the last wave. It
//   pays about a fifth over raster order. A tile's output depends only on
//   its own segment, so neither the order nor the block that blends it can
//   change a bit.
// - One pixel a thread (PPT = 1). Two pixels a thread share a record's
//   loads but double a warp's footprint and are much slower; forcing more
//   resident blocks (fewer registers) is slower too.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int PPT = 1;                 // pixels a thread (see above)
constexpr int THREADS = PIX / PPT;     // threads a tile (a block)
constexpr int BATCH = 128;             // records a ring stage
constexpr int STAGES = 2;
constexpr int REC = 16;                // floats a staged record
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
// Pair attribute rows (ops/kernels/expand_fov.py ATTR_ROWS); record slot a
// holds row a: q[0] = (mx, my, ca, cb), q[1] = (cc, op1, op2, r1),
// q[2] = (g1, b1, r2, g2), q[3] = (b2, -, -, -).
constexpr int NUM_ATTRS = 13;

struct alignas(16) Rec {
  float4 q[REC / 4];
};

struct Chain {
  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  bool done;

  // One front-to-back step; freezes the chain instead of blending a pair
  // that would take T below T_EPS.
  __device__ inline void step(float op, float G, float cr, float cg,
                              float cb) {
    const float a = fminf(ALPHA_MAX, op * G);
    if (!(a >= ALPHA_MIN)) return;
    const float test = T * (1.0f - a);
    if (test < T_EPS) {
      done = true;
      return;
    }
    const float w = a * T;
    r += cr * w;
    g += cg * w;
    b += cb * w;
    T = test;
  }
};

// Issue the copies of `count` pairs from `base` into one ring stage, row
// by row so that a warp's 32 reads of a row are consecutive, every thread
// a share (the blend needs no record owned by one thread, as kernels 5
// and 8 do), and commit them as one group. fs::stage_records, where
// thread i copies record i, was 3.1% slower at the centre gaze and 2.6%
// faster at (0.2, 0.2) in one call (tools/ablate_blend_fov.py
// --variants owner_staging; PERF.md), so the centre's loop stays.
__device__ inline void stage_batch(const float* __restrict__ attrs, int cap,
                                   int base, int count, Rec* dst) {
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll 4
  for (int e = threadIdx.x; e < NUM_ATTRS * BATCH; e += THREADS) {
    const int a = e / BATCH, i = e % BATCH;
    if (i < count)
      fs::cp_async4(d + i * REC + a,
                    attrs + static_cast<size_t>(a) * cap + base + i);
  }
  fs::cp_async_commit();
}

// One staged pair against one pixel, in the plain version's order.
__device__ inline void blend_pair(const float4 (&q)[REC / 4], float px,
                                  float py, float power_cutoff, Chain& c1,
                                  Chain& c2) {
  const float dx = q[0].x - px;
  const float dy = q[0].y - py;
  const float power = -0.5f * (q[0].z * dx * dx + q[1].x * dy * dy) -
                      q[0].w * dx * dy;
  if (!(power <= 0.0f && power >= power_cutoff)) return;  // NaN too
  const float G = expf(power);
  if (!c1.done) c1.step(q[1].y, G, q[1].w, q[2].x, q[2].y);
  if (!c2.done) c2.step(q[1].z, G, q[2].z, q[2].w, q[3].x);
}

__device__ inline void blend_tile(const float* __restrict__ attrs, int cap,
                                  const int* __restrict__ seg_start,
                                  const bool* __restrict__ l1_active,
                                  const bool* __restrict__ l2_active,
                                  int grid_x, float power_cutoff,
                                  float* __restrict__ out, int t,
                                  Rec (*ring)[BATCH]) {
  const int start = seg_start[t], end = seg_start[t + 1];
  const int x0 = (t % grid_x) * TILE, y0 = (t / grid_x) * TILE;
  int pix[PPT];
  float px[PPT], py[PPT];
  Chain c1[PPT], c2[PPT];
  bool act2[PPT];
  bool any2 = false;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pix[k] = fs::pixel_of(threadIdx.x * PPT + k);
    px[k] = static_cast<float>(x0 + p % TILE);
    py[k] = static_cast<float>(y0 + p / TILE);
    c1[k].done = !l1_active[t * PIX + p];
    act2[k] = l2_active[t * PIX + p];
    any2 = any2 || act2[k];
  }
  const bool dual = __syncthreads_or(any2);
#pragma unroll
  for (int k = 0; k < PPT; ++k) c2[k].done = !(dual && act2[k]);

  const int count = end - start;
  const int nb = (count + BATCH - 1) / BATCH;
  if (nb > 0) stage_batch(attrs, cap, start, min(BATCH, count), ring[0]);
  for (int b = 0; b < nb; ++b) {
    // Batch b has landed (this thread's copies); after the barrier every
    // thread's copies are visible and batch b - 1's stage is free.
    fs::cp_async_wait_all();
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live = live || !(c1[k].done && c2[k].done);
    if (__syncthreads_count(live) == 0) break;
    if (b + 1 < nb) {
      const int next = (b + 1) * BATCH;
      stage_batch(attrs, cap, start + next, min(BATCH, count - next),
                  ring[(b + 1) & 1]);
    }
    const Rec* recs = ring[b & 1];
    const int m = min(BATCH, count - b * BATCH);
    for (int j = 0; j < m; ++j) {
      bool walk = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        walk = walk || !(c1[k].done && c2[k].done);
      if (!walk) break;
      // The whole record at once: reading the colours only when a chain
      // steps takes fewer registers (48 against 60) but is slower.
      float4 q[REC / 4];
#pragma unroll
      for (int s = 0; s < REC / 4; ++s) q[s] = recs[j].q[s];
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (!(c1[k].done && c2[k].done))
          blend_pair(q, px[k], py[k], power_cutoff, c1[k], c2[k]);
    }
  }

  // out (T, 8, PIX): C1 rgb, T1, C2 rgb, T2. An inactive chain leaves
  // C = 0, T = 1, as the plain version does.
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* o = out + static_cast<size_t>(t) * 8 * PIX + pix[k];
    o[0 * PIX] = c1[k].r;
    o[1 * PIX] = c1[k].g;
    o[2 * PIX] = c1[k].b;
    o[3 * PIX] = c1[k].T;
    o[4 * PIX] = c2[k].r;
    o[5 * PIX] = c2[k].g;
    o[6 * PIX] = c2[k].b;
    o[7 * PIX] = c2[k].T;
  }
}

// Persistent blocks take tiles from the atomic counter *next_tile, in the
// order of order_kernel, until every tile is blended.
__global__ void __launch_bounds__(THREADS)
blend_fov_kernel(const float* __restrict__ attrs, int cap,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ order, int* __restrict__ next_tile,
                 int num_tiles, const bool* __restrict__ l1_active,
                 const bool* __restrict__ l2_active, int grid_x,
                 float power_cutoff, float* __restrict__ out) {
  __shared__ Rec ring[STAGES][BATCH];
  __shared__ int tile_slot[2];
  for (int it = 0;; ++it) {
    const int t = fs::next_tile(order, next_tile, num_tiles, tile_slot, it);
    if (t < 0) return;
    blend_tile(attrs, cap, seg_start, l1_active, l2_active, grid_x,
               power_cutoff, out, t, ring);
  }
}

}  // namespace

// scratch: num_tiles + 1 ints (the tile order and the tile counter).
FS_EXPORT int fs_blend_fov(const float* attrs, int cap, const int* seg_start,
                           const bool* l1_active, const bool* l2_active,
                           int num_tiles, int grid_x, float power_cutoff,
                           int* scratch, float* out, void* stream) {
  if (num_tiles < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident[fs::MAX_DEVICES];
  int blocks = 0;
  cudaError_t err =
      fs::resident_blocks(blend_fov_kernel, THREADS, resident, &blocks);
  if (err != cudaSuccess) return err;
  err = fs::tile_order(seg_start, seg_start + 1, num_tiles, scratch, s);
  if (err != cudaSuccess) return err;
  blend_fov_kernel<<<min(num_tiles, blocks), THREADS, 0, s>>>(
      attrs, cap, seg_start, scratch, scratch + num_tiles, num_tiles,
      l1_active, l2_active, grid_x, power_cutoff, out);
  return cudaGetLastError();
}
