// Kernel 14 of the score pass: the per-Gaussian fetched-pair count.
//
// The counting rasterizers of modes "sum" and "loss_weighted_max_count"
// count a Gaussian once for every (tile, Gaussian) pair that the
// reference's fetch loop reads (..._pcheck_obb_sum/cuda_rasterizer/
// forward.cu:348-361): pairs are fetched in rounds of 256, and the loop
// ends at the first round start where every pixel of the tile is done.
// Kernel 8 (blend_stats.cu) writes each pixel's first_trig, the rank in
// its tile's segment of the pair that froze it (1 << 30 if none did).
//
// One block takes one tile, one thread a pixel:
// - The tile's fetch point nf, the rule of ops/kernels/fetch_count.py
//   tile_fetch_counts: 0 for a tile with no pixel inside width x height;
//   else the segment's length if an inside pixel never froze; else
//   min(seg_len, (floor(max_j / 256) + 1) * 256), max_j the largest
//   first_trig of the inside pixels. The padding pixels of edge tiles are
//   masked as blend.tile_inside_mask masks them. The rule is evaluated in
//   f32 operation for operation as the twin does (the integers converted
//   to nearest, the result truncated), so the two agree on every input;
//   for every first_trig and segment length below GID_EXACT (2^24, which
//   ops/stats.rasterize_stats enforces) it is the integer rule
//   min(seg_len, ((max_j >> 8) + 1) << 8).
// - The walk: lanes seg_start[t] .. seg_start[t] + nf - 1 only, read
//   coalesced, UNROLL loads in flight a thread; each lane whose gid lies
//   in [0, n) adds 1 to count[gid] with a 32-bit integer atomic, whose
//   result is unused (a reduction in L2). Integer adds give one answer in
//   any order, so two launches give the same bits. No float atomics.
// Lanes past a tile's fetch point, and past seg_start[T] (the kept
// pairs), are never read: nothing is sent to a sentinel slot. The caller
// zeroes count (n,) i32 on the same stream. seg_start[0] is 0, as every
// binning writes it.
//
// Bound: bytes, by need: first_trig of every tile read (4 B a pixel),
// seg_start (4 B a tile), the fetched lanes' gids read (4 B each) and the
// count written (4 B a Gaussian). No FLOP worth counting.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = fs::BLEND_TILE;
constexpr int PIX = TILE * TILE;
constexpr int THREADS = PIX;     // one pixel a thread
constexpr int NWARPS = THREADS / 32;
constexpr int UNROLL = 4;        // gid loads in flight a thread
constexpr int NEVER = 1 << 30;   // first_trig of a pixel that never froze
constexpr float ROUND = 256.0f;  // the reference's fetch-batch width
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
fetch_count_kernel(const int* __restrict__ first_trig,
                   const int* __restrict__ seg_start,
                   const int* __restrict__ gid, int n, int grid_x, int width,
                   int height, int* __restrict__ count) {
  __shared__ int warp_max[NWARPS];
  __shared__ int tile_nf;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = (t % grid_x) * TILE + p % TILE;
  const int py = (t / grid_x) * TILE + p / TILE;
  const bool inside = px < width && py < height;
  // The largest first_trig of the inside pixels (-1 for the others).
  int mx = inside ? first_trig[static_cast<size_t>(t) * PIX + p] : -1;
  mx = __reduce_max_sync(FULL, mx);
  if ((p & 31) == 0) warp_max[p >> 5] = mx;
  const bool any_inside = __syncthreads_or(inside);
  const int start = seg_start[t];
  if (p == 0) {
    int m = warp_max[0];
    for (int w = 1; w < NWARPS; ++w) m = max(m, warp_max[w]);
    // Rounding to nearest keeps the order, so the f32 of the largest is
    // the largest f32, and `never` (an inside pixel at or past NEVER in
    // f32) is the largest's test.
    const float seg_len = static_cast<float>(seg_start[t + 1] - start);
    const float max_j = static_cast<float>(m);
    const bool never = max_j >= static_cast<float>(NEVER);
    float f = (never || max_j < 0.0f)
                  ? seg_len
                  : fminf(seg_len, (floorf(max_j / ROUND) + 1.0f) * ROUND);
    if (!any_inside) f = 0.0f;
    tile_nf = static_cast<int>(f);
  }
  __syncthreads();
  const int nf = tile_nf;
  const int* __restrict__ g = gid + start;
  for (int base = 0; base < nf; base += THREADS * UNROLL) {
    int v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + p;
      v[u] = i < nf ? __ldg(g + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (static_cast<unsigned>(v[u]) < static_cast<unsigned>(n)) {
        atomicAdd(count + v[u], 1);
      }
    }
  }
}

}  // namespace

// count: n ints, zeroed by the caller.
FS_EXPORT int fs_fetch_count(const int* first_trig, const int* seg_start,
                             int num_tiles, const int* gid, int n,
                             int grid_x, int width, int height, int* count,
                             void* stream) {
  if (num_tiles < 1 || grid_x < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fetch_count_kernel<<<num_tiles, THREADS, 0, s>>>(
      first_trig, seg_start, gid, n, grid_x, width, height, count);
  return cudaGetLastError();
}
