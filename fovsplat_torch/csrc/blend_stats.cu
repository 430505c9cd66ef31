// Kernel 8 of the score pass: the single-chain blend forward with
// per-pair and per-pixel statistics.
//
// Replaces fovsplat/ops/pallas/blend_stats.py:196 blend_stats_pallas
// (_stats_kernel), the render loop of the reference's counting rasterizers
// (..._pcheck_obb_sum/cuda_rasterizer/forward.cu:364-435), which gather
// their statistics with float atomics. One thread per pixel walks its
// tile's segment front to back, kernel 5's walk on kernel 5's schedule
// and staging (csrc/blend_fwd.cu, common.cuh): a persistent grid that
// takes the tiles heaviest first, 8x4 pixel blocks a warp, packed 12-float
// records through a two-stage cp.async ring, one barrier a batch, and a
// warp skips a pair whose window reaches none of its pixels
// (fs::window_blocks). Rules (blend_stats.py:88-141):
//   alpha = min(0.99, op * exp(power)); a pair counts for a pixel only
//   when power lies in [power_cutoff, 0] and alpha >= 1/255; the pair that
//   would take T below 1e-4 freezes the pixel and does not contribute;
//   pixels outside width x height start frozen (blend_stats.py:56-59).
// Per pixel: colour and final T (T, 4, PIX); best_lane and best_w, the
// lane and weight of the pixel's largest alpha * T, the lowest lane on ties
// (a walk in lane order with a strict >), CAP and 0 if it has none; and
// first_trig, the rank in the segment of the pair that froze it, 1 << 30
// if none did.
// Per pair (4, CAP): w_sum, touched, w_max over the pixels it contributes
// to, and geo_win, the pixels not frozen before it whose power lies in the
// window (the freezing pair included, forward.cu:381). No warp-wide
// operation runs per pair: each lane writes one value per pair to its
// warp's buffer (-w where the pair contributes, -0 where only its power
// lies in the window, +0 elsewhere), and every 16 pairs the warp reduces
// the buffer's rows in lane order (warp_partials): touched and geo_win
// count the nonzero values and the signs, w_max is the largest magnitude
// taken on the bits (non-negative floats order as their bits, so it is
// exact), w_sum a sum in a fixed order. After the batch's barrier one pass
// adds the eight warps' partials in warp order and writes the rows. No
// float atomics, so the rows are deterministic; every output but w_sum is
// exact. A warp whose pixels are all frozen stops walking and writes zero
// partials for the rest of the batch. Each pair belongs to one tile, so
// one block writes its rows once. The block stops once every pixel is
// frozen (the batch barrier's count) and zeroes the rest of its segment;
// lanes past the last segment are zeroed too, where the TPU kernel leaves
// them unwritten.
// Bound: the larger of bytes and operations, each operation counted only
// on the pair-pixels that need it. Per pair and pixel walked before the
// pixel freezes 13 FLOP: power 11, the window test 2. Where the power lies
// in the window (geo_win) 5 more: expf, alpha and its test 4, the geo_win
// sum 1. Where the pair contributes (touched) 14 more: T and its test 3,
// the weight 1, the colour 6, the argmax compare 1, the w_sum, touched and
// w_max reductions 3. Per freezing pair 3: T and its test. Bytes: 36 B per pair in and 16 B out, 28 B per pixel out.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = fs::BLEND_TILE;
constexpr int PIX = TILE * TILE;
constexpr int THREADS = PIX;     // one pixel a thread
constexpr int NWARPS = THREADS / 32;
constexpr int BATCH = 96;        // records a ring stage
constexpr int GROUP = 16;        // pairs a warp reduces at once
constexpr int VSTRIDE = 33;      // a row of vbuf, padded (no bank conflicts)
constexpr int STAGES = 2;
constexpr int REC = fs::PAIR_REC;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ABS = 0x7fffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr int NEVER = 1 << 30;
constexpr int NROWS = 9;
enum Stat { S_WSUM = 0, S_TOUCHED, S_WMAX, S_GEO, NSTAT };

using Rec = fs::PairRec;

// One batch's per-warp partials of each pair: the warp's w_sum, the bits
// of its w_max, and its touched and geo_win counts (touched | geo << 16).
struct Partials {
  float wsum[BATCH][NWARPS];
  unsigned wmax[BATCH][NWARPS];
  unsigned counts[BATCH][NWARPS];
};

// One warp's partials of the pairs [j0, j0 + g) of the batch from vb, its
// per-pixel values of them (row jj, lane l: v of pair j0 + jj at lane l's
// pixel, -w where the pair contributes, -0 where only its power lies in
// the window, +0 elsewhere): lane l < 16 adds lanes 0-15 of row l and lane
// l + 16 lanes 16-31, each in lane order, then the two halves. Exact but
// for w_sum's rounding, which the fixed order makes deterministic.
__device__ inline void warp_partials(const float* vb, int g, int j0,
                                     int warp, int lane, Partials& pt) {
  const int row = lane & (GROUP - 1);
  float ws = 0.0f;
  unsigned wm = 0u, c = 0u;
  if (row < g) {
    const float* src = vb + row * VSTRIDE + (lane >> 4) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v = src[k];
      const unsigned u = __float_as_uint(v);
      ws -= v;
      wm = max(wm, u & ABS);
      c += ((u & ABS) != 0u ? 1u : 0u) | ((u >> 31) << 16);
    }
  }
  ws += __shfl_down_sync(FULL, ws, 16);
  wm = max(wm, __shfl_down_sync(FULL, wm, 16));
  c += __shfl_down_sync(FULL, c, 16);
  if (lane < g) {
    pt.wsum[j0 + lane][warp] = ws;
    pt.wmax[j0 + lane][warp] = wm;
    pt.counts[j0 + lane][warp] = c;
  }
}

// The stat rows of the batch's pairs [lane0, lane0 + m): the eight warp
// partials of each, in warp order.
__device__ inline void write_rows(const Partials& pt,
                                  float* __restrict__ stats, int cap,
                                  int lane0, int m) {
  for (int k = threadIdx.x; k < m; k += THREADS) {
    float ws = pt.wsum[k][0];
    unsigned wm = pt.wmax[k][0], c = pt.counts[k][0];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) {
      ws += pt.wsum[k][w];
      wm = max(wm, pt.wmax[k][w]);
      c += pt.counts[k][w];
    }
    float* row = stats + lane0 + k;
    row[S_WSUM * static_cast<size_t>(cap)] = ws;
    row[S_TOUCHED * static_cast<size_t>(cap)] =
        static_cast<float>(c & 0xFFFFu);
    row[S_WMAX * static_cast<size_t>(cap)] = __uint_as_float(wm);
    row[S_GEO * static_cast<size_t>(cap)] = static_cast<float>(c >> 16);
  }
}

__device__ inline void stats_tile(const float* __restrict__ pairs, int cap,
                                  const int* __restrict__ seg_start, int t,
                                  int grid_x, int width, int height,
                                  float power_cutoff, float* __restrict__ out,
                                  float* __restrict__ stats,
                                  int* __restrict__ best_lane,
                                  float* __restrict__ best_w,
                                  int* __restrict__ first_trig,
                                  Rec (*ring)[BATCH], Partials* part,
                                  float* vb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned warp_bit = 1u << warp;
  const int p = fs::pixel_of(threadIdx.x);
  const int ix = (t % grid_x) * TILE + p % TILE;
  const int iy = (t / grid_x) * TILE + p / TILE;
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(iy);
  const int start = seg_start[t], end = seg_start[t + 1];
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, bw = 0.0f;
  int bl = cap, ft = NEVER;
  bool done = !(ix < width && iy < height);

  const int count = max(end - start, 0);
  const int nb = (count + BATCH - 1) / BATCH;
  if (nb > 0)
    fs::stage_records<NROWS, REC>(
        pairs, cap, start, min(BATCH, count),
        reinterpret_cast<float*>(ring[0]));
  int b = 0;
  for (;; ++b) {
    // Batch b has landed (this thread's copies); each thread marks the
    // record it copied. After the barrier every record is visible, batch
    // b - 1's partials are complete and its ring stage is free.
    const int m = b < nb ? min(BATCH, count - b * BATCH) : 0;
    fs::cp_async_wait_all();
    if (static_cast<int>(threadIdx.x) < m)
      fs::mark_blocks(ring[b & 1][threadIdx.x],
                      static_cast<float>((t % grid_x) * TILE),
                      static_cast<float>((t / grid_x) * TILE), power_cutoff);
    const int live = __syncthreads_count(!done);
    if (b > 0)
      write_rows(part[(b - 1) & 1], stats, cap, start + (b - 1) * BATCH,
                 min(BATCH, count - (b - 1) * BATCH));
    if (b == nb || live == 0) break;
    if (b + 1 < nb) {
      const int next = (b + 1) * BATCH;
      fs::stage_records<NROWS, REC>(
          pairs, cap, start + next, min(BATCH, count - next),
          reinterpret_cast<float*>(ring[(b + 1) & 1]));
    }
    const Rec* recs = ring[b & 1];
    Partials& pt = part[b & 1];
    for (int j0 = 0; j0 < m; j0 += GROUP) {
      if (__all_sync(FULL, done)) {
        // Every pixel of the warp is frozen: zero partials for the rest.
        for (int k = j0 + lane; k < m; k += 32) {
          pt.wsum[k][warp] = 0.0f;
          pt.wmax[k][warp] = 0u;
          pt.counts[k][warp] = 0u;
        }
        break;
      }
      const int g = min(GROUP, m - j0);
      for (int jj = 0; jj < g; ++jj) {
        const int j = j0 + jj;
        const float4 q2 = recs[j].q[2];
        float v = 0.0f;
        // The pair reaches no pixel of the warp (window_blocks), or this
        // pixel is frozen: +0.
        if ((__float_as_uint(q2.y) & warp_bit) && !done) {
          const float4 q0 = recs[j].q[0], q1 = recs[j].q[1];
          const float dx = q0.x - px;
          const float dy = q0.y - py;
          const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                              q0.w * dx * dy;
          if (power <= 0.0f && power >= power_cutoff) {   // NaN fails
            v = -0.0f;
            const float a = fminf(ALPHA_MAX, q1.y * expf(power));
            if (a >= ALPHA_MIN) {
              const float test = T * (1.0f - a);
              if (test < T_EPS) {
                done = true;
                ft = b * BATCH + j;
              } else {
                const float w = a * T;
                cr += q1.z * w;
                cg += q1.w * w;
                cb += q2.x * w;
                T = test;
                v = -w;
                if (w > bw) {
                  bw = w;
                  bl = start + b * BATCH + j;
                }
              }
            }
          }
        }
        vb[jj * VSTRIDE + lane] = v;
      }
      __syncwarp();
      warp_partials(vb, g, j0, warp, lane, pt);
      __syncwarp();   // vb is rewritten by the next group
    }
  }
  // The block stopped early: the rest of its segment has zero rows.
  for (int i = start + b * BATCH + static_cast<int>(threadIdx.x); i < end;
       i += THREADS) {
#pragma unroll
    for (int r = 0; r < NSTAT; ++r) stats[static_cast<size_t>(r) * cap + i] = 0.0f;
  }

  float* o = out + static_cast<size_t>(t) * 4 * PIX + p;
  o[0 * PIX] = cr;
  o[1 * PIX] = cg;
  o[2 * PIX] = cb;
  o[3 * PIX] = T;
  best_lane[t * PIX + p] = bl;
  best_w[t * PIX + p] = bw;
  first_trig[t * PIX + p] = ft;
}

// Persistent blocks take tiles from the counter *next_tile in the order
// of fs::order_kernel until every tile is blended.
__global__ void __launch_bounds__(THREADS)
blend_stats_kernel(const float* __restrict__ pairs, int cap,
                   const int* __restrict__ seg_start,
                   const int* __restrict__ order, int* __restrict__ next_tile,
                   int num_tiles, int grid_x, int width, int height,
                   float power_cutoff, float* __restrict__ out,
                   float* __restrict__ stats, int* __restrict__ best_lane,
                   float* __restrict__ best_w, int* __restrict__ first_trig) {
  __shared__ Rec ring[STAGES][BATCH];
  __shared__ Partials part[2];
  __shared__ float vbuf[NWARPS][GROUP * VSTRIDE];
  __shared__ int tile_slot[2];
  for (int it = 0;; ++it) {
    const int t = fs::next_tile(order, next_tile, num_tiles, tile_slot, it);
    if (t < 0) return;
    stats_tile(pairs, cap, seg_start, t, grid_x, width, height, power_cutoff,
               out, stats, best_lane, best_w, first_trig, ring, part,
               vbuf[threadIdx.x >> 5]);
  }
}

// Zero the stat rows of lanes past the last segment.
__global__ void zero_tail_kernel(float* __restrict__ stats, int cap,
                                 const int* __restrict__ num_pairs) {
  const int first = *num_pairs;
  for (int i = first + blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int r = 0; r < NSTAT; ++r) stats[static_cast<size_t>(r) * cap + i] = 0.0f;
  }
}

}  // namespace

// scratch: num_tiles + 1 ints (the tile order and the tile counter).
FS_EXPORT int fs_blend_stats(const float* pairs, int cap, const int* seg_start,
                             int num_tiles, int grid_x, int width, int height,
                             float power_cutoff, int* scratch, float* out,
                             float* stats, int* best_lane, float* best_w,
                             int* first_trig, void* stream) {
  if (num_tiles < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident[fs::MAX_DEVICES];
  int blocks = 0;
  cudaError_t err =
      fs::resident_blocks(blend_stats_kernel, THREADS, resident, &blocks);
  if (err != cudaSuccess) return err;
  err = fs::tile_order(seg_start, seg_start + 1, num_tiles, scratch, s);
  if (err != cudaSuccess) return err;
  blend_stats_kernel<<<min(num_tiles, blocks), THREADS, 0, s>>>(
      pairs, cap, seg_start, scratch, scratch + num_tiles, num_tiles, grid_x,
      width, height, power_cutoff, out, stats, best_lane, best_w, first_trig);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int zblocks = cap < 1024 * 256 ? (cap + 255) / 256 : 1024;
  zero_tail_kernel<<<zblocks, 256, 0, s>>>(stats, cap, seg_start + num_tiles);
  return cudaGetLastError();
}
