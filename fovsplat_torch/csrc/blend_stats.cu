// Kernel 8 of the score pass: the single-chain blend forward with
// per-pair and per-pixel statistics.
//
// Replaces fovsplat/ops/pallas/blend_stats.py:196 blend_stats_pallas
// (_stats_kernel), the render loop of the reference's counting rasterizers
// (..._pcheck_obb_sum/cuda_rasterizer/forward.cu:364-435), which gather
// their statistics with float atomics. One 256-thread block per 16x16 tile,
// one thread per pixel, kernel 5's walk (csrc/blend_fwd.cu): the tile's
// segment is staged through shared memory BATCH pairs at a time and each
// pixel walks it front to back. Rules (blend_stats.py:88-141):
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
// window (the freezing pair included, forward.cu:381). The four are reduced
// over the tile's 256 pixels in a fixed order, kernel 6's: a warp butterfly
// (skipped when no lane of the warp is in the window), then the eight warp
// values in warp order. No float atomics, so the rows are deterministic.
// Each pair belongs to one tile, so one block writes its rows once. The
// block stops once every pixel is frozen (__syncthreads_count) and zeroes
// the rest of its segment; lanes past the last segment are zeroed too,
// where the TPU kernel leaves them unwritten.
// Bound: the larger of bytes and operations, each operation counted only
// on the pair-pixels that need it. Per pair and pixel walked before the
// pixel freezes 13 FLOP: power 11, the window test 2. Where the power lies
// in the window (geo_win) 5 more: expf, alpha and its test 4, the geo_win
// sum 1. Where the pair contributes (touched) 14 more: T and its test 3,
// the weight 1, the colour 6, the argmax compare 1, the w_sum, touched and
// w_max reductions 3 (the butterfly does 5 shuffles and operations per
// value where one is needed). Per freezing pair 3: T and its test. Bytes:
// 36 B per pair in and 16 B out, 28 B per pixel out.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NWARPS = PIX / 32;
constexpr int BATCH = 32;   // pairs staged per step
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr int NEVER = 1 << 30;
constexpr int NROWS = 9;
enum Attr { A_MX = 0, A_MY, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B };
enum Stat { S_WSUM = 0, S_TOUCHED, S_WMAX, S_GEO, NSTAT };

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(PIX)
blend_stats_kernel(const float* __restrict__ pairs, int cap,
                   const int* __restrict__ seg_start, int grid_x, int width,
                   int height, float power_cutoff, float* __restrict__ out,
                   float* __restrict__ stats, int* __restrict__ best_lane,
                   float* __restrict__ best_w, int* __restrict__ first_trig) {
  __shared__ float sm[NROWS][BATCH];
  __shared__ float part[BATCH][NSTAT][NWARPS];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int ix = (t % grid_x) * TILE + p % TILE;
  const int iy = (t / grid_x) * TILE + p / TILE;
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(iy);
  const int start = seg_start[t], end = seg_start[t + 1];
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, bw = 0.0f;
  int bl = cap, ft = NEVER;
  bool done = !(ix < width && iy < height);

  int base = start;
  for (; base < end; base += BATCH) {
    // Also the barrier after the previous step's reads of sm and part.
    if (__syncthreads_count(!done) == 0) break;
    const int m = min(BATCH, end - base);
    if (p < m) {
#pragma unroll
      for (int a = 0; a < NROWS; ++a)
        sm[a][p] = pairs[static_cast<size_t>(a) * cap + base + p];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float v[NSTAT] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!done) {
        const float dx = sm[A_MX][j] - px;
        const float dy = sm[A_MY][j] - py;
        const float power = -0.5f * (sm[A_CA][j] * dx * dx +
                                     sm[A_CC][j] * dy * dy) -
                            sm[A_CB][j] * dx * dy;
        if (power <= 0.0f && power >= power_cutoff) {   // NaN fails
          v[S_GEO] = 1.0f;
          const float a = fminf(ALPHA_MAX, sm[A_OP][j] * expf(power));
          if (a >= ALPHA_MIN) {
            const float test = T * (1.0f - a);
            if (test < T_EPS) {
              done = true;
              ft = base + j - start;
            } else {
              const float w = a * T;
              cr += sm[A_R][j] * w;
              cg += sm[A_G][j] * w;
              cb += sm[A_B][j] * w;
              T = test;
              v[S_WSUM] = w;
              v[S_TOUCHED] = 1.0f;
              v[S_WMAX] = w;
              if (w > bw) {
                bw = w;
                bl = base + j;
              }
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, v[S_GEO] != 0.0f)) {
        v[S_WSUM] = warp_sum(v[S_WSUM]);
        v[S_TOUCHED] = warp_sum(v[S_TOUCHED]);
        v[S_WMAX] = warp_max(v[S_WMAX]);
        v[S_GEO] = warp_sum(v[S_GEO]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NSTAT; ++r) part[j][r][warp] = v[r];
      }
    }
    __syncthreads();
    for (int idx = p; idx < NSTAT * m; idx += PIX) {
      const int r = idx / m, k = idx % m;
      float s = part[k][r][0];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w)
        s = r == S_WMAX ? fmaxf(s, part[k][r][w]) : s + part[k][r][w];
      stats[static_cast<size_t>(r) * cap + base + k] = s;
    }
  }
  // The block stopped early: the rest of its segment has zero rows.
  for (int i = base + p; i < end; i += PIX) {
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

FS_EXPORT int fs_blend_stats(const float* pairs, int cap, const int* seg_start,
                             int num_tiles, int grid_x, int width, int height,
                             float power_cutoff, float* out, float* stats,
                             int* best_lane, float* best_w, int* first_trig,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blend_stats_kernel<<<num_tiles, PIX, 0, s>>>(
      pairs, cap, seg_start, grid_x, width, height, power_cutoff, out, stats,
      best_lane, best_w, first_trig);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = cap < 1024 * 256 ? (cap + 255) / 256 : 1024;
  zero_tail_kernel<<<blocks, 256, 0, s>>>(stats, cap, seg_start + num_tiles);
  return cudaGetLastError();
}
