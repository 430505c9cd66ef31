// Kernels 5 and 6 of the train step: the single-chain tile blend, forward
// and backward.
//
// Forward, replaces fovsplat/ops/pallas/blend_fwd.py:472 _forward (the
// exact f32 train mode). One thread per pixel walks its tile's segment of
// the sorted pair list front to back. Rules (blend_fwd.py:129-143,
// 234-242; forward.cu:380-426):
//   alpha = min(0.99, op * exp(power)); skip when power > 0, power <
//   power_cutoff or alpha < 1/255; a pixel freezes BEFORE blending the
//   pair that would take T below 1e-4; the block stops once every pixel
//   is frozen (__syncthreads_count).
// Out: colour and final T (T, 4, PIX) and n_contrib (T, PIX), the 1-based
// rank in the segment of the pixel's last contributing pair.
// Bound: operations, each counted on the pair-pixels that need it, as
// kernel 8's (csrc/blend_stats.cu). Per pair and pixel walked before the
// pixel freezes 13 FLOP: the offsets and power 11, the window test 2.
// Where the power lies in the window 4 more: expf, alpha and its test.
// Where the pair contributes 10 more: T and its test 3, the weight 1, the
// colour 6. Per freezing pair 3: T and its test. The pair list is read
// once per tile. The loop issues far more instructions than it does FLOP,
// and a warp walks until its last pixel freezes, so the issue rate and
// idle lanes, not bytes, limit it. Kernel 3's design (common.cuh), measured against the rest by
// tools/ablate_blend_single.py (numbers in PERF.md):
// - a persistent grid of the resident blocks takes the tiles heaviest
//   first (order_kernel over the segment lengths);
// - each warp blends an 8x4 pixel block (fs::pixel_of), so a Gaussian
//   more often covers a warp whole and its pixels freeze together;
// - each pair is staged as a packed 12-float record [mx, my, ca, cb, cc,
//   op, r, g, b, blocks, -, -] (three 128-bit broadcast loads a pair and
//   pixel), through a two-stage cp.async ring of BATCH records: batch
//   k + 1 is in flight while batch k blends, and one barrier a batch,
//   which also counts the live pixels (the early exit);
// - once a record has landed, the thread that copied it marks the warps'
//   pixel blocks its window may reach (fs::window_blocks, a conservative
//   bound that accounts for the f32 rounding of the power), and a warp
//   skips a pair whose window reaches none of its pixels: every lane
//   would have failed the window test.
// The per-pixel arithmetic is the previous design's operation for
// operation, so colour, T and n_contrib are bit-identical to it.
//
// Forward-only inference variant (kernel 5q), replaces the same _forward
// as blend_pallas_fwd_only runs it (blend_fwd.py:947-956, mxu_power=True,
// :349-377). The same schedule and walk over the quantized rows [mx, my,
// P_caca, P_cbcc, OPRGB] of expand_ps1.cu's inference mode, with tile t's
// pairs [seg_start[t], seg_end[t]) (MM-FR empties segments; an empty
// tile sorts last). The ring stages the five raw words of each pair;
// after its copies land, each thread decodes the record it copied in
// place, once per pair (BATCH == THREADS): ca = hi + lo of P_caca, cb and
// cc the halves of P_cbcc, opacity u8 / 255, colour u8 * 2 / 255, and the
// mean moved to tile-local coordinates. The power is then computed
// directly in f32 from the local offsets; the JAX kernel's bf16x2
// bilinear MXU form (blend_fwd.py:182-212, ~2e-4 absolute) is a device of
// the TPU's matrix unit. Its geometry test is kept: power_cutoff <= power
// <= 3e-3 (the decoded bf16 conic need not be positive definite), G =
// exp(min(power, 0)). Bound as the train forward: operations, plus 20 B
// per pair read.
//
// Backward, replaces fovsplat/ops/pallas/blend_fwd.py:833 _backward. One
// block per tile walks back to front from the tile's deepest contributing
// pair (max n_contrib) and recovers T by division by (1 - alpha), clamped
// at 1 (backward.cu:503; blend_fwd.py:23-27): T_before = min(T_after /
// (1 - a), 1), starting from the saved final T. A pair contributed to a
// pixel iff it passes the alpha tests and its rank is below the pixel's
// n_contrib. Each pair's nine terms are reduced over the 256 pixels in a
// fixed order (a warp butterfly, skipped when no lane of the warp
// contributes, then the eight warp sums in warp order), so gradients are
// deterministic: no floating-point atomics. Each pair belongs to one tile,
// so one block owns its gradient rows and writes them once; rows past the
// deepest contributor, and lanes past the last segment, are written as
// zeros. The TPU kernel's read-merge-write of boundary chunks is a device
// of its chunked DMA and has no counterpart here.
// Bound: operations. Per pair and pixel up to the pixel's last contributor
// ~66 FLOP: power 11; the tests, expf and alpha 7; the T recovery 3; w,
// the colour dot, dL/dalpha and the suffix sum 13; the nine terms 23; and
// their sum over the tile's pixels 9 (the warp butterfly does 5 shuffles
// and adds per value where one add is needed). Bytes: 72 B per pair (rows
// in, gradients out) and 24 B per pixel.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = fs::BLEND_TILE;
constexpr int PIX = TILE * TILE;
constexpr int NWARPS = PIX / 32;
constexpr int THREADS = PIX;   // one pixel a thread
// Forward ring: BATCH records a stage, one a thread, so that each thread
// decodes (5q) the record whose rows it copied; REC floats a record.
constexpr int BATCH = THREADS;
constexpr int STAGES = 2;
constexpr int REC = fs::PAIR_REC;
using Rec = fs::PairRec;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
// Pair rows (ops/kernels/expand_ps1.py ATTR_ROWS, the first nine).
constexpr int NROWS = 9;
enum Attr { A_MX = 0, A_MY, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B };
// Fin rows of the backward: cotangents of r, g, b and T, and the final T.
enum Fin { F_GR = 0, F_GG, F_GB, F_GT, F_TF, NFIN };
constexpr int BWD_BATCH = 32;   // pairs staged per backward step
// Quantized rows (ops/kernels/expand_ps1.py Q_ROWS) and their decoding.
enum QRow { Q_MX = 0, Q_MY, Q_CACA, Q_CBCC, Q_OPRGB, QROWS };
constexpr float C_OP = 1.0f / 255.0f;
constexpr float C_COL = 2.0f / 255.0f;
constexpr float POWER_MAX_Q = 3e-3f;

__device__ inline float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xFFFF0000u);
}
__device__ inline float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }

template <int W>
__device__ inline float pair_power(float (*sm)[W], int j, float px, float py,
                                   float* dx, float* dy) {
  *dx = sm[A_MX][j] - px;
  *dy = sm[A_MY][j] - py;
  return -0.5f * (sm[A_CA][j] * *dx * *dx + sm[A_CC][j] * *dy * *dy) -
         sm[A_CB][j] * *dx * *dy;
}

// Kernel 5q's decoding of a record staged raw (the five quantized words
// in slots 0-4), in place, with the mean moved to tile-local
// coordinates.
__device__ inline void decode_q(Rec& r, float tx0, float ty0) {
  const float4 raw = r.q[0];
  const unsigned caca = __float_as_uint(raw.z);
  const unsigned cbcc = __float_as_uint(raw.w);
  const unsigned q = __float_as_uint(r.q[1].x);
  r.q[0] = make_float4(raw.x - tx0, raw.y - ty0,
                       bf16_hi(caca) + bf16_lo(caca), bf16_hi(cbcc));
  r.q[1] = make_float4(bf16_lo(cbcc), static_cast<float>(q >> 24) * C_OP,
                       static_cast<float>((q >> 16) & 255u) * C_COL,
                       static_cast<float>((q >> 8) & 255u) * C_COL);
  r.q[2].x = static_cast<float>(q & 255u) * C_COL;
}

// Tile t's pairs [start, end) blended into its pixels. Q = false: the
// train forward over the nine f32 rows, pixels in image coordinates.
// Q = true: kernel 5q over the quantized rows, in tile-local coordinates.
template <bool Q>
__device__ inline void blend_fwd_tile(const float* __restrict__ pairs,
                                      int cap, int start, int end, int t,
                                      int grid_x, float power_cutoff,
                                      float* __restrict__ out,
                                      int* __restrict__ n_contrib,
                                      Rec (*ring)[BATCH]) {
  constexpr int ROWS = Q ? QROWS : NROWS;
  constexpr float power_max = Q ? POWER_MAX_Q : 0.0f;
  const int p = fs::pixel_of(threadIdx.x);
  const float tx0 = static_cast<float>((t % grid_x) * TILE);
  const float ty0 = static_cast<float>((t / grid_x) * TILE);
  const float px = Q ? static_cast<float>(p % TILE)
                     : static_cast<float>((t % grid_x) * TILE + p % TILE);
  const float py = Q ? static_cast<float>(p / TILE)
                     : static_cast<float>((t / grid_x) * TILE + p / TILE);
  const unsigned warp_bit = 1u << (threadIdx.x >> 5);
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int nc = 0;
  bool done = false;

  const int count = max(end - start, 0);
  const int nb = (count + BATCH - 1) / BATCH;
  if (nb > 0)
    fs::stage_records<ROWS, REC>(
        pairs, cap, start, min(BATCH, count),
        reinterpret_cast<float*>(ring[0]));
  for (int b = 0; b < nb; ++b) {
    const int m = min(BATCH, count - b * BATCH);
    // Batch b has landed (this thread's copies); each thread decodes (5q)
    // and marks the record it copied. After the barrier every record is
    // visible and batch b - 1's stage is free.
    fs::cp_async_wait_all();
    if (static_cast<int>(threadIdx.x) < m) {
      Rec& r = ring[b & 1][threadIdx.x];
      if (Q) decode_q(r, tx0, ty0);
      fs::mark_blocks(r, Q ? 0.0f : tx0, Q ? 0.0f : ty0, power_cutoff);
    }
    if (__syncthreads_count(!done) == 0) break;
    if (b + 1 < nb) {
      const int next = (b + 1) * BATCH;
      fs::stage_records<ROWS, REC>(
          pairs, cap, start + next, min(BATCH, count - next),
          reinterpret_cast<float*>(ring[(b + 1) & 1]));
    }
    const Rec* recs = ring[b & 1];
    for (int j = 0; j < m && !done; ++j) {
      const float4 q2 = recs[j].q[2];
      if (!(__float_as_uint(q2.y) & warp_bit)) continue;  // whole warp
      const float4 q0 = recs[j].q[0], q1 = recs[j].q[1];
      const float dx = q0.x - px;
      const float dy = q0.y - py;
      const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                          q0.w * dx * dy;
      if (!(power <= power_max && power >= power_cutoff)) continue;  // NaN
      const float a = fminf(ALPHA_MAX, q1.y * expf(fminf(power, 0.0f)));
      if (!(a >= ALPHA_MIN)) continue;
      const float test = T * (1.0f - a);
      if (test < T_EPS) {
        done = true;
        break;
      }
      const float w = a * T;
      cr += q1.z * w;
      cg += q1.w * w;
      cb += q2.x * w;
      T = test;
      nc = b * BATCH + j + 1;
    }
  }
  float* o = out + static_cast<size_t>(t) * 4 * PIX + p;
  o[0 * PIX] = cr;
  o[1 * PIX] = cg;
  o[2 * PIX] = cb;
  o[3 * PIX] = T;
  n_contrib[t * PIX + p] = nc;
}

// Persistent blocks take tiles from the counter *next_tile in the order
// of fs::order_kernel until every tile is blended. Tile t's pairs are
// [seg_start[t], seg_end[t]); the train forward passes seg_end =
// seg_start + 1.
template <bool Q>
__global__ void __launch_bounds__(THREADS)
blend_fwd_kernel(const float* __restrict__ pairs, int cap,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ seg_end,
                 const int* __restrict__ order, int* __restrict__ next_tile,
                 int num_tiles, int grid_x, float power_cutoff,
                 float* __restrict__ out, int* __restrict__ n_contrib) {
  __shared__ Rec ring[STAGES][BATCH];
  __shared__ int tile_slot[2];
  for (int it = 0;; ++it) {
    const int t = fs::next_tile(order, next_tile, num_tiles, tile_slot, it);
    if (t < 0) return;
    blend_fwd_tile<Q>(pairs, cap, seg_start[t], seg_end[t], t, grid_x,
                      power_cutoff, out, n_contrib, ring);
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(PIX)
blend_bwd_kernel(const float* __restrict__ pairs, int cap,
                 const int* __restrict__ seg_start, int grid_x,
                 float power_cutoff, const float* __restrict__ fin,
                 const int* __restrict__ n_contrib,
                 float* __restrict__ grads) {
  __shared__ float sm[NROWS][BWD_BATCH];
  __shared__ float part[BWD_BATCH][NROWS][NWARPS];
  __shared__ int warp_max[NWARPS];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const float px = static_cast<float>((t % grid_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / grid_x) * TILE + p / TILE);
  const int start = seg_start[t], end = seg_start[t + 1];
  const float* f = fin + static_cast<size_t>(t) * NFIN * PIX + p;
  const float g_r = f[F_GR * PIX], g_g = f[F_GG * PIX], g_b = f[F_GB * PIX];
  const float gT_Tf = f[F_GT * PIX] * f[F_TF * PIX];
  const int nc = n_contrib[t * PIX + p];

  const int wmax = __reduce_max_sync(0xffffffffu, nc);
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  int max_nc = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) max_nc = max(max_nc, warp_max[w]);
  const int deepest = min(end, start + max_nc);

  for (int i = deepest + p; i < end; i += PIX) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) grads[static_cast<size_t>(r) * cap + i] = 0.0f;
  }

  float T = f[F_TF * PIX];   // T after the pixel's last contributing pair
  float S = 0.0f;            // sum over deeper pairs of w * (colour . g)
  for (int hi = deepest; hi > start; hi -= BWD_BATCH) {
    const int lo = max(start, hi - BWD_BATCH);
    const int m = hi - lo;
    __syncthreads();   // the previous batch's sm and part are consumed
    if (p < m) {
#pragma unroll
      for (int a = 0; a < NROWS; ++a)
        sm[a][p] = pairs[static_cast<size_t>(a) * cap + lo + p];
    }
    __syncthreads();
    for (int k = m - 1; k >= 0; --k) {
      float v[NROWS];
#pragma unroll
      for (int r = 0; r < NROWS; ++r) v[r] = 0.0f;
      float dx, dy;
      const float power = pair_power(sm, k, px, py, &dx, &dy);
      bool contrib = false;
      float G = 0.0f, a = 0.0f;
      if (power <= 0.0f && power >= power_cutoff && lo + k - start < nc) {
        G = expf(power);
        a = fminf(ALPHA_MAX, sm[A_OP][k] * G);
        contrib = a >= ALPHA_MIN;
      }
      if (contrib) {
        const float om = 1.0f - a;
        const float Tj = fminf(T / om, 1.0f);
        const float w = a * Tj;
        const float gc = g_r * sm[A_R][k] + g_g * sm[A_G][k] + g_b * sm[A_B][k];
        const float dL_da = gc * Tj - (S + gT_Tf) / om;
        S += w * gc;
        T = Tj;
        const float d_power = a * dL_da;
        const float ca = sm[A_CA][k], cb = sm[A_CB][k], cc = sm[A_CC][k];
        v[A_MX] = d_power * (-(ca * dx + cb * dy));
        v[A_MY] = d_power * (-(cc * dy + cb * dx));
        v[A_CA] = d_power * (-0.5f * dx * dx);
        v[A_CB] = d_power * (-dx * dy);
        v[A_CC] = d_power * (-0.5f * dy * dy);
        v[A_OP] = G * dL_da;
        v[A_R] = w * g_r;
        v[A_G] = w * g_g;
        v[A_B] = w * g_b;
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int r = 0; r < NROWS; ++r) v[r] = warp_sum(v[r]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NROWS; ++r) part[k][r][warp] = v[r];
      }
    }
    __syncthreads();
    for (int idx = p; idx < NROWS * m; idx += PIX) {
      const int r = idx / m, k = idx % m;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += part[k][r][w];
      grads[static_cast<size_t>(r) * cap + lo + k] = s;
    }
  }
}

// Zero the gradient rows of lanes past the last segment.
__global__ void zero_tail_kernel(float* __restrict__ grads, int cap,
                                 const int* __restrict__ num_pairs) {
  const int first = *num_pairs;
  for (int i = first + blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) grads[static_cast<size_t>(r) * cap + i] = 0.0f;
  }
}

}  // namespace

namespace {

// The forward of either kind: the tile order, then the persistent blend.
// scratch: num_tiles + 1 ints (the tile order and the tile counter).
template <bool Q>
int launch_fwd(const float* pairs, int cap, const int* seg_start,
               const int* seg_end, int num_tiles, int grid_x,
               float power_cutoff, int* scratch, float* out, int* n_contrib,
               void* stream) {
  if (num_tiles < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident[fs::MAX_DEVICES];
  int blocks = 0;
  cudaError_t err = fs::resident_blocks(blend_fwd_kernel<Q>, THREADS,
                                        resident, &blocks);
  if (err != cudaSuccess) return err;
  err = fs::tile_order(seg_start, seg_end, num_tiles, scratch, s);
  if (err != cudaSuccess) return err;
  blend_fwd_kernel<Q><<<min(num_tiles, blocks), THREADS, 0, s>>>(
      pairs, cap, seg_start, seg_end, scratch, scratch + num_tiles,
      num_tiles, grid_x, power_cutoff, out, n_contrib);
  return cudaGetLastError();
}

}  // namespace

FS_EXPORT int fs_blend_fwd(const float* pairs, int cap, const int* seg_start,
                           int num_tiles, int grid_x, float power_cutoff,
                           int* scratch, float* out, int* n_contrib,
                           void* stream) {
  return launch_fwd<false>(pairs, cap, seg_start, seg_start + 1, num_tiles,
                           grid_x, power_cutoff, scratch, out, n_contrib,
                           stream);
}

FS_EXPORT int fs_blend_fwd_q(const float* pairs, int cap,
                             const int* seg_start, const int* seg_end,
                             int num_tiles, int grid_x, float power_cutoff,
                             int* scratch, float* out, int* n_contrib,
                             void* stream) {
  return launch_fwd<true>(pairs, cap, seg_start, seg_end, num_tiles, grid_x,
                          power_cutoff, scratch, out, n_contrib, stream);
}

FS_EXPORT int fs_blend_bwd(const float* pairs, int cap, const int* seg_start,
                           int num_tiles, int grid_x, float power_cutoff,
                           const float* fin, const int* n_contrib,
                           float* grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blend_bwd_kernel<<<num_tiles, PIX, 0, s>>>(pairs, cap, seg_start, grid_x,
                                             power_cutoff, fin, n_contrib,
                                             grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = cap < 1024 * 256 ? (cap + 255) / 256 : 1024;
  zero_tail_kernel<<<blocks, 256, 0, s>>>(grads, cap, seg_start + num_tiles);
  return cudaGetLastError();
}
