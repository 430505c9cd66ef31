// Kernels 5 and 6 of the train step: the single-chain tile blend, forward
// and backward.
//
// Forward, replaces fovsplat/ops/pallas/blend_fwd.py:472 _forward (the
// exact f32 train mode). The blend_fov.cu design with one chain: one
// 256-thread block per 16x16 tile, one thread per pixel; the tile's
// segment of the sorted pair list is staged through shared memory 256
// pairs at a time and each thread walks it front to back. Rules
// (blend_fwd.py:129-143, 234-242; forward.cu:380-426):
//   alpha = min(0.99, op * exp(power)); skip when power > 0, power <
//   power_cutoff or alpha < 1/255; a pixel freezes BEFORE blending the
//   pair that would take T below 1e-4; the block stops once every pixel
//   is frozen (__syncthreads_count).
// Out: colour and final T (T, 4, PIX) and n_contrib (T, PIX), the 1-based
// rank in the segment of the pixel's last contributing pair.
// Bound: operations in the pair-pixel loop (~25 FLOP and one expf per
// pair and pixel walked); the pair list is read once per tile, one
// coalesced read per staged pair instead of 256.
//
// Forward-only inference variant (kernel 5q), replaces the same _forward
// as blend_pallas_fwd_only runs it (blend_fwd.py:947-956, mxu_power=True,
// :349-377). The same block and walk over the quantized rows [mx, my,
// P_caca, P_cbcc, OPRGB] of expand_ps1.cu's inference mode, with tile t's
// pairs [seg_start[t], seg_end[t]) (MM-FR empties segments). Each pair is
// decoded once, while it is staged: ca = hi + lo of P_caca, cb and cc the
// halves of P_cbcc, opacity u8 / 255, colour u8 * 2 / 255, and the mean
// moved to tile-local coordinates. The power is then computed directly in
// f32 from the local offsets; the JAX kernel's bf16x2 bilinear MXU form
// (blend_fwd.py:182-212, ~2e-4 absolute) is a device of the TPU's matrix
// unit. Its geometry test is kept: power_cutoff <= power <= 3e-3 (the
// decoded bf16 conic need not be positive definite), G = exp(min(power,
// 0)). Bound as the train forward: operations, plus 20 B per pair read.
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

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NWARPS = PIX / 32;
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
enum QRow { Q_MX = 0, Q_MY, Q_CACA, Q_CBCC, Q_OPRGB };
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

// Q = false: the train forward over f32 rows, tile t's pairs
// [seg_start[t], seg_start[t + 1]). Q = true: kernel 5q over the quantized
// rows, tile t's pairs [seg_start[t], seg_end[t]), in tile-local
// coordinates.
template <bool Q>
__global__ void __launch_bounds__(PIX)
blend_fwd_kernel(const float* __restrict__ pairs, int cap,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ seg_end, int grid_x,
                 float power_cutoff, float* __restrict__ out,
                 int* __restrict__ n_contrib) {
  __shared__ float sm[NROWS][PIX];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float tx0 = static_cast<float>((t % grid_x) * TILE);
  const float ty0 = static_cast<float>((t / grid_x) * TILE);
  const float px = Q ? static_cast<float>(p % TILE)
                     : static_cast<float>((t % grid_x) * TILE + p % TILE);
  const float py = Q ? static_cast<float>(p / TILE)
                     : static_cast<float>((t / grid_x) * TILE + p / TILE);
  const int start = seg_start[t];
  const int end = Q ? seg_end[t] : seg_start[t + 1];
  constexpr float power_max = Q ? POWER_MAX_Q : 0.0f;
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int nc = 0;
  bool done = false;

  for (int base = start; base < end; base += PIX) {
    if (__syncthreads_count(!done) == 0) break;
    const int i = base + p;
    if (i < end) {
      if (Q) {
        const unsigned* u = reinterpret_cast<const unsigned*>(pairs);
        const unsigned caca = u[static_cast<size_t>(Q_CACA) * cap + i];
        const unsigned cbcc = u[static_cast<size_t>(Q_CBCC) * cap + i];
        const unsigned q = u[static_cast<size_t>(Q_OPRGB) * cap + i];
        sm[A_MX][p] = pairs[static_cast<size_t>(Q_MX) * cap + i] - tx0;
        sm[A_MY][p] = pairs[static_cast<size_t>(Q_MY) * cap + i] - ty0;
        sm[A_CA][p] = bf16_hi(caca) + bf16_lo(caca);
        sm[A_CB][p] = bf16_hi(cbcc);
        sm[A_CC][p] = bf16_lo(cbcc);
        sm[A_OP][p] = static_cast<float>(q >> 24) * C_OP;
        sm[A_R][p] = static_cast<float>((q >> 16) & 255u) * C_COL;
        sm[A_G][p] = static_cast<float>((q >> 8) & 255u) * C_COL;
        sm[A_B][p] = static_cast<float>(q & 255u) * C_COL;
      } else {
#pragma unroll
        for (int a = 0; a < NROWS; ++a)
          sm[a][p] = pairs[static_cast<size_t>(a) * cap + i];
      }
    }
    __syncthreads();
    const int m = min(PIX, end - base);
    for (int j = 0; j < m && !done; ++j) {
      float dx, dy;
      const float power = pair_power(sm, j, px, py, &dx, &dy);
      if (!(power <= power_max && power >= power_cutoff)) continue;  // NaN
      const float a = fminf(ALPHA_MAX,
                            sm[A_OP][j] * expf(fminf(power, 0.0f)));
      if (!(a >= ALPHA_MIN)) continue;
      const float test = T * (1.0f - a);
      if (test < T_EPS) {
        done = true;
        break;
      }
      const float w = a * T;
      cr += sm[A_R][j] * w;
      cg += sm[A_G][j] * w;
      cb += sm[A_B][j] * w;
      T = test;
      nc = base + j - start + 1;
    }
    __syncthreads();
  }
  float* o = out + static_cast<size_t>(t) * 4 * PIX + p;
  o[0 * PIX] = cr;
  o[1 * PIX] = cg;
  o[2 * PIX] = cb;
  o[3 * PIX] = T;
  n_contrib[t * PIX + p] = nc;
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

FS_EXPORT int fs_blend_fwd(const float* pairs, int cap, const int* seg_start,
                           int num_tiles, int grid_x, float power_cutoff,
                           float* out, int* n_contrib, void* stream) {
  blend_fwd_kernel<false>
      <<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
          pairs, cap, seg_start, nullptr, grid_x, power_cutoff, out,
          n_contrib);
  return cudaGetLastError();
}

FS_EXPORT int fs_blend_fwd_q(const float* pairs, int cap,
                             const int* seg_start, const int* seg_end,
                             int num_tiles, int grid_x, float power_cutoff,
                             float* out, int* n_contrib, void* stream) {
  blend_fwd_kernel<true>
      <<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
          pairs, cap, seg_start, seg_end, grid_x, power_cutoff, out,
          n_contrib);
  return cudaGetLastError();
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
