// Kernels 13 and 13b: the mean SSIM of two images, forward and backward
// (ops/kernels/ssim.py).
//
// Replaces no Pallas kernel: the JAX package computes SSIM with jnp
// (fovsplat/train/losses.py ssim, a separable shift-add blur). In the
// port it was ~230 shift-add operations forward over (B * 3, H, W) copies
// of the images (train/losses.py _depthwise_blur, the plain twin) and
// more in their autograd backward: ~570 of a fine-tune step's ~940
// device operations.
//
// The function (train/losses.py ssim): per channel, G the 11-tap
// Gaussian window (sigma 1.5) applied along W and then along H with zero
// padding ("same"); mu_a = G a, mu_b = G b, s_a = G a^2 - mu_a^2, s_b =
// G b^2 - mu_b^2, s_ab = G ab - mu_a mu_b; the map m = (2 mu_a mu_b + C1)
// (2 s_ab + C2) / ((mu_a^2 + mu_b^2 + C1) (s_a + s_b + C2)), C1 = 0.01^2,
// C2 = 0.03^2; the loss its mean over every pixel and channel. robust
// clamps s_a and s_b at 0 and s_ab to +-sqrt(s_a s_b) (the prune and mask
// gates' form). The taps are the twin's f32 values, given by value.
//
//   13   forward: a block takes a 32 x 32 tile of one channel of one image
//        pair, stages it with a halo of 5 (zeros outside the image) from
//        the (B, H, W, 3) layout as it is, blurs the five products a, b,
//        a^2, b^2, ab along W into shared memory, then along H into
//        registers, forms the map and writes the block's sum; one block
//        then adds the partials in a fixed order and divides by the count.
//        Each map value takes the twin's operations in the twin's order
//        (nvcc's -fmad=false), so only the mean's order of sums differs.
//   13b  backward: the gradient of g x the mean, g the loss's cotangent
//        read on the card. With D = (mu_a^2 + mu_b^2 + C1)(s_a + s_b + C2)
//        and the map's factors A1 = 2 mu_a mu_b + C1, A2 = 2 s_ab + C2,
//        B1 = mu_a^2 + mu_b^2 + C1, B2 = s_a + s_b + C2, the map's
//        partials in the five blurred values are
//          dm/dmu_a = 2 (mu_b (A2 - A1) - mu_a m (B2 - B1)) / D,
//          dm/dG(a^2) = dm/dG(b^2) = -m / B2,  dm/dG(ab) = 2 A1 / D,
//        and dmean/da = (G dm/dmu_a + 2 a G dm/dG(a^2) + b G dm/dG(ab)) /
//        N: G is its own transpose (a symmetric window, zero padding), and
//        a coefficient outside the image is 0. A block takes a 16 x 32
//        tile of one channel, stages the images with a halo of 10,
//        recomputes the five maps over the tile and a halo of 5, forms the
//        three coefficients there (four where b's gradient is asked for:
//        dm/dmu_b = 2 (mu_a (A2 - A1) - mu_b m (B2 - B1)) / D), blurs them
//        along W and along H into the tile and writes the gradient. One
//        pass; nothing of the forward is read but the images.
//
// Bound, by need, counted as benchmark/reference/work.py counts
// SSIM_PIXEL (5 blurs, 2 passes, 11 taps, a multiply and an add a tap, 20
// for the map: 720 FLOP a pixel of 3 channels), at 1237x822: 13 reads
// the two images once (24.4 MB, 0.0073 ms at 3.35 TB/s) and runs 0.732
// GFLOP (0.0109 ms at 67 TFLOP/s), so operations bound it; 13b reads the
// images and writes one gradient (36.6 MB, 0.0109 ms) and runs the five
// blurs again, the map and its three coefficients (~50) and their three
// blurs (132): 1,221 FLOP a pixel, 1.24 GFLOP, 0.0185 ms, operations.
// Nothing the autograd version kept in device memory (the permuted
// copies, the padded tensors, the five maps, the products, their
// cotangents) leaves shared memory or registers here. The tiles' halos
// add work: 13 blurs 42 x 32 values along W for 32 x 32 outputs, 1.3x
// the bound's count of that pass; 13b's halo of 10 brings its
// recomputation to ~2.5x. Each blur gives a thread Q (or QW) outputs in
// a row or column, so a staged value is read once for Q outputs, not Q
// times: a third of the shared-memory reads of one output a thread.
//
// Deterministic: no atomics, every sum in a fixed order; f32 throughout,
// no TF32, no cuDNN.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads a block
constexpr int K = 11;              // taps
constexpr int R = K / 2;           // the window's reach
constexpr int Q = 4;               // outputs a thread takes in a blur

// 13: a block's output tile, and the tile with a halo of R.
constexpr int FH = 32, FW = 32;
constexpr int IH = FH + 2 * R, IW = FW + 2 * R;
// 13b: a block's output tile, with a halo of 2R (the images) and of R
// (the maps); the products along W get Q - 2 rows more, read only for
// the maps' last, partial group of Q rows.
constexpr int TH = 16, TW = 32;
constexpr int BH = TH + 4 * R, BW = TW + 4 * R;
constexpr int MH = TH + 2 * R, MW = TW + 2 * R;
constexpr int MG = (MH + Q - 1) / Q;          // groups of Q map rows
constexpr int HR = MG * Q + K - 1;            // rows of a product plane
constexpr int QW = 6;                         // MW / QW along W in 13b
static_assert(FW % Q == 0 && FH % Q == 0 && TW % Q == 0 && MW % QW == 0 &&
              TH % 2 == 0 && HR >= BH, "whole groups");

struct Window {  // the twin's taps, f32
  float g[K];
};

// Channel c of image pair z = batch * 3 + c over rows [y0, y0 + rows) and
// columns [x0, x0 + cols) into sa and sb (rows x cols), zeros outside the
// h x w image.
__device__ inline void stage(const float* __restrict__ a,
                             const float* __restrict__ b, int h, int w,
                             int y0, int x0, int rows, int cols, float* sa,
                             float* sb) {
  const int z = blockIdx.z, bi = z / 3, c = z - bi * 3;
  const size_t base = static_cast<size_t>(bi) * h * w * 3 + c;
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, s = i - r * cols;
    const int y = y0 + r, x = x0 + s;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    const size_t e = base + (static_cast<size_t>(y) * w + x) * 3;
    sa[i] = in ? __ldg(a + e) : 0.f;
    sb[i] = in ? __ldg(b + e) : 0.f;
  }
}

// One tap of a blur into Q outputs: x, the j-th value of the window run,
// enters output o with tap j - o, in the twin's order (g0 x0, then
// + g_t x_t), so every output's sum runs over t = 0 .. K - 1 in turn.
template <int QN>
__device__ __forceinline__ void tap(const Window& g, int j, float x,
                                    float v[QN]) {
#pragma unroll
  for (int o = 0; o < QN; ++o) {
    const int t = j - o;
    if (t == 0) {
      v[o] = g.g[0] * x;
    } else if (t > 0 && t < K) {
      v[o] = v[o] + g.g[t] * x;
    }
  }
}

// The five products (a, b, a^2, b^2, ab) of rows x (cols + 2R) staged
// values (row stride cols + 2R) blurred along W into hs[k] (row stride
// cols, planes `plane` apart), QN columns a thread.
template <int QN>
__device__ inline void blur_products_w(const float* sa, const float* sb,
                                       int rows, int cols, const Window& g,
                                       float* hs, int plane) {
  const int in_w = cols + 2 * R, groups = cols / QN;
  for (int i = threadIdx.x; i < rows * groups; i += NT) {
    const int r = i / groups, s0 = (i - r * groups) * QN;
    const float* pa = sa + r * in_w + s0;
    const float* pb = sb + r * in_w + s0;
    float v[5][QN];
#pragma unroll
    for (int j = 0; j < QN + K - 1; ++j) {
      const float x = pa[j], y = pb[j];
      tap<QN>(g, j, x, v[0]);
      tap<QN>(g, j, y, v[1]);
      tap<QN>(g, j, x * x, v[2]);
      tap<QN>(g, j, y * y, v[3]);
      tap<QN>(g, j, x * y, v[4]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int o = 0; o < QN; ++o) hs[k * plane + r * cols + s0 + o] = v[k][o];
    }
  }
}

// N planes (row stride cols, planes `plane` apart) at column s, rows
// [r0, r0 + QN + K - 1), blurred along H into QN outputs of each plane.
template <int N, int QN>
__device__ __forceinline__ void blur_h(const float* p, int plane, int cols,
                                       int r0, int s, const Window& g,
                                       float v[N][QN]) {
#pragma unroll
  for (int j = 0; j < QN + K - 1; ++j) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      tap<QN>(g, j, p[k * plane + (r0 + j) * cols + s], v[k]);
    }
  }
}

struct Map {         // the map and its factors at one pixel
  float mu_a, mu_b, m, A1, A2, B1, B2, D;
};

// The map from the five blurred values (v[k][o], output o), in the
// twin's operations.
template <bool ROBUST>
__device__ __forceinline__ Map ssim_map(const float v[5][Q], int o, float c1,
                                        float c2) {
  const float mu_a = v[0][o], mu_b = v[1][o];
  const float aa = mu_a * mu_a, bb = mu_b * mu_b, ab = mu_a * mu_b;
  float s_a = v[2][o] - aa, s_b = v[3][o] - bb, s_ab = v[4][o] - ab;
  if (ROBUST) {
    s_a = fmaxf(s_a, 0.f);
    s_b = fmaxf(s_b, 0.f);
    const float lim = sqrtf(s_a * s_b);
    s_ab = fminf(fmaxf(s_ab, -lim), lim);
  }
  Map p;
  p.mu_a = mu_a;
  p.mu_b = mu_b;
  p.A1 = 2.f * ab + c1;
  p.A2 = 2.f * s_ab + c2;
  p.B1 = aa + bb + c1;
  p.B2 = s_a + s_b + c2;
  p.D = p.B1 * p.B2;
  p.m = (p.A1 * p.A2) / p.D;
  return p;
}

// ---------------------------------------------------------------- 13

template <bool ROBUST>
__global__ void __launch_bounds__(NT)
ssim_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                int h, int w, Window g, float c1, float c2,
                float* __restrict__ partial) {
  __shared__ float sa[IH * IW], sb[IH * IW];
  __shared__ float hs[5 * IH * FW];
  const int y0 = blockIdx.y * FH, x0 = blockIdx.x * FW;
  stage(a, b, h, w, y0 - R, x0 - R, IH, IW, sa, sb);
  __syncthreads();
  blur_products_w<Q>(sa, sb, IH, FW, g, hs, IH * FW);
  __syncthreads();
  float acc = 0.f;
  for (int i = threadIdx.x; i < FH / Q * FW; i += NT) {
    const int r0 = i / FW * Q, s = i - i / FW * FW;
    if (x0 + s >= w) continue;
    float v[5][Q];
    blur_h<5, Q>(hs, IH * FW, FW, r0, s, g, v);
#pragma unroll
    for (int o = 0; o < Q; ++o) {
      if (y0 + r0 + o < h) acc += ssim_map<ROBUST>(v, o, c1, c2).m;
    }
  }
  const float sum = fs::block_sum<NT>(acc);
  if (threadIdx.x == 0) {
    partial[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                gridDim.x + blockIdx.x] = sum;
  }
}

// One block: the partials in order, over the count n.
__global__ void __launch_bounds__(NT)
ssim_final_kernel(const float* __restrict__ partial, int n_partial, float n,
                  float* __restrict__ loss) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += NT) acc += partial[i];
  const float s = fs::block_sum<NT>(acc);
  if (threadIdx.x == 0) loss[0] = s / n;
}

// ---------------------------------------------------------------- 13b

// 13b's shared memory: the images, the products along W and the
// coefficient planes (dm/dmu_a, dm/dG(a^2) = dm/dG(b^2), dm/dG(ab), and
// dm/dmu_b where b's gradient is asked for).
size_t bwd_smem(bool grad_b) {
  return sizeof(float) *
         (2 * BH * BW + 5 * HR * MW + (grad_b ? 4 : 3) * MH * MW);
}

template <bool GRAD_B>
__global__ void __launch_bounds__(NT)
ssim_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                int h, int w, Window g, float c1, float c2,
                const float* __restrict__ gscale, float n,
                float* __restrict__ da, float* __restrict__ db) {
  constexpr int NC = GRAD_B ? 4 : 3;  // bwd_smem's coefficient planes
  extern __shared__ float smem[];
  float* sa = smem;                  // BH x BW: the images, halo 2R
  float* sb = sa + BH * BW;
  float* hs = sb + BH * BW;          // 5 x HR x MW: the products along W
  float* cf = hs + 5 * HR * MW;      // NC x MH x MW: the coefficients
  float* hc = hs;                    // NC x MH x TW: theirs along W
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  stage(a, b, h, w, y0 - 2 * R, x0 - 2 * R, BH, BW, sa, sb);
  __syncthreads();
  blur_products_w<QW>(sa, sb, BH, MW, g, hs, HR * MW);
  __syncthreads();
  // The maps and their coefficients over the tile and a halo of R, Q rows
  // a thread; a coefficient outside the image is 0. The last group's rows
  // past MH read rows of hs that nothing wrote, and are dropped.
  for (int i = threadIdx.x; i < MG * MW; i += NT) {
    const int r0 = i / MW * Q, s = i - i / MW * MW;
    const int x = x0 - R + s;
    float v[5][Q];
    blur_h<5, Q>(hs, HR * MW, MW, r0, s, g, v);
#pragma unroll
    for (int o = 0; o < Q; ++o) {
      const int r = r0 + o, y = y0 - R + r;
      if (r >= MH) break;
      float c[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) c[k] = 0.f;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        const Map p = ssim_map<false>(v, o, c1, c2);
        const float d = p.A2 - p.A1, e = p.m * (p.B2 - p.B1);
        c[0] = 2.f * (p.mu_b * d - p.mu_a * e) / p.D;
        c[1] = -p.m / p.B2;
        c[2] = 2.f * p.A1 / p.D;
        if (GRAD_B) c[3] = 2.f * (p.mu_a * d - p.mu_b * e) / p.D;
      }
#pragma unroll
      for (int k = 0; k < NC; ++k) cf[k * MH * MW + r * MW + s] = c[k];
    }
  }
  __syncthreads();  // hs read for the last time; hc takes its place
  for (int i = threadIdx.x; i < MH * (TW / Q); i += NT) {
    const int r = i / (TW / Q), s0 = (i - r * (TW / Q)) * Q;
    float v[NC][Q];
#pragma unroll
    for (int j = 0; j < Q + K - 1; ++j) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        tap<Q>(g, j, cf[k * MH * MW + r * MW + s0 + j], v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
#pragma unroll
      for (int o = 0; o < Q; ++o) hc[k * MH * TW + r * TW + s0 + o] = v[k][o];
    }
  }
  __syncthreads();
  const float scale = gscale[0] / n;
  const int z = blockIdx.z, bi = z / 3, ch = z - bi * 3;
  for (int i = threadIdx.x; i < TH / 2 * TW; i += NT) {
    const int r0 = i / TW * 2, s = i - i / TW * TW;
    const int x = x0 + s;
    if (x >= w) continue;
    float v[NC][2];
    blur_h<NC, 2>(hc, MH * TW, TW, r0, s, g, v);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int r = r0 + o, y = y0 + r;
      if (y >= h) break;
      const float av = sa[(r + 2 * R) * BW + s + 2 * R];
      const float bv = sb[(r + 2 * R) * BW + s + 2 * R];
      const size_t e =
          ((static_cast<size_t>(bi) * h + y) * w + x) * 3 + ch;
      da[e] = (v[0][o] + 2.f * av * v[1][o] + bv * v[2][o]) * scale;
      if (GRAD_B) {
        db[e] = (v[3][o] + 2.f * bv * v[1][o] + av * v[2][o]) * scale;
      }
    }
  }
}

dim3 fwd_grid(int batch, int h, int w) {
  return dim3((w + FW - 1) / FW, (h + FH - 1) / FH, batch * 3);
}

dim3 bwd_grid(int batch, int h, int w) {
  return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, batch * 3);
}

// The values the mean takes, as torch.mean's f32 divisor.
float count(int batch, int h, int w) {
  return static_cast<float>(static_cast<double>(batch) * h * w * 3);
}

}  // namespace

// The number of partial sums kernel 13 writes for `batch` h x w images.
FS_EXPORT int fs_ssim_partials(int batch, int h, int w) {
  const dim3 g = fwd_grid(batch, h, w);
  return static_cast<int>(g.x * g.y * g.z);
}

// Kernel 13: the mean SSIM (loss, one float) of the image pairs a and b,
// (batch, h, w, 3) f32; partial holds fs_ssim_partials floats.
FS_EXPORT int fs_ssim_fwd(const float* a, const float* b, int batch, int h,
                          int w, Window g, float c1, float c2, int robust,
                          float* partial, float* loss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = fwd_grid(batch, h, w);
  if (robust) {
    ssim_fwd_kernel<true><<<grid, NT, 0, st>>>(a, b, h, w, g, c1, c2,
                                               partial);
  } else {
    ssim_fwd_kernel<false><<<grid, NT, 0, st>>>(a, b, h, w, g, c1, c2,
                                                partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_partial = static_cast<int>(grid.x * grid.y * grid.z);
  ssim_final_kernel<<<1, NT, 0, st>>>(partial, n_partial, count(batch, h, w),
                                      loss);
  return cudaGetLastError();
}

// Kernel 13b: da (and db, unless null) the gradient of gscale[0] times
// the mean SSIM of a and b, (batch, h, w, 3) f32.
FS_EXPORT int fs_ssim_bwd(const float* a, const float* b, int batch, int h,
                          int w, Window g, float c1, float c2,
                          const float* gscale, float* da, float* db,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = bwd_grid(batch, h, w);
  const float n = count(batch, h, w);
  cudaError_t err;
  if (db != nullptr) {
    err = cudaFuncSetAttribute(ssim_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_smem(true)));
    if (err != cudaSuccess) return err;
    ssim_bwd_kernel<true><<<grid, NT, bwd_smem(true), st>>>(
        a, b, h, w, g, c1, c2, gscale, n, da, db);
  } else {
    err = cudaFuncSetAttribute(ssim_bwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_smem(false)));
    if (err != cudaSuccess) return err;
    ssim_bwd_kernel<false><<<grid, NT, bwd_smem(false), st>>>(
        a, b, h, w, g, c1, c2, gscale, n, da, nullptr);
  }
  return cudaGetLastError();
}
