// Kernels 11-12b: the uniform metameric (HVS) loss, forward and backward
// (ops/kernels/hvs_loss.py).
//
// Replaces no Pallas kernel: the JAX package computes this loss with jnp
// (fovsplat/perception/metameric.py statsmaps, metameric_loss_uniform;
// pyramid.py construct_pyramid). In the port it was ~4,400 autograd
// operations a step: each 5x5 filter bank as 25 materialised tap
// products, each of the 50 stats maps through four gather resamplings.
//
// The function (perception/metameric.py, its plain twin): the image
// resized (bilinear) up to the pyramid size and taken to YCrCb; h0 and l0
// of it; per band level l the six oriented bands of the lowpass L_l (5x5,
// reflection padding), L_{l+1} its 2x2 mean; for the h0 band and every
// oriented band B the pooled grids S1 = A B and S2 = A B^2 (A: the area
// pooling onto the level's grid, any ratio, bins [floor(i in / out),
// ceil((i + 1) in / out)) that may overlap by a pixel), the mean map U S1
// and the mean of squares U S2 (U: bilinear back up), std =
// sqrt(max(U S2 - (U S1)^2, 1e-7)); the loss the mean over the maps of the
// mean |gap| (L1) or gap^2 (MSE) of image and target, the last lowpass
// entering raw. The tables of A, U and the resize are metameric's
// (_resample_map), read here as they are.
//
//   11   level forward, one launch a band level, image and target as one
//        batch: a block takes 8 x 16 bins of the grid and walks the pixels
//        they cover in 32 x 64 chunks; per chunk it loads the lowpass with
//        a halo of 2 (at level 0 it makes it from the image: the resize,
//        YCrCb, l0, and h0 beside it), computes the bands into shared
//        memory, and each bin's thread adds its pixels and their squares.
//        Writes S1 and S2 of each band and the level's lowpass, nothing
//        else. A pixel in two bins or two blocks' chunks is computed in
//        both, never added with atomics.
//   11b  stats loss: a thread a band pixel, every band and channel; the
//        bilinear taps of the four grids (image and target, S1 and S2),
//        the std, the gaps; block partials, then one block adds them in a
//        fixed order with the last lowpass's term.
//   12   stats backward, one launch a band level: a block takes 8 x 16
//        bins, computes the cotangents of U S1 and U S2 of the pixels
//        their transposed bilinear taps reach (chunks in shared memory,
//        two planes at a time), and gathers them into dS1 and dS2 of each
//        bin, divided by its area.
//   12b  level backward, coarse to fine: a block takes 16 x 64 pixels of
//        the lowpass, loads it with a halo of 4, recomputes each band on
//        the tile and a halo of 2, dB = A^T dS1 + 2 B A^T dS2 there, and
//        applies the bank's transpose with the reflection folded back;
//        adds the coarser level's gradient through the 2x2 mean (or, at
//        the last band level, the last lowpass's term). At level 0 then
//        the image side: h0's and l0's transpose, YCrCb's, and the
//        resize's transpose.
//
// Full-resolution intermediates: none but each level's lowpass and its
// gradient, and at level 0 the gradient of the image at the pyramid size
// where the image is resized. Grids are at the pooled size (1.38 MB a
// band at 1237x822 and pooling 3).
//
// Bound, at 1237x822 and pooling 3 (chip_smoke.py's hvs_work), bytes by
// need: 11 by operations, 3.3 GFLOP, 0.049 ms (its bytes, the images read
// and the grids written, 163 MB, 0.049 ms); 11b by bytes (the grids and
// the final lowpass read), 0.041 ms; 12 by bytes (the grids read), 0.041
// ms; 12b by operations, ~3.5 GFLOP (the bands recomputed, their
// cotangents, the transposed banks), 0.052 ms. The design's own traffic
// beyond that (each level's lowpass and its gradient, 12's grid
// cotangents) is ~280 MB, ~0.08 ms. What the kernels keep in shared memory or registers (the
// bands, their taps, the maps, the std) is what the autograd version
// wrote to and read from device memory.
//
// Deterministic: no atomics, every sum in a fixed order; f32 throughout,
// no TF32, no cuDNN; nvcc's -fmad=false (ops/kernels/_build.py).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads a block
constexpr int NO = 6;              // orientations
constexpr int KS = 5;              // the cropped filters are 5 x 5
constexpr int KK = KS * KS;
constexpr int NF = (2 + NO) * KK;  // h0, l0 and the six band filters
constexpr int MAXL = 8;            // band levels one launch of 11b takes
constexpr float EPS = 1e-7f;       // _find_stats' variance floor

// Kernels 11 and 12: a block's bins and the pixel chunk it walks.
constexpr int TBH = 8, TBW = 16, NBIN = TBH * TBW;
constexpr int CH = 32, CW = 64, CHW = CH * CW;
// Kernels 12b and 12c: a block's output pixels, 4 a thread.
constexpr int TH = 16, TW = 64, PER = TH * TW / NT;
constexpr int PH = TH + 4, PW = TW + 4;  // the tile and a halo of 2
constexpr int LH = TH + 8, LW = TW + 8;  // the tile and a halo of 4

struct Taps {            // an (n, k) gather table: row i reads idx[i, :k]
  const long long* idx;  // with weights w[i, :k]; padding reads 0 with
  const float* w;        // weight 0
  int k;
};

struct Axis {      // one axis of one band level: n pixels, g bins
  int n, g;
  Taps area;       // (g, ka): each bin's pixels, weight 1
  const float* d;  // (g,): each bin's length
  Taps area_t;     // (n, kat): the bins that hold each pixel
  Taps up;         // (n, ku): bilinear, bins to pixels
  Taps up_t;       // (g, kut): its transpose
};

struct Resize {   // resize_for_pyramid's bilinear map, rows and columns;
  Taps h, w;      // h.idx null: the image has the pyramid size already
  Taps h_t, w_t;  // (h_in, k), (w_in, k): the transposes
  int h_in, w_in;
};

struct StatLevel {      // kernel 11b's view of one band level
  const float* grids;   // (2B, nb, 2, 3, gh, gw): the images, the targets
  Taps uh, uw;          // bilinear, (h, ku) and (w, ku)
  int h, w, gh, gw, nb;
  int block0;           // the level's first block
  float wt;             // 1 / (maps x B x h x w x 3)
};

struct StatLevels {
  StatLevel lv[MAXL];
  int n, batch;
};

// F.pad's "reflect" index for an overhang below n; clamped, for the halo
// rows a tile loads but never reads.
__device__ __forceinline__ int reflect(int m, int n) {
  m = m < 0 ? -m : m;
  m = m >= n ? 2 * (n - 1) - m : m;
  return min(max(m, 0), n - 1);
}

// Bin a's pixels [lo, hi) from an area table (its taps are the bin's
// pixels in order, weight 1).
__device__ inline void bin_range(const Taps& t, int a, int& lo, int& hi) {
  const long long* idx = t.idx + static_cast<size_t>(a) * t.k;
  const float* w = t.w + static_cast<size_t>(a) * t.k;
  int cnt = 0;
  for (int k = 0; k < t.k; ++k) cnt += w[k] != 0.f;
  lo = static_cast<int>(idx[0]);
  hi = lo + cnt;
}

// The pixels [lo, hi) that the bilinear taps of bins [a0, a1) reach (a
// transposed table; lo >= hi when none does).
__device__ inline void reach(const Taps& t, int a0, int a1, int& lo,
                             int& hi) {
  lo = INT_MAX;
  hi = 0;
  for (int a = a0; a < a1; ++a) {
    for (int k = 0; k < t.k; ++k) {
      const size_t e = static_cast<size_t>(a) * t.k + k;
      if (t.w[e] != 0.f) {
        const int p = static_cast<int>(t.idx[e]);
        lo = min(lo, p);
        hi = max(hi, p + 1);
      }
    }
  }
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);  // NaN stays NaN
}

// The YCrCb image at pyramid pixel (r, s), its three channels into
// out: the resize's bilinear taps of the RGB image x (h_in, w_in, 3), rows
// then columns, then rgb_to_ycrcb.
__device__ void ycrcb_at(const float* __restrict__ x, const Resize& rs, int r,
                         int s, float out[3]) {
  float rgb[3];
  if (rs.h.idx == nullptr) {
    const float* p = x + (static_cast<size_t>(r) * rs.w_in + s) * 3;
    rgb[0] = p[0];
    rgb[1] = p[1];
    rgb[2] = p[2];
  } else {
    const long long* ih = rs.h.idx + static_cast<size_t>(r) * rs.h.k;
    const float* wh = rs.h.w + static_cast<size_t>(r) * rs.h.k;
    const long long* iw = rs.w.idx + static_cast<size_t>(s) * rs.w.k;
    const float* ww = rs.w.w + static_cast<size_t>(s) * rs.w.k;
    for (int ch = 0; ch < 3; ++ch) {
      float v = 0.f;
      for (int j = 0; j < rs.w.k; ++j) {
        float t = 0.f;
        for (int i = 0; i < rs.h.k; ++i) {
          t += wh[i] * x[(ih[i] * rs.w_in + iw[j]) * 3 + ch];
        }
        v += ww[j] * t;
      }
      rgb[ch] = v;
    }
  }
  const float y = 0.299f * rgb[0] + 0.587f * rgb[1] + 0.114f * rgb[2];
  out[0] = y;
  out[1] = 0.5f + 0.713f * (rgb[0] - y);
  out[2] = 0.5f + 0.564f * (rgb[2] - y);
}

// The 5x5 cross-correlation of the tile t (row stride ld) with top-left
// (y, x), in the twin's row-major tap order.
__device__ __forceinline__ float conv5(const float* t, int ld, int y, int x,
                                       const float* k) {
  const float* p = t + y * ld + x;
  float acc = k[0] * p[0];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (i != 0 || j != 0) acc = acc + k[i * KS + j] * p[i * ld + j];
    }
  }
  return acc;
}

// The six oriented bands at once: each tap read once.
__device__ __forceinline__ void bands6(const float* t, int ld, int y, int x,
                                       const float* kb, float out[NO]) {
  const float* p = t + y * ld + x;
#pragma unroll
  for (int o = 0; o < NO; ++o) out[o] = kb[o * KK] * p[0];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (i == 0 && j == 0) continue;
      const float v = p[i * ld + j];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        out[o] = out[o] + kb[o * KK + i * KS + j] * v;
      }
    }
  }
}

// A pixel's bilinear taps into a grid (a table row holds at most two):
// the offsets of row tap i and column tap j, o[i][j] = row x ld + column
// (rows and columns counted from r0 and c0), and the weights. A padding
// tap reads the first one with weight 0.
struct Bilin {
  int o[2][2];
  float wh[2], ww[2];
};

__device__ __forceinline__ void taps2(const Taps& t, int p, int base,
                                      int i[2], float w[2]) {
  const long long* idx = t.idx + static_cast<size_t>(p) * t.k;
  const float* wt = t.w + static_cast<size_t>(p) * t.k;
  i[0] = static_cast<int>(idx[0]) - base;
  w[0] = wt[0];
  const bool two = t.k > 1 && wt[1] != 0.f;
  i[1] = two ? static_cast<int>(idx[1]) - base : i[0];
  w[1] = two ? wt[1] : 0.f;
}

__device__ __forceinline__ Bilin bilin(const Taps& uh, int r, const Taps& uw,
                                       int s, int r0, int c0, int ld) {
  Bilin b;
  int ih[2], iw[2];
  taps2(uh, r, r0, ih, b.wh);
  taps2(uw, s, c0, iw, b.ww);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) b.o[i][j] = ih[i] * ld + iw[j];
  }
  return b;
}

// A grid plane g brought up to the pixel: rows then columns, as the twin's
// resampling sums them.
__device__ __forceinline__ float up_at(const float* __restrict__ g,
                                       const Bilin& b) {
  const float t0 = b.wh[0] * g[b.o[0][0]] + b.wh[1] * g[b.o[1][0]];
  const float t1 = b.wh[0] * g[b.o[0][1]] + b.wh[1] * g[b.o[1][1]];
  return b.ww[0] * t0 + b.ww[1] * t1;
}

struct Stats {
  float ma, mb, sa, sb, va;
};

// The mean and std maps of image and target at a pixel from their S1
// and S2 planes.
__device__ __forceinline__ Stats stats_at(const float* a1, const float* a2,
                                          const float* b1, const float* b2,
                                          const Bilin& bl) {
  Stats st;
  st.ma = up_at(a1, bl);
  st.mb = up_at(b1, bl);
  const float m2a = up_at(a2, bl);
  const float m2b = up_at(b2, bl);
  st.va = m2a - st.ma * st.ma;
  const float vb = m2b - st.mb * st.mb;
  st.sa = sqrtf(st.va < EPS ? EPS : st.va);  // clamp keeps a NaN
  st.sb = sqrtf(vb < EPS ? EPS : vb);
  return st;
}

template <bool MSE>
__device__ __forceinline__ float gap(float a, float b) {
  const float d = a - b;
  return MSE ? d * d : fabsf(d);
}

template <bool MSE>
__device__ __forceinline__ float dgap(float a, float b, float w) {
  return MSE ? w * (2.f * (a - b)) : w * sgn(a - b);
}

// A block's sum of v, in a fixed order (thread 0 holds it).
__device__ float block_sum(float v) {
  __shared__ float warp_sums[NT / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  __syncthreads();  // warp_sums may still be read by a previous call
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NT / 32; ++i) s += warp_sums[i];
  }
  return s;
}

// ---------------------------------------------------------------- 11

template <bool L0>
__global__ void __launch_bounds__(NT)
hvs_level_fwd_kernel(const float* __restrict__ img_a,
                     const float* __restrict__ img_b, int n_a, Resize rs,
                     const float* __restrict__ prev, Axis ah, Axis aw,
                     const float* __restrict__ f_h0,
                     const float* __restrict__ f_l0,
                     const float* __restrict__ f_b, float* __restrict__ low,
                     float* __restrict__ grids) {
  constexpr int NB = L0 ? NO + 1 : NO;  // at level 0 h0 is band 0
  constexpr int LLD = CW + 4, YLD = CW + 8, YP = (CH + 8) * YLD;
  extern __shared__ float sm[];
  float* fs = sm;                         // h0, l0, b
  float* bs = fs + NF;                    // the chunk's bands
  float* ls = bs + NB * CHW;              // the lowpass, halo 2
  float* ys = ls + (CH + 4) * LLD;        // level 0: YCrCb, halo 4, 3 planes
  const int H = ah.n, W = aw.n, gh = ah.g, gw = aw.g, z = blockIdx.z;
  const int a0 = blockIdx.y * TBH, b0 = blockIdx.x * TBW;
  const int a1 = min(a0 + TBH, gh), b1 = min(b0 + TBW, gw);
  const int ta = a0 + threadIdx.x / TBW, tb = b0 + threadIdx.x % TBW;
  const bool mine = threadIdx.x < NBIN && ta < a1 && tb < b1;
  int r_lo = 0, r_hi = 0, c_lo = 0, c_hi = 0, unused;
  if (mine) {
    bin_range(ah.area, ta, r_lo, r_hi);
    bin_range(aw.area, tb, c_lo, c_hi);
  }
  // The block's pixels, and the part of them whose lowpass it writes.
  int R0, R1, C0, C1, K1 = H, Q1 = W;
  bin_range(ah.area, a0, R0, unused);
  bin_range(ah.area, a1 - 1, unused, R1);
  bin_range(aw.area, b0, C0, unused);
  bin_range(aw.area, b1 - 1, unused, C1);
  if (a1 < gh) bin_range(ah.area, a1, K1, unused);
  if (b1 < gw) bin_range(aw.area, b1, Q1, unused);
  for (int i = threadIdx.x; i < KK; i += NT) {
    fs[i] = f_h0[i];
    fs[KK + i] = f_l0[i];
  }
  for (int i = threadIdx.x; i < NO * KK; i += NT) fs[2 * KK + i] = f_b[i];
  const float* x = nullptr;
  if (L0) {
    const size_t img = static_cast<size_t>(rs.h_in) * rs.w_in * 3;
    x = z < n_a ? img_a + z * img : img_b + (z - n_a) * img;
  }
  float s1[3][NB], s2[3][NB];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int o = 0; o < NB; ++o) s1[c][o] = s2[c][o] = 0.f;
  }
  for (int cr = R0; cr < R1; cr += CH) {
    const int nr = min(CH, R1 - cr);
    for (int cc = C0; cc < C1; cc += CW) {
      const int nc = min(CW, C1 - cc);
      if (L0) {
        __syncthreads();  // the last chunk's reads of ys are done
        for (int i = threadIdx.x; i < (nr + 8) * (nc + 8); i += NT) {
          const int y = i / (nc + 8), xx = i - y * (nc + 8);
          float v[3];
          ycrcb_at(x, rs, reflect(cr - 4 + y, H), reflect(cc - 4 + xx, W), v);
#pragma unroll
          for (int c = 0; c < 3; ++c) ys[c * YP + y * YLD + xx] = v[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        __syncthreads();  // ys written; the last channel's reads are done
        if (L0) {
          // The lowpass at each padded position is l0 at the position it
          // reflects to.
          const float* yc = ys + c * YP;
          for (int i = threadIdx.x; i < (nr + 4) * (nc + 4); i += NT) {
            const int y = i / (nc + 4), xx = i - y * (nc + 4);
            ls[y * LLD + xx] = conv5(yc, YLD, reflect(cr - 2 + y, H) - cr + 2,
                                     reflect(cc - 2 + xx, W) - cc + 2,
                                     fs + KK);
          }
          for (int i = threadIdx.x; i < nr * nc; i += NT) {
            const int y = i / nc, xx = i - y * nc;
            bs[y * CW + xx] = conv5(yc, YLD, y + 2, xx + 2, fs);
          }
        } else {
          const float* pc =
              prev + (static_cast<size_t>(z) * 3 + c) * 4 * H * W;
          for (int i = threadIdx.x; i < (nr + 4) * (nc + 4); i += NT) {
            const int y = i / (nc + 4), xx = i - y * (nc + 4);
            const int r = reflect(cr - 2 + y, H), s = reflect(cc - 2 + xx, W);
            const float* p = pc + static_cast<size_t>(2 * r) * (2 * W) + 2 * s;
            ls[y * LLD + xx] = (p[0] + p[1] + p[2 * W] + p[2 * W + 1]) * 0.25f;
          }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < nr * nc; i += NT) {
          const int y = i / nc, xx = i - y * nc, r = cr + y, s = cc + xx;
          float v[NO];
          bands6(ls, LLD, y, xx, fs + 2 * KK, v);
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            bs[(o + NB - NO) * CHW + y * CW + xx] = v[o];
          }
          if (r >= R0 && r < K1 && s >= C0 && s < Q1) {
            low[((static_cast<size_t>(z) * 3 + c) * H + r) * W + s] =
                ls[(y + 2) * LLD + xx + 2];
          }
        }
        __syncthreads();
        if (mine) {
          const int rr0 = max(r_lo, cr), rr1 = min(r_hi, cr + nr);
          const int q0 = max(c_lo, cc), q1 = min(c_hi, cc + nc);
          for (int r = rr0; r < rr1; ++r) {
            for (int s = q0; s < q1; ++s) {
              const float* p = bs + (r - cr) * CW + (s - cc);
#pragma unroll
              for (int o = 0; o < NB; ++o) {
                const float v = p[o * CHW];
                s1[c][o] += v;
                s2[c][o] += v * v;
              }
            }
          }
        }
      }
    }
  }
  if (mine) {
    const float dh = ah.d[ta], dw = aw.d[tb];
    const size_t plane = static_cast<size_t>(gh) * gw;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int o = 0; o < NB; ++o) {
        float* g = grids + ((static_cast<size_t>(z) * NB + o) * 6 + c) * plane +
                   static_cast<size_t>(ta) * gw + tb;
        g[0] = s1[c][o] / dh / dw;
        g[3 * plane] = s2[c][o] / dh / dw;
      }
    }
  }
}

// ---------------------------------------------------------------- 11b

template <bool MSE>
__global__ void __launch_bounds__(NT)
hvs_stats_loss_kernel(StatLevels L, float* __restrict__ partial) {
  int l = 0;
  while (l + 1 < L.n && static_cast<int>(blockIdx.x) >= L.lv[l + 1].block0) ++l;
  const StatLevel v = L.lv[l];
  const int hw = v.h * v.w;
  const int i = (blockIdx.x - v.block0) * NT + threadIdx.x;
  float acc = 0.f;
  if (i < L.batch * hw) {
    const int b = i / hw, p = i - b * hw, r = p / v.w, s = p - r * v.w;
    const size_t plane = static_cast<size_t>(v.gh) * v.gw;
    const Bilin bl = bilin(v.uh, r, v.uw, s, 0, 0, v.gw);
    const float* ga = v.grids + static_cast<size_t>(b) * v.nb * 6 * plane;
    const float* gb =
        v.grids + static_cast<size_t>(b + L.batch) * v.nb * 6 * plane;
    for (int pl = 0; pl < v.nb * 3; ++pl) {
      const size_t e = (pl / 3 * 6 + pl % 3) * plane;  // band, channel
      const Stats st = stats_at(ga + e, ga + e + 3 * plane, gb + e,
                                gb + e + 3 * plane, bl);
      acc += gap<MSE>(st.ma, st.mb) + gap<MSE>(st.sa, st.sb);
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = s * v.wt;
}

// The 2x2 mean of plane p (h, w) at (r, s) of the half-size grid.
__device__ __forceinline__ float down2(const float* p, int w, int r, int s) {
  const float* q = p + static_cast<size_t>(2 * r) * w + 2 * s;
  return (q[0] + q[1] + q[w] + q[w + 1]) * 0.25f;
}

// One block: the partials in order, then the last lowpass's term: L4 =
// the 2x2 mean of the last band level's lowpass low (2B, 3, h, w).
template <bool MSE>
__global__ void __launch_bounds__(NT)
hvs_loss_final_kernel(const float* __restrict__ partial, int n_partial,
                      const float* __restrict__ low, int batch, int h, int w,
                      float wt4, float* __restrict__ loss) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += NT) acc += partial[i];
  const int h4 = h / 2, w4 = w / 2, n4 = batch * 3 * h4 * w4;
  const size_t img = static_cast<size_t>(3) * h * w;
  float t4 = 0.f;
  for (int i = threadIdx.x; i < n4; i += NT) {
    const int bc = i / (h4 * w4), p = i - bc * (h4 * w4), r = p / w4,
              s = p - r * w4;
    const float* pa = low + static_cast<size_t>(bc) * h * w;
    t4 += gap<MSE>(down2(pa, w, r, s), down2(pa + batch * img, w, r, s));
  }
  const float a = block_sum(acc);
  const float b = block_sum(t4);
  if (threadIdx.x == 0) loss[0] = a + b * wt4;
}

// ---------------------------------------------------------------- 12

template <bool MSE>
__global__ void __launch_bounds__(NT)
hvs_stats_bwd_kernel(const float* __restrict__ grids, int batch, int nb,
                     Axis ah, Axis aw, float wt,
                     const float* __restrict__ gscale, float* __restrict__ q) {
  constexpr int WH = TBH + 2, WW = TBW + 2;  // the grid window
  __shared__ float cs[2][2][CHW];   // two planes: d mean, d mean of squares
  __shared__ float gs[2][4][WH * WW];  // their grids: image S1, S2, target
  extern __shared__ float taps[];   // the bins' transposed bilinear taps
  const int gh = ah.g, gw = aw.g, b = blockIdx.z;
  const int a0 = blockIdx.y * TBH, b0 = blockIdx.x * TBW;
  const int a1 = min(a0 + TBH, gh), b1 = min(b0 + TBW, gw);
  const int half = threadIdx.x / NBIN, t = threadIdx.x % NBIN;
  const int ty = t / TBW, tx = t % TBW, ta = a0 + ty, tb = b0 + tx;
  const bool mine = ta < a1 && tb < b1;
  const int kh = ah.up_t.k, kw = aw.up_t.k;
  int* th_i = reinterpret_cast<int*>(taps);
  float* th_w = taps + TBH * kh;
  int* tw_i = reinterpret_cast<int*>(th_w + TBH * kh);
  float* tw_w = th_w + TBH * kh + TBW * kw;
  for (int i = threadIdx.x; i < TBH * kh; i += NT) {
    const int a = a0 + i / kh;
    const size_t e = static_cast<size_t>(a) * kh + i % kh;
    th_i[i] = a < gh ? static_cast<int>(ah.up_t.idx[e]) : 0;
    th_w[i] = a < gh ? ah.up_t.w[e] : 0.f;
  }
  for (int i = threadIdx.x; i < TBW * kw; i += NT) {
    const int a = b0 + i / kw;
    const size_t e = static_cast<size_t>(a) * kw + i % kw;
    tw_i[i] = a < gw ? static_cast<int>(aw.up_t.idx[e]) : 0;
    tw_w[i] = a < gw ? aw.up_t.w[e] : 0.f;
  }
  // The pixels whose taps reach the bins; their taps lie in the window.
  int R0, R1, C0, C1;
  reach(ah.up_t, a0, a1, R0, R1);
  reach(aw.up_t, b0, b1, C0, C1);
  const int wa0 = max(a0 - 1, 0), wb0 = max(b0 - 1, 0);
  const int wh = min(a1 + 1, gh) - wa0, ww = min(b1 + 1, gw) - wb0;
  const float w = wt * gscale[0];
  const size_t plane = static_cast<size_t>(gh) * gw;
  const float* gimg = grids + static_cast<size_t>(b) * nb * 6 * plane;
  const float* gtgt = grids + static_cast<size_t>(b + batch) * nb * 6 * plane;
  const int planes = nb * 3;
  for (int p0 = 0; p0 < planes; p0 += 2) {
    const int pl = p0 + half;
    __syncthreads();  // the last pair's reads of gs are done
    for (int i = threadIdx.x; i < 8 * wh * ww; i += NT) {
      const int g = i / (wh * ww), j = i - g * (wh * ww);
      const int y = j / ww, x = j - y * ww, pp = p0 + g / 4, k = g % 4;
      if (pp >= planes) continue;
      const float* src = (k < 2 ? gimg : gtgt) +
                         ((pp / 3 * 2 + (k & 1)) * 3 + pp % 3) * plane;
      gs[g / 4][k][y * WW + x] =
          src[static_cast<size_t>(wa0 + y) * gw + wb0 + x];
    }
    float acc1 = 0.f, acc2 = 0.f;
    for (int cr = R0; cr < R1; cr += CH) {
      const int nr = min(CH, R1 - cr);
      for (int cc = C0; cc < C1; cc += CW) {
        const int nc = min(CW, C1 - cc);
        __syncthreads();  // gs loaded; the last chunk's reads of cs done
        for (int i = threadIdx.x; i < nr * nc; i += NT) {
          const int y = i / nc, x = i - y * nc;
          const Bilin bl = bilin(ah.up, cr + y, aw.up, cc + x, wa0, wb0, WW);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            if (p0 + h2 >= planes) break;
            const Stats st =
                stats_at(gs[h2][0], gs[h2][1], gs[h2][2], gs[h2][3], bl);
            const float gm = dgap<MSE>(st.ma, st.mb, w);
            const float gsd = dgap<MSE>(st.sa, st.sb, w);
            const float dv = st.va >= EPS ? gsd / (2.f * st.sa) : 0.f;
            cs[h2][0][y * CW + x] = gm - 2.f * st.ma * dv;
            cs[h2][1][y * CW + x] = dv;
          }
        }
        __syncthreads();
        if (mine && pl < planes) {
          for (int i = 0; i < kh; ++i) {
            const int r = th_i[ty * kh + i] - cr;
            const float wr = th_w[ty * kh + i];
            if (wr == 0.f || r < 0 || r >= nr) continue;
            float t1 = 0.f, t2 = 0.f;
            for (int j = 0; j < kw; ++j) {
              const int s = tw_i[tx * kw + j] - cc;
              const float ws = tw_w[tx * kw + j];
              if (ws == 0.f || s < 0 || s >= nc) continue;
              t1 += ws * cs[half][0][r * CW + s];
              t2 += ws * cs[half][1][r * CW + s];
            }
            acc1 += wr * t1;
            acc2 += wr * t2;
          }
        }
      }
    }
    if (mine && pl < planes) {
      const int o = pl / 3, c = pl - o * 3;
      float* g = q + ((static_cast<size_t>(b) * nb + o) * 6 + c) * plane +
                 static_cast<size_t>(ta) * gw + tb;
      const float dh = ah.d[ta], dw = aw.d[tb];
      g[0] = acc1 / dw / dh;
      g[3 * plane] = acc2 / dw / dh;
    }
  }
}

// ---------------------------------------------------------------- 12b

// The padded positions that reflect to pixel u of an n-pixel axis: u
// itself; -u for u in 1-2; 2n - 2 - u for u in n-3 .. n-2. Returns how many.
__device__ __forceinline__ int sources(int u, int n, int xs[3]) {
  int k = 0;
  xs[k++] = u;
  if (u >= 1 && u <= 2) xs[k++] = -u;
  if (u >= n - 3 && u <= n - 2) xs[k++] = 2 * n - 2 - u;
  return k;
}

// The transpose of nf 5x5 reflection-padded correlations (filters k, nf x
// 25) at output pixel (u, v) of an (h, w) plane: d holds their
// cotangents, nf planes dstride apart, on rows [u0 - 2, u0 + TH + 2) and
// columns [v0 - 2, v0 + TW + 2), stride PW. Each padded position that
// reflects to the pixel adds the taps that read it, in a fixed order.
template <int NFILT>
__device__ float fold5(const float* d, int dstride, const float* k, int u,
                       int v, int u0, int v0, int h, int w) {
  if (u >= 3 && u <= h - 4 && v >= 3 && v <= w - 4) {
    // No reflection reaches the pixel: all 25 taps of each filter.
    const float* p = d + (u + 4 - u0) * PW + (v + 4 - v0);
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int j = 0; j < KS; ++j) {
#pragma unroll
        for (int f = 0; f < NFILT; ++f) {
          a += k[f * KK + i * KS + j] * p[f * dstride - i * PW - j];
        }
      }
    }
    return a;
  }
  int xs[3], ys[3];
  const int nx = sources(u, h, xs), ny = sources(v, w, ys);
  float a = 0.f;
  for (int m = 0; m < nx; ++m) {
    const int x = xs[m];
    const int ilo = max(0, x + 2 - (h - 1)), ihi = min(KS - 1, x + 2);
    for (int n = 0; n < ny; ++n) {
      const int y = ys[n];
      const int jlo = max(0, y + 2 - (w - 1)), jhi = min(KS - 1, y + 2);
      for (int i = ilo; i <= ihi; ++i) {
        const float* row = d + (x + 2 - i - (u0 - 2)) * PW + (y + 2 - (v0 - 2));
        for (int j = jlo; j <= jhi; ++j) {
#pragma unroll
          for (int f = 0; f < NFILT; ++f) {
            a += k[f * KK + i * KS + j] * row[f * dstride - j];
          }
        }
      }
    }
  }
  return a;
}

// The bins that hold pixel (r, s) (transposed area tables th, tw) and
// A^T dS1 + 2 B A^T dS2 of the nf bands there: q1 points at band 0's dS1
// plane of the pixel's channel, the bands qstride apart, dS2 off2 further;
// columns then rows, as the twin's resampling backward sums.
template <int NFILT>
__device__ __forceinline__ void dbands(const float* __restrict__ q1,
                                       size_t qstride, size_t off2, int gw,
                                       const Taps& th, int r, const Taps& tw,
                                       int s, const float band[NFILT],
                                       float out[NFILT]) {
  const long long* ih = th.idx + static_cast<size_t>(r) * th.k;
  const float* wh = th.w + static_cast<size_t>(r) * th.k;
  const long long* iw = tw.idx + static_cast<size_t>(s) * tw.k;
  const float* ww = tw.w + static_cast<size_t>(s) * tw.k;
  float t1[NFILT], t2[NFILT];
#pragma unroll
  for (int f = 0; f < NFILT; ++f) t1[f] = t2[f] = 0.f;
  for (int i = 0; i < th.k; ++i) {
    if (wh[i] == 0.f) continue;  // padding
    float u1[NFILT], u2[NFILT];
#pragma unroll
    for (int f = 0; f < NFILT; ++f) u1[f] = u2[f] = 0.f;
    for (int j = 0; j < tw.k; ++j) {
      if (ww[j] == 0.f) continue;
      const size_t e = ih[i] * gw + iw[j];
#pragma unroll
      for (int f = 0; f < NFILT; ++f) {
        u1[f] += ww[j] * q1[f * qstride + e];
        u2[f] += ww[j] * q1[f * qstride + off2 + e];
      }
    }
#pragma unroll
    for (int f = 0; f < NFILT; ++f) {
      t1[f] += wh[i] * u1[f];
      t2[f] += wh[i] * u2[f];
    }
  }
#pragma unroll
  for (int f = 0; f < NFILT; ++f) {
    out[f] = t1[f] + (t2[f] * band[f] + t2[f] * band[f]);
  }
}

template <bool MSE>
__global__ void __launch_bounds__(NT)
hvs_level_bwd_kernel(const float* __restrict__ low, int batch,
                     const float* __restrict__ q, int nb, Axis ah, Axis aw,
                     const float* __restrict__ f_b,
                     const float* __restrict__ dnext, float wt4,
                     const float* __restrict__ gscale,
                     float* __restrict__ dlow) {
  __shared__ float fs[NO * KK];
  __shared__ float ls[LH * LW];
  __shared__ float ds[NO * PH * PW];  // the six bands' cotangents
  const int H = ah.n, W = aw.n, gw = aw.g, b = blockIdx.z;
  const int u0 = blockIdx.y * TH, v0 = blockIdx.x * TW;
  const size_t plane = static_cast<size_t>(ah.g) * gw;
  for (int i = threadIdx.x; i < NO * KK; i += NT) fs[i] = f_b[i];
  const float g4 = dnext == nullptr ? wt4 * gscale[0] : 0.f;
  for (int c = 0; c < 3; ++c) {
    const float* lc = low + (static_cast<size_t>(b) * 3 + c) * H * W;
    const float* qc =
        q + ((static_cast<size_t>(b) * nb + (nb - NO)) * 6 + c) * plane;
    __syncthreads();  // the last channel's reads of ls and ds are done
    for (int i = threadIdx.x; i < LH * LW; i += NT) {
      const int y = i / LW, x = i - y * LW;
      ls[i] = lc[static_cast<size_t>(reflect(u0 - 4 + y, H)) * W +
                 reflect(v0 - 4 + x, W)];
    }
    __syncthreads();
    // Two passes over the positions, each thread its own: the bands,
    // then their cotangents in place (fewer values live at once).
    for (int i = threadIdx.x; i < PH * PW; i += NT) {
      const int y = i / PW, x = i - y * PW;
      float band[NO];
      bands6(ls, LW, y, x, fs, band);
#pragma unroll
      for (int o = 0; o < NO; ++o) ds[o * PH * PW + i] = band[o];
    }
    for (int i = threadIdx.x; i < PH * PW; i += NT) {
      const int y = i / PW, x = i - y * PW, r = u0 - 2 + y, s = v0 - 2 + x;
      float band[NO], d[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        band[o] = ds[o * PH * PW + i];
        d[o] = 0.f;
      }
      if (r >= 0 && r < H && s >= 0 && s < W) {
        dbands<NO>(qc, 6 * plane, 3 * plane, gw, ah.area_t, r, aw.area_t, s,
                   band, d);
      }
#pragma unroll
      for (int o = 0; o < NO; ++o) ds[o * PH * PW + i] = d[o];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = k * NT + threadIdx.x, u = u0 + e / TW, v = v0 + e % TW;
      if (u >= H || v >= W) continue;
      float g;
      if (dnext != nullptr) {
        g = dnext[((static_cast<size_t>(b) * 3 + c) * (H / 2) + u / 2) *
                      (W / 2) + v / 2];
      } else {
        const float la = down2(lc, W, u / 2, v / 2);
        const float lb = down2(lc + static_cast<size_t>(batch) * 3 * H * W, W,
                               u / 2, v / 2);
        g = dgap<MSE>(la, lb, g4);
      }
      dlow[((static_cast<size_t>(b) * 3 + c) * H + u) * W + v] =
          fold5<NO>(ds, PH * PW, fs, u, v, u0, v0, H, W) + 0.25f * g;
    }
  }
}

// Level 0's image side: dY = h0^T dH0 + l0^T dL0 (dH0 from band 0 of q,
// the h0 band recomputed from the image), then YCrCb's transpose; dx
// (B, H, W, 3) at the pyramid size.
__global__ void __launch_bounds__(NT)
hvs_input_bwd_kernel(const float* __restrict__ img, Resize rs,
                     const float* __restrict__ dlow,
                     const float* __restrict__ q,
                     int nb, Axis ah, Axis aw, const float* __restrict__ f_h0,
                     const float* __restrict__ f_l0, float* __restrict__ dx) {
  __shared__ float fs[2 * KK];
  __shared__ float ys[3][LH * LW];
  __shared__ float dh[PH * PW];
  __shared__ float dl[PH * PW];
  const int H = ah.n, W = aw.n, gw = aw.g, b = blockIdx.z;
  const int u0 = blockIdx.y * TH, v0 = blockIdx.x * TW;
  const size_t plane = static_cast<size_t>(ah.g) * gw;
  for (int i = threadIdx.x; i < KK; i += NT) {
    fs[i] = f_h0[i];
    fs[KK + i] = f_l0[i];
  }
  const float* x = img + static_cast<size_t>(b) * rs.h_in * rs.w_in * 3;
  for (int i = threadIdx.x; i < LH * LW; i += NT) {
    const int y = i / LW, xx = i - y * LW;
    float v[3];
    ycrcb_at(x, rs, reflect(u0 - 4 + y, H), reflect(v0 - 4 + xx, W), v);
#pragma unroll
    for (int c = 0; c < 3; ++c) ys[c][i] = v[c];
  }
  float acc[3][PER];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* qp = q + ((static_cast<size_t>(b) * nb) * 6 + c) * plane;
    const float* lc = dlow + (static_cast<size_t>(b) * 3 + c) * H * W;
    __syncthreads();  // ys written; the last channel's reads are done
    for (int i = threadIdx.x; i < PH * PW; i += NT) {
      const int y = i / PW, xx = i - y * PW, r = u0 - 2 + y, s = v0 - 2 + xx;
      float d = 0.f, e = 0.f;
      if (r >= 0 && r < H && s >= 0 && s < W) {
        const float band[1] = {conv5(ys[c], LW, y, xx, fs)};
        float out[1];
        dbands<1>(qp, 0, 3 * plane, gw, ah.area_t, r, aw.area_t, s, band,
                  out);
        d = out[0];
        e = lc[static_cast<size_t>(r) * W + s];
      }
      dh[i] = d;
      dl[i] = e;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = k * NT + threadIdx.x, u = u0 + e / TW, v = v0 + e % TW;
      acc[c][k] = 0.f;
      if (u < H && v < W) {
        acc[c][k] = fold5<1>(dh, 0, fs, u, v, u0, v0, H, W) +
                    fold5<1>(dl, 0, fs + KK, u, v, u0, v0, H, W);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = k * NT + threadIdx.x, u = u0 + e / TW, v = v0 + e % TW;
    if (u >= H || v >= W) continue;
    const float dy = acc[0][k], dcr = acc[1][k], dcb = acc[2][k];
    const float gy = dy - 0.713f * dcr - 0.564f * dcb;
    float* p = dx + ((static_cast<size_t>(b) * H + u) * W + v) * 3;
    p[0] = 0.299f * gy + 0.713f * dcr;
    p[1] = 0.587f * gy;
    p[2] = 0.114f * gy + 0.564f * dcb;
  }
}

// The resize's transpose: the image's gradient (B, h_in, w_in, 3) from dx
// (B, H, W, 3), columns then rows.
__global__ void __launch_bounds__(NT)
hvs_resize_bwd_kernel(const float* __restrict__ dx, Resize rs, int H, int W,
                      int batch, float* __restrict__ dimg) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= batch * rs.h_in * rs.w_in * 3) return;
  const int c = i % 3, p = i / 3, s = p % rs.w_in, br = p / rs.w_in,
            r = br % rs.h_in, b = br / rs.h_in;
  const long long* ih = rs.h_t.idx + static_cast<size_t>(r) * rs.h_t.k;
  const float* wh = rs.h_t.w + static_cast<size_t>(r) * rs.h_t.k;
  const long long* iw = rs.w_t.idx + static_cast<size_t>(s) * rs.w_t.k;
  const float* ww = rs.w_t.w + static_cast<size_t>(s) * rs.w_t.k;
  const float* xb = dx + static_cast<size_t>(b) * H * W * 3;
  float v = 0.f;
  for (int a = 0; a < rs.h_t.k; ++a) {
    float t = 0.f;
    for (int k = 0; k < rs.w_t.k; ++k) {
      t += ww[k] * xb[(ih[a] * W + iw[k]) * 3 + c];
    }
    v += wh[a] * t;
  }
  dimg[i] = v;
}

inline dim3 bin_grid(const Axis& ah, const Axis& aw, int z) {
  return dim3((aw.g + TBW - 1) / TBW, (ah.g + TBH - 1) / TBH, z);
}

inline dim3 tile_grid(int h, int w, int z) {
  return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, z);
}

}  // namespace

// Kernel 11 at one band level for n_img images: level 0 (prev null) reads
// the RGB images, the first n_a from img_a and the rest from img_b, each
// (h_in, w_in, 3); a later level reads the previous level's lowpass prev
// (n_img, 3, 2 h, 2 w). Writes low (n_img, 3, h, w) and grids (n_img, nb,
// 2, 3, gh, gw), nb 7 at level 0 (h0 first) and 6 after.
FS_EXPORT int fs_hvs_level_fwd(const float* img_a, const float* img_b,
                               int n_a, const Resize* rs, const float* prev,
                               const Axis* ah, const Axis* aw,
                               const float* f_h0, const float* f_l0,
                               const float* f_b, int n_img, float* low,
                               float* grids, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = bin_grid(*ah, *aw, n_img);
  const bool l0 = prev == nullptr;
  const size_t smem =
      sizeof(float) * (NF + (l0 ? NO + 1 : NO) * CHW + (CH + 4) * (CW + 4) +
                       (l0 ? 3 * (CH + 8) * (CW + 8) : 0));
  cudaError_t err;
  if (l0) {
    err = cudaFuncSetAttribute(hvs_level_fwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    hvs_level_fwd_kernel<true><<<grid, NT, smem, st>>>(
        img_a, img_b, n_a, *rs, prev, *ah, *aw, f_h0, f_l0, f_b, low, grids);
  } else {
    err = cudaFuncSetAttribute(hvs_level_fwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    hvs_level_fwd_kernel<false><<<grid, NT, smem, st>>>(
        img_a, img_b, n_a, *rs, prev, *ah, *aw, f_h0, f_l0, f_b, low, grids);
  }
  return cudaGetLastError();
}

// Kernel 11b: the loss of the levels' grids (n_blocks blocks in all, the
// level's first in block0) and the last lowpass term from low (2B, 3, h,
// w), the last band level's lowpass; partial holds n_blocks floats.
FS_EXPORT int fs_hvs_stats_loss(const StatLevels* levels, int n_blocks,
                                const float* low, int h, int w, float wt4,
                                int mse, float* partial, float* loss,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mse) {
    hvs_stats_loss_kernel<true><<<n_blocks, NT, 0, st>>>(*levels, partial);
    hvs_loss_final_kernel<true><<<1, NT, 0, st>>>(
        partial, n_blocks, low, levels->batch, h, w, wt4, loss);
  } else {
    hvs_stats_loss_kernel<false><<<n_blocks, NT, 0, st>>>(*levels, partial);
    hvs_loss_final_kernel<false><<<1, NT, 0, st>>>(
        partial, n_blocks, low, levels->batch, h, w, wt4, loss);
  }
  return cudaGetLastError();
}

// Kernel 12 at one band level: q (B, nb, 2, 3, gh, gw) the cotangents of
// the images' grids, each divided by its bin's area; wt the level's weight,
// gscale the loss's cotangent (one float on the card).
FS_EXPORT int fs_hvs_stats_bwd(const float* grids, int batch, int nb,
                               const Axis* ah, const Axis* aw, float wt,
                               const float* gscale, int mse, float* q,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = bin_grid(*ah, *aw, batch);
  const size_t smem = sizeof(float) * 2 * (TBH * ah->up_t.k + TBW * aw->up_t.k);
  auto kernel = mse ? hvs_stats_bwd_kernel<true> : hvs_stats_bwd_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(grids, batch, nb, *ah, *aw, wt, gscale, q);
  return cudaGetLastError();
}

// Kernel 12b at one band level: dlow (B, 3, h, w) from the level's
// lowpass low (2B, 3, h, w), its cotangents q (B, nb, ...) and dnext (B,
// 3, h / 2, w / 2), the next level's lowpass gradient, or null at the last
// band level (then the last lowpass's term, weight wt4).
FS_EXPORT int fs_hvs_level_bwd(const float* low, int batch, const float* q,
                               int nb, const Axis* ah, const Axis* aw,
                               const float* f_b, const float* dnext, float wt4,
                               const float* gscale, int mse, float* dlow,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = tile_grid(ah->n, aw->n, batch);
  if (mse) {
    hvs_level_bwd_kernel<true><<<grid, NT, 0, st>>>(
        low, batch, q, nb, *ah, *aw, f_b, dnext, wt4, gscale, dlow);
  } else {
    hvs_level_bwd_kernel<false><<<grid, NT, 0, st>>>(
        low, batch, q, nb, *ah, *aw, f_b, dnext, wt4, gscale, dlow);
  }
  return cudaGetLastError();
}

// Kernel 12b's image side: dx (B, H, W, 3) at the pyramid size from level
// 0's lowpass gradient dlow and cotangents q; then, where the image was
// resized (rs->h.idx not null), its gradient dimg (B, h_in, w_in, 3).
FS_EXPORT int fs_hvs_input_bwd(const float* img, const Resize* rs,
                               const float* dlow, const float* q, int nb,
                               const Axis* ah, const Axis* aw,
                               const float* f_h0, const float* f_l0, int batch,
                               float* dx, float* dimg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  hvs_input_bwd_kernel<<<tile_grid(ah->n, aw->n, batch), NT, 0, st>>>(
      img, *rs, dlow, q, nb, *ah, *aw, f_h0, f_l0, dx);
  if (rs->h.idx != nullptr) {
    const int n = batch * rs->h_in * rs->w_in * 3;
    hvs_resize_bwd_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(
        dx, *rs, ah->n, aw->n, batch, dimg);
  }
  return cudaGetLastError();
}
