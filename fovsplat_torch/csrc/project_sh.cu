// Kernel 10: the train route's per-Gaussian projection and SH colour,
// forward and backward (ops/kernels/project_sh.py).
//
// Replaces no Pallas kernel: the JAX package computes this stage with jnp
// and jax.grad (fovsplat/ops/projection.py preprocess_cols, sh.py
// sh_to_rgb). In the port it was ~250 autograd column operations forward
// and their backward, among them the gradient of 16 strided selects of a
// (3, 16, N) view of the SH, each a fill and an add over all 16 N x 3
// coefficients (~14 GB a step at N = 1.16M). Here one thread handles one
// Gaussian, forward and backward, with the arithmetic of project_sh.cuh.
//
// Forward: reads the means, activated scales, unit rotations, opacities,
// the live mask, the optional pixel offset and the SH rows, (N, K, 3) or
// as the model stores them, (N, 1, 3) DC and (N, K - 1, 3) rest, which
// spares the step their concatenation (or the given (N, 3) colours), and
// writes the nine differentiable train
// columns (mx, my, ca, cb, cc, op, r, g, b), the ten constant ones (rx0,
// ry0, rw, tnum, v1x, v1y, v2x, v2y, len1, len2), valid, depth and the
// radius, each an (N,) row.
//
// Backward: reads the nine cotangent rows and the same inputs, recomputes
// the forward's intermediates in registers and writes the gradients of
// the means, scales and rotations and, from the SH, the SH gradient in
// the SH's one or two arrays. No atomics: each output element has one
// writer.
//
// Bound: bytes. Forward ~250 B a Gaussian at K = 16 (192 B of SH), 88 B
// out; backward ~290 B in, ~232 B out; ~600-1,000 FLOP a Gaussian, far
// below the card's ratio. The SH rows are 192 B apart, so a block stages
// its rows through shared memory with coalesced loads (and the backward
// writes its SH gradient back the same way); the row stride there is
// 3K + 1 words, odd, so a warp's reads of one coefficient hit 32 banks.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "project_sh.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int MAX_K = 16;   // ops/kernels/project_sh.MAX_K

// Rows [row0, row0 + rows) of an (n, k3) f32 array to or from shared
// memory (into_smem or not), where row r's words sit at smem[r * stride +
// col0 ...]. Consecutive threads move consecutive 16-byte words when the
// block's words are whole 16-byte words (always at K = 16, and for the
// model's (N, 1, 3) and (N, 15, 3) SH from fresh allocations), else
// consecutive words; each thread's loads are issued before its first
// store. A word's row and column advance by fixed steps, with no division
// inside the loop.
template <bool into_smem>
__device__ inline void move_rows(const float* gsrc, float* gdst, float* smem,
                                 int row0, int rows, int k3, int stride,
                                 int col0) {
  const size_t off = static_cast<size_t>(row0) * k3;
  const int total = rows * k3;
  const float* g = into_smem ? gsrc + off : gdst + off;
  const bool vec = (total & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int w = vec ? 4 : 1;           // words a thread moves at a time
  const int step = w * BLOCK;          // words a pass over the block
  const int dr = step / k3, dc = step - dr * k3;
  int e = w * threadIdx.x;
  int r = e / k3, c = e - r * k3;
  if (vec) {
    // 12 passes move the most a block holds (BLOCK x 48 words).
    constexpr int PASSES = 3 * MAX_K / 4;
    float4 v[PASSES];
    int rs[PASSES], cs[PASSES];
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      rs[j] = r;
      cs[j] = c;
      if (into_smem && e < total) {
        v[j] = __ldg(reinterpret_cast<const float4*>(gsrc + off + e));
      }
      e += step;
      r += dr;
      c += dc;
      if (c >= k3) {
        c -= k3;
        ++r;
      }
    }
    e = w * threadIdx.x;
#pragma unroll
    for (int j = 0; j < PASSES; ++j, e += step) {
      if (e >= total) break;
      // The word's four floats may run into the next rows (k3 >= 3).
      float* s[4];
      int rr = rs[j], cc = cs[j];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s[t] = smem + rr * stride + col0 + cc;
        if (++cc == k3) {
          cc = 0;
          ++rr;
        }
      }
      if (into_smem) {
        *s[0] = v[j].x;
        *s[1] = v[j].y;
        *s[2] = v[j].z;
        *s[3] = v[j].w;
      } else {
        *reinterpret_cast<float4*>(gdst + off + e) =
            make_float4(*s[0], *s[1], *s[2], *s[3]);
      }
    }
    return;
  }
  for (; e < total; e += step) {
    float* sp = smem + r * stride + col0 + c;
    if (into_smem) {
      *sp = __ldg(gsrc + off + e);
    } else {
      gdst[off + e] = *sp;
    }
    r += dr;
    c += dc;
    if (c >= k3) {
      c -= k3;
      ++r;
    }
  }
}

// A block's SH rows, coefficients [0, k_a) from sh_a (n, k_a, 3) and
// [k_a, k_a + k_b) from sh_b (n, k_b, 3) when given, into shared memory
// as one row of 3 (k_a + k_b) words each, row stride 3 (k_a + k_b) + 1:
// odd, so a warp's reads of one coefficient hit 32 banks.
__device__ inline void stage_sh(const float* sh_a, int k_a, const float* sh_b,
                                int k_b, float* smem, int row0, int rows) {
  const int stride = 3 * (k_a + k_b) + 1;
  move_rows<true>(sh_a, nullptr, smem, row0, rows, 3 * k_a, stride, 0);
  if (sh_b != nullptr) {
    move_rows<true>(sh_b, nullptr, smem, row0, rows, 3 * k_b, stride,
                    3 * k_a);
  }
}

__device__ inline void load3(const float* __restrict__ p, int i, float v[3]) {
  for (int j = 0; j < 3; ++j) v[j] = __ldg(p + 3 * i + j);
}

__global__ void __launch_bounds__(BLOCK)
project_sh_fwd_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ scales,
                      const float* __restrict__ rot,
                      const float* __restrict__ opac,
                      const bool* __restrict__ live,
                      const float* __restrict__ offset,
                      const float* __restrict__ sh_a,
                      const float* __restrict__ sh_b,
                      const float* __restrict__ colors,
                      const float* __restrict__ cam, int n, int k_a,
                      int k_b, int sh_degree, int grid_x, int grid_y,
                      int width,
                      int height, float scale_modifier,
                      float* __restrict__ diff, float* __restrict__ aux,
                      bool* __restrict__ valid_out,
                      float* __restrict__ depth_out,
                      float* __restrict__ radius_out) {
  extern __shared__ float sh_s[];
  const int row0 = blockIdx.x * BLOCK;
  const int i = row0 + threadIdx.x;
  const int k3 = 3 * (k_a + k_b);
  if (sh_a != nullptr) {
    stage_sh(sh_a, k_a, sh_b, k_b, sh_s, row0, min(BLOCK, n - row0));
    __syncthreads();
  }
  if (i >= n) return;

  float m[3], s[3], q[4];
  load3(xyz, i, m);
  load3(scales, i, s);
  for (int j = 0; j < 4; ++j) q[j] = __ldg(rot + 4 * i + j);
  const psh::Ewa e = psh::ewa(cam, m, s, q, scale_modifier);
  const bool alive = live == nullptr || live[i];
  const psh::Cols o = psh::columns(e, alive, grid_x, grid_y, width, height);

  float col[3];
  if (sh_a != nullptr) {
    const float* row = sh_s + threadIdx.x * (k3 + 1);
    float bas[16];
    psh::sh_basis(sh_degree, psh::view_dir(cam, m), bas);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[c] = psh::clamp_min(psh::sh_raw(sh_degree, bas, row, c), 0.0f);
    }
  } else {
    load3(colors, i, col);
  }
  float mx = o.px, my = o.py;
  if (offset != nullptr) {
    mx = mx + __ldg(offset + 2 * i);
    my = my + __ldg(offset + 2 * i + 1);
  }

  auto put = [&](float* rows, int r, float v) {
    rows[static_cast<size_t>(r) * n + i] = v;
  };
  put(diff, 0, mx);
  put(diff, 1, my);
  put(diff, 2, o.ca);
  put(diff, 3, o.cb);
  put(diff, 4, o.cc);
  put(diff, 5, __ldg(opac + i));
  put(diff, 6, col[0]);
  put(diff, 7, col[1]);
  put(diff, 8, col[2]);
  put(aux, 0, static_cast<float>(o.rx0));
  put(aux, 1, static_cast<float>(o.ry0));
  put(aux, 2, static_cast<float>(o.rw));
  put(aux, 3, static_cast<float>(o.tnum));
  put(aux, 4, o.v1x);
  put(aux, 5, o.v1y);
  put(aux, 6, o.v2x);
  put(aux, 7, o.v2y);
  put(aux, 8, o.len1);
  put(aux, 9, o.len2);
  valid_out[i] = o.valid;
  depth_out[i] = o.depth;
  radius_out[i] = o.radius;
}

__global__ void __launch_bounds__(BLOCK)
project_sh_bwd_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ scales,
                      const float* __restrict__ rot,
                      const float* __restrict__ sh_a,
                      const float* __restrict__ sh_b,
                      const float* __restrict__ cam,
                      const float* __restrict__ grad, int n, int k_a,
                      int k_b, int sh_degree, int width, int height,
                      float scale_modifier, float* __restrict__ d_xyz,
                      float* __restrict__ d_scales,
                      float* __restrict__ d_rot, float* __restrict__ d_a,
                      float* __restrict__ d_b) {
  extern __shared__ float sh_s[];
  const int row0 = blockIdx.x * BLOCK;
  const int rows = min(BLOCK, n - row0);
  const int i = row0 + threadIdx.x;
  const int k3 = 3 * (k_a + k_b);
  if (sh_a != nullptr) {
    stage_sh(sh_a, k_a, sh_b, k_b, sh_s, row0, rows);
    __syncthreads();
  }
  if (i < n) {
    float m[3], s[3], q[4], g[9];
    load3(xyz, i, m);
    load3(scales, i, s);
    for (int j = 0; j < 4; ++j) q[j] = __ldg(rot + 4 * i + j);
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      g[r] = __ldg(grad + static_cast<size_t>(r) * n + i);
    }
    // The SH gradient replaces the coefficients in the thread's own row.
    float* row = sh_a != nullptr ? sh_s + threadIdx.x * (k3 + 1) : nullptr;
    float dm[3], ds[3], dq[4];
    psh::backward(cam, width, height, scale_modifier, m, s, q, row,
                  sh_degree, k_a + k_b, g, dm, ds, dq, row);
    for (int j = 0; j < 3; ++j) {
      d_xyz[3 * i + j] = dm[j];
      d_scales[3 * i + j] = ds[j];
    }
    for (int j = 0; j < 4; ++j) d_rot[4 * i + j] = dq[j];
  }
  if (sh_a != nullptr) {
    __syncthreads();
    move_rows<false>(nullptr, d_a, sh_s, row0, rows, 3 * k_a, k3 + 1, 0);
    if (sh_b != nullptr) {
      move_rows<false>(nullptr, d_b, sh_s, row0, rows, 3 * k_b, k3 + 1,
                       3 * k_a);
    }
  }
}

}  // namespace

// sh_a (n, k_a, 3) holds the first k_a SH coefficients of each row and
// sh_b (n, k_b, 3), or null with k_b = 0, the rest; sh_a null: the
// colours (n, 3) are given.
FS_EXPORT int fs_project_sh_fwd(const float* xyz, const float* scales,
                                const float* rot, const float* opac,
                                const void* live, const float* offset,
                                const float* sh_a, const float* sh_b,
                                const float* colors, const float* cam, int n,
                                int k_a, int k_b, int sh_degree, int grid_x,
                                int grid_y, int width, int height,
                                float scale_modifier, float* diff, float* aux,
                                void* valid, float* depth, float* radius,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (n + BLOCK - 1) / BLOCK;
  const size_t smem =
      sh_a != nullptr ? sizeof(float) * BLOCK * (3 * (k_a + k_b) + 1) : 0;
  project_sh_fwd_kernel<<<nb, BLOCK, smem, st>>>(
      xyz, scales, rot, opac, static_cast<const bool*>(live), offset, sh_a,
      sh_b, colors, cam, n, k_a, k_b, sh_degree, grid_x, grid_y, width,
      height, scale_modifier, diff, aux, static_cast<bool*>(valid), depth,
      radius);
  return cudaGetLastError();
}

// The SH as fs_project_sh_fwd takes it; d_a and d_b take the shapes of
// sh_a and sh_b.
FS_EXPORT int fs_project_sh_bwd(const float* xyz, const float* scales,
                                const float* rot, const float* sh_a,
                                const float* sh_b, const float* cam,
                                const float* grad, int n, int k_a, int k_b,
                                int sh_degree, int width, int height,
                                float scale_modifier, float* d_xyz,
                                float* d_scales, float* d_rot, float* d_a,
                                float* d_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (n + BLOCK - 1) / BLOCK;
  const size_t smem =
      sh_a != nullptr ? sizeof(float) * BLOCK * (3 * (k_a + k_b) + 1) : 0;
  project_sh_bwd_kernel<<<nb, BLOCK, smem, st>>>(
      xyz, scales, rot, sh_a, sh_b, cam, grad, n, k_a, k_b, sh_degree, width,
      height, scale_modifier, d_xyz, d_scales, d_rot, d_a, d_b);
  return cudaGetLastError();
}
