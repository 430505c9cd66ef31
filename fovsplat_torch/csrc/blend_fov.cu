// Kernel 3 of the foveated frame: the dual-transmittance tile blend.
//
// Replaces fovsplat/ops/pallas/blend_fov.py:408 blend_fov_pallas. One
// 256-thread block per 16x16 tile, one thread per pixel, as the
// reference's renderCUDA_blending: the tile's segment of the sorted pair
// list is staged through shared memory 256 pairs at a time, and each
// thread walks the pairs front to back with two chains (T1, C1) and
// (T2, C2). l1_active / l2_active mask each chain per pixel; a tile whose
// l2_active is all zero runs one chain. Rules (the per-pixel semantics of
// fovsplat/ops/foveated.py:315 _dual_blend):
//   alpha = min(0.99, op * exp(power)); skip when alpha < 1/255, power > 0
//   or power < power_cutoff; a chain freezes BEFORE blending the pair that
//   would take T below 1e-4; the block stops once every pixel is frozen
//   or inactive in both chains.
// An L2-culled pair carries op2 = -1 (expand_fov.cu), which the alpha
// test rejects. expf, not __expf, and no fast math.
//
// Bound: operations in the pair-pixel loop (~30 FLOP and one expf per
// pair and pixel); the pair list itself is read once per tile. Staging
// through shared memory makes each pair one coalesced read per block
// instead of 256.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
// Pair attribute rows (ops/kernels/expand_fov.py ATTR_ROWS).
constexpr int NUM_ATTRS = 13;
enum Attr {
  A_MX = 0, A_MY, A_CA, A_CB, A_CC, A_OP1, A_OP2, A_R1, A_G1, A_B1, A_R2,
  A_G2, A_B2
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

__global__ void __launch_bounds__(PIX)
blend_fov_kernel(const float* __restrict__ attrs, int cap,
                 const int* __restrict__ seg_start,
                 const bool* __restrict__ l1_active,
                 const bool* __restrict__ l2_active, int grid_x,
                 float power_cutoff, float* __restrict__ out) {
  __shared__ float sm[NUM_ATTRS][PIX];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % grid_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / grid_x) * TILE + p / TILE);
  const bool act1 = l1_active[t * PIX + p];
  const bool act2 = l2_active[t * PIX + p];
  const bool dual = __syncthreads_or(act2);
  Chain c1, c2;
  c1.done = !act1;
  c2.done = !(dual && act2);
  const int start = seg_start[t], end = seg_start[t + 1];

  for (int base = start; base < end; base += PIX) {
    if (__syncthreads_count(!(c1.done && c2.done)) == 0) break;
    const int i = base + p;
    if (i < end) {
#pragma unroll
      for (int a = 0; a < NUM_ATTRS; ++a)
        sm[a][p] = attrs[static_cast<size_t>(a) * cap + i];
    }
    __syncthreads();
    const int m = min(PIX, end - base);
    for (int j = 0; j < m && !(c1.done && c2.done); ++j) {
      const float dx = sm[A_MX][j] - px;
      const float dy = sm[A_MY][j] - py;
      const float power = -0.5f * (sm[A_CA][j] * dx * dx +
                                   sm[A_CC][j] * dy * dy) -
                          sm[A_CB][j] * dx * dy;
      if (!(power <= 0.0f && power >= power_cutoff)) continue;  // NaN too
      const float G = expf(power);
      if (!c1.done)
        c1.step(sm[A_OP1][j], G, sm[A_R1][j], sm[A_G1][j], sm[A_B1][j]);
      if (!c2.done)
        c2.step(sm[A_OP2][j], G, sm[A_R2][j], sm[A_G2][j], sm[A_B2][j]);
    }
    __syncthreads();
  }

  // out (T, 8, PIX): C1 rgb, T1, C2 rgb, T2. An inactive chain leaves
  // C = 0, T = 1, as the plain version does.
  float* o = out + static_cast<size_t>(t) * 8 * PIX + p;
  o[0 * PIX] = c1.r;
  o[1 * PIX] = c1.g;
  o[2 * PIX] = c1.b;
  o[3 * PIX] = c1.T;
  o[4 * PIX] = c2.r;
  o[5 * PIX] = c2.g;
  o[6 * PIX] = c2.b;
  o[7 * PIX] = c2.T;
}

}  // namespace

FS_EXPORT int fs_blend_fov(const float* attrs, int cap, const int* seg_start,
                           const bool* l1_active, const bool* l2_active,
                           int num_tiles, int grid_x, float power_cutoff,
                           float* out, void* stream) {
  blend_fov_kernel<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      attrs, cap, seg_start, l1_active, l2_active, grid_x, power_cutoff, out);
  return cudaGetLastError();
}
