// Kernel 2 of the foveated frame: pair expansion, OBB and level cull,
// per-level attribute selection and deterministic compaction.
//
// Replaces fovsplat/ops/pallas/expand_fov.py:841 expand_fov_pallas. One
// thread per Gaussian walks its (clipped) tile rect in row-major order,
// as the reference's duplicateWithKeys does: for every candidate tile it
// runs the OBB separating-axis test (fovsplat/ops/binning.py:51-79) and
// the level cull level[tile] < hl + 1, reading the level from the
// per-tile table (compute_tile_levels) instead of the TPU's per-pair
// series. Compaction is deterministic: pass 1 counts each Gaussian's kept
// pairs, common.cuh's scan turns the counts into offsets, pass 2 writes
// the kept pairs at their offsets. The output order is the JAX kernel's
// pre-sort order: Gaussian order, then tile row-major.
//
// Kept pairs at or past `cap_out` and candidates at or past `pair_cap`
// are dropped; the wrapper counts both into `overflow`.
//
// Bound: bytes (a few dozen FLOP per candidate). Pass 1 reads 12 table
// rows per Gaussian and the 16 KB level table (L1-resident); pass 2
// re-reads them plus the 4L level rows and writes 64 B per kept pair.
// The walk is per Gaussian, so a Gaussian with a large rect keeps one
// thread busy (the reference's imbalance too); the writes of one warp go
// to nearby offsets because offsets grow with the Gaussian index.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
// Table rows (ops/kernels/build_table.py ROW_*).
enum Row {
  R_RX0 = 0, R_RY0, R_RW, R_TNUM, R_MX, R_MY, R_V1X, R_V1Y, R_V2X, R_V2Y,
  R_LEN1, R_LEN2, R_CA, R_CB, R_CC, R_HL, R_DEPTH, R_VALID, R_LEVEL
};
// Output attribute rows (ops/kernels/expand_fov.py ATTR_ROWS).
enum Attr {
  A_MX = 0, A_MY, A_CA, A_CB, A_CC, A_OP1, A_OP2, A_R1, A_G1, A_B1, A_R2,
  A_G2, A_B2
};

struct Gauss {
  int rx0, ry0, rw, tnum, cum;
  float mx, my, v1x, v1y, v2x, v2y, len1, len2, hl;
};

__device__ inline Gauss load_gauss(const float* __restrict__ table,
                                   const int* __restrict__ cum, int n,
                                   int g) {
  auto row = [&](int r) { return table[static_cast<size_t>(r) * n + g]; };
  Gauss q;
  q.rx0 = static_cast<int>(row(R_RX0));
  q.ry0 = static_cast<int>(row(R_RY0));
  q.rw = static_cast<int>(row(R_RW));
  q.tnum = static_cast<int>(row(R_TNUM));
  q.cum = cum[g];
  q.mx = row(R_MX);
  q.my = row(R_MY);
  q.v1x = row(R_V1X);
  q.v1y = row(R_V1Y);
  q.v2x = row(R_V2X);
  q.v2y = row(R_V2Y);
  q.len1 = row(R_LEN1);
  q.len2 = row(R_LEN2);
  q.hl = row(R_HL);
  return q;
}

// OBB / tile separating-axis test (binning.obb_pass), skipped for
// single-tile rects (len1 == 0), then the level cull.
__device__ inline bool keep_pair(const Gauss& q, int tx, int ty,
                                 const float* __restrict__ levels,
                                 int grid_x, int use_obb, float* lv_out) {
  if (use_obb && q.len1 > 0.0f) {
    const float half = TILE / 2.0f;
    const float tpx = static_cast<float>(tx) * TILE + half;
    const float tpy = static_cast<float>(ty) * TILE + half;
    const float d1x = q.len1 * q.v1x, d1y = q.len1 * q.v1y;
    const float d2x = q.len2 * q.v2x, d2y = q.len2 * q.v2y;
    const float cx = q.mx - tpx;
    const float cy = q.my - tpy;
    const float ext_x = fabsf(d1x) + fabsf(d2x);
    const float ext_y = fabsf(d1y) + fabsf(d2y);
    const float base1 = -(cx * q.v1x + cy * q.v1y);
    const float base2 = -(cx * q.v2x + cy * q.v2y);
    const float e1 = half * (fabsf(q.v1x) + fabsf(q.v1y));
    const float e2 = half * (fabsf(q.v2x) + fabsf(q.v2y));
    const bool ok = fabsf(cx) <= half + ext_x && fabsf(cy) <= half + ext_y &&
                    fabsf(base1) <= q.len1 + e1 && fabsf(base2) <= q.len2 + e2;
    if (!ok) return false;
  }
  const float lv = levels[ty * grid_x + tx];
  *lv_out = lv;
  return lv < q.hl + 1.0f;
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
count_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             const float* __restrict__ levels, int n, int grid_x,
             int pair_cap, int use_obb, int* __restrict__ counts) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const Gauss q = load_gauss(table, cum, n, g);
  const int m = min(q.tnum, pair_cap - q.cum);   // candidates past the cap
  int kept = 0;
  float lv;
  for (int j = 0; j < m; ++j) {
    const int ty = q.ry0 + j / q.rw, tx = q.rx0 + j % q.rw;
    kept += keep_pair(q, tx, ty, levels, grid_x, use_obb, &lv);
  }
  counts[g] = kept;
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
write_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             const float* __restrict__ levels, const int* __restrict__ offsets,
             int n, int L, int grid_x, int pair_cap, int cap_out, int use_obb,
             int* __restrict__ tile_out, float* __restrict__ depth_out,
             int* __restrict__ gid_out, float* __restrict__ attrs) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const Gauss q = load_gauss(table, cum, n, g);
  const int m = min(q.tnum, pair_cap - q.cum);
  if (m <= 0) return;
  auto row = [&](int r) { return table[static_cast<size_t>(r) * n + g]; };
  const float depth = row(R_DEPTH);
  const float ca = row(R_CA), cb = row(R_CB), cc = row(R_CC);
  int o = offsets[g];
  float lv = 0.0f;
  for (int j = 0; j < m && o < cap_out; ++j) {
    const int ty = q.ry0 + j / q.rw, tx = q.rx0 + j % q.rw;
    if (!keep_pair(q, tx, ty, levels, grid_x, use_obb, &lv)) continue;
    const int p1 = static_cast<int>(lv);
    const int p2 = min(p1 + 1, L - 1);
    auto put = [&](int a, float v) {
      attrs[static_cast<size_t>(a) * cap_out + o] = v;
    };
    tile_out[o] = ty * grid_x + tx;
    depth_out[o] = depth;
    gid_out[o] = g;
    put(A_MX, q.mx);
    put(A_MY, q.my);
    put(A_CA, ca);
    put(A_CB, cb);
    put(A_CC, cc);
    put(A_OP1, row(R_LEVEL + p1));
    // The L2 cull folds into the sign of op2: the blend's alpha >= 1/255
    // test then rejects the pair in the second chain.
    put(A_OP2, (q.hl + 1.0f) < (lv + 1.0f) ? -1.0f : row(R_LEVEL + p2));
    put(A_R1, row(R_LEVEL + L + p1));
    put(A_G1, row(R_LEVEL + 2 * L + p1));
    put(A_B1, row(R_LEVEL + 3 * L + p1));
    put(A_R2, row(R_LEVEL + L + p2));
    put(A_G2, row(R_LEVEL + 2 * L + p2));
    put(A_B2, row(R_LEVEL + 3 * L + p2));
    ++o;
  }
}

}  // namespace

FS_EXPORT int fs_expand_fov(const float* table, const int* cum,
                            const float* levels, int n, int L, int grid_x,
                            int pair_cap, int cap_out, int use_obb,
                            int* counts, int* offsets, int* block_sums,
                            int* kept, int* tile_out, float* depth_out,
                            int* gid_out, float* attrs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(n);
  count_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(table, cum, levels, n, grid_x,
                                             pair_cap, use_obb, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_local_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(counts, offsets,
                                                      block_sums, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_carry_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(offsets, block_sums, nb,
                                                      n, kept);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  write_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(
      table, cum, levels, offsets, n, L, grid_x, pair_cap, cap_out, use_obb,
      tile_out, depth_out, gid_out, attrs);
  return cudaGetLastError();
}
