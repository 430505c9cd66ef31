// Kernel 2 of the foveated frame: pair expansion, OBB and level cull,
// per-level attribute selection and deterministic compaction.
//
// Replaces fovsplat/ops/pallas/expand_fov.py:841 expand_fov_pallas. The
// candidates are the (Gaussian, tile) pairs of every Gaussian's (clipped)
// tile rect, numbered by `cum`, the exclusive prefix of the table's tnum
// row: candidate c belongs to the Gaussian g with cum[g] <= c < cum[g] +
// tnum[g] and is tile j = c - cum[g] of its rect in row-major order, as
// the reference's duplicateWithKeys walks it. A candidate is kept when it
// passes the OBB separating-axis test (fovsplat/ops/binning.py:51-79) and
// the level cull level[tile] < hl + 1, the level read from the per-tile
// table (compute_tile_levels) instead of the TPU's per-pair series. The
// output order is the JAX kernel's pre-sort order: Gaussian order, then
// tile row-major.
//
// Bound: bytes (the table in, 64 B per kept pair out; a few dozen FLOP
// per candidate). The design is candidate-parallel, as the TPU kernel's
// fixed candidate chunks with their first Gaussian from `gstarts`
// (expand_fov.py:841-851) are:
//
// - One thread per candidate, CHUNK candidates a block in ROUNDS rounds of
//   BLOCK. A block finds the Gaussians of its first and last candidate by
//   binary searches over `cum`; each thread then searches between them
//   (from its previous round's Gaussian on). A Gaussian with a rect of
//   hundreds of tiles is spread over hundreds of threads instead of
//   keeping one thread busy while its warp waits.
// - Neighbouring candidates mostly share a Gaussian, so its 12 table rows
//   (and in the write pass its depth, conic and colour rows) are the same
//   addresses across a warp: one L1 transaction serves them all.
// - Compaction is deterministic: a count pass writes each block's kept
//   count, one block scans the counts (common.cuh's scan_sums_kernel), and
//   the write pass recomputes each keep flag and places a kept pair at its
//   block's offset plus a block-level exclusive scan of the flags, round
//   by round. Offsets are exact integers, so the output is the same bits
//   as the plain twin's, in candidate order. Consecutive kept pairs have
//   consecutive offsets, so a warp's writes are coalesced row by row.
// - The per-candidate arithmetic (keep_pair and the attribute selection)
//   is unchanged, in the same order of operations, so under -fmad=false
//   the kept pairs are bit-equal to expand_fov_plain's.
//
// Kept pairs at or past `cap_out` and candidates at or past `pair_cap` are
// dropped; the caller counts both into `overflow`. Blocks past the last
// candidate (min(total, pair_cap), read on the device) exit at once.
//
// The table holds L_lay colour levels: chain 1 reads level min(p1, L_lay
// - 1) and chain 2 level min(p1 + 1, L_lay - 1), p1 the tile's integer
// level. L_lay = 1 is the SM-FR shared layout (foveated.py:755-760): one
// colour and opacity per Gaussian, while the cull still runs at every
// level.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = 256;
constexpr int ROUNDS = 4;
constexpr int CHUNK = BLOCK * ROUNDS;    // candidates a block takes
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

// One candidate: its Gaussian (searched from *g_from on), tile and keep
// flag. The owners of a block's candidates lie in [g_from, g_last].
struct Cand {
  Gauss q;
  int g, tx, ty;
  float lv;
  bool keep;
};

__device__ inline Cand candidate(const float* __restrict__ table,
                                 const int* __restrict__ cum,
                                 const float* __restrict__ levels, int n,
                                 int grid_x, int use_obb, int c, int* g_from,
                                 int g_last) {
  Cand k;
  k.g = fs::owner(cum, *g_from, g_last, c);
  *g_from = k.g;
  k.q = load_gauss(table, cum, n, k.g);
  const int j = c - k.q.cum;
  k.ty = k.q.ry0 + j / k.q.rw;
  k.tx = k.q.rx0 + j % k.q.rw;
  k.lv = 0.0f;
  k.keep = keep_pair(k.q, k.tx, k.ty, levels, grid_x, use_obb, &k.lv);
  return k;
}

__global__ void __launch_bounds__(BLOCK)
count_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             const float* __restrict__ levels, int n, int grid_x,
             int pair_cap, int use_obb, int* __restrict__ counts) {
  __shared__ int span[2];
  const int last = fs::block_span<CHUNK>(
      cum, table + static_cast<size_t>(R_TNUM) * n, n, pair_cap, span);
  if (last < 0) {
    if (threadIdx.x == 0) counts[blockIdx.x] = 0;
    return;
  }
  int g_from = span[0];
  const int g_last = span[1];
  int kept = 0;
  for (int r = 0; r < ROUNDS; ++r) {
    const int c = blockIdx.x * CHUNK + r * BLOCK + threadIdx.x;
    bool keep = false;
    if (c <= last)
      keep = candidate(table, cum, levels, n, grid_x, use_obb, c, &g_from,
                       g_last).keep;
    kept += __syncthreads_count(keep);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = kept;
}

__global__ void __launch_bounds__(BLOCK)
write_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             const float* __restrict__ levels,
             const int* __restrict__ block_offsets, int n, int L_lay,
             int grid_x, int pair_cap, int cap_out, int use_obb,
             int* __restrict__ tile_out, float* __restrict__ depth_out,
             int* __restrict__ gid_out, float* __restrict__ attrs) {
  __shared__ int span[2];
  const int last = fs::block_span<CHUNK>(
      cum, table + static_cast<size_t>(R_TNUM) * n, n, pair_cap, span);
  if (last < 0) return;
  int g_from = span[0];
  const int g_last = span[1];
  int o_base = block_offsets[blockIdx.x];
  for (int r = 0; r < ROUNDS && o_base < cap_out; ++r) {
    const int c = blockIdx.x * CHUNK + r * BLOCK + threadIdx.x;
    Cand k;
    k.keep = false;
    if (c <= last)
      k = candidate(table, cum, levels, n, grid_x, use_obb, c, &g_from,
                    g_last);
    int round_kept;
    const int o = o_base + fs::block_exclusive_scan(k.keep ? 1 : 0,
                                                    &round_kept);
    o_base += round_kept;
    if (!k.keep || o >= cap_out) continue;
    const int g = k.g;
    auto row = [&](int rr) { return table[static_cast<size_t>(rr) * n + g]; };
    const float lv = k.lv;
    const int p1 = min(static_cast<int>(lv), L_lay - 1);
    const int p2 = min(static_cast<int>(lv) + 1, L_lay - 1);
    auto put = [&](int a, float v) {
      attrs[static_cast<size_t>(a) * cap_out + o] = v;
    };
    tile_out[o] = k.ty * grid_x + k.tx;
    depth_out[o] = row(R_DEPTH);
    gid_out[o] = g;
    put(A_MX, k.q.mx);
    put(A_MY, k.q.my);
    put(A_CA, row(R_CA));
    put(A_CB, row(R_CB));
    put(A_CC, row(R_CC));
    put(A_OP1, row(R_LEVEL + p1));
    // The L2 cull folds into the sign of op2: the blend's alpha >= 1/255
    // test then rejects the pair in the second chain.
    put(A_OP2, (k.q.hl + 1.0f) < (lv + 1.0f) ? -1.0f : row(R_LEVEL + p2));
    put(A_R1, row(R_LEVEL + L_lay + p1));
    put(A_G1, row(R_LEVEL + 2 * L_lay + p1));
    put(A_B1, row(R_LEVEL + 3 * L_lay + p1));
    put(A_R2, row(R_LEVEL + L_lay + p2));
    put(A_G2, row(R_LEVEL + 2 * L_lay + p2));
    put(A_B2, row(R_LEVEL + 3 * L_lay + p2));
  }
}

}  // namespace

// Candidates a block takes: the wrapper's `counts` buffer holds one int
// per CHUNK of pair_cap.
FS_EXPORT int fs_expand_fov_chunk() { return CHUNK; }

FS_EXPORT int fs_expand_fov(const float* table, const int* cum,
                            const float* levels, int n, int L_lay,
                            int grid_x, int pair_cap, int cap_out,
                            int use_obb, int* counts, int* kept,
                            int* tile_out, float* depth_out, int* gid_out,
                            float* attrs, void* stream) {
  if (n < 1 || pair_cap < 1 || cap_out < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (pair_cap + CHUNK - 1) / CHUNK;
  count_kernel<<<nblk, BLOCK, 0, s>>>(table, cum, levels, n, grid_x,
                                      pair_cap, use_obb, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_sums_kernel<<<1, fs::SUMS_BLOCK, 0, s>>>(counts, nblk, kept);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  write_kernel<<<nblk, BLOCK, 0, s>>>(table, cum, levels, counts, n, L_lay,
                                      grid_x, pair_cap, cap_out, use_obb,
                                      tile_out, depth_out, gid_out, attrs);
  return cudaGetLastError();
}
