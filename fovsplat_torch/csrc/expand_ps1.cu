// Kernel 4: single-level pair expansion, OBB cull and deterministic
// compaction, with exact f32 attribute rows (train) or the quantized
// inference rows.
//
// Replaces fovsplat/ops/pallas/expand_fov.py:768 expand_ps1_pallas in its
// train=True and train=False forms. One thread per Gaussian walks its
// tile rect in row-major order and runs the OBB separating-axis test
// (binning.obb_pass; kept without a test when len1 <= 0, the single-tile
// rects). The TPU kernel carries a running kept count across its
// sequential grid; CUDA blocks have no order, so compaction is count,
// scan, write: pass 1 counts each Gaussian's kept pairs, common.cuh's scan
// turns the counts into offsets, pass 2 writes the kept pairs at their
// offsets. Output order is the JAX kernel's pre-sort order (Gaussian,
// then tile row-major), and the kept count and every lane are
// deterministic.
//
// Out, per kept pair: tile (i32), view depth (f32) and the attribute
// rows, written as 32-bit patterns:
//   train: ten f32 rows [mx, my, ca, cb, cc, op, r, g, b, gid] copied from
//     the table (gid as an exact f32 integer, N < 2^24);
//   inference: five rows [mx, my, P_caca, P_cbcc, OPRGB], the encoding of
//     expand_fov.py:151-168 and :697-730 bit for bit. The TPU kernel
//     stages cb, cc, op, r, g and b through one bf16 matmul, so each is
//     rounded to bf16 (nearest even) before it is packed; ca travels as
//     exact split parts. P_caca = pack2(trunc_bf16(ca), ca -
//     trunc_bf16(ca)); P_cbcc = pack2(cb, cc), pack2 rounding each half by
//     +0x8000 and masking; OPRGB = q8(op, 255) << 24 | q8(r, 127.5) << 16 |
//     q8(g, 127.5) << 8 | q8(b, 127.5), q8(v, s) = clip(floor(v s + 0.5),
//     0, 255). The encoding is per Gaussian, so it is computed once per
//     Gaussian and copied to each of its pairs.
// The wrapper builds the fused sort key from tile and depth. Candidates
// at or past `pair_cap` and kept pairs at or past `cap_out` are dropped;
// the caller counts both into overflow.
//
// Bound: bytes. The table (20 rows) is read once per pass and each kept
// pair writes 48 B (train) or 28 B (inference); the OBB test is ~30 FLOP
// per candidate. The walk is per Gaussian, so a large rect keeps one
// thread busy while its warp idles (the reference's duplicateWithKeys has
// the same imbalance); the writes of one warp land near each other
// because offsets grow with the Gaussian index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
// Table rows (ops/kernels/expand_ps1.py ROW_*).
enum Row {
  R_RX0 = 0, R_RY0, R_RW, R_TNUM, R_MX, R_MY, R_V1X, R_V1Y, R_V2X, R_V2Y,
  R_LEN1, R_LEN2, R_CA, R_CB, R_CC, R_OP, R_R, R_G, R_B, R_DEPTH
};
constexpr int NUM_ATTRS = 10;   // mx, my, ca, cb, cc, op, r, g, b, gid
constexpr int NUM_QROWS = 5;    // mx, my, P_caca, P_cbcc, OPRGB

struct Rect {
  int rx0, ry0, rw, m;
  float mx, my, v1x, v1y, v2x, v2y, len1, len2;
};

__device__ inline float row(const float* __restrict__ table, int n, int r,
                            int g) {
  return table[static_cast<size_t>(r) * n + g];
}

__device__ inline Rect load_rect(const float* __restrict__ table,
                                 const int* __restrict__ cum, int n,
                                 int pair_cap, int g) {
  Rect q;
  q.rx0 = static_cast<int>(row(table, n, R_RX0, g));
  q.ry0 = static_cast<int>(row(table, n, R_RY0, g));
  q.rw = static_cast<int>(row(table, n, R_RW, g));
  q.m = min(static_cast<int>(row(table, n, R_TNUM, g)), pair_cap - cum[g]);
  q.mx = row(table, n, R_MX, g);
  q.my = row(table, n, R_MY, g);
  q.v1x = row(table, n, R_V1X, g);
  q.v1y = row(table, n, R_V1Y, g);
  q.v2x = row(table, n, R_V2X, g);
  q.v2y = row(table, n, R_V2Y, g);
  q.len1 = row(table, n, R_LEN1, g);
  q.len2 = row(table, n, R_LEN2, g);
  return q;
}

// OBB / tile separating-axis test in the operation order of the plain
// version (expand_ps1_plain), so that -fmad=false keeps them bit-equal.
__device__ inline bool keep_pair(const Rect& q, int tx, int ty,
                                 int use_obb) {
  if (!use_obb) return true;
  const float half = TILE / 2.0f;
  const float cx = q.mx - (static_cast<float>(tx) * TILE + half);
  const float cy = q.my - (static_cast<float>(ty) * TILE + half);
  const float ext_x = fabsf(q.len1 * q.v1x) + fabsf(q.len2 * q.v2x);
  const float ext_y = fabsf(q.len1 * q.v1y) + fabsf(q.len2 * q.v2y);
  const float base1 = -(cx * q.v1x + cy * q.v1y);
  const float base2 = -(cx * q.v2x + cy * q.v2y);
  const float e1 = half * (fabsf(q.v1x) + fabsf(q.v1y));
  const float e2 = half * (fabsf(q.v2x) + fabsf(q.v2y));
  const bool obb = fabsf(cx) <= half + ext_x && fabsf(cy) <= half + ext_y &&
                   fabsf(base1) <= q.len1 + e1 && fabsf(base2) <= q.len2 + e2;
  return obb || q.len1 <= 0.0f;
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
count_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             int n, int pair_cap, int use_obb, int* __restrict__ counts) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const Rect q = load_rect(table, cum, n, pair_cap, g);
  int kept = 0;
  for (int j = 0; j < q.m; ++j)
    kept += keep_pair(q, q.rx0 + j % q.rw, q.ry0 + j / q.rw, use_obb);
  counts[g] = kept;
}

__device__ inline float bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two f32 -> (bf16(a) << 16 | bf16(b)), each half rounded by +0x8000.
__device__ inline unsigned pack2(float a, float b) {
  const unsigned ua = (__float_as_uint(a) + 0x8000u) & 0xFFFF0000u;
  const unsigned ub = ((__float_as_uint(b) + 0x8000u) & 0xFFFF0000u) >> 16;
  return ua | ub;
}

__device__ inline unsigned q8(float v, float scale) {
  return static_cast<unsigned>(
      fminf(fmaxf(floorf(v * scale + 0.5f), 0.0f), 255.0f));
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
write_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             const int* __restrict__ offsets, int n, int grid_x,
             int pair_cap, int cap_out, int use_obb, int quant,
             int* __restrict__ tile_out, float* __restrict__ depth_out,
             unsigned* __restrict__ attrs) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const Rect q = load_rect(table, cum, n, pair_cap, g);
  if (q.m <= 0) return;
  unsigned vals[NUM_ATTRS];
  vals[0] = __float_as_uint(q.mx);
  vals[1] = __float_as_uint(q.my);
  int nrows = NUM_ATTRS;
  if (quant) {
    const float ca = row(table, n, R_CA, g);
    const float ca_hi = __uint_as_float(__float_as_uint(ca) & 0xFFFF0000u);
    vals[2] = pack2(ca_hi, ca - ca_hi);
    vals[3] = pack2(bf16_rne(row(table, n, R_CB, g)),
                    bf16_rne(row(table, n, R_CC, g)));
    vals[4] = q8(bf16_rne(row(table, n, R_OP, g)), 255.0f) << 24 |
              q8(bf16_rne(row(table, n, R_R, g)), 127.5f) << 16 |
              q8(bf16_rne(row(table, n, R_G, g)), 127.5f) << 8 |
              q8(bf16_rne(row(table, n, R_B, g)), 127.5f);
    nrows = NUM_QROWS;
  } else {
#pragma unroll
    for (int a = 2; a < 9; ++a)
      vals[a] = __float_as_uint(row(table, n, R_CA + a - 2, g));
    vals[9] = __float_as_uint(static_cast<float>(g));
  }
  const float depth = row(table, n, R_DEPTH, g);
  int o = offsets[g];
  for (int j = 0; j < q.m && o < cap_out; ++j) {
    const int tx = q.rx0 + j % q.rw, ty = q.ry0 + j / q.rw;
    if (!keep_pair(q, tx, ty, use_obb)) continue;
    tile_out[o] = ty * grid_x + tx;
    depth_out[o] = depth;
#pragma unroll
    for (int a = 0; a < NUM_ATTRS; ++a)
      if (a < nrows) attrs[static_cast<size_t>(a) * cap_out + o] = vals[a];
    ++o;
  }
}

}  // namespace

FS_EXPORT int fs_expand_ps1(const float* table, const int* cum, int n,
                            int grid_x, int pair_cap, int cap_out,
                            int use_obb, int quant, int* counts,
                            int* offsets, int* block_sums, int* kept,
                            int* tile_out, float* depth_out, void* attrs,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(n);
  count_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(table, cum, n, pair_cap,
                                             use_obb, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_local_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(counts, offsets,
                                                      block_sums, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fs::scan_carry(offsets, block_sums, nb, n, kept, s);
  if (err != cudaSuccess) return err;
  write_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(
      table, cum, offsets, n, grid_x, pair_cap, cap_out, use_obb, quant,
      tile_out, depth_out, static_cast<unsigned*>(attrs));
  return cudaGetLastError();
}
