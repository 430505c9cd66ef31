// Kernel 4: single-level pair expansion, OBB cull and deterministic
// compaction, with exact f32 attribute rows (train) or the quantized
// inference rows.
//
// Replaces fovsplat/ops/pallas/expand_fov.py:768 expand_ps1_pallas in its
// train=True and train=False forms. The candidates are the (Gaussian, tile)
// pairs of every Gaussian's tile rect, numbered by `cum`, the exclusive
// prefix of the table's tnum row: candidate c belongs to the Gaussian g
// with cum[g] <= c < cum[g] + tnum[g] and is tile j = c - cum[g] of its
// rect in row-major order. A candidate is kept when it passes the OBB
// separating-axis test (binning.obb_pass; kept without a test when len1 <=
// 0, the single-tile rects). Output order is the JAX kernel's pre-sort
// order (Gaussian, then tile row-major), and the kept count and every lane
// are deterministic.
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
//     0, 255). Each kept pair computes the encoding from its Gaussian's
//     table column.
// The wrapper builds the fused sort key from tile and depth. Candidates
// at or past `pair_cap` and kept pairs at or past `cap_out` are dropped;
// the caller counts both into overflow.
//
// Bound: bytes (the table in, 48 B (train) or 28 B (inference) per kept
// pair out; ~30 FLOP of OBB test per candidate). The design is kernel 2's
// (expand_fov.cu), candidate-parallel as the TPU kernel's fixed candidate
// chunks with their first Gaussian from `gstarts` are:
//
// - One thread per candidate, CHUNK candidates a block in ROUNDS rounds of
//   BLOCK. A block finds the Gaussians of its first and last candidate by
//   binary searches over `cum` (common.cuh's block_span); each thread then
//   searches between them, from its previous round's Gaussian on. A
//   Gaussian whose rect covers hundreds of tiles is spread over hundreds of
//   threads instead of keeping one thread busy while its warp waits.
// - Neighbouring candidates mostly share a Gaussian, so its 12 rect and OBB
//   rows (and in the write pass its depth and attribute rows) are the same
//   addresses across a warp: one L1 transaction serves them all.
// - Compaction by block counts: a count pass writes each block's kept
//   count, one block scans the counts (common.cuh's scan_sums_kernel), and
//   the write pass recomputes each keep flag and places a kept pair at its
//   block's offset plus a block-level exclusive scan of the flags, round
//   by round. Consecutive kept pairs have consecutive offsets, so a warp's
//   stores to each row are coalesced. No per-Gaussian buffer is needed.
// - keep_pair keeps the operation order of expand_ps1_plain (it differs
//   from kernel 2's), so that under -fmad=false the kept pairs are the
//   plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = 256;
constexpr int ROUNDS = 4;
constexpr int CHUNK = BLOCK * ROUNDS;    // candidates a block takes
// Table rows (ops/kernels/expand_ps1.py ROW_*).
enum Row {
  R_RX0 = 0, R_RY0, R_RW, R_TNUM, R_MX, R_MY, R_V1X, R_V1Y, R_V2X, R_V2Y,
  R_LEN1, R_LEN2, R_CA, R_CB, R_CC, R_OP, R_R, R_G, R_B, R_DEPTH
};
constexpr int NUM_ATTRS = 10;   // mx, my, ca, cb, cc, op, r, g, b, gid

struct Rect {
  int rx0, ry0, rw, cum;
  float mx, my, v1x, v1y, v2x, v2y, len1, len2;
};

__device__ inline float row(const float* __restrict__ table, int n, int r,
                            int g) {
  return table[static_cast<size_t>(r) * n + g];
}

__device__ inline Rect load_rect(const float* __restrict__ table,
                                 const int* __restrict__ cum, int n, int g) {
  Rect q;
  q.rx0 = static_cast<int>(row(table, n, R_RX0, g));
  q.ry0 = static_cast<int>(row(table, n, R_RY0, g));
  q.rw = static_cast<int>(row(table, n, R_RW, g));
  q.cum = cum[g];
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

// One candidate: its Gaussian (searched from *g_from on), tile and keep
// flag. The owners of a block's candidates lie in [g_from, g_last].
struct Cand {
  int g, tx, ty;
  bool keep;
};

__device__ inline Cand candidate(const float* __restrict__ table,
                                 const int* __restrict__ cum, int n,
                                 int use_obb, int c, int* g_from,
                                 int g_last) {
  Cand k;
  k.g = fs::owner(cum, *g_from, g_last, c);
  *g_from = k.g;
  const Rect q = load_rect(table, cum, n, k.g);
  const int j = c - q.cum;
  k.tx = q.rx0 + j % q.rw;
  k.ty = q.ry0 + j / q.rw;
  k.keep = keep_pair(q, k.tx, k.ty, use_obb);
  return k;
}

__global__ void __launch_bounds__(BLOCK)
count_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             int n, int pair_cap, int use_obb, int* __restrict__ counts) {
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
      keep = candidate(table, cum, n, use_obb, c, &g_from, g_last).keep;
    kept += __syncthreads_count(keep);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = kept;
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

__global__ void __launch_bounds__(BLOCK)
write_kernel(const float* __restrict__ table, const int* __restrict__ cum,
             const int* __restrict__ block_offsets, int n, int grid_x,
             int pair_cap, int cap_out, int use_obb, int quant,
             int* __restrict__ tile_out, float* __restrict__ depth_out,
             unsigned* __restrict__ attrs) {
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
      k = candidate(table, cum, n, use_obb, c, &g_from, g_last);
    int round_kept;
    const int o = o_base + fs::block_exclusive_scan(k.keep ? 1 : 0,
                                                    &round_kept);
    o_base += round_kept;
    if (!k.keep || o >= cap_out) continue;
    const int g = k.g;
    auto put = [&](int a, unsigned v) {
      attrs[static_cast<size_t>(a) * cap_out + o] = v;
    };
    tile_out[o] = k.ty * grid_x + k.tx;
    depth_out[o] = row(table, n, R_DEPTH, g);
    put(0, __float_as_uint(row(table, n, R_MX, g)));
    put(1, __float_as_uint(row(table, n, R_MY, g)));
    if (quant) {
      const float ca = row(table, n, R_CA, g);
      const float ca_hi = __uint_as_float(__float_as_uint(ca) & 0xFFFF0000u);
      put(2, pack2(ca_hi, ca - ca_hi));
      put(3, pack2(bf16_rne(row(table, n, R_CB, g)),
                   bf16_rne(row(table, n, R_CC, g))));
      put(4, q8(bf16_rne(row(table, n, R_OP, g)), 255.0f) << 24 |
                 q8(bf16_rne(row(table, n, R_R, g)), 127.5f) << 16 |
                 q8(bf16_rne(row(table, n, R_G, g)), 127.5f) << 8 |
                 q8(bf16_rne(row(table, n, R_B, g)), 127.5f));
    } else {
#pragma unroll
      for (int a = 2; a < NUM_ATTRS - 1; ++a)
        put(a, __float_as_uint(row(table, n, R_CA + a - 2, g)));
      put(NUM_ATTRS - 1, __float_as_uint(static_cast<float>(g)));
    }
  }
}

}  // namespace

// Candidates a block takes: the wrapper's `counts` buffer holds one int
// per CHUNK of pair_cap.
FS_EXPORT int fs_expand_ps1_chunk() { return CHUNK; }

FS_EXPORT int fs_expand_ps1(const float* table, const int* cum, int n,
                            int grid_x, int pair_cap, int cap_out,
                            int use_obb, int quant, int* counts, int* kept,
                            int* tile_out, float* depth_out, void* attrs,
                            void* stream) {
  if (n < 1 || pair_cap < 1 || cap_out < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (pair_cap + CHUNK - 1) / CHUNK;
  count_kernel<<<nblk, BLOCK, 0, s>>>(table, cum, n, pair_cap, use_obb,
                                      counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_sums_kernel<<<1, fs::SUMS_BLOCK, 0, s>>>(counts, nblk, kept);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  write_kernel<<<nblk, BLOCK, 0, s>>>(
      table, cum, counts, n, grid_x, pair_cap, cap_out, use_obb, quant,
      tile_out, depth_out, static_cast<unsigned*>(attrs));
  return cudaGetLastError();
}
