// Kernel 7 of the train step and the score pass: per-Gaussian sums of value
// rows over a gid-sorted stream.
//
// Replaces fovsplat/ops/pallas/segment_reduce.py:154 reduce_by_sorted_gid.
// The stream comes from a stable torch.sort on the gid (lanes with an
// all-zero cotangent carry the sentinel n and sort to the tail, as
// fovsplat/ops/rasterize.py:381-387 does), so each Gaussian's lanes form
// one run, and a run starts where the gid differs from the lane before.
//
// Bound: bytes (40 B per live lane in at 9 rows, 36 B per Gaussian out;
// one add per value). The design follows the bytes:
//
// - Work is balanced by lanes, not by runs. Block b takes the CHUNK lanes
//   [b CHUNK, (b+1) CHUNK) in PASSES passes of BLOCK lanes (coalesced row
//   loads) and sums every run inside them with a segmented inclusive scan
//   (warp shuffles, then the eight warp aggregates in order, then a carry
//   from pass to pass). The gids of the next pass and the values of this
//   one load while the pass before is scanned. A short run costs one
//   lane's share of a scan, and a run of tens of thousands of lanes (one
//   Gaussian that wins that many pixels of the score pass's argmax
//   stream) is spread over every block it touches.
// - A run that lies wholly inside the chunk is written to `out` by the
//   lane that ends it. The run cut by the chunk's first lane and the run
//   cut by its last lane leave partial sums in `parts` instead, and
//   finish_kernel adds a cut run's partials, one warp per run: the part
//   in the run's first chunk, then the parts of the chunks after it, 32
//   at a time, each 32 by a butterfly. No float atomics anywhere: the
//   summation order is fixed by the chunk geometry alone, so two calls on
//   the same input give the same bits. The order differs from the plain
//   twin's (torch.segment_reduce) and from the JAX kernel's chunked
//   one-hot sums; they agree within 1e-5 of the largest sum.
// - Only the live prefix is read. A block whose first gid is the sentinel
//   (gid >= n) exits at once; sentinel lanes load no values.
// - Every output column is written once, so the output needs no zero
//   fill of its own. The lane that starts a run also owns the gap of
//   columns without a lane just below its gid; the block scans its gap
//   lengths and writes the chunk's gap columns together, coalesced.
//   The first sentinel lane (or the stream's last lane, when it has no
//   sentinel) records where the gap above the last live gid starts, and
//   finish_kernel's grid writes that gap.
// - The row count is a template parameter (1 for the score pass, 9 for
//   the train step, up to 16 otherwise), so the scan keeps only the rows
//   it needs in registers.
//
// Two launches, no host sync, no scratch beyond `parts` (2 x 16 floats a
// chunk) and one int.

#include <climits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MAX_ROWS = 16;
constexpr int BLOCK = fs::SCAN_BLOCK;
constexpr int WARPS = BLOCK / 32;
constexpr int PASSES = 4;
constexpr int CHUNK = BLOCK * PASSES;   // lanes a block reduces
constexpr int FINISH_BLOCKS = 264;       // two per SM for the tail gap

// parts[(b * 2 + HEAD) * MAX_ROWS + r]: chunk b's sum of the run cut by its
// first lane; TAIL: of the run cut by its last lane (the same sum when one
// run covers the whole chunk).
constexpr int HEAD = 0, TAIL = 1;

// Largest t in [0, BLOCK) with off[t] <= k (off ascending, off[0] = 0).
__device__ inline int gap_owner(const int* off, int k) {
  int lo = 0, hi = BLOCK - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The values of lane i, zero unless it is live.
template <int NR>
__device__ inline void load_vals(const float* __restrict__ vals, int cap,
                                 int nrows, int n, int i, int g, float* v) {
  const bool live = g >= 0 && g < n;      // g is INT_MAX past the chunk
#pragma unroll
  for (int r = 0; r < NR; ++r)
    v[r] = (r < nrows && live) ? vals[static_cast<size_t>(r) * cap + i]
                               : 0.0f;
}

template <int NR>
__global__ void __launch_bounds__(BLOCK)
chunk_kernel(const int* __restrict__ gid, const float* __restrict__ vals,
             int cap, int nrows, int n, float* __restrict__ out,
             float* __restrict__ parts, int* __restrict__ tail) {
  __shared__ float agg[WARPS][NR];
  __shared__ int agg_f[WARPS];
  __shared__ int gap_off[BLOCK], gap_lo[BLOCK];
  const int b = blockIdx.x;
  const int base = b * CHUNK;
  const int stop = min(base + CHUNK, cap);
  const int prev_g = base > 0 ? gid[base - 1] : -1;
  if (gid[base] >= n) {                      // the sentinel tail
    if (threadIdx.x == 0 && prev_g < n) *tail = prev_g + 1;
    return;
  }
  const int next_g = stop < cap ? gid[stop] : INT_MIN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto load_gid = [&](int i) { return i < stop ? gid[i] : INT_MAX; };

  // Software pipeline: the gids of the next pass and the values of this
  // one are in flight while the pass before is scanned.
  int g_cur = load_gid(base + threadIdx.x);
  int g_nxt = load_gid(base + BLOCK + threadIdx.x);
  float v_cur[NR];
  load_vals<NR>(vals, cap, nrows, n, base + threadIdx.x, g_cur, v_cur);

  // Running segment value at the end of the previous pass. Its flag is
  // never needed: lane `base` always starts a segment.
  float carry[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) carry[r] = 0.0f;

#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int i = base + p * BLOCK + threadIdx.x;
    const bool in = i < stop;
    const int g = g_cur;
    float s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] = v_cur[r];
    const int g_nn = p + 2 < PASSES ? load_gid(i + 2 * BLOCK) : INT_MAX;
    if (p + 1 < PASSES)
      load_vals<NR>(vals, cap, nrows, n, i + BLOCK, g_nxt, v_cur);
    // The lanes on either side, from the neighbouring threads.
    int before = __shfl_up_sync(0xffffffffu, g, 1);
    int after = __shfl_down_sync(0xffffffffu, g, 1);
    if (lane == 0) before = in && i > 0 ? gid[i - 1] : -1;
    if (lane == 31) after = i + 1 < stop ? gid[i + 1] : INT_MAX;

    const bool live = in && g >= 0 && g < n;
    // The columns (before, g) have no lane: this run's head owns them.
    const int gap = live && before != g ? g - before - 1 : 0;
    if (in && g >= n && before < n) *tail = before + 1;  // first sentinel
    if (live && i == cap - 1) *tail = g + 1;             // no sentinel
    int f = (i == base || !in || before != g) ? 1 : 0;   // segment head

    // Segmented inclusive scan over the warp: (f, s) of lane - d before
    // (f, s) of this lane, left operand first.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int fu = __shfl_up_sync(0xffffffffu, f, d);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrows) {
          const float su = __shfl_up_sync(0xffffffffu, s[r], d);
          if (lane >= d && !f) s[r] = su + s[r];
        }
      }
      if (lane >= d) f |= fu;
    }
    if (lane == 31) {
      agg_f[warp] = f;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < nrows) agg[warp][r] = s[r];
    }
    int gaps;
    const int goff = fs::block_exclusive_scan(gap, &gaps);  // syncs
    gap_off[threadIdx.x] = goff;
    gap_lo[threadIdx.x] = before + 1;

    // The block's segmented prefix, warp by warp from the carry; every
    // thread folds the same values in the same order. s becomes the
    // lane's value in its run so far.
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w == warp && !f) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
          if (r < nrows) s[r] = carry[r] + s[r];
      }
      const int af = agg_f[w];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < nrows) carry[r] = af ? agg[w][r] : carry[r] + agg[w][r];
    }

    const bool last = i == stop - 1;
    if (live && (last || after != g)) {      // this lane ends its run
      const bool cut_head = g == prev_g;
      const bool cut_tail = last && g == next_g;
      float* ph = parts + (static_cast<size_t>(b) * 2 + HEAD) * MAX_ROWS;
      float* pt = parts + (static_cast<size_t>(b) * 2 + TAIL) * MAX_ROWS;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < nrows) {
          if (!cut_head && !cut_tail)
            out[static_cast<size_t>(r) * n + g] = s[r];
          if (cut_head) ph[r] = s[r];
          if (cut_tail) pt[r] = s[r];
        }
      }
    }

    // The pass's gap columns, BLOCK at a time, in column order.
    __syncthreads();                          // gap_off, gap_lo written
    for (int k = threadIdx.x; k < gaps; k += BLOCK) {
      const int t = gap_owner(gap_off, k);
      const int c = gap_lo[t] + (k - gap_off[t]);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < nrows) out[static_cast<size_t>(r) * n + c] = 0.0f;
    }
    __syncthreads();                          // shared reused next pass
    g_cur = g_nxt;
    g_nxt = g_nn;
  }
}

// Warps [0, nchunks): the cut run that starts in chunk t, if any: its
// tail part in chunk t plus the head parts of the chunks it covers after
// t, 32 chunks at a time (lane l takes chunk t + 1 + l, a butterfly sums
// the 32 in a fixed order). The whole grid: zeros in the columns
// [*tail, n), above the last live gid.
__global__ void __launch_bounds__(BLOCK)
finish_kernel(const int* __restrict__ gid, int cap, int nrows, int n,
              int nchunks, const float* __restrict__ parts,
              const int* __restrict__ tail, float* __restrict__ out) {
  const int tid = blockIdx.x * BLOCK + threadIdx.x;
  const int t = tid >> 5, lane = threadIdx.x & 31;
  const int stop = (t + 1) * CHUNK;
  // Uniform over the warp.
  const int g = t < nchunks && stop < cap ? gid[stop - 1] : -1;
  if (g >= 0 && g < n && gid[stop] == g &&
      (t == 0 || gid[t * CHUNK - 1] != g)) {
    float acc[MAX_ROWS];
    const float* pt = parts + (static_cast<size_t>(t) * 2 + TAIL) * MAX_ROWS;
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = r < nrows ? pt[r] : 0.0f;
    for (int c0 = t + 1; c0 < nchunks; c0 += 32) {
      const int c = c0 + lane;
      // Chunk c holds a head part of this run iff its first lane is in it.
      const bool mine = c < nchunks && gid[static_cast<size_t>(c) * CHUNK] == g;
      const float* ph =
          parts + (static_cast<size_t>(c) * 2 + HEAD) * MAX_ROWS;
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < nrows) {
          float v = mine ? ph[r] : 0.0f;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          acc[r] += v;
        }
      }
      if (!__all_sync(0xffffffffu, mine)) break;
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < nrows && r == lane) out[static_cast<size_t>(r) * n + g] = acc[r];
  }
  for (int c = *tail + tid; c < n; c += gridDim.x * BLOCK) {
    for (int r = 0; r < nrows; ++r) out[static_cast<size_t>(r) * n + c] = 0.0f;
  }
}

}  // namespace

// Lanes a block reduces, for the wrapper's `parts` buffer.
FS_EXPORT int fs_segment_reduce_chunk() { return CHUNK; }

// parts: (ceil(cap / CHUNK) * 2 * 16) floats; tail: one int.
FS_EXPORT int fs_segment_reduce(const int* gid, const float* vals, int cap,
                                int nrows, int n, float* parts, int* tail,
                                float* out, void* stream) {
  if (nrows < 1 || nrows > MAX_ROWS || cap < 1 || n < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (cap + CHUNK - 1) / CHUNK;
  if (nrows == 1)
    chunk_kernel<1><<<nchunks, BLOCK, 0, s>>>(gid, vals, cap, nrows, n, out,
                                              parts, tail);
  else if (nrows <= 9)
    chunk_kernel<9><<<nchunks, BLOCK, 0, s>>>(gid, vals, cap, nrows, n, out,
                                              parts, tail);
  else
    chunk_kernel<MAX_ROWS><<<nchunks, BLOCK, 0, s>>>(gid, vals, cap, nrows,
                                                     n, out, parts, tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunk_blocks = (nchunks + WARPS - 1) / WARPS;   // warp a chunk
  finish_kernel<<<chunk_blocks > FINISH_BLOCKS ? chunk_blocks : FINISH_BLOCKS,
                  BLOCK, 0, s>>>(gid, cap, nrows, n, nchunks, parts, tail,
                                 out);
  return cudaGetLastError();
}
