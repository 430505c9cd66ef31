// Kernel 9: compaction of the per-Gaussian table.
//
// Replaces fovsplat/ops/pallas/compact_table.py:189 compact_table_pallas
// (reached through fovsplat/ops/binning.py:346 compact_prebuilt). The
// columns of an f32 SoA table (R, N) whose flag row exceeds a threshold
// are kept in order; the table's tnum row is summed over the kept columns
// into the rebuilt exclusive cumsum. Out: the compacted table (R, N) with
// zeroed columns at and past `live`, cum (N,) with the total on every lane
// at or past `live` (binning.py:366-370), live and total.
//
// The TPU kernel carries its write position and pair total across a
// sequential grid; here it is count, scan, write: a flag pass writes each
// column's keep bit and its kept tnum, common.cuh's scan turns both into
// offsets (and live) and the compacted cum (and total), a write pass
// copies each kept column to its offset, and a tail pass zeroes the
// columns past live. No atomics: every lane is deterministic.
//
// Why it exists: the TPU's expand kernels need one dummy pair per invalid
// row to keep their bounded-window property (compact_table.py:4-10), and
// this kernel removed those rows. The port has no dummy pairs, so that
// motive is gone; all it can buy here is denser warps in kernels 2 and 4
// (every thread of a warp then owns a Gaussian with tiles). It stays off
// by default (RasterizeConfig.compact_table).
//
// Bound: bytes. The table is read once (R x 4 B a column) and each kept
// column is written once, plus 12 B a lane of cum, flag and scan traffic.
// The column copy is coalesced on the read (thread i reads column i of
// every row) and nearly so on the write (kept columns of a warp land on
// consecutive offsets).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
flag_kernel(const float* __restrict__ table, int n, int flag_row,
            float flag_thresh, int tnum_row, int* __restrict__ keep,
            int* __restrict__ kept_tnum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool k = table[static_cast<size_t>(flag_row) * n + i] > flag_thresh;
  keep[i] = k;
  kept_tnum[i] =
      k ? static_cast<int>(table[static_cast<size_t>(tnum_row) * n + i]) : 0;
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
write_kernel(const float* __restrict__ table, int n, int rows,
             const int* __restrict__ keep, const int* __restrict__ offsets,
             const int* __restrict__ kept_cum, float* __restrict__ out,
             int* __restrict__ cum_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !keep[i]) return;
  const int o = offsets[i];
  for (int r = 0; r < rows; ++r)
    out[static_cast<size_t>(r) * n + o] = table[static_cast<size_t>(r) * n + i];
  cum_out[o] = kept_cum[i];
}

// Lanes at or past live: zero columns, cum = total.
__global__ void tail_kernel(int n, int rows, const int* __restrict__ live,
                            const int* __restrict__ total,
                            float* __restrict__ out,
                            int* __restrict__ cum_out) {
  const int first = *live, tot = *total;
  for (int o = first + blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += gridDim.x * blockDim.x) {
    for (int r = 0; r < rows; ++r) out[static_cast<size_t>(r) * n + o] = 0.0f;
    cum_out[o] = tot;
  }
}

}  // namespace

FS_EXPORT int fs_compact_table(const float* table, int n, int rows,
                               int flag_row, float flag_thresh, int tnum_row,
                               int* keep, int* kept_tnum, int* offsets,
                               int* kept_cum, int* block_sums, float* out,
                               int* cum_out, int* live, int* total,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(n);
  flag_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(table, n, flag_row, flag_thresh,
                                            tnum_row, keep, kept_tnum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The two scans share block_sums: the second starts after the first's
  // carry pass on the same stream.
  fs::scan_local_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(keep, offsets,
                                                      block_sums, n);
  err = fs::scan_carry(offsets, block_sums, nb, n, live, s);
  if (err != cudaSuccess) return err;
  fs::scan_local_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(kept_tnum, kept_cum,
                                                      block_sums, n);
  err = fs::scan_carry(kept_cum, block_sums, nb, n, total, s);
  if (err != cudaSuccess) return err;
  write_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(table, n, rows, keep, offsets,
                                             kept_cum, out, cum_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tail_blocks = nb < 1024 ? nb : 1024;
  tail_kernel<<<tail_blocks, fs::SCAN_BLOCK, 0, s>>>(n, rows, live, total,
                                                     out, cum_out);
  return cudaGetLastError();
}
