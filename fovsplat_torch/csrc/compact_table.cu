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
// sequential grid; here one pass with a decoupled look-back carries them
// across blocks. Each block takes its index from an atomic counter, so
// every block before it has started and the look-back cannot deadlock,
// and takes CHUNK columns:
// 1. it flags its columns and takes each kept column's tnum, as one
//    packed word (kept | tnum << 32), read coalesced and scanned through
//    shared memory (each thread ITEMS consecutive columns, then one block
//    scan of the thread sums);
// 2. warp 0 (the kept count) and warp 1 (the tnum sum) publish the
//    block's aggregate in its status word, then walk back over the
//    predecessors' words to the nearest inclusive prefix and publish
//    their own (64-bit words: a flag in bits 62-63, the value in the low
//    32 bits, so a word is read whole; acquire loads, release stores);
// 3. it copies each kept column's R rows to its offset and writes cum
//    there. The last block writes live and total.
// A second launch zeroes the columns from live on, with cum = total
// there. The status words and the counter are zeroed on the stream first
// (cudaMemsetAsync). Integer sums, so every output is exact: the tnum
// sums wrap mod 2^32 as the plain version's i32 cumsum does.
//
// Why it exists: the TPU's expand kernels need one dummy pair per invalid
// row to keep their bounded-window property (compact_table.py:4-10), and
// this kernel removed those rows. The port has no dummy pairs, so that
// motive is gone; all it can buy here is denser warps in kernels 2 and 4
// (every thread of a warp then owns a Gaussian with tiles). It stays off
// by default (RasterizeConfig.compact_table).
//
// Bound: bytes. The table is read once and the whole output table is
// written once (R x 4 B a column each way, the zeroed columns included),
// plus 4 B a lane of cum. Reads are coalesced (thread i of a block reads
// column i of every row); the kept columns of a warp land on consecutive
// offsets, so the writes nearly are.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                  // columns a thread
constexpr int CHUNK = THREADS * ITEMS;    // columns a block
constexpr int ROW_BATCH = 4;              // rows copied at once
constexpr unsigned FULL = 0xffffffffu;
// Status word flags: nothing yet, the block's own aggregate, the
// inclusive prefix through the block.
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long PREFIX = 2ull << 62;

__device__ inline unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ inline void store_release(unsigned long long* p,
                                     unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// One warp: the sum, mod 2^32, of the values of blocks [0, b) from their
// status words, 32 predecessors at a time; it waits while any of them is
// empty and stops at the nearest inclusive prefix.
__device__ inline unsigned look_back(const unsigned long long* status,
                                     int b) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0u;
  for (int pred = b - 1; pred >= 0;) {
    const int i = pred - lane;
    const unsigned long long w = i >= 0 ? load_acquire(status + i) : PREFIX;
    if (__any_sync(FULL, (w >> 62) == 0)) continue;
    const unsigned prefix = __ballot_sync(FULL, (w >> 62) == 2);
    const int first = prefix ? __ffs(prefix) - 1 : 31;
    excl += __reduce_add_sync(FULL, lane <= first ? static_cast<unsigned>(w)
                                                  : 0u);
    if (prefix) break;
    pred -= 32;
  }
  return excl;
}

// status: 2 * nblocks words (the kept counts', then the tnum sums'), and
// the block counter after them, all zero at launch.
__global__ void __launch_bounds__(THREADS)
compact_kernel(const float* __restrict__ table, int n, int rows,
               int flag_row, float flag_thresh, int tnum_row,
               unsigned long long* __restrict__ status, int nblocks,
               float* __restrict__ out, int* __restrict__ cum_out,
               int* __restrict__ live, int* __restrict__ total) {
  __shared__ unsigned long long words[CHUNK];
  __shared__ unsigned base[2];   // the kept count and tnum before the block
  __shared__ int block_id;
  if (threadIdx.x == 0)
    block_id = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(status + 2 * nblocks), 1u));
  __syncthreads();
  const int b = block_id;
  const int c0 = b * CHUNK;

  // 1. Column c0 + j * THREADS + tid: its flag and packed word.
  bool keep[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int c = c0 + j * THREADS + threadIdx.x;
    keep[j] = c < n && table[static_cast<size_t>(flag_row) * n + c] >
                           flag_thresh;
    const unsigned tn =
        keep[j] ? static_cast<unsigned>(static_cast<int>(
                      table[static_cast<size_t>(tnum_row) * n + c]))
                : 0u;
    words[j * THREADS + threadIdx.x] =
        (keep[j] ? 1ull : 0ull) | (static_cast<unsigned long long>(tn) << 32);
  }
  __syncthreads();
  // Thread i's columns [i * ITEMS, (i + 1) * ITEMS) of the chunk: the
  // packed sums add the kept counts (below 2^31) and the tnum sums (mod
  // 2^32) at once.
  unsigned long long local[ITEMS], sum = 0ull;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    local[i] = sum;
    sum += words[threadIdx.x * ITEMS + i];
  }
  unsigned long long agg;
  const unsigned long long excl =
      fs::block_exclusive_scan<THREADS>(sum, &agg);

  // 2. The block's prefix: warp q carries quantity q.
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    unsigned long long* st = status + warp * nblocks;
    const unsigned a = static_cast<unsigned>(warp == 0 ? agg : agg >> 32);
    if ((threadIdx.x & 31) == 0) {
      __threadfence();
      store_release(st + b, (b == 0 ? PREFIX : AGGREGATE) | a);
    }
    const unsigned before = b > 0 ? look_back(st, b) : 0u;
    if ((threadIdx.x & 31) == 0) {
      if (b > 0) store_release(st + b, PREFIX | (before + a));
      base[warp] = before;
      if (b == nblocks - 1) *(warp == 0 ? live : total) =
          static_cast<int>(before + a);
    }
  }
  __syncthreads();
  const unsigned long long start =
      base[0] | (static_cast<unsigned long long>(base[1]) << 32);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    words[threadIdx.x * ITEMS + i] = start + excl + local[i];
  __syncthreads();

  // 3. Each kept column to its offset: the low word of its prefix. The
  // rows go ROW_BATCH at a time, all their loads before their stores.
  int col[ITEMS], off[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned long long w = words[j * THREADS + threadIdx.x];
    col[j] = c0 + j * THREADS + threadIdx.x;
    off[j] = static_cast<int>(static_cast<unsigned>(w));
    if (keep[j]) cum_out[off[j]] = static_cast<int>(w >> 32);
  }
  for (int r0 = 0; r0 < rows; r0 += ROW_BATCH) {
    float v[ROW_BATCH][ITEMS];
#pragma unroll
    for (int i = 0; i < ROW_BATCH; ++i) {
      const float* src = table + static_cast<size_t>(r0 + i) * n;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        v[i][j] = r0 + i < rows && col[j] < n ? src[col[j]] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < ROW_BATCH; ++i) {
      float* dst = out + static_cast<size_t>(r0 + i) * n;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (keep[j] && r0 + i < rows) dst[off[j]] = v[i][j];
    }
  }
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

// status: 2 * ceil(n / CHUNK) + 1 words of scratch (zeroed here).
FS_EXPORT int fs_compact_table(const float* table, int n, int rows,
                               int flag_row, float flag_thresh, int tnum_row,
                               unsigned long long* status, float* out,
                               int* cum_out, int* live, int* total,
                               void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = (n + CHUNK - 1) / CHUNK;
  cudaError_t err = cudaMemsetAsync(
      status, 0, (2 * static_cast<size_t>(nblocks) + 1) * sizeof(*status),
      s);
  if (err != cudaSuccess) return err;
  compact_kernel<<<nblocks, THREADS, 0, s>>>(table, n, rows, flag_row,
                                             flag_thresh, tnum_row, status,
                                             nblocks, out, cum_out, live,
                                             total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nb = fs::scan_blocks(n);
  tail_kernel<<<nb < 1024 ? nb : 1024, fs::SCAN_BLOCK, 0, s>>>(
      n, rows, live, total, out, cum_out);
  return cudaGetLastError();
}
