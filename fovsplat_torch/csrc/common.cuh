// Shared pieces of the port's CUDA sources: the block-local exclusive scan
// and the linear carry that finishes it across blocks (the tiles-touched
// cumsum of build_table.cu, the kept-pair offsets of expand_fov.cu and
// expand_ps1.cu, the column offsets of compact_table.cu), and the
// error-string export.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that the Python wrapper can raise on a
// launch that was refused.
#pragma once

#include <cuda_runtime.h>

#define FS_EXPORT extern "C" __attribute__((visibility("default")))

namespace fs {

constexpr int SCAN_BLOCK = 256;
// Threads of the one block that scans the block sums, and the sums each
// thread takes per round: 4,096 sums a round, so a million-lane scan
// (4,537 blocks of SCAN_BLOCK) finishes in two rounds.
constexpr int SUMS_BLOCK = 1024;
constexpr int SUMS_ITEMS = 4;

// Exclusive prefix sum of one int per thread over a BLOCK-thread block.
// Returns the thread's exclusive prefix; *block_total receives the block's
// sum (valid in every thread). Warp shuffles, then one warp scans the warp
// sums.
template <int BLOCK = SCAN_BLOCK>
__device__ inline int block_exclusive_scan(int v, int* block_total) {
  static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "block of whole warps");
  __shared__ int warp_sums[BLOCK / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < BLOCK / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < BLOCK / 32) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int warp_base = warp > 0 ? warp_sums[warp - 1] : 0;
  *block_total = warp_sums[BLOCK / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the caller's next scan
  return warp_base + incl - v;
}

// out[i] = exclusive prefix of in[] within its SCAN_BLOCK block;
// block_sums[b] = that block's sum.
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_local_kernel(const int* __restrict__ in, int* __restrict__ out,
                  int* __restrict__ block_sums, int n) {
  const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const int v = i < n ? in[i] : 0;
  int total;
  const int excl = block_exclusive_scan(v, &total);
  if (i < n) out[i] = excl;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// One block turns block_sums[0, nblocks) into its exclusive prefix, in
// place, and writes the grand total: SUMS_ITEMS consecutive sums per
// thread, a block scan of the thread sums, a running carry across rounds.
// Linear in nblocks.
__global__ void __launch_bounds__(SUMS_BLOCK)
scan_sums_kernel(int* __restrict__ block_sums, int nblocks,
                 int* __restrict__ total) {
  int carry = 0;
  for (int base = 0; base < nblocks; base += SUMS_BLOCK * SUMS_ITEMS) {
    const int i0 = base + threadIdx.x * SUMS_ITEMS;
    int v[SUMS_ITEMS];
    int s = 0;
#pragma unroll
    for (int k = 0; k < SUMS_ITEMS; ++k) {
      v[k] = i0 + k < nblocks ? block_sums[i0 + k] : 0;
      s += v[k];
    }
    int round_total;
    int excl = carry + block_exclusive_scan<SUMS_BLOCK>(s, &round_total);
#pragma unroll
    for (int k = 0; k < SUMS_ITEMS; ++k) {
      if (i0 + k < nblocks) block_sums[i0 + k] = excl;
      excl += v[k];
    }
    carry += round_total;
  }
  if (threadIdx.x == 0) *total = carry;
}

// Block b adds its carry, block_sums[b] after scan_sums_kernel, to its part
// of out[].
__global__ void __launch_bounds__(SCAN_BLOCK)
add_carry_kernel(int* __restrict__ out, const int* __restrict__ block_sums,
                 int n) {
  const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  if (i < n) out[i] += block_sums[blockIdx.x];
}

inline int scan_blocks(int n) { return (n + SCAN_BLOCK - 1) / SCAN_BLOCK; }

// Finishes a scan whose blocks wrote their local exclusive prefixes to
// out[] and their sums to block_sums[]: one block scans the sums, then
// every block adds its carry; *total receives the grand total. Two
// launches on `s`; block_sums holds the carries afterwards.
inline cudaError_t scan_carry(int* out, int* block_sums, int nblocks, int n,
                              int* total, cudaStream_t s) {
  scan_sums_kernel<<<1, SUMS_BLOCK, 0, s>>>(block_sums, nblocks, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) add_carry_kernel<<<nblocks, SCAN_BLOCK, 0, s>>>(out, block_sums, n);
  return cudaGetLastError();
}

}  // namespace fs

FS_EXPORT const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
