// Shared pieces of the port's CUDA sources: the block-local exclusive scan
// with its carry pass (the tiles-touched cumsum of build_table.cu and the
// kept-pair offsets of expand_fov.cu), and the error-string export.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that the Python wrapper can raise on a
// launch that was refused.
#pragma once

#include <cuda_runtime.h>

#define FS_EXPORT extern "C" __attribute__((visibility("default")))

namespace fs {

constexpr int SCAN_BLOCK = 256;

// Exclusive prefix sum of one int per thread over a SCAN_BLOCK-thread
// block. Returns the thread's exclusive prefix; *block_total receives the
// block's sum (valid in every thread). Warp shuffles, then one warp scans
// the eight warp sums.
__device__ inline int block_exclusive_scan(int v, int* block_total) {
  __shared__ int warp_sums[SCAN_BLOCK / 32];
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
    int w = lane < SCAN_BLOCK / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < SCAN_BLOCK / 32) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int warp_base = warp > 0 ? warp_sums[warp - 1] : 0;
  *block_total = warp_sums[SCAN_BLOCK / 32 - 1];
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

// Second pass: block b adds the sum of block_sums[0, b) to its part of
// out[]; the last block writes the grand total. Each block reduces its own
// carry, so one launch finishes the scan.
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_carry_kernel(int* __restrict__ out, const int* __restrict__ block_sums,
                  int nblocks, int n, int* __restrict__ total) {
  __shared__ int red[SCAN_BLOCK];
  const int b = blockIdx.x;
  int s = 0;
  for (int j = threadIdx.x; j < b; j += SCAN_BLOCK) s += block_sums[j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = SCAN_BLOCK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const int carry = red[0];
  const int i = b * SCAN_BLOCK + threadIdx.x;
  if (i < n) out[i] += carry;
  if (b == nblocks - 1 && threadIdx.x == 0) *total = carry + block_sums[b];
}

inline int scan_blocks(int n) { return (n + SCAN_BLOCK - 1) / SCAN_BLOCK; }

}  // namespace fs

FS_EXPORT const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
