// Kernel 7 of the train step: per-Gaussian sums of the cotangent rows over
// a gid-sorted stream.
//
// Replaces fovsplat/ops/pallas/segment_reduce.py:154 reduce_by_sorted_gid.
// The stream comes from a stable torch.sort on the gid (lanes with an
// all-zero cotangent carry the sentinel n and sort to the tail, as
// fovsplat/ops/rasterize.py:381-387 does), so each Gaussian's lanes form
// one run. Runs are found with a flag and a scan: a lane starts a run when
// its gid differs from the lane before it; common.cuh's scan numbers the
// run starts and a third pass lists them. Then one warp sums each run: its
// 32 lanes stride over the run, and a butterfly reduces the 32 partial sums
// in a fixed order, so the sums are deterministic (no atomics). A run of
// sentinel lanes (gid >= n) is skipped without reading its values, as
// skip_from does. The wrapper zero-fills the output for Gaussians without
// a run.
//
// Bound: bytes (40 B per live lane in, 36 B per Gaussian out; one add per
// value). Finding the runs reads the gid stream and writes and reads 8 B of
// scratch per lane over the whole capacity, the sentinel tail included;
// the sums themselves read each live lane once, 32 lanes of a run at a
// time. A warp per run instead of a thread per run keeps a Gaussian that
// covers many tiles (a run of hundreds of lanes) from serialising in one
// thread.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MAX_ROWS = 16;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_REDUCE_BLOCKS = 4096;

__device__ inline bool run_starts(const int* __restrict__ gid, int i) {
  return i == 0 || gid[i - 1] != gid[i];
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
flag_kernel(const int* __restrict__ gid, int cap, int* __restrict__ flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap) flags[i] = run_starts(gid, i) ? 1 : 0;
}

__global__ void __launch_bounds__(fs::SCAN_BLOCK)
list_kernel(const int* __restrict__ gid, const int* __restrict__ offsets,
            int cap, int* __restrict__ run_start) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap && run_starts(gid, i)) run_start[offsets[i]] = i;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per run, grid-strided over the runs; every branch below is
// uniform across the warp, so the butterfly sees all 32 lanes.
__global__ void __launch_bounds__(BLOCK)
reduce_kernel(const int* __restrict__ gid, const float* __restrict__ vals,
              const int* __restrict__ run_start,
              const int* __restrict__ num_runs, int cap, int nrows, int n,
              float* __restrict__ out) {
  const int runs = *num_runs;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int k = blockIdx.x * WARPS + (threadIdx.x >> 5); k < runs;
       k += stride) {
    const int s = run_start[k];
    const int g = gid[s];
    if (g < 0 || g >= n) continue;
    const int e = k + 1 < runs ? run_start[k + 1] : cap;
    float acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.0f;
    for (int j = s + lane; j < e; j += 32) {
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
        if (r < nrows) acc[r] += vals[static_cast<size_t>(r) * cap + j];
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < nrows) {
        const float v = warp_sum(acc[r]);
        if (lane == 0) out[static_cast<size_t>(r) * n + g] = v;
      }
    }
  }
}

}  // namespace

FS_EXPORT int fs_segment_reduce(const int* gid, const float* vals, int cap,
                                int nrows, int n, int* flags, int* offsets,
                                int* block_sums, int* num_runs,
                                int* run_start, float* out, void* stream) {
  if (nrows < 1 || nrows > MAX_ROWS) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(cap);
  flag_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(gid, cap, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_local_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(flags, offsets,
                                                      block_sums, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_carry_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(offsets, block_sums, nb,
                                                      cap, num_runs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  list_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(gid, offsets, cap, run_start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int want = (cap + WARPS - 1) / WARPS;
  const int blocks = want < MAX_REDUCE_BLOCKS ? want : MAX_REDUCE_BLOCKS;
  reduce_kernel<<<blocks, BLOCK, 0, s>>>(gid, vals, run_start, num_runs, cap,
                                         nrows, n, out);
  return cudaGetLastError();
}
