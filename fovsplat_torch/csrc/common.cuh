// Shared pieces of the port's CUDA sources: the block-local exclusive scan
// (of any integer type) and the linear carry that finishes it across
// blocks (the tiles-touched cumsum of build_table.cu, the block offsets
// of expand_fov.cu and expand_ps1.cu; compact_table.cu scans packed
// 64-bit words), the candidate search of the two candidate-parallel
// expansions, the schedule and staging of the tile blends (blend_fov.cu,
// blend_fwd.cu, blend_stats.cu), and the error-string export.
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

// Exclusive prefix sum of one value per thread over a BLOCK-thread block
// (T an integer type). Returns the thread's exclusive prefix;
// *block_total receives the block's sum (valid in every thread). Warp
// shuffles, then one warp scans the warp sums.
template <int BLOCK = SCAN_BLOCK, typename T = int>
__device__ inline T block_exclusive_scan(T v, T* block_total) {
  static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "block of whole warps");
  __shared__ T warp_sums[BLOCK / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < BLOCK / 32 ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < BLOCK / 32) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const T warp_base = warp > 0 ? warp_sums[warp - 1] : T(0);
  *block_total = warp_sums[BLOCK / 32 - 1];
  __syncthreads();  // warp_sums may be reused by the caller's next scan
  return warp_base + incl - v;
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

// Largest g in [lo, hi] with cum[g] <= c (cum ascending, cum[lo] <= c): the
// Gaussian that owns candidate c of the expansions' cumsum.
__device__ inline int owner(const int* __restrict__ cum, int lo, int hi,
                            int c) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (cum[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The candidates [base, last] of block blockIdx.x of a candidate-parallel
// expansion, CHUNK a block, and the Gaussians of both ends in span[0] and
// span[1]. The last candidate is min(total, pair_cap) - 1, total =
// cum[n - 1] + tnum[n - 1] read on the device. Returns -1 when the block
// has none (then span is not written). Uniform over the block; ends with a
// barrier.
template <int CHUNK>
__device__ inline int block_span(const int* __restrict__ cum,
                                 const float* __restrict__ tnum, int n,
                                 int pair_cap, int* span) {
  const int total = n > 0 ? cum[n - 1] + static_cast<int>(tnum[n - 1]) : 0;
  const int limit = min(total, pair_cap);
  const int base = blockIdx.x * CHUNK;
  if (base >= limit) return -1;
  const int last = min(base + CHUNK, limit) - 1;
  if (threadIdx.x == 0) span[0] = owner(cum, 0, n - 1, base);
  if (threadIdx.x == 32) span[1] = owner(cum, 0, n - 1, last);
  __syncthreads();
  return last;
}

inline int scan_blocks(int n) { return (n + SCAN_BLOCK - 1) / SCAN_BLOCK; }

// ---- The tile blends' schedule and staging (kernels 3, 5, 5q, 6, 8) ----
//
// A persistent grid of the resident blocks takes the tiles heaviest
// first: order_kernel sorts them by segment length and each block takes
// the next one from an atomic counter, so the long foveal tiles start
// first instead of ending the last wave. A tile's output depends only on
// its own segment, so neither the order nor the block can change a bit.
// Each block stages its segment through a two-stage ring of packed pair
// records filled with cp.async, one barrier a batch, and gives each warp
// an 8x4 pixel block of the 16x16 tile (pixel_of).

constexpr int BLEND_TILE = 16;
constexpr int ORDER_THREADS = 1024;
constexpr int BUCKETS = 128;
constexpr int MAX_DEVICES = 64;

__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of pairs [base, base + count) of the ROWS x cap rows
// into one ring stage of records of REC floats (row a into slot a),
// thread i copying every row of record i (count <= the block size), so a
// warp's 32 reads of a row are consecutive and a thread may rewrite its
// own record once its copies have landed; commit them as one group.
template <int ROWS, int REC>
__device__ inline void stage_records(const float* __restrict__ rows, int cap,
                                     int base, int count, float* dst) {
  const int i = threadIdx.x;
  if (i < count) {
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
      cp_async4(dst + i * REC + a,
                rows + static_cast<size_t>(a) * cap + base + i);
  }
  cp_async_commit();
}

// The pixel (row-major in the tile) of slot s: each warp takes an 8x4
// block of the tile, which a Gaussian's footprint more often covers whole
// than a 16x2 row pair, so fewer lanes idle and a warp's pixels freeze
// closer together.
__device__ inline int pixel_of(int s) {
  const int w = s >> 5, l = s & 31;
  return ((w >> 1) * 4 + (l >> 3)) * BLEND_TILE + (w & 1) * 8 + (l & 7);
}

// The warps' pixel blocks of the tile (bit w: the pixels pixel_of gives
// warp w, the rectangle from its first to its last) in which some pixel
// may pass a pair's window test power >= power_cutoff, for a pair with
// its mean (mx, my) in tile-local pixel coordinates and conic (ca, cb,
// cc). A clear bit is a promise: the blends compute the power in f32 as
// -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy, and that value
// is below power_cutoff at every pixel of the block, so a warp may skip
// the pair without changing a bit. With Q = ca dx^2 + cc dy^2 + 2 cb dx
// dy, the test is Q <= Qc = -2 power_cutoff; the f32 power is within
// 3 eps S of the exact one, S = |ca| dx^2 + |cc| dy^2 + 2 |cb dx dy| <=
// K Q with K = 1 + (ca + cc)^2 / det. So outside the ellipse Q <= Qc (1 +
// 1e-5 K) no pixel can pass while K < 2.7e6, and a block outside that
// ellipse's bounding box (half-widths sqrt(Q cc / det), sqrt(Q ca / det),
// widened by 1e-5 and by the rounding of dx and dy, `slack`) is cleared.
// det comes from Kahan's two-product form. A conic that is not positive
// definite, K >= 1e6, or a NaN or an infinity anywhere sets every bit.
__device__ inline unsigned window_blocks(float mx, float my, float ca,
                                         float cb, float cc,
                                         float power_cutoff, float slack) {
  const float p = cb * cb;
  const float det = fmaf(ca, cc, -p) - fmaf(cb, cb, -p);
  const float k = 1.0f + (ca + cc) * (ca + cc) / det;
  if (!(ca > 0.0f && cc > 0.0f && det > 0.0f && k < 1e6f &&
        power_cutoff < 0.0f))
    return 0xFFu;
  const float q = -2.0f * power_cutoff * (1.0f + 1e-5f * k);
  const float ex = sqrtf(q * cc / det) * (1.0f + 1e-5f) + slack;
  const float ey = sqrtf(q * ca / det) * (1.0f + 1e-5f) + slack;
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int first = pixel_of(32 * w), last = pixel_of(32 * w + 31);
    const bool clear =
        static_cast<float>(first % BLEND_TILE) > mx + ex ||
        static_cast<float>(last % BLEND_TILE) < mx - ex ||
        static_cast<float>(first / BLEND_TILE) > my + ey ||
        static_cast<float>(last / BLEND_TILE) < my - ey;
    if (!clear) mask |= 1u << w;
  }
  return mask;
}

// A staged pair of the single-chain blends (kernels 5, 5q, 6, 8): q[0] =
// (mx, my, ca, cb), q[1] = (cc, op, r, g), q[2] = (b, blocks, -, -),
// blocks the bits of window_blocks.
struct alignas(16) PairRec {
  float4 q[3];
};
constexpr int PAIR_REC = 12;   // floats a PairRec

// A staged record's window blocks into q[2].y; (ox, oy) is the tile's
// origin in the record's coordinates. `slack` covers the rounding of the
// kernels' offsets dx = mx - px, dy = my - py (2^-23 of the coordinates)
// and of the tile-local mean here.
__device__ inline void mark_blocks(PairRec& r, float ox, float oy,
                                   float power_cutoff) {
  const float4 q0 = r.q[0];
  const float slack =
      1e-3f + 5e-7f * (fabsf(q0.x) + fabsf(q0.y) + ox + oy + 32.0f);
  r.q[2].y = __uint_as_float(window_blocks(
      q0.x - ox, q0.y - oy, q0.z, q0.w, r.q[1].x, power_cutoff, slack));
}

// The next tile of a persistent block, taken from order[] by the atomic
// counter; -1 once every tile is taken. slot: 2 ints of shared memory,
// used in turn (it = the block's iteration), so one barrier a call
// suffices. Block-uniform.
__device__ inline int next_tile(const int* __restrict__ order, int* counter,
                                int num_tiles, int* slot, int it) {
  if (threadIdx.x == 0) {
    const int k = atomicAdd(counter, 1);
    slot[it & 1] = k < num_tiles ? order[k] : -1;
  }
  __syncthreads();
  return slot[it & 1];
}

// Quarter-octave bucket of a segment length; 0 for an empty segment.
__device__ inline int length_bucket(int len) {
  if (len <= 0) return 0;
  const int lg = 31 - __clz(len);
  const int frac = lg >= 2 ? (len >> (lg - 2)) & 3 : (len << (2 - lg)) & 3;
  return min(1 + 4 * lg + frac, BUCKETS - 1);
}

// One block: order[] = the tiles by descending length bucket of their
// segments [seg_start[t], seg_end[t]) (a counting sort; the order within
// a bucket is whatever the shared atomics give, which changes no output),
// and *counter = 0. Pass seg_end = seg_start + 1 for the (T + 1,) bounds
// of a train segment list.
__global__ void __launch_bounds__(ORDER_THREADS)
order_kernel(const int* __restrict__ seg_start,
             const int* __restrict__ seg_end, int num_tiles,
             int* __restrict__ order, int* __restrict__ counter) {
  __shared__ int cursor[BUCKETS];
  for (int b = threadIdx.x; b < BUCKETS; b += ORDER_THREADS) cursor[b] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += ORDER_THREADS)
    atomicAdd(&cursor[length_bucket(seg_end[t] - seg_start[t])], 1);
  __syncthreads();
  // The longest bucket first: thread i scans bucket BUCKETS - 1 - i.
  const int b = BUCKETS - 1 - static_cast<int>(threadIdx.x);
  const int v = b >= 0 ? cursor[b] : 0;
  int total;
  const int first = block_exclusive_scan<ORDER_THREADS>(v, &total);
  if (b >= 0) cursor[b] = first;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += ORDER_THREADS)
    order[atomicAdd(&cursor[length_bucket(seg_end[t] - seg_start[t])],
                    1)] = t;
  if (threadIdx.x == 0) *counter = 0;
}

// scratch (num_tiles + 1 ints): the tile order, then the tile counter.
inline cudaError_t tile_order(const int* seg_start, const int* seg_end,
                              int num_tiles, int* scratch, cudaStream_t s) {
  order_kernel<<<1, ORDER_THREADS, 0, s>>>(seg_start, seg_end, num_tiles,
                                           scratch, scratch + num_tiles);
  return cudaGetLastError();
}

// *blocks = the blocks of `kernel` (threads a block, smem bytes of
// dynamic shared memory, which it is allowed first where that exceeds
// the default 48 KB) resident on the current device at once: the
// persistent grid's size. cache[dev] keeps it per device; the caller owns
// one cache (MAX_DEVICES ints, zeroed) per kernel.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, int* cache,
                                   int* blocks, size_t smem = 0) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

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
