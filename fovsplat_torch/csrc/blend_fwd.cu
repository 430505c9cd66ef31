// Kernels 5 and 6 of the train step: the single-chain tile blend, forward
// and backward.
//
// Forward, replaces fovsplat/ops/pallas/blend_fwd.py:472 _forward (the
// exact f32 train mode). One thread per pixel walks its tile's segment of
// the sorted pair list front to back. Rules (blend_fwd.py:129-143,
// 234-242; forward.cu:380-426):
//   alpha = min(0.99, op * exp(power)); skip when power > 0, power <
//   power_cutoff or alpha < 1/255; a pixel freezes BEFORE blending the
//   pair that would take T below 1e-4; the block stops once every pixel
//   is frozen (__syncthreads_count).
// Out: colour and final T (T, 4, PIX) and n_contrib (T, PIX), the 1-based
// rank in the segment of the pixel's last contributing pair.
// Bound: operations, each counted on the pair-pixels that need it, as
// kernel 8's (csrc/blend_stats.cu). Per pair and pixel walked before the
// pixel freezes 13 FLOP: the offsets and power 11, the window test 2.
// Where the power lies in the window 4 more: expf, alpha and its test.
// Where the pair contributes 10 more: T and its test 3, the weight 1, the
// colour 6. Per freezing pair 3: T and its test. The pair list is read
// once per tile. The loop issues far more instructions than it does FLOP,
// and a warp walks until its last pixel freezes, so the issue rate and
// idle lanes, not bytes, limit it. Kernel 3's design (common.cuh), measured against the rest by
// tools/ablate_blend_single.py (numbers in PERF.md):
// - a persistent grid of the resident blocks takes the tiles heaviest
//   first (order_kernel over the segment lengths);
// - each warp blends an 8x4 pixel block (fs::pixel_of), so a Gaussian
//   more often covers a warp whole and its pixels freeze together;
// - each pair is staged as a packed 12-float record [mx, my, ca, cb, cc,
//   op, r, g, b, blocks, -, -] (three 128-bit broadcast loads a pair and
//   pixel), through a two-stage cp.async ring of BATCH records: batch
//   k + 1 is in flight while batch k blends, and one barrier a batch,
//   which also counts the live pixels (the early exit);
// - once a record has landed, the thread that copied it marks the warps'
//   pixel blocks its window may reach (fs::window_blocks, a conservative
//   bound that accounts for the f32 rounding of the power), and a warp
//   skips a pair whose window reaches none of its pixels: every lane
//   would have failed the window test.
// The per-pixel arithmetic is the previous design's operation for
// operation, so colour, T and n_contrib are bit-identical to it.
//
// Forward-only inference variant (kernel 5q), replaces the same _forward
// as blend_pallas_fwd_only runs it (blend_fwd.py:947-956, mxu_power=True,
// :349-377). The same schedule and walk over the quantized rows [mx, my,
// P_caca, P_cbcc, OPRGB] of expand_ps1.cu's inference mode, with tile t's
// pairs [seg_start[t], seg_end[t]) (MM-FR empties segments; an empty
// tile sorts last). The ring stages the five raw words of each pair;
// after its copies land, each thread decodes the record it copied in
// place, once per pair (BATCH == THREADS): ca = hi + lo of P_caca, cb and
// cc the halves of P_cbcc, opacity u8 / 255, colour u8 * 2 / 255, and the
// mean moved to tile-local coordinates. The power is then computed
// directly in f32 from the local offsets; the JAX kernel's bf16x2
// bilinear MXU form (blend_fwd.py:182-212, ~2e-4 absolute) is a device of
// the TPU's matrix unit. Its geometry test is kept: power_cutoff <= power
// <= 3e-3 (the decoded bf16 conic need not be positive definite), G =
// exp(min(power, 0)). Bound as the train forward: operations, plus 20 B
// per pair read.
//
// Backward (kernel 6), replaces fovsplat/ops/pallas/blend_fwd.py:833
// _backward. Each pixel walks its tile's pairs back to front from its
// warp's deepest contributing pair and recovers T by division by
// (1 - alpha), clamped at 1 (backward.cu:503; blend_fwd.py:23-27):
// T_before = min(T_after / (1 - a), 1), starting from the saved final T.
// A pair contributed to a pixel iff it passes the alpha tests and its
// rank is below the pixel's n_contrib. The per-pixel arithmetic is the
// previous design's operation for operation. The schedule is the
// forward's:
// - a persistent grid of the resident blocks takes the tiles heaviest
//   first (order_kernel over the segment lengths; ordering by walk depth
//   needed a pass of its own that cost more than it paid);
// - each block finds its tile's deepest contributor (the largest
//   n_contrib), zeroes the rows of the pairs past it and walks from it;
// - each warp blends an 8x4 pixel block (fs::pixel_of);
// - the pairs are staged back to front as packed records through the
//   two-stage cp.async ring, a batch of BWD_BATCH between two barriers
//   (the second frees the one buffer of partials); the thread that copied
//   a record marks its window blocks (fs::mark_blocks) and its warp
//   gathers the marks into one bit a record for each warp;
// - a warp walks only the pairs whose window reaches its pixels, below
//   its own largest n_contrib: no lane would contribute to the others,
//   and T and S change only where a lane does.
// No warp-wide operation runs per pair: each lane writes a walked pair's
// nine values (zeros where it does not contribute) into its warp's
// buffer, and every BWD_GROUP pairs one lane per (pair, row) adds the 32
// values in a fixed tree (warp_partials) into the warp's partial. After
// the next batch barrier one pass adds each pair's partials in warp order
// over the warps that walked it and writes its nine rows once. The order
// is fixed and there are no float atomics, so gradients are
// deterministic. Each pair belongs to one tile, so one block owns its
// rows; lanes past the last segment are zeroed by a second launch. The
// TPU kernel's read-merge-write of boundary chunks is a device of its
// chunked DMA and has no counterpart here. The walk is issue-bound: per
// walked pair a warp issues ~150 instructions (two IEEE divisions, expf,
// the nine terms and their reduction) at 4 blocks an SM, which the 64
// registers and the shared memory allow.
// Bound: the larger of bytes and operations, each operation counted on
// the pair-pixels that need it (blend_backward_plain's return_work). Per
// pair and pixel up to the pixel's last contributor 13 FLOP: the offsets
// and power 11, the window test 2. Where the power lies in the window 4
// more: expf, alpha and its test. Where the pair contributes 48 more: the
// T recovery 3, w 1, the colour dot 5, dL/dalpha 4, S 2, d_power 1, the
// nine terms 23 and one add each for their sum over the pixels 9. Bytes:
// 72 B per pair (rows in, gradients out) and 24 B per pixel.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = fs::BLEND_TILE;
constexpr int PIX = TILE * TILE;
constexpr int NWARPS = PIX / 32;
constexpr int THREADS = PIX;   // one pixel a thread
// Forward ring: BATCH records a stage, one a thread, so that each thread
// decodes (5q) the record whose rows it copied; REC floats a record.
constexpr int BATCH = THREADS;
constexpr int STAGES = 2;
constexpr int REC = fs::PAIR_REC;
using Rec = fs::PairRec;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
// Pair rows (ops/kernels/expand_ps1.py ATTR_ROWS, the first nine).
constexpr int NROWS = 9;
enum Attr { A_MX = 0, A_MY, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B };
// Fin rows of the backward: cotangents of r, g, b and T, and the final T.
enum Fin { F_GR = 0, F_GG, F_GB, F_GT, F_TF, NFIN };
// The backward's ring stage (records), the walked pairs a warp reduces
// at once (one of their rows a lane), and the padded row of its
// buffer: a multiple of 4 floats, so that a lane reads a row as float4s,
// 4 past a multiple of 32, so that those reads meet no bank conflict.
constexpr int BWD_BATCH = 64;
constexpr int BWD_GROUP = 3;
constexpr int VSTRIDE = 36;
constexpr unsigned FULL = 0xffffffffu;
// Quantized rows (ops/kernels/expand_ps1.py Q_ROWS) and their decoding.
enum QRow { Q_MX = 0, Q_MY, Q_CACA, Q_CBCC, Q_OPRGB, QROWS };
constexpr float C_OP = 1.0f / 255.0f;
constexpr float C_COL = 2.0f / 255.0f;
constexpr float POWER_MAX_Q = 3e-3f;

__device__ inline float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xFFFF0000u);
}
__device__ inline float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }

// Kernel 5q's decoding of a record staged raw (the five quantized words
// in slots 0-4), in place, with the mean moved to tile-local
// coordinates.
__device__ inline void decode_q(Rec& r, float tx0, float ty0) {
  const float4 raw = r.q[0];
  const unsigned caca = __float_as_uint(raw.z);
  const unsigned cbcc = __float_as_uint(raw.w);
  const unsigned q = __float_as_uint(r.q[1].x);
  r.q[0] = make_float4(raw.x - tx0, raw.y - ty0,
                       bf16_hi(caca) + bf16_lo(caca), bf16_hi(cbcc));
  r.q[1] = make_float4(bf16_lo(cbcc), static_cast<float>(q >> 24) * C_OP,
                       static_cast<float>((q >> 16) & 255u) * C_COL,
                       static_cast<float>((q >> 8) & 255u) * C_COL);
  r.q[2].x = static_cast<float>(q & 255u) * C_COL;
}

// Tile t's pairs [start, end) blended into its pixels. Q = false: the
// train forward over the nine f32 rows, pixels in image coordinates.
// Q = true: kernel 5q over the quantized rows, in tile-local coordinates.
template <bool Q>
__device__ inline void blend_fwd_tile(const float* __restrict__ pairs,
                                      int cap, int start, int end, int t,
                                      int grid_x, float power_cutoff,
                                      float* __restrict__ out,
                                      int* __restrict__ n_contrib,
                                      Rec (*ring)[BATCH]) {
  constexpr int ROWS = Q ? QROWS : NROWS;
  constexpr float power_max = Q ? POWER_MAX_Q : 0.0f;
  const int p = fs::pixel_of(threadIdx.x);
  const float tx0 = static_cast<float>((t % grid_x) * TILE);
  const float ty0 = static_cast<float>((t / grid_x) * TILE);
  const float px = Q ? static_cast<float>(p % TILE)
                     : static_cast<float>((t % grid_x) * TILE + p % TILE);
  const float py = Q ? static_cast<float>(p / TILE)
                     : static_cast<float>((t / grid_x) * TILE + p / TILE);
  const unsigned warp_bit = 1u << (threadIdx.x >> 5);
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int nc = 0;
  bool done = false;

  const int count = max(end - start, 0);
  const int nb = (count + BATCH - 1) / BATCH;
  if (nb > 0)
    fs::stage_records<ROWS, REC>(
        pairs, cap, start, min(BATCH, count),
        reinterpret_cast<float*>(ring[0]));
  for (int b = 0; b < nb; ++b) {
    const int m = min(BATCH, count - b * BATCH);
    // Batch b has landed (this thread's copies); each thread decodes (5q)
    // and marks the record it copied. After the barrier every record is
    // visible and batch b - 1's stage is free.
    fs::cp_async_wait_all();
    if (static_cast<int>(threadIdx.x) < m) {
      Rec& r = ring[b & 1][threadIdx.x];
      if (Q) decode_q(r, tx0, ty0);
      fs::mark_blocks(r, Q ? 0.0f : tx0, Q ? 0.0f : ty0, power_cutoff);
    }
    if (__syncthreads_count(!done) == 0) break;
    if (b + 1 < nb) {
      const int next = (b + 1) * BATCH;
      fs::stage_records<ROWS, REC>(
          pairs, cap, start + next, min(BATCH, count - next),
          reinterpret_cast<float*>(ring[(b + 1) & 1]));
    }
    const Rec* recs = ring[b & 1];
    for (int j = 0; j < m && !done; ++j) {
      const float4 q2 = recs[j].q[2];
      if (!(__float_as_uint(q2.y) & warp_bit)) continue;  // whole warp
      const float4 q0 = recs[j].q[0], q1 = recs[j].q[1];
      const float dx = q0.x - px;
      const float dy = q0.y - py;
      const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                          q0.w * dx * dy;
      if (!(power <= power_max && power >= power_cutoff)) continue;  // NaN
      const float a = fminf(ALPHA_MAX, q1.y * expf(fminf(power, 0.0f)));
      if (!(a >= ALPHA_MIN)) continue;
      const float test = T * (1.0f - a);
      if (test < T_EPS) {
        done = true;
        break;
      }
      const float w = a * T;
      cr += q1.z * w;
      cg += q1.w * w;
      cb += q2.x * w;
      T = test;
      nc = b * BATCH + j + 1;
    }
  }
  float* o = out + static_cast<size_t>(t) * 4 * PIX + p;
  o[0 * PIX] = cr;
  o[1 * PIX] = cg;
  o[2 * PIX] = cb;
  o[3 * PIX] = T;
  n_contrib[t * PIX + p] = nc;
}

// Persistent blocks take tiles from the counter *next_tile in the order
// of fs::order_kernel until every tile is blended. Tile t's pairs are
// [seg_start[t], seg_end[t]); the train forward passes seg_end =
// seg_start + 1.
template <bool Q>
__global__ void __launch_bounds__(THREADS)
blend_fwd_kernel(const float* __restrict__ pairs, int cap,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ seg_end,
                 const int* __restrict__ order, int* __restrict__ next_tile,
                 int num_tiles, int grid_x, float power_cutoff,
                 float* __restrict__ out, int* __restrict__ n_contrib) {
  __shared__ Rec ring[STAGES][BATCH];
  __shared__ int tile_slot[2];
  for (int it = 0;; ++it) {
    const int t = fs::next_tile(order, next_tile, num_tiles, tile_slot, it);
    if (t < 0) return;
    blend_fwd_tile<Q>(pairs, cap, seg_start[t], seg_end[t], t, grid_x,
                      power_cutoff, out, n_contrib, ring);
  }
}

// The backward's shared memory: the ring; per stage, the pairs of the
// batch whose window reaches each warp's pixels (bit k of word i of
// warp w: record 32 i + k); one batch's per-warp partials (pair k's row r
// from warp w at part[r][w][k]) with the pairs each warp walked (bit k of
// word i of used[w]: pair 32 i + k); each warp's value buffer; each
// warp's largest n_contrib. One buffer of partials and a second barrier
// a batch leave room for four blocks an SM.
struct BwdShared {
  Rec ring[STAGES][BWD_BATCH];
  unsigned reach[STAGES][NWARPS][BWD_BATCH / 32];
  float part[NROWS][NWARPS][BWD_BATCH];
  unsigned used[NWARPS][BWD_BATCH / 32];
  alignas(16) float vbuf[NWARPS][BWD_GROUP * NROWS * VSTRIDE];
  int warp_max[NWARPS];
  int tile_slot[2];
};
static_assert(BWD_BATCH % 32 == 0 && BWD_BATCH <= THREADS, "whole words");
static_assert(BWD_GROUP * NROWS <= 32, "a lane a row");

// One warp's partials of the g pairs in its buffer (row r of slot jj,
// lane l at vb[(jj * NROWS + r) * VSTRIDE + l]; lane jj of slot_pair
// holds slot jj's pair): lane jj * NROWS + r adds the 32 values of row r
// of slot jj in a fixed order and writes the warp's partial.
__device__ inline void warp_partials(const float* vb, int g, int slot_pair,
                                     int lane, int warp, float* part) {
  const int jj = lane / NROWS, r = lane - jj * NROWS;
  const int k = __shfl_sync(FULL, slot_pair, jj);
  if (jj < g) {
    // A fixed tree over the lanes, (l0 + l1) + (l2 + l3) and so on.
    const float4* src = reinterpret_cast<const float4*>(vb + lane * VSTRIDE);
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 x = src[e];
      s[e] = (x.x + x.y) + (x.z + x.w);
    }
#pragma unroll
    for (int h = 4; h > 0; h >>= 1) {
#pragma unroll
      for (int e = 0; e < h; ++e) s[e] = s[2 * e] + s[2 * e + 1];
    }
    part[(r * NWARPS + warp) * BWD_BATCH + k] = s[0];
  }
}

// The warp's values of pair k into its buffer's next slot; a full buffer
// is reduced into the partials.
__device__ inline void push_pair(const float* v, int k, float* vb,
                                 int& slot, int& slot_pair, int lane,
                                 int warp, float* part) {
#pragma unroll
  for (int r = 0; r < NROWS; ++r) vb[(slot * NROWS + r) * VSTRIDE + lane] = v[r];
  if (lane == slot) slot_pair = k;
  if (++slot == BWD_GROUP) {
    __syncwarp();
    warp_partials(vb, slot, slot_pair, lane, warp, part);
    __syncwarp();   // vb is rewritten by the next group
    slot = 0;
  }
}

// The gradient rows of the batch's pairs [lo, lo + m): each pair's
// partials in warp order over the warps that walked it, 0 where none did.
__device__ inline void write_rows(const float* part,
                                  const unsigned (*used)[BWD_BATCH / 32],
                                  float* __restrict__ grads, int cap, int lo,
                                  int m) {
  for (int i = threadIdx.x; i < NROWS * m; i += THREADS) {
    const int r = i / m, k = i - r * m;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      if ((used[w][k >> 5] >> (k & 31)) & 1u)
        s += part[(r * NWARPS + w) * BWD_BATCH + k];
    grads[static_cast<size_t>(r) * cap + lo + k] = s;
  }
}

// Tile t's gradient rows of its pairs [start, end).
__device__ inline void bwd_tile(const float* __restrict__ pairs, int cap,
                                int start, int end, int t, int grid_x,
                                float power_cutoff,
                                const float* __restrict__ fin,
                                const int* __restrict__ n_contrib,
                                float* __restrict__ grads, BwdShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = fs::pixel_of(threadIdx.x);
  const float tx0 = static_cast<float>((t % grid_x) * TILE);
  const float ty0 = static_cast<float>((t / grid_x) * TILE);
  const float px = static_cast<float>((t % grid_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / grid_x) * TILE + p / TILE);
  const float* f = fin + static_cast<size_t>(t) * NFIN * PIX + p;
  const float g_r = f[F_GR * PIX], g_g = f[F_GG * PIX], g_b = f[F_GB * PIX];
  const float gT_Tf = f[F_GT * PIX] * f[F_TF * PIX];
  const int nc = n_contrib[t * PIX + p];
  const int wmax = __reduce_max_sync(FULL, nc);
  float* vb = sh.vbuf[warp];
  float T = f[F_TF * PIX];   // T after the pixel's last contributing pair
  float S = 0.0f;            // sum over deeper pairs of w * (colour . g)

  // The walk starts at the tile's deepest contributor; the rows past it
  // are zero.
  if (lane == 0) sh.warp_max[warp] = wmax;
  __syncthreads();
  int max_nc = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) max_nc = max(max_nc, sh.warp_max[w]);
  const int deep = min(end, start + max_nc);
  for (int i = deep + static_cast<int>(threadIdx.x); i < end; i += THREADS) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) grads[static_cast<size_t>(r) * cap + i] = 0.0f;
  }

  // Batch b: the pairs [lo_b, hi_b), hi_b = deep - b * BWD_BATCH.
  const int count = max(deep - start, 0);
  const int nb = (count + BWD_BATCH - 1) / BWD_BATCH;
  if (nb > 0) {
    const int lo = max(start, deep - BWD_BATCH);
    fs::stage_records<NROWS, REC>(pairs, cap, lo, deep - lo,
                                  reinterpret_cast<float*>(sh.ring[0]));
  }
  int prev_lo = 0, prev_m = 0;   // batch b - 1
  for (int b = 0;; ++b) {
    // Batch b has landed (this thread's copies); each thread marks the
    // record it copied, and its warp gathers the marks into each warp's
    // reach words. After the barrier every record and word is visible,
    // batch b - 1's partials are complete and its ring stage is free;
    // after the second, its partials are written out.
    const int hi = deep - b * BWD_BATCH;
    const int lo = max(start, hi - BWD_BATCH);
    const int m = b < nb ? hi - lo : 0;
    fs::cp_async_wait_all();
    if (static_cast<int>(threadIdx.x) < BWD_BATCH && m > 0) {
      unsigned blocks = 0u;
      if (static_cast<int>(threadIdx.x) < m) {
        Rec& r = sh.ring[b & 1][threadIdx.x];
        fs::mark_blocks(r, tx0, ty0, power_cutoff);
        blocks = __float_as_uint(r.q[2].y);
      }
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const unsigned bits = __ballot_sync(FULL, (blocks >> w) & 1u);
        if (lane == w) sh.reach[b & 1][w][warp] = bits;
      }
    }
    __syncthreads();
    if (b > 0)
      write_rows(&sh.part[0][0][0], sh.used, grads, cap, prev_lo, prev_m);
    if (b == nb) break;
    prev_lo = lo;
    prev_m = m;
    if (b + 1 < nb) {
      const int nlo = max(start, lo - BWD_BATCH);
      fs::stage_records<NROWS, REC>(
          pairs, cap, nlo, lo - nlo,
          reinterpret_cast<float*>(sh.ring[(b + 1) & 1]));
    }
    if (b > 0) __syncthreads();
    const Rec* recs = sh.ring[b & 1];
    float* part = &sh.part[0][0][0];
    const int rank0 = lo - start;
    // The warp walks, from the last, the pairs whose window reaches its
    // pixels below its largest n_contrib (at or past it no lane
    // contributes), 32 a word.
    const int kmax = min(m, wmax - rank0);
    int slot = 0, slot_pair = 0;
#pragma unroll 1
    for (int i = BWD_BATCH / 32 - 1; i >= 0; --i) {
      const int lim = kmax - 32 * i;
      const unsigned reach = sh.reach[b & 1][warp][i];
      const unsigned walk = lim <= 0 ? 0u : lim >= 32 ? reach
                                          : reach & ((1u << lim) - 1u);
      if (lane == 0) sh.used[warp][i] = walk;
      for (unsigned todo = walk; todo;) {
        const int bit = 31 - __clz(todo);
        todo ^= 1u << bit;
        const int k = 32 * i + bit;
        const float4 q0 = recs[k].q[0], q1 = recs[k].q[1];
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                            q0.w * dx * dy;
        bool contrib = false;
        float G = 0.0f, a = 0.0f;
        if (power <= 0.0f && power >= power_cutoff && rank0 + k < nc) {
          G = expf(power);
          a = fminf(ALPHA_MAX, q1.y * G);
          contrib = a >= ALPHA_MIN;
        }
        float v[NROWS];
  #pragma unroll
        for (int r = 0; r < NROWS; ++r) v[r] = 0.0f;
        if (contrib) {
          const float b_ = recs[k].q[2].x;
          const float om = 1.0f - a;
          const float Tj = fminf(T / om, 1.0f);
          const float w = a * Tj;
          const float gc = g_r * q1.z + g_g * q1.w + g_b * b_;
          const float dL_da = gc * Tj - (S + gT_Tf) / om;
          S += w * gc;
          T = Tj;
          const float d_power = a * dL_da;
          const float ca = q0.z, cb = q0.w, cc = q1.x;
          v[A_MX] = d_power * (-(ca * dx + cb * dy));
          v[A_MY] = d_power * (-(cc * dy + cb * dx));
          v[A_CA] = d_power * (-0.5f * dx * dx);
          v[A_CB] = d_power * (-dx * dy);
          v[A_CC] = d_power * (-0.5f * dy * dy);
          v[A_OP] = G * dL_da;
          v[A_R] = w * g_r;
          v[A_G] = w * g_g;
          v[A_B] = w * g_b;
        }
        push_pair(v, k, vb, slot, slot_pair, lane, warp, part);
      }
    }
    if (slot > 0) {
      __syncwarp();
      warp_partials(vb, slot, slot_pair, lane, warp, part);
      __syncwarp();
    }
  }
}

// Persistent blocks take tiles from the counter *next_tile in the order
// of fs::order_kernel until every tile is done.
__global__ void __launch_bounds__(THREADS)
blend_bwd_kernel(const float* __restrict__ pairs, int cap,
                 const int* __restrict__ seg_start,
                 const int* __restrict__ order, int* __restrict__ next_tile,
                 int num_tiles, int grid_x, float power_cutoff,
                 const float* __restrict__ fin,
                 const int* __restrict__ n_contrib,
                 float* __restrict__ grads) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(smem);
  for (int it = 0;; ++it) {
    const int t = fs::next_tile(order, next_tile, num_tiles, sh.tile_slot,
                                it);
    if (t < 0) return;
    bwd_tile(pairs, cap, seg_start[t], seg_start[t + 1], t, grid_x,
             power_cutoff, fin, n_contrib, grads, sh);
  }
}

// Zero the gradient rows of lanes past the last segment.
__global__ void zero_tail_kernel(float* __restrict__ grads, int cap,
                                 const int* __restrict__ num_pairs) {
  const int first = *num_pairs;
  for (int i = first + blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) grads[static_cast<size_t>(r) * cap + i] = 0.0f;
  }
}

}  // namespace

namespace {

// The forward of either kind: the tile order, then the persistent blend.
// scratch: num_tiles + 1 ints (the tile order and the tile counter).
template <bool Q>
int launch_fwd(const float* pairs, int cap, const int* seg_start,
               const int* seg_end, int num_tiles, int grid_x,
               float power_cutoff, int* scratch, float* out, int* n_contrib,
               void* stream) {
  if (num_tiles < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident[fs::MAX_DEVICES];
  int blocks = 0;
  cudaError_t err = fs::resident_blocks(blend_fwd_kernel<Q>, THREADS,
                                        resident, &blocks);
  if (err != cudaSuccess) return err;
  err = fs::tile_order(seg_start, seg_end, num_tiles, scratch, s);
  if (err != cudaSuccess) return err;
  blend_fwd_kernel<Q><<<min(num_tiles, blocks), THREADS, 0, s>>>(
      pairs, cap, seg_start, seg_end, scratch, scratch + num_tiles,
      num_tiles, grid_x, power_cutoff, out, n_contrib);
  return cudaGetLastError();
}

}  // namespace

FS_EXPORT int fs_blend_fwd(const float* pairs, int cap, const int* seg_start,
                           int num_tiles, int grid_x, float power_cutoff,
                           int* scratch, float* out, int* n_contrib,
                           void* stream) {
  return launch_fwd<false>(pairs, cap, seg_start, seg_start + 1, num_tiles,
                           grid_x, power_cutoff, scratch, out, n_contrib,
                           stream);
}

FS_EXPORT int fs_blend_fwd_q(const float* pairs, int cap,
                             const int* seg_start, const int* seg_end,
                             int num_tiles, int grid_x, float power_cutoff,
                             int* scratch, float* out, int* n_contrib,
                             void* stream) {
  return launch_fwd<true>(pairs, cap, seg_start, seg_end, num_tiles, grid_x,
                          power_cutoff, scratch, out, n_contrib, stream);
}

// scratch: num_tiles + 1 ints (the tile order and the tile counter).
FS_EXPORT int fs_blend_bwd(const float* pairs, int cap, const int* seg_start,
                           int num_tiles, int grid_x, float power_cutoff,
                           const float* fin, const int* n_contrib,
                           int* scratch, float* grads, void* stream) {
  if (num_tiles < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int resident[fs::MAX_DEVICES];
  int blocks = 0;
  cudaError_t err = fs::resident_blocks(blend_bwd_kernel, THREADS, resident,
                                        &blocks, sizeof(BwdShared));
  if (err != cudaSuccess) return err;
  err = fs::tile_order(seg_start, seg_start + 1, num_tiles, scratch, s);
  if (err != cudaSuccess) return err;
  blend_bwd_kernel<<<min(num_tiles, blocks), THREADS, sizeof(BwdShared), s>>>(
      pairs, cap, seg_start, scratch, scratch + num_tiles, num_tiles, grid_x,
      power_cutoff, fin, n_contrib, grads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int zblocks = cap < 1024 * 256 ? (cap + 255) / 256 : 1024;
  zero_tail_kernel<<<zblocks, 256, 0, s>>>(grads, cap, seg_start + num_tiles);
  return cudaGetLastError();
}
