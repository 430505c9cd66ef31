// Kernel 1: the per-Gaussian table build, fov mode (the foveated frames)
// and ps1 mode (the single-level inference frame).
//
// Replaces fovsplat/ops/pallas/build_table.py:391 build_fov_table_pallas.
// One thread per Gaussian reads the packed model (geometry f32, SH / DC /
// opacity bf16), runs the EWA projection, the tile rect, the OBB axes,
// the conic and the degree-3 SH sum, and writes one column of an f32 SoA
// table. The exclusive cumsum of the tiles touched is fused in: a
// block-local scan here, then common.cuh's carry pass.
//
//   fov mode (row layout in fovsplat_torch/ops/kernels/build_table.py):
//     the rect is clipped to the bbox of the tiles the Gaussian's highest
//     level reaches (L levels), and the table holds L_lay levels of
//     opacity and colour: L_lay = L for "ours", L_lay = 1 for the SM-FR
//     shared layout, whose cull still runs at L levels
//     (build_table.py:95-98, fov_num / fov_num_bbox);
//   ps1 mode (build_table.py:227-229, 337-339, 370-379; the row layout of
//     fovsplat_torch/ops/kernels/expand_ps1.py ps1_table): no level clip
//     and no hl gate, the SH's k = 0 slot holds the DC, one opacity; the
//     columns are sanitised as ps1_table does, so kernel 4 reads the
//     table unchanged. Given an owned-tile box (an MM-FR level pass,
//     eval/mmfr.py), the rect is clipped to it as fov mode clips to a
//     level's box, and a row whose opacity is below 1/255 is culled
//     (renderCUDA_mmfr's dead-opacity test); a template argument, so the
//     frame without a box runs the code it ran before.
//
// Bound: bytes. Per Gaussian, fov mode at degree 3 and L = 4 reads 44 B of
// geometry and 128 B of bf16 colour rows and writes (18 + 4L) x 4 + 4 =
// 140 B; ps1 mode reads 40 + 98 B and writes 84 B: ~500 FLOP against
// ~250 B, far below the card's ratio. The design keeps everything per
// Gaussian in registers and reads each input row once, coalesced (N-last
// layout: thread i reads column i).
//
// The projection is project_sh.cuh's ewa and columns (kernel 10's): they
// mirror fovsplat_torch/ops/projection.py operation for operation, NaN
// rules included; with -fmad=false (see _build.py) the integer rect
// columns match the plain version exactly. Deviation from the TPU
// kernel: the OBB extents are zeroed from the PRE-clip tile count (as
// projection.preprocess_cols and the XLA binning do), not the post-clip
// one (build_table.py:259).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "project_sh.cuh"

namespace {

using namespace psh;   // the projection and its constants, shared with
                       // kernel 10 (project_sh.cu)

// fov table rows (ops/kernels/build_table.py ROW_*).
enum Row {
  R_RX0 = 0, R_RY0, R_RW, R_TNUM, R_MX, R_MY, R_V1X, R_V1Y, R_V2X, R_V2Y,
  R_LEN1, R_LEN2, R_CA, R_CB, R_CC, R_HL, R_DEPTH, R_VALID, R_LEVEL
};
// ps1 table rows (ops/kernels/expand_ps1.py ROW_*).
enum Ps1Row {
  P_RX0 = 0, P_RY0, P_RW, P_TNUM, P_MX, P_MY, P_V1X, P_V1Y, P_V2X, P_V2Y,
  P_LEN1, P_LEN2, P_CA, P_CB, P_CC, P_OP, P_R, P_G, P_B, P_DEPTH
};

// preprocess_cols for Gaussian i, up to the unclipped tile rect: valid
// and tnum before any level clip.
__device__ inline Cols project(const float* __restrict__ xyz,
                               const float* __restrict__ scales,
                               const float* __restrict__ rot,
                               const float* __restrict__ cam, int i,
                               int grid_x, int grid_y, int width, int height,
                               float scale_modifier) {
  const float m[3] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
  const float s[3] = {scales[3 * i], scales[3 * i + 1], scales[3 * i + 2]};
  const float q[4] = {rot[4 * i], rot[4 * i + 1], rot[4 * i + 2],
                      rot[4 * i + 3]};
  return columns(ewa(cam, m, s, q, scale_modifier), true, grid_x, grid_y,
                 width, height);
}

// The degree-`sh_degree` SH sum + 0.5 of channel c, k = 0 included (the
// fov model's k = 0 slot is zero, the ps1 model's holds the DC).
__device__ inline void sh_sum(const __nv_bfloat16* __restrict__ sh_t, int n,
                              int k_sh, int i, int sh_degree,
                              const float* __restrict__ cam,
                              const float* __restrict__ xyz, float out[3]) {
  const float dxc = xyz[3 * i] - cam[C_CAM];
  const float dyc = xyz[3 * i + 1] - cam[C_CAM + 1];
  const float dzc = xyz[3 * i + 2] - cam[C_CAM + 2];
  const float inv_n = rsqrtf(fmaxf(dxc * dxc + dyc * dyc + dzc * dzc,
                                   1e-20f));
  const float dx = dxc * inv_n, dy = dyc * inv_n, dz = dzc * inv_n;
  const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
  const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const __nv_bfloat16* s = sh_t + static_cast<size_t>(c) * k_sh * n;
    auto cf = [&](int k) {
      return __bfloat162float(s[static_cast<size_t>(k) * n + i]);
    };
    float r = SH_C0 * cf(0);
    if (sh_degree > 0) {
      r = r - SH_C1 * dy * cf(1) + SH_C1 * dz * cf(2) - SH_C1 * dx * cf(3);
      if (sh_degree > 1) {
        r = r + SH_C2_0 * xy * cf(4) + SH_C2_1 * yz * cf(5) +
            SH_C2_2 * (2.0f * zz - xx - yy) * cf(6) +
            SH_C2_3 * xz * cf(7) + SH_C2_4 * (xx - yy) * cf(8);
        if (sh_degree > 2) {
          r = r + SH_C3_0 * dy * (3.0f * xx - yy) * cf(9) +
              SH_C3_1 * xy * dz * cf(10) +
              SH_C3_2 * dy * (4.0f * zz - xx - yy) * cf(11) +
              SH_C3_3 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy) * cf(12) +
              SH_C3_4 * dx * (4.0f * zz - xx - yy) * cf(13) +
              SH_C3_5 * dz * (xx - yy) * cf(14) +
              SH_C3_6 * dx * (xx - 3.0f * yy) * cf(15);
        }
      }
    }
    out[c] = r + 0.5f;
  }
}

// Fov mode: per-level rect clip (L levels), L_lay colour levels.
__global__ void __launch_bounds__(fs::SCAN_BLOCK)
build_table_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ scales,
                   const float* __restrict__ rot,
                   const float* __restrict__ hl_in,
                   const __nv_bfloat16* __restrict__ rest_t,
                   const __nv_bfloat16* __restrict__ dc_t,
                   const __nv_bfloat16* __restrict__ opac_t,
                   const float* __restrict__ cam,
                   const int* __restrict__ bbox,
                   int n, int L, int L_lay, int k_rest, int grid_x,
                   int grid_y, int width, int height, float scale_modifier,
                   int sh_degree, float* __restrict__ table,
                   int* __restrict__ cum, int* __restrict__ block_sums) {
  const int i = blockIdx.x * fs::SCAN_BLOCK + threadIdx.x;
  int tnum_out = 0;
  if (i < n) {
    const Cols q = project(xyz, scales, rot, cam, i, grid_x, grid_y, width,
                           height, scale_modifier);

    // --- per-level rect clip (fov_soa_cols); hl < 0 marks a dead row.
    // The OBB extents keep the pre-clip tile count (see header) ---
    const float hl = hl_in[i];
    const int hli = min(max(static_cast<int>(hl), 0), L - 1);
    const int rx0 = max(q.rx0, bbox[hli]);
    const int ry0 = max(q.ry0, bbox[L + hli]);
    int rx1 = min(q.rx1, bbox[2 * L + hli]);
    const int ry1 = min(q.ry1, bbox[3 * L + hli]);
    const int tnum = max(rx1 - rx0, 0) * max(ry1 - ry0, 0);
    const bool valid = q.valid && tnum > 0 && hl >= 0.0f;
    rx1 = max(rx1, rx0);
    tnum_out = valid ? tnum : 0;

    float rest_c[3];
    sh_sum(rest_t, n, k_rest, i, sh_degree, cam, xyz, rest_c);

    // --- table column; invalid rows are sanitised (build_table.py:240-284)
    auto put = [&](int row, float v) {
      table[static_cast<size_t>(row) * n + i] = v;
    };
    put(R_RX0, valid ? static_cast<float>(rx0) : 0.0f);
    put(R_RY0, valid ? static_cast<float>(ry0) : 0.0f);
    put(R_RW, valid ? static_cast<float>(max(rx1 - rx0, 1)) : 1.0f);
    put(R_TNUM, static_cast<float>(tnum_out));
    put(R_MX, valid ? q.px : 0.0f);
    put(R_MY, valid ? q.py : 0.0f);
    put(R_V1X, valid ? q.v1x : 0.0f);
    put(R_V1Y, valid ? q.v1y : 0.0f);
    put(R_V2X, valid ? q.v2x : 0.0f);
    put(R_V2Y, valid ? q.v2y : 0.0f);
    put(R_LEN1, valid ? q.len1 : 0.0f);
    put(R_LEN2, valid ? q.len2 : 0.0f);
    put(R_CA, valid ? q.ca : 1.0f);
    put(R_CB, valid ? q.cb : 0.0f);
    put(R_CC, valid ? q.cc : 1.0f);
    put(R_HL, valid ? hl : -2.0f);
    put(R_DEPTH, valid ? q.depth : 1.0f);
    put(R_VALID, valid ? 1.0f : 0.0f);
    for (int l = 0; l < L_lay; ++l) {
      const float op = __bfloat162float(opac_t[static_cast<size_t>(l) * n + i]);
      put(R_LEVEL + l, valid ? op : 0.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dc = __bfloat162float(
            dc_t[(static_cast<size_t>(c) * L_lay + l) * n + i]);
        const float col = fmaxf(SH_C0 * dc + rest_c[c], 0.0f);
        put(R_LEVEL + (1 + c) * L_lay + l, valid ? col : 0.0f);
      }
    }
  }

  // --- exclusive cumsum of tnum: block-local part ---
  int block_total;
  const int excl = fs::block_exclusive_scan(tnum_out, &block_total);
  if (i < n) cum[i] = excl;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = block_total;
}

// Ps1 mode: no level clip, no hl gate; the ps1_table layout. BOX: the
// rect clipped to box (x0, y0, x1, y1) and the dead-opacity cull.
template <bool BOX>
__global__ void __launch_bounds__(fs::SCAN_BLOCK)
build_table_ps1_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ scales,
                       const float* __restrict__ rot,
                       const __nv_bfloat16* __restrict__ sh_t,
                       const __nv_bfloat16* __restrict__ opac,
                       const float* __restrict__ cam,
                       const int* __restrict__ box, int n, int k_sh,
                       int grid_x, int grid_y, int width, int height,
                       float scale_modifier, int sh_degree,
                       float* __restrict__ table, int* __restrict__ cum,
                       int* __restrict__ block_sums) {
  const int i = blockIdx.x * fs::SCAN_BLOCK + threadIdx.x;
  int tnum_out = 0;
  if (i < n) {
    Cols q = project(xyz, scales, rot, cam, i, grid_x, grid_y, width,
                     height, scale_modifier);
    if (BOX) {
      // As fov mode's level clip; the OBB extents keep the pre-clip count.
      q.rx0 = max(q.rx0, box[0]);
      q.ry0 = max(q.ry0, box[1]);
      q.rx1 = min(q.rx1, box[2]);
      q.ry1 = min(q.ry1, box[3]);
      const int tnum = max(q.rx1 - q.rx0, 0) * max(q.ry1 - q.ry0, 0);
      q.valid = q.valid && tnum > 0 &&
                __bfloat162float(opac[i]) >= 1.0f / 255.0f;
      q.tnum = q.valid ? tnum : 0;
      q.rw = max(q.rx1 - q.rx0, 1);
    }
    const bool valid = q.valid;
    tnum_out = q.tnum;
    float col[3];
    sh_sum(sh_t, n, k_sh, i, sh_degree, cam, xyz, col);

    // Sanitised as ps1_table: rw, ca, cc and depth 1, the rest 0.
    auto put = [&](int row, float v, float safe) {
      table[static_cast<size_t>(row) * n + i] = valid ? v : safe;
    };
    put(P_RX0, static_cast<float>(q.rx0), 0.0f);
    put(P_RY0, static_cast<float>(q.ry0), 0.0f);
    put(P_RW, static_cast<float>(q.rw), 1.0f);
    put(P_TNUM, static_cast<float>(tnum_out), 0.0f);
    put(P_MX, q.px, 0.0f);
    put(P_MY, q.py, 0.0f);
    put(P_V1X, q.v1x, 0.0f);
    put(P_V1Y, q.v1y, 0.0f);
    put(P_V2X, q.v2x, 0.0f);
    put(P_V2Y, q.v2y, 0.0f);
    put(P_LEN1, q.len1, 0.0f);
    put(P_LEN2, q.len2, 0.0f);
    put(P_CA, q.ca, 1.0f);
    put(P_CB, q.cb, 0.0f);
    put(P_CC, q.cc, 1.0f);
    put(P_OP, __bfloat162float(opac[i]), 0.0f);
    put(P_R, fmaxf(col[0], 0.0f), 0.0f);
    put(P_G, fmaxf(col[1], 0.0f), 0.0f);
    put(P_B, fmaxf(col[2], 0.0f), 0.0f);
    put(P_DEPTH, q.depth, 1.0f);
  }

  int block_total;
  const int excl = fs::block_exclusive_scan(tnum_out, &block_total);
  if (i < n) cum[i] = excl;
  if (threadIdx.x == 0) block_sums[blockIdx.x] = block_total;
}

}  // namespace

FS_EXPORT int fs_build_table(const float* xyz, const float* scales,
                             const float* rot, const float* hl,
                             const void* rest_t, const void* dc_t,
                             const void* opac_t, const float* cam,
                             const int* bbox, int n, int L, int L_lay,
                             int k_rest, int grid_x, int grid_y, int width,
                             int height, float scale_modifier, int sh_degree,
                             float* table, int* cum, int* block_sums,
                             int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(n);
  build_table_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(
      xyz, scales, rot, hl, static_cast<const __nv_bfloat16*>(rest_t),
      static_cast<const __nv_bfloat16*>(dc_t),
      static_cast<const __nv_bfloat16*>(opac_t), cam, bbox, n, L, L_lay,
      k_rest, grid_x, grid_y, width, height, scale_modifier, sh_degree,
      table, cum, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fs::scan_carry(cum, block_sums, nb, n, total, s);
}

// box: (4,) i32 on the device, or null for the frame without one.
FS_EXPORT int fs_build_table_ps1(const float* xyz, const float* scales,
                                 const float* rot, const void* sh_t,
                                 const void* opac, const float* cam,
                                 const int* box, int n, int k_sh, int grid_x,
                                 int grid_y, int width, int height,
                                 float scale_modifier, int sh_degree,
                                 float* table, int* cum, int* block_sums,
                                 int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(n);
  const auto* sh = static_cast<const __nv_bfloat16*>(sh_t);
  const auto* op = static_cast<const __nv_bfloat16*>(opac);
  if (box != nullptr) {
    build_table_ps1_kernel<true><<<nb, fs::SCAN_BLOCK, 0, s>>>(
        xyz, scales, rot, sh, op, cam, box, n, k_sh, grid_x, grid_y, width,
        height, scale_modifier, sh_degree, table, cum, block_sums);
  } else {
    build_table_ps1_kernel<false><<<nb, fs::SCAN_BLOCK, 0, s>>>(
        xyz, scales, rot, sh, op, cam, box, n, k_sh, grid_x, grid_y, width,
        height, scale_modifier, sh_degree, table, cum, block_sums);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fs::scan_carry(cum, block_sums, nb, n, total, s);
}
