// Kernel 1 of the foveated frame: the per-Gaussian table build.
//
// Replaces fovsplat/ops/pallas/build_table.py:391 build_fov_table_pallas
// (fov mode). One thread per Gaussian reads the packed model (geometry
// f32, SH / DC / opacity bf16), runs the EWA projection, the tile rect and
// its per-level clip, the OBB axes, the conic, the degree-3 SH rest term
// and the per-level colours, and writes one column of an f32 SoA table
// (row layout in fovsplat_torch/ops/kernels/build_table.py). The
// exclusive cumsum of the tiles touched is fused in: a block-local scan
// here, then common.cuh's carry pass.
//
// Bound: bytes. Per Gaussian it reads 44 B of geometry and 128 B of bf16
// colour rows (16 SH slots x 3 channels, 4 DC levels x 3, 4 opacities, at
// degree 3 and L = 4) and writes (18 + 4L) x 4 + 4 = 140 B: ~200 FLOP
// against 312 B, far below the card's ratio. The design keeps everything
// per Gaussian in registers and reads each input row once, coalesced
// (N-last layout: thread i reads column i).
//
// The arithmetic mirrors fovsplat_torch/ops/projection.py operation for
// operation; with -fmad=false (see _build.py) the integer rect columns
// match the plain version exactly. Deviation from the TPU kernel: the
// OBB extents are zeroed from the PRE-clip tile count (as
// projection.preprocess_cols and the XLA binning do), not the post-clip
// one (build_table.py:259).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr float NEAR_CULL_Z = 0.2f;
constexpr float LOWPASS = 0.3f;
constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C2_0 = 1.0925484305920792f;
constexpr float SH_C2_1 = -1.0925484305920792f;
constexpr float SH_C2_2 = 0.31539156525252005f;
constexpr float SH_C2_3 = -1.0925484305920792f;
constexpr float SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f;
constexpr float SH_C3_1 = 2.890611442640554f;
constexpr float SH_C3_2 = -0.4570457994644658f;
constexpr float SH_C3_3 = 0.3731763325901154f;
constexpr float SH_C3_4 = -0.4570457994644658f;
constexpr float SH_C3_5 = 1.445305721320277f;
constexpr float SH_C3_6 = -0.5900435899266435f;

// Camera constants (ops/kernels/build_table.py camera_consts).
constexpr int C_WV = 0;     // world_view rows 0..2, row-major 3 x 4
constexpr int C_FP0 = 12;   // full_proj row 0
constexpr int C_FP1 = 16;   // full_proj row 1
constexpr int C_FP3 = 20;   // full_proj row 3
constexpr int C_CAM = 24;   // camera centre xyz
constexpr int C_FOC = 27;   // focal_x, focal_y, tan_fovx, tan_fovy

// Table rows (ops/kernels/build_table.py ROW_*).
enum Row {
  R_RX0 = 0, R_RY0, R_RW, R_TNUM, R_MX, R_MY, R_V1X, R_V1Y, R_V2X, R_V2Y,
  R_LEN1, R_LEN2, R_CA, R_CB, R_CC, R_HL, R_DEPTH, R_VALID, R_LEVEL
};

// clip(int32(x), 0, hi) with truncation toward zero; the float clamp keeps
// the conversion defined for huge or NaN x (fmaxf drops a NaN).
__device__ inline int trunc_clip(float x, int hi) {
  const int v = static_cast<int>(fminf(fmaxf(x, -1.0f), hi + 1.0f));
  return min(max(v, 0), hi);
}

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
                   int n, int L, int k_rest, int grid_x, int grid_y,
                   int width, int height, float scale_modifier,
                   int sh_degree, float* __restrict__ table,
                   int* __restrict__ cum, int* __restrict__ block_sums) {
  const int i = blockIdx.x * fs::SCAN_BLOCK + threadIdx.x;
  int tnum_out = 0;
  if (i < n) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    const float* wv = cam + C_WV;

    // --- view / projection (preprocess_cols) ---
    const float depth = wv[8] * x + wv[9] * y + wv[10] * z + wv[11];
    const float hx = cam[C_FP0] * x + cam[C_FP0 + 1] * y +
                     cam[C_FP0 + 2] * z + cam[C_FP0 + 3];
    const float hy = cam[C_FP1] * x + cam[C_FP1 + 1] * y +
                     cam[C_FP1 + 2] * z + cam[C_FP1 + 3];
    const float hw = cam[C_FP3] * x + cam[C_FP3 + 1] * y +
                     cam[C_FP3 + 2] * z + cam[C_FP3 + 3];
    const bool in_front = depth > NEAR_CULL_Z;
    const float hw_safe = in_front ? hw + 1e-7f : 1.0f;
    const float p_w = 1.0f / hw_safe;
    const float p_x = hx * p_w;
    const float p_y = hy * p_w;

    // --- cov3d (_cov3d_cols) ---
    const float qr = rot[4 * i], qx = rot[4 * i + 1], qy = rot[4 * i + 2],
                qz = rot[4 * i + 3];
    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qr * qz);
    const float r02 = 2.0f * (qx * qz + qr * qy);
    const float r10 = 2.0f * (qx * qy + qr * qz);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qr * qx);
    const float r20 = 2.0f * (qx * qz - qr * qy);
    const float r21 = 2.0f * (qy * qz + qr * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    float s0 = scales[3 * i] * scale_modifier;
    float s1 = scales[3 * i + 1] * scale_modifier;
    float s2 = scales[3 * i + 2] * scale_modifier;
    s0 = s0 * s0;
    s1 = s1 * s1;
    s2 = s2 * s2;
    const float sxx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2;
    const float sxy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2;
    const float sxz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2;
    const float syy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2;
    const float syz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2;
    const float szz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2;

    // --- EWA cov2d (_cov2d_from_cols) ---
    const float tX = wv[0] * x + wv[1] * y + wv[2] * z + wv[3];
    const float tY = wv[4] * x + wv[5] * y + wv[6] * z + wv[7];
    const float tz = depth > NEAR_CULL_Z ? depth : 1.0f;
    const float focal_x = cam[C_FOC], focal_y = cam[C_FOC + 1];
    const float limx = 1.3f * cam[C_FOC + 2];
    const float limy = 1.3f * cam[C_FOC + 3];
    const float tx = fminf(fmaxf(tX / tz, -limx), limx) * tz;
    const float ty = fminf(fmaxf(tY / tz, -limy), limy) * tz;
    const float inv_z = 1.0f / tz;
    const float inv_z2 = inv_z * inv_z;
    const float j00 = focal_x * inv_z, j02 = -focal_x * tx * inv_z2;
    const float j11 = focal_y * inv_z, j12 = -focal_y * ty * inv_z2;
    const float a0 = j00 * wv[0] + j02 * wv[8];
    const float a1 = j00 * wv[1] + j02 * wv[9];
    const float a2 = j00 * wv[2] + j02 * wv[10];
    const float b0 = j11 * wv[4] + j12 * wv[8];
    const float b1 = j11 * wv[5] + j12 * wv[9];
    const float b2 = j11 * wv[6] + j12 * wv[10];
    const float sa0 = sxx * a0 + sxy * a1 + sxz * a2;
    const float sa1 = sxy * a0 + syy * a1 + syz * a2;
    const float sa2 = sxz * a0 + syz * a1 + szz * a2;
    const float sb0 = sxx * b0 + sxy * b1 + sxz * b2;
    const float sb1 = sxy * b0 + syy * b1 + syz * b2;
    const float sb2 = sxz * b0 + syz * b1 + szz * b2;
    const float cxx = a0 * sa0 + a1 * sa1 + a2 * sa2 + LOWPASS;
    const float cxy = b0 * sa0 + b1 * sa1 + b2 * sa2;
    const float cyy = b0 * sb0 + b1 * sb1 + b2 * sb2;

    const float det = cxx * cyy - cxy * cxy;
    const bool det_ok = det != 0.0f;
    const float safe_det = det_ok ? det : 1.0f;
    const float det_inv = 1.0f / safe_det;
    const float mid = 0.5f * (cxx + cyy);
    const float disc = sqrtf(fmaxf(mid * mid - safe_det, 0.1f));
    const float lambda1 = mid + disc;
    const float lambda2 = mid - disc;
    const float radius = ceilf(3.0f * sqrtf(fmaxf(lambda1, lambda2)));

    const float px = ((p_x + 1.0f) * width - 1.0f) * 0.5f;
    const float py = ((p_y + 1.0f) * height - 1.0f) * 0.5f;
    int rx0 = trunc_clip((px - radius) / TILE, grid_x);
    int ry0 = trunc_clip((py - radius) / TILE, grid_y);
    int rx1 = trunc_clip((px + radius + TILE - 1.0f) / TILE, grid_x);
    int ry1 = trunc_clip((py + radius + TILE - 1.0f) / TILE, grid_y);
    const int tiles0 = (rx1 - rx0) * (ry1 - ry0);
    const bool valid0 = in_front && det_ok && tiles0 > 0;
    const bool multi = valid0 && tiles0 > 1;   // pre-clip, see the header

    // --- per-level rect clip (fov_soa_cols); hl < 0 marks a dead row ---
    const float hl = hl_in[i];
    const int hli = min(max(static_cast<int>(hl), 0), L - 1);
    rx0 = max(rx0, bbox[hli]);
    ry0 = max(ry0, bbox[L + hli]);
    rx1 = min(rx1, bbox[2 * L + hli]);
    ry1 = min(ry1, bbox[3 * L + hli]);
    const int tnum = max(rx1 - rx0, 0) * max(ry1 - ry0, 0);
    const bool valid = valid0 && tnum > 0 && hl >= 0.0f;
    rx1 = max(rx1, rx0);
    tnum_out = valid ? tnum : 0;

    // --- OBB axes and conic ---
    const float e1 = cxx - lambda1;
    const float e2 = cxx - lambda2;
    const float n1 = rsqrtf(fmaxf(cxy * cxy + e1 * e1, 1e-20f));
    const float n2 = rsqrtf(fmaxf(cxy * cxy + e2 * e2, 1e-20f));
    const float len1 = multi ? 3.0f * sqrtf(fmaxf(lambda1, 0.0f)) : 0.0f;
    const float len2 = multi ? 3.0f * sqrtf(fmaxf(lambda2, 0.0f)) : 0.0f;

    // --- SH rest term (k = 0 of rest_t is the zero DC slot) ---
    const float dxc = x - cam[C_CAM];
    const float dyc = y - cam[C_CAM + 1];
    const float dzc = z - cam[C_CAM + 2];
    const float inv_n = rsqrtf(fmaxf(dxc * dxc + dyc * dyc + dzc * dzc,
                                     1e-20f));
    const float dx = dxc * inv_n, dy = dyc * inv_n, dz = dzc * inv_n;
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
    float rest_c[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const __nv_bfloat16* s = rest_t + static_cast<size_t>(c) * k_rest * n;
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
      rest_c[c] = r + 0.5f;
    }

    // --- table column; invalid rows are sanitised (build_table.py:240-284)
    auto put = [&](int row, float v) {
      table[static_cast<size_t>(row) * n + i] = v;
    };
    put(R_RX0, valid ? static_cast<float>(rx0) : 0.0f);
    put(R_RY0, valid ? static_cast<float>(ry0) : 0.0f);
    put(R_RW, valid ? static_cast<float>(max(rx1 - rx0, 1)) : 1.0f);
    put(R_TNUM, static_cast<float>(tnum_out));
    put(R_MX, valid ? px : 0.0f);
    put(R_MY, valid ? py : 0.0f);
    put(R_V1X, valid ? -cxy * n1 : 0.0f);
    put(R_V1Y, valid ? e1 * n1 : 0.0f);
    put(R_V2X, valid ? -cxy * n2 : 0.0f);
    put(R_V2Y, valid ? e2 * n2 : 0.0f);
    put(R_LEN1, valid ? len1 : 0.0f);
    put(R_LEN2, valid ? len2 : 0.0f);
    put(R_CA, valid ? cyy * det_inv : 1.0f);
    put(R_CB, valid ? -cxy * det_inv : 0.0f);
    put(R_CC, valid ? cxx * det_inv : 1.0f);
    put(R_HL, valid ? hl : -2.0f);
    put(R_DEPTH, valid ? depth : 1.0f);
    put(R_VALID, valid ? 1.0f : 0.0f);
    for (int l = 0; l < L; ++l) {
      const float op = __bfloat162float(opac_t[static_cast<size_t>(l) * n + i]);
      put(R_LEVEL + l, valid ? op : 0.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dc = __bfloat162float(
            dc_t[(static_cast<size_t>(c) * L + l) * n + i]);
        const float col = fmaxf(SH_C0 * dc + rest_c[c], 0.0f);
        put(R_LEVEL + (1 + c) * L + l, valid ? col : 0.0f);
      }
    }
  }

  // --- exclusive cumsum of tnum: block-local part ---
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
                             const int* bbox, int n, int L, int k_rest,
                             int grid_x, int grid_y, int width, int height,
                             float scale_modifier, int sh_degree,
                             float* table, int* cum, int* block_sums,
                             int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = fs::scan_blocks(n);
  build_table_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(
      xyz, scales, rot, hl, static_cast<const __nv_bfloat16*>(rest_t),
      static_cast<const __nv_bfloat16*>(dc_t),
      static_cast<const __nv_bfloat16*>(opac_t), cam, bbox, n, L, k_rest,
      grid_x, grid_y, width, height, scale_modifier, sh_degree, table, cum,
      block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fs::scan_carry_kernel<<<nb, fs::SCAN_BLOCK, 0, s>>>(cum, block_sums, nb, n,
                                                      total);
  return cudaGetLastError();
}

