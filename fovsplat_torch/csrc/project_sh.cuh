// The per-Gaussian arithmetic of kernel 10 (project_sh.cu): the train
// route's projection (ops/projection.py preprocess_cols), its SH colour
// (ops/sh.py sh_to_rgb) and their backward. Kernel 1 (build_table.cu)
// projects with the same ewa and columns.
//
// The forward mirrors PyTorch's elementwise operations one for one, in
// their order and with their NaN rules (torch.clamp, torch.maximum and
// nan_to_num keep or map a NaN where fmaxf would drop it), so that under
// -fmad=false (see ops/kernels/_build.py) every column equals the plain
// version's bit for bit on the card. Scalars are Python floats converted
// to f32, as PyTorch converts a scalar operand.
//
// The backward follows autograd's rules on that composition: torch.where
// sends a zero gradient to the branch it did not take (hw_safe, tz,
// safe_det), torch.clamp passes the gradient where its input lies within
// the bounds, ends included (the 1.3 tan_fov clamp, the colour's clamp at
// 0), and coefficients above the SH degree get zero. Only the order of
// the f32 sums differs from autograd's.
#pragma once

#include <math.h>

namespace psh {

// Camera constants (ops/kernels/build_table.camera_consts).
constexpr int C_WV = 0;     // world_view rows 0..2, row-major 3 x 4
constexpr int C_FP0 = 12;   // full_proj row 0
constexpr int C_FP1 = 16;   // full_proj row 1
constexpr int C_FP3 = 20;   // full_proj row 3
constexpr int C_CAM = 24;   // camera centre xyz
constexpr int C_FOC = 27;   // focal_x, focal_y, tan_fovx, tan_fovy

constexpr int TILE = 16;
constexpr float NEAR_CULL_Z = 0.2;
constexpr float LOWPASS = 0.3;
constexpr float HW_EPS = 1e-7;
constexpr float DISC_MIN = 0.1;
constexpr float AXIS_MIN = 1e-20;
constexpr float FOV_CLAMP = 1.3;
constexpr float SH_C0 = 0.28209479177387814;
constexpr float SH_C1 = 0.4886025119029199;
constexpr float SH_C2_0 = 1.0925484305920792;
constexpr float SH_C2_1 = -1.0925484305920792;
constexpr float SH_C2_2 = 0.31539156525252005;
constexpr float SH_C2_3 = -1.0925484305920792;
constexpr float SH_C2_4 = 0.5462742152960396;
constexpr float SH_C3_0 = -0.5900435899266435;
constexpr float SH_C3_1 = 2.890611442640554;
constexpr float SH_C3_2 = -0.4570457994644658;
constexpr float SH_C3_3 = 0.3731763325901154;
constexpr float SH_C3_4 = -0.4570457994644658;
constexpr float SH_C3_5 = 1.445305721320277;
constexpr float SH_C3_6 = -0.5900435899266435;

__device__ inline bool is_nan(float x) { return x != x; }

// torch.clamp(x, min=lo): a NaN stays NaN.
__device__ inline float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

// torch.clamp(x, lo, hi).
__device__ inline float clamp2(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.maximum(a, b): a NaN in either wins.
__device__ inline float maximum(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}

// projection._trunc_clip: clip(int32(x), 0, hi), truncation toward zero,
// NaN read as -1 (nan_to_num), infinities as the clamp's ends.
__device__ inline int trunc_clip(float x, int hi) {
  if (is_nan(x)) x = -1.0f;
  const int v = static_cast<int>(fminf(fmaxf(x, -1.0f), hi + 1.0f));
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The EWA projection of one Gaussian up to the 2D covariance's inverse
// (_cov3d_cols, _cov2d_from_cols and the first lines of
// preprocess_cols), with every intermediate the backward reads.
struct Ewa {
  bool in_front, det_ok;
  float depth, hx, hy, p_w, p_x, p_y;
  float r[9];           // rotation, row-major
  float u[3], v[3];     // u = scale * modifier, v = u^2
  float sig[6];         // sxx, sxy, sxz, syy, syz, szz
  float tX, tY, tz, ux, uy, clx, cly, tx, ty, inv_z, inv_z2;
  float j00, j02, j11, j12;
  float a[3], b[3], sa[3], sb[3];
  float cxx, cxy, cyy, det, safe_det, det_inv;
};

__device__ inline Ewa ewa(const float* cam, const float m[3],
                                   const float s[3], const float q[4],
                                   float scale_modifier) {
  Ewa e;
  const float* wv = cam + C_WV;
  const float* f0 = cam + C_FP0;
  const float* f1 = cam + C_FP1;
  const float* f3 = cam + C_FP3;
  const float x = m[0], y = m[1], z = m[2];
  e.depth = wv[8] * x + wv[9] * y + wv[10] * z + wv[11];
  e.hx = f0[0] * x + f0[1] * y + f0[2] * z + f0[3];
  e.hy = f1[0] * x + f1[1] * y + f1[2] * z + f1[3];
  const float hw = f3[0] * x + f3[1] * y + f3[2] * z + f3[3];
  e.in_front = e.depth > NEAR_CULL_Z;
  const float hw_safe = e.in_front ? hw + HW_EPS : 1.0f;
  e.p_w = 1.0f / hw_safe;
  e.p_x = e.hx * e.p_w;
  e.p_y = e.hy * e.p_w;

  const float qr = q[0], qx = q[1], qy = q[2], qz = q[3];
  float* R = e.r;
  R[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  R[1] = 2.0f * (qx * qy - qr * qz);
  R[2] = 2.0f * (qx * qz + qr * qy);
  R[3] = 2.0f * (qx * qy + qr * qz);
  R[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  R[5] = 2.0f * (qy * qz - qr * qx);
  R[6] = 2.0f * (qx * qz - qr * qy);
  R[7] = 2.0f * (qy * qz + qr * qx);
  R[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  for (int j = 0; j < 3; ++j) {
    e.u[j] = s[j] * scale_modifier;
    e.v[j] = e.u[j] * e.u[j];
  }
  const float* v = e.v;
  e.sig[0] = R[0] * R[0] * v[0] + R[1] * R[1] * v[1] + R[2] * R[2] * v[2];
  e.sig[1] = R[0] * R[3] * v[0] + R[1] * R[4] * v[1] + R[2] * R[5] * v[2];
  e.sig[2] = R[0] * R[6] * v[0] + R[1] * R[7] * v[1] + R[2] * R[8] * v[2];
  e.sig[3] = R[3] * R[3] * v[0] + R[4] * R[4] * v[1] + R[5] * R[5] * v[2];
  e.sig[4] = R[3] * R[6] * v[0] + R[4] * R[7] * v[1] + R[5] * R[8] * v[2];
  e.sig[5] = R[6] * R[6] * v[0] + R[7] * R[7] * v[1] + R[8] * R[8] * v[2];
  const float sxx = e.sig[0], sxy = e.sig[1], sxz = e.sig[2];
  const float syy = e.sig[3], syz = e.sig[4], szz = e.sig[5];

  e.tX = wv[0] * x + wv[1] * y + wv[2] * z + wv[3];
  e.tY = wv[4] * x + wv[5] * y + wv[6] * z + wv[7];
  e.tz = e.in_front ? e.depth : 1.0f;
  const float limx = FOV_CLAMP * cam[C_FOC + 2];
  const float limy = FOV_CLAMP * cam[C_FOC + 3];
  e.ux = e.tX / e.tz;
  e.uy = e.tY / e.tz;
  e.clx = clamp2(e.ux, -limx, limx);
  e.cly = clamp2(e.uy, -limy, limy);
  e.tx = e.clx * e.tz;
  e.ty = e.cly * e.tz;
  e.inv_z = 1.0f / e.tz;
  e.inv_z2 = e.inv_z * e.inv_z;
  const float fx = cam[C_FOC], fy = cam[C_FOC + 1];
  e.j00 = fx * e.inv_z;
  e.j02 = -fx * e.tx * e.inv_z2;
  e.j11 = fy * e.inv_z;
  e.j12 = -fy * e.ty * e.inv_z2;
  for (int k = 0; k < 3; ++k) {
    e.a[k] = e.j00 * wv[k] + e.j02 * wv[8 + k];
    e.b[k] = e.j11 * wv[4 + k] + e.j12 * wv[8 + k];
  }
  const float* a = e.a;
  const float* b = e.b;
  e.sa[0] = sxx * a[0] + sxy * a[1] + sxz * a[2];
  e.sa[1] = sxy * a[0] + syy * a[1] + syz * a[2];
  e.sa[2] = sxz * a[0] + syz * a[1] + szz * a[2];
  e.sb[0] = sxx * b[0] + sxy * b[1] + sxz * b[2];
  e.sb[1] = sxy * b[0] + syy * b[1] + syz * b[2];
  e.sb[2] = sxz * b[0] + syz * b[1] + szz * b[2];
  e.cxx = a[0] * e.sa[0] + a[1] * e.sa[1] + a[2] * e.sa[2] + LOWPASS;
  e.cxy = b[0] * e.sa[0] + b[1] * e.sa[1] + b[2] * e.sa[2];
  e.cyy = b[0] * e.sb[0] + b[1] * e.sb[1] + b[2] * e.sb[2];
  e.det = e.cxx * e.cyy - e.cxy * e.cxy;
  e.det_ok = e.det != 0.0f;
  e.safe_det = e.det_ok ? e.det : 1.0f;
  e.det_inv = 1.0f / e.safe_det;
  return e;
}

// The columns of preprocess_cols and train_columns for one Gaussian.
struct Cols {
  bool valid;
  int rx0, ry0, rx1, ry1, rw, tnum;
  float depth, px, py, ca, cb, cc, v1x, v1y, v2x, v2y, len1, len2, radius;
};

__device__ inline Cols columns(const Ewa& e, bool live, int grid_x,
                                        int grid_y, int width, int height) {
  Cols o;
  const float mid = 0.5f * (e.cxx + e.cyy);
  const float disc = sqrtf(clamp_min(mid * mid - e.safe_det, DISC_MIN));
  const float l1 = mid + disc;
  const float l2 = mid - disc;
  o.radius = ceilf(3.0f * sqrtf(maximum(l1, l2)));
  o.depth = e.depth;
  o.px = ((e.p_x + 1.0f) * static_cast<float>(width) - 1.0f) * 0.5f;
  o.py = ((e.p_y + 1.0f) * static_cast<float>(height) - 1.0f) * 0.5f;
  const float t = static_cast<float>(TILE);
  o.rx0 = trunc_clip((o.px - o.radius) / t, grid_x);
  o.ry0 = trunc_clip((o.py - o.radius) / t, grid_y);
  o.rx1 = trunc_clip((o.px + o.radius + t - 1.0f) / t, grid_x);
  o.ry1 = trunc_clip((o.py + o.radius + t - 1.0f) / t, grid_y);
  const int tiles = (o.rx1 - o.rx0) * (o.ry1 - o.ry0);
  o.valid = e.in_front && e.det_ok && tiles > 0 && live;
  o.tnum = o.valid ? tiles : 0;
  o.rw = o.rx1 - o.rx0 > 1 ? o.rx1 - o.rx0 : 1;

  const bool multi = o.tnum > 1;
  const float e1 = e.cxx - l1;
  const float e2 = e.cxx - l2;
  const float n1 = rsqrtf(clamp_min(e.cxy * e.cxy + e1 * e1, AXIS_MIN));
  const float n2 = rsqrtf(clamp_min(e.cxy * e.cxy + e2 * e2, AXIS_MIN));
  o.len1 = multi ? 3.0f * sqrtf(clamp_min(l1, 0.0f)) : 0.0f;
  o.len2 = multi ? 3.0f * sqrtf(clamp_min(l2, 0.0f)) : 0.0f;
  o.ca = e.cyy * e.det_inv;
  o.cb = -e.cxy * e.det_inv;
  o.cc = e.cxx * e.det_inv;
  o.v1x = -e.cxy * n1;
  o.v1y = e1 * n1;
  o.v2x = -e.cxy * n2;
  o.v2y = e2 * n2;
  return o;
}

// Unit view direction (sh._unit_dirs): d = mean - centre, inv =
// rsqrt(|d|^2); no clamp, so a Gaussian at the centre reads NaN.
struct Dir {
  float d[3], inv, x, y, z;
};

__device__ inline Dir view_dir(const float* cam, const float m[3]) {
  Dir o;
  for (int j = 0; j < 3; ++j) o.d[j] = m[j] - cam[C_CAM + j];
  o.inv = rsqrtf(o.d[0] * o.d[0] + o.d[1] * o.d[1] + o.d[2] * o.d[2]);
  o.x = o.d[0] * o.inv;
  o.y = o.d[1] * o.inv;
  o.z = o.d[2] * o.inv;
  return o;
}

// The SH basis factors of sh._eval_sh_nlast, b[k] for k < (deg + 1)^2,
// each formed as that code forms it; terms 1 and 3 enter the sum with a
// minus sign.
__device__ inline void sh_basis(int deg, const Dir& w, float b[16]) {
  const float x = w.x, y = w.y, z = w.z;
  b[0] = SH_C0;
  if (deg > 0) {
    b[1] = SH_C1 * y;
    b[2] = SH_C1 * z;
    b[3] = SH_C1 * x;
  }
  if (deg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = SH_C2_0 * xy;
    b[5] = SH_C2_1 * yz;
    b[6] = SH_C2_2 * (2.0f * zz - xx - yy);
    b[7] = SH_C2_3 * xz;
    b[8] = SH_C2_4 * (xx - yy);
    if (deg > 2) {
      b[9] = SH_C3_0 * y * (3.0f * xx - yy);
      b[10] = SH_C3_1 * xy * z;
      b[11] = SH_C3_2 * y * (4.0f * zz - xx - yy);
      b[12] = SH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = SH_C3_4 * x * (4.0f * zz - xx - yy);
      b[14] = SH_C3_5 * z * (xx - yy);
      b[15] = SH_C3_6 * x * (xx - 3.0f * yy);
    }
  }
}

// Channel c's SH sum + 0.5 before the clamp; sh holds the Gaussian's
// (K, 3) coefficients, row-major.
__device__ inline float sh_raw(int deg, const float b[16],
                                        const float* sh, int c) {
  float r = b[0] * sh[c];
  if (deg > 0) {
    r = r - b[1] * sh[3 + c];
    r = r + b[2] * sh[6 + c];
    r = r - b[3] * sh[9 + c];
  }
  if (deg > 1) {
#pragma unroll
    for (int k = 4; k < 9; ++k) r = r + b[k] * sh[3 * k + c];
  }
  if (deg > 2) {
#pragma unroll
    for (int k = 9; k < 16; ++k) r = r + b[k] * sh[3 * k + c];
  }
  return r + 0.5f;
}

// d(colour)/d(x, y, z) of channel c before the clamp, the unit direction
// held fixed (3DGS computeColorFromSH's backward).
__device__ inline void sh_dir_grad(int deg, const Dir& w,
                                            const float* sh, int c,
                                            float out[3]) {
  const float x = w.x, y = w.y, z = w.z;
  auto s = [&](int k) { return sh[3 * k + c]; };
  float dx = -SH_C1 * s(3), dy = -SH_C1 * s(1), dz = SH_C1 * s(2);
  if (deg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    dx += SH_C2_0 * y * s(4) + SH_C2_2 * 2.0f * -x * s(6) +
          SH_C2_3 * z * s(7) + SH_C2_4 * 2.0f * x * s(8);
    dy += SH_C2_0 * x * s(4) + SH_C2_1 * z * s(5) +
          SH_C2_2 * 2.0f * -y * s(6) + SH_C2_4 * 2.0f * -y * s(8);
    dz += SH_C2_1 * y * s(5) + SH_C2_2 * 2.0f * 2.0f * z * s(6) +
          SH_C2_3 * x * s(7);
    if (deg > 2) {
      dx += SH_C3_0 * s(9) * 3.0f * 2.0f * xy + SH_C3_1 * s(10) * yz +
            SH_C3_2 * s(11) * -2.0f * xy +
            SH_C3_3 * s(12) * -3.0f * 2.0f * xz +
            SH_C3_4 * s(13) * (-3.0f * xx + 4.0f * zz - yy) +
            SH_C3_5 * s(14) * 2.0f * xz + SH_C3_6 * s(15) * 3.0f * (xx - yy);
      dy += SH_C3_0 * s(9) * 3.0f * (xx - yy) + SH_C3_1 * s(10) * xz +
            SH_C3_2 * s(11) * (-3.0f * yy + 4.0f * zz - xx) +
            SH_C3_3 * s(12) * -3.0f * 2.0f * yz +
            SH_C3_4 * s(13) * -2.0f * xy + SH_C3_5 * s(14) * -2.0f * yz +
            SH_C3_6 * s(15) * -3.0f * 2.0f * xy;
      dz += SH_C3_1 * s(10) * xy + SH_C3_2 * s(11) * 4.0f * 2.0f * yz +
            SH_C3_3 * s(12) * 3.0f * (2.0f * zz - xx - yy) +
            SH_C3_4 * s(13) * 4.0f * 2.0f * xz + SH_C3_5 * s(14) * (xx - yy);
    }
  }
  out[0] = dx;
  out[1] = dy;
  out[2] = dz;
}

// The backward of one Gaussian. g: the nine cotangents (mx, my, ca, cb,
// cc, op, r, g, b). sh: the (k_sh, 3) coefficients, or null when the
// colours were given (their gradient is the cotangent; no d_sh). Writes
// d_m (3), d_s (3), d_q (4) and, with sh, all of d_sh (k_sh, 3); d_sh
// may alias sh: it is written after the last read of sh. The opacity's
// and the pixel offset's gradients are their cotangents, not written
// here.
__device__ inline void backward(const float* cam, int width,
                                         int height, float scale_modifier,
                                         const float m[3], const float s[3],
                                         const float q[4], const float* sh,
                                         int deg, int k_sh, const float g[9],
                                         float d_m[3], float d_s[3],
                                         float d_q[4], float* d_sh) {
  bool any = false;
  for (int k = 0; k < 9; ++k) any = any || g[k] != 0.0f;
  if (!any) {
    for (int j = 0; j < 3; ++j) d_m[j] = d_s[j] = 0.0f;
    for (int j = 0; j < 4; ++j) d_q[j] = 0.0f;
    if (sh != nullptr) {
      for (int k = 0; k < 3 * k_sh; ++k) d_sh[k] = 0.0f;
    }
    return;
  }
  const Ewa e = ewa(cam, m, s, q, scale_modifier);
  const float* wv = cam + C_WV;
  const float* f0 = cam + C_FP0;
  const float* f1 = cam + C_FP1;
  const float* f3 = cam + C_FP3;

  // --- pixel centre: ndc2pix, p = h / hw_safe ---
  const float d_px = g[0] * 0.5f * static_cast<float>(width);
  const float d_py = g[1] * 0.5f * static_cast<float>(height);
  const float d_hx = d_px * e.p_w;
  const float d_hy = d_py * e.p_w;
  const float d_pw = d_px * e.hx + d_py * e.hy;
  const float d_hw = e.in_front ? -d_pw * (e.p_w * e.p_w) : 0.0f;

  // --- conic (ca, cb, cc) = (cyy, -cxy, cxx) / safe_det ---
  const float d_det_inv = g[2] * e.cyy + g[3] * -e.cxy + g[4] * e.cxx;
  float d_cxx = g[4] * e.det_inv;
  float d_cxy = -(g[3] * e.det_inv);
  float d_cyy = g[2] * e.det_inv;
  const float d_det =
      e.det_ok ? -d_det_inv * (e.det_inv * e.det_inv) : 0.0f;
  d_cxx += d_det * e.cyy;
  d_cyy += d_det * e.cxx;
  d_cxy += -2.0f * (d_det * e.cxy);

  // --- cxx = a.Sa + lowpass, cxy = b.Sa, cyy = b.Sb ---
  const float* sig = e.sig;
  float d_a[3], d_b[3], d_sa[3], d_sb[3];
  for (int k = 0; k < 3; ++k) {
    d_a[k] = d_cxx * e.sa[k];
    d_b[k] = d_cxy * e.sa[k] + d_cyy * e.sb[k];
    d_sa[k] = d_cxx * e.a[k] + d_cxy * e.b[k];
    d_sb[k] = d_cyy * e.b[k];
  }
  // Sa = Sigma a, Sigma symmetric.
  d_a[0] += d_sa[0] * sig[0] + d_sa[1] * sig[1] + d_sa[2] * sig[2];
  d_a[1] += d_sa[0] * sig[1] + d_sa[1] * sig[3] + d_sa[2] * sig[4];
  d_a[2] += d_sa[0] * sig[2] + d_sa[1] * sig[4] + d_sa[2] * sig[5];
  d_b[0] += d_sb[0] * sig[0] + d_sb[1] * sig[1] + d_sb[2] * sig[2];
  d_b[1] += d_sb[0] * sig[1] + d_sb[1] * sig[3] + d_sb[2] * sig[4];
  d_b[2] += d_sb[0] * sig[2] + d_sb[1] * sig[4] + d_sb[2] * sig[5];
  const float* a = e.a;
  const float* b = e.b;
  float d_sig[6];
  d_sig[0] = d_sa[0] * a[0] + d_sb[0] * b[0];
  d_sig[1] = d_sa[0] * a[1] + d_sa[1] * a[0] + d_sb[0] * b[1] +
             d_sb[1] * b[0];
  d_sig[2] = d_sa[0] * a[2] + d_sa[2] * a[0] + d_sb[0] * b[2] +
             d_sb[2] * b[0];
  d_sig[3] = d_sa[1] * a[1] + d_sb[1] * b[1];
  d_sig[4] = d_sa[1] * a[2] + d_sa[2] * a[1] + d_sb[1] * b[2] +
             d_sb[2] * b[1];
  d_sig[5] = d_sa[2] * a[2] + d_sb[2] * b[2];

  // --- the Jacobian rows a = j00 W0 + j02 W2, b = j11 W1 + j12 W2 ---
  float d_j00 = 0.0f, d_j02 = 0.0f, d_j11 = 0.0f, d_j12 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    d_j00 += d_a[k] * wv[k];
    d_j02 += d_a[k] * wv[8 + k];
    d_j11 += d_b[k] * wv[4 + k];
    d_j12 += d_b[k] * wv[8 + k];
  }
  const float fx = cam[C_FOC], fy = cam[C_FOC + 1];
  const float d_tx = d_j02 * e.inv_z2 * -fx;
  const float d_ty = d_j12 * e.inv_z2 * -fy;
  const float d_inv_z2 = d_j02 * (-fx * e.tx) + d_j12 * (-fy * e.ty);
  const float d_inv_z = d_j00 * fx + d_j11 * fy + 2.0f * d_inv_z2 * e.inv_z;
  float d_tz = -d_inv_z * (e.inv_z * e.inv_z);
  // t = clamp(T / tz, -lim, lim) * tz
  const float limx = FOV_CLAMP * cam[C_FOC + 2];
  const float limy = FOV_CLAMP * cam[C_FOC + 3];
  d_tz += d_tx * e.clx + d_ty * e.cly;
  const float d_ux = (e.ux >= -limx && e.ux <= limx) ? d_tx * e.tz : 0.0f;
  const float d_uy = (e.uy >= -limy && e.uy <= limy) ? d_ty * e.tz : 0.0f;
  const float d_tX = d_ux / e.tz;
  const float d_tY = d_uy / e.tz;
  d_tz += -d_ux * e.tX / (e.tz * e.tz) - d_uy * e.tY / (e.tz * e.tz);
  const float d_tz_raw = e.in_front ? d_tz : 0.0f;
  for (int j = 0; j < 3; ++j) {
    d_m[j] = f0[j] * d_hx + f1[j] * d_hy + f3[j] * d_hw + wv[j] * d_tX +
             wv[4 + j] * d_tY + wv[8 + j] * d_tz_raw;
  }

  // --- Sigma = R diag(v) R^T, v = (s * modifier)^2 ---
  const float* R = e.r;
  // The symmetric entry of row a, column c: 2 dS on the diagonal.
  const float dS[3][3] = {{2.0f * d_sig[0], d_sig[1], d_sig[2]},
                          {d_sig[1], 2.0f * d_sig[3], d_sig[4]},
                          {d_sig[2], d_sig[4], 2.0f * d_sig[5]}};
  float d_R[9];
  for (int j = 0; j < 3; ++j) {
    d_s[j] = (d_sig[0] * R[j] * R[j] + d_sig[1] * R[j] * R[3 + j] +
              d_sig[2] * R[j] * R[6 + j] + d_sig[3] * R[3 + j] * R[3 + j] +
              d_sig[4] * R[3 + j] * R[6 + j] +
              d_sig[5] * R[6 + j] * R[6 + j]) *
             (2.0f * e.u[j]) * scale_modifier;
    for (int r = 0; r < 3; ++r) {
      d_R[3 * r + j] = e.v[j] * (dS[r][0] * R[j] + dS[r][1] * R[3 + j] +
                                 dS[r][2] * R[6 + j]);
    }
  }
  const float qr = q[0], qx = q[1], qy = q[2], qz = q[3];
  d_q[0] = 2.0f * (-d_R[1] * qz + d_R[2] * qy + d_R[3] * qz - d_R[5] * qx -
                   d_R[6] * qy + d_R[7] * qx);
  d_q[1] = 2.0f * (d_R[1] * qy + d_R[2] * qz + d_R[3] * qy - d_R[5] * qr +
                   d_R[6] * qz + d_R[7] * qr) -
           4.0f * qx * (d_R[4] + d_R[8]);
  d_q[2] = 2.0f * (d_R[1] * qx + d_R[2] * qr + d_R[3] * qx + d_R[5] * qz -
                   d_R[6] * qr + d_R[7] * qz) -
           4.0f * qy * (d_R[0] + d_R[8]);
  d_q[3] = 2.0f * (-d_R[1] * qr + d_R[2] * qx + d_R[3] * qr + d_R[5] * qy +
                   d_R[6] * qx + d_R[7] * qy) -
           4.0f * qz * (d_R[0] + d_R[4]);

  if (sh == nullptr) return;

  // --- colour = clamp(SH sum + 0.5, min=0) ---
  const Dir w = view_dir(cam, m);
  float bas[16];
  sh_basis(deg, w, bas);
  float gc[3];
  float d_dir[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) {
    gc[c] = sh_raw(deg, bas, sh, c) >= 0.0f ? g[6 + c] : 0.0f;
    if (deg > 0) {
      float dd[3];
      sh_dir_grad(deg, w, sh, c, dd);
      for (int j = 0; j < 3; ++j) d_dir[j] += gc[c] * dd[j];
    }
  }
  if (deg > 0) {
    // dir = d * rsqrt(|d|^2)
    const float d_inv =
        d_dir[0] * w.d[0] + d_dir[1] * w.d[1] + d_dir[2] * w.d[2];
    const float d_n2 = d_inv * (-0.5f * (w.inv * w.inv * w.inv));
    for (int j = 0; j < 3; ++j) {
      d_m[j] += d_dir[j] * w.inv + 2.0f * w.d[j] * d_n2;
    }
  }
  // Last: d_sh may alias sh. k_sh <= 16 (MAX_K in project_sh.cu).
  const int nc = (deg + 1) * (deg + 1);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= k_sh) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = 0.0f;
      if (k < nc) {
        v = gc[c] * bas[k];
        if (k == 1 || k == 3) v = -v;
      }
      d_sh[3 * k + c] = v;
    }
  }
}

}  // namespace psh
