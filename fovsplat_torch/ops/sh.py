"""Real spherical harmonics, degree 0..3 (fovsplat/ops/sh.py:
num_sh_coeffs, eval_sh, _eval_sh_nlast, sh_to_rgb, eval_sh_rest,
_unit_dirs, rgb_to_sh_dc, sh_dc_to_rgb). Constants and basis order follow
the reference CUDA tables."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh_dc(rgb):
    """Inverse of the DC term: (rgb - 0.5) / C0 (utils/sh_utils.py RGB2SH)."""
    return (rgb - 0.5) / SH_C0


def sh_dc_to_rgb(dc):
    return dc * SH_C0 + 0.5


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh (..., K, 3) coefficients, K >= (degree + 1)^2, dirs (..., 3) unit
    view directions. Returns (..., 3) raw radiance (no +0.5, no clamp)."""
    result = SH_C0 * sh[..., 0, :]
    if degree > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - SH_C1 * y * sh[..., 1, :]
                  + SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4, :]
                      + SH_C2[1] * yz * sh[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + SH_C2[3] * xz * sh[..., 7, :]
                      + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if degree > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + SH_C3[1] * xy * z * sh[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy)
                          * sh[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                          * sh[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy)
                          * sh[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return result


def _eval_sh_nlast(degree: int, sh_t: torch.Tensor, x, y, z) -> torch.Tensor:
    """sh_t (C, K, N) coefficients (any float dtype, read as f32), x/y/z
    (N,) unit view directions. Returns (C, N) raw radiance (no +0.5)."""
    def s(k):
        return sh_t[:, k].float()
    result = SH_C0 * s(0)
    if degree > 0:
        result = (result - SH_C1 * y * s(1) + SH_C1 * z * s(2)
                  - SH_C1 * x * s(3))
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * s(4)
                      + SH_C2[1] * yz * s(5)
                      + SH_C2[2] * (2.0 * zz - xx - yy) * s(6)
                      + SH_C2[3] * xz * s(7)
                      + SH_C2[4] * (xx - yy) * s(8))
            if degree > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * s(9)
                          + SH_C3[1] * xy * z * s(10)
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * s(11)
                          + SH_C3[3] * z * (2.0 * zz - 3 * xx - 3 * yy)
                          * s(12)
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * s(13)
                          + SH_C3[5] * z * (xx - yy) * s(14)
                          + SH_C3[6] * x * (xx - 3.0 * yy) * s(15))
    return result


def _unit_dirs(means, cam_center):
    dx = means[:, 0] - cam_center[0]
    dy = means[:, 1] - cam_center[1]
    dz = means[:, 2] - cam_center[2]
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv


def sh_to_rgb(degree: int, sh: torch.Tensor, means: torch.Tensor,
              cam_center: torch.Tensor) -> torch.Tensor:
    """SH (N, K, 3) -> clamped RGB (N, 3) as in the reference preprocess;
    differentiable in the coefficients and the means."""
    x, y, z = _unit_dirs(means, cam_center)
    sh_t = sh.permute(2, 1, 0)              # (3, K, N)
    out = _eval_sh_nlast(degree, sh_t, x, y, z) + 0.5
    return torch.clamp(out, min=0.0).T      # (N, 3)


def eval_sh_rest(degree: int, sh_rest: torch.Tensor, means: torch.Tensor,
                 cam_center: torch.Tensor) -> torch.Tensor:
    """The foveated renderer's shared colour term: the degree >= 1
    contribution plus the 0.5 shift, no DC (computeRestColorFromSH,
    ..._fov_pcheck_obb/cuda_rasterizer/rasterizer_impl.cu:34-84).
    sh_rest (N, K-1, 3), coefficients 1..K-1. Returns (N, 3)."""
    n = sh_rest.shape[0]
    x, y, z = _unit_dirs(means, cam_center)
    sh_t = torch.cat([sh_rest.new_zeros((3, 1, n)),
                      sh_rest.permute(2, 1, 0)], dim=1)
    return (_eval_sh_nlast(degree, sh_t, x, y, z) + 0.5).T
