"""Per-Gaussian projection on (N,) columns (fovsplat/ops/projection.py).

Torch column math with the JAX package's operation order, so that a
kernel that mirrors it (csrc/build_table.cu, built without FMA
contraction) gives the same rect bounds bit for bit:

  - frustum cull: view-space z > 0.2
  - cov3D = R diag(s^2) R^T, cov2D = J W Sigma W^T J^T + 0.3 I (EWA), with
    the view-space x/y clamped to 1.3 tan_fov before J is built
  - radius = ceil(3 sqrt(lambda_max)), lambda = mid +- sqrt(max(0.1,
    mid^2 - det))
  - tile rect: int truncation toward zero, then clip to the grid
  - OBB axes are zeroed unless the (pre-clip) rect covers more than one
    tile
"""

from __future__ import annotations

import dataclasses

import torch

TILE = 16
NEAR_CULL_Z = 0.2
LOWPASS = 0.3


def _cov3d_cols(scales, rotations, scale_modifier):
    """Sigma = R diag(s^2) R^T as six (N,) columns
    (sxx, sxy, sxz, syy, syz, szz)."""
    r, x, y, z = (rotations[:, 0], rotations[:, 1], rotations[:, 2],
                  rotations[:, 3])
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = (scales[:, 0] * scale_modifier) ** 2
    s1 = (scales[:, 1] * scale_modifier) ** 2
    s2 = (scales[:, 2] * scale_modifier) ** 2
    sxx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    sxy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    sxz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    syy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    syz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    szz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return sxx, sxy, sxz, syy, syz, szz


def _cov2d_from_cols(means3d, sig, world_view, focal_x, focal_y,
                     tan_fovx, tan_fovy):
    """EWA projection on (N,) columns. Returns (cxx, cxy, cyy) with the
    +0.3 low-pass."""
    sxx, sxy, sxz, syy, syz, szz = sig
    W = world_view
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    tX = W[0, 0] * mx + W[0, 1] * my + W[0, 2] * mz + W[0, 3]
    tY = W[1, 0] * mx + W[1, 1] * my + W[1, 2] * mz + W[1, 3]
    tz_raw = W[2, 0] * mx + W[2, 1] * my + W[2, 2] * mz + W[2, 3]
    # Rows at or behind the near plane are culled; keep them finite.
    tz = torch.where(tz_raw > NEAR_CULL_Z, tz_raw, torch.ones_like(tz_raw))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(tX / tz, -limx, limx) * tz
    ty = torch.clamp(tY / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j02 = focal_x * inv_z, -focal_x * tx * inv_z2
    j11, j12 = focal_y * inv_z, -focal_y * ty * inv_z2
    a0 = j00 * W[0, 0] + j02 * W[2, 0]
    a1 = j00 * W[0, 1] + j02 * W[2, 1]
    a2 = j00 * W[0, 2] + j02 * W[2, 2]
    b0 = j11 * W[1, 0] + j12 * W[2, 0]
    b1 = j11 * W[1, 1] + j12 * W[2, 1]
    b2 = j11 * W[1, 2] + j12 * W[2, 2]
    sa0 = sxx * a0 + sxy * a1 + sxz * a2
    sa1 = sxy * a0 + syy * a1 + syz * a2
    sa2 = sxz * a0 + syz * a1 + szz * a2
    sb0 = sxx * b0 + sxy * b1 + sxz * b2
    sb1 = sxy * b0 + syy * b1 + syz * b2
    sb2 = sxz * b0 + syz * b1 + szz * b2
    cxx = a0 * sa0 + a1 * sa1 + a2 * sa2 + LOWPASS
    cxy = b0 * sa0 + b1 * sa1 + b2 * sa2
    cyy = b0 * sb0 + b1 * sb1 + b2 * sb2
    return cxx, cxy, cyy


def _trunc_clip(x, hi: int):
    """clip(int32(x), 0, hi) with truncation toward zero. Clamping the
    float to [-1, hi + 1] first gives the same result for every finite x
    and keeps the conversion defined for huge or NaN inputs."""
    x = torch.nan_to_num(x, nan=-1.0)
    return torch.clamp(torch.clamp(x, -1.0, hi + 1.0).to(torch.int32),
                       0, hi)


@dataclasses.dataclass(frozen=True)
class PreprocessedCols:
    """Per-Gaussian screen-space columns, each (N,)."""
    depth: torch.Tensor
    valid: torch.Tensor
    mx: torch.Tensor
    my: torch.Tensor
    ca: torch.Tensor
    cb: torch.Tensor
    cc: torch.Tensor
    v1x: torch.Tensor
    v1y: torch.Tensor
    v2x: torch.Tensor
    v2y: torch.Tensor
    len1: torch.Tensor
    len2: torch.Tensor
    rx0: torch.Tensor     # int32 tile rect, min inclusive
    ry0: torch.Tensor
    rx1: torch.Tensor     # int32 tile rect, max exclusive
    ry1: torch.Tensor
    tnum: torch.Tensor    # int32 tiles in the rect (0 when invalid)


def preprocess_cols(means3d, scales, rotations, camera,
                    scale_modifier: float = 1.0) -> PreprocessedCols:
    W, H = camera.width, camera.height
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE

    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    WV = camera.world_view
    FP = camera.full_proj
    depth = WV[2, 0] * mx + WV[2, 1] * my + WV[2, 2] * mz + WV[2, 3]
    hx = FP[0, 0] * mx + FP[0, 1] * my + FP[0, 2] * mz + FP[0, 3]
    hy = FP[1, 0] * mx + FP[1, 1] * my + FP[1, 2] * mz + FP[1, 3]
    hw = FP[3, 0] * mx + FP[3, 1] * my + FP[3, 2] * mz + FP[3, 3]
    in_front = depth > NEAR_CULL_Z
    hw_safe = torch.where(in_front, hw + 1e-7, torch.ones_like(hw))
    p_w = 1.0 / hw_safe
    p_x = hx * p_w
    p_y = hy * p_w

    sig = _cov3d_cols(scales, rotations, scale_modifier)
    cxx, cxy, cyy = _cov2d_from_cols(means3d, sig, WV, camera.focal_x,
                                     camera.focal_y, camera.tan_fovx,
                                     camera.tan_fovy)
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    det_inv = 1.0 / safe_det

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - safe_det, min=0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))

    px = ((p_x + 1.0) * W - 1.0) * 0.5          # ndc2pix
    py = ((p_y + 1.0) * H - 1.0) * 0.5

    rx0 = _trunc_clip((px - radius_f) / TILE, grid_x)
    ry0 = _trunc_clip((py - radius_f) / TILE, grid_y)
    rx1 = _trunc_clip((px + radius_f + TILE - 1) / TILE, grid_x)
    ry1 = _trunc_clip((py + radius_f + TILE - 1) / TILE, grid_y)
    tiles_touched = (rx1 - rx0) * (ry1 - ry0)

    valid = in_front & det_ok & (tiles_touched > 0)
    tiles_touched = torch.where(valid, tiles_touched,
                                torch.zeros_like(tiles_touched))

    # OBB principal axes; zero lengths mark single-tile rects, whose OBB
    # test is skipped.
    multi = tiles_touched > 1
    a1 = cxx - lambda1
    a2 = cxx - lambda2
    n1 = torch.rsqrt(torch.clamp(cxy * cxy + a1 * a1, min=1e-20))
    n2 = torch.rsqrt(torch.clamp(cxy * cxy + a2 * a2, min=1e-20))
    zero = torch.zeros_like(lambda1)
    len1 = torch.where(multi, 3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)),
                       zero)
    len2 = torch.where(multi, 3.0 * torch.sqrt(torch.clamp(lambda2, min=0.0)),
                       zero)

    return PreprocessedCols(
        depth=depth, valid=valid, mx=px, my=py,
        ca=cyy * det_inv, cb=-cxy * det_inv, cc=cxx * det_inv,
        v1x=-cxy * n1, v1y=a1 * n1, v2x=-cxy * n2, v2y=a2 * n2,
        len1=len1, len2=len2,
        rx0=rx0, ry0=ry0, rx1=rx1, ry1=ry1,
        tnum=tiles_touched)
