"""Per-Gaussian projection (fovsplat/ops/projection.py): preprocess_cols
on (N,) columns and its helpers, quat_to_rotmat, and the stacked form of
the XLA route, preprocess / Preprocessed with compute_cov3d,
compute_cov2d (a precomputed 3D covariance) and ndc2pix.

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

On the card, rasterize's kernel route runs this projection and the SH
colour as kernel 10 (csrc/project_sh.cu, ops/kernels/project_sh), forward
and backward; preprocess_cols and sh.sh_to_rgb are its plain twin there,
and CPU tensors run them. The frame and stats paths, the XLA route and
eval/mmfr call preprocess_cols directly.
"""

from __future__ import annotations

import dataclasses

import torch

TILE = 16
NEAR_CULL_Z = 0.2
LOWPASS = 0.3


def quat_to_rotmat(q):
    """(..., 4) wxyz quaternion (assumed normalized) -> (..., 3, 3)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


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


def compute_cov3d(scales, rotations, scale_modifier: float = 1.0):
    """(N, 3) activated scales and (N, 4) unit quaternions -> (N, 3, 3)
    world covariance R diag(s)^2 R^T."""
    R = quat_to_rotmat(rotations)
    M = R * (scales * scale_modifier)[..., None, :]        # R @ diag(s)
    return M @ M.transpose(-1, -2)


def compute_cov2d(means3d, cov3d, world_view, focal_x, focal_y, tan_fovx,
                  tan_fovy):
    """EWA projection of a precomputed (N, 3, 3) covariance: (cxx, cxy,
    cyy) with the +0.3 low-pass."""
    s = cov3d
    return _cov2d_from_cols(means3d, (s[:, 0, 0], s[:, 0, 1], s[:, 0, 2],
                                      s[:, 1, 1], s[:, 1, 2], s[:, 2, 2]),
                            world_view, focal_x, focal_y, tan_fovx, tan_fovy)


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


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
    radius: torch.Tensor  # f32 pixel radius (before the valid mask)


@dataclasses.dataclass(frozen=True)
class Preprocessed:
    """preprocess_cols stacked per Gaussian (the XLA route's layout)."""
    mean2d: torch.Tensor          # (N, 2) pixel-space centre
    depth: torch.Tensor           # (N,) view-space z
    conic: torch.Tensor           # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor          # (N,) i32 pixel radius, 0 when invalid
    valid: torch.Tensor           # (N,) bool
    eigen_len: torch.Tensor       # (N, 2) 3-sigma lengths (0: one tile)
    eigen_vec: torch.Tensor       # (N, 2, 2) unit principal axes (rows)
    rect_min: torch.Tensor        # (N, 2) i32 tile rect min, inclusive
    rect_max: torch.Tensor        # (N, 2) i32 tile rect max, exclusive
    tiles_touched: torch.Tensor   # (N,) i32 tiles in the rect


def preprocess(means3d, scales, rotations, camera,
               scale_modifier: float = 1.0, cov3d_precomp=None,
               live_mask=None) -> Preprocessed:
    """preprocess_cols, stacked (projection.py:175-202)."""
    c = preprocess_cols(means3d, scales, rotations, camera,
                        scale_modifier=scale_modifier,
                        cov3d_precomp=cov3d_precomp, live_mask=live_mask)
    return Preprocessed(
        mean2d=torch.stack([c.mx, c.my], -1),
        depth=c.depth,
        conic=torch.stack([c.ca, c.cb, c.cc], -1),
        radius=torch.where(c.valid, c.radius,
                           torch.zeros_like(c.radius)).to(torch.int32),
        valid=c.valid,
        eigen_len=torch.stack([c.len1, c.len2], -1),
        eigen_vec=torch.stack([torch.stack([c.v1x, c.v1y], -1),
                               torch.stack([c.v2x, c.v2y], -1)], -2),
        rect_min=torch.stack([c.rx0, c.ry0], -1),
        rect_max=torch.stack([c.rx1, c.ry1], -1),
        tiles_touched=c.tnum)


def preprocess_cols(means3d, scales, rotations, camera,
                    scale_modifier: float = 1.0, cov3d_precomp=None,
                    live_mask=None) -> PreprocessedCols:
    """live_mask: optional (N,) bool; rows marked False are culled (the
    capacity-padded training state prunes through it). cov3d_precomp:
    optional (N, 3, 3) world covariances, used in place of scales and
    rotations.

    Autograd through the differentiable outputs (mx, my, ca, cb, cc) stays
    finite on culled rows: every division and square root that a culled
    row could hit reads a safe operand chosen by torch.where (hw_safe,
    tz, safe_det), and torch.where sends a zero gradient to the branch it
    did not take, so no 0 * inf reaches the inputs."""
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

    if cov3d_precomp is None:
        sig = _cov3d_cols(scales, rotations, scale_modifier)
        cxx, cxy, cyy = _cov2d_from_cols(means3d, sig, WV, camera.focal_x,
                                         camera.focal_y, camera.tan_fovx,
                                         camera.tan_fovy)
    else:
        cxx, cxy, cyy = compute_cov2d(means3d, cov3d_precomp, WV,
                                      camera.focal_x, camera.focal_y,
                                      camera.tan_fovx, camera.tan_fovy)
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    det_inv = 1.0 / safe_det

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - safe_det, min=0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))

    px = ndc2pix(p_x, W)
    py = ndc2pix(p_y, H)

    rx0 = _trunc_clip((px - radius_f) / TILE, grid_x)
    ry0 = _trunc_clip((py - radius_f) / TILE, grid_y)
    rx1 = _trunc_clip((px + radius_f + TILE - 1) / TILE, grid_x)
    ry1 = _trunc_clip((py + radius_f + TILE - 1) / TILE, grid_y)
    tiles_touched = (rx1 - rx0) * (ry1 - ry0)

    valid = in_front & det_ok & (tiles_touched > 0)
    if live_mask is not None:
        valid = valid & live_mask
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
        tnum=tiles_touched, radius=radius_f)
