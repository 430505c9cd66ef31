"""Eccentricity-driven per-tile quality levels (fovsplat/ops/foveation.py),
as torch tensor math on the render device."""

from __future__ import annotations

import dataclasses
import math

import torch

from fovsplat_torch.ops.projection import TILE


@dataclasses.dataclass(frozen=True)
class FoveationConfig:
    fov_num: int = 4
    real_image_width: float = 2.0
    real_viewing_distance: float = 1.0
    sqrt_max_ps: float = math.sqrt(12.0)
    start_blend: float = 0.5
    blend_width: float = 0.5


def _ncd2dir(ncd_x, ncd_y, real_w, real_h, dist):
    x = (ncd_x - 0.5) * real_w
    y = (ncd_y - 0.5) * real_h
    z = torch.full_like(x + y, dist)
    n = torch.sqrt(x * x + y * y + z * z)
    return x / n, y / n, z / n


def ps2level(ps, cfg: FoveationConfig):
    step = (cfg.sqrt_max_ps - 1.0) / (cfg.fov_num - 1)
    return torch.where(ps <= 1.0, torch.zeros_like(ps),
                       (torch.sqrt(torch.clamp(ps, min=1.0)) - 1.0) / step)


def tile_levels_at(tx, ty, gaze, width: int, height: int, alpha,
                   cfg: FoveationConfig = FoveationConfig()) -> torch.Tensor:
    """Fractional foveation level at tile coords (tx, ty). gaze: (2,) f32
    tensor in [0, 1] on the same device."""
    px = tx.float() * TILE + TILE / 2
    py = ty.float() * TILE + TILE / 2
    real_w = cfg.real_image_width
    real_h = height / width * real_w
    dist = cfg.real_viewing_distance

    ncx = px / width
    ncy = py / height
    dx, dy, dz = _ncd2dir(ncx, ncy, real_w, real_h, dist)
    gdx, gdy, gdz = _ncd2dir(gaze[0], gaze[1], real_w, real_h, dist)
    half = torch.full((), 0.5, device=px.device)
    cdx, cdy, cdz = _ncd2dir(half, half, real_w, real_h, dist)

    ecc = torch.arccos(torch.clamp(dx * gdx + dy * gdy + dz * gdz, -1.0, 1.0))
    ecc_center = torch.arccos(torch.clamp(dx * cdx + dy * cdy + dz * cdz,
                                          -1.0, 1.0))

    pooling_rad = alpha * ecc * ecc
    angle_min = ecc_center - pooling_rad * 0.5
    angle_max = ecc_center + pooling_rad * 0.5
    d2pix = torch.sqrt(((ncx - 0.5) * real_w) ** 2
                       + ((ncy - 0.5) * real_h) ** 2 + dist * dist)
    major = (torch.tan(angle_max) - torch.tan(angle_min)) * dist
    minor = 2.0 * d2pix * torch.tan(pooling_rad * 0.5)
    area = math.pi * major * minor * 0.25
    ps = torch.sqrt(torch.clamp(area, min=0.0)) * (width / real_w)
    level = ps2level(ps, cfg)
    return torch.clamp(level, max=cfg.fov_num - 0.1)


def compute_tile_levels(gaze, width: int, height: int, alpha,
                        cfg: FoveationConfig = FoveationConfig()
                        ) -> torch.Tensor:
    """gaze: (2,) f32 tensor in [0, 1]. Returns (grid_y * grid_x,) levels
    on gaze's device."""
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    t = torch.arange(gx * gy, device=gaze.device)
    return tile_levels_at(t % gx, t // gx, gaze, width, height, alpha, cfg)


def compute_tile_level_infos(levels: torch.Tensor, width: int, height: int,
                             cfg: FoveationConfig = FoveationConfig()):
    """Central-difference level gradients (one-sided at the grid edges)
    and the per-tile blending decision. Returns (grad_x, grad_y,
    level_min, blending), each (T,)."""
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    lv = levels.reshape(gy, gx)

    def _grad(l, axis):
        fwd = torch.roll(l, -1, axis) - l
        bwd = l - torch.roll(l, 1, axis)
        ctr = 0.5 * (torch.roll(l, -1, axis) - torch.roll(l, 1, axis))
        n = l.shape[axis]
        idx = torch.arange(n, device=l.device)
        shape = [1, 1]
        shape[axis] = n
        has_lo = (idx > 0).reshape(shape)
        has_hi = (idx < n - 1).reshape(shape)
        zero = torch.zeros_like(l)
        return torch.where(has_lo & has_hi, ctr,
                           torch.where(has_hi, fwd,
                                       torch.where(has_lo, bwd, zero)))

    grad_x = _grad(lv, 1)
    grad_y = _grad(lv, 0)
    max_delta = 0.5 * (torch.abs(grad_x) + torch.abs(grad_y))
    tile_min = lv - max_delta
    tile_min_i = torch.trunc(tile_min)   # CUDA float(int(x)) truncates
    blending = (((tile_min - tile_min_i) > cfg.start_blend)
                & (tile_min_i < cfg.fov_num - 1))
    return (grad_x.reshape(-1), grad_y.reshape(-1), tile_min.reshape(-1),
            blending.reshape(-1))
