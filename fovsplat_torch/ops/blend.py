"""Blend constants and the tile-major to image reshape
(fovsplat/ops/blend.py:34-37,275)."""

from __future__ import annotations

import torch

from fovsplat_torch.ops.projection import TILE

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
PIX = TILE * TILE  # pixels per tile


def tiles_to_image(tile_img: torch.Tensor, grid_x: int, grid_y: int,
                   width: int, height: int) -> torch.Tensor:
    """[num_tiles, PIX, C] tile-major -> (H, W, C) image, cropped to
    width x height."""
    c = tile_img.shape[-1]
    img = tile_img.reshape(grid_y, grid_x, TILE, TILE, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, c)
    return img[:height, :width]
