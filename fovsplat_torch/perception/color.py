"""Colour conversions (counterpart of fovsplat/perception/color.py).

Parity: metamer/odak_perception/color_conversion.py:382-430 (the
ITU-R-style YCrCb of every metameric loss). Images are (..., H, W, 3)
floats in [0, 1].
"""

from __future__ import annotations

import torch


def rgb_to_ycrcb(image: torch.Tensor) -> torch.Tensor:
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = 0.5 + 0.713 * (r - y)
    cb = 0.5 + 0.564 * (b - y)
    return torch.stack([y, cr, cb], dim=-1)


def ycrcb_to_rgb(image: torch.Tensor) -> torch.Tensor:
    y, cr, cb = image[..., 0], image[..., 1], image[..., 2]
    r = y + 1.403 * (cr - 0.5)
    g = y - 0.714 * (cr - 0.5) - 0.344 * (cb - 0.5)
    b = y + 1.773 * (cb - 0.5)
    return torch.stack([r, g, b], dim=-1)
