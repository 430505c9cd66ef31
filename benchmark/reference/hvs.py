"""The plain reference of the uniform metameric (HVS) loss, in float32
PyTorch: torch's own resampling and convolutions, autograd for the
gradient.

MetaSapiens' mask training (metric_mask_learn.py) with odak's
MetamericLossUniform: the image resized (bilinear) up to a multiple of
2^levels, taken to YCrCb, a real steerable pyramid of `levels` levels
and `orientations` orientations (odak's cropped 5x5 filters, reflection
padding, a 2x area downsampling between levels), and for the highpass
band and each oriented band the local mean and standard deviation over
pooling windows (an area resampling by 1 / pooling size, bilinear back
up; the pooling size halves per level), the last lowpass entering raw.
The loss is the mean over the maps of the mean absolute (L1) or squared
(MSE) gap.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.nn.functional as F

_FILTERS = Path(__file__).resolve().parent / "sp_filters_o6_cropped.json"


def filters(device, dtype) -> dict:
    d = json.loads(_FILTERS.read_text())
    return {k: torch.tensor(d[k], dtype=torch.float32).to(device, dtype)
            for k in ("h0", "l0", "l", "b")}


def _conv(x, kernels):
    """x (1, C, H, W), kernels (F, k, k): each kernel over each channel,
    reflection-padded "same" cross-correlation. Returns (F, 1, C, H, W)."""
    nf, k = kernels.shape[0], kernels.shape[-1]
    c = x.shape[1]
    p = (k - 1) // 2
    xp = F.pad(x, (p, p, p, p), mode="reflect")
    w = kernels[None].expand(c, nf, k, k).reshape(c * nf, 1, k, k)
    y = F.conv2d(xp, w, groups=c)                     # (1, C * F, H, W)
    return y.reshape(1, c, nf, *y.shape[2:]).permute(2, 0, 1, 3, 4)


def _blur(x, ps):
    if ps == 1:
        return x
    h, w = x.shape[-2:]
    small = F.adaptive_avg_pool2d(x, (max(int(h / ps), 1),
                                      max(int(w / ps), 1)))
    return F.interpolate(small, size=(h, w), mode="bilinear",
                         align_corners=False)


def _stats(band, ps):
    mean = _blur(band, ps)
    meansq = _blur(band * band, ps)
    return [mean, torch.sqrt(torch.clamp(meansq - mean * mean, min=1e-7))]


def statsmaps(img, pooling: float, levels: int, flt: dict) -> list:
    """img (H, W, 3) RGB -> the list of statistics maps."""
    x = img.permute(2, 0, 1)[None]
    h, w = x.shape[-2:]
    d = 2 ** levels
    rh, rw = -(-h // d) * d, -(-w // d) * d
    if (rh, rw) != (h, w):
        x = F.interpolate(x, size=(rh, rw), mode="bilinear",
                          align_corners=False)
    r, g, b = x[:, 0:1], x[:, 1:2], x[:, 2:3]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    x = torch.cat([y, 0.5 + 0.713 * (r - y), 0.5 + 0.564 * (b - y)], 1)
    h0, low = _conv(x, torch.stack([flt["h0"], flt["l0"]]))
    out = _stats(h0, pooling)
    ps = pooling
    for lv in range(levels - 1):
        if lv > 0:
            low = F.avg_pool2d(low, 2)
        for band in _conv(low, flt["b"]):
            out += _stats(band, ps)
        ps = ps / 2
    out.append(F.avg_pool2d(low, 2))
    return out


def loss(img, target_stats: list, pooling: float, levels: int, flt: dict,
         loss_type: str = "L1"):
    a = statsmaps(img, pooling, levels, flt)
    total = 0.0
    for x, t in zip(a, target_stats):
        d = x - t
        total = total + (torch.mean(d * d) if loss_type == "MSE"
                         else torch.mean(torch.abs(d)))
    return total / len(a)
