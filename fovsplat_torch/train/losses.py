"""Image losses: L1 (mean and per-pixel map), L2, PSNR, SSIM and the
photometric training loss (counterpart of fovsplat/train/losses.py).

Parity: fov3dgs/utils/loss_utils.py (11x11 sigma-1.5 Gaussian window SSIM,
C1 = 0.01^2, C2 = 0.03^2) and utils/image_utils.py:17 (PSNR). Images are
(H, W, C) or batched (B, H, W, C), float in [0, 1].

The SSIM blur is the JAX package's separable shift-add form in f32 (the
same tap sums in the same order), not a convolution: cuDNN would run an
f32 convolution in TF32 unless the caller turned that off, and the loss
must not depend on a global flag. That code is the plain twin of kernels
13 and 13b (ops/kernels/ssim.py), which take every image pair on the
card; CPU tensors take the twin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def l1_loss_map(a, b):
    return torch.abs(a - b)


def l2_loss(a, b):
    return torch.mean((a - b) ** 2)


def psnr(a, b):
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_1d(size: int = 11, sigma: float = 1.5, device=None):
    xs = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _depthwise_blur(img, g):
    """img (B, H, W, C), g (k,) 1-D Gaussian -> same-padded separable blur
    by shift-adds over (B*C, H, W): along W, then along H."""
    b, h, w, c = img.shape
    k = g.shape[0]
    pad = k // 2
    x = img.permute(0, 3, 1, 2).reshape(b * c, h, w)
    xp = F.pad(x, (pad, pad))
    out = g[0] * xp[:, :, 0:w]
    for i in range(1, k):
        out = out + g[i] * xp[:, :, i:i + w]
    xp = F.pad(out, (0, 0, pad, pad))
    out = g[0] * xp[:, 0:h, :]
    for i in range(1, k):
        out = out + g[i] * xp[:, i:i + h, :]
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def ssim(a, b, size: int = 11, sigma: float = 1.5, robust: bool = False):
    """Mean SSIM (loss_utils.py:36-76: per-channel window, same padding).

    robust=True clamps the variances at 0 and the covariance by
    Cauchy-Schwarz, which bounds each pixel's SSIM to [-1, 1]; the quality
    gates of the prune and mask loops use it (fovsplat/train/losses.py:
    66-95), the training loss does not.

    CPU tensors take the shift-add twin, ssim_plain; tensors on the card
    kernels 13 and 13b (ops/kernels/ssim.ssim: float32, 3 channels, the
    11-tap window, or it raises)."""
    if a.device.type == "cpu":
        return ssim_plain(a, b, size, sigma, robust)
    from fovsplat_torch.ops.kernels import ssim as kernel
    return kernel.ssim(a, b, size, sigma, robust)


def ssim_plain(a, b, size: int = 11, sigma: float = 1.5,
               robust: bool = False):
    """ssim's plain twin on any device: the five separable shift-add
    blurs (_depthwise_blur), the map, its mean."""
    if a.dim() == 3:
        a = a[None]
        b = b[None]
    w = _gaussian_1d(size, sigma, a.device)
    mu1 = _depthwise_blur(a, w)
    mu2 = _depthwise_blur(b, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _depthwise_blur(a * a, w) - mu1_sq
    s2 = _depthwise_blur(b * b, w) - mu2_sq
    s12 = _depthwise_blur(a * b, w) - mu12
    if robust:
        s1 = torch.clamp(s1, min=0.0)
        s2 = torch.clamp(s2, min=0.0)
        lim = torch.sqrt(s1 * s2)
        s12 = torch.clamp(s12, -lim, lim)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = (((2 * mu12 + c1) * (2 * s12 + c2))
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return torch.mean(m)


def photometric_loss(render, gt, lambda_dssim: float = 0.2):
    """The reference training loss: (1 - l) * L1 + l * (1 - SSIM)
    (eff_finetune.py:124-125, prune.py:252-254)."""
    return ((1.0 - lambda_dssim) * l1_loss(render, gt)
            + lambda_dssim * (1.0 - ssim(render, gt)))
