"""Quality metrics: PSNR, SSIM, HVS (uniform and foveated) and LPIPS
(counterpart of fovsplat/eval/metrics.py).

Each takes numpy arrays or tensors, (H, W, 3) or (B, H, W, 3), and returns
a Python float, so each call waits for the device. A tensor render keeps
its device and the ground truth is moved there; a numpy render goes to
the GPU (raising without CUDA, as every entry point of the port does).

LPIPS needs pretrained VGG features. Without the weights file `lpips()`
returns None and the JSON writers record null, as in the JAX package. The
path comes from FOVSPLAT_LPIPS_WEIGHTS, read at import, or defaults to
fovsplat_torch/eval/data/lpips_vgg.npz.

On the card SSIM and LPIPS run as CUDA graphs, one per input shape (JAX
jits them, train/losses.py:65 and eval/lpips_jax.py:36); the float is
read after the replay. PSNR and the HVS metrics run eagerly, as in the
JAX package.
"""

from __future__ import annotations

import os

import torch

from fovsplat_torch.ops.kernels import hvs_loss
from fovsplat_torch.perception import foveated_loss, metameric
from fovsplat_torch.train import losses
from fovsplat_torch.utils import graphs
from fovsplat_torch.utils.device import resolve_device

LPIPS_WEIGHTS = os.environ.get(
    "FOVSPLAT_LPIPS_WEIGHTS",
    os.path.join(os.path.dirname(__file__), "data", "lpips_vgg.npz"))


def _pair(a, b):
    """(a, b) as f32 tensors on a's device (the GPU for a numpy a)."""
    dev = a.device if torch.is_tensor(a) else resolve_device(None)
    return (torch.as_tensor(a, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev))


def psnr(a, b) -> float:
    return float(losses.psnr(*_pair(a, b)))


# losses.ssim keyed by the shapes, the window size and `robust`.
_ssim = graphs.graphed_fn(
    lambda a, b, size, robust: losses.ssim(a, b, size, robust=robust),
    n_static=2)


def ssim(a, b) -> float:
    return float(_ssim(*_pair(a, b), 11, False))


def hvs_uniform(a, b, pooling_size: float = 1.0, loss_type: str = "MSE") -> float:
    """Uniform-HVS metric (HVSLoss.calc_uniform_loss, hvs_loss_calc.py:66-70)."""
    a, b = _pair(a, b)
    with torch.no_grad():
        return float(hvs_loss.uniform_loss(a, b, pooling_size,
                                           loss_type=loss_type))


def hvs_fov(a, b, gaze=(0.5, 0.5), alpha: float = 0.05) -> float:
    """Foveated HVS metric (HVSLoss.calc_fov_loss, hvs_loss_calc.py:72-75:
    alpha 0.05, width 1.0, distance 0.5, MSE)."""
    a, b = _pair(a, b)
    with torch.no_grad():
        return float(foveated_loss.metameric_loss_fov(
            metameric.resize_for_pyramid(a), metameric.resize_for_pyramid(b),
            gaze=gaze, alpha=alpha))


_lpips_net = None


def lpips(a, b) -> float | None:
    """LPIPS-vgg where the weights file exists, else None."""
    global _lpips_net
    if _lpips_net is None:
        if not os.path.exists(LPIPS_WEIGHTS):
            return None
        from fovsplat_torch.eval import lpips_torch
        _lpips_net = lpips_torch.LPIPS(LPIPS_WEIGHTS)
    return float(_lpips_net(*_pair(a, b)))


def image_metrics(render, gt, hvs: bool = True) -> dict:
    """Per-view metric dict in the reference's quality_metrics.py layout."""
    render, gt = _pair(render, gt)
    render = torch.clamp(render, 0, 1)
    out = {"ssim": ssim(render, gt), "psnr": psnr(render, gt),
           "lpips": lpips(render, gt)}
    if hvs:
        out["hvs"] = hvs_uniform(render, gt, 1.0)
    return out
