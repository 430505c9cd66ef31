"""Real-valued spatial steerable pyramid (counterpart of
fovsplat/perception/pyramid.py: load_filters, depthwise_conv,
area_downsample_2x, construct_pyramid, reconstruct_from_pyramid).
Images are (B, H, W, C).

The filters are the public NYU pyrtools steerable-pyramid filters ("full")
and odak's cropped 5x5 variants ("cropped"), in the port's own copy of the
data file (perception/data/sp_filters_nyu.npz).

The depthwise convolutions are written without cuDNN: each filter is
the sum of its k*k shifted, weighted copies of the reflection-padded
image (cross-correlation, as XLA's convolution). cuDNN would run an f32
convolution in TF32 unless the caller turned that off, and the HVS loss
must not depend on a global flag; the shift-adds are f32 on any device,
deterministic, and their backward is shift-adds too. The reflection
padding is slices, flips and a concatenation, whose backward adds the
reflected gradients in a fixed order (F.pad's reflect backward on CUDA
adds them with float atomics, in a varying order). Filters applied to
the same image go through one pass as a bank (filter_bank), so the six
oriented bands of a level cost one set of k*k multiply-adds.

The pyramid reads its filters as device tensors from a per-(device,
dtype) cache (device_filters): a call then copies nothing from the host,
so a CUDA graph can hold it once the cache is filled (before the
capture: metameric.prepare).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

_DATA = Path(__file__).resolve().parent / "data" / "sp_filters_nyu.npz"


@functools.lru_cache(maxsize=None)
def load_filters(n_orientations: int = 6, filter_type: str = "cropped"):
    """{'h0': (k, k), 'l0': (k, k), 'l': (m, m), 'b': (O, k, k)} f32 numpy
    arrays; filter_type "cropped" (the HVS loss's) or "full"."""
    z = np.load(_DATA)
    pre = f"o{n_orientations}_{filter_type}_"
    return {k: np.asarray(z[pre + k], np.float32)
            for k in ("h0", "l0", "l", "b")}


@functools.lru_cache(maxsize=None)
def device_filters(n_orientations: int, filter_type: str, device: str,
                   dtype: torch.dtype):
    """load_filters' arrays as tensors of `dtype` on `device` (a string,
    as str(tensor.device) gives it), plus 'h0l0': h0 and l0 stacked (where
    their shapes agree), the bank construct_pyramid applies first. Filled
    once per key: the one host-to-device copy of the filters."""
    f = load_filters(n_orientations, filter_type)
    out = {k: torch.as_tensor(v, dtype=dtype, device=device)
           for k, v in f.items()}
    if f["h0"].shape == f["l0"].shape:
        out["h0l0"] = torch.as_tensor(np.stack([f["h0"], f["l0"]]),
                                      dtype=dtype, device=device)
    return out


def _reflect_pad(x, dim: int, pad: int):
    """Reflection padding of `pad` along `dim` (F.pad's "reflect"): slices,
    flips and a concatenation, whose backward is deterministic."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, pad).flip(dim), x,
                      x.narrow(dim, n - 1 - pad, pad).flip(dim)], dim)


def filter_bank(x, kernels):
    """x (B, H, W, C), kernels (F, k, k) numpy or a tensor (used as it is
    when it has x's device and dtype) -> (F, B, H', W', C): each kernel
    applied to every channel with reflection padding (k - 1) // 2 on each
    side, as a sum of shifted copies in row-major tap order."""
    nf, k = kernels.shape[0], kernels.shape[-1]
    pad = (k - 1) // 2
    xp = x
    if pad:
        xp = _reflect_pad(_reflect_pad(x, 1, pad), 2, pad)
    h, w = xp.shape[1] - k + 1, xp.shape[2] - k + 1   # (B, H+2p, W+2p, C)
    wt = torch.as_tensor(kernels, dtype=x.dtype, device=x.device)
    out = None
    for i in range(k):
        for j in range(k):
            term = (wt[:, i, j].reshape(nf, 1, 1, 1, 1)
                    * xp[None, :, i:i + h, j:j + w, :])
            out = term if out is None else out + term
    return out


def depthwise_conv(x, kernel):
    """x (B, H, W, C), kernel (k, k) numpy or a tensor applied per
    channel, reflection 'same' (fovsplat/perception/pyramid.py:42)."""
    if not torch.is_tensor(kernel):
        kernel = np.asarray(kernel, np.float32)
    return filter_bank(x, kernel[None])[0]


def area_downsample_2x(x):
    """torch interpolate(scale_factor=0.5, mode='area'): a 2x2 mean."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _downsample(lowpass, f, use_bilinear_downup: bool):
    if use_bilinear_downup:
        return area_downsample_2x(lowpass)
    return depthwise_conv(lowpass, f["l"])[:, ::2, ::2, :]


def construct_pyramid(image, n_levels: int = 5, n_orientations: int = 6,
                      filter_type: str = "cropped",
                      use_bilinear_downup: bool = True,
                      multiple_highpass: bool = False):
    """image (B, H, W, C), H and W divisible by 2^n_levels (callers resize
    first: metameric.resize_for_pyramid). Between levels, a 2x area
    downsampling (use_bilinear_downup, the HVS loss's configuration) or
    the lowpass filter `l` and stride-2 sampling; multiple_highpass adds a
    highpass band 'h' to every level but the last.

    Returns [{'h', 'l', 'b' (list)}, ..., {'l'}], largest first."""
    f = device_filters(n_orientations, filter_type, str(image.device),
                       image.dtype)
    if "h0l0" in f:
        h0, lowpass = filter_bank(image, f["h0l0"])
    else:
        h0, lowpass = (depthwise_conv(image, f["h0"]),
                       depthwise_conv(image, f["l0"]))
    pyramid = [{"h": h0, "l": lowpass, "b": list(filter_bank(lowpass,
                                                              f["b"]))}]
    for _ in range(n_levels - 2):
        lowpass = _downsample(lowpass, f, use_bilinear_downup)
        level = {"l": lowpass, "b": list(filter_bank(lowpass, f["b"]))}
        if multiple_highpass:
            level["h"] = depthwise_conv(lowpass, f["h0"])
        pyramid.append(level)
    pyramid.append({"l": _downsample(lowpass, f, use_bilinear_downup)})
    return pyramid


def reconstruct_from_pyramid(pyr, n_orientations: int = 6,
                             filter_type: str = "cropped",
                             use_bilinear_downup: bool = True):
    """The inverse transform (spatial_steerable_pyramid.py:182-223): per
    level, upsample the lowpass (bilinear, or zero insertion and the
    lowpass filter `l`) and subtract the bands filtered again; then the
    l0 / h0 combination. The cropped 6-orientation `l` is 2x2, so its
    "same" convolution loses a row and a column and the level sizes stop
    matching: that combination raises, as it does in the JAX package."""
    from fovsplat_torch.perception.metameric import bilinear_upsample
    f = load_filters(n_orientations, filter_type)

    def upsample(img, hw):
        if use_bilinear_downup:
            return bilinear_upsample(img, hw[0], hw[1])
        b, h, w, c = img.shape
        zeros = img.new_zeros((b, h * 2, w * 2, c))
        zeros[:, ::2, ::2, :] = img
        return depthwise_conv(zeros, f["l"])

    image = pyr[-1]["l"]
    for level in reversed(pyr[:-1]):
        image = upsample(image, level["b"][0].shape[1:3])
        for b in range(len(level["b"])):
            image = image + depthwise_conv(level["b"][b], -f["b"][b])
    image = depthwise_conv(image, f["l0"])
    return image + depthwise_conv(pyr[0]["h"], f["h0"])
