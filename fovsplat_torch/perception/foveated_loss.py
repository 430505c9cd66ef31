"""Gaze-contingent (foveated) metameric loss (counterpart of
fovsplat/perception/foveated_loss.py: make_pooling_size_map_pixels,
make_lod_map, radially_varying_blur, statsmaps_fov, metameric_loss_fov).

Parity targets: metamer/odak_perception/metameric_loss.py (MetamericLoss
as HVSLoss configures it, hvs_loss_calc.py:34-49: quadratic mode, no
radial weighting), radially_varying_blur.py (the mipmap LOD blur) and
foveation.py (the pooling-size maps). Images are (B, H, W, C).

The mip chain is built on metameric.adaptive_area_downsample and
bilinear_upsample, the gather-sum autograd Functions of the uniform loss,
so no cuDNN, TF32 or float atomic enters. Maps are f32 on the image's
device, computed in the JAX package's operation order.
"""

from __future__ import annotations

import math

import torch

from fovsplat_torch.perception import color, metameric, pyramid
from fovsplat_torch.utils.device import resolve_device


def _linspace(start: float, stop: float, num: int, device):
    """jnp.linspace in f32: start (1 - s) + stop s with s = i / (num - 1),
    the last point exactly `stop`."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    s = (torch.arange(num - 1, dtype=torch.float32, device=device)
         / float(num - 1))
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def make_pooling_size_map_pixels(gaze, height: int, width: int, alpha,
                                 real_image_width: float,
                                 real_viewing_distance: float,
                                 mode: str = "quadratic", device=None):
    """(H, W) pooling sizes in pixels (foveation.py:94-146). gaze: two
    floats (or a (2,) tensor) in [0, 1]. As in the reference, the ellipse's
    major axis spans the pooling angle around the centre's eccentricity,
    not the pixel's."""
    dev = resolve_device(device)
    real_h = real_image_width / width * height
    xs = _linspace(-0.5, 0.5, width, dev) * real_image_width
    ys = _linspace(-0.5, 0.5, height, dev) * real_h
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    Z = torch.full_like(X, real_viewing_distance)
    dist = torch.sqrt(X * X + Y * Y + Z * Z)
    dirx, diry, dirz = X / dist, Y / dist, Z / dist

    def ecc_from(gx, gy):
        g3 = torch.stack([(gx * 2 - 1) * real_image_width * 0.5,
                          (gy * 2 - 1) * real_h * 0.5,
                          torch.tensor(real_viewing_distance,
                                       dtype=torch.float32, device=dev)])
        g3 = g3 / torch.linalg.vector_norm(g3)
        dot = dirx * g3[0] + diry * g3[1] + dirz * g3[2]
        return torch.arccos(torch.clamp(dot, -1.0, 1.0))

    g = torch.as_tensor(gaze, dtype=torch.float32, device=dev)
    half = torch.tensor(0.5, dtype=torch.float32, device=dev)
    ecc = ecc_from(g[0], g[1])
    ecc_centre = ecc_from(half, half)
    pooling_rad = alpha * ecc
    if mode == "quadratic":
        pooling_rad = pooling_rad * ecc
    angle_min = ecc_centre - pooling_rad * 0.5
    angle_max = ecc_centre + pooling_rad * 0.5
    major = (torch.tan(angle_max) - torch.tan(angle_min)) \
        * real_viewing_distance
    minor = 2 * dist * torch.tan(pooling_rad * 0.5)
    area = torch.abs(math.pi * major * minor * 0.25)
    return torch.sqrt(area) / real_image_width * width


def make_lod_map(gaze, height, width, alpha, real_image_width,
                 real_viewing_distance, mode="quadratic", device=None):
    """(H, W) mip level: max(log2(1e-6 + pooling size), 0)."""
    ps = make_pooling_size_map_pixels(gaze, height, width, alpha,
                                      real_image_width,
                                      real_viewing_distance, mode, device)
    return torch.clamp(torch.log2(1e-6 + ps), min=0.0)


def radially_varying_blur(image, lod_map):
    """The mipmap LOD blur (radially_varying_blur.py:100-140): image (B, H,
    W, C), lod_map (H, W). Mips halve (area pooling, odd sizes rounding
    down) while both sides exceed 1, then the reference's tail: a width
    of 2 is averaged to 1, and a height of 2 appends the mean over the
    height of the mip BEFORE the last one. Each pixel blends the two mips
    around its LOD, upsampled bilinearly; the last mip enters as its
    mean."""
    b, h, w, c = image.shape
    mips = [image]
    while mips[-1].shape[1] > 1 and mips[-1].shape[2] > 1:
        mh, mw = mips[-1].shape[1], mips[-1].shape[2]
        mips.append(metameric.adaptive_area_downsample(
            mips[-1], max(mh // 2, 1), max(mw // 2, 1)))
    if mips[-1].shape[2] == 2:
        mips.append(torch.mean(mips[-1], dim=2, keepdim=True))
    if mips[-1].shape[1] == 2:
        mips.append(torch.mean(mips[-2], dim=1, keepdim=True))

    full = [mips[0]]
    for m in mips[1:-1]:
        full.append(metameric.bilinear_upsample(m, h, w))
    last = mips[-1]
    if last.shape[1] * last.shape[2] > 1:
        last = torch.mean(last, dim=(1, 2), keepdim=True)
    full.append(last.expand(image.shape))

    n = len(full)
    lod = lod_map[None, :, :, None]
    frac = torch.remainder(lod, 1.0)
    out = torch.zeros_like(image)
    for lv in range(n):
        if lv == 0:
            mask = lod < (lv + 1)
        elif lv == n - 1:
            mask = lod >= lv
        else:
            mask = (lod >= lv) & (lod < (lv + 1))
        if lv == n - 1:
            blended = full[lv]
        else:
            blended = (1 - frac) * full[lv] + frac * full[lv + 1]
        out = torch.where(mask, blended, out)
    return out


def statsmaps_fov(image, gaze, alpha: float = 0.05,
                  real_image_width: float = 1.0,
                  real_viewing_distance: float = 0.5,
                  n_levels: int = 5, n_orientations: int = 6,
                  colorspace: str = "RGB", mode: str = "quadratic"):
    """Foveated stats maps (metameric_loss.py calc_statsmaps, HVSLoss's
    configuration): each band's local mean and std under the radially
    varying blur, with an LOD map per pyramid level at that level's
    size; the lowpass residual enters raw."""
    if image.dim() == 3:
        image = image[None]
    if image.shape[-1] == 3 and colorspace == "RGB":
        image = color.rgb_to_ycrcb(image)
    pyr = pyramid.construct_pyramid(image, n_levels, n_orientations)

    lod_cache = {}

    def blur(x):
        hh, ww = x.shape[1], x.shape[2]
        if (hh, ww) not in lod_cache:
            lod_cache[(hh, ww)] = make_lod_map(
                gaze, hh, ww, alpha, real_image_width,
                real_viewing_distance, mode, device=x.device)
        return radially_varying_blur(x, lod_cache[(hh, ww)])

    def find_stats(band):
        means = blur(band)
        meansq = blur(band * band)
        variances = torch.clamp(meansq - means * means, min=1e-7)
        return [means, torch.sqrt(variances)]

    out = find_stats(pyr[0]["h"])
    for level in pyr[:-1]:
        for band in level["b"]:
            out += find_stats(band)
    out.append(pyr[-1]["l"])
    return out


def metameric_loss_fov(image, target, gaze=(0.5, 0.5), alpha: float = 0.05,
                       real_image_width: float = 1.0,
                       real_viewing_distance: float = 0.5,
                       n_levels: int = 5, n_orientations: int = 6,
                       loss_type: str = "MSE", target_stats=None):
    """HVSLoss.calc_fov_loss (hvs_loss_calc.py:72-75). Pass precomputed
    `target_stats` to skip the target's pyramid."""
    a = statsmaps_fov(image, gaze, alpha, real_image_width,
                      real_viewing_distance, n_levels, n_orientations)
    if target_stats is None:
        target_stats = statsmaps_fov(target, gaze, alpha, real_image_width,
                                     real_viewing_distance, n_levels,
                                     n_orientations)
    return metameric.loss_from_stats(a, target_stats, loss_type)
