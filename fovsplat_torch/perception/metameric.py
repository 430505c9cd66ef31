"""Uniform metameric (HVS) loss (counterpart of
fovsplat/perception/metameric.py: adaptive_area_downsample,
bilinear_upsample, uniform_blur, statsmaps, loss_from_stats,
metameric_loss_uniform, resize_for_pyramid, gen_metamer, metamer_mse_loss
and blur_loss).

Parity target: metamer/odak_perception/metameric_loss_uniform.py as the
reference's training and eval scripts use it (bilinear down/up, 5
levels, 6 orientations; L1 for mask training, MSE for eval). For the
highpass band and each oriented band of each level, the mean and std
over `pooling_size` windows (area-downsample by 1/ps, then bilinear back
up); the pooling size halves per level and the final lowpass residual
enters raw. Images are (B, H, W, C) or (H, W, C).

Both resamplings (area pooling and bilinear resize) are separable linear
maps, applied one axis at a time as gathers and sums (_Resample): the
JAX package's integral images and resize matrices compute the same maps,
and so do torch's adaptive_avg_pool2d and bilinear interpolate, whose
CUDA backward passes accumulate with float atomics. The gathers make the
HVS gradient deterministic on the card.

The gather tables are built on the host and copied to the device once per
(kind, sizes, device) (_resample_map's cache). A CUDA graph cannot hold
that copy, so prepare fills every table (and the pyramid's filters) that
an HVS loss or view at one image size and pooling size reads, before a
graph's warm-up.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fovsplat_torch.perception import color, pyramid


def _tables(m: np.ndarray, device):
    """Gather tables of the banded (out, in) matrix m: (idx (out, K) i64,
    w (out, K) f32), K the most nonzeros of a row; padding taps read
    index 0 with weight 0."""
    nz = m != 0
    k = max(int(nz.sum(1).max()), 1)
    idx = np.zeros((m.shape[0], k), np.int64)
    w = np.zeros((m.shape[0], k), np.float32)
    for i in range(m.shape[0]):
        cols = np.nonzero(nz[i])[0]
        idx[i, :cols.size] = cols
        w[i, :cols.size] = m[i, cols]
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device))


@functools.lru_cache(maxsize=None)
def _resample_map(kind: str, n_in: int, n_out: int, device: str):
    """(forward tables, divisors (out,), transposed tables) of one axis.
    kind "area": adaptive average pooling, the sum over the bin [floor(i *
    in / out), ceil((i + 1) * in / out)) divided by its length (bins
    computed in f32, as metameric.py:43-44 does). kind "bilinear":
    align_corners=False, the source coordinate max(s * (i + 0.5) - 0.5,
    0) with s = in / out in f32, as torch computes it."""
    m = np.zeros((n_out, n_in), np.float32)
    d = np.ones(n_out, np.float32)
    i = np.arange(n_out)
    if kind == "area":
        starts = np.floor((i * n_in).astype(np.float32)
                          / np.float32(n_out)).astype(np.int64)
        ends = np.ceil(((i + 1) * n_in).astype(np.float32)
                       / np.float32(n_out)).astype(np.int64)
        for r in range(n_out):
            m[r, starts[r]:ends[r]] = 1.0
        d = (ends - starts).astype(np.float32)
    else:
        s = np.float32(n_in) / np.float32(n_out)
        src = np.maximum(s * (i.astype(np.float32) + np.float32(0.5))
                         - np.float32(0.5), np.float32(0.0))
        i0 = src.astype(np.int64)
        i1 = i0 + (i0 < n_in - 1)
        l1 = src - i0.astype(np.float32)
        np.add.at(m, (i, i0), np.float32(1.0) - l1)
        np.add.at(m, (i, i1), l1)
    return (_tables(m, device), torch.as_tensor(d, device=device),
            _tables(np.ascontiguousarray(m.T), device))


def _gather_sum(x, dim: int, idx, w):
    n_out, k = idx.shape
    g = x.index_select(dim, idx.reshape(-1))
    shape = list(x.shape)
    shape[dim:dim + 1] = [n_out, k]
    wshape = [1] * len(shape)
    wshape[dim], wshape[dim + 1] = n_out, k
    return (g.reshape(shape) * w.reshape(wshape)).sum(dim + 1)


def _along(v, dim: int, ndim: int):
    shape = [1] * ndim
    shape[dim] = v.shape[0]
    return v.reshape(shape)


class _Resample(torch.autograd.Function):
    """y = (M x) / d along one axis, M banded: gathers and a sum over the
    band. The backward is M's transpose applied the same way to g / d."""

    @staticmethod
    def forward(ctx, x, dim, fwd, d, bwd):
        ctx.dim, ctx.d, ctx.bwd = dim, d, bwd
        return _gather_sum(x, dim, *fwd) / _along(d, dim, x.dim())

    @staticmethod
    def backward(ctx, g):
        g = g / _along(ctx.d, ctx.dim, g.dim())
        return _gather_sum(g, ctx.dim, *ctx.bwd), None, None, None, None


def _resample(x, kind: str, out_h: int, out_w: int):
    """(B, H, W, C) -> (B, out_h, out_w, C): along H, then along W."""
    for dim, n_out in ((1, out_h), (2, out_w)):
        fwd, d, bwd = _resample_map(kind, x.shape[dim], n_out, str(x.device))
        x = _Resample.apply(x, dim, fwd, d, bwd)
    return x


def adaptive_area_downsample(x, out_h: int, out_w: int):
    """torch F.interpolate(mode='area'): adaptive average pooling with
    bins [floor(i*H/out), ceil((i+1)*H/out)), also for out > in."""
    return _resample(x, "area", out_h, out_w)


def bilinear_upsample(x, out_h: int, out_w: int):
    """F.interpolate(mode='bilinear', align_corners=False), no
    antialiasing (jax.image.resize(method='linear', antialias=False))."""
    return _resample(x, "bilinear", out_h, out_w)


def _pooled(n: int, pooling_size) -> int:
    return max(int(n / pooling_size), 1)


def uniform_blur(x, pooling_size):
    """uniform_blur (metameric_loss_uniform.py:8-12). The reference applies
    it for pooling sizes below 1 as well (the levels halve the size): an
    area *resample* to int(size / ps), larger than the input, then
    bilinear back. Not an identity; replicated as it is."""
    if pooling_size == 1:
        return x
    _, h, w, _ = x.shape
    oh, ow = _pooled(h, pooling_size), _pooled(w, pooling_size)
    return bilinear_upsample(adaptive_area_downsample(x, oh, ow), h, w)


def _find_stats(band, pooling_size, eps=1e-7):
    means = uniform_blur(band, pooling_size)
    meansq = uniform_blur(band * band, pooling_size)
    variances = torch.clamp(meansq - means * means, min=eps)
    return means, torch.sqrt(variances)


def statsmaps(image, pooling_size, n_levels: int = 5,
              n_orientations: int = 6, colorspace: str = "RGB"):
    """image (B, H, W, C) or (H, W, C); a 3-channel RGB image is taken to
    YCrCb first (colorspace "RGB"), any other enters as it is. Returns the
    list of stats maps."""
    if image.dim() == 3:
        image = image[None]
    if image.shape[-1] == 3 and colorspace == "RGB":
        image = color.rgb_to_ycrcb(image)
    pyr = pyramid.construct_pyramid(image, n_levels, n_orientations)
    out = list(_find_stats(pyr[0]["h"], pooling_size))
    ps = pooling_size
    for level in pyr[:-1]:
        for band in level["b"]:
            out += _find_stats(band, ps)
        ps = ps / 2
    out.append(pyr[-1]["l"])
    return out


def loss_from_stats(stats_a, stats_b, loss_type: str = "L1"):
    total = 0.0
    for a, b in zip(stats_a, stats_b):
        if loss_type == "MSE":
            total = total + torch.mean((a - b) ** 2)
        else:
            total = total + torch.mean(torch.abs(a - b))
    return total / len(stats_a)


def metameric_loss_uniform(image, target, pooling_size, n_levels: int = 5,
                           n_orientations: int = 6, loss_type: str = "L1"):
    """MetamericLossUniform.__call__."""
    return loss_from_stats(
        statsmaps(image, pooling_size, n_levels, n_orientations),
        statsmaps(target, pooling_size, n_levels, n_orientations), loss_type)


def _pyramid_size(h: int, w: int, n_levels: int):
    d = 2 ** n_levels
    return math.ceil(h / d) * d, math.ceil(w / d) * d


def resize_for_pyramid(image, n_levels: int = 5):
    """HVSLoss.resize_img (hvs_loss_calc.py:52-65): bilinear resize up to
    the next multiple of 2^n_levels where needed. Returns (B, H, W, C)."""
    if image.dim() == 3:
        image = image[None]
    _, h, w, _ = image.shape
    rh, rw = _pyramid_size(h, w, n_levels)
    if rh == h and rw == w:
        return image
    return bilinear_upsample(image, rh, rw)


def prepare(height: int, width: int, pooling_size, n_levels: int = 5,
            n_orientations: int = 6, device="cpu"):
    """Fill every resampling table (both directions) and the pyramid's
    filters that resize_for_pyramid and the uniform HVS loss of an
    (height, width) image at `pooling_size` read on `device`, so that the
    HVS step and view then copy nothing from the host (a CUDA graph's
    warm-up and capture must not). Mirrors resize_for_pyramid and
    statsmaps: the highpass band at the pyramid size, then level i at
    size / 2^i with pooling_size / 2^i; at a pooling size of 1 the
    identity's tables, which the kernels of ops/kernels/hvs_loss.py read
    where the twin skips the pooling."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dev = str(dev)
    rh, rw = _pyramid_size(height, width, n_levels)
    if (rh, rw) != (height, width):
        _resample_map("bilinear", height, rh, dev)
        _resample_map("bilinear", width, rw, dev)
    blurs = [(rh, rw, pooling_size)]
    ps = pooling_size
    for lv in range(n_levels - 1):
        blurs.append((rh >> lv, rw >> lv, ps))
        ps = ps / 2
    for h, w, ps in blurs:
        for n in (h, w):
            _resample_map("area", n, _pooled(n, ps), dev)
            _resample_map("bilinear", _pooled(n, ps), n, dev)
    pyramid.device_filters(n_orientations, "cropped", dev, torch.float32)


def gen_metamer(image, pooling_size, n_levels: int = 5,
                n_orientations: int = 6, generator=None, noise=None):
    """A metamer of the RGB image (metameric_loss_uniform.py:160-216, after
    Freeman & Simoncelli): a uniform noise image's pyramid with each band
    matched to the target's local mean and std maps, the target's lowpass
    residual, reconstructed and taken back to RGB.

    noise: a (B, H, W, 3) tensor in [0, 1) on the image's device, or None
    to draw one with `generator` (a torch.Generator on that device; None
    seeds one with 0). JAX's PRNG is not reproduced: to compare with the
    JAX function, pass its jax.random.uniform draw as `noise`."""
    if image.dim() == 3:
        image = image[None]
    ycrcb = color.rgb_to_ycrcb(image)
    stats = statsmaps(ycrcb, pooling_size, n_levels, n_orientations,
                      colorspace="YCrCb")
    means, stds = stats[::2], stats[1::2]
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=image.device).manual_seed(0)
        noise = torch.rand(ycrcb.shape, generator=generator,
                           device=image.device)
    npyr = pyramid.construct_pyramid(noise, n_levels, n_orientations)
    ipyr = pyramid.construct_pyramid(ycrcb, n_levels, n_orientations)

    def match(level, mean_map, std_map):
        level = level - torch.mean(level)
        input_std = torch.clamp(torch.sqrt(torch.mean(level * level)),
                                min=1e-6)
        return level / input_std * std_map + mean_map

    nbands = len(npyr[0]["b"])
    npyr[0]["h"] = match(npyr[0]["h"], means[0], stds[0])
    for lv in range(len(npyr) - 1):
        for b in range(nbands):
            idx = 1 + lv * nbands + b
            npyr[lv]["b"][b] = match(npyr[lv]["b"][b], means[idx],
                                     stds[idx])
    npyr[-1]["l"] = ipyr[-1]["l"]
    metamer = pyramid.reconstruct_from_pyramid(npyr, n_orientations)
    return color.ycrcb_to_rgb(metamer)


def metamer_mse_loss(image, target, pooling_size, n_levels: int = 5,
                     n_orientations: int = 6, generator=None, noise=None):
    """MetamerMSELoss (metamer_mse_loss.py): the MSE against a metamer of
    the target, which carries no gradient."""
    m = gen_metamer(target, pooling_size, n_levels, n_orientations,
                    generator, noise).detach()
    return torch.mean((image - m) ** 2)


def blur_loss(image, target, gaze=(0.5, 0.5), alpha: float = 0.2,
              real_image_width: float = 0.2,
              real_viewing_distance: float = 0.7, blur_source: bool = False):
    """BlurLoss (blur_loss.py): the MSE against the target blurred by the
    radially varying (foveated) blur, optionally blurring the source
    too."""
    from fovsplat_torch.perception import foveated_loss as fl
    if image.dim() == 3:
        image = image[None]
    if target.dim() == 3:
        target = target[None]
    h, w = target.shape[1:3]
    lod = fl.make_lod_map(gaze, h, w, alpha, real_image_width,
                          real_viewing_distance, device=target.device)
    bt = fl.radially_varying_blur(target, lod)
    src = fl.radially_varying_blur(image, lod) if blur_source else image
    return torch.mean((src - bt) ** 2)
