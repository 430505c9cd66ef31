"""Kernels 11-12b: the uniform metameric (HVS) loss on the card, forward
and backward (csrc/hvs_loss.cu), and the autograd.Function that joins
them.

Replaces no Pallas kernel: the JAX package computes this loss with jnp
(fovsplat/perception/metameric.py statsmaps, metameric_loss_uniform;
pyramid.py construct_pyramid). The plain twin is the port's PyTorch code
of perception/metameric.py (resize_for_pyramid, statsmaps,
loss_from_stats, their filter banks and resamplings), unchanged; CPU
tensors take it. uniform_loss is the route: a CUDA float32 image goes to
the kernels, anything else on the card raises.

  11   hvs_level_forward: per band level, one launch for the image and the
       target together: the level's lowpass and the pooled grids S1 =
       A band, S2 = A band^2 of each band (A: the area pooling of
       metameric.uniform_blur);
  11b  hvs_stats_loss: the loss from the grids (bilinear back up, the std,
       the gaps), block partials added in a fixed order;
  12   hvs_stats_backward: per band level, the cotangents of the image's
       grids;
  12b  hvs_level_backward: per band level, coarse to fine, the lowpass's
       gradient; then the image's, through h0, l0, YCrCb and the resize.

pooled_grids_plain and maps_from_grids_plain are kernel 11's and 11b's
functions in the twin's code, for the tests and chip_smoke.py. The
resampling tables are metameric's (_resample_map) and the filters
pyramid.device_filters': metameric.prepare fills both before a CUDA
graph's capture, so a call copies nothing from the host.

Bound on the card, bytes by need: operations for 11 and 12b, bytes for
11b and 12 (the pooled grids); see the source header.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.perception import color, metameric, pyramid

MAXL = 8           # csrc/hvs_loss.cu MAXL: band levels of one 11b launch
N_ORIENT = 6       # csrc/hvs_loss.cu NO
STATS_BLOCK = 256  # csrc/hvs_loss.cu NT: 11b's pixels a block


class _Taps(ctypes.Structure):
    _fields_ = [("idx", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("k", ctypes.c_int)]


class _Axis(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("g", ctypes.c_int), ("area", _Taps),
                ("d", ctypes.c_void_p), ("area_t", _Taps), ("up", _Taps),
                ("up_t", _Taps)]


class _Resize(ctypes.Structure):
    _fields_ = [("h", _Taps), ("w", _Taps), ("h_t", _Taps), ("w_t", _Taps),
                ("h_in", ctypes.c_int), ("w_in", ctypes.c_int)]


class _StatLevel(ctypes.Structure):
    _fields_ = [("grids", ctypes.c_void_p), ("uh", _Taps), ("uw", _Taps),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("gh", ctypes.c_int), ("gw", ctypes.c_int),
                ("nb", ctypes.c_int), ("block0", ctypes.c_int),
                ("wt", ctypes.c_float)]


class _StatLevels(ctypes.Structure):
    _fields_ = [("lv", _StatLevel * MAXL), ("n", ctypes.c_int),
                ("batch", ctypes.c_int)]


def _taps(t) -> _Taps:
    idx, w = t
    return _Taps(idx.data_ptr(), w.data_ptr(), idx.shape[1])


@dataclasses.dataclass(frozen=True)
class _Level:
    h: int
    w: int
    gh: int
    gw: int
    nb: int          # bands: 7 at level 0 (h0 first), 6 after
    ah: _Axis
    aw: _Axis


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernels' view of one (image size, pooling size, levels) on one
    device: the levels' axes and the resize, as ctypes structures that
    point at metameric's resampling tables (held in `keep`)."""
    height: int        # the image's size
    width: int
    rh: int            # the pyramid's
    rw: int
    levels: tuple      # _Level of each band level, largest first
    resize: _Resize
    filters: dict      # pyramid.device_filters
    keep: tuple


def _axis(n: int, ps, dev: str, keep: list) -> _Axis:
    """One axis of a band level at pooling size ps: the area pooling onto
    _pooled(n, ps) bins and the bilinear map back, both directions."""
    g = metameric._pooled(n, ps)
    area, d, area_t = metameric._resample_map("area", n, g, dev)
    up, _, up_t = metameric._resample_map("bilinear", g, n, dev)
    if up[0].shape[1] > 2:   # csrc/hvs_loss.cu reads two bilinear taps
        raise ValueError(f"hvs_loss: {up[0].shape[1]} bilinear taps a row")
    keep.extend([*area, d, *area_t, *up, *up_t])
    return _Axis(n, g, _taps(area), d.data_ptr(), _taps(area_t), _taps(up),
                 _taps(up_t))


@functools.lru_cache(maxsize=None)
def plan(height: int, width: int, pooling_size, n_levels: int,
         device: str) -> Plan:
    """The plan of an (height, width) image at `pooling_size` with
    `n_levels` levels on `device` (a string with the card's index, as
    str(tensor.device)). Host work only once metameric.prepare filled the
    tables."""
    if n_levels < 2 or n_levels - 1 > MAXL:
        raise ValueError(f"hvs_loss: {n_levels} levels; the kernels take "
                         f"2 to {MAXL + 1}")
    rh, rw = metameric._pyramid_size(height, width, n_levels)
    keep = []
    resize = _Resize(h_in=height, w_in=width)
    if (rh, rw) != (height, width):
        fh, _, th = metameric._resample_map("bilinear", height, rh, device)
        fw, _, tw = metameric._resample_map("bilinear", width, rw, device)
        keep.extend([*fh, *th, *fw, *tw])
        resize = _Resize(_taps(fh), _taps(fw), _taps(th), _taps(tw), height,
                         width)
    levels = []
    ps = pooling_size
    for lv in range(n_levels - 1):
        h, w = rh >> lv, rw >> lv
        ah, aw = _axis(h, ps, device, keep), _axis(w, ps, device, keep)
        levels.append(_Level(h, w, ah.g, aw.g, 7 if lv == 0 else 6, ah, aw))
        ps = ps / 2
    f = pyramid.device_filters(N_ORIENT, "cropped", device, torch.float32)
    return Plan(height, width, rh, rw, tuple(levels), resize, f, tuple(keep))


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """Kernel 11's outputs for n_img images: per band level the lowpass
    (n_img, 3, h, w) and the grids (n_img, nb, 2, 3, gh, gw): S1 then S2
    of each band, h0 first at level 0."""
    lows: tuple
    grids: tuple


def _f32_images(what, x, dev):
    x = x[None] if x.dim() == 3 else x
    if x.device != dev or x.dtype != torch.float32 or x.dim() != 4 or \
            x.shape[-1] != 3:
        raise ValueError(f"{what}: a float32 (H, W, 3) or (B, H, W, 3) "
                         f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    return x.contiguous()


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _entry(name, argtypes):
    """(library, entry point) of csrc/hvs_loss.cu, its types declared."""
    lib = _build.load("hvs_loss")
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = I
    return lib, fn


def hvs_level_forward(image, target, p: Plan) -> Pyramid:
    """Kernel 11 at every band level: image and target (B, H, W, 3) float32
    RGB on the card, or target None for the image alone. The pyramid of
    the image(s) and then the target(s)."""
    dev = image.device
    n_a = image.shape[0]
    n_img = n_a + (0 if target is None else target.shape[0])
    b_ptr = image.data_ptr() if target is None else target.data_ptr()
    lib, fn = _entry("fs_hvs_level_fwd",
                     [P, P, I, P, P, P, P, P, P, P, I, P, P, P])
    f = p.filters
    lows, grids, prev = [], [], None
    for lv in p.levels:
        low = torch.empty((n_img, 3, lv.h, lv.w), dtype=torch.float32,
                          device=dev)
        g = torch.empty((n_img, lv.nb, 2, 3, lv.gh, lv.gw),
                        dtype=torch.float32, device=dev)
        err = fn(image.data_ptr(), b_ptr, n_a, ctypes.byref(p.resize),
                 None if prev is None else prev.data_ptr(),
                 ctypes.byref(lv.ah), ctypes.byref(lv.aw),
                 f["h0"].data_ptr(), f["l0"].data_ptr(), f["b"].data_ptr(),
                 n_img, low.data_ptr(), g.data_ptr(), _build.stream_ptr(dev))
        _build.check(lib, err, "hvs_level_forward")
        hvs_level_forward.launches += 1
        lows.append(low)
        grids.append(g)
        prev = low
    return Pyramid(tuple(lows), tuple(grids))


def _n_maps(p: Plan) -> int:
    return 2 * sum(lv.nb for lv in p.levels) + 1


def _weights(p: Plan, batch: int):
    """Each band level's weight and the last lowpass's, as the twin's
    loss_from_stats and torch.mean give them: (1 / maps) / numel, f32."""
    inv = np.float32(1.0) / np.float32(_n_maps(p))
    last = p.levels[-1]
    w4 = float(inv / np.float32(batch * 3 * (last.h // 2) * (last.w // 2)))
    return [float(inv / np.float32(batch * 3 * lv.h * lv.w))
            for lv in p.levels], w4


def hvs_stats_loss(pyr: Pyramid, p: Plan, batch: int, mse: bool):
    """Kernel 11b: the loss (0-d) of a pyramid of 2 * batch images, the
    images then their targets."""
    dev = pyr.lows[0].device
    wts, w4 = _weights(p, batch)
    levels = _StatLevels(n=len(p.levels), batch=batch)
    block0 = 0
    for i, (lv, g, wt) in enumerate(zip(p.levels, pyr.grids, wts)):
        levels.lv[i] = _StatLevel(g.data_ptr(), lv.ah.up, lv.aw.up, lv.h,
                                  lv.w, lv.gh, lv.gw, lv.nb, block0, wt)
        block0 += -(-batch * lv.h * lv.w // STATS_BLOCK)
    partial = torch.empty(block0, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    last = p.levels[-1]
    lib, fn = _entry("fs_hvs_stats_loss", [P, I, P, I, I, F, I, P, P, P])
    err = fn(ctypes.byref(levels), block0, pyr.lows[-1].data_ptr(), last.h,
             last.w, w4, int(mse), partial.data_ptr(), loss.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "hvs_stats_loss")
    hvs_stats_loss.launches += 2
    return loss


def hvs_stats_backward(pyr: Pyramid, p: Plan, batch: int, mse: bool,
                       gscale):
    """Kernel 12 at every band level: the cotangents (batch, nb, 2, 3, gh,
    gw) of the images' grids, each divided by its bin's area; gscale the
    loss's cotangent (a float32 scalar on the card)."""
    dev = pyr.lows[0].device
    wts, _ = _weights(p, batch)
    lib, fn = _entry("fs_hvs_stats_bwd", [P, I, I, P, P, F, P, I, P, P])
    qs = []
    for lv, g, wt in zip(p.levels, pyr.grids, wts):
        q = torch.empty((batch, lv.nb, 2, 3, lv.gh, lv.gw),
                        dtype=torch.float32, device=dev)
        err = fn(g.data_ptr(), batch, lv.nb, ctypes.byref(lv.ah),
                 ctypes.byref(lv.aw), wt, gscale.data_ptr(), int(mse),
                 q.data_ptr(), _build.stream_ptr(dev))
        _build.check(lib, err, "hvs_stats_backward")
        hvs_stats_backward.launches += 1
        qs.append(q)
    return qs


def hvs_level_backward(image, pyr: Pyramid, qs, p: Plan, batch: int,
                       mse: bool, gscale):
    """Kernel 12b at every band level, coarse to fine, then the image
    side: the gradient (batch, H, W, 3) of the images."""
    dev = image.device
    _, w4 = _weights(p, batch)
    f = p.filters
    lib, fn = _entry("fs_hvs_level_bwd",
                     [P, I, P, I, P, P, P, P, F, P, I, P, P])
    dnext = None
    for lv, low, q in reversed(list(zip(p.levels, pyr.lows, qs))):
        dlow = torch.empty((batch, 3, lv.h, lv.w), dtype=torch.float32,
                           device=dev)
        err = fn(low.data_ptr(), batch, q.data_ptr(), lv.nb,
                 ctypes.byref(lv.ah), ctypes.byref(lv.aw), f["b"].data_ptr(),
                 None if dnext is None else dnext.data_ptr(), w4,
                 gscale.data_ptr(), int(mse), dlow.data_ptr(),
                 _build.stream_ptr(dev))
        _build.check(lib, err, "hvs_level_backward")
        hvs_level_backward.launches += 1
        dnext = dlow
    lv0 = p.levels[0]
    resized = p.resize.h.idx is not None
    dx = torch.empty((batch, p.rh, p.rw, 3), dtype=torch.float32, device=dev)
    dimg = torch.empty_like(image) if resized else dx
    lib, fn = _entry("fs_hvs_input_bwd",
                     [P, P, P, P, I, P, P, P, P, I, P, P, P])
    err = fn(image.data_ptr(), ctypes.byref(p.resize), dnext.data_ptr(),
             qs[0].data_ptr(), lv0.nb, ctypes.byref(lv0.ah),
             ctypes.byref(lv0.aw), f["h0"].data_ptr(), f["l0"].data_ptr(),
             batch, dx.data_ptr(), dimg.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "hvs_level_backward")
    hvs_level_backward.launches += 2 if resized else 1
    return dimg


hvs_level_forward.launches = 0
hvs_stats_loss.launches = 0
hvs_stats_backward.launches = 0
hvs_level_backward.launches = 0


class UniformLoss(torch.autograd.Function):
    """The uniform HVS loss of image against target (B, H, W, 3),
    contiguous float32 on the card: forward kernels 11 and 11b, backward
    kernels 12 and 12b. The gradient reaches the image only."""

    @staticmethod
    def forward(ctx, image, target, p, mse):
        pyr = hvs_level_forward(image, target, p)
        loss = hvs_stats_loss(pyr, p, image.shape[0], mse)
        ctx.save_for_backward(image, *pyr.lows, *pyr.grids)
        ctx.args = (p, mse)
        return loss

    @staticmethod
    def backward(ctx, g):
        image, *saved = ctx.saved_tensors
        p, mse = ctx.args
        n = len(p.levels)
        pyr = Pyramid(tuple(saved[:n]), tuple(saved[n:]))
        g = g.detach().float().contiguous()
        qs = hvs_stats_backward(pyr, p, image.shape[0], mse, g)
        return (hvs_level_backward(image, pyr, qs, p, image.shape[0], mse,
                                   g), None, None, None)


def uniform_loss(image, target, pooling_size, n_levels: int = 5,
                 n_orientations: int = 6, loss_type: str = "L1"):
    """MetamericLossUniform of the RGB image against the target, each
    (H, W, 3) or (B, H, W, 3) at any size: resized for the pyramid,
    taken to YCrCb, `n_levels` levels, the pooling size halving per
    level; L1, or MSE for loss_type "MSE". Differentiable in the image.

    CPU tensors take the plain twin (metameric.resize_for_pyramid and
    metameric_loss_uniform); float32 tensors on the card the kernels,
    with 6 orientations (the cropped filters). Anything else raises."""
    dev = image.device
    if dev.type == "cpu":
        return metameric.metameric_loss_uniform(
            metameric.resize_for_pyramid(image, n_levels),
            metameric.resize_for_pyramid(target, n_levels), pooling_size,
            n_levels, n_orientations, loss_type)
    if dev.type != "cuda":
        raise ValueError(f"uniform_loss: image on {dev}; the kernels need "
                         "CUDA")
    if n_orientations != N_ORIENT:
        raise ValueError(f"uniform_loss: {n_orientations} orientations; "
                         f"the kernels take {N_ORIENT}")
    x = _f32_images("uniform_loss", image, dev)
    t = _f32_images("uniform_loss", target, dev).detach()
    if x.shape != t.shape:
        raise ValueError(f"uniform_loss: image {tuple(x.shape)} and target "
                         f"{tuple(t.shape)} differ")
    p = plan(x.shape[1], x.shape[2], pooling_size, n_levels, str(dev))
    return UniformLoss.apply(x, t, p, loss_type == "MSE")


def pooled_grids_plain(image, pooling_size, n_levels: int = 5,
                       n_orientations: int = 6):
    """Kernel 11's grids in the twin's code: the RGB image (H, W, 3) or
    (B, H, W, 3) resized and taken to YCrCb, its pyramid
    (pyramid.construct_pyramid), and per band in statsmaps' order (h0,
    then each level's oriented bands) the pair (A band, A band^2), A the
    area pooling of metameric.uniform_blur (none at a pooling size of
    1), each (B, gh, gw, 3); last the final lowpass."""
    x = color.rgb_to_ycrcb(metameric.resize_for_pyramid(image, n_levels))
    pyr = pyramid.construct_pyramid(x, n_levels, n_orientations)

    def pooled(band, ps):
        if ps == 1:
            return band, band * band
        _, h, w, _ = band.shape
        oh, ow = metameric._pooled(h, ps), metameric._pooled(w, ps)
        return (metameric.adaptive_area_downsample(band, oh, ow),
                metameric.adaptive_area_downsample(band * band, oh, ow))

    out = [pooled(pyr[0]["h"], pooling_size)]
    ps = pooling_size
    for level in pyr[:-1]:
        out += [pooled(band, ps) for band in level["b"]]
        ps = ps / 2
    return out, pyr[-1]["l"]


def maps_from_grids_plain(grids, last, pooling_size, height: int,
                          width: int, n_levels: int = 5):
    """Kernel 11b's maps in the twin's code: pooled_grids_plain's grids
    and last lowpass of an (height, width) image brought back to statsmaps'
    maps, as metameric.uniform_blur and _find_stats do (bilinear up, the
    std with its 1e-7 floor; a grid at a pooling size of 1 is the band)."""
    rh, rw = metameric._pyramid_size(height, width, n_levels)
    n_bands = (len(grids) - 1) // (n_levels - 1)
    out = []
    for i, (s1, s2) in enumerate(grids):
        lv = max(i - 1, 0) // n_bands
        ps = pooling_size / 2 ** lv
        mean, meansq = s1, s2
        if ps != 1:
            mean = metameric.bilinear_upsample(s1, rh >> lv, rw >> lv)
            meansq = metameric.bilinear_upsample(s2, rh >> lv, rw >> lv)
        out += [mean, torch.sqrt(torch.clamp(meansq - mean * mean,
                                             min=1e-7))]
    return out + [last]


def kernel_grids(pyr: Pyramid, first: int, count: int):
    """Kernel 11's grids of images [first, first + count) in
    pooled_grids_plain's order and layout: [(S1, S2) (count, gh, gw, 3)
    of each band]."""
    out = []
    for g in pyr.grids:
        g = g[first:first + count].permute(1, 2, 0, 4, 5, 3)
        out += [(b[0], b[1]) for b in g]
    return out
