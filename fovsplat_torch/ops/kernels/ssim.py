"""Kernels 13 and 13b: the mean SSIM of two images on the card, forward and
backward (csrc/ssim.cu), and the autograd.Function that joins them.

Replaces no Pallas kernel: the JAX package computes SSIM with jnp
(fovsplat/train/losses.py ssim). The plain twin is the port's shift-add
code in train/losses.py (ssim_plain, _depthwise_blur), unchanged; CPU
tensors take it. losses.ssim is the route: a CUDA float32 image pair
goes to the kernels, anything else on the card raises.

  13   ssim_forward: the five blurred maps of a tile and its halo in
       shared memory, the SSIM map, one partial sum a block; then one
       block adds the partials in a fixed order (two launches, one call);
  13b  ssim_backward: the gradient of the mean in the image (and in the
       target where it requires one), the maps recomputed over a halo of
       5 and their coefficients blurred back, in one launch.

ssim_grad_plain is 13b's formula in the twin's code, for the tests. The
window's 11 taps are the twin's f32 values (losses._gaussian_1d), made on
the host once and passed by value, so a call copies nothing from the
host.

Bound on the card, by need: operations for both (see the source header).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.train import losses

SIZE = 11          # csrc/ssim.cu K: the window the kernels take
C1 = float(np.float32(0.01 ** 2))   # the twin's constants in f32
C2 = float(np.float32(0.03 ** 2))


class _Window(ctypes.Structure):
    _fields_ = [("g", ctypes.c_float * SIZE)]


@functools.lru_cache(maxsize=None)
def window(sigma: float) -> _Window:
    """The twin's 11 f32 taps at `sigma`, computed on the host."""
    taps = losses._gaussian_1d(SIZE, sigma).tolist()
    return _Window((ctypes.c_float * SIZE)(*taps))


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _entry(name, argtypes, restype=I):
    """(library, entry point) of csrc/ssim.cu, its types declared."""
    lib = _build.load("ssim")
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype
    return lib, fn


def ssim_forward(a, b, sigma: float = 1.5, robust: bool = False):
    """Kernel 13: the mean SSIM (0-d) of a and b, contiguous float32
    (B, H, W, 3) on the card. One call, two launches (the tiles, then
    their partials in a fixed order); the counter counts calls."""
    dev = a.device
    batch, h, w, _ = a.shape
    lib, count = _entry("fs_ssim_partials", [I, I, I])
    partial = torch.empty(count(batch, h, w), dtype=torch.float32,
                          device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    lib, fn = _entry("fs_ssim_fwd", [P, P, I, I, I, _Window, F, F, I, P, P,
                                     P])
    err = fn(a.data_ptr(), b.data_ptr(), batch, h, w, window(sigma), C1, C2,
             int(robust), partial.data_ptr(), loss.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "ssim_forward")
    ssim_forward.launches += 1
    return loss


def ssim_backward(a, b, g, sigma: float = 1.5, grad_b: bool = False):
    """Kernel 13b: the gradients (da, db or None) of g times the mean SSIM
    of a and b (contiguous float32 (B, H, W, 3) on the card); g the loss's
    cotangent, a float32 scalar on the card."""
    dev = a.device
    batch, h, w, _ = a.shape
    da = torch.empty_like(a)
    db = torch.empty_like(b) if grad_b else None
    lib, fn = _entry("fs_ssim_bwd", [P, P, I, I, I, _Window, F, F, P, P, P,
                                     P])
    err = fn(a.data_ptr(), b.data_ptr(), batch, h, w, window(sigma), C1, C2,
             g.data_ptr(), da.data_ptr(), None if db is None else
             db.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "ssim_backward")
    ssim_backward.launches += 1
    return da, db


ssim_forward.launches = 0
ssim_backward.launches = 0


class SSIM(torch.autograd.Function):
    """The mean SSIM of a and b (B, H, W, 3), contiguous float32 on the
    card: forward kernel 13, backward kernel 13b. robust has no
    backward: the gates that take it only evaluate."""

    @staticmethod
    def forward(ctx, a, b, sigma, robust):
        ctx.save_for_backward(a, b)
        ctx.args = (sigma, robust)
        return ssim_forward(a, b, sigma, robust)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sigma, robust = ctx.args
        if robust:
            raise RuntimeError("ssim: robust=True has no backward on the "
                               "card")
        da, db = ssim_backward(a, b, g.detach().float().contiguous(), sigma,
                               ctx.needs_input_grad[1])
        return (da if ctx.needs_input_grad[0] else None), db, None, None


def ssim(a, b, size: int = SIZE, sigma: float = 1.5, robust: bool = False):
    """losses.ssim's route on the card: a and b float32 (H, W, 3) or (B, H,
    W, 3) on one CUDA device, the 11-tap window. Anything else raises."""
    if size != SIZE:
        raise ValueError(f"ssim: window {size}; the kernels take {SIZE}")
    if a.dim() == 3:
        a, b = a[None], b[None]
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"ssim: {name} must be a float32 (H, W, 3) or "
                             f"(B, H, W, 3) tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"ssim: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         "differ")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"ssim: images on {a.device} and {b.device}; the "
                         "kernels need both on one CUDA device")
    return SSIM.apply(a.contiguous(), b.contiguous(), float(sigma), robust)


def ssim_grad_plain(a, b, size: int = SIZE, sigma: float = 1.5):
    """Kernel 13b's formula in the twin's code: the gradients (da, db) of
    the mean SSIM of a and b ((H, W, 3) or (B, H, W, 3)) from the five
    blurred maps, the map's coefficients dm/dmu_a, dm/dmu_b, dm/dG(a^2)
    (= dm/dG(b^2)) and dm/dG(ab), each blurred (the window is its own
    transpose), then combined with a and b, over the count."""
    squeeze = a.dim() == 3
    if squeeze:
        a, b = a[None], b[None]
    g = losses._gaussian_1d(size, sigma, a.device)

    def blur(x):
        return losses._depthwise_blur(x, g)
    mu_a, mu_b = blur(a), blur(b)
    aa, bb, ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_a, s_b, s_ab = blur(a * a) - aa, blur(b * b) - bb, blur(a * b) - ab
    a1, a2 = 2 * ab + C1, 2 * s_ab + C2
    b1, b2 = aa + bb + C1, s_a + s_b + C2
    d = b1 * b2
    m = (a1 * a2) / d
    e = m * (b2 - b1)
    g_mu_a = blur(2 * (mu_b * (a2 - a1) - mu_a * e) / d)
    g_mu_b = blur(2 * (mu_a * (a2 - a1) - mu_b * e) / d)
    g_sq = blur(-m / b2)
    g_ab = blur(2 * a1 / d)
    n = a.numel()
    da = (g_mu_a + 2 * a * g_sq + b * g_ab) / n
    db = (g_mu_b + 2 * b * g_sq + a * g_ab) / n
    return (da[0], db[0]) if squeeze else (da, db)
