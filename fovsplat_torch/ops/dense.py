"""Dense reference renderer, the correctness oracle (counterpart of
fovsplat/ops/dense.py).

Renders by evaluating every Gaussian at every pixel, with no tile
binning, and the blend rules of the reference renderCUDA
(..._pcheck_obb_sum/cuda_rasterizer/forward.cu:298-426):

  power = -0.5 (a dx^2 + c dy^2) - b dx dy
  skip if power > 0 or power < power_cutoff
  alpha = min(0.99, opacity exp(power)); skip if alpha < 1/255
  front to back, T *= (1 - alpha); a Gaussian whose T (1 - alpha) would
  fall below 1e-4 ends the pixel without contributing.

The tile rect and the OBB test of the reference are applied per pixel,
as the tiled renderers apply them per tile. O(N H W) memory and time:
for checks at small sizes only.
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import binning, projection

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def blend_prefix(alpha, axis: int = -1):
    """The closed form of sequential front-to-back blending (dense.py:
    31-56). alpha: masked alphas (0 where skipped), front to back along
    `axis`. Returns (weight, final_T, contribute): weight alpha_j T_j on
    the entries that blended, else 0; the transmittance at the end;
    the mask of the entries that blended."""
    one_minus = 1.0 - alpha
    incl = torch.cumprod(one_minus, dim=axis)
    excl = incl / one_minus
    trigger = (alpha > 0) & (incl < T_EPS)
    done_incl = torch.cumsum(trigger.to(torch.int32), dim=axis) > 0
    done_before = done_incl & ~trigger
    contribute = (alpha > 0) & ~trigger & ~done_before
    weight = torch.where(contribute, alpha * excl, torch.zeros_like(alpha))
    last = incl.select(axis, incl.shape[axis] - 1)
    final_T = torch.where(trigger.any(axis),
                          torch.where(trigger, excl,
                                      torch.zeros_like(excl)).amax(axis),
                          last)
    return weight, final_T, contribute


def render_dense(means3d, scales, rotations, opacities, colors, camera,
                 bg_color=None, power_cutoff: float = -4.5,
                 scale_modifier: float = 1.0):
    """Oracle render (dense.py:59-115). colors (N, 3) RGB. Returns a dict:
    render (H, W, 3), final_T (H, W), radii (N,) i32."""
    W, H = camera.width, camera.height
    dev = means3d.device
    prep = projection.preprocess(means3d, scales, rotations, camera,
                                 scale_modifier=scale_modifier)
    inf = torch.full_like(prep.depth, float("inf"))
    order = torch.argsort(torch.where(prep.valid, prep.depth, inf),
                          stable=True)
    mean2d = prep.mean2d[order]
    conic = prep.conic[order]
    op = opacities[order] * prep.valid[order]
    col = colors[order]

    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")                      # (H, W)
    dx = mean2d[:, 0, None, None] - px[None]                    # (N, H, W)
    dy = mean2d[:, 1, None, None] - py[None]
    # The reference's getRect can leave out a tile the 3-sigma ellipse
    # touches; pixels outside the rect never see the Gaussian there.
    rect_min = prep.rect_min[order]
    rect_max = prep.rect_max[order]
    tx = (px / projection.TILE).to(torch.int32)[None]
    ty = (py / projection.TILE).to(torch.int32)[None]
    in_rect = ((tx >= rect_min[:, 0, None, None])
               & (tx < rect_max[:, 0, None, None])
               & (ty >= rect_min[:, 1, None, None])
               & (ty < rect_max[:, 1, None, None]))
    # The OBB test on multi-tile rects, as the reference's filter runs it.
    ob = binning.obb_pass(tx, ty, mean2d[:, None, None, :],
                          prep.eigen_vec[order][:, None, None],
                          prep.eigen_len[order][:, None, None])
    multi = (prep.tiles_touched[order] > 1)[:, None, None]
    in_rect = in_rect & (ob | ~multi)
    a = conic[:, 0, None, None]
    b = conic[:, 1, None, None]
    c = conic[:, 2, None, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(op[:, None, None] * torch.exp(power), max=ALPHA_MAX)
    skip = ((power > 0.0) | (power < power_cutoff) | (alpha < ALPHA_MIN)
            | ~in_rect)
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

    weight, final_T, _ = blend_prefix(alpha, axis=0)
    image = torch.einsum("nhw,nc->hwc", weight, col)
    if bg_color is not None:
        image = image + final_T[..., None] * torch.as_tensor(
            bg_color, dtype=image.dtype, device=dev)
    return {"render": image, "final_T": final_T, "radii": prep.radius}
