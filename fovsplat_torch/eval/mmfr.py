"""MM-FR baseline: LightGaussian multi-model foveated rendering
(fovsplat/eval/mmfr.py, the fused route).

Counterpart of gaussian_renderer_fov_mmfr/__init__.py:75-162 and the
_mmfr_pcheck_obb rasterizer (reference N8): four independently pruned
single-level models, one pass per level that renders only the tiles whose
level is that pass's, images summed. Each pass bins its whole model once
(kernel 4's quantized rows and the fused-key sort) and blends with kernel
5q over segments in which every tile it does not own is emptied, as the
reference's per-pass tile_skips do. With config.backend "xla" a pass is
instead the XLA rasterizer with a per-pair tile mask (mmfr.py:43-50):
plain PyTorch, no kernel.
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import binning, foveation, projection
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops.blend import PIX, tiles_to_image
from fovsplat_torch.ops.foveation import FoveationConfig
from fovsplat_torch.ops.kernels.blend_fwd import blend_forward_q
from fovsplat_torch.ops.rasterize import _grid, _images

_BBOX_NONE = 1 << 20   # x0/y0 when the pass owns no tile


def level_pairs(m, camera, level_i, li: int, config):
    """The pairs kernel 5q blends in one MM-FR level pass (mmfr.py:100-
    160): column preprocess, every rect clipped to the bbox of the owned
    tiles, the dead-opacity cull (opacity >= 1/255) and the inference
    binning of the whole model. Returns (pairs (5, CAP), seg_start (T,),
    seg_end (T,), binned), with every segment of a tile the pass does not
    own emptied, as the reference's per-pass tile_skips do."""
    gx, gy = _grid(camera)
    dev = level_i.device
    pc = projection.preprocess_cols(m["xyz"], m["scaling"], m["rotation"],
                                    camera,
                                    scale_modifier=config.scale_modifier)
    owned = level_i == li
    owned2d = owned.reshape(gy, gx)
    txs = torch.arange(gx, device=dev).expand(gy, gx)
    tys = torch.arange(gy, device=dev)[:, None].expand(gy, gx)
    big = torch.full_like(txs, _BBOX_NONE)
    zero = torch.zeros_like(txs)
    rx0 = torch.maximum(pc.rx0, torch.where(owned2d, txs, big).amin())
    ry0 = torch.maximum(pc.ry0, torch.where(owned2d, tys, big).amin())
    rx1 = torch.minimum(pc.rx1, torch.where(owned2d, txs + 1, zero).amax())
    ry1 = torch.minimum(pc.ry1, torch.where(owned2d, tys + 1, zero).amax())
    tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = pc.valid & (tnum > 0) & (m["opacity"] >= 1.0 / 255.0)
    colors = m["colors"]
    cols = [rx0.float(), ry0.float(), torch.clamp(rx1 - rx0, min=1).float(),
            torch.where(valid, tnum, torch.zeros_like(tnum)).float(),
            pc.mx, pc.my, pc.v1x, pc.v1y, pc.v2x, pc.v2y, pc.len1, pc.len2,
            pc.ca, pc.cb, pc.cc, m["opacity"], colors[:, 0], colors[:, 1],
            colors[:, 2]]
    pairs, bn = binning.bin_fused_ps1(
        cols, valid, pc.depth, gx, gy, config.pair_capacity,
        config.kept_capacity(), config.use_obb, train=False,
        sort_exact=config.sort_exact_depth)
    ss = bn.seg_start[:-1]
    se = torch.where(owned, bn.seg_start[1:], ss)   # empty non-owned tiles
    return pairs, ss, se, bn


def _render_level_fused(m, camera, level_i, li: int, config):
    """One MM-FR level pass: level_pairs, then kernel 5q over them."""
    gx, gy = _grid(camera)
    pairs, ss, se, bn = level_pairs(m, camera, level_i, li, config)
    tile_color, final_T, _ = blend_forward_q(pairs, ss, se, gx,
                                             config.power_cutoff,
                                             config.chunk)
    image, T_img = _images(tile_color, final_T, gx, gy, camera, None)
    return {"render": image, "final_T": T_img, "overflow": bn.overflow,
            "num_pairs": bn.num_pairs, "candidates": bn.candidates}


def _render_level_masked(m, camera, level_i, li: int, config):
    """One MM-FR level pass on the XLA route (mmfr.py:43-50): the whole
    model through rasterize with a per-pair mask of the owned tiles."""
    num_tiles = level_i.shape[0]

    def tile_mask(orig, tile):
        return level_i[torch.clamp(tile, max=num_tiles - 1)] == li

    out = rast.rasterize(m["xyz"], m["scaling"], m["rotation"], m["opacity"],
                         camera, colors=m["colors"], config=config,
                         tile_mask_fn=tile_mask)
    bn = out["binned"]
    return {"render": out["render"], "final_T": out["final_T"],
            "overflow": bn.overflow, "num_pairs": bn.num_pairs,
            "candidates": bn.candidates}


def _level_contrib(m, camera, level_i, li: int, config, bg_color):
    """A pass's image on its own tiles (renderCUDA_mmfr writes 0 on the
    others), the background composited there only; and its diagnostics."""
    gx, gy = _grid(camera)
    render = (_render_level_masked if config.backend == "xla"
              else _render_level_fused)
    out = render(m, camera, level_i, li, config)
    own = (level_i == li).float()
    own_img = tiles_to_image(own[:, None, None].expand(-1, PIX, 1), gx, gy,
                             camera.width, camera.height)[..., 0]
    contrib = out["render"] * own_img[..., None]
    if bg_color is not None:
        contrib = contrib + (own_img * out["final_T"])[..., None] * \
            torch.as_tensor(bg_color, dtype=contrib.dtype,
                            device=contrib.device)
    return contrib, {"overflow": out["overflow"],
                     "num_pairs": out["num_pairs"],
                     "candidates": out["candidates"]}


def render_mmfr(models, camera, gaze, alpha, config,
                fov_cfg: FoveationConfig = FoveationConfig(),
                bg_color=None, return_diag: bool = False):
    """models: a list of L dicts with xyz, scaling, rotation, opacity
    (activated) and colors (N, 3), point counts free to differ; one pass
    per level, restricted to that level's tiles, images summed. config: a
    RasterizeConfig, or one per level (per-level capacities, as bench.py
    sizes them). gaze: (2,) f32 tensor on the models' device. With
    return_diag, also a list of each pass's overflow, num_pairs and
    candidates (0-d tensors)."""
    levels = foveation.compute_tile_levels(gaze, camera.width, camera.height,
                                           alpha, fov_cfg)
    level_i = levels.to(torch.int32)
    cfgs = (config if isinstance(config, (list, tuple))
            else [config] * len(models))
    total, diags = None, []
    for li, (m, cfg) in enumerate(zip(models, cfgs)):
        contrib, diag = _level_contrib(m, camera, level_i, li, cfg, bg_color)
        total = contrib if total is None else total + contrib
        diags.append(diag)
    return (total, diags) if return_diag else total


def render_mmfr_level(m, camera, gaze, alpha, li: int, config,
                      fov_cfg=None, bg_color=None, return_diag=False):
    """One MM-FR level pass on its own (mmfr.py:67): its image on the
    owned tiles and, with return_diag, its overflow, num_pairs and
    candidates."""
    fov_cfg = fov_cfg or FoveationConfig()
    levels = foveation.compute_tile_levels(gaze, camera.width, camera.height,
                                           alpha, fov_cfg)
    contrib, diag = _level_contrib(m, camera, levels.to(torch.int32), li,
                                   config, bg_color)
    return (contrib, diag) if return_diag else contrib
