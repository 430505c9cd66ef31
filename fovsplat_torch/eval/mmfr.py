"""MM-FR baseline: LightGaussian multi-model foveated rendering
(fovsplat/eval/mmfr.py, the fused route).

Counterpart of gaussian_renderer_fov_mmfr/__init__.py:75-162 and the
_mmfr_pcheck_obb rasterizer (reference N8): four independently pruned
single-level models, one pass per level that renders only the tiles whose
level is that pass's, images summed. Each pass bins its whole model once
(kernel 4's quantized rows and the fused-key sort) and blends with kernel
5q over segments in which every tile it does not own is emptied, as the
reference's per-pass tile_skips do.

The models come in two forms. The packed SH form (render_mmfr_sh) is
the published model: four rasterize.Ps1ModelSoA (SH in bf16, point
counts free to differ; pack_level_models, train/multimodel), each pass
the PS1 frame's kernel route over the tiles it owns (rasterize.ps1_pairs:
kernel 1p with the owned-tile box and the dead-opacity cull, 4q, the
sort, 5q), so the view-dependent colour is evaluated every frame; it is
the form eval/fps.make_mmfr_render graphs (composed_level_models makes
it of a composed model). The dict form (render_mmfr), held against the
JAX package's render_mmfr, takes colours fixed before the frame and builds
each pass's columns in torch (level_pairs); with config.backend "xla" a
pass is instead the XLA rasterizer with a per-pair tile mask
(mmfr.py:43-50): plain PyTorch, no kernel.
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import binning, foveation, projection
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops.blend import PIX, tiles_to_image
from fovsplat_torch.ops.foveation import FoveationConfig
from fovsplat_torch.ops.kernels.blend_fwd import blend_forward_q
from fovsplat_torch.ops.kernels.build_table import clip_to_box
from fovsplat_torch.ops.rasterize import _grid, _images
from fovsplat_torch.utils.profiling import span

_BBOX_NONE = 1 << 20   # x0/y0 when the pass owns no tile


def level_pairs(m, camera, level_i, li: int, config):
    """The pairs kernel 5q blends in one MM-FR level pass (mmfr.py:100-
    160): column preprocess, every rect clipped to the bbox of the owned
    tiles, the dead-opacity cull (opacity >= 1/255) and the inference
    binning of the whole model. Returns (pairs (5, CAP), seg_start (T,),
    seg_end (T,), binned), with every segment of a tile the pass does not
    own emptied, as the reference's per-pass tile_skips do."""
    gx, gy = _grid(camera)
    pc = projection.preprocess_cols(m["xyz"], m["scaling"], m["rotation"],
                                    camera,
                                    scale_modifier=config.scale_modifier)
    boxes, masks = tile_ownership(level_i, gx, gy, li + 1)
    owned = masks[li]
    pc = clip_to_box(pc, boxes[li], m["opacity"])
    valid = pc.valid
    colors = m["colors"]
    cols = [pc.rx0.float(), pc.ry0.float(),
            torch.clamp(pc.rx1 - pc.rx0, min=1).float(), pc.tnum.float(),
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


# --- the packed SH form ---------------------------------------------------

def pack_level_models(means, scales, rotations, opacities4, shs_dcs,
                      shs_rest, highest_levels, pnum) -> list:
    """The L level models of a composed model's arrays (N, ...) as
    rasterize.Ps1ModelSoA: level li keeps the pnum[li] rows of the
    highest highest_levels (ties broken by row order), in row order,
    with their level-li opacity (opacities4 (N, L), activated) and DC
    (shs_dcs (N, L, 3)), the shared SH rest (N, K-1, 3) and geometry."""
    order = torch.sort(highest_levels, descending=True, stable=True)[1]
    models = []
    for li, n in enumerate(pnum):
        idx = torch.sort(order[:n])[0]
        models.append(rast.pack_ps1_model(
            means[idx], scales[idx], rotations[idx], opacities4[idx, li],
            shs_dcs[idx, li:li + 1], shs_rest[idx]))
    return models


def composed_level_models(composed) -> list:
    """The level models of a composed "ours" model (train/compose.
    ComposedModel) in the packed SH form (fps.py:117): level li keeps
    the live rows of highest level >= li, with their level-li opacity
    and DC and the PS1 model's SH rest and geometry."""
    p = composed.params
    hl = torch.where(composed.live, composed.highest_levels,
                     torch.full_like(composed.highest_levels, -1.0))
    pnum = [int((hl >= li).sum())
            for li in range(composed.opacities.shape[1])]
    return pack_level_models(p.xyz.detach(), p.get_scaling().detach(),
                             p.get_rotation().detach(), composed.opacities,
                             composed.shs_dcs, p.features_rest.detach(), hl,
                             pnum)


def tile_ownership(level_i, gx: int, gy: int, L: int):
    """Each level pass's tiles at the integer tile levels level_i (T,):
    (boxes (L, 4) i32, the bbox x0, y0, x1, y1 of the tiles of level li,
    (1 << 20, 1 << 20, 0, 0) where there are none; masks (L, T) bool)."""
    dev = level_i.device
    masks = level_i[None, :] == torch.arange(L, device=dev,
                                              dtype=level_i.dtype)[:, None]
    own = masks.reshape(L, gy, gx)
    txs = torch.arange(gx, device=dev).expand(L, gy, gx)
    tys = torch.arange(gy, device=dev)[:, None].expand(L, gy, gx)
    big = torch.full_like(txs, _BBOX_NONE)
    zero = torch.zeros_like(txs)
    boxes = torch.stack([torch.where(own, txs, big).amin((1, 2)),
                         torch.where(own, tys, big).amin((1, 2)),
                         torch.where(own, txs + 1, zero).amax((1, 2)),
                         torch.where(own, tys + 1, zero).amax((1, 2))], 1)
    return boxes.to(torch.int32), masks


def render_mmfr_sh(models, camera, gaze, alpha, config,
                   fov_cfg: FoveationConfig = FoveationConfig()):
    """The MM-FR frame of the packed SH form: models, a list of L
    rasterize.Ps1ModelSoA at SH degree 3; config, one RasterizeConfig or
    one per level;
    gaze (2,) f32 on the models' device. Stages: "levels" (tile levels
    and ownership), "pass<li>" (rasterize.ps1_pairs over the owned tiles
    and kernel 5q), "sum" (the passes' tiles, each zero off its own, the
    image and the totals). Returns {"render" (H, W, 3), "overflow" and
    "num_pairs" summed over the passes, "passes": each pass's overflow,
    num_pairs and candidates}, 0-d tensors."""
    gx, gy = _grid(camera)
    cfgs = (config if isinstance(config, (list, tuple))
            else [config] * len(models))
    with span("levels"):
        levels = foveation.compute_tile_levels(gaze, camera.width,
                                               camera.height, alpha, fov_cfg)
        boxes, masks = tile_ownership(levels.to(torch.int32), gx, gy,
                                      len(models))
    tiles, diags = [], []
    for li, (m, cfg) in enumerate(zip(models, cfgs)):
        with span(f"pass{li}"):
            pairs, ss, se, bn = rast.ps1_pairs(m, camera, config=cfg,
                                               owned=(boxes[li], masks[li]))
            with span("blend"):
                tiles.append(blend_forward_q(pairs, ss, se, gx,
                                             cfg.power_cutoff,
                                             cfg.chunk)[0])
        diags.append({"overflow": bn.overflow, "num_pairs": bn.num_pairs,
                      "candidates": bn.candidates})
    with span("sum"):
        return {"render": tiles_to_image(_total(tiles), gx, gy,
                                         camera.width, camera.height),
                "overflow": _total([d["overflow"] for d in diags]),
                "num_pairs": _total([d["num_pairs"] for d in diags]),
                "passes": diags}


def _total(xs):
    return sum(xs[1:], xs[0])
