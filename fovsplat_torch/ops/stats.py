"""The counting rasterizer: a render with per-Gaussian statistics
(counterpart of fovsplat/ops/stats.py: MODES, tile_fetch_counts,
tile_inside_mask, image_to_tiles and rasterize_stats on its fused route,
stats.py:39-62, 202-348).

The reference's counting rasterizers, by mode:
  "sum"   gs_count +1 per fetched (tile, Gaussian) pair, contribs the sum
          of alpha * T over the pixels it contributes to
          (..._pcheck_obb_sum, forward.cu:357-361, 381, 400);
  "max"   gs_count the pixels in the power window while not done,
          contribs the largest alpha * T (..._pcheck_obb_max);
  "loss_weighted_max_count"  gs_count as "sum"; each pixel routes its
          loss-map value to the Gaussian of its largest alpha * T
          (forward.cu:403-435);
  "count_opacity"  gs_count the contributing pixels, contribs the sum of
          opacity over them (LightGaussian's renderCUDA_count).

rasterize_stats runs kernel 4 (binning.bin_fused_ps1, which carries each
pair's Gaussian id), kernel 8 (ops/kernels/blend_stats) and reductions by
Gaussian id. Float sums are deterministic: the value rows are sorted by
Gaussian id (a stable torch.sort) and kernel 7 sums each Gaussian's run
in a fixed order; CUDA's index_add_ on floats adds in a varying order,
and one ulp in a score can reorder metric_prune's ranks. Integer counts
go through integer index_add_ and the per-Gaussian max through
scatter_reduce("amax"), both exact in any order. The argmax tie-break is
the lowest lane, as in the JAX Pallas kernel (the CUDA original's is a
race). The XLA oracle blend_stats is not ported yet.
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import binning, projection, sh
from fovsplat_torch.ops.blend import (BIG, PIX, tile_inside_mask,
                                      tiles_to_image)
from fovsplat_torch.ops.kernels.blend_stats import blend_stats
from fovsplat_torch.ops.kernels.segment_reduce import reduce_by_sorted_gid
from fovsplat_torch.ops.projection import TILE
from fovsplat_torch.ops.rasterize import (RasterizeConfig, _grid,
                                          train_columns)

MODES = ("sum", "max", "loss_weighted_max_count", "count_opacity")

REF_FETCH_ROUND = 256   # the reference's BLOCK_SIZE fetch-batch width


def tile_fetch_counts(first_trig, seg_start, inside):
    """Per-tile fetched-pair count of the reference's fetch loop
    (..._pcheck_obb_sum/cuda_rasterizer/forward.cu:348-361): pairs are
    fetched in rounds of 256 and the loop ends at the first round start
    where every pixel is done (frozen, or outside the image from the
    start). first_trig (T, PIX) rank of each pixel's freezing pair (BIG if
    none), f32 as stats.py:50-62 keeps it; inside (T, PIX) bool. Returns
    (T,) i32."""
    seg_len = (seg_start[1:] - seg_start[:-1]).to(torch.float32)
    ft = torch.where(inside, first_trig, torch.full_like(first_trig, -1.0))
    never = (inside & (first_trig >= float(BIG))).any(1)
    max_j = ft.amax(1)
    rounds = torch.floor(max_j / REF_FETCH_ROUND) + 1.0
    f = torch.where(never | (max_j < 0.0), seg_len,
                    torch.minimum(seg_len, rounds * REF_FETCH_ROUND))
    # A tile without an inside pixel (all padding) fetches nothing.
    f = torch.where(inside.any(1), f, torch.zeros_like(f))
    return f.to(torch.int32)


def image_to_tiles(img, grid_x: int, grid_y: int):
    """(H, W) -> (T, PIX) tile-major, zero-padded to whole tiles."""
    h, w = img.shape[:2]
    img = torch.nn.functional.pad(img, (0, grid_x * TILE - w,
                                        0, grid_y * TILE - h))
    img = img.reshape(grid_y, TILE, grid_x, TILE).permute(0, 2, 1, 3)
    return img.reshape(grid_y * grid_x, PIX)


def _sorted_sums(gid, vals, n: int):
    """Per-Gaussian sums of the value rows (R, L): a stable sort by gid
    (gid n marks a lane to skip), then kernel 7. Returns (R, n)."""
    key, perm = torch.sort(gid, stable=True)
    return reduce_by_sorted_gid(key.to(torch.int32).contiguous(),
                                vals.index_select(1, perm).contiguous(), n)


def _counts(gid, vals, n: int):
    """Per-Gaussian integer sums of vals (L,) (gid n: skip). (n,) i32."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=gid.device)
    return out.index_add_(0, gid.long(), vals.long())[:n].to(torch.int32)


@torch.no_grad()
def rasterize_stats(means3d, scales, rotations, opacities, camera,
                    colors=None, shs=None, sh_degree: int = 3, mode="sum",
                    loss_map=None, bg_color=None,
                    config: RasterizeConfig = RasterizeConfig(),
                    live_mask=None):
    """Render and per-Gaussian statistics of one view (the counting
    variants' outputs: colour, radii, gaussians_count, contributions,
    ..._pcheck_obb_sum/__init__.py:92-104).

    Arguments as ops/rasterize.rasterize, plus mode (one of MODES) and
    loss_map (H, W) for "loss_weighted_max_count" (None: ones). Returns a
    dict: render (H, W, 3), final_T (H, W), gs_count (N,) i32, contribs
    (N,) f32, radii (N,) i32 and binned (ops/binning.Binned)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    gx, gy = _grid(camera)
    num_tiles = gx * gy
    n = means3d.shape[0]
    cfg = config
    prep = projection.preprocess_cols(means3d, scales, rotations, camera,
                                      scale_modifier=cfg.scale_modifier,
                                      live_mask=live_mask)
    if colors is None:
        colors = sh.sh_to_rgb(sh_degree, shs, means3d, camera.cam_center)
    pairs, bn = binning.bin_fused_ps1(
        train_columns(prep, opacities, colors), prep.valid, prep.depth, gx,
        gy, cfg.pair_capacity, cfg.kept_capacity(), cfg.use_obb)
    seg_start = bn.seg_start
    tile_color, final_T, pair_stats, best_lane, best_w, first_trig = \
        blend_stats(pairs, seg_start, gx, camera.width, camera.height,
                    cfg.power_cutoff, cfg.chunk)
    cap = pairs.shape[1]
    dev = pairs.device
    lane = torch.arange(cap, device=dev)
    in_use = lane < bn.num_pairs
    gid = torch.where(in_use, bn.pair_gauss, n)

    def fetched_counts():
        # The exact fetch-time gs_count (forward.cu:357-361): count each
        # tile's pairs below its 256-round early-exit point.
        nf = tile_fetch_counts(first_trig.to(torch.float32), seg_start,
                               tile_inside_mask(gx, gy, camera.width,
                                                camera.height, dev))
        t_all = torch.clamp(torch.searchsorted(
            seg_start[1:num_tiles].contiguous(), lane.to(torch.int32),
            right=True), max=num_tiles - 1)
        fetched = in_use & ((lane - seg_start[t_all]) < nf[t_all])
        return _counts(torch.where(fetched, gid, n), fetched, n)

    if mode == "sum":
        gs_count = fetched_counts()
        contribs = _sorted_sums(gid, pair_stats[0:1], n)[0]
    elif mode == "max":
        gs_count = _counts(gid, pair_stats[3], n)
        contribs = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        contribs = contribs.scatter_reduce_(
            0, gid.long(), pair_stats[2], "amax")[:n]
    elif mode == "count_opacity":
        gs_count = _counts(gid, pair_stats[1], n)
        contribs = _sorted_sums(gid, (pairs[5] * pair_stats[1])[None], n)[0]
    else:   # loss_weighted_max_count
        gs_count = fetched_counts()
        lm = (torch.ones(num_tiles * PIX, dtype=torch.float32, device=dev)
              if loss_map is None
              else image_to_tiles(loss_map, gx, gy).reshape(-1))
        has_best = (best_w > 0).reshape(-1)
        best = torch.clamp(best_lane.reshape(-1), 0, cap - 1).long()
        gid_best = torch.where(has_best, gid[best], n)
        contribs = _sorted_sums(
            gid_best, torch.where(has_best, lm, 0.0)[None], n)[0]

    image = tiles_to_image(tile_color, gx, gy, camera.width, camera.height)
    T_img = tiles_to_image(final_T[..., None], gx, gy, camera.width,
                           camera.height)[..., 0]
    if bg_color is not None:
        image = image + T_img[..., None] * torch.as_tensor(
            bg_color, dtype=image.dtype, device=dev)
    return {"render": image, "final_T": T_img, "gs_count": gs_count,
            "contribs": contribs,
            "radii": torch.where(prep.valid, prep.radius,
                                 torch.zeros_like(prep.radius)).to(
                                     torch.int32),
            "binned": bn}
