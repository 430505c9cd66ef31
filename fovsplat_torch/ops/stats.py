"""The counting rasterizer: a render with per-Gaussian statistics
(counterpart of fovsplat/ops/stats.py: MODES, image_to_tiles and
rasterize_stats on its fused route, stats.py:202-348; its
tile_fetch_counts is ops/kernels/fetch_count's, tile_inside_mask
ops/blend's).

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

rasterize_stats runs kernel 10's forward (ops/kernels/project_sh, the
train route's projection and SH colour; CPU tensors take its plain twin,
project_sh_plain), kernel 4 (binning.bin_fused_ps1, which carries each
pair's Gaussian id), kernel 8 (ops/kernels/blend_stats) and reductions by
Gaussian id. Float sums are deterministic: the value rows are sorted by
Gaussian id (a stable torch.sort) and kernel 7 sums each Gaussian's run
in a fixed order; CUDA's index_add_ on floats adds in a varying order,
and one ulp in a score can reorder metric_prune's ranks. The fetched-pair
count of modes "sum" and "loss_weighted_max_count" is kernel 14
(ops/kernels/fetch_count), which walks only the lanes each tile's fetch
loop reads and adds with integer atomics; the other integer counts go
through integer index_add_ and the per-Gaussian max through
scatter_reduce("amax"), all exact in any order. The argmax tie-break is
the lowest lane, as in the JAX Pallas kernel (the CUDA original's is a
race). blend_stats is the XLA oracle (stats.py:65-198) in plain PyTorch,
no kernel: the plain stats walk of kernel 8 with the oracle's argmax
tie-break (the lowest Gaussian id) and the same reductions through the
plain versions of kernels 7 and 14;
rasterize_stats takes it with config.backend = "xla", over
binning.bin_gaussians' pairs.

The fused route carries each pair's Gaussian id as an f32 row, exact up
to 2^24 (GID_EXACT): rasterize_stats refuses a state or a kept capacity
past it before any work. Its stages run in profiling spans: project
(kernel 10's forward: projection, SH colour and the table's columns, the
SH read in place from the model's pair), the binning's table, expand,
sort and gather, stats (kernel 8), reduce (the per-Gaussian counts and
sums: kernel 14, the argmax stream's sort and kernel 7) and compose (the
image and radii).
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import binning, sh
from fovsplat_torch.ops.blend import PIX, blend_stats_plain, tiles_to_image
from fovsplat_torch.ops.kernels.blend_stats import (
    blend_stats as blend_stats_kernel)
from fovsplat_torch.ops.kernels.fetch_count import (
    fetch_count, fetch_count_plain, gid_counts)
from fovsplat_torch.ops.kernels.project_sh import (project_sh, sh_tensor,
                                                   train_order)
from fovsplat_torch.ops.kernels.segment_reduce import (
    reduce_by_sorted_gid, reduce_by_sorted_gid_plain)
from fovsplat_torch.ops.projection import TILE
from fovsplat_torch.ops.rasterize import RasterizeConfig, _grid, _xla_pairs
from fovsplat_torch.utils.profiling import span

MODES = ("sum", "max", "loss_weighted_max_count", "count_opacity")

GID_EXACT = 1 << 24     # f32 holds every integer up to 2^24


def image_to_tiles(img, grid_x: int, grid_y: int):
    """(H, W) -> (T, PIX) tile-major, zero-padded to whole tiles."""
    h, w = img.shape[:2]
    img = torch.nn.functional.pad(img, (0, grid_x * TILE - w,
                                        0, grid_y * TILE - h))
    img = img.reshape(grid_y, TILE, grid_x, TILE).permute(0, 2, 1, 3)
    return img.reshape(grid_y * grid_x, PIX)


def _sorted_sums(gid, vals, n: int, reduce=reduce_by_sorted_gid):
    """Per-Gaussian sums of the value rows (R, L): a stable sort by gid
    (gid n marks a lane to skip), then kernel 7 (or `reduce`, its plain
    version). Returns (R, n)."""
    key, perm = torch.sort(gid, stable=True)
    return reduce(key.to(torch.int32).contiguous(),
                  vals.index_select(1, perm).contiguous(), n)


def _per_gaussian(mode, pair_op, pair_stats, best_lane, best_w, first_trig,
                  gid, seg_start, n: int, grid_x: int, width: int,
                  height: int, loss_map_tiles=None,
                  reduce=reduce_by_sorted_gid, count=fetch_count):
    """Per-Gaussian (gs_count (n,) i32, contribs (n,) f32) of a stats walk
    (stats.py:175-198, 293-325): gid (CAP,) the Gaussian of each sorted
    pair, n on lanes past num_pairs; pair_op (CAP,) the pairs' opacity;
    loss_map_tiles (T, PIX) or None (ones); float sums through `reduce`
    (kernel 7, or its plain version); the fetched-pair count of "sum" and
    "loss_weighted_max_count" through `count` (kernel 14, or its plain
    version), each tile's pairs below its 256-round early-exit point
    (forward.cu:357-361)."""
    cap = gid.shape[0]
    dev = gid.device
    num_tiles = seg_start.shape[0] - 1

    def fetched_counts():
        return count(first_trig, seg_start, gid, n, grid_x, width, height)

    if mode == "sum":
        return (fetched_counts(),
                _sorted_sums(gid, pair_stats[0:1], n, reduce)[0])
    if mode == "max":
        contribs = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        return (gid_counts(gid, pair_stats[3], n),
                contribs.scatter_reduce_(0, gid.long(), pair_stats[2],
                                         "amax")[:n])
    if mode == "count_opacity":
        return (gid_counts(gid, pair_stats[1], n),
                _sorted_sums(gid, (pair_op * pair_stats[1])[None], n,
                             reduce)[0])
    # loss_weighted_max_count
    lm = (torch.ones(num_tiles * PIX, dtype=torch.float32, device=dev)
          if loss_map_tiles is None else loss_map_tiles.reshape(-1))
    has_best = (best_w > 0).reshape(-1)
    best = torch.clamp(best_lane.reshape(-1), 0, cap - 1).long()
    gid_best = torch.where(has_best, gid[best], n)
    return fetched_counts(), _sorted_sums(
        gid_best, torch.where(has_best, lm, 0.0)[None], n, reduce)[0]


def blend_stats(pair_tile, pair_gauss, pair_mean2d, pair_conic, pair_opacity,
                pair_color, seg_start, num_pairs, n_gaussians: int,
                grid_x: int, grid_y: int, chunk: int, power_cutoff: float,
                mode: str, loss_map_tiles=None, width=None, height=None):
    """The XLA oracle (stats.py:65-198): a forward blend and per-Gaussian
    stats over a tile-sorted pair list, in plain PyTorch. Per-pair inputs
    as ops/blend.blend's, pair_gauss (CAP,) the pairs' Gaussian ids.
    Pixels outside width x height (None: the whole grid) start frozen, as
    the reference's padding pixels do (JAX passes them as `inside`).
    Returns (tile colour (T, PIX, 3), final T (T, PIX), gs_count (N,)
    i32, contribs (N,) f32); the argmax keeps the lowest Gaussian id on
    ties."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    del pair_tile
    w = grid_x * TILE if width is None else width
    h = grid_y * TILE if height is None else height
    pairs = torch.cat([pair_mean2d.T, pair_conic.T, pair_opacity[None],
                       pair_color.T]).contiguous()
    lane = torch.arange(pairs.shape[1], device=pairs.device)
    gid = torch.where(lane < num_pairs, pair_gauss.long(), n_gaussians)
    color, final_T, pair_stats, best_lane, best_w, first_trig = \
        blend_stats_plain(pairs, seg_start, grid_x, w, h, power_cutoff,
                          chunk, tie_gid=gid)
    gs_count, contribs = _per_gaussian(
        mode, pairs[5], pair_stats, best_lane, best_w, first_trig, gid,
        seg_start, n_gaussians, grid_x, w, h, loss_map_tiles,
        reduce_by_sorted_gid_plain, fetch_count_plain)
    return color, final_T, gs_count, contribs


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
    loss_map (H, W) for "loss_weighted_max_count" (None: ones); shs the
    pair (sh_a, sh_b or None), as the model's (features_dc,
    features_rest), or one (N, K, 3) tensor, the same bits either way;
    config.backend "xla" takes the XLA route (stats.py:330-345). Returns a
    dict: render (H, W, 3), final_T (H, W), gs_count (N,) i32, contribs
    (N,) f32, radii (N,) i32 and binned (ops/binning.Binned), whose
    overflow counts the pairs past the capacities. The fused route raises
    ValueError for more than GID_EXACT Gaussians or kept pairs."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    gx, gy = _grid(camera)
    n = means3d.shape[0]
    cfg = config
    if cfg.backend != "xla" and max(n, cfg.kept_capacity()) > GID_EXACT:
        raise ValueError(
            f"the fused stats route sorts Gaussian ids as f32, exact up to "
            f"{GID_EXACT}; got {n} Gaussians and a kept capacity of "
            f"{cfg.kept_capacity()}")
    if colors is None and torch.is_tensor(shs):
        shs = (shs, None)
    if cfg.backend == "xla":
        with span("project"):
            if colors is None:
                colors = sh.sh_to_rgb(sh_degree, sh_tensor(shs), means3d,
                                      camera.cam_center)
        lm = None if loss_map is None else image_to_tiles(loss_map, gx, gy)
        prep, bn, rows = _xla_pairs(means3d, scales, rotations, opacities,
                                    camera, colors, cfg, None, live_mask,
                                    None)
        valid, radius = prep.valid, prep.radius
        tile_color, final_T, gs_count, contribs = blend_stats(
            bn.pair_tile, bn.pair_gauss, rows[:, 0:2], rows[:, 2:5],
            rows[:, 5], rows[:, 6:9], bn.seg_start, bn.num_pairs, n, gx, gy,
            cfg.chunk, cfg.power_cutoff, mode, lm, camera.width,
            camera.height)
    else:
        with span("project"):
            prep = project_sh(means3d, scales, rotations, opacities, camera,
                              colors=colors, shs=shs, sh_degree=sh_degree,
                              scale_modifier=cfg.scale_modifier,
                              live_mask=live_mask)
            valid, radius = prep.valid, prep.radius
        pairs, bn = binning.bin_fused_ps1(
            train_order(prep.aux, prep.diff), prep.valid, prep.depth, gx,
            gy, cfg.pair_capacity, cfg.kept_capacity(), cfg.use_obb)
        with span("stats"):
            lm = None if loss_map is None else image_to_tiles(loss_map, gx,
                                                              gy)
            tile_color, final_T, pair_stats, best_lane, best_w, first_trig \
                = blend_stats_kernel(pairs, bn.seg_start, gx, camera.width,
                                     camera.height, cfg.power_cutoff,
                                     cfg.chunk)
        with span("reduce"):
            lane = torch.arange(pairs.shape[1], device=pairs.device)
            gid = torch.where(lane < bn.num_pairs, bn.pair_gauss, n)
            gs_count, contribs = _per_gaussian(
                mode, pairs[5], pair_stats, best_lane, best_w, first_trig,
                gid, bn.seg_start, n, gx, camera.width, camera.height, lm)
    with span("compose"):
        image = tiles_to_image(tile_color, gx, gy, camera.width,
                               camera.height)
        T_img = tiles_to_image(final_T[..., None], gx, gy, camera.width,
                               camera.height)[..., 0]
        if bg_color is not None:
            image = image + T_img[..., None] * torch.as_tensor(
                bg_color, dtype=image.dtype, device=image.device)
        radii = torch.where(valid, radius,
                            torch.zeros_like(radius)).to(torch.int32)
    return {"render": image, "final_T": T_img, "gs_count": gs_count,
            "contribs": contribs, "radii": radii, "binned": bn}
