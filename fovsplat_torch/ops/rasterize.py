"""Rasterizer configuration, the single-level render and the packed PS1
inference frame (fovsplat/ops/rasterize.py: RasterizeConfig, _grid,
rasterize with its fused train and forward-only branches,
rasterize.py:157-274, 335-407, and Ps1ModelSoA, pack_ps1_model,
rasterize_ps1_soa, rasterize.py:412-495).

rasterize runs the per-Gaussian projection and SH colour
(ops/kernels/project_sh: on the card kernel 10, csrc/project_sh.cu,
forward and backward; projection.preprocess_cols, sh.sh_to_rgb and
train_columns are its plain twin, which CPU tensors run), the pair
builder (an autograd.Function: kernel 4 and the exact tile sort forward,
the gid sort and kernel 7 backward) and the blend (kernels 5 and 6). Its
gradient reaches the means, scales, rotations, opacities and colours (or
SH coefficients); pair selection (rects, OBB axes, validity) is constant,
as in the reference. With config.fwd_only it takes the inference route
instead: kernel 4's quantized rows, the fused-key sort and the
forward-only blend (kernel 5q), not differentiable. rasterize_ps1_soa
renders a packed model through kernel 1's ps1 mode, optionally kernel 9,
then the same inference route (ps1_pairs, which an MM-FR level pass
also runs over the tiles it owns).

With config.backend = "xla", rasterize takes the JAX package's XLA route
(rasterize.py:201-206, 255-262, 319-324) in plain PyTorch and launches no
kernel: projection.preprocess, binning.bin_gaussians (with tile_mask_fn,
a per-pair cull), the per-pair gather (GatherPairs) and blend.blend. It
is the oracle the kernel route is held against; on the card it runs
there too.

The JAX config's Pallas-only fields are left out: the `pallas_*` and
`expand_*` tuning knobs, `dummy_slack` and `expand_drop_invalid` size
TPU grids, windows and the dummy-pair scheme, none of which the CUDA
kernels have. `pallas_fwd_only` is `fwd_only` here. `backend` selects
the kernel route ("kernels", the default, JAX's fused "pallas" route) or
the XLA route; on the kernel route a tensor on the card runs the kernels,
a tensor on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.ops import blend as blend_ops
from fovsplat_torch.ops import projection, sh
from fovsplat_torch.ops.blend import tiles_to_image
from fovsplat_torch.ops.kernels.blend_fwd import blend, blend_forward_q
from fovsplat_torch.ops.kernels.build_table import build_table_ps1
from fovsplat_torch.ops.kernels.project_sh import (project_sh, sh_tensor,
                                                   train_order)
from fovsplat_torch.ops.kernels.segment_reduce import (
    reduce_by_sorted_gid, reduce_by_sorted_gid_plain)
from fovsplat_torch.ops.projection import TILE
from fovsplat_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    pair_capacity: int = 1 << 18      # candidate (Gaussian, tile) pairs a
                                      # frame may expand; the excess is
                                      # dropped and counted in `overflow`
    chunk: int = 1 << 16              # plain blend: pairs (padded per
                                      # tile) per step; bounds its memory
    power_cutoff: float = -4.5        # skip pairs with power below this
    use_obb: bool = True              # exact tile/Gaussian SAT test
    scale_modifier: float = 1.0
    compact_capacity: int | None = None  # kept pairs the sort runs over;
                                      # None = pair_capacity. The excess
                                      # is dropped and counted
    sort_exact_depth: bool = False    # add the full f32 depth bits as a
                                      # second sort key (exact order);
                                      # else depth ties within ~2^-11
                                      # relative blend in index order
    clip_level_rects: bool = True     # clip each rect to the bbox of the
                                      # tiles its level reaches before
                                      # expansion (output-invariant)
    compact_table: bool = False       # pack the table's live columns to
                                      # the front (kernel 9) before
                                      # expansion (output-invariant)
    fwd_only: bool = False            # rasterize: the forward-only
                                      # inference route (quantized rows,
                                      # kernel 5q), not differentiable
    backend: str = "kernels"          # "kernels" (the fused kernel
                                      # route) or "xla" (the plain
                                      # PyTorch oracle route; no kernel)

    def kept_capacity(self) -> int:
        return (self.pair_capacity if self.compact_capacity is None
                else self.compact_capacity)


def _grid(camera):
    gx = (camera.width + TILE - 1) // TILE
    gy = (camera.height + TILE - 1) // TILE
    return gx, gy


def _images(tile_color, final_T, gx: int, gy: int, camera, bg_color):
    """(image (H, W, 3) with the background, final T (H, W))."""
    image = tiles_to_image(tile_color, gx, gy, camera.width, camera.height)
    T_img = tiles_to_image(final_T[..., None], gx, gy, camera.width,
                           camera.height)[..., 0]
    if bg_color is not None:
        image = image + T_img[..., None] * torch.as_tensor(
            bg_color, dtype=image.dtype, device=image.device)
    return image, T_img


def train_columns(prep, opacities, colors):
    """The 19 per-Gaussian columns of the train route, in the table order
    of ops/kernels/expand_ps1 (rasterize.py:214-226): [rx0, ry0, rw, tnum,
    mx, my, v1x, v1y, v2x, v2y, len1, len2, ca, cb, cc, op, r, g, b]. The
    rect and OBB columns are detached: pair selection is constant
    (rasterize.py:216-226 stop_gradient)."""
    aux = [prep.rx0.float(), prep.ry0.float(),
           torch.clamp(prep.rx1 - prep.rx0, min=1).float(),
           prep.tnum.float(), prep.v1x, prep.v1y, prep.v2x, prep.v2y,
           prep.len1, prep.len2]
    aux = [c.detach() for c in aux]
    return [*aux[0:4], prep.mx, prep.my, *aux[4:10], prep.ca, prep.cb,
            prep.cc, opacities, colors[:, 0], colors[:, 1], colors[:, 2]]


def gid_sorted_stream(d_pairs, gid, num_pairs, n: int):
    """The gid-sorted cotangent stream kernel 7 reduces
    (rasterize.py:381-387): lanes past num_pairs, and lanes whose nine
    cotangents are all zero, carry the sentinel n and sort to the tail.
    Returns (sorted gid (CAP,) i32, sorted rows (9, CAP) f32)."""
    lane = torch.arange(d_pairs.shape[1], device=d_pairs.device)
    vals = torch.where(lane < num_pairs, d_pairs, torch.zeros_like(d_pairs))
    alive = (vals != 0.0).any(0)
    key = torch.where(alive, gid, torch.full_like(gid, n))
    sorted_key, perm = torch.sort(key, stable=True)
    return sorted_key, vals.index_select(1, perm)


class PairBuilder(torch.autograd.Function):
    """The fused train pair builder (rasterize.py:335-407). Forward:
    kernel 4 and the exact tile sort over the 19 train columns of a
    project_sh.Projected (aux, diff). Backward: a generalised gather's
    transpose. The per-pair cotangent rows are sorted by Gaussian id
    (gid_sorted_stream) and kernel 7 sums each Gaussian's run:
    deterministic, no atomics. The sums (9, N) are the gradient of diff
    as they are."""

    @staticmethod
    def forward(ctx, valid, depth, grid_x, grid_y, pair_capacity,
                compact_capacity, use_obb, aux, diff):
        # Imported here: binning imports ops.foveated, which imports this
        # module.
        from fovsplat_torch.ops import binning
        pairs, bn = binning.bin_fused_ps1(train_order(aux, diff), valid,
                                          depth, grid_x, grid_y,
                                          pair_capacity, compact_capacity,
                                          use_obb)
        ctx.save_for_backward(bn.pair_gauss, bn.num_pairs)
        ctx.n = valid.shape[0]
        ctx.mark_non_differentiable(bn.pair_gauss, bn.seg_start,
                                    bn.num_pairs, bn.overflow,
                                    bn.candidates)
        return (pairs[:9], bn.pair_gauss, bn.seg_start, bn.num_pairs,
                bn.overflow, bn.candidates)

    @staticmethod
    def backward(ctx, d_pairs, *_):
        gid, num_pairs = ctx.saved_tensors
        out = reduce_by_sorted_gid(*gid_sorted_stream(d_pairs, gid,
                                                      num_pairs, ctx.n),
                                   ctx.n)
        return (None,) * 8 + (out,)


class GatherPairs(torch.autograd.Function):
    """Per-Gaussian rows x (N, R) gathered at the pairs' Gaussian ids gid
    (CAP,) i64: the XLA route's prep.mean2d[gid], ... (rasterize.py:
    319-324). Backward sums each Gaussian's pair cotangents in a fixed
    order: lanes past num_pairs and all-zero lanes go to the sentinel
    (gid_sorted_stream), a stable sort by gid, then a segmented sum
    (reduce_by_sorted_gid_plain; no kernel, no float atomics)."""

    @staticmethod
    def forward(ctx, gid, num_pairs, x):
        ctx.save_for_backward(gid, num_pairs)
        ctx.n = x.shape[0]
        return x[gid]

    @staticmethod
    def backward(ctx, d):
        gid, num_pairs = ctx.saved_tensors
        key, rows = gid_sorted_stream(d.T, gid, num_pairs, ctx.n)
        return None, None, reduce_by_sorted_gid_plain(key, rows, ctx.n).T


def _xla_pairs(means3d, scales, rotations, opacities, camera, colors, cfg,
               tile_mask_fn, live_mask, mean2d_offset):
    """preprocess, bin_gaussians and the per-pair gather of the XLA route.
    Returns (prep, Binned, rows (CAP, 9): mean2d, conic, opacity,
    colour)."""
    from fovsplat_torch.ops import binning   # see PairBuilder
    gx, gy = _grid(camera)
    prep = projection.preprocess(means3d, scales, rotations, camera,
                                 scale_modifier=cfg.scale_modifier,
                                 live_mask=live_mask)
    if mean2d_offset is not None:
        prep = dataclasses.replace(prep, mean2d=prep.mean2d + mean2d_offset)
    bn = binning.bin_gaussians(prep, gx, gy, cfg.pair_capacity,
                               tile_mask_fn=tile_mask_fn,
                               use_obb=cfg.use_obb)
    gid = torch.clamp(bn.pair_gauss.long(), max=means3d.shape[0] - 1)
    rows = GatherPairs.apply(gid, bn.num_pairs, torch.cat(
        [prep.mean2d, prep.conic, opacities[:, None], colors], 1))
    return prep, bn, rows


def rasterize(means3d, scales, rotations, opacities, camera, colors=None,
              shs=None, sh_degree: int = 3, bg_color=None,
              config: RasterizeConfig = RasterizeConfig(),
              tile_mask_fn=None, live_mask=None, mean2d_offset=None):
    """Render one view through the fused train route (config.backend
    "kernels") or the XLA route ("xla").

    means3d (N, 3); scales (N, 3) activated; rotations (N, 4) unit
    quaternions; opacities (N,) activated; colors (N, 3) precomputed RGB,
    or None to evaluate shs: the pair (sh_a (N, K1, 3), sh_b (N, K2, 3)
    or None), as the model's (features_dc, features_rest), which the
    kernel route reads in place; bg_color (3,) or None (black);
    tile_mask_fn(gaussian, tile) -> bool: a per-pair cull, XLA route
    only (binning.bin_gaussians); live_mask (N,) bool or None;
    mean2d_offset (N, 2) or None, added to
    the projected pixel centres: the reference's screenspace_points
    trick (gaussian_renderer/__init__.py:28-32, rasterize.py:192-196).
    Its gradient is the view-space positional gradient densification
    reads: the pair rows' mx / my cotangents, which kernel 7 sums.

    Returns a dict: render (H, W, 3), final_T (H, W), n_contrib (H, W)
    i32, radii (N,) i32 and binned (ops/binning.Binned: overflow,
    num_pairs, candidates, seg_start, pair_gauss (None with fwd_only);
    0-d tensors on the device, not synchronised). On the kernel route,
    CUDA tensors run the kernels and CPU tensors their plain versions;
    the XLA route's Binned also has pair_tile and depth_order, and it
    ignores fwd_only, as the JAX one does."""
    gx, gy = _grid(camera)
    cfg = config
    if cfg.backend not in ("kernels", "xla"):
        raise ValueError(f"backend {cfg.backend!r}: 'kernels' or 'xla'")
    if tile_mask_fn is not None and cfg.backend != "xla":
        raise ValueError("tile_mask_fn needs backend='xla'")
    if cfg.backend == "xla":
        if colors is None:
            colors = sh.sh_to_rgb(sh_degree, sh_tensor(shs), means3d,
                                  camera.cam_center)
        prep, bn, rows = _xla_pairs(means3d, scales, rotations, opacities,
                                    camera, colors, cfg, tile_mask_fn,
                                    live_mask, mean2d_offset)
        tile_color, final_T, n_contrib = blend_ops.blend(
            bn.pair_tile, rows[:, 0:2], rows[:, 2:5], rows[:, 5],
            rows[:, 6:9], bn.seg_start, bn.num_pairs, gx, gy, cfg.chunk,
            cfg.power_cutoff)
        radii = prep.radius
    else:
        tile_color, final_T, n_contrib, bn, radii = _kernel_route(
            means3d, scales, rotations, opacities, camera, colors, shs,
            sh_degree, cfg, live_mask, mean2d_offset)
    with span("compose"):
        image, T_img = _images(tile_color, final_T, gx, gy, camera,
                               bg_color)
        nc_img = tiles_to_image(n_contrib[..., None], gx, gy, camera.width,
                                camera.height)[..., 0]
    return {"render": image, "final_T": T_img, "n_contrib": nc_img,
            "radii": radii, "binned": bn}


def _kernel_route(means3d, scales, rotations, opacities, camera, colors,
                  shs, sh_degree, cfg, live_mask, mean2d_offset):
    """rasterize's fused train route, or its inference route with
    cfg.fwd_only. Returns (tile colour, final T, n_contrib, Binned, radii
    (N,) i32)."""
    from fovsplat_torch.ops import binning   # see PairBuilder
    gx, gy = _grid(camera)
    prep = project_sh(means3d, scales, rotations, opacities, camera,
                      colors=colors, shs=shs, sh_degree=sh_degree,
                      scale_modifier=cfg.scale_modifier, live_mask=live_mask,
                      mean2d_offset=mean2d_offset)
    if cfg.fwd_only:
        # The inference route (rasterize.py:234-254, 270-274).
        pairs, bn = binning.bin_fused_ps1(
            train_order(prep.aux.detach(), prep.diff.detach()), prep.valid,
            prep.depth.detach(), gx, gy, cfg.pair_capacity,
            cfg.kept_capacity(), cfg.use_obb, train=False,
            sort_exact=cfg.sort_exact_depth)
        with span("blend"):
            tile_color, final_T, n_contrib = blend_forward_q(
                pairs, bn.seg_start[:-1], bn.seg_start[1:], gx,
                cfg.power_cutoff, cfg.chunk)
    else:
        pairs, pair_gauss, seg_start, num_pairs, overflow, candidates = \
            PairBuilder.apply(prep.valid, prep.depth.detach(), gx, gy,
                              cfg.pair_capacity, cfg.kept_capacity(),
                              cfg.use_obb, prep.aux, prep.diff)
        bn = binning.Binned(seg_start=seg_start, num_pairs=num_pairs,
                            overflow=overflow, candidates=candidates,
                            pair_gauss=pair_gauss)
        with span("blend"):
            tile_color, final_T, n_contrib = blend(pairs, seg_start, gx,
                                                   cfg.power_cutoff,
                                                   cfg.chunk)
    radii = torch.where(prep.valid, prep.radius,
                        torch.zeros_like(prep.radius)).to(torch.int32)
    return tile_color, final_T, n_contrib, bn, radii


@dataclasses.dataclass(frozen=True)
class Ps1ModelSoA:
    """A single-level model packed once for the inference render loop
    (rasterize.py:412-423): geometry f32, SH and opacity bf16."""
    xyz: torch.Tensor        # (N, 3)
    scales: torch.Tensor     # (N, 3) activated
    rotations: torch.Tensor  # (N, 4) unit quaternions (w, x, y, z)
    sh_t: torch.Tensor       # (3, K, N) bf16 SH coefficients, DC at k=0
    opac: torch.Tensor       # (N,) bf16 activated opacity


def pack_ps1_model(means3d, scales, rotations, opacities, features_dc,
                   features_rest) -> Ps1ModelSoA:
    """Layout conversion of (N, ...) tensors on one device (rasterize.py:
    426-448): scales, rotations and opacities (N,) activated,
    features_dc (N, 1, 3), features_rest (N, K-1, 3)."""
    bf = torch.bfloat16
    sh_t = torch.cat([features_dc.to(bf).permute(2, 1, 0),
                      features_rest.to(bf).permute(2, 1, 0)], dim=1)
    return Ps1ModelSoA(xyz=means3d.float().contiguous(),
                       scales=scales.float().contiguous(),
                       rotations=rotations.float().contiguous(),
                       sh_t=sh_t.contiguous(),
                       opac=opacities.reshape(-1).to(bf).contiguous())


def ps1_pairs(model: Ps1ModelSoA, camera, sh_degree: int = 3,
              config: RasterizeConfig = RasterizeConfig(), owned=None):
    """The pairs kernel 5q blends in the PS1 frame: kernel 1's ps1 mode,
    kernel 9 with config.compact_table, kernel 4's quantized rows and the
    fused-key sort (exact two-key with sort_exact_depth).

    owned: None (every tile), or an MM-FR pass's ownership (box (4,) i32,
    mask (T,) bool): kernel 1p clips each rect to the box and culls the
    dead rows (build_table.clip_to_box), and the segment of every tile
    outside the mask is emptied, as the reference's per-pass tile_skips
    do. Returns (pairs (5, CAP), seg_start (T,), seg_end (T,), Binned)."""
    from fovsplat_torch.ops import binning   # see PairBuilder
    gx, gy = _grid(camera)
    cfg = config
    box, mask = (None, None) if owned is None else owned
    with span("table"):
        table, cum, total = build_table_ps1(model, camera, sh_degree,
                                            cfg.scale_modifier, box)
        if cfg.compact_table:
            table, cum, total, _ = binning.compact_prebuilt(table)
    pairs, bn = binning.bin_fused_ps1(
        None, None, None, gx, gy, cfg.pair_capacity, cfg.kept_capacity(),
        cfg.use_obb, train=False, sort_exact=cfg.sort_exact_depth,
        prebuilt=(table, cum, total))
    ss, se = bn.seg_start[:-1], bn.seg_start[1:]
    if mask is not None:
        se = torch.where(mask, se, ss)
    return pairs, ss, se, bn


def rasterize_ps1_soa(model: Ps1ModelSoA, camera, bg_color=None,
                      sh_degree: int = 3,
                      config: RasterizeConfig = RasterizeConfig()):
    """The PS1 inference frame over a packed model (rasterize.py:451):
    ps1_pairs over every tile, kernel 5q, tiles_to_image and the
    background.

    Returns a dict: render (H, W, 3), final_T (H, W), num_pairs, overflow
    and candidates (0-d i32 tensors on the device, not synchronised)."""
    gx, gy = _grid(camera)
    pairs, ss, se, bn = ps1_pairs(model, camera, sh_degree, config)
    with span("blend"):
        tile_color, final_T, _ = blend_forward_q(pairs, ss, se, gx,
                                                 config.power_cutoff,
                                                 config.chunk)
    with span("compose"):
        image, T_img = _images(tile_color, final_T, gx, gy, camera,
                               bg_color)
    return {"render": image, "final_T": T_img, "num_pairs": bn.num_pairs,
            "overflow": bn.overflow, "candidates": bn.candidates}
