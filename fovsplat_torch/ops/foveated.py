"""Foveated "ours" frame over a packed model (fovsplat/ops/foveated.py:630-887)
and over an unpacked f32 model (rasterize_fov, foveated.py:404).

rasterize_fov_soa renders one frame in five stages:

  1. per-tile levels, blend flags and per-level clip boxes (torch);
  2. kernel 1, the per-Gaussian table (ops/kernels/build_table);
  3. kernel 2, pair expansion with OBB and level cull and compaction
     (ops/kernels/expand_fov);
  4. the fused-key tile sort: torch.sort on the i32 (tile, depth) key,
     an index_select of the pair rows, torch.searchsorted for segments;
  5. kernel 3, the dual-transmittance blend (ops/kernels/blend_fov), then
     the background, the smoothstep merge and tiles_to_image (torch).

With config.compact_table, kernel 9 (ops/kernels/compact_table) packs
the valid columns of the table before stage 3. A shared-colour model
(pack_fov_model(shared_colors=True), the SM-FR baseline) has one colour
and opacity per Gaussian; the cull still runs at every level.

rasterize_fov builds stage 2's table in f32 from torch columns instead of
kernel 1, as the JAX function builds it with XLA (build_fov_dtable), and
then runs stages 3-5. On a model on the card the kernels run; on a CPU
model the same wrappers take their plain versions. With config.backend
"xla" it takes the JAX package's XLA route instead, in plain PyTorch
(_render_xla: bin_gaussians with the level cull, then _dual_blend).
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.ops import foveation, projection, sh
from fovsplat_torch.ops.blend import PIX, tiles_to_image
from fovsplat_torch.ops.foveation import FoveationConfig
from fovsplat_torch.ops.kernels.blend_fov import blend_fov, blend_fov_plain
from fovsplat_torch.ops.kernels import build_table as bt
from fovsplat_torch.ops.kernels.build_table import build_table
from fovsplat_torch.ops.kernels.compact_table import compact_table
from fovsplat_torch.ops.kernels.expand_fov import expand_fov
from fovsplat_torch.ops.projection import TILE
from fovsplat_torch.ops.rasterize import RasterizeConfig, _grid

_BBOX_NONE = 1 << 20   # x0/y0 of a level that reaches no tile


@dataclasses.dataclass(frozen=True)
class FovModelSoA:
    """A foveated model packed once for the render loop. Geometry is f32;
    SH, DC and opacity are bf16, as the JAX packing stores them."""
    xyz: torch.Tensor        # (N, 3)
    scales: torch.Tensor     # (N, 3) activated
    rotations: torch.Tensor  # (N, 4) unit quaternions (w, x, y, z)
    rest_t: torch.Tensor     # (3, K, N) bf16 SH coefficients, zero at k=0
    dc_t: torch.Tensor       # (3, L_lay, N) bf16 per-level DC
    opac_t: torch.Tensor     # (L_lay, N) bf16 activated per-level opacity
                             # (L_lay = L, or 1 for shared colours)
    hl: torch.Tensor         # (N,) f32 highest level; < 0 marks a dead row


def pack_fov_model(means3d, scales, rotations, opacities, shs_dcs, shs_rest,
                   highest_levels, shared_colors: bool = False) -> FovModelSoA:
    """Layout conversion of (N, ...) tensors on one device: opacities
    (N, L), shs_dcs (N, L, 3), shs_rest (N, K-1, 3), highest_levels
    (N,). shared_colors packs the SM-FR layout (foveated.py:648-670): one
    DC and opacity per Gaussian (opacities (N,) or (N, L) column 0,
    shs_dcs level 0), while highest_levels still drive the cull."""
    n = means3d.shape[0]
    if shared_colors:
        opacities = (opacities[:, :1] if opacities.dim() == 2
                     else opacities[:, None])
        shs_dcs = shs_dcs[:, :1, :]
    bf = torch.bfloat16
    rest_t = torch.cat([
        torch.zeros((3, 1, n), dtype=bf, device=means3d.device),
        shs_rest.to(bf).permute(2, 1, 0)], dim=1)
    return FovModelSoA(
        xyz=means3d.float().contiguous(),
        scales=scales.float().contiguous(),
        rotations=rotations.float().contiguous(),
        rest_t=rest_t.contiguous(),
        dc_t=shs_dcs.to(bf).permute(2, 1, 0).contiguous(),
        opac_t=opacities.to(bf).T.contiguous(),
        hl=highest_levels.float().contiguous())


def level_bboxes(levels, grid_x: int, grid_y: int, L: int,
                 clip: bool = True) -> torch.Tensor:
    """(4, L) i32 per-level clip boxes, rows x0, y0, x1, y1: the bbox of
    the tiles with level < h + 1 (x0 = y0 = 1 << 20, x1 = y1 = 0 when a
    level reaches no tile). clip=False gives the whole grid."""
    dev = levels.device
    if not clip:
        return torch.tensor([[0] * L, [0] * L, [grid_x] * L, [grid_y] * L],
                            dtype=torch.int32, device=dev)
    lv2d = levels.reshape(grid_y, grid_x)
    ok = lv2d[None] < (torch.arange(L, device=dev, dtype=torch.float32)
                       + 1.0)[:, None, None]                   # (L, gy, gx)
    txs = torch.arange(grid_x, device=dev).expand(L, grid_y, grid_x)
    tys = torch.arange(grid_y, device=dev)[:, None].expand(L, grid_y, grid_x)
    big = torch.full_like(txs, _BBOX_NONE)
    zero = torch.zeros_like(txs)
    return torch.stack([
        torch.where(ok, txs, big).amin((1, 2)),
        torch.where(ok, tys, big).amin((1, 2)),
        torch.where(ok, txs + 1, zero).amax((1, 2)),
        torch.where(ok, tys + 1, zero).amax((1, 2))]).to(torch.int32)


def clipped_geometry(pc, hl, bbox, L: int):
    """The level-rect clip (foveated.py:44-81) of preprocess_cols' output:
    each rect cut to the bbox of its Gaussian's highest level. Returns
    (t1cols, valid): the 16 columns [rx0, ry0, rw, tnum, mx, my, v1x, v1y,
    v2x, v2y, len1, len2, ca, cb, cc, hl], tnum 0 on invalid rows."""
    hli = torch.clamp(hl.to(torch.int32), 0, L - 1).long()
    rx0 = torch.maximum(pc.rx0, bbox[0][hli])
    ry0 = torch.maximum(pc.ry0, bbox[1][hli])
    rx1 = torch.minimum(pc.rx1, bbox[2][hli])
    ry1 = torch.minimum(pc.ry1, bbox[3][hli])
    tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = pc.valid & (tnum > 0) & (hl >= 0.0)
    tnum = torch.where(valid, tnum, torch.zeros_like(tnum))
    rx1 = torch.maximum(rx1, rx0)
    t1cols = [rx0.float(), ry0.float(),
              torch.clamp(rx1 - rx0, min=1).float(), tnum.float(),
              pc.mx, pc.my, pc.v1x, pc.v1y, pc.v2x, pc.v2y, pc.len1,
              pc.len2, pc.ca, pc.cb, pc.cc, hl]
    return t1cols, valid


def level_cols(opacities, colors):
    """The 4 L per-level columns [op_0.., r_*, g_*, b_*] of (N, L)
    opacities and (N, L, 3) colours."""
    L = opacities.shape[1]
    return ([opacities[:, lv] for lv in range(L)]
            + [colors[:, lv, c] for c in range(3) for lv in range(L)])


def fov_soa_cols(xyz, scales, rotations, rest_t, dc_t, opac_t, hl, camera,
                 bbox, L: int, sh_degree: int, scale_modifier: float = 1.0):
    """Per-Gaussian preprocess, level-rect clip and per-level colour and
    opacity columns of a packed model (fovsplat/ops/foveated.py:705).
    bbox: (4, L) i32 for the L levels of the cull; the colour layout has
    L_lay = dc_t.shape[1] levels (L, or 1 for the SM-FR shared layout).
    Returns (t1cols, t2cols, valid, depth) (clipped_geometry, level_cols)."""
    pc = projection.preprocess_cols(xyz, scales, rotations, camera,
                                    scale_modifier=scale_modifier)
    t1cols, valid = clipped_geometry(pc, hl, bbox, L)

    # Shared SH rest term + per-level DC. The max guard keeps a Gaussian
    # at the camera centre finite.
    dx_ = xyz[:, 0] - camera.cam_center[0]
    dy_ = xyz[:, 1] - camera.cam_center[1]
    dz_ = xyz[:, 2] - camera.cam_center[2]
    inv = torch.rsqrt(torch.clamp(dx_ * dx_ + dy_ * dy_ + dz_ * dz_,
                                  min=1e-20))
    rest_c = sh._eval_sh_nlast(sh_degree, rest_t, dx_ * inv, dy_ * inv,
                               dz_ * inv) + 0.5                   # (3, N)
    colors = torch.clamp(sh.SH_C0 * dc_t.float() + rest_c[:, None, :],
                         min=0.0).permute(2, 1, 0)        # (N, L_lay, 3)
    return t1cols, level_cols(opac_t.float().T, colors), valid, pc.depth


def compute_fov_colors(means3d, shs_rest, shs_dcs, cam_center,
                       sh_degree: int = 3) -> torch.Tensor:
    """(N, L, 3) per-level clamped RGB (foveated.py:93): the shared SH rest
    term (sh.eval_sh_rest) plus each level's DC, clamped at 0. shs_rest
    (N, K-1, 3), shs_dcs (N, L, 3)."""
    rest = sh.eval_sh_rest(sh_degree, shs_rest, means3d, cam_center)
    return torch.clamp(sh.SH_C0 * shs_dcs + rest[:, None, :], min=0.0)


def tile_bits(num_tiles: int) -> int:
    """Bits for tile ids 0..num_tiles (the sentinel included)."""
    return max(int(num_tiles + 1).bit_length(), 1)


def fused_key32(tile, depth, usable, num_tiles: int):
    """i32 sort keys (fovsplat/ops/pallas/expand_fov.py:116, bit for bit).

    key = tile << db | f32_bits(depth) >> (32 - db), db = 31 -
    tile_bits(num_tiles): view-space depth is positive, so its high float
    bits order like the depth. dbits = the full depth bits, the exact
    second key. Lanes >= usable (a 0-d tensor) get the sentinel
    num_tiles << db, which sorts last, and dbits 0."""
    db = 31 - tile_bits(num_tiles)
    dbits = depth.view(torch.int32)
    key = (tile << db) | (dbits >> (32 - db))
    ok = torch.arange(tile.shape[0], device=tile.device) < usable
    return (torch.where(ok, key, torch.full_like(key, num_tiles << db)),
            torch.where(ok, dbits, torch.zeros_like(dbits)))


def seg_bounds32(num_tiles: int, device=None) -> torch.Tensor:
    """searchsorted boundaries for the i32 fused key."""
    db = 31 - tile_bits(num_tiles)
    return torch.arange(num_tiles + 1, dtype=torch.int32, device=device) << db


def sort_pairs(key, dbits, attrs, num_tiles: int, exact: bool):
    """Stable sort of the pair rows by key (and by the exact depth bits
    when `exact`). Returns (sorted attrs (13, CAP), seg_start (T+1,) i32)."""
    if exact:
        # dbits >= 0 on every lane, so one i64 key orders (key, dbits).
        _, perm = torch.sort((key.long() << 32) | dbits.long(), stable=True)
        sorted_key = key[perm]
    else:
        sorted_key, perm = torch.sort(key, stable=True)
    seg_start = torch.searchsorted(
        sorted_key, seg_bounds32(num_tiles, key.device),
        side="left").to(torch.int32)
    return attrs.index_select(1, perm), seg_start


def chain_masks(levels, grad_x, grad_y, tile_blend):
    """Per-pixel estimated level est (T, PIX) and the chain activity masks
    (renderCUDA_blending's L1_done init and L2_done): on blending tiles
    chain 1 runs where est <= floor(level) + 1 and chain 2 everywhere; on
    plain tiles chain 1 runs everywhere and chain 2 nowhere."""
    pix = torch.arange(PIX, device=levels.device)
    lx = (pix % TILE).float()
    ly = torch.floor(pix.float() / TILE)
    est = (levels[:, None]
           + (lx[None, :] * grad_x[:, None] + ly[None, :] * grad_y[:, None])
           / TILE)
    l1_active = torch.where(tile_blend[:, None],
                            est <= (levels.to(torch.int32) + 1)[:, None].float(),
                            torch.ones_like(est, dtype=torch.bool))
    l2_active = tile_blend[:, None].expand(est.shape).contiguous()
    return est, l1_active.contiguous(), l2_active


def _render_table(table, cum, total, levels, grad_x, grad_y, tile_blend,
                  camera, L: int, bg_color, config: RasterizeConfig,
                  fov_cfg: FoveationConfig):
    """Stages 3-5 of a foveated frame over kernel 2's table (kernel 9
    first with config.compact_table): expansion, the tile sort, the
    dual-transmittance blend, the background and the smoothstep merge.
    Returns the dict of rasterize_fov_soa."""
    gx, gy = _grid(camera)
    num_tiles = gx * gy
    cap_out = config.kept_capacity()
    if config.compact_table:
        table, cum, _, total = compact_table(table, bt.ROW_VALID, 0.5,
                                             bt.ROW_TNUM)
    ex = expand_fov(table, cum, levels, L, gx, config.pair_capacity,
                    cap_out, config.use_obb)
    candidates, kept = total[0], ex.kept[0]
    overflow = (torch.clamp(candidates - config.pair_capacity, min=0)
                + torch.clamp(kept - cap_out, min=0))
    key, dbits = fused_key32(ex.tile, ex.depth,
                             torch.clamp(kept, max=cap_out), num_tiles)
    pairs, seg_start = sort_pairs(key, dbits, ex.attrs, num_tiles,
                                  config.sort_exact_depth)

    est, l1_active, l2_active = chain_masks(levels, grad_x, grad_y,
                                            tile_blend)
    c1, t1, c2, t2 = blend_fov(pairs, seg_start, l1_active, l2_active, gx,
                               config.power_cutoff, config.chunk)
    return {"render": _merge(c1, t1, c2, t2, levels, est, tile_blend,
                             camera, bg_color, fov_cfg),
            "tile_levels": levels, "tile_blend": tile_blend,
            "num_pairs": seg_start[-1], "overflow": overflow,
            "candidates": candidates}


def _merge(c1, t1, c2, t2, levels, est, tile_blend, camera, bg_color,
           fov_cfg: FoveationConfig):
    """The background on both chains, then the smoothstep merge of the
    blending tiles (reference forward.cu:459-476); the image (H, W, 3)."""
    gx, gy = _grid(camera)
    return tiles_to_image(merge_tiles(c1, t1, c2, t2, levels, est,
                                      tile_blend, bg_color, fov_cfg),
                          gx, gy, camera.width, camera.height)


def merge_tiles(c1, t1, c2, t2, levels, est, tile_blend, bg_color,
                fov_cfg: FoveationConfig):
    """_merge's tile colours (T, PIX, 3) of any run of tiles, given their
    rows of levels, est and tile_blend: elementwise per tile, so a
    tile-sharded owner's tiles come out as in the whole frame."""
    dev = c1.device
    bg = (torch.zeros(3, device=dev) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))
    c1 = c1 + t1[..., None] * bg
    c2 = c2 + t2[..., None] * bg
    l1_i = levels.to(torch.int32)
    x = torch.abs(est - (l1_i[:, None].float() + fov_cfg.start_blend))
    x = torch.clamp(x / fov_cfg.blend_width, 0.0, 1.0)
    blend_T = 3 * x * x - 2 * x * x * x
    l1_w = 1.0 - blend_T
    merged = c1 * l1_w[..., None] + c2 * (1.0 - l1_w[..., None])
    return torch.where(tile_blend[:, None, None], merged, c1)


def _dual_blend(pair_tile, pair_mean2d, pair_conic, pair_op1, pair_op2,
                pair_col1, pair_col2, pair_l2_cull, seg_start, num_pairs,
                tile_l1_active, tile_l2_active, grid_x: int, grid_y: int,
                chunk: int, power_cutoff: float):
    """The XLA route's two transmittance chains over a tile-sorted pair
    list (foveated.py:315-402), in plain PyTorch: kernel 3's plain walk
    (blend_fov_plain, _dual_blend's log-space chains) over the pairs'
    rows, a pair culled from chain 2 (pair_l2_cull) carrying opacity 0
    there (alpha below ALPHA_MIN skips it). tile_l1_active /
    tile_l2_active (T, PIX) bool; the per-pair inputs as ops/blend.blend's,
    with an opacity and a colour per chain. Returns (C1 (T, PIX, 3), C2,
    T1 (T, PIX), T2)."""
    del pair_tile, num_pairs, grid_y
    op2 = torch.where(pair_l2_cull, torch.zeros_like(pair_op2), pair_op2)
    pairs = torch.cat([pair_mean2d.T, pair_conic.T, pair_op1[None],
                       op2[None], pair_col1.T, pair_col2.T]).contiguous()
    c1, t1, c2, t2 = blend_fov_plain(pairs, seg_start, tile_l1_active,
                                     tile_l2_active, grid_x, power_cutoff,
                                     chunk)
    return c1, c2, t1, t2


def _clip_rects_to_levels(prep, hl, bbox, L: int):
    """The level-rect clip (foveated.py:44-81) of a projection.
    Preprocessed: each rect cut to the bbox (4, L) of its Gaussian's
    highest level; output-invariant under the level cull."""
    hli = torch.clamp(hl.to(torch.int32), 0, L - 1).long()
    gb = bbox.T[hli]                                         # (N, 4)
    new_min = torch.maximum(prep.rect_min, gb[:, 0:2])
    new_max = torch.minimum(prep.rect_max, gb[:, 2:4])
    wh = torch.clamp(new_max - new_min, min=0)
    new_tnum = wh[:, 0] * wh[:, 1]
    return dataclasses.replace(
        prep, rect_min=new_min, rect_max=torch.maximum(new_max, new_min),
        tiles_touched=torch.where(prep.valid, new_tnum,
                                  torch.zeros_like(new_tnum)),
        valid=prep.valid & (new_tnum > 0))


def _render_xla(means3d, scales, rotations, opacities, colors, hl, camera,
                levels, grad_x, grad_y, tile_blend, bbox, L: int, bg_color,
                config: RasterizeConfig, fov_cfg: FoveationConfig,
                live_mask):
    """rasterize_fov's XLA route (foveated.py:489-527, 603): preprocess,
    the level-rect clip, bin_gaussians with the per-pair level cull, the
    per-level rows gathered after the sort, _dual_blend and the merge.
    Plain PyTorch, no kernel."""
    from fovsplat_torch.ops import binning   # binning imports this module
    gx, gy = _grid(camera)
    num_tiles = gx * gy
    n = means3d.shape[0]
    prep = projection.preprocess(means3d, scales, rotations, camera,
                                 scale_modifier=config.scale_modifier,
                                 live_mask=live_mask)
    prep = _clip_rects_to_levels(prep, hl, bbox, L)

    def level_mask(orig, tile):
        return levels[torch.clamp(tile, max=num_tiles - 1)] < hl[orig] + 1.0

    bn = binning.bin_gaussians(prep, gx, gy, config.pair_capacity,
                               tile_mask_fn=level_mask,
                               use_obb=config.use_obb)
    gid = torch.clamp(bn.pair_gauss.long(), max=n - 1)
    kt = torch.clamp(bn.pair_tile.long(), max=num_tiles - 1)
    l1_i = levels.to(torch.int32)
    l2_i = torch.clamp(l1_i + 1, max=L - 1)
    lvl_table = torch.cat([colors.reshape(n * L, 3),
                           opacities.reshape(n * L, 1),
                           hl[:, None, None].expand(n, L, 1).reshape(n * L,
                                                                     1)], 1)
    row1 = lvl_table[gid * L + l1_i[kt]]
    row2 = lvl_table[gid * L + l2_i[kt]]
    l2_cull = (row1[:, 4] + 1.0) < (levels[kt] + 1.0)
    est, l1_active, l2_active = chain_masks(levels, grad_x, grad_y,
                                            tile_blend)
    c1, c2, t1, t2 = _dual_blend(
        bn.pair_tile, prep.mean2d[gid], prep.conic[gid], row1[:, 3],
        row2[:, 3], row1[:, 0:3], row2[:, 0:3], l2_cull, bn.seg_start,
        bn.num_pairs, l1_active, l2_active, gx, gy, config.chunk,
        config.power_cutoff)
    return {"render": _merge(c1, t1, c2, t2, levels, est, tile_blend,
                             camera, bg_color, fov_cfg),
            "tile_levels": levels, "tile_blend": tile_blend,
            "num_pairs": bn.num_pairs, "overflow": bn.overflow,
            "candidates": bn.candidates}


def _tile_levels(gaze, camera, alpha, blending: bool, config, fov_cfg):
    """Per-tile levels, gradients, blend flags and per-level clip boxes."""
    gx, gy = _grid(camera)
    levels = foveation.compute_tile_levels(gaze, camera.width, camera.height,
                                           alpha, fov_cfg)
    grad_x, grad_y, _, tile_blend = foveation.compute_tile_level_infos(
        levels, camera.width, camera.height, fov_cfg)
    if not blending:
        tile_blend = torch.zeros_like(tile_blend)
    bbox = level_bboxes(levels, gx, gy, fov_cfg.fov_num,
                        config.clip_level_rects)
    return levels, grad_x, grad_y, tile_blend, bbox


def rasterize_fov_soa(model: FovModelSoA, camera, gaze, alpha,
                      blending: bool = True, bg_color=None,
                      sh_degree: int = 3,
                      config: RasterizeConfig = RasterizeConfig(),
                      fov_cfg: FoveationConfig = FoveationConfig()):
    """Foveated render of a packed model. gaze: (2,) f32 tensor in [0, 1]
    on the model's device; alpha: foveation strength.

    Returns a dict: render (H, W, 3), tile_levels (T,), tile_blend (T,),
    num_pairs, overflow and candidates (0-d i32 tensors, on the device,
    not synchronised). overflow counts candidates past pair_capacity plus
    kept pairs past the compact capacity; candidates has no dummy pairs.
    The model's colour levels are fov_cfg.fov_num or 1 (shared)."""
    L = fov_cfg.fov_num
    if model.dc_t.shape[1] not in (1, L):
        raise ValueError(f"model has {model.dc_t.shape[1]} colour levels, "
                         f"fov_cfg.fov_num is {L}")
    levels, grad_x, grad_y, tile_blend, bbox = _tile_levels(
        gaze, camera, alpha, blending, config, fov_cfg)
    table, cum, total = build_table(model, camera, bbox, sh_degree,
                                    config.scale_modifier)
    return _render_table(table, cum, total, levels, grad_x, grad_y,
                         tile_blend, camera, L, bg_color, config, fov_cfg)


def rasterize_fov(means3d, scales, rotations, opacities, shs_dcs, shs_rest,
                  highest_levels, camera, gaze, alpha,
                  blending: bool = True, bg_color=None, sh_degree: int = 3,
                  config: RasterizeConfig = RasterizeConfig(),
                  fov_cfg: FoveationConfig = FoveationConfig(),
                  colors_override=None, opacity_shared=None,
                  live_mask=None):
    """Foveated render ("ours" FR) of an unpacked model in f32
    (foveated.py:404), for inference: not differentiable.

    opacities (N, L) activated per-level opacity, or None with
    opacity_shared (N,) (the SM-FR baseline); shs_dcs (N, L, 3) per-level
    DC, or None with colors_override (N, L, 3) precomputed colours;
    shs_rest (N, K-1, 3); highest_levels (N,); gaze (2,) in [0, 1];
    live_mask (N,) bool or None.

    The 16 + 4 L columns are built here in f32 (preprocess_cols,
    clipped_geometry, compute_fov_colors) and assembled into kernel 2's
    table (build_table.assemble_table, the counterpart of
    build_fov_dtable); kernel 1 does not run. Then kernel 2, the tile
    sort and kernel 3, as in rasterize_fov_soa, whose dict it returns.
    With config.backend "xla", the XLA route instead (_render_xla: plain
    PyTorch, no kernel), with the same dict."""
    dev = means3d.device
    L = fov_cfg.fov_num
    n = means3d.shape[0]
    gaze = torch.as_tensor(gaze, dtype=torch.float32, device=dev)
    levels, grad_x, grad_y, tile_blend, bbox = _tile_levels(
        gaze, camera, alpha, blending, config, fov_cfg)
    with torch.no_grad():
        hl = highest_levels.float()
        colors = (compute_fov_colors(means3d, shs_rest, shs_dcs,
                                     camera.cam_center, sh_degree)
                  if colors_override is None else colors_override)
        if opacity_shared is not None:
            opacities = opacity_shared[:, None].expand(n, L)
        if config.backend == "xla":
            return _render_xla(means3d, scales, rotations, opacities.float(),
                               colors.float(), hl, camera, levels, grad_x,
                               grad_y, tile_blend, bbox, L, bg_color, config,
                               fov_cfg, live_mask)
        pc = projection.preprocess_cols(means3d, scales, rotations, camera,
                                        scale_modifier=config.scale_modifier,
                                        live_mask=live_mask)
        t1cols, valid = clipped_geometry(pc, hl, bbox, L)
        table, cum, total = bt.assemble_table(
            t1cols, level_cols(opacities.float(), colors.float()), valid,
            pc.depth)
        return _render_table(table, cum, total, levels, grad_x, grad_y,
                             tile_blend, camera, L, bg_color, config,
                             fov_cfg)
