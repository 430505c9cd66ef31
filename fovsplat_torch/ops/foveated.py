"""Foveated "ours" frame over a packed model (fovsplat/ops/foveated.py:630-887).

rasterize_fov_soa renders one frame in five stages:

  1. per-tile levels, blend flags and per-level clip boxes (torch);
  2. kernel 1, the per-Gaussian table (ops/kernels/build_table);
  3. kernel 2, pair expansion with OBB and level cull and compaction
     (ops/kernels/expand_fov);
  4. the fused-key tile sort: torch.sort on the i32 (tile, depth) key,
     an index_select of the pair rows, torch.searchsorted for segments;
  5. kernel 3, the dual-transmittance blend (ops/kernels/blend_fov), then
     the background, the smoothstep merge and tiles_to_image (torch).

On a model on the card the three kernels run; on a CPU model the same
wrappers take their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.ops import foveation, projection, sh
from fovsplat_torch.ops.blend import PIX, tiles_to_image
from fovsplat_torch.ops.foveation import FoveationConfig
from fovsplat_torch.ops.kernels.blend_fov import blend_fov
from fovsplat_torch.ops.kernels.build_table import build_table
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
    dc_t: torch.Tensor       # (3, L, N) bf16 per-level DC
    opac_t: torch.Tensor     # (L, N) bf16 activated per-level opacity
    hl: torch.Tensor         # (N,) f32 highest level; < 0 marks a dead row


def pack_fov_model(means3d, scales, rotations, opacities, shs_dcs, shs_rest,
                   highest_levels) -> FovModelSoA:
    """Layout conversion of (N, ...) tensors on one device: opacities
    (N, L), shs_dcs (N, L, 3), shs_rest (N, K-1, 3), highest_levels
    (N,)."""
    n = means3d.shape[0]
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


def fov_soa_cols(xyz, scales, rotations, rest_t, dc_t, opac_t, hl, camera,
                 bbox, L: int, sh_degree: int, scale_modifier: float = 1.0):
    """Per-Gaussian preprocess, level-rect clip and per-level colour and
    opacity columns (fovsplat/ops/foveated.py:705). bbox: (4, L) i32.
    Returns (t1cols, t2cols, valid, depth): t1cols the 16 columns [rx0,
    ry0, rw, tnum, mx, my, v1x, v1y, v2x, v2y, len1, len2, ca, cb, cc,
    hl] and t2cols the 4L columns [op_0..op_L-1, r_*, g_*, b_*]."""
    pc = projection.preprocess_cols(xyz, scales, rotations, camera,
                                    scale_modifier=scale_modifier)
    hli = torch.clamp(hl.to(torch.int32), 0, L - 1).long()
    rx0 = torch.maximum(pc.rx0, bbox[0][hli])
    ry0 = torch.maximum(pc.ry0, bbox[1][hli])
    rx1 = torch.minimum(pc.rx1, bbox[2][hli])
    ry1 = torch.minimum(pc.ry1, bbox[3][hli])
    tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = pc.valid & (tnum > 0) & (hl >= 0.0)
    tnum = torch.where(valid, tnum, torch.zeros_like(tnum))
    rx1 = torch.maximum(rx1, rx0)

    # Shared SH rest term + per-level DC. The max guard keeps a Gaussian
    # at the camera centre finite.
    dx_ = xyz[:, 0] - camera.cam_center[0]
    dy_ = xyz[:, 1] - camera.cam_center[1]
    dz_ = xyz[:, 2] - camera.cam_center[2]
    inv = torch.rsqrt(torch.clamp(dx_ * dx_ + dy_ * dy_ + dz_ * dz_,
                                  min=1e-20))
    rest_c = sh._eval_sh_nlast(sh_degree, rest_t, dx_ * inv, dy_ * inv,
                               dz_ * inv) + 0.5                   # (3, N)

    t1cols = [rx0.float(), ry0.float(),
              torch.clamp(rx1 - rx0, min=1).float(), tnum.float(),
              pc.mx, pc.my, pc.v1x, pc.v1y, pc.v2x, pc.v2y, pc.len1,
              pc.len2, pc.ca, pc.cb, pc.cc, hl]
    t2cols = ([opac_t[l].float() for l in range(L)]
              + [torch.clamp(sh.SH_C0 * dc_t[c, l].float() + rest_c[c],
                             min=0.0)
                 for c in range(3) for l in range(L)])
    return t1cols, t2cols, valid, pc.depth


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
    kept pairs past the compact capacity; candidates has no dummy pairs."""
    dev = model.xyz.device
    gx, gy = _grid(camera)
    num_tiles = gx * gy
    L = fov_cfg.fov_num
    if model.dc_t.shape[1] != L:
        raise ValueError(f"model has {model.dc_t.shape[1]} colour levels, "
                         f"fov_cfg.fov_num is {L}")
    cap_out = config.kept_capacity()

    levels = foveation.compute_tile_levels(gaze, camera.width, camera.height,
                                           alpha, fov_cfg)
    grad_x, grad_y, _, tile_blend = foveation.compute_tile_level_infos(
        levels, camera.width, camera.height, fov_cfg)
    if not blending:
        tile_blend = torch.zeros_like(tile_blend)
    bbox = level_bboxes(levels, gx, gy, L, config.clip_level_rects)

    table, cum, total = build_table(model, camera, bbox, sh_degree,
                                    config.scale_modifier)
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

    bg = (torch.zeros(3, device=dev) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))
    c1 = c1 + t1[..., None] * bg
    c2 = c2 + t2[..., None] * bg
    # Smoothstep merge (reference forward.cu:459-476).
    l1_i = levels.to(torch.int32)
    x = torch.abs(est - (l1_i[:, None].float() + fov_cfg.start_blend))
    x = torch.clamp(x / fov_cfg.blend_width, 0.0, 1.0)
    blend_T = 3 * x * x - 2 * x * x * x
    l1_w = 1.0 - blend_T
    merged = c1 * l1_w[..., None] + c2 * (1.0 - l1_w[..., None])
    tile_color = torch.where(tile_blend[:, None, None], merged, c1)

    image = tiles_to_image(tile_color, gx, gy, camera.width, camera.height)
    return {"render": image, "tile_levels": levels, "tile_blend": tile_blend,
            "num_pairs": seg_start[-1], "overflow": overflow,
            "candidates": candidates}
