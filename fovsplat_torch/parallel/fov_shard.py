"""The foveated "ours" frame with the Gaussians sharded over the ranks
and the tiles owned by them (counterpart of
fovsplat/parallel/fov_shard.py).

Every rank computes the replicated per-gaze tile state (levels, level
bboxes, chain masks and smoothstep weights; ops/foveation,
ops/foveated.chain_masks), then on its own Gaussians runs the fused
frame's kernels: kernel 1 (ops/kernels/build_table, fov mode; kernel 9
first with config.compact_table), kernel 2 (ops/kernels/expand_fov) with
its share of the capacities, the fused i32 key (foveated.fused_key32)
and the exact two-key sort. It routes its rows to the tiles' owners in
one all-to-all of fixed-capacity blocks; each owner stable-sorts what it
receives by (key, depth bits), launches kernel 3 (ops/kernels/blend_fov)
over its own tile range only (tile0), merges the chains with the
background and all-gathers the image. Forward only, as in the JAX
package.

Exchange rows (NROW): the key and the depth bits as f32 bit containers,
then the 13 f32 rows kernel 3 reads (expand_fov.ATTR_ROWS), 60 bytes a
pair. The JAX module sends 8 bf16-packed rows (32 bytes a pair) that its
Pallas blend reads; the port's kernel 3 reads f32 rows.

Order: kernel 2 writes a rank's pairs in Gaussian order, its sort is
stable, the shards are contiguous id ranges in rank order
(shard_fov_model) and the owner's re-sort is stable over blocks arriving
in rank order; so every owner blends its tiles in the single-device
order of rasterize_fov_soa with sort_exact_depth, ties in (key, depth
bits) included, and the frame equals that frame bit for bit. (The JAX
owner's re-sort is not stable, fov_shard.py:184.)

Capacities: config.pair_capacity and config.kept_capacity() are global;
each rank expands ceil(pair_capacity / W) candidates and keeps
ceil(kept / W) pairs (JAX's compact_capacity over the mesh). Each
(source, destination) block holds per_dest_capacity rows (default
max(2 cap_local // W, 256), JAX's). Pairs past any capacity are dropped
and counted; `overflow` and `num_pairs` are summed over the ranks. The
destination bounds are clamped to the grid before the shift, so the i32
bound keys cannot wrap (the JAX bound (k tiles_per_dev) << db wraps when
W tiles_per_dev >= 2^tile_bits, fov_shard.py:160,196), and num_pairs
counts the owned tiles' pairs only (the JAX count takes in sentinel rows
when the tiles do not split evenly, fov_shard.py:222).
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import foveated as fov
from fovsplat_torch.ops.blend import tiles_to_image
from fovsplat_torch.ops.foveation import FoveationConfig
from fovsplat_torch.ops.kernels import build_table as bt
from fovsplat_torch.ops.kernels.blend_fov import blend_fov
from fovsplat_torch.ops.kernels.compact_table import compact_table
from fovsplat_torch.ops.kernels.expand_fov import ATTR_ROWS, expand_fov
from fovsplat_torch.ops.rasterize import RasterizeConfig, _grid
from fovsplat_torch.parallel import collectives, multihost
from fovsplat_torch.parallel.tile_shard import (dest_blocks, gather_tiles,
                                                owned_tiles, reduce_stats)

NROW = 2 + len(ATTR_ROWS)   # key, dbits, then the rows kernel 3 reads


def pad_fov_model(model: fov.FovModelSoA, ndev: int) -> fov.FovModelSoA:
    """The model's N axis padded to a multiple of ndev with dead rows
    (hl = -1: clipped_geometry and kernel 1 mark them invalid)."""
    n = model.xyz.shape[0]
    pad = (-n) % ndev
    if pad == 0:
        return model

    def pn(a):
        return torch.cat([a, torch.zeros((pad, *a.shape[1:]), dtype=a.dtype,
                                         device=a.device)])

    def pl(a):
        return torch.cat([a, torch.zeros((*a.shape[:-1], pad), dtype=a.dtype,
                                         device=a.device)], -1)
    return fov.FovModelSoA(
        xyz=pn(model.xyz), scales=pn(model.scales),
        rotations=pn(model.rotations), rest_t=pl(model.rest_t),
        dc_t=pl(model.dc_t), opac_t=pl(model.opac_t),
        hl=torch.cat([model.hl, torch.full((pad,), -1.0,
                                           device=model.hl.device)]))


def shard_fov_model(model: fov.FovModelSoA, group=None) -> fov.FovModelSoA:
    """This rank's contiguous rows of a whole model (multihost.row_range),
    contiguous in memory."""
    lo, hi = multihost.row_range(model.xyz.shape[0], group)
    rows = {f: getattr(model, f)[lo:hi] for f in ("xyz", "scales",
                                                  "rotations", "hl")}
    cols = {f: getattr(model, f)[..., lo:hi] for f in ("rest_t", "dc_t",
                                                       "opac_t")}
    return fov.FovModelSoA(**{k: v.contiguous()
                              for k, v in {**rows, **cols}.items()})


def _exact_sorted(key, dbits, rows):
    """Rows (R, CAP) stable-sorted by (key, dbits); dbits >= 0 on every
    lane, so one i64 key orders both (foveated.sort_pairs). Returns
    (sorted key, sorted rows)."""
    _, perm = torch.sort((key.long() << 32) | dbits.long(), stable=True)
    return key[perm], rows.index_select(1, perm)


def render_fov_tile_sharded(model: fov.FovModelSoA, camera, gaze,
                            alpha: float = 0.05, blending: bool = True,
                            bg_color=None, sh_degree: int = 3,
                            config: RasterizeConfig = RasterizeConfig(),
                            fov_cfg: FoveationConfig = FoveationConfig(),
                            per_dest_capacity: int | None = None,
                            group=None):
    """Foveated frame of this rank's shard of a packed model (its
    contiguous rows, shard_fov_model), every rank of `group` calling
    together (a process group or 1-D DeviceMesh; None: the default group;
    one rank is a group of one). gaze (2,) f32 on the model's device.

    Returns (image (H, W, 3), aux {tile_levels and tile_shard.reduce_stats'
    counts over all ranks}), the same on every rank."""
    L = fov_cfg.fov_num
    if model.dc_t.shape[1] not in (1, L):
        raise ValueError(f"model has {model.dc_t.shape[1]} colour levels, "
                         f"fov_cfg.fov_num is {L}")
    w, rank = collectives.world(group)
    dev = model.xyz.device
    gx, gy = _grid(camera)
    num_tiles = gx * gy
    tpd, t0, n_own = owned_tiles(num_tiles, w, rank)
    cap_local = -(-config.pair_capacity // w)
    kept_local = -(-config.kept_capacity() // w)
    c2 = per_dest_capacity or max(2 * cap_local // w, 256)
    db = 31 - fov.tile_bits(num_tiles)

    levels, grad_x, grad_y, tile_blend, bbox = fov._tile_levels(
        gaze, camera, alpha, blending, config, fov_cfg)
    est, l1_active, l2_active = fov.chain_masks(levels, grad_x, grad_y,
                                                tile_blend)

    table, cum, total = bt.build_table(model, camera, bbox, sh_degree,
                                       config.scale_modifier)
    if config.compact_table:
        table, cum, _, total = compact_table(table, bt.ROW_VALID, 0.5,
                                             bt.ROW_TNUM)
    ex = expand_fov(table, cum, levels, L, gx, cap_local, kept_local,
                    config.use_obb)
    candidates, kept = total[0], ex.kept[0]
    overflow = (torch.clamp(candidates - cap_local, min=0)
                + torch.clamp(kept - kept_local, min=0))
    key, dbits = fov.fused_key32(ex.tile, ex.depth,
                                 torch.clamp(kept, max=kept_local),
                                 num_tiles)
    f32 = torch.float32
    key, rows = _exact_sorted(key, dbits, torch.cat(
        [key.view(f32)[None], dbits.view(f32)[None], ex.attrs]))

    # Tile t goes to rank t // tpd; the key-sorted list is destination-
    # contiguous. The bounds are clamped to the grid before the shift.
    edges = torch.clamp(torch.arange(w + 1, device=dev) * tpd,
                        max=num_tiles) << db
    sentinel = torch.zeros(NROW, device=dev)
    sentinel[0] = torch.tensor(num_tiles << db, dtype=torch.int32).view(f32)
    send, counts, send_overflow = dest_blocks(rows.T, key, edges, c2,
                                              sentinel)
    recv = collectives.all_to_all(send, group).reshape(w * c2, NROW).T

    r_key, r_rows = _exact_sorted(recv[0].contiguous().view(torch.int32),
                                  recv[1].contiguous().view(torch.int32),
                                  recv[2:])
    seg = torch.searchsorted(
        r_key, (t0 + torch.arange(n_own + 1, device=dev, dtype=torch.int32))
        << db, side="left").to(torch.int32)
    own = slice(t0, t0 + n_own)
    if n_own > 0:
        c1, t1, c2_, t2 = blend_fov(r_rows.contiguous(), seg,
                                    l1_active[own].contiguous(),
                                    l2_active[own].contiguous(), gx,
                                    config.power_cutoff, config.chunk,
                                    tile0=t0)
        color = fov.merge_tiles(c1, t1, c2_, t2, levels[own], est[own],
                                tile_blend[own], bg_color, fov_cfg)
    else:
        color = torch.zeros((0, est.shape[1], 3), device=dev)
    tile_color = gather_tiles(color, tpd, num_tiles, group)
    stats = reduce_stats(overflow + send_overflow, seg[-1] - seg[0],
                         counts.max(), group)
    return (tiles_to_image(tile_color, gx, gy, camera.width, camera.height),
            {**stats, "tile_levels": levels})
