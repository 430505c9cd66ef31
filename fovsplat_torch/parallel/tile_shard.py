"""Single-frame rendering with the Gaussians sharded over the ranks and
the tiles owned by them (counterpart of fovsplat/parallel/tile_shard.py).

Each rank preprocesses and bins its own Gaussians against every tile
(projection.preprocess, binning.bin_gaussians), routes the (tile, depth,
attributes) rows of its pairs to the rank that owns the tile in one
all-to-all of fixed-capacity blocks, stable-sorts the rows it receives
by (tile, depth), blends, keeps its own tiles and all-gathers the image.
Forward only: training scales by data parallelism over views
(parallel/data_parallel; the rationale is in the JAX module's
docstring).

Order: a rank's rows of one tile arrive in its bin order (depth, then
Gaussian id), and the blocks of the ranks in rank order, so the owner's
stable (tile, depth) sort leaves depth ties in global Gaussian order when
the shards are contiguous id ranges in rank order
(multihost.shard_rows). That is the order of the single-device routes:
bin_gaussians (depth-sorted, then a stable tile sort) and the exact
two-key sort of the fused route (rasterize with sort_exact_depth), so a
sharded frame equals its single-device twin bit for bit (backend "xla":
rasterize(backend="xla"); "kernels": rasterize(fwd_only=True,
sort_exact_depth=True)).

Backends: "xla" blends the f32 rows with the plain walk
(ops/blend.blend_forward_plain); "kernels" (the default, as in
RasterizeConfig) packs the five quantized rows as the fused inference
route does (ops/kernels/expand_ps1.pack_q_rows: cb, cc, opacity and
colour rounded to bf16 first, as the TPU kernel stages them; the JAX
module packs the f32 values directly, tile_shard.py:114-132) and launches
kernel 5q (ops/kernels/blend_fwd.blend_forward_q). Every rank blends the
whole grid, its other tiles empty, as the JAX module does.

Capacities: `pair_capacity` is global (each rank bins pair_capacity // W
candidates); `per_dest_capacity` bounds each (source, destination) block
(default max(2 cap_local // W, 256), JAX's). Pairs past either are
dropped and counted in `overflow`, which is summed over the ranks (the
JAX module returns one rank's count, tile_shard.py:152). Destination
bounds are clamped to the grid, so sentinel rows are never sent as
pairs.
"""

from __future__ import annotations

import torch

from fovsplat_torch.ops import binning, projection
from fovsplat_torch.ops.blend import blend_forward_plain, tiles_to_image
from fovsplat_torch.ops.kernels.blend_fwd import blend_forward_q
from fovsplat_torch.ops.kernels.expand_ps1 import pack_q_rows
from fovsplat_torch.ops.projection import TILE
from fovsplat_torch.parallel import collectives

NATTR = 11   # mx my ca cb cc op r g b depth tile
_DEPTH, _TILE = 9, 10


def dest_blocks(rows, sorted_tile, bounds_tiles, c2: int, sentinel):
    """Fixed-capacity send blocks of tile-sorted rows (CAP, A): block k
    holds the rows whose tile lies in [bounds_tiles[k], bounds_tiles[k +
    1]), at most c2 of them, then `sentinel` rows (A,). Returns (send
    (W, c2, A), per-destination row counts (W,), rows past c2 (0-d))."""
    bounds = torch.searchsorted(sorted_tile, bounds_tiles.to(
        sorted_tile.dtype), side="left")
    counts = bounds[1:] - bounds[:-1]
    idx = bounds[:-1, None] + torch.arange(c2, device=rows.device)[None, :]
    valid = idx < bounds[1:, None]
    gathered = rows[torch.clamp(idx, max=rows.shape[0] - 1)]
    send = torch.where(valid[..., None], gathered, sentinel)
    return send, counts, torch.clamp(counts - c2, min=0).sum()


def owned_tiles(num_tiles: int, w: int, rank: int):
    """(tiles a rank owns at most, first tile, tiles it owns): tile t
    belongs to rank t // ceil(num_tiles / W); the last ranks may own
    fewer tiles, or none."""
    tpd = -(-num_tiles // w)
    t0 = min(rank * tpd, num_tiles)
    return tpd, t0, min(tpd, num_tiles - t0)


def gather_tiles(own, tpd: int, num_tiles: int, group):
    """Every rank's (n_own, ...) tile rows, padded to tpd, all-gathered
    into the (num_tiles, ...) tile-major array."""
    pad = torch.zeros((tpd - own.shape[0], *own.shape[1:]), dtype=own.dtype,
                      device=own.device)
    full = collectives.all_gather(torch.cat([own, pad]), group)
    return full.reshape(-1, *own.shape[1:])[:num_tiles]


def reduce_stats(overflow, num_pairs, max_block, group) -> dict:
    """The aux counts over the ranks from one all-gather of each rank's
    three: overflow and num_pairs summed (JAX's psum), the largest
    (source, destination) block, and each rank's own overflow
    (overflow_by_rank (W,)), all i64."""
    s = collectives.all_gather(torch.stack([
        torch.as_tensor(x).to(torch.int64).reshape(()).to(overflow.device)
        for x in (overflow, num_pairs, max_block)]), group)
    return {"overflow": s[:, 0].sum(), "num_pairs": s[:, 1].sum(),
            "max_dest_block": s[:, 2].max(), "overflow_by_rank": s[:, 0]}


def render_tile_sharded(means3d, scales, rotations, opacities, colors,
                        camera, pair_capacity: int = 1 << 18,
                        per_dest_capacity: int | None = None,
                        chunk: int = 1 << 16, power_cutoff: float = -4.5,
                        bg_color=None, backend: str = "kernels",
                        group=None):
    """Render one view from this rank's Gaussians (its contiguous rows of
    the cloud: means3d (n, 3), scales (n, 3) activated, rotations (n, 4)
    unit, opacities (n,), colors (n, 3)), every rank of `group` calling
    together (a process group or 1-D DeviceMesh; None: the default group;
    one rank is a group of one).

    Returns (image (H, W, 3), aux {final_T (H, W) and reduce_stats'
    counts}), the same on every rank; num_pairs counts the pairs blended,
    max_dest_block the rows of the largest (source, destination) block
    before the capacity cut."""
    if backend not in ("kernels", "xla"):
        raise ValueError(f"backend {backend!r}: 'kernels' or 'xla'")
    w, rank = collectives.world(group)
    dev = means3d.device
    gx = (camera.width + TILE - 1) // TILE
    gy = (camera.height + TILE - 1) // TILE
    num_tiles = gx * gy
    tpd, t0, n_own = owned_tiles(num_tiles, w, rank)
    cap_local = pair_capacity // w
    c2 = per_dest_capacity or max(2 * cap_local // w, 256)

    with torch.no_grad():
        prep = projection.preprocess(means3d, scales, rotations, camera)
        bn = binning.bin_gaussians(prep, gx, gy, cap_local)
        gid = torch.clamp(bn.pair_gauss.long(), max=means3d.shape[0] - 1)
        tile = bn.pair_tile
        depth = torch.where(tile < num_tiles, prep.depth[gid],
                            torch.full_like(prep.depth[gid], float("inf")))
        attrs = torch.cat([prep.mean2d[gid], prep.conic[gid],
                           opacities[gid, None], colors[gid],
                           depth[:, None], tile.float()[:, None]], 1)
        sentinel = torch.zeros(NATTR, device=dev)
        sentinel[_DEPTH], sentinel[_TILE] = float("inf"), float(num_tiles)
        edges = torch.clamp(torch.arange(w + 1, device=dev) * tpd,
                            max=num_tiles)
        send, counts, send_overflow = dest_blocks(attrs, tile, edges, c2,
                                                  sentinel)
        recv = collectives.all_to_all(send, group).reshape(w * c2, NATTR)

        # The owner's stable (tile, depth) sort; depth >= 0 (inf on the
        # sentinel), so its bits order like its value.
        r_tile = recv[:, _TILE].to(torch.int64)
        r_dbits = recv[:, _DEPTH].contiguous().view(torch.int32).long()
        _, perm = torch.sort((r_tile << 32) | r_dbits, stable=True)
        rows = recv[perm]
        seg = torch.searchsorted(
            r_tile[perm], torch.arange(num_tiles + 1, device=dev),
            side="left").to(torch.int32)
        if backend == "kernels":
            q = pack_q_rows(*rows[:, :9].T)
            color, final_T, _ = blend_forward_q(q, seg[:-1], seg[1:], gx,
                                                power_cutoff, chunk)
        else:
            color, final_T, _ = blend_forward_plain(
                rows[:, :9].T.contiguous(), seg, gx, power_cutoff, chunk)

        tile_color = gather_tiles(color[t0:t0 + n_own], tpd, num_tiles,
                                  group)
        tile_T = gather_tiles(final_T[t0:t0 + n_own], tpd, num_tiles, group)
        stats = reduce_stats(bn.overflow + send_overflow,
                             seg[t0 + n_own] - seg[t0], counts.max(), group)
    image = tiles_to_image(tile_color, gx, gy, camera.width, camera.height)
    T_img = tiles_to_image(tile_T[..., None], gx, gy, camera.width,
                           camera.height)[..., 0]
    if bg_color is not None:
        image = image + T_img[..., None] * torch.as_tensor(
            bg_color, dtype=image.dtype, device=dev)
    return image, {"final_T": T_img, **stats}
