"""Tile binning (counterpart of fovsplat/ops/binning.py: obb_pass,
bin_gaussians, bin_fused_ps1 / _ps1_expand_sort and compact_prebuilt).

bin_gaussians is the XLA route's binning in plain PyTorch, no kernel:
depth sort, pair expansion by rank, OBB cull and an optional per-pair
cull hook, one stable tile sort.

bin_fused_ps1 is the torch glue around kernel 4 (ops/kernels/expand_ps1):
valid-masked per-Gaussian columns and their exclusive cumsum (or a
prebuilt table from kernel 1's ps1 mode, optionally compacted by kernel
9), the expansion kernel, then the tile sort and the segment bounds. The
train route writes exact f32 rows and sorts on two keys (the fused i32
key, then the full depth bits); the inference route writes the quantized
rows and sorts on the fused key alone unless `sort_exact`. The JAX
route's bf16 split-row table, dummy pair per invalid row and window
slack are devices of the TPU kernel; the port's table is f32 and has no
dummy candidates.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.ops.foveated import fused_key32, sort_pairs
from fovsplat_torch.ops.kernels import expand_ps1 as ep1
from fovsplat_torch.ops.kernels.compact_table import compact_table
from fovsplat_torch.ops.kernels.expand_ps1 import expand_ps1, ps1_table
from fovsplat_torch.ops.projection import TILE
from fovsplat_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Binned:
    """Sorted pair list of one view. CAP = the kept capacity."""
    seg_start: torch.Tensor   # (T+1,) i32 segment bounds
    num_pairs: torch.Tensor   # () i32 kept pairs in the sorted list
    overflow: torch.Tensor    # () i32 candidates past the pair capacity
                              # plus kept pairs past the kept capacity
    candidates: torch.Tensor  # () i32 candidate pairs (no dummy pairs)
    pair_gauss: torch.Tensor | None  # (CAP,) i32 Gaussian of each sorted
                              # pair (train route; None on the inference
                              # route); lanes at or past num_pairs are
                              # unspecified
    pair_tile: torch.Tensor | None = None  # (CAP,) i32 ascending tile of
                              # each sorted pair, num_tiles past num_pairs
                              # (bin_gaussians only)
    depth_order: torch.Tensor | None = None  # (N,) Gaussians by depth,
                              # invalid last (bin_gaussians only)


def obb_pass(tile_x, tile_y, center, eigen_vec, eigen_len):
    """Vectorised OBB / tile separating-axis test (auxiliary.h OBB_check).
    Per pair: tile_x / tile_y int tiles, center (P, 2) pixel centre,
    eigen_vec (P, 2, 2) unit axes, eigen_len (P, 2)."""
    half = TILE / 2.0
    tpx = tile_x.float() * TILE + half
    tpy = tile_y.float() * TILE + half
    v1 = eigen_vec[..., 0, :]
    v2 = eigen_vec[..., 1, :]
    d1 = eigen_len[..., 0:1] * v1
    d2 = eigen_len[..., 1:2] * v2
    cx = center[..., 0] - tpx
    cy = center[..., 1] - tpy
    # Axis tests 1-2: the OBB's AABB against the tile.
    ext_x = torch.abs(d1[..., 0]) + torch.abs(d2[..., 0])
    ext_y = torch.abs(d1[..., 1]) + torch.abs(d2[..., 1])
    pass_x = torch.abs(cx) <= half + ext_x
    pass_y = torch.abs(cy) <= half + ext_y
    # Axis tests 3-4: tile corners projected onto the principal axes.
    base1 = -(cx * v1[..., 0] + cy * v1[..., 1])
    base2 = -(cx * v2[..., 0] + cy * v2[..., 1])
    e1 = half * (torch.abs(v1[..., 0]) + torch.abs(v1[..., 1]))
    e2 = half * (torch.abs(v2[..., 0]) + torch.abs(v2[..., 1]))
    pass_1 = torch.abs(base1) <= eigen_len[..., 0] + e1
    pass_2 = torch.abs(base2) <= eigen_len[..., 1] + e2
    return pass_x & pass_y & pass_1 & pass_2


def bin_gaussians(prep, grid_x: int, grid_y: int, pair_capacity: int,
                  tile_mask_fn=None, use_obb: bool = True) -> Binned:
    """The XLA route's binning (binning.py:82-219) of a
    projection.Preprocessed, in plain PyTorch:

      1. a stable depth sort of the Gaussians, invalid ones last;
      2. pair p in [0, pair_capacity) belongs to the Gaussian whose
         inclusive tile-count cumsum first exceeds p, and to the tile of
         its rank in that Gaussian's rect (row-major);
      3. the OBB test on Gaussians whose pre-clip rect spans more than
         one tile (eigen_len[:, 0] > 0; ROADMAP section 3), and
         tile_mask_fn(gaussian (P,) i64, tile (P,) i64) -> bool, an extra
         per-pair cull (tile = ty * grid_x + tx);
      4. a stable sort of the kept pairs by tile, which keeps each tile's
         pairs in depth order.

    Returns Binned with pair_gauss (CAP,) i32, pair_tile (CAP,) i32
    (num_tiles past num_pairs), seg_start, num_pairs, overflow (candidates
    past the capacity), candidates and depth_order. JAX's carry_geometry,
    gauss_attrs, attr_table and pair_fn feed its unfused Pallas routes;
    the port's kernels do their work, so they are not here."""
    n = prep.depth.shape[0]
    dev = prep.depth.device
    num_tiles = grid_x * grid_y
    cap = pair_capacity

    inf = torch.full_like(prep.depth, float("inf"))
    depth_order = torch.argsort(torch.where(prep.valid, prep.depth, inf),
                                stable=True)
    tnum = prep.tiles_touched.long()[depth_order]
    cum_incl = torch.cumsum(tnum, 0)
    total = cum_incl[-1]
    overflow = torch.clamp(total - cap, min=0)

    p = torch.arange(cap, device=dev)
    g = torch.clamp(torch.searchsorted(cum_incl, p, right=True), max=n - 1)
    orig = depth_order[g]
    local = p - (cum_incl - tnum)[g]
    rmin = prep.rect_min.long()[orig]
    rw = torch.clamp(prep.rect_max[:, 0] - prep.rect_min[:, 0],
                     min=1).long()[orig]
    tx = rmin[:, 0] + local % rw
    ty = rmin[:, 1] + local // rw
    tile = ty * grid_x + tx

    keep = p < total
    if use_obb:
        multi = prep.eigen_len[orig, 0] > 0.0
        ob = obb_pass(tx, ty, prep.mean2d[orig], prep.eigen_vec[orig],
                      prep.eigen_len[orig])
        keep = keep & (ob | ~multi)
    if tile_mask_fn is not None:
        keep = keep & tile_mask_fn(orig, tile)

    key = torch.where(keep, tile, torch.full_like(tile, num_tiles))
    sorted_key, perm = torch.sort(key, stable=True)
    seg_start = torch.searchsorted(
        sorted_key, torch.arange(num_tiles + 1, device=dev),
        side="left").to(torch.int32)
    return Binned(seg_start=seg_start, num_pairs=seg_start[-1].clone(),
                  overflow=overflow.to(torch.int32),
                  candidates=total.to(torch.int32),
                  pair_gauss=orig[perm].to(torch.int32),
                  pair_tile=sorted_key.to(torch.int32),
                  depth_order=depth_order)


def bin_fused_ps1(cols, valid, depth, grid_x: int, grid_y: int,
                  pair_capacity: int, compact_capacity: int | None = None,
                  use_obb: bool = True, train: bool = True,
                  sort_exact: bool = False, prebuilt=None):
    """Pair expansion (kernel 4) and the tile sort. cols: the 19 (N,) f32
    columns [rx0, ry0, rw, tnum, mx, my, v1x, v1y, v2x, v2y, len1, len2,
    ca, cb, cc, op, r, g, b]; or prebuilt = (table, cum, total) from
    kernel 1's ps1 mode (or compact_prebuilt), when cols, valid and depth
    are ignored.

    train: returns (pairs (10, CAP) f32 sorted rows [mx, my, ca, cb, cc,
    op, r, g, b, gid], Binned), sorted on the exact two keys. Else the
    inference route: (pairs (5, CAP) sorted bit containers [mx, my,
    P_caca, P_cbcc, OPRGB], Binned with pair_gauss None), sorted on the
    fused key, or on both keys with `sort_exact`. CAP = compact_capacity
    (None: pair_capacity). overflow counts candidates past pair_capacity
    and kept pairs past CAP, never silently; the candidate count has no
    dummy pairs, so it is smaller than the JAX route's by the number of
    invalid rows."""
    num_tiles = grid_x * grid_y
    cap_out = pair_capacity if compact_capacity is None else compact_capacity
    if prebuilt is None:
        with span("table"):
            table, cum, total = ps1_table(cols, valid, depth)
    else:
        table, cum, total = prebuilt
    with span("expand"):
        ex = expand_ps1(table, cum, grid_x, pair_capacity, cap_out, use_obb,
                        quantize=not train)
        candidates, kept = total[0], ex.kept[0]
        overflow = (torch.clamp(candidates - pair_capacity, min=0)
                    + torch.clamp(kept - cap_out, min=0))
        key, dbits = fused_key32(ex.tile, ex.depth,
                                 torch.clamp(kept, max=cap_out), num_tiles)
    pairs, seg_start = sort_pairs(key, dbits, ex.attrs, num_tiles,
                                  exact=train or sort_exact)
    return pairs, Binned(seg_start=seg_start, num_pairs=seg_start[-1].clone(),
                         overflow=overflow, candidates=candidates.clone(),
                         pair_gauss=(pairs[9].to(torch.int32) if train
                                     else None))


def compact_prebuilt(table):
    """Kernel 9 on a ps1 table (binning.py:346 compact_prebuilt): the
    columns with tiles (ROW_TNUM > 0.5; valid implies tnum >= 1) packed to
    the front, the cumsum rebuilt from the table's tnum row. Returns
    (table, cum, total, live), the first three the prebuilt contract of
    bin_fused_ps1."""
    table, cum, live, total = compact_table(table, ep1.ROW_TNUM, 0.5,
                                            ep1.ROW_TNUM)
    return table, cum, total, live
