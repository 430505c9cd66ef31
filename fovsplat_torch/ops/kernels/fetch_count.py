"""Kernel 14: the score view's per-Gaussian fetched-pair count
(csrc/fetch_count.cu).

gs_count of the counting modes "sum" and "loss_weighted_max_count"
(..._pcheck_obb_sum/cuda_rasterizer/forward.cu:357-361): +1 for every
(tile, Gaussian) pair that the reference's fetch loop reads, which is
each tile's pairs below its 256-round early-exit point. One block a tile
finds that point from kernel 8's first_trig and walks only the lanes
before it, adding into the count with integer atomics (one answer in any
order). The plain version, fetch_count_plain, finds the tile of every
capacity lane with a searchsorted and counts the fetched lanes with an
integer index_add_, the lanes not fetched sent to a sentinel slot.

Bound on the card: bytes, by need (first_trig, seg_start, the fetched
lanes' gids read; the count written).
"""

from __future__ import annotations

import ctypes

import torch

from fovsplat_torch.ops.blend import BIG, PIX, tile_inside_mask
from fovsplat_torch.ops.kernels import _build

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


def gid_counts(gid, vals, n: int):
    """Per-Gaussian integer sums of vals (L,) (gid n: skip). (n,) i32."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=gid.device)
    return out.index_add_(0, gid.long(), vals.long())[:n].to(torch.int32)


def fetch_count_plain(first_trig, seg_start, gid, n: int, grid_x: int,
                      width: int, height: int):
    """The kernel's function in plain PyTorch: each lane's tile by a
    searchsorted over the segment bounds, the lanes below their tile's
    fetch point counted by Gaussian, every other lane sent to slot n."""
    cap = gid.shape[0]
    dev = gid.device
    num_tiles = seg_start.shape[0] - 1
    lane = torch.arange(cap, device=dev)
    nf = tile_fetch_counts(first_trig.to(torch.float32), seg_start,
                           tile_inside_mask(grid_x, num_tiles // grid_x,
                                            width, height, dev))
    t_all = torch.clamp(torch.searchsorted(
        seg_start[1:num_tiles].contiguous(), lane.to(torch.int32),
        right=True), max=num_tiles - 1)
    fetched = (gid < n) & ((lane - seg_start[t_all]) < nf[t_all])
    return gid_counts(torch.where(fetched, gid, n), fetched, n)


def fetch_count(first_trig, seg_start, gid, n: int, grid_x: int, width: int,
                height: int):
    """Kernel 14 on CUDA tensors, its plain version on CPU tensors.

    first_trig (T, PIX) i32 (kernel 8's); seg_start (T+1,) i32 with
    seg_start[0] = 0; gid (CAP,) i32 the Gaussian of each sorted pair (n
    or more: no Gaussian); width x height the image, padding pixels of the
    edge tiles masked. Returns gs_count (n,) i32."""
    if gid.device.type == "cpu":
        return fetch_count_plain(first_trig, seg_start, gid, n, grid_x,
                                 width, height)
    dev = gid.device
    if dev.type != "cuda":
        raise ValueError(f"fetch_count: gid on {dev}; the kernel needs CUDA")
    T = seg_start.shape[0] - 1
    _build.check_tensors("fetch_count", dev, (
        ("first_trig", first_trig, torch.int32, (T, PIX)),
        ("seg_start", seg_start, torch.int32, (T + 1,)),
        ("gid", gid, torch.int32, (gid.shape[0],))))
    if not (T >= 1 and grid_x >= 1 and T % grid_x == 0 and n >= 0):
        raise ValueError(f"fetch_count: {T} tiles, grid_x={grid_x}, n={n}")
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    lib = _build.load("fetch_count")
    fn = lib.fs_fetch_count
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, P, I, I, I, I, P, P]
    fn.restype = I
    err = fn(first_trig.data_ptr(), seg_start.data_ptr(), T, gid.data_ptr(),
             n, grid_x, width, height, out.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, err, "fetch_count")
    fetch_count.launches += 1
    return out


fetch_count.launches = 0
