"""Kernel 2: pair expansion, OBB and level cull, per-level attribute
selection and compaction (csrc/expand_fov.cu).

Replaces fovsplat/ops/pallas/expand_fov.py:841 expand_fov_pallas. The
candidates are the tiles of each Gaussian's clipped rect in row-major
order, numbered by `cum` (the exclusive prefix of the table's tnum row);
a (Gaussian, tile) pair is kept when it passes the OBB separating-axis
test (skipped for single-tile rects) and the level cull level[tile] <
hl + 1.
The level comes from the per-tile table (foveation.compute_tile_levels),
not from the TPU kernel's per-pair trig series. Kept pairs come out in
the JAX kernel's pre-sort order (Gaussian, then tile row-major), as f32
rows; the TPU's u8/bf16 inference packing is not carried over.

The table may hold fewer colour levels than the cull has (L_lay = 1, the
SM-FR shared layout, foveated.py:755-760): chain 1 then reads colour
level min(p1, L_lay - 1) and chain 2 min(p1 + 1, L_lay - 1).

Capacities: candidates whose index in the cumsum is at or past
`pair_capacity`, and kept pairs at or past `cap_out`, are dropped; the
caller counts both into `overflow`. The candidate count has no dummy
pairs (the JAX count includes one per invalid row).

Bound on the card: bytes (see the source header). The kernel takes one
thread per candidate, finding its Gaussian by a search over `cum`; the
compaction is deterministic (count per block, scan, write) and needs no
atomics.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from fovsplat_torch.ops.kernels import _build
from fovsplat_torch.ops.kernels import build_table as bt
from fovsplat_torch.ops.projection import TILE

# Output attribute rows.
ATTR_ROWS = ("mx", "my", "ca", "cb", "cc", "op1", "op2", "r1", "g1", "b1",
             "r2", "g2", "b2")


@dataclasses.dataclass(frozen=True)
class Expanded:
    """Kept pairs in pre-sort order; lanes at or past min(kept, cap_out)
    are unspecified."""
    tile: torch.Tensor    # (cap_out,) i32
    depth: torch.Tensor   # (cap_out,) f32 view-space depth
    gid: torch.Tensor     # (cap_out,) i32 Gaussian index
    attrs: torch.Tensor   # (13, cap_out) f32, rows ATTR_ROWS
    kept: torch.Tensor    # (1,) i32 kept pairs, before the cap_out cut


def expand_fov_plain(table, cum, levels, L: int, grid_x: int,
                     pair_capacity: int, cap_out: int,
                     use_obb: bool = True) -> Expanded:
    """The kernel's function in plain PyTorch (vectorised over pairs)."""
    dev = table.device
    n = table.shape[1]
    L_lay = (table.shape[0] - bt.ROW_LEVEL) // 4
    row = lambda r: table[r]                                # noqa: E731
    tnum = row(bt.ROW_TNUM).long()
    m = torch.clamp(torch.minimum(tnum, pair_capacity - cum.long()), min=0)
    g = torch.repeat_interleave(torch.arange(n, device=dev), m)
    j = torch.arange(g.numel(), device=dev) - (torch.cumsum(m, 0) - m)[g]
    rw = row(bt.ROW_RW).long()[g]
    tx = row(bt.ROW_RX0).long()[g] + j % rw
    ty = row(bt.ROW_RY0).long()[g] + j // rw

    keep = torch.ones_like(g, dtype=torch.bool)
    if use_obb:
        half = TILE / 2.0
        mx, my = row(bt.ROW_MX)[g], row(bt.ROW_MY)[g]
        v1x, v1y = row(bt.ROW_V1X)[g], row(bt.ROW_V1Y)[g]
        v2x, v2y = row(bt.ROW_V2X)[g], row(bt.ROW_V2Y)[g]
        len1, len2 = row(bt.ROW_LEN1)[g], row(bt.ROW_LEN2)[g]
        cx = mx - (tx.float() * TILE + half)
        cy = my - (ty.float() * TILE + half)
        ext_x = torch.abs(len1 * v1x) + torch.abs(len2 * v2x)
        ext_y = torch.abs(len1 * v1y) + torch.abs(len2 * v2y)
        base1 = -(cx * v1x + cy * v1y)
        base2 = -(cx * v2x + cy * v2y)
        e1 = half * (torch.abs(v1x) + torch.abs(v1y))
        e2 = half * (torch.abs(v2x) + torch.abs(v2y))
        obb = ((torch.abs(cx) <= half + ext_x)
               & (torch.abs(cy) <= half + ext_y)
               & (torch.abs(base1) <= len1 + e1)
               & (torch.abs(base2) <= len2 + e2))
        keep = obb | ~(len1 > 0.0)
    tile = ty * grid_x + tx
    lv = levels[tile]
    hl = row(bt.ROW_HL)[g]
    keep = keep & (lv < hl + 1.0)

    g, tile, lv, hl = g[keep], tile[keep], lv[keep], hl[keep]
    kept = g.numel()
    k = min(kept, cap_out)
    g, tile, lv, hl = g[:k], tile[:k], lv[:k], hl[:k]
    p1 = torch.clamp(lv.long(), max=L_lay - 1)
    p2 = torch.clamp(lv.long() + 1, max=L_lay - 1)
    lvl = table[bt.ROW_LEVEL:].reshape(4, L_lay, n)  # op, r, g, b by level
    op2 = torch.where((hl + 1.0) < (lv + 1.0), torch.full_like(hl, -1.0),
                      lvl[0, p2, g])
    vals = torch.stack([row(bt.ROW_MX)[g], row(bt.ROW_MY)[g],
                        row(bt.ROW_CA)[g], row(bt.ROW_CB)[g],
                        row(bt.ROW_CC)[g], lvl[0, p1, g], op2,
                        lvl[1, p1, g], lvl[2, p1, g], lvl[3, p1, g],
                        lvl[1, p2, g], lvl[2, p2, g], lvl[3, p2, g]])

    def pad(x, fill=0):
        out = torch.full((*x.shape[:-1], cap_out), fill, dtype=x.dtype,
                         device=dev)
        out[..., :k] = x
        return out
    return Expanded(tile=pad(tile.to(torch.int32)),
                    depth=pad(row(bt.ROW_DEPTH)[g]),
                    gid=pad(g.to(torch.int32)), attrs=pad(vals),
                    kept=torch.tensor([kept], dtype=torch.int32, device=dev))


def expand_fov(table, cum, levels, L: int, grid_x: int, pair_capacity: int,
               cap_out: int, use_obb: bool = True) -> Expanded:
    """Kernel 2 on CUDA tensors, its plain version on CPU tensors.

    table (num_rows(L_lay), N) f32 and cum (N,) i32 from build_table,
    L_lay in {1, L}; levels (T,) f32 per-tile foveation levels of the L
    cull levels."""
    if table.device.type == "cpu":
        return expand_fov_plain(table, cum, levels, L, grid_x,
                                pair_capacity, cap_out, use_obb)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"expand_fov: table on {dev}; the kernel needs CUDA")
    n = table.shape[1]
    L_lay = 1 if table.shape[0] == bt.num_rows(1) else L
    _build.check_tensors("expand_fov", dev, (
        ("table", table, torch.float32, (bt.num_rows(L_lay), n)),
        ("cum", cum, torch.int32, (n,)),
        ("levels", levels, torch.float32, (levels.shape[0],))))
    if cap_out < 1 or pair_capacity < 1 or levels.shape[0] % grid_x:
        raise ValueError("expand_fov: capacities must be positive and "
                         "levels a whole number of tile rows")
    lib = _build.load("expand_fov")
    chunk = lib.fs_expand_fov_chunk()
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty((pair_capacity + chunk - 1) // chunk, **i32)
    kept = torch.empty(1, **i32)
    tile = torch.empty(cap_out, **i32)
    depth = torch.empty(cap_out, dtype=torch.float32, device=dev)
    gid = torch.empty(cap_out, **i32)
    attrs = torch.empty((len(ATTR_ROWS), cap_out), dtype=torch.float32,
                        device=dev)

    fn = lib.fs_expand_fov
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 3 + [I] * 6 + [P] * 7
    fn.restype = I
    err = fn(table.data_ptr(), cum.data_ptr(), levels.data_ptr(), n, L_lay,
             grid_x, pair_capacity, cap_out, int(use_obb),
             counts.data_ptr(), kept.data_ptr(), tile.data_ptr(),
             depth.data_ptr(), gid.data_ptr(), attrs.data_ptr(),
             _build.stream_ptr(dev))
    _build.check(lib, err, "expand_fov")
    expand_fov.launches += 1
    return Expanded(tile=tile, depth=depth, gid=gid, attrs=attrs, kept=kept)


expand_fov.launches = 0
