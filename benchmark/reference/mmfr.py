"""The plain reference of the MM-FR frame: MetaSapiens' multi-model
foveated baseline (LightGaussian/get_multimodel.py:22-80, fov3dgs/
render_compose_gazes_fps_mmfr.py with the _mmfr_pcheck_obb rasterizer).

Four single-level models, one for each foveation level, each at SH degree
3. A frame runs one pass a level: the whole PS1 frame of that level's
model (raster.py's projection, candidates, OBB test and fused-key sort,
frames.q_rows' quantized rows), with every rect clipped to the bbox of
the tiles whose integer level is the pass's level and the rows of
opacity below 1/255 culled (renderCUDA_mmfr's dead-opacity test), then a
blend of those tiles alone (tile_skips). The four images are summed; a
tile belongs to one pass, and is zero in the others.

The level models (level_models) come from the benchmark's proxy: level
li holds the pnum[li] rows of the highest `highest_levels`, ties broken
by the seeded row order, in that order, with their level-li opacity and
DC, the shared SH rest and the shared geometry. The published level
models are fine-tuned after pruning, so their geometry differs between
levels; the proxy's does not (the configuration's `departures`).
"""

from __future__ import annotations

import torch

from benchmark.reference import frames as F
from benchmark.reference import raster as R

# Kernel 1p's bytes a row of the packed model (rasterize.Ps1ModelSoA):
# xyz, scales and rotation in f32 (40 B) and the opacity in bf16 (2 B)
# read, the 20-row f32 table and the i32 cumsum (84 B) written, for every
# row; the 16 x 3 SH in bf16 (96 B) read only for a row that the box clip
# and the opacity cull leave valid (an invalid row's colour is 0; kernel
# 1p reads it all the same, so this bound is by need). With
# every row valid, 1,161,358 rows: 257.8 MB, 0.0770 ms at 3.35 TB/s.
TABLE_BYTES_ROW = 3 * 4 + 3 * 4 + 4 * 4 + 2 + 20 * 4 + 4
TABLE_BYTES_SH = 48 * 2
# The work counts a pass adds to the frame's.
SUMMED = ("visible", "candidates", "kept", "walked", "in_window",
          "contributing", "frozen", "tiles")


def level_models(sc: dict, pnum) -> list:
    """The level models of the proxy `sc` (reference/proxy.py): a list of
    dicts means, scales, rotations, opacity (N_l,), dc (N_l, 3) and
    shs_rest (N_l, 15, 3), N_l = pnum[l]."""
    order = torch.sort(sc["highest_levels"], descending=True,
                       stable=True)[1]
    out = []
    for li, n in enumerate(pnum):
        idx = torch.sort(order[:n])[0]
        out.append({"means": sc["means"][idx], "scales": sc["scales"][idx],
                    "rotations": sc["rotations"][idx],
                    "opacity": sc["opacities4"][idx, li],
                    "dc": sc["shs_dcs"][idx, li], "shs_rest":
                    sc["shs_rest"][idx]})
    return out


def ownership(levels, gx: int, gy: int, L: int):
    """(own (L, T) bool, box (L, 4) i64): the tiles of each integer level
    and their bbox x0, y0, x1, y1 (an empty box where there are none)."""
    dev = levels.device
    own = levels.to(torch.int32)[None] == torch.arange(
        L, device=dev, dtype=torch.int32)[:, None]
    t = torch.arange(gx * gy, device=dev)
    tx, ty = (t % gx)[None].expand(L, -1), (t // gx)[None].expand(L, -1)
    big, zero = torch.full_like(tx, 1 << 20), torch.zeros_like(tx)
    box = torch.stack([torch.where(own, tx, big).amin(1),
                       torch.where(own, ty, big).amin(1),
                       torch.where(own, tx + 1, zero).amax(1),
                       torch.where(own, ty + 1, zero).amax(1)], 1)
    return own, box


def level_pass(m: dict, cam, own, box, pair_capacity: int,
               compact_capacity: int, cfg: dict, dtype):
    """One level pass. Returns (tile colours (T, PIX, 3), zero off the
    owned tiles, counts {"num_pairs", "overflow", "candidates"}, work
    {"visible", "candidates", "kept" (the pairs of owned tiles, which the
    blend reads), "walked", "in_window", "contributing", "frozen",
    "tiles", "rows", "table_bytes"}). "visible" counts the rows the box
    clip and the opacity cull leave valid, the rows whose projection and
    colour the pass uses, so that work.frame_flop charges SH colour on
    them alone."""
    W, H = cam.width, cam.height
    gx, gy = R.grid(W, H)
    T = gx * gy
    xyz = m["means"]
    c = R.project(xyz, m["scales"], m["rotations"], cam, cfg["lowpass"],
                  dtype)
    sh_t = torch.cat([F._bf16(m["dc"][:, None, :]), F._bf16(m["shs_rest"])],
                     1).permute(2, 1, 0)                          # (3, 16, N)
    colors = torch.clamp(R.sh_radiance(sh_t, xyz, cam.cam_center, dtype)
                         + 0.5, min=0.0)                           # (3, N)
    op = F._bf16(m["opacity"])
    rx0 = torch.maximum(c["rx0"], box[0].to(c["rx0"].dtype))
    ry0 = torch.maximum(c["ry0"], box[1].to(c["ry0"].dtype))
    rx1 = torch.minimum(c["rx1"], box[2].to(c["rx1"].dtype))
    ry1 = torch.minimum(c["ry1"], box[3].to(c["ry1"].dtype))
    tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = c["valid"] & (tnum > 0) & (op >= 1.0 / 255.0)
    tnum = torch.where(valid, tnum, torch.zeros_like(tnum))
    g, tx, ty, total = R.candidates(tnum, rx0, ry0,
                                    torch.clamp(rx1 - rx0, min=1),
                                    pair_capacity, gx)
    keep = R.obb_keep(c, g, tx, ty)
    g, tile = g[keep], (ty * gx + tx)[keep]
    kept = g.numel()
    k = min(kept, compact_capacity)
    g, tile = g[:k], tile[:k]
    perm, _ = R.sort_pairs(tile, c["depth"][g], T, exact=False)
    rows = F.q_rows(c["mx"][g], c["my"][g], c["ca"][g], c["cb"][g],
                    c["cc"][g], op[g], *colors[:, g])
    # The blend reads the owned tiles' segments only.
    sorted_tile = tile[perm]
    on = own[sorted_tile]
    rows = torch.stack(rows)[:, perm[on]].to(dtype)
    seg = torch.searchsorted(sorted_tile[on].contiguous(), torch.arange(
        T + 1, device=xyz.device, dtype=sorted_tile.dtype))

    color = torch.zeros((T, R.PIX, 3), dtype=dtype, device=xyz.device)
    work = torch.zeros(4, dtype=torch.int64, device=xyz.device)
    for t0, t1, idx, in_seg in R.tile_groups(seg, cfg["reference_chunk"]):
        a = rows[:, idx]
        dx, dy = R.pixel_offsets(a[0], a[1], t0, t1, gx, local=True)
        power = (-0.5 * (a[2][..., None] * dx * dx + a[4][..., None] * dy * dy)
                 - a[3][..., None] * dx * dy)
        G = torch.exp(torch.clamp(power, max=0.0))
        geo = ((power <= R.POWER_MAX_Q) & (power >= cfg["power_cutoff"])
               & in_seg[..., None])
        w, contrib, trigger, _ = R.chain(a[5][..., None], G, geo)
        color[t0:t1] = torch.einsum("gsp,cgs->gpc", w, a[6:9])
        trig = trigger.int()
        done = (torch.cumsum(trig, 1) - trig) > 0
        work += torch.stack([R.walked_until(trigger, in_seg).sum(),
                             (geo & ~done).sum(), contrib.sum(),
                             trigger.any(1).sum()])
    wk = [int(x) for x in work.tolist()]
    overflow = (max(total - pair_capacity, 0)
                + max(kept - compact_capacity, 0))
    n = xyz.shape[0]
    counts = {"num_pairs": k, "overflow": overflow,
              "candidates": min(total, pair_capacity)}
    return color, counts, {
        "visible": int(valid.sum()), "candidates": counts["candidates"],
        "kept": int(on.sum()), "walked": wk[0], "in_window": wk[1],
        "contributing": wk[2], "frozen": wk[3], "tiles": T, "rows": n,
        "table_bytes": n * TABLE_BYTES_ROW
        + int(valid.sum()) * TABLE_BYTES_SH}


def mmfr_frame(sc: dict, cam, gaze, cfg: dict, pnum,
               dtype=torch.float32):
    """The MM-FR frame of the proxy `sc` at `gaze` (2,) f32. cfg: the
    configuration's "frame" block (per-level "pair_capacity" and
    "compact_capacity" lists). Returns (image (H, W, 3) f32, {"num_pairs",
    "overflow"} summed over the passes, work: the PS1 keys summed over
    the passes (frame_flop reads them as a PS1 frame's), "pixels", and
    "passes", each pass's counts and work)."""
    W, H = cam.width, cam.height
    gx, gy = R.grid(W, H)
    L = len(pnum)
    levels = R.tile_levels(gaze, W, H, cfg["alpha"], cfg["foveation"])[0]
    own, box = ownership(levels, gx, gy, L)
    color, passes = None, []
    for li, m in enumerate(level_models(sc, pnum)):
        col, counts, work = level_pass(
            m, cam, own[li], box[li], cfg["pair_capacity"][li],
            cfg["compact_capacity"][li], cfg, dtype)
        color = col if color is None else color + col
        passes.append({**counts, **work})
    image = R.tiles_to_image(color.float(), gx, gy, W, H)
    total = {k: sum(p[k] for p in passes) for k in SUMMED}
    return image, {"num_pairs": sum(p["num_pairs"] for p in passes),
                   "overflow": sum(p["overflow"] for p in passes)}, {
        **total, "pixels": W * H, "passes": passes}
