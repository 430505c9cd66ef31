"""The plain reference of the two frames the benchmark times: the
foveated "ours" frame of a composed 4-level model and the PS1 frame of a
single-level model, each with the counts of work the rooflines read.

The semantics are those of MetaSapiens' renderers as the configuration
states them (see raster.py for what is frozen from where): "ours" culls a
pair when the tile's level is not below the Gaussian's highest level + 1
and blends two chains per pixel, the tile's level and the next, merged by
a smoothstep across the blend band; PS1 blends one chain of the quantized
inference rows.
"""

from __future__ import annotations

import torch

from benchmark.reference import raster as R


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _level_clip(c, hl, bbox, L: int):
    hli = torch.clamp(hl.to(torch.int32), 0, L - 1).long()
    rx0 = torch.maximum(c["rx0"], bbox[0][hli])
    ry0 = torch.maximum(c["ry0"], bbox[1][hli])
    rx1 = torch.minimum(c["rx1"], bbox[2][hli])
    ry1 = torch.minimum(c["ry1"], bbox[3][hli])
    tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
    valid = c["valid"] & (tnum > 0) & (hl >= 0.0)
    tnum = torch.where(valid, tnum, torch.zeros_like(tnum))
    return rx0, ry0, torch.clamp(torch.maximum(rx1, rx0) - rx0, min=1), tnum


def ours_frame(sc: dict, cam, gaze, cfg: dict, dtype=torch.float32):
    """The "ours" frame of the proxy `sc` (reference/proxy.py) at `gaze`
    (2,) f32. cfg: the configuration's "frame" block. Returns (image (H,
    W, 3) f32, {"num_pairs", "overflow"}, work {"visible", "candidates",
    "kept", "walked", "pixels"})."""
    W, H = cam.width, cam.height
    gx, gy = R.grid(W, H)
    T = gx * gy
    fov = cfg["foveation"]
    L = fov["fov_num"]
    levels, grad_x, grad_y, tblend = R.tile_levels(gaze, W, H, cfg["alpha"],
                                                   fov)
    bbox = R.level_bboxes(levels, gx, gy, L)
    xyz = sc["means"]
    c = R.project(xyz, sc["scales"], sc["rotations"], cam,
                  cfg["lowpass"], dtype)
    hl = sc["highest_levels"]
    rx0, ry0, rw, tnum = _level_clip(c, hl, bbox, L)

    # Colours from the stored precisions: bf16 SH rest, per-level DC and
    # opacity.
    n = xyz.shape[0]
    rest_t = torch.cat([torch.zeros((3, 1, n), device=xyz.device),
                        _bf16(sc["shs_rest"]).permute(2, 1, 0)], 1)
    rest_c = R.sh_radiance(rest_t, xyz, cam.cam_center, dtype) + 0.5
    colors = torch.clamp(R.SH_C0 * _bf16(sc["shs_dcs"]).permute(2, 1, 0).to(
        dtype) + rest_c[:, None, :], min=0.0)                     # (3, L, N)
    opac = _bf16(sc["opacities4"]).to(dtype)                       # (N, L)

    g, tx, ty, total = R.candidates(tnum, rx0, ry0, rw, cfg["pair_capacity"],
                                    gx)
    tile = ty * gx + tx
    keep = R.obb_keep(c, g, tx, ty) & (levels[tile] < hl[g] + 1.0)
    g, tile = g[keep], tile[keep]
    kept = g.numel()
    k = min(kept, cfg["compact_capacity"])
    g, tile = g[:k], tile[:k]
    lv = levels[tile]
    p1 = torch.clamp(lv.long(), max=L - 1)
    p2 = torch.clamp(lv.long() + 1, max=L - 1)
    op2 = torch.where((hl[g] + 1.0) < (lv + 1.0),
                      torch.full_like(lv, -1.0).to(dtype), opac[g, p2])
    perm, seg = R.sort_pairs(tile, c["depth"][g], T, exact=False)
    rows = torch.stack([c["mx"][g], c["my"][g], c["ca"][g], c["cb"][g],
                        c["cc"][g], opac[g, p1], op2, *colors[:, p1, g],
                        *colors[:, p2, g]])[:, perm].to(dtype)

    est, l1_act, l2_act = R.chain_masks(levels, grad_x, grad_y, tblend)
    out = torch.zeros((T, 8, R.PIX), dtype=dtype, device=xyz.device)
    out[:, 3] = 1.0
    out[:, 7] = 1.0
    walked = torch.zeros((T, R.PIX), dtype=torch.int64, device=xyz.device)
    for t0, t1, idx, in_seg in R.tile_groups(seg, cfg["reference_chunk"]):
        a = rows[:, idx]
        dx, dy = R.pixel_offsets(a[0], a[1], t0, t1, gx, local=False)
        power = (-0.5 * (a[2][..., None] * dx * dx + a[4][..., None] * dy * dy)
                 - a[3][..., None] * dx * dy)
        G = torch.exp(torch.clamp(power, max=0.0))
        geo = ((power <= 0.0) & (power >= cfg["power_cutoff"])
               & in_seg[..., None])
        for ch, (op_row, col0, act) in enumerate(((5, 7, l1_act),
                                                   (6, 10, l2_act))):
            on = act[t0:t1, None, :]
            w, contrib, trigger, om = R.chain(a[op_row][..., None], G,
                                              geo & on)
            out[t0:t1, 4 * ch:4 * ch + 3] = torch.einsum(
                "gsp,cgs->gcp", w, a[col0:col0 + 3])
            out[t0:t1, 4 * ch + 3] = torch.cumprod(torch.where(
                contrib, om, torch.ones_like(om)), 1)[:, -1]
            stop = torch.where(act[t0:t1], R.walked_until(trigger, in_seg),
                               0)
            walked[t0:t1] = torch.maximum(walked[t0:t1], stop.long())
    c1, t1_, c2, t2_ = (out[:, 0:3].transpose(1, 2), out[:, 3],
                        out[:, 4:7].transpose(1, 2), out[:, 7])
    del t1_, t2_
    x = torch.abs(est - (levels.to(torch.int32)[:, None].float()
                         + fov["start_blend"]))
    x = torch.clamp(x / fov["blend_width"], 0.0, 1.0)
    w1 = (1.0 - (3 * x * x - 2 * x * x * x)).to(dtype)[..., None]
    merged = torch.where(tblend[:, None, None], c1 * w1 + c2 * (1.0 - w1), c1)
    image = R.tiles_to_image(merged.float(), gx, gy, W, H)
    overflow = (max(total - cfg["pair_capacity"], 0)
                + max(kept - cfg["compact_capacity"], 0))
    work = {"visible": int(c["valid"].sum()), "candidates":
            min(total, cfg["pair_capacity"]), "kept": k,
            "walked": int(walked.sum()), "pixels": W * H, "tiles": T}
    return image, {"num_pairs": k, "overflow": overflow}, work


def _pack_half_up(b):
    """b rounded to bf16 by +0x8000 and truncation (the quantized rows'
    low-half encoding), as f32."""
    bits = b.float().contiguous().view(torch.int32)
    return (((bits + 0x8000) >> 16) << 16).view(torch.float32)


def q_rows(mx, my, ca, cb, cc, op, r, g, b):
    """The PS1 inference rows as the blend reads them: mx, my exact; ca as
    its high bf16 part plus the rest rounded to bf16; cb, cc in bf16;
    opacity on a 1/255 step and colours on a 2/255 step, after bf16."""
    ca = ca.float()
    ca_hi = (ca.contiguous().view(torch.int32) & -65536).view(torch.float32)

    def q8(v, s):
        return torch.clamp(torch.floor(_bf16(v) * s + 0.5), 0.0, 255.0)
    return [mx.float(), my.float(), ca_hi + _pack_half_up(ca - ca_hi),
            _bf16(cb), _bf16(cc), q8(op, 255.0) * (1.0 / 255.0),
            q8(r, 127.5) * (2.0 / 255.0), q8(g, 127.5) * (2.0 / 255.0),
            q8(b, 127.5) * (2.0 / 255.0)]


def ps1_frame(sc: dict, cam, cfg: dict, dtype=torch.float32):
    """The PS1 frame of the proxy `sc` (level-0 DC, shared opacity).
    Returns (image, {"num_pairs", "overflow"}, work {"visible",
    "candidates", "kept", "walked", "in_window", "contributing",
    "frozen", "pixels"})."""
    W, H = cam.width, cam.height
    gx, gy = R.grid(W, H)
    T = gx * gy
    xyz = sc["means"]
    c = R.project(xyz, sc["scales"], sc["rotations"], cam,
                  cfg["lowpass"], dtype)
    sh_t = torch.cat([_bf16(sc["shs_dcs"][:, 0:1]), _bf16(sc["shs_rest"])],
                     1).permute(2, 1, 0)                          # (3, 16, N)
    colors = torch.clamp(R.sh_radiance(sh_t, xyz, cam.cam_center, dtype)
                         + 0.5, min=0.0)                           # (3, N)
    op = _bf16(sc["opacity"])
    rw = torch.clamp(c["rx1"] - c["rx0"], min=1)
    g, tx, ty, total = R.candidates(c["tnum"], c["rx0"], c["ry0"], rw,
                                    cfg["pair_capacity"], gx)
    keep = R.obb_keep(c, g, tx, ty)
    g, tile = g[keep], (ty * gx + tx)[keep]
    kept = g.numel()
    k = min(kept, cfg["compact_capacity"])
    g, tile = g[:k], tile[:k]
    perm, seg = R.sort_pairs(tile, c["depth"][g], T, exact=False)
    rows = q_rows(c["mx"][g], c["my"][g], c["ca"][g], c["cb"][g],
                  c["cc"][g], op[g], *colors[:, g])
    rows = torch.stack(rows)[:, perm].to(dtype)

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
    image = R.tiles_to_image(color.float(), gx, gy, W, H)
    w = [int(x) for x in work.tolist()]
    overflow = (max(total - cfg["pair_capacity"], 0)
                + max(kept - cfg["compact_capacity"], 0))
    return image, {"num_pairs": k, "overflow": overflow}, {
        "visible": int(c["valid"].sum()),
        "candidates": min(total, cfg["pair_capacity"]), "kept": k,
        "walked": w[0], "in_window": w[1], "contributing": w[2],
        "frozen": w[3], "pixels": W * H, "tiles": T}
