"""The plain reference of the frames and of the train route's forward, in
float32 PyTorch with no kernel, no cache and no graph.

Frozen from the port's plain code: fovsplat_torch/ops/projection.py
(preprocess_cols), ops/sh.py (_eval_sh_nlast), ops/foveation.py (tile
levels, gradients, blend flags), ops/foveated.py (level_bboxes,
clipped_geometry, fused_key32, chain_masks, merge_tiles),
ops/kernels/expand_fov.py and expand_ps1.py (expand_*_plain,
pack_q_rows) and ops/blend.py (tiles_to_image, the per-pixel rules). What
the configuration states is kept exactly: the storage precisions (bf16
SH, DC and opacity in the packed frames; the PS1 frame's quantized pair
rows), the pair order (Gaussian, then tile row-major), the sort keys (the
fused 32-bit (tile, depth) key, stably; the train route adds the exact
depth bits), the per-pixel blend rules (power window, ALPHA_MIN,
ALPHA_MAX, a chain that freezes before the pair that would take T below
T_EPS) and the EWA low-pass, which the configuration gives per axis
(`lowpass`: the system adds it to xx only, the published renderer to xx
and yy). The blends are written afresh as sequential products over padded
tile groups (torch.cumprod), and every count of work the benchmark's
rooflines use is taken here.

`dtype` runs the floating-point work in another precision: the control
(bfloat16 for the configuration's float32).
"""

from __future__ import annotations

import math

import torch

TILE = 16
PIX = TILE * TILE
NEAR_CULL_Z = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
POWER_MAX_Q = 3e-3
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def grid(width: int, height: int):
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


# --- projection -------------------------------------------------------

def _trunc_clip(x, hi: int):
    x = torch.nan_to_num(x.float(), nan=-1.0)
    return torch.clamp(torch.clamp(x, -1.0, hi + 1.0).to(torch.int32), 0, hi)


def project(xyz, scales, rots, cam, lowpass, dtype=torch.float32):
    """Per-Gaussian screen-space columns (preprocess_cols): a dict with
    depth, valid, mx, my, ca, cb, cc (differentiable), v1x, v1y, v2x,
    v2y, len1, len2, rx0, ry0, rx1, ry1, tnum. rots are unit
    quaternions (w, x, y, z); lowpass the (xx, yy) terms added to the 2D
    covariance, as the configuration states them."""
    W, H = cam.width, cam.height
    gx, gy = grid(W, H)
    c = lambda t: t.to(dtype)                                # noqa: E731
    mx, my, mz = (c(xyz[:, i]) for i in range(3))
    WV, FP = c(cam.world_view), c(cam.full_proj)
    depth = WV[2, 0] * mx + WV[2, 1] * my + WV[2, 2] * mz + WV[2, 3]
    hx = FP[0, 0] * mx + FP[0, 1] * my + FP[0, 2] * mz + FP[0, 3]
    hy = FP[1, 0] * mx + FP[1, 1] * my + FP[1, 2] * mz + FP[1, 3]
    hw = FP[3, 0] * mx + FP[3, 1] * my + FP[3, 2] * mz + FP[3, 3]
    in_front = depth > NEAR_CULL_Z
    p_w = 1.0 / torch.where(in_front, hw + 1e-7, torch.ones_like(hw))

    r, x, y, z = (c(rots[:, i]) for i in range(4))
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
         [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
         [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]
    s = [c(scales[:, i]) ** 2 for i in range(3)]

    def sig(i, j):
        return R[i][0] * R[j][0] * s[0] + R[i][1] * R[j][1] * s[1] \
            + R[i][2] * R[j][2] * s[2]
    sxx, sxy, sxz, syy, syz, szz = (sig(0, 0), sig(0, 1), sig(0, 2),
                                    sig(1, 1), sig(1, 2), sig(2, 2))
    tX = WV[0, 0] * mx + WV[0, 1] * my + WV[0, 2] * mz + WV[0, 3]
    tY = WV[1, 0] * mx + WV[1, 1] * my + WV[1, 2] * mz + WV[1, 3]
    tz = torch.where(depth > NEAR_CULL_Z, depth, torch.ones_like(depth))
    tanx, tany = c(cam.tan_fovx), c(cam.tan_fovy)
    fx, fy = c(cam.focal_x), c(cam.focal_y)
    tx = torch.clamp(tX / tz, -1.3 * tanx, 1.3 * tanx) * tz
    ty = torch.clamp(tY / tz, -1.3 * tany, 1.3 * tany) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    a0 = j00 * WV[0, 0] + j02 * WV[2, 0]
    a1 = j00 * WV[0, 1] + j02 * WV[2, 1]
    a2 = j00 * WV[0, 2] + j02 * WV[2, 2]
    b0 = j11 * WV[1, 0] + j12 * WV[2, 0]
    b1 = j11 * WV[1, 1] + j12 * WV[2, 1]
    b2 = j11 * WV[1, 2] + j12 * WV[2, 2]
    sa0 = sxx * a0 + sxy * a1 + sxz * a2
    sa1 = sxy * a0 + syy * a1 + syz * a2
    sa2 = sxz * a0 + syz * a1 + szz * a2
    sb0 = sxx * b0 + sxy * b1 + sxz * b2
    sb1 = sxy * b0 + syy * b1 + syz * b2
    sb2 = sxz * b0 + syz * b1 + szz * b2
    cxx = a0 * sa0 + a1 * sa1 + a2 * sa2 + lowpass[0]
    cxy = b0 * sa0 + b1 * sa1 + b2 * sa2
    cyy = b0 * sb0 + b1 * sb1 + b2 * sb2
    if lowpass[1]:
        cyy = cyy + lowpass[1]

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    det_inv = 1.0 / safe_det
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - safe_det, min=0.1))
    lam1, lam2 = mid + disc, mid - disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam1, lam2)))
    px = ((hx * p_w + 1.0) * W - 1.0) * 0.5
    py = ((hy * p_w + 1.0) * H - 1.0) * 0.5
    rx0 = _trunc_clip((px - radius) / TILE, gx)
    ry0 = _trunc_clip((py - radius) / TILE, gy)
    rx1 = _trunc_clip((px + radius + TILE - 1) / TILE, gx)
    ry1 = _trunc_clip((py + radius + TILE - 1) / TILE, gy)
    tnum = (rx1 - rx0) * (ry1 - ry0)
    valid = in_front & det_ok & (tnum > 0)
    tnum = torch.where(valid, tnum, torch.zeros_like(tnum))
    multi = tnum > 1
    e1, e2 = cxx - lam1, cxx - lam2
    n1 = torch.rsqrt(torch.clamp(cxy * cxy + e1 * e1, min=1e-20))
    n2 = torch.rsqrt(torch.clamp(cxy * cxy + e2 * e2, min=1e-20))
    zero = torch.zeros_like(lam1)
    return {"depth": depth, "valid": valid, "mx": px, "my": py,
            "ca": cyy * det_inv, "cb": -cxy * det_inv, "cc": cxx * det_inv,
            "v1x": -cxy * n1, "v1y": e1 * n1, "v2x": -cxy * n2,
            "v2y": e2 * n2,
            "len1": torch.where(multi, 3.0 * torch.sqrt(
                torch.clamp(lam1, min=0.0)), zero),
            "len2": torch.where(multi, 3.0 * torch.sqrt(
                torch.clamp(lam2, min=0.0)), zero),
            "rx0": rx0, "ry0": ry0, "rx1": rx1, "ry1": ry1, "tnum": tnum}


def sh_radiance(sh_t, xyz, center, dtype=torch.float32):
    """Degree-3 radiance (C, N) of coefficients sh_t (C, 16, N), +0.5 not
    added, at the unit directions from `center` to `xyz`."""
    c = lambda t: t.to(dtype)                                # noqa: E731
    dx = c(xyz[:, 0]) - c(center[0])
    dy = c(xyz[:, 1]) - c(center[1])
    dz = c(xyz[:, 2]) - c(center[2])
    inv = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-20))
    x, y, z = dx * inv, dy * inv, dz * inv

    def s(k):
        return c(sh_t[:, k])
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return (SH_C0 * s(0) - SH_C1 * y * s(1) + SH_C1 * z * s(2)
            - SH_C1 * x * s(3)
            + SH_C2[0] * xy * s(4) + SH_C2[1] * yz * s(5)
            + SH_C2[2] * (2.0 * zz - xx - yy) * s(6) + SH_C2[3] * xz * s(7)
            + SH_C2[4] * (xx - yy) * s(8)
            + SH_C3[0] * y * (3.0 * xx - yy) * s(9) + SH_C3[1] * xy * z * s(10)
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * s(11)
            + SH_C3[3] * z * (2.0 * zz - 3 * xx - 3 * yy) * s(12)
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * s(13)
            + SH_C3[5] * z * (xx - yy) * s(14)
            + SH_C3[6] * x * (xx - 3.0 * yy) * s(15))


# --- foveation --------------------------------------------------------

def tile_levels(gaze, width: int, height: int, alpha: float, fov: dict):
    """Fractional level per tile (T,) at `gaze` (2,) f32 (MetaSapiens'
    eccentricity-driven pooling size), and the blending decision:
    (levels, grad_x, grad_y, tile_blend)."""
    gx, gy = grid(width, height)
    dev = gaze.device
    t = torch.arange(gx * gy, device=dev)
    px = (t % gx).float() * TILE + TILE / 2
    py = (t // gx).float() * TILE + TILE / 2
    real_w = fov["real_image_width"]
    real_h = height / width * real_w
    dist = fov["real_viewing_distance"]

    def ncd2dir(nx, ny):
        x = (nx - 0.5) * real_w
        y = (ny - 0.5) * real_h
        zz = torch.full_like(x + y, dist)
        n = torch.sqrt(x * x + y * y + zz * zz)
        return x / n, y / n, zz / n
    ncx, ncy = px / width, py / height
    dx, dy, dz = ncd2dir(ncx, ncy)
    gdx, gdy, gdz = ncd2dir(gaze[0], gaze[1])
    half = torch.full((), 0.5, device=dev)
    cdx, cdy, cdz = ncd2dir(half, half)
    ecc = torch.arccos(torch.clamp(dx * gdx + dy * gdy + dz * gdz, -1.0, 1.0))
    ecc_c = torch.arccos(torch.clamp(dx * cdx + dy * cdy + dz * cdz,
                                     -1.0, 1.0))
    pool = alpha * ecc * ecc
    amin, amax = ecc_c - pool * 0.5, ecc_c + pool * 0.5
    d2pix = torch.sqrt(((ncx - 0.5) * real_w) ** 2
                       + ((ncy - 0.5) * real_h) ** 2 + dist * dist)
    major = (torch.tan(amax) - torch.tan(amin)) * dist
    minor = 2.0 * d2pix * torch.tan(pool * 0.5)
    area = math.pi * major * minor * 0.25
    ps = torch.sqrt(torch.clamp(area, min=0.0)) * (width / real_w)
    L = fov["fov_num"]
    step = (fov["sqrt_max_ps"] - 1.0) / (L - 1)
    lvl = torch.where(ps <= 1.0, torch.zeros_like(ps),
                      (torch.sqrt(torch.clamp(ps, min=1.0)) - 1.0) / step)
    levels = torch.clamp(lvl, max=L - 0.1)

    lv = levels.reshape(gy, gx)

    def grad(l, axis):
        up, dn = torch.roll(l, -1, axis), torch.roll(l, 1, axis)
        n = l.shape[axis]
        idx = torch.arange(n, device=dev)
        shape = [1, 1]
        shape[axis] = n
        lo = (idx > 0).reshape(shape)
        hi = (idx < n - 1).reshape(shape)
        return torch.where(lo & hi, 0.5 * (up - dn),
                           torch.where(hi, up - l,
                                       torch.where(lo, l - dn,
                                                   torch.zeros_like(l))))
    gxv, gyv = grad(lv, 1), grad(lv, 0)
    tmin = lv - 0.5 * (torch.abs(gxv) + torch.abs(gyv))
    tmin_i = torch.trunc(tmin)
    blend = (((tmin - tmin_i) > fov["start_blend"]) & (tmin_i < L - 1))
    return levels, gxv.reshape(-1), gyv.reshape(-1), blend.reshape(-1)


def level_bboxes(levels, gx: int, gy: int, L: int):
    """(4, L) i32 boxes x0, y0, x1, y1 of the tiles with level < h + 1."""
    dev = levels.device
    ok = levels.reshape(gy, gx)[None] < (
        torch.arange(L, device=dev, dtype=torch.float32) + 1.0)[:, None, None]
    txs = torch.arange(gx, device=dev).expand(L, gy, gx)
    tys = torch.arange(gy, device=dev)[:, None].expand(L, gy, gx)
    big = torch.full_like(txs, 1 << 20)
    zero = torch.zeros_like(txs)
    return torch.stack([torch.where(ok, txs, big).amin((1, 2)),
                        torch.where(ok, tys, big).amin((1, 2)),
                        torch.where(ok, txs + 1, zero).amax((1, 2)),
                        torch.where(ok, tys + 1, zero).amax((1, 2))]).to(
        torch.int32)


def chain_masks(levels, grad_x, grad_y, tile_blend):
    """(est, l1_active, l2_active), each (T, PIX)."""
    pix = torch.arange(PIX, device=levels.device)
    lx, ly = (pix % TILE).float(), torch.floor(pix.float() / TILE)
    est = levels[:, None] + (lx[None] * grad_x[:, None]
                             + ly[None] * grad_y[:, None]) / TILE
    l1 = torch.where(tile_blend[:, None],
                     est <= (levels.to(torch.int32) + 1)[:, None].float(),
                     torch.ones_like(est, dtype=torch.bool))
    l2 = tile_blend[:, None].expand(est.shape)
    return est, l1, l2


def tiles_to_image(tile_img, gx: int, gy: int, width: int, height: int):
    c = tile_img.shape[-1]
    img = tile_img.reshape(gy, gx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * TILE, gx * TILE, c)[:height, :width]


# --- pairs ------------------------------------------------------------

def candidates(tnum, rx0, ry0, rw, pair_capacity: int, gx: int):
    """Every candidate (Gaussian, tile) of the rects, Gaussian-major and
    row-major within a rect, cut at `pair_capacity`: (g, tx, ty, total)."""
    dev = tnum.device
    tnum = tnum.long()
    cum = torch.cumsum(tnum, 0) - tnum
    m = torch.clamp(torch.minimum(tnum, pair_capacity - cum), min=0)
    g = torch.repeat_interleave(torch.arange(tnum.shape[0], device=dev), m)
    j = torch.arange(g.numel(), device=dev) - (torch.cumsum(m, 0) - m)[g]
    w = rw.long()[g]
    return g, rx0.long()[g] + j % w, ry0.long()[g] + j // w, int(tnum.sum())


def obb_keep(c, g, tx, ty):
    """The OBB separating-axis test of each candidate (skipped for
    single-tile rects, len1 0)."""
    half = TILE / 2.0
    mx, my = c["mx"][g].float(), c["my"][g].float()
    v1x, v1y, v2x, v2y = (c[k][g].float() for k in ("v1x", "v1y", "v2x",
                                                    "v2y"))
    len1, len2 = c["len1"][g].float(), c["len2"][g].float()
    cx = mx - (tx.float() * TILE + half)
    cy = my - (ty.float() * TILE + half)
    ext_x = torch.abs(len1 * v1x) + torch.abs(len2 * v2x)
    ext_y = torch.abs(len1 * v1y) + torch.abs(len2 * v2y)
    b1 = -(cx * v1x + cy * v1y)
    b2 = -(cx * v2x + cy * v2y)
    e1 = half * (torch.abs(v1x) + torch.abs(v1y))
    e2 = half * (torch.abs(v2x) + torch.abs(v2y))
    obb = ((torch.abs(cx) <= half + ext_x) & (torch.abs(cy) <= half + ext_y)
           & (torch.abs(b1) <= len1 + e1) & (torch.abs(b2) <= len2 + e2))
    return obb | ~(len1 > 0.0)


def sort_pairs(tile, depth, num_tiles: int, exact: bool):
    """The stable tile sort: the fused 32-bit key (tile, high depth bits),
    then the exact depth bits when `exact`. Returns (perm, seg_start
    (T+1,))."""
    db = 31 - max(int(num_tiles + 1).bit_length(), 1)
    dbits = depth.float().contiguous().view(torch.int32)
    key = (tile.to(torch.int32) << db) | (dbits >> (32 - db))
    if exact:
        _, perm = torch.sort((key.long() << 32) | dbits.long(), stable=True)
    else:
        _, perm = torch.sort(key, stable=True)
    sorted_tile = tile[perm]
    seg = torch.searchsorted(sorted_tile.contiguous(), torch.arange(
        num_tiles + 1, device=tile.device, dtype=sorted_tile.dtype))
    return perm, seg


def tile_groups(seg_start, chunk: int):
    """Runs of consecutive tiles whose segments, padded to the run's
    longest, hold at most `chunk` pairs (or one tile): (t0, t1, idx (G,
    S), in_seg (G, S))."""
    dev = seg_start.device
    starts = seg_start[:-1].tolist()
    counts = (seg_start[1:] - seg_start[:-1]).tolist()
    T = len(counts)
    t0 = 0
    while t0 < T:
        t1, smax = t0 + 1, counts[t0]
        while t1 < T and (t1 + 1 - t0) * max(smax, counts[t1]) <= chunk:
            smax = max(smax, counts[t1])
            t1 += 1
        if smax > 0:
            s = torch.arange(smax, device=dev)
            in_seg = s[None] < torch.tensor(counts[t0:t1], device=dev)[:, None]
            idx = torch.tensor(starts[t0:t1], device=dev)[:, None] + s
            yield t0, t1, torch.where(in_seg, idx, torch.zeros_like(idx)), \
                in_seg
        t0 = t1


def pixel_offsets(mx, my, t0: int, t1: int, gx: int, local: bool):
    """dx, dy (G, S, PIX) of the pairs' centres from each pixel; `local`
    takes them in tile-local coordinates, as the quantized blend does."""
    dev = mx.device
    pix = torch.arange(PIX, device=dev)
    lx, ly = (pix % TILE).to(mx.dtype), torch.floor(pix.float() / TILE).to(
        mx.dtype)
    tiles = torch.arange(t0, t1, device=dev)
    tx0 = ((tiles % gx).to(mx.dtype) * TILE)[:, None, None]
    ty0 = ((tiles // gx).to(mx.dtype) * TILE)[:, None, None]
    if local:
        return (mx[..., None] - tx0) - lx, (my[..., None] - ty0) - ly
    return mx[..., None] - (tx0 + lx), my[..., None] - (ty0 + ly)


def chain(op, G, ok):
    """One transmittance chain over a group: per (G, S, PIX) pair-pixel
    alpha = min(op G, ALPHA_MAX) where `ok` and alpha >= ALPHA_MIN. The
    pixel freezes before the pair that would take T below T_EPS. Returns
    (weight, contrib, trigger, om): weight = alpha T_before on the
    pairs that contribute. The clamp at ALPHA_MAX passes the gradient
    straight through, as the reference rasterizer's backward does."""
    raw = op * G
    alpha = raw - torch.clamp(raw - ALPHA_MAX, min=0.0).detach()
    a = torch.where(ok & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    om = 1.0 - a
    T_incl = torch.cumprod(om, 1)
    T_row = torch.cat([torch.ones_like(om[:, :1]), T_incl[:, :-1]], 1)
    trigger = (a > 0) & (T_row * om < T_EPS)
    trig = trigger.int()
    done = (torch.cumsum(trig, 1) - trig) > 0
    contrib = (a > 0) & ~trigger & ~done
    w = torch.where(contrib, a * T_row, torch.zeros_like(a))
    return w, contrib, trigger, om


def walked_until(trigger, in_seg):
    """Per pixel, the pairs walked up to and including the one that froze
    it, else every pair of the segment: (G, PIX)."""
    fired = trigger.any(1)
    return torch.where(fired, trigger.int().argmax(1) + 1,
                       in_seg.sum(1)[:, None].int())
