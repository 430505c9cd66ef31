"""Blend constants, the tile-major to image reshape and the plain
single-chain blend (fovsplat/ops/blend.py).

blend_forward_plain and blend_backward_plain are the plain PyTorch twins
of kernels 5 and 6 (csrc/blend_fwd.cu): the tile-sorted pair list is cut
into groups of consecutive tiles whose segments, padded to the group's
longest, are evaluated as (tiles, pairs, pixels) tensors."""

from __future__ import annotations

import torch

from fovsplat_torch.ops.projection import TILE

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
PIX = TILE * TILE  # pixels per tile


def tiles_to_image(tile_img: torch.Tensor, grid_x: int, grid_y: int,
                   width: int, height: int) -> torch.Tensor:
    """[num_tiles, PIX, C] tile-major -> (H, W, C) image, cropped to
    width x height."""
    c = tile_img.shape[-1]
    img = tile_img.reshape(grid_y, grid_x, TILE, TILE, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, c)
    return img[:height, :width]


# Pair rows of the single-chain blend (ops/kernels/expand_ps1.ATTR_ROWS).
_MX, _MY, _CA, _CB, _CC, _OP, _R, _G, _B = range(9)


def _tile_groups(seg_start, chunk: int):
    """Consecutive tiles grouped so that each group's segments, padded to
    the group's longest, hold at most `chunk` pairs (or one tile). Yields
    (t0, t1, idx (G, S) lane index, in_seg (G, S) bool)."""
    dev = seg_start.device
    T = seg_start.shape[0] - 1
    starts = seg_start[:-1].tolist()
    counts = (seg_start[1:] - seg_start[:-1]).tolist()
    t0 = 0
    while t0 < T:
        t1, smax = t0 + 1, counts[t0]
        while t1 < T and (t1 + 1 - t0) * max(smax, counts[t1]) <= chunk:
            smax = max(smax, counts[t1])
            t1 += 1
        if smax > 0:
            s = torch.arange(smax, device=dev)
            cnt = torch.tensor(counts[t0:t1], device=dev)
            in_seg = s[None, :] < cnt[:, None]
            idx = torch.tensor(starts[t0:t1], device=dev)[:, None] + s
            yield t0, t1, torch.where(in_seg, idx, torch.zeros_like(idx)), \
                in_seg
        t0 = t1


def _pair_pixel(pairs, idx, in_seg, t0: int, t1: int, grid_x: int,
                power_cutoff: float):
    """Rows, offsets, power, G, alpha and the static test for a tile group:
    (a (9, G, S), dx, dy, G, alpha, ok), the last five (G, S, PIX)."""
    dev = pairs.device
    pix = torch.arange(PIX, device=dev)
    tiles = torch.arange(t0, t1, device=dev)
    px = ((tiles % grid_x).float() * TILE)[:, None, None] + (pix % TILE).float()
    py = ((tiles // grid_x).float() * TILE)[:, None, None] \
        + torch.floor(pix.float() / TILE)
    a = pairs[:9, idx]
    dx = a[_MX][..., None] - px
    dy = a[_MY][..., None] - py
    power = (-0.5 * (a[_CA][..., None] * dx * dx + a[_CC][..., None] * dy * dy)
             - a[_CB][..., None] * dx * dy)
    G = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(a[_OP][..., None] * G, max=ALPHA_MAX)
    ok = ((power <= 0.0) & (power >= power_cutoff) & (alpha >= ALPHA_MIN)
          & in_seg[..., None])
    return a, dx, dy, G, alpha, ok


def blend_forward_plain(pairs, seg_start, grid_x: int,
                        power_cutoff: float = -4.5, chunk: int = 1 << 16,
                        return_walked: bool = False):
    """Plain single-chain blend forward (fovsplat/ops/blend.py:84-141 and
    the per-pixel rule of fovsplat/ops/pallas/blend_fwd.py:234-242).

    pairs (>= 9, CAP) f32 sorted pair rows [mx, my, ca, cb, cc, op, r, g,
    b]; seg_start (T+1,) i32. Transmittances are sequential products
    (torch.cumprod), the kernel's own T = T * (1 - a) chain. Returns
    (colour (T, PIX, 3), final T (T, PIX), n_contrib (T, PIX) i32) and,
    with return_walked, the (T, PIX) count of pairs each pixel walks
    before it freezes (the data-dependent work of the kernel)."""
    dev = pairs.device
    T = seg_start.shape[0] - 1
    color = torch.zeros((T, PIX, 3), dtype=torch.float32, device=dev)
    final_T = torch.ones((T, PIX), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((T, PIX), dtype=torch.int32, device=dev)
    walked = torch.zeros((T, PIX), dtype=torch.int32, device=dev)
    for t0, t1, idx, in_seg in _tile_groups(seg_start, chunk):
        a, _, _, _, alpha, ok = _pair_pixel(pairs, idx, in_seg, t0, t1,
                                            grid_x, power_cutoff)
        a_eff = torch.where(ok, alpha, torch.zeros_like(alpha))
        om = 1.0 - a_eff
        T_incl = torch.cumprod(om, 1)
        T_row = torch.cat([torch.ones_like(om[:, :1]), T_incl[:, :-1]], 1)
        trigger = (a_eff > 0) & (T_row * om < T_EPS)
        trig = trigger.int()
        done_before = (torch.cumsum(trig, 1) - trig) > 0
        contrib = (a_eff > 0) & ~trigger & ~done_before
        w = torch.where(contrib, a_eff * T_row, torch.zeros_like(a_eff))
        color[t0:t1] = torch.einsum("gsp,cgs->gpc", w, a[_R:_B + 1])
        final_T[t0:t1] = torch.cumprod(
            torch.where(contrib, om, torch.ones_like(om)), 1)[:, -1]
        rank = torch.arange(1, idx.shape[1] + 1, device=dev)[None, :, None]
        n_contrib[t0:t1] = torch.where(contrib, rank, 0).amax(1).int()
        if return_walked:
            cnt = in_seg.sum(1)[:, None]
            walked[t0:t1] = torch.where(trigger.any(1),
                                        trigger.int().argmax(1) + 1,
                                        cnt).int()
    if return_walked:
        return color, final_T, n_contrib, walked
    return color, final_T, n_contrib


def blend_backward_plain(pairs, seg_start, grid_x: int, g_color, g_T,
                         final_T, n_contrib, power_cutoff: float = -4.5,
                         chunk: int = 1 << 16):
    """Plain single-chain blend backward (fovsplat/ops/blend.py:144-238,
    with the T recovery of fovsplat/ops/pallas/blend_fwd.py:705-716).

    A pair contributed to a pixel iff it passes the alpha tests and its
    rank is below the pixel's n_contrib. T before pair j is the saved
    final T times the suffix product of 1 / (1 - a) from j on, clamped at
    1. Returns the (9, CAP) per-pair gradient rows [mx, my, ca, cb, cc,
    op, r, g, b]; lanes that contributed nowhere are zero."""
    grads = torch.zeros((9, pairs.shape[1]), dtype=torch.float32,
                        device=pairs.device)
    for t0, t1, idx, in_seg in _tile_groups(seg_start, chunk):
        a, dx, dy, G, alpha, ok = _pair_pixel(pairs, idx, in_seg, t0, t1,
                                              grid_x, power_cutoff)
        rank = torch.arange(idx.shape[1], device=pairs.device)
        contrib = ok & (rank[None, :, None] < n_contrib[t0:t1, None, :])
        a_eff = torch.where(contrib, alpha, torch.zeros_like(alpha))
        inv_om = 1.0 / (1.0 - a_eff)
        sfx = torch.flip(torch.cumprod(torch.flip(inv_om, [1]), 1), [1])
        Tf = final_T[t0:t1, None, :]
        T_j = torch.clamp(Tf * sfx, max=1.0)
        w = a_eff * T_j
        g = g_color[t0:t1, None]                             # (G, 1, PIX, 3)
        gc = (g[..., 0] * a[_R][..., None] + g[..., 1] * a[_G][..., None]
              + g[..., 2] * a[_B][..., None])
        wgc = w * gc
        S = torch.flip(torch.cumsum(torch.flip(wgc, [1]), 1), [1]) - wgc
        dL_da = torch.where(
            contrib, gc * T_j - (S + g_T[t0:t1, None, :] * Tf) * inv_om,
            torch.zeros_like(w))
        d_power = a_eff * dL_da
        ca, cb, cc = (a[r][..., None] for r in (_CA, _CB, _CC))
        rows = torch.stack([
            (d_power * (-(ca * dx + cb * dy))).sum(-1),
            (d_power * (-(cc * dy + cb * dx))).sum(-1),
            (d_power * (-0.5 * dx * dx)).sum(-1),
            (d_power * (-dx * dy)).sum(-1),
            (d_power * (-0.5 * dy * dy)).sum(-1),
            (torch.where(contrib, G, torch.zeros_like(G)) * dL_da).sum(-1),
            (w * g[..., 0]).sum(-1), (w * g[..., 1]).sum(-1),
            (w * g[..., 2]).sum(-1)])                         # (9, G, S)
        grads[:, idx[in_seg]] = rows[:, in_seg]
    return grads
