"""Blend constants, the tile-major to image reshape, the plain
single-chain blend and the XLA route's differentiable blend
(fovsplat/ops/blend.py).

blend_forward_plain and blend_backward_plain are the plain PyTorch twins
of kernels 5 and 6 (csrc/blend_fwd.cu), blend_forward_q_plain that of the
forward-only blend of the quantized inference rows (kernel 5q, the same
source), blend_stats_plain that of kernel 8 (csrc/blend_stats.cu): the
tile-sorted pair list is cut into groups of consecutive tiles whose
segments, padded to the group's longest, are evaluated as (tiles, pairs,
pixels) tensors. blend is the JAX route's custom-VJP blend
(blend.py:241-272) as an autograd.Function over the plain forward and
backward: plain PyTorch on any device, no kernel."""

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


def _tile_groups(seg_start, chunk: int, seg_end=None):
    """Consecutive tiles grouped so that each group's segments, padded to
    the group's longest, hold at most `chunk` pairs (or one tile). Tile t's
    segment is [seg_start[t], seg_start[t + 1]) or, given seg_end (T,),
    [seg_start[t], seg_end[t]). Yields (t0, t1, idx (G, S) lane index,
    in_seg (G, S) bool)."""
    dev = seg_start.device
    if seg_end is None:
        seg_start, seg_end = seg_start[:-1], seg_start[1:]
    T = seg_start.shape[0]
    starts = seg_start.tolist()
    counts = torch.clamp(seg_end - seg_start, min=0).tolist()
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
                power_cutoff: float, power_max: float = 0.0,
                local: bool = False):
    """Rows, offsets, G, alpha and the static tests for a tile group:
    (a (9, G, S), dx, dy, G, alpha, ok, geo), the last six (G, S, PIX);
    geo is the power window [power_cutoff, power_max] alone, ok adds
    alpha >= ALPHA_MIN. `local` takes the offsets in tile-local
    coordinates: (mx - tile x0) - pixel x, as kernel 5q does."""
    dev = pairs.device
    pix = torch.arange(PIX, device=dev)
    tiles = torch.arange(t0, t1, device=dev)
    a = pairs[:9, idx]
    tx0 = ((tiles % grid_x).float() * TILE)[:, None, None]
    ty0 = ((tiles // grid_x).float() * TILE)[:, None, None]
    lx, ly = (pix % TILE).float(), torch.floor(pix.float() / TILE)
    mx, my = a[_MX][..., None], a[_MY][..., None]
    if local:
        dx, dy = (mx - tx0) - lx, (my - ty0) - ly
    else:
        dx, dy = mx - (tx0 + lx), my - (ty0 + ly)
    power = (-0.5 * (a[_CA][..., None] * dx * dx + a[_CC][..., None] * dy * dy)
             - a[_CB][..., None] * dx * dy)
    G = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(a[_OP][..., None] * G, max=ALPHA_MAX)
    geo = (power <= power_max) & (power >= power_cutoff) & in_seg[..., None]
    return a, dx, dy, G, alpha, geo & (alpha >= ALPHA_MIN), geo


def blend_forward_plain(pairs, seg_start, grid_x: int,
                        power_cutoff: float = -4.5, chunk: int = 1 << 16,
                        return_work: bool = False):
    """Plain single-chain blend forward (fovsplat/ops/blend.py:84-141 and
    the per-pixel rule of fovsplat/ops/pallas/blend_fwd.py:234-242).

    pairs (>= 9, CAP) f32 sorted pair rows [mx, my, ca, cb, cc, op, r, g,
    b]; seg_start (T+1,) i32. Transmittances are sequential products
    (torch.cumprod), the kernel's own T = T * (1 - a) chain. Returns
    (colour (T, PIX, 3), final T (T, PIX), n_contrib (T, PIX) i32) and,
    with return_work, the data-dependent work of the kernel: a (4, T,
    PIX) i32 count, per pixel, of the pairs it walks before it freezes
    (the freezing pair included), of those whose power lies in the
    window, of those that contribute, and whether a pair froze it."""
    return _blend_forward(pairs, seg_start, None, grid_x, power_cutoff,
                          chunk, return_work)


C_OP = 1.0 / 255.0     # u8 opacity step (blend_fwd.py:70)
C_COL = 2.0 / 255.0    # u8 colour step on [0, 2]
POWER_MAX_Q = 3e-3     # kernel 5q's upper power bound (blend_fwd.py:377)


def decode_q_rows(pairs):
    """The quantized inference rows [mx, my, P_caca, P_cbcc, OPRGB]
    (ops/kernels/expand_ps1.Q_ROWS) decoded as blend_fwd.py:353-377 does:
    (9, CAP) f32 [mx, my, ca, cb, cc, op, r, g, b] with ca = hi + lo of
    P_caca, cb and cc the halves of P_cbcc, opacity u8 / 255 and colours
    u8 * 2 / 255."""
    bits = pairs[2:5].contiguous().view(torch.int32)

    def hi(b):
        return (b & -65536).view(torch.float32)

    def lo(b):
        return (b << 16).view(torch.float32)

    def u8(sh):
        return ((bits[2] >> sh) & 255).float()
    return torch.stack([pairs[0], pairs[1], hi(bits[0]) + lo(bits[0]),
                        hi(bits[1]), lo(bits[1]), u8(24) * C_OP,
                        u8(16) * C_COL, u8(8) * C_COL, u8(0) * C_COL])


def blend_forward_q_plain(pairs, seg_start, seg_end, grid_x: int,
                          power_cutoff: float = -4.5, chunk: int = 1 << 16,
                          return_work: bool = False):
    """Plain forward-only blend of the quantized inference rows, the
    function of kernel 5q (fovsplat/ops/pallas/blend_fwd.py:947
    blend_pallas_fwd_only, _forward with mxu_power=True).

    pairs (>= 5, CAP) f32 bit containers (decode_q_rows); seg_start and
    seg_end (T,) i32, tile t's pairs [seg_start[t], seg_end[t]) (MM-FR
    empties segments). The power is evaluated in tile-local coordinates
    and the window is power_cutoff <= power <= 3e-3, as the JAX kernel's
    (blend_fwd.py:377): the decoded bf16 conic need not be positive
    definite. Returns (colour (T, PIX, 3), final T (T, PIX), n_contrib
    (T, PIX) i32) and, with return_work, the work counts of
    blend_forward_plain."""
    return _blend_forward(decode_q_rows(pairs), seg_start, seg_end, grid_x,
                          power_cutoff, chunk, return_work,
                          power_max=POWER_MAX_Q, local=True)


def _blend_forward(pairs, seg_start, seg_end, grid_x: int,
                   power_cutoff: float, chunk: int, return_work: bool,
                   power_max: float = 0.0, local: bool = False):
    dev = pairs.device
    T = seg_start.shape[0] - (1 if seg_end is None else 0)
    color = torch.zeros((T, PIX, 3), dtype=torch.float32, device=dev)
    final_T = torch.ones((T, PIX), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((T, PIX), dtype=torch.int32, device=dev)
    work = torch.zeros((4, T, PIX), dtype=torch.int32, device=dev)
    for t0, t1, idx, in_seg in _tile_groups(seg_start, chunk, seg_end):
        a, _, _, _, alpha, ok, geo = _pair_pixel(pairs, idx, in_seg, t0, t1,
                                                 grid_x, power_cutoff,
                                                 power_max, local)
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
        if return_work:
            fired = trigger.any(1)
            work[0, t0:t1] = torch.where(fired, trig.argmax(1) + 1,
                                         in_seg.sum(1)[:, None]).int()
            work[1, t0:t1] = (geo & ~done_before).sum(1).int()
            work[2, t0:t1] = contrib.sum(1).int()
            work[3, t0:t1] = fired.int()
    if return_work:
        return color, final_T, n_contrib, work
    return color, final_T, n_contrib


def blend_backward_plain(pairs, seg_start, grid_x: int, g_color, g_T,
                         final_T, n_contrib, power_cutoff: float = -4.5,
                         chunk: int = 1 << 16, return_work: bool = False):
    """Plain single-chain blend backward (fovsplat/ops/blend.py:144-238,
    with the T recovery of fovsplat/ops/pallas/blend_fwd.py:705-716).

    A pair contributed to a pixel iff it passes the alpha tests and its
    rank is below the pixel's n_contrib. T before pair j is the saved
    final T times the suffix product of 1 / (1 - a) from j on, clamped at
    1. Returns the (9, CAP) per-pair gradient rows [mx, my, ca, cb, cc,
    op, r, g, b]; lanes that contributed nowhere are zero. With
    return_work, also the data-dependent work of the kernel: a (3, T,
    PIX) i32 count, per pixel, of the pairs up to its last contributor,
    of those whose power lies in the window, and of those that
    contribute."""
    dev = pairs.device
    grads = torch.zeros((9, pairs.shape[1]), dtype=torch.float32,
                        device=dev)
    work = torch.zeros((3,) + tuple(n_contrib.shape), dtype=torch.int32,
                       device=dev)
    for t0, t1, idx, in_seg in _tile_groups(seg_start, chunk):
        a, dx, dy, G, alpha, ok, geo = _pair_pixel(pairs, idx, in_seg, t0,
                                                   t1, grid_x, power_cutoff)
        rank = torch.arange(idx.shape[1], device=dev)
        walked = (rank[None, :, None] < n_contrib[t0:t1, None, :]) \
            & in_seg[..., None]
        contrib = ok & walked
        if return_work:
            work[0, t0:t1] = walked.sum(1).int()
            work[1, t0:t1] = (geo & walked).sum(1).int()
            work[2, t0:t1] = contrib.sum(1).int()
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
    if return_work:
        return grads, work
    return grads


class _Blend(torch.autograd.Function):
    """blend_forward_plain forward; blend_backward_plain backward, which
    walks each tile back to front from the saved final T and n_contrib
    (blend.py:144-238): deterministic per-pair gradients."""

    @staticmethod
    def forward(ctx, pair_mean2d, pair_conic, pair_opacity, pair_color,
                seg_start, grid_x, chunk, power_cutoff):
        pairs = torch.cat([pair_mean2d.T, pair_conic.T, pair_opacity[None],
                           pair_color.T]).contiguous()
        color, final_T, n_contrib = blend_forward_plain(
            pairs, seg_start, grid_x, power_cutoff, chunk)
        ctx.save_for_backward(pairs, seg_start, final_T, n_contrib)
        ctx.args = (grid_x, power_cutoff, chunk)
        ctx.mark_non_differentiable(n_contrib)
        return color, final_T, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_T, _):
        pairs, seg_start, final_T, n_contrib = ctx.saved_tensors
        grid_x, power_cutoff, chunk = ctx.args
        rows = blend_backward_plain(pairs, seg_start, grid_x,
                                    g_color.contiguous(), g_T.contiguous(),
                                    final_T, n_contrib, power_cutoff, chunk)
        return (rows[0:2].T, rows[2:5].T, rows[5], rows[6:9].T,
                None, None, None, None)


def blend(pair_tile, pair_mean2d, pair_conic, pair_opacity, pair_color,
          seg_start, num_pairs, grid_x: int, grid_y: int, chunk: int,
          power_cutoff: float):
    """Differentiable tile blend of the XLA route (blend.py:241-272):
    per-pair mean2d (CAP, 2), conic (CAP, 3), opacity (CAP,) and colour
    (CAP, 3) of a tile-sorted pair list with segments seg_start (T+1,).
    Returns (tile colour (T, PIX, 3), final T (T, PIX), n_contrib (T, PIX)
    i32), differentiable in the four per-pair inputs. Tile t blends pairs
    [seg_start[t], seg_start[t + 1]), so pair_tile and num_pairs (JAX's
    loop bounds) only describe that list; chunk bounds the plain walk's
    padded pairs a step, as RasterizeConfig.chunk does."""
    del pair_tile, num_pairs, grid_y
    return _Blend.apply(pair_mean2d, pair_conic, pair_opacity, pair_color,
                        seg_start, grid_x, chunk, power_cutoff)


BIG = 1 << 30          # first_trig of a pixel that never freezes
STAT_ROWS = 4          # w_sum, touched, w_max, geo_win


def tile_inside_mask(grid_x: int, grid_y: int, width: int, height: int,
                     device=None) -> torch.Tensor:
    """(T, PIX) bool: the pixel lies inside the image. Edge tiles carry
    padding pixels, which the reference starts as done (forward.cu:326)."""
    t = torch.arange(grid_x * grid_y, device=device)
    pix = torch.arange(PIX, device=device)
    px = (t % grid_x)[:, None] * TILE + (pix % TILE)[None, :]
    py = (t // grid_x)[:, None] * TILE + (pix // TILE)[None, :]
    return (px < width) & (py < height)


def blend_stats_plain(pairs, seg_start, grid_x: int, width: int,
                      height: int, power_cutoff: float = -4.5,
                      chunk: int = 1 << 16, return_walked: bool = False,
                      tie_gid=None):
    """Plain blend forward with per-pair and per-pixel statistics
    (fovsplat/ops/pallas/blend_stats.py:88-141), the function of kernel 8.

    pairs (>= 9, CAP) f32 sorted rows; seg_start (T+1,) i32. The blend is
    blend_forward_plain's, with padding pixels (outside width x height)
    frozen from the start. Returns (colour (T, PIX, 3), final T (T, PIX),
    stats (4, CAP) f32, best_lane (T, PIX) i32, best_w (T, PIX) f32,
    first_trig (T, PIX) i32):
      stats rows, per pair over its tile's pixels: w_sum (sum of the
        blend weights alpha * T of the pixels it contributes to), touched
        (their number), w_max (their largest weight), geo_win (pixels not
        frozen before the pair whose power lies in the window, the pair
        that freezes a pixel included); zero on every other lane;
      best_lane: the lane of the pixel's largest weight, the lowest lane
        on ties, CAP if it has none; best_w: that weight, else 0;
      first_trig: the rank in the tile's segment of the pair that froze
        the pixel, BIG if none did.
    With return_walked, also the (T, PIX) count of pairs each pixel walks
    before it freezes. With tie_gid (CAP,) integer, best_lane is the lane
    of the lowest tie_gid among the largest weights: the XLA oracle's
    lowest-Gaussian-id rule (stats.py:160-170)."""
    dev = pairs.device
    T = seg_start.shape[0] - 1
    cap = pairs.shape[1]
    color = torch.zeros((T, PIX, 3), dtype=torch.float32, device=dev)
    final_T = torch.ones((T, PIX), dtype=torch.float32, device=dev)
    stats = torch.zeros((STAT_ROWS, cap), dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    best_lane = torch.full((T, PIX), cap, **i32)
    best_w = torch.zeros((T, PIX), dtype=torch.float32, device=dev)
    first_trig = torch.full((T, PIX), BIG, **i32)
    walked = torch.zeros((T, PIX), **i32)
    inside = tile_inside_mask(grid_x, T // grid_x, width, height, dev)
    for t0, t1, idx, in_seg in _tile_groups(seg_start, chunk):
        a, _, _, _, alpha, ok, geo = _pair_pixel(pairs, idx, in_seg, t0, t1,
                                                 grid_x, power_cutoff)
        ins = inside[t0:t1, None, :]
        a_eff = torch.where(ok & ins, alpha, torch.zeros_like(alpha))
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
        rows = torch.stack([w.sum(-1), contrib.sum(-1).float(), w.amax(-1),
                            (geo & ins & ~done_before).sum(-1).float()])
        stats[:, idx[in_seg]] = rows[:, in_seg]
        wmax = w.amax(1)                                        # (G, PIX)
        best = (w == wmax[:, None]) & (w > 0)
        if tie_gid is None:
            first = best.int().argmax(1)
        else:
            first = torch.where(best, tie_gid[idx].long()[..., None],
                                torch.iinfo(torch.int64).max).argmin(1)
        has = wmax > 0
        best_lane[t0:t1] = torch.where(
            has, torch.gather(idx, 1, first).to(torch.int32), cap)
        best_w[t0:t1] = wmax
        fired = trigger.any(1)
        first_trig[t0:t1] = torch.where(fired, trig.argmax(1), BIG).int()
        if return_walked:
            walked[t0:t1] = torch.where(
                fired, trig.argmax(1) + 1,
                torch.where(inside[t0:t1], in_seg.sum(1)[:, None], 0)).int()
    out = (color, final_T, stats, best_lane, best_w, first_trig)
    return out + (walked,) if return_walked else out
