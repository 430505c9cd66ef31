"""The plain reference of the metric-prune score pass, in float32 PyTorch
with no kernel, no cache and no graph.

MetaSapiens' metric_pruning (fov3dgs/prune.py:71-110) renders every train
view through the N5 counting rasterizer
(diff-gaussian-rasterization_pcheck_obb_loss_weighted_max_count), scores
each Gaussian as max_comp_efficiency, takes the max over the views and
cuts the lowest share. As that rasterizer's render loop
(cuda_rasterizer/forward.cu) behaves:

  * each tile's pairs are fetched in rounds of 256 (its BLOCK_SIZE), and
    the fetch loop ends at the first round whose start finds every pixel
    of the tile done; a pixel outside the image is done from the start,
    and a pixel is done once a pair would take its T below 1e-4 (that
    pair does not contribute);
  * gs_count: one per pair fetched, to the pair's Gaussian;
  * a pair counts for a pixel when its power lies in [power_cutoff, 0]
    and alpha = min(0.99, opacity exp(power)) >= 1/255; its weight is
    alpha T;
  * contribs: each pixel adds its loss-map value (here ones) to the
    Gaussian of its largest weight, the earliest pair of the tile's
    depth order on ties (the CUDA original's is a race of float atomics);
  * the score: contribs / (gs_count + 1e-7), 0 where gs_count < 1; the
    pass's score is the max over the views;
  * the cut kills floor(n_live * ratio) live rows, the lowest scores
    first, ranked by a stable ascending sort (ties to the row index).

The pairs are raster.py's: its projection, candidates (Gaussian-major,
row-major in each rect, cut at the pair capacity), OBB test, kept-pair cut
and exact tile-and-depth sort. The projection and the candidates run in
blocks of rows and the walk in groups of tiles, so that a state of
millions of rows fits beside the program. `dtype` runs the floating-point
work in another precision (the control). Each view also returns its
counts of work, for the rooflines: visible rows, candidates, kept pairs,
pixels, and the walk's pair-pixels (walked, in the power window,
contributing, up to each pixel's last contributor) and frozen pixels.
"""

from __future__ import annotations

import torch

from benchmark.reference import raster as R
from benchmark.reference import work as W

FETCH_ROUND = 256
ROW_BLOCK = 1 << 20
COLUMNS = ("depth", "valid", "mx", "my", "ca", "cb", "cc", "v1x", "v1y",
           "v2x", "v2y", "len1", "len2", "rx0", "ry0", "rx1", "ry1", "tnum")


def _columns(p: dict, cam, lowpass, dtype):
    """raster.project over the rows of raw parameters `p`, in blocks."""
    n = p["xyz"].shape[0]
    parts = {k: [] for k in COLUMNS}
    for a in range(0, n, ROW_BLOCK):
        b = min(a + ROW_BLOCK, n)
        q = p["rotation"][a:b]
        cols = R.project(p["xyz"][a:b], torch.exp(p["scaling"][a:b]),
                         q / torch.linalg.vector_norm(q, dim=-1,
                                                      keepdim=True),
                         cam, lowpass, dtype)
        for k in COLUMNS:
            parts[k].append(cols[k])
    return {k: torch.cat(v) for k, v in parts.items()}


def _pairs(cols, gx: int, pair_capacity: int, kept_capacity: int):
    """The kept pairs in candidate order, cut at the capacities: (Gaussian
    (K,) i64, tile (K,) i64, candidates, kept before the cut). Candidates
    are taken in blocks of rows; the cut counts across the blocks."""
    tnum = cols["tnum"].long()
    rw = torch.clamp(cols["rx1"] - cols["rx0"], min=1)
    gs, tiles, total, kept = [], [], 0, 0
    for a in range(0, tnum.shape[0], ROW_BLOCK):
        b = min(a + ROW_BLOCK, tnum.shape[0])
        g, tx, ty, t = R.candidates(tnum[a:b], cols["rx0"][a:b],
                                    cols["ry0"][a:b], rw[a:b],
                                    max(pair_capacity - total, 0), gx)
        g = g + a
        keep = R.obb_keep(cols, g, tx, ty)
        gs.append(g[keep])
        tiles.append((ty * gx + tx)[keep])
        total += t
        kept += int(keep.sum())
    g, tile = torch.cat(gs), torch.cat(tiles)
    return g[:kept_capacity], tile[:kept_capacity], total, kept


def score_view(p: dict, opacity, cam, cfg: dict, dtype=torch.float32):
    """One view of the N5 counting rasterizer with a loss map of ones:
    (gs_count (N,) i64, contribs (N,) f32, work {counts}). `p` the raw
    parameters (xyz, scaling, rotation), `opacity` (N,) activated; cfg
    the configuration's frame (lowpass, capacities, power_cutoff,
    reference_chunk)."""
    n = opacity.shape[0]
    dev = opacity.device
    Wd, Ht = cam.width, cam.height
    gx, gy = R.grid(Wd, Ht)
    T = gx * gy
    cols = _columns(p, cam, cfg["lowpass"], dtype)
    g, tile, total, kept = _pairs(cols, gx, cfg["pair_capacity"],
                                  cfg["compact_capacity"])
    perm, seg = R.sort_pairs(tile, cols["depth"][g], T, exact=True)
    g = g[perm]
    rows = torch.stack([cols["mx"][g], cols["my"][g], cols["ca"][g],
                        cols["cb"][g], cols["cc"][g],
                        opacity.to(dtype)[g]])
    pix = torch.arange(R.PIX, device=dev)
    tiles = torch.arange(T, device=dev)
    inside = (((tiles % gx) * R.TILE)[:, None] + pix % R.TILE < Wd) & (
        ((tiles // gx) * R.TILE)[:, None] + pix // R.TILE < Ht)
    gs_count = torch.zeros(n, dtype=torch.int64, device=dev)
    contribs = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = dict.fromkeys(("walked", "in_window", "contributing", "frozen",
                            "to_last"), 0)
    cutoff = cfg["power_cutoff"]
    for t0, t1, idx, in_seg in R.tile_groups(seg, cfg["reference_chunk"]):
        r = rows[:, idx]
        dx, dy = R.pixel_offsets(r[0], r[1], t0, t1, gx, local=False)
        power = (-0.5 * (r[2][..., None] * dx * dx + r[4][..., None] * dy * dy)
                 - r[3][..., None] * dx * dy)
        ins = inside[t0:t1, None, :]
        geo = (power <= 0.0) & (power >= cutoff) & in_seg[..., None] & ins
        alpha = torch.clamp(r[5][..., None] * torch.exp(power),
                            max=R.ALPHA_MAX)
        a = torch.where(geo & (alpha >= R.ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
        om = 1.0 - a
        T_before = torch.cat([torch.ones_like(om[:, :1]),
                              torch.cumprod(om, 1)[:, :-1]], 1)
        trigger = (a > 0) & (T_before * om < R.T_EPS)
        trig = trigger.int()
        done = (torch.cumsum(trig, 1) - trig) > 0
        contrib = (a > 0) & ~trigger & ~done
        w = torch.where(contrib, a * T_before, torch.zeros_like(a))
        # Each pixel's largest weight; argmax of the first maximum is the
        # earliest pair in the tile's order.
        wmax = w.amax(1)
        first = ((w == wmax[:, None]) & (w > 0)).int().argmax(1)
        has = wmax > 0
        win = torch.gather(idx, 1, first)[has]
        contribs.index_add_(0, g[win], torch.ones_like(win))
        # The fetch loop: rounds of 256 until every pixel is done.
        fired = trigger.any(1)
        rank = trig.argmax(1)
        never = (ins[:, 0] & ~fired).any(1)
        last = torch.where(ins[:, 0] & fired, rank, -1).amax(1)
        seg_len = in_seg.sum(1)
        fetched = torch.where(
            never, seg_len, torch.minimum(
                seg_len, (torch.div(last, FETCH_ROUND, rounding_mode="floor")
                          + 1) * FETCH_ROUND))
        fetched = torch.where(ins[:, 0].any(1), fetched,
                              torch.zeros_like(fetched))
        s = torch.arange(idx.shape[1], device=dev)
        took = in_seg & (s[None] < fetched[:, None])
        gs_count.index_add_(0, g[idx[took]], torch.ones_like(idx[took]))
        step = torch.arange(1, idx.shape[1] + 1, device=dev)[None, :, None]
        walked = torch.where(fired, rank + 1, torch.where(
            ins[:, 0], seg_len[:, None], 0))
        to_last = torch.where(contrib, step, 0).amax(1)
        for key, v in (("walked", walked.sum()),
                       ("in_window", (geo & ~done).sum()),
                       ("contributing", contrib.sum()),
                       ("frozen", fired.sum()), ("to_last", to_last.sum())):
            counts[key] += int(v)
    work = {"visible": int(cols["valid"].sum()), "candidates": total,
            "kept": kept, "pairs": g.numel(), "tiles": T, "pixels": Wd * Ht,
            **counts}
    return gs_count, contribs.to(torch.float32), work


def efficiency(gs_count, contribs):
    """max_comp_efficiency of one view: pixels won over pairs fetched, 0
    where no pair was fetched."""
    s = contribs / (gs_count.to(torch.float32) + 1e-7)
    return torch.where(gs_count >= 1, s, torch.zeros_like(s))


def cut(scores, live, ratio: float):
    """The rows the cut kills: (N,) bool, floor(n_live * ratio) live rows
    of lowest score, ties to the lower row index."""
    n = scores.shape[0]
    k = int(int(live.sum()) * ratio)
    s = torch.where(live, scores.float(), torch.full_like(scores.float(),
                                                          float("inf")))
    order = torch.sort(s, stable=True).indices
    kill = torch.zeros(n, dtype=torch.bool, device=scores.device)
    kill[order[:k]] = True
    return kill & live


def score_pass(p: dict, cams, cfg: dict, ratio: float,
               dtype=torch.float32) -> dict:
    """One metric-prune pass over `cams` with every row live: {"views":
    [(gs_count, contribs, work)], "max" (N,) f32, "kill" (N,) bool}."""
    opacity = torch.sigmoid(p["opacity"][:, 0].to(dtype))
    views, best = [], None
    for cam in cams:
        gs, c, w = score_view(p, opacity, cam, cfg, dtype)
        s = efficiency(gs, c)
        best = s if best is None else torch.maximum(best, s)
        views.append((gs, c, w))
    live = torch.ones(best.shape[0], dtype=torch.bool, device=best.device)
    return {"views": views, "max": best, "kill": cut(best, live, ratio)}


# --- counts of work: kernel 8's bound and the pass's operations -------

# csrc/blend_stats.cu's header: per pair-pixel walked 13 FLOP, 5 more in
# the power window, 14 more where the pair contributes, 3 per freezing
# pair; 36 B a pair in and 16 B out, 28 B a pixel out.
STATS_WALKED, STATS_WINDOW, STATS_CONTRIB, STATS_FREEZE = 13, 5, 14, 3
MAX_ROW = 1      # the max over views, a row a view
CUT_ROW = 2      # the cut by need: a selection, linear in the rows


def stats_work(w: dict) -> tuple:
    """(bytes, FLOP) of kernel 8 on one view, by need."""
    nbytes = w["pairs"] * (36 + 16) + w["tiles"] * R.PIX * 28 \
        + (w["tiles"] + 1) * 4
    flop = (STATS_WALKED * w["walked"] + STATS_WINDOW * w["in_window"]
            + STATS_CONTRIB * w["contributing"]
            + STATS_FREEZE * w["frozen"])
    return nbytes, flop


def stats_bound_s(ws) -> float:
    """Kernel 8's least seconds over the views `ws`."""
    return sum(W.bound_s(*stats_work(w))[0] for w in ws)


def pass_flop(ws, rows: int) -> float:
    """f32 operations by need of one score pass over the views `ws` of a
    state of `rows` rows: projection and SH colour of each visible row,
    the OBB test of each candidate, kernel 8's walk, the max over views
    and the cut."""
    return (sum((W.PROJECT + W.SH3) * w["visible"]
                + W.CANDIDATE * w["candidates"] + stats_work(w)[1]
                for w in ws)
            + MAX_ROW * rows * len(ws) + CUT_ROW * rows)
