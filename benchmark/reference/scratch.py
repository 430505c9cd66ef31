"""The plain reference of 3DGS's from-scratch training at its published
schedule (the Inria trainer's train.py and scene/gaussian_model.py): the
scratch step with its densification statistics, densify_and_prune with
no budget, the opacity reset and a loop of them, in float32 PyTorch with
no kernel and no graph, TF32 off. Rows are compact: there are no dead
rows.

The step is reference/train.py's (the render through its train route,
the photometric loss, autograd, Adam with the per-group rates) with 3DGS's
screen-space points: a zero (N, 2) tensor added to the projected pixel
means as the rasterizer's means2D, whose gradient, taken to NDC as the
rasterizer's backward takes it (x by W / 2, y by H / 2), feeds
add_densification_stats: for each row the render sees (radius > 0) the
norm of that gradient accumulates and its denominator counts one, and
the row's largest screen radius is kept.

densify_and_prune (gaussian_model.py:688-851): the mean gradient (0
where nothing accumulated) against the threshold; densify_and_clone
appends a copy of each candidate whose largest scale is at most
percent_dense * extent; densify_and_split appends N = 2 samples of each
larger candidate's Gaussian (rotation times noise times scale, plus the
mean; scale / (0.8 N); rotation, colour and opacity copied) and drops the
parent; densification_postfix zeroes the statistics, max_radii2D
included; then rows of opacity under 0.005, and past the first opacity
reset rows of screen radius over max_screen (none: the radii are zero)
or of largest scale over 0.1 * extent, are dropped. Appended rows get
zero Adam moments (cat_tensors_to_optimizer) and dropped rows lose theirs
(_prune_optimizer); the Adam count is kept. Every output row carries its
origin (the input row it came from) and its kind (KEPT, CLONE, CHILD0,
CHILD1), which its caller may use to order rows.

Departures from gaussian_model.py:688-851, each the system's:
  - the split's standard normals come in as an argument (2, N, 3), the
    first child's in [0], the second's in [1], where the published code
    draws torch.normal on the spot;
  - the screen radius is taken from the render's conic (its inverse is
    the 2D covariance; radius = ceil(3 sqrt(largest eigenvalue))), since
    reference/raster.project returns the rectangle and not the radius.
"""

from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

from benchmark.reference import raster
from benchmark.reference import train

FIELDS = train.FIELDS
KEPT, CLONE, CHILD0, CHILD1 = 0, 1, 2, 3
MIN_OPACITY = 0.005


def no_tf32() -> None:
    """Matrix products and convolutions in full float32 (the split's
    rotation, SSIM's window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nerfpp_radius(cam_centers) -> float:
    """getNerfppNorm's radius (the scene extent): 1.1 times the largest
    distance of a camera centre from their mean."""
    c = np.asarray(cam_centers, np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def zero_stats(n: int, dev) -> dict:
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return {"grad_accum": z, "denom": z, "max_radii": z}


@contextlib.contextmanager
def _screen_points(offset, seen: list):
    """While the block runs, raster.project's pixel means carry `offset`
    (N, 2) and each call's columns are appended to `seen`."""
    project = raster.project

    def with_offset(*a, **k):
        cols = project(*a, **k)
        seen.append(cols)
        return {**cols, "mx": cols["mx"] + offset[:, 0],
                "my": cols["my"] + offset[:, 1]}
    raster.project = with_offset
    try:
        yield
    finally:
        raster.project = project


def screen_radius(cols: dict) -> torch.Tensor:
    """ceil(3 sqrt(largest eigenvalue)) of the 2D covariance, the inverse
    of the render's conic (ca, cb, cc); 0 where the row is not valid."""
    with torch.no_grad():
        ca, cb, cc = (cols[k].float() for k in ("ca", "cb", "cc"))
        d = ca * cc - cb * cb
        safe = torch.where(cols["valid"], d, torch.ones_like(d))
        cxx, cyy = cc / safe, ca / safe
        mid = 0.5 * (cxx + cyy)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - 1.0 / safe, min=0.1))
        r = torch.ceil(3.0 * torch.sqrt(lam))
        return torch.where(cols["valid"], r, torch.zeros_like(r))


def accumulate(stats: dict, g2d, radius, width: int, height: int) -> dict:
    """add_densification_stats on the rows with radius > 0: the norm of
    the NDC gradient, a count, the largest radius."""
    ndc = torch.stack([g2d[:, 0] * (0.5 * width),
                       g2d[:, 1] * (0.5 * height)], 1).float()
    norm = torch.linalg.vector_norm(ndc, dim=-1)
    vis = radius > 0
    return {"grad_accum": stats["grad_accum"] + torch.where(
                vis, norm, torch.zeros_like(norm)),
            "denom": stats["denom"] + vis.float(),
            "max_radii": torch.where(vis, torch.maximum(stats["max_radii"],
                                                        radius),
                                     stats["max_radii"])}


def step(p: dict, adam: dict, stats: dict, cam, gt, it: int, fc: dict,
         optim: dict, lam: float, dtype=torch.float32) -> tuple:
    """One scratch step on view `cam`: (new params, new Adam state, new
    statistics, loss). `optim` the per-group rates as reference/train.adam
    takes them, the xyz rates already times the spatial scale."""
    no_tf32()
    leaves = {f: p[f].detach().to(dtype).requires_grad_(True) for f in FIELDS}
    n = leaves["xyz"].shape[0]
    offset = torch.zeros((n, 2), dtype=dtype, device=leaves["xyz"].device,
                         requires_grad=True)
    seen = []
    with _screen_points(offset, seen):
        img, _ = train.render(leaves, cam, fc, dtype)
    loss = train.loss_of(img, gt.to(dtype), lam)
    g = torch.autograd.grad(loss, [leaves[f] for f in FIELDS] + [offset])
    grads = {f: torch.where(torch.isfinite(x), x, torch.zeros_like(x))
             for f, x in zip(FIELDS, g)}
    with torch.no_grad():
        new_p, new_adam = train.adam({f: leaves[f].detach() for f in FIELDS},
                                     grads, adam, it, optim)
        stats = accumulate(stats, g[-1], screen_radius(seen[0]), cam.width,
                           cam.height)
    return new_p, new_adam, stats, float(loss.detach())


def build_rotation(q):
    """gaussian_model.py's build_rotation: the rotation of the normalised
    quaternion (w, x, y, z)."""
    norm = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
                      + q[:, 2] * q[:, 2] + q[:, 3] * q[:, 3])
    r, x, y, z = (q / norm[:, None]).unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], 1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], 1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], 1)], 1)


@torch.no_grad()
def densify_and_prune(p: dict, adam: dict, stats: dict, threshold: float,
                      extent: float, percent_dense: float, noise,
                      max_screen) -> tuple:
    """densify_and_prune with no budget (module docstring). noise (2, N,
    3) standard normals, noise[:, r] for a split of row r; max_screen
    None before the first opacity reset. Returns (params, Adam state,
    zero statistics, out): out holds origin and kind (M,) i64 of each
    output row, the candidate masks clone and split (N,), and the origin
    and kind of each row the prune dropped (pruned_origin,
    pruned_kind)."""
    no_tf32()
    n = p["xyz"].shape[0]
    dev = p["xyz"].device
    grads = stats["grad_accum"] / stats["denom"]
    grads[grads.isnan()] = 0.0
    scaling = torch.exp(p["scaling"])
    big = scaling.max(dim=1).values > percent_dense * extent
    sel = grads >= threshold
    clone, split = sel & ~big, sel & big
    k = int(split.sum())
    stds = scaling[split].repeat(2, 1)
    samples = noise[:, split].reshape(2 * k, 3) * stds
    rots = build_rotation(p["rotation"][split]).repeat(2, 1, 1)
    children = {
        "xyz": torch.bmm(rots, samples.unsqueeze(-1)).squeeze(-1)
        + p["xyz"][split].repeat(2, 1),
        "scaling": torch.log(stds / (0.8 * 2)),
        **{f: p[f][split].repeat(2, *([1] * (p[f].dim() - 1)))
           for f in ("features_dc", "features_rest", "rotation", "opacity")}}
    rows = {f: torch.cat([p[f], p[f][clone], children[f]]) for f in FIELDS}
    m = rows["xyz"].shape[0]
    idx = torch.arange(n, device=dev)
    origin = torch.cat([idx, idx[clone], idx[split], idx[split]])
    kind = torch.cat([torch.full((n,), KEPT, device=dev),
                      torch.full((int(clone.sum()),), CLONE, device=dev),
                      torch.full((k,), CHILD0, device=dev),
                      torch.full((k,), CHILD1, device=dev)])
    fresh = torch.zeros(m - n, dtype=torch.bool, device=dev)
    parent = torch.cat([split, fresh])
    # densification_postfix has zeroed max_radii2D: no radius passes
    # max_screen.
    radii = torch.zeros(m, device=dev)
    pruned = torch.sigmoid(rows["opacity"][:, 0]) < MIN_OPACITY
    if max_screen is not None:
        pruned = pruned | (radii > max_screen) | (
            torch.exp(rows["scaling"]).max(dim=1).values > 0.1 * extent)
    pruned = pruned & ~parent
    keep = ~(parent | pruned)

    def moments(x):
        return torch.cat([x, x.new_zeros((m - n,) + tuple(x.shape[1:]))])[keep]
    new_adam = {"mu": {f: moments(adam["mu"][f]) for f in FIELDS},
                "nu": {f: moments(adam["nu"][f]) for f in FIELDS},
                "count": adam["count"]}
    out = {"origin": origin[keep], "kind": kind[keep], "clone": clone,
           "split": split, "pruned_origin": origin[pruned],
           "pruned_kind": kind[pruned]}
    return ({f: rows[f][keep] for f in FIELDS}, new_adam,
            zero_stats(int(keep.sum()), dev), out)


def reset_opacity(p: dict, adam: dict, value: float = 0.01) -> tuple:
    """reset_opacity: opacities capped at `value`, the opacity group's
    moments zeroed (replace_tensor_to_optimizer)."""
    op = torch.clamp(torch.sigmoid(p["opacity"]), max=value)
    new = {**p, "opacity": torch.log(op / (1 - op))}
    z = torch.zeros_like(p["opacity"])
    return new, {"mu": {**adam["mu"], "opacity": z},
                 "nu": {**adam["nu"], "opacity": z}, "count": adam["count"]}


def xyz_rates(optim: dict, extent: float) -> dict:
    """The per-group rates with the xyz schedule times the spatial scale
    (create_from_pcd's spatial_lr_scale, the scene extent)."""
    return {**optim, "position_lr_init": optim["position_lr_init"] * extent,
            "position_lr_final": optim["position_lr_final"] * extent}


def run_schedule(p: dict, cams: list, gts: list, sched: dict, extent: float,
                 fc: dict, optim: dict, lam: float, start_iter: int,
                 iterations: int, seed: int, noise_for, adam=None,
                 after_event=None) -> tuple:
    """train.py's loop from iteration start_iter + 1 for `iterations`
    iterations at SH degree 3: views popped from a random.Random(seed)
    shuffle of the views each time the stack runs out, densify_and_prune
    every densify_every iterations strictly between densify_from and
    densify_until, the opacity reset every opacity_reset_every
    iterations. noise_for(events so far) gives the next event's split
    normals; after_event(events so far, params, Adam state), if given,
    returns the rows to go on from (a caller may put other rows of the
    same origins in their place). Returns (params, Adam state, events:
    [{"it", "live", "out"}])."""
    dev = p["xyz"].device
    adam = adam or train.init_state(p)
    stats = zero_stats(p["xyz"].shape[0], dev)
    rng, stack, events = random.Random(seed), [], []
    rates = xyz_rates(optim, extent)
    for it in range(start_iter + 1, start_iter + iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
            rng.shuffle(stack)
        v = stack.pop()
        p, adam, stats, _ = step(p, adam, stats, cams[v], gts[v], it, fc,
                                 rates, lam)
        if sched["densify_from"] < it < sched["densify_until"]:
            if it % sched["densify_every"] == 0:
                max_screen = (20.0 if it > sched["opacity_reset_every"]
                              else None)
                p, adam, stats, out = densify_and_prune(
                    p, adam, stats, sched["densify_grad_threshold"], extent,
                    sched["percent_dense"], noise_for(events),
                    max_screen)
                events.append({"it": it, "live": p["xyz"].shape[0],
                               "out": out})
                if after_event is not None:
                    p, adam = after_event(events, p, adam)
            if it % sched["opacity_reset_every"] == 0:
                p, adam = reset_opacity(p, adam)
    return p, adam, events
