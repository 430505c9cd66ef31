"""Densification (clone/split) and size pruning under capacity + live mask
(counterpart of fovsplat/models/densify.py).

Counterpart of the reference's densify_and_prune family
(scene/gaussian_model.py:688-851: densify_and_clone, densify_and_split with
scale/1.6 resampling, prune by opacity/screen-size) and the gradient
accumulation driven from the render loop (add_densification_stats).

Fixed capacity: each densify event promotes at most `budget` candidates
into dead capacity rows, highest view-space positional gradient first. If
the capacity runs out the lowest-priority candidates are dropped and
counted, never silently reordered. Ranks are taken by stable sorts, so
ties go to the lower row index, as jax.lax.top_k orders them: the
candidate ranking and the dead-slot pick (whose scores are all +-1) give
the JAX package's rows exactly. The split's normal samples come in as an
argument, so that a caller decides where they are drawn.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.ops.projection import quat_to_rotmat
from fovsplat_torch.train import optim
from fovsplat_torch.utils.device import resolve_device
from fovsplat_torch.utils.general import inverse_sigmoid


@dataclasses.dataclass(frozen=True)
class DensifyStats:
    grad_accum: torch.Tensor   # (C,) sum of view-space grad norms
    denom: torch.Tensor        # (C,) number of contributions
    max_radii: torch.Tensor    # (C,) max screen radius seen


def stats_tensors(stats: DensifyStats) -> tuple:
    """The statistics' tensors, in field order (a CUDA graph's inputs and
    outputs)."""
    return tuple(getattr(stats, f.name) for f in dataclasses.fields(stats))


def stats_of(ts) -> DensifyStats:
    """stats_tensors' inverse."""
    return DensifyStats(*ts)


def init_stats(capacity: int, device=None) -> DensifyStats:
    """Zero statistics on `device` (None: CUDA). The three fields share
    one zero tensor: no caller writes into them."""
    z = torch.zeros(capacity, dtype=torch.float32,
                    device=resolve_device(device))
    return DensifyStats(grad_accum=z, denom=z, max_radii=z)


def accumulate(stats: DensifyStats, mean2d_grad, radii, width,
               height) -> DensifyStats:
    """add_densification_stats: accumulate ||d mean2d|| for visible rows.
    The reference uses NDC-space gradients (viewspace_points); the
    pixel-space gradients here are rescaled by 2/size to match the
    threshold scale."""
    gx = mean2d_grad[:, 0] * (2.0 / width)
    gy = mean2d_grad[:, 1] * (2.0 / height)
    norm = torch.sqrt(gx * gx + gy * gy)
    vis = radii > 0
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(vis, norm,
                                                  torch.zeros_like(norm)),
        denom=stats.denom + vis.to(torch.float32),
        max_radii=torch.maximum(stats.max_radii, radii.to(torch.float32)))


def _top(scores: torch.Tensor, budget: int):
    """(values, indices) of the `budget` largest scores, ties by lower
    index first (jax.lax.top_k's order)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:budget], idx[:budget]


def _place_rows(state: S.TrainerState, new_params: dict, priority,
                want, budget: int):
    """Write up to `budget` new rows (new_params: field -> (C, ...) tensor
    aligned with the state's rows) into dead slots, highest `priority`
    first. Only the placed lanes are written. Returns (state, cand_idx
    (budget,), place (budget,) bool, dropped count (0-d tensor))."""
    live = state.live
    pr = torch.where(want, priority, torch.full_like(priority,
                                                     float("-inf")))
    top_pr, cand_idx = _top(pr, budget)
    cand_ok = top_pr > float("-inf")
    # The first `budget` dead slots, in row order.
    dead_score = torch.where(live, -1.0, 1.0)
    slot_score, slots = _top(dead_score, budget)
    place = cand_ok & (slot_score > 0)
    dropped = torch.clamp(want.sum() - place.sum(), min=0)

    rows = slots[place]
    src = cand_idx[place]
    params = {}
    for f in FIELDS:
        x = getattr(state.params, f).detach().clone()
        x[rows] = new_params[f][src]
        params[f] = x
    new_live = live.clone()
    new_live[rows] = True

    def zero_rows(x):
        x = x.clone()
        x[rows] = 0.0
        return x
    opt = optim.AdamState(mu={f: zero_rows(v) for f, v in state.opt.mu.items()},
                          nu={f: zero_rows(v) for f, v in state.opt.nu.items()},
                          count=state.opt.count)
    return (S.TrainerState(params=GaussianParams(**params), opt=opt,
                           live=new_live), cand_idx, place, dropped)


def _mean_grads(stats: DensifyStats):
    return stats.grad_accum / torch.clamp(stats.denom, min=1.0)


@torch.no_grad()
def densify_and_split(state: S.TrainerState, stats: DensifyStats,
                      grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01, budget: int = 16384,
                      noise: torch.Tensor = None):
    """Split: large Gaussians with high positional gradient are replaced by
    two samples from the Gaussian, scales / 1.6 (gaussian_model.py:751-793).
    One of the two samples reuses the parent's row. `noise` (2, C, 3)
    standard normal samples, on the state's device. Returns (state,
    dropped)."""
    p = state.params
    grads = _mean_grads(stats)
    scale = p.get_scaling().detach()
    max_scale = scale.amax(1)
    want = (state.live & (grads >= grad_threshold)
            & (max_scale > percent_dense * scene_extent))

    R = quat_to_rotmat(p.get_rotation().detach())
    samples = p.xyz.detach() + torch.einsum('nij,knj->kni', R,
                                            noise * scale)
    new_scaling = torch.log(scale / (0.8 * 2))   # = log(scale / 1.6)

    same = {f: getattr(p, f).detach()
            for f in ("features_dc", "features_rest", "rotation", "opacity")}
    child = {**same, "xyz": samples[0], "scaling": new_scaling}
    state2, cand_idx, place, dropped = _place_rows(state, child, grads, want,
                                                   budget)
    # Parent rows that actually split: replaced in place by sample 1 of
    # their own candidate lane.
    src = cand_idx[place]
    parent = {**same, "xyz": samples[1], "scaling": new_scaling}
    params = {}
    for f in FIELDS:
        x = getattr(state2.params, f).detach().clone()
        x[src] = parent[f][src]
        params[f] = x
    return dataclasses.replace(state2,
                               params=GaussianParams(**params)), dropped


@torch.no_grad()
def densify_and_clone(state: S.TrainerState, stats: DensifyStats,
                      grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01, budget: int = 16384):
    """Clone: small Gaussians with high positional gradient are duplicated
    as-is (gaussian_model.py:795-812). Returns (state, dropped)."""
    p = state.params
    grads = _mean_grads(stats)
    max_scale = p.get_scaling().detach().amax(1)
    want = (state.live & (grads >= grad_threshold)
            & (max_scale <= percent_dense * scene_extent))
    src = {f: t.detach() for f, t in p.fields().items()}
    state2, _, _, dropped = _place_rows(state, src, grads, want, budget)
    return state2, dropped


@torch.no_grad()
def prune_oversized(state: S.TrainerState, stats: DensifyStats,
                    max_screen_size: float | None, scene_extent: float,
                    opacity_threshold: float = 0.005) -> S.TrainerState:
    """densify_and_prune's prune: low opacity, huge screen radius, or
    world-size > 0.1 * extent (gaussian_model.py:814-834)."""
    p = state.params
    kill = torch.sigmoid(p.opacity.detach()[:, 0]) < opacity_threshold
    if max_screen_size is not None:
        kill = kill | (stats.max_radii > max_screen_size)
        kill = kill | (p.get_scaling().detach().amax(1)
                       > 0.1 * scene_extent)
    return S.prune_mask(state, state.live & kill)


@torch.no_grad()
def reset_opacity(state: S.TrainerState, value: float = 0.01
                  ) -> S.TrainerState:
    """reset_opacity (gaussian_model.py:421-425): clamp to <= value and
    refresh the opacity optimizer state."""
    new_op = inverse_sigmoid(torch.clamp(
        torch.sigmoid(state.params.opacity.detach()), max=value))
    params = GaussianParams(**{**state.params.fields(), "opacity": new_op})
    return S.TrainerState(params=params,
                          opt=optim.replace_field(state.opt, "opacity"),
                          live=state.live)
