"""Densification (clone/split) and size pruning under capacity + live mask
(counterpart of fovsplat/models/densify.py).

Counterpart of the reference's densify_and_prune family
(scene/gaussian_model.py:688-851: densify_and_clone, densify_and_split with
scale/1.6 resampling, prune by opacity/screen-size) and the gradient
accumulation driven from the render loop (add_densification_stats).

Fixed capacity (densify_and_clone, densify_and_split): each densify
event promotes at most `budget` candidates into dead capacity rows,
highest view-space positional gradient first. If the capacity runs out
the lowest-priority candidates are dropped and counted, never silently
reordered. Ranks are taken by stable sorts, so ties go to the lower row
index, as jax.lax.top_k orders them: the candidate ranking and the
dead-slot pick (whose scores are all +-1) give the JAX package's rows
exactly.

Every candidate (densify_every_candidate): the reference's rule, with no
budget. Every candidate is cloned or split, and the state grows to a
larger capacity first when its dead rows cannot hold the new rows, so
nothing is dropped. The split's normal samples come in as an argument in
both forms, so that a caller decides where they are drawn.
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
from fovsplat_torch.utils.profiling import span


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


def accumulate(stats: DensifyStats, mean2d_grad, radii, width, height,
               ndc: bool = False) -> DensifyStats:
    """add_densification_stats: accumulate ||d mean2d|| for visible rows.
    The reference takes the norm of the NDC-space gradient
    (viewspace_points), the pixel-space gradient times size / 2; `ndc`
    does the same. By default the pixel-space gradients are scaled by
    2 / size, as the JAX package scales them, so that its thresholds
    hold."""
    sx, sy = ((0.5 * width, 0.5 * height) if ndc
              else (2.0 / width, 2.0 / height))
    gx = mean2d_grad[:, 0] * sx
    gy = mean2d_grad[:, 1] * sy
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


def _put_rows(state: S.TrainerState, rows, values: dict):
    """Write values (field -> (k, ...)) into `rows` of the state's own
    tensors, zero their Adam moments and mark them live: in place, so
    only on a state that grow has just made."""
    for f in FIELDS:
        getattr(state.params, f)[rows] = values[f]
        state.opt.mu[f][rows] = 0.0
        state.opt.nu[f][rows] = 0.0
    state.live[rows] = True


def _first_rows(mask, k: int):
    """The first k rows where `mask` holds (it holds at k rows or more),
    in row order, read without a host sync: row r goes to slot
    cumsum(mask)[r] - 1, the other rows to a spare slot k."""
    c = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (c < k), c, k)
    out = torch.empty(k + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.numel(), device=mask.device))
    return out[:k]


@torch.no_grad()
def densify_every_candidate(state: S.TrainerState, stats: DensifyStats,
                            grad_threshold: float, scene_extent: float,
                            percent_dense: float, noise: torch.Tensor,
                            capacity_for):
    """densify_and_clone, then densify_and_split, with no budget
    (gaussian_model.py:751-812): every live row whose mean gradient
    reaches the threshold is cloned (largest scale at most percent_dense
    * extent) or split in two samples of its Gaussian, scales / 1.6.

    The new rows fill the state's first dead rows in row order: the
    clones, in their sources' order, then each split's first child; the
    second child takes its parent's row. When the dead rows cannot hold
    them, the state first grows to capacity_for(rows needed)
    (models/state.grow). Every new row, both children included, carries
    zero Adam moments; the other rows keep theirs. `noise` (2, C, 3):
    standard normals at the state's capacity C, noise[:, r] for a split
    of row r. The state given is left as it was. One host read, of the
    live and candidate counts, decides the growth. Stages: densify/grow
    (the candidates, the growth and the rows to fill), densify/clone and
    densify/split.

    Returns (state, moves): moves holds the index tensors clone_src,
    clone_dst, split_src and split_dst (each first child's row)."""
    p = state.params
    with span("densify/grow"):
        grads = _mean_grads(stats)
        scale = p.get_scaling().detach()
        big = scale.amax(1) > percent_dense * scene_extent
        want = state.live & (grads >= grad_threshold)
        clone, split = want & ~big, want & big
        live, n_clone, n_split = torch.stack(
            [state.live.sum(), clone.sum(), split.sum()]).tolist()
        n_new = n_clone + n_split
        need = live + n_new
        cap = state.capacity if need <= state.capacity else capacity_for(
            need)
        work = S.grow(state, cap)
        clone_src = _first_rows(clone, n_clone)
        split_src = _first_rows(split, n_split)
        dst = _first_rows(~work.live, n_new)
        clone_dst, split_dst = dst[:n_clone], dst[n_clone:]
    with span("densify/clone"):
        _put_rows(work, clone_dst, {f: t.detach()[clone_src]
                                    for f, t in p.fields().items()})
    with span("densify/split"):
        s = scale[split_src]
        R = quat_to_rotmat(p.get_rotation().detach()[split_src])
        samples = p.xyz.detach()[split_src] + torch.einsum(
            'nij,knj->kni', R, noise[:, split_src] * s)
        child = {f: getattr(p, f).detach()[split_src]
                 for f in ("features_dc", "features_rest", "rotation",
                           "opacity")}
        child["scaling"] = torch.log(s / (0.8 * 2))
        _put_rows(work, split_dst, {**child, "xyz": samples[0]})
        _put_rows(work, split_src, {**child, "xyz": samples[1]})
    return work, {"clone_src": clone_src, "clone_dst": clone_dst,
                  "split_src": split_src, "split_dst": split_dst}


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
