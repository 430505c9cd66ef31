"""Capacity-padded training state with a live mask (counterpart of
fovsplat/models/state.py).

Parameters stay at a fixed capacity and pruning flips rows of the boolean
`live` mask, which the rasterizer's cull consumes (preprocess_cols
live_mask). The prune functions (prune_mask, opacity_prune,
reset_opacity_max, metric_prune) are functional: each returns a new
state and writes into no tensor of the old one, so a state kept as a
rollback snapshot by the prune and mask loops stays as it was.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.train import optim
from fovsplat_torch.utils.general import inverse_sigmoid
from fovsplat_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TrainerState:
    params: GaussianParams
    opt: optim.AdamState
    live: torch.Tensor       # (C,) bool

    @property
    def capacity(self) -> int:
        return self.params.num_points

    def live_count(self):
        return self.live.sum()


def _pad_params(params: GaussianParams, cap: int) -> GaussianParams:
    """The parameters followed by cap - N dead rows."""
    n = params.num_points

    def pad(x, fill=0.0):
        extra = torch.full((cap - n,) + tuple(x.shape[1:]), fill,
                           dtype=x.dtype, device=x.device)
        return torch.cat([x.detach(), extra], dim=0)
    # Padding rows must be numerically safe, not just dead: an all-zero
    # quaternion hits 0/0 in the normalisation, and the NaN leaks into
    # dead-row gradients through masked values (0 * NaN = NaN).
    rotation = pad(params.rotation)
    rotation[n:, 0] = 1.0
    return GaussianParams(
        xyz=pad(params.xyz),
        features_dc=pad(params.features_dc),
        features_rest=pad(params.features_rest),
        scaling=pad(params.scaling, -10.0),     # exp -> ~5e-5
        rotation=rotation,
        opacity=pad(params.opacity, -10.0))     # sigmoid -> ~5e-5


def from_params(params: GaussianParams, capacity: int | None = None
                ) -> TrainerState:
    n = params.num_points
    cap = capacity or n
    if cap > n:
        params = _pad_params(params, cap)
    live = torch.arange(cap, device=params.xyz.device) < n
    return TrainerState(params=params, opt=optim.init_state(params),
                        live=live)


def grow(state: TrainerState, capacity: int) -> TrainerState:
    """The state at `capacity` >= its own: its rows first, then dead rows
    as from_params pads them, with zero Adam moments (the Adam count
    kept). Every tensor is new, so the caller may write into it."""
    if capacity < state.capacity:
        raise ValueError(f"grow: capacity {capacity} is below the state's "
                         f"{state.capacity}")
    extra = capacity - state.capacity
    live = torch.cat([state.live, state.live.new_zeros(extra)])
    return TrainerState(params=_pad_params(state.params, capacity),
                        opt=optim.concat_rows(state.opt, extra), live=live)


def compact(state: TrainerState):
    """Drop dead rows. Returns (params, original row indices (M,) i64)."""
    idx = torch.nonzero(state.live).reshape(-1)
    return GaussianParams(**{f: getattr(state.params, f)[idx]
                             for f in FIELDS}), idx


def prune_mask(state: TrainerState, kill: torch.Tensor) -> TrainerState:
    """Deactivate rows where `kill` is True and zero their Adam moments
    (_prune_optimizer keeps only the survivors' state)."""
    def zero(x):
        k = kill.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(k, torch.zeros_like(x), x)
    opt = optim.AdamState(mu={f: zero(v) for f, v in state.opt.mu.items()},
                          nu={f: zero(v) for f, v in state.opt.nu.items()},
                          count=state.opt.count)
    return TrainerState(params=state.params, opt=opt,
                        live=state.live & ~kill)


def opacity_prune(state: TrainerState, threshold: float = 0.005
                  ) -> TrainerState:
    """prune(prune_method="opacity"): kill live rows whose activated
    opacity is below threshold (prune.py:280)."""
    op = torch.sigmoid(state.params.opacity[:, 0].detach())
    return prune_mask(state, state.live & (op < threshold))


def reset_opacity_max(state: TrainerState, max_val: float = 0.1
                      ) -> TrainerState:
    """reset_opacity_max with replace_tensor_to_optimizer: opacities
    capped at max_val and fresh moments for the opacity group
    (gaussian_model.py:427-431, 609-622)."""
    p = state.params
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(p.opacity.detach()),
                                         max=max_val))
    params = GaussianParams(**{**p.fields(), "opacity": new_op})
    return TrainerState(params=params,
                        opt=optim.replace_field(state.opt, "opacity"),
                        live=state.live)


def metric_prune(state: TrainerState, scores: torch.Tensor,
                 ratio: float) -> TrainerState:
    """Kill exactly floor(n_live * ratio) live rows, those of lowest score
    (metric_pruning, prune.py:101-110). Rank-based, as the JAX package's
    (fovsplat/models/state.py:101-119): a stable sort, so ties break by
    row index, and a threshold never kills every row of a tied score.
    Runs in the profiling span "cut"."""
    with span("cut"):
        cap = state.live.shape[0]
        k = (state.live.sum().to(torch.float32) * ratio).to(torch.int32)
        s = torch.where(state.live, scores,
                        torch.full_like(scores, float("inf")))
        order = torch.argsort(s, stable=True)
        rank = torch.empty(cap, dtype=torch.int32, device=s.device)
        rank[order] = torch.arange(cap, dtype=torch.int32, device=s.device)
        return prune_mask(state, state.live & (rank < k))
