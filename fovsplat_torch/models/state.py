"""Capacity-padded training state with a live mask (counterpart of
fovsplat/models/state.py: TrainerState and from_params).

Parameters stay at a fixed capacity and pruning flips rows of the boolean
`live` mask, which the rasterizer's cull consumes (preprocess_cols
live_mask). The prune functions are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.models.gaussians import GaussianParams
from fovsplat_torch.train import optim


@dataclasses.dataclass(frozen=True)
class TrainerState:
    params: GaussianParams
    opt: optim.AdamState
    live: torch.Tensor       # (C,) bool

    @property
    def capacity(self) -> int:
        return self.params.num_points


def from_params(params: GaussianParams, capacity: int | None = None
                ) -> TrainerState:
    n = params.num_points
    cap = capacity or n
    if cap > n:
        def pad(x, fill=0.0):
            extra = torch.full((cap - n,) + tuple(x.shape[1:]), fill,
                               dtype=x.dtype, device=x.device)
            return torch.cat([x.detach(), extra], dim=0)
        # Padding rows must be numerically safe, not just dead: an all-zero
        # quaternion hits 0/0 in the normalisation, and the NaN leaks into
        # dead-row gradients through masked values (0 * NaN = NaN).
        rotation = pad(params.rotation)
        rotation[n:, 0] = 1.0
        params = GaussianParams(
            xyz=pad(params.xyz),
            features_dc=pad(params.features_dc),
            features_rest=pad(params.features_rest),
            scaling=pad(params.scaling, -10.0),     # exp -> ~5e-5
            rotation=rotation,
            opacity=pad(params.opacity, -10.0))     # sigmoid -> ~5e-5
    live = torch.arange(cap, device=params.xyz.device) < n
    return TrainerState(params=params, opt=optim.init_state(params),
                        live=live)
