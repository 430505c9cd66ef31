"""Model composition: fold the PS-mask layers into the foveated model
(counterpart of fovsplat/train/compose.py).

Counterparts of the reference's compose_models.py:39-80 (ours),
gen_naive_FR.py:30-60 (the SM-FR baseline: random nested subsets sized
like ours' layers) and pnum_analyzer.py (per-layer counts). Every layer
state has the same capacity and row identity, so composition is three
selects per layer. pack_composed packs the result for the foveated frame
(ops/foveated.rasterize_fov_soa) with the live mask folded into
highest_levels as -1, a level no tile reaches (fovsplat/eval/fps.py:
44-48).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import GaussianParams
from fovsplat_torch.ops.foveated import FovModelSoA, pack_fov_model


@dataclasses.dataclass
class ComposedModel:
    """The foveated render model (compose_models.py's outputs
    highest_levels.pt, shs_dcs.pt, opacities.pt)."""
    params: GaussianParams    # capacity rows; xyz, scaling, rotation and
                              # features_rest of the PS1 model
    live: torch.Tensor        # (C,) bool, the PS1 live mask
    highest_levels: torch.Tensor  # (C,) f32
    shs_dcs: torch.Tensor     # (C, L, 3) raw DC coefficients per level
    opacities: torch.Tensor   # (C, L) activated opacity per level


def compose_layers(layer_states: list[S.TrainerState]) -> ComposedModel:
    """layer_states[0] is the PS1 model; each later state has the same
    capacity, a nested live mask and retrained DC and opacity. Level i
    takes a row's DC and opacity from layer i where the row is live there,
    else from level i - 1; highest_levels is the last layer it is live
    in."""
    base = layer_states[0]
    dev = base.live.device
    cap, L = base.capacity, len(layer_states)
    shs_dcs = torch.zeros((cap, L, 3), dtype=torch.float32, device=dev)
    opacities = torch.ones((cap, L), dtype=torch.float32, device=dev)
    highest = torch.zeros(cap, dtype=torch.float32, device=dev)
    for i, st in enumerate(layer_states):
        dc = st.params.features_dc.detach()[:, 0, :]
        op = torch.sigmoid(st.params.opacity.detach())[:, 0]
        if i == 0:
            shs_dcs[:, 0] = dc
            opacities[:, 0] = op
        else:
            live = st.live
            shs_dcs[:, i] = torch.where(live[:, None], dc, shs_dcs[:, i - 1])
            opacities[:, i] = torch.where(live, op, opacities[:, i - 1])
            highest = torch.where(live, float(i), highest)
    return ComposedModel(params=base.params, live=base.live,
                         highest_levels=highest, shs_dcs=shs_dcs,
                         opacities=opacities)


def gen_naive_fr(ps1_state: S.TrainerState, layer_counts: list[int],
                 seed: int = 0) -> torch.Tensor:
    """SM-FR baseline highest_levels: nested random subsets of the live
    rows with the given per-layer counts (gen_naive_FR.py:44-55), drawn
    with numpy's default_rng(seed) as the JAX package draws them. (C,)
    f32 on the state's device, dead rows 0."""
    live_idx = np.nonzero(ps1_state.live.cpu().numpy())[0]
    current = np.random.default_rng(seed).permutation(live_idx)
    highest = np.zeros(ps1_state.capacity, np.float32)
    for i, count in enumerate(layer_counts[1:], start=1):
        current = current[:count]
        highest[current] = i
    return torch.as_tensor(highest, device=ps1_state.live.device)


def layer_counts(layer_states: list[S.TrainerState]) -> list[int]:
    """Live rows per layer (pnum_analyzer.py)."""
    return [int(st.live.sum()) for st in layer_states]


def pack_composed(model: ComposedModel,
                  shared_colors: bool = False) -> FovModelSoA:
    """The composed model packed for rasterize_fov_soa; dead rows get
    highest level -1, which no tile's level reaches. shared_colors packs
    the SM-FR layout: the level-0 (PS1) DC and opacity for every level."""
    p = model.params
    return pack_fov_model(
        p.xyz.detach(), p.get_scaling().detach(), p.get_rotation().detach(),
        model.opacities, model.shs_dcs, p.features_rest.detach(),
        torch.where(model.live, model.highest_levels, -1.0),
        shared_colors=shared_colors)


def save_composed(path_prefix: str, model: ComposedModel) -> None:
    np.savez(path_prefix + "_composed.npz",
             highest_levels=model.highest_levels.cpu().numpy(),
             shs_dcs=model.shs_dcs.cpu().numpy(),
             opacities=model.opacities.cpu().numpy(),
             live=model.live.cpu().numpy())


def load_composed_arrays(path: str):
    """(highest_levels, shs_dcs, opacities, live) numpy arrays."""
    z = np.load(path)
    return (z["highest_levels"], z["shs_dcs"], z["opacities"], z["live"])
