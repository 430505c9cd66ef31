"""Carry models and cameras across from the JAX package's numpy arrays.

fov_model_from_numpy and ps1_model_from_numpy take the same arrays as
fovsplat.ops.foveated.pack_fov_model and fovsplat.ops.rasterize.
pack_ps1_model and give packed models whose tensors are bitwise equal to
the JAX packings' fields; mmfr_models_from_numpy builds the four MM-FR
level models from a proxy's arrays as bench.py:255-268 does;
camera_from_numpy takes a JAX Camera's fields; params_from_numpy takes a
JAX GaussianParams' raw fields, so that both packages train the same
model, and densify_stats_from_numpy a JAX DensifyStats' fields.
"""

from __future__ import annotations

import numpy as np
import torch

from fovsplat_torch.data.cameras import camera_from_numpy  # noqa: F401
from fovsplat_torch.models.densify import DensifyStats
from fovsplat_torch.models.gaussians import GaussianParams
from fovsplat_torch.ops.foveated import FovModelSoA, pack_fov_model
from fovsplat_torch.ops.rasterize import Ps1ModelSoA, pack_ps1_model
from fovsplat_torch.utils.device import resolve_device


def _tensor_fn(device):
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)
    return t


def fov_model_from_numpy(means, scales, rotations, opacities4, shs_dcs,
                         shs_rest, highest_levels, device=None,
                         shared_colors: bool = False) -> FovModelSoA:
    """means (N, 3), scales (N, 3) activated, rotations (N, 4) unit,
    opacities4 (N, L) (or (N,) with shared_colors) activated, shs_dcs
    (N, L, 3), shs_rest (N, K-1, 3), highest_levels (N,): f32 numpy
    arrays, packed on `device`; shared_colors packs the SM-FR layout."""
    t = _tensor_fn(device)
    return pack_fov_model(t(means), t(scales), t(rotations), t(opacities4),
                          t(shs_dcs), t(shs_rest), t(highest_levels),
                          shared_colors=shared_colors)


def ps1_model_from_numpy(means, scales, rotations, opacities, features_dc,
                         features_rest, device=None) -> Ps1ModelSoA:
    """means (N, 3), scales (N, 3) and rotations (N, 4) activated,
    opacities (N,) activated, features_dc (N, 1, 3), features_rest
    (N, K-1, 3): f32 numpy arrays, packed on `device`."""
    t = _tensor_fn(device)
    return pack_ps1_model(t(means), t(scales), t(rotations), t(opacities),
                          t(features_dc), t(features_rest))


def mmfr_models_from_numpy(means, scales, rotations, opacities4, shs_dcs,
                           highest_levels, device=None) -> list:
    """The four MM-FR level models of a proxy (bench.py:255-268): level li
    keeps the Gaussians with highest_level >= li, with their level-li
    opacity (the rest 0) and the DC colour min(max(0.282095 dc + 0.5, 0),
    1), computed in numpy as the bench does. Returns the dicts
    eval/mmfr.render_mmfr takes, on `device`."""
    t = _tensor_fn(device)
    models = []
    for li in range(opacities4.shape[1]):
        keep = highest_levels >= li
        colors = np.maximum(0.282095 * shs_dcs[:, li, :] + 0.5, 0.0)
        models.append({"xyz": t(means), "scaling": t(scales),
                       "rotation": t(rotations),
                       "opacity": t(opacities4[:, li] * keep),
                       "colors": t(np.minimum(colors, 1.0))})
    return models


def params_from_numpy(xyz, features_dc, features_rest, scaling, rotation,
                      opacity, device=None) -> GaussianParams:
    """A JAX GaussianParams' raw fields as numpy arrays -> the port's
    GaussianParams on `device`, bit for bit (f32)."""
    t = _tensor_fn(device)
    return GaussianParams(t(xyz), t(features_dc), t(features_rest),
                          t(scaling), t(rotation), t(opacity))


def densify_stats_from_numpy(grad_accum, denom, max_radii,
                             device=None) -> DensifyStats:
    """A JAX DensifyStats' fields as numpy arrays -> the port's
    DensifyStats on `device`, bit for bit (f32)."""
    t = _tensor_fn(device)
    return DensifyStats(grad_accum=t(grad_accum), denom=t(denom),
                        max_radii=t(max_radii))
