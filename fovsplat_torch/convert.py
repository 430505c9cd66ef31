"""Carry models and cameras across from the JAX package's numpy arrays.

fov_model_from_numpy takes the same arrays as
fovsplat.ops.foveated.pack_fov_model and gives a FovModelSoA whose
tensors are bitwise equal to the JAX packing's fields;
camera_from_numpy takes a JAX Camera's fields; params_from_numpy takes a
JAX GaussianParams' raw fields, so that both packages train the same
model.
"""

from __future__ import annotations

import numpy as np
import torch

from fovsplat_torch.data.cameras import camera_from_numpy  # noqa: F401
from fovsplat_torch.models.gaussians import GaussianParams
from fovsplat_torch.ops.foveated import FovModelSoA, pack_fov_model
from fovsplat_torch.utils.device import resolve_device


def fov_model_from_numpy(means, scales, rotations, opacities4, shs_dcs,
                         shs_rest, highest_levels, device=None) -> FovModelSoA:
    """means (N, 3), scales (N, 3) activated, rotations (N, 4) unit,
    opacities4 (N, L) activated, shs_dcs (N, L, 3), shs_rest (N, K-1, 3),
    highest_levels (N,): f32 numpy arrays, packed on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)
    return pack_fov_model(t(means), t(scales), t(rotations), t(opacities4),
                          t(shs_dcs), t(shs_rest), t(highest_levels))


def params_from_numpy(xyz, features_dc, features_rest, scaling, rotation,
                      opacity, device=None) -> GaussianParams:
    """A JAX GaussianParams' raw fields as numpy arrays -> the port's
    GaussianParams on `device`, bit for bit (f32)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)
    return GaussianParams(t(xyz), t(features_dc), t(features_rest),
                          t(scaling), t(rotation), t(opacity))
