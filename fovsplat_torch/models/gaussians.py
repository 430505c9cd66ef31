"""GaussianParams: the raw parameter store (counterpart of
fovsplat/models/gaussians.py: the class and its activations).

An nn.Module holding the six raw (pre-activation) tensors as parameters;
the activations of the reference (gaussian_model.py:200-240) are applied
at read time. The train step builds a new module from the updated tensors
instead of writing into the old one, so a state stays valid after a step
(the JAX package's pytrees are immutable the same way). PLY interop, knn
initialisation and densification are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


class GaussianParams(nn.Module):
    """Raw parameters, shapes (N, ...): xyz (N, 3), features_dc (N, 1, 3),
    features_rest (N, K-1, 3), scaling (N, 3) log-scale, rotation (N, 4)
    unnormalised quaternion (w, x, y, z), opacity (N, 1) logit."""

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity):
        super().__init__()
        for name, t in zip(FIELDS, (xyz, features_dc, features_rest, scaling,
                                    rotation, opacity)):
            setattr(self, name, nn.Parameter(t.detach()))

    def fields(self) -> dict:
        return {f: getattr(self, f) for f in FIELDS}

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round((self.features_rest.shape[1] + 1) ** 0.5)) - 1

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_rotation(self):
        q = self.rotation
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)[..., 0]

    def get_features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)
