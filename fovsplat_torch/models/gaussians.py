"""GaussianParams: the raw parameter store (counterpart of
fovsplat/models/gaussians.py).

An nn.Module holding the six raw (pre-activation) tensors as parameters;
the activations of the reference (gaussian_model.py:200-240) are applied
at read time. The train step builds a new module from the updated tensors
instead of writing into the old one, so a state stays valid after a step
(the JAX package's pytrees are immutable the same way). Also here: the
initialisation from a coloured point cloud (create_from_points, scales
from ops/knn), row selection and concatenation, and the PLY interop in the
reference's three schemas (plain, +index, composed; f_rest channel-major),
which reads and writes the same files as the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from fovsplat_torch.data import ply as plyio
from fovsplat_torch.ops import knn, sh
from fovsplat_torch.utils.device import resolve_device
from fovsplat_torch.utils.general import inverse_sigmoid

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


def create_from_points(points: np.ndarray, colors: np.ndarray,
                       sh_degree: int = 3, device=None) -> GaussianParams:
    """Initialise from a coloured point cloud (create_from_pcd,
    gaussian_model.py:246-270) on `device` (None: CUDA): scales from the
    mean 3-NN distance, identity rotation, opacity sigmoid^-1(0.1)."""
    dev = resolve_device(device)
    n = points.shape[0]
    k = sh.num_sh_coeffs(sh_degree)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dc = sh.rgb_to_sh_dc(torch.as_tensor(np.asarray(colors, np.float32),
                                         device=dev))[:, None, :]
    rest = torch.zeros((n, k - 1, 3), dtype=torch.float32, device=dev)
    dist2 = torch.clamp(knn.mean_knn_sqdist(pts), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rots[:, 0] = 1.0
    opac = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32,
                                            device=dev))
    return GaussianParams(pts, dc, rest, scales, rots, opac)


def select(params: GaussianParams, idx) -> GaussianParams:
    """Gather rows (prune keep-list, split/clone source list, ...)."""
    return GaussianParams(**{f: t.detach()[idx]
                             for f, t in params.fields().items()})


def concat(a: GaussianParams, b: GaussianParams) -> GaussianParams:
    return GaussianParams(**{f: torch.cat([getattr(a, f).detach(),
                                           getattr(b, f).detach()], dim=0)
                             for f in FIELDS})


def reset_opacity_max(params: GaussianParams, max_val: float = 0.99
                      ) -> GaussianParams:
    """Clamp activated opacity to <= max_val (reset_opacity_max,
    gaussian_model.py:427-431)."""
    o = torch.clamp(torch.sigmoid(params.opacity.detach()), max=max_val)
    return GaussianParams(**{**params.fields(), "opacity": inverse_sigmoid(o)})


# ---------------------------------------------------------------- PLY interop

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def to_ply_arrays(params: GaussianParams, indexes=None, shs_dcs=None,
                  ecc_threshs=None) -> dict[str, np.ndarray]:
    """Column dict in the reference's save_ply layout (f_rest
    channel-major, gaussian_model.py:356-374). Pass `indexes` for the
    index schema, `shs_dcs` + `ecc_threshs` for the composed schema."""
    xyz = _np(params.xyz)
    n = xyz.shape[0]
    cols: dict[str, np.ndarray] = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    f_dc = _np(params.features_dc).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = _np(params.features_rest).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i]
    cols["opacity"] = _np(params.opacity)[:, 0]
    sc = _np(params.scaling)
    for i in range(sc.shape[1]):
        cols[f"scale_{i}"] = sc[:, i]
    rot = _np(params.rotation)
    for i in range(rot.shape[1]):
        cols[f"rot_{i}"] = rot[:, i]
    if shs_dcs is not None:
        sd = _np(shs_dcs).transpose(0, 2, 1).reshape(n, -1)
        for i in range(sd.shape[1]):
            cols[f"shs_dc_{i}"] = sd[:, i]
        cols["ecc_thresh"] = _np(ecc_threshs).reshape(n)
    if indexes is not None:
        if isinstance(indexes, torch.Tensor):
            indexes = indexes.cpu().numpy()
        cols["index"] = np.asarray(indexes, np.int32).reshape(n)
    return cols


def save_ply(path: str, params: GaussianParams, **kw) -> None:
    plyio.write_ply(path, to_ply_arrays(params, **kw))


def from_ply_arrays(cols: dict[str, np.ndarray], sh_degree: int = 3,
                    device=None):
    """Inverse of to_ply_arrays. Returns (params on `device` (None: CUDA),
    extras), where extras (numpy) may hold 'index', 'shs_dcs',
    'ecc_thresh'."""
    dev = resolve_device(device)
    n = len(cols["x"])
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    k = sh.num_sh_coeffs(sh_degree)
    n_dc = sum(1 for c in cols if c.startswith("f_dc_"))
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(n_dc)], -1)
    f_dc = f_dc.reshape(n, 3, n_dc // 3).transpose(0, 2, 1)
    n_rest = sum(1 for c in cols if c.startswith("f_rest_"))
    if n_rest:
        f_rest = np.stack([cols[f"f_rest_{i}"] for i in range(n_rest)], -1)
        f_rest = f_rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, k - 1, 3), np.float32)
    n_sc = sum(1 for c in cols if c.startswith("scale_"))
    scaling = np.stack([cols[f"scale_{i}"] for i in range(n_sc)], -1)
    n_rot = sum(1 for c in cols if c.startswith("rot_"))
    rotation = np.stack([cols[f"rot_{i}"] for i in range(n_rot)], -1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)
    params = GaussianParams(t(xyz), t(f_dc), t(f_rest), t(scaling),
                            t(rotation), t(cols["opacity"][:, None]))
    extras: dict[str, Any] = {}
    if "index" in cols:
        extras["index"] = cols["index"].astype(np.int32)
    n_sd = sum(1 for c in cols if c.startswith("shs_dc_"))
    if n_sd:
        sd = np.stack([cols[f"shs_dc_{i}"] for i in range(n_sd)], -1)
        extras["shs_dcs"] = sd.reshape(n, 3, n_sd // 3).transpose(0, 2, 1)
    if "ecc_thresh" in cols:
        extras["ecc_thresh"] = cols["ecc_thresh"].astype(np.float32)
    return params, extras


def load_ply(path: str, sh_degree: int = 3, device=None):
    data = plyio.read_ply(path)
    return from_ply_arrays(data["vertex"], sh_degree=sh_degree,
                           device=device)
