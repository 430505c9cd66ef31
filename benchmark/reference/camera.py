"""Cameras on the proxy's capture ring, built in numpy.

Frozen from fovsplat_torch/utils/graphics.py (world_to_view,
projection_matrix: the reference's getWorld2View2 and
getProjectionMatrix), fovsplat_torch/data/cameras.py (look_at_extrinsics,
make_camera) and chip_smoke.py (ring_extrinsics: radius 4, height -1.1,
the first camera at the proxy camera's eye, looking at the origin). The
benchmark builds every camera here and hands the same f32 matrices to the
program and to the plain reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Z_NEAR = 0.01
Z_FAR = 100.0
RING_RADIUS = 4.0
RING_HEIGHT = -1.1
RING_START = math.atan2(-2.4, 3.2)   # the proxy camera's eye (3.2, -1.1, -2.4)
FOVX = 1.20


def fovy(width: int, height: int) -> float:
    return FOVX * height / width * 1.24


def projection_matrix(fx: float, fy: float) -> np.ndarray:
    top = math.tan(fy / 2) * Z_NEAR
    right = math.tan(fx / 2) * Z_NEAR
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = Z_NEAR / right
    P[1, 1] = Z_NEAR / top
    P[2, 2] = Z_FAR / (Z_FAR - Z_NEAR)
    P[2, 3] = -(Z_FAR * Z_NEAR) / (Z_FAR - Z_NEAR)
    P[3, 2] = 1.0
    return P


def ring_arrays(angles, width: int, height: int) -> dict:
    """The f32 camera arrays of ring cameras at `angles` (radians, 0 at
    the proxy camera's eye), looking at the origin with up (0, -1, 0):
    world_view (F, 4, 4), full_proj (F, 4, 4), cam_center (F, 3), and
    the scalars tan_fovx, tan_fovy."""
    fy = fovy(width, height)
    a = RING_START + np.asarray(angles, np.float64)
    eye = np.stack([RING_RADIUS * np.cos(a), np.full_like(a, RING_HEIGHT),
                    RING_RADIUS * np.sin(a)], 1)
    fwd = -eye / np.linalg.norm(eye, axis=1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=2)           # columns, c2w
    w2c = np.zeros((len(a), 4, 4))
    w2c[:, :3, :3] = R.transpose(0, 2, 1)
    w2c[:, :3, 3] = -np.einsum("fji,fj->fi", R, eye)
    w2c[:, 3, 3] = 1.0
    w2c = w2c.astype(np.float32)
    full = (projection_matrix(FOVX, fy)[None] @ w2c).astype(np.float32)
    center = np.linalg.inv(w2c)[:, :3, 3].astype(np.float32)
    return {"world_view": w2c, "full_proj": full, "cam_center": center,
            "tan_fovx": np.float32(math.tan(FOVX * 0.5)),
            "tan_fovy": np.float32(math.tan(fy * 0.5))}


@dataclasses.dataclass(frozen=True)
class RefCamera:
    """One camera for the plain reference: f32 tensors on its device."""
    world_view: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    width: int
    height: int

    @property
    def focal_x(self):
        return (torch.full((), float(self.width),
                           device=self.world_view.device)
                / (2.0 * self.tan_fovx))

    @property
    def focal_y(self):
        return (torch.full((), float(self.height),
                           device=self.world_view.device)
                / (2.0 * self.tan_fovy))


def ref_camera(arrays: dict, i: int, width: int, height: int,
               device) -> RefCamera:
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)
    return RefCamera(t(arrays["world_view"][i]), t(arrays["full_proj"][i]),
                     t(arrays["cam_center"][i]), t(arrays["tan_fovx"]),
                     t(arrays["tan_fovy"]), width, height)
