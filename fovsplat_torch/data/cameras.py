"""Camera container (counterpart of fovsplat/data/cameras.py).

A frozen dataclass of tensors: the matrices, centre and half-angle
tangents live on the render device; width and height are plain ints.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fovsplat_torch.utils import graphics
from fovsplat_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: torch.Tensor   # (4, 4) f32, x_cam = world_view @ x_world
    full_proj: torch.Tensor    # (4, 4) f32, proj @ world_view
    cam_center: torch.Tensor   # (3,) f32
    tan_fovx: torch.Tensor     # () f32
    tan_fovy: torch.Tensor     # () f32
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def focal_x(self) -> torch.Tensor:
        # Tensor / tensor: one correctly rounded f32 division, as numpy's
        # f32 arithmetic does in the JAX package.
        return (torch.full((), float(self.width), device=self.device)
                / (2.0 * self.tan_fovx))

    @property
    def focal_y(self) -> torch.Tensor:
        return (torch.full((), float(self.height), device=self.device)
                / (2.0 * self.tan_fovy))


def camera_from_numpy(world_view, full_proj, cam_center, tan_fovx,
                      tan_fovy, width: int, height: int,
                      device=None) -> Camera:
    """Camera from a JAX Camera's fields as numpy arrays (or anything
    array-like), all stored as f32 on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)
    return Camera(world_view=t(world_view), full_proj=t(full_proj),
                  cam_center=t(cam_center), tan_fovx=t(tan_fovx),
                  tan_fovy=t(tan_fovy), width=int(width), height=int(height))


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                translate: np.ndarray | None = None, scale: float = 1.0,
                device=None) -> Camera:
    """Camera from COLMAP-style extrinsics (R: C2W rotation, t: W2C
    translation). The matrices are built in numpy exactly as the JAX
    package builds them, then moved to `device`."""
    w2c = graphics.world_to_view(R, t, translate, scale)
    proj = graphics.projection_matrix(graphics.Z_NEAR, graphics.Z_FAR,
                                      fovx, fovy)
    full = (proj @ w2c).astype(np.float32)
    cam_center = np.linalg.inv(w2c)[:3, 3].astype(np.float32)
    return camera_from_numpy(w2c, full, cam_center, math.tan(fovx * 0.5),
                             math.tan(fovy * 0.5), width, height, device)


def look_at_camera(eye, target, up, fovx: float, fovy: float,
                   width: int, height: int, device=None) -> Camera:
    """Camera at `eye` looking at `target` (+x right, +y down, +z
    forward, the COLMAP convention)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)
    t = -R_c2w.T @ eye
    return make_camera(R_c2w, t, fovx, fovy, width, height, device=device)
