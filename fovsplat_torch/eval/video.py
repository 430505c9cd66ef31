"""Camera-path video rendering (counterpart of fovsplat/eval/video.py).

Counterpart of LightGaussian/render_video.py: a smooth camera trajectory
(an ellipse around the scene) rendered to PNG frames.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fovsplat_torch.data.cameras import look_at_camera


def ellipse_path(views, n_frames: int = 120, z_rate: float = 0.1):
    """Cameras on an ellipse fitted through the training camera centres,
    looking at their mean, on the first view's camera's device."""
    centers = np.stack([v.camera.cam_center.cpu().numpy() for v in views])
    mean = centers.mean(axis=0)
    offsets = centers - mean
    # Principal plane via SVD.
    _, _, vt = np.linalg.svd(offsets, full_matrices=False)
    a = np.abs(offsets @ vt[0]).max()
    b = np.abs(offsets @ vt[1]).max()
    h = offsets @ vt[2]
    up = -vt[2] if vt[2][1] > 0 else vt[2]

    ref = views[0].camera
    w, hgt = ref.width, ref.height
    fovx = 2 * np.arctan(float(ref.tan_fovx))
    fovy = 2 * np.arctan(float(ref.tan_fovy))

    cams = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        pos = (mean + a * np.cos(th) * vt[0] + b * np.sin(th) * vt[1]
               + z_rate * h.mean() * np.sin(2 * th) * vt[2])
        cams.append(look_at_camera(pos, mean, up, fovx, fovy, w, hgt,
                                   device=ref.device))
    return cams


def render_video(render_fn, cameras, out_dir: str, prefix: str = "frame"):
    """render_fn(camera) -> (H, W, 3). Writes `<prefix>_NNNN.png` frames
    (assemble them with any encoder, e.g. ffmpeg). Returns their count."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for i, cam in enumerate(cameras):
        img = torch.clamp(torch.as_tensor(render_fn(cam)), 0, 1)
        Image.fromarray((img.cpu().numpy() * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"{prefix}_{i:04d}.png"))
    return len(cameras)
