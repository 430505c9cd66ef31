"""Foveated FPS benchmark, "ours" mode (fovsplat/eval/fps.py).

The reference's compose_gazes harness shape: a 3x3 grid of gazes
(0.2 / 0.5 / 0.8 on each axis), warm-ups, then timed repetitions of the
render call. Time comes from a pair of torch.cuda.Event around each batch
of repetitions, with one synchronize per batch; the harness refuses to
time anything but a CUDA render.
"""

from __future__ import annotations

import numpy as np
import torch

from fovsplat_torch.ops import foveated as fov
from fovsplat_torch.ops.foveation import FoveationConfig

GAZES = [(x, y) for y in (0.2, 0.5, 0.8) for x in (0.2, 0.5, 0.8)]


def make_fov_render(model: fov.FovModelSoA, config, fov_cfg=None,
                    alpha: float = 0.05, blending: bool = True):
    """render(camera, gaze (2,) f32 tensor) -> the rasterize_fov_soa dict
    for a packed "ours" model (fold a live mask in as hl = -1)."""
    fov_cfg = fov_cfg or FoveationConfig()

    def render(camera, gaze):
        return fov.rasterize_fov_soa(model, camera, gaze=gaze, alpha=alpha,
                                     blending=blending, config=config,
                                     fov_cfg=fov_cfg)
    return render


def fps_benchmark(render_fn, cameras, gazes=GAZES, warmups: int = 3,
                  reps: int = 20, log=print) -> dict:
    """render_fn(camera, gaze) -> dict with "render". Returns per-gaze
    mean ms and FPS and the averages over gazes."""
    dev = cameras[0].device
    if dev.type != "cuda":
        raise RuntimeError("fps_benchmark times the card; got cameras on "
                           f"{dev}")
    per_ms = []
    for gz in gazes:
        gaze = torch.tensor(gz, dtype=torch.float32, device=dev)
        for _ in range(warmups):
            render_fn(cameras[0], gaze)
        torch.cuda.synchronize(dev)
        times = []
        for cam in cameras:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                render_fn(cam, gaze)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        ms = float(np.mean(times))
        per_ms.append(ms)
        log(f"[fps] gaze={gz} ms={ms:.3f} fps={1000.0 / ms:.1f}")
    per_fps = [1000.0 / ms for ms in per_ms]
    return {"per_gaze_ms": per_ms, "per_gaze_fps": per_fps,
            "avg_ms": float(np.mean(per_ms)), "avg_fps": float(np.mean(per_fps))}
