"""Foveated FPS benchmark (fovsplat/eval/fps.py): the "ours" and SM-FR
("naive") frames of a composed model and the MM-FR baseline.

The reference's compose_gazes harness shape: a 3x3 grid of gazes
(0.2 / 0.5 / 0.8 on each axis), warm-ups, then timed repetitions of the
render call. Time comes from a pair of torch.cuda.Event around each batch
of repetitions, with one synchronize per batch, or, as the JAX harness
times it, from the host clock with a host read after every repetition;
the harness refuses to time anything but a CUDA render.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fovsplat_torch.eval import mmfr as emm
from fovsplat_torch.ops import foveated as fov
from fovsplat_torch.ops import sh as sh_mod
from fovsplat_torch.ops.foveation import FoveationConfig

GAZES = [(x, y) for y in (0.2, 0.5, 0.8) for x in (0.2, 0.5, 0.8)]
MODES = ("ours", "naive")


def make_fov_render(model, config, fov_cfg=None, alpha: float = 0.05,
                    blending: bool = True, mode: str = "ours"):
    """render(camera, gaze (2,) f32 tensor) -> the rasterize_fov_soa dict.

    model: a train/compose.ComposedModel, packed here for `mode` ("ours":
    per-level DC and opacity; "naive", SM-FR: one shared colour and
    opacity, the levels only gate participation, fps.py:62-76), its live
    mask folded in as hl = -1; or a FovModelSoA packed already, whose
    colour layout must match `mode`."""
    from fovsplat_torch.train import compose
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    fov_cfg = fov_cfg or FoveationConfig()
    if isinstance(model, compose.ComposedModel):
        model = compose.pack_composed(model, shared_colors=mode == "naive")
    elif (model.dc_t.shape[1] == 1) != (mode == "naive"):
        raise ValueError(f"a model with {model.dc_t.shape[1]} colour levels "
                         f"is not a {mode!r} model")

    def render(camera, gaze):
        return fov.rasterize_fov_soa(model, camera, gaze=gaze, alpha=alpha,
                                     blending=blending, config=config,
                                     fov_cfg=fov_cfg)
    return render


def make_mmfr_render(models, config, fov_cfg=None, alpha: float = 0.05):
    """render(camera, gaze) -> {"render", "overflow", "num_pairs",
    "passes"} for the MM-FR baseline (fps.py:96): four single-level
    models, one pass per level restricted to that level's tiles
    (eval/mmfr.render_mmfr). config: one RasterizeConfig or one per level.
    overflow and num_pairs sum the passes; "passes" lists each pass's
    diagnostics."""
    fov_cfg = fov_cfg or FoveationConfig()

    def render(camera, gaze):
        img, diags = emm.render_mmfr(models, camera, gaze, alpha, config,
                                     fov_cfg=fov_cfg, return_diag=True)
        return {"render": img,
                "overflow": sum(d["overflow"] for d in diags),
                "num_pairs": sum(d["num_pairs"] for d in diags),
                "passes": diags}
    return render


def mmfr_models_from_composed(composed):
    """Four single-level model dicts from a composed "ours" model
    (fps.py:117): level li keeps the live Gaussians with highest_level >=
    li, with their level-li opacity and the DC-only colour max(SH_C0 dc +
    0.5, 0); the rest get opacity 0."""
    p = composed.params
    L = composed.opacities.shape[1]
    models = []
    for li in range(L):
        keep = composed.live & (composed.highest_levels >= li)
        models.append({
            "xyz": p.xyz.detach(), "scaling": p.get_scaling().detach(),
            "rotation": p.get_rotation().detach(),
            "opacity": torch.where(keep, composed.opacities[:, li],
                                   torch.zeros_like(composed.opacities[:,
                                                                       li])),
            "colors": torch.clamp(sh_mod.SH_C0 * composed.shs_dcs[:, li, :]
                                  + 0.5, min=0.0)})
    return models


def fps_benchmark(render_fn, cameras, gazes=GAZES, warmups: int | None = None,
                  reps: int | None = None, sync_every_rep: bool = False,
                  log=print) -> dict:
    """render_fn(camera, gaze) -> dict with "render". Returns per-gaze
    mean ms and FPS and their averages over gazes: "per_gaze_ms",
    "per_gaze_fps", "avg_ms", "avg_fps", and the JAX harness's keys
    "per_gaze" (FPS, the same list as "per_gaze_fps") and "avg" (their
    mean).

    By default (3 warm-ups, 20 reps) each camera's reps run as one batch
    between two CUDA events, with one synchronize per batch. With
    `sync_every_rep`, the JAX form (fps.py:144-168; 10 warm-ups, 5 reps):
    each rep reads one pixel back to the host and time is the host clock's,
    so a host-bound frame's dispatch is timed as a caller that waits for
    each frame sees it."""
    dev = cameras[0].device
    if dev.type != "cuda":
        raise RuntimeError("fps_benchmark times the card; got cameras on "
                           f"{dev}")
    if warmups is None:
        warmups = 10 if sync_every_rep else 3
    if reps is None:
        reps = 5 if sync_every_rep else 20

    def force(out):
        return float(out["render"].reshape(-1)[0])

    def batch_ms(cam, gaze):
        if sync_every_rep:
            t0 = time.perf_counter()
            for _ in range(reps):
                force(render_fn(cam, gaze))
            return (time.perf_counter() - t0) * 1000.0 / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            render_fn(cam, gaze)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    per_ms = []
    for gz in gazes:
        gaze = torch.tensor(gz, dtype=torch.float32, device=dev)
        if sync_every_rep:
            force(render_fn(cameras[0], gaze))
        for _ in range(warmups):
            out = render_fn(cameras[0], gaze)
            if sync_every_rep:
                force(out)
        torch.cuda.synchronize(dev)
        ms = float(np.mean([batch_ms(cam, gaze) for cam in cameras]))
        per_ms.append(ms)
        log(f"[fps] gaze={gz} ms={ms:.3f} fps={1000.0 / ms:.1f}")
    per_fps = [1000.0 / ms for ms in per_ms]
    avg_fps = float(np.mean(per_fps))
    return {"per_gaze_ms": per_ms, "per_gaze_fps": per_fps,
            "avg_ms": float(np.mean(per_ms)), "avg_fps": avg_fps,
            "per_gaze": per_fps, "avg": avg_fps}
