"""The generic train step over the rasterizer (counterpart of
fovsplat/train/trainer.py: TrainConfig, render_params, make_train_step).

render -> loss (0.8 L1 + 0.2 (1 - SSIM) by default) -> backward ->
per-group Adam, on one device. The JAX step's axis_name (gradients
averaged over a device mesh) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.train import losses, optim
from fovsplat_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    raster: rast.RasterizeConfig = rast.RasterizeConfig()
    optim: optim.OptimConfig = optim.OptimConfig()
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    spatial_lr_scale: float = 1.0
    masking: bool = False   # train only DC-SH + opacity (metric_mask_learn)


def render_params(params: GaussianParams, camera, cfg: TrainConfig,
                  bg_color=None):
    return rast.rasterize(
        params.xyz, params.get_scaling(), params.get_rotation(),
        params.get_opacity(), camera, shs=params.get_features(),
        sh_degree=cfg.sh_degree, bg_color=bg_color, config=cfg.raster)


def _freeze_mask(cfg: TrainConfig):
    """Masking mode trains only DC-SH and opacity
    (gaussian_renderer/__init__.py:71-82 detaches the rest)."""
    if not cfg.masking:
        return None
    return {f: f in ("features_dc", "opacity") for f in FIELDS}


def make_train_step(cfg: TrainConfig, loss_fn: Callable | None = None,
                    device=None):
    """step(params, opt_state, camera, gt, step_idx, bg_color=None) ->
    (new params, new opt state, {loss, radii, overflow, num_pairs}).
    `loss_fn(render, gt) -> scalar` defaults to the photometric loss.
    `device` None means CUDA and raises without it; pass "cpu" for the
    plain path."""
    resolve_device(device)
    if loss_fn is None:
        def loss_fn(render, gt):
            return losses.photometric_loss(render, gt, cfg.lambda_dssim)

    def step(params: GaussianParams, opt_state: optim.AdamState, camera, gt,
             step_idx, bg_color=None):
        with torch.enable_grad():
            out = render_params(params, camera, cfg, bg_color=bg_color)
            loss = loss_fn(out["render"], gt)
            fields = params.fields()
            g = torch.autograd.grad(loss, list(fields.values()))
        lrs = optim.learning_rates(params, step_idx, cfg.optim,
                                   cfg.spatial_lr_scale)
        new_params, new_state = optim.apply_updates(
            params, dict(zip(fields, g)), opt_state, lrs, cfg.optim,
            freeze_mask=_freeze_mask(cfg))
        return new_params, new_state, {
            "loss": loss.detach(), "radii": out["radii"],
            "overflow": out["binned"].overflow,
            "num_pairs": out["binned"].num_pairs}

    return step
