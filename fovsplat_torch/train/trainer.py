"""The generic train step over the rasterizer (counterpart of
fovsplat/train/trainer.py: TrainConfig, render_params, make_train_step).

render -> loss (0.8 L1 + 0.2 (1 - SSIM) by default) -> backward ->
per-group Adam. With a process group (`group`, the JAX step's
axis_name) the loss and gradients are averaged over its ranks before the
update, JAX's pmean: replicated-parameter data parallelism over views
(parallel/data_parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.parallel import collectives
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
        params.get_opacity(), camera,
        shs=(params.features_dc, params.features_rest),
        sh_degree=cfg.sh_degree, bg_color=bg_color, config=cfg.raster)


def _freeze_mask(cfg: TrainConfig):
    """Masking mode trains only DC-SH and opacity
    (gaussian_renderer/__init__.py:71-82 detaches the rest)."""
    if not cfg.masking:
        return None
    return {f: f in ("features_dc", "opacity") for f in FIELDS}


def value_and_grad(params: GaussianParams, camera, gt, cfg: TrainConfig,
                   loss_fn: Callable, bg_color=None):
    """(loss, {field: gradient}, render output) of one view."""
    with torch.enable_grad():
        out = render_params(params, camera, cfg, bg_color=bg_color)
        loss = loss_fn(out["render"], gt)
        fields = params.fields()
        g = torch.autograd.grad(loss, list(fields.values()))
    return loss.detach(), dict(zip(fields, g)), out


def photometric_loss_fn(cfg: TrainConfig) -> Callable:
    def loss_fn(render, gt):
        return losses.photometric_loss(render, gt, cfg.lambda_dssim)
    return loss_fn


def update(params: GaussianParams, opt_state: optim.AdamState, loss,
           grads: dict, step_idx, cfg: TrainConfig, group=None):
    """(loss, grads, new params, new opt state): with `group` (a process
    group or 1-D DeviceMesh, the JAX step's axis_name) the loss and
    gradients are first averaged over its ranks (collectives.mean_over,
    JAX's pmean), then the per-group Adam runs (masking mode trains DC-SH
    and opacity only), the same update on every rank's replica. The one
    averaging path of make_train_step and data_parallel's step."""
    if group is not None:
        loss, grads = collectives.mean_over(group, loss, grads)
    lrs = optim.learning_rates(params, step_idx, cfg.optim,
                               cfg.spatial_lr_scale)
    new_params, new_state = optim.apply_updates(
        params, grads, opt_state, lrs, cfg.optim,
        freeze_mask=_freeze_mask(cfg))
    return loss, grads, new_params, new_state


def make_train_step(cfg: TrainConfig, loss_fn: Callable | None = None,
                    device=None, group=None):
    """step(params, opt_state, camera, gt, step_idx, bg_color=None) ->
    (new params, new opt state, {loss, radii, overflow, num_pairs}).
    `loss_fn(render, gt) -> scalar` defaults to the photometric loss.
    `device` None means CUDA and raises without it; pass "cpu" for the
    plain path. With `group` (a process group or 1-D DeviceMesh, the JAX
    step's axis_name) the loss and gradients are averaged over its ranks
    before the update (update), so every rank applies the same update to
    its replica."""
    resolve_device(device)
    if loss_fn is None:
        loss_fn = photometric_loss_fn(cfg)

    def step(params: GaussianParams, opt_state: optim.AdamState, camera, gt,
             step_idx, bg_color=None):
        loss, grads, out = value_and_grad(params, camera, gt, cfg, loss_fn,
                                          bg_color)
        loss, _, new_params, new_state = update(params, opt_state, loss,
                                                grads, step_idx, cfg, group)
        return new_params, new_state, {
            "loss": loss, "radii": out["radii"],
            "overflow": out["binned"].overflow,
            "num_pairs": out["binned"].num_pairs}

    return step
