"""The photometric train step (counterpart of fovsplat/train/loops.py:
LoopConfig, render_state, _mask_dead_grads, NanWatch and
make_photometric_step, loops.py:35-149).

One step: render through rasterize's fused train route, loss = (1 -
lambda) * L1 + lambda * (1 - SSIM) (plus the optional scale-decay term),
backward, masking of dead and non-finite gradients, per-group Adam. The
step is functional: it returns a new TrainerState and leaves the old one
as it was. The HVS step and the prune and mask loops are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.train import losses, optim
from fovsplat_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    raster: rast.RasterizeConfig = rast.RasterizeConfig()
    optim: optim.OptimConfig = optim.OptimConfig()
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    spatial_lr_scale: float = 1.0


def render_state(state: S.TrainerState, camera, cfg: LoopConfig,
                 bg_color=None):
    p = state.params
    return rast.rasterize(p.xyz, p.get_scaling(), p.get_rotation(),
                          p.get_opacity(), camera, shs=p.get_features(),
                          sh_degree=cfg.sh_degree, bg_color=bg_color,
                          config=cfg.raster, live_mask=state.live)


def _gs_counts(binned, capacity: int):
    """Kept pairs per Gaussian ~ the reference's gs_count (one atomicAdd
    per fetched (tile, Gaussian) pair, forward.cu:361), from the sorted
    pair list's Gaussian ids up to num_pairs."""
    lane = torch.arange(binned.pair_gauss.shape[0],
                        device=binned.pair_gauss.device)
    ids = torch.where(lane < binned.num_pairs, binned.pair_gauss.long(),
                      capacity)
    return torch.bincount(ids, minlength=capacity + 1)[:capacity]


def _mask_dead_grads(grads: dict, live):
    """Zero dead-row and non-finite gradients; returns (grads, n_bad), where
    n_bad counts LIVE rows whose gradient had a non-finite component (a
    kernel bug must surface, not be absorbed: the step reports it)."""
    bad = torch.zeros_like(live)
    out = {}
    for f, g in grads.items():
        fin = torch.isfinite(g)
        bad = bad | (live & ~fin.reshape(live.shape[0], -1).all(1))
        lv = live.reshape(live.shape + (1,) * (g.dim() - 1))
        out[f] = torch.where(lv & fin, g, torch.zeros_like(g))
    return out, bad.sum().to(torch.int32)


class NanWatch:
    """Surfaces _mask_dead_grads' live-row non-finite counter. Reads each
    step's counter one step late, so the host read does not stall the
    card's queue."""

    def __init__(self, log: Callable):
        self.total = 0
        self.events = 0
        self._log = log
        self._prev = None

    def push(self, aux):
        prev, self._prev = self._prev, aux
        if prev is not None:
            self._read(prev)

    def _read(self, aux):
        nb = int(aux.get("nonfinite", 0))
        if nb:
            self.total += nb
            self.events += 1
            self._log(f"[warn] non-finite grads zeroed on {nb} LIVE rows "
                      f"(event {self.events}, cum rows {self.total}) - "
                      f"possible blend-backward overflow")

    def flush(self):
        if self._prev is not None:
            self._read(self._prev)
            self._prev = None


def photometric_grads(state: S.TrainerState, camera, gt, cfg: LoopConfig,
                      use_scale_decay: bool = False, scale_weight=0.0):
    """Loss and masked gradients of one view: returns (loss, grads {field:
    tensor}, n_bad, render output)."""
    params = state.params
    with torch.enable_grad():
        out = render_state(state, camera, cfg)
        loss = losses.photometric_loss(out["render"], gt, cfg.lambda_dssim)
        if use_scale_decay:
            # prune.py:257-261: + w * mean(max_scale * (gs_count - 4)
            # * [gs_count > 4]) over live rows.
            gs_count = _gs_counts(out["binned"], state.capacity)
            scale_max = params.get_scaling().amax(1)
            term = scale_max * (gs_count - 4) * (gs_count > 4) * state.live
            n_live = torch.clamp(state.live.sum(), min=1)
            loss = loss + scale_weight * term.sum() / n_live
        fields = params.fields()
        g = torch.autograd.grad(loss, list(fields.values()))
    grads, n_bad = _mask_dead_grads(dict(zip(fields, g)), state.live)
    return loss.detach(), grads, n_bad, out


def make_photometric_step(cfg: LoopConfig, use_scale_decay: bool = False,
                          device=None):
    """The step function step(state, camera, gt, it, scale_weight) ->
    (new state, {loss, overflow, nonfinite, num_pairs}), the values 0-d
    tensors on the device (not synchronised). `device` None means CUDA
    and raises without it; pass "cpu" for the plain path."""
    dev = resolve_device(device)

    def step(state: S.TrainerState, camera, gt, it, scale_weight=0.0):
        if state.params.xyz.device.type != dev.type:
            raise ValueError(f"state on {state.params.xyz.device}, step "
                             f"made for {dev}")
        loss, grads, n_bad, out = photometric_grads(
            state, camera, gt, cfg, use_scale_decay, scale_weight)
        lrs = optim.learning_rates(state.params, it, cfg.optim,
                                   cfg.spatial_lr_scale)
        params, opt = optim.apply_updates(state.params, grads, state.opt,
                                          lrs, cfg.optim)
        bn = out["binned"]
        return (dataclasses.replace(state, params=params, opt=opt),
                {"loss": loss, "overflow": bn.overflow, "nonfinite": n_bad,
                 "num_pairs": bn.num_pairs})

    return step
