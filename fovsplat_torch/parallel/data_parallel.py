"""Multi-device training: replicated parameters, views split over the
ranks, averaged gradients (counterpart of
fovsplat/parallel/data_parallel.py).

Parameters (the Gaussian cloud) are replicated; each rank renders its
own views through the fused train route (on the card kernels 4, 5, 6 and
7), averages its views' losses and gradients, and the averages are
all-reduced and divided by the world size (JAX's pmean,
data_parallel.py:89-90) before the per-group Adam, which every rank then
applies identically to its replica.

Gaussian- and tile-sharded single-frame rendering lives in
parallel/tile_shard and parallel/fov_shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fovsplat_torch.data.cameras import Camera
from fovsplat_torch.parallel import collectives
from fovsplat_torch.train import trainer
from fovsplat_torch.utils.device import resolve_device


def make_mesh(n_devices: int | None = None):
    """The default process group, JAX's Mesh over the devices (a rank is
    one device); raises without one. n_devices, when given, must be the
    world size."""
    w, _ = collectives.world()
    if n_devices not in (None, w):
        raise ValueError(f"{n_devices} devices asked for, {w} ranks")
    return dist.group.WORLD


def stack_cameras(cams: list[Camera]) -> Camera:
    """Equal-resolution cameras as one Camera whose tensors have a leading
    view axis (B, ...)."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("batched cameras must share resolution")
    return Camera(
        world_view=torch.stack([c.world_view for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        cam_center=torch.stack([c.cam_center for c in cams]),
        tan_fovx=torch.stack([c.tan_fovx for c in cams]),
        tan_fovy=torch.stack([c.tan_fovy for c in cams]),
        width=cams[0].width, height=cams[0].height)


def _index_camera(cams: Camera, i: int) -> Camera:
    return Camera(world_view=cams.world_view[i], full_proj=cams.full_proj[i],
                  cam_center=cams.cam_center[i], tan_fovx=cams.tan_fovx[i],
                  tan_fovy=cams.tan_fovy[i], width=cams.width,
                  height=cams.height)


def make_dp_train_step(cfg: trainer.TrainConfig, group=None, device=None):
    """step(params, opt_state, cams, gts, step_idx) -> (params, opt_state,
    {"loss", "grads", "overflow"}), run by every rank of `group` (a process
    group or 1-D DeviceMesh; None: the default group). cams: this rank's
    views as a stacked Camera (B_local, ...), gts (B_local, H, W, 3); the
    ranks' views together are the batch. Each view's loss and gradients
    come from the photometric objective; a rank's views are averaged, then
    trainer.update averages over the ranks and applies the update, so
    "loss" and "grads" are the batch means on every rank, and one view a
    rank is make_train_step(cfg, group=group) bit for bit (masking mode
    included, which the JAX step ignores). "overflow" sums the pair
    overflow of this rank's views. `device` None means CUDA and raises
    without it."""
    resolve_device(device)
    loss_fn = trainer.photometric_loss_fn(cfg)

    def step(params, opt_state, cams: Camera, gts, step_idx):
        views = [trainer.value_and_grad(params, _index_camera(cams, i),
                                        gts[i], cfg, loss_fn)
                 for i in range(gts.shape[0])]
        overflow = sum(v[2]["binned"].overflow for v in views)
        if len(views) == 1:
            loss, grads, _ = views[0]
        else:
            loss = torch.stack([v[0] for v in views]).mean(0)
            grads = {f: torch.stack([v[1][f] for v in views]).mean(0)
                     for f in views[0][1]}
        loss, grads, new_params, new_state = trainer.update(
            params, opt_state, loss, grads, step_idx, cfg, group)
        return new_params, new_state, {"loss": loss, "grads": grads,
                                       "overflow": overflow}

    return step
