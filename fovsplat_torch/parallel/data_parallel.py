"""Multi-device training: replicated parameters, views split over the
ranks, averaged gradients (counterpart of
fovsplat/parallel/data_parallel.py).

Parameters (the Gaussian cloud) are replicated; each rank renders its
own views through the fused train route (on the card kernels 4, 5, 6 and
7), averages its views' losses and gradients, and the averages are
all-reduced and divided by the world size (JAX's pmean,
data_parallel.py:89-90) before the per-group Adam, which every rank then
applies identically to its replica.

On the card the step is one CUDA graph per (rows, views, width, height)
(utils/graphs; JAX jits it, data_parallel.py:115), its all-reduce
captured with it. Only NCCL's collectives can be captured: on a gloo
group (the CPU, or ranks that share one card) the step runs eagerly when
asked with graph=False, and asking it for a graph raises
CaptureUnsupported. multihost.init_group turns NCCL's asynchronous error
handling off (TORCH_NCCL_ASYNC_ERROR_HANDLING=0) for that reason, as
torch's CUDA-graph notes ask for captured collectives.

Gaussian- and tile-sharded single-frame rendering lives in
parallel/tile_shard and parallel/fov_shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fovsplat_torch.data.cameras import (TENSOR_FIELDS, Camera,
                                         camera_tensors, camera_with_tensors)
from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.parallel import collectives
from fovsplat_torch.train import optim, trainer
from fovsplat_torch.utils import graphs
from fovsplat_torch.utils.device import resolve_device


class CaptureUnsupported(RuntimeError):
    """A CUDA graph was asked to hold a collective of a backend it cannot
    capture (gloo)."""


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


def make_dp_train_step(cfg: trainer.TrainConfig, group=None, device=None,
                       graph: bool | None = None):
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
    without it.

    graph (None: on CUDA) makes the step one CUDA graph per (rows, views,
    width, height): the parameters, moments, Adam count, cameras, ground
    truths and step_idx (a 0-d input) are its static inputs and the
    outputs fresh tensors; attributes `graph` and `eager`. A graph needs
    an NCCL group: on any other backend graph=True raises
    CaptureUnsupported (run a gloo group with graph=False)."""
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    if graph:
        backend = dist.get_backend(collectives.as_group(group))
        if backend != "nccl":
            raise CaptureUnsupported(
                f"a CUDA graph cannot capture a {backend} collective: "
                f"make the DP step with graph=False on a {backend} group")
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
    loss_fn = trainer.photometric_loss_fn(cfg)

    def eager(params, opt_state, cams: Camera, gts, step_idx):
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

    if not graph:
        return eager
    g = graphs.Graph()
    k, n_cam = len(FIELDS), len(TENSOR_FIELDS)

    def step(params, opt_state, cams: Camera, gts, step_idx):
        def run(*ts):
            p, o, aux = eager(
                GaussianParams(**dict(zip(FIELDS, ts[:k]))),
                optim.AdamState(mu=dict(zip(FIELDS, ts[k:2 * k])),
                                nu=dict(zip(FIELDS, ts[2 * k:3 * k])),
                                count=ts[3 * k]),
                camera_with_tensors(cams, ts[3 * k + 1:3 * k + 1 + n_cam]),
                *ts[3 * k + 1 + n_cam:])
            return ([getattr(p, f) for f in FIELDS],
                    [o.mu[f] for f in FIELDS], [o.nu[f] for f in FIELDS],
                    o.count, aux)

        p, mu, nu, count, aux = g(
            (params.num_points, gts.shape[0], cams.width, cams.height), run,
            *(getattr(params, f) for f in FIELDS),
            *(opt_state.mu[f] for f in FIELDS),
            *(opt_state.nu[f] for f in FIELDS), opt_state.count,
            *camera_tensors(cams), gts, step_idx)
        return (GaussianParams(**dict(zip(FIELDS, p))),
                optim.AdamState(mu=dict(zip(FIELDS, mu)),
                                nu=dict(zip(FIELDS, nu)), count=count),
                aux)

    step.graph = g
    step.eager = eager
    return step
