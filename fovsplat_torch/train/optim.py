"""Per-group Adam (counterpart of fovsplat/train/optim.py).

The reference's torch.optim.Adam param groups (scene/gaussian_model.py:
273-301: per-tensor learning rates, eps=1e-15, xyz on an exponential
schedule), written out by hand with the JAX package's formula so that the
moments stay plain tensors keyed like the parameters: the row surgery of
pruning (models/state.prune_mask, replace_field) and densification
(select_rows, concat_rows) edits them in lockstep with
the parameters, which torch.optim.Adam's per-parameter state does not
allow.
"""

from __future__ import annotations

import dataclasses

import torch

from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.utils.general import expon_lr


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Defaults = reference OptimizationParams (arguments/__init__.py:71-91)."""
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    eps: float = 1e-15
    beta1: float = 0.9
    beta2: float = 0.999


@dataclasses.dataclass(frozen=True)
class AdamState:
    mu: dict        # field -> first moments, shaped like the parameter
    nu: dict        # field -> second moments
    count: torch.Tensor   # () int32 steps taken


def init_state(params: GaussianParams) -> AdamState:
    zeros = {f: torch.zeros_like(t, requires_grad=False)
             for f, t in params.fields().items()}
    return AdamState(mu=zeros, nu=dict(zeros),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params.xyz.device))


def learning_rates(params: GaussianParams, step, cfg: OptimConfig,
                   spatial_lr_scale: float = 1.0) -> dict:
    """field -> learning rate; xyz follows the exponential schedule
    (update_learning_rate, gaussian_model.py:297-303), computed on the
    parameters' device: `step` is a python number, filled into a 0-d
    tensor there (no host-to-device copy, so a CUDA graph can hold the
    step), or a 0-d tensor."""
    dev = params.xyz.device
    step = (step.to(dev) if torch.is_tensor(step)
            else torch.full((), step, dtype=torch.float32, device=dev))
    xyz_lr = expon_lr(step, cfg.position_lr_init * spatial_lr_scale,
                      cfg.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=cfg.position_lr_delay_mult,
                      max_steps=cfg.position_lr_max_steps)
    return {"xyz": xyz_lr,
            "features_dc": cfg.feature_lr,
            "features_rest": cfg.feature_lr / 20.0,
            "scaling": cfg.scaling_lr,
            "rotation": cfg.rotation_lr,
            "opacity": cfg.opacity_lr}


@torch.no_grad()
def apply_updates(params: GaussianParams, grads: dict, state: AdamState,
                  lrs: dict, cfg: OptimConfig = OptimConfig(),
                  freeze_mask: dict | None = None):
    """One Adam step. grads: field -> gradient. Returns (new params,
    new state); the inputs are left as they were.

    freeze_mask (field -> 0 or 1) keeps the fields marked 0 as they were
    and zeroes their moments: masking trains only DC-SH and opacity
    (gaussian_renderer/__init__.py:71-82; fovsplat/train/optim.py:92-97).
    A frozen field's new tensor is the old one, bit for bit."""
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c = count.to(torch.float32)
    mu_hat_scale = 1.0 / (1 - torch.pow(b1, c))
    nu_hat_scale = 1.0 / (1 - torch.pow(b2, c))
    mu, nu, new = {}, {}, {}
    for f in FIELDS:
        g = grads[f]
        mu[f] = b1 * state.mu[f] + (1 - b1) * g
        nu[f] = b2 * state.nu[f] + (1 - b2) * g * g
        old = getattr(params, f).detach()
        if freeze_mask is not None and not freeze_mask[f]:
            new[f] = old
            mu[f] = mu[f] * 0.0
            nu[f] = nu[f] * 0.0
            continue
        step = lrs[f] * (mu[f] * mu_hat_scale) / (
            torch.sqrt(nu[f] * nu_hat_scale) + cfg.eps)
        new[f] = old - step
    return GaussianParams(**new), AdamState(mu=mu, nu=nu, count=count)


def select_rows(state: AdamState, idx) -> AdamState:
    """Row surgery to mirror pruning (reference _prune_optimizer keeps
    exp_avg/exp_avg_sq rows of survivors)."""
    return AdamState(mu={f: v[idx] for f, v in state.mu.items()},
                     nu={f: v[idx] for f, v in state.nu.items()},
                     count=state.count)


def concat_rows(state: AdamState, n_new: int) -> AdamState:
    """Append zero-state rows for densified Gaussians
    (cat_tensors_to_optimizer)."""
    def cat(x):
        return torch.cat([x, x.new_zeros((n_new,) + tuple(x.shape[1:]))],
                         dim=0)
    return AdamState(mu={f: cat(v) for f, v in state.mu.items()},
                     nu={f: cat(v) for f, v in state.nu.items()},
                     count=state.count)


def replace_field(state: AdamState, field: str) -> AdamState:
    """Zero the moments of one field (replace_tensor_to_optimizer, used by
    reset_opacity_max)."""
    return AdamState(
        mu={**state.mu, field: torch.zeros_like(state.mu[field])},
        nu={**state.nu, field: torch.zeros_like(state.nu[field])},
        count=state.count)
