"""Small math and schedule helpers (counterpart of fovsplat/utils/general.py:
inverse_sigmoid and expon_lr only)."""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear lr interpolation with an optional delayed warm-up
    (get_expon_lr_func). `step` is a python number or a tensor; returns
    a 0-d f32 tensor on the step's device (the CPU for a python step)."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_init == lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t)
                         + math.log(lr_final) * t)
    return delay_rate * log_lerp
