"""The benchmark's weights: a proxy of the pruned Mip360 bicycle model,
drawn on the device from the run's seed.

Frozen from fovsplat_torch/data/proxy.py (bicycle_proxy, train_arrays),
itself a numpy copy of fovsplat/data/proxy.py. The distributions, the
layout and the calibration knob are that file's; the draws come from a
torch.Generator on the device in a few large calls instead of numpy on
the host. One cloud is drawn from a fixed generator seed and the run's
seed orders its rows: every seed renders and trains the same set of
Gaussians in another order, so a seed does not change the work (a cloud
drawn afresh per seed moved the PS1 frame rate on an H100 by up to 6%).
The draws are stratified: each column of uniform or normal
values is the same set of quantiles in an order drawn from the fixed
seed, which holds the level counts to the ladder. The numpy original was
calibrated to 1.528M kept pairs at the centre gaze and 0.713M at (0.2,
0.8) at 1237x822 (OBB + level cull).

  * N = 1,161,358 points at PS1 (MetaSapiens fov3dgs/pnum/ours-Q/bicycle.txt)
  * highest-level fractions from the ladder 1161358/465471/252678/202263
  * a central object cluster, a ground annulus and a far background shell
  * per-level DC and opacity correlated across levels, as in a composed
    model whose masked layers fine-tune the previous layer
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814


def hl_probs(pnum):
    """P(highest_level == l) from the survivor ladder `pnum`."""
    surv = [c / pnum[0] for c in pnum] + [0.0]
    return [surv[i] - surv[i + 1] for i in range(len(pnum))]


def _gamma(shape: float, n: int, g, dev) -> torch.Tensor:
    """Gamma(shape, 1) draws for shape >= 1 (Marsaglia and Tsang), eight
    vectorised rounds of the rejection step; a draw still rejected after
    them (probability below 1e-10 each) takes the mode."""
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.full((n,), d, dtype=torch.float64, device=dev)
    todo = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(8):
        x = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    return out


CLOUD_SEED = 0


def bicycle_proxy(n: int, seed: int, device, pnum,
                  scale_mult: float = 0.45) -> dict:
    """The proxy cloud on `device`, its rows in an order drawn from
    `seed`: a dict of f32 tensors means (N, 3), scales (N, 3) activated,
    rotations (N, 4) unit, opacity (N,) shared, opacities4 (N, L)
    activated per level, shs_dcs (N, L, 3), shs_rest (N, 15, 3),
    highest_levels (N,). `pnum` is the per-level point ladder (L
    levels)."""
    dev = torch.device(device)
    cloud = _cloud(n, dev, pnum, scale_mult)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    order = torch.randperm(n, generator=g, device=dev)
    return {k: v[order].contiguous() for k, v in cloud.items()}


def _cloud(n: int, dev, pnum, scale_mult: float) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(CLOUD_SEED)
    f64 = torch.float64

    def uniform(*shape):
        # Each column holds the n midpoint quantiles (i + 1/2) / n in a
        # drawn order.
        rows = shape[0]
        cols = math.prod(shape[1:])
        u = torch.stack([torch.randperm(rows, generator=g, device=dev)
                         for _ in range(cols)], 1).to(f64)
        return ((u + 0.5) / rows).reshape(shape)

    def normal(*shape):
        return torch.special.ndtri(uniform(*shape))

    L = len(pnum)
    n_fg = int(n * 0.38)       # central object (bike + bench)
    n_gnd = int(n * 0.30)      # ground annulus
    n_bg = n - n_fg - n_gnd    # background shell (trees, buildings)

    fg = normal(n_fg, 3) * torch.tensor([0.55, 0.35, 0.55], device=dev,
                                        dtype=f64)
    fg[:, 1] -= 0.2
    r = 0.8 + 6.2 * torch.sqrt(uniform(n_gnd))
    th = 2 * math.pi * uniform(n_gnd)
    gnd = torch.stack([r * torch.cos(th), 0.55 + 0.05 * normal(n_gnd),
                       r * torch.sin(th)], 1)
    # numpy's power(a) draws U ** (1 / a).
    rb = 4.0 + 10.0 * uniform(n_bg) ** (1.0 / 2.0)
    thb = 2 * math.pi * uniform(n_bg)
    yb = -(uniform(n_bg) ** (1.0 / 2.5)) * 6.0 + 0.6
    bg = torch.stack([rb * torch.cos(thb), yb, rb * torch.sin(thb)], 1)
    means = torch.cat([fg, gnd, bg]).float()

    base = torch.cat([torch.full((n_fg,), 0.0065, device=dev, dtype=f64),
                      torch.full((n_gnd,), 0.018, device=dev, dtype=f64),
                      torch.full((n_bg,), 0.05, device=dev, dtype=f64)])
    dist_comp = 1.0 + 0.15 * torch.linalg.norm(means.double(), dim=1)
    s_iso = base * dist_comp * torch.exp(0.85 * normal(n))
    aniso = torch.exp(0.45 * normal(n, 3))
    scales = (s_iso[:, None] * aniso * scale_mult).float()

    quats = normal(n, 4)
    quats = (quats / torch.linalg.norm(quats, dim=1, keepdim=True)).float()

    # Beta(4, 1.6) as X / (X + Y), X ~ Gamma(4), Y ~ Gamma(1.6).
    ga, gb = _gamma(4.0, n, g, dev), _gamma(1.6, n, g, dev)
    opacity = (ga / (ga + gb)).float() * 0.98 + 0.01

    cum = torch.tensor(hl_probs(pnum), device=dev, dtype=f64).cumsum(0)
    hl = torch.clamp(torch.searchsorted(cum, uniform(n)), max=L - 1).float()

    hue = 0.5 + 0.5 * torch.tanh(means.double() / 4.0)
    base_rgb = 0.15 + 0.7 * hue * (0.6 + 0.4 * uniform(n, 1))
    base_dc = ((base_rgb - 0.5) / SH_C0).float()
    deltas = (0.08 * normal(n, L, 3)).float()
    deltas[:, 0, :] = 0.0
    shs_dcs = base_dc[:, None, :] + torch.cumsum(deltas, 1)
    op_logit = torch.log(opacity.double() / (1 - opacity.double()))
    op_deltas = torch.cat([torch.zeros((n, 1), device=dev, dtype=f64),
                           0.25 + 0.15 * normal(n, L - 1)], 1)
    opacities4 = torch.sigmoid(op_logit[:, None]
                               + torch.cumsum(op_deltas, 1)).float()
    rest = (normal(n, 15, 3) * (0.08 / torch.arange(
        1, 16, device=dev, dtype=f64)[None, :, None] ** 0.5)).float()
    return {"means": means.contiguous(), "scales": scales.contiguous(),
            "rotations": quats.contiguous(), "opacity": opacity.contiguous(),
            "opacities4": opacities4.contiguous(),
            "shs_dcs": shs_dcs.contiguous(), "shs_rest": rest.contiguous(),
            "highest_levels": hl.contiguous()}


def train_raw(sc: dict) -> dict:
    """The raw (pre-activation) single-level parameters of a proxy: log
    scales, logit opacity (N, 1), the level-0 DC (N, 1, 3) and the SH
    rest (train_arrays without its fixed row permutation, which only
    reorders rows)."""
    op = sc["opacity"]
    return {"xyz": sc["means"], "features_dc": sc["shs_dcs"][:, 0:1, :].contiguous(),
            "features_rest": sc["shs_rest"],
            "scaling": torch.log(torch.clamp(sc["scales"], min=1e-9)),
            "rotation": sc["rotations"],
            "opacity": torch.log(op / (1 - op))[:, None].contiguous()}
