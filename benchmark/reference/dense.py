"""The benchmark's dense weights: a proxy of 3DGS's dense 30k-iteration
bicycle model, the model that efficiency-aware pruning starts from, drawn
on the device.

Rows 0..n_ps1-1 are the PS1 proxy exactly as reference/proxy.py draws it
for the bicycle-ps1 configuration (bicycle_proxy: the fixed cloud, rows
in the run's seed order). The rest are the rows that pruning removes:
each is a split child of a PS1 row, built as 3DGS's densify_and_split
builds a child with N = 2 (gaussian_model.py): the parent's mean plus a
draw from the parent's Gaussian, the parent's scale divided by 0.8 N =
1.6, the parent's rotation and SH, and a low opacity (the configuration's
`children`: a normal law of the logit, clipped below at 3DGS's
opacity-prune threshold). The parents, the draws and the opacities
come from a fixed generator seed over the cloud in its fixed order, and
the run's seed orders the children as it orders the PS1 rows, so every
seed holds the same Gaussians and does the same work.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import proxy

CHILD_SEED = 1


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def split_children(cloud: dict, n_children: int, dev, law: dict) -> dict:
    """The raw parameters of `n_children` split children of the rows of
    `cloud` (proxy._cloud's dict, its rows in the fixed order), and each
    child's parent row: a dict of f32 tensors xyz (M, 3), features_dc
    (M, 1, 3), features_rest (M, 15, 3), scaling (M, 3) log, rotation
    (M, 4), opacity (M, 1) logit, and parent (M,) i64."""
    g = torch.Generator(device=dev)
    g.manual_seed(CHILD_SEED)
    n = cloud["means"].shape[0]
    parent = torch.randint(0, n, (n_children,), generator=g, device=dev)
    s = cloud["scales"][parent]
    q = cloud["rotations"][parent]
    w, x, y, z = q.unbind(1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], 1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], 1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], 1)], 1)
    sample = torch.randn((n_children, 3), generator=g, device=dev) * s
    xyz = (R * sample[:, None, :]).sum(2) + cloud["means"][parent]
    logit = (law["opacity_logit_mean"] + law["opacity_logit_sigma"]
             * torch.randn(n_children, generator=g, device=dev)).clamp(
                 min=_logit(law["opacity_floor"]))
    return {"xyz": xyz.contiguous(),
            "features_dc": cloud["shs_dcs"][parent, 0:1, :].contiguous(),
            "features_rest": cloud["shs_rest"][parent].contiguous(),
            "scaling": torch.log(torch.clamp(s / (0.8 * law["split_n"]),
                                             min=1e-9)).contiguous(),
            "rotation": q.contiguous(),
            "opacity": logit[:, None].float().contiguous(),
            "parent": parent}


def dense_raw(cfg: dict, seed: int, dev) -> dict:
    """The dense proxy's raw parameters (reference/train.FIELDS, as
    proxy.train_raw gives them) on `dev`: the PS1 proxy of
    cfg["ps1_points"] rows in the seed's order, then the split children
    up to cfg["frame"]["points"] rows in the seed's order."""
    n_ps1, n = cfg["ps1_points"], cfg["frame"]["points"]
    ps1 = proxy.train_raw(proxy.bicycle_proxy(n_ps1, seed, dev, cfg["pnum"]))
    cloud = proxy._cloud(n_ps1, torch.device(dev), cfg["pnum"], 0.45)
    kids = split_children(cloud, n - n_ps1, dev, cfg["children"])
    del cloud
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    order = torch.randperm(n - n_ps1, generator=g, device=dev)
    return {f: torch.cat([ps1[f], kids[f][order]]).contiguous()
            for f in ps1}
