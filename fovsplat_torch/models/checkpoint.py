"""Checkpoint IO: .npz trainer state + PLY export (counterpart of
fovsplat/models/checkpoint.py).

One .npz carries the params, the live mask, the Adam moments and the
step, under the JAX package's keys (p_*, mu_*, nu_*, live, count, step,
extra_json), so a checkpoint written by either package loads in the
other bit for bit. PLY export writes the compacted cloud in the
reference's schema.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fovsplat_torch.models import gaussians as G
from fovsplat_torch.models import state as S
from fovsplat_torch.train import optim
from fovsplat_torch.utils.device import resolve_device

def save(path: str, state: S.TrainerState, step: int = 0,
         extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(t):
        return t.detach().cpu().numpy()
    arrs = {}
    for f in G.FIELDS:
        arrs["p_" + f] = host(getattr(state.params, f))
        arrs["mu_" + f] = host(state.opt.mu[f])
        arrs["nu_" + f] = host(state.opt.nu[f])
    arrs["live"] = host(state.live)
    arrs["count"] = host(state.opt.count)
    arrs["step"] = np.asarray(step)
    if extra:
        arrs["extra_json"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    np.savez(path, **arrs)


def load(path: str, device=None):
    """Returns (state on `device` (None: CUDA), step, extra)."""
    dev = resolve_device(device)
    z = np.load(path)

    def t(key):
        return torch.as_tensor(z[key], device=dev)
    params = G.GaussianParams(**{f: t("p_" + f) for f in G.FIELDS})
    opt = optim.AdamState(mu={f: t("mu_" + f) for f in G.FIELDS},
                          nu={f: t("nu_" + f) for f in G.FIELDS},
                          count=t("count"))
    state = S.TrainerState(params=params, opt=opt, live=t("live"))
    extra = {}
    if "extra_json" in z:
        extra = json.loads(bytes(z["extra_json"]).decode())
    return state, int(z["step"]), extra


def export_ply(path: str, state: S.TrainerState,
               with_index: bool = False) -> None:
    """Compacted PLY in the reference schema; `with_index` writes the
    original capacity-row index (the cross-layer identity column,
    gaussian_model.py save_ply_index)."""
    params, idx = S.compact(state)
    G.save_ply(path, params,
               indexes=idx.to(torch.int32) if with_index else None)
