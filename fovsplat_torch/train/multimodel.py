"""MM-FR baseline generation: one pruned model per foveation level
(counterpart of fovsplat/train/multimodel.py, LightGaussian/
get_multimodel.py and scripts/run_prune_finetune.sh).

Read the "ours" model's per-layer point counts, then for each coarser
level prune the PS1 model down to that level's count with LightGaussian's
v-importance score (scratch.lightgaussian_prune: the count_opacity score
pass, kernels 4, 7 and 8 on the card) and fine-tune photometrically
(loops.finetune, kernels 4-7). mm_render_models turns the states into
the dicts eval/mmfr.render_mmfr takes (four rasterizer passes a frame,
the baseline's cost profile).
"""

from __future__ import annotations

from typing import Callable

import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.ops import sh as sh_mod
from fovsplat_torch.train import loops, scratch


def generate_mm_models(ps1: S.TrainerState, train_views,
                       layer_counts: list[int], cfg: loops.LoopConfig,
                       finetune_iters: int = 1000, log: Callable = print,
                       v_pow: float = 0.1) -> list[S.TrainerState]:
    """Returns one TrainerState per level; level 0 is PS1 itself."""
    models = [ps1]
    total = int(ps1.live_count())
    for i, count in enumerate(layer_counts[1:], start=1):
        ratio = 1.0 - count / total
        st = scratch.lightgaussian_prune(ps1, train_views, cfg,
                                         percent=max(ratio, 0.0),
                                         prune_type="v_important_score",
                                         v_pow=v_pow)
        log(f"[mmfr] level {i}: pruned to {int(st.live_count())} "
            f"(target {count})")
        st = loops.finetune(st, train_views, finetune_iters, cfg, log=log)
        models.append(st)
    return models


@torch.no_grad()
def mm_render_models(models: list[S.TrainerState], camera,
                     sh_degree: int = 3) -> list[dict]:
    """The states as eval/mmfr.render_mmfr's dicts: activated xyz,
    scaling, rotation, opacity (zero on dead rows) and the view's colours
    (N, 3)."""
    out = []
    for st in models:
        p = st.params
        colors = sh_mod.sh_to_rgb(sh_degree, p.get_features(), p.xyz,
                                  camera.cam_center)
        out.append({"xyz": p.xyz.detach(), "scaling": p.get_scaling(),
                    "rotation": p.get_rotation(),
                    "opacity": p.get_opacity() * st.live,
                    "colors": colors})
    return out
