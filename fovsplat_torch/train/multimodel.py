"""MM-FR baseline generation: one pruned model per foveation level
(counterpart of fovsplat/train/multimodel.py, LightGaussian/
get_multimodel.py and scripts/run_prune_finetune.sh).

Read the "ours" model's per-layer point counts, then for each coarser
level prune the PS1 model down to that level's count with LightGaussian's
v-importance score (scratch.lightgaussian_prune: the count_opacity score
pass, kernels 4, 7 and 8 on the card) and fine-tune photometrically
(loops.finetune, kernels 4-7). mm_render_models packs the states'
live rows in the SH form that eval/fps.make_mmfr_render takes (four PS1
passes a frame, the baseline's cost profile, colour from the SH every
frame).
"""

from __future__ import annotations

from typing import Callable

import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.ops.rasterize import pack_ps1_model
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
def mm_render_models(models: list[S.TrainerState]) -> list:
    """The states as the packed SH form of eval/mmfr.render_mmfr_sh: each
    state's live rows as a rasterize.Ps1ModelSoA (activated geometry and
    opacity, the whole SH; SH and opacity in bf16)."""
    out = []
    for st in models:
        p, live = st.params, st.live
        out.append(pack_ps1_model(
            p.xyz[live], p.get_scaling()[live], p.get_rotation()[live],
            p.get_opacity()[live], p.features_dc[live],
            p.features_rest[live]))
    return out
