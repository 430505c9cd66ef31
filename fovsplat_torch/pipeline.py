"""End-to-end pipeline orchestrator (combined_training_script.py,
in-process; the port's counterpart of fovsplat/pipeline.py).

Stage chain per scene (reference §3.1):
  0. scratch        — from-scratch 3DGS training (train_densify_prune)
  1. finetune       — photometric fine-tune of the pretrained model
  2. prune          — efficiency-aware pruning to targets derived from the
                      pretrain eval (run_prune.py: hvs*(1+r), ssim*(1-r),
                      psnr*(1-r))
  3. hvs_finetune   — uniform-HVS(L1) reshape at PS=1
  4. mask layers    — PS ladder round((1+i*(sqrt(12)-1)/3)^2) = [1,3,7,12]
                      (run_multi_ecc_masking.py:119-131)
  5. compose        — highest_levels / shs_dcs / opacities

Same filesystem-idempotency contract as the reference: every stage checks
for its output checkpoint and skips finished work, so a crashed run resumes
at the failed stage (SURVEY.md §5.3). The stage files are the JAX
package's (base.npz, pruned.npz, ps1.npz, layer{i}_ps{ps}.npz,
ours_composed.npz, pnum.txt, naive_fr.npz, point_cloud_ps1.ply, log.txt)
and its checkpoints load in either package, so a run started by one can
resume in the other. Everything runs on `device` (None: CUDA).

As in the JAX package, `pair_capacity` is the rasterizer's candidate-pair
buffer; the port's counts real candidates only, where the JAX buffer also
holds one dummy pair per Gaussian (ROADMAP section 3).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from fovsplat_torch.data import dataset
from fovsplat_torch.models import checkpoint as ckpt
from fovsplat_torch.models import gaussians as G
from fovsplat_torch.models import state as S
from fovsplat_torch.ops.rasterize import RasterizeConfig
from fovsplat_torch.train import compose as compose_mod
from fovsplat_torch.train import loops, scratch
from fovsplat_torch.utils.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    layer_num: int = 4
    max_pooling_size: int = 12
    prune_iters: int = 50_000
    prune_adapt_split: float = 0.9          # 90/10 prune/adapt
    masking_budget: int = 22_500
    target_relax: float = 0.075             # run_prune.py default ratio
    mask_target_scale: float = 1.0          # reference target_loss_scale:
                                            # the single absolute masking
                                            # target is PS1's HVS@pooling-1
                                            # times this (combined_training
                                            # _script.py passes 1.0)
    scratch_iters: int = 30_000
    scratch_budget: int | None = 16384     # ScratchConfig.densify_budget;
                                            # None: every candidate, the
                                            # capacity grown in buckets
    finetune_iters: int = 5_000
    hvs_ft_iters: int = 5_000
    capacity_headroom: float = 1.3
    pair_capacity: int = 1 << 21
    chunk: int = 2048
    eval_views_cap: int = 25


def pooling_ladder(cfg: PipelineConfig) -> list[float]:
    """[1, 3, 7, 12] for the defaults (run_multi_ecc_masking.py:119-131)."""
    sq = cfg.max_pooling_size ** 0.5
    interval = (sq - 1) / (cfg.layer_num - 1)
    return [round((1 + i * interval) ** 2) for i in range(cfg.layer_num)]


def _log_to(path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = open(path, "a")

    def log(msg):
        stamp = time.strftime("%H:%M:%S")
        line = f"[{stamp}] {msg}"
        print(line, flush=True)
        f.write(line + "\n")
        f.flush()

    return log


def run_pipeline(source_path: str, out_dir: str,
                 pretrained_ply: str | None = None,
                 cfg: PipelineConfig = PipelineConfig(),
                 resolution: int = -1, loop_cfg: loops.LoopConfig | None = None,
                 small: bool = False, device=None):
    """Run the full MetaSapiens pipeline on one scene directory, on
    `device` (None: CUDA, raising without it)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    log = _log_to(os.path.join(out_dir, "log.txt"))
    scene = dataset.load_scene(source_path, resolution=resolution,
                               device=dev)
    log(f"scene: {len(scene.train_views)} train / {len(scene.test_views)} "
        f"test views, {len(scene.points)} points, "
        f"extent={scene.spatial_scale:.2f}")

    base_loop = loop_cfg or loops.LoopConfig(
        raster=RasterizeConfig(pair_capacity=cfg.pair_capacity,
                               chunk=cfg.chunk),
        spatial_lr_scale=scene.spatial_scale)

    def stage(name):
        return os.path.join(out_dir, f"{name}.npz")

    # ---- stage 0/1: base model ------------------------------------------
    base_path = stage("base")
    if os.path.exists(base_path):
        state, _, _ = ckpt.load(base_path, device=dev)
        log(f"[skip] base model exists ({int(state.live_count())} live)")
    else:
        if pretrained_ply:
            params, _ = G.load_ply(pretrained_ply, device=dev)
            capacity = int(params.num_points * 1.02)
            state = S.from_params(params, capacity=capacity)
            log(f"loaded pretrained ply: {params.num_points} gaussians")
            state = loops.finetune(state, scene.train_views,
                                   cfg.finetune_iters, base_loop,
                                   start_iter=30_000, log=log)
        else:
            params = G.create_from_points(scene.points, scene.colors,
                                          device=dev)
            scfg = scratch.ScratchConfig(iterations=cfg.scratch_iters,
                                         densify_budget=cfg.scratch_budget)
            if cfg.scratch_budget is None:
                capacity = scratch.capacity_bucket(len(scene.points))
            else:
                capacity = int(len(scene.points) * cfg.capacity_headroom * 8)
            state = S.from_params(params, capacity=capacity)
            log(f"from-scratch init: {params.num_points} gaussians, "
                f"capacity {capacity}")
            state = scratch.train_scratch(state, scene.train_views,
                                          base_loop, scfg,
                                          scene_extent=scene.spatial_scale,
                                          log=log)
        ckpt.save(base_path, state)

    eval_view, hvs_view = loops.make_eval_fns(base_loop)

    # ---- stage 2: efficiency-aware pruning -------------------------------
    pruned_path = stage("pruned")
    if os.path.exists(pruned_path):
        state, _, _ = ckpt.load(pruned_path, device=dev)
        log(f"[skip] pruned model exists ({int(state.live_count())} live)")
    else:
        ssim0, psnr0 = loops.evaluate(state, scene.test_views or
                                      scene.train_views, eval_view,
                                      max_views=cfg.eval_views_cap)
        t_ssim = ssim0 * (1 - cfg.target_relax)
        t_psnr = psnr0 * (1 - cfg.target_relax)
        log(f"prune targets: ssim>={t_ssim:.4f} psnr>={t_psnr:.2f} "
            f"(pretrain {ssim0:.4f}/{psnr0:.2f})")
        it = cfg.prune_iters if not small else 300
        p_it = int(it * cfg.prune_adapt_split)
        state = loops.prune_training(
            state, scene.train_views, scene.test_views, t_ssim, t_psnr,
            base_loop, iters=it, pruning_iters=p_it,
            prune_interval=1000 if not small else 50,
            eval_views_cap=cfg.eval_views_cap, log=log)
        ckpt.save(pruned_path, state)

    # ---- stage 3: HVS reshape at PS=1 ------------------------------------
    ps1_path = stage("ps1")
    if os.path.exists(ps1_path):
        ps1, _, _ = ckpt.load(ps1_path, device=dev)
        log(f"[skip] ps1 model exists")
    else:
        it = cfg.hvs_ft_iters if not small else 50
        ps1 = loops.finetune(state, scene.train_views, it, base_loop,
                             hvs_pooling=1, hvs_loss_type="L1", log=log)
        ckpt.save(ps1_path, ps1)
        ckpt.export_ply(os.path.join(out_dir, "point_cloud_ps1.ply"), ps1)

    # ---- stage 4: PS-mask layers ----------------------------------------
    ladder = pooling_ladder(cfg)
    layer_states = [ps1]
    per_layer_budget = cfg.masking_budget // (cfg.layer_num - 1)
    prev = ps1
    # Reference target semantics (run_multi_ecc_masking.py:108-112): ONE
    # absolute target for every layer = the PS1 model's uniform HVS at
    # pooling_size=1, times target_loss_scale (reference default 1.0) —
    # each layer's own-pooling HVS is tested against this same number
    # (metric_mask_learn.py:255). Round-4 used per-pooling relative
    # targets, a deviation (see artifacts/ladder_probe_r5.json).
    hvs_ps1 = np.mean([
        float(hvs_view(ps1, v.camera, loops.view_image(v, dev), 1.0))
        for v in (scene.test_views or scene.train_views)[:5]])
    target = float(hvs_ps1) * cfg.mask_target_scale
    log(f"masking target (PS1@1 x {cfg.mask_target_scale}): {target:.3e}")
    for i, ps in enumerate(ladder[1:], start=1):
        lp = stage(f"layer{i}_ps{ps}")
        if os.path.exists(lp):
            st, _, _ = ckpt.load(lp, device=dev)
            log(f"[skip] layer {i} exists ({int(st.live_count())} live)")
        else:
            it = per_layer_budget if not small else 40
            m_it = int(it * 0.8)
            st = loops.mask_training(
                prev, scene.train_views, float(ps), target, base_loop,
                iters=it, masking_iters=m_it,
                prune_interval=500 if not small else 16, log=log)
            ckpt.save(lp, st)
        layer_states.append(st)
        prev = st

    # ---- stage 5: compose ------------------------------------------------
    model = compose_mod.compose_layers(layer_states)
    compose_mod.save_composed(os.path.join(out_dir, "ours"), model)
    counts = compose_mod.layer_counts(layer_states)
    with open(os.path.join(out_dir, "pnum.txt"), "w") as f:
        f.write("\n".join(str(c) for c in counts))
    log(f"composed: layer counts {counts}")

    naive_hl = compose_mod.gen_naive_fr(ps1, counts)
    np.savez(os.path.join(out_dir, "naive_fr.npz"),
             highest_levels=naive_hl.cpu().numpy())
    log("pipeline complete")
    return model, layer_states
