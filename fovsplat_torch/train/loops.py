"""Training loops: the photometric and HVS steps, efficiency-aware
pruning and PS-mask learning (counterpart of fovsplat/train/loops.py).

  make_photometric_step  render through rasterize's fused train route,
                      loss = (1 - lambda) * L1 + lambda * (1 - SSIM) (plus
                      the optional scale-decay term), backward, masking of
                      dead and non-finite gradients, per-group Adam;
  make_hvs_step       the same with the uniform metameric loss; with
                      masking only DC-SH and opacity move;
  finetune            eff_finetune.py training(), photometric or HVS;
  prune_training      prune.py training(): quality-gated metric pruning
                      with current-best rollback, the scale-decay loss,
                      opacity pruning, reset_opacity_max(0.1);
  mask_training       metric_mask_learn.py training(): HVS(L1) at one
                      pooling size, DC-SH and opacity trainable,
                      HVS-gated "surface" pruning.

The steps are functional: each returns a new TrainerState and leaves the
old one as it was, and so do the prune functions of models/state.py. So
a rollback snapshot is the state itself, where the JAX loops copy it to
host memory (loops.py:342-346). The control flow (the seeded view stack,
the gates, the scale-weight schedule, the per-cut re-gating) is the JAX
package's step for step. A loop runs on the device of the state it is
given. finetune serves a live viewer (eval/network_gui) when given one.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

import numpy as np
import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import FIELDS
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops import stats as stats_ops
from fovsplat_torch.perception import metameric
from fovsplat_torch.train import losses, optim
from fovsplat_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    raster: rast.RasterizeConfig = rast.RasterizeConfig()
    optim: optim.OptimConfig = optim.OptimConfig()
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    spatial_lr_scale: float = 1.0
    # HVS loss settings (5 levels and 6 orientations everywhere in the
    # reference).
    hvs_levels: int = 5
    hvs_orientations: int = 6


def render_state(state: S.TrainerState, camera, cfg: LoopConfig,
                 bg_color=None):
    p = state.params
    return rast.rasterize(p.xyz, p.get_scaling(), p.get_rotation(),
                          p.get_opacity(), camera, shs=p.get_features(),
                          sh_degree=cfg.sh_degree, bg_color=bg_color,
                          config=cfg.raster, live_mask=state.live)


def _gs_counts(binned, capacity: int):
    """Kept pairs per Gaussian ~ the reference's gs_count (one atomicAdd
    per fetched (tile, Gaussian) pair, forward.cu:361), from the sorted
    pair list's Gaussian ids up to num_pairs."""
    lane = torch.arange(binned.pair_gauss.shape[0],
                        device=binned.pair_gauss.device)
    ids = torch.where(lane < binned.num_pairs, binned.pair_gauss.long(),
                      capacity)
    return torch.bincount(ids, minlength=capacity + 1)[:capacity]


def _mask_dead_grads(grads: dict, live):
    """Zero dead-row and non-finite gradients; returns (grads, n_bad), where
    n_bad counts LIVE rows whose gradient had a non-finite component (a
    kernel bug must surface, not be absorbed: the step reports it)."""
    bad = torch.zeros_like(live)
    out = {}
    for f, g in grads.items():
        fin = torch.isfinite(g)
        bad = bad | (live & ~fin.reshape(live.shape[0], -1).all(1))
        lv = live.reshape(live.shape + (1,) * (g.dim() - 1))
        out[f] = torch.where(lv & fin, g, torch.zeros_like(g))
    return out, bad.sum().to(torch.int32)


class NanWatch:
    """Surfaces _mask_dead_grads' live-row non-finite counter. Reads each
    step's counter one step late, so the host read does not stall the
    card's queue."""

    def __init__(self, log: Callable):
        self.total = 0
        self.events = 0
        self._log = log
        self._prev = None

    def push(self, aux):
        prev, self._prev = self._prev, aux
        if prev is not None:
            self._read(prev)

    def _read(self, aux):
        nb = int(aux.get("nonfinite", 0))
        if nb:
            self.total += nb
            self.events += 1
            self._log(f"[warn] non-finite grads zeroed on {nb} LIVE rows "
                      f"(event {self.events}, cum rows {self.total}) - "
                      f"possible blend-backward overflow")

    def flush(self):
        if self._prev is not None:
            self._read(self._prev)
            self._prev = None


def _loss_grads(state: S.TrainerState, camera, cfg: LoopConfig, loss_of):
    """Render one view, loss = loss_of(render output), and the masked
    gradients: returns (loss, grads {field: tensor}, n_bad, output)."""
    fields = state.params.fields()
    with torch.enable_grad():
        out = render_state(state, camera, cfg)
        loss = loss_of(out)
        g = torch.autograd.grad(loss, list(fields.values()))
    grads, n_bad = _mask_dead_grads(dict(zip(fields, g)), state.live)
    return loss.detach(), grads, n_bad, out


def photometric_grads(state: S.TrainerState, camera, gt, cfg: LoopConfig,
                      use_scale_decay: bool = False, scale_weight=0.0):
    """Loss and masked gradients of one view: returns (loss, grads {field:
    tensor}, n_bad, render output)."""
    def loss_of(out):
        loss = losses.photometric_loss(out["render"], gt, cfg.lambda_dssim)
        if use_scale_decay:
            # prune.py:257-261: + w * mean(max_scale * (gs_count - 4)
            # * [gs_count > 4]) over live rows.
            gs_count = _gs_counts(out["binned"], state.capacity)
            scale_max = state.params.get_scaling().amax(1)
            term = scale_max * (gs_count - 4) * (gs_count > 4) * state.live
            n_live = torch.clamp(state.live.sum(), min=1)
            loss = loss + scale_weight * term.sum() / n_live
        return loss
    return _loss_grads(state, camera, cfg, loss_of)


def make_photometric_step(cfg: LoopConfig, use_scale_decay: bool = False,
                          device=None):
    """The step function step(state, camera, gt, it, scale_weight) ->
    (new state, {loss, overflow, nonfinite, num_pairs}), the values 0-d
    tensors on the device (not synchronised). `device` None means CUDA
    and raises without it; pass "cpu" for the plain path."""
    dev = resolve_device(device)

    def step(state: S.TrainerState, camera, gt, it, scale_weight=0.0):
        if state.params.xyz.device.type != dev.type:
            raise ValueError(f"state on {state.params.xyz.device}, step "
                             f"made for {dev}")
        loss, grads, n_bad, out = photometric_grads(
            state, camera, gt, cfg, use_scale_decay, scale_weight)
        lrs = optim.learning_rates(state.params, it, cfg.optim,
                                   cfg.spatial_lr_scale)
        params, opt = optim.apply_updates(state.params, grads, state.opt,
                                          lrs, cfg.optim)
        bn = out["binned"]
        return (dataclasses.replace(state, params=params, opt=opt),
                {"loss": loss, "overflow": bn.overflow, "nonfinite": n_bad,
                 "num_pairs": bn.num_pairs})

    return step


def hvs_grads(state: S.TrainerState, camera, gt, cfg: LoopConfig,
              pooling_size, loss_type: str = "L1"):
    """Uniform HVS loss and masked gradients of one view (the objective of
    loops.py:163-174): the ground truth's statistics are taken once,
    without a gradient. Returns (loss, grads, n_bad, render output)."""
    with torch.no_grad():
        gt_stats = metameric.statsmaps(
            metameric.resize_for_pyramid(gt, cfg.hvs_levels), pooling_size,
            cfg.hvs_levels, cfg.hvs_orientations)

    def loss_of(out):
        img = metameric.resize_for_pyramid(out["render"], cfg.hvs_levels)
        return metameric.metameric_loss_uniform(
            img, None, pooling_size, cfg.hvs_levels, cfg.hvs_orientations,
            loss_type, target_stats=gt_stats)
    return _loss_grads(state, camera, cfg, loss_of)


# Masking trains the DC colour and the opacity only
# (gaussian_renderer/__init__.py:71-82).
_MASKING_FREEZE = {f: f in ("features_dc", "opacity") for f in FIELDS}


def make_hvs_step(cfg: LoopConfig, pooling_size, loss_type: str = "L1",
                  masking: bool = False, device=None):
    """The step function step(state, camera, gt, it) -> (new state, {loss,
    overflow, nonfinite, num_pairs}) of the uniform HVS loss at
    `pooling_size`, the values 0-d tensors on the device. With masking
    the other four fields keep their tensors bit for bit and their Adam
    moments are zeroed. `device` as make_photometric_step's."""
    dev = resolve_device(device)
    freeze = _MASKING_FREEZE if masking else None

    def step(state: S.TrainerState, camera, gt, it):
        if state.params.xyz.device.type != dev.type:
            raise ValueError(f"state on {state.params.xyz.device}, step "
                             f"made for {dev}")
        loss, grads, n_bad, out = hvs_grads(state, camera, gt, cfg,
                                            pooling_size, loss_type)
        lrs = optim.learning_rates(state.params, it, cfg.optim,
                                   cfg.spatial_lr_scale)
        params, opt = optim.apply_updates(state.params, grads, state.opt,
                                          lrs, cfg.optim, freeze_mask=freeze)
        bn = out["binned"]
        return (dataclasses.replace(state, params=params, opt=opt),
                {"loss": loss, "overflow": bn.overflow, "nonfinite": n_bad,
                 "num_pairs": bn.num_pairs})

    return step


def make_eval_fns(cfg: LoopConfig):
    """(eval_view(state, camera, gt) -> {ssim, psnr}, hvs_view(state,
    camera, gt, pooling_size) -> HVS MSE), 0-d tensors, no gradient."""
    @torch.no_grad()
    def eval_view(state, camera, gt):
        img = torch.clamp(render_state(state, camera, cfg)["render"], 0.0,
                          1.0)
        # robust=True: a quality gate must be bounded (losses.ssim).
        return {"ssim": losses.ssim(img, gt, robust=True),
                "psnr": losses.psnr(img, gt)}

    @torch.no_grad()
    def hvs_view(state, camera, gt, pooling_size):
        img = metameric.resize_for_pyramid(torch.clamp(
            render_state(state, camera, cfg)["render"], 0.0, 1.0),
            cfg.hvs_levels)
        gt_r = metameric.resize_for_pyramid(gt, cfg.hvs_levels)
        return metameric.metameric_loss_uniform(
            img, gt_r, pooling_size, cfg.hvs_levels, cfg.hvs_orientations,
            "MSE")

    return eval_view, hvs_view


def make_score_fn(cfg: LoopConfig, metric: str = "max_comp_efficiency"):
    """score_view(state, camera) -> (C,) per-Gaussian metric of one view
    (metric_pruning's inner body, prune.py:79-97): "max_comp_efficiency"
    (pixels won / fetched pairs), "max_contrib" (the largest alpha * T)
    or "surface" (pixels won)."""
    mode = "max" if metric == "max_contrib" else "loss_weighted_max_count"

    def score_view(state: S.TrainerState, camera):
        p = state.params
        loss_map = torch.ones((camera.height, camera.width),
                              dtype=torch.float32, device=p.xyz.device)
        out = stats_ops.rasterize_stats(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(),
            camera, shs=p.get_features(), sh_degree=cfg.sh_degree,
            mode=mode, loss_map=loss_map, config=cfg.raster,
            live_mask=state.live)
        contribs = out["contribs"]
        if metric == "max_comp_efficiency":
            gs = out["gs_count"]
            s = contribs / (gs.to(torch.float32) + 1e-7)
            return torch.where(gs >= 1, s, torch.zeros_like(s))
        return contribs

    return score_view


def metric_prune_scores(state, views, score_view):
    """Max over views of the per-view metric (prune.py:86)."""
    scores = torch.zeros(state.capacity, dtype=torch.float32,
                         device=state.live.device)
    for v in views:
        scores = torch.maximum(scores, score_view(state, v.camera))
    return scores


def view_image(v, device):
    """A view's ground truth (H, W, 3) f32 on `device` (no copy when it is
    there already)."""
    return torch.as_tensor(v.image, dtype=torch.float32, device=device)


def evaluate(state, views, eval_view, max_views=None):
    """Mean SSIM and PSNR over the first max_views views (all if None)."""
    ssims, psnrs = [], []
    dev = state.live.device
    for v in views[:max_views]:
        m = eval_view(state, v.camera, view_image(v, dev))
        ssims.append(float(m["ssim"]))
        psnrs.append(float(m["psnr"]))
    return float(np.mean(ssims)), float(np.mean(psnrs))


class _ViewStack:
    """The reference's view stack: a fresh random.Random(seed) shuffle of
    the views each time it runs out, popped from the end."""

    def __init__(self, views, seed: int):
        self._views = views
        self._rng = random.Random(seed)
        self._stack = []

    def pop(self):
        if not self._stack:
            self._stack = list(self._views)
            self._rng.shuffle(self._stack)
        return self._stack.pop()


def _viewer_render(state, cam, cfg):
    with torch.no_grad():
        return torch.clamp(render_state(state, cam, cfg)["render"], 0.0,
                           1.0)


def finetune(state: S.TrainerState, views: Sequence, iters: int,
             cfg: LoopConfig, start_iter: int = 0, hvs_pooling=None,
             hvs_loss_type: str = "L1", log: Callable = print,
             log_every: int = 200, seed: int = 0, gui=None,
             source_path: str = ""):
    """eff_finetune.py: photometric, or uniform-HVS with hvs_pooling.

    gui: an eval/network_gui.NetworkGUI, polled once an iteration before
    the step with a render of the current state clipped to [0, 1], where
    the reference serves its viewer in the fine-tune loop
    (eff_finetune.py:77-90); source_path is its verify string."""
    dev = state.live.device
    if hvs_pooling is None:
        step_fn = make_photometric_step(cfg, device=dev)

        def call(state, v, it):
            return step_fn(state, v.camera, view_image(v, dev), it, 0.0)
    else:
        step_fn = make_hvs_step(cfg, hvs_pooling, hvs_loss_type, device=dev)

        def call(state, v, it):
            return step_fn(state, v.camera, view_image(v, dev), it)

    stack = _ViewStack(views, seed)
    ema = None
    watch = NanWatch(log)
    for it in range(start_iter + 1, start_iter + iters + 1):
        if gui is not None:
            gui.serve_step(lambda cam: _viewer_render(state, cam, cfg),
                           source_path)
        state, aux = call(state, stack.pop(), it)
        watch.push(aux)
        loss = float(aux["loss"])
        ema = loss if ema is None else 0.6 * ema + 0.4 * loss
        if it % log_every == 0:
            log(f"[finetune] it={it} ema_loss={ema:.5f} "
                f"live={int(state.live_count())}")
    watch.flush()
    return state


def prune_training(state: S.TrainerState, train_views, test_views,
                   target_ssim: float, target_psnr: float, cfg: LoopConfig,
                   iters: int = 50_000, pruning_iters: int = 45_000,
                   prune_interval: int = 1000, prune_ratio: float = 0.02,
                   per_prune_times: int = 5, use_scale_decay: bool = True,
                   metric: str = "max_comp_efficiency",
                   start_iter: int = 0, log: Callable = print, seed: int = 0,
                   final_prune_rounds: int = 5, eval_views_cap: int = 25):
    """Efficiency-aware pruning (prune.py training()). As the JAX loop
    (loops.py:298-416), each prune_ratio cut of an event is re-gated on
    its own and the last state that passes is kept; at pruning_iters the
    state rolls back to the best one if below target, then keeps pruning
    (with a short adapt window) until the gate binds or
    final_prune_rounds run out."""
    dev = state.live.device
    step_fn = make_photometric_step(cfg, use_scale_decay=use_scale_decay,
                                    device=dev)
    eval_view, _ = make_eval_fns(cfg)
    score_view = make_score_fn(cfg, metric)

    def run_eval(st):
        return evaluate(st, test_views or train_views, eval_view,
                        max_views=eval_views_cap)

    def passes(st):
        c_ssim, c_psnr = run_eval(st)
        return c_ssim >= target_ssim and c_psnr >= target_psnr, c_ssim, \
            c_psnr

    def do_metric_prunes(st, times):
        for _ in range(times):
            cand = S.metric_prune(
                st, metric_prune_scores(st, train_views, score_view),
                prune_ratio)
            if not passes(cand)[0]:
                break
            st = cand
        return st

    stack = _ViewStack(train_views, seed)
    scale_weight = 2e-6 if use_scale_decay else 0.0
    best = None   # the current-best state for the rollback
    watch = NanWatch(log)

    for it in range(start_iter + 1, start_iter + iters + 1):
        v = stack.pop()
        state, aux = step_fn(state, v.camera, view_image(v, dev), it,
                             scale_weight)
        watch.push(aux)

        rel = it - start_iter
        if rel % prune_interval == 1 and rel < pruning_iters:
            state = S.opacity_prune(state, 0.005)
            ok, t_ssim, t_psnr = passes(state)
            log(f"[prune] it={it} live={int(state.live_count())} "
                f"ssim={t_ssim:.4f} psnr={t_psnr:.3f} sw={scale_weight:.2e}")
            if ok:
                best = state
                state = do_metric_prunes(state, per_prune_times)
                scale_weight = max(scale_weight * 3, 1e-4) \
                    if use_scale_decay else 0.0
                state = S.reset_opacity_max(state, 0.1)
                log(f"[prune] it={it} pass -> pruned to "
                    f"{int(state.live_count())}")
            else:
                scale_weight = scale_weight / 3
                if scale_weight < 1e-4:
                    scale_weight = 0.0
                log(f"[prune] it={it} FAIL gates, skip pruning")

        if rel == pruning_iters:
            # Final gate (prune.py:326-356): roll back to the best state if
            # below target, then prune until the gate binds.
            if not passes(state)[0] and best is not None:
                log(f"[prune] it={it} below target, rollback to best")
                state = best
            adapt_iters = max(prune_interval // 10, 25)
            for _ in range(final_prune_rounds):
                cand = S.metric_prune(
                    state, metric_prune_scores(state, train_views,
                                               score_view), prune_ratio)
                for ai in range(adapt_iters):
                    va = stack.pop()
                    cand, aux = step_fn(cand, va.camera,
                                        view_image(va, dev), it + ai, 0.0)
                    watch.push(aux)
                ok, c_ssim, c_psnr = passes(cand)
                if ok:
                    state = cand
                    log(f"[prune] final prune kept: live="
                        f"{int(state.live_count())} ssim={c_ssim:.4f} "
                        f"psnr={c_psnr:.2f}")
                else:
                    log(f"[prune] final prune rejected (ssim={c_ssim:.4f} "
                        f"psnr={c_psnr:.2f}) - gate binds")
                    break

    watch.flush()
    return S.opacity_prune(state, 0.005)


def mask_training(state: S.TrainerState, train_views, pooling_size: float,
                  target_hvs: float, cfg: LoopConfig, iters: int = 7500,
                  masking_iters: int = 6000, prune_interval: int = 500,
                  prune_ratio: float = 0.02, per_prune_times: int = 5,
                  start_iter: int = 0, log: Callable = print, seed: int = 0,
                  eval_views_cap: int = 10):
    """PS-mask learning (metric_mask_learn.py training(); loops.py:
    419-486): HVS(L1) at `pooling_size` with DC-SH and opacity trainable,
    "surface" pruning gated on the HVS(MSE) target with per-cut re-gating
    and a rollback to the best state at the end."""
    dev = state.live.device
    step_fn = make_hvs_step(cfg, pooling_size, "L1", masking=True,
                            device=dev)
    _, hvs_view = make_eval_fns(cfg)
    score_view = make_score_fn(cfg, "surface")

    def run_hvs(st):
        return float(np.mean([
            float(hvs_view(st, v.camera, view_image(v, dev),
                           float(pooling_size)))
            for v in train_views[:eval_views_cap]]))

    stack = _ViewStack(train_views, seed)
    best = None
    watch = NanWatch(log)

    for it in range(start_iter + 1, start_iter + iters + 1):
        v = stack.pop()
        state, aux = step_fn(state, v.camera, view_image(v, dev), it)
        watch.push(aux)

        rel = it - start_iter
        if rel % prune_interval == 1 and rel < masking_iters:
            state = S.opacity_prune(state, 0.005)
            hvs = run_hvs(state)
            log(f"[mask ps={pooling_size}] it={it} "
                f"live={int(state.live_count())} hvs={hvs:.3e} "
                f"target={target_hvs:.3e}")
            if hvs <= target_hvs:
                best = state
                for _ in range(per_prune_times):
                    cand = S.metric_prune(
                        state, metric_prune_scores(state, train_views,
                                                   score_view), prune_ratio)
                    if run_hvs(cand) > target_hvs:
                        break
                    state = best = cand
                state = S.reset_opacity_max(state, 0.1)
                log(f"[mask] pruned to {int(state.live_count())} "
                    f"(per-prune gated)")

    watch.flush()
    hvs = run_hvs(state)
    if hvs > target_hvs and best is not None:
        log(f"[mask] final hvs {hvs:.3e} above target, rollback")
        state = best
    return state
