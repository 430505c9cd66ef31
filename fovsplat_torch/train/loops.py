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

On the card the makers return their steps and views as CUDA graphs per
state capacity and camera shape (utils/graphs), the counterpart of the
JAX makers' jax.jit: make_photometric_step (eager body photometric_step),
make_hvs_step (hvs_step), make_eval_fns and make_score_fn. The steps are
functional: each returns a new TrainerState and leaves the old one as it
was, and so do the prune functions of models/state.py. So
a rollback snapshot is the state itself, where the JAX loops copy it to
host memory (loops.py:342-346). The control flow (the seeded view stack,
the gates, the scale-weight schedule, the per-cut re-gating) is the JAX
package's step for step. A loop runs on the device of the state it is
given. finetune serves a live viewer (eval/network_gui) when given one.
A step's stages run in profiling spans (utils/profiling.span), which a
CUDA graph's stage map reads: render (holding the frame's own spans),
loss, backward (autograd and the dead-gradient mask) and adam; a score
view's are ops/stats.rasterize_stats' (project, table, expand, sort,
gather, stats, reduce, compose), and a score pass adds max (the max over
views) and models/state.metric_prune's cut.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

import numpy as np
import torch

from fovsplat_torch.data.cameras import (TENSOR_FIELDS, camera_tensors,
                                         camera_with_tensors)
from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops import stats as stats_ops
from fovsplat_torch.ops.kernels import hvs_loss
from fovsplat_torch.perception import metameric
from fovsplat_torch.train import losses, optim
from fovsplat_torch.utils import graphs
from fovsplat_torch.utils.device import resolve_device
from fovsplat_torch.utils.profiling import span


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
                          p.get_opacity(), camera,
                          shs=(p.features_dc, p.features_rest),
                          sh_degree=cfg.sh_degree, bg_color=bg_color,
                          config=cfg.raster, live_mask=state.live)


def _gs_counts(binned, capacity: int):
    """Kept pairs per Gaussian ~ the reference's gs_count (one atomicAdd
    per fetched (tile, Gaussian) pair, forward.cu:361), from the sorted
    pair list's Gaussian ids up to num_pairs: ones added into a fixed
    capacity + 1 buffer, the last slot taking the lanes past num_pairs
    (bincount would read its length back to the host). Integer sums:
    exact, whatever the order."""
    lane = torch.arange(binned.pair_gauss.shape[0],
                        device=binned.pair_gauss.device)
    ids = torch.where(lane < binned.num_pairs, binned.pair_gauss.long(),
                      capacity)
    counts = torch.zeros(capacity + 1, dtype=torch.int64, device=ids.device)
    return counts.index_add_(0, ids, torch.ones_like(ids))[:capacity]


def _mask_dead_grads(grads: dict, live):
    """Zero dead-row and non-finite gradients; returns (grads, n_bad), where
    n_bad counts LIVE rows whose gradient had a non-finite component (a
    kernel bug must surface, not be absorbed: the step reports it).

    On the card n_bad counts only rows that received a cotangent: kernel
    10's backward (ops/kernels/project_sh) gives a row whose nine
    cotangents are zero zero gradients without recomputing it, where
    autograd of its plain twin, on the CPU, gives NaN to such a row when
    an intermediate is not finite (a Gaussian at the camera centre, a
    covariance that overflows). The masked gradients agree."""
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
        with span("render"):
            out = render_state(state, camera, cfg)
        with span("loss"):
            loss = loss_of(out)
        with span("backward"):
            g = torch.autograd.grad(loss, list(fields.values()))
    with span("backward"):
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


def photometric_step(state: S.TrainerState, camera, gt, it, scale_weight,
                     cfg: LoopConfig, use_scale_decay: bool = False):
    """One photometric step, the eager body of make_photometric_step's
    step: (new state, {loss, overflow, nonfinite, num_pairs}), the values
    0-d tensors on the state's device (not synchronised). `it` and
    `scale_weight` are python numbers or 0-d tensors there."""
    loss, grads, n_bad, out = photometric_grads(
        state, camera, gt, cfg, use_scale_decay, scale_weight)
    with span("adam"):
        lrs = optim.learning_rates(state.params, it, cfg.optim,
                                   cfg.spatial_lr_scale)
        params, opt = optim.apply_updates(state.params, grads, state.opt,
                                          lrs, cfg.optim)
    bn = out["binned"]
    return (dataclasses.replace(state, params=params, opt=opt),
            {"loss": loss, "overflow": bn.overflow, "nonfinite": n_bad,
             "num_pairs": bn.num_pairs})


def _state_tensors(state: S.TrainerState) -> tuple:
    """The parameters, first and second moments (FIELDS order each), the
    Adam count and the live mask."""
    p, o = state.params, state.opt
    return (*(getattr(p, f) for f in FIELDS), *(o.mu[f] for f in FIELDS),
            *(o.nu[f] for f in FIELDS), o.count, state.live)


def _state_of(ts) -> S.TrainerState:
    """_state_tensors' inverse."""
    k = len(FIELDS)
    return S.TrainerState(
        params=GaussianParams(**dict(zip(FIELDS, ts[:k]))),
        opt=optim.AdamState(mu=dict(zip(FIELDS, ts[k:2 * k])),
                            nu=dict(zip(FIELDS, ts[2 * k:3 * k])),
                            count=ts[3 * k]),
        live=ts[3 * k + 1])


def _params_state(ts) -> S.TrainerState:
    """A state of the parameters (FIELDS order) and the live mask, without
    Adam moments: what the views read."""
    return S.TrainerState(params=GaussianParams(**dict(zip(FIELDS, ts[:-1]))),
                          opt=None, live=ts[-1])


def _check_device(state: S.TrainerState, dev: torch.device):
    if state.params.xyz.device.type != dev.type:
        raise ValueError(f"state on {state.params.xyz.device}, step made "
                         f"for {dev}")


def _graph_step(graph, body, state: S.TrainerState, camera, gt, scalars,
                key=(), prepare=None):
    """body(state, camera, gt, *scalars) -> (new state, aux) through
    `graph`, keyed by the state capacity, the camera (width, height) and
    `key`: the parameters, moments, Adam count, live mask, camera
    tensors, ground truth and scalars are its static inputs. The new
    state's tensors are fresh; its live mask is the caller's."""
    n_state, n_cam = 3 * len(FIELDS) + 2, len(TENSOR_FIELDS)

    def run(*ts):
        new, aux = body(_state_of(ts[:n_state]),
                        camera_with_tensors(camera,
                                            ts[n_state:n_state + n_cam]),
                        *ts[n_state + n_cam:])
        return _state_tensors(new)[:-1], aux

    new, aux = graph((state.capacity, camera.width, camera.height, *key),
                     run, *_state_tensors(state), *camera_tensors(camera),
                     gt, *scalars, prepare=prepare)
    return _state_of((*new, state.live)), aux


def graphed_view(fn, device=None, n_static: int = 0, prepare=None):
    """fn(state, camera, *rest), a view without a gradient, as the view
    makers return it: for device "cpu" fn itself; else a callable that
    runs a state on the CPU through fn and a state on the card through a
    CUDA graph keyed by the state capacity and the camera (width, height)
    (the parameters, live mask, camera tensors and `rest` its static
    inputs; fn's state has no Adam moments), with attributes `graph` and
    `eager` (fn). The last n_static arguments of a call are static: they
    join the key and are never inputs (hvs_view's pooling size fixes its
    shapes, as JAX's static_argnums=(3,)). prepare(state, camera,
    *static) runs before a capture's warm-up."""
    if device is not None and resolve_device(device).type == "cpu":
        return fn
    graph = graphs.Graph()
    n_p, n_cam = len(FIELDS) + 1, len(TENSOR_FIELDS)

    def view(state: S.TrainerState, camera, *rest):
        if state.live.device.type == "cpu":
            return fn(state, camera, *rest)
        cut = len(rest) - n_static
        dyn, static = rest[:cut], rest[cut:]

        def run(*ts):
            return fn(_params_state(ts[:n_p]),
                      camera_with_tensors(camera, ts[n_p:n_p + n_cam]),
                      *ts[n_p + n_cam:], *static)

        return graph(
            (state.capacity, camera.width, camera.height, *static), run,
            *(getattr(state.params, f) for f in FIELDS), state.live,
            *camera_tensors(camera), *dyn,
            prepare=(lambda: prepare(state, camera, *static)) if prepare
            else None)

    view.graph = graph
    view.eager = fn
    return view


def make_photometric_step(cfg: LoopConfig, use_scale_decay: bool = False,
                          device=None):
    """The step function step(state, camera, gt, it, scale_weight) ->
    (new state, {loss, overflow, nonfinite, num_pairs}), the values 0-d
    tensors on the device (not synchronised). `device` None means CUDA
    and raises without it; pass "cpu" for the plain path.

    On the card the step is a CUDA graph per state capacity and camera
    (width, height) (utils/graphs.Graph): the parameters, moments, live
    mask, Adam count, camera tensors, ground truth, `it` and
    `scale_weight` are its static inputs, copied in each call, and the
    new state's tensors are fresh (the live mask is the caller's). The
    graphed step has attributes `graph` and `eager` (the eager step); on
    the CPU the eager step is returned."""
    dev = resolve_device(device)

    def eager(state: S.TrainerState, camera, gt, it, scale_weight=0.0):
        _check_device(state, dev)
        return photometric_step(state, camera, gt, it, scale_weight, cfg,
                                use_scale_decay)

    if dev.type == "cpu":
        return eager
    graph = graphs.Graph()

    def body(state, camera, gt, it, scale_weight):
        return photometric_step(state, camera, gt, it, scale_weight, cfg,
                                use_scale_decay)

    def step(state: S.TrainerState, camera, gt, it, scale_weight=0.0):
        _check_device(state, dev)
        return _graph_step(graph, body, state, camera, gt,
                           (it, scale_weight))

    step.graph = graph
    step.eager = eager
    return step


def hvs_grads(state: S.TrainerState, camera, gt, cfg: LoopConfig,
              pooling_size, loss_type: str = "L1"):
    """Uniform HVS loss and masked gradients of one view (the objective of
    loops.py:163-174): the ground truth's statistics are taken beside the
    render's, without a gradient (on the card kernel 11 takes both images
    as one batch). Returns (loss, grads, n_bad, render output)."""
    def loss_of(out):
        return hvs_loss.uniform_loss(out["render"], gt, pooling_size,
                                     cfg.hvs_levels, cfg.hvs_orientations,
                                     loss_type)
    return _loss_grads(state, camera, cfg, loss_of)


# Masking trains the DC colour and the opacity only
# (gaussian_renderer/__init__.py:71-82).
_MASKING_FREEZE = {f: f in ("features_dc", "opacity") for f in FIELDS}


def hvs_step(state: S.TrainerState, camera, gt, it, cfg: LoopConfig,
             pooling_size, loss_type: str = "L1", masking: bool = False):
    """One uniform-HVS step, the eager body of make_hvs_step's step: (new
    state, {loss, overflow, nonfinite, num_pairs}), the values 0-d tensors
    on the state's device (not synchronised). `it` is a python number or
    a 0-d tensor there. With masking the other four fields keep their
    tensors bit for bit and their Adam moments are zeroed."""
    loss, grads, n_bad, out = hvs_grads(state, camera, gt, cfg,
                                        pooling_size, loss_type)
    with span("adam"):
        lrs = optim.learning_rates(state.params, it, cfg.optim,
                                   cfg.spatial_lr_scale)
        params, opt = optim.apply_updates(
            state.params, grads, state.opt, lrs, cfg.optim,
            freeze_mask=_MASKING_FREEZE if masking else None)
    bn = out["binned"]
    return (dataclasses.replace(state, params=params, opt=opt),
            {"loss": loss, "overflow": bn.overflow, "nonfinite": n_bad,
             "num_pairs": bn.num_pairs})


def _prepare_hvs(cfg: LoopConfig, camera, pooling_size, device):
    """Fill the HVS loss's tables and filters for this camera and pooling
    size (metameric.prepare): a graph's prepare callback."""
    metameric.prepare(camera.height, camera.width, pooling_size,
                      cfg.hvs_levels, cfg.hvs_orientations, device)


def make_hvs_step(cfg: LoopConfig, pooling_size, loss_type: str = "L1",
                  masking: bool = False, device=None):
    """The step function step(state, camera, gt, it) -> (new state, {loss,
    overflow, nonfinite, num_pairs}) of the uniform HVS loss at
    `pooling_size` (hvs_step), the values 0-d tensors on the device.
    `device` as make_photometric_step's.

    On the card the step is a CUDA graph per state capacity and camera
    (width, height), as make_photometric_step's, with `it` a 0-d input;
    pooling_size, loss_type and masking are fixed here. Before a capture
    the loss's tables and filters for the camera are filled
    (metameric.prepare). With masking the frozen fields come back as
    fresh tensors equal to the given ones. The graphed step has
    attributes `graph` and `eager`; on the CPU the eager step is
    returned."""
    dev = resolve_device(device)

    def body(state, camera, gt, it):
        return hvs_step(state, camera, gt, it, cfg, pooling_size, loss_type,
                        masking)

    def eager(state: S.TrainerState, camera, gt, it):
        _check_device(state, dev)
        return body(state, camera, gt, it)

    if dev.type == "cpu":
        return eager
    graph = graphs.Graph()

    def step(state: S.TrainerState, camera, gt, it):
        _check_device(state, dev)
        return _graph_step(graph, body, state, camera, gt, (it,),
                           prepare=lambda: _prepare_hvs(
                               cfg, camera, pooling_size, gt.device))

    step.graph = graph
    step.eager = eager
    return step


def make_eval_fns(cfg: LoopConfig, device=None):
    """(eval_view(state, camera, gt) -> {ssim, psnr}, hvs_view(state,
    camera, gt, pooling_size) -> HVS MSE), 0-d tensors, no gradient.

    Unless `device` is "cpu" (then the eager functions), each runs a state
    on the card through a CUDA graph per state capacity and camera
    (width, height) (graphed_view), hvs_view one per pooling size too:
    the pooling size fixes its shapes, so it is part of the key and not
    an input. A state on the CPU runs eagerly."""
    @torch.no_grad()
    def eval_view(state, camera, gt):
        img = torch.clamp(render_state(state, camera, cfg)["render"], 0.0,
                          1.0)
        # robust=True: a quality gate must be bounded (losses.ssim).
        return {"ssim": losses.ssim(img, gt, robust=True),
                "psnr": losses.psnr(img, gt)}

    @torch.no_grad()
    def hvs_view(state, camera, gt, pooling_size):
        img = torch.clamp(render_state(state, camera, cfg)["render"], 0.0,
                          1.0)
        return hvs_loss.uniform_loss(img, gt, pooling_size, cfg.hvs_levels,
                                     cfg.hvs_orientations, "MSE")

    def prepare(state, camera, pooling_size):
        _prepare_hvs(cfg, camera, pooling_size, state.live.device)

    return (graphed_view(eval_view, device),
            graphed_view(hvs_view, device, n_static=1, prepare=prepare))


def make_score_fn(cfg: LoopConfig, metric: str = "max_comp_efficiency",
                  device=None):
    """score_view(state, camera) -> (scores (C,), overflow ()): the
    per-Gaussian metric of one view (metric_pruning's inner body,
    prune.py:79-97), "max_comp_efficiency" (pixels won / fetched pairs),
    "max_contrib" (the largest alpha * T) or "surface" (pixels won), and
    the view's pairs past the capacities (Binned.overflow: a view that
    spills scores a cut pair list). Its stage project is the activations
    in torch and kernel 10's forward (rasterize_stats), which reads the
    model's SH pair in place. Unless `device` is "cpu" (then the eager
    function), a state on the card runs through a CUDA graph per state
    capacity and camera (width, height) (graphed_view), kernels 10, 8
    and the reductions inside; a state on the CPU runs eagerly."""
    mode = "max" if metric == "max_contrib" else "loss_weighted_max_count"

    def score_view(state: S.TrainerState, camera):
        p = state.params
        with span("project"):
            acts = (p.get_scaling(), p.get_rotation(), p.get_opacity())
        with span("stats"):
            loss_map = torch.ones((camera.height, camera.width),
                                  dtype=torch.float32, device=p.xyz.device)
        out = stats_ops.rasterize_stats(
            p.xyz, *acts, camera, shs=(p.features_dc, p.features_rest),
            sh_degree=cfg.sh_degree, mode=mode, loss_map=loss_map,
            config=cfg.raster, live_mask=state.live)
        scores = out["contribs"]
        if metric == "max_comp_efficiency":
            with span("reduce"):
                gs = out["gs_count"]
                s = scores / (gs.to(torch.float32) + 1e-7)
                scores = torch.where(gs >= 1, s, torch.zeros_like(s))
        return scores, out["binned"].overflow

    return graphed_view(score_view, device)


def metric_prune_scores(state, views, score_view):
    """Max over views of the per-view metric (prune.py:86) and the views'
    overflow summed: (scores (C,) f32, overflow () i64), not
    synchronised."""
    dev = state.live.device
    with span("max"):
        scores = torch.zeros(state.capacity, dtype=torch.float32, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for v in views:
        s, ovf = score_view(state, v.camera)
        with span("max"):
            scores = torch.maximum(scores, s)
            overflow = overflow + ovf
    return scores, overflow


class ScoreWatch:
    """Runs the score passes of the prune and mask loops and counts those
    whose views overflowed: each is logged, and still cuts on the scores
    of the pairs that fit (the loops do not cut on the count). `passes`
    and `overflowed` count the passes and the overflowing ones."""

    def __init__(self, views, score_view, log: Callable):
        self._views, self._score_view, self._log = views, score_view, log
        self.passes = 0
        self.overflowed = 0

    def scores(self, state: S.TrainerState):
        scores, overflow = metric_prune_scores(state, self._views,
                                               self._score_view)
        self.passes += 1
        ovf = int(overflow)
        if ovf:
            self.overflowed += 1
            self._log(f"[warn] score pass {self.passes} overflowed: {ovf} "
                      f"pairs past the capacities over {len(self._views)} "
                      f"views (overflowed passes: {self.overflowed})")
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
    eval_view, _ = make_eval_fns(cfg, device=dev)
    watch_scores = ScoreWatch(train_views, make_score_fn(cfg, metric,
                                                         device=dev), log)

    def run_eval(st):
        return evaluate(st, test_views or train_views, eval_view,
                        max_views=eval_views_cap)

    def passes(st):
        c_ssim, c_psnr = run_eval(st)
        return c_ssim >= target_ssim and c_psnr >= target_psnr, c_ssim, \
            c_psnr

    def do_metric_prunes(st, times):
        for _ in range(times):
            cand = S.metric_prune(st, watch_scores.scores(st), prune_ratio)
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
                cand = S.metric_prune(state, watch_scores.scores(state),
                                      prune_ratio)
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
    _, hvs_view = make_eval_fns(cfg, device=dev)
    watch_scores = ScoreWatch(train_views, make_score_fn(cfg, "surface",
                                                         device=dev), log)

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
                    cand = S.metric_prune(state, watch_scores.scores(state),
                                          prune_ratio)
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
