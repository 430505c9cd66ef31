"""From-scratch 3DGS training with densification (counterpart of
fovsplat/train/scratch.py).

Counterpart of LightGaussian/train_densify_prune.py (and the stock Inria
trainer it extends): photometric loss, clone/split densification every 100
iters in [500, 15000), opacity resets every 3000, optional
global-significance prune rounds (LightGaussian, at 16k/24k by default),
progressive SH degree (oneupSHdegree every 1000 iters).

The step renders through rasterize's fused train route (kernels 4-7) with
a zero mean2d_offset whose gradient feeds the densification statistics.
The global-significance scores run the count_opacity stats pass (kernel
8). On the card the step and the significance pass's view are CUDA
graphs (utils/graphs), the counterpart of the JAX package's jax.jit
(scratch.py:71 and :96): the step one per state capacity, camera (width,
height) and active SH degree, which picks the SH coefficients (a 30k run
captures once a degree). scratch_step is the step's eager body; its
stages run in the spans render, loss, backward, adam and stats (the
statistics' accumulate).

A densify event (densify_event: clone, split, the size prune, the
statistics' reset) takes one of two forms. With a densify_budget, the
JAX package's: at most that many candidates placed into dead rows, the
capacity kept, so it captures nothing. With densify_budget None, the
reference's: every candidate cloned or split, the state grown to the
next capacity bucket (capacity_bucket) when its dead rows cannot hold
the new rows, the statistics in the reference's NDC scale, so that the
published threshold 2e-4 holds, and reset before the size prune reads
them, as the published densification_postfix resets them, so that the
screen-size rule never fires; a new capacity is a new key, so the step
captures once a bucket. Its stages run in the spans
densify/grow, densify/clone, densify/split, densify/prune and
densify/reset. The split's normal samples are drawn from a
torch.Generator on the state's device, seeded from `seed`, in place of
the JAX package's key chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from fovsplat_torch.models import densify as D
from fovsplat_torch.models import state as S
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops import stats as stats_ops
from fovsplat_torch.train import loops, losses, optim
from fovsplat_torch.utils import graphs
from fovsplat_torch.utils.device import resolve_device
from fovsplat_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ScratchConfig:
    iterations: int = 30_000
    densify_from: int = 500
    densify_until: int = 15_000
    densify_every: int = 100
    densify_grad_threshold: float = 2e-4
    opacity_reset_every: int = 3_000
    percent_dense: float = 0.01
    sh_up_every: int = 1_000
    prune_iterations: tuple = ()          # LightGaussian: (16_000, 24_000)
    prune_percent: float = 0.1
    prune_decay: float = 0.6
    v_pow: float = 0.1
    # None: the reference's rule (every candidate, the capacity grown in
    # buckets, NDC statistics); an int: the JAX package's budgeted event.
    densify_budget: int | None = 16384


# The buckets' step, in rows; a new bucket holds an eighth more rows than
# it must, so that the next events' rows fit before the capacity grows
# again.
CAPACITY_QUANTUM = 1 << 20
CAPACITY_HEADROOM = 1.125


def capacity_bucket(rows: int) -> int:
    """The capacity that holds `rows`: the smallest multiple of
    CAPACITY_QUANTUM at or above CAPACITY_HEADROOM * rows."""
    q = CAPACITY_QUANTUM
    return -(-math.ceil(CAPACITY_HEADROOM * rows) // q) * q


def scratch_step(state: S.TrainerState, dstats: D.DensifyStats, camera,
                 gt, it, sh_degree: int, cfg: loops.LoopConfig,
                 scfg: ScratchConfig = ScratchConfig()):
    """One from-scratch step, the eager body of make_scratch_step's step:
    (new state, new dstats, {loss, nonfinite, overflow, num_pairs}), the
    values 0-d tensors on the state's device (not synchronised). `it` is
    a python number or a 0-d tensor there. The statistics take the scale
    of scfg's densify event: the reference's NDC gradient with no budget,
    the JAX package's scale with one (D.accumulate). Raises ValueError
    for a capacity or kept capacity of 2^24 or more: the pair rows carry
    Gaussian ids as exact f32 integers."""
    cap = max(state.capacity, cfg.raster.kept_capacity())
    if cap >= stats_ops.GID_EXACT:
        raise ValueError(
            f"the scratch step's pair rows carry Gaussian ids as f32, exact "
            f"below {stats_ops.GID_EXACT}; got a capacity of "
            f"{state.capacity} and a kept capacity of "
            f"{cfg.raster.kept_capacity()}")
    p = state.params
    fields = p.fields()
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32,
                         device=p.xyz.device, requires_grad=True)
    with torch.enable_grad():
        with span("render"):
            out = rast.rasterize(p.xyz, p.get_scaling(), p.get_rotation(),
                                 p.get_opacity(), camera,
                                 shs=(p.features_dc, p.features_rest),
                                 sh_degree=sh_degree, config=cfg.raster,
                                 live_mask=state.live, mean2d_offset=offset)
        with span("loss"):
            loss = losses.photometric_loss(out["render"], gt,
                                           cfg.lambda_dssim)
        with span("backward"):
            g = torch.autograd.grad(loss, [*fields.values(), offset])
    with span("backward"):
        grads, n_bad = loops._mask_dead_grads(dict(zip(fields, g[:-1])),
                                              state.live)
    with span("adam"):
        lrs = optim.learning_rates(p, it, cfg.optim, cfg.spatial_lr_scale)
        params, opt = optim.apply_updates(p, grads, state.opt, lrs,
                                          cfg.optim)
    with span("stats"):
        dstats = D.accumulate(dstats, g[-1], out["radii"], camera.width,
                              camera.height,
                              ndc=scfg.densify_budget is None)
    bn = out["binned"]
    return (dataclasses.replace(state, params=params, opt=opt), dstats,
            {"loss": loss.detach(), "nonfinite": n_bad,
             "overflow": bn.overflow, "num_pairs": bn.num_pairs})


def make_scratch_step(cfg: loops.LoopConfig, device=None,
                      scfg: ScratchConfig = ScratchConfig()):
    """step(state, dstats, camera, gt, it, sh_degree) -> (new state, new
    dstats, {loss, nonfinite, overflow, num_pairs}) (scratch_step, the
    statistics in the scale of scfg's densify event), the values 0-d
    tensors on the device (not synchronised). `device` None means CUDA
    and raises without it; pass "cpu" for the plain path.

    On the card the step is a CUDA graph per state capacity, camera
    (width, height) and sh_degree: the state's tensors, the DensifyStats
    tensors, the camera tensors, the ground truth and `it` are its static
    inputs, and the new state and statistics come back as fresh tensors
    (the live mask is the caller's). The graphed step has attributes
    `graph` and `eager`; on the CPU the eager step is returned."""
    dev = resolve_device(device)

    def eager(state: S.TrainerState, dstats: D.DensifyStats, camera, gt,
              it, sh_degree: int):
        loops._check_device(state, dev)
        return scratch_step(state, dstats, camera, gt, it, sh_degree, cfg,
                            scfg)

    if dev.type == "cpu":
        return eager
    graph = graphs.Graph()
    n_stats = len(dataclasses.fields(D.DensifyStats))

    def step(state: S.TrainerState, dstats: D.DensifyStats, camera, gt, it,
             sh_degree: int):
        loops._check_device(state, dev)

        def body(st, cam, g, *rest):
            new, ds, aux = scratch_step(st, D.stats_of(rest[:n_stats]), cam,
                                        g, rest[n_stats], sh_degree, cfg,
                                        scfg)
            return new, (D.stats_tensors(ds), aux)

        new, (ds, aux) = loops._graph_step(
            graph, body, state, camera, gt,
            (*D.stats_tensors(dstats), it), key=(sh_degree,))
        return new, D.stats_of(ds), aux

    step.graph = graph
    step.eager = eager
    return step


@dataclasses.dataclass(frozen=True)
class EventCounts:
    """What one densify event did: rows cloned, split (one new row each),
    pruned and dropped (0-d tensors on the state's device, not
    synchronised), the capacity before and after, and, with no budget,
    moves (densify_every_candidate's index tensors; None otherwise)."""
    cloned: torch.Tensor
    split: torch.Tensor
    pruned: torch.Tensor
    dropped: torch.Tensor
    capacity_before: int
    capacity_after: int
    moves: dict | None = None


def densify_event(state: S.TrainerState, dstats: D.DensifyStats, it: int,
                  scfg: ScratchConfig, scene_extent: float, noise):
    """densify_and_prune at iteration `it`: clone, then split, then the
    size prune (past the first opacity reset, also the screen-size and
    world-size rules), and fresh statistics at the state's capacity.
    With a densify budget, the JAX package's: both budgeted, the prune
    reading the pass's largest screen radii, then the reset. With
    scfg.densify_budget None, the reference's: every candidate, the
    capacity grown in buckets (D.densify_every_candidate), then the
    statistics reset before the prune reads them, as
    densification_postfix resets max_radii2D, so that the screen-size
    rule never fires. `noise` (2, C, 3) standard normals at the state's
    capacity, for the split. Returns (state, dstats, EventCounts); the
    counts are tensors, and only the unbudgeted growth reads the host."""
    thr, pd = scfg.densify_grad_threshold, scfg.percent_dense
    cap0, live0 = state.capacity, state.live.sum()
    max_screen = 20.0 if it > scfg.opacity_reset_every else None
    moves = None
    if scfg.densify_budget is None:
        state, moves = D.densify_every_candidate(
            state, dstats, thr, scene_extent, pd, noise, capacity_bucket)
        dropped = torch.zeros((), dtype=torch.int64, device=live0.device)
        live1 = live0 + moves["clone_src"].numel()
        live2 = live1 + moves["split_src"].numel()
        with span("densify/reset"):
            dstats = D.init_stats(state.capacity, state.live.device)
        with span("densify/prune"):
            state = D.prune_oversized(state, dstats, max_screen,
                                      scene_extent)
    else:
        with span("densify/clone"):
            state, d1 = D.densify_and_clone(state, dstats, thr, scene_extent,
                                            pd, scfg.densify_budget)
            live1 = state.live.sum()
        with span("densify/split"):
            state, d2 = D.densify_and_split(state, dstats, thr, scene_extent,
                                            pd, scfg.densify_budget,
                                            noise=noise)
            live2 = state.live.sum()
        dropped = d1 + d2
        with span("densify/prune"):
            state = D.prune_oversized(state, dstats, max_screen,
                                      scene_extent)
        with span("densify/reset"):
            dstats = D.init_stats(state.capacity, state.live.device)
    return state, dstats, EventCounts(
        cloned=live1 - live0, split=live2 - live1,
        pruned=live2 - state.live.sum(), dropped=dropped,
        capacity_before=cap0, capacity_after=state.capacity, moves=moves)


def v_importance_score(state: S.TrainerState, gs_count, important_score,
                       v_pow: float = 0.1):
    """LightGaussian calculate_v_imp_score (prune.py:112-128): importance *
    (volume / 90th-percentile-volume)^v_pow."""
    volume = torch.prod(state.params.get_scaling().detach(), dim=1)
    live_vol = torch.where(state.live, volume, torch.zeros_like(volume))
    sorted_v = torch.sort(live_vol).values
    n_live = state.live.sum()
    idx90 = (state.capacity - n_live
             + (0.9 * n_live.to(torch.float32)).to(torch.int32))
    v90 = sorted_v[torch.clamp(idx90, max=state.capacity - 1)]
    v_norm = volume / torch.clamp(v90, min=1e-12)
    return torch.pow(torch.clamp(v_norm, min=1e-12), v_pow) * important_score


def make_significance_view(cfg: loops.LoopConfig, device=None):
    """view(state, camera) -> (gs_count (C,) i32, contribs (C,) f32): one
    view's count_opacity stats pass (rasterize_stats, kernel 8), the
    per-view body of global_significance_scores. Unless `device` is "cpu"
    (then the eager function), a state on the card runs through a CUDA
    graph per state capacity and camera (width, height)
    (loops.graphed_view); a state on the CPU runs eagerly."""
    def view(state: S.TrainerState, camera):
        p = state.params
        out = stats_ops.rasterize_stats(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(),
            camera, shs=(p.features_dc, p.features_rest),
            sh_degree=cfg.sh_degree, mode="count_opacity", config=cfg.raster,
            live_mask=state.live)
        return out["gs_count"], out["contribs"]

    return loops.graphed_view(view, device)


def global_significance_scores(state: S.TrainerState, views,
                               cfg: loops.LoopConfig):
    """LightGaussian prune_list (prune.py:133-157): accumulate per-Gaussian
    count and opacity-importance over all training views via the counting
    rasterizer (make_significance_view: rasterize_stats' count_opacity
    mode, kernel 8)."""
    dev = state.live.device
    view = make_significance_view(cfg, device=dev)
    gs_count = torch.zeros(state.capacity, dtype=torch.int32, device=dev)
    imp = torch.zeros(state.capacity, dtype=torch.float32, device=dev)
    for v in views:
        count, contribs = view(state, v.camera)
        gs_count = gs_count + count
        imp = imp + contribs
    return gs_count, imp


def lightgaussian_prune(state: S.TrainerState, views, cfg: loops.LoopConfig,
                        percent: float, prune_type: str = "v_important_score",
                        v_pow: float = 0.1) -> S.TrainerState:
    """prune_finetune.py:214-243 percentile prune by the chosen score."""
    gs_count, imp = global_significance_scores(state, views, cfg)
    if prune_type == "important_score":
        score = imp
    elif prune_type == "v_important_score":
        score = v_importance_score(state, gs_count, imp, v_pow)
    elif prune_type == "count":
        score = gs_count.to(torch.float32)
    elif prune_type == "opacity":
        score = torch.sigmoid(state.params.opacity.detach()[:, 0])
    else:
        raise ValueError(prune_type)
    return S.metric_prune(state, score, percent)


def train_scratch(state: S.TrainerState, train_views: Sequence,
                  cfg: loops.LoopConfig, scfg: ScratchConfig = ScratchConfig(),
                  scene_extent: float = 1.0, start_iter: int = 0,
                  log: Callable = print, seed: int = 0,
                  log_every: int = 500) -> S.TrainerState:
    """The from-scratch loop on the device of `state`: the reference's
    seeded view stack, densification (clone, then split, then the size
    prune) every densify_every iterations strictly between densify_from
    and densify_until, opacity resets, the SH degree raised every
    sh_up_every iterations (from start_iter's degree) and LightGaussian
    prunes at prune_iterations. Each densify event (densify_event) logs
    the live count and its EventCounts, with the step's captures so far,
    in one read."""
    dev = state.live.device
    dstats = D.init_stats(state.capacity, dev)
    stack = loops._ViewStack(train_views, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    max_sh = state.params.sh_degree
    active_sh = min(start_iter // scfg.sh_up_every, max_sh)
    step_fn = make_scratch_step(cfg, device=dev, scfg=scfg)
    graph = getattr(step_fn, "graph", None)

    for it in range(start_iter + 1, start_iter + scfg.iterations + 1):
        if it % scfg.sh_up_every == 0 and active_sh < max_sh:
            active_sh += 1
        v = stack.pop()
        state, dstats, aux = step_fn(state, dstats, v.camera,
                                     loops.view_image(v, dev), it, active_sh)
        if it % log_every == 0:
            log(f"[scratch] it={it} loss={float(aux['loss']):.4f} "
                f"live={int(state.live_count())}")

        if scfg.densify_from < it < scfg.densify_until:
            if it % scfg.densify_every == 0:
                noise = torch.randn((2, state.capacity, 3), generator=gen,
                                    device=dev)
                state, dstats, ev = densify_event(state, dstats, it, scfg,
                                                  scene_extent, noise)
                live, cloned, split, pruned, dropped = torch.stack([
                    state.live_count(), ev.cloned, ev.split, ev.pruned,
                    ev.dropped]).tolist()
                log(f"[scratch] it={it} densify live={live} "
                    f"dropped={dropped} cloned={cloned} split={split} "
                    f"pruned={pruned} capacity={ev.capacity_before}->"
                    f"{ev.capacity_after} captures="
                    f"{graph.captures if graph else 0}")
            if it % scfg.opacity_reset_every == 0:
                state = D.reset_opacity(state, 0.01)

        if it in scfg.prune_iterations:
            i = list(scfg.prune_iterations).index(it)
            pct = scfg.prune_percent * (scfg.prune_decay ** i)
            state = lightgaussian_prune(state, train_views, cfg, pct,
                                        v_pow=scfg.v_pow)
            log(f"[scratch] it={it} LG prune {pct:.3f} -> "
                f"live={int(state.live_count())}")
    return state
