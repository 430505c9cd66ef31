"""The score pass of efficiency-aware pruning: metric-prune passes issued
back to back.

Set-up draws the dense proxy from the seed (reference/dense.py), makes
the program's training state of it and its graphed score view
(train/loops.make_score_fn). One step is one pass as the prune loop's
do_metric_prunes runs it: loops.metric_prune_scores over the
configuration's ring views in order (one graph replay a view), the cut
models/state.metric_prune, and the candidate's live count read back, the
host read of the loop's gate. The state is not carried: every pass starts
from the full dense state, the prune stage's first and largest event, so
every step does the same work. step_ms is the window over the passes it
completed. A pass fails on overflow in any of its views or on a score
that is not finite.

The check compares the first pass with the plain reference
(reference/score.py) over every view: each view's gs_count and contribs
(from ops/stats.rasterize_stats, the function the graphed view runs), the
max over the views and the cut's rows. Traced, a second profiler window
over the same passes keeps utils/profiling.window_report of its events as
data["program"]: the views' replays by stage (project, table, expand,
sort, gather, stats, reduce, compose) and, outside the graphs, max and
cut.
"""

from __future__ import annotations

import gc
import sys
import time
import types

import numpy as np
import torch

from benchmark import devtrace, harness
from benchmark.reference import camera as refcam
from benchmark.reference import dense
from benchmark.reference import score as ref
from benchmark.runners.frame_loop import program_cameras
from benchmark.runners.train_loop import program_state


def program_score(cfg: dict, dev):
    """(the program's LoopConfig with the configuration's capacities, its
    score view: view(state, camera) -> (scores, overflow), a CUDA graph on
    the card)."""
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops
    fc = cfg["frame"]
    lc = loops.LoopConfig(
        raster=RasterizeConfig(pair_capacity=fc["pair_capacity"],
                               compact_capacity=fc["compact_capacity"],
                               power_cutoff=fc["power_cutoff"]),
        sh_degree=cfg["sh_degree"])
    return lc, loops.make_score_fn(lc, cfg["prune"]["metric"], device=dev)


def program_window(run) -> dict:
    """utils/profiling.window_report of a torch.profiler window over
    run()."""
    from torch.profiler import ProfilerActivity, profile
    from fovsplat_torch.utils import profiling
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gc.disable()    # as in the measured window
        try:
            run()
            torch.cuda.synchronize()
        finally:
            gc.enable()
    return profiling.window_report(prof.events())


def program_views(state, cams, lc, mode: str) -> list:
    """Each view's (gs_count, contribs, overflow) from the program's
    ops/stats.rasterize_stats, as its score view calls it."""
    from fovsplat_torch.ops import stats
    p = state.params
    out = []
    for cam in cams:
        o = stats.rasterize_stats(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(), cam,
            shs=p.get_features(), sh_degree=lc.sh_degree, mode=mode,
            loss_map=torch.ones((cam.height, cam.width), device=p.xyz.device),
            config=lc.raster, live_mask=state.live)
        out.append((o["gs_count"], o["contribs"], int(o["binned"].overflow)))
    return out


def run(ctx) -> dict:
    from fovsplat_torch.models import state as S
    from fovsplat_torch.train import loops
    if not hasattr(loops, "ScoreWatch"):
        # A score view that does not return its overflow leaves a spilled
        # pass uncounted: the cell cannot apply its failure rule.
        raise SystemExit("benchmark: the program's score view reports no "
                         "overflow")
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    fc, pc = cfg["frame"], cfg["prune"]
    Wd, Ht = fc["width"], fc["height"]
    arrays = refcam.ring_arrays(2 * np.pi * np.arange(pc["views"])
                                / pc["views"], Wd, Ht)
    p0 = dense.dense_raw(cfg, ctx.seed, dev)
    cams = program_cameras(arrays, Wd, Ht, dev)
    views = [types.SimpleNamespace(camera=c) for c in cams]
    lc, score_view = program_score(cfg, dev)
    state = program_state(p0)
    ratio = pc["prune_ratio"]

    def one_pass():
        scores, overflow = loops.metric_prune_scores(state, views,
                                                     score_view)
        return scores, overflow, S.metric_prune(state, scores, ratio)

    # The first passes go through the window's own call; the check keeps
    # the first one's max and cut.
    for i in range(mix["first_steps"]):
        scores, overflow, cand = one_pass()
        int(cand.live_count())
        if i == 0:
            first = {"max": scores, "kill": state.live & ~cand.live}
        del scores, overflow, cand
    t_warm = time.perf_counter() + mix["warmup_s"]
    while time.perf_counter() < t_warm:
        scores, overflow, cand = one_pass()
        int(cand.live_count())
        del scores, overflow, cand
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cap = mix["max_window_steps"]
    ovf = torch.zeros(cap, dtype=torch.int64, device=dev)
    bad = torch.zeros(cap, dtype=torch.int64, device=dev)
    call = []
    setup_s = harness.process_age_s()
    steps = 0
    gc.disable()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while True:
        t0 = time.perf_counter()
        scores, overflow, cand = one_pass()
        call.append(time.perf_counter() - t0)
        ovf[steps:steps + 1].copy_(overflow.reshape(1))
        bad[steps:steps + 1].copy_((~torch.isfinite(scores)).sum().reshape(1))
        int(cand.live_count())
        steps += 1
        t_end = time.perf_counter()
        del scores, overflow, cand
        if t_end >= deadline or steps >= cap:
            break
    gc.enable()
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    failed = int(((ovf[:steps] > 0) | (bad[:steps] > 0)).sum())
    e2e = {"step_ms": (t_end - t_start) / steps * 1e3, "setup_s": setup_s}
    data = {"unit": "step", "kind": "score",
            "host_ms": float(np.mean(call)) * 1e3,
            "steps_per_s": steps / (t_end - t_start),
            "views": len(views), "rows": state.capacity}

    if ctx.trace and dev.type == "cuda":
        from torch.profiler import record_function

        def run_steps():
            for _ in range(mix["profile_steps"]):
                with record_function("step"):
                    sc, ov, cd = one_pass()
                    with record_function("synchronize"):
                        int(cd.live_count())
            return mix["profile_steps"]
        data["profile"] = devtrace.profile(run_steps, "step")
        data["own_kernels"] = devtrace.own_kernels()
        data["program"] = program_window(run_steps)

    mode = "max" if pc["metric"] == "max_contrib" \
        else "loss_weighted_max_count"
    prog = {"views": program_views(state, cams, lc, mode), **first}
    del score_view, state, cams, views
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, work = check(ctx, cfg, arrays, p0, prog)
    readings["failed_steps"] = failed
    data["work"] = work
    return {"e2e": e2e, "attempted": steps, "failed": failed,
            "readings": readings, "data": data, "peak": peak}


def gaps(got: dict, want: dict) -> dict:
    """The readings compared, each the worst over the views where it is
    per view: gs_count_gap, the summed |gs_count gap|; contribs_rel_gap,
    the summed |contribs gap| over the summed contribs (a pixel routed to
    another Gaussian moves 2); max_rel_gap, the same of the max over the
    views; cut_rows_gap, the rows cut by one side only over the rows cut."""
    gs, con = 0, 0.0
    for (g_gs, g_c, *_), (w_gs, w_c, _) in zip(got["views"], want["views"]):
        gs = max(gs, int((g_gs.long() - w_gs.long()).abs().sum()))
        con = max(con, float((g_c.double() - w_c.double()).abs().sum())
                  / max(float(w_c.double().sum()), 1.0))
    mx = float((got["max"].double() - want["max"].double()).abs().sum()) \
        / max(float(want["max"].double().sum()), 1e-30)
    cut = int((got["kill"] ^ want["kill"]).sum()) \
        / max(int(want["kill"].sum()), 1)
    return {"gs_count_gap": gs, "contribs_rel_gap": con, "max_rel_gap": mx,
            "cut_rows_gap": cut}


def check(ctx, cfg, arrays, p0, prog) -> tuple:
    """The readings of the program's first pass against the reference's
    pass on the same views, and the reference's counts of each view's
    work (every pass scores the same views of the same state)."""
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fc, pc = cfg["frame"], cfg["prune"]
    cams = [refcam.ref_camera(arrays, i, fc["width"], fc["height"], dev)
            for i in range(pc["views"])]
    want = ref.score_pass(p0, cams, fc, pc["prune_ratio"])
    if ctx.control is not None:
        prog = ref.score_pass(p0, cams, fc, pc["prune_ratio"], ctx.control)
    print(f"reference work by view {[v[2] for v in want['views']]}",
          file=sys.stderr, flush=True)
    return gaps(prog, want), [v[2] for v in want["views"]]
