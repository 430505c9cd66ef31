"""3DGS's from-scratch training in the middle of densification: passes of
100 scratch steps and the densify event that ends them, issued back to
back.

Set-up draws the snapshot's rows from the seed (the PS1 proxy and the
first split children of reference/dense.py, each row's DC with the
configuration's seeded texture: snapshot_raw), renders the
configuration's ring views of the rows as the ground truth holds them
(scales and opacities of finer rows of the same cover: ground_truth)
with the plain reference, perturbs the rows from the seed, and makes the
program's state at the snapshot's capacity (Adam moments zero, the Adam
count at the snapshot's iteration) and its graphed scratch step
(train/scratch.make_scratch_step with the schedule's ScratchConfig, so
the reference's NDC statistics). One pass, one in flight: from the
snapshot (the steps are functional, so nothing is copied back), the
scratch steps of the snapshot's next iterations over the views in
train_scratch's seeded view stack, then the last iteration's densify
event (train/scratch.densify_event, every candidate cloned or split) and
its live count read back. Every pass starts from the same snapshot with
the same view order and split normals, so every pass does the same work
and none crosses a capacity bucket. step_ms is the window over the
iterations of the whole passes it holds, the events inside. A step fails
on overflow or a non-finite gradient or loss; an event fails when it
drops a candidate.

The check follows the first pass: the plain reference (reference/
scratch.py) takes the first three steps from the same state (losses,
leaf norms of the first gradient and of the change after three steps,
norms of the statistics), and the pass's densify event on the program's
own end-of-pass state, statistics and normals (the rows cloned, split and
pruned, the live count, every live row's parameters and Adam moments,
rows matched by origin and kind). Traced, a second profiler window over
one pass keeps utils/profiling.window_report of its events as
data["program"]: the steps' replays by stage (render, loss, backward,
adam, stats) and the event's operations by its spans (densify/grow,
clone, split, reset, prune).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, harness
from benchmark.reference import camera as refcam
from benchmark.reference import dense, proxy
from benchmark.reference import scratch as ref
from benchmark.reference import train as rtrain
from benchmark.runners.frame_loop import program_cameras
from benchmark.runners.score_loop import program_window
from benchmark.runners.train_loop import (derived_seed, leaf_norms,
                                          program_state)

FIELDS = rtrain.FIELDS
STATS = ("grad_accum", "denom", "max_radii")


def snapshot_raw(cfg: dict, seed: int, dev) -> dict:
    """The snapshot's raw parameters (FIELDS), unperturbed: the PS1 proxy
    of cfg["ps1_points"] rows in the seed's order, then the first
    frame.points - ps1_points of reference/dense.py's split children (its
    fixed draw of snapshot.dense_points - ps1_points) in the seed's
    order; each row's DC plus seeded normals times texture.dc_sigma."""
    n_ps1, n = cfg["ps1_points"], cfg["frame"]["points"]
    ps1 = proxy.train_raw(proxy.bicycle_proxy(n_ps1, seed, dev, cfg["pnum"]))
    cloud = proxy._cloud(n_ps1, torch.device(dev), cfg["pnum"], 0.45)
    kids = dense.split_children(cloud, cfg["snapshot"]["dense_points"]
                                - n_ps1, dev, cfg["children"])
    del cloud
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    order = torch.randperm(n - n_ps1, generator=g, device=dev)
    rows = {f: torch.cat([ps1[f], kids[f][:n - n_ps1][order]]).contiguous()
            for f in FIELDS}
    g.manual_seed(derived_seed(seed, 6))
    rows["features_dc"] = (rows["features_dc"] + cfg["texture"]["dc_sigma"]
                           * torch.randn(rows["features_dc"].shape,
                                         generator=g, device=dev))
    return rows


def perturbed(raw: dict, cfg: dict, seed: int, dev) -> dict:
    """The trained state's rows: `raw` with the configuration's seeded
    noise on the DC and the opacity logits (train_loop.initial_state's
    rule)."""
    g = torch.Generator(device=dev)
    g.manual_seed(derived_seed(seed, 3))
    pt = cfg["train"]["perturb"]
    p = dict(raw)
    p["features_dc"] = raw["features_dc"] + pt["dc_sigma"] * torch.randn(
        raw["features_dc"].shape, generator=g, device=dev)
    p["opacity"] = raw["opacity"] + pt["opacity_logit_sigma"] * torch.randn(
        raw["opacity"].shape, generator=g, device=dev)
    return {f: p[f].contiguous() for f in FIELDS}


def ground_truth(raw: dict, arrays: dict, cfg: dict, dev) -> list:
    """The views' images: the reference's render of the unperturbed rows
    as the ground truth holds them, each row's scales times
    ground_truth.scale and its opacity a to 1 - (1 - a) ** coverage_power
    (a row of a quarter of the area at scale 0.5 covers as much with
    power 4)."""
    fc, gc = cfg["frame"], cfg["ground_truth"]
    a = 1.0 - (1.0 - torch.sigmoid(raw["opacity"])) ** gc["coverage_power"]
    a = torch.clamp(a, 1e-6, 1.0 - 1e-6)
    truth = {**raw, "scaling": raw["scaling"] + math.log(gc["scale"]),
             "opacity": torch.log(a / (1.0 - a))}
    out = []
    with torch.no_grad():
        for i in range(len(arrays["world_view"])):
            cam = refcam.ref_camera(arrays, i, fc["width"], fc["height"], dev)
            out.append(rtrain.render(truth, cam, fc)[0].contiguous())
    return out


def schedule(cfg: dict, scratch):
    """The configuration's schedule as the program's ScratchConfig, with
    no densify budget."""
    s = cfg["schedule"]
    return scratch.ScratchConfig(
        iterations=s["iterations"], densify_from=s["densify_from_iter"],
        densify_until=s["densify_until_iter"],
        densify_every=s["densification_interval"],
        densify_grad_threshold=s["densify_grad_threshold"],
        opacity_reset_every=s["opacity_reset_interval"],
        percent_dense=s["percent_dense"], sh_up_every=s["sh_up_every"],
        densify_budget=None)


def program_step(cfg: dict, dev):
    """(the program's LoopConfig, its graphed scratch step)."""
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops, optim, scratch
    fc, tc = cfg["frame"], cfg["train"]
    lc = loops.LoopConfig(
        raster=RasterizeConfig(pair_capacity=fc["pair_capacity"],
                               compact_capacity=fc["compact_capacity"],
                               power_cutoff=fc["power_cutoff"]),
        optim=optim.OptimConfig(**tc["optim"]),
        lambda_dssim=cfg["schedule"]["lambda_dssim"],
        sh_degree=cfg["sh_degree"], spatial_lr_scale=cfg["scene_extent"])
    return lc, scratch.make_scratch_step(lc, device=dev,
                                         scfg=schedule(cfg, scratch))


def snapshot_state(p0: dict, cfg: dict, dev):
    """The program's state of the rows p0 at the snapshot's capacity, the
    Adam count at the snapshot's iteration."""
    from fovsplat_torch.models import state as S
    snap = cfg["snapshot"]
    st = S.grow(program_state(p0), snap["capacity"])
    count = torch.full((), snap["adam_count"], dtype=torch.int32, device=dev)
    return dataclasses.replace(st, opt=dataclasses.replace(st.opt,
                                                           count=count))


class Pass:
    """One pass from the snapshot: its steps, then the densify event. The
    views come from train_scratch's view stack (loops._ViewStack), the
    split normals from a generator, both seeded the same for every pass.
    A call returns the live count read back after the event; `views`
    holds the pass's views. Keyword arguments: watch(k, state, dstats,
    aux) sees each step's output; `fails` (bool, on the device) gets, at
    `at` + k, whether step k failed; `span(name)` wraps each iteration
    (the event inside the last); `keep` keeps the event's input (state,
    statistics, normals), its output state and its EventCounts in
    `last`."""

    def __init__(self, cfg, mix, step, snap, cams, gts, seed, dev):
        from fovsplat_torch.train import scratch
        self.cfg, self.step, self.snap = cfg, step, snap
        self.cams, self.gts, self.dev = cams, gts, dev
        self.iters = mix["pass_iterations"]
        self.it0 = cfg["snapshot"]["iteration"]
        self.sh = cfg["snapshot"]["active_sh_degree"]
        self.scfg = schedule(cfg, scratch)
        self.view_seed = derived_seed(seed, 4)
        self.noise_seed = derived_seed(seed, 5)
        self.gen = torch.Generator(device=dev)
        self.last = None
        self.views = []

    def __call__(self, watch=None, fails=None, at=0, span=None,
                 keep=False) -> int:
        from fovsplat_torch.models import densify as D
        from fovsplat_torch.train import loops, scratch
        state = self.snap
        dstats = D.init_stats(state.capacity, self.dev)
        stack = loops._ViewStack(list(range(len(self.cams))),
                                 self.view_seed)
        self.gen.manual_seed(self.noise_seed)
        self.views = []
        for k in range(self.iters):
            it = self.it0 + 1 + k
            with span("step") if span else contextlib.nullcontext():
                v = stack.pop()
                self.views.append(v)
                state, dstats, aux = self.step(state, dstats, self.cams[v],
                                               self.gts[v], it, self.sh)
                if fails is not None:
                    fails[at + k:at + k + 1].copy_(
                        ((aux["overflow"] > 0) | (aux["nonfinite"] > 0)
                         | ~torch.isfinite(aux["loss"])).reshape(1))
                if watch is not None:
                    watch(k, state, dstats, aux)
                if k < self.iters - 1:
                    continue
                noise = torch.randn((2, state.capacity, 3),
                                    generator=self.gen, device=self.dev)
                new, _, ev = scratch.densify_event(
                    state, dstats, it, self.scfg, self.cfg["scene_extent"],
                    noise)
                if fails is not None:
                    fails[at + k:at + k + 1] |= (ev.dropped > 0).reshape(1)
                live = int(new.live_count())
        self.last = ((state, dstats, noise), new, ev, it) if keep else None
        return live


def event_window(run, attempts: int = 3) -> dict:
    """score_loop.program_window over run(), opened again, up to
    `attempts` windows, while its report holds no device time of the
    densify event's spans: the profiler drops a window's device events
    at times (devtrace.profile)."""
    for _ in range(attempts):
        rep = program_window(run)
        if any(label.startswith("densify/") and secs > 0
               for label, secs in rep["outside_s"].items()):
            break
    return rep


def stat_norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(d[k].double())) for k in STATS}


def run(ctx) -> dict:
    from fovsplat_torch.train import scratch
    if not hasattr(scratch, "densify_event"):
        # A program without the event's one function and its capacity
        # growth cannot run the published schedule's event.
        raise SystemExit("benchmark: the program's scratch training has no "
                         "densify event with every candidate")
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    fc = cfg["frame"]
    W, H = fc["width"], fc["height"]
    views = cfg["train"]["views"]
    arrays = refcam.ring_arrays(2 * np.pi * np.arange(views) / views, W, H)
    raw = snapshot_raw(cfg, ctx.seed, dev)
    gts = ground_truth(raw, arrays, cfg, dev)
    p0 = perturbed(raw, cfg, ctx.seed, dev)
    del raw
    cams = program_cameras(arrays, W, H, dev)
    lc, step = program_step(cfg, dev)
    snap = snapshot_state(p0, cfg, dev)
    one_pass = Pass(cfg, mix, step, snap, cams, gts, ctx.seed, dev)

    # The first pass goes through the window's own call; the check keeps
    # its first steps, and its event is checked at once.
    beta1 = cfg["train"]["optim"]["beta1"]
    first = mix["first_steps"]
    prog = {"loss": []}

    def watch(k, state, dstats, aux):
        if k < first:
            prog["loss"].append(float(aux["loss"]))
        if k == 0:
            prog["grad1"] = leaf_norms({f: state.opt.mu[f] / (1 - beta1)
                                        for f in FIELDS})
        if k == first - 1:
            n = p0["xyz"].shape[0]
            prog["delta3"] = leaf_norms({
                f: getattr(state.params, f).detach()[:n] - p0[f]
                for f in FIELDS})
            prog["stats3"] = stat_norms({name: getattr(dstats, name)
                                         for name in STATS})
    one_pass(watch, keep=True)
    order = one_pass.views[:first]
    pre, post, ev, it = one_pass.last
    event = {"cloned": int(ev.cloned), "split": int(ev.split),
             "pruned": int(ev.pruned), "dropped": int(ev.dropped),
             "live_before": int(pre[0].live_count()),
             "live": int(post.live_count()),
             "capacity_before": ev.capacity_before,
             "capacity_after": ev.capacity_after,
             "captures": getattr(getattr(step, "graph", None), "captures", 0)}
    print(f"event {event}", file=sys.stderr, flush=True)
    event_readings = check_event(ctx, cfg, pre, post, ev, it)
    del pre, post, ev
    one_pass.last = None
    # Warm-up: more passes until warmup_s has passed.
    t_warm = time.perf_counter() + mix["warmup_s"]
    while time.perf_counter() < t_warm:
        one_pass()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cap = mix["max_window_passes"]
    fails = torch.zeros(cap * one_pass.iters, dtype=torch.bool, device=dev)
    calls = []
    step_fn = one_pass.step

    def timed(*a):
        t0 = time.perf_counter()
        out = step_fn(*a)
        calls.append(time.perf_counter() - t0)
        return out
    one_pass.step = timed
    setup_s = harness.process_age_s()
    passes = 0
    gc.disable()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while True:
        one_pass(fails=fails, at=passes * one_pass.iters)
        passes += 1
        t_end = time.perf_counter()
        if t_end >= deadline or passes >= cap:
            break
    gc.enable()
    one_pass.step = step_fn
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    iters = passes * one_pass.iters
    failed = int(fails[:iters].sum())
    e2e = {"step_ms": (t_end - t_start) / iters * 1e3, "setup_s": setup_s}
    data = {"unit": "step", "kind": "scratch",
            "host_ms": float(np.mean(calls)) * 1e3,
            "steps_per_s": iters / (t_end - t_start), "passes": passes,
            "pass_iterations": one_pass.iters, "rows": snap.capacity,
            "event": event}

    prof_views = []
    if ctx.trace and dev.type == "cuda":
        from torch.profiler import record_function

        def run_pass():
            one_pass(span=record_function)
            prof_views.extend(one_pass.views)
            return one_pass.iters
        data["profile"] = devtrace.profile(run_pass, "step")
        data["own_kernels"] = devtrace.own_kernels()
        data["program"] = event_window(run_pass)

    del step, snap, one_pass, cams
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, work = check_steps(ctx, cfg, arrays, gts, order, p0, prog,
                                 sorted(set(prof_views)))
    readings.update(event_readings)
    readings["failed_steps"] = failed
    data["work"] = [work[v] for v in prof_views]
    return {"e2e": e2e, "attempted": iters, "failed": failed,
            "readings": readings, "data": data, "peak": peak}


def follow(cfg: dict, arrays, gts, order, p0: dict, dev, dtype) -> dict:
    """The reference's first steps from p0 (Adam count at the snapshot's
    iteration) on the views `order`: {"loss", "grad1" (leaf norms of the
    first gradient), "delta3" (of the change after the steps), "stats3"
    (norms of the statistics after them)}."""
    fc, snapc = cfg["frame"], cfg["snapshot"]
    sched = cfg["schedule"]
    p = dict(p0)
    adam = rtrain.init_state(p0, dtype)
    adam["count"] = snapc["adam_count"]
    stats = ref.zero_stats(p0["xyz"].shape[0], dev)
    rates = ref.xyz_rates(cfg["train"]["optim"], cfg["scene_extent"])
    beta1 = rates["beta1"]
    losses = []
    for k, v in enumerate(order):
        cam = refcam.ref_camera(arrays, v, fc["width"], fc["height"], dev)
        p, adam, stats, loss = ref.step(p, adam, stats, cam, gts[v],
                                        snapc["iteration"] + 1 + k, fc,
                                        rates, sched["lambda_dssim"], dtype)
        losses.append(loss)
        if k == 0:
            g1 = leaf_norms({f: adam["mu"][f].float() / (1 - beta1)
                             for f in FIELDS})
    return {"loss": losses, "grad1": g1,
            "delta3": leaf_norms({f: p[f].float() - p0[f] for f in FIELDS}),
            "stats3": stat_norms(stats)}


def step_work(cfg: dict, arrays, p0: dict, view: int, dev) -> dict:
    """The reference's counts of one step's work on `view` (a pass's
    steps move the state little)."""
    fc = cfg["frame"]
    cam = refcam.ref_camera(arrays, view, fc["width"], fc["height"], dev)
    work = {"params": sum(p0[f].numel() for f in FIELDS)}
    with torch.no_grad():
        rtrain.render(p0, cam, fc, work=work)
    return work


def check_steps(ctx, cfg, arrays, gts, order, p0, prog, work_views) -> tuple:
    """The readings of the program's first steps against the reference's
    (train_loop.gaps, and stats3_gap: the widest relative gap of the
    statistics' norms), and the work counts of `work_views`."""
    from benchmark.runners.train_loop import gaps
    dev = ctx.device
    want = follow(cfg, arrays, gts, order, p0, dev, torch.float32)
    if ctx.control is not None:
        prog = follow(cfg, arrays, gts, order, p0, dev, ctx.control)
    print(f"program {prog}\nreference {want}", file=sys.stderr, flush=True)
    out = gaps(prog, want)
    out["stats3_gap"] = max(abs(prog["stats3"][k] - want["stats3"][k])
                            / max(want["stats3"][k], 1e-30) for k in STATS)
    return out, {v: step_work(cfg, arrays, p0, v, dev) for v in work_views}


# --- the densify event ------------------------------------------------

def _sorted_rows(keys, rows: dict, mu: dict, nu: dict) -> dict:
    order = torch.argsort(keys)
    return {"keys": keys[order],
            "rows": {f: rows[f][order] for f in FIELDS},
            "mu": {f: mu[f][order] for f in FIELDS},
            "nu": {f: nu[f][order] for f in FIELDS}}


def reference_event(p: dict, adam: dict, stats: dict, noise, cfg: dict,
                    it: int, dtype) -> dict:
    """The reference's event of iteration `it` on compact rows, at
    `dtype`: the candidate rows cloned and split, the keys (origin * 4 +
    kind) of the rows it pruned, and its output rows sorted by key."""
    s = cfg["schedule"]
    c = lambda x: x.to(dtype)                                # noqa: E731
    max_screen = 20.0 if it > s["opacity_reset_interval"] else None
    new_p, new_adam, _, out = ref.densify_and_prune(
        {f: c(p[f]) for f in FIELDS},
        {"mu": {f: c(adam["mu"][f]) for f in FIELDS},
         "nu": {f: c(adam["nu"][f]) for f in FIELDS},
         "count": adam["count"]},
        {k: c(stats[k]) for k in STATS}, s["densify_grad_threshold"],
        cfg["scene_extent"], s["percent_dense"], c(noise), max_screen)
    got = _sorted_rows(out["origin"] * 4 + out["kind"],
                       {f: new_p[f].float() for f in FIELDS},
                       {f: new_adam["mu"][f].float() for f in FIELDS},
                       {f: new_adam["nu"][f].float() for f in FIELDS})
    got.update(clone=torch.nonzero(out["clone"]).reshape(-1),
               split=torch.nonzero(out["split"]).reshape(-1),
               pruned=torch.sort(out["pruned_origin"] * 4
                                 + out["pruned_kind"]).values)
    return got


def program_event(pre_state, post, moves: dict) -> dict:
    """The program's event in reference_event's terms: each row keyed by
    the compact index (among pre_state's live rows) of the row it came
    from, times 4, plus its kind (kept, clone, first child, second
    child)."""
    dev = post.live.device
    live_idx = torch.nonzero(pre_state.live).reshape(-1)
    inv = torch.full((post.capacity,), -1, dtype=torch.int64, device=dev)
    inv[live_idx] = torch.arange(live_idx.numel(), device=dev)
    key = torch.full((post.capacity,), -1, dtype=torch.int64, device=dev)
    key[live_idx] = inv[live_idx] * 4 + ref.KEPT
    key[moves["split_src"]] = inv[moves["split_src"]] * 4 + ref.CHILD1
    key[moves["clone_dst"]] = inv[moves["clone_src"]] * 4 + ref.CLONE
    key[moves["split_dst"]] = inv[moves["split_src"]] * 4 + ref.CHILD0
    pruned = (key >= 0) & ~post.live
    p, o = post.params, post.opt
    got = _sorted_rows(
        key[post.live], {f: getattr(p, f).detach()[post.live] for f in FIELDS},
        {f: o.mu[f][post.live] for f in FIELDS},
        {f: o.nu[f][post.live] for f in FIELDS})
    got.update(clone=torch.sort(inv[moves["clone_src"]]).values,
               split=torch.sort(inv[moves["split_src"]]).values,
               pruned=torch.sort(key[pruned]).values)
    return got


def _sym_diff(a, b) -> int:
    _, counts = torch.unique(torch.cat([a, b]), return_counts=True)
    return int((counts == 1).sum())


def _field_gap(a: dict, b: dict) -> float:
    return max(float((a[f] - b[f]).abs().max())
               / max(float(b[f].abs().max()), 1e-30) for f in FIELDS)


def event_gaps(got: dict, want: dict) -> dict:
    """The event's readings: the rows cloned, split and pruned by one side
    only; the live counts' gap; over the rows both keep (matched by key),
    the widest gap of a parameter and of an Adam moment, each over that
    field's largest magnitude."""
    both_g = torch.isin(got["keys"], want["keys"])
    both_w = torch.isin(want["keys"], got["keys"])

    def sel(d, m):
        return {f: d[f][m] for f in FIELDS}
    return {"clone_rows_gap": _sym_diff(got["clone"], want["clone"]),
            "split_rows_gap": _sym_diff(got["split"], want["split"]),
            "prune_rows_gap": _sym_diff(got["pruned"], want["pruned"]),
            "live_gap": abs(got["keys"].numel() - want["keys"].numel()),
            "rows_gap": _field_gap(sel(got["rows"], both_g),
                                   sel(want["rows"], both_w)),
            "adam_rows_gap": max(
                _field_gap(sel(got[m], both_g), sel(want[m], both_w))
                for m in ("mu", "nu"))}


def check_event(ctx, cfg: dict, pre, post, ev, it: int) -> dict:
    """The readings of the first pass's densify event (iteration `it`)
    against the
    reference's on the program's own end-of-pass state, statistics and
    normals (pre: (state, statistics, normals)), compacted to its live
    rows."""
    state, dstats, noise = pre
    idx = torch.nonzero(state.live).reshape(-1)
    p = {f: getattr(state.params, f).detach()[idx] for f in FIELDS}
    adam = {"mu": {f: state.opt.mu[f][idx] for f in FIELDS},
            "nu": {f: state.opt.nu[f][idx] for f in FIELDS},
            "count": int(state.opt.count)}
    stats = {k: getattr(dstats, k)[idx] for k in STATS}
    want = reference_event(p, adam, stats, noise[:, idx], cfg, it,
                           torch.float32)
    if ctx.control is not None:
        got = reference_event(p, adam, stats, noise[:, idx], cfg, it,
                              ctx.control)
    else:
        got = program_event(state, post, ev.moves)
    out = event_gaps(got, want)
    print(f"event readings {out}", file=sys.stderr, flush=True)
    return out
