"""A model build's inner loop: train steps issued back to back.

Set-up draws the proxy from the seed, renders the configuration's ring
views with the plain reference as ground truth, perturbs the state from
the seed, and makes the program's graphed step. It drives that one step
object through the first `first_steps` steps (the check keeps what they
return), then hands it to the window. Each step of the window pops the
next view of a seeded stack (a fresh shuffle of the views each time it
runs out, as the program's fine-tune loop draws them), calls the step,
and reads its loss back as that loop does, which waits for the step.
step_ms is the window over the steps it completed. After the window the
plain reference follows the first three steps from the same seed.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, harness
from benchmark.reference import camera as refcam
from benchmark.reference import hvs
from benchmark.reference import proxy
from benchmark.reference import train as ref

FIELDS = ref.FIELDS


def derived_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


def initial_state(cfg: dict, seed: int, dev) -> tuple:
    """(the proxy, the perturbed raw parameters): the state the steps
    start from, drawn from the seed."""
    sc = proxy.bicycle_proxy(cfg["frame"]["points"], seed, dev, cfg["pnum"])
    raw = proxy.train_raw(sc)
    g = torch.Generator(device=dev)
    g.manual_seed(derived_seed(seed, 3))
    pt = cfg["train"]["perturb"]
    p = dict(raw)
    p["features_dc"] = raw["features_dc"] + pt["dc_sigma"] * torch.randn(
        raw["features_dc"].shape, generator=g, device=dev)
    p["opacity"] = raw["opacity"] + pt["opacity_logit_sigma"] * torch.randn(
        raw["opacity"].shape, generator=g, device=dev)
    return sc, {f: p[f].contiguous() for f in FIELDS}


def ground_truth(sc: dict, arrays: dict, cfg: dict, dev) -> list:
    """The views' images: the reference's render of the unperturbed
    proxy."""
    fc = cfg["frame"]
    raw = proxy.train_raw(sc)
    out = []
    with torch.no_grad():
        for i in range(len(arrays["world_view"])):
            cam = refcam.ref_camera(arrays, i, fc["width"], fc["height"], dev)
            out.append(ref.render(raw, cam, fc)[0].contiguous())
    return out


class ViewStack:
    """A fresh random.Random(seed) shuffle of the view indices each time
    the stack runs out, popped from the end."""

    def __init__(self, n: int, seed: int):
        self._n, self._rng, self._stack = n, random.Random(seed), []

    def pop(self) -> int:
        if not self._stack:
            self._stack = list(range(self._n))
            self._rng.shuffle(self._stack)
        return self._stack.pop()


def program_step(cfg: dict, mix: dict, dev):
    """The program's step entry: step(state, camera, gt, it) -> (state,
    aux), a CUDA graph on the card."""
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops, optim
    fc, tc = cfg["frame"], cfg["train"]
    lc = loops.LoopConfig(
        raster=RasterizeConfig(pair_capacity=fc["pair_capacity"],
                               compact_capacity=fc["compact_capacity"],
                               power_cutoff=fc["power_cutoff"]),
        optim=optim.OptimConfig(**tc["optim"]),
        lambda_dssim=tc["lambda_dssim"], sh_degree=cfg["sh_degree"],
        hvs_levels=tc["hvs_levels"], hvs_orientations=tc["hvs_orientations"])
    if mix["step"] == "photometric":
        make = loops.make_photometric_step(lc, device=dev)

        def step(state, camera, gt, it):
            return make(state, camera, gt, it, 0.0)
        return step
    if mix["step"] == "hvs":
        return loops.make_hvs_step(lc, mix["pooling_size"], mix["loss_type"],
                                   masking=mix["masking"], device=dev)
    raise ValueError(f"unknown step {mix['step']!r}")


# Mask training trains the DC colour and the opacity only.
MASK_FROZEN = ("xyz", "features_rest", "scaling", "rotation")


def frozen(mix: dict) -> tuple:
    return MASK_FROZEN if mix.get("masking") else ()


def objective(cfg: dict, mix: dict, dev, dtype):
    """The reference's loss of the mix's step: loss(image, ground truth)."""
    if mix["step"] == "photometric":
        lam = cfg["train"]["lambda_dssim"]
        return lambda img, gt: ref.loss_of(img, gt, lam)
    flt = hvs.filters(dev, dtype)
    ps, lv = mix["pooling_size"], cfg["train"]["hvs_levels"]

    def hvs_loss(img, gt):
        with torch.no_grad():
            target = hvs.statsmaps(gt, ps, lv, flt)
        return hvs.loss(img, target, ps, lv, flt, mix["loss_type"])
    return hvs_loss


def program_state(p: dict):
    from fovsplat_torch.models import state as S
    from fovsplat_torch.models.gaussians import GaussianParams
    return S.from_params(GaussianParams(**{f: p[f].clone() for f in FIELDS}))


def leaf_norms(d: dict) -> dict:
    return {f: float(torch.linalg.vector_norm(d[f].double())) for f in FIELDS}


def run(ctx) -> dict:
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    fc, tc = cfg["frame"], cfg["train"]
    W, H = fc["width"], fc["height"]
    views = tc["views"]
    arrays = refcam.ring_arrays(2 * np.pi * np.arange(views) / views, W, H)
    sc, p0 = initial_state(cfg, ctx.seed, dev)
    gts = ground_truth(sc, arrays, cfg, dev)
    del sc
    from benchmark.runners.frame_loop import program_cameras
    cams = program_cameras(arrays, W, H, dev)
    stack = ViewStack(views, derived_seed(ctx.seed, 4))
    step = program_step(cfg, mix, dev)
    state = program_state(p0)

    # The first steps go through the window's own call and feed; the
    # check keeps their losses, the first gradient as Adam's first moment
    # holds it, and the change after three steps.
    beta1 = tc["optim"]["beta1"]
    order, losses, prog = [], [], {}
    for it in range(1, mix["first_steps"] + 1):
        v = stack.pop()
        order.append(v)
        state, aux = step(state, cams[v], gts[v], it)
        losses.append(float(aux["loss"]))
        if it == 1:
            prog["grad1"] = leaf_norms({f: state.opt.mu[f] / (1 - beta1)
                                        for f in FIELDS})
        if it == 3:
            prog["delta3"] = leaf_norms({f: getattr(state.params, f).detach()
                                         - p0[f] for f in FIELDS})
    prog["loss"] = losses[:3]
    # Warm-up: more steps until warmup_s has passed, so that the card's
    # clocks settle before the window.
    t_warm = time.perf_counter() + mix["warmup_s"]
    while time.perf_counter() < t_warm:
        v = stack.pop()
        it += 1
        state, aux = step(state, cams[v], gts[v], it)
        float(aux["loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cap = mix["max_window_steps"]
    ovf = torch.zeros(cap, dtype=torch.int32, device=dev)
    bad = torch.zeros(cap, dtype=torch.int32, device=dev)
    call = []
    setup_s = harness.process_age_s()
    steps = 0
    gc.disable()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while True:
        v = stack.pop()
        it += 1
        t0 = time.perf_counter()
        state, aux = step(state, cams[v], gts[v], it)
        call.append(time.perf_counter() - t0)
        ovf[steps:steps + 1].copy_(aux["overflow"].reshape(1))
        bad[steps:steps + 1].copy_(aux["nonfinite"].reshape(1))
        loss = float(aux["loss"])
        steps += 1
        t_end = time.perf_counter()
        if not loss == loss or abs(loss) == float("inf"):
            bad[steps - 1:steps].fill_(1)
        if t_end >= deadline or steps >= cap:
            break
    gc.enable()
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    failed = int(((ovf[:steps] > 0) | (bad[:steps] > 0)).sum())
    e2e = {"step_ms": (t_end - t_start) / steps * 1e3, "setup_s": setup_s}
    data = {"unit": "step", "kind": mix["step"],
            "host_ms": float(np.mean(call)) * 1e3,
            "steps_per_s": steps / (t_end - t_start)}

    prof_views = []
    if ctx.trace and dev.type == "cuda":
        from torch.profiler import record_function
        holder = {"state": state, "it": it}

        def run_steps():
            for _ in range(mix["profile_steps"]):
                with record_function("step"):
                    with record_function("traffic"):
                        v = stack.pop()
                        prof_views.append(v)
                        holder["it"] += 1
                    st, ax = step(holder["state"], cams[v], gts[v],
                                  holder["it"])
                    with record_function("synchronize"):
                        float(ax["loss"])
                    holder["state"] = st
            return mix["profile_steps"]
        data["profile"] = devtrace.profile(run_steps, "step")
        data["own_kernels"] = devtrace.own_kernels()

    del step, state, aux, cams
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings, work = check(ctx, cfg, arrays, gts, order, p0, prog,
                           prof_views[-mix["profile_steps"]:])
    readings["failed_steps"] = failed
    data["work"] = work
    return {"e2e": e2e, "attempted": steps, "failed": failed,
            "readings": readings, "data": data, "peak": peak}


def follow(cfg: dict, mix: dict, arrays, gts, order, p0: dict, dev, dtype,
           half_rows: bool = False, unchanged: bool = False) -> dict:
    """The reference's first three steps from p0 on the views `order`:
    {"loss": [3], "grad1": leaf norms of the first gradient as the
    optimizer takes it (a frozen field's is zero), "delta3": leaf
    norms}. The faults: `half_rows` takes each loss over the top half of
    the image, `unchanged` returns each step's state as it was given."""
    fc, tc = cfg["frame"], cfg["train"]
    p, st = dict(p0), ref.init_state(p0, dtype)
    obj, fz = objective(cfg, mix, dev, dtype), frozen(mix)
    losses = []
    for it, v in enumerate(order[:3], start=1):
        cam = refcam.ref_camera(arrays, v, fc["width"], fc["height"], dev)
        new_p, new_st, loss, grads = ref.step(p, st, cam, gts[v], it, fc,
                                              tc, obj, dtype, half_rows, fz)
        if not unchanged:
            p, st = new_p, new_st
        elif it == 1:
            g1_state = new_st
        losses.append(loss)
        if it == 1:
            g1 = leaf_norms({f: grads[f] * (f not in fz) for f in FIELDS})
    if unchanged:
        # The optimizer's state is the one handed back: no step taken.
        g1 = leaf_norms({f: g1_state["mu"][f] * 0 for f in FIELDS})
    return {"loss": losses, "grad1": g1,
            "delta3": leaf_norms({f: p[f].float() - p0[f] for f in FIELDS})}


def gaps(got: dict, want: dict, fz=()) -> dict:
    """The readings compared: the widest relative gap of the three losses,
    and by the worst leaf the gap between the norms of the first gradient
    and of the change after three steps, each against the reference's
    norm of that leaf or of the median leaf, whichever is larger; leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out, and so are the fields the step keeps frozen (`fz`)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                    want["loss"]))
    trained = [f for f in FIELDS if f not in fz]
    med_g = float(np.median([want["grad1"][f] for f in trained]))
    med_d = float(np.median([want["delta3"][f] for f in trained]))
    live = [f for f in trained if want["grad1"][f] >= 1e-3 * med_g]
    grad = max(abs(got["grad1"][f] - want["grad1"][f])
               / max(want["grad1"][f], med_g) for f in live)
    delta = max(abs(got["delta3"][f] - want["delta3"][f])
                / max(want["delta3"][f], med_d) for f in live)
    return {"loss_rel_gap": loss, "grad1_leaf_gap": grad,
            "delta3_leaf_gap": delta}


def step_work(cfg: dict, mix: dict, arrays, p0: dict, view: int,
              dev) -> dict:
    """The reference's counts of one step's work on `view` (the state's
    drift over the window moves them little)."""
    fc = cfg["frame"]
    cam = refcam.ref_camera(arrays, view, fc["width"], fc["height"], dev)
    d = 2 ** cfg["train"]["hvs_levels"]
    work = {"params": sum(p0[f].numel() for f in FIELDS
                          if f not in frozen(mix)),
            "pyramid_pixels": (-(-fc["height"] // d) * d)
            * (-(-fc["width"] // d) * d)}
    with torch.no_grad():
        ref.render(p0, cam, fc, work=work)
    return work


def check(ctx, cfg, arrays, gts, order, p0, prog, work_views) -> tuple:
    """The readings of the program's first three steps against the
    reference's, and the work counts of `work_views`."""
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix = ctx.cell.traffic
    want = follow(cfg, mix, arrays, gts, order, p0, dev, torch.float32)
    if ctx.control in ("half-batch", "unchanged"):
        prog = follow(cfg, mix, arrays, gts, order, p0, dev, torch.float32,
                      half_rows=ctx.control == "half-batch",
                      unchanged=ctx.control == "unchanged")
    elif ctx.control is not None:
        prog = follow(cfg, mix, arrays, gts, order, p0, dev, ctx.control)
    print(f"program {prog}\nreference {want}", file=sys.stderr, flush=True)
    return gaps(prog, want, frozen(mix)), [
        step_work(cfg, mix, arrays, p0, v, dev) for v in work_views]
