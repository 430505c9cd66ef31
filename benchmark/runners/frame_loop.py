"""A display loop: a closed loop with one frame in flight.

The traffic file gives the head path and, for a foveated frame, the gaze
path; both are drawn from the seed in blocks that hold the same set of
fixation points, fixation lengths and head speeds in another order, so
any seed asks for the same work. The trace is made at set-up as the
program's camera objects and gaze tensors on the device. Each frame of
the window hands the next camera and gaze to the program's graphed
render and waits for it (torch.cuda.synchronize); its latency runs from
the call to the end of that wait. After the window, each frame's
overflow and image sum (recorded on the device as the window ran) count
the frames that failed, and a seeded sample of the window's frames is
compared with the plain reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark import devtrace, harness
from benchmark.reference import camera as refcam
from benchmark.reference import frames as ref_frames
from benchmark.reference import proxy


# --- traffic ----------------------------------------------------------

def _blocks(rng, count: int, block: int):
    """`count` indices into a block of `block` stratified values, each
    block a fresh permutation."""
    return np.concatenate([rng.permutation(block)
                           for _ in range(-(-count // block))])[:count]


def trace(mix: dict, seed: int) -> dict:
    """The seeded head angles (F,) in radians (0 at the proxy camera's
    eye) and gazes (F, 2) of a mix."""
    rng = np.random.default_rng(seed)
    F = mix["trace_frames"]
    g = mix.get("gaze")
    head = mix["head"]
    side = int(round(math.sqrt(mix["block"])))
    B = side * side
    n_fix = F // 8 + 2
    order = _blocks(rng, n_fix, B)
    lo, hi = head["speed_deg_s"]
    speeds = np.linspace(lo, hi, B)[_blocks(rng, n_fix, B)]
    if g is None:
        fix_len = np.full(n_fix, 40)
        points = np.full((n_fix, 2), 0.5)
    else:
        fl, fh = g["fixation_frames"]
        fix_len = np.round(np.linspace(fl, fh, B)).astype(int)[
            _blocks(rng, n_fix, B)]
        b0, b1 = g["box"]
        cell = (b1 - b0) / side
        cx, cy = order % side, order // side
        points = np.stack([b0 + (cx + rng.uniform(0, 1, n_fix)) * cell,
                           b0 + (cy + rng.uniform(0, 1, n_fix)) * cell], 1)
    gazes, speed = [], []
    prev = points[0]
    for k in range(n_fix):
        sac = 0 if (g is None or k == 0) else g["saccade_frames"]
        t = (np.arange(1, sac + 1) / (sac + 1))[:, None]
        path = prev + (points[k] - prev) * t
        dwell = points[k] + (rng.normal(0, g["jitter"], (fix_len[k], 2))
                             if g is not None else 0.0)
        gazes.append(np.concatenate([path, np.broadcast_to(
            dwell, (fix_len[k], 2))]))
        speed.append(np.full(sac + fix_len[k], speeds[k]))
        prev = points[k]
    gaze = np.clip(np.concatenate(gazes)[:F], 0.0, 1.0).astype(np.float32)
    step = np.radians(np.concatenate(speed)[:F]) / head["trace_hz"]
    angles = np.concatenate([[0.0], np.cumsum(step)[:-1]])
    return {"angles": angles, "gazes": gaze}


def sample_frames(mix: dict, tr: dict, seed: int) -> list:
    """The window's frames the check compares: `count` drawn from the
    seed among the first `pool`, and for a gaze trace the frame whose
    gaze lies nearest the centre (the most pairs)."""
    s = mix["sample"]
    rng = np.random.default_rng([seed, 1])
    pick = set(rng.choice(s["pool"], s["count"], replace=False).tolist())
    if mix.get("gaze") is not None:
        d = np.abs(tr["gazes"][:s["pool"]] - 0.5).max(1)
        pick.add(int(d.argmin()))
    return sorted(pick)


def profiled_frames(mix: dict, seed: int) -> list:
    rng = np.random.default_rng([seed, 2])
    return rng.choice(mix["trace_frames"], mix["profile_frames"],
                      replace=False).tolist()


# --- the program's side -----------------------------------------------

def program_frame(cfg: dict, mix: dict, sc: dict, dev):
    """The program's frame entry for the configuration: render(camera,
    gaze) -> dict, a CUDA graph on the card (eager on the CPU)."""
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    fc = cfg["frame"]
    rc = RasterizeConfig(pair_capacity=fc["pair_capacity"],
                         compact_capacity=fc["compact_capacity"],
                         compact_table=fc["compact_table"],
                         power_cutoff=fc["power_cutoff"])
    if mix["frame"] == "ours":
        from fovsplat_torch.eval import fps
        from fovsplat_torch.ops.foveated import pack_fov_model
        from fovsplat_torch.ops.foveation import FoveationConfig
        model = pack_fov_model(sc["means"], sc["scales"], sc["rotations"],
                               sc["opacities4"], sc["shs_dcs"],
                               sc["shs_rest"], sc["highest_levels"])
        return fps.make_fov_render(model, rc, FoveationConfig(
            **fc["foveation"]), alpha=fc["alpha"], mode="ours")
    if mix["frame"] == "ps1":
        from fovsplat_torch.ops.rasterize import (pack_ps1_model,
                                                  rasterize_ps1_soa)
        from fovsplat_torch.utils.graphs import graphed_frame
        model = pack_ps1_model(sc["means"], sc["scales"], sc["rotations"],
                               sc["opacity"], sc["shs_dcs"][:, 0:1],
                               sc["shs_rest"])

        def render(camera, _gaze):
            return rasterize_ps1_soa(model, camera, config=rc)
        return render if dev.type == "cpu" else graphed_frame(render)
    raise ValueError(f"unknown frame {mix['frame']!r}")


def program_cameras(arrays: dict, width: int, height: int, dev) -> list:
    """The trace's cameras as the program's Camera objects, their tensors
    views of four uploads."""
    from fovsplat_torch.data.cameras import Camera
    wv = torch.as_tensor(arrays["world_view"], device=dev)
    fp = torch.as_tensor(arrays["full_proj"], device=dev)
    cc = torch.as_tensor(arrays["cam_center"], device=dev)
    tx = torch.as_tensor(arrays["tan_fovx"], device=dev)
    ty = torch.as_tensor(arrays["tan_fovy"], device=dev)
    return [Camera(wv[i], fp[i], cc[i], tx, ty, width, height)
            for i in range(wv.shape[0])]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    """Set-up, the window, the traced window (ctx.trace), and the check.
    Returns the runner's result: end_to_end values, attempted, failed,
    the readings compared, the per-layer data and the memory peak."""
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    fc = cfg["frame"]
    W, H = fc["width"], fc["height"]
    tr = trace(mix, ctx.seed)
    F = len(tr["angles"])
    arrays = refcam.ring_arrays(tr["angles"], W, H)
    sample = sample_frames(mix, tr, ctx.seed)

    # The weights, on the device from the seed; the program packs them.
    sc = proxy.bicycle_proxy(fc["points"], ctx.seed, dev, cfg["pnum"])
    render = program_frame(cfg, mix, sc, dev)
    del sc
    cams = program_cameras(arrays, W, H, dev)
    gazes = torch.as_tensor(tr["gazes"], device=dev)
    gz = [gazes[i] for i in range(F)]
    # Warm-up: the capture, then frames for warmup_s seconds so that the
    # card's clocks settle before the window.
    t_warm = time.perf_counter() + mix["warmup_s"]
    i = 0
    while i < mix["warmup_frames"] or time.perf_counter() < t_warm:
        render(cams[i % F], gz[i % F])
        _sync(dev)
        i += 1
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cap = mix["max_window_frames"]
    ovf = torch.zeros(cap, dtype=torch.int32, device=dev)
    sums = torch.zeros(cap, dtype=torch.float32, device=dev)
    lat, call = [], []
    kept = {}
    want = set(sample)
    setup_s = harness.process_age_s()
    i = 0
    gc.disable()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while True:
        j = i % F
        t0 = time.perf_counter()
        out = render(cams[j], gz[j])
        t1 = time.perf_counter()
        _sync(dev)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        call.append(t1 - t0)
        if i < cap:
            ovf[i:i + 1].copy_(out["overflow"].reshape(1))
            torch.sum(out["render"].reshape(-1), 0, keepdim=True,
                      out=sums[i:i + 1])
        if i in want:
            kept[i] = out
        i += 1
        if t2 >= deadline or i >= cap:
            break
    gc.enable()
    t_end = t2
    frames = i
    # Sampled frames past the window's end are rendered now, untimed.
    while i <= max(want):
        out = render(cams[i % F], gz[i % F])
        if i in want:
            kept[i] = out
        i += 1
    _sync(dev)
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    n = min(frames, cap)
    bad = ((ovf[:n] > 0) | ~torch.isfinite(sums[:n])).sum()
    failed = int(bad)

    e2e = {"fps": frames / (t_end - t_start),
           "frame_ms_p95": float(np.percentile(np.array(lat) * 1e3, 95)),
           "setup_s": setup_s}
    data = {"unit": "frame", "host_ms": float(np.mean(call)) * 1e3,
            "fps": e2e["fps"],
            "kind": mix["frame"]}

    prof_idx = profiled_frames(mix, ctx.seed)
    if ctx.trace and dev.type == "cuda":
        from torch.profiler import record_function

        def run16():
            for j in prof_idx:
                with record_function("frame"):
                    with record_function("traffic"):
                        c, g = cams[j], gz[j]
                    out = render(c, g)
                    with record_function("synchronize"):
                        torch.cuda.synchronize(dev)
            return len(prof_idx)
        data["profile"] = devtrace.profile(run16, "frame")
        data["own_kernels"] = devtrace.own_kernels()

    outs = {k: (v["render"], int(v["num_pairs"]), int(v["overflow"]))
            for k, v in kept.items()}
    del render, kept, out, cams, gz, gazes, ovf, sums
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings, work = check(ctx, cfg, mix, arrays, tr, outs,
                           prof_idx if ctx.trace else [])
    readings["failed_frames"] = failed
    data["work"] = work
    return {"e2e": e2e, "attempted": frames, "failed": failed,
            "readings": readings, "data": data, "peak": peak}


def reference_frame(cfg, mix, sc, arrays, tr, i, dev, dtype):
    fc = cfg["frame"]
    cam = refcam.ref_camera(arrays, i, fc["width"], fc["height"], dev)
    if mix["frame"] == "ours":
        gaze = torch.as_tensor(tr["gazes"][i], device=dev)
        return ref_frames.ours_frame(sc, cam, gaze, fc, dtype)
    return ref_frames.ps1_frame(sc, cam, fc, dtype)


def check(ctx, cfg, mix, arrays, tr, outs: dict, work_frames) -> tuple:
    """The plain reference, run after the window on the same seed's
    weights: the sampled frames' widest pixel gap and pair-count gap, and
    the work counts of `work_frames`."""
    dev = ctx.device
    if isinstance(ctx.control, str):
        raise ValueError(f"control {ctx.control!r} is a train cell's fault")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = proxy.bicycle_proxy(cfg["frame"]["points"], ctx.seed, dev,
                             cfg["pnum"])
    img_gap, pair_gap, works = 0.0, 0, {}
    F = len(tr["angles"])
    for i, (img, pairs, _ovf) in outs.items():
        ref, counts, work = reference_frame(cfg, mix, sc, arrays, tr, i % F,
                                            dev, torch.float32)
        works[i % F] = work
        if ctx.control is not None:
            img, counts_c, _ = reference_frame(cfg, mix, sc, arrays, tr,
                                               i % F, dev, ctx.control)
            pairs = counts_c["num_pairs"]
        gap = float((img.float() - ref).abs().max())
        img_gap = max(img_gap, gap if gap == gap else float("inf"))
        pair_gap = max(pair_gap, abs(pairs - counts["num_pairs"]))
        print(f"frame {i}: image gap {gap!r}, pairs {pairs} vs "
              f"{counts['num_pairs']}", file=sys.stderr, flush=True)
    work_list = []
    for j in work_frames:
        if j not in works:
            works[j] = reference_frame(cfg, mix, sc, arrays, tr, j, dev,
                                       torch.float32)[2]
        work_list.append(works[j])
    return {"image_max_abs": img_gap, "num_pairs_gap": pair_gap}, work_list
