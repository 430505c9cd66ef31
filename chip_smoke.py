#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port renders (the foveated
"ours" frame and the PS1, SM-FR and MM-FR inference frames), trains,
prunes and masks on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels of fovsplat_torch/csrc
into build/kernels first. Phases, one JSON line each on stdout:

  1. device: torch's name for the card and nvidia-smi's name and power
     limit (also printed raw on a line of its own);
  2. build: nvcc time for the eight sources (nine kernels);
  3. the frame's kernels 1-3 against their plain PyTorch versions on the
     card, at the frame's shapes (the 1,161,358-Gaussian bicycle proxy at
     1237x822, centre gaze, alpha 0.05; kernel 2 also at gaze (0.2, 0.2),
     every output bit for bit and two launches bit-identical) and, for
     the blend, also on the 150k proxy at 656x528 (two launches
     bit-identical). Integer outputs and the kept count must match
     exactly, float outputs within the tolerances below;
  4. the train step's kernels 4-7 against their plain versions at the
     step's full-width shapes (the permuted proxy of bench.py's train leg,
     1<<22 + N candidates, 3,145,728 kept): kernel 4 exact (rows, keys,
     two launches; also with a pair_capacity that ends inside a rect and
     a cap_out at half the kept count), the blend forward
     within T_EPS, the backward's per-pair rows within 1e-4 of each row's
     largest value, the gid reduce within 1e-5 of the largest sum and
     bit-identical over two launches;
  5. the frame path: the foveated "ours" frame at full width over the 9
     gazes (3 warm-ups, 20 timed reps each) through eval/fps.py, with every
     launch counter set to 0 just before and read just after; kernels 1-3
     must have launched, overflow must be 0 and the image finite; then
     the frame's times through the harness in both forms, batched and
     synchronised after every rep (the JAX harness's form, its keys
     "per_gaze" and "avg" checked);
  6. a torch.profiler window over 10 centre-gaze frames: device time by
     kernel and the device's idle share;
  7. the frame on the card against the same frame on the CPU (plain
     versions) on a small input;
  8. the inference kernels against their plain versions at the PS1
     frame's full-width shapes (the proxy as a PS1 model, 1237x822, the
     train capacities): kernel 1's ps1 mode (integer rows and cum exact,
     floats 1e-5 relative), kernel 4's quantized rows (kept count, tiles,
     depths, sorted keys and the five rows bit-identical, also at cut
     capacities as in phase 4), kernel 5q
     within T_EPS on the full and on emptied segments, kernel 9
     bit-identical on the ps1 table and on the frame's fov table;
  9. the PS1 frame at full width, compaction off and on, 3 warm-ups and
     20 timed frames each, counters set to 0 before and read after: both
     images bit-identical with equal num_pairs, overflow 0, kernels 1p,
     4q, 5q (and 9 with compaction) launched; then its times in both
     harness forms, as in phase 5, and a profiler window over 10 frames;
 10. the PS1 frame on the card against the CPU at 20k / 320x224 (within
     1e-4) and against the port's f32 train-route rasterize of the same
     model (above 40 dB);
 11. kernel 2 against its plain version on the SM-FR table (L_lay = 1)
     at the centre gaze, bit for bit; the SM-FR frame over the 9 gazes at
     full width (the frame's proxy and capacities, shared colours),
     counters set to 0 before and read after; at the centre gaze the
     shared and broadcast packings render bit-identical images;
 12. the MM-FR frame over the 9 gazes at full width: the four level
     models of bench.py:255-268, per-level capacities sized from probe
     runs as bench.py:299-331 does, overflow 0 on every pass; then a
     profiler window over 3 centre-gaze frames;
 13. the train path: the photometric train step at full width, 3 warm-up
     and 10 timed steps (CUDA events), with every launch counter set to 0
     just before and read just after; kernels 4-7 must have launched, and
     every step must report overflow 0, nonfinite 0 and a finite loss;
 14. determinism: two gradient evaluations of the same state on the card
     are bit-identical;
 15. the train step on the card against the CPU plain path on the 20k
     proxy at 320x224: loss within 1e-5 relative, gradients scaled by
     their largest value within rtol 2e-3, atol 2e-4;
 16. a torch.profiler window over 3 train steps;
 17. kernel 8 (the stats blend) against its plain version on the score
     pass's own pairs at the train phase's shapes: best_lane, first_trig
     and the touched and geo_win rows exact, the float rows and best_w
     within 1e-5 relative, colour and T within T_EPS; then kernel 7 on
     the score view's argmax stream (1,038,336 lanes, one row) as on the
     train stream;
 18. the score pass at full width: one score view per metric
     (max_comp_efficiency, max_contrib, surface), timed, with the launch
     counters set to 0 just before and read just after; two runs give
     bit-identical scores; then the card against the CPU at 20k / 320x224
     (gs_count exact, contribs and scores within 1e-5 relative);
 19. the model-building chain at full width (scripts/onchip_pipeline.py's
     chain, port only): ground truth rendered from the proxy on 6 ring
     cameras (4 train, 2 test), a seeded perturbation as the student,
     prune_training to 0.99 of its SSIM and PSNR, three chained
     mask_training layers at pooling 3, 7 and 12 against PS1's HVS at
     pooling 1, compose_layers and one foveated frame of the composed
     model; every counter set to 0 before and read after. Every step must
     report overflow 0, nonfinite 0 and a finite loss, the live masks
     must nest, masking must leave xyz, scaling, rotation and
     features_rest bit-unchanged, and the frame must be finite;
 20. one masked HVS step on the card against the CPU at 20k / 320x224:
     loss within 1e-5 relative, DC and opacity gradients as in phase 15;
 21. torch.profiler windows over one score view and one HVS step (with
     the HVS step's time without the profiler, CUDA events over 3);
 22. the kernels line: per kernel (1-9, and 1p, 4q, 5q, and kernel 7's
     argmax stream) its launches on its path, time (CUDA events over 20
     calls), own device time (device_ms, a profiler window over 20
     more, split by CUDA kernel), plain time, bound and error, the
     index_add_ time of kernel 7's sums as its library time, and the
     torch.sort times of the frame's and the train route's keys as
     library rows.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero without that line, after printing
{"phase": "error", "at": <the last phase printed>, "error": <message>};
a machine without CUDA or a checkout without the package exits non-zero
too.
"""

import contextlib
import json
import math
import re
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
N_FULL = 1_161_358
W_FULL, H_FULL = 1237, 822
PAIR_CAPACITY = 2_490_368      # bench.py's probe capacities
COMPACT_CAPACITY = 1_769_472
ALPHA = 0.05
TABLE_RTOL = 1e-5              # kernel 1 float rows vs plain: relative
BLEND_ATOL = 1e-4              # kernel 3 vs plain: T_EPS
FRAME_ATOL = 1e-4              # card frame vs CPU frame
# bench.py:383-386 leg_train_step: pair_capacity 1 << 22. The JAX buffer
# holds that many candidates plus one dummy slot per row
# (binning.py:263-265); the port has no dummy pairs and counts real
# candidates only, so the same buffer is 1 << 22 + N real candidates.
TRAIN_PAIR_CAPACITY = (1 << 22) + N_FULL
TRAIN_COMPACT_CAPACITY = 3_145_728
BWD_RTOL = 1e-4                # kernel 6 vs plain, of each row's max
REDUCE_RTOL = 1e-5             # kernel 7 vs plain
LOSS_RTOL = 1e-5               # card step vs CPU step
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4   # scaled gradients, card vs CPU
STATS_RTOL = 1e-5              # kernel 8 float rows vs plain; card scores
                               # vs CPU scores
METRICS = ("max_comp_efficiency", "max_contrib", "surface")
# The chain's capacities: the 6 ring cameras see the proxy from other
# sides than the train phase's camera, so it gets headroom over the
# train phase's 1 << 22 + N candidates and 3,145,728 kept pairs.
CHAIN_PAIR_CAPACITY = 1 << 23
CHAIN_COMPACT_CAPACITY = 6 << 20


# The phase of the last line emitted, for the error line.
_last_phase = ["start"]


def emit(obj):
    if "phase" in obj:
        _last_phase[0] = " ".join(str(obj[k]) for k in ("phase", "kernel",
                                                         "path")
                                  if k in obj)
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean ms of fn() over `reps` launches, timed with CUDA events after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def own_kernel_names():
    """The __global__ functions of fovsplat_torch/csrc: the port's own
    kernels, as the profiler names them."""
    from fovsplat_torch.ops.kernels import _build
    names = set()
    for src in sorted(_build.CSRC.glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    return names


def device_ms(fn, reps):
    """The kernel's own device time per call: the CUDA time of the port's
    kernels (own_kernel_names, not the allocations or torch ops of the
    wrapper) in a torch.profiler window over `reps` calls of fn(), after
    one warm-up call. Each kernel name counts its mean time per event
    times its launches per call (its events over `reps`, rounded, at
    least 1), so an event the profiler drops does not shorten the time.
    Returns (ms, events seen, ms per call by kernel name). Raises if the
    window holds none of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(r"\b(%s)\s*[(<]" % "|".join(sorted(own_kernel_names())))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        m = pat.search(e.name)
        if e.device_type == DeviceType.CUDA and "at::" not in e.name and m:
            by_name.setdefault(m.group(1), []).append(
                e.time_range.elapsed_us())
    if not by_name:
        raise AssertionError("the profiler window holds none of the port's "
                             "kernels")
    split = {k: sum(t) / len(t) * max(1, round(len(t) / reps)) / 1e3
             for k, t in by_name.items()}
    return (sum(split.values()), sum(len(t) for t in by_name.values()),
            split)


def kernel_times(fn, reps=20):
    """{"ms": CUDA-event mean over `reps` calls of the wrapper, "device_ms":
    the kernel's own device time per call over another `reps`,
    "device_events": the kernel events that window saw, "device_split":
    device ms per call by kernel name}."""
    dev_ms, events, split = device_ms(fn, reps)
    return {"ms": cuda_ms(fn, reps), "device_ms": dev_ms,
            "device_events": events, "device_split": split}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / F32_FLOP_PER_S * 1e3
    return (o_ms, "operations") if o_ms > b_ms else (b_ms, "bytes")


def frame_inputs(n, width, height, gaze, device):
    """Packed proxy model, camera and the pre-kernel per-tile state."""
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import foveation
    sc = proxy.bicycle_proxy(n=n, seed=0)
    model = convert.fov_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=device)
    cam = proxy.proxy_camera(width=width, height=height, device=device)
    levels = foveation.compute_tile_levels(
        torch.tensor(gaze, dtype=torch.float32, device=device), width,
        height, ALPHA)
    gx, gy = (width + 15) // 16, (height + 15) // 16
    bbox = fov.level_bboxes(levels, gx, gy, 4)
    return model, cam, levels, bbox, gx, gy


def blend_inputs(model, cam, levels, bbox, gx, gy):
    """Sorted pairs and activity masks for the blend, through the kernels,
    exactly as rasterize_fov_soa builds them."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import foveation
    from fovsplat_torch.ops.kernels.build_table import build_table
    from fovsplat_torch.ops.kernels.expand_fov import expand_fov
    T = gx * gy
    table, cum, total = build_table(model, cam, bbox)
    ex = expand_fov(table, cum, levels, 4, gx, PAIR_CAPACITY,
                    COMPACT_CAPACITY)
    kept = torch.clamp(ex.kept[0], max=COMPACT_CAPACITY)
    key, dbits = fov.fused_key32(ex.tile, ex.depth, kept, T)
    pairs, seg = fov.sort_pairs(key, dbits, ex.attrs, T, False)
    grad_x, grad_y, _, tile_blend = foveation.compute_tile_level_infos(
        levels, cam.width, cam.height)
    _, l1, l2 = fov.chain_masks(levels, grad_x, grad_y, tile_blend)
    return pairs, seg, l1, l2


def check_table_and_expand(dev, results):
    """Kernels 1 and 2 (and the sort on their output) against their plain
    versions at the main path's shapes, centre gaze."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import foveation
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import expand_fov as ef
    model, cam, levels, bbox, gx, gy = frame_inputs(
        N_FULL, W_FULL, H_FULL, (0.5, 0.5), dev)
    T = gx * gy
    n = N_FULL

    tk, ck, totk = bt.build_table(model, cam, bbox)
    tp, cp, totp = bt.build_table_plain(model, cam, bbox)
    int_rows = [bt.ROW_RX0, bt.ROW_RY0, bt.ROW_RW, bt.ROW_TNUM, bt.ROW_HL,
                bt.ROW_VALID]
    for r in int_rows:
        bad = int((tk[r] != tp[r]).sum())
        if bad:
            raise AssertionError(f"build_table row {r}: {bad} of {n} differ")
    if not (torch.equal(ck, cp) and torch.equal(totk, totp)):
        raise AssertionError("build_table cumsum differs from the plain one")
    fl = [r for r in range(tk.shape[0]) if r not in int_rows]
    err = (tk[fl] - tp[fl]).abs()
    tab_err = float(err.max())
    rel = float((err / tp[fl].abs().clamp(min=1.0)).max())
    if not rel <= TABLE_RTOL:
        raise AssertionError(f"build_table float rows: rel err {rel}")
    tab_times = kernel_times(lambda: bt.build_table(model, cam, bbox))
    tab_plain_ms = cuda_ms(lambda: bt.build_table_plain(model, cam, bbox), 3)
    L = 4
    tab_bytes = n * (12 + 12 + 16 + 4 + 2 * (3 * 16 + 3 * L + L)) \
        + n * 4 * (bt.num_rows(L) + 1)
    # About 550 FLOP a Gaussian (counted from csrc/build_table.cu):
    # projection, EWA, rect and OBB ~290, degree-3 SH ~230, colours 36.
    tab_bound, tab_by = bound(tab_bytes, 550.0 * n)
    results["build_table"] = dict(
        launches=None, max_abs_err=tab_err, **tab_times,
        plain_ms=tab_plain_ms,
        bound_ms=tab_bound, bound_by=tab_by,
        shape=f"N={n}, {W_FULL}x{H_FULL}", total_candidates=int(totk))
    emit({"phase": "check", "kernel": "build_table", "rows_exact": int_rows,
          "float_rel_err": rel, "max_abs_err": tab_err,
          "candidates": int(totk)})

    kept, ek = check_expand_exact(tk, ck, levels, gx, "centre gaze")
    k = min(kept, COMPACT_CAPACITY)
    corner = foveation.compute_tile_levels(
        torch.tensor((0.2, 0.2), dtype=torch.float32, device=dev), W_FULL,
        H_FULL, ALPHA)
    tc, cc, _ = bt.build_table(model, cam, fov.level_bboxes(corner, gx, gy,
                                                            L))
    check_expand_exact(tc, cc, corner, gx, "gaze (0.2, 0.2)")
    del tc, cc
    args = (tk, ck, levels, L, gx, PAIR_CAPACITY, COMPACT_CAPACITY)
    exp_times = kernel_times(lambda: ef.expand_fov(*args))
    exp_plain_ms = cuda_ms(lambda: ef.expand_fov_plain(*args), 3)
    key, dbits = fov.fused_key32(ek.tile, ek.depth, torch.clamp(
        ek.kept[0], max=COMPACT_CAPACITY), T)
    sort_ms = cuda_ms(lambda: torch.sort(key, stable=True), 20)
    exp_bytes = tk.numel() * 4 + n * 4 + T * 4 + k * 4 * (3 + 13)
    # ~30 FLOP of OBB test and level cull per candidate pair walked.
    exp_bound, exp_by = bound(exp_bytes,
                              30.0 * min(int(totk), PAIR_CAPACITY))
    results["expand_fov"] = dict(
        launches=None, max_abs_err=0.0, **exp_times, plain_ms=exp_plain_ms,
        bound_ms=exp_bound, bound_by=exp_by,
        shape=f"N={n}, {W_FULL}x{H_FULL}, kept={kept}")
    results["torch.sort"] = dict(ms=sort_ms, lanes=COMPACT_CAPACITY)
    return model, cam, levels, bbox, gx, gy


def check_expand_exact(table, cum, levels, gx, tag):
    """Kernel 2 against its plain version on one table at the frame's
    capacities: kept, tile, gid, depth, attrs and the sorted keys,
    segments and rows bit for bit, and a second launch bit-identical to
    the first. Returns (kept, the kernel's output)."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.kernels import expand_fov as ef
    T = levels.shape[0]
    args = (table, cum, levels, 4, gx, PAIR_CAPACITY, COMPACT_CAPACITY)
    ek, again = ef.expand_fov(*args), ef.expand_fov(*args)
    ep = ef.expand_fov_plain(*args)
    kept = int(ek.kept)
    k = min(kept, COMPACT_CAPACITY)
    same = {"kept": kept == int(ep.kept) == int(again.kept)}
    for name in ("tile", "gid", "depth", "attrs"):
        a, b, c = (getattr(e, name)[..., :k] for e in (ek, ep, again))
        same[name] = bool(torch.equal(a, b) and torch.equal(a, c))
    keys = []
    for e in (ek, ep):
        key, dbits = fov.fused_key32(e.tile, e.depth, torch.clamp(
            e.kept[0], max=COMPACT_CAPACITY), T)
        pairs, seg = fov.sort_pairs(key, dbits, e.attrs, T, True)
        keys.append((torch.sort(key).values, seg, pairs[:, :k]))
    same["sorted_keys"] = all(torch.equal(a, b) for a, b in zip(*keys))
    emit({"phase": "check", "kernel": "expand_fov", "shape": tag,
          "table_rows": table.shape[0], "kept": kept, "exact": same})
    if not all(same.values()):
        raise AssertionError(f"expand_fov {tag}: {same}")
    return kept, ek


def check_blend(tag, inputs, reps):
    """Kernel 3 against its plain version on the same sorted pairs."""
    import torch
    from fovsplat_torch.ops.kernels import blend_fov as bf
    pairs, seg, l1, l2 = blend_inputs(*inputs)
    gx = inputs[4]
    ok_ = bf.blend_fov(pairs, seg, l1, l2, gx)
    again = bf.blend_fov(pairs, seg, l1, l2, gx)
    op_ = bf.blend_fov_plain(pairs, seg, l1, l2, gx, return_walked=True)
    walked = op_[4]
    err = max(float((a - b).abs().max()) for a, b in zip(ok_, op_[:4]))
    twice = all(torch.equal(a, b) for a, b in zip(ok_, again))
    emit({"phase": "check", "kernel": "blend_fov", "shape": tag,
          "max_abs_err": err, "tol": BLEND_ATOL,
          "bit_identical_twice": twice})
    if not (err <= BLEND_ATOL and twice):
        raise AssertionError(f"blend_fov {tag}: max abs err {err}, "
                             f"bit-identical twice {twice}")
    times = kernel_times(lambda: bf.blend_fov(pairs, seg, l1, l2, gx), reps)
    plain_ms = cuda_ms(lambda: bf.blend_fov_plain(pairs, seg, l1, l2, gx), 1)
    T = l1.shape[0]
    kept = int(seg[-1])
    nbytes = kept * 13 * 4 + (T + 1) * 4 + 2 * T * 256 + T * 8 * 256 * 4
    # Per pair and pixel walked: 11 FLOP of power, 2 compares, the exp and
    # ~10 FLOP per active chain; counted as 25.
    bound_ms, bound_by = bound(nbytes, 25.0 * float(walked.double().sum()))
    return dict(launches=None, max_abs_err=err, **times, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                shape=tag, pair_pixels_walked=int(walked.long().sum()))


def profile_window(fn, iters):
    """Device time by kernel name, and the device's idle share of the wall
    time, over `iters` calls of fn() under torch.profiler (which adds host
    overhead of its own), after 3 warm-up calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # Device time of the kernels each host-side torch op launched itself
    # (key_averages also lists the kernels as entries of their own).
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    return {"iters": iters, "wall_ms_per_iter": wall_us / iters / 1e3,
            "device_busy_ms_per_iter": busy_us / iters / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if by_name
            else None,
            "kernel_events": sum(c for _, c in by_name.values()),
            "top": [{"name": k[:80], "ms_per_iter": us / iters / 1e3,
                     "launches_per_iter": c / iters}
                    for k, (us, c) in top],
            "top_ops": [{"op": k, "device_ms_per_iter": us / iters / 1e3,
                         "calls_per_iter": c / iters}
                        for k, us, c in ops[:16]]}


def train_inputs(n, width, height, seed, device):
    """A capacity-n TrainerState of the permuted proxy (bench.py:355-371),
    its camera and the uniform ground truth of bench.py:374."""
    import numpy as np
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.models import state as S
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=seed))
    st = S.from_params(convert.params_from_numpy(**raw, device=device))
    cam = proxy.proxy_camera(width=width, height=height, device=device)
    gt = np.random.default_rng(1).uniform(0, 1, (height, width, 3))
    return st, cam, torch.tensor(gt, dtype=torch.float32, device=device)


def train_config(pair_capacity=TRAIN_PAIR_CAPACITY,
                 compact_capacity=TRAIN_COMPACT_CAPACITY):
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops
    return loops.LoopConfig(raster=RasterizeConfig(
        pair_capacity=pair_capacity, compact_capacity=compact_capacity))


def check_ps1_exact(table, cum, gx, T, pair_capacity, cap_out, quantize,
                    tag):
    """Kernel 4 (or 4q) against its plain version on one table: at the
    given capacities, kept, tile, depth, the attribute rows' bits and the
    sorted fused keys exact and a second launch bit-identical; the same
    with a pair_capacity that ends inside the rect of a Gaussian at the
    middle of the candidates, and with a cap_out at half the kept
    count. Returns (the kernel's output at the given capacities,
    kept)."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.kernels import expand_ps1 as ep1
    kind = "expand_ps1_q" if quantize else "expand_ps1"
    total = int(cum[-1]) + int(table[ep1.ROW_TNUM, -1])
    tnum = table[ep1.ROW_TNUM]
    mid = int(torch.searchsorted(cum, min(total, pair_capacity) // 2,
                                 right=True)) - 1
    big = torch.nonzero((tnum >= 4) & (torch.arange(
        cum.numel(), device=cum.device) >= mid))
    g = int(big[0]) if big.numel() else mid
    cut_cap = int(cum[g]) + max(int(tnum[g]) // 2, 1)
    report = {}
    first = None
    for case, pcap, cout in (("full", pair_capacity, cap_out),
                             ("pair_cut", cut_cap, cap_out),
                             ("out_cut", pair_capacity, None)):
        if cout is None:
            cout = max(int(first.kept) // 2, 1)
        args = (table, cum, gx, pcap, cout)
        ek = ep1.expand_ps1(*args, quantize=quantize)
        again = ep1.expand_ps1(*args, quantize=quantize)
        ep = ep1.expand_ps1_plain(*args, quantize=quantize)
        kept = int(ek.kept)
        k = min(kept, cout)
        same = {"kept": kept == int(ep.kept) == int(again.kept)}
        for name in ("tile", "depth", "attrs"):
            a, b, c = (getattr(e, name)[..., :k].contiguous().view(
                torch.int32) for e in (ek, ep, again))
            same[name] = bool(torch.equal(a, b) and torch.equal(a, c))
        keys = [torch.sort(fov.fused_key32(e.tile, e.depth, torch.clamp(
            e.kept[0], max=cout), T)[0]).values for e in (ek, ep)]
        same["sorted_keys"] = torch.equal(*keys)
        report[case] = {"pair_capacity": pcap, "cap_out": cout,
                        "kept": kept, "exact": same}
        if first is None:
            first = ek
        if not all(same.values()):
            emit({"phase": "check", "kernel": kind, "shape": tag, **report})
            raise AssertionError(f"{kind} {tag} ({case}) differs: {same}")
    emit({"phase": "check", "kernel": kind, "shape": tag,
          "candidates": total, **report})
    return first, int(first.kept)


def check_train_kernels(st, cam, gt, results):
    """Kernels 4-7 against their plain versions on the train step's own
    inputs at full width: the 19 columns of the state, the sorted pairs,
    the cotangent of the photometric loss of the forward's image, and
    the gid-sorted stream of the backward's rows."""
    import torch
    from fovsplat_torch.ops import blend, foveated as fov
    from fovsplat_torch.ops import projection, sh
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.kernels import blend_fwd as bfw
    from fovsplat_torch.ops.kernels import expand_ps1 as ep1
    from fovsplat_torch.train import losses
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    T, n, P = gx * gy, st.capacity, blend.PIX
    cap = TRAIN_COMPACT_CAPACITY
    p = st.params
    with torch.no_grad():
        prep = projection.preprocess_cols(p.xyz, p.get_scaling(),
                                          p.get_rotation(), cam,
                                          live_mask=st.live)
        colors = sh.sh_to_rgb(3, p.get_features(), p.xyz, cam.cam_center)
        cols = rast.train_columns(prep, p.get_opacity(), colors)
        table, cum, total = ep1.ps1_table(cols, prep.valid, prep.depth)

    # --- kernel 4
    args = (table, cum, gx, TRAIN_PAIR_CAPACITY, cap)
    ek, kept = check_ps1_exact(table, cum, gx, T, TRAIN_PAIR_CAPACITY, cap,
                               False, "train table")
    cand = int(total)
    k = min(kept, cap)
    nbytes = table.numel() * 4 + n * 4 + k * 48
    # ~30 FLOP of OBB test per candidate pair walked.
    b_ms, b_by = bound(nbytes, 30.0 * min(cand, TRAIN_PAIR_CAPACITY))
    results["expand_ps1"] = dict(
        max_abs_err=0.0, **kernel_times(lambda: ep1.expand_ps1(*args)),
        plain_ms=cuda_ms(lambda: ep1.expand_ps1_plain(*args), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"N={n}, {cam.width}x{cam.height}, candidates={cand}, "
              f"kept={kept}")

    key, dbits = fov.fused_key32(ek.tile, ek.depth,
                                 torch.clamp(ek.kept[0], max=cap), T)
    full, seg = fov.sort_pairs(key, dbits, ek.attrs, T, True)
    results["torch.sort train"] = dict(
        ms=cuda_ms(lambda: torch.sort((key.long() << 32) | dbits.long(),
                                      stable=True), 20), lanes=cap)
    pairs, num_pairs = full[:9], int(seg[-1])

    # --- kernel 5
    ck, Tk, nk = bfw.blend_forward(pairs, seg, gx)
    cp, Tp, ncp, walked = blend.blend_forward_plain(pairs, seg, gx,
                                                    return_walked=True)
    f_err = max(float((ck - cp).abs().max()), float((Tk - Tp).abs().max()))
    nc_diff = int((nk != ncp).sum())
    emit({"phase": "check", "kernel": "blend_forward", "num_pairs": num_pairs,
          "max_abs_err": f_err, "tol": BLEND_ATOL,
          "n_contrib_differing_pixels": nc_diff})
    if not f_err <= BLEND_ATOL or nc_diff > T * P // 1000:
        raise AssertionError(f"blend_forward: err {f_err}, {nc_diff} "
                             "n_contrib differ")
    nbytes = num_pairs * 36 + (T + 1) * 4 + T * P * 20
    b_ms, b_by = bound(nbytes, 25.0 * float(walked.double().sum()))
    results["blend_forward"] = dict(
        max_abs_err=f_err, **kernel_times(lambda: bfw.blend_forward(
            pairs, seg, gx)),
        plain_ms=cuda_ms(lambda: blend.blend_forward_plain(pairs, seg, gx),
                         1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{cam.width}x{cam.height}, pairs={num_pairs}",
        pair_pixels_walked=int(walked.long().sum()))

    # --- kernel 6, on the cotangent of the photometric loss
    tile_c = ck.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        img = blend.tiles_to_image(tile_c, gx, gy, cam.width, cam.height)
        g_c, = torch.autograd.grad(losses.photometric_loss(img, gt), tile_c)
    g_T = torch.zeros_like(Tk)
    bargs = (pairs, seg, gx, g_c, g_T, Tk, nk)
    gk = bfw.blend_backward(*bargs)
    gp = blend.blend_backward_plain(*bargs)
    row_max = gp.abs().amax(1)
    b_rel = float(((gk - gp).abs().amax(1) / row_max.clamp(min=1e-30))
                  .max())
    emit({"phase": "check", "kernel": "blend_backward",
          "max_rel_err_of_row_max": b_rel, "tol": BWD_RTOL,
          "row_max": [float(x) for x in row_max]})
    if not b_rel <= BWD_RTOL:
        raise AssertionError(f"blend_backward: rel err {b_rel}")
    # ~66 FLOP per pair and pixel up to the pixel's last contributor,
    # counted from csrc/blend_fwd.cu (its header), one expf counted as one.
    nbytes = num_pairs * 72 + T * P * 24
    b_ms, b_by = bound(nbytes, 66.0 * float(nk.double().sum()))
    results["blend_backward"] = dict(
        max_abs_err=float((gk - gp).abs().max()),
        **kernel_times(lambda: bfw.blend_backward(*bargs)),
        plain_ms=cuda_ms(lambda: blend.blend_backward_plain(*bargs), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{cam.width}x{cam.height}, pairs={num_pairs}",
        max_rel_err_of_row_max=b_rel,
        pair_pixels_to_last_contributor=int(nk.long().sum()))

    # --- kernel 7
    gid, vals = rast.gid_sorted_stream(gk, full[9].to(torch.int32),
                                       seg[-1], n)
    results["reduce_by_sorted_gid"] = check_reduce(
        gid, vals, n, f"train stream, N={n}, lanes={cap}")


def check_reduce(gid, vals, n, tag):
    """Kernel 7 against its plain version on one gid-sorted stream (within
    REDUCE_RTOL of the largest sum), two launches bit-identical, and its
    times beside index_add_'s over the same live lanes. Returns the row of
    the kernels line."""
    import torch
    from fovsplat_torch.ops.kernels import segment_reduce as sr
    rk = sr.reduce_by_sorted_gid(gid, vals, n)
    same = bool(torch.equal(rk, sr.reduce_by_sorted_gid(gid, vals, n)))
    rp = sr.reduce_by_sorted_gid_plain(gid, vals, n)
    r_err = float((rk - rp).abs().max())
    r_rel = r_err / max(float(rp.abs().max()), 1e-30)
    live_lanes = int((gid < n).sum())
    run_lens = torch.unique_consecutive(gid[:live_lanes],
                                        return_counts=True)[1]
    runs = run_lens.numel()
    longest = int(run_lens.max()) if runs else 0
    # The library call sums the live prefix as the kernel does (sending
    # the sentinel tail to one column costs index_add_ its atomics on one
    # address).
    gid_l, live_vals = gid[:live_lanes].long(), vals[:, :live_lanes]

    def library():
        out = torch.zeros((vals.shape[0], n), device=vals.device)
        return out.index_add_(1, gid_l, live_vals)
    lib_err = float((library() - rp).abs().max())
    times = kernel_times(lambda: sr.reduce_by_sorted_gid(gid, vals, n))
    lib_ms = cuda_ms(library, 20)
    rows = vals.shape[0]
    # Bytes: the gid and the value rows of each live lane in, every
    # output column out; one add per live value.
    b_ms, b_by = bound(live_lanes * 4 * (1 + rows) + n * 4 * rows,
                       float(rows * live_lanes))
    emit({"phase": "check", "kernel": "reduce_by_sorted_gid", "shape": tag,
          "rows": rows, "live_lanes": live_lanes, "runs": runs,
          "longest_run": longest, "max_abs_err": r_err,
          "rel_err_of_max": r_rel, "tol": REDUCE_RTOL,
          "bit_identical_twice": same, **times, "library_ms": lib_ms,
          "no_slower_than_library":
              max(times["ms"], times["device_ms"]) <= lib_ms})
    if not (r_rel <= REDUCE_RTOL and same):
        raise AssertionError(f"reduce_by_sorted_gid {tag}: rel err {r_rel}, "
                             f"bit-identical twice {same}")
    return dict(
        max_abs_err=r_err, **times,
        plain_ms=cuda_ms(lambda: sr.reduce_by_sorted_gid_plain(
            gid, vals, n), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library_max_abs_err=lib_err,
        shape=f"{tag}, live lanes={live_lanes}, runs={runs}, "
              f"longest run={longest}")


def run_train_path(st, cam, gt, cfg, kernels):
    """The main train path: 3 warm-up and 10 timed photometric steps at
    full width, every launch counter set to 0 just before and read just
    after. Returns (per-step rows, mean step ms, launches)."""
    import torch
    from fovsplat_torch.train import loops
    step = loops.make_photometric_step(cfg)
    for kf in kernels.values():
        kf.launches = 0
    torch.cuda.reset_peak_memory_stats()
    auxs, cur = [], st
    for i in range(3):
        cur, aux = step(cur, cam, gt, i)
        auxs.append(aux)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for i in range(3, 13):
        cur, aux = step(cur, cam, gt, i)
        auxs.append(aux)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 10
    launches = {name: kf.launches for name, kf in kernels.items()}
    rows = [{k: (float(v) if k == "loss" else int(v)) for k, v in a.items()}
            for a in auxs]
    for i, r in enumerate(rows):
        if not (r["overflow"] == 0 and r["nonfinite"] == 0
                and r["loss"] == r["loss"] and abs(r["loss"]) < float("inf")):
            raise AssertionError(f"train step {i}: {r}")
    return rows, start.elapsed_time(end) / 10, wall_ms, launches, \
        torch.cuda.max_memory_allocated()


def check_determinism(st, cam, gt, cfg):
    """Two gradient evaluations of one state give bit-identical results."""
    import torch
    from fovsplat_torch.train import loops
    a = loops.photometric_grads(st, cam, gt, cfg)
    b = loops.photometric_grads(st, cam, gt, cfg)
    same = {f: bool(torch.equal(a[1][f], b[1][f])) for f in a[1]}
    same["loss"] = bool(torch.equal(a[0], b[0]))
    emit({"phase": "determinism", "bit_identical": same})
    if not all(same.values()):
        raise AssertionError(f"gradients differ between two runs: {same}")


def train_vs_cpu(cfg):
    """The photometric gradients on the card against the CPU plain path on
    the 20k proxy at 320x224."""
    outs = []
    for d in ("cuda", "cpu"):
        from fovsplat_torch.train import loops
        st, cam, gt = train_inputs(20_000, 320, 224, 1, d)
        loss, grads, n_bad, out = loops.photometric_grads(st, cam, gt, cfg)
        outs.append((float(loss), {f: g.cpu() for f, g in grads.items()},
                     int(n_bad), int(out["binned"].num_pairs)))
    (lc, gc, bc, nc), (lh, gh, bh, nh) = outs
    loss_rel = abs(lc - lh) / abs(lh)
    worst = {}
    for f, g in gh.items():
        scale = float(g.abs().max()) or 1.0
        d = (gc[f] - g).abs() / scale
        worst[f] = float((d - GRAD_RTOL * (g.abs() / scale)).max())
    emit({"phase": "train_vs_cpu", "shape": "N=20000, 320x224",
          "loss": [lc, lh], "loss_rel_err": loss_rel, "num_pairs": [nc, nh],
          "nonfinite": [bc, bh], "grad_excess_over_rtol": worst,
          "tol": {"loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL,
                  "grad_atol": GRAD_ATOL}})
    if not (loss_rel <= LOSS_RTOL and bc == bh == 0
            and all(v <= GRAD_ATOL for v in worst.values())):
        raise AssertionError("card train step differs from the CPU step")


def check_stats_kernel(st, cam, results):
    """Kernel 8 against its plain version on the score pass's own pairs:
    the train phase's state, camera and capacities, binned by kernel 4."""
    import torch
    from fovsplat_torch.ops import binning, blend, projection, sh
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.kernels import blend_stats as bs
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    T, P = gx * gy, blend.PIX
    p = st.params
    with torch.no_grad():
        prep = projection.preprocess_cols(p.xyz, p.get_scaling(),
                                          p.get_rotation(), cam,
                                          live_mask=st.live)
        colors = sh.sh_to_rgb(3, p.get_features(), p.xyz, cam.cam_center)
        pairs, bn = binning.bin_fused_ps1(
            rast.train_columns(prep, p.get_opacity(), colors), prep.valid,
            prep.depth, gx, gy, TRAIN_PAIR_CAPACITY, TRAIN_COMPACT_CAPACITY)
    seg, num_pairs = bn.seg_start, int(bn.num_pairs)
    args = (pairs, seg, gx, cam.width, cam.height)
    k = bs.blend_stats(*args)
    q = blend.blend_stats_plain(*args, return_walked=True)
    walked = q[6]
    exact = {"best_lane": torch.equal(k[3], q[3]),
             "first_trig": torch.equal(k[5], q[5]),
             "touched": torch.equal(k[2][1], q[2][1]),
             "geo_win": torch.equal(k[2][3], q[2][3])}

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    floats = {"w_sum": rel(k[2][0], q[2][0]), "w_max": rel(k[2][2], q[2][2]),
              "best_w": rel(k[4], q[4])}
    # Lanes where both are 0 give 0/1e-30 = 0; a kernel value where the
    # plain one is 0 shows up as a huge relative error.
    blend_err = max(float((k[0] - q[0]).abs().max()),
                    float((k[1] - q[1]).abs().max()))
    # Operations counted in the header of csrc/blend_stats.cu, each on the
    # pair-pixels that need it: 13 FLOP per pair-pixel walked before the
    # pixel freezes, 5 more where the power lies in the window (geo_win),
    # 14 more where the pair contributes (touched), 3 per freezing pair.
    counts = {"pair_pixels_walked": int(walked.long().sum()),
              "pair_pixels_in_window": int(q[2][3].double().sum()),
              "pair_pixels_touched": int(q[2][1].double().sum()),
              "pixels_frozen": int((q[5] != blend.BIG).sum())}
    flop = (13 * counts["pair_pixels_walked"]
            + 5 * counts["pair_pixels_in_window"]
            + 14 * counts["pair_pixels_touched"] + 3 * counts["pixels_frozen"])
    nbytes = num_pairs * (36 + 16) + T * P * 28 + (T + 1) * 4
    emit({"phase": "check", "kernel": "blend_stats", "num_pairs": num_pairs,
          "exact": exact, "float_rel_err": floats, "blend_max_abs_err":
          blend_err, "tol": {"float_rtol": STATS_RTOL,
                             "blend_atol": BLEND_ATOL},
          **counts, "flop": flop, "bytes": nbytes})
    if not (all(exact.values()) and blend_err <= BLEND_ATOL
            and all(v <= STATS_RTOL for v in floats.values())):
        raise AssertionError("blend_stats differs from its plain version")
    err = max(blend_err, float((k[2] - q[2]).abs().max()),
              float((k[4] - q[4]).abs().max()))
    b_ms, b_by = bound(nbytes, float(flop))
    results["blend_stats"] = dict(
        max_abs_err=err, **kernel_times(lambda: bs.blend_stats(*args)),
        plain_ms=cuda_ms(lambda: blend.blend_stats_plain(*args), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{cam.width}x{cam.height}, pairs={num_pairs}")

    # --- kernel 7 on the score view's argmax stream, built as
    # ops/stats.py's loss_weighted_max_count builds it: each pixel's best
    # lane's Gaussian (n where the pixel has none), sorted stably; the
    # values are seeded uniform draws on the pixels that have one.
    n, cap = st.capacity, pairs.shape[1]
    gid = torch.where(torch.arange(cap, device=pairs.device) < bn.num_pairs,
                      bn.pair_gauss, n)
    has = (k[4] > 0).reshape(-1)
    best = torch.clamp(k[3].reshape(-1), 0, cap - 1).long()
    gen = torch.Generator(device=pairs.device).manual_seed(0)
    w = torch.rand(has.shape, generator=gen, device=pairs.device)
    key, perm = torch.sort(torch.where(has, gid[best], n), stable=True)
    results["reduce_by_sorted_gid_argmax"] = check_reduce(
        key.to(torch.int32).contiguous(),
        torch.where(has, w, 0.0)[None].index_select(1, perm).contiguous(), n,
        f"score view argmax stream, N={n}, lanes={has.numel()}")


def run_score_pass(st, cam, cfg, kernels):
    """The score pass at full width: one score view per metric, with every
    launch counter set to 0 just before and read just after; then the
    time of each and a second run that must be bit-identical."""
    import torch
    from fovsplat_torch.ops import stats
    from fovsplat_torch.train import loops
    fns = {m: loops.make_score_fn(cfg, m) for m in METRICS}
    for kf in kernels.values():
        kf.launches = 0
    first = {m: fn(st, cam) for m, fn in fns.items()}
    torch.cuda.synchronize()
    launches = {name: kf.launches for name, kf in kernels.items()}
    same = {m: bool(torch.equal(first[m], fn(st, cam)))
            for m, fn in fns.items()}
    p = st.params
    out = stats.rasterize_stats(
        p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(), cam,
        shs=p.get_features(), mode="loss_weighted_max_count",
        config=cfg.raster, live_mask=st.live)
    row = {"phase": "score", "n": st.capacity, "width": cam.width,
           "height": cam.height, "launches": launches,
           "bit_identical": same,
           "ms": {m: cuda_ms(lambda: fn(st, cam), 5) for m, fn in fns.items()},
           "overflow": int(out["binned"].overflow),
           "num_pairs": int(out["binned"].num_pairs),
           "scored": {m: int((v > 0).sum()) for m, v in first.items()}}
    emit(row)
    if not all(same.values()):
        raise AssertionError(f"scores differ between two runs: {same}")
    if (row["overflow"] != 0 or launches["blend_stats"] <= 0
            or launches["reduce_by_sorted_gid"] <= 0):
        raise AssertionError(f"score pass: {row}")
    return launches


def score_vs_cpu(cfg):
    """gs_count and contribs of every mode, and the three metrics, on the
    card against the CPU plain path on the 20k proxy at 320x224."""
    from fovsplat_torch.ops import stats
    from fovsplat_torch.train import loops
    outs = []
    for d in ("cuda", "cpu"):
        st, cam, _ = train_inputs(20_000, 320, 224, 1, d)
        p = st.params
        res = {}
        for mode in stats.MODES:
            o = stats.rasterize_stats(
                p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(),
                cam, shs=p.get_features(), mode=mode, config=cfg.raster,
                live_mask=st.live)
            res[mode] = (o["gs_count"].cpu(), o["contribs"].cpu(),
                         int(o["binned"].overflow))
        res.update({m: loops.make_score_fn(cfg, m)(st, cam).cpu()
                    for m in METRICS})
        outs.append(res)
    card, cpu = outs
    counts_equal, rel = {}, {}
    for mode in stats.MODES:
        counts_equal[mode] = bool((card[mode][0] == cpu[mode][0]).all())
        rel[mode] = float(((card[mode][1] - cpu[mode][1]).abs()
                           / cpu[mode][1].abs().clamp(min=1e-30)).max())
    for m in METRICS:
        rel[m] = float(((card[m] - cpu[m]).abs()
                        / cpu[m].abs().clamp(min=1e-30)).max())
    overflow = [card[m][2] for m in stats.MODES] + [cpu[m][2]
                                                     for m in stats.MODES]
    emit({"phase": "score_vs_cpu", "shape": "N=20000, 320x224",
          "gs_count_equal": counts_equal, "rel_err": rel,
          "overflow": overflow, "tol": {"rtol": STATS_RTOL}})
    if not (all(counts_equal.values()) and not any(overflow)
            and all(v <= STATS_RTOL for v in rel.values())):
        raise AssertionError("card scores differ from the CPU scores")


class View:
    def __init__(self, camera, image):
        self.camera = camera
        self.image = image


def ring_cameras(count, width, height, device):
    """`count` cameras on the proxy camera's capture ring (radius 4, the
    first at the proxy camera's eye), looking at the object."""
    from fovsplat_torch.data.cameras import look_at_camera
    a0 = math.atan2(-2.4, 3.2)
    return [look_at_camera(
        [4.0 * math.cos(a0 + 2 * math.pi * i / count), -1.1,
         4.0 * math.sin(a0 + 2 * math.pi * i / count)], [0.0, 0.0, 0.0],
        [0, -1, 0], fovx=1.20, fovy=1.20 * height / width * 1.24,
        width=width, height=height, device=device) for i in range(count)]


@contextlib.contextmanager
def recorded_steps(loops, auxs):
    """Keep every step's output row while the loops run: the loops' step
    factories are wrapped for the duration, and restored after."""
    saved = (loops.make_photometric_step, loops.make_hvs_step)

    def wrap(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*sa, **sk):
                new, aux = step(*sa, **sk)
                auxs.append(aux)
                return new, aux
            return run
        return made
    loops.make_photometric_step, loops.make_hvs_step = map(wrap, saved)
    try:
        yield
    finally:
        loops.make_photometric_step, loops.make_hvs_step = saved


def chain_inputs(n, width, height, cfg, device):
    """The teacher (the proxy as the train phase builds it), its renders on
    6 ring cameras (4 train views, 2 test views) and the student: the
    teacher perturbed as scripts/onchip_pipeline.py:106-118 does, from
    default_rng(0)."""
    import numpy as np
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.models import state as S
    from fovsplat_torch.train import loops
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=0))
    teacher = S.from_params(convert.params_from_numpy(**raw, device=device))
    views = []
    with torch.no_grad():
        for c in ring_cameras(6, width, height, device):
            img = loops.render_state(teacher, c, cfg)["render"]
            views.append(View(c, torch.clamp(img, 0.0, 1.0)))
    rng = np.random.default_rng(0)
    noise = {"xyz": 0.004, "features_dc": 0.08, "scaling": 0.05,
             "opacity": 0.2}
    student = {k: (v + rng.normal(0, noise[k], v.shape).astype(np.float32)
                   if k in noise else v) for k, v in raw.items()}
    return (S.from_params(convert.params_from_numpy(**student,
                                                    device=device)),
            views[:4], views[4:])


def run_chain(n, width, height, cfg, frame_cfg, kernels, device,
              prune_iters=30, mask_iters=12, log=None):
    """prune_training, three chained mask_training layers (pooling 3, 7,
    12) against PS1's HVS at pooling 1, compose_layers and one foveated
    frame of the composed model at the centre gaze, with every launch
    counter set to 0 just before and read just after. Returns the phase
    row; raises when a check fails."""
    import numpy as np
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.train import compose, loops
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    student, train_views, test_views = chain_inputs(n, width, height, cfg,
                                                    device)
    eval_view, hvs_view = loops.make_eval_fns(cfg)
    ssim0, psnr0 = loops.evaluate(student, test_views, eval_view)
    sync()
    seconds = {"inputs": time.perf_counter() - t0}
    for kf in kernels.values():
        kf.launches = 0
    auxs = []
    with recorded_steps(loops, auxs):
        t0 = time.perf_counter()
        ps1 = loops.prune_training(
            student, train_views, test_views, 0.99 * ssim0, 0.99 * psnr0,
            cfg, iters=prune_iters, pruning_iters=int(prune_iters * 0.9),
            prune_interval=10, final_prune_rounds=1, eval_views_cap=2,
            log=log)
        sync()
        seconds["prune"] = time.perf_counter() - t0
        n_prune_steps = len(auxs)
        target = float(np.mean([float(hvs_view(ps1, v.camera, v.image, 1.0))
                                for v in train_views[:2]]))
        layers = [ps1]
        for ps in (3.0, 7.0, 12.0):
            t0 = time.perf_counter()
            layers.append(loops.mask_training(
                layers[-1], train_views, ps, target, cfg, iters=mask_iters,
                masking_iters=mask_iters - 2, prune_interval=4,
                prune_ratio=0.035, per_prune_times=6, eval_views_cap=2,
                log=log))
            sync()
            seconds[f"mask_ps{int(ps)}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = compose.compose_layers(layers)
    frame = fov.rasterize_fov_soa(
        compose.pack_composed(model), train_views[0].camera,
        torch.tensor((0.5, 0.5), dtype=torch.float32,
                     device=model.live.device), ALPHA, config=frame_cfg)
    img = frame["render"]
    finite = bool(torch.isfinite(img).all())
    sync()
    seconds["compose_and_frame"] = time.perf_counter() - t0
    launches = {name: kf.launches for name, kf in kernels.items()}

    steps = [{k: (float(v) if k == "loss" else int(v))
              for k, v in a.items()} for a in auxs]
    bad_steps = [i for i, r in enumerate(steps)
                 if not (r["overflow"] == 0 and r["nonfinite"] == 0
                         and math.isfinite(r["loss"]))]
    counts = compose.layer_counts(layers)
    nested = [not bool((b.live & ~a.live).any())
              for a, b in zip(layers, layers[1:])]
    frozen = {f: all(torch.equal(getattr(L.params, f), getattr(ps1.params, f))
                     for L in layers[1:])
              for f in ("xyz", "scaling", "rotation", "features_rest")}
    eval_after = loops.evaluate(ps1, test_views, eval_view)
    row = {"phase": "chain", "n": n, "width": width, "height": height,
           "views": {"train": len(train_views), "test": len(test_views)},
           "student": {"ssim": ssim0, "psnr": psnr0},
           "targets": {"ssim": 0.99 * ssim0, "psnr": 0.99 * psnr0,
                       "hvs_ps1_at_1": target},
           "ps1": {"ssim": eval_after[0], "psnr": eval_after[1]},
           "live": {"student": int(student.live_count()),
                    "ps1": counts[0], "ps3": counts[1], "ps7": counts[2],
                    "ps12": counts[3]},
           "seconds": seconds,
           "steps": {"prune": n_prune_steps,
                     "mask": len(steps) - n_prune_steps,
                     "losses_first_last": [steps[0]["loss"],
                                           steps[-1]["loss"]],
                     "max_num_pairs": max(r["num_pairs"] for r in steps),
                     "bad": bad_steps},
           "nested": nested, "frozen_bit_unchanged": frozen,
           "frame": {"finite": finite, "num_pairs": int(frame["num_pairs"]),
                     "overflow": int(frame["overflow"]),
                     "mean": float(img.mean())},
           "launches": launches}
    emit(row)
    if (bad_steps or not all(nested) or not all(frozen.values())
            or not finite or row["frame"]["overflow"] != 0):
        raise AssertionError("the model-building chain failed a check")
    for k in ("expand_ps1", "blend_forward", "blend_backward",
              "reduce_by_sorted_gid", "blend_stats"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched in the chain")
    return launches


def hvs_vs_cpu(cfg):
    """One masked HVS step (pooling 3) on the card against the CPU plain
    path on the 20k proxy at 320x224: loss within 1e-5 relative, the DC
    and opacity gradients (the first Adam moments) scaled by their
    largest value within rtol 2e-3, atol 2e-4."""
    from fovsplat_torch.train import loops
    outs = []
    for d in ("cuda", "cpu"):
        st, cam, gt = train_inputs(20_000, 320, 224, 1, d)
        new, aux = loops.make_hvs_step(cfg, 3.0, masking=True, device=d)(
            st, cam, gt, 1)
        outs.append((float(aux["loss"]), int(aux["nonfinite"]),
                     int(aux["overflow"]),
                     {f: new.opt.mu[f].cpu()
                      for f in ("features_dc", "opacity")}))
    (lc, bc, oc, mc), (lh, bh, oh, mh) = outs
    loss_rel = abs(lc - lh) / abs(lh)
    worst = {}
    for f, g in mh.items():
        scale = float(g.abs().max()) or 1.0
        d = (mc[f] - g).abs() / scale
        worst[f] = float((d - GRAD_RTOL * (g.abs() / scale)).max())
    emit({"phase": "hvs_vs_cpu", "shape": "N=20000, 320x224, pooling 3",
          "loss": [lc, lh], "loss_rel_err": loss_rel, "nonfinite": [bc, bh],
          "overflow": [oc, oh], "grad_excess_over_rtol": worst,
          "tol": {"loss_rtol": LOSS_RTOL, "grad_rtol": GRAD_RTOL,
                  "grad_atol": GRAD_ATOL}})
    if not (loss_rel <= LOSS_RTOL and bc == bh == 0 and oc == oh == 0
            and all(v <= GRAD_ATOL for v in worst.values())):
        raise AssertionError("card HVS step differs from the CPU step")


def ps1_inputs(n, width, height, seed, device):
    """The proxy as a PS1 model (level-0 DC, SH rest, the shared opacity)
    and its camera."""
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    sc = proxy.bicycle_proxy(n=n, seed=seed)
    model = convert.ps1_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacity"],
        sc["shs_dcs"][:, 0:1], sc["shs_rest"], device=device)
    return model, proxy.proxy_camera(width=width, height=height,
                                     device=device)


def check_inference_kernels(dev, fov_table, results):
    """Kernel 1's ps1 mode, kernel 4's quantized rows, kernel 5q and
    kernel 9 against their plain versions at the PS1 frame's full-width
    shapes (the proxy as a PS1 model, 1237x822, the train capacities);
    kernel 9 also on the "ours" frame's table at the centre gaze."""
    import torch
    from fovsplat_torch.ops import blend, foveated as fov
    from fovsplat_torch.ops.kernels import blend_fwd as bfw
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import compact_table as ct
    from fovsplat_torch.ops.kernels import expand_ps1 as ep1
    model, cam = ps1_inputs(N_FULL, W_FULL, H_FULL, 0, dev)
    gx, gy = (W_FULL + 15) // 16, (H_FULL + 15) // 16
    T, n, P = gx * gy, N_FULL, blend.PIX
    shape = f"N={n}, {W_FULL}x{H_FULL}"

    # --- 1p
    tk, ck, totk = bt.build_table_ps1(model, cam)
    tp, cp, totp = bt.build_table_ps1_plain(model, cam)
    int_rows = [ep1.ROW_RX0, ep1.ROW_RY0, ep1.ROW_RW, ep1.ROW_TNUM]
    bad = {r: int((tk[r] != tp[r]).sum()) for r in int_rows}
    if any(bad.values()) or not (torch.equal(ck, cp)
                                 and torch.equal(totk, totp)):
        raise AssertionError(f"build_table_ps1: integer rows differ {bad}")
    fl = [r for r in range(tk.shape[0]) if r not in int_rows]
    err = (tk[fl] - tp[fl]).abs()
    rel = float((err / tp[fl].abs().clamp(min=1.0)).max())
    if not rel <= TABLE_RTOL:
        raise AssertionError(f"build_table_ps1 float rows: rel err {rel}")
    cand = int(totk)
    # Bytes: 40 B of geometry and 98 B of bf16 SH and opacity in, the
    # 20-row table and cum out. ~530 FLOP a Gaussian (projection, EWA,
    # rect and OBB ~290, degree-3 SH ~230, colours).
    b_ms, b_by = bound(n * (40 + 2 * 49) + n * 4 * (ep1.NUM_ROWS + 1),
                       530.0 * n)
    results["build_table_ps1"] = dict(
        max_abs_err=float(err.max()),
        **kernel_times(lambda: bt.build_table_ps1(model, cam)),
        plain_ms=cuda_ms(lambda: bt.build_table_ps1_plain(model, cam), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{shape}, candidates={cand}")
    emit({"phase": "check", "kernel": "build_table_ps1", "rows_exact":
          int_rows, "float_rel_err": rel, "candidates": cand,
          "tol": TABLE_RTOL})

    # --- 4q
    args = (tk, ck, gx, TRAIN_PAIR_CAPACITY, TRAIN_COMPACT_CAPACITY)
    ek, kept = check_ps1_exact(tk, ck, gx, T, TRAIN_PAIR_CAPACITY,
                               TRAIN_COMPACT_CAPACITY, True, "PS1 table")
    k = min(kept, TRAIN_COMPACT_CAPACITY)
    key, dbits = fov.fused_key32(ek.tile, ek.depth, ek.kept[0], T)
    b_ms, b_by = bound(tk.numel() * 4 + n * 4 + k * 28,
                       30.0 * min(cand, TRAIN_PAIR_CAPACITY))
    results["expand_ps1_q"] = dict(
        max_abs_err=0.0,
        **kernel_times(lambda: ep1.expand_ps1(*args, quantize=True)),
        plain_ms=cuda_ms(lambda: ep1.expand_ps1_plain(*args, quantize=True),
                         3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{shape}, candidates={cand}, kept={kept}")

    # --- 5q, on the frame's fused-key sort; checked on the full segments
    # and with every third tile's segment emptied (MM-FR's masking)
    pairs, seg = fov.sort_pairs(key, dbits, ek.attrs, T, False)
    num_pairs = int(seg[-1])
    ss = seg[:-1]
    errs = {}
    for tag, se in (("full", seg[1:]),
                    ("emptied", torch.where(torch.arange(T, device=dev) % 3
                                            != 0, seg[1:], ss))):
        ko = bfw.blend_forward_q(pairs, ss, se, gx)
        po = blend.blend_forward_q_plain(pairs, ss, se, gx,
                                         return_walked=True)
        errs[tag] = max(float((ko[0] - po[0]).abs().max()),
                        float((ko[1] - po[1]).abs().max()))
        if tag == "full":
            walked = po[3]
    emit({"phase": "check", "kernel": "blend_forward_q",
          "num_pairs": num_pairs, "max_abs_err": errs, "tol": BLEND_ATOL})
    if not all(e <= BLEND_ATOL for e in errs.values()):
        raise AssertionError(f"blend_forward_q: {errs}")
    # 25 FLOP per pair-pixel walked (as kernel 5); bytes: 20 B per pair
    # read, the segment bounds, colour, T and n_contrib out.
    b_ms, b_by = bound(num_pairs * 20 + 2 * T * 4 + T * P * 20,
                       25.0 * float(walked.double().sum()))
    se = seg[1:]
    results["blend_forward_q"] = dict(
        max_abs_err=max(errs.values()),
        **kernel_times(lambda: bfw.blend_forward_q(pairs, ss, se, gx)),
        plain_ms=cuda_ms(lambda: blend.blend_forward_q_plain(pairs, ss, se,
                                                             gx), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{W_FULL}x{H_FULL}, pairs={num_pairs}",
        pair_pixels_walked=int(walked.long().sum()))

    # --- 9, on the ps1 table (timed) and on the "ours" frame's table
    checks = {}
    for tag, table, flag, tn in (
            ("ps1", tk, ep1.ROW_TNUM, ep1.ROW_TNUM),
            ("fov", fov_table, bt.ROW_VALID, bt.ROW_TNUM)):
        ko = ct.compact_table(table, flag, 0.5, tn)
        po = ct.compact_table_plain(table, flag, 0.5, tn)
        checks[tag] = {"bit_identical": all(torch.equal(a, b)
                                            for a, b in zip(ko, po)),
                       "live": int(ko[2]), "columns": table.shape[1],
                       "total": int(ko[3])}
    emit({"phase": "check", "kernel": "compact_table", **checks})
    if not all(c["bit_identical"] for c in checks.values()):
        raise AssertionError(f"compact_table differs: {checks}")
    live = checks["ps1"]["live"]
    b_ms, b_by = bound(tk.numel() * 4 + tk.shape[0] * 4 * live + n * 4, 0.0)
    results["compact_table"] = dict(
        max_abs_err=0.0,
        **kernel_times(lambda: ct.compact_table(tk, ep1.ROW_TNUM, 0.5,
                                                ep1.ROW_TNUM)),
        plain_ms=cuda_ms(lambda: ct.compact_table_plain(
            tk, ep1.ROW_TNUM, 0.5, ep1.ROW_TNUM), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"ps1 table {tk.shape[0]}x{n}, live={live}")
    return model, cam


def run_ps1_frame(model, cam, kernels):
    """The PS1 frame at full width, compaction off and on: per setting
    every counter set to 0 just before 3 warm-up and 20 timed frames
    (CUDA events) and read just after. The two images must be
    bit-identical with equal num_pairs and overflow 0. Returns the
    launches per setting."""
    import torch
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    outs, launches, rows = [], {}, {}
    for flag in (False, True):
        cfg = RasterizeConfig(pair_capacity=TRAIN_PAIR_CAPACITY,
                              compact_capacity=TRAIN_COMPACT_CAPACITY,
                              compact_table=flag)
        for kf in kernels.values():
            kf.launches = 0
        for _ in range(3):
            rast.rasterize_ps1_soa(model, cam, config=cfg)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            out = rast.rasterize_ps1_soa(model, cam, config=cfg)
        end.record()
        end.synchronize()
        tag = "compact_table" if flag else "plain_table"
        launches[tag] = {k: kf.launches for k, kf in kernels.items()}
        img = out["render"]
        rows[tag] = {"ms": start.elapsed_time(end) / 20,
                     "num_pairs": int(out["num_pairs"]),
                     "candidates": int(out["candidates"]),
                     "overflow": int(out["overflow"]),
                     "finite": bool(torch.isfinite(img).all()),
                     "mean": float(img.mean())}
        outs.append(img)
    same = bool(torch.equal(outs[0], outs[1]))
    emit({"phase": "ps1_frame", "n": N_FULL, "width": W_FULL,
          "height": H_FULL, "pair_capacity": TRAIN_PAIR_CAPACITY,
          "compact_capacity": TRAIN_COMPACT_CAPACITY, "warmups": 3,
          "timed": 20, **rows, "bit_identical": same, "launches": launches})
    r0, r1 = rows["plain_table"], rows["compact_table"]
    if not (same and r0["num_pairs"] == r1["num_pairs"]
            and r0["overflow"] == r1["overflow"] == 0 and r0["finite"]):
        raise AssertionError("the PS1 frame failed a check")
    for tag, need in (("plain_table", ("build_table_ps1", "expand_ps1",
                                       "blend_forward_q")),
                      ("compact_table", ("build_table_ps1", "expand_ps1",
                                         "blend_forward_q",
                                         "compact_table"))):
        for k in need:
            if launches[tag][k] <= 0:
                raise AssertionError(f"{k} never launched on the PS1 frame "
                                     f"({tag})")
    return launches


def ps1_vs_cpu_and_f32():
    """The PS1 frame on the card against the CPU plain path (within
    FRAME_ATOL), and against the port's own f32 train-route rasterize of
    the same model (above 40 dB), on the 20k proxy at 320x224."""
    import numpy as np
    import torch
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    cfg = RasterizeConfig(pair_capacity=1 << 20, sort_exact_depth=True)
    outs = []
    for d in ("cuda", "cpu"):
        model, cam = ps1_inputs(20_000, 320, 224, 1, d)
        o = rast.rasterize_ps1_soa(model, cam, bg_color=[0.1, 0.2, 0.3],
                                   config=cfg)
        outs.append((o["render"].cpu(), int(o["num_pairs"])))
    err = float((outs[0][0] - outs[1][0]).abs().max())
    sc = proxy.bicycle_proxy(n=20_000, seed=1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32),    # noqa: E731
                                  device="cuda")
    with torch.no_grad():
        f32 = rast.rasterize(
            t(sc["means"]), t(sc["scales"]), t(sc["rotations"]),
            t(sc["opacity"]), proxy.proxy_camera(320, 224, device="cuda"),
            shs=torch.cat([t(sc["shs_dcs"][:, 0:1]), t(sc["shs_rest"])], 1),
            bg_color=[0.1, 0.2, 0.3], config=cfg)["render"].cpu()
    mse = float(((outs[0][0] - f32).double() ** 2).mean())
    psnr = -10.0 * math.log10(max(mse, 1e-30))
    emit({"phase": "ps1_vs_cpu", "shape": "N=20000, 320x224",
          "num_pairs": [outs[0][1], outs[1][1]], "max_abs_err": err,
          "tol": FRAME_ATOL, "psnr_vs_f32_route_db": psnr,
          "max_abs_err_vs_f32_route": float((outs[0][0] - f32).abs().max())})
    if outs[0][1] != outs[1][1] or not err <= FRAME_ATOL or not psnr > 40.0:
        raise AssertionError("card PS1 frame differs from the CPU frame or "
                             "from the f32 route")


def gaze_rows(render, cam, extra=None):
    """One more frame per gaze: its num_pairs, candidates and overflow
    (and `extra` per pass), checking a finite image of the full shape."""
    import torch
    from fovsplat_torch.eval import fps
    rows = []
    for gz in fps.GAZES:
        out = render(cam, torch.tensor(gz, dtype=torch.float32,
                                       device=cam.device))
        img = out["render"]
        row = {"gaze": gz, "num_pairs": int(out["num_pairs"]),
               "overflow": int(out["overflow"])}
        if extra:
            row.update(extra(out))
        rows.append(row)
        if row["overflow"] != 0:
            raise AssertionError(f"overflow at gaze {gz}: {row}")
        if tuple(img.shape) != (cam.height, cam.width, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"bad image at gaze {gz}")
    return rows


def run_smfr(cam, kernels):
    """The SM-FR (naive) frame over the 9 gazes at full width on the
    "ours" frame's proxy and capacities, packed with shared colours; at
    the centre gaze the shared and broadcast packings must render
    bit-identical images. First kernel 2 against its plain version on the
    shared table (L_lay = 1) at the centre gaze, bit for bit."""
    import numpy as np
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.eval import fps
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import foveation
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    sc = proxy.bicycle_proxy(n=N_FULL, seed=0)
    arrays = (sc["means"], sc["scales"], sc["rotations"])
    shared = convert.fov_model_from_numpy(
        *arrays, sc["opacities4"], sc["shs_dcs"], sc["shs_rest"],
        sc["highest_levels"], device=cam.device, shared_colors=True)
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    levels = foveation.compute_tile_levels(
        torch.tensor((0.5, 0.5), dtype=torch.float32, device=cam.device),
        cam.width, cam.height, ALPHA)
    table, cum, _ = bt.build_table(shared, cam,
                                   fov.level_bboxes(levels, gx, gy, 4))
    check_expand_exact(table, cum, levels, gx, "SM-FR table, centre gaze")
    del table, cum
    cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                          compact_capacity=COMPACT_CAPACITY)
    render = fps.make_fov_render(shared, cfg, alpha=ALPHA, mode="naive")
    for kf in kernels.values():
        kf.launches = 0
    res = fps.fps_benchmark(render, [cam], warmups=3, reps=20,
                            log=lambda *_: None)
    launches = {k: kf.launches for k, kf in kernels.items()}
    rows = gaze_rows(render, cam, lambda o: {
        "candidates": int(o["candidates"])})
    for r, ms in zip(rows, res["per_gaze_ms"]):
        r["ms"] = ms
    n = N_FULL
    bcast = convert.fov_model_from_numpy(
        *arrays, np.broadcast_to(sc["opacities4"][:, :1], (n, 4)),
        np.broadcast_to(sc["shs_dcs"][:, :1], (n, 4, 3)), sc["shs_rest"],
        sc["highest_levels"], device=cam.device)
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=cam.device)
    imgs = [fov.rasterize_fov_soa(m, cam, gaze, ALPHA, config=cfg)["render"]
            for m in (shared, bcast)]
    same = bool(torch.equal(*imgs))
    emit({"phase": "smfr_frame", "n": N_FULL, "width": W_FULL,
          "height": H_FULL, "alpha": ALPHA, "warmups": 3, "reps": 20,
          "per_gaze": rows, "avg_ms": res["avg_ms"],
          "avg_fps": res["avg_fps"], "shared_vs_broadcast_bit_identical":
          same, "launches": launches})
    if not same:
        raise AssertionError("SM-FR shared and broadcast packings differ")
    for k in ("build_table", "expand_fov", "blend_fov"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the SM-FR frame")


def run_mmfr(cam, kernels):
    """The MM-FR baseline over the 9 gazes at full width: the four level
    models of bench.py:255-268, per-level capacities sized as
    bench.py:299-331 does (the largest kept and candidate counts over the
    9 gazes at probe capacities, rounded up), overflow 0 on every pass."""
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.eval import fps
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    import torch
    sc = proxy.bicycle_proxy(n=N_FULL, seed=0)
    models = convert.mmfr_models_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["highest_levels"], device=cam.device)
    probe = RasterizeConfig(pair_capacity=CHAIN_PAIR_CAPACITY,
                            compact_capacity=CHAIN_COMPACT_CAPACITY)
    need = [[0, 0] for _ in models]
    probe_render = fps.make_mmfr_render(models, probe, alpha=ALPHA)
    for gz in fps.GAZES:
        out = probe_render(cam, torch.tensor(gz, dtype=torch.float32,
                                             device=cam.device))
        for li, d in enumerate(out["passes"]):
            if int(d["overflow"]) != 0:
                raise AssertionError(f"MM-FR probe overflow {gz} {li}")
            need[li][0] = max(need[li][0], int(d["candidates"]))
            need[li][1] = max(need[li][1], int(d["num_pairs"]))

    def up(v, gran):
        return (max(v, 1) + gran - 1) // gran * gran
    caps = [(min(up(c, 786_432), CHAIN_PAIR_CAPACITY),
             min(up(k, 524_288), CHAIN_COMPACT_CAPACITY)) for c, k in need]
    cfgs = [RasterizeConfig(pair_capacity=c, compact_capacity=k)
            for c, k in caps]
    render = fps.make_mmfr_render(models, cfgs, alpha=ALPHA)
    for kf in kernels.values():
        kf.launches = 0
    res = fps.fps_benchmark(render, [cam], warmups=3, reps=20,
                            log=lambda *_: None)
    launches = {k: kf.launches for k, kf in kernels.items()}
    rows = gaze_rows(render, cam, lambda o: {
        "pass_num_pairs": [int(d["num_pairs"]) for d in o["passes"]],
        "pass_overflow": [int(d["overflow"]) for d in o["passes"]]})
    for r, ms in zip(rows, res["per_gaze_ms"]):
        r["ms"] = ms
        if any(r["pass_overflow"]):
            raise AssertionError(f"MM-FR pass overflow: {r}")
    emit({"phase": "mmfr_frame", "n": N_FULL, "width": W_FULL,
          "height": H_FULL, "alpha": ALPHA, "warmups": 3, "reps": 20,
          "level_points": [int((m["opacity"] > 0).sum()) for m in models],
          "probe_need_candidates_kept": need, "level_caps": caps,
          "per_gaze": rows, "avg_ms": res["avg_ms"],
          "avg_fps": res["avg_fps"], "launches": launches})
    for k in ("expand_ps1", "blend_forward_q"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the MM-FR frame")
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=cam.device)
    emit({"phase": "profile", "path": "MM-FR frame, centre gaze",
          **profile_window(lambda: render(cam, gaze), 3)})
    return launches


def frame_times(path, render, cam, gazes):
    """One frame's times through eval/fps.py's harness in both forms:
    batched (3 warm-ups, CUDA events around 20 reps) and per-rep
    synchronised, the JAX harness's form (10 warm-ups, a host read after
    each of 5 reps, host clock). Checks the harness's six keys and that
    "avg" is the mean of "per_gaze"."""
    from fovsplat_torch.eval import fps
    keys = {"per_gaze_ms", "per_gaze_fps", "avg_ms", "avg_fps", "per_gaze",
            "avg"}
    row = {"phase": "frame_times", "path": path, "gazes": len(gazes)}
    for form, sync in (("batched", False), ("per_rep_sync", True)):
        res = fps.fps_benchmark(render, [cam], gazes=gazes,
                                sync_every_rep=sync, log=lambda *_: None)
        mean = sum(res["per_gaze"]) / len(res["per_gaze"])
        if set(res) != keys or not math.isclose(res["avg"], mean,
                                                rel_tol=1e-12):
            raise AssertionError(f"fps_benchmark returned {sorted(res)}")
        row[form] = {"avg_ms": res["avg_ms"], "avg_fps": res["avg"],
                     "per_gaze_ms": res["per_gaze_ms"]}
    emit(row)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from fovsplat_torch.eval import fps
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.kernels import _build
    from fovsplat_torch.ops.kernels import blend_fov as bf
    from fovsplat_torch.ops.kernels import blend_fwd as bfw
    from fovsplat_torch.ops.kernels import blend_stats as bs
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import compact_table as ct
    from fovsplat_torch.ops.kernels import expand_fov as ef
    from fovsplat_torch.ops.kernels import expand_ps1 as ep1
    from fovsplat_torch.ops.kernels import segment_reduce as sr
    from fovsplat_torch.ops.rasterize import RasterizeConfig

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "torch_name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "sources": list(_build.SOURCES),
          "seconds": time.perf_counter() - t0})

    # Every kernel wrapper, by the name of its row in the kernels line.
    frame_kernels = {"build_table": bt.build_table,
                     "expand_fov": ef.expand_fov,
                     "blend_fov": bf.blend_fov}
    train_kernels = {"expand_ps1": ep1.expand_ps1,
                     "blend_forward": bfw.blend_forward,
                     "blend_backward": bfw.blend_backward,
                     "reduce_by_sorted_gid": sr.reduce_by_sorted_gid}
    all_kernels = {**frame_kernels, **train_kernels,
                   "blend_stats": bs.blend_stats}

    results = {}
    full = check_table_and_expand(dev, results)
    results["blend_fov"] = check_blend(f"N={N_FULL}, {W_FULL}x{H_FULL}",
                                       full, 20)
    results["blend_fov_150k"] = check_blend(
        "N=150000, 656x528", frame_inputs(150_000, 656, 528, (0.5, 0.5), dev),
        20)
    st, tcam, gt = train_inputs(N_FULL, W_FULL, H_FULL, 0, dev)
    check_train_kernels(st, tcam, gt, results)

    # --- the frame path: the full-width frame over 9 gazes ---
    model, cam = full[0], full[1]
    cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                          compact_capacity=COMPACT_CAPACITY)
    render = fps.make_fov_render(model, cfg, alpha=ALPHA)
    for kf in all_kernels.values():
        kf.launches = 0
    res = fps.fps_benchmark(render, [cam], warmups=3, reps=20,
                            log=lambda *_: None)
    launches = {k: kf.launches for k, kf in all_kernels.items()}
    per_gaze = []
    for gz, ms in zip(fps.GAZES, res["per_gaze_ms"]):
        out = render(cam, torch.tensor(gz, dtype=torch.float32, device=dev))
        img = out["render"]
        row = {"gaze": gz, "ms": ms, "fps": 1000.0 / ms,
               "num_pairs": int(out["num_pairs"]),
               "candidates": int(out["candidates"]),
               "overflow": int(out["overflow"])}
        per_gaze.append(row)
        if row["overflow"] != 0:
            raise AssertionError(f"overflow at gaze {gz}: {row}")
        if tuple(img.shape) != (H_FULL, W_FULL, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"bad image at gaze {gz}")
    emit({"phase": "frame", "n": N_FULL, "width": W_FULL,
          "height": H_FULL, "alpha": ALPHA, "warmups": 3, "reps": 20,
          "per_gaze": per_gaze, "avg_ms": res["avg_ms"],
          "avg_fps": res["avg_fps"], "launches": launches})
    for k in frame_kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the frame path")

    frame_times("ours", render, cam, fps.GAZES)
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=dev)
    emit({"phase": "profile", "path": "frame, centre gaze",
          **profile_window(lambda: render(cam, gaze), 10)})

    # --- the frame on the card against the CPU plain path, small input ---
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    sc = proxy.bicycle_proxy(n=20_000, seed=1)
    outs = []
    for d in ("cuda", "cpu"):
        m = convert.fov_model_from_numpy(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=d)
        c = proxy.proxy_camera(width=320, height=224, device=d)
        o = fov.rasterize_fov_soa(
            m, c, torch.tensor([0.4, 0.6], device=d), 0.05,
            bg_color=[0.1, 0.2, 0.3],
            config=RasterizeConfig(pair_capacity=1 << 20,
                                   sort_exact_depth=True))
        outs.append((o["render"].cpu(), int(o["num_pairs"])))
    frame_err = float((outs[0][0] - outs[1][0]).abs().max())
    emit({"phase": "frame_vs_cpu", "shape": "N=20000, 320x224",
          "num_pairs": [outs[0][1], outs[1][1]], "max_abs_err": frame_err,
          "tol": FRAME_ATOL})
    if outs[0][1] != outs[1][1] or not frame_err <= FRAME_ATOL:
        raise AssertionError("card frame differs from the CPU frame")

    # --- the inference frames: PS1, SM-FR, MM-FR ---
    all_kernels.update({"build_table_ps1": bt.build_table_ps1,
                        "blend_forward_q": bfw.blend_forward_q,
                        "compact_table": ct.compact_table})
    ps1_model, ps1_cam = check_inference_kernels(
        dev, bt.build_table(model, cam, full[3])[0], results)
    pl = run_ps1_frame(ps1_model, ps1_cam, all_kernels)
    for row, k in (("build_table_ps1", "build_table_ps1"),
                   ("expand_ps1_q", "expand_ps1"),
                   ("blend_forward_q", "blend_forward_q")):
        launches[row] = pl["plain_table"][k] + pl["compact_table"][k]
    launches["compact_table"] = pl["compact_table"]["compact_table"]
    ps1_cfg = RasterizeConfig(pair_capacity=TRAIN_PAIR_CAPACITY,
                              compact_capacity=TRAIN_COMPACT_CAPACITY)
    frame_times("PS1", lambda c, _gaze: rast.rasterize_ps1_soa(
        ps1_model, c, config=ps1_cfg), ps1_cam, [(0.5, 0.5)])
    emit({"phase": "profile", "path": "PS1 frame",
          **profile_window(lambda: rast.rasterize_ps1_soa(
              ps1_model, ps1_cam, config=ps1_cfg), 10)})
    ps1_vs_cpu_and_f32()
    run_smfr(cam, all_kernels)
    run_mmfr(cam, all_kernels)
    del ps1_model

    # --- the train path: the photometric step at full width ---
    tcfg = train_config()
    steps, step_ms, wall_ms, tl, peak = run_train_path(st, tcam, gt, tcfg,
                                                       all_kernels)
    emit({"phase": "train", "n": N_FULL, "width": W_FULL, "height": H_FULL,
          "pair_capacity": TRAIN_PAIR_CAPACITY,
          "compact_capacity": TRAIN_COMPACT_CAPACITY, "warmups": 3,
          "timed": 10, "step_ms": step_ms, "host_wall_ms_per_step": wall_ms,
          "peak_mem_bytes": peak, "steps": steps, "launches": tl})
    for k in train_kernels:
        if tl[k] <= 0:
            raise AssertionError(f"{k} never launched on the train path")
        launches[k] = tl[k]
    check_determinism(st, tcam, gt, tcfg)
    train_vs_cpu(train_config(1 << 20, None))
    from fovsplat_torch.train import loops
    step = loops.make_photometric_step(tcfg)
    emit({"phase": "profile", "path": "train step",
          **profile_window(lambda: step(st, tcam, gt, 0), 3)})

    # --- the score pass, the model-building chain, the HVS step ---
    check_stats_kernel(st, tcam, results)
    sl = run_score_pass(st, tcam, tcfg, all_kernels)
    # Kernel 7 runs on the score pass's argmax stream only.
    launches["reduce_by_sorted_gid_argmax"] = sl["reduce_by_sorted_gid"]
    score_vs_cpu(train_config(1 << 20, None))
    chain_cfg = train_config(CHAIN_PAIR_CAPACITY, CHAIN_COMPACT_CAPACITY)
    cl = run_chain(N_FULL, W_FULL, H_FULL, chain_cfg, chain_cfg.raster,
                   all_kernels, dev)
    launches["blend_stats"] = cl["blend_stats"]
    hvs_vs_cpu(train_config(1 << 20, None))
    score = loops.make_score_fn(tcfg)
    emit({"phase": "profile", "path": "score view (max_comp_efficiency)",
          **profile_window(lambda: score(st, tcam), 3)})
    hvs_step = loops.make_hvs_step(tcfg, 3.0, masking=True)
    emit({"phase": "profile", "path": "masked HVS step, pooling 3",
          "step_ms_unprofiled": cuda_ms(lambda: hvs_step(st, tcam, gt, 1), 3),
          **profile_window(lambda: hvs_step(st, tcam, gt, 1), 3)})

    # --- kernels line ---
    src = {"build_table": ("fovsplat_torch/csrc/build_table.cu",
                           "fovsplat/ops/pallas/build_table.py:418"),
           "expand_fov": ("fovsplat_torch/csrc/expand_fov.cu",
                          "fovsplat/ops/pallas/expand_fov.py:906"),
           "blend_fov": ("fovsplat_torch/csrc/blend_fov.cu",
                         "fovsplat/ops/pallas/blend_fov.py:463"),
           "expand_ps1": ("fovsplat_torch/csrc/expand_ps1.cu",
                          "fovsplat/ops/pallas/expand_fov.py:819"),
           "blend_forward": ("fovsplat_torch/csrc/blend_fwd.cu",
                             "fovsplat/ops/pallas/blend_fwd.py:508"),
           "blend_backward": ("fovsplat_torch/csrc/blend_fwd.cu",
                              "fovsplat/ops/pallas/blend_fwd.py:874"),
           "reduce_by_sorted_gid": (
               "fovsplat_torch/csrc/segment_reduce.cu",
               "fovsplat/ops/pallas/segment_reduce.py:175"),
           "reduce_by_sorted_gid_argmax": (
               "fovsplat_torch/csrc/segment_reduce.cu",
               "fovsplat/ops/pallas/segment_reduce.py:175"),
           "blend_stats": ("fovsplat_torch/csrc/blend_stats.cu",
                           "fovsplat/ops/pallas/blend_stats.py:234"),
           "build_table_ps1": ("fovsplat_torch/csrc/build_table.cu",
                               "fovsplat/ops/pallas/build_table.py:418"),
           "expand_ps1_q": ("fovsplat_torch/csrc/expand_ps1.cu",
                            "fovsplat/ops/pallas/expand_fov.py:819"),
           "blend_forward_q": ("fovsplat_torch/csrc/blend_fwd.cu",
                               "fovsplat/ops/pallas/blend_fwd.py:508"),
           "compact_table": ("fovsplat_torch/csrc/compact_table.cu",
                             "fovsplat/ops/pallas/compact_table.py:218")}
    rows = []
    for k, (source, replaces) in src.items():
        r = results[k]
        rows.append({"name": k, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms": r["device_ms"],
                     "device_split": r["device_split"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "shape": r["shape"]})
    emit({"kernels": rows,
          "blend_fov_150k": results["blend_fov_150k"],
          "library": [{"name": "torch.sort (i32 fused key, stable), frame",
                       "ms": results["torch.sort"]["ms"],
                       "lanes": results["torch.sort"]["lanes"]},
                      {"name": "torch.sort (i64 fused key and depth bits, "
                               "stable), train",
                       "ms": results["torch.sort train"]["ms"],
                       "lanes": results["torch.sort train"]["lanes"]},
                      {"name": "index_add_ of the 9 cotangent rows "
                               "(kernel 7's function)",
                       "ms": results["reduce_by_sorted_gid"]["library_ms"],
                       "max_abs_err": results["reduce_by_sorted_gid"][
                           "library_max_abs_err"]},
                      {"name": "index_add_ of the argmax stream "
                               "(kernel 7's function)",
                       "ms": results["reduce_by_sorted_gid_argmax"][
                           "library_ms"],
                       "max_abs_err": results["reduce_by_sorted_gid_argmax"][
                           "library_max_abs_err"]}],
          "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:
        emit({"phase": "error", "at": _last_phase[0],
              "error": f"{type(exc).__name__}: {exc}"})
        traceback.print_exc()
        code = 1
    sys.exit(code)
