#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port renders (the foveated
"ours" frame and the PS1, SM-FR and MM-FR inference frames), trains,
prunes and masks on the GPU, that it loads a scene, trains a model from
scratch and runs the whole pipeline there, that it scores models (PSNR,
SSIM, LPIPS, HVS, per-layer HVS, rendered views and video), that it
builds the LightGaussian models (VQ compression, SH distillation, MM-FR
models, the vq subcommand), that its plain XLA oracle route agrees
with its kernel route, and that its multi-device paths (the
data-parallel step, the tile- and fov-sharded frames, the dry run), the
viewer, the native COLMAP parser and the profiler trace work there.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels of fovsplat_torch/csrc
into build/kernels first. Phases, one JSON line each on stdout:

  1. device: torch's name for the card and nvidia-smi's name and power
     limit (also printed raw on a line of its own);
  2. build: nvcc time for the eight sources of fovsplat_torch/csrc (one
     nvcc process a source, all started together) and the __global__
     functions they define (with the four of common.cuh, built into
     every source's library);
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
     within T_EPS and bit-identical over two launches, the backward's
     per-pair rows within 1e-4 of each row's largest value on the loss
     cotangent and on a seeded random g_T, and bit-identical over two
     launches (its work counts beside its bound), the gid reduce within
     1e-5 of the largest sum and bit-identical over two launches;
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
     within T_EPS and bit-identical over two launches on the full and on
     emptied segments, kernel 9 bit-identical to its plain version and
     over two launches on the ps1 table, on the frame's fov table and on
     that table with no column and with every column valid;
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
     runs as bench.py:299-331 does, overflow 0 on every pass; then kernel
     5q on the four level passes at the centre gaze against its plain
     version (within T_EPS) and bit-identical over two launches, timed
     per launch, and a profiler window over 3 centre-gaze frames;
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
     within 1e-5 relative, colour and T within T_EPS, every output
     bit-identical over two launches; then kernel 7 on
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
 22. scene_io: a COLMAP binary scene written under build/scene_io by the
     port's writer (the 16 ring cameras as PINHOLE entries, PNGs rendered
     from the full-width proxy, 100,000 points: the centres and DC
     colours of the 100,000-Gaussian proxy of seed 1), loaded with
     dataset.load_scene(resolution=1): cameras within 1e-6 of the ring
     cameras, 14 train and 2 test views (LLFF hold 8), points and colours
     exact; seconds to write and to load;
 23. scratch: create_from_points on the card (knn over the 100,000
     points), from_params at the pipeline's capacity of 1,040,000 rows,
     train_scratch on a cut schedule (SCRATCH_CUT: 300 iterations,
     densify events at 100, 150, 200 and 250, an opacity reset at 200,
     the SH degree raised every 100, one LG prune at 280), every counter
     set to 0 just before and read just after: overflow 0 and a finite
     loss on every step, kernels 4-8 launched exactly as the schedule
     implies; live and dropped counts at every event, ms a step (CUDA
     events); then the first 100 iterations twice from one init and seed,
     params, Adam moments, live mask and DensifyStats bit-identical, and
     a profiler window over 3 scratch steps from the state after the
     first densify event;
 24. scratch_vs_cpu: 20 scratch steps with one densify event on the 20k
     proxy at 320x224, card against the CPU plain path with the same
     split noise: DensifyStats within 1e-4 of the largest sum, clone and
     split selections equal but near the threshold, params within 1e-4
     of each row's largest value on at least 99.5% of the rows (new rows
     matched by the candidate they came from);
 25. pipeline: run_pipeline(small=True) on the scene_io scene with
     PipelineConfig(scratch_iters=300) and the scratch cut, counters set
     to 0 before and read after: every stage file there, base.npz
     reloading bit-identically, point_cloud_ps1.ply reloading to ps1.npz's
     live rows, no bad step; a second call skips every stage (its
     seconds); stage seconds, the live ladder and one "ours" frame of the
     composed model at the centre gaze;
 26. quality: quality_eval(make_ps1_render(teacher)) over the 16 views
     of the scene_io scene, the teacher being the proxy state the PNGs
     were rendered from (the same exact route: kernel 4's f32 rows, the
     exact sort, kernel 5), counters set to 0 before and read after: each
     render rounds to its PNG exactly (only the 8-bit rounding separates
     them), mean PSNR >= 50 dB and SSIM >= 0.998 (the rounding alone
     gives 58.9 dB and 0.99886), LPIPS null (no weights file), both JSON
     files with the reference's keys, overflow 0 on every render, kernels
     4 and 5 launched once a view; seconds a view split into render,
     SSIM, PSNR, LPIPS and HVS;
 27. lpips: LPIPS-vgg on synthetic weights (a fixed numpy seed, written to
     build/lpips_synthetic.npz) at full width, timed, two calls
     bit-identical, TF32 allowed globally for the phase so that only the
     module's local flag keeps it off; the card against the CPU at
     160x112 within 1e-5 relative;
 28. hvs_fov: the foveated HVS metric and blur_loss at full width at
     gazes (0.5, 0.5) and (0.2, 0.8), timed; metameric_loss_fov and
     blur_loss on the card against the CPU at 320x224 within 1e-5
     relative, gen_metamer with one injected noise draw within 1e-5 of
     the image's range;
 29. layers: eval_layers with layer_render_ours on the chain phase's
     composed model, ladder [1, 3, 7, 12], the scene's 2 test views,
     counters set to 0 before and read after: four JSON files, finite
     values, overflow 0, kernels 4 and 5 launched once a layer and view;
     one layer's scores on the card against the CPU (20k proxy, 320x224)
     within 1e-5 relative;
 30. fov_unpacked: rasterize_fov on the unpacked f32 full-width proxy at
     the centre gaze with the frame's capacities, counters set to 0
     before and read after (kernels 2 and 3 once, kernel 1 never),
     overflow 0, bit-identical twice, above 40 dB against the bf16 SoA
     frame of the same proxy, timed; the card against the CPU at 160x112
     within 1e-4;
 31. cli_eval: `python -m fovsplat_torch.cli` render, eval, eval-layers
     and video --frames 8 on the pipeline phase's output and the
     scene_io scene, the four processes started together: each exits 0
     and leaves its PNG, JSON and frame files; seconds to exit;
 32. vq: LightGaussian's VQ compression (models/vq.py) of the 1.16M
     teacher (codebook 8,192, ratio 0.6, 10 iterations) with importance
     from global_significance_scores on the scene's 14 train views,
     counters set to 0 before and read after (kernels 4, 7, 8 once a
     view): two runs bit-identical with TF32 allowed globally, the
     round-trip bounds of tests/test_models_data.py, size and ratio, a
     PS1 render of the decompressed model against the teacher's (PSNR,
     overflow 0), seconds; the card against the CPU at 20,000 rows and
     codebook 256 with the same injected draws (codebook within 1e-5
     relative, keep masks equal, ids equal where the two nearest
     codewords are further apart than the distance formula's rounding
     bound, and no near-tie pick further than that);
 33. distill: the teacher distilled from SH degree 3 to 1 for 20
     iterations on the 14 views, twice from one seed (bit-identical),
     launches of kernels 4-7, the loss against the teacher's render
     before and after, ms an iteration;
 34. mm_models: generate_mm_models from the chain phase's PS1 state with
     its live ladder as layer_counts (3 finetune iterations a level),
     live counts against their targets, every step finite with overflow
     0; a 9-gaze MM-FR frame of mm_render_models, its times and the
     launches of kernels 4q and 5q;
 35. cli_vq: `python -m fovsplat_torch.cli vq` on the pipeline phase's
     output; its JSON on a line of its own;
 36. xla_route: the port's XLA oracle route (config.backend "xla", plain
     PyTorch) against the kernel route at full width, every counter 0
     across its calls: the train-step render and gradients (kept pairs
     equal, images within 1e-4, gradients within 1e-4 of each field's
     largest, bit-identical twice), the "ours" frame at the centre gaze
     (within 1e-4), the three score views (within 1e-5 relative), and
     render_dense against the XLA route at 2,000 Gaussians and 160x112;
     times labelled "plain PyTorch route";
 37. kernel 3 over one owner's tile range (tile0 = ceil(T / 4), the
     tiles of rank 1 of 4) at the full-width frame against its plain
     version with the same tile0 (within T_EPS), bit-identical to those
     tiles of a whole-grid launch and over two launches, timed;
 38. parallel_nccl: a world-size-1 NCCL group in this process, every
     counter 0 before each sharded call and read after it: the DP step
     over one ring view bit-identical to trainer.make_train_step, the
     tile-sharded PS1 frame (kernel 5q) bit-identical to
     rasterize(fwd_only, sort_exact_depth) and the fov-sharded frame
     (kernels 1-3) bit-identical to rasterize_fov_soa(sort_exact_depth),
     at full width;
 39. parallel_ranks: 4 gloo ranks spawned on the one card, each with its
     contiguous quarter of the full-width proxy's rows in a seeded order
     (SHARD_SEED), at the single-device global capacities: the
     fov-sharded frame at gazes (0.5, 0.5) and (0.2, 0.2) and the
     tile-sharded PS1 frame equal to the single-device frames of the
     same rows bit for bit on every rank, num_pairs equal, overflow 0 at
     the default per-destination blocks (the largest block printed), an
     undersized block (65,536) reporting overflow; the DP step over 4
     ring views (one a rank): gradients within 1e-6 of each field's
     largest against the one-process mean, equal on every rank,
     bit-identical over two runs; launches and wall ms of every call,
     labelled "4 ranks sharing one H100 through gloo; not a scaling
     figure"; then, alone on the card, dryrun: `python -m
     fovsplat_torch.cli dryrun --devices 1` (NCCL), exit 0 and its line;
 40. viewer: a loopback client's request for a 656x528 view, served by
     NetworkGUI.serve_step with the centre-gaze frame rendered on the
     card: the decoded camera within 1e-6 of the request's, the answer
     the frame's bytes; native_colmap: the scene_io scene's images.bin
     and points3D.bin parsed natively (built with g++ into build/native)
     and in Python, equal; trace: utils/profiling.trace around one frame
     writes a non-empty Chrome trace under build/trace;
 41. the kernels line: per kernel (1-9, and 1p, 4q, 5q, kernel 5q on
     MM-FR, kernel 7's argmax stream and kernel 3 over a tile range)
     its launches on its path, time
     (CUDA events over 20 calls), own device time (device_ms, a profiler
     window over 20 more, split by CUDA kernel, and the CUDA kernels a
     call launches), plain time, bound and error, the
     index_add_ time of kernel 7's sums as its library time, and the
     torch.sort times of the frame's and the train route's keys as
     library rows; the rows of kernels 4-8 also give their launches on
     the scratch and pipeline phases, and every row its launches in the
     quality, layers and fov_unpacked phases and in the vq, distill,
     mm_models (generation) and mm_frame phases, and in the sharded
     calls of phases 38 and 39 (the tile-range row: kernel 3's launches
     there); the largest per-destination blocks of phase 39.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero without that line, after printing
{"phase": "error", "at": <the last phase printed>, "error": <message>};
a machine without CUDA or a checkout without the package exits non-zero
too.
"""

import contextlib
import dataclasses
import json
import math
import os
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


def kernel_names(sources):
    """The __global__ functions defined in the CUDA sources (paths), as
    the profiler names them."""
    names = set()
    for src in sources:
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    return names


def own_kernel_names():
    """The __global__ functions of fovsplat_torch/csrc: the port's own
    kernels."""
    from fovsplat_torch.ops.kernels import _build
    return kernel_names(sorted(_build.CSRC.glob("*.cu*")))


def profiled(run, holds, attempts=3):
    """A torch.profiler window (CPU and CUDA activities) over run(), opened
    again, up to `attempts` windows in all, while holds(events) is false:
    the profiler at times delivers a window without its device events.
    Returns (the events, or None if no window held them, the last
    window's wall time in us, the windows opened)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        if holds(events):
            return prof, wall_us, attempt
    return None, wall_us, attempts


def device_ms(fn, reps, names=None):
    """The kernel's own device time per call: the CUDA time of the port's
    kernels (`names`, by default own_kernel_names; not the allocations or
    torch ops of the wrapper) in a torch.profiler window over `reps` calls
    of fn(), after
    one warm-up call. Each kernel name counts its mean time per event
    times its launches per call (its events over `reps`, rounded, at
    least 1), so an event the profiler drops does not shorten the time.
    Where three windows hold none of the port's kernels, the time is the
    CUDA-event mean over `reps` calls instead (wrapper included).
    Returns (ms, events seen, ms per call by kernel name, "profiler" or
    "cuda_events")."""
    import torch
    from torch.autograd import DeviceType
    pat = re.compile(r"\b(%s)\s*[(<]" % "|".join(
        sorted(names or own_kernel_names())))

    def by_name(events):
        out = {}
        for e in events:
            m = pat.search(e.name)
            if (e.device_type == DeviceType.CUDA and "at::" not in e.name
                    and m):
                out.setdefault(m.group(1), []).append(
                    e.time_range.elapsed_us())
        return out

    def run():
        for _ in range(reps):
            fn()
    fn()
    torch.cuda.synchronize()
    prof, _, windows = profiled(run, lambda ev: bool(by_name(ev)))
    if prof is None:
        emit({"phase": "note", "profiler_windows_empty": windows,
              "device_ms_from": "cuda_events"})
        return cuda_ms(fn, reps), 0, {}, "cuda_events"
    times = by_name(prof.events())
    split = {k: sum(t) / len(t) * max(1, round(len(t) / reps)) / 1e3
             for k, t in times.items()}
    return (sum(split.values()), sum(len(t) for t in times.values()),
            split, "profiler")


def kernel_times(fn, reps=20):
    """{"ms": CUDA-event mean over `reps` calls of the wrapper, "device_ms":
    the kernel's own device time per call over another `reps`,
    "device_events": the kernel events that window saw, "device_split":
    device ms per call by kernel name, "device_ms_from": "profiler", or
    "cuda_events" where no profiler window held the kernels,
    "launches_per_call": the events over `reps` (None without them)}."""
    dev_ms, events, split, origin = device_ms(fn, reps)
    return {"ms": cuda_ms(fn, reps), "device_ms": dev_ms,
            "device_events": events, "device_split": split,
            "device_ms_from": origin,
            "launches_per_call": events / reps if events else None}


def same_outputs(a, b):
    """Two launches' output tuples are equal bit for bit."""
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def train_pairs(st, cam):
    """The sorted train rows of a state seen from `cam`, with the train
    phase's capacities: the pairs kernels 5, 6 and 8 blend (the score
    pass bins as the step does). Returns (pairs (10, CAP), Binned)."""
    import torch
    from fovsplat_torch.ops import binning, projection, sh
    from fovsplat_torch.ops import rasterize as rast
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    p = st.params
    with torch.no_grad():
        prep = projection.preprocess_cols(p.xyz, p.get_scaling(),
                                          p.get_rotation(), cam,
                                          live_mask=st.live)
        colors = sh.sh_to_rgb(3, p.get_features(), p.xyz, cam.cam_center)
        return binning.bin_fused_ps1(
            rast.train_columns(prep, p.get_opacity(), colors), prep.valid,
            prep.depth, gx, gy, TRAIN_PAIR_CAPACITY, TRAIN_COMPACT_CAPACITY)


def ps1_pairs(model, cam):
    """Kernel 5q's inputs on the PS1 frame: the quantized rows of the PS1
    model (kernel 1's ps1 mode, kernel 4q, the fused-key sort) with the
    train capacities. Returns (pairs (5, CAP), seg_start (T,), seg_end
    (T,))."""
    from fovsplat_torch.ops import binning
    from fovsplat_torch.ops.kernels import build_table as bt
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    pairs, bn = binning.bin_fused_ps1(
        None, None, None, gx, gy, TRAIN_PAIR_CAPACITY,
        TRAIN_COMPACT_CAPACITY, train=False,
        prebuilt=bt.build_table_ps1(model, cam))
    return pairs, bn.seg_start[:-1], bn.seg_start[1:]


def mmfr_models(device):
    """The four MM-FR level models of bench.py:255-268."""
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    sc = proxy.bicycle_proxy(n=N_FULL, seed=0)
    return convert.mmfr_models_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["highest_levels"], device=device)


def mmfr_level_pairs(models, cfgs, cam, gaze):
    """Kernel 5q's inputs in each MM-FR level pass at `gaze`, as
    render_mmfr builds them: [(pairs, seg_start, seg_end)], the segments
    of the tiles a pass does not own emptied."""
    import torch
    from fovsplat_torch.eval import mmfr
    from fovsplat_torch.ops import foveation
    levels = foveation.compute_tile_levels(
        torch.tensor(gaze, dtype=torch.float32, device=cam.device),
        cam.width, cam.height, ALPHA)
    return [mmfr.level_pairs(m, cam, levels.to(torch.int32), li, cfg)[:3]
            for li, (m, cfg) in enumerate(zip(models, cfgs))]


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / F32_FLOP_PER_S * 1e3
    return (o_ms, "operations") if o_ms > b_ms else (b_ms, "bytes")


def forward_work(work):
    """(counts, FLOP) of kernels 5 and 5q from their plain version's work
    counts (blend.blend_forward_plain's return_work, summed over calls),
    each operation counted on the pair-pixels that need it, as the header
    of csrc/blend_fwd.cu sets out: 13 FLOP per pair-pixel walked before
    the pixel freezes, 4 more where the power lies in the window, 10 more
    where the pair contributes, 3 per freezing pair."""
    w = [int(x) for x in work.reshape(4, -1).long().sum(1)]
    counts = dict(zip(("pair_pixels_walked", "pair_pixels_in_window",
                       "pair_pixels_touched", "pixels_frozen"), w))
    return counts, 13 * w[0] + 4 * w[1] + 10 * w[2] + 3 * w[3]


def backward_work(work):
    """(counts, FLOP) of kernel 6 from its plain version's work counts
    (blend.blend_backward_plain's return_work), each operation counted on
    the pair-pixels that need it, as the backward's header in
    csrc/blend_fwd.cu sets out: 13 FLOP per pair-pixel up to the pixel's
    last contributor, 4 more where the power lies in the window, 48 more
    where the pair contributes."""
    w = [int(x) for x in work.reshape(3, -1).long().sum(1)]
    counts = dict(zip(("pair_pixels_to_last_contributor",
                       "pair_pixels_in_window", "pair_pixels_contributing"),
                      w))
    return counts, 13 * w[0] + 4 * w[1] + 48 * w[2]


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
    overhead of its own), after 3 warm-up calls; up to three windows
    (profiled) until one holds CUDA events, else the device keys are
    None."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    prof, wall_us, windows = profiled(
        run, lambda ev: any(e.device_type == DeviceType.CUDA for e in ev))
    by_name = {}
    for e in prof.events() if prof is not None else ():
        if e.device_type == DeviceType.CUDA:
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # Device time of the kernels each host-side torch op launched itself
    # (key_averages also lists the kernels as entries of their own).
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in (prof.key_averages() if prof is not None else ())
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    return {"iters": iters, "wall_ms_per_iter": wall_us / iters / 1e3,
            "device_busy_ms_per_iter": busy_us / iters / 1e3
            if by_name else None,
            "device_idle_share": (1.0 - busy_us / wall_us) if by_name
            else None,
            "profiler_windows": windows,
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
    import numpy as np
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
    cp, Tp, ncp, work = blend.blend_forward_plain(pairs, seg, gx,
                                                  return_work=True)
    counts, flop = forward_work(work)
    f_err = max(float((ck - cp).abs().max()), float((Tk - Tp).abs().max()))
    nc_diff = int((nk != ncp).sum())
    twice = same_outputs((ck, Tk, nk), bfw.blend_forward(pairs, seg, gx))
    emit({"phase": "check", "kernel": "blend_forward", "num_pairs": num_pairs,
          "max_abs_err": f_err, "tol": BLEND_ATOL,
          "n_contrib_differing_pixels": nc_diff,
          "bit_identical_twice": twice, **counts, "flop": flop})
    if not f_err <= BLEND_ATOL or nc_diff > T * P // 1000 or not twice:
        raise AssertionError(f"blend_forward: err {f_err}, {nc_diff} "
                             f"n_contrib differ, bit-identical twice {twice}")
    nbytes = num_pairs * 36 + (T + 1) * 4 + T * P * 20
    b_ms, b_by = bound(nbytes, float(flop))
    results["blend_forward"] = dict(
        max_abs_err=f_err, **kernel_times(lambda: bfw.blend_forward(
            pairs, seg, gx)),
        plain_ms=cuda_ms(lambda: blend.blend_forward_plain(pairs, seg, gx),
                         1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{cam.width}x{cam.height}, pairs={num_pairs}", **counts)

    # --- kernel 6, on the cotangent of the photometric loss (g_T = 0, the
    # step's) and with a seeded random g_T of the colour cotangent's scale
    tile_c = ck.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        img = blend.tiles_to_image(tile_c, gx, gy, cam.width, cam.height)
        g_c, = torch.autograd.grad(losses.photometric_loss(img, gt), tile_c)
    rand_g_T = torch.from_numpy(np.random.default_rng(6).normal(
        0.0, 1.0, tuple(Tk.shape)).astype(np.float32)).to(Tk.device) \
        * g_c.abs().max()
    checks, b_err = {}, 0.0
    for tag, g_T in (("loss", torch.zeros_like(Tk)), ("random_g_T",
                                                       rand_g_T)):
        bargs = (pairs, seg, gx, g_c, g_T, Tk, nk)
        gk = bfw.blend_backward(*bargs)
        twice = bool(torch.equal(gk, bfw.blend_backward(*bargs)))
        gp, work = blend.blend_backward_plain(*bargs, return_work=True)
        row_max = gp.abs().amax(1)
        rel = float(((gk - gp).abs().amax(1) / row_max.clamp(min=1e-30))
                    .max())
        b_err = max(b_err, float((gk - gp).abs().max()))
        checks[tag] = {"max_rel_err_of_row_max": rel,
                       "bit_identical_twice": twice,
                       "row_max": [float(x) for x in row_max]}
        if tag == "loss":
            counts, flop = backward_work(work)
    # FLOP by need (backward_work); bytes: 72 B per pair (rows in,
    # gradients out) and 24 B per pixel.
    nbytes = num_pairs * 72 + T * P * 24
    b_ms, b_by = bound(nbytes, float(flop))
    emit({"phase": "check", "kernel": "blend_backward",
          "num_pairs": num_pairs, **checks, "tol": BWD_RTOL, **counts,
          "flop": flop, "bytes": nbytes, "bound_ms": b_ms,
          "bound_by": b_by})
    if not all(c["max_rel_err_of_row_max"] <= BWD_RTOL
               and c["bit_identical_twice"] for c in checks.values()):
        raise AssertionError(f"blend_backward: {checks}")
    bargs = (pairs, seg, gx, g_c, torch.zeros_like(Tk), Tk, nk)
    results["blend_backward"] = dict(
        max_abs_err=b_err,
        **kernel_times(lambda: bfw.blend_backward(*bargs)),
        plain_ms=cuda_ms(lambda: blend.blend_backward_plain(*bargs), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{cam.width}x{cam.height}, pairs={num_pairs}",
        max_rel_err_of_row_max=max(c["max_rel_err_of_row_max"]
                                   for c in checks.values()), **counts)

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
    from fovsplat_torch.ops import blend
    from fovsplat_torch.ops.kernels import blend_stats as bs
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    T, P = gx * gy, blend.PIX
    pairs, bn = train_pairs(st, cam)
    seg, num_pairs = bn.seg_start, int(bn.num_pairs)
    args = (pairs, seg, gx, cam.width, cam.height)
    k = bs.blend_stats(*args)
    q = blend.blend_stats_plain(*args, return_walked=True)
    walked = q[6]
    exact = {"best_lane": torch.equal(k[3], q[3]),
             "first_trig": torch.equal(k[5], q[5]),
             "touched": torch.equal(k[2][1], q[2][1]),
             "geo_win": torch.equal(k[2][3], q[2][3]),
             "bit_identical_twice": same_outputs(k, bs.blend_stats(*args))}

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


def ring_extrinsics(count, width, height):
    """(R_c2w, t, fovx, fovy) of `count` cameras on the proxy camera's
    capture ring (radius 4, the first at the proxy camera's eye), looking
    at the object."""
    from fovsplat_torch.data.cameras import look_at_extrinsics
    a0 = math.atan2(-2.4, 3.2)
    out = []
    for i in range(count):
        R, t = look_at_extrinsics(
            [4.0 * math.cos(a0 + 2 * math.pi * i / count), -1.1,
             4.0 * math.sin(a0 + 2 * math.pi * i / count)], [0.0, 0.0, 0.0],
            [0, -1, 0])
        out.append((R, t, 1.20, 1.20 * height / width * 1.24))
    return out


def ring_cameras(count, width, height, device):
    """The cameras of ring_extrinsics."""
    from fovsplat_torch.data.cameras import make_camera
    return [make_camera(R, t, fx, fy, width, height, device=device)
            for R, t, fx, fy in ring_extrinsics(count, width, height)]


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
    counter set to 0 just before and read just after. Returns (the launch
    counts, the composed model, {"ps1": the PS1 state, "train_views",
    "counts": the live ladder}); raises when a check fails."""
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
    return launches, model, {"ps1": ps1, "train_views": train_views,
                             "counts": counts}


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


# ----------------------------------------------------- scene, scratch, pipeline

SCENE_VIEWS = 16
SCENE_POINTS = 100_000           # dataset.py:156's Blender init count
SCENE_DIR = "build/scene_io"
# pipeline.py:117: from-scratch capacity = points * headroom 1.3 * 8.
SCRATCH_CAPACITY = int(SCENE_POINTS * 1.3 * 8)
# The scratch schedule, cut from ScratchConfig's 30,000 iterations
# (densify from 500 every 100 until 15,000, opacity reset every 3,000, SH
# up every 1,000, LG prunes at 16,000 and 24,000): densify events at 100,
# 150, 200 and 250, an opacity reset at 200 (so the screen-size prune
# runs at 250), the SH degree raised at 100, 200 and 300, one LG prune at
# 280.
#
# The threshold is not a cut: the JAX package's accumulate scales the
# pixel-space gradient by 2 / size where the reference's NDC gradient is
# the pixel gradient times size / 2 (ROADMAP section 3), so its default
# 2e-4 never densifies at this width. 2e-4 (2 / 1237)^2 is the
# reference's 2e-4 in that scaling (for x; y's factor is (1237 / 822)^2
# larger).
def jax_scaled_threshold(width, ref=2e-4):
    return ref * (2.0 / width) ** 2


SCRATCH_CUT = dict(iterations=300, densify_from=50, densify_every=50,
                   densify_until=260, opacity_reset_every=200,
                   sh_up_every=100, prune_iterations=(280,),
                   densify_grad_threshold=jax_scaled_threshold(W_FULL))
SCRATCH_RTOL = 1e-4              # card vs CPU: DensifyStats (of the largest sum),
                                 # params (of each row's largest value)


def qvec_of(R):
    """A unit quaternion (w, x, y, z) whose colmap.qvec2rotmat is the
    rotation R (Shepperd's method: the largest of the four terms first)."""
    import numpy as np
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [s / 4, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, s / 4, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, s / 4,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, s / 4]
    q = np.array(q)
    return q / np.linalg.norm(q)


def write_scene(root, width, height, cfg, device):
    """A COLMAP binary scene at `root`: the 16 ring cameras as PINHOLE
    entries, their PNGs rendered from the full-width proxy (as
    chain_inputs renders its ground truth) and 100,000 points, the centres
    of the 100,000-Gaussian proxy of seed 1 with their level-0 DC colours.
    Returns (ring cameras, points f32, colours f32 as the loader reads
    them)."""
    import os
    import numpy as np
    import torch
    from PIL import Image
    from fovsplat_torch import convert
    from fovsplat_torch.data import colmap, proxy
    from fovsplat_torch.models import state as S
    from fovsplat_torch.ops import sh
    from fovsplat_torch.train import loops
    from fovsplat_torch.utils import graphics
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=N_FULL, seed=0))
    teacher = S.from_params(convert.params_from_numpy(**raw, device=device))
    ext = ring_extrinsics(SCENE_VIEWS, width, height)
    cams = ring_cameras(SCENE_VIEWS, width, height, device)
    imgs = {}
    with torch.no_grad():
        for i, ((R, t, fovx, fovy), c) in enumerate(zip(ext, cams)):
            img = loops.render_state(teacher, c, cfg)["render"]
            u8 = torch.round(torch.clamp(img, 0.0, 1.0) * 255).to(
                torch.uint8).cpu().numpy()
            name = f"view_{i:03d}.png"
            Image.fromarray(u8).save(os.path.join(root, "images", name))
            imgs[i + 1] = colmap.ColmapImage(i + 1, qvec_of(R.T), t, 1, name)
    del teacher
    fovx, fovy = ext[0][2], ext[0][3]
    cam = colmap.ColmapCamera(1, "PINHOLE", width, height, np.array(
        [graphics.fov2focal(fovx, width), graphics.fov2focal(fovy, height),
         width / 2, height / 2]))
    pts = proxy.bicycle_proxy(n=SCENE_POINTS, seed=1)
    rgb = np.round(np.clip(sh.sh_dc_to_rgb(pts["shs_dcs"][:, 0, :]), 0.0,
                           1.0) * 255).astype(np.uint8)
    colmap.write_model(os.path.join(root, "sparse", "0"), {1: cam}, imgs,
                       pts["means"], rgb)
    return cams, pts["means"], rgb.astype(np.float32) / 255.0


def run_scene_io(cfg, device):
    """Phase scene_io: write the scene, load it with dataset.load_scene
    (resolution 1) and check it. Returns (scene, its directory)."""
    import os
    import numpy as np
    from fovsplat_torch.data import dataset
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SCENE_DIR)
    t0 = time.perf_counter()
    cams, pts, cols = write_scene(root, W_FULL, H_FULL, cfg, device)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = dataset.load_scene(root, resolution=1, device=device)
    t_load = time.perf_counter() - t0
    views = sorted(scene.train_views + scene.test_views,
                   key=lambda v: v.image_name)
    cam_err = max(float((getattr(v.camera, f) - getattr(c, f)).abs().max())
                  for v, c in zip(views, cams)
                  for f in ("world_view", "full_proj"))
    sizes = {(v.camera.width, v.camera.height) for v in views}
    shapes = {v.image.shape for v in views}
    test_names = [v.image_name for v in scene.test_views]
    points_exact = bool(np.array_equal(scene.points, pts.astype(np.float32)))
    colors_exact = bool(np.array_equal(scene.colors, cols))
    row = {"phase": "scene_io", "root": SCENE_DIR, "views": len(views),
           "train": len(scene.train_views), "test": len(scene.test_views),
           "test_views": test_names, "camera_max_abs_err": cam_err,
           "sizes": sorted(sizes), "points": len(scene.points),
           "points_exact": points_exact, "colors_exact": colors_exact,
           "spatial_scale": scene.spatial_scale,
           "seconds": {"write": t_write, "load": t_load},
           "tol": {"camera": 1e-6}}
    emit(row)
    if not (cam_err <= 1e-6 and len(scene.train_views) == 14
            and test_names == ["view_000", "view_008"]
            and sizes == {(W_FULL, H_FULL)}
            and shapes == {(H_FULL, W_FULL, 3)} and points_exact
            and colors_exact and len(views) == SCENE_VIEWS):
        raise AssertionError("the loaded scene differs from the written one")
    return scene, root


@contextlib.contextmanager
def recorded_scratch_steps(scratch, rows, last, timed):
    """Keep every scratch step's output row (and, with `timed`, a pair of
    CUDA events around it), and the last step's DensifyStats in
    last["dstats"], while train_scratch runs."""
    import torch
    saved = scratch.make_scratch_step

    def made(*a, **k):
        step = saved(*a, **k)

        def run(*sa, **sk):
            ev = None
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            new, dstats, aux = step(*sa, **sk)
            if timed:
                ev[1].record()
            rows.append((aux, ev))
            last["dstats"] = dstats
            return new, dstats, aux
        return run
    scratch.make_scratch_step = made
    try:
        yield
    finally:
        scratch.make_scratch_step = saved


def bad_rows(rows):
    """Indices of step rows with overflow, non-finite gradients or a
    non-finite loss."""
    out = []
    for i, r in enumerate(rows):
        if not (int(r["overflow"]) == 0 and int(r["nonfinite"]) == 0
                and math.isfinite(float(r["loss"]))):
            out.append(i)
    return out


def scratch_launches(iterations, views, lg_prunes):
    """The launches of kernels 4-8 a train_scratch run implies: one
    expansion, forward and backward blend and gid reduce a step, and per
    view of each LG prune one expansion, stats blend and reduce (the
    count_opacity contributions)."""
    lg = views * lg_prunes
    return {"expand_ps1": iterations + lg, "blend_forward": iterations,
            "blend_backward": iterations,
            "reduce_by_sorted_gid": iterations + lg, "blend_stats": lg}


def scratch_config(**kw):
    from fovsplat_torch.train import scratch
    return scratch.ScratchConfig(**{**SCRATCH_CUT, **kw})


def run_scratch(scene, cfg, kernels, device):
    """Phase scratch: create_from_points on the card (knn over the scene's
    100,000 points), from_params at the pipeline's capacity, train_scratch
    on the cut schedule with every launch counter set to 0 just before
    and read just after; then the first 100 iterations twice from the same
    init and seed, bit-identical."""
    import torch
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.models import gaussians as G
    from fovsplat_torch.models import state as S
    from fovsplat_torch.train import scratch
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    cfg = dataclasses.replace(cfg, spatial_lr_scale=scene.spatial_scale)
    t0 = time.perf_counter()
    params = G.create_from_points(scene.points, scene.colors, device=device)
    init = S.from_params(params, capacity=SCRATCH_CAPACITY)
    sync()
    seconds = {"init": time.perf_counter() - t0}
    events = []

    def log(msg):
        events.append(msg)
        print(msg, file=sys.stderr, flush=True)

    rows, last = [], {}
    scfg = scratch_config()
    wants = []
    clone = D.densify_and_clone

    def counted_clone(state, stats, thr, extent, pd, budget):
        # Live rows over the threshold at each event, small and large.
        g = stats.grad_accum / torch.clamp(stats.denom, min=1.0)
        big = state.params.get_scaling().detach().amax(1) > pd * extent
        over = state.live & (g >= thr)
        wants.append({"clone": int((over & ~big).sum()),
                      "split": int((over & big).sum())})
        return clone(state, stats, thr, extent, pd, budget)

    for kf in kernels.values():
        kf.launches = 0
    t0 = time.perf_counter()
    D.densify_and_clone = counted_clone
    try:
        with recorded_scratch_steps(scratch, rows, last, device != "cpu"):
            out = scratch.train_scratch(init, scene.train_views, cfg, scfg,
                                        scene_extent=scene.spatial_scale,
                                        log=log, seed=0)
    finally:
        D.densify_and_clone = clone
    sync()
    seconds["train_scratch"] = time.perf_counter() - t0
    launches = {k: kf.launches for k, kf in kernels.items()}
    want = scratch_launches(scfg.iterations, len(scene.train_views),
                            len(scfg.prune_iterations))
    step_ms = ([a[1][0].elapsed_time(a[1][1]) for a in rows]
               if device != "cpu" else [])
    dens = [{"it": int(re.search(r"it=(\d+)", m).group(1)),
             "live": int(re.search(r"live=(\d+)", m).group(1)),
             "dropped": int(re.search(r"dropped=(\d+)", m).group(1))}
            for m in events if "densify live=" in m]
    lg = [m for m in events if "LG prune" in m]
    steps = [r[0] for r in rows]
    bad = bad_rows(steps)
    losses = [float(r["loss"]) for r in steps]
    row = {"phase": "scratch", "width": W_FULL, "height": H_FULL,
           "points": len(scene.points), "capacity": SCRATCH_CAPACITY,
           "schedule": {k: v for k, v in SCRATCH_CUT.items()},
           "cuts": "iterations 300 of 30,000; densify from 50 every 50 "
                   "until 260 (500 / 100 / 15,000); opacity reset every 200 "
                   "(3,000); SH up every 100 (1,000); LG prune at 280 "
                   "(16,000 and 24,000); densify threshold 2e-4 (2/1237)^2 "
                   "for the JAX package's 2/size gradient scaling",
           "want_at_events": wants,
           "raster": {"pair_capacity": cfg.raster.pair_capacity,
                      "compact_capacity": cfg.raster.compact_capacity},
           "spatial_scale": scene.spatial_scale,
           "live": {"init": int(init.live_count()),
                    "end": int(out.live_count())},
           "densify_events": dens, "lg_prune": lg,
           "steps": len(steps), "bad_steps": bad,
           "loss_first_last": [losses[0], losses[-1]],
           "max_num_pairs": max(int(r["num_pairs"]) for r in steps),
           "step_ms_mean": (sum(step_ms) / len(step_ms)) if step_ms else None,
           "step_ms_min_max": ([min(step_ms), max(step_ms)] if step_ms
                               else None),
           "seconds": seconds, "launches": launches,
           "launches_expected": want}
    emit(row)
    events = [i for i in range(1, scfg.iterations + 1)
              if scfg.densify_from < i < scfg.densify_until
              and i % scfg.densify_every == 0]
    if (bad or [e["it"] for e in dens] != events
            or len(lg) != len(scfg.prune_iterations)):
        raise AssertionError("the scratch run failed a check")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{k}: {launches[k]} launches on the "
                                 f"scratch path, the schedule implies {n}")

    # Determinism: the first 100 iterations twice from one init and seed.
    # The state after them (the first densify event, at 100, done) is the
    # profiled state.
    outs = []
    for _ in range(2):
        rows2, last2 = [], {}
        with recorded_scratch_steps(scratch, rows2, last2, False):
            st = scratch.train_scratch(init, scene.train_views, cfg,
                                       scratch_config(iterations=100),
                                       scene_extent=scene.spatial_scale,
                                       log=lambda m: None, seed=0)
        outs.append((st, last2["dstats"]))
    (a, da), (b, db) = outs
    same = {"live": bool(torch.equal(a.live, b.live)),
            "count": bool(torch.equal(a.opt.count, b.opt.count))}
    for f in a.params.fields():
        same[f] = bool(torch.equal(getattr(a.params, f),
                                   getattr(b.params, f)))
        same["mu_" + f] = bool(torch.equal(a.opt.mu[f], b.opt.mu[f]))
        same["nu_" + f] = bool(torch.equal(a.opt.nu[f], b.opt.nu[f]))
    for f in ("grad_accum", "denom", "max_radii"):
        same["stats_" + f] = bool(torch.equal(getattr(da, f),
                                              getattr(db, f)))
    emit({"phase": "scratch_determinism", "iterations": 100,
          "live": int(a.live_count()), "bit_identical": same})
    if not all(same.values()):
        raise AssertionError(f"two scratch runs differ: {same}")
    if device != "cpu":
        step = scratch.make_scratch_step(cfg)
        v = scene.train_views[0]
        gt = torch.as_tensor(v.image, device=device)
        d0 = D.init_stats(a.capacity, device)

        def one():
            return step(a, d0, v.camera, gt, 101, 1)
        emit({"phase": "profile", "path": "scratch step, first densify "
                                          "event (iteration 101)",
              "live": int(a.live_count()),
              "step_ms_unprofiled": cuda_ms(one, 3),
              **profile_window(one, 3)})
    return launches


@contextlib.contextmanager
def recorded_densify(D, split_noise, rec):
    """While train_scratch runs: the split takes `split_noise` (moved to the
    state's device) in place of its own draw, and each densify event
    records the statistics and the clone's and split's placements (the
    dead slots filled, the candidate lanes and which were placed)."""
    import torch
    saved = (D.densify_and_clone, D.densify_and_split, D._place_rows)

    def clone(state, stats, *a, **k):
        rec.setdefault("stats", stats)
        return saved[0](state, stats, *a, **k)

    def split(state, stats, *a, noise=None):
        return saved[1](state, stats, *a,
                        noise=split_noise.to(state.live.device))

    def place(state, new_params, priority, want, budget):
        # The dead slots _place_rows fills, in its order.
        _, slots = D._top(torch.where(state.live, -1.0, 1.0), budget)
        out = saved[2](state, new_params, priority, want, budget)
        rec.setdefault("places", []).append(
            (slots.cpu(), out[1].cpu(), out[2].cpu(), want.cpu()))
        return out

    D.densify_and_clone, D.densify_and_split, D._place_rows = (clone, split,
                                                               place)
    try:
        yield
    finally:
        D.densify_and_clone, D.densify_and_split, D._place_rows = saved


def scratch_vs_cpu(cfg, n=20_000, w=320, h=224, devices=("cuda", "cpu")):
    """Phase scratch_vs_cpu: 20 scratch steps with one densify event (at
    iteration 10) on the 20k proxy of train_vs_cpu (capacity 40,000) at
    320x224 against renders of the 20k proxy of seed 0 on 4 ring cameras,
    on the card and on the CPU plain path, with the same split noise
    and the threshold of SCRATCH_CUT's rule at this width. DensifyStats at the event within 1e-4 relative; clone
    and split selections equal but for rows whose mean gradient lies
    within 1e-4 relative of the threshold (counted); params after the 20
    steps within 1e-4 of each row's largest value, new rows matched by
    the candidate they came from."""
    import numpy as np
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import dataset, proxy
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.models import state as S
    from fovsplat_torch.train import loops, scratch
    cap = 2 * n          # room for the clones and the splits
    teacher = S.from_params(convert.params_from_numpy(
        **proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=0)),
        device="cpu"))
    with torch.no_grad():
        images = [torch.clamp(loops.render_state(teacher, c, cfg)["render"],
                              0.0, 1.0).numpy()
                  for c in ring_cameras(4, w, h, "cpu")]
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=1))
    extent = dataset._nerfpp_norm(np.stack(
        [-R @ t for R, t, _, _ in ring_extrinsics(4, w, h)]))
    scfg = scratch.ScratchConfig(
        iterations=20, densify_from=9, densify_every=10, densify_until=19,
        opacity_reset_every=1000, sh_up_every=1000,
        densify_grad_threshold=jax_scaled_threshold(w))
    noise = torch.randn((2, cap, 3), generator=torch.Generator().manual_seed(7))
    res = []
    for d in devices:
        views = [View(c, img) for c, img in zip(ring_cameras(4, w, h, d),
                                               images)]
        st = S.from_params(convert.params_from_numpy(**raw, device=d), cap)
        rows, last, rec = [], {}, {}
        with recorded_scratch_steps(scratch, rows, last, False), \
                recorded_densify(D, noise, rec):
            out = scratch.train_scratch(st, views, cfg, scfg,
                                        scene_extent=extent,
                                        log=lambda m: None, seed=0)
        res.append((out, rec, [r[0] for r in rows]))
    (oc, rc, sc_rows), (oh, rh, sh_rows) = res
    thr = scfg.densify_grad_threshold
    # Statistics at the event.
    sc_, sh_ = rc["stats"], rh["stats"]
    ga_c, ga_h = sc_.grad_accum.cpu(), sh_.grad_accum
    nz = ga_h != 0
    # Relative to the largest sum, as gradients are compared: a row whose
    # gradients cancel has a small sum with the absolute error of a
    # large one (the elementwise worst is printed beside it).
    stats_rel = float((ga_c - ga_h).abs().max() / ga_h.abs().max())
    stats_rel_elementwise = float(
        ((ga_c - ga_h).abs()[nz] / ga_h.abs()[nz]).max())
    stats_exact = {"zero_rows": bool((ga_c[~nz] == 0).all()),
                   "denom": bool(torch.equal(sc_.denom.cpu(), sh_.denom)),
                   "max_radii": bool(torch.equal(sc_.max_radii.cpu(),
                                                 sh_.max_radii))}
    g_h = ga_h / torch.clamp(sh_.denom, min=1.0)
    near = (g_h - thr).abs() <= SCRATCH_RTOL * thr
    # Selections, and for each CPU row the card row that holds the same
    # Gaussian: a new row is matched by the candidate it came from, since
    # near-equal priorities may rank in another order on the card.
    src_row = torch.arange(cap)
    excluded = torch.zeros(cap, dtype=torch.bool)
    sel = []
    for (s_c, c_c, p_c, w_c), (s_h, c_h, p_h, w_h) in zip(rc["places"],
                                                          rh["places"]):
        diff = w_c != w_h
        sel.append({"want": int(w_h.sum()), "want_differs": int(diff.sum()),
                    "differs_off_threshold": int((diff & ~near).sum()),
                    "placed": int(p_h.sum())})
        slot_c = dict(zip(c_c[p_c].tolist(), s_c[p_c].tolist()))
        slot_h = dict(zip(c_h[p_h].tolist(), s_h[p_h].tolist()))
        for cand in set(slot_c) | set(slot_h):
            if cand in slot_c and cand in slot_h:
                src_row[slot_h[cand]] = slot_c[cand]
            else:
                for sl in (slot_c.get(cand), slot_h.get(cand)):
                    if sl is not None:
                        excluded[sl] = True
                excluded[cand] = True
    live_c, live_h = oc.live.cpu(), oh.live
    live_same = bool(torch.equal(live_c[src_row][~excluded],
                                 live_h[~excluded]))
    keep = live_h & ~excluded
    # Params within 1e-4 of each row's largest value, but for at most
    # 0.5% of the rows of a field: an Adam step moves an entry by ~lr
    # whatever its gradient's size, so an entry whose gradient is ~0 at
    # some step moves by the sign of summation noise there (as in
    # tests/test_torch_scratch.py). Those rows stay within 2 lr a step.
    lrs = {"xyz": cfg.optim.position_lr_init * cfg.spatial_lr_scale,
           "features_dc": cfg.optim.feature_lr,
           "features_rest": cfg.optim.feature_lr / 20.0,
           "scaling": cfg.optim.scaling_lr,
           "rotation": cfg.optim.rotation_lr,
           "opacity": cfg.optim.opacity_lr}
    param_err, rows_off, worst_lr = {}, {}, {}
    for f in oh.params.fields():
        a = getattr(oc.params, f).detach().cpu()[src_row][keep].reshape(
            int(keep.sum()), -1)
        b = getattr(oh.params, f).detach()[keep].reshape(int(keep.sum()), -1)
        rmax = b.abs().amax(1, keepdim=True)
        excess = (a - b).abs() - SCRATCH_RTOL * rmax
        param_err[f] = float(excess.max())
        rows_off[f] = float((excess > 0).any(1).float().mean())
        worst_lr[f] = float((a - b).abs().max()) / lrs[f]
    bad = bad_rows(sc_rows) + bad_rows(sh_rows)
    row = {"phase": "scratch_vs_cpu", "shape": f"N={n}, {w}x{h}",
           "capacity": cap, "steps": len(sc_rows), "bad_steps": bad,
           "threshold": thr, "stats_rel_err": stats_rel,
           "stats_rel_err_elementwise": stats_rel_elementwise,
           "stats_exact": stats_exact,
           "rows_near_threshold": int(near.sum()),
           "selections": dict(zip(("clone", "split"), sel)),
           "rows_excluded": int(excluded.sum()),
           "live": [int(oc.live_count()), int(oh.live_count())],
           "live_equal_mapped": live_same,
           "param_excess_over_tol": param_err,
           "param_rows_over_tol": rows_off, "param_worst_in_lr": worst_lr,
           "tol": {"rtol": SCRATCH_RTOL, "rows_over": 0.005,
                   "worst_in_lr": 2 * scfg.iterations}}
    emit(row)
    if not (not bad and stats_rel <= SCRATCH_RTOL and all(stats_exact.values())
            and all(s["differs_off_threshold"] == 0 for s in sel)
            and sel[0]["placed"] + sel[1]["placed"] > 0 and live_same
            and all(v <= 0.005 for v in rows_off.values())
            and all(v <= 2 * scfg.iterations for v in worst_lr.values())):
        raise AssertionError("card scratch run differs from the CPU run")


@contextlib.contextmanager
def pipeline_probes(pipeline, scratch, loops, rows, seconds, saved_states):
    """While run_pipeline runs: train_scratch takes the cut schedule
    (SCRATCH_CUT) in place of the pipeline's iterations-only config; the
    loops' and the scratch step's rows are recorded; each training stage's
    seconds are summed by name; and each checkpoint saved is kept by its
    file name."""
    import os
    orig = {"train_scratch": scratch.train_scratch,
            "prune_training": loops.prune_training,
            "finetune": loops.finetune, "mask_training": loops.mask_training}
    save = pipeline.ckpt.save

    def timed(name):
        def run(*a, **k):
            if name == "train_scratch":
                a = list(a)
                a[3] = scratch_config(iterations=a[3].iterations)
            t0 = time.perf_counter()
            out = orig[name](*a, **k)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    def keep_save(path, state, *a, **k):
        saved_states[os.path.basename(path)] = state
        return save(path, state, *a, **k)

    scratch.train_scratch = timed("train_scratch")
    for name in ("prune_training", "finetune", "mask_training"):
        setattr(loops, name, timed(name))
    pipeline.ckpt.save = keep_save
    try:
        with recorded_scratch_steps(scratch, rows, {}, False), \
                recorded_steps(loops, rows):
            yield
    finally:
        scratch.train_scratch = orig["train_scratch"]
        for name in ("prune_training", "finetune", "mask_training"):
            setattr(loops, name, orig[name])
        pipeline.ckpt.save = save


def run_pipeline_phase(root, scene, cfg, frame_cfg, kernels, device):
    """Phase pipeline: run_pipeline(small=True) on the scene_io scene with
    PipelineConfig(scratch_iters=300) and the scratch cut, every launch
    counter set to 0 just before and read just after; every stage file
    present, base.npz reloading bit-identically, point_cloud_ps1.ply
    reloading to ps1.npz's live rows; a second call skipping every stage;
    one "ours" frame of the composed model at the centre gaze."""
    import io
    import os
    import shutil
    import torch
    from fovsplat_torch import pipeline
    from fovsplat_torch.eval import fps
    from fovsplat_torch.models import checkpoint as ckpt
    from fovsplat_torch.models import gaussians as G
    from fovsplat_torch.models import state as S
    from fovsplat_torch.train import loops, scratch
    out_dir = os.path.join(root, "pipeline_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    pcfg = pipeline.PipelineConfig(scratch_iters=300)
    lcfg = dataclasses.replace(cfg, spatial_lr_scale=scene.spatial_scale)
    rows, seconds, saved = [], {}, {}
    for kf in kernels.values():
        kf.launches = 0
    t0 = time.perf_counter()
    with pipeline_probes(pipeline, scratch, loops, rows, seconds, saved), \
            contextlib.redirect_stdout(sys.stderr):
        model, layers = pipeline.run_pipeline(root, out_dir, cfg=pcfg,
                                              loop_cfg=lcfg, small=True,
                                              device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds["total"] = time.perf_counter() - t0
    launches = {k: kf.launches for k, kf in kernels.items()}
    files = ["base.npz", "pruned.npz", "ps1.npz"] + [
        f"layer{i}_ps{ps}.npz" for i, ps in
        enumerate(pipeline.pooling_ladder(pcfg)[1:], start=1)] + [
        "ours_composed.npz", "pnum.txt", "naive_fr.npz",
        "point_cloud_ps1.ply", "log.txt"]
    missing = [f for f in files if not os.path.exists(os.path.join(out_dir,
                                                                    f))]
    base, _, _ = ckpt.load(os.path.join(out_dir, "base.npz"), device=device)
    ref = saved["base.npz"]
    base_same = (bool(torch.equal(base.live, ref.live))
                 and bool(torch.equal(base.opt.count, ref.opt.count))
                 and all(torch.equal(getattr(base.params, f),
                                     getattr(ref.params, f))
                         and torch.equal(base.opt.mu[f], ref.opt.mu[f])
                         and torch.equal(base.opt.nu[f], ref.opt.nu[f])
                         for f in base.params.fields()))
    ps1, _, _ = ckpt.load(os.path.join(out_dir, "ps1.npz"), device=device)
    ply, _ = G.load_ply(os.path.join(out_dir, "point_cloud_ps1.ply"),
                        device=device)
    compact, _ = S.compact(ps1)
    ply_same = all(torch.equal(getattr(ply, f), getattr(compact, f))
                   for f in ply.fields())
    log_first = open(os.path.join(out_dir, "log.txt")).read()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.run_pipeline(root, out_dir, cfg=pcfg, loop_cfg=lcfg,
                              small=True, device=device)
    resume_s = time.perf_counter() - t0
    log_second = open(os.path.join(out_dir, "log.txt")).read()[
        len(log_first):]
    skips = ["base model", "pruned model", "ps1 model"] + [
        f"layer {i}" for i in range(1, len(layers))]
    not_skipped = [s for s in skips if f"[skip] {s}" not in log_second]
    render = fps.make_fov_render(model, frame_cfg, alpha=ALPHA)
    cam = scene.test_views[0].camera
    frame = render(cam, torch.tensor((0.5, 0.5), dtype=torch.float32,
                                     device=cam.device))
    img = frame["render"]
    finite = bool(torch.isfinite(img).all())
    bad = bad_rows([r[0] if isinstance(r, tuple) else r for r in rows])
    row = {"phase": "pipeline", "config": "PipelineConfig(scratch_iters=300)"
                                          ", small=True, scratch cut as the "
                                          "scratch phase",
           "raster": {"pair_capacity": lcfg.raster.pair_capacity,
                      "compact_capacity": lcfg.raster.compact_capacity},
           "stage_files_missing": missing, "base_reload_bit_identical":
               base_same, "ply_matches_ps1_live_rows": ply_same,
           "live_ladder": [int(s.live_count()) for s in layers],
           "base_live": int(ref.live_count()),
           "steps": len(rows), "bad_steps": bad, "seconds": seconds,
           "resume_seconds": resume_s, "resume_not_skipped": not_skipped,
           "frame": {"camera": scene.test_views[0].image_name,
                     "finite": finite, "num_pairs": int(frame["num_pairs"]),
                     "overflow": int(frame["overflow"]),
                     "mean": float(img.mean())},
           "launches": launches}
    emit(row)
    if (missing or not base_same or not ply_same or not_skipped or bad
            or not finite or row["frame"]["overflow"] != 0):
        raise AssertionError("the pipeline phase failed a check")
    for k in ("expand_ps1", "blend_forward", "blend_backward",
              "reduce_by_sorted_gid", "blend_stats"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched in the pipeline")
    return launches


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
    errs, twice = {}, {}
    for tag, se in (("full", seg[1:]),
                    ("emptied", torch.where(torch.arange(T, device=dev) % 3
                                            != 0, seg[1:], ss))):
        ko = bfw.blend_forward_q(pairs, ss, se, gx)
        po = blend.blend_forward_q_plain(pairs, ss, se, gx,
                                         return_work=True)
        errs[tag] = max(float((ko[0] - po[0]).abs().max()),
                        float((ko[1] - po[1]).abs().max()))
        twice[tag] = same_outputs(ko, bfw.blend_forward_q(pairs, ss, se, gx))
        if tag == "full":
            counts, flop = forward_work(po[3])
    emit({"phase": "check", "kernel": "blend_forward_q",
          "num_pairs": num_pairs, "max_abs_err": errs, "tol": BLEND_ATOL,
          "bit_identical_twice": twice, **counts, "flop": flop})
    if not (all(e <= BLEND_ATOL for e in errs.values())
            and all(twice.values())):
        raise AssertionError(f"blend_forward_q: {errs}, bit-identical "
                             f"twice {twice}")
    # FLOP by need (forward_work); bytes: 20 B per pair read, the segment
    # bounds, colour, T and n_contrib out.
    b_ms, b_by = bound(num_pairs * 20 + 2 * T * 4 + T * P * 20, float(flop))
    se = seg[1:]
    results["blend_forward_q"] = dict(
        max_abs_err=max(errs.values()),
        **kernel_times(lambda: bfw.blend_forward_q(pairs, ss, se, gx)),
        plain_ms=cuda_ms(lambda: blend.blend_forward_q_plain(pairs, ss, se,
                                                             gx), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{W_FULL}x{H_FULL}, pairs={num_pairs}", **counts)

    # --- 9, on the ps1 table (timed), on the "ours" frame's table, and on
    # that table with no column valid and with every column valid
    checks = {}
    for tag, table, flag, tn, valid in (
            ("ps1", tk, ep1.ROW_TNUM, ep1.ROW_TNUM, None),
            ("fov", fov_table, bt.ROW_VALID, bt.ROW_TNUM, None),
            ("fov_none_kept", fov_table, bt.ROW_VALID, bt.ROW_TNUM, 0.0),
            ("fov_all_kept", fov_table, bt.ROW_VALID, bt.ROW_TNUM, 1.0)):
        if valid is not None:
            table = table.clone()
            table[flag] = valid
        ko = ct.compact_table(table, flag, 0.5, tn)
        again = ct.compact_table(table, flag, 0.5, tn)
        po = ct.compact_table_plain(table, flag, 0.5, tn)
        checks[tag] = {"bit_identical": same_outputs(ko, po),
                       "bit_identical_twice": same_outputs(ko, again),
                       "live": int(ko[2]), "columns": table.shape[1],
                       "total": int(ko[3])}
    del table, ko, again, po
    emit({"phase": "check", "kernel": "compact_table", **checks})
    if not all(c["bit_identical"] and c["bit_identical_twice"]
               for c in checks.values()):
        raise AssertionError(f"compact_table differs: {checks}")
    live = checks["ps1"]["live"]
    # Bytes: the table read once and the whole output table written once
    # (the zeroed columns included), and cum.
    b_ms, b_by = bound(2 * tk.numel() * 4 + n * 4, 0.0)
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


def run_mmfr(cam, kernels, results):
    """The MM-FR baseline over the 9 gazes at full width: the four level
    models of bench.py:255-268, per-level capacities sized as
    bench.py:299-331 does (the largest kept and candidate counts over the
    9 gazes at probe capacities, rounded up), overflow 0 on every pass.
    Then kernel 5q on the level passes (check_mmfr_blend)."""
    from fovsplat_torch.eval import fps
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    import torch
    models = mmfr_models(cam.device)
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
    results["blend_forward_q_mmfr"] = check_mmfr_blend(models, cfgs, cam)
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=cam.device)
    emit({"phase": "profile", "path": "MM-FR frame, centre gaze",
          **profile_window(lambda: render(cam, gaze), 3)})
    return launches


def check_mmfr_blend(models, cfgs, cam):
    """Kernel 5q on the four MM-FR level passes at the centre gaze (their
    own capacities): each within T_EPS of its plain version and
    bit-identical over two launches; times, plain time and bound per
    launch (the four passes' mean), for the kernels line."""
    from fovsplat_torch.ops import blend
    from fovsplat_torch.ops.kernels import blend_fwd as bfw
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    T, P = gx * gy, blend.PIX
    inputs = mmfr_level_pairs(models, cfgs, cam, (0.5, 0.5))
    errs, twice, pairs_n, owned, work = [], [], [], [], 0
    for pairs, ss, se in inputs:
        ko = bfw.blend_forward_q(pairs, ss, se, gx)
        po = blend.blend_forward_q_plain(pairs, ss, se, gx,
                                         return_work=True)
        errs.append(max(float((ko[0] - po[0]).abs().max()),
                        float((ko[1] - po[1]).abs().max())))
        twice.append(same_outputs(ko, bfw.blend_forward_q(pairs, ss, se,
                                                          gx)))
        pairs_n.append(int((se - ss).clamp(min=0).sum()))
        owned.append(int((se > ss).sum()))
        work = work + po[3].reshape(4, -1).long().sum(1)
    counts, flop = forward_work(work)
    emit({"phase": "check", "kernel": "blend_forward_q_mmfr",
          "gaze": (0.5, 0.5), "pairs_blended": pairs_n,
          "tiles_with_pairs": owned, "max_abs_err": errs, "tol": BLEND_ATOL,
          "bit_identical_twice": twice, **counts, "flop": flop})
    if not (all(e <= BLEND_ATOL for e in errs) and all(twice)):
        raise AssertionError(f"blend_forward_q on MM-FR: {errs}, "
                             f"bit-identical twice {twice}")

    def all_levels(fn):
        for pairs, ss, se in inputs:
            fn(pairs, ss, se, gx)
    n = len(inputs)
    times = kernel_times(lambda: all_levels(bfw.blend_forward_q))
    times = {"ms": times["ms"] / n, "device_ms": times["device_ms"] / n,
             "device_events": times["device_events"],
             "device_split": {k: v / n
                              for k, v in times["device_split"].items()},
             "device_ms_from": times["device_ms_from"]}
    # As kernel 5q on PS1: FLOP by need (forward_work); 20 B per pair
    # blended, the segment bounds, colour, T and n_contrib out.
    b_ms, b_by = bound((sum(pairs_n) * 20 + n * (2 * T * 4 + T * P * 20))
                       / n, flop / n)
    return dict(max_abs_err=max(errs), **times,
                plain_ms=cuda_ms(lambda: all_levels(
                    blend.blend_forward_q_plain), 1) / n,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"{W_FULL}x{H_FULL}, centre gaze, per launch over the "
                      f"4 level passes, pairs blended={pairs_n}",
                **{k: v / n for k, v in counts.items()})


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


# --- the eval phases -------------------------------------------------------

# The scene's PNGs are the teacher's own renders rounded to 8 bits, so
# the eval renders must round to them exactly; what is left is the
# rounding: 58.9 dB, and an SSIM of 0.99886 on this scene (measured on the
# H100; the 0.999 first proposed for the bar is above what the rounding
# alone allows).
QUALITY_PSNR_MIN = 50.0
QUALITY_SSIM_MIN = 0.998
EVAL_RTOL = 1e-5                 # LPIPS, HVS, layer metrics: card vs CPU
UNPACKED_ATOL = 1e-4             # rasterize_fov card vs CPU: T_EPS
UNPACKED_PSNR_MIN = 40.0         # f32 rasterize_fov vs the bf16 SoA frame
LADDER = [1, 3, 7, 12]           # pipeline.pooling_ladder's default
LPIPS_SYNTHETIC = "build/lpips_synthetic.npz"
CLI_FRAMES = 8


def synthetic_vgg_weights(seed=7):
    """LPIPS-vgg weights in the .npz layout lpips_torch reads (HWIO
    kernels, (1, 1, C, 1) heads), drawn from a seeded normal at a He-like
    scale that keeps activations O(1) through the 13 convolutions
    (tests/test_eval_schema.py's weight maker). No pretrained file is in
    the repository; these check the graph."""
    import numpy as np
    from fovsplat_torch.eval import lpips_torch
    rng = np.random.default_rng(seed)
    w, taps, cin = {}, [], 3
    for layer in lpips_torch._VGG_LAYERS:
        if layer == "pool":
            continue
        name, cout = layer
        w[name + "_w"] = rng.normal(
            0, 1.0 / np.sqrt(9 * cin), (3, 3, cin, cout)).astype(np.float32)
        w[name + "_b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        if name in lpips_torch._TAPS:
            taps.append(cout)
        cin = cout
    for i, c in enumerate(taps):
        w[f"lin{i}_w"] = np.abs(rng.normal(0, 1.0 / c, (1, 1, c, 1))
                                ).astype(np.float32)
    return w


def synced(device):
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    return sync


@contextlib.contextmanager
def timed_calls(module, names, seconds, sync):
    """Add each call's wall seconds (synchronised after the call) to
    seconds[name] while module.<name> is wrapped; restored after."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, f):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = f(*a, **k)
            sync()
            seconds[n] = seconds.get(n, 0.0) + time.perf_counter() - t0
            return out
        return call
    for n, f in saved.items():
        setattr(module, n, wrap(n, f))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


@contextlib.contextmanager
def recorded_overflow(rast, out):
    """Keep the overflow counter of every rasterize call while the eval
    entry points run (they call rast.rasterize); restored after."""
    orig = rast.rasterize

    def call(*a, **k):
        res = orig(*a, **k)
        out.append(res["binned"].overflow)
        return res
    rast.rasterize = call
    try:
        yield
    finally:
        rast.rasterize = orig


def max_overflow(out):
    import torch
    return int(torch.stack([o.reshape(()) for o in out]).max()) if out else 0


def run_quality(root, scene, sc, cfg, kernels, device):
    """Phase quality: quality_eval(make_ps1_render(teacher, cfg.raster))
    over the 16 views of the scene_io scene, the teacher being the proxy
    state write_scene rendered the PNGs from (loops.render_state, the same
    exact route: kernel 4's f32 rows, the exact sort, kernel 5), every
    counter set to 0 just before and read just after. Returns the
    teacher's render and the ground truth of the first view."""
    import json
    import os
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.eval import metrics, quality
    from fovsplat_torch.models import state as S
    from fovsplat_torch.ops import rasterize as rast
    sync = synced(device)
    t0 = time.perf_counter()
    teacher = S.from_params(convert.params_from_numpy(
        **proxy.train_arrays(sc), device=device))
    views = sorted(scene.train_views + scene.test_views,
                   key=lambda v: v.image_name)
    render = quality.make_ps1_render(teacher, cfg.raster, cfg.sh_degree)
    img0 = render(views[0].camera)
    gt0 = torch.as_tensor(views[0].image, device=img0.device)
    metrics.hvs_uniform(img0, gt0)
    sync()
    setup_s = time.perf_counter() - t0
    seconds, overflow = {"render": 0.0}, []

    def timed_render(camera):
        t = time.perf_counter()
        img = render(camera)
        sync()
        seconds["render"] += time.perf_counter() - t
        return img
    out_dir = os.path.join(root, "quality")
    for kf in kernels.values():
        kf.launches = 0
    t0 = time.perf_counter()
    with timed_calls(metrics, ("ssim", "psnr", "lpips", "hvs_uniform"),
                     seconds, sync), recorded_overflow(rast, overflow):
        mean = quality.quality_eval(timed_render, views, out_dir, "scene")
    total = time.perf_counter() - t0
    launches = {k: kf.launches for k, kf in kernels.items()}
    # Each render rounded to 8 bits as write_scene rounded it, against the
    # PNG the loader read: only the rounding may separate them.
    differing = 0
    for v in views:
        img = render(v.camera)
        u8 = torch.round(torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)
        png = torch.round(torch.as_tensor(v.image, device=img.device)
                          * 255).to(torch.uint8)
        differing += int((u8 != png).any(-1).sum())
    full = json.load(open(os.path.join(out_dir, "scene_quality.json")))
    per = json.load(open(os.path.join(out_dir, "scene_quality_per.json")))
    names = [v.image_name for v in views]
    keys_ok = (list(full) == ["ps1"]
               and sorted(full["ps1"]) == ["HVS", "LPIPS", "PSNR", "SSIM"]
               and list(per) == ["ps1"]
               and sorted(per["ps1"]) == ["Per HVS", "Per LPIPS",
                                          "Per PSNR", "Per SSIM"]
               and all(list(d) == names for d in per["ps1"].values()))
    psnrs = list(per["ps1"]["Per PSNR"].values())
    row = {"phase": "quality", "n": N_FULL, "width": W_FULL,
           "height": H_FULL, "views": len(views),
           "raster": {"pair_capacity": cfg.raster.pair_capacity,
                      "compact_capacity": cfg.raster.compact_capacity},
           "mean": mean, "psnr_min_max": [min(psnrs), max(psnrs)],
           "pixels_differing_after_rounding": differing,
           "json_keys_ok": keys_ok, "overflow": max_overflow(overflow),
           "rasterize_calls": len(overflow),
           "seconds_per_view": {k: v / len(views) for k, v in
                                seconds.items()},
           "seconds": {"setup": setup_s, "quality_eval": total},
           "launches": launches,
           "gates": {"psnr_min": QUALITY_PSNR_MIN,
                     "ssim_min": QUALITY_SSIM_MIN}}
    emit(row)
    if not (mean["psnr"] >= QUALITY_PSNR_MIN
            and mean["ssim"] >= QUALITY_SSIM_MIN and mean["lpips"] is None
            and differing == 0 and keys_ok and row["overflow"] == 0
            and len(overflow) == len(views)):
        raise AssertionError("the quality phase failed a check")
    if not (launches["expand_ps1"] == launches["blend_forward"] == len(views)
            and launches["blend_backward"] == 0):
        raise AssertionError(f"quality: kernels 4 and 5 must launch once a "
                             f"view, kernel 6 never: {launches}")
    return img0, gt0, launches


def run_lpips(img, gt):
    """Phase lpips: LPIPS-vgg on synthetic weights (written under build/)
    at full width, timed, two calls bit-identical, with TF32 allowed
    globally for the phase (the module's local flag must keep it off);
    then the card against the CPU at 160x112."""
    import os
    import numpy as np
    import torch
    from fovsplat_torch.eval import lpips_torch
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        LPIPS_SYNTHETIC)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **synthetic_vgg_weights())
    net = lpips_torch.LPIPS(path)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        first, second = net(img, gt), net(img, gt)
        bit = bool(torch.equal(first, second))
        t0 = time.perf_counter()
        vals = [float(net(img, gt)) for _ in range(3)]
        full_s = (time.perf_counter() - t0) / 3
        rng = np.random.default_rng(8)
        a = rng.uniform(0, 1, (112, 160, 3)).astype(np.float32)
        b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(
            np.float32)
        card = float(net(torch.from_numpy(a).to(img.device),
                         torch.from_numpy(b).to(img.device)))
        cpu = float(net(torch.from_numpy(a), torch.from_numpy(b)))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    rel = abs(card - cpu) / abs(cpu)
    row = {"phase": "lpips", "weights": "synthetic, seed 7",
           "full": {"shape": [H_FULL, W_FULL], "value": vals[0],
                    "seconds_per_call": full_s, "bit_identical_twice": bit,
                    "repeat_equal": len(set(vals)) == 1},
           "vs_cpu": {"shape": [112, 160], "card": card, "cpu": cpu,
                      "rel_err": rel},
           "global_tf32_during_phase": True, "tol": EVAL_RTOL}
    emit(row)
    if not (bit and len(set(vals)) == 1 and math.isfinite(vals[0])
            and rel <= EVAL_RTOL):
        raise AssertionError("the LPIPS phase failed a check")


def run_hvs_fov(img, gt):
    """Phase hvs_fov: the foveated HVS metric (metameric_loss_fov after
    resize_for_pyramid) and blur_loss at full width at gazes (0.5, 0.5)
    and (0.2, 0.8), timed (wall seconds; each call returns a float or is
    synchronised); then the card against the CPU at 320x224, and
    gen_metamer with one injected noise draw on both."""
    import numpy as np
    import torch
    from fovsplat_torch.eval import metrics
    from fovsplat_torch.perception import foveated_loss as fl
    from fovsplat_torch.perception import metameric
    dev = img.device
    full = []
    for gaze in ((0.5, 0.5), (0.2, 0.8)):
        vals, secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            vals.append(metrics.hvs_fov(img, gt, gaze=gaze))
            secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with torch.no_grad():
            bl = float(metameric.blur_loss(img, gt, gaze=gaze))
        full.append({"gaze": gaze, "hvs_fov": vals[0],
                     "repeat_equal": vals[0] == vals[1],
                     "hvs_fov_seconds_first_second": secs,
                     "blur_loss": bl,
                     "blur_loss_seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (224, 320, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    small = []
    for gaze in ((0.5, 0.5), (0.2, 0.8)):
        pair = []
        for d in (dev, torch.device("cpu")):
            x, y = torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)
            with torch.no_grad():
                pair.append((float(fl.metameric_loss_fov(x, y, gaze=gaze)),
                             float(metameric.blur_loss(x, y, gaze=gaze))))
        small.append({"gaze": gaze, "fov_loss": [pair[0][0], pair[1][0]],
                      "fov_rel_err": abs(pair[0][0] - pair[1][0])
                      / abs(pair[1][0]),
                      "blur_loss": [pair[0][1], pair[1][1]],
                      "blur_rel_err": abs(pair[0][1] - pair[1][1])
                      / abs(pair[1][1])})
    noise = torch.rand((1, 224, 320, 3),
                       generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        mc = metameric.gen_metamer(torch.from_numpy(a).to(dev), 2.0,
                                   noise=noise.to(dev)).cpu()
        mp = metameric.gen_metamer(torch.from_numpy(a), 2.0, noise=noise)
    met_err = float((mc - mp).abs().max())
    met_range = float(mp.max() - mp.min())
    row = {"phase": "hvs_fov", "full": full,
           "vs_cpu": {"shape": [224, 320], "losses": small,
                      "gen_metamer_max_abs_err": met_err,
                      "gen_metamer_range": met_range},
           "tol": EVAL_RTOL}
    emit(row)
    ok = (all(r["repeat_equal"] and math.isfinite(r["hvs_fov"])
              and math.isfinite(r["blur_loss"]) for r in full)
          and all(r["fov_rel_err"] <= EVAL_RTOL
                  and r["blur_rel_err"] <= EVAL_RTOL for r in small)
          and met_err <= EVAL_RTOL * met_range)
    if not ok:
        raise AssertionError("the foveated HVS phase failed a check")


def small_composed(n, device):
    """The n-Gaussian proxy of seed 1 as a 4-level composed model (its
    level-0 DC and opacity in the params, every level in the composed
    arrays, every row live)."""
    import numpy as np
    import torch
    from fovsplat_torch import convert
    from fovsplat_torch.data import proxy
    from fovsplat_torch.train import compose
    sc = proxy.bicycle_proxy(n=n, seed=1)
    op0 = sc["opacities4"][:, :1]
    params = convert.params_from_numpy(
        xyz=sc["means"], features_dc=sc["shs_dcs"][:, :1, :],
        features_rest=sc["shs_rest"], scaling=np.log(sc["scales"]),
        rotation=sc["rotations"], opacity=np.log(op0 / (1 - op0)),
        device=device)

    def t(x):
        return torch.as_tensor(x, device=device)
    return compose.ComposedModel(
        params=params, live=t(np.ones(n, bool)),
        highest_levels=t(sc["highest_levels"]), shs_dcs=t(sc["shs_dcs"]),
        opacities=t(sc["opacities4"]))


def run_layers(root, model, views, cfg, kernels, device):
    """Phase layers: eval_layers with layer_render_ours on the chain
    phase's composed model (4 levels of the full-width proxy), ladder [1,
    3, 7, 12], the scene's 2 test views, counters set to 0 just before and
    read just after; then one layer's eval on the card against the CPU on
    the 20k proxy at 320x224."""
    import os
    import numpy as np
    import torch
    from fovsplat_torch.data import proxy
    from fovsplat_torch.eval import layers
    from fovsplat_torch.ops import rasterize as rast
    out_dir = os.path.join(root, "layers_eval")
    overflow = []
    for kf in kernels.values():
        kf.launches = 0
    t0 = time.perf_counter()
    with recorded_overflow(rast, overflow):
        res = layers.eval_layers(
            lambda i: layers.layer_render_ours(model.params, model.live,
                                               model, i, cfg.raster),
            views, LADDER, out_dir, "scene")
    seconds = time.perf_counter() - t0
    launches = {k: kf.launches for k, kf in kernels.items()}
    files = [f"scene_{ps}.json" for ps in LADDER]
    missing = [f for f in files
               if not os.path.exists(os.path.join(out_dir, f))]
    finite = all(math.isfinite(r[k]) for r in res.values()
                 for k in ("hvs", "psnr", "ssim"))
    gt = np.random.default_rng(10).uniform(0, 1, (224, 320, 3)).astype(
        np.float32)
    pair = []
    for d in (device, "cpu"):
        small = small_composed(20_000, d)
        view = View(proxy.proxy_camera(320, 224, device=d), gt)
        r = layers.eval_layers(
            lambda i: layers.layer_render_ours(
                small.params, small.live, small, 2,
                dataclasses.replace(cfg.raster, pair_capacity=1 << 20,
                                    compact_capacity=None)),
            [view], [7], os.path.join(root, f"layers_vs_cpu_{d}"), "proxy")
        pair.append(r[7])
    rel = {k: abs(pair[0][k] - pair[1][k]) / abs(pair[1][k])
           for k in ("hvs", "psnr", "ssim")}
    row = {"phase": "layers", "model": "the chain phase's composed model",
           "live_per_level": [int((model.live & (model.highest_levels >= i)
                                   ).sum()) for i in range(len(LADDER))],
           "ladder": LADDER, "views": [v.image_name for v in views],
           "results": {str(k): v for k, v in res.items()},
           "files_missing": missing, "finite": finite,
           "overflow": max_overflow(overflow),
           "rasterize_calls": len(overflow), "seconds": seconds,
           "launches": launches,
           "vs_cpu": {"shape": "N=20000, 320x224, layer 2 at ps 7",
                      "card": pair[0], "cpu": pair[1], "rel_err": rel},
           "tol": EVAL_RTOL}
    emit(row)
    calls = len(LADDER) * len(views)
    if (missing or not finite or row["overflow"] != 0
            or len(overflow) != calls
            or max(rel.values()) > EVAL_RTOL):
        raise AssertionError("the layers phase failed a check")
    if not (launches["expand_ps1"] == launches["blend_forward"] == calls
            and launches["blend_backward"] == 0):
        raise AssertionError(f"layers: kernels 4 and 5 must launch once a "
                             f"layer and view: {launches}")
    return launches


def run_fov_unpacked(sc, soa_model, kernels, device):
    """Phase fov_unpacked: rasterize_fov on the unpacked f32 full-width
    proxy at the centre gaze with the frame's capacities, counters set to
    0 just before the first call and read just after (kernels 2 and 3
    launched, kernel 1 not), overflow 0, two calls bit-identical, against
    rasterize_fov_soa on the packed (bf16) model of the same proxy (> 40
    dB), timed; then the card against the CPU at 160x112."""
    import torch
    from fovsplat_torch.data import proxy
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    keys = ("means", "scales", "rotations", "opacities4", "shs_dcs",
            "shs_rest", "highest_levels")

    def arrays(s, d):
        return [torch.as_tensor(s[k], device=d) for k in keys]
    args = arrays(sc, device)
    cam = proxy.proxy_camera(W_FULL, H_FULL, device=device)
    cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                          compact_capacity=COMPACT_CAPACITY)
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=device)
    for kf in kernels.values():
        kf.launches = 0
    first = fov.rasterize_fov(*args, cam, gaze, ALPHA, config=cfg)
    launches = {k: kf.launches for k, kf in kernels.items()}
    second = fov.rasterize_fov(*args, cam, gaze, ALPHA, config=cfg)
    bit = bool(torch.equal(first["render"], second["render"]))
    soa = fov.rasterize_fov_soa(soa_model, cam, gaze, ALPHA, config=cfg)
    mse = float(((first["render"] - soa["render"]) ** 2).mean())
    psnr = -10.0 * math.log10(mse) if mse > 0 else float("inf")
    ms = cuda_ms(lambda: fov.rasterize_fov(*args, cam, gaze, ALPHA,
                                           config=cfg), 10)
    soa_ms = cuda_ms(lambda: fov.rasterize_fov_soa(soa_model, cam, gaze,
                                                   ALPHA, config=cfg), 10)
    small = proxy.bicycle_proxy(n=20_000, seed=1)
    outs = []
    for d in (device, "cpu"):
        o = fov.rasterize_fov(
            *arrays(small, d), proxy.proxy_camera(160, 112, device=d),
            torch.tensor((0.3, 0.6), device=d), ALPHA, bg_color=[0.1, 0.2,
                                                                 0.3],
            config=RasterizeConfig(pair_capacity=1 << 20,
                                   sort_exact_depth=True))
        outs.append((o["render"].cpu(), int(o["num_pairs"])))
    err = float((outs[0][0] - outs[1][0]).abs().max())
    img = first["render"]
    row = {"phase": "fov_unpacked", "n": N_FULL, "width": W_FULL,
           "height": H_FULL, "gaze": [0.5, 0.5],
           "num_pairs": int(first["num_pairs"]),
           "candidates": int(first["candidates"]),
           "overflow": int(first["overflow"]),
           "finite": bool(torch.isfinite(img).all()),
           "bit_identical_twice": bit,
           "psnr_vs_soa_db": psnr, "soa_num_pairs": int(soa["num_pairs"]),
           "ms": ms, "soa_ms": soa_ms, "launches": launches,
           "vs_cpu": {"shape": "N=20000, 160x112, gaze (0.3, 0.6)",
                      "num_pairs": [outs[0][1], outs[1][1]],
                      "max_abs_err": err},
           "tol": {"vs_cpu": UNPACKED_ATOL,
                   "psnr_vs_soa_min": UNPACKED_PSNR_MIN}}
    emit(row)
    if not (row["overflow"] == 0 and row["finite"] and bit
            and psnr > UNPACKED_PSNR_MIN and outs[0][1] == outs[1][1]
            and err <= UNPACKED_ATOL):
        raise AssertionError("the unpacked foveated render failed a check")
    if not (launches["expand_fov"] == launches["blend_fov"] == 1
            and launches["build_table"] == 0):
        raise AssertionError(f"fov_unpacked: kernels 2 and 3 must launch "
                             f"once and kernel 1 never: {launches}")
    return launches


def run_cli_eval(scene_root, model_dir):
    """Phase cli_eval: `python -m fovsplat_torch.cli` render, eval,
    eval-layers and video --frames 8 on the pipeline phase's output and the
    scene_io scene, the four processes started together (each stopped if
    it outlives its time limit). Each must exit 0 and leave its files."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    cmds = {"render": [], "eval": [], "eval-layers": [],
            "video": ["--frames", str(CLI_FRAMES)]}
    procs, seconds, rcs, tails = {}, {}, {}, {}
    t0 = time.perf_counter()
    for cmd, extra in cmds.items():
        procs[cmd] = subprocess.Popen(
            [sys.executable, "-m", "fovsplat_torch.cli", cmd, "-s",
             scene_root, "-m", model_dir, *extra], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for cmd, p in procs.items():
            out, _ = p.communicate(timeout=300)
            rcs[cmd] = p.returncode
            seconds[cmd] = time.perf_counter() - t0
            tails[cmd] = out.strip().splitlines()[-1:] if out else []
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    want = ([os.path.join("renders", f"{n}.png")
             for n in ("view_000", "view_008")]
            + ["scene_quality.json", "scene_quality_per.json"]
            + [os.path.join("layers_eval", f"scene_{ps}.json")
               for ps in LADDER]
            + [os.path.join("video", f"frame_{i:04d}.png")
               for i in range(CLI_FRAMES)])
    missing = [f for f in want
               if not os.path.exists(os.path.join(model_dir, f))]
    row = {"phase": "cli_eval", "commands": list(cmds), "rc": rcs,
           "seconds_to_exit": seconds,
           "wall_seconds": time.perf_counter() - t0,
           "files_missing": missing, "last_lines": tails}
    emit(row)
    if missing or any(rc != 0 for rc in rcs.values()):
        raise AssertionError("an eval subcommand failed")


VQ_CODEBOOK = 8192               # LightGaussian VecTree's defaults
VQ_RATIO = 0.6
VQ_ITERS = 10
VQ_CHECK_ROWS = 20_000           # card vs CPU check shape
VQ_CHECK_CODEBOOK = 256
VQ_RTOL = 1e-5                   # codebook card vs CPU; id near-tie bar
DISTILL_DEGREE = 1
DISTILL_ITERS = 20               # of LightGaussian's 2,000 (cut)
MM_FINETUNE_ITERS = 3            # a level, of multimodel's 1,000 (cut)
XLA_ATOL = 1e-4                  # routes' images: T_EPS
XLA_GRAD_RTOL = BWD_RTOL         # routes' gradients, of each field's max:
                                 # kernel 6's bar against its twin (xyz
                                 # reads 3.3e-5, kernel 7's chunked sums
                                 # through the projection's chain rule)
DENSE_SHAPE = (2_000, 160, 112)  # render_dense check (O(N H W))
DENSE_T_ATOL, DENSE_ATOL = 2e-5, 2e-4   # tests/test_rasterize_parity.py


def vq_id_check(ids, ref_ids, rows, codebook, rtol=VQ_RTOL):
    """ids against ref_ids on the same rows and the reference codebook
    (float64 distances). The |a|^2 - 2 a.b + |b|^2 formula rounds at rtol
    of |a|^2 + |b|^2: on rows whose two nearest codewords are further
    apart than that the ids must be equal; elsewhere (near ties) the
    chosen codeword must be as near within it. Returns (rows without a
    near tie, mismatches there, near-tie rows whose pick is worse)."""
    import numpy as np
    r = rows.astype(np.float64)
    c = codebook.astype(np.float64)
    d2 = ((r * r).sum(1)[:, None] - 2.0 * r @ c.T + (c * c).sum(1)[None])
    order = np.argsort(d2, 1)[:, :2]
    two = np.take_along_axis(d2, order, 1)
    tol = rtol * ((r * r).sum(1) + (c[order[:, 0]] ** 2).sum(1))
    clear = (two[:, 1] - two[:, 0]) > tol
    i = np.arange(len(ids))
    worse = d2[i, ids] - d2[i, ref_ids] > tol
    return (int(clear.sum()), int((ids != ref_ids)[clear].sum()),
            int(worse.sum()))


def run_vq(st, scene, cfg, kernels, device):
    """Phase vq: importance from global_significance_scores on the scene's
    14 train views, then compress of the 1.16M teacher (codebook 8,192,
    ratio 0.6, 10 iterations) twice with TF32 allowed globally (only
    vq's local flag keeps it off): bit-identical; the round-trip bounds
    of tests/test_models_data.py's test_vq_compress_roundtrip (xyz's fp16
    bound relative to the larger of |x| and 1, the proxy's positions
    reaching past 1); a PS1 render of the decompressed model against the
    teacher's; then the card against the CPU at 20,000 rows and codebook
    256 with the same injected draws. Returns the launch counts."""
    import numpy as np
    import torch
    from fovsplat_torch.models import state as S
    from fovsplat_torch.models import vq
    from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
    from fovsplat_torch.train import loops, scratch
    sync = synced(device)
    p = st.params
    for kf in kernels.values():
        kf.launches = 0
    t0 = time.perf_counter()
    _, imp = scratch.global_significance_scores(st, scene.train_views, cfg)
    imp = imp.cpu().numpy()
    score_s = time.perf_counter() - t0
    launches = {k: kf.launches for k, kf in kernels.items()}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        comp = vq.compress(p, imp, VQ_RATIO, VQ_CODEBOOK, VQ_ITERS)
        sync()
        compress_s = time.perf_counter() - t0
        again = vq.compress(p, imp, VQ_RATIO, VQ_CODEBOOK, VQ_ITERS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    bit = sorted(comp) == sorted(again) and all(
        np.array_equal(comp[k], again[k]) for k in comp)
    n = p.num_points
    raw_bytes = sum(getattr(p, f).numel() * 4 for f in FIELDS)
    size = vq.compressed_size_bytes(comp)
    t0 = time.perf_counter()
    dec = vq.decompress(comp, device)
    sync()
    decompress_s = time.perf_counter() - t0
    keep = torch.as_tensor(np.unpackbits(comp["keep_mask_packed"])[:n]
                           .astype(bool), device=device)
    cam = scene.train_views[0].camera
    with torch.no_grad():
        dc_err = float((dec.features_dc - p.features_dc)[keep].abs().max())
        rest_err = float((dec.features_rest - p.features_rest).abs().mean())
        xyz_rel = float(((dec.xyz - p.xyz).abs()
                         / p.xyz.abs().clamp(min=1.0)).max())
        ref = loops.render_state(st, cam, cfg)
        got = loops.render_state(S.from_params(dec), cam, cfg)
    mse = float(((got["render"] - ref["render"]) ** 2).mean())
    overflow = int(got["binned"].overflow)

    # The card against the CPU at the check shape, same draws.
    rows_n, k = VQ_CHECK_ROWS, VQ_CHECK_CODEBOOK
    n_vq = rows_n - int(rows_n * (1 - VQ_RATIO))
    init, starts = vq.draws(n_vq, k, VQ_ITERS, 80_000,
                            torch.Generator().manual_seed(1))
    small = {d: GaussianParams(**{f: getattr(p, f)[:rows_n].detach().to(d)
                                  for f in FIELDS})
             for d in (device, "cpu")}
    comps = {d: vq.compress(m, imp[:rows_n], VQ_RATIO, k, VQ_ITERS, init,
                            starts) for d, m in small.items()}
    kept = np.unpackbits(comps["cpu"]["keep_mask_packed"])[:rows_n].astype(
        bool)
    m = small["cpu"]
    feats = torch.cat([m.features_dc.reshape(rows_n, -1),
                       m.features_rest.reshape(rows_n, -1)],
                      1).detach().numpy()[~kept]
    books = {d: vq.ema_kmeans(torch.as_tensor(feats, device=d), k,
                              VQ_ITERS, init_idx=init,
                              starts=starts).cpu().numpy()
             for d in (device, "cpu")}
    book_rel = float(np.abs(books[device] - books["cpu"]).max()
                     / np.abs(books["cpu"]).max())

    def ids(c):
        b = int(c["bits"])
        raw = np.unpackbits(c["vq_indices_packed"])[:int(c["num_vq"]) * b]
        return raw.reshape(-1, b) @ (1 << np.arange(b - 1, -1, -1))
    same_book = {d: vq._assign(torch.as_tensor(feats, device=d),
                               torch.as_tensor(books["cpu"], device=d))
                 .cpu().numpy() for d in (device, "cpu")}
    same_assign = bool(np.array_equal(same_book[device], same_book["cpu"]))
    clear, mismatched, worse = vq_id_check(ids(comps[device]),
                                           ids(comps["cpu"]), feats,
                                           books["cpu"])
    same_keep = np.array_equal(comps[device]["keep_mask_packed"],
                               comps["cpu"]["keep_mask_packed"])
    row = {"phase": "vq", "n": n, "width": cam.width, "height": cam.height,
           "views": len(scene.train_views), "codebook": VQ_CODEBOOK,
           "vq_ratio": VQ_RATIO, "iters": VQ_ITERS,
           "num_vq": int(comp["num_vq"]), "raw_bytes": raw_bytes,
           "compressed_bytes": size, "ratio": raw_bytes / size,
           "bytes_per_row": size / n,
           "seconds": {"scores": score_s, "compress": compress_s,
                       "decompress": decompress_s},
           "bit_identical_twice": bit,
           "round_trip": {"kept_dc_max_err": dc_err,
                          "rest_mean_abs_err": rest_err,
                          "xyz_rel_err": xyz_rel},
           "render_vs_original": {
               "psnr_db": -10.0 * math.log10(mse) if mse > 0
               else float("inf"), "overflow": overflow},
           "vs_cpu": {"rows": rows_n, "codebook": k, "num_vq": n_vq,
                      "codebook_rel_err": book_rel,
                      "keep_mask_equal": same_keep,
                      "ids_equal_on_one_codebook": same_assign,
                      "ids_equal": bool(np.array_equal(
                          ids(comps[device]), ids(comps["cpu"]))),
                      "rows_without_near_tie": clear,
                      "ids_differing_there": mismatched,
                      "near_tie_rows_picking_worse": worse},
           "launches": launches,
           "tol": {"kept_dc": 2e-3, "rest_mean": 0.12, "xyz_rel": 2e-3,
                   "size_of_raw": 0.55, "codebook_rtol": VQ_RTOL}}
    emit(row)
    if not (bit and dc_err <= 2e-3 and rest_err < 0.12 and xyz_rel <= 2e-3
            and size < 0.55 * raw_bytes and overflow == 0
            and book_rel <= VQ_RTOL and same_keep and same_assign
            and mismatched == 0 and worse == 0):
        raise AssertionError("the vq phase failed a check")
    if not (launches["expand_ps1"] == launches["blend_stats"]
            == len(scene.train_views)):
        raise AssertionError(f"vq: kernels 4 and 8 must launch once a "
                             f"view: {launches}")
    return launches


def run_distill(st, scene, cfg, kernels, device):
    """Phase distill: the quality phase's teacher (the 1.16M proxy, SH
    degree 3) distilled to degree 1 for DISTILL_ITERS iterations on the
    scene's 14 train views, counters set to 0 before and read after
    (kernels 4 and 5 twice an iteration, 6 and 7 once), twice from the
    same seed: the students bit-identical; the loss against the teacher's
    render of view 0 before and after, ms an iteration."""
    import torch
    from fovsplat_torch.models.gaussians import FIELDS
    from fovsplat_torch.train import distill, loops, losses
    sync = synced(device)
    views = scene.train_views
    for kf in kernels.values():
        kf.launches = 0
    t0 = time.perf_counter()
    s1 = distill.distill(st, views, DISTILL_DEGREE, cfg, DISTILL_ITERS,
                         log=lambda *_: None)
    sync()
    secs = time.perf_counter() - t0
    launches = {k: kf.launches for k, kf in kernels.items()}
    s2 = distill.distill(st, views, DISTILL_DEGREE, cfg, DISTILL_ITERS,
                         log=lambda *_: None)
    bit = all(torch.equal(getattr(s1.params, f), getattr(s2.params, f))
              and torch.equal(s1.opt.mu[f], s2.opt.mu[f])
              and torch.equal(s1.opt.nu[f], s2.opt.nu[f]) for f in FIELDS)
    s_cfg = dataclasses.replace(cfg, sh_degree=DISTILL_DEGREE)
    cam = views[0].camera
    with torch.no_grad():
        pseudo = loops.render_state(st, cam, cfg)["render"]
        before = float(losses.photometric_loss(loops.render_state(
            dataclasses.replace(st, params=distill.truncate_sh(
                st.params, DISTILL_DEGREE)), cam, s_cfg)["render"], pseudo))
        after = float(losses.photometric_loss(
            loops.render_state(s1, cam, s_cfg)["render"], pseudo))
    row = {"phase": "distill", "n": st.capacity, "width": cam.width,
           "height": cam.height, "views": len(views),
           "degrees": [cfg.sh_degree, DISTILL_DEGREE],
           "iters": DISTILL_ITERS,
           "features_rest": list(s1.params.features_rest.shape),
           "loss_view0": {"truncated": before, "distilled": after},
           "seconds": secs, "ms_per_iter": 1000.0 * secs / DISTILL_ITERS,
           "bit_identical_twice": bit, "launches": launches}
    emit(row)
    it = DISTILL_ITERS
    if not (bit and math.isfinite(after)
            and row["features_rest"] == [st.capacity, 3, 3]):
        raise AssertionError("the distill phase failed a check")
    if not (launches["expand_ps1"] == launches["blend_forward"] == 2 * it
            and launches["blend_backward"]
            == launches["reduce_by_sorted_gid"] == it):
        raise AssertionError(f"distill: kernels 4, 5 twice and 6, 7 once "
                             f"an iteration: {launches}")
    return launches


def run_mm_models(chain, cfg, kernels, device):
    """Phase mm_models: generate_mm_models from the chain phase's PS1
    state with its live ladder as layer_counts (each level a v-importance
    prune over the chain's 4 train views and MM_FINETUNE_ITERS finetune
    iterations), counters set to 0 before and read after; every step
    finite with overflow 0, each level's live count within 1% of its
    target. Then a 9-gaze MM-FR frame of mm_render_models on the chain's
    first camera (1 warm-up, 5 timed reps a gaze), overflow 0, launches
    of 4q and 5q. Returns (generation launches, frame launches by row)."""
    import torch
    from fovsplat_torch.eval import fps
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops, multimodel
    sync = synced(device)
    ps1, views, targets = chain["ps1"], chain["train_views"], chain["counts"]
    for kf in kernels.values():
        kf.launches = 0
    auxs, logs = [], []
    t0 = time.perf_counter()
    with recorded_steps(loops, auxs):
        models = multimodel.generate_mm_models(
            ps1, views, targets, cfg, finetune_iters=MM_FINETUNE_ITERS,
            log=logs.append)
    sync()
    gen_s = time.perf_counter() - t0
    gen_l = {k: kf.launches for k, kf in kernels.items()}
    live = [int(m.live_count()) for m in models]
    bad = [i for i, a in enumerate(auxs)
           if not (int(a["overflow"]) == 0 and int(a["nonfinite"]) == 0
                   and math.isfinite(float(a["loss"])))]
    cam = views[0].camera
    dicts = multimodel.mm_render_models(models, cam)
    render = fps.make_mmfr_render(
        dicts, RasterizeConfig(pair_capacity=CHAIN_PAIR_CAPACITY,
                               compact_capacity=CHAIN_COMPACT_CAPACITY),
        alpha=ALPHA)
    for kf in kernels.values():
        kf.launches = 0
    res = fps.fps_benchmark(render, [cam], warmups=1, reps=5,
                            log=lambda *_: None)
    frame_l = {k: kf.launches for k, kf in kernels.items()}
    rows = gaze_rows(render, cam, lambda o: {
        "pass_overflow": [int(d["overflow"]) for d in o["passes"]]})
    for r, ms in zip(rows, res["per_gaze_ms"]):
        r["ms"] = ms
    row = {"phase": "mm_models", "width": cam.width, "height": cam.height,
           "views": len(views), "finetune_iters": MM_FINETUNE_ITERS,
           "live": live, "targets": targets, "seconds": gen_s,
           "steps": len(auxs), "bad_steps": bad,
           "frame": {"per_gaze": rows, "avg_ms": res["avg_ms"],
                     "warmups": 1, "reps": 5},
           "launches": gen_l, "frame_launches": frame_l}
    emit(row)
    close = all(abs(a - b) <= 0.01 * b for a, b in zip(live, targets))
    if bad or live[0] != targets[0] or not close or len(live) != 4 or \
            len(auxs) != 3 * MM_FINETUNE_ITERS:
        raise AssertionError("the mm_models phase failed a check")
    if not (gen_l["blend_stats"] > 0 and gen_l["blend_backward"] > 0
            and frame_l["expand_ps1"] > 0 and frame_l["blend_forward_q"] > 0):
        raise AssertionError(f"mm_models: kernels 4-8 on the generation, 4q "
                             f"and 5q on the frame: {gen_l} {frame_l}")
    return gen_l, {"expand_ps1_q": frame_l["expand_ps1"],
                   "blend_forward_q_mmfr": frame_l["blend_forward_q"]}


def run_cli_vq(scene_root, model_dir):
    """Phase cli_vq: `python -m fovsplat_torch.cli vq` on the pipeline
    phase's output; it must exit 0, write vq_compressed.npz and print its
    JSON (printed here on a line of its own)."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "fovsplat_torch.cli", "vq",
                        "-s", scene_root, "-m", model_dir], cwd=here,
                       capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    print(lines[-1] if lines else "", flush=True)
    emit({"phase": "cli_vq", "rc": p.returncode, "seconds": secs,
          "json": out, "stderr_tail": p.stderr.strip().splitlines()[-3:]})
    if out is None or not os.path.exists(
            os.path.join(model_dir, "vq_compressed.npz")):
        raise AssertionError("the vq subcommand failed")


def run_xla_route(st, cam, gt, cfg, sc, kernels, device):
    """Phase xla_route: the port's two routes against each other at full
    width. The XLA route (config.backend "xla": plain PyTorch) must
    launch no kernel: every counter is set to 0 before its calls and read
    after. PS1 train-step render and gradients (loops.photometric_grads
    on the train phase's state): kept pairs equal, images within 1e-4,
    each field's gradient within 1e-4 of its largest magnitude, the XLA
    route's gradients bit-identical twice; the "ours" frame at the centre
    gaze through rasterize_fov (exact depth sort), within 1e-4; the three
    score views through stats.blend_stats against kernel 8's, within
    1e-5 relative; render_dense against the XLA route at DENSE_SHAPE
    within tests/test_rasterize_parity.py's bars."""
    import torch
    from fovsplat_torch.data import proxy
    from fovsplat_torch.models.gaussians import FIELDS
    from fovsplat_torch.ops import dense
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import loops
    sync = synced(device)
    xcfg = dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, backend="xla"))
    keys = ("means", "scales", "rotations", "opacities4", "shs_dcs",
            "shs_rest", "highest_levels")
    fargs = [torch.as_tensor(sc[k], device=device) for k in keys]
    fcam = proxy.proxy_camera(W_FULL, H_FULL, device=device)
    gaze = torch.tensor((0.5, 0.5), dtype=torch.float32, device=device)
    fcfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                           compact_capacity=COMPACT_CAPACITY,
                           sort_exact_depth=True)
    fxcfg = dataclasses.replace(fcfg, backend="xla")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1000.0 * (time.perf_counter() - t0)
    kern, kern_ms = timed(lambda: loops.photometric_grads(st, cam, gt, cfg))
    kframe, kframe_ms = timed(lambda: fov.rasterize_fov(
        *fargs, fcam, gaze, ALPHA, config=fcfg))
    kscores = {m: loops.make_score_fn(cfg, m)(st, cam) for m in METRICS}
    for kf in kernels.values():
        kf.launches = 0
    xa, xla_ms = timed(lambda: loops.photometric_grads(st, cam, gt, xcfg))
    xb = loops.photometric_grads(st, cam, gt, xcfg)
    xframe, xframe_ms = timed(lambda: fov.rasterize_fov(
        *fargs, fcam, gaze, ALPHA, config=fxcfg))
    xscores, score_ms = {}, {}
    for m in METRICS:
        xscores[m], score_ms[m] = timed(
            lambda m=m: loops.make_score_fn(xcfg, m)(st, cam))
    n_d, w_d, h_d = DENSE_SHAPE
    small = proxy.bicycle_proxy(n=n_d, seed=2)
    dcam = proxy.proxy_camera(w_d, h_d, device=device)
    dargs = [torch.as_tensor(small[k], device=device)
             for k in ("means", "scales", "rotations")]
    dop = torch.as_tensor(small["opacities4"][:, 0], device=device)
    dcol = torch.clamp(0.28209479177387814 * torch.as_tensor(
        small["shs_dcs"][:, 0], device=device) + 0.5, min=0.0)
    with torch.no_grad():
        od, dense_ms = timed(lambda: dense.render_dense(
            *dargs, dop, dcol, dcam, bg_color=[0.1, 0.2, 0.3]))
        ox = rast.rasterize(*dargs, dop, dcam, colors=dcol,
                            bg_color=[0.1, 0.2, 0.3],
                            config=RasterizeConfig(pair_capacity=1 << 20,
                                                   backend="xla"))
    launches = {k: kf.launches for k, kf in kernels.items()}

    def max_abs(a, b):
        return float((a.detach() - b.detach()).abs().max())
    kept = [int(kern[3]["binned"].num_pairs), int(xa[3]["binned"].num_pairs)]
    grad_rel = {f: max_abs(xa[1][f], kern[1][f])
                / max(float(kern[1][f].abs().max()), 1e-30) for f in FIELDS}
    bit = bool(torch.equal(xa[0], xb[0])) and all(
        torch.equal(xa[1][f], xb[1][f]) for f in FIELDS)
    score_rel = {m: float(((xscores[m] - kscores[m]).abs()
                           / kscores[m].abs().clamp(min=1e-30)).max())
                 for m in METRICS}
    frame_pairs = [int(kframe["num_pairs"]), int(xframe["num_pairs"])]
    row = {"phase": "xla_route", "label": "plain PyTorch route",
           "n": st.capacity, "width": cam.width, "height": cam.height,
           "train_render": {"kept_pairs": kept,
                            "overflow": int(xa[3]["binned"].overflow),
                            "image_max_abs_err": max_abs(
                                xa[3]["render"], kern[3]["render"]),
                            "loss": [float(kern[0]), float(xa[0])],
                            "grad_err_of_field_max": grad_rel,
                            "xla_bit_identical_twice": bit,
                            "ms": {"kernels": kern_ms,
                                   "plain PyTorch route": xla_ms}},
           "ours_frame": {"num_pairs": frame_pairs,
                          "overflow": int(xframe["overflow"]),
                          "max_abs_err": max_abs(xframe["render"],
                                                 kframe["render"]),
                          "ms": {"kernels": kframe_ms,
                                 "plain PyTorch route": xframe_ms}},
           "score_views": {"rel_err": score_rel,
                           "ms_plain PyTorch route": score_ms},
           "dense": {"shape": f"N={n_d}, {w_d}x{h_d}",
                     "final_T_max_abs_err": max_abs(ox["final_T"],
                                                    od["final_T"]),
                     "image_max_abs_err": max_abs(ox["render"],
                                                  od["render"]),
                     "ms": dense_ms},
           "launches": launches,
           "tol": {"image": XLA_ATOL, "grad": XLA_GRAD_RTOL,
                   "scores": STATS_RTOL, "dense_final_T": DENSE_T_ATOL,
                   "dense_image": DENSE_ATOL}}
    emit(row)
    if any(launches.values()):
        raise AssertionError(f"the XLA route launched kernels: {launches}")
    if not (kept[0] == kept[1] and row["train_render"]["overflow"] == 0
            and row["train_render"]["image_max_abs_err"] <= XLA_ATOL
            and all(v <= XLA_GRAD_RTOL for v in grad_rel.values()) and bit
            and frame_pairs[0] == frame_pairs[1]
            and row["ours_frame"]["overflow"] == 0
            and row["ours_frame"]["max_abs_err"] <= XLA_ATOL
            and all(v <= STATS_RTOL for v in score_rel.values())
            and row["dense"]["final_T_max_abs_err"] <= DENSE_T_ATOL
            and row["dense"]["image_max_abs_err"] <= DENSE_ATOL):
        raise AssertionError("the XLA route failed a check")


# ---------------------------------------------------------------------------
# The twelfth slice: multi-device paths, the viewer, the native COLMAP
# parser and the profiler trace.

RANKS = 4                         # gloo ranks sharing the card
# The 4 ranks split the proxy's rows after a seeded permutation, which the
# single-device twins render too: the proxy's contiguous quarters are far
# from balanced (rank 0's holds about half of a frame's pairs, PERF.md),
# and the sharded calls keep the single-device global capacities, each
# rank a quarter of them.
# Per-destination blocks: the default, max(2 cap_local // W, 256) rows;
# SMALL_DEST_CAPACITY is the undersized one.
SHARD_SEED = 7
SMALL_DEST_CAPACITY = 65_536
DP_GRAD_RTOL = 1e-6               # all-reduced vs one-process mean, of
                                  # each field's largest
SHARED_LABEL = "4 ranks sharing one H100 through gloo; not a scaling figure"
PARALLEL_GAZES = [(0.5, 0.5), (0.2, 0.2)]
BG = [0.1, 0.2, 0.3]


def digest(t):
    """sha1 of a tensor's bytes: ranks compare images without moving them."""
    import hashlib
    return hashlib.sha1(t.detach().contiguous().cpu().numpy()
                        .tobytes()).hexdigest()


def parallel_kernels():
    """The wrappers of the kernels the parallel paths launch, by the name
    of their rows in the kernels line."""
    from fovsplat_torch.ops.kernels import blend_fov as bf
    from fovsplat_torch.ops.kernels import blend_fwd as bfw
    from fovsplat_torch.ops.kernels import build_table as bt
    from fovsplat_torch.ops.kernels import expand_fov as ef
    from fovsplat_torch.ops.kernels import expand_ps1 as ep1
    from fovsplat_torch.ops.kernels import segment_reduce as sr
    return {"build_table": bt.build_table, "expand_fov": ef.expand_fov,
            "blend_fov": bf.blend_fov, "expand_ps1": ep1.expand_ps1,
            "blend_forward": bfw.blend_forward,
            "blend_backward": bfw.blend_backward,
            "reduce_by_sorted_gid": sr.reduce_by_sorted_gid,
            "blend_forward_q": bfw.blend_forward_q}


def counted(kernels, fn):
    """fn() with every launch counter set to 0 just before and read just
    after (kernel 3's launches from tile0 > 0 also as "blend_fov_tile0");
    returns (fn's result, launches, wall ms synchronised)."""
    import torch
    for kf in kernels.values():
        kf.launches = 0
    kernels["blend_fov"].launches_tile0 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: kf.launches for k, kf in kernels.items()}
    launches["blend_fov_tile0"] = kernels["blend_fov"].launches_tile0
    return out, launches, ms


def ps1_columns(device):
    """The full-width proxy's single-level columns (means, scales,
    rotations, opacity, level-0 DC colour clipped as bench.py's tile-shard
    leg and __graft_entry__ build them)."""
    import numpy as np
    import torch
    from fovsplat_torch.data import proxy
    sc = proxy.bicycle_proxy(n=N_FULL, seed=0)
    cols = np.clip(0.5 + 0.282095 * sc["shs_dcs"][:, 0, :], 0.0, 1.0)
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in (sc["means"], sc["scales"], sc["rotations"],
                      sc["opacity"], cols)]


def row_permutation(n, device):
    """The seeded order of the proxy's rows that the 4 ranks split."""
    import numpy as np
    import torch
    return torch.as_tensor(np.random.default_rng(SHARD_SEED).permutation(n),
                           device=device)


def permuted_fov_model(model, perm):
    """The packed model with its Gaussians in the order `perm`."""
    from fovsplat_torch.ops import foveated as fov
    return fov.FovModelSoA(
        xyz=model.xyz[perm], scales=model.scales[perm],
        rotations=model.rotations[perm], rest_t=model.rest_t[..., perm],
        dc_t=model.dc_t[..., perm], opac_t=model.opac_t[..., perm],
        hl=model.hl[perm])


def dp_views(device):
    """The DP step's inputs: the train phase's state and 4 ring cameras at
    full width with seeded uniform ground truths, and the train config at
    the chain's capacities (ring views see the proxy from every side)."""
    import numpy as np
    import torch
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.train import trainer
    st, _, _ = train_inputs(N_FULL, W_FULL, H_FULL, 0, device)
    cams = ring_cameras(RANKS, W_FULL, H_FULL, device)
    rng = np.random.default_rng(12)
    gts = torch.tensor(rng.uniform(0, 1, (RANKS, H_FULL, W_FULL, 3)),
                       dtype=torch.float32, device=device)
    cfg = trainer.TrainConfig(raster=RasterizeConfig(
        pair_capacity=CHAIN_PAIR_CAPACITY,
        compact_capacity=CHAIN_COMPACT_CAPACITY))
    return st.params, cams, gts, cfg


def parallel_rank(rank, dev):
    """One of the 4 gloo ranks that share the card (phase parallel_ranks):
    the fov-sharded frame at two gazes and with an undersized block, the
    tile-sharded PS1 frame (both from the rank's quarter of the permuted
    proxy, at the single-device global capacities), and the DP step over
    one ring view a rank, twice; rank 0 also renders the single-device
    frames of the permuted proxy and the one-process mean of the 4 views'
    gradients. Images are compared by digest; every call's launches and
    wall ms are returned."""
    import torch
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.parallel import (data_parallel as dp, fov_shard,
                                         multihost, tile_shard)
    from fovsplat_torch.train import optim, trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = parallel_kernels()
    group = dp.make_mesh()
    out = {"rank": rank, "fov": {}, "launches": {}, "ms": {}}
    model, cam, *_ = frame_inputs(N_FULL, W_FULL, H_FULL, (0.5, 0.5), dev)
    perm = row_permutation(N_FULL, dev)
    model = permuted_fov_model(model, perm)
    shard = fov_shard.shard_fov_model(model, group)
    cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                          compact_capacity=COMPACT_CAPACITY,
                          sort_exact_depth=True)
    for gz in PARALLEL_GAZES:
        g = torch.tensor(gz, dtype=torch.float32, device=dev)
        (img, aux), launches, ms = counted(
            kernels, lambda: fov_shard.render_fov_tile_sharded(
                shard, cam, g, ALPHA, bg_color=BG, config=cfg,
                group=group))
        _, _, ms_warm = counted(
            kernels, lambda: fov_shard.render_fov_tile_sharded(
                shard, cam, g, ALPHA, bg_color=BG, config=cfg,
                group=group))
        row = {"digest": digest(img), "num_pairs": int(aux["num_pairs"]),
               "overflow": int(aux["overflow"]),
               "overflow_by_rank": aux["overflow_by_rank"].tolist(),
               "max_dest_block": int(aux["max_dest_block"]),
               "launches": launches, "ms_first": ms, "ms": ms_warm,
               "finite": bool(torch.isfinite(img).all())}
        if rank == 0:
            ref = fov.rasterize_fov_soa(model, cam, g, ALPHA, bg_color=BG,
                                        config=cfg)
            row.update(single_digest=digest(ref["render"]),
                       single_num_pairs=int(ref["num_pairs"]),
                       max_abs_err=float((img - ref["render"]).abs().max()))
        out["fov"][str(gz)] = row
    _, aux = fov_shard.render_fov_tile_sharded(
        shard, cam, torch.tensor(PARALLEL_GAZES[0], device=dev), ALPHA,
        config=cfg, per_dest_capacity=SMALL_DEST_CAPACITY, group=group)
    out["fov_small"] = {"overflow": int(aux["overflow"]),
                        "overflow_by_rank": aux["overflow_by_rank"].tolist(),
                        "per_dest_capacity": SMALL_DEST_CAPACITY}
    del model, shard

    full = [a[perm] for a in ps1_columns(dev)]
    mine = [multihost.shard_rows(a, group) for a in full]
    (img, aux), launches, ms = counted(
        kernels, lambda: tile_shard.render_tile_sharded(
            *mine, cam, pair_capacity=TRAIN_PAIR_CAPACITY, bg_color=BG,
            group=group))
    _, _, ms_warm = counted(
        kernels, lambda: tile_shard.render_tile_sharded(
            *mine, cam, pair_capacity=TRAIN_PAIR_CAPACITY, bg_color=BG,
            group=group))
    out["tile"] = {"digest": digest(img), "num_pairs": int(aux["num_pairs"]),
                   "overflow": int(aux["overflow"]),
                   "overflow_by_rank": aux["overflow_by_rank"].tolist(),
                   "max_dest_block": int(aux["max_dest_block"]),
                   "launches": launches, "ms_first": ms, "ms": ms_warm}
    if rank == 0:
        ref = rast.rasterize(*full[:4], cam, colors=full[4], bg_color=BG,
                             config=RasterizeConfig(
                                 pair_capacity=TRAIN_PAIR_CAPACITY,
                                 fwd_only=True, sort_exact_depth=True))
        out["tile"].update(single_digest=digest(ref["render"]),
                           single_num_pairs=int(ref["binned"].num_pairs))
    del full, mine

    params, cams, gts, tcfg = dp_views(dev)
    step = dp.make_dp_train_step(tcfg, group, device=dev)
    view = dp.stack_cameras([cams[rank]])
    runs = []
    for _ in range(2):
        (_, _, aux), launches, ms = counted(
            kernels, lambda: step(params, optim.init_state(params), view,
                                  gts[rank:rank + 1], 0))
        runs.append((aux, launches, ms))
    (a, launches, ms), (b, _, ms2) = runs
    out["dp"] = {"loss": float(a["loss"]),
                 "overflow": int(a["overflow"]),
                 "bit_identical_twice": bool(
                     a["loss"] == b["loss"] and all(
                         torch.equal(a["grads"][f], b["grads"][f])
                         for f in a["grads"])),
                 "grads_digest": digest(torch.cat(
                     [g.reshape(-1) for g in a["grads"].values()])),
                 "launches": launches, "ms_first": ms, "ms": ms2}
    if rank == 0:
        loss_fn = trainer.photometric_loss_fn(tcfg)
        views = [trainer.value_and_grad(params, c, gts[i], tcfg, loss_fn)
                 for i, c in enumerate(cams)]
        err = {}
        for f, g in a["grads"].items():
            single = torch.stack([v[1][f] for v in views]).mean(0)
            err[f] = float((g - single).abs().max()
                           / single.abs().max().clamp(min=1e-30))
        out["dp"]["grad_rel_err"] = err
        out["dp"]["single_loss"] = float(
            torch.stack([v[0] for v in views]).mean())
    return out


def run_parallel_ranks(results):
    """Phase parallel_ranks: parallel_rank on 4 gloo ranks sharing the
    card. Every sharded frame must equal its single-device frame bit for
    bit on every rank, with the single-device num_pairs and overflow 0;
    the undersized block must report overflow; the DP gradients must be
    within DP_GRAD_RTOL of the one-process mean, the same on every rank,
    and bit-identical over two runs. Returns the summed launches of the
    sharded calls (fov at both gazes, tile, DP), by phase."""
    import torch
    from fovsplat_torch.parallel import dryrun
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = dryrun.spawn_ranks(parallel_rank, RANKS, "cuda", "gloo")
    seconds = time.perf_counter() - t0
    r0 = outs[0]
    fails = []
    for gz, row in r0["fov"].items():
        if not (row["digest"] == row["single_digest"]
                and row["num_pairs"] == row["single_num_pairs"]
                and row["overflow"] == 0 and row["finite"]):
            fails.append(f"fov {gz}: {row}")
        if any(o["fov"][gz]["digest"] != row["digest"] for o in outs):
            fails.append(f"fov {gz}: ranks disagree")
    if not r0["fov_small"]["overflow"] > 0:
        fails.append(f"undersized block: {r0['fov_small']}")
    t = r0["tile"]
    if not (t["digest"] == t["single_digest"] and t["overflow"] == 0
            and t["num_pairs"] == t["single_num_pairs"]
            and all(o["tile"]["digest"] == t["digest"] for o in outs)):
        fails.append(f"tile: {t}")
    d = r0["dp"]
    if not (max(d["grad_rel_err"].values()) <= DP_GRAD_RTOL
            and all(o["dp"]["bit_identical_twice"] for o in outs)
            and all(o["dp"]["overflow"] == 0 for o in outs)
            and len({o["dp"]["grads_digest"] for o in outs}) == 1):
        fails.append(f"dp: {d}")

    def summed(rows):
        return {k: sum(r[k] for r in rows) for k in rows[0]}
    launches = {
        "fov_shard": summed([o["fov"][gz]["launches"] for o in outs
                             for gz in r0["fov"]]),
        "tile_shard": summed([o["tile"]["launches"] for o in outs]),
        "dp_step": summed([o["dp"]["launches"] for o in outs])}
    ms = {"fov_shard": {gz: [o["fov"][gz]["ms"] for o in outs]
                        for gz in r0["fov"]},
          "tile_shard": [o["tile"]["ms"] for o in outs],
          "dp_step": [o["dp"]["ms"] for o in outs],
          "first_calls": {"fov_shard": {gz: [o["fov"][gz]["ms_first"]
                                             for o in outs]
                                        for gz in r0["fov"]},
                          "tile_shard": [o["tile"]["ms_first"]
                                         for o in outs],
                          "dp_step": [o["dp"]["ms_first"] for o in outs]}}
    emit({"phase": "parallel_ranks", "ranks": RANKS, "backend": "gloo",
          "n": N_FULL, "width": W_FULL, "height": H_FULL,
          "fov": {gz: {k: v for k, v in row.items()
                       if k not in ("digest", "single_digest", "launches")}
                  for gz, row in r0["fov"].items()},
          "fov_undersized": r0["fov_small"],
          "tile": {k: v for k, v in t.items()
                   if k not in ("digest", "single_digest", "launches")},
          "per_dest_capacity": {
              "fov": max(2 * -(-PAIR_CAPACITY // RANKS) // RANKS, 256),
              "tile": max(2 * (TRAIN_PAIR_CAPACITY // RANKS) // RANKS, 256)},
          "shard_seed": SHARD_SEED,
          "dp": {"loss": d["loss"], "single_loss": d["single_loss"],
                 "grad_rel_err": d["grad_rel_err"], "tol": DP_GRAD_RTOL,
                 "bit_identical_twice": [o["dp"]["bit_identical_twice"]
                                         for o in outs]},
          "launches": launches, "wall_ms_per_call": ms,
          "wall_ms_label": SHARED_LABEL, "seconds": seconds})
    if fails:
        raise AssertionError("parallel_ranks: " + "; ".join(fails))
    for name, ks in (("fov_shard", ("build_table", "expand_fov",
                                    "blend_fov")),
                     ("tile_shard", ("blend_forward_q",)),
                     ("dp_step", ("expand_ps1", "blend_forward",
                                  "blend_backward",
                                  "reduce_by_sorted_gid"))):
        for k in ks:
            if launches[name][k] <= 0:
                raise AssertionError(f"{k} never launched on {name}")
    results["parallel_ranks_max_dest_block"] = {
        "fov": max(r["max_dest_block"] for r in r0["fov"].values()),
        "tile": t["max_dest_block"]}
    return launches


def run_parallel_nccl(dev):
    """Phase parallel_nccl: a world-size-1 NCCL group in this process. The
    DP step over one view against trainer.make_train_step, the
    tile-sharded frame ("kernels") against rasterize(fwd_only,
    sort_exact_depth) and the fov-sharded frame against rasterize_fov_soa
    (sort_exact_depth), each bit-identical, with the launches of each
    sharded call (counters set to 0 just before, read just after)."""
    import torch
    import torch.distributed as dist
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops import rasterize as rast
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    from fovsplat_torch.parallel import (data_parallel as dp, dryrun,
                                         fov_shard, multihost, tile_shard)
    from fovsplat_torch.train import optim, trainer
    kernels = parallel_kernels()
    multihost.init_group(f"127.0.0.1:{dryrun.free_port()}", 1, 0, dev,
                         "nccl")
    try:
        group = dp.make_mesh()
        model, cam, *_ = frame_inputs(N_FULL, W_FULL, H_FULL, (0.5, 0.5),
                                      dev)
        cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                              compact_capacity=COMPACT_CAPACITY,
                              sort_exact_depth=True)
        g = torch.tensor((0.5, 0.5), dtype=torch.float32, device=dev)
        (img, aux), fl, fms = counted(
            kernels, lambda: fov_shard.render_fov_tile_sharded(
                fov_shard.shard_fov_model(model, group), cam, g, ALPHA,
                bg_color=BG, config=cfg, group=group))
        ref = fov.rasterize_fov_soa(model, cam, g, ALPHA, bg_color=BG,
                                    config=cfg)
        fov_same = bool(torch.equal(img, ref["render"])
                        and int(aux["num_pairs"]) == int(ref["num_pairs"])
                        and int(aux["overflow"]) == 0)
        del model, img, ref
        full = ps1_columns(dev)
        (img, aux), tl, tms = counted(
            kernels, lambda: tile_shard.render_tile_sharded(
                *full, cam, pair_capacity=TRAIN_PAIR_CAPACITY,
                bg_color=BG, group=group))
        ref = rast.rasterize(*full[:4], cam, colors=full[4], bg_color=BG,
                             config=RasterizeConfig(
                                 pair_capacity=TRAIN_PAIR_CAPACITY,
                                 fwd_only=True, sort_exact_depth=True))
        tile_same = bool(torch.equal(img, ref["render"])
                         and int(aux["num_pairs"]) ==
                         int(ref["binned"].num_pairs)
                         and int(aux["overflow"]) == 0)
        del full, img, ref
        params, cams, gts, tcfg = dp_views(dev)
        (dp_p, _, dp_aux), dl, dms = counted(
            kernels, lambda: dp.make_dp_train_step(tcfg, group, device=dev)(
                params, optim.init_state(params),
                dp.stack_cameras(cams[:1]), gts[:1], 0))
        one_p, _, one_aux = trainer.make_train_step(tcfg, device=dev)(
            params, optim.init_state(params), cams[0], gts[0], 0)
        dp_same = bool(dp_aux["loss"] == one_aux["loss"] and all(
            torch.equal(getattr(dp_p, f), getattr(one_p, f))
            for f in params.fields()))
    finally:
        dist.destroy_process_group()
    launches = {"fov_shard": fl, "tile_shard": tl, "dp_step": dl}
    emit({"phase": "parallel_nccl", "world_size": 1, "backend": "nccl",
          "n": N_FULL, "width": W_FULL, "height": H_FULL,
          "fov_bit_identical": fov_same, "tile_bit_identical": tile_same,
          "dp_bit_identical": dp_same, "launches": launches,
          "ms_first_call": {"fov_shard": fms, "tile_shard": tms,
                            "dp_step": dms}})
    if not (fov_same and tile_same and dp_same):
        raise AssertionError("parallel_nccl: a sharded result differs from "
                             "the single-device one")
    return launches


def check_blend_range(full, results):
    """Kernel 3 over one owner's tile range (rank 1 of 4: tile0 = ceil(T /
    4)) at the full-width frame: against blend_fov_plain with the same
    tile0 within T_EPS, and bit-identical to those tiles of the whole-grid
    launch and over two launches; timed beside its plain version, its
    bound counted from the range's walked pair-pixels."""
    import torch
    from fovsplat_torch.ops.kernels import blend_fov as bf
    pairs, seg, l1, l2 = blend_inputs(*full)
    gx = full[4]
    T = l1.shape[0]
    tpd = -(-T // RANKS)
    t0, n = tpd, tpd
    args = (pairs, seg[t0:t0 + n + 1].contiguous(),
            l1[t0:t0 + n].contiguous(), l2[t0:t0 + n].contiguous(), gx)
    k = bf.blend_fov(*args, tile0=t0)
    again = bf.blend_fov(*args, tile0=t0)
    whole = bf.blend_fov(pairs, seg, l1, l2, gx)
    plain = bf.blend_fov_plain(*args, return_walked=True, tile0=t0)
    err = max(float((a - b).abs().max()) for a, b in zip(k, plain[:4]))
    same_whole = all(torch.equal(a, w[t0:t0 + n]) for a, w in zip(k, whole))
    twice = same_outputs(k, again)
    emit({"phase": "check", "kernel": "blend_fov", "shape":
          f"tile0={t0}, {n} tiles of {T}", "max_abs_err": err,
          "tol": BLEND_ATOL, "equals_whole_grid_rows": same_whole,
          "bit_identical_twice": twice})
    if not (err <= BLEND_ATOL and same_whole and twice):
        raise AssertionError(f"blend_fov tile0={t0}: err {err}, whole-grid "
                             f"rows {same_whole}, twice {twice}")
    times = kernel_times(lambda: bf.blend_fov(*args, tile0=t0))
    plain_ms = cuda_ms(lambda: bf.blend_fov_plain(*args, tile0=t0), 1)
    kept = int(seg[t0 + n] - seg[t0])
    nbytes = kept * 13 * 4 + (n + 1) * 4 + 2 * n * 256 + n * 8 * 256 * 4
    b_ms, b_by = bound(nbytes, 25.0 * float(plain[4].double().sum()))
    results["blend_fov_tile0"] = dict(
        launches=None, max_abs_err=err, **times, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"N={N_FULL}, {W_FULL}x{H_FULL}, tiles [{t0}, {t0 + n}) "
              f"of {T}")


def run_dryrun():
    """Phase dryrun: `python -m fovsplat_torch.cli dryrun --devices 1`
    (NCCL, one card) in a process of its own, alone on the card; its JSON
    line and seconds to exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "fovsplat_torch.cli",
                             "dryrun", "--devices", "1"], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"cli dryrun rc={proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    emit({"phase": "dryrun", "devices": 1, "backend": "nccl",
          "result": json.loads(lines[-1]), "seconds": seconds})


def viewer_request(cam):
    """The viewer's JSON request for a port camera: its matrices in the
    SIBR viewer's transposed, Y/Z-flipped convention
    (eval/network_gui.receive inverts it)."""
    import numpy as np
    view = cam.world_view.cpu().numpy().T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    full = cam.full_proj.cpu().numpy().T.copy()
    full[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height,
            "view_matrix": view.ravel().tolist(),
            "view_projection_matrix": full.ravel().tolist(),
            "fov_x": 2 * math.atan(float(cam.tan_fovx)),
            "fov_y": 2 * math.atan(float(cam.tan_fovy)),
            "train": True, "keep_alive": True}


def run_viewer(model, dev):
    """Phase viewer: a loopback client sends one request for the proxy
    camera at 656x528; NetworkGUI.serve_step decodes the camera on the
    card and answers with the centre-gaze "ours" frame of the full-width
    model. The decoded camera must match the request's within 1e-6 and
    the bytes must be the frame's, clipped to [0, 1] and cut to u8."""
    import socket
    import threading
    import numpy as np
    import torch
    from fovsplat_torch.data import proxy
    from fovsplat_torch.eval import network_gui
    from fovsplat_torch.ops import foveated as fov
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    cam = proxy.proxy_camera(width=656, height=528, device=dev)
    cfg = RasterizeConfig(pair_capacity=PAIR_CAPACITY,
                          compact_capacity=COMPACT_CAPACITY)
    g = torch.tensor((0.5, 0.5), device=dev)

    def render(c):
        return torch.clamp(fov.rasterize_fov_soa(model, c, g, ALPHA,
                                                 config=cfg)["render"], 0, 1)
    payload = json.dumps(viewer_request(cam)).encode()
    expect = cam.width * cam.height * 3 + 4 + len("proxy")
    gui = network_gui.NetworkGUI(port=0, device=dev)
    got, seen = [], {}
    try:
        sock = socket.create_connection(gui.listener.getsockname())

        def client():
            sock.sendall(len(payload).to_bytes(4, "little") + payload)
            buf = b""
            while len(buf) < expect:
                chunk = sock.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
            got.append(buf)
        th = threading.Thread(target=client)
        th.start()

        def fn(c):
            seen["cam"] = c
            return render(c)
        t0 = time.perf_counter()
        msg = None
        for _ in range(1000):
            msg = gui.serve_step(fn, "proxy")
            if msg is not None:
                break
        th.join(timeout=60)
        seconds = time.perf_counter() - t0
        sock.close()
    finally:
        gui.close()
    c = seen.get("cam")
    cam_err = max(float((getattr(c, f) - getattr(cam, f)).abs().max())
                  for f in ("world_view", "full_proj", "cam_center"))
    want = (np.clip(render(c).cpu().numpy(), 0, 1) * 255).astype(
        np.uint8).tobytes()
    ok = (msg is not None and got and len(got[0]) == expect
          and got[0][:len(want)] == want and cam_err <= 1e-6
          and c.world_view.device.type == "cuda")
    emit({"phase": "viewer", "width": cam.width, "height": cam.height,
          "bytes": len(got[0]) if got else 0, "camera_max_abs_err": cam_err,
          "image_bytes_equal": bool(got and got[0][:len(want)] == want),
          "seconds": seconds})
    if not ok:
        raise AssertionError("viewer round trip failed")


def run_native_colmap(scene_root):
    """Phase native_colmap: the native parser (fovsplat_torch/native, built
    with g++ into build/native) and the Python parser on the scene_io
    scene's images.bin and points3D.bin: equal results, seconds each."""
    import numpy as np
    from fovsplat_torch import native
    from fovsplat_torch.data import colmap
    sparse = os.path.join(scene_root, "sparse", "0")
    pts, ims = (os.path.join(sparse, f) for f in ("points3D.bin",
                                                  "images.bin"))
    t0 = time.perf_counter()
    lib = native.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast_p, fast_i = native.parse_points3d(pts), colmap.read_images_binary(
        ims)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_p = colmap.read_points3d_binary_python(pts)
    py_i = colmap.read_images_binary_python(ims)
    t_python = time.perf_counter() - t0
    same = (fast_p is not None
            and all(np.array_equal(a, b) for a, b in zip(fast_p, py_p))
            and sorted(fast_i) == sorted(py_i)
            and all(fast_i[k].name == py_i[k].name
                    and np.array_equal(fast_i[k].qvec, py_i[k].qvec)
                    and np.array_equal(fast_i[k].tvec, py_i[k].tvec)
                    for k in py_i))
    emit({"phase": "native_colmap", "points": len(py_p[0]),
          "images": len(py_i), "equal": same, "library": os.path.relpath(
              lib, os.path.dirname(os.path.abspath(__file__))),
          "seconds": {"build": t_build, "native": t_native,
                      "python": t_python}})
    if not same:
        raise AssertionError("native and Python COLMAP parses differ")


def run_trace(render, cam):
    """Phase trace: utils/profiling.trace around one centre-gaze "ours"
    frame; the Chrome trace must exist, be non-empty and hold the port's
    kernels."""
    import torch
    from fovsplat_torch.utils import profiling
    root = os.path.dirname(os.path.abspath(__file__))
    g = torch.tensor((0.5, 0.5), device=cam.device)
    with profiling.trace(os.path.join(root, "build", "trace")) as path:
        render(cam, g)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    pat = re.compile(r"\b(%s)\s*[(<]" % "|".join(sorted(own_kernel_names())))
    ours = sorted({m.group(1) for e in events if e.get("cat") == "kernel"
                   for m in [pat.search(e.get("name", ""))] if m})
    emit({"phase": "trace", "path": os.path.relpath(path, root),
          "bytes": os.path.getsize(path), "events": len(events),
          "own_kernels": ours})
    if not (os.path.getsize(path) > 0 and events):
        raise AssertionError("profiling.trace wrote an empty trace")


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
          "global_functions": sorted(own_kernel_names()),
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
    ml = run_mmfr(cam, all_kernels, results)
    launches["blend_forward_q_mmfr"] = ml["blend_forward_q"]
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
    cl, chain_model, chain = run_chain(N_FULL, W_FULL, H_FULL, chain_cfg,
                                       chain_cfg.raster, all_kernels, dev)
    launches["blend_stats"] = cl["blend_stats"]
    hvs_vs_cpu(train_config(1 << 20, None))
    score = loops.make_score_fn(tcfg)
    emit({"phase": "profile", "path": "score view (max_comp_efficiency)",
          **profile_window(lambda: score(st, tcam), 3)})
    hvs_step = loops.make_hvs_step(tcfg, 3.0, masking=True)
    emit({"phase": "profile", "path": "masked HVS step, pooling 3",
          "step_ms_unprofiled": cuda_ms(lambda: hvs_step(st, tcam, gt, 1), 3),
          **profile_window(lambda: hvs_step(st, tcam, gt, 1), 3)})

    # --- scene and model I/O, from-scratch training, the pipeline ---
    scene, scene_root = run_scene_io(chain_cfg, dev)
    scratch_l = run_scratch(scene, chain_cfg, all_kernels, dev)
    scratch_vs_cpu(train_config(1 << 20, None))
    pipeline_l = run_pipeline_phase(scene_root, scene, chain_cfg, cfg,
                                    all_kernels, dev)

    # --- quality evaluation: metrics, LPIPS, foveated HVS, layers, the
    # unpacked foveated frame, the eval subcommands ---
    sc_full = proxy.bicycle_proxy(n=N_FULL, seed=0)
    img0, gt0, quality_l = run_quality(scene_root, scene, sc_full, chain_cfg,
                                       all_kernels, dev)
    run_lpips(img0, gt0)
    run_hvs_fov(img0, gt0)
    layers_l = run_layers(scene_root, chain_model, scene.test_views,
                          chain_cfg, all_kernels, dev)
    del chain_model
    unpacked_l = run_fov_unpacked(sc_full, model, all_kernels, dev)
    run_cli_eval(scene_root, os.path.join(scene_root, "pipeline_out"))
    eval_l = {"quality": quality_l, "layers": layers_l,
              "fov_unpacked": unpacked_l}

    # --- the LightGaussian models, the vq subcommand, the XLA route ---
    vq_l = run_vq(st, scene, chain_cfg, all_kernels, dev)
    distill_l = run_distill(st, scene, chain_cfg, all_kernels, dev)
    mm_l, mm_frame_l = run_mm_models(chain, chain_cfg, all_kernels, dev)
    del chain
    run_cli_vq(scene_root, os.path.join(scene_root, "pipeline_out"))
    run_xla_route(st, tcam, gt, tcfg, sc_full, all_kernels, dev)
    lg_l = {"vq": vq_l, "distill": distill_l, "mm_models": mm_l,
            "mm_frame": mm_frame_l}

    # --- multi-device: kernel 3 over an owner's tile range, the sharded
    # paths (one NCCL rank; 4 gloo ranks sharing the card), the dry run;
    # the viewer, the native COLMAP parser, the profiler trace ---
    check_blend_range(full, results)
    torch.cuda.empty_cache()
    nccl_l = run_parallel_nccl(dev)
    ranks_l = run_parallel_ranks(results)
    run_dryrun()
    run_viewer(model, dev)
    run_native_colmap(scene_root)
    run_trace(render, cam)
    parallel_l = {f"{ph}_{path}": l for ph, ls in (("nccl", nccl_l),
                                                    ("ranks", ranks_l))
                  for path, l in ls.items()}
    launches["blend_fov_tile0"] = (nccl_l["fov_shard"]["blend_fov_tile0"]
                                   + ranks_l["fov_shard"]["blend_fov_tile0"])

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
           "blend_forward_q_mmfr": ("fovsplat_torch/csrc/blend_fwd.cu",
                                    "fovsplat/ops/pallas/blend_fwd.py:508"),
           "compact_table": ("fovsplat_torch/csrc/compact_table.cu",
                             "fovsplat/ops/pallas/compact_table.py:218"),
           "blend_fov_tile0": ("fovsplat_torch/csrc/blend_fov.cu",
                               "fovsplat/ops/pallas/blend_fov.py:463")}
    rows = []
    for k, (source, replaces) in src.items():
        r = results[k]
        rows.append({"name": k, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms": r["device_ms"],
                     "device_split": r["device_split"],
                     "device_ms_from": r["device_ms_from"],
                     "launches_per_call": r.get("launches_per_call"),
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "shape": r["shape"]})
        if k in ("expand_ps1", "blend_forward", "blend_backward",
                 "reduce_by_sorted_gid", "blend_stats"):
            rows[-1]["launches_scratch"] = scratch_l[k]
            rows[-1]["launches_pipeline"] = pipeline_l[k]
        # Launches in the eval phases, by the wrapper of the row's name (the
        # rows of other routes through a shared wrapper get 0).
        rows[-1]["launches_eval"] = {ph: l.get(k, 0)
                                     for ph, l in eval_l.items()}
        # And in the LightGaussian phases (mm_frame keyed by row).
        rows[-1]["launches_lightgaussian"] = {ph: l.get(k, 0)
                                              for ph, l in lg_l.items()}
        # And in the sharded calls of the parallel phases (the tile-range
        # row counts kernel 3's launches from tile0 > 0 there).
        rows[-1]["launches_parallel"] = {ph: l.get(k, 0)
                                         for ph, l in parallel_l.items()}
    emit({"kernels": rows,
          "blend_fov_150k": results["blend_fov_150k"],
          "largest_dest_block": results["parallel_ranks_max_dest_block"],
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
