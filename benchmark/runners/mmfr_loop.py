"""The MM-FR display loop: frame_loop's closed loop with one frame in
flight, its trace, sampled frames, window, latency statistics and check,
on the MM-FR frame.

frame_loop's program_frame and reference_frame know the "ours" and PS1
frames only. This runner loads a private copy of frame_loop and binds
those two names to the MM-FR frame: the program's four packed SH level
models through eval/fps.make_mmfr_render (one CUDA graph a frame), and
the plain reference/mmfr.py. Traced, it opens one more profiler window
over the same profiled frames, after frame_loop's, and keeps
utils/profiling.window_report of its events as data["program"]: the
graph replays' device time by stage (levels, pass<l>/table, .../sort,
sum), which the per-layer metric mmfr_sort_ms reads.
"""

from __future__ import annotations

import gc
from pathlib import Path

import torch

from benchmark import devtrace, harness
from benchmark.reference import camera as refcam
from benchmark.reference import mmfr as ref_mmfr

_loop = harness.load_module(Path(__file__).with_name("frame_loop.py"),
                            "benchmark_runner_mmfr_frame_loop")


def program_frame(cfg: dict, mix: dict, sc: dict, dev):
    """The program's MM-FR frame: render(camera, gaze) -> dict, a CUDA
    graph on the card (eager on the CPU)."""
    from fovsplat_torch.eval import fps, mmfr
    from fovsplat_torch.ops.foveation import FoveationConfig
    from fovsplat_torch.ops.rasterize import RasterizeConfig
    fc = cfg["frame"]
    models = mmfr.pack_level_models(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], cfg["pnum"])
    rcs = [RasterizeConfig(pair_capacity=p, compact_capacity=k,
                           compact_table=fc["compact_table"],
                           power_cutoff=fc["power_cutoff"])
           for p, k in zip(fc["pair_capacity"], fc["compact_capacity"])]
    return fps.make_mmfr_render(models, rcs, FoveationConfig(
        **fc["foveation"]), alpha=fc["alpha"])


def reference_frame(cfg, mix, sc, arrays, tr, i, dev, dtype):
    fc = cfg["frame"]
    cam = refcam.ref_camera(arrays, i, fc["width"], fc["height"], dev)
    gaze = torch.as_tensor(tr["gazes"][i], device=dev)
    return ref_mmfr.mmfr_frame(sc, cam, gaze, fc, cfg["pnum"], dtype)


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


class _Trace:
    """devtrace for the private frame_loop: its profile() also keeps the
    program's window report of the same frames."""

    def __init__(self):
        self.report = None

    def __getattr__(self, name):
        return getattr(devtrace, name)

    def profile(self, run, unit: str, attempts: int = 3):
        out = devtrace.profile(run, unit, attempts)
        self.report = program_window(run)
        return out


_loop.program_frame = program_frame
_loop.reference_frame = reference_frame


def run(ctx) -> dict:
    """frame_loop.run on the MM-FR frame; traced, data["program"] holds
    the program's window report."""
    trace = _loop.devtrace = _Trace()
    out = _loop.run(ctx)
    if trace.report is not None:
        out["data"]["program"] = trace.report
    return out
