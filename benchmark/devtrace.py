"""The traced window: torch.profiler over a few frames or steps, reduced to
device time by operation, the busy and idle time of the device, and the
idle gaps labelled by the host span they fell in.

The host spans are the benchmark's own record_function ranges: "frame"
or "step" around each unit of work, and inside it "traffic" (the next
input), "copy-in", "replay" and "clone" (the program's graph: utils/
graphs.Graph.load, its CUDA graph's replay and fresh_outputs, wrapped
for the traced window only) and "synchronize".
"""

from __future__ import annotations

import contextlib
import gc
import re
from pathlib import Path

SPANS = ("traffic", "copy-in", "replay", "clone", "synchronize")


def kernel_names(sources) -> set:
    """The __global__ functions defined in CUDA sources, as the profiler
    names them."""
    names = set()
    for src in sources:
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            Path(src).read_text()))
    return names


def program_csrc() -> Path:
    """The program's CUDA source directory, read at run time."""
    import fovsplat_torch
    return Path(fovsplat_torch.__file__).resolve().parent / "csrc"


def own_kernels() -> set:
    """Every __global__ of the program's csrc/ (headers included)."""
    return kernel_names(sorted(program_csrc().glob("*.cu*")))


def name_matcher(names):
    return re.compile(r"\b(%s)\s*[(<]" % "|".join(sorted(names)))


@contextlib.contextmanager
def graph_spans():
    """While the block runs, the program's graph calls carry the spans
    copy-in, replay and clone."""
    from torch.profiler import record_function
    from fovsplat_torch.utils import graphs
    saved = graphs.Graph.load, graphs.Graph.replay, graphs.Graph.fresh_outputs

    def wrap(fn, label):
        def inner(self, *a, **k):
            with record_function(label):
                return fn(self, *a, **k)
        return inner
    graphs.Graph.load = wrap(saved[0], "copy-in")
    graphs.Graph.replay = wrap(saved[1], "replay")
    graphs.Graph.fresh_outputs = wrap(saved[2], "clone")
    try:
        yield
    finally:
        (graphs.Graph.load, graphs.Graph.replay,
         graphs.Graph.fresh_outputs) = saved


def profile(run, unit: str, attempts: int = 3):
    """torch.profiler (CPU and CUDA) over run(), which does units of work
    each in a record_function(unit) span and returns their number; a
    window that holds no device event (the profiler drops them at times)
    is opened again, up to `attempts` windows. Returns summarise()'s
    dict, or None when no window held device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(attempts):
        with graph_spans():
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                gc.disable()    # as in the measured window
                try:
                    units = run()
                    torch.cuda.synchronize()
                finally:
                    gc.enable()
        events = list(prof.events())
        # The record_function ranges also appear on the device's timeline
        # as annotations; only operations count.
        labels = (unit,) + SPANS
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in labels]
        if dev:
            return summarise(events, dev, unit, units)
    return None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(events, dev_events, unit: str, units: int):
    """Device seconds by operation name, busy seconds (the union of the
    device intervals inside the window), the window's seconds (from the
    first `unit` span's start to the last one's end), and the idle gaps'
    seconds by the innermost host span (SPANS) that held their middle."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in (unit,) + SPANS]
    frames = [e for e in host if e.name == unit]
    if frames:
        w0 = min(e.time_range.start for e in frames)
        w1 = max(e.time_range.end for e in frames)
    else:
        w0 = min(e.time_range.start for e in dev_events)
        w1 = max(e.time_range.end for e in dev_events)
    by_name = {}
    iv = []
    for e in dev_events:
        s, t = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) * 1e-6
        s, t = max(s, w0), min(t, w1)
        if t > s:
            iv.append((s, t))
    busy = _union(iv)
    busy_us = sum(t - s for s, t in busy)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name in SPANS]
    gaps = {}
    edges = [w0] + [x for b in busy for x in b] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = max(inner, key=lambda s: s[0])[2] if inner else "other"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    return {"unit": unit, "units": units, "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_us * 1e-6,
            "device_s_by_name": by_name, "idle_gaps_s": gaps}


def device_seconds(summary: dict, names) -> float:
    """Device seconds of the operations named `names` (kernel names, as
    __global__ functions)."""
    pat = name_matcher(names)
    return sum(s for n, s in summary["device_s_by_name"].items()
               if pat.search(n))


def breakdown(summary: dict) -> dict:
    """The contract's breakdown: the device operations that took most time
    and the idle gaps by host span, at most 10 each, in seconds."""
    ops = sorted(summary["device_s_by_name"].items(), key=lambda kv: -kv[1])
    gaps = sorted(summary["idle_gaps_s"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
