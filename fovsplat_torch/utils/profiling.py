"""Stage timing and device traces (counterpart of
fovsplat/utils/profiling.py).

The reference times its stages with CUDA events
(gaussian_renderer_fov/__init__.py:74-97). StageTimer keeps the JAX
package's per-stage wall-clock report (preprocess / bin / sort / blend or
any names), benchmark its seconds per call, and trace writes a
torch.profiler Chrome trace of the device's kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def force(x) -> None:
    """Wait until the device has finished the work that produced `x` (a
    tensor or a tree of them): torch.cuda.synchronize of the first
    tensor's device. It reads no element; on the CPU there is nothing to
    wait for."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StageTimer:
    """Accumulates wall time per named stage across frames."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, out=None):
        """Times the block; put the stage's output in the yielded dict
        under "out" (or pass `out`) to wait for its device work."""
        t0 = time.perf_counter()
        holder = {}
        yield holder
        if "out" in holder:
            force(holder["out"])
        elif out is not None:
            force(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<14} {tot/n*1e3:8.2f} ms/frame  ({n} frames)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler window (CPU and, on a machine with a card, CUDA
    activities) over the block; on exit its Chrome trace is written to
    <log_dir>/trace.json (chrome://tracing, Perfetto). Yields the path."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def benchmark(fn, *args, warmup: int = 3, reps: int = 10) -> float:
    """Seconds per call of fn(*args), each call waited for (force)."""
    force(fn(*args))
    for _ in range(warmup):
        force(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        force(fn(*args))
    return (time.perf_counter() - t0) / reps
