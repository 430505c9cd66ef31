"""Shared set-up of the benchmark's CPU tests: the repository root on the
import path, and each cell at a tiny size."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = ("ours-gaze-trace", "ps1-finetune-step", "ps1-frame-orbit",
         "ps1-hvs-mask-step")


def tiny_cell(name: str) -> harness.Cell:
    """The cell as BENCHMARK.json has it, at 3,000 points and 160x112:
    the same code paths, the program's plain twins on the CPU."""
    cell = copy.deepcopy(harness.load_cell(ROOT, name))
    fc = cell.config["frame"]
    fc.update(points=3000, width=160, height=112, pair_capacity=1 << 17,
              compact_capacity=1 << 16)
    if "train" in cell.config:
        cell.config["train"]["views"] = 4
    cell.traffic.update(trace_frames=400, sample={"count": 2, "pool": 6},
                        profile_frames=2, profile_steps=1)
    return cell


def tiny_run(name: str, seed: int = 2**31 + 77, control=None, runner=None):
    """One run of the tiny cell on the CPU: the runner's output."""
    import torch
    cell = tiny_cell(name)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.3, trace=False,
                          device=torch.device("cpu"), control=control)
    mod = runner or harness.runner(cell.traffic["runner"])
    return ctx, mod.run(ctx)


@pytest.fixture
def root():
    return ROOT
