"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are found by name (harness.py); its runner builds the weights and
the traffic from the seed, warms up, measures for --seconds, and checks
what the window produced against the plain reference. --trace 1 adds a
profiled window after the measured one and reports the per-layer metrics
instead of the end-to-end ones. --control bfloat16 puts the plain
reference at that precision in the program's place; for the train
cells --control half-batch puts there the reference with its loss over
half of each image, --control unchanged the reference with each step's
state handed back as it came. Their readings set the upper end of each
limit (PERF.md); the benchmark's own runs never pass --control.

Exit codes: 0 with a result line; 2 for bad arguments or an unknown cell;
3 without CUDA or with fewer cards than the cell asks for; 4 when jax,
jaxlib, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16", "half-batch",
                                         "unchanged"), default=None)
    args = p.parse_args(argv)

    # Every cache of the run lies inside the checkout, at a fixed path.
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    if sys.path[0] == str(Path(__file__).resolve().parent):
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))

    from benchmark import harness
    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    control = args.control
    if control == "bfloat16":
        control = torch.bfloat16
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=dev, control=control)
    out = harness.runner(cell.traffic["runner"]).run(ctx)

    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {found}",
              file=sys.stderr)
        return 4
    line = harness.finish(ctx, out, harness.device_info(
        torch, cell.chips, dev, out["peak"]))
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
