"""One traced run of a benchmark cell with the program's stage split.

    python3 tools/stage_split.py --workload <cell> --seed <n> \
        [--seconds 10] [--spans on|off]

Runs `benchmark/run.py --trace 1` in this process, with the benchmark's
profiler window also handed to utils/profiling.window_report, and prints
after the run's result line one JSON line: the window report reduced to
device milliseconds a frame or step by stage label (`stage_ms`), each
graph's operations and bytes a call, the replays that did not match,
and the checks the stage map answers for (stages against the replays'
device time, the share of `other`). `--spans off` keeps the program's
spans from reaching the profiler (the report is then empty): the cost of
tracing when on is the result line's host_ms and the device's idle share
against the same run with `--spans on`. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def reduce(report: dict, units: int) -> dict:
    """Device ms a unit of work by stage label, summed over the graphs."""
    stage_ms, device_s = {}, 0.0
    for g in report["graphs"].values():
        device_s += g["device_s"]
        for label, s in g["stage_s"].items():
            stage_ms[label] = stage_ms.get(label, 0.0) + s * 1e3 / units
    total = sum(stage_ms.values())
    return {
        "units": units, "unmatched": report["unmatched"],
        "stage_ms": dict(sorted(stage_ms.items(), key=lambda kv: -kv[1])),
        "replay_ms": device_s * 1e3 / units,
        "stages_over_replays": total / (device_s * 1e3 / units)
        if device_s else None,
        "other_share": stage_ms.get("other", 0.0) / total if total else None,
        "graphs": {k: {f: g.get(f) for f in (
            "replays", "unmatched", "nodes", "bytes_in", "bytes_out")}
            for k, g in report["graphs"].items()},
        "outside_ms": {k: v * 1e3 / units
                       for k, v in report["outside_s"].items()},
        "idle_gaps_ms": {k: v * 1e3 / units
                         for k, v in report["idle_gaps_s"].items()}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--spans", choices=("on", "off"), default="on")
    args = p.parse_args()

    from benchmark import devtrace, run
    from fovsplat_torch.utils import profiling
    if args.spans == "off":
        profiling._autograd_profiler = types.SimpleNamespace(
            _is_profiler_enabled=False)
    got = {}
    summarise = devtrace.summarise

    def with_report(events, dev_events, unit, units):
        got["report"] = profiling.window_report(events)
        got["units"] = units
        return summarise(events, dev_events, unit, units)
    devtrace.summarise = with_report
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if "report" in got:
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "spans": args.spans,
                          **reduce(got["report"], got["units"])}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
