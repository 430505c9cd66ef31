"""What every cell shares: BENCHMARK.json, the files found by name, the
set-up clock, the device checks, the import check and the result line.

Everything that belongs to one configuration, traffic mix, limit set or
per-layer metric sits in a file of its own, found by the name that
BENCHMARK.json gives it:

  configs/<config>.json     the configuration (sizes, capacities, precision)
  traffic/<mix>.json        the mix's parameters; "runner" names the code
  runners/<runner>.py       a general generator and window (run(ctx))
  limits/<cell>.json        the limit of each number `correct` compares
  metrics/<metric>.py       a per-layer reader: read(data) -> number | None
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Modules whose presence after the window fails the run, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "fovsplat")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), the set-up
    clock's origin; the interpreter's own start-up is included."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path, name: str):
    """Import the Python file `path` under the module name `name` (file
    names may hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell of BENCHMARK.json with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, spec: dict | None = None) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json (or of `spec`) with its
    configuration, traffic mix and limits. Raises KeyError for an unknown
    cell."""
    spec = spec if spec is not None else read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def runner(name: str):
    return load_module(HERE / "runners" / f"{name}.py",
                       f"benchmark_runner_{name}")


def read_per_layer(cell: Cell, data: dict) -> dict:
    """{metric: {"value", "unit"}} of every per-layer metric of the cell
    whose reader finds something to read in `data`."""
    out = {}
    for m in cell.per_layer:
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "benchmark_metric_" + m["name"].replace(".", "_"))
        v = mod.read(data)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is jax,
    jaxlib, flax or the JAX package (fovsplat, not fovsplat_torch)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def compare(readings: dict, limits: dict) -> tuple:
    """(correct, checks): each number compared beside its limit; a number
    passes when it is finite and at most its limit."""
    checks, ok = {}, True
    for k, v in readings.items():
        lim = limits[k]
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        checks[k] = {"value": v if math.isfinite(v) else str(v),
                     "limit": lim}
    return ok, checks


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    """The last line of standard output; `checks` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def device_info(torch, chips: int, dev, peak: int) -> dict:
    """The result's device: the card's name, the cards used, the memory
    peak read when the window closed, and nvidia-smi's name and power
    limit line beside it."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak)}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


@dataclasses.dataclass
class Context:
    """What a runner is given: the cell, the run's arguments, the device,
    and the control's precision (None for the program)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    control: object = None


def finish(ctx: Context, out: dict, device: dict) -> str:
    """The result line of a runner's output `out`: the end-to-end metrics
    (or, traced, the per-layer ones with busy_s and window_s), and each
    reading beside its limit, also printed last on standard error."""
    if ctx.trace:
        prof = out["data"].get("profile")
        if prof is None:
            raise RuntimeError("no profiler window held device events")
        metrics = read_per_layer(ctx.cell, out["data"])
        device = {**device, "busy_s": prof["busy_s"],
                  "window_s": prof["window_s"]}
        from benchmark import devtrace
        bd = devtrace.breakdown(prof)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in ctx.cell.end_to_end}
        bd = None
    correct, checks = compare(out["readings"], ctx.cell.limits)
    print_checks(checks)
    return result_line(correct, out["attempted"], out["failed"], metrics,
                       device, checks, bd)
