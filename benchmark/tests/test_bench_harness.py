"""The harness: BENCHMARK.json against the contract, files found by name,
the result line, the comparison."""

import hashlib
import json
import math
import re
import shutil

import pytest

from benchmark import harness
from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert [w["name"] for w in s["workloads"]] == list(CELLS)
    configs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        assert any(w["config"] == c["name"] for w in s["workloads"])
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        mine = [m for m in s["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in
                   s["per_layer"])
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = {}
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len({w["config"] + "/" + w["traffic"]
                for w in s["workloads"]}) == len(s["workloads"])


def test_cells_find_their_files():
    for name in CELLS:
        cell = harness.load_cell(ROOT, name)
        assert cell.limits and cell.traffic["runner"]
        harness.runner(cell.traffic["runner"])
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no-such-cell")


def _digest(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(folder.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_come_as_new_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a limit file and
    a per-layer metric as new files plus BENCHMARK.json entries: the
    harness finds them, and no file that was there changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    s = spec()
    b = tmp_path / "benchmark"
    cfg = json.loads((ROOT / "benchmark/configs/bicycle-ps1.json")
                     .read_text())
    (b / "configs" / "garden-ps1.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/orbit.json").read_text())
    mix["head"]["speed_deg_s"] = [0, 5]
    (b / "traffic" / "slow-orbit.json").write_text(json.dumps(mix))
    (b / "limits" / "garden-slow-orbit.json").write_text(
        (ROOT / "benchmark/limits/ps1-frame-orbit.json").read_text())
    (b / "metrics" / "frames_per_host_ms.py").write_text(
        "def read(data):\n    return 1.0 / data['host_ms']\n")
    s["configs"].append({"name": "garden-ps1", "source": "x",
                         "file": "benchmark/configs/garden-ps1.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "garden-slow-orbit",
                           "config": "garden-ps1", "traffic": "slow-orbit",
                           "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "frames_per_host_ms", "unit": "1/ms",
                           "better": "higher", "source": "program_span",
                           "layer": "entry and graphs",
                           "moves": "frame_ms_p95",
                           "workloads": ["garden-slow-orbit"]})
    h = harness.load_module(b / "harness.py", "copied_harness")
    cell = h.load_cell(tmp_path, "garden-slow-orbit", s)
    assert cell.traffic["head"]["speed_deg_s"] == [0, 5]
    assert cell.config == cfg
    got = h.read_per_layer(cell, {"host_ms": 0.25})
    assert got == {"frames_per_host_ms": {"value": 4.0, "unit": "1/ms"}}
    after = _digest(b)
    assert {k: v for k, v in after.items() if k in before} == before


def test_result_line_keys_and_order():
    checks = {"image_max_abs": {"value": 1e-7, "limit": 1e-5}}
    line = harness.result_line(True, 10, 0, {"fps": {"value": 1.0,
                                                     "unit": "frames/s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 1}, checks,
                               {"device_ops": [], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    assert "breakdown" not in json.loads(harness.result_line(
        True, 1, 0, {}, {}, checks))


def test_compare_fails_on_a_number_past_its_limit_or_not_finite():
    ok, checks = harness.compare({"a": 1e-7, "b": 0}, {"a": 1e-5, "b": 0})
    assert ok and checks["a"] == {"value": 1e-7, "limit": 1e-5}
    assert not harness.compare({"a": 2e-5}, {"a": 1e-5})[0]
    assert not harness.compare({"a": math.nan}, {"a": 1e-5})[0]
    bad = harness.compare({"a": math.inf}, {"a": 1e-5})[1]
    assert bad["a"]["value"] == "inf"


def test_finish_reports_the_cells_metrics():
    cell = harness.load_cell(ROOT, "ps1-frame-orbit")
    ctx = harness.Context(cell=cell, seed=1, seconds=1.0, trace=False,
                          device="cpu")
    out = {"e2e": {"fps": 700.0, "frame_ms_p95": 1.3, "setup_s": 9.0},
           "attempted": 7000, "failed": 0, "data": {},
           "readings": {"image_max_abs": 0.0, "num_pairs_gap": 0,
                        "failed_frames": 0}}
    d = json.loads(harness.finish(ctx, out, {"platform": "gpu"}))
    assert set(d["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}
    assert d["correct"] and list(d)[-1] == "checks"
