"""The readers of the program's own graph counters (benchmark/program.py)
on synthetic records: a count a graph call, nothing from a program
without records, nothing in a cell of the other unit."""

import sys
import types

import pytest

from benchmark import harness
from conftest import ROOT

NEW = ("ops.frame", "ops.train", "graph_bytes.frame", "graph_bytes.train")
MODULE = "fovsplat_torch.utils.profiling"


def reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               "test_reader_" + name.replace(".", "_"))


def record(nodes, replays, bytes_in, bytes_out):
    return types.SimpleNamespace(nodes=nodes, replays=replays,
                                 bytes_in=bytes_in, bytes_out=bytes_out)


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's profiling module in sys.modules."""
    mod = types.ModuleType(MODULE)
    monkeypatch.setitem(sys.modules, MODULE, mod)
    return mod


@pytest.mark.parametrize("kind,unit", [("frame", "frame"), ("train", "step")])
def test_counts_a_graph_call(program, kind, unit):
    program.RECORDS = {1: record(1000, 3, 4_000_000, 8_000_000),
                       2: record(200, 1, 1_000_000, 0),
                       3: record(7, 0, 5, 5)}
    data = {"unit": unit}
    assert reader(f"ops.{kind}").read(data) == pytest.approx(
        (1000 * 3 + 200) / 4)
    assert reader(f"graph_bytes.{kind}").read(data) == pytest.approx(
        (12 * 3 + 1) / 4)


@pytest.mark.parametrize("name", NEW)
def test_reads_nothing_without_records(program, monkeypatch, name):
    unit = "frame" if name.endswith("frame") else "step"
    other = "step" if unit == "frame" else "frame"
    read = reader(name).read
    assert read({"unit": unit}) is None            # no RECORDS (the parent)
    program.RECORDS = {}
    assert read({"unit": unit}) is None
    program.RECORDS = {1: record(10, 0, 1, 1)}     # captured, never replayed
    assert read({"unit": unit}) is None
    program.RECORDS = {1: record(10, 2, 1, 1)}
    assert read({"unit": other}) is None and read({}) is None
    assert read({"unit": unit}) is not None
    monkeypatch.delitem(sys.modules, MODULE)
    assert read({"unit": unit}) is None


def test_new_metrics_are_listed_where_they_read():
    spec = harness.read_json(ROOT / "BENCHMARK.json")
    got = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = got[name]
        assert m["source"] == "program_counter"
        assert m["layer"] == "entry and graphs"
        frames = name.endswith("frame")
        assert m["moves"] == ("fps" if frames else "step_ms")
        assert m["workloads"] == (
            ["ours-gaze-trace", "ps1-frame-orbit"] if frames
            else ["ps1-finetune-step", "ps1-hvs-mask-step"])
