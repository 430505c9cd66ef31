"""The port's spans and stage maps (utils/profiling) on the CPU: the
span off and under a CPU profiler, a capture's stage map from node
counts, the bytes of a graph's record, and window_report on synthetic
profiler events."""

import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fovsplat_torch.utils import profiling
from tests.torch_cpu import one_torch_thread  # noqa: F401


def test_span_is_the_shared_no_op_when_off():
    assert profiling._capture is None
    a, b = profiling.span("sort"), profiling.span("graph.replay", 7)
    assert a is b is profiling._OFF
    with a:
        pass


def test_span_emits_prefixed_ranges_under_a_cpu_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("render"):
            with profiling.span("sort"):
                torch.ones(8).sort()
        with profiling.span("graph.replay", 12):
            torch.zeros(2) + 1
    names = [e.name for e in prof.events()]
    for want in ("fovsplat.render", "fovsplat.sort",
                 "fovsplat.graph.replay#12"):
        assert want in names
    assert profiling.span("sort") is profiling._OFF


class FakeGraph:
    """Node reads of a capture: letters appended as the 'stream' runs."""

    LETTERS = {**{v: k for k, v in profiling._NODE_LETTERS.items()},
               "x": 7}   # x: an event record node

    def __init__(self):
        self.nodes = []

    def add(self, letters):
        self.nodes.extend(self.LETTERS[c] for c in letters)

    def read(self, stream, cap):
        assert stream == 99
        return len(self.nodes), self.nodes[:cap]


def test_stage_map_labels_nodes_by_span_path(monkeypatch):
    fake = FakeGraph()
    monkeypatch.setattr(profiling, "_read_nodes", fake.read)
    with profiling.capturing(99) as marks:
        fake.add("k")                        # outside every span: other
        with profiling.span("render"):
            fake.add("kc")
            with profiling.span("table"):
                fake.add("kk")
            with profiling.span("sort"):
                fake.add("skx")
            fake.add("k")
            with profiling.span("sort"):
                pass                         # no nodes: no stage
        with profiling.span("adam"):
            fake.add("kk")
        got = marks.finish()
    assert profiling._capture is None
    assert got["ops"] == "kkckkskkkk"
    assert got["stages"] == [
        ("other", 0, 1, {"k": 1}), ("render", 1, 2, {"c": 1, "k": 1}),
        ("render/table", 3, 2, {"k": 2}), ("render/sort", 5, 2,
                                           {"k": 1, "s": 1}),
        ("render", 7, 1, {"k": 1}), ("adam", 8, 2, {"k": 2})]


def test_record_bytes_are_the_static_inputs_and_outputs():
    stage_map = {"ops": "kkc", "stages": [("other", 0, 3, {})]}
    inputs = (torch.zeros(10, 3), torch.zeros((), dtype=torch.int64),
              torch.zeros(4, dtype=torch.bfloat16))
    outputs = [torch.zeros(5, 5, 3), 3, None, torch.zeros(2, dtype=torch.int32)]
    rec = profiling.record_graph(("key", 1), stage_map, inputs, outputs)
    assert rec.bytes_in == 10 * 3 * 4 + 8 + 4 * 2
    assert rec.bytes_out == 5 * 5 * 3 * 4 + 2 * 4
    assert rec.nodes == 3 and profiling.RECORDS[rec.serial] is rec
    assert profiling.static_bytes([1.0, "x"]) == 0


def ev(name, start, end, dev=False, eid=0, annotation=False):
    return types.SimpleNamespace(
        name=name, id=eid, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


REC = profiling.GraphRecord(
    serial=5, key="k", nodes=5, ops="kkcks",
    stages=[("levels", 0, 2, {}), ("render/sort", 2, 2, {}),
            ("other", 4, 1, {})],
    bytes_in=100, bytes_out=40)
OPS = ("kern_a", "kern_b", "Memcpy DtoD (Device -> Device)", "RadixSort",
       "Memset (Device)")


def replay_events(t0, names=OPS, launch_id=1):
    """One call at t0 (us): copy-in span with a memcpy, the replay span
    with its launch and operations 10 us apart (each 4 us), a clone."""
    out = [ev("fovsplat.graph.copy-in", t0, t0 + 5),
           ev("cudaMemcpyAsync", t0 + 1, t0 + 2, eid=launch_id + 100),
           ev("Memcpy DtoD (Device -> Device)", t0 + 3, t0 + 8, dev=True,
              eid=launch_id + 100),
           ev("fovsplat.graph.replay#5", t0 + 10, t0 + 20),
           ev("cudaGraphLaunch", t0 + 11, t0 + 19, eid=launch_id),
           ev("replay", t0 + 12, t0 + 70, dev=True, annotation=True)]
    out += [ev(n, t0 + 12 + 10 * i, t0 + 16 + 10 * i, dev=True,
               eid=launch_id) for i, n in enumerate(names)]
    out += [ev("fovsplat.graph.clone", t0 + 21, t0 + 25),
            ev("cudaMemcpyAsync", t0 + 22, t0 + 23, eid=launch_id + 200),
            ev("Memcpy DtoD (Device -> Device)", t0 + 70, t0 + 74, dev=True,
               eid=launch_id + 200)]
    return out


def test_window_report_splits_replays_by_stage():
    events = replay_events(0) + replay_events(100, launch_id=2)
    rep = profiling.window_report(events, {5: REC})
    g = rep["graphs"]["5"]
    assert (g["replays"], g["unmatched"], rep["unmatched"]) == (2, 0, 0)
    assert g["stage_s"] == pytest.approx(
        {"levels": 16e-6, "render/sort": 16e-6, "other": 8e-6})
    assert g["device_s"] == pytest.approx(40e-6)
    assert (g["nodes"], g["bytes_in"], g["bytes_out"]) == (5, 100, 40)
    # The copies of copy-in and clone stay out of the stages, labelled by
    # the span their launch ran in.
    assert rep["outside_s"] == pytest.approx(
        {"graph.copy-in": 10e-6, "graph.clone": 8e-6})
    assert rep["window_s"] == pytest.approx(125e-6)
    # Busy inside [0, 125] us: the first call's 5 + 20 + 4 us, the
    # second's copy-in 5 and the 4 + 3 us of its operations before 125.
    assert sum(rep["idle_gaps_s"].values()) == pytest.approx(
        (125 - 29 - 12) * 1e-6)
    stages = profiling.replay_stages(events, {5: REC})
    assert [s for s, _ in stages] == ["5", "5"]
    assert [(lb, e.name) for lb, e in stages[0][1]] == [
        ("levels", "kern_a"), ("levels", "kern_b"),
        ("render/sort", OPS[2]), ("render/sort", "RadixSort"),
        ("other", "Memset (Device)")]


def shifted(e, dt):
    return ev(e.name, e.time_range.start + dt, e.time_range.end + dt,
              dev=True, eid=e.id, annotation=e.is_user_annotation)


def test_window_report_follows_the_launch_when_the_device_lags():
    """A second call issued while the first replay still runs on the
    device: each replay keeps its own launch's operations; a copy or set
    node run as CUDA's own kernel counts as a copy or set."""
    lowered = OPS[:2] + ("memcpy128", "RadixSort", "memset32")
    first = replay_events(0, lowered)
    second = [shifted(e, 50) if e.device_type == DeviceType.CUDA
              else e for e in replay_events(30, launch_id=2)]
    rep = profiling.window_report(first + second, {5: REC})
    g = rep["graphs"]["5"]
    assert (g["replays"], g["unmatched"]) == (2, 0)
    assert g["stage_s"] == pytest.approx(
        {"levels": 16e-6, "render/sort": 16e-6, "other": 8e-6})


@pytest.mark.parametrize("fault", ["types", "short", "record", "launch"])
def test_window_report_counts_mismatches_as_unmatched(fault):
    names = OPS
    if fault == "types":
        names = ("kern_a", "Memset (Device)") + OPS[2:]
    elif fault == "short":
        names = OPS[:4]
    events = replay_events(100) + replay_events(
        0, names, launch_id=2)
    if fault == "launch":
        events = [e for e in events
                  if not (e.name == "cudaGraphLaunch" and e.id == 2)]
    records = {} if fault == "record" else {5: REC}
    rep = profiling.window_report(events, records)
    g = rep["graphs"]["5"]
    assert g["replays"] == 2
    if fault == "record":
        assert g["unmatched"] == 2 and g["stage_s"] == {}
        return
    assert g["unmatched"] == 1 and rep["unmatched"] == 1
    # The matched replay alone is split; nothing is guessed.
    assert g["device_s"] == pytest.approx(20e-6)
    assert [ops is None for _, ops in profiling.replay_stages(
        events, records)] == [True, False]
