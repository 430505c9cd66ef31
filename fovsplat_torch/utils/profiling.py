"""Spans, the stage map of a CUDA graph, device traces and timing
(counterpart of fovsplat/utils/profiling.py).

span(name) marks a stage of the port's frames and steps (levels, table,
expand, sort, gather, blend, compose; render, loss, backward, adam) and
of utils/graphs.Graph (graph.capture, graph.copy-in, graph.replay,
graph.clone). Off, that is when no torch.profiler records and no Graph
captures, it is one shared no-op context. While a profiler records it is
a record_function range "fovsplat.<name>" on the profiler's clock. While
a Graph captures it also marks a stage boundary in that graph's stage
map: the graph nodes the capture holds so far, read from the stream
(csrc/capture_nodes.cu). Spans nest; a stage's label is the path of its
span names ("render/sort"), and a node outside every span is "other".

A replay runs no Python between its kernels, so the stages inside it
cannot be timed from the host. Every capture instead leaves a
GraphRecord here (RECORDS, by serial number; it outlives the Graph):
the device operations a replay launches in order (kernel, copy, set),
the stages over them, and the bytes that a call copies into the static
inputs and clones out of the outputs.
window_report matches the device operations of each replay's
cudaGraphLaunch in a torch.profiler window (by correlation id) to its
record and sums their device seconds by stage.
trace() writes that report beside the Chrome trace.

force and benchmark time a call from the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
import json
import os
import time
from bisect import bisect_left, bisect_right

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "fovsplat."
REPLAY = "graph.replay"
# cudaGraphNodeType -> one letter: the device operations a profiler
# lists (kernel, memcpy, memset); any other node (events, host, empty) x.
_NODE_LETTERS = {0: "k", 1: "c", 2: "s"}
OPERATIONS = "kcs"

_OFF = contextlib.nullcontext()
_capture = None          # the _StageMap of the capture in progress
RECORDS: dict = {}       # serial -> GraphRecord, every capture of the process
_serials = itertools.count(1)


def span(name: str, serial=None):
    """The stage `name` over a block (see the module docstring); `serial`
    tags the profiler range ("fovsplat.graph.replay#7")."""
    if _capture is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, serial)


class _Span:
    __slots__ = ("name", "serial", "_range", "_map")

    def __init__(self, name: str, serial):
        self.name, self.serial = name, serial

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            # A FUNCTION-scope range: it does not take over the device
            # timeline's annotation from an enclosing user range.
            tag = "" if self.serial is None else f"#{self.serial}"
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name + tag)
            self._range.__enter__()
        self._map = _capture
        if self._map is not None:
            self._map.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self._map is not None:
            self._map.exit()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


# --- the stage map of a capture ---------------------------------------

@functools.cache
def _node_reader():
    from fovsplat_torch.ops.kernels import _build
    lib = _build.load("capture_nodes")
    fn = lib.fs_capture_nodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return lambda *args: _build.check(lib, fn(*args), "capture_nodes")


def _read_nodes(stream: int, cap: int) -> tuple:
    """(node count, types of the first min(count, cap) nodes) of the
    capture in progress on `stream` (a cudaStream_t)."""
    types = (ctypes.c_int * max(cap, 1))()
    count = ctypes.c_longlong(0)
    _node_reader()(stream, cap, types, ctypes.byref(count))
    return count.value, list(types[:min(cap, count.value)])


class _StageMap:
    """Span boundaries during one capture, in node counts of the graph
    being captured."""

    def __init__(self, stream: int):
        self.stream = stream
        self.path = []
        self.marks = [(0, "other")]   # (first node, label from there on)

    def node_count(self) -> int:
        return _read_nodes(self.stream, 0)[0]

    def enter(self, name: str):
        self.path.append(name)
        self.marks.append((self.node_count(), "/".join(self.path)))

    def exit(self):
        self.path.pop()
        self.marks.append((self.node_count(),
                           "/".join(self.path) or "other"))

    def finish(self) -> dict:
        """The stages over the device operations: ops (one letter an
        operation, in order) and stages [(label, first, count, {letter:
        n})]."""
        n = self.node_count()
        letters = "".join(_NODE_LETTERS.get(t, "x")
                          for t in _read_nodes(self.stream, n)[1])
        # Operation index of every node boundary.
        at = list(itertools.accumulate(
            (c in OPERATIONS for c in letters), initial=0))
        stages = []
        bounds = [m for m in self.marks if m[0] <= n] + [(n, None)]
        for (a, label), (b, _) in zip(bounds, bounds[1:]):
            ops = "".join(c for c in letters[a:b] if c in OPERATIONS)
            if not ops:
                continue
            counts = {c: ops.count(c) for c in sorted(set(ops))}
            if stages and stages[-1][0] == label:
                first, cnt, prev = stages[-1][1:]
                for c, k in counts.items():
                    prev[c] = prev.get(c, 0) + k
                stages[-1] = (label, first, cnt + len(ops), prev)
            else:
                stages.append((label, at[a], len(ops), counts))
        return {"ops": "".join(c for c in letters if c in OPERATIONS),
                "stages": stages}


@contextlib.contextmanager
def capturing(stream: int):
    """Marks the block as a Graph's capture on `stream` (a cudaStream_t):
    spans inside it mark stage boundaries. Yields the _StageMap."""
    global _capture
    outer, _capture = _capture, _StageMap(stream)
    try:
        yield _capture
    finally:
        _capture = outer


@dataclasses.dataclass
class GraphRecord:
    """What one capture left: serial number, the key (its repr, cut to
    200 characters), nodes (device operations a replay), ops (their
    types in order: k kernel, c copy, s set), stages [(label, first,
    count, {type: n})] over ops, bytes_in, bytes_out, and replays (every
    replay since the capture)."""
    serial: int
    key: str
    nodes: int
    ops: str
    stages: list
    bytes_in: int
    bytes_out: int
    replays: int = 0


def static_bytes(values) -> int:
    """Bytes of the tensors among `values`."""
    return sum(v.numel() * v.element_size() for v in values
               if torch.is_tensor(v))


def record_graph(key, stage_map: dict, inputs, outputs) -> GraphRecord:
    """Keep a capture's record in RECORDS under a new serial number.
    stage_map: _StageMap.finish()'s dict; inputs and outputs: the static
    inputs load copies into and the outputs fresh_outputs clones."""
    rec = GraphRecord(serial=next(_serials), key=repr(key)[:200],
                      nodes=len(stage_map["ops"]), ops=stage_map["ops"],
                      stages=stage_map["stages"],
                      bytes_in=static_bytes(inputs),
                      bytes_out=static_bytes(outputs))
    RECORDS[rec.serial] = rec
    return rec


# --- the window report ------------------------------------------------

def _op_letter(name: str) -> str:
    """A profiled operation's node type: CUDA may run a copy or
    set node as a kernel of its own ("memcpy128", "memset32")."""
    low = name[:6].lower()
    if low == "memcpy":
        return "c"
    if low == "memset":
        return "s"
    return "k"


class _Window:
    """A profiler window's events, sorted: the program's spans (start,
    end, name without the prefix), the cudaGraphLaunch calls (start,
    correlation id), the device operations (no annotations), their
    indices by correlation id, and each runtime call's start by
    correlation id."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        self.spans, self.launches, self.dev, self.runtime = [], [], [], {}
        for e in events:
            t = e.time_range
            if e.device_type == DeviceType.CPU:
                if e.name.startswith(PREFIX):
                    self.spans.append((t.start, t.end, e.name[len(PREFIX):]))
                elif e.name.startswith("cuda"):
                    self.runtime.setdefault(e.id, t.start)
                    if e.name.startswith("cudaGraphLaunch"):
                        self.launches.append((t.start, e.id))
            elif (e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)):
                self.dev.append(e)
        self.spans.sort()
        self.launches.sort()
        self.dev.sort(key=lambda e: e.time_range.start)
        self.starts = [s[0] for s in self.spans]
        self.by_id = {}
        for k, e in enumerate(self.dev):
            self.by_id.setdefault(e.id, []).append(k)

    def label_at(self, t) -> str:
        """The innermost program span at time t (serial cut), or other."""
        for i in range(bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[i][1] >= t:
                return self.spans[i][2].split("#")[0]
        return "other"


def _replays(win: _Window, records: dict):
    """(serial, record or None, the indices of its device operations or
    None) of each replay span in the window. The operations are those of
    the first cudaGraphLaunch in the span (its correlation id), in start
    order; None unless they are the record's, type for type."""
    for s0, s1, name in win.spans:
        if not name.startswith(REPLAY + "#"):
            continue
        serial = name.split("#", 1)[1]
        rec = records.get(int(serial)) if serial.isdigit() else None
        i = bisect_left(win.launches, (s0,))
        ops = None
        if rec is not None and i < len(win.launches) \
                and win.launches[i][0] <= s1:
            ops = win.by_id.get(win.launches[i][1], [])
            if (len(ops) != rec.nodes or "".join(
                    _op_letter(win.dev[k].name) for k in ops) != rec.ops):
                ops = None
        yield serial, rec, ops


def replay_stages(events, records=None) -> list:
    """[(serial, [(stage label, device event), ...] or None)] of each
    graph replay in a profiler window, None where its operations did not
    match (window_report)."""
    records = RECORDS if records is None else records
    win = _Window(events)
    out = []
    for serial, rec, ops in _replays(win, records):
        if ops is not None:
            ops = [(label, win.dev[k]) for label, first, count, _
                   in rec.stages for k in ops[first:first + count]]
        out.append((serial, ops))
    return out


def window_report(events, records=None) -> dict:
    """The stage split of a torch.profiler window's events (prof.events()).

    For each "fovsplat.graph.replay#<serial>" span: the first
    cudaGraphLaunch inside it, and the device operations of that launch
    (its correlation id), in start order. There must be the record's
    `nodes` of them, of its ops' types one for one; then their device
    seconds are summed by stage label. A replay without its record, its launch, enough
    operations or the same types counts under `unmatched` and is left
    out of the split. Returns {"graphs": {serial: {key, replays,
    unmatched, nodes, bytes_in, bytes_out, device_s, stage_s {label:
    s}}}, "unmatched", "outside_s"
    {label: s} (device seconds of the operations of no replay, by the
    innermost program span around their launch), "idle_gaps_s" {label:
    s} (the window's idle time by the innermost program span at the
    gap's middle), "window_s" (first to last program span)}."""
    records = RECORDS if records is None else records
    win = _Window(events)
    graphs, used = {}, set()
    for serial, rec, ops in _replays(win, records):
        g = graphs.get(serial)
        if g is None:
            g = graphs[serial] = {"key": None, "replays": 0, "unmatched": 0,
                                  "device_s": 0.0, "stage_s": {}}
            if rec is not None:
                g.update(key=rec.key, nodes=rec.nodes,
                         bytes_in=rec.bytes_in, bytes_out=rec.bytes_out)
        g["replays"] += 1
        if ops is None:
            g["unmatched"] += 1
            continue
        used.update(ops)
        for label, first, count, _ in rec.stages:
            secs = sum(win.dev[k].time_range.end - win.dev[k].time_range.start
                       for k in ops[first:first + count]) * 1e-6
            g["stage_s"][label] = g["stage_s"].get(label, 0.0) + secs
            g["device_s"] += secs

    outside = {}
    for k, e in enumerate(win.dev):
        if k not in used:
            label = win.label_at(win.runtime.get(e.id, e.time_range.start))
            outside[label] = (outside.get(label, 0.0)
                              + (e.time_range.end - e.time_range.start)
                              * 1e-6)

    gaps, window = {}, 0.0
    if win.spans:
        w0, w1 = win.spans[0][0], max(s[1] for s in win.spans)
        window = (w1 - w0) * 1e-6
        busy = []
        for e in win.dev:
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b <= a:
                continue
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        edges = [w0] + [x for b in busy for x in b] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                label = win.label_at(0.5 * (g0 + g1))
                gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    return {"graphs": graphs,
            "unmatched": sum(g["unmatched"] for g in graphs.values()),
            "outside_s": outside, "idle_gaps_s": gaps, "window_s": window}


# --- traces and host timing -------------------------------------------

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


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler window (CPU and, on a machine with a card, CUDA
    activities) over the block; on exit its Chrome trace is written to
    <log_dir>/trace.json (chrome://tracing, Perfetto) and its
    window_report to <log_dir>/stages.json. Yields the trace's path."""
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
    with open(os.path.join(log_dir, "stages.json"), "w") as f:
        json.dump(window_report(prof.events()), f, indent=1)


def benchmark(fn, *args, warmup: int = 3, reps: int = 10) -> float:
    """Seconds per call of fn(*args), each call waited for (force)."""
    force(fn(*args))
    for _ in range(warmup):
        force(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        force(fn(*args))
    return (time.perf_counter() - t0) / reps
