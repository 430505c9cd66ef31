"""CUDA graphs of the port's frames, train steps, renders, metrics and
passes: the counterpart of the jax.jit that the JAX package puts around
them (fovsplat/eval/fps.py:93 and :114; fovsplat/train/loops.py:149, the
photometric step, :185 the HVS step, :189 and :200 the eval and HVS
views, :217 the score view; fovsplat/train/scratch.py:71 the scratch step
and :96 the significance pass; fovsplat/train/distill.py:37 the
teacher's render, fovsplat/eval/quality.py:76 and eval/layers.py:33, :51
the quality and layer renders, train/losses.py:65 SSIM,
eval/lpips_jax.py:36 LPIPS, models/vq.py:24 and :44 VQ's assignment and
EMA update, parallel/data_parallel.py:115 the DP step).

A Graph holds one captured graph of a function of tensors at a time,
keyed by the caller's static arguments (shapes, widths, capacities and
configs: what jax.jit treats as static) and by the shapes and types of
the arguments. The first call for a key:

  1. copies the arguments into static input buffers and runs the
     caller's `prepare` callback, if any, outside the sync-debug window:
     it fills the host-built tables a path reads (the HVS loss's
     resampling tables and pyramid filters), so that no host-to-device
     copy is left for the warm-up or the capture;
  2. runs the function WARMUPS times on a side stream under
     torch.cuda.set_sync_debug_mode("error"): the kernels are built and
     loaded there, csrc/common.cuh's resident_blocks fills its per-device
     cache (cudaFuncSetAttribute, the occupancy query) outside the
     capture, and any host synchronisation left on the path raises
     there, by name;
  3. captures one call with torch.cuda.graph, in a memory pool of its
     own.

Every call, the first included, then copies its arguments in (a python
number is filled into a 0-d static input), replays the graph and returns
clones of the static outputs: fresh tensors, as jax.jit returns fresh
arrays, so no call writes into a tensor that an earlier call returned. A
new key replaces the graph and frees its pool. A failed capture raises,
and a CPU tensor is refused: nothing runs eagerly in a graph's place.
The makers (eval/fps, eval/quality, eval/layers, train/loops,
train/scratch, parallel/data_parallel) return their eager functions for
the CPU, and graphed_fn and graphed_camera run CPU tensors eagerly.

Launch counters: each kernel wrapper counts its launches in Python
(ops/kernels.launch_counters), so a replay would not move them. A
capture's change of every counter is taken back (the captured kernels
did not run then) and added again on every replay; the warm-up's
launches did run, and stay counted.

Stage map and counts (utils/profiling): the capture runs inside
profiling.capturing, so every profiling.span inside the captured
function marks a stage boundary in nodes of the graph being captured.
Once the function returns, the graph's nodes are read in order. The
Graph's `record`, a profiling.GraphRecord of its key, then holds
`stages` (label, first operation, operations, their types), `nodes`
(the device operations a replay launches: kernels, copies and sets),
`bytes_in` (the static inputs that load copies into) and `bytes_out`
(the outputs that fresh_outputs clones), computed once from the static
shapes, and `serial`, its number. The process keeps every record after
its Graph is gone (profiling.RECORDS). Reading the nodes adds nothing
to the graph.

Spans: a Graph's own work runs in profiling.span ranges
fovsplat.graph.capture (warm-up and capture), fovsplat.graph.copy-in
(load), fovsplat.graph.replay#<serial> (the graph's launch) and
fovsplat.graph.clone (fresh_outputs). Off, each costs one check.
"""

from __future__ import annotations

import time

import torch
from torch.utils import _pytree

from fovsplat_torch.data.cameras import camera_tensors, camera_with_tensors
from fovsplat_torch.ops.kernels import launch_counters
from fovsplat_torch.utils import profiling

WARMUPS = 1
# The type of a 0-d static input that holds a python number.
_SCALAR_DTYPES = {int: torch.int64, float: torch.float32}


def _signature(arg):
    if torch.is_tensor(arg):
        if arg.device.type != "cuda":
            raise ValueError(f"a CUDA graph takes CUDA tensors; got a tensor "
                             f"on {arg.device}")
        return tuple(arg.shape), arg.dtype, arg.device
    if type(arg) not in _SCALAR_DTYPES:
        raise TypeError(f"a CUDA graph takes tensors and python numbers; got "
                        f"{type(arg).__name__}")
    return type(arg)


def _counts(counters):
    return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}


class Graph:
    """One CUDA graph at a time. Attributes: key (the captured key),
    captures, replays, capture_seconds (the last capture's wall time,
    warm-up included), launches_per_replay ({counter name: launches
    the graph holds}) and record (the captured key's
    profiling.GraphRecord, or None; the module docstring)."""

    def __init__(self):
        self.key = None
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.launches_per_replay = {}
        self.record = None
        self._counters = []     # (wrapper, attribute, launches a replay)
        self._graph = None
        self._inputs = ()
        self._outputs = []
        self._spec = None

    def __call__(self, key, fn, *args, prepare=None):
        """fn(*args) through the graph of `key`: args are CUDA tensors on
        one device and python numbers. fn is called only to warm up and
        capture, so it must compute the same function of its arguments
        for every call with this key. prepare() runs before a capture's
        warm-up, outside the sync-debug window (not on a replay)."""
        sig = (key, tuple(_signature(a) for a in args))
        if sig != self.key:
            self._capture(sig, fn, args, prepare)
        else:
            self.load(args)
        return self.replay()

    def load(self, args):
        """Copy the arguments into the static inputs."""
        with profiling.span("graph.copy-in"), torch.no_grad():
            for dst, src in zip(self._inputs, args):
                if torch.is_tensor(src):
                    dst.copy_(src)
                else:
                    dst.fill_(src)

    def replay(self):
        """Replay the graph on the current stream, count its launches and
        return fresh_outputs()."""
        with profiling.span("graph.replay", self.record.serial):
            self._graph.replay()
        self.replays += 1
        self.record.replays += 1
        for obj, attr, n in self._counters:
            setattr(obj, attr, getattr(obj, attr) + n)
        return self.fresh_outputs()

    def fresh_outputs(self):
        """Clones of the static outputs, in the structure fn returned."""
        with profiling.span("graph.clone"), torch.no_grad():
            return _pytree.tree_unflatten(
                [t.clone() if torch.is_tensor(t) else t
                 for t in self._outputs], self._spec)

    def _capture(self, sig, fn, args, prepare):
        with profiling.span("graph.capture"):
            self._capture_key(sig, fn, args, prepare)

    def _capture_key(self, sig, fn, args, prepare):
        # Drop the old graph first, so that its pool is freed.
        self.key, self._graph, self._inputs, self._outputs = None, None, (), []
        self.launches_per_replay, self._counters = {}, []
        self.record = None
        devs = {a.device for a in args if torch.is_tensor(a)}
        if len(devs) != 1:
            raise ValueError(f"a CUDA graph takes tensors on one device; got "
                             f"{sorted(map(str, devs))}")
        dev = devs.pop()
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            with torch.no_grad():
                inputs = tuple(
                    a.detach().clone() if torch.is_tensor(a) else
                    torch.full((), a, dtype=_SCALAR_DTYPES[type(a)],
                               device=dev) for a in args)
            if prepare is not None:
                prepare()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            mode = torch.cuda.get_sync_debug_mode()
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(WARMUPS):
                        fn(*inputs)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.current_stream(dev).wait_stream(side)
            counters = launch_counters()
            before = _counts(counters)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    with profiling.capturing(stream) as marks:
                        out = fn(*inputs)
                        stage_map = marks.finish()
            finally:
                after = _counts(counters)
                for name, (obj, attr) in counters.items():
                    setattr(obj, attr, before[name])
        self._outputs, self._spec = _pytree.tree_flatten(out)
        self._graph, self._inputs = graph, inputs
        self.launches_per_replay = {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}
        self._counters = [(*counters[k], n)
                          for k, n in self.launches_per_replay.items()]
        self.record = profiling.record_graph(sig, stage_map, inputs,
                                             self._outputs)
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0
        self.key = sig


def graphed_frame(render):
    """render(camera, gaze) -> dict of tensors, as one CUDA graph per
    camera (width, height); the camera's tensors and the gaze are static
    inputs. The returned frame(camera, gaze) has attributes `graph` (its
    Graph) and `eager` (render itself)."""
    graph = Graph()

    def frame(camera, gaze):
        def run(*ts):
            return render(camera_with_tensors(camera, ts[:-1]), ts[-1])
        return graph((camera.width, camera.height), run,
                     *camera_tensors(camera), gaze)

    frame.graph = graph
    frame.eager = render
    return frame


def graphed_camera(render):
    """render(camera) -> tensors, as one CUDA graph per camera (width,
    height): the camera's tensors are the static inputs. What render
    closes over (a model's tensors, fixed for the maker's life) is read
    by the graph where it lies, as jax.jit bakes a closure's arrays into
    its executable: nothing is copied in for it. A camera on the CPU runs
    render eagerly. The returned call(camera) has attributes `graph` and
    `eager` (render itself)."""
    graph = Graph()

    def call(camera):
        if camera.world_view.device.type == "cpu":
            return render(camera)
        return graph((camera.width, camera.height),
                     lambda *ts: render(camera_with_tensors(camera, ts)),
                     *camera_tensors(camera))

    call.graph = graph
    call.eager = render
    return call


def graphed_fn(fn, n_static: int = 0, prepare=None):
    """fn(*args) through one CUDA graph at a time: the last n_static
    arguments are static (they join the key and fix shapes, as jax.jit's
    static arguments), the others tensors and python numbers, the static
    inputs. Arguments whose first tensor lies on the CPU run fn eagerly.
    prepare(*args) runs before a capture's warm-up. The returned call has
    attributes `graph` and `eager` (fn)."""
    graph = Graph()

    def call(*args):
        cut = len(args) - n_static
        dyn, static = args[:cut], args[cut:]
        first = next(a for a in dyn if torch.is_tensor(a))
        if first.device.type == "cpu":
            return fn(*args)
        return graph(static, lambda *ts: fn(*ts, *static), *dyn,
                     prepare=(lambda: prepare(*args)) if prepare else None)

    call.graph = graph
    call.eager = fn
    return call
