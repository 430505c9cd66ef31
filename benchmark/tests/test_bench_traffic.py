"""The traffic and the weights are drawn from the seed: the same seed
gives the same inputs, and every seed the same set of sizes in another
order."""

import numpy as np
import torch

from benchmark import harness
from benchmark.runners import frame_loop, train_loop
from benchmark.reference import proxy
from conftest import ROOT

PNUM = [1161358, 465471, 252678, 202263]


def test_gaze_trace_is_deterministic_in_the_seed():
    mix = harness.load_cell(ROOT, "ours-gaze-trace").traffic
    a, b = frame_loop.trace(mix, 2**31 + 5), frame_loop.trace(mix, 2**31 + 5)
    c = frame_loop.trace(mix, 2**31 + 6)
    assert np.array_equal(a["gazes"], b["gazes"])
    assert np.array_equal(a["angles"], b["angles"])
    assert not np.array_equal(a["gazes"], c["gazes"])
    F = mix["trace_frames"]
    assert a["gazes"].shape == (F, 2) and a["angles"].shape == (F,)
    assert a["gazes"].min() >= 0.0 and a["gazes"].max() <= 1.0
    lo, hi = mix["head"]["speed_deg_s"]
    step = np.degrees(np.diff(a["angles"])) * mix["head"]["trace_hz"]
    assert step.min() >= lo - 1e-9 and step.max() <= hi + 1e-9
    # Same set of head speeds over any seed's first blocks.
    sc = np.sort(np.round(np.degrees(np.diff(c["angles"])), 9))
    assert abs(np.mean(step) - np.mean(sc * mix["head"]["trace_hz"])) < 1.0
    assert frame_loop.sample_frames(mix, a, 9) == \
        frame_loop.sample_frames(mix, b, 9)
    assert frame_loop.profiled_frames(mix, 9) == \
        frame_loop.profiled_frames(mix, 9)


def test_orbit_has_no_gaze_and_the_same_head_path_rule():
    mix = harness.load_cell(ROOT, "ps1-frame-orbit").traffic
    t = frame_loop.trace(mix, 3)
    assert np.all(t["gazes"] == 0.5)
    assert np.array_equal(t["angles"], frame_loop.trace(mix, 3)["angles"])


def test_proxy_is_deterministic_and_holds_the_same_values_for_any_seed():
    a = proxy.bicycle_proxy(4000, 2**31 + 1, "cpu", PNUM)
    b = proxy.bicycle_proxy(4000, 2**31 + 1, "cpu", PNUM)
    c = proxy.bicycle_proxy(4000, 2**31 + 2, "cpu", PNUM)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["means"], c["means"])
    # Every seed: the same Gaussians in another order, the level counts
    # those of the ladder.
    for k in a:
        rows = lambda t: t.reshape(4000, -1)               # noqa: E731
        assert torch.equal(torch.unique(rows(a[k]), dim=0),
                           torch.unique(rows(c[k]), dim=0)), k
    counts = torch.bincount(a["highest_levels"].long()).tolist()
    want = [round(4000 * p) for p in proxy.hl_probs(PNUM)]
    assert all(abs(x - y) <= 1 for x, y in zip(counts, want))
    assert bool(torch.isfinite(a["scales"]).all())


def test_view_stack_draws_epochs_without_replacement():
    s = train_loop.ViewStack(8, 5)
    first = [s.pop() for _ in range(8)]
    assert sorted(first) == list(range(8))
    again = train_loop.ViewStack(8, 5)
    assert [again.pop() for _ in range(8)] == first
    assert train_loop.derived_seed(2**31 + 9, 3) == \
        train_loop.derived_seed(2**31 + 9, 3)
