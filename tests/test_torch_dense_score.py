"""The metric-prune score pass on a tiny dense proxy: the port's CPU path
(train/loops.make_score_fn, metric_prune_scores, models/state.
metric_prune) against the benchmark's plain reference
(benchmark/reference/score.py), the dense proxy's rows
(benchmark/reference/dense.py), the score route's overflow count, its
bound on the f32 Gaussian-id row and its two forms of the SH; and the
fetched-pair count's plain version (kernel 14's twin) against the JAX
package's fused-route count on edge tiles."""

import dataclasses
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import camera as refcam
from benchmark.reference import dense
from benchmark.reference import proxy as bproxy
from benchmark.reference import score as ref
from benchmark.runners.frame_loop import program_cameras
from fovsplat.ops import stats as jstats
from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import GaussianParams
from fovsplat_torch.ops import stats
from fovsplat_torch.ops.blend import tile_inside_mask
from fovsplat_torch.ops.kernels import fetch_count as fc
from fovsplat_torch.ops.kernels.project_sh import sh_tensor
from fovsplat_torch.ops.rasterize import RasterizeConfig
from fovsplat_torch.train import loops
from tests.test_torch_cuda import (FETCH_CAP, FETCH_CASES, FETCH_GRID,
                                   FETCH_N, fetch_case)
from tests.torch_cpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
W, H, VIEWS, SEED = 80, 56, 3, 2**31 + 11
MODE = "loss_weighted_max_count"


def _config(n_ps1=1000, n=5250):
    """The cell's configuration at a tiny size: n_ps1 PS1 rows and their
    split children up to n rows, 80x56."""
    cfg = json.loads((ROOT / "benchmark/configs/bicycle-3dgs-dense.json")
                     .read_text())
    cfg["ps1_points"] = n_ps1
    cfg["frame"].update(points=n, width=W, height=H,
                        pair_capacity=1 << 16, compact_capacity=1 << 15)
    return cfg


def _loop_config(fc, pair_capacity=None):
    cap = pair_capacity or fc["pair_capacity"]
    return loops.LoopConfig(raster=RasterizeConfig(
        pair_capacity=cap, compact_capacity=min(cap, fc["compact_capacity"]),
        power_cutoff=fc["power_cutoff"]))


def _state(p0):
    return S.from_params(GaussianParams(**{f: v.clone()
                                           for f, v in p0.items()}))


def _views(n):
    arrays = refcam.ring_arrays(2 * np.pi * np.arange(n) / n, W, H)
    return arrays, program_cameras(arrays, W, H, torch.device("cpu"))


@pytest.fixture(scope="module")
def dense_pass():
    """The port's score views, pass and cut, and the reference's, on the
    tiny dense proxy over three ring views."""
    cfg = _config()
    fc = cfg["frame"]
    p0 = dense.dense_raw(cfg, SEED, "cpu")
    st = _state(p0)
    lc = _loop_config(fc)
    arrays, cams = _views(VIEWS)
    score_view = loops.make_score_fn(lc, device="cpu")
    seen = []

    def view(state, camera):
        seen.append(score_view(state, camera))
        return seen[-1]
    best, overflow = loops.metric_prune_scores(
        st, [types.SimpleNamespace(camera=c) for c in cams], view)
    p = st.params
    per_view = []
    for cam, (scores, ovf) in zip(cams, seen):
        o = stats.rasterize_stats(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(), cam,
            shs=p.get_features(), mode=MODE,
            loss_map=torch.ones((H, W)), config=lc.raster,
            live_mask=st.live)
        per_view.append((o["gs_count"], o["contribs"], scores, ovf))
    cut = S.metric_prune(st, best, cfg["prune"]["prune_ratio"])
    want = ref.score_pass(
        p0, [refcam.ref_camera(arrays, i, W, H, "cpu") for i in range(VIEWS)],
        fc, cfg["prune"]["prune_ratio"])
    return {"views": per_view, "max": best, "overflow": overflow,
            "kill": st.live & ~cut.live, "want": want}


@pytest.mark.parametrize("case", ["view0", "view1", "view2", "pass"])
def test_dense_score_matches_reference(dense_pass, case):
    """Each view's gs_count and contribs exactly, its max_comp_efficiency
    within 1e-6 relative; the pass's max over the views and the rows its
    2% cut kills, as the reference's."""
    d, want = dense_pass, dense_pass["want"]
    if case == "pass":
        torch.testing.assert_close(d["max"], want["max"], rtol=1e-6, atol=0)
        assert int(d["overflow"]) == 0
        assert torch.equal(d["kill"], want["kill"])
        assert int(d["kill"].sum()) == int(want["max"].shape[0] * 0.02)
        return
    gs, contribs, scores, overflow = d["views"][int(case[-1])]
    w_gs, w_contribs, work = want["views"][int(case[-1])]
    assert int(overflow) == 0 and work["kept"] > 1000
    assert torch.equal(gs.long(), w_gs)
    assert torch.equal(contribs, w_contribs)
    assert int((contribs > 0).sum()) > 100
    torch.testing.assert_close(scores, ref.efficiency(w_gs, w_contribs),
                               rtol=1e-6, atol=0)


def test_dense_proxy_rows():
    """The first rows are the PS1 proxy of the same seed; the rest are
    split children (the parent's scale / 1.6, its rotation and SH, an
    opacity above the floor); the row count is the configuration's; a
    seed only orders the rows."""
    cfg = _config()
    n_ps1, n = cfg["ps1_points"], cfg["frame"]["points"]
    p0 = dense.dense_raw(cfg, SEED, "cpu")
    assert all(v.shape[0] == n for v in p0.values())
    ps1 = bproxy.train_raw(bproxy.bicycle_proxy(n_ps1, SEED, "cpu",
                                                cfg["pnum"]))
    for f, v in ps1.items():
        assert torch.equal(p0[f][:n_ps1], v), f
    cloud = bproxy._cloud(n_ps1, torch.device("cpu"), cfg["pnum"], 0.45)
    kids = dense.split_children(cloud, n - n_ps1, "cpu", cfg["children"])
    par = kids["parent"]
    torch.testing.assert_close(torch.exp(kids["scaling"]),
                               cloud["scales"][par] / 1.6, rtol=1e-6, atol=0)
    assert torch.equal(kids["rotation"], cloud["rotations"][par])
    assert torch.equal(kids["features_rest"], cloud["shs_rest"][par])
    floor = float(np.log(0.005 / 0.995))
    assert float(kids["opacity"].min()) >= floor - 1e-6
    assert float(torch.sigmoid(kids["opacity"]).median()) < 0.1
    other = dense.dense_raw(cfg, SEED + 1, "cpu")

    def rows(q):
        # Ordered by the position's x, then its y.
        r = torch.cat([q[f].reshape(n, -1) for f in sorted(q)], 1)
        r = r[torch.argsort(q["xyz"][:, 1], stable=True)]
        return r[torch.argsort(r[:, -3], stable=True)]
    assert not torch.equal(other["xyz"], p0["xyz"])
    assert torch.equal(rows(other), rows(p0))


def test_score_pass_counts_overflow():
    """A pair capacity the views spill: each view reports its overflow,
    the pass their sum, and ScoreWatch logs the pass and counts it."""
    cfg = _config(n_ps1=500, n=2500)
    st = _state(dense.dense_raw(cfg, SEED, "cpu"))
    _, cams = _views(2)
    view = loops.make_score_fn(_loop_config(cfg["frame"], 1 << 11),
                               device="cpu")
    each = [int(view(st, c)[1]) for c in cams]
    views = [types.SimpleNamespace(camera=c) for c in cams]
    _, total = loops.metric_prune_scores(st, views, view)
    assert min(each) > 0 and int(total) == sum(each)
    logs = []
    watch = loops.ScoreWatch(views, view, logs.append)
    watch.scores(st)
    assert (watch.passes, watch.overflowed) == (1, 1)
    assert len(logs) == 1 and f"{sum(each)} pairs" in logs[0]


@pytest.mark.parametrize("past", ["gaussians", "kept"])
def test_gid_row_bound_raises(past):
    """The fused stats route sorts Gaussian ids as an f32 row: it refuses
    more than 2^24 Gaussians or kept pairs before any work."""
    n = stats.GID_EXACT + 1 if past == "gaussians" else 16
    cam = _views(1)[1][0]
    rows = torch.zeros(1, 4).expand(n, 4)
    cfg = RasterizeConfig(pair_capacity=1 << 12, compact_capacity=(
        stats.GID_EXACT + 1 if past == "kept" else None))
    with pytest.raises(ValueError, match="exact up to"):
        stats.rasterize_stats(rows[:, :3], rows[:, :3], rows, rows[:, 0],
                              cam, colors=rows[:, :3], config=cfg)


@pytest.mark.parametrize("mode", stats.MODES)
@pytest.mark.parametrize("backend", ["kernels", "xla"])
def test_sh_pair_matches_one_tensor(backend, mode):
    """rasterize_stats with the model's SH pair (features_dc,
    features_rest) and with sh_tensor of it, one (N, 16, 3) tensor: every
    output bit for bit, on the kernel route (its plain twin on the CPU)
    and on the XLA route, over the dense proxy's split children with
    every fifth row dead."""
    cfg = _config(n_ps1=500, n=2500)
    p = _state(dense.dense_raw(cfg, SEED, "cpu")).params
    live = torch.arange(p.num_points) % 5 != 2
    cam = _views(1)[1][0]
    raster = dataclasses.replace(_loop_config(cfg["frame"]).raster,
                                 backend=backend)
    loss_map = torch.rand((H, W), generator=torch.Generator().manual_seed(1))
    pair = (p.features_dc, p.features_rest)
    a, b = [stats.rasterize_stats(
        p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(), cam,
        shs=shs, mode=mode, loss_map=loss_map, config=raster,
        live_mask=live) for shs in (pair, sh_tensor(pair))]
    for k in ("render", "final_T", "gs_count", "contribs", "radii"):
        assert torch.equal(a[k], b[k]), k
    assert int(a["binned"].num_pairs) == int(b["binned"].num_pairs) > 1000
    assert int(a["binned"].overflow) == 0
    assert int((a["contribs"] > 0).sum()) > 100
    assert not bool(a["radii"][~live].any())


@pytest.fixture(scope="module")
def jax_fetch_counts():
    """The JAX package's fetch-time gs_count of its fused route
    (fovsplat/ops/stats.py:285-302: tile_fetch_counts, each lane's tile by
    a boundary scatter and a cumsum, a segment_sum of the fetched lanes)
    on every fetch_case, one compile for all of them."""
    gx, gy = FETCH_GRID
    T = gx * gy

    @jax.jit
    def count(first_trig, seg_start, inside, pair_gauss):
        nf = jstats.tile_fetch_counts(first_trig, seg_start, inside, T)
        lane = jnp.arange(FETCH_CAP, dtype=jnp.int32)
        in_use = lane < seg_start[T]
        gid = jnp.where(in_use, pair_gauss, FETCH_N)
        marks = jnp.zeros(FETCH_CAP, jnp.int32).at[seg_start[1:T]].add(
            1, mode="drop")
        t_all = jnp.minimum(jnp.cumsum(marks), T - 1).astype(jnp.int32)
        fetched = in_use & ((lane - seg_start[t_all]) < nf[t_all])
        return jax.ops.segment_sum(
            fetched.astype(jnp.int32), jnp.where(fetched, gid, FETCH_N),
            num_segments=FETCH_N + 1)[:FETCH_N]
    out = {}
    for case in FETCH_CASES:
        ft, seg, gauss, w, h = fetch_case(case)
        inside = jstats.tile_inside_mask(gx, gy, w, h)
        out[case] = np.asarray(count(jnp.asarray(ft, jnp.float32),
                                     jnp.asarray(seg), inside,
                                     jnp.asarray(gauss)))
    return out


@pytest.mark.parametrize("case", FETCH_CASES)
def test_fetch_count_plain_matches_jax(jax_fetch_counts, case):
    """fetch_count on CPU tensors (its plain version) against the JAX
    package's gs_count on each edge case of fetch_case, exactly: tiles
    without an inside pixel, pixels that never freeze, fetch points past
    a segment's end and on round edges, empty segments, lanes past
    num_pairs, padding pixels; and each case's own tiles stop where the
    case puts their fetch points."""
    ft, seg, gauss, w, h = fetch_case(case)
    lane = np.arange(FETCH_CAP)
    gid = np.where(lane < seg[-1], gauss, FETCH_N).astype(np.int32)
    got = fc.fetch_count(torch.from_numpy(ft), torch.from_numpy(seg),
                         torch.from_numpy(gid), FETCH_N, FETCH_GRID[0], w, h)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_fetch_counts[case])
    nf = fc.tile_fetch_counts(
        torch.from_numpy(ft).float(), torch.from_numpy(seg),
        tile_inside_mask(FETCH_GRID[0], FETCH_GRID[1], w, h)).numpy()
    seg_len = np.diff(seg)
    # Each case's tiles: their fetch points as the case sets them.
    want = {"no_inside": ([4, 9, 14, 19], 0),
            "never": ([0, 7, 12], seg_len[[0, 7, 12]]),
            "past_end": ([3, 8], [300, 257]),
            "rounds": ([1, 2, 6, 11, 13], [256, 256, 512, 512, 768]),
            "empty": ([0, 5, 6, 19], 0),
            "padding": ([4, 19], np.minimum(seg_len[[4, 19]], 256))}
    if case in want:
        tiles, nfs = want[case]
        np.testing.assert_array_equal(nf[tiles], nfs)
    assert 0 < int(got.sum()) < int((gid < FETCH_N).sum())
    assert (nf < seg_len).any()
    if case == "past_num_pairs":
        assert FETCH_CAP - seg[-1] >= 3000
        assert (gauss[seg[-1]:] < FETCH_N).any()
