"""From-scratch training at the published schedule on the CPU: the port's
densify event with no budget (train/scratch.densify_event,
models/densify.densify_every_candidate), its capacity growth
(models/state.grow, scratch.capacity_bucket) and a short schedule of
train_scratch, against the benchmark's plain reference
(benchmark/reference/scratch.py), on tiny forms of the
bicycle-3dgs-scratch configuration at 80x56.

Rows are matched by origin and kind, the reference's order: the port
writes new rows into dead rows of a fixed capacity, the reference
appends them and drops the rest. The row sets cloned, split and pruned
and every live row's Adam moments must be equal; parameters equal for
kept and cloned rows, within 1e-6 of the largest value for split
children (the port's rotation and the reference's build_rotation round
apart).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import camera as refcam
from benchmark.reference import scratch as ref
from benchmark.reference import train as rtrain
from benchmark.runners import scratch_loop as R
from benchmark.runners.frame_loop import program_cameras
from fovsplat_torch.models import densify as D
from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import FIELDS
from fovsplat_torch.ops import stats as stats_ops
from fovsplat_torch.train import loops, scratch
from tests.torch_cpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
W, H, VIEWS, SEED = 80, 56, 4, 2**31 + 29
EXTENT = 4.4
CPU = torch.device("cpu")


def _config(n_ps1=80, n=200):
    """The configuration at a tiny size: n_ps1 PS1 rows and split
    children up to n rows, 80x56."""
    cfg = json.loads((ROOT / "benchmark/configs/bicycle-3dgs-scratch.json")
                     .read_text())
    cfg["ps1_points"] = n_ps1
    cfg["frame"].update(points=n, width=W, height=H,
                        pair_capacity=1 << 15, compact_capacity=1 << 14)
    cfg["snapshot"]["dense_points"] = 3 * n
    return cfg


@pytest.fixture(scope="module")
def scene():
    cfg = _config()
    arrays = refcam.ring_arrays(2 * np.pi * np.arange(VIEWS) / VIEWS, W, H)
    raw = R.snapshot_raw(cfg, SEED, CPU)
    return {"cfg": cfg, "arrays": arrays,
            "gts": R.ground_truth(raw, arrays, cfg, CPU),
            "p0": R.perturbed(raw, cfg, SEED, CPU),
            "cams": program_cameras(arrays, W, H, CPU),
            "ref_cams": [refcam.ref_camera(arrays, i, W, H, CPU)
                         for i in range(VIEWS)]}


def _loop_config(cfg):
    lc, _ = R.program_step(cfg, CPU)
    return lc


def _scfg(cfg, **kw):
    return dataclasses.replace(R.schedule(cfg, scratch), **kw)


@pytest.fixture
def quantum64(monkeypatch):
    """Capacity buckets of 64 rows, so that a tiny cloud crosses them."""
    monkeypatch.setattr(scratch, "CAPACITY_QUANTUM", 64)


def _holed_state(p0, capacity, seed):
    """The rows of p0 at `capacity`, every 7th row dead, random Adam
    moments on the live rows (count 7000)."""
    st = S.from_params(R.program_state(p0).params, capacity)
    n = p0["xyz"].shape[0]
    kill = torch.zeros(capacity, dtype=torch.bool)
    kill[:n:7] = True
    g = torch.Generator().manual_seed(seed)

    def moments(x):
        m = torch.randn(x.shape, generator=g) * 1e-3
        live = st.live.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(live, m, torch.zeros_like(m))
    opt = dataclasses.replace(
        st.opt, mu={f: moments(v) for f, v in st.opt.mu.items()},
        nu={f: moments(v).abs() for f, v in st.opt.nu.items()},
        count=torch.tensor(7000, dtype=torch.int32))
    return S.prune_mask(dataclasses.replace(st, opt=opt), kill)


def _stats(state, seed):
    """Statistics of a pass on the live rows: counts 0-12, mean gradients
    log-normal about the threshold 2e-4 (about a third above it), largest
    radii 0-40 px."""
    g = torch.Generator().manual_seed(seed)
    c = state.capacity
    denom = torch.randint(0, 13, (c,), generator=g).float() * state.live
    mean = 2e-4 * torch.exp(torch.randn(c, generator=g) * 1.5 - 0.6)
    radii = torch.randint(0, 41, (c,), generator=g).float() * (denom > 0)
    return D.DensifyStats(grad_accum=mean * denom, denom=denom,
                          max_radii=radii)


def _snapshot(state):
    return [t.clone() for t in (*state.params.fields().values(),
                                *state.opt.mu.values(),
                                *state.opt.nu.values(), state.live)]


@pytest.mark.parametrize("case", ["fits", "grows", "before_reset"])
def test_event_matches_reference(scene, case, quantum64):
    """The port's event with no budget against reference/scratch.py's
    densify_and_prune on the same live rows, statistics and normals: the
    rows cloned, split and pruned, the live rows (kept, clones, both
    children of each split) with their Adam moments, nothing dropped,
    the capacity grown by the bucket rule only when the dead rows cannot
    hold the new rows, and the state given left as it was. The
    statistics' radii reach 40 px, yet no row is pruned for its screen
    radius: the statistics are reset before the prune, as published."""
    cfg, p0 = scene["cfg"], scene["p0"]
    n = p0["xyz"].shape[0]
    state = _holed_state(p0, 3 * n if case != "grows" else n + 8, SEED)
    stats = _stats(state, SEED + 1)
    it = 1000 if case == "before_reset" else 7100
    scfg = _scfg(cfg)
    noise = torch.randn((2, state.capacity, 3),
                        generator=torch.Generator().manual_seed(SEED + 2))
    before = _snapshot(state)
    new, dstats, ev = scratch.densify_event(state, stats, it, scfg, EXTENT,
                                            noise)
    for a, b in zip(before, _snapshot(state)):
        assert torch.equal(a, b)
    idx = torch.nonzero(state.live).reshape(-1)
    p = {f: getattr(state.params, f).detach()[idx] for f in FIELDS}
    adam = {"mu": {f: state.opt.mu[f][idx] for f in FIELDS},
            "nu": {f: state.opt.nu[f][idx] for f in FIELDS}, "count": 7000}
    want = R.reference_event(p, adam, {k: getattr(stats, k)[idx]
                                       for k in R.STATS},
                             noise[:, idx], cfg, it, torch.float32)
    got = R.program_event(state, new, ev.moves)
    gaps = R.event_gaps(got, want)
    assert gaps["rows_gap"] <= 1e-6, gaps
    assert {k: v for k, v in gaps.items() if k != "rows_gap"} == {
        "clone_rows_gap": 0, "split_rows_gap": 0, "prune_rows_gap": 0,
        "live_gap": 0, "adam_rows_gap": 0.0}
    assert torch.equal(got["keys"], want["keys"])
    kept = (got["keys"] % 4) < ref.CHILD0
    for f in FIELDS:
        assert torch.equal(got["rows"][f][kept], want["rows"][f][kept]), f
    n_clone, n_split = want["clone"].numel(), want["split"].numel()
    assert n_clone > 10 and n_split > 10 and want["pruned"].numel() > 0
    rows = state.params
    small = ((torch.sigmoid(rows.opacity.detach()[:, 0]) >= 0.005)
             & (rows.get_scaling().detach().amax(1) <= 0.1 * EXTENT))
    assert (state.live & small & (stats.max_radii > 20)).any()
    assert int(ev.cloned) == n_clone and int(ev.split) == n_split
    assert int(ev.dropped) == 0
    assert int(ev.pruned) == want["pruned"].numel()
    need = int(state.live.sum()) + n_clone + n_split
    if case == "grows":
        assert ev.capacity_after == scratch.capacity_bucket(need) \
            > ev.capacity_before
    else:
        assert ev.capacity_after == ev.capacity_before
    assert new.capacity == dstats.grad_accum.shape[0] == ev.capacity_after
    assert not dstats.grad_accum.any() and not dstats.max_radii.any()


@pytest.mark.parametrize("view", [0, 1])
def test_step_after_grow_matches_old_capacity(scene, view):
    """A scratch step of a grown state equals the same step at the old
    capacity on the old rows: the image, the loss, the gradients (as
    Adam's first moments hold them), the parameters and the statistics;
    the rows grown into stay dead, with zero moments and statistics. Both
    capacities are multiples of 64 rows, as the bucket rule's are: the
    CPU's vectorised loops then treat every old row alike (a row in a
    loop's scalar tail may round an exp or a root one ulp apart)."""
    cfg, p0 = scene["cfg"], scene["p0"]
    lc = _loop_config(cfg)
    small = _holed_state(p0, 256, SEED + 3)
    big = S.grow(small, 512)
    assert big.capacity == 512 and not big.live[256:].any()
    cam, gt = scene["cams"][view], scene["gts"][view]
    outs = []
    for st in (small, big):
        img = loops.render_state(st, cam, lc)["render"]
        st2, ds, aux = scratch.scratch_step(
            st, D.init_stats(st.capacity, CPU), cam, gt, 7001, 3, lc,
            _scfg(cfg))
        outs.append((img, st2, ds, aux))
    (i1, s1, d1, a1), (i2, s2, d2, a2) = outs
    c = small.capacity
    assert torch.equal(i1, i2)
    assert float(a1["loss"]) == float(a2["loss"])
    assert int(a2["nonfinite"]) == 0 and int(a2["overflow"]) == 0
    for f in FIELDS:
        assert torch.equal(getattr(s1.params, f), getattr(s2.params, f)[:c])
        assert torch.equal(s1.opt.mu[f], s2.opt.mu[f][:c])
        assert torch.equal(s1.opt.nu[f], s2.opt.nu[f][:c])
        assert not s2.opt.mu[f][c:].any() and not s2.opt.nu[f][c:].any()
        assert torch.equal(getattr(s2.params, f)[c:],
                           getattr(big.params, f)[c:])
    assert s1.opt.mu["xyz"].any()
    for k in R.STATS:
        assert torch.equal(getattr(d1, k), getattr(d2, k)[:c])
        assert not getattr(d2, k)[c:].any()


@pytest.mark.parametrize("past", ["capacity", "kept"])
def test_scratch_step_refuses_gid_row_bound(scene, past):
    """The scratch step's pair rows carry Gaussian ids as exact f32
    integers: a state or kept capacity of 2^24 or more is refused before
    any work."""
    lc = _loop_config(scene["cfg"])
    n = stats_ops.GID_EXACT if past == "capacity" else 16
    if past == "kept":
        lc = dataclasses.replace(lc, raster=dataclasses.replace(
            lc.raster, compact_capacity=stats_ops.GID_EXACT))
    rows = torch.zeros(1, 48).expand(n, 48)
    from fovsplat_torch.models.gaussians import GaussianParams
    params = GaussianParams(xyz=rows[:, :3], features_dc=rows[:, :3, None]
                            .reshape(n, 1, 3), features_rest=rows[:, :45]
                            .reshape(n, 15, 3), scaling=rows[:, :3],
                            rotation=rows[:, :4], opacity=rows[:, :1])
    st = S.TrainerState(params=params, opt=None,
                        live=torch.zeros(1, dtype=torch.bool).expand(n))
    with pytest.raises(ValueError, match="exact"):
        scratch.scratch_step(st, None, scene["cams"][0], scene["gts"][0],
                             1, 3, lc)


@pytest.mark.parametrize("rows,capacity", [
    (3_000_000, 4_194_304), (932_067, 1_048_576), (932_068, 2_097_152),
    (5_600_000, 7_340_032), (6_100_000, 7_340_032)])
def test_capacity_bucket(rows, capacity):
    """The published rule: the smallest multiple of 2^20 at or above
    1.125 times the rows."""
    assert scratch.capacity_bucket(rows) == capacity


def test_config_holds_its_rules():
    """bicycle-3dgs-scratch.json: its scene extent is getNerfppNorm's over
    the ring cameras, its capacity the bucket rule's for its live rows,
    its capacities under the f32 gid row's 2^24."""
    cfg = json.loads((ROOT / "benchmark/configs/bicycle-3dgs-scratch.json")
                     .read_text())
    fc, snap = cfg["frame"], cfg["snapshot"]
    v = cfg["train"]["views"]
    arrays = refcam.ring_arrays(2 * np.pi * np.arange(v) / v, fc["width"],
                                fc["height"])
    assert abs(ref.nerfpp_radius(arrays["cam_center"])
               - cfg["scene_extent"]) < 1e-6
    assert snap["live"] == fc["points"]
    assert scratch.capacity_bucket(snap["live"]) == snap["capacity"]
    assert max(snap["capacity"], fc["compact_capacity"]) \
        < stats_ops.GID_EXACT
    assert fc["pair_capacity"] % 65536 == fc["compact_capacity"] % 65536 \
        == 0


def test_pipeline_scratch_stage_starts_at_the_bucket(tmp_path):
    """run_pipeline with scratch_budget None starts the scratch stage at
    the bucket of the scene's points and trains it with no densify
    budget; the JAX-parity default keeps points x 1.3 x 8."""
    from fovsplat_torch import pipeline
    from tests.test_cli_pipeline import _build_scene
    scene_dir = _build_scene(str(tmp_path / "scene"), n_views=2, res=32)
    seen = []

    class Stop(Exception):
        pass

    def train(state, views, cfg, scfg, **kw):
        seen.append((state.capacity, int(state.live.sum()), scfg))
        raise Stop

    def bucket(rows):
        seen.append(rows)
        return rows + 40
    for budget in (None, 16384):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(scratch, "train_scratch", train)
            mp.setattr(scratch, "capacity_bucket", bucket)
            with pytest.raises(Stop):
                pipeline.run_pipeline(
                    scene_dir, str(tmp_path / f"out{budget}"),
                    cfg=pipeline.PipelineConfig(scratch_budget=budget),
                    device="cpu")
    (rows, (cap, live, scfg)), (cap2, live2, scfg2) = seen[:2], seen[2]
    assert live == rows and cap == rows + 40
    assert scfg.densify_budget is None and scfg2.densify_budget == 16384
    assert cap2 == int(live2 * 1.3 * 8)


# --- a short schedule -------------------------------------------------

SCHED = dict(iterations=300, densify_from=3000, densify_until=3076,
             densify_every=25, opacity_reset_every=100)
START = 3000      # the SH degree is 3 from iteration 3,000 on


def _slot_keys(pre_live, post, moves, slot_of_ref) -> dict:
    """{(reference row before an event, kind): the port's row after it},
    over the rows the port keeps live; slot_of_ref maps the reference's
    rows before the event to the port's."""
    ref_of_slot = {int(s): r for r, s in enumerate(slot_of_ref)}
    out = {(ref_of_slot[s], ref.KEPT): s
           for s in torch.nonzero(pre_live).reshape(-1).tolist()}
    for kind, src, dst in (
            (ref.CHILD1, moves["split_src"], moves["split_src"]),
            (ref.CLONE, moves["clone_src"], moves["clone_dst"]),
            (ref.CHILD0, moves["split_src"], moves["split_dst"])):
        for a, b in zip(src.tolist(), dst.tolist()):
            if kind == ref.CHILD1:      # the parent's row, replaced
                del out[(ref_of_slot[a], ref.KEPT)]
            out[(ref_of_slot[a], kind)] = b
    return {k: s for k, s in out.items() if bool(post.live[s])}


@pytest.fixture(scope="module")
def schedule_runs(scene):
    """train_scratch with no budget for 300 iterations from the tiny
    cloud (events at 3,025-3,100, every 25 iterations, an opacity reset
    every 100), and the reference's loop (ref.run_schedule) from the same
    rows with the same views and split normals: each event's normals
    drawn by the port for its rows, taken to the reference's rows through
    the rows' origin and kind. After each event the reference goes on
    from the port's rows, so that the two loops' rounding does not build
    up across events (an Adam step moves an entry of ~0 gradient by the
    sign of float noise); after the last, each runs on alone for 200
    iterations. The capacity starts at the bucket of the live rows, so
    the events grow it."""
    cfg, p0 = scene["cfg"], scene["p0"]
    n = p0["xyz"].shape[0]
    scfg = _scfg(cfg, **SCHED)
    lc = _loop_config(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scratch, "CAPACITY_QUANTUM", 64)
        cap = scratch.capacity_bucket(n)
    st = S.from_params(R.program_state(p0).params, cap)
    views = [type("View", (), {"camera": c, "image": g})
             for c, g in zip(scene["cams"], scene["gts"])]
    events, logs = [], []
    event = scratch.densify_event

    def recorded(state, dstats, it, sc, extent, noise):
        out = event(state, dstats, it, sc, extent, noise)
        events.append({"pre_live": state.live.clone(), "noise": noise,
                       "post": out[0], "ev": out[2],
                       "mean": D._mean_grads(dstats)[state.live]})
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scratch, "densify_event", recorded)
        mp.setattr(scratch, "CAPACITY_QUANTUM", 64)
        out = scratch.train_scratch(st, views, lc, scfg, scene_extent=EXTENT,
                                    start_iter=START, log=logs.append,
                                    seed=SEED % 1000)
    slot_of_ref = list(range(n))
    agree = []

    def noise_for(ref_events):
        return events[len(ref_events)]["noise"][:, slot_of_ref]

    def after_event(ref_events, p, adam):
        nonlocal slot_of_ref
        e = events[len(ref_events) - 1]
        keys = _slot_keys(e["pre_live"], e["post"], e["ev"].moves,
                          slot_of_ref)
        o = ref_events[-1]["out"]
        pairs = list(zip(o["origin"].tolist(), o["kind"].tolist()))
        agree.append(set(pairs) == set(keys))
        if not agree[-1]:
            return p, adam
        slot_of_ref = [keys[k] for k in pairs]
        post = e["post"]
        return ({f: getattr(post.params, f).detach()[slot_of_ref].clone()
                 for f in FIELDS},
                {"mu": {f: post.opt.mu[f][slot_of_ref] for f in FIELDS},
                 "nu": {f: post.opt.nu[f][slot_of_ref] for f in FIELDS},
                 "count": adam["count"]})

    sched = {**SCHED, "densify_grad_threshold": scfg.densify_grad_threshold,
             "percent_dense": scfg.percent_dense}
    p_ref, _, ref_events = ref.run_schedule(
        dict(p0), scene["ref_cams"], scene["gts"], sched, EXTENT,
        cfg["frame"], cfg["train"]["optim"], cfg["schedule"]["lambda_dssim"],
        START, SCHED["iterations"], SEED % 1000, noise_for,
        after_event=after_event)
    return {"port": out, "ref": p_ref, "events": events, "agree": agree,
            "ref_events": ref_events, "logs": logs, "lc": lc, "n": n}


def test_short_schedule_matches_reference(scene, schedule_runs):
    """Every event's live count as the reference loop's, nothing dropped,
    at least one capacity bucket crossed (each logged with its counts),
    the rows each event keeps the same (origin and kind), and the final
    image of the first view as the reference's: every pixel within 1e-2
    of the largest value, the mean gap within 1e-5 of it. After the last
    event each loop runs 225 iterations alone, and an Adam entry of ~0
    gradient moves by the sign of float noise, so a few pixels move by up
    to ~3e-3 of the largest value while the mean gap stays ~2e-6 of it.
    No mean gradient lies within 1e-3 relative of the threshold, where
    the two loops' rounding (up to ~2e-4 relative near it after 25 steps)
    could flip a selection."""
    r = schedule_runs
    assert len(r["events"]) == len(r["ref_events"]) == 3
    assert r["agree"] == [True] * 3
    for e, w in zip(r["events"], r["ref_events"]):
        assert int(e["post"].live.sum()) == w["live"]
        assert int(e["ev"].dropped) == 0
        assert not ((e["mean"] - 2e-4).abs() < 2e-7).any()
        assert int(e["ev"].cloned) > 0 and int(e["ev"].split) > 0
    assert any(e["ev"].capacity_after > e["ev"].capacity_before
               for e in r["events"])
    assert r["events"][-1]["post"].live.sum() > r["n"]
    lines = [ln for ln in r["logs"] if "densify live=" in ln]
    assert len(lines) == 3 and all("dropped=0" in ln and "capacity=" in ln
                                   for ln in lines)
    with torch.no_grad():
        img = loops.render_state(r["port"], scene["cams"][0],
                                 r["lc"])["render"]
        want, _ = rtrain.render(r["ref"], scene["ref_cams"][0],
                                scene["cfg"]["frame"])
    gap, top = (img - want).abs(), float(want.abs().max())
    assert float(gap.max()) <= 1e-2 * top
    assert float(gap.mean()) <= 1e-5 * top
