"""The port's densification and from-scratch training against the JAX
package, on the CPU.

The same numpy inputs go through fovsplat (JAX on the CPU: the XLA route,
or Pallas in interpret mode for the offset gradient) and through
fovsplat_torch with CPU tensors, where every kernel wrapper runs its
plain version. The split's normal samples are JAX's own draw, passed to
the port. Live masks, placed rows and dropped counts must be exact;
densify outputs within 1e-6; gradients and steps at
tests/test_torch_train.py's tolerance (scaled by the largest value, rtol
2e-3, atol 2e-4). Each JAX loop runs once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.models import densify as jdens
from fovsplat.models import gaussians as jgauss
from fovsplat.models import state as jstate
from fovsplat.ops import dense as jdense
from fovsplat.ops import rasterize as jrast
from fovsplat.train import loops as jloops
from fovsplat.train import optim as joptim
from fovsplat.train import scratch as jscratch
from fovsplat_torch import convert
from fovsplat_torch.models import densify as tdens
from fovsplat_torch.models import state as tstate
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.train import optim as toptim
from fovsplat_torch.train import scratch as tscratch
from tests.test_torch_train import FIELDS, tcam
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

STEP_RTOL, STEP_ATOL = 2e-3, 2e-4


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _states(raw, capacity):
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    jst = jstate.from_params(jgauss.GaussianParams(
        **{k: jnp.asarray(v) for k, v in raw.items()}), capacity)
    tst = tstate.from_params(convert.params_from_numpy(**raw, device="cpu"),
                             capacity)
    return jst, tst


def _same_state(ts, js, rtol=1e-6, atol=1e-6):
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts.params, f).detach().numpy(),
                                   np.asarray(getattr(js.params, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
        np.testing.assert_array_equal(ts.opt.mu[f].numpy(),
                                      np.asarray(getattr(js.opt.mu, f)))
        np.testing.assert_array_equal(ts.opt.nu[f].numpy(),
                                      np.asarray(getattr(js.opt.nu, f)))


def _densify_case(n, capacity, seed, extent=4.0):
    """n live rows in a capacity with dead rows between live ones, random
    Adam moments, and statistics whose mean gradients tie exactly in
    groups (priority ties), half of them above the threshold 2e-4; half
    the rows are larger than percent_dense * extent."""
    rng = np.random.default_rng(seed)
    raw = dict(xyz=rng.normal(size=(n, 3)),
               features_dc=rng.normal(size=(n, 1, 3)),
               features_rest=rng.normal(0, 0.1, (n, 15, 3)),
               scaling=np.log(rng.choice([0.01, 0.08], n)[:, None]
                              * rng.uniform(0.5, 1.5, (n, 3))),
               rotation=rng.normal(size=(n, 4)),
               opacity=rng.normal(size=(n, 1)))
    jst, tst = _states(raw, capacity)
    kill = np.zeros(capacity, bool)
    kill[rng.choice(n, n // 8, replace=False)] = True
    moments = {f: rng.normal(size=np.shape(getattr(jst.params, f))).astype(
        np.float32) for f in FIELDS}
    jst = jstate.prune_mask(dataclasses.replace(jst, opt=joptim.AdamState(
        mu=jgauss.GaussianParams(**{f: jnp.asarray(v)
                                    for f, v in moments.items()}),
        nu=jgauss.GaussianParams(**{f: jnp.asarray(np.abs(v))
                                    for f, v in moments.items()}),
        count=jnp.int32(5))), jnp.asarray(kill))
    tst = tstate.TrainerState(
        params=tst.params, live=torch.from_numpy(np.array(jst.live)),
        opt=toptim.AdamState(
            mu={f: t(getattr(jst.opt.mu, f)) for f in FIELDS},
            nu={f: t(getattr(jst.opt.nu, f)) for f in FIELDS},
            count=torch.tensor(5, dtype=torch.int32)))
    denom = rng.integers(0, 6, capacity).astype(np.float32)
    level = rng.choice([1e-4, 3e-4, 5e-4, 7e-4], capacity)
    accum = (level * np.maximum(denom, 1)).astype(np.float32)
    radii = rng.integers(0, 40, capacity).astype(np.float32)
    js = jdens.DensifyStats(grad_accum=jnp.asarray(accum),
                            denom=jnp.asarray(denom),
                            max_radii=jnp.asarray(radii))
    ts = convert.densify_stats_from_numpy(accum, denom, radii, device="cpu")
    return jst, tst, js, ts, extent


def test_accumulate_matches_jax():
    rng = np.random.default_rng(0)
    c = 500
    g = rng.normal(0, 3.0, (c, 2)).astype(np.float32)
    radii = rng.integers(0, 5, c).astype(np.int32)
    base = [rng.random(c).astype(np.float32) for _ in range(3)]
    js = jdens.accumulate(jdens.DensifyStats(*map(jnp.asarray, base)),
                          jnp.asarray(g), jnp.asarray(radii), 96, 64)
    ts = tdens.accumulate(convert.densify_stats_from_numpy(*base,
                                                           device="cpu"),
                          t(g), torch.from_numpy(radii), 96, 64)
    for f in ("grad_accum", "denom", "max_radii"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   err_msg=f)
    z = tdens.init_stats(7, device="cpu")
    assert z.grad_accum.shape == (7,) and not z.denom.any()


@pytest.mark.parametrize("case", ["room", "budget", "capacity_out"])
def test_place_rows_matches_jax(case):
    """Candidates ranked by priority with exact ties, into the first dead
    slots: the same candidate lanes, placements and dropped count."""
    n, cap, budget = {"room": (120, 400, 200), "budget": (120, 400, 17),
                      "capacity_out": (150, 170, 64)}[case]
    jst, tst, js, ts, _ = _densify_case(n, cap, seed=1)
    grads_j = js.grad_accum / jnp.maximum(js.denom, 1.0)
    want_j = jst.live & (grads_j >= 2e-4)
    grads_t = ts.grad_accum / torch.clamp(ts.denom, min=1.0)
    want_t = tst.live & (grads_t >= 2e-4)
    src = {f: getattr(tst.params, f).detach() for f in FIELDS}
    js2, cj, pj, dj = jdens._place_rows(jst, jst.params, grads_j, want_j,
                                        budget)
    ts2, ct, pt, dt = tdens._place_rows(tst, src, grads_t, want_t, budget)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ct.numpy()[pt.numpy()],
                                  np.asarray(cj)[np.asarray(pj)])
    assert int(dt) == int(dj)
    if case == "room":
        assert int(dt) == 0
    else:
        assert int(dt) > 0
    _same_state(ts2, js2, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["room", "capacity_out"])
def test_densify_and_prune_match_jax(case):
    """Clone, then split with JAX's noise, then the size prune and the
    opacity reset, as one densify event runs them."""
    n, cap, budget = {"room": (160, 480, 128),
                      "capacity_out": (160, 190, 64)}[case]
    jst, tst, js, ts, extent = _densify_case(n, cap, seed=2)
    jc, djc = jdens.densify_and_clone(jst, js, 2e-4, extent, 0.01, budget)
    tc, dtc = tdens.densify_and_clone(tst, ts, 2e-4, extent, 0.01, budget)
    _same_state(tc, jc)
    assert int(dtc) == int(djc)
    grown = int(tc.live.sum()) - int(tst.live.sum())
    assert grown > 10
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, (2, cap, 3))
    jsp, djs = jdens.densify_and_split(jc, js, 2e-4, extent, 0.01, budget,
                                       key=key)
    tsp, dts = tdens.densify_and_split(tc, ts, 2e-4, extent, 0.01, budget,
                                       noise=t(noise))
    _same_state(tsp, jsp)
    assert int(dts) == int(djs)
    assert int(tsp.live.sum()) > int(tc.live.sum())
    if case == "capacity_out":
        assert int(dtc) + int(dts) > 0 and bool(tsp.live.all())
    else:
        assert int(dtc) + int(dts) == 0
    for mss in (None, 20.0):
        _same_state(tdens.prune_oversized(tsp, ts, mss, extent),
                    jdens.prune_oversized(jsp, js, mss, extent))
    pruned = tdens.prune_oversized(tsp, ts, 20.0, extent)
    assert int(pruned.live.sum()) < int(tsp.live.sum())
    _same_state(tdens.reset_opacity(tsp, 0.01),
                jdens.reset_opacity(jsp, 0.01))


def test_optimizer_row_surgery_matches_jax():
    jst, tst, _, _, _ = _densify_case(50, 64, seed=4)
    idx = np.array([5, 0, 63, 5, 20])
    js = joptim.select_rows(jst.opt, jnp.asarray(idx))
    ts = toptim.select_rows(tst.opt, torch.from_numpy(idx))
    jc = joptim.concat_rows(jst.opt, 7)
    tc = toptim.concat_rows(tst.opt, 7)
    for a, b in ((ts, js), (tc, jc)):
        for f in FIELDS:
            np.testing.assert_array_equal(a.mu[f].numpy(),
                                          np.asarray(getattr(b.mu, f)))
            np.testing.assert_array_equal(a.nu[f].numpy(),
                                          np.asarray(getattr(b.nu, f)))
        assert int(a.count) == int(b.count)
    assert tc.mu["features_rest"].shape == (71, 15, 3)


# -------------------------------------------------- the offset gradient

def test_mean2d_offset_gradient_matches_jax_fused_route():
    """The gradient of a loss w.r.t. mean2d_offset: the port's fused
    train route (kernel 7 sums the pair rows' mx / my cotangents) against
    JAX's fused train route (Pallas, interpret mode)."""
    means, scales, quats, ops_, colors = synthetic_cloud(n=220, seed=33)
    cam = make_test_camera(width=80, height=64)
    target = np.full((64, 80, 3), 0.3, np.float32)
    off0 = np.random.default_rng(5).normal(0, 0.3, (220, 2)).astype(
        np.float32)
    jcfg = jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256,
                                 backend="pallas", pallas_chunk=128,
                                 pallas_interpret=True)

    def jloss(off, m):
        out = jrast.rasterize(m, jnp.asarray(scales), jnp.asarray(quats),
                              jnp.asarray(ops_), cam,
                              colors=jnp.asarray(colors), config=jcfg,
                              mean2d_offset=off)
        return jnp.mean((out["render"] - target) ** 2)

    g_off_j, g_m_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(off0), jnp.asarray(means))
    off = t(off0).requires_grad_(True)
    m = t(means).requires_grad_(True)
    out = trast.rasterize(m, t(scales), t(quats), t(ops_), tcam(cam),
                          colors=t(colors),
                          config=trast.RasterizeConfig(pair_capacity=1 << 13),
                          mean2d_offset=off)
    torch.mean((out["render"] - torch.from_numpy(target)) ** 2).backward()
    for name, a, b in (("offset", g_off_j, off.grad), ("means", g_m_j,
                                                        m.grad)):
        a = np.asarray(a)
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b.numpy() / scale, a / scale,
                                   rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=name)
    assert (np.abs(np.asarray(g_off_j)) > 0).sum() > 100


# ------------------------------------------------- scratch steps and loop

@dataclasses.dataclass
class _View:
    camera: object
    image: np.ndarray


@pytest.fixture(scope="module")
def scene():
    """160 Gaussians seen by 4 cameras at 64x64 (ground truth from the
    dense oracle); the model starts from create_from_points on the
    cloud's centres and colours, capacity 400."""
    means, scales, quats, ops_, colors = synthetic_cloud(n=160, seed=9)
    cams = [make_test_camera(width=64, height=64, dist=d, fov=f)
            for d, f in ((4.0, 0.9), (4.4, 0.85), (3.8, 1.0), (4.2, 0.95))]
    jviews = [_View(c, np.asarray(jdense.render_dense(
        means, scales, quats, ops_, colors, c,
        bg_color=jnp.zeros(3))["render"])) for c in cams]
    tviews = [_View(tcam(v.camera), v.image) for v in jviews]
    p = jgauss.create_from_points(means, colors)
    raw = {f: np.asarray(getattr(p, f)) for f in FIELDS}
    jst, tst = _states(raw, 400)
    jcfg = jloops.LoopConfig(
        raster=jrast.RasterizeConfig(pair_capacity=1 << 13, chunk=256),
        optim=joptim.OptimConfig(position_lr_max_steps=200))
    tcfg = tloops.LoopConfig(
        raster=trast.RasterizeConfig(pair_capacity=1 << 13),
        optim=toptim.OptimConfig(position_lr_max_steps=200))
    return dict(jviews=jviews, tviews=tviews, jst=jst, tst=tst, jcfg=jcfg,
                tcfg=tcfg)


def _close_scaled(a, b, rtol=STEP_RTOL, atol=STEP_ATOL, msg=""):
    b = np.asarray(b)
    scale = np.abs(b).max()
    assert scale > 0, msg
    np.testing.assert_allclose(np.asarray(a) / scale, b / scale, rtol=rtol,
                               atol=atol, err_msg=msg)


def test_scratch_steps_match_jax(scene):
    """Three scratch steps at SH degree 1 from the same state: losses,
    first moments, the densification statistics and the parameters."""
    s = scene
    jstep = jscratch.make_scratch_step(s["jcfg"], 1)
    tstep = tscratch.make_scratch_step(s["tcfg"], device="cpu")
    jst, tst = s["jst"], s["tst"]
    jd = jdens.init_stats(400)
    td = tdens.init_stats(400, device="cpu")
    for i in range(3):
        jv, tv = s["jviews"][i], s["tviews"][i]
        jst, jd, jaux = jstep(jst, jd, jv.camera, jnp.asarray(jv.image),
                              jnp.int32(i + 1))
        tst, td, taux = tstep(tst, td, tv.camera, t(tv.image), i + 1, 1)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
        assert int(taux["nonfinite"]) == int(jaux["nonfinite"]) == 0
        assert int(taux["overflow"]) == 0
    for f in FIELDS:
        _close_scaled(tst.opt.mu[f].numpy(), getattr(jst.opt.mu, f), msg=f)
        mu = np.asarray(getattr(jst.opt.mu, f))
        big = np.abs(mu) > 1e-2 * np.abs(mu).max()
        np.testing.assert_allclose(
            getattr(tst.params, f).detach().numpy()[big],
            np.asarray(getattr(jst.params, f))[big], rtol=0, atol=1e-5,
            err_msg=f)
    _close_scaled(td.grad_accum.numpy(), jd.grad_accum, msg="grad_accum")
    np.testing.assert_array_equal(td.denom.numpy(), np.asarray(jd.denom))
    np.testing.assert_array_equal(td.max_radii.numpy(),
                                  np.asarray(jd.max_radii))
    assert float(td.denom.max()) == 3.0


SCRATCH = dict(iterations=20, densify_from=4, densify_every=5,
               densify_until=12, opacity_reset_every=10, sh_up_every=15,
               prune_iterations=(18,), prune_percent=0.1,
               densify_grad_threshold=2e-6, densify_budget=64)
# The knn-initialised scales (0.3-1.0) put the mean gradients at ~1e-7 to
# ~6e-6, so the threshold sits at their ~90th percentile; an extent of 50
# puts percent_dense * extent (0.5) near the median scale, so rows both
# clone and split.
EXTENT = 50.0
_O = toptim.OptimConfig()
LRS = {"xyz": _O.position_lr_init, "features_dc": _O.feature_lr,
       "features_rest": _O.feature_lr / 20.0, "scaling": _O.scaling_lr,
       "rotation": _O.rotation_lr, "opacity": _O.opacity_lr}


@pytest.fixture(scope="module")
def scratch_runs(scene):
    """Each package's train_scratch once: densify events at 5 and 10, an
    opacity reset at 10, the SH degree raised at 15 and an LG prune at
    18. The port's split takes JAX's draws (the key chain of
    fovsplat/train/scratch.py: split, then normal(k1, (2, C, 3)))."""
    s = scene
    logs = {"j": [], "t": []}
    jout = jscratch.train_scratch(
        s["jst"], s["jviews"], s["jcfg"], jscratch.ScratchConfig(**SCRATCH),
        scene_extent=EXTENT, log=logs["j"].append, seed=0)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(2):
        key, k1 = jax.random.split(key)
        draws.append(t(jax.random.normal(k1, (2, 400, 3))))
    stats = []
    split = tdens.densify_and_split

    def split_with_jax_noise(state, dstats, *a, noise=None):
        stats.append(dstats)
        return split(state, dstats, *a, noise=draws[len(stats) - 1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdens, "densify_and_split", split_with_jax_noise)
        tout = tscratch.train_scratch(
            s["tst"], s["tviews"], s["tcfg"],
            tscratch.ScratchConfig(**SCRATCH), scene_extent=EXTENT,
            log=logs["t"].append, seed=0)
    return dict(jout=jout, tout=tout, logs=logs, stats=stats)


def test_train_scratch_matches_jax(scene, scratch_runs):
    r = scratch_runs
    assert len(r["stats"]) == 2
    # No row sits near the threshold, where summation order could flip
    # a selection.
    for d in r["stats"]:
        g = (d.grad_accum / torch.clamp(d.denom, min=1.0)).numpy()
        assert not (np.abs(g - 2e-4) < 1e-4 * 2e-4).any()
    np.testing.assert_array_equal(r["tout"].live.numpy(),
                                  np.asarray(r["jout"].live))
    live0 = int(scene["tst"].live_count())
    n_dens = [int(ln.split("live=")[1].split()[0]) for ln in r["logs"]["t"]
              if "densify live=" in ln]
    assert len(n_dens) == 2 and n_dens[0] > live0
    assert any("LG prune" in ln for ln in r["logs"]["t"])
    assert int(r["tout"].live_count()) < n_dens[1]
    live = r["tout"].live.numpy()
    for f in FIELDS:
        _close_scaled(r["tout"].opt.mu[f].numpy()[live],
                      np.asarray(getattr(r["jout"].opt.mu, f))[live], msg=f)
        # The parameters at the step tolerance, but for at most 0.5% of a
        # field's entries: an Adam step moves an entry by up to ~lr
        # whatever the gradient's size, so an entry whose gradient is ~0
        # at some step moves by the sign of float noise there. Those stay
        # within 2 lr a step.
        a = getattr(r["tout"].params, f).detach().numpy()[live]
        b = np.asarray(getattr(r["jout"].params, f))[live]
        off = np.abs(a - b) > (STEP_ATOL * np.abs(b).max()
                               + STEP_RTOL * np.abs(b))
        assert off.mean() <= 0.005, (f, int(off.sum()))
        lr = LRS[f]
        assert np.abs(a - b).max() <= 2 * lr * SCRATCH["iterations"], f
