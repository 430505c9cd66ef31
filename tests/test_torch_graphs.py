"""The port's CUDA-graph slices on the CPU: the pieces changed so that a
graph can hold the photometric, HVS and scratch steps and the views (the
pair counts of the scale-decay term, the device-side learning-rate
schedule, `it` and `scale_weight` as 0-d tensors, the HVS loss's tables
and filters filled before a capture, the DensifyStats as flat tensors),
the makers' fresh outputs and eager functions on the CPU, and the graph
helper's refusal of CPU tensors. The graphs themselves run on the card
only (tests/test_torch_cuda.py, chip_smoke.py's graphs phase).

The scale-decay, masked HVS and scratch steps are held against the JAX
package's jitted steps on the same numpy inputs (the XLA route, as
tests/test_torch_train.py's test_step_variants_match_jax_xla), one
compile a fixture.

VQ's fixed-size steps (the near-tie slots, the integer counts, the sums
over k per-codeword lengths) are held against the forms they replace,
which are kept here as references; tests/test_torch_lightgaussian.py
holds ema_kmeans and compress against JAX. The DP step's maker refuses a
graph on a gloo group.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import rasterize as jrast
from fovsplat.train import loops as jloops
from fovsplat_torch import convert
from fovsplat_torch.data import proxy
from fovsplat_torch.eval import fps, mmfr
from fovsplat_torch.ops import binning
from fovsplat_torch.ops import kernels
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.train import optim as toptim
from fovsplat_torch.train import scratch as tscratch
from fovsplat_torch.utils import general, graphs
from tests.test_torch_train import FIELDS, _kept_pair_counts, _train_setup
from tests.test_torch_prune import tcam
from tests.torch_cpu import one_torch_thread  # noqa: F401

W, H = 80, 56
SCALE_WEIGHT = 2.0
LATER_IT = 5000          # the xyz schedule at 5000 of 30,000 steps



# ------------------------------------------------------------ pair counts

@pytest.mark.parametrize("num_pairs", [0, 700, 1024])
def test_gs_counts_match_bincount(num_pairs):
    """The index_add_ pair counts equal the bincount form: lanes past
    num_pairs (garbage ids: negative, at and past the capacity) go to the
    sentinel slot, which is dropped."""
    cap, lanes = 300, 1024
    rng = np.random.default_rng(num_pairs)
    ids = rng.integers(0, cap, lanes)
    ids[num_pairs:] = rng.choice([-7, cap, cap + 5, 1 << 30],
                                 lanes - num_pairs)
    pair_gauss = torch.from_numpy(ids.astype(np.int32))
    bn = binning.Binned(seg_start=None, num_pairs=torch.tensor(num_pairs,
                                                               dtype=torch.int32),
                        overflow=None, candidates=None,
                        pair_gauss=pair_gauss)
    got = tloops._gs_counts(bn, cap)
    lane = torch.arange(lanes)
    want = torch.bincount(torch.where(lane < num_pairs, pair_gauss.long(),
                                      cap), minlength=cap + 1)[:cap]
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(got.sum()) == num_pairs


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("it", [0, 1, 900, 29_999, 40_000])
def test_learning_rates_tensor_step_matches_python(it):
    """learning_rates with a 0-d tensor step (int or float) equals the
    python step, and the schedule equals expon_lr of the python step (the
    form the rates had before they moved to the parameters' device)."""
    params = convert.params_from_numpy(
        **{k: v[:4] for k, v in proxy.train_arrays(
            proxy.bicycle_proxy(n=64, seed=0)).items()}, device="cpu")
    cfg = toptim.OptimConfig()
    want = toptim.learning_rates(params, it, cfg, 2.5)
    for step in (torch.tensor(it), torch.tensor(float(it))):
        got = toptim.learning_rates(params, step, cfg, 2.5)
        assert set(got) == set(want)
        assert torch.equal(got["xyz"], want["xyz"])
        assert all(got[f] == want[f] for f in want if f != "xyz")
    ref = general.expon_lr(it, cfg.position_lr_init * 2.5,
                           cfg.position_lr_final * 2.5,
                           lr_delay_mult=cfg.position_lr_delay_mult,
                           max_steps=cfg.position_lr_max_steps)
    assert want["xyz"].dtype == torch.float32 and torch.equal(want["xyz"],
                                                              ref)


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def scale_decay_steps():
    """The JAX scale-decay step (XLA route, kept-pair counts as the port
    takes them) at it = 1 and LATER_IT, from one state; the port's inputs.
    The shapes and config are tests/test_torch_train.py's
    test_step_variants_match_jax_xla's, so the two share one compile."""
    jst, tst, cam, gt = _train_setup(n=200, capacity=224)
    jstep = jloops.make_photometric_step(
        jloops.LoopConfig(raster=jrast.RasterizeConfig(pair_capacity=1 << 13,
                                                       chunk=256)),
        use_scale_decay=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloops, "_gs_counts", _kept_pair_counts)
        jouts = {it: jstep(jst, cam, jnp.asarray(gt), jnp.int32(it),
                           jnp.float32(SCALE_WEIGHT))
                 for it in (1, LATER_IT)}
    tcfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    return jouts, tst, tcam(cam), torch.from_numpy(gt), tcfg


def _flat(state, aux):
    return ([getattr(state.params, f).detach() for f in FIELDS]
            + [state.opt.mu[f] for f in FIELDS]
            + [state.opt.nu[f] for f in FIELDS]
            + [state.opt.count, state.live] + [aux[k] for k in sorted(aux)])


@pytest.mark.parametrize("it", [1, LATER_IT])
def test_scale_decay_step_tensor_scalars_match_python_and_jax(
        scale_decay_steps, it):
    """The scale-decay step with `it` and `scale_weight` as 0-d tensors
    (as a CUDA graph holds them) is the step with python numbers bit for
    bit, and matches JAX's jitted step: loss within 1e-5 relative, first
    moments (the masked gradients) scaled by their largest value within
    rtol 2e-3, atol 2e-4, and Adam's first step (lr * sign(g), so the xyz
    schedule at `it`) within 1e-6 where the gradient is well above 0."""
    jouts, tst, cam, gt, tcfg = scale_decay_steps
    step = tloops.make_photometric_step(tcfg, use_scale_decay=True,
                                        device="cpu")
    py_new, py_aux = step(tst, cam, gt, it, SCALE_WEIGHT)
    t_new, t_aux = step(tst, cam, gt, torch.tensor(it),
                        torch.tensor(SCALE_WEIGHT, dtype=torch.float32))
    for a, b in zip(_flat(py_new, py_aux), _flat(t_new, t_aux)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    jnew, jaux = jouts[it]
    assert int(t_aux["overflow"]) == int(jaux["overflow"]) == 0
    assert int(t_aux["nonfinite"]) == int(jaux["nonfinite"]) == 0
    assert int(t_aux["num_pairs"]) == int(jaux["num_pairs"]) > 300
    np.testing.assert_allclose(float(t_aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    for f in FIELDS:
        g = np.asarray(getattr(jnew.opt.mu, f))
        scale = np.abs(g).max()
        assert scale > 0, f
        np.testing.assert_allclose(t_new.opt.mu[f].numpy() / scale,
                                   g / scale, rtol=2e-3, atol=2e-4,
                                   err_msg=f)
        big = np.abs(g) > 1e-3 * scale
        np.testing.assert_allclose(
            getattr(t_new.params, f).detach().numpy()[big],
            np.asarray(getattr(jnew.params, f))[big], rtol=0, atol=1e-6,
            err_msg=f)
    # Adam's first xyz step is the schedule's rate at `it` (in float64;
    # the f32 subtraction rounds each step by up to half an ulp of xyz).
    oc = toptim.OptimConfig()
    t = min(it / oc.position_lr_max_steps, 1.0)
    lr = np.exp(np.log(oc.position_lr_init) * (1 - t)
                + np.log(oc.position_lr_final) * t)
    g = np.asarray(jnew.opt.mu.xyz)
    moved = np.abs((t_new.params.xyz - tst.params.xyz).detach().numpy())
    np.testing.assert_allclose(
        np.median(moved[np.abs(g) > 1e-3 * np.abs(g).max()]), lr, rtol=1e-2)
    if it == LATER_IT:
        assert lr < 0.6 * oc.position_lr_init


# ------------------------------------------------------------ fresh outputs

def _fov_model(n=1000, shared=False):
    sc = proxy.bicycle_proxy(n=n, seed=4)
    return convert.fov_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device="cpu",
        shared_colors=shared), sc


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("path", ["ours", "naive", "mmfr"])
def test_cpu_frame_makers_return_fresh_frames(path):
    """For a model on the CPU the frame makers return the eager render
    (no graph), and a second frame leaves the first as it was."""
    cfg = trast.RasterizeConfig(pair_capacity=1 << 14)
    if path == "mmfr":
        _, sc = _fov_model()
        sc = {k: torch.as_tensor(v) for k, v in sc.items()}
        render = fps.make_mmfr_render(mmfr.pack_level_models(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"],
            [1000, 400, 217, 174]), cfg)
    else:
        model, _ = _fov_model(shared=path == "naive")
        render = fps.make_fov_render(model, cfg, mode=path)
    assert not hasattr(render, "graph")
    cam = proxy.proxy_camera(W, H, device="cpu")
    first = render(cam, torch.tensor([0.3, 0.6]))
    kept = _clone(first)
    second = render(cam, torch.tensor([0.7, 0.4]))
    assert _same(first, kept)
    assert not torch.equal(first["render"], second["render"])
    assert int(first["overflow"]) == 0 and int(first["num_pairs"]) > 100


def test_cpu_step_returns_fresh_state(scale_decay_steps):
    """make_photometric_step on the CPU is the eager step: a second step
    from the first step's state leaves that state as it was."""
    _, tst, cam, gt, tcfg = scale_decay_steps
    step = tloops.make_photometric_step(tcfg, use_scale_decay=True,
                                        device="cpu")
    assert not hasattr(step, "graph")
    first, aux = step(tst, cam, gt, 1, 1e-4)
    kept = [t.clone() for t in _flat(first, aux)]
    second, _ = step(first, cam, gt, 2, 0.0)
    assert all(torch.equal(a, b) for a, b in zip(_flat(first, aux), kept))
    assert not torch.equal(second.params.xyz, first.params.xyz)
    assert int(second.opt.count) == 2


# ------------------------------------------------------------ the helper

@pytest.mark.parametrize("bad", ["cpu_tensor", "list", "bool",
                                 "cpu_camera"])
def test_graph_refuses_what_it_cannot_capture(bad):
    """The graph helper takes CUDA tensors and python numbers only: a CPU
    tensor raises before anything runs (no eager fallback), as does an
    argument of another type."""
    calls = []

    def fn(*args):
        calls.append(args)
        return args[0]

    graph = graphs.Graph()
    if bad == "cpu_camera":
        frame = graphs.graphed_frame(lambda cam, gaze: calls.append(cam))
        with pytest.raises(ValueError, match="CUDA tensors"):
            frame(proxy.proxy_camera(W, H, device="cpu"),
                  torch.tensor([0.5, 0.5]))
        assert frame.graph.captures == 0
    elif bad == "cpu_tensor":
        with pytest.raises(ValueError, match="CUDA tensors"):
            graph("key", fn, torch.zeros(3), 1.0)
    else:
        with pytest.raises(TypeError, match="tensors and python numbers"):
            graph("key", fn, [1.0, 2.0] if bad == "list" else True)
    assert calls == [] and graph.captures == 0 and graph.replays == 0


def test_launch_counters_list_every_wrapper():
    """ops/kernels.launch_counters names every kernel wrapper's counter
    (the graphs add a replay's launches to them), and nothing else."""
    import importlib
    import pkgutil
    found = set()
    for mod in pkgutil.iter_modules(kernels.__path__):
        m = importlib.import_module(f"{kernels.__name__}.{mod.name}")
        for name, obj in vars(m).items():
            if callable(obj) and hasattr(obj, "launches") and \
                    obj.__module__ == m.__name__:
                found.add(name)
    counters = kernels.launch_counters()
    assert set(counters) == found | {"blend_fov_tile0"}
    for name, (obj, attr) in counters.items():
        assert isinstance(getattr(obj, attr), int), name


# ------------------------------------------------------------ HVS, scratch

@pytest.fixture(scope="module")
def hvs_steps():
    """The JAX masked HVS step at it = 5 (tests/test_torch_prune.py's
    test_hvs_step_masking_matches_jax's call, so the two share one
    compile) and the port's inputs."""
    jst, tst, cam, gt = _train_setup(n=200, capacity=224)
    jcfg = jloops.LoopConfig(raster=jrast.RasterizeConfig(
        pair_capacity=1 << 13, chunk=256))
    jout = jloops.make_hvs_step(jcfg, 3.0, "L1", masking=True)(
        jst, cam, jnp.asarray(gt), jnp.int32(5))
    tcfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    return jout, tst, tcam(cam), torch.from_numpy(gt), tcfg


@pytest.mark.parametrize("masking", [True, False])
def test_hvs_step_tensor_it_matches_python_and_jax(hvs_steps, masking):
    """hvs_step with `it` as a 0-d tensor (as a CUDA graph holds it) is
    the step with a python int bit for bit; the masked step matches JAX's
    as test_hvs_step_masking_matches_jax holds it (loss within 1e-5
    relative, DC and opacity moments scaled within rtol 2e-3, atol 2e-4,
    the four frozen fields bit for bit), and its frozen fields come back
    equal to the given ones."""
    (jnew, jaux), tst, cam, gt, tcfg = hvs_steps
    py_new, py_aux = tloops.hvs_step(tst, cam, gt, 5, tcfg, 3.0, "L1",
                                     masking)
    t_new, t_aux = tloops.hvs_step(tst, cam, gt, torch.tensor(5), tcfg, 3.0,
                                   "L1", masking)
    for a, b in zip(_flat(py_new, py_aux), _flat(t_new, t_aux)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(t_aux["nonfinite"]) == 0 and int(t_aux["overflow"]) == 0
    moved = {f for f in FIELDS if not torch.equal(
        getattr(t_new.params, f), getattr(tst.params, f))}
    if not masking:
        assert moved == set(FIELDS)
        return
    assert moved == {"features_dc", "opacity"}
    np.testing.assert_allclose(float(t_aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    for f in FIELDS:
        if f in moved:
            g = np.asarray(getattr(jnew.opt.mu, f))
            scale = np.abs(g).max()
            np.testing.assert_allclose(t_new.opt.mu[f].numpy() / scale,
                                       g / scale, rtol=2e-3, atol=2e-4,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(
                getattr(t_new.params, f).detach().numpy(),
                np.asarray(getattr(jnew.params, f)), err_msg=f)


@pytest.fixture(scope="module")
def scratch_steps():
    """The JAX scratch step at SH degree 1 and it = 3 from the HVS
    fixture's state (tests/test_torch_scratch.py's test_scratch_steps_
    match_jax holds a chain of them), and the port's inputs."""
    from fovsplat.models import densify as jdens
    from fovsplat.train import scratch as jscratch
    jst, tst, cam, gt = _train_setup(n=200, capacity=224)
    jcfg = jloops.LoopConfig(raster=jrast.RasterizeConfig(
        pair_capacity=1 << 13, chunk=256))
    jout = jscratch.make_scratch_step(jcfg, 1)(
        jst, jdens.init_stats(224), cam, jnp.asarray(gt), jnp.int32(3))
    tcfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    return jout, tst, tcam(cam), torch.from_numpy(gt), tcfg


def test_scratch_step_tensor_it_matches_python_and_jax(scratch_steps):
    """scratch_step with `it` as a 0-d tensor and the aliased init_stats
    is the step with a python int bit for bit (state, statistics, aux),
    and matches JAX's at tests/test_torch_scratch.py's tolerances: loss
    1e-5 relative, first moments and grad_accum scaled within rtol 2e-3,
    atol 2e-4, denom and max_radii exact."""
    from fovsplat_torch.models import densify as tdens
    (jnew, jd, jaux), tst, cam, gt, tcfg = scratch_steps
    outs = [tscratch.scratch_step(tst, tdens.init_stats(224, device="cpu"),
                                  cam, gt, it, 1, tcfg)
            for it in (3, torch.tensor(3))]
    (pn, pd, pa), (tn, td, ta) = outs
    for a, b in zip(_flat(pn, pa) + list(tdens.stats_tensors(pd)),
                    _flat(tn, ta) + list(tdens.stats_tensors(td))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(ta["nonfinite"]) == int(jaux["nonfinite"]) == 0
    assert int(ta["overflow"]) == 0
    np.testing.assert_allclose(float(ta["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    for name, a, b in ([(f, tn.opt.mu[f], getattr(jnew.opt.mu, f))
                        for f in FIELDS]
                       + [("grad_accum", td.grad_accum, jd.grad_accum)]):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=2e-3,
                                   atol=2e-4, err_msg=name)
    np.testing.assert_array_equal(td.denom.numpy(), np.asarray(jd.denom))
    np.testing.assert_array_equal(td.max_radii.numpy(),
                                  np.asarray(jd.max_radii))


def test_densify_stats_round_trip_through_tensors():
    """stats_tensors and stats_of round-trip, the aliased init_stats (one
    zero tensor in all three fields) included; a graph copies the three
    into separate static inputs, so the step's statistics do not depend
    on the aliasing."""
    from fovsplat_torch.models import densify as tdens
    z = tdens.init_stats(7, device="cpu")
    assert z.grad_accum is z.denom is z.max_radii
    rng = np.random.default_rng(0)
    ds = tdens.DensifyStats(*(torch.from_numpy(rng.uniform(
        0, 1, 7).astype(np.float32)) for _ in range(3)))
    for s in (z, ds):
        ts = tdens.stats_tensors(s)
        assert len(ts) == 3
        back = tdens.stats_of(ts)
        assert all(getattr(back, f) is getattr(s, f)
                   for f in ("grad_accum", "denom", "max_radii"))
        copies = [t.clone() for t in ts]
        copies[0].add_(1.0)     # separate buffers, as a graph's inputs
        sep = tdens.stats_of(copies)
        assert torch.equal(sep.denom, s.denom)
        assert torch.equal(sep.max_radii, s.max_radii)


# ------------------------------------------------------------ tables

def test_device_filters_match_numpy_weights():
    """The pyramid's cached device filters give filter_bank and
    depthwise_conv outputs bit-equal to the numpy-weight path."""
    from fovsplat_torch.perception import pyramid as tpyr
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (1, 32, 48, 3)).astype(np.float32))
    f = tpyr.load_filters(6, "cropped")
    dev = tpyr.device_filters(6, "cropped", "cpu", torch.float32)
    assert torch.equal(tpyr.filter_bank(x, dev["b"]),
                       tpyr.filter_bank(x, f["b"]))
    assert torch.equal(tpyr.filter_bank(x, dev["h0l0"]),
                       tpyr.filter_bank(x, np.stack([f["h0"], f["l0"]])))
    for k in ("h0", "l0", "l"):
        assert torch.equal(tpyr.depthwise_conv(x, dev[k]),
                           tpyr.depthwise_conv(x, f[k])), k
    assert tpyr.device_filters(6, "cropped", "cpu", torch.float32) is dev


@pytest.mark.parametrize("pooling", [1.0, 3.0, 12.0])
def test_prepare_fills_every_table(pooling):
    """After metameric.prepare for a camera and pooling size, an eager HVS
    step (forward and backward) and hvs_view at that size add no miss to
    the resampling tables' cache or the pyramid filters' cache: a CUDA
    graph's warm-up and capture then copy nothing from the host. 80x56
    is resized for the pyramid (to 96x64)."""
    from fovsplat_torch.perception import metameric as tmeta
    from fovsplat_torch.perception import pyramid as tpyr
    _, tst, _, _ = _train_setup(n=200, capacity=224)
    cam = proxy.proxy_camera(W, H, device="cpu")
    gt = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (H, W, 3)).astype(np.float32))
    cfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    tmeta._resample_map.cache_clear()
    tpyr.device_filters.cache_clear()
    tmeta.prepare(H, W, pooling, cfg.hvs_levels, cfg.hvs_orientations, "cpu")
    misses = (tmeta._resample_map.cache_info().misses,
              tpyr.device_filters.cache_info().misses)
    assert misses[0] > 0 and misses[1] == 1
    _, aux = tloops.hvs_step(tst, cam, gt, 1, cfg, pooling)
    _, hvs_view = tloops.make_eval_fns(cfg, device="cpu")
    mse = hvs_view(tst, cam, gt, pooling)
    assert np.isfinite(float(aux["loss"])) and np.isfinite(float(mse))
    assert (tmeta._resample_map.cache_info().misses,
            tpyr.device_filters.cache_info().misses) == misses


# ------------------------------------------------------------ makers

MAKERS = ["hvs_step", "eval_view", "hvs_view", "score_view", "scratch_step",
          "significance_view", "teacher_render", "ps1_render", "layer_ours",
          "layer_naive", "dp_step"]
# Makers that follow the device of the model they are given, or take
# `device` and raise without CUDA: no graphed callable on a CPU machine.
EAGER_ONLY = ("hvs_step", "scratch_step", "teacher_render", "ps1_render",
              "layer_ours", "layer_naive", "dp_step")


def _composed(st):
    """A 4-level composed model's arrays over the state's rows."""
    import types
    rng = np.random.default_rng(8)
    n = st.capacity
    return types.SimpleNamespace(
        highest_levels=rng.integers(0, 4, n),
        opacities=rng.uniform(0.2, 0.9, (n, 4)).astype(np.float32),
        shs_dcs=rng.normal(0, 0.5, (n, 4, 3)).astype(np.float32))


def _maker(name, cfg, device, st=None):
    from fovsplat_torch.eval import layers as tlayers
    from fovsplat_torch.eval import quality as tquality
    from fovsplat_torch.parallel import data_parallel as tdp
    from fovsplat_torch.train import distill as tdistill
    from fovsplat_torch.train import trainer as ttrainer
    if name == "teacher_render":
        return tdistill.teacher_render(st, cfg)
    if name == "ps1_render":
        return tquality.make_ps1_render(st, cfg.raster)
    if name == "layer_ours":
        return tlayers.layer_render_ours(st.params, st.live, _composed(st),
                                         2, cfg.raster)
    if name == "layer_naive":
        return tlayers.layer_render_naive(
            st.params, st.live, _composed(st).highest_levels, 2, cfg.raster)
    if name == "dp_step":
        return tdp.make_dp_train_step(ttrainer.TrainConfig(raster=cfg.raster),
                                      device=device)
    if name == "hvs_step":
        return tloops.make_hvs_step(cfg, 3.0, masking=True, device=device)
    if name == "scratch_step":
        return tscratch.make_scratch_step(cfg, device=device)
    if name == "significance_view":
        return tscratch.make_significance_view(cfg, device=device)
    if name == "score_view":
        return tloops.make_score_fn(cfg, device=device)
    return tloops.make_eval_fns(cfg, device=device)[name == "hvs_view"]


def _call(name, fn, st, cam, gt):
    from fovsplat_torch.models import densify as tdens
    if name == "hvs_step":
        return fn(st, cam, gt, 1)
    if name == "scratch_step":
        return fn(st, tdens.init_stats(st.capacity, device="cpu"), cam, gt,
                  1, 1)
    if name == "eval_view":
        return fn(st, cam, gt)
    if name == "hvs_view":
        return fn(st, cam, gt, 3.0)
    if name == "dp_step":
        from fovsplat_torch.parallel import data_parallel as tdp
        from fovsplat_torch.train import optim as topt
        p, o, aux = fn(st.params, topt.init_state(st.params),
                       tdp.stack_cameras([cam]), gt[None], 1)
        return ([getattr(p, f).detach() for f in FIELDS]
                + [o.mu[f] for f in FIELDS] + [o.nu[f] for f in FIELDS]
                + [o.count, aux["loss"], aux["overflow"]])
    if name in ("teacher_render", "ps1_render", "layer_ours",
                "layer_naive"):
        return fn(cam)
    return fn(st, cam)


def _leaves(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    if hasattr(out, "params"):
        return _flat(out, {})
    if hasattr(out, "grad_accum"):
        return [out.grad_accum, out.denom, out.max_radii]
    return [out]


@pytest.mark.parametrize("name", MAKERS)
def test_cpu_makers_return_eager_functions(name):
    """On the CPU the makers of the HVS step, the eval and HVS views, the
    score view, the scratch step, the significance view, distill's
    teacher render, the quality and layer renders and the DP step return
    their eager functions (no graph). The view makers' default (device
    None) gives a graphed callable that runs a state on the CPU through
    the same eager function: equal outputs, no capture."""
    _, tst, _, _ = _train_setup(n=200, capacity=224)
    cam = proxy.proxy_camera(W, H, device="cpu")
    gt = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (H, W, 3)).astype(np.float32))
    cfg = tloops.LoopConfig(raster=trast.RasterizeConfig(
        pair_capacity=1 << 13))
    fn = _maker(name, cfg, "cpu", tst)
    assert not hasattr(fn, "graph")
    want = _leaves(_call(name, fn, tst, cam, gt))
    assert want and all(bool(torch.isfinite(t.float()).all()) for t in want)
    if name in EAGER_ONLY:
        return
    graphed = _maker(name, cfg, None)
    assert graphed.eager is not None and graphed.graph.captures == 0
    got = _leaves(_call(name, graphed, tst, cam, gt))
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    assert graphed.graph.captures == 0 and graphed.graph.replays == 0



@pytest.mark.parametrize("name", ["ssim", "lpips"])
def test_graphed_metrics_run_cpu_tensors_eagerly(name, tmp_path):
    """The SSIM metric and LPIPS, graphed on the card, run CPU tensors
    through their eager functions: the same value, no capture, no
    replay; LPIPS's z-score constants now come with its weights."""
    from fovsplat_torch.eval import lpips_torch
    from fovsplat_torch.eval import metrics as tmetrics
    from fovsplat_torch.train import losses as tlosses
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    if name == "ssim":
        fn, want = tmetrics._ssim, float(tlosses.ssim(a, b))
        got = tmetrics.ssim(a, b)
    else:
        from chip_smoke import synthetic_vgg_weights
        path = tmp_path / "vgg.npz"
        np.savez(path, **synthetic_vgg_weights())
        net = lpips_torch.LPIPS(str(path))
        fn = net
        want, got = float(net.eager(a, b)), float(net(a, b))
        w = net._weights(torch.device("cpu"))
        assert torch.equal(w["shift"].reshape(-1),
                           torch.from_numpy(lpips_torch._SHIFT))
        assert torch.equal(w["scale"].reshape(-1),
                           torch.from_numpy(lpips_torch._SCALE))
    assert got == want and np.isfinite(got)
    assert fn.graph.captures == 0 and fn.graph.replays == 0


# ------------------------------------------------------------ VQ

def _assign_reference(data, codebook, rows, step):
    """The assignment that vq._assign's fixed-size form replaces: the
    near-tie rows found with torch.nonzero and decided in a python loop
    over their count, `rows` rows a chunk and `step` near-tie rows a
    float64 batch."""
    from fovsplat_torch.models import vq as tvq
    k = codebook.shape[0]
    cb2 = torch.sum(codebook * codebook, 1)[None, :]
    ids, counts = [], []
    for s in range(0, data.shape[0], rows):
        a = data[s:s + rows]
        a2 = torch.sum(a * a, 1, keepdim=True)
        d2 = a2 - 2.0 * a @ codebook.T + cb2
        two, idx = torch.topk(d2, min(2, k), dim=1, largest=False)
        best = torch.argmin(d2, dim=1)
        near = torch.nonzero((two[:, 1] - two[:, 0]) <= tvq.TIE_RTOL * (
            a2[:, 0] + cb2[0, idx[:, 0]]))[:, 0]
        counts.append(near.numel())
        for t in range(0, near.numel(), step):
            sel = near[t:t + step]
            diff = a[sel, None, :].double() - codebook[None].double()
            best[sel] = torch.argmin((diff * diff).sum(-1), dim=1)
        ids.append(best)
    return torch.cat(ids), counts


def _tie_rows(n=700, d=48, seed=3):
    """Rows and a 64-codeword codebook: 24 codewords, their 24 twins a
    few ulps away (as k-means' draws with replacement make them) and 16
    singletons. A row near a twinned codeword is a near tie, a row near
    a singleton is not; both fall in every 64-row chunk."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (40, d)).astype(np.float32)
    cb = np.concatenate([base, base[:24] * np.float32(1 + 2e-7)])
    rows = (base[rng.integers(0, 40, n)]
            + rng.normal(0, 0.05, (n, d))).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(cb)


@pytest.mark.parametrize("capacity", [64, 8])
def test_fixed_size_assign_matches_the_nonzero_form(capacity, monkeypatch):
    """vq._assign with a fixed number of near-tie slots a chunk gives the
    nonzero-and-loop form's ids bit for bit when the slots hold the
    chunk's near ties, and counts the most ties a chunk held either way.
    With 8 slots every chunk overflows: _assign reports more than 8, and
    vq.assign grows the slots to the next power of two that holds them
    and reruns, with the same ids and the regrowth recorded."""
    from fovsplat_torch.models import vq as tvq
    monkeypatch.setattr(tvq, "ASSIGN_ELEMENTS", 64 * 64)   # 64-row chunks
    data, cb = _tie_rows()
    want, counts = _assign_reference(data, cb, 64, 64 * 64 // (64 * 48))
    most = max(counts)
    assert 8 < most < 64 and min(counts) > 0
    ids, got_most = tvq._assign(data, cb, capacity)
    assert int(got_most) == most
    if capacity >= most:
        assert ids.dtype == want.dtype and torch.equal(ids, want)
    else:
        assert not torch.equal(ids, want)
    ties = tvq.Ties(capacity=capacity)
    assert torch.equal(tvq.assign(data, cb, ties), want)
    assert ties.most == most
    if capacity < most:
        assert ties.regrown == 1 and ties.capacity == 1 << (
            most - 1).bit_length()
    else:
        assert ties.regrown == 0 and ties.capacity == capacity


def test_fixed_size_ema_sums_and_counts_match_the_forms_they_replace():
    """The EMA update's sums over k per-codeword lengths equal
    reduce_by_sorted_gid_plain's (unique_consecutive) bit for bit,
    codewords without a row included (zero), and the integer index_add_
    counts equal bincount's."""
    from fovsplat_torch.models import vq as tvq
    from fovsplat_torch.ops.kernels.segment_reduce import (
        reduce_by_sorted_gid_plain)
    rng = np.random.default_rng(12)
    k = 40
    ids = torch.from_numpy(rng.choice(np.arange(0, k, 3), 500))
    rows = torch.from_numpy(rng.normal(0, 1, (500, 48)).astype(np.float32))
    sorted_ids, perm = torch.sort(ids, stable=True)
    want = reduce_by_sorted_gid_plain(sorted_ids, rows[perm].T, k).T
    got = tvq._codeword_sums(ids, rows, k)
    assert got.shape == want.shape and torch.equal(got, want)
    empty = torch.ones(k, dtype=torch.bool)
    empty[ids] = False
    assert int(empty.sum()) > 20 and not got[empty].any()
    counts = tvq._codeword_counts(ids, k)
    assert torch.equal(counts, torch.bincount(ids, minlength=k))


def test_ema_kmeans_reruns_an_overflowed_step_exactly():
    """ema_kmeans on rows full of near ties with one slot a chunk: every
    step overflows once, grows the slots and reruns; the codebook equals
    the run whose slots held the ties from the start, bit for bit."""
    from fovsplat_torch.models import vq as tvq
    data, _ = _tie_rows(n=400)
    init, starts = tvq.draws(400, 64, 3, 200,
                             torch.Generator().manual_seed(3))
    init[1::2] = init[::2]        # drawn with replacement: exact ties
    runs = []
    for cap in (1, 512):
        ties = tvq.Ties(capacity=cap)
        runs.append((tvq.ema_kmeans(data, 64, 3, batch=200, init_idx=init,
                                    starts=starts, ties=ties), ties))
    (small, t1), (big, t2) = runs
    assert t1.regrown >= 1 and t2.regrown == 0 and t1.most == t2.most > 1
    assert torch.equal(small, big)


# ------------------------------------------------------------ the DP step

@pytest.fixture
def gloo_group(tmp_path):
    """A gloo group of one rank in this process (a file store: no
    socket), destroyed after the test."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("given", ["default", "group"])
def test_dp_step_refuses_a_graph_on_gloo(gloo_group, given):
    """make_dp_train_step(graph=True) on a gloo group raises
    CaptureUnsupported (a gloo collective cannot be captured) instead of
    running eagerly; graph=False gives the eager step."""
    from fovsplat_torch.parallel import data_parallel as tdp
    from fovsplat_torch.train import trainer as ttrainer
    cfg = ttrainer.TrainConfig()
    group = None if given == "default" else gloo_group
    with pytest.raises(tdp.CaptureUnsupported, match="gloo"):
        tdp.make_dp_train_step(cfg, group, device="cpu", graph=True)
    step = tdp.make_dp_train_step(cfg, group, device="cpu", graph=False)
    assert callable(step) and not hasattr(step, "graph")
