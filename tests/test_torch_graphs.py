"""The port's CUDA-graph slice on the CPU: the pieces changed so that a
graph can hold the photometric step (the pair counts of the scale-decay
term, the device-side learning-rate schedule, `it` and `scale_weight` as
0-d tensors), the makers' fresh outputs, and the graph helper's refusal
of CPU tensors. The graphs themselves run on the card only
(tests/test_torch_cuda.py, chip_smoke.py's graphs phase).

The scale-decay step is held against the JAX package's jitted step on
the same numpy inputs (the XLA route, as tests/test_torch_train.py's
test_step_variants_match_jax_xla), one compile for both of its `it`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import rasterize as jrast
from fovsplat.train import loops as jloops
from fovsplat_torch import convert
from fovsplat_torch.data import proxy
from fovsplat_torch.eval import fps
from fovsplat_torch.ops import binning
from fovsplat_torch.ops import kernels
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.train import optim as toptim
from fovsplat_torch.utils import general, graphs
from tests.test_torch_train import FIELDS, _kept_pair_counts, _train_setup
from tests.test_torch_prune import tcam

W, H = 80, 56
SCALE_WEIGHT = 2.0
LATER_IT = 5000          # the xyz schedule at 5000 of 30,000 steps


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this file, restored after: these shapes
    gain nothing from more, and beside the other test workers the
    thread pools' waits cost seconds a test. Each comparison here runs
    both sides at the same thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
        render = fps.make_mmfr_render(convert.mmfr_models_from_numpy(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["highest_levels"], device="cpu"), cfg)
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
