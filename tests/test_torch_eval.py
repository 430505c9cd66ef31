"""The port's quality evaluation against the JAX package, on the CPU: the
config system, LPIPS, the metrics, the quality and per-layer JSONs, the
eval renders, the unpacked foveated render rasterize_fov, the video path
and the command line.

The same numpy inputs (3,000 Gaussians at 160x112, 64x96 images, seeded)
go through fovsplat and fovsplat_torch with device="cpu", where the
kernel wrappers run their plain versions. The JAX renders take the f32
XLA route. LPIPS runs on synthetic VGG weights made from a seed (the
weight maker of tests/test_eval_schema.py, copied).
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat import cli as jcli
from fovsplat.data import cameras as jcameras
from fovsplat.eval import layers as jlayers
from fovsplat.eval import lpips_jax
from fovsplat.eval import metrics as jmetrics
from fovsplat.eval import quality as jquality
from fovsplat.eval import video as jvideo
from fovsplat.models import gaussians as jgauss
from fovsplat.models import state as jstate
from fovsplat.ops import foveated as jfov
from fovsplat.ops.rasterize import RasterizeConfig as JConfig
from fovsplat.train import compose as jcompose
from fovsplat.train import loops as jloops
from fovsplat.utils import config as jconfig
from fovsplat_torch import cli as tcli
from fovsplat_torch import convert
from fovsplat_torch.data import dataset as tdataset
from fovsplat_torch.eval import layers as tlayers
from fovsplat_torch.eval import lpips_torch
from fovsplat_torch.eval import metrics as tmetrics
from fovsplat_torch.eval import quality as tquality
from fovsplat_torch.eval import video as tvideo
from fovsplat_torch.models import state as tstate
from fovsplat_torch.ops import foveated as tfov
from fovsplat_torch.ops.rasterize import RasterizeConfig as TConfig
from fovsplat_torch.train import compose as tcompose
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.utils import config as tconfig
from tests.test_torch_parity import bf16_exact
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

W, H, N = 160, 112, 3000
CAP = 1 << 16
BG = [0.1, 0.2, 0.3]
GAZES = [(0.5, 0.5), (0.2, 0.2)]


def t(a):
    return torch.from_numpy(np.asarray(a))


def port_camera(cam):
    return convert.camera_from_numpy(cam.world_view, cam.full_proj,
                                     cam.cam_center, cam.tan_fovx,
                                     cam.tan_fovy, cam.width, cam.height,
                                     device="cpu")


# ----------------------------------------------------------------- config

@dataclasses.dataclass(frozen=True)
class _Inner:
    rate: float = 0.5
    flag: bool = False


@dataclasses.dataclass(frozen=True)
class _Outer:
    inner: _Inner = _Inner()
    steps: int = 10
    name: str = "a"
    sizes: tuple = (1, 2)


def test_config_reflection_round_trip(tmp_path):
    ap = argparse.ArgumentParser()
    tconfig.add_dataclass_args(ap, tloops.LoopConfig)
    ns = ap.parse_args(["--lambda-dssim", "0.3", "--raster.pair-capacity",
                        "4096", "--raster.sort-exact-depth",
                        "--no-raster.use-obb", "--optim.position-lr-init",
                        "0.5"])
    cfg = tconfig.apply_args(tloops.LoopConfig(), ns)
    assert cfg.lambda_dssim == 0.3
    assert cfg.raster.pair_capacity == 4096
    assert cfg.raster.sort_exact_depth and not cfg.raster.use_obb
    assert cfg.optim.position_lr_init == 0.5
    assert tconfig.from_dict(tloops.LoopConfig, tconfig.to_dict(cfg)) == cfg
    path = str(tmp_path / "m" / "cfg_args.json")
    tconfig.save_config(path, cfg)
    assert tconfig.load_config(path, tloops.LoopConfig) == cfg
    over = tconfig.combined_config(tloops.LoopConfig, str(tmp_path / "m"),
                                   ap.parse_args(["--sh-degree", "2"]))
    assert over == dataclasses.replace(cfg, sh_degree=2)
    # Nested dataclasses, tuples and the --no-X pairs, as in JAX.
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.add_dataclass_args(p, _Outer)
        o = mod.apply_args(_Outer(), p.parse_args(
            ["--inner.flag", "--steps", "3", "--name", "b"]))
        assert o == _Outer(inner=_Inner(flag=True), steps=3, name="b")
        assert mod.from_dict(_Outer, {"sizes": [4], "extra": 1}).sizes == (4,)


def test_jax_written_config_loads_in_the_port(tmp_path):
    """from_dict ignores keys the port's LoopConfig lacks (the Pallas-only
    raster fields) and keeps every shared value."""
    jcfg = jloops.LoopConfig(
        raster=JConfig(pair_capacity=12345, backend="pallas",
                       pallas_chunk=128, sort_exact_depth=True,
                       clip_level_rects=False),
        lambda_dssim=0.25, sh_degree=2, spatial_lr_scale=3.5)
    path = str(tmp_path / "cfg_args.json")
    jconfig.save_config(path, jcfg)
    cfg = tconfig.load_config(path, tloops.LoopConfig)
    assert cfg == tloops.LoopConfig(
        raster=TConfig(pair_capacity=12345, chunk=jcfg.raster.chunk,
                       sort_exact_depth=True, clip_level_rects=False),
        lambda_dssim=0.25, sh_degree=2, spatial_lr_scale=3.5,
        optim=cfg.optim)
    assert tconfig.to_dict(cfg.optim) == {
        k: v for k, v in jconfig.to_dict(jcfg.optim).items()}


# ------------------------------------------------------------------ LPIPS

def _synthetic_vgg_weights(rng):
    """tests/test_eval_schema.py's weight maker."""
    w = {}
    cin = 3
    taps = []
    for layer in lpips_torch._VGG_LAYERS:
        if layer == "pool":
            continue
        name, cout = layer
        # He-ish scale keeps activations O(1) through 13 layers.
        w[name + "_w"] = rng.normal(
            0, 1.0 / np.sqrt(9 * cin), (3, 3, cin, cout)).astype(np.float32)
        w[name + "_b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        if name in lpips_torch._TAPS:
            taps.append(cout)
        cin = cout
    for i, c in enumerate(taps):
        w[f"lin{i}_w"] = np.abs(rng.normal(0, 1.0 / c, (1, 1, c, 1))
                                ).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def lpips_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "vgg.npz")
    np.savez(path, **_synthetic_vgg_weights(np.random.default_rng(7)))
    return path


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(21)
    a = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_lpips_matches_jax(lpips_file, images):
    a, b = images
    want = float(lpips_jax.LPIPS(lpips_file)(a, b))
    net = lpips_torch.LPIPS(lpips_file)
    got = float(net(t(a), t(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    batch = float(net(t(np.stack([a, a])), t(np.stack([b, b]))))
    np.testing.assert_allclose(batch, got, rtol=1e-6)
    assert float(net(t(a), t(a))) == 0.0


@pytest.fixture
def lpips_at(monkeypatch):
    """Point both packages' metrics at a weights path and reset their
    LPIPS singletons."""
    def point(path):
        for mod in (jmetrics, tmetrics):
            monkeypatch.setattr(mod, "LPIPS_WEIGHTS", path)
            monkeypatch.setattr(mod, "_lpips_net", None)
    return point


def test_metrics_match_jax(images, lpips_at, lpips_file, tmp_path):
    a, b = images
    ta, tb = t(a), t(b)
    for name in ("psnr", "ssim"):
        np.testing.assert_allclose(getattr(tmetrics, name)(ta, b),
                                   getattr(jmetrics, name)(a, b), rtol=1e-6,
                                   err_msg=name)
    for ps in (1.0, 3.0):
        np.testing.assert_allclose(tmetrics.hvs_uniform(ta, tb, ps),
                                   jmetrics.hvs_uniform(a, b, ps), rtol=1e-5)
    np.testing.assert_allclose(tmetrics.hvs_fov(ta, tb, gaze=(0.3, 0.6)),
                               jmetrics.hvs_fov(a, b, gaze=(0.3, 0.6)),
                               rtol=1e-5)
    lpips_at(str(tmp_path / "absent.npz"))
    assert tmetrics.lpips(ta, tb) is None and jmetrics.lpips(a, b) is None
    im_t = tmetrics.image_metrics(ta * 1.2, tb)
    im_j = jmetrics.image_metrics(a * 1.2, b)
    assert im_t.keys() == im_j.keys() and im_t["lpips"] is None
    for k in ("ssim", "psnr", "hvs"):
        np.testing.assert_allclose(im_t[k], im_j[k], rtol=1e-5, err_msg=k)
    lpips_at(lpips_file)
    np.testing.assert_allclose(tmetrics.lpips(ta, tb), jmetrics.lpips(a, b),
                               rtol=1e-5)
    assert isinstance(tmetrics.psnr(ta, tb), float)


def test_metrics_of_numpy_need_cuda(images, monkeypatch):
    """A numpy render goes to the GPU, so without CUDA the metric raises;
    a tensor render keeps its device."""
    a, b = images
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmetrics.psnr(a, b)
    assert tmetrics.psnr(t(a), b) > 0


# --------------------------------------------------------- the eval JSONs

@dataclasses.dataclass
class _View:
    camera: object
    image: np.ndarray
    image_name: str


@pytest.fixture(scope="module")
def fake_views():
    rng = np.random.default_rng(31)
    gts = rng.uniform(0, 1, (3, 64, 96, 3)).astype(np.float32)
    renders = np.clip(gts + 0.05 * rng.normal(0, 1, gts.shape), -0.1,
                      1.1).astype(np.float32)
    views = [_View(camera=i, image=g, image_name=f"v{i}")
             for i, g in enumerate(gts)]
    return views, renders


def _assert_json_close(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_json_close(a[k], b[k], f"{path}/{k}")
    elif b is None:
        assert a is None, path
    elif isinstance(b, str):
        assert a == b, path
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=path)


def test_quality_eval_json_matches_jax(fake_views, tmp_path, lpips_at):
    views, renders = fake_views
    lpips_at(str(tmp_path / "absent.npz"))
    mt = tquality.quality_eval(lambda c: renders[c], views,
                               str(tmp_path / "t"), "scene")
    mj = jquality.quality_eval(lambda c: renders[c], views,
                               str(tmp_path / "j"), "scene")
    _assert_json_close(mt, mj)
    assert mt["lpips"] is None
    for f in ("scene_quality.json", "scene_quality_per.json"):
        _assert_json_close(json.load(open(tmp_path / "t" / f)),
                           json.load(open(tmp_path / "j" / f)), f)


def test_eval_layers_json_matches_jax(fake_views, tmp_path):
    views, renders = fake_views
    ladder = [1, 3, 7]

    def for_layer(i):
        return lambda c: renders[c] * (1.0 - 0.05 * i)
    rt = tlayers.eval_layers(for_layer, views, ladder, str(tmp_path / "t"),
                             "scene", max_views=2)
    rj = jlayers.eval_layers(for_layer, views, ladder, str(tmp_path / "j"),
                             "scene", max_views=2)
    _assert_json_close({str(k): v for k, v in rt.items()},
                       {str(k): v for k, v in rj.items()})
    for ps in ladder:
        f = f"scene_{ps}.json"
        _assert_json_close(json.load(open(tmp_path / "t" / f)),
                           json.load(open(tmp_path / "j" / f)), f)


# ------------------------------------------------------------ the renders

@pytest.fixture(scope="module")
def model():
    """A 3,000-Gaussian cloud with per-level DC and opacity (bf16-exact),
    100 dead rows; JAX and port trainer states of its level-0 model and
    composed models."""
    rng = np.random.default_rng(41)
    means, scales, quats, ops_, _ = synthetic_cloud(n=N, seed=41,
                                                    scale_hi=0.3)
    hl = rng.integers(0, 4, (N,)).astype(np.float32)
    hl[:20] = -1.0
    dcs = bf16_exact(rng.normal(0, 0.6, (N, 4, 3)))
    op4 = bf16_exact(np.clip(ops_[:, None] + rng.normal(0, 0.1, (N, 4)),
                             0.05, 0.95))
    rest = bf16_exact(rng.normal(0, 0.03, (N, 15, 3)))
    live = np.ones(N, bool)
    live[-100:] = False
    raw = dict(xyz=means, features_dc=dcs[:, 0:1, :], features_rest=rest,
               scaling=np.log(scales), rotation=quats,
               opacity=np.log(op4[:, :1] / (1 - op4[:, :1])))
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    jst = jstate.from_params(jgauss.GaussianParams(
        **{k: jnp.asarray(v) for k, v in raw.items()}))
    jst = dataclasses.replace(jst, live=jnp.asarray(live))
    tst = tstate.from_params(convert.params_from_numpy(**raw, device="cpu"))
    tst = dataclasses.replace(tst, live=t(live))
    jcm = jcompose.ComposedModel(params=jst.params, live=live,
                                 highest_levels=hl, shs_dcs=dcs,
                                 opacities=op4)
    tcm = tcompose.ComposedModel(params=tst.params, live=t(live),
                                 highest_levels=t(hl), shs_dcs=t(dcs),
                                 opacities=t(op4))
    cam = make_test_camera(width=W, height=H)
    return dict(arrays=(means, scales, quats, op4, dcs, rest, hl),
                live=live, jst=jst, tst=tst, jcm=jcm, tcm=tcm, cam=cam,
                tcam=port_camera(cam), rng=rng)


def _close_image(got, want, atol=1e-4):
    got = got.numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_make_ps1_render_matches_jax(model):
    cam, tcam = model["cam"], model["tcam"]
    want = jquality.make_ps1_render(model["jst"], JConfig(
        pair_capacity=CAP, chunk=256), bg_color=jnp.asarray(BG))(cam)
    got = tquality.make_ps1_render(model["tst"], TConfig(
        pair_capacity=CAP), bg_color=BG)(tcam)
    assert not got.requires_grad
    _close_image(got, want)


@pytest.mark.parametrize("layer", [0, 2])
def test_layer_renders_match_jax(model, layer):
    cam, tcam = model["cam"], model["tcam"]
    jcfg, tcfg = JConfig(pair_capacity=CAP, chunk=256), TConfig(
        pair_capacity=CAP)
    want = jlayers.layer_render_ours(model["jst"].params, model["live"],
                                     model["jcm"], layer, jcfg)(cam)
    got = tlayers.layer_render_ours(model["tst"].params, model["live"],
                                    model["tcm"], layer, tcfg)(tcam)
    _close_image(got, want)
    hl = model["arrays"][-1]
    want = jlayers.layer_render_naive(model["jst"].params, model["live"],
                                      hl, layer, jcfg)(cam)
    got = tlayers.layer_render_naive(model["tst"].params, t(model["live"]),
                                     t(hl), layer, tcfg)(tcam)
    _close_image(got, want)


def test_compute_fov_colors_matches_jax(model):
    means, _, _, _, dcs, rest, _ = model["arrays"]
    cam = model["cam"]
    np.testing.assert_allclose(
        tfov.compute_fov_colors(t(means), t(rest), t(dcs),
                                model["tcam"].cam_center).numpy(),
        np.asarray(jfov.compute_fov_colors(means, rest, dcs,
                                           cam.cam_center)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("gaze", GAZES)
def test_rasterize_fov_matches_jax_xla(model, gaze, override):
    """Against the f32 XLA route; `override` feeds colors_override and
    opacity_shared in place of the per-level DC and opacity. A live mask
    removes 100 rows."""
    means, scales, quats, op4, dcs, rest, hl = model["arrays"]
    rng = np.random.default_rng(51)
    cols = rng.uniform(0, 1, (N, 4, 3)).astype(np.float32)
    op_sh = op4[:, 1].copy()
    kw_j = kw_t = {}
    if override:
        kw_j = dict(colors_override=jnp.asarray(cols),
                    opacity_shared=jnp.asarray(op_sh))
        kw_t = dict(colors_override=t(cols), opacity_shared=t(op_sh))
    out_j = jax.jit(lambda: jfov.rasterize_fov(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        None if override else jnp.asarray(op4),
        None if override else jnp.asarray(dcs), jnp.asarray(rest),
        jnp.asarray(hl), model["cam"], gaze=jnp.asarray(gaze, jnp.float32),
        alpha=0.05, bg_color=jnp.asarray(BG),
        config=JConfig(pair_capacity=CAP, chunk=256),
        live_mask=jnp.asarray(model["live"]), **kw_j))()
    out_t = tfov.rasterize_fov(
        t(means), t(scales), t(quats), None if override else t(op4),
        None if override else t(dcs), t(rest), t(hl), model["tcam"],
        torch.tensor(gaze), 0.05, bg_color=BG,
        config=TConfig(pair_capacity=CAP, sort_exact_depth=True),
        live_mask=t(model["live"]), **kw_t)
    assert int(out_t["num_pairs"]) == int(out_j["binned"].num_pairs) > 1000
    assert int(out_t["overflow"]) == 0
    np.testing.assert_array_equal(out_t["tile_blend"].numpy(),
                                  np.asarray(out_j["tile_blend"]))
    _close_image(out_t["render"], out_j["render"])


@pytest.mark.parametrize("gaze", GAZES)
def test_rasterize_fov_matches_soa_frame(model, gaze):
    """On bf16-representable inputs the packed model loses nothing, so the
    unpacked f32 render equals the SoA frame (kernel 1's plain version)."""
    means, scales, quats, op4, dcs, rest, hl = model["arrays"]
    cfg = TConfig(pair_capacity=CAP, sort_exact_depth=True)
    soa = tfov.rasterize_fov_soa(
        convert.fov_model_from_numpy(means, scales, quats, op4, dcs, rest,
                                     hl, device="cpu"),
        model["tcam"], torch.tensor(gaze), 0.05, bg_color=BG, config=cfg)
    out = tfov.rasterize_fov(t(means), t(scales), t(quats), t(op4), t(dcs),
                             t(rest), t(hl), model["tcam"], gaze, 0.05,
                             bg_color=BG, config=cfg)
    assert int(out["num_pairs"]) == int(soa["num_pairs"])
    np.testing.assert_allclose(out["render"].numpy(), soa["render"].numpy(),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------------ video

def _ring_views(n, width=W, height=H):
    """JAX and port views on a ring around the cloud, without images."""
    rng = np.random.default_rng(61)
    jviews, tviews = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = [4 * np.cos(ang), -0.5 + 0.1 * rng.normal(), 4 * np.sin(ang)]
        jc = jcameras.look_at_camera(eye, [0, 0, 0], [0, -1, 0], 0.9, 0.7,
                                     width, height)
        jviews.append(_View(camera=jc, image=None, image_name=f"v{i}"))
        tviews.append(_View(camera=port_camera(jc), image=None,
                            image_name=f"v{i}"))
    return jviews, tviews


def test_ellipse_path_and_video_match_jax(model, tmp_path):
    jviews, tviews = _ring_views(5)
    cj = jvideo.ellipse_path(jviews, n_frames=6)
    ct = tvideo.ellipse_path(tviews, n_frames=6)
    assert len(ct) == len(cj) == 6
    for a, b in zip(ct, cj):
        assert (a.width, a.height) == (b.width, b.height)
        for f in ("world_view", "full_proj", "cam_center", "tan_fovx",
                  "tan_fovy"):
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       np.asarray(getattr(b, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    render = tquality.make_ps1_render(model["tst"], TConfig(
        pair_capacity=CAP))
    n = tvideo.render_video(render, ct[:3], str(tmp_path / "video"))
    files = sorted(os.listdir(tmp_path / "video"))
    assert n == 3 and files == [f"frame_{i:04d}.png" for i in range(3)]
    from PIL import Image
    assert np.asarray(Image.open(tmp_path / "video" / files[0])).shape == (
        H, W, 3)


# -------------------------------------------------------- the command line

class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch):
    """The namespace `main` parses from argv (parsing stops it)."""
    orig = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(vars(orig(self, args, namespace)))
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Parsed) as e:
            main(argv)
    return e.value.args[0]


EVAL_ARGV = [
    ["render", "-m", "out", "-s", "scene", "-r", "2",
     "--pair-capacity", "4096"],
    ["eval", "-m", "out", "-s", "scene", "--chunk", "512"],
    ["eval-layers", "-m", "out", "-s", "scene"],
    ["video", "-m", "out", "-s", "scene", "--frames", "8"],
]


@pytest.mark.parametrize("argv", EVAL_ARGV, ids=lambda a: a[0])
def test_cli_eval_commands_parse_like_jax(argv, monkeypatch):
    assert _parsed(tcli.main, argv, monkeypatch) == _parsed(jcli.main, argv,
                                                            monkeypatch)


@pytest.mark.parametrize("argv", EVAL_ARGV, ids=lambda a: a[0])
def test_cli_eval_commands_need_cuda(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(argv)


def test_cli_eval_commands_run_on_a_scene(model, monkeypatch, tmp_path):
    """render, eval, eval-layers and video end to end on a stand-in scene
    (three 80x56 train views for the video's ellipse, one test view for
    the rest): the scene loader and the device are stubbed, the
    checkpoints are real files."""
    from fovsplat_torch.models import checkpoint as tckpt
    m = tmp_path / "m"
    os.makedirs(m)
    tst = model["tst"]
    tckpt.save(str(m / "ps1.npz"), tst, 0)
    means, scales, quats, op4, dcs, rest, hl = model["arrays"]
    np.savez(m / "ours_composed.npz", highest_levels=hl, shs_dcs=dcs,
             opacities=op4, live=model["live"])
    # 80x56: the plain twins' many small ops are what this test costs.
    gts = np.random.default_rng(71).uniform(0, 1, (3, 56, 80, 3)).astype(
        np.float32)
    views = _ring_views(3, 80, 56)[1]
    for v, g in zip(views, gts):
        v.image = g
    scene = tdataset.SceneData(train_views=views, test_views=views[:1],
                               points=None, colors=None, spatial_scale=1.0)
    monkeypatch.setattr(tdataset, "load_scene", lambda *a, **k: scene)
    monkeypatch.setattr("fovsplat_torch.utils.device.resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(tmetrics, "_lpips_net", None)
    common = ["-m", str(m), "-s", "unused", "--pair-capacity", str(CAP)]
    assert tcli.main(["render"] + common) == 0
    assert os.listdir(m / "renders") == ["v0.png"]
    assert tcli.main(["eval"] + common) == 0
    q = json.load(open(m / "scene_quality.json"))["ps1"]
    assert q["LPIPS"] is None and q["PSNR"] > 0
    assert tcli.main(["eval-layers"] + common) == 0
    assert sorted(os.listdir(m / "layers_eval")) == sorted(
        f"scene_{ps}.json" for ps in (1, 3, 7, 12))
    assert tcli.main(["video", "--frames", "2"] + common) == 0
    assert sorted(os.listdir(m / "video")) == ["frame_0000.png",
                                                "frame_0001.png"]
