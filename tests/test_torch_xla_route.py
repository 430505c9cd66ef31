"""The port's XLA oracle route against the JAX package's, on the CPU:
projection.preprocess, binning.bin_gaussians (with and without a per-pair
cull), ops/dense.py, rasterize(backend="xla") with the blend's gradient,
stats.blend_stats through rasterize_stats, the foveated XLA route
(_dual_blend) and MM-FR's per-pair tile-mask route.

Both sides run plain array code: JAX its XLA route, the port plain
PyTorch on CPU tensors. Tolerances: preprocess and binning exact (float
columns within 1e-6), the dense oracle within 1e-6, the rasterizer
within tests/test_rasterize_parity.py's bars (final T 2e-5, images 2e-4,
gradients 5e-3 / 5e-4 of their largest value), the stats within
tests/test_torch_stats.py's (counts exact, contribs 1e-4 / 1e-5), the
foveated and MM-FR frames within T_EPS (1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.eval import mmfr as jmmfr
from fovsplat.ops import binning as jbin
from fovsplat.ops import dense as jdense
from fovsplat.ops import foveated as jfov
from fovsplat.ops import projection as jproj
from fovsplat.ops import rasterize as jrast
from fovsplat.ops import stats as jstats
from fovsplat.train import loops as jloops
from fovsplat.utils import config as jconfig
from fovsplat_torch import convert
from fovsplat_torch.eval import mmfr as tmmfr
from fovsplat_torch.ops import binning as tbin
from fovsplat_torch.ops import dense as tdense
from fovsplat_torch.ops import foveated as tfov
from fovsplat_torch.ops import projection as tproj
from fovsplat_torch.ops import rasterize as trast
from fovsplat_torch.ops import stats as tstats
from fovsplat_torch.train import loops as tloops
from fovsplat_torch.utils import config as tconfig
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud

W, H = 80, 56
GX, GY = 5, 4
CAP = 1 << 13
BG = [0.1, 0.2, 0.3]


def tcam(cam):
    return convert.camera_from_numpy(cam.world_view, cam.full_proj,
                                     cam.cam_center, cam.tan_fovx,
                                     cam.tan_fovy, cam.width, cam.height,
                                     device="cpu")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def cloud():
    """400 Gaussians at 80x56, 20 of them dead in the live mask."""
    arrs = synthetic_cloud(n=400, seed=3, scale_hi=0.2)
    live = np.ones(400, bool)
    live[:20] = False
    return arrs, live, make_test_camera(width=W, height=H)


def _jprep(arrs, cam, live=None, cov=None):
    means, scales, quats = arrs[:3]
    return jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                            jnp.asarray(quats), cam, cov3d_precomp=cov,
                            live_mask=None if live is None
                            else jnp.asarray(live))


def _tprep(jp):
    """A JAX Preprocessed as the port's (bit for bit)."""
    return tproj.Preprocessed(**{
        f.name: torch.from_numpy(np.array(getattr(jp, f.name)))
        for f in dataclasses.fields(tproj.Preprocessed)})


@pytest.mark.parametrize("precomp", [False, True])
def test_preprocess_matches_jax(cloud, precomp):
    """preprocess (and compute_cov2d through cov3d_precomp, given JAX's
    compute_cov3d on both sides; the two compute_cov3d's 3x3 products
    round apart by ulps, which an ill-conditioned conic amplifies):
    integer fields exact, float fields within 1e-6."""
    arrs, live, cam = cloud
    means, scales, quats = arrs[:3]
    jcov = tcov = None
    if precomp:
        jcov = jproj.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
        np.testing.assert_allclose(
            tproj.compute_cov3d(t(scales), t(quats)).numpy(),
            np.asarray(jcov), rtol=1e-6, atol=1e-7)
        tcov = t(jcov)
    jp = _jprep(arrs, cam, live, jcov)
    tp = tproj.preprocess(t(means), t(scales), t(quats), tcam(cam),
                          cov3d_precomp=tcov, live_mask=torch.from_numpy(
                              live))
    for f in dataclasses.fields(tproj.Preprocessed):
        a = getattr(tp, f.name).numpy()
        b = np.asarray(getattr(jp, f.name))
        assert a.dtype == b.dtype, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    v = np.linspace(-1.5, 1.5, 7, dtype=np.float32)
    np.testing.assert_array_equal(tproj.ndc2pix(t(v), W).numpy(),
                                  np.asarray(jproj.ndc2pix(jnp.asarray(v),
                                                           W)))


@pytest.mark.parametrize("case", ["plain", "tile_mask", "capacity_cut"])
def test_bin_gaussians_matches_jax(cloud, case):
    """On the same Preprocessed: every sorted pair, segment bound, count
    and the depth order exact; with a per-pair cull (even tiles of odd
    Gaussians dropped), and with a capacity that cuts the candidates."""
    arrs, live, cam = cloud
    jp = _jprep(arrs, cam, live)
    cap = 1000 if case == "capacity_cut" else CAP
    jmask = tmask = None
    if case == "tile_mask":
        def jmask(g, tile):
            return (g % 2 == 0) | (tile % 2 == 1)

        def tmask(g, tile):
            return (g % 2 == 0) | (tile % 2 == 1)
    jb = jbin.bin_gaussians(jp, GX, GY, cap, tile_mask_fn=jmask)
    tb = tbin.bin_gaussians(_tprep(jp), GX, GY, cap, tile_mask_fn=tmask)
    k = int(jb.num_pairs)
    assert int(tb.num_pairs) == k > 300
    assert int(tb.overflow) == int(jb.overflow)
    assert (int(tb.overflow) > 0) == (case == "capacity_cut")
    np.testing.assert_array_equal(tb.seg_start.numpy(),
                                  np.asarray(jb.seg_start))
    np.testing.assert_array_equal(tb.pair_tile.numpy(),
                                  np.asarray(jb.pair_tile))
    np.testing.assert_array_equal(tb.pair_gauss.numpy()[:k],
                                  np.asarray(jb.pair_gauss)[:k])
    np.testing.assert_array_equal(tb.depth_order.numpy(),
                                  np.asarray(jb.depth_order))


def test_render_dense_matches_jax():
    """The oracle at 150 Gaussians and 80x56 (O(N H W)): render, final T
    and blend_prefix within 1e-6, radii exact."""
    means, scales, quats, ops_, colors = synthetic_cloud(n=150, seed=8,
                                                         scale_hi=0.25)
    cam = make_test_camera(width=W, height=H)
    jo = jdense.render_dense(means, scales, quats, ops_, colors, cam,
                             bg_color=jnp.asarray(BG))
    to = tdense.render_dense(t(means), t(scales), t(quats), t(ops_),
                             t(colors), tcam(cam), bg_color=BG)
    np.testing.assert_allclose(to["render"].numpy(), np.asarray(jo["render"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to["final_T"].numpy(),
                               np.asarray(jo["final_T"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(to["radii"].numpy(),
                                  np.asarray(jo["radii"]))
    a = np.random.default_rng(2).uniform(0, 0.99, (40, 6)).astype(np.float32)
    a[a < 0.2] = 0.0
    for x, y in zip(tdense.blend_prefix(t(a), axis=0),
                    jdense.blend_prefix(jnp.asarray(a), axis=0)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-7)


def test_rasterize_xla_matches_jax_and_kernel_route(cloud):
    """rasterize(backend="xla") against JAX's XLA route: kept pairs exact,
    final T, image and n_contrib, and the gradients of a loss through
    blend and the per-pair gather; then against the port's kernel route
    (the kernels' plain versions here): kept pairs equal, images within
    T_EPS."""
    arrs, live, cam = cloud
    target = np.random.default_rng(4).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    jcfg = jrast.RasterizeConfig(pair_capacity=CAP, chunk=256)

    def jloss(m, s, q, o, c):
        out = jrast.rasterize(m, s, q, o, cam, colors=c,
                              bg_color=jnp.asarray(BG), config=jcfg,
                              live_mask=jnp.asarray(live))
        return (jnp.mean((out["render"] - target) ** 2)
                + 0.1 * jnp.mean(out["final_T"]), out)

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(
        *[jnp.asarray(a) for a in arrs])
    ins = [t(a).requires_grad_(True) for a in arrs]
    out = trast.rasterize(*ins[:4], tcam(cam), colors=ins[4], bg_color=BG,
                          config=trast.RasterizeConfig(pair_capacity=CAP,
                                                       backend="xla"),
                          live_mask=torch.from_numpy(live))
    loss = (torch.mean((out["render"] - t(target)) ** 2)
            + 0.1 * torch.mean(out["final_T"]))
    loss.backward()
    assert int(out["binned"].num_pairs) == int(jout["binned"].num_pairs)
    assert int(out["binned"].overflow) == 0
    np.testing.assert_allclose(out["final_T"].detach().numpy(),
                               np.asarray(jout["final_T"]), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out["render"].detach().numpy(),
                               np.asarray(jout["render"]), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(out["n_contrib"].numpy(),
                                  np.asarray(jout["n_contrib"]))
    np.testing.assert_array_equal(out["radii"].numpy(),
                                  np.asarray(jout["radii"]))
    for name, x, ref in zip(["means", "scales", "quats", "opacities",
                             "colors"], ins, jg):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(x.grad.numpy() / scale, ref / scale,
                                   rtol=5e-3, atol=5e-4, err_msg=name)
    kern = trast.rasterize(*[t(a) for a in arrs[:4]], tcam(cam),
                           colors=t(arrs[4]), bg_color=BG,
                           config=trast.RasterizeConfig(pair_capacity=CAP),
                           live_mask=torch.from_numpy(live))
    assert int(kern["binned"].num_pairs) == int(out["binned"].num_pairs)
    np.testing.assert_allclose(kern["render"].numpy(),
                               out["render"].detach().numpy(), rtol=0,
                               atol=1e-4)


def test_rasterize_rejects_a_mask_on_the_kernel_route(cloud):
    arrs, _, cam = cloud
    with pytest.raises(ValueError, match="backend='xla'"):
        trast.rasterize(*[t(a) for a in arrs[:4]], tcam(cam),
                        colors=t(arrs[4]),
                        tile_mask_fn=lambda g, tile: tile >= 0)


@pytest.mark.parametrize("mode", list(jstats.MODES))
def test_rasterize_stats_xla_matches_jax(cloud, mode):
    """stats.blend_stats through rasterize_stats(backend="xla") against
    JAX's XLA oracle, with the live mask and, for the loss-weighted mode,
    a loss map."""
    arrs, live, cam = cloud
    lm = (np.abs(np.random.default_rng(5).normal(0.5, 0.2, (H, W)))
          .astype(np.float32) if mode == "loss_weighted_max_count" else None)
    out_j = jax.jit(lambda m, s, q, o, c: jstats.rasterize_stats(
        m, s, q, o, cam, colors=c, mode=mode,
        loss_map=None if lm is None else jnp.asarray(lm),
        config=jrast.RasterizeConfig(pair_capacity=CAP, chunk=256),
        live_mask=jnp.asarray(live)))(*[jnp.asarray(a) for a in arrs])
    out_t = tstats.rasterize_stats(
        *[t(a) for a in arrs[:4]], tcam(cam), colors=t(arrs[4]), mode=mode,
        loss_map=None if lm is None else t(lm),
        config=trast.RasterizeConfig(pair_capacity=CAP, backend="xla"),
        live_mask=torch.from_numpy(live))
    assert int(out_t["binned"].num_pairs) == int(out_j["binned"].num_pairs)
    np.testing.assert_allclose(out_t["render"].numpy(),
                               np.asarray(out_j["render"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out_t["final_T"].numpy(),
                               np.asarray(out_j["final_T"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(out_t["gs_count"].numpy(),
                                  np.asarray(out_j["gs_count"]))
    np.testing.assert_allclose(out_t["contribs"].numpy(),
                               np.asarray(out_j["contribs"]), rtol=1e-4,
                               atol=1e-5)
    assert int(out_t["gs_count"].sum()) > 0
    assert float(out_t["contribs"].sum()) > 0


@pytest.fixture(scope="module")
def fov_model():
    """A 600-Gaussian foveated model: 4 levels of DC and opacity, random
    highest levels (20 dead rows at -1)."""
    rng = np.random.default_rng(17)
    n = 600
    means, scales, quats, ops_, _ = synthetic_cloud(n=n, seed=17,
                                                    scale_hi=0.25)
    hl = rng.integers(0, 4, (n,)).astype(np.float32)
    hl[:20] = -1.0
    dcs = rng.normal(0, 0.6, (n, 4, 3)).astype(np.float32)
    op4 = np.clip(ops_[:, None] + rng.normal(0, 0.1, (n, 4)), 0.05,
                  0.95).astype(np.float32)
    rest = rng.normal(0, 0.03, (n, 15, 3)).astype(np.float32)
    return (means, scales, quats, op4, dcs, rest, hl)


@pytest.mark.parametrize("gaze", [(0.5, 0.5), (0.3, 0.7)])
def test_rasterize_fov_xla_matches_jax(fov_model, gaze):
    """The foveated XLA route (bin_gaussians with the level cull,
    _dual_blend) against JAX's, and against the port's kernel route."""
    arrs = fov_model
    out_j = jax.jit(lambda: jfov.rasterize_fov(
        *[jnp.asarray(a) for a in arrs], make_test_camera(W, H),
        gaze=jnp.asarray(gaze, jnp.float32), alpha=0.3,
        bg_color=jnp.asarray(BG),
        config=jrast.RasterizeConfig(pair_capacity=CAP, chunk=256)))()
    cam = tcam(make_test_camera(W, H))
    outs = [tfov.rasterize_fov(
        *[t(a) for a in arrs], cam, torch.tensor(gaze), 0.3, bg_color=BG,
        config=trast.RasterizeConfig(pair_capacity=CAP, backend=b,
                                     sort_exact_depth=True))
        for b in ("xla", "kernels")]
    assert (int(outs[0]["num_pairs"]) == int(outs[1]["num_pairs"])
            == int(out_j["binned"].num_pairs) > 500)
    assert int(outs[0]["overflow"]) == 0
    np.testing.assert_array_equal(outs[0]["tile_blend"].numpy(),
                                  np.asarray(out_j["tile_blend"]))
    assert bool(outs[0]["tile_blend"].any())
    for o in outs:
        np.testing.assert_allclose(o["render"].numpy(),
                                   np.asarray(out_j["render"]), rtol=0,
                                   atol=1e-4)


def test_mmfr_tile_mask_route_matches_jax(fov_model):
    """render_mmfr(backend="xla"), each pass the XLA rasterizer with a
    per-pair tile mask, against JAX's and against the port's fused
    route."""
    means, scales, quats, op4, dcs, _, hl = fov_model
    models = convert.mmfr_models_from_numpy(means, scales, quats, op4, dcs,
                                            hl, device="cpu")
    jmodels = [{k: jnp.asarray(v.numpy()) for k, v in m.items()}
               for m in models]
    gaze = (0.4, 0.6)
    img_j = jax.jit(lambda: jmmfr.render_mmfr(
        jmodels, make_test_camera(W, H), jnp.asarray(gaze, jnp.float32),
        0.3, jrast.RasterizeConfig(pair_capacity=CAP, chunk=256),
        bg_color=jnp.asarray(BG)))()
    cam = tcam(make_test_camera(W, H))
    imgs = [tmmfr.render_mmfr(
        models, cam, torch.tensor(gaze), 0.3,
        trast.RasterizeConfig(pair_capacity=CAP, backend=b,
                              sort_exact_depth=True), bg_color=BG)
        for b in ("xla", "kernels")]
    np.testing.assert_allclose(imgs[0].numpy(), np.asarray(img_j), rtol=0,
                               atol=1e-4)
    assert float(imgs[0].std()) > 0.01
    # The fused route quantizes its pair rows (>40 dB against f32).
    mse = float(((imgs[1] - imgs[0]) ** 2).mean())
    assert 10 * np.log10(1.0 / mse) > 40.0


def test_jax_config_backend_is_ignored(tmp_path):
    """A JAX-written config carries backend "xla" (its default); the port
    keeps its kernel route."""
    path = str(tmp_path / "cfg_args.json")
    jconfig.save_config(path, jloops.LoopConfig())
    assert tconfig.load_config(path, tloops.LoopConfig).raster.backend == \
        "kernels"
