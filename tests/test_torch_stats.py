"""The port's counting rasterizer and kernel 8's plain version against the
JAX package, on the CPU.

fovsplat runs its fused Pallas route in interpret mode; fovsplat_torch
runs kernel 4's and kernel 8's plain versions (ops/kernels/expand_ps1,
ops/blend.blend_stats_plain) and kernel 7's for the sums. Tolerances are
tests/test_stats.py's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import binning as jbin
from fovsplat.ops import projection as jproj
from fovsplat.ops import stats as jstats
from fovsplat.ops.pallas import blend_stats as jbs
from fovsplat.ops.rasterize import RasterizeConfig as JConfig
from fovsplat_torch import convert
from fovsplat_torch.ops import binning as tbin
from fovsplat_torch.ops import blend as tblend
from fovsplat_torch.ops import stats as tstats
from fovsplat_torch.ops.kernels import blend_stats as tbs
from fovsplat_torch.ops.kernels import fetch_count as tfc
from fovsplat_torch.ops.rasterize import RasterizeConfig as TConfig
from tests.test_stats import _fetch_oracle
from tests.test_torch_train import ps1_columns
from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.utils import make_test_camera, synthetic_cloud


def tcam(cam):
    return convert.camera_from_numpy(cam.world_view, cam.full_proj,
                                     cam.cam_center, cam.tan_fovx,
                                     cam.tan_fovy, cam.width, cam.height,
                                     device="cpu")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def setup():
    """tests/test_stats.py's scene: n=256 at 96x64."""
    means, scales, quats, ops_, colors = synthetic_cloud(n=256, seed=11)
    return (means, scales, quats, ops_, colors), make_test_camera(96, 64)


@pytest.mark.parametrize("mode", list(jstats.MODES))
def test_rasterize_stats_matches_jax_pallas(setup, mode):
    arrs, cam = setup
    lm = (np.abs(np.random.default_rng(5).normal(
        0.5, 0.2, (cam.height, cam.width))).astype(np.float32)
        if mode == "loss_weighted_max_count" else None)
    kw = dict(loss_map=None if lm is None else jnp.asarray(lm))
    jcfg = JConfig(pair_capacity=1 << 13, chunk=256, backend="pallas",
                   pallas_chunk=128, pallas_interpret=True)
    out_j = jax.jit(lambda m, s, q, o, c: jstats.rasterize_stats(
        m, s, q, o, cam, colors=c, mode=mode, config=jcfg, **kw))(
            *[jnp.asarray(a) for a in arrs])
    out_t = tstats.rasterize_stats(
        *[t(a) for a in arrs[:4]], tcam(cam), colors=t(arrs[4]), mode=mode,
        loss_map=None if lm is None else t(lm),
        config=TConfig(pair_capacity=1 << 13))
    assert int(out_t["binned"].num_pairs) == int(out_j["binned"].num_pairs)
    assert int(out_t["binned"].overflow) == 0
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
    np.testing.assert_array_equal(out_t["radii"].numpy(),
                                  np.asarray(out_j["radii"]))
    assert int(out_t["gs_count"].sum()) > 0
    assert float(out_t["contribs"].sum()) > 0


def test_blend_stats_plain_matches_pallas_kernel(setup):
    """blend_stats_plain against blend_stats_pallas(interpret=True) on the
    same sorted train rows (the fused binning's), at a camera that leaves
    padding pixels in the edge tiles."""
    (means, scales, quats, ops_, colors), _ = setup
    cam = make_test_camera(width=90, height=60)
    gx, gy = 6, 4
    prep = jproj.preprocess_cols(jnp.asarray(means), jnp.asarray(scales),
                                 jnp.asarray(quats), cam)
    cols = [jnp.asarray(c) for c in ps1_columns(prep, ops_, colors)]
    packed, seg, nump, _, _, _ = jbin.bin_fused_ps1(
        cols, prep.valid, prep.depth, gx, gy, 1 << 13, interpret=True,
        train=True)
    col_j, T_j, st_j, arg_j = jbs.blend_stats_pallas(
        packed, seg[:-1], seg[1:], gx, gy, 128, -4.5, True,
        width=cam.width, height=cam.height)
    k = int(nump)
    col, T, st, best_lane, best_w, first_trig = tbs.blend_stats(
        t(np.asarray(packed)[:9]), torch.from_numpy(np.array(seg)), gx,
        cam.width, cam.height)
    np.testing.assert_allclose(col.numpy(), np.asarray(col_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st[:, :k].numpy(), np.asarray(st_j)[:4, :k],
                               rtol=1e-5, atol=1e-5)
    assert not st[:, k:].any()
    arg = np.asarray(arg_j)
    np.testing.assert_array_equal(best_lane.numpy(), arg[..., 0])
    np.testing.assert_array_equal(first_trig.numpy(), arg[..., 2])
    np.testing.assert_allclose(best_w.numpy(), arg[..., 1], rtol=1e-5,
                               atol=1e-6)
    # The scene exercises every output: contributions, wins, and padding
    # pixels that never blend.
    assert k > 500 and float(st[1].sum()) > 1000
    assert int((best_lane < k).sum()) > 1000
    inside = tblend.tile_inside_mask(gx, gy, cam.width, cam.height)
    assert not inside.all()
    assert bool((T[~inside] == 1.0).all())
    assert bool((best_lane[~inside] == packed.shape[1]).all())


@pytest.mark.parametrize("wh", [(64, 48), (61, 45)])
def test_gs_count_exact_fetch_semantics(wh):
    """tests/test_stats.py:185-250 on the port: on a cloud dense enough
    that tiles saturate a few 256-pair rounds in, mode "sum" counts
    exactly the pairs the reference fetches, and mode "max" counts the
    power-window passes within a slack of 1 on at most 3 Gaussians
    (borderline freezes, within f32 noise of T_EPS, can flip between the
    product and the oracle's f64 chain). (61, 45) is not tile-aligned:
    padding pixels start done and must not count."""
    rng = np.random.default_rng(5)
    n = 3000
    means = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(-0.3, 0.3, n)
    scales = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4))
    quats = (quats / np.linalg.norm(quats, axis=1, keepdims=True)
             ).astype(np.float32)
    ops_ = rng.uniform(0.7, 0.99, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cam = make_test_camera(width=wh[0], height=wh[1])
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    cfg = TConfig(pair_capacity=1 << 16)
    args = [t(a) for a in (means, scales, quats, ops_)]
    out = tstats.rasterize_stats(*args, tcam(cam), colors=t(colors),
                                 mode="sum", config=cfg)
    prep = jax.jit(lambda m, s, q: jproj.preprocess(m, s, q, cam))(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats))
    bn = out["binned"]
    gs_ref, geo_ref = _fetch_oracle(bn, prep, ops_, cam, n, gx * gy, gx)
    assert gs_ref.sum() < int(bn.num_pairs)     # the early exit triggered
    np.testing.assert_array_equal(out["gs_count"].numpy(), gs_ref)

    out_m = tstats.rasterize_stats(*args, tcam(cam), colors=t(colors),
                                   mode="max", config=cfg)
    gd = np.abs(out_m["gs_count"].numpy() - geo_ref)
    assert gd.max() <= 1 and (gd > 0).sum() <= 3, (gd.max(), (gd > 0).sum())


def test_tile_helpers_match_jax():
    gx, gy, w, h = 5, 4, 70, 55
    rng = np.random.default_rng(2)
    np.testing.assert_array_equal(
        tblend.tile_inside_mask(gx, gy, w, h).numpy(),
        np.asarray(jstats.tile_inside_mask(gx, gy, w, h)))
    img = rng.normal(0, 1, (h, w)).astype(np.float32)
    np.testing.assert_array_equal(
        tstats.image_to_tiles(t(img), gx, gy).numpy(),
        np.asarray(jstats.image_to_tiles(jnp.asarray(img), gx, gy)))
    T = gx * gy
    seg = np.concatenate([[0], np.cumsum(rng.integers(0, 900, T))]).astype(
        np.int32)
    ft = rng.integers(0, 900, (T, 256)).astype(np.float32)
    ft[rng.random((T, 256)) < 0.2] = float(1 << 30)
    ft[3] = float(1 << 30)
    ft[5] = rng.integers(0, 40, 256)
    inside = np.asarray(jstats.tile_inside_mask(gx, gy, w, h))
    np.testing.assert_array_equal(
        tfc.tile_fetch_counts(t(ft), torch.from_numpy(seg),
                              torch.from_numpy(inside.copy())).numpy(),
        np.asarray(jstats.tile_fetch_counts(jnp.asarray(ft),
                                            jnp.asarray(seg),
                                            jnp.asarray(inside), T)))


def test_rasterize_stats_rejects_unknown_mode(setup):
    arrs, cam = setup
    with pytest.raises(ValueError, match="mode"):
        tstats.rasterize_stats(*[t(a) for a in arrs[:4]], tcam(cam),
                               colors=t(arrs[4]), mode="mean")


def test_stats_binning_is_the_train_route(setup):
    """rasterize_stats bins through the same kernel-4 route as the train
    step: its pair list equals bin_fused_ps1's on the same columns."""
    arrs, cam = setup
    means, scales, quats, ops_, colors = arrs
    prep = jproj.preprocess_cols(jnp.asarray(means), jnp.asarray(scales),
                                 jnp.asarray(quats), cam)
    cols = ps1_columns(prep, ops_, colors)
    pairs, bn = tbin.bin_fused_ps1([t(c) for c in cols],
                                   torch.from_numpy(np.asarray(prep.valid)),
                                   t(np.asarray(prep.depth)), 6, 4, 1 << 13)
    out = tstats.rasterize_stats(*[t(a) for a in arrs[:4]], tcam(cam),
                                 colors=t(colors), mode="sum",
                                 config=TConfig(pair_capacity=1 << 13))
    k = int(bn.num_pairs)
    assert int(out["binned"].num_pairs) == k
    np.testing.assert_array_equal(out["binned"].seg_start.numpy(),
                                  bn.seg_start.numpy())
    np.testing.assert_array_equal(out["binned"].pair_gauss[:k].numpy(),
                                  bn.pair_gauss[:k].numpy())
