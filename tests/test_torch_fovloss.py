"""The port's foveated HVS loss, pyramid, metamer and small loss and SH
pieces against the JAX package, on the CPU.

The same numpy inputs (64x96 images from a seed) go through fovsplat and
fovsplat_torch. Each JAX loss compiles once in a module fixture. "Within
1e-5 relative" means the largest absolute difference within 1e-5 of the
largest absolute JAX value of the compared set (the std maps of a flat
band sit at the sqrt(eps) floor, where both packages read rounding
noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import sh as jsh
from fovsplat.perception import foveated_loss as jfl
from fovsplat.perception import metameric as jmeta
from fovsplat.perception import pyramid as jpyr
from fovsplat.train import losses as jlosses
from fovsplat_torch.ops import sh as tsh
from fovsplat_torch.perception import foveated_loss as tfl
from fovsplat_torch.perception import metameric as tmeta
from fovsplat_torch.perception import pyramid as tpyr
from fovsplat_torch.train import losses as tlosses
from tests.torch_cpu import one_torch_thread  # noqa: F401

H, W = 64, 96
GAZES = [(0.5, 0.5), (0.2, 0.8)]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def assert_rel(got, want, tol=1e-5, err_msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        err_msg, np.abs(got - want).max() / scale)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size", [(H, W), (50, 70)])
@pytest.mark.parametrize("gaze", GAZES)
def test_pooling_and_lod_maps_match_jax(size, gaze):
    """At the HVS metric's configuration (alpha 0.05, width 1.0, distance
    0.5). blur_loss's (0.2, 0.2, 0.7) has small pooling angles, where the
    tan(angle_max) - tan(angle_min) cancellation puts the two packages'
    f32 maps up to 4e-5 apart (ROADMAP section 3); its loss is held at
    1e-5 in test_blur_loss_matches_jax."""
    h, w = size
    assert_rel(tfl.make_pooling_size_map_pixels(gaze, h, w, 0.05, 1.0, 0.5,
                                                device="cpu"),
               jfl.make_pooling_size_map_pixels(gaze, h, w, 0.05, 1.0, 0.5),
               err_msg="pooling")
    assert_rel(tfl.make_lod_map(gaze, h, w, 0.05, 1.0, 0.5, device="cpu"),
               jfl.make_lod_map(gaze, h, w, 0.05, 1.0, 0.5), err_msg="lod")


@pytest.mark.parametrize("size", [(H, W), (50, 70)])
def test_radially_varying_blur_matches_jax(size):
    """64x96 halves to 1x1; 50x70 stops at 1x2 and takes the reference's
    width-2 tail. The LOD map is scaled so every mip level is blended."""
    h, w = size
    x = np.random.default_rng(5).uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)
    lod = 3.0 * np.asarray(jfl.make_lod_map((0.2, 0.8), h, w, 0.2, 0.2, 0.7))
    assert lod.max() > 5.0
    want = jax.jit(jfl.radially_varying_blur)(jnp.asarray(x),
                                             jnp.asarray(lod))
    assert_rel(tfl.radially_varying_blur(t(x), t(lod)), want)


def test_mip_tail_of_height_two():
    """A 4x2 image stops at 2x1, where the reference's tail appends the
    mean over the height of the mip before it (the 4x2 image)."""
    x = np.random.default_rng(6).uniform(0, 1, (1, 4, 2, 3)).astype(
        np.float32)
    lod = np.array([[0.0, 0.5], [1.0, 1.5], [2.0, 2.5], [3.0, 0.2]],
                   np.float32)
    assert_rel(tfl.radially_varying_blur(t(x), t(lod)),
               jfl.radially_varying_blur(jnp.asarray(x), jnp.asarray(lod)))


@pytest.fixture(scope="module")
def jax_fov(images):
    """statsmaps_fov of both images and the foveated MSE loss at each
    gaze, one compile per gaze."""
    a, b = images
    out = {}
    for gaze in GAZES:
        def fn(x, y, gaze=gaze):
            sa = jfl.statsmaps_fov(x, gaze)
            return sa, jfl.metameric_loss_fov(x, y, gaze=gaze)
        out[gaze] = jax.jit(fn)(jnp.asarray(a), jnp.asarray(b))
    return out


@pytest.mark.parametrize("gaze", GAZES)
def test_statsmaps_fov_and_loss_match_jax(images, jax_fov, gaze):
    """Means and the lowpass as they are; the std maps squared, as the
    variances they are the root of. Near the gaze the blur is close to
    the identity, so the variance is the rounding noise of meansq - mean^2
    at the 1e-7 floor, which the square root amplifies ~1,600 times."""
    a, b = images
    sj, lj = jax_fov[gaze]
    st = tfl.statsmaps_fov(t(a), gaze)
    assert len(st) == len(sj) == 51
    sj = [np.asarray(x, np.float64) for x in sj]
    st = [y.numpy().astype(np.float64) for y in st]
    for i in range(1, 50, 2):
        sj[i], st[i] = sj[i] ** 2, st[i] ** 2
    scale = max(np.abs(x).max() for x in sj)
    for i, (x, y) in enumerate(zip(sj, st)):
        assert y.shape == x.shape, i
        assert np.abs(y - x).max() <= 1e-5 * scale, i
    lt = float(tfl.metameric_loss_fov(t(a), t(b), gaze=gaze))
    assert float(lj) > 0
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)


@pytest.mark.parametrize("blur_source", [False, True])
def test_blur_loss_matches_jax(images, blur_source):
    a, b = images
    lj = jax.jit(lambda x, y: jmeta.blur_loss(
        x, y, gaze=(0.3, 0.6), blur_source=blur_source))(jnp.asarray(a),
                                                         jnp.asarray(b))
    lt = tmeta.blur_loss(t(a), t(b), gaze=(0.3, 0.6), blur_source=blur_source)
    assert float(lj) > 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_metamer_and_metamer_loss_match_jax(images):
    """JAX's jax.random.uniform draw is injected as the port's noise."""
    a, b = images
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(key, (1, H, W, 3)))
    mj, lj = jax.jit(lambda x, y: (
        jmeta.gen_metamer(x, 2.0, key=key),
        jmeta.metamer_mse_loss(y, x, 2.0, key=key)))(jnp.asarray(a),
                                                     jnp.asarray(b))
    mt = tmeta.gen_metamer(t(a), 2.0, noise=t(noise))
    mj = np.asarray(mj)
    assert np.abs(mt.numpy() - mj).max() <= 1e-5 * np.ptp(mj)
    lt = tmeta.metamer_mse_loss(t(b), t(a), 2.0, noise=t(noise))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # The port's own draw: a seeded generator repeats its metamer.
    g = [torch.Generator().manual_seed(9) for _ in range(2)]
    torch.testing.assert_close(tmeta.gen_metamer(t(a), 2.0, generator=g[0]),
                               tmeta.gen_metamer(t(a), 2.0, generator=g[1]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("filter_type", ["cropped", "full"])
@pytest.mark.parametrize("bilinear", [True, False])
def test_pyramid_round_trip_matches_jax(images, filter_type, bilinear):
    """construct_pyramid (with multiple_highpass) and
    reconstruct_from_pyramid. The cropped 6-orientation lowpass is 2x2,
    so without bilinear resampling the level sizes stop matching and both
    packages raise."""
    x = np.stack(images)
    pj = jpyr.construct_pyramid(jnp.asarray(x), 5, 6, filter_type, bilinear,
                                multiple_highpass=True)
    pt = tpyr.construct_pyramid(t(x), 5, 6, filter_type, bilinear,
                                multiple_highpass=True)
    assert len(pt) == len(pj) == 5
    for lj, lt in zip(pj, pt):
        assert lj.keys() == lt.keys()
        for k in lj:
            for u, v in zip(lj[k] if k == "b" else [lj[k]],
                            lt[k] if k == "b" else [lt[k]]):
                assert_rel(v, u, err_msg=k)
    if filter_type == "cropped" and not bilinear:
        with pytest.raises(TypeError):
            jpyr.reconstruct_from_pyramid(pj, 6, filter_type, bilinear)
        with pytest.raises(RuntimeError):
            tpyr.reconstruct_from_pyramid(pt, 6, filter_type, bilinear)
        return
    assert_rel(tpyr.reconstruct_from_pyramid(pt, 6, filter_type, bilinear),
               jpyr.reconstruct_from_pyramid(pj, 6, filter_type, bilinear))


@pytest.mark.parametrize("pooling_size", [1.0, 3.0])
def test_statsmaps_ycrcb_matches_jax(images, pooling_size):
    """colorspace "YCrCb" takes the image as it is (no RGB conversion)."""
    a, _ = images
    sj = jax.jit(lambda x: jmeta.statsmaps(x, pooling_size,
                                           colorspace="YCrCb"))(
        jnp.asarray(a))
    st = tmeta.statsmaps(t(a), pooling_size, colorspace="YCrCb")
    scale = max(float(np.abs(np.asarray(x)).max()) for x in sj)
    for i, (x, y) in enumerate(zip(sj, st)):
        assert np.abs(y.numpy() - np.asarray(x)).max() <= 1e-5 * scale, i
    rgb = tmeta.statsmaps(t(a), pooling_size)
    assert not torch.equal(rgb[0], st[0])


def test_losses_and_sh_match_jax(images):
    a, b = images
    np.testing.assert_allclose(tlosses.l1_loss_map(t(a), t(b)).numpy(),
                               np.asarray(jlosses.l1_loss_map(a, b)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tlosses.l2_loss(t(a), t(b))),
                               float(jlosses.l2_loss(a, b)), rtol=1e-6)
    rng = np.random.default_rng(4)
    n = 500
    means = rng.normal(0, 1, (n, 3)).astype(np.float32)
    centre = np.array([0.3, -0.2, 4.0], np.float32)
    rest = rng.normal(0, 0.3, (n, 15, 3)).astype(np.float32)
    coef = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    dirs = means - centre
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    for degree in range(4):
        np.testing.assert_allclose(
            tsh.eval_sh_rest(degree, t(rest), t(means), t(centre)).numpy(),
            np.asarray(jsh.eval_sh_rest(degree, rest, means, centre)),
            rtol=0, atol=1e-6, err_msg=f"eval_sh_rest {degree}")
        np.testing.assert_allclose(
            tsh.eval_sh(degree, t(coef), t(dirs)).numpy(),
            np.asarray(jsh.eval_sh(degree, coef, dirs)),
            rtol=0, atol=1e-6, err_msg=f"eval_sh {degree}")
