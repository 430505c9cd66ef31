"""The uniform HVS loss's route (ops/kernels/hvs_loss.uniform_loss) on the
CPU, where it takes the plain twin: against today's
metameric.metameric_loss_uniform and the JAX package's, loss and image
gradient, L1 and MSE; the twin's pooled grids (kernel 11's function)
against statsmaps' maps; the kernels' plan of the benchmark's image.

Images: 64x96 (a multiple of 32, not resized) and 50x70 (resized to
64x96), at pooling sizes 1, 3 and 5.5 (at 5.5 the area bins overlap);
against JAX three of those six, each size and each pooling size once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.perception import metameric as jmeta
from fovsplat_torch.ops.kernels import hvs_loss
from fovsplat_torch.perception import metameric as tmeta
from tests.torch_cpu import one_torch_thread  # noqa: F401

SHAPES = [(64, 96), (50, 70)]
POOLINGS = [1.0, 3.0, 5.5]
LOSSES = ("L1", "MSE")


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _images(shape):
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _loss_and_grad(fn, a):
    x = t(a).requires_grad_(True)
    loss = fn(x)
    return loss.detach(), torch.autograd.grad(loss, x)[0]


def _route(a, b, pooling, loss_type):
    return _loss_and_grad(lambda x: hvs_loss.uniform_loss(
        x, t(b), pooling, loss_type=loss_type), a)


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("shape", SHAPES)
def test_route_matches_twin(shape, pooling):
    """uniform_loss on CPU tensors equals resize_for_pyramid and
    metameric_loss_uniform bit for bit, loss and image gradient, L1 and
    MSE."""
    a, b = _images(shape)
    for lt in LOSSES:
        loss, grad = _route(a, b, pooling, lt)
        ref, ref_grad = _loss_and_grad(
            lambda x: tmeta.metameric_loss_uniform(
                tmeta.resize_for_pyramid(x), tmeta.resize_for_pyramid(t(b)),
                pooling, loss_type=lt), a)
        assert torch.equal(loss, ref) and torch.equal(grad, ref_grad), lt
        assert grad.shape == shape + (3,) and float(loss) > 0


@pytest.mark.parametrize("shape, pooling", [(SHAPES[0], 1.0),
                                            (SHAPES[1], 3.0),
                                            (SHAPES[0], 5.5)])
def test_route_matches_jax(shape, pooling):
    """uniform_loss on CPU tensors against the JAX package's
    metameric_loss_uniform of the resized images (one compile gives both
    losses and their gradients): the loss within 1e-5 relative, the image
    gradient within 1e-5 of its largest value (f32 sums in another
    order)."""
    a, b = _images(shape)

    def jfn(x, y):
        yr = jmeta.resize_for_pyramid(y, 5)
        return [jax.value_and_grad(lambda z: jmeta.metameric_loss_uniform(
            jmeta.resize_for_pyramid(z, 5), yr, pooling, loss_type=lt))(x)
            for lt in LOSSES]
    for lt, (jl, jg) in zip(LOSSES, jax.jit(jfn)(jnp.asarray(a),
                                                 jnp.asarray(b))):
        loss, grad = _route(a, b, pooling, lt)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5,
                                   err_msg=lt)
        jg = np.asarray(jg)
        scale = np.abs(jg).max()
        err = np.abs(grad.numpy() - jg).max()
        assert scale > 0 and err <= 1e-5 * scale, (lt, err / scale)


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pooled_grids_upsampled_are_statsmaps(shape, pooling):
    """The twin's pooled grids (pooled_grids_plain: kernel 11's function),
    brought up as uniform_blur does and through _find_stats' std, equal
    statsmaps' mean and std maps bit for bit, and its last lowpass the
    last map; at a level whose pooling size is 1 the grid is the band."""
    a, _ = _images(shape)
    grids, last = hvs_loss.pooled_grids_plain(t(a), pooling)
    maps = tmeta.statsmaps(tmeta.resize_for_pyramid(t(a)), pooling)
    assert len(maps) == 2 * len(grids) + 1 == 51
    sizes = [pooling] + [pooling / 2 ** (i // 6) for i in range(24)]
    for i, ((s1, _), ps) in enumerate(zip(grids, sizes)):
        h, w = maps[2 * i].shape[1:3]
        assert s1.shape[1:3] == ((h, w) if ps == 1 else (
            tmeta._pooled(h, ps), tmeta._pooled(w, ps))), i
    up = hvs_loss.maps_from_grids_plain(grids, last, pooling, *shape)
    assert len(up) == len(maps)
    for i, (x, y) in enumerate(zip(up, maps)):
        assert torch.equal(x, y), i


def test_plan_of_the_benchmark_image():
    """The kernels' plan of the HVS cell's 1237x822 image at pooling 3:
    resized to 1248x832, four band levels each pooled onto 277x416 (up
    onto it at levels 2 and 3), 7 bands at level 0 and 6 after, 51 maps,
    and the levels' weights 1 / (51 x 3 h w) in f32."""
    p = hvs_loss.plan(822, 1237, 3.0, 5, "cpu")
    assert (p.rh, p.rw) == (832, 1248)
    assert p.resize.h.idx is not None and p.resize.h_in == 822
    assert [(lv.h, lv.w, lv.gh, lv.gw, lv.nb) for lv in p.levels] == [
        (832, 1248, 277, 416, 7), (416, 624, 277, 416, 6),
        (208, 312, 277, 416, 6), (104, 156, 277, 416, 6)]
    assert [(lv.ah.n, lv.ah.g, lv.aw.n, lv.aw.g) for lv in p.levels] == [
        (lv.h, lv.gh, lv.w, lv.gw) for lv in p.levels]
    assert hvs_loss._n_maps(p) == 51
    wts, w4 = hvs_loss._weights(p, 1)
    assert wts[0] == float(np.float32(1 / 51) / np.float32(3 * 832 * 1248))
    assert w4 == float(np.float32(1 / 51) / np.float32(3 * 52 * 78))
    # A size already at the pyramid's: no resize.
    assert hvs_loss.plan(64, 96, 1.0, 5, "cpu").resize.h.idx is None


def test_route_refuses_what_the_kernels_do_not_take():
    """Off the CPU the route takes the kernels or raises: not CUDA, or on
    the card another orientation count."""
    x = torch.empty((8, 8, 3), device="meta")
    with pytest.raises(ValueError, match="need"):
        hvs_loss.uniform_loss(x, x, 3.0)
    with pytest.raises(ValueError, match="levels"):
        hvs_loss.plan(64, 64, 3.0, 1, "cpu")
