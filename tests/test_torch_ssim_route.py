"""SSIM's route (train/losses.ssim) on the CPU, where it takes the plain
twin (losses.ssim_plain), and kernel 13b's formula (ops/kernels/ssim.
ssim_grad_plain) against autograd of the twin.

The card's side, kernels 13 and 13b against the twin, is in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from fovsplat_torch.ops.kernels import launch_counters
from fovsplat_torch.ops.kernels import ssim as kernel
from fovsplat_torch.train import losses
from tests.torch_cpu import one_torch_thread  # noqa: F401

SHAPES = [(1, 37, 53, 3), (2, 37, 53, 3)]


def _images(shape, seed=11):
    """Seeded noise and a target 0.1 of noise away, clipped to [0, 1]; a
    black corner and a white one."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, shape), 0, 1).astype(np.float32)
    a[..., :5, :7, :] = b[..., :5, :7, :] = 0.0
    a[..., -4:, -6:, :] = b[..., -4:, -6:, :] = 1.0
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(37, 53, 3)])
def test_cpu_route_is_the_twin(shape, robust):
    """losses.ssim on CPU tensors is ssim_plain, the shift-add code it ran
    before the kernels: the mean and both images' gradients bit for bit."""
    a, b = _images(shape)
    out = []
    for fn in (losses.ssim, losses.ssim_plain):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        v = fn(x, y, robust=robust)
        out.append((v.detach(), *torch.autograd.grad(v, [x, y])))
    assert all(torch.equal(p, q) for p, q in zip(*out))
    assert 0.5 < float(out[0][0]) < 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_ssim_grad_plain_matches_autograd(shape):
    """Kernel 13b's formula (the three coefficient maps of each image,
    blurred, combined with a and b) against autograd of the twin, both in
    float64 on the same f32 images: each image's gradient within 1e-6 of
    its largest value. (In float32 two forms of the same gradient differ
    by up to ~1.6e-6 of it from rounding alone, so f64 isolates the
    formula.)"""
    a, b = (t.double() for t in _images(shape))
    da, db = kernel.ssim_grad_plain(a, b)
    x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ra, rb = torch.autograd.grad(losses.ssim_plain(x, y), [x, y])
    for got, ref in ((da, ra), (db, rb)):
        scale = float(ref.abs().max())
        assert scale > 0
        assert float((got - ref).abs().max()) <= 1e-6 * scale


def test_window_is_the_twins_and_symmetric():
    """The taps passed to the kernels are _gaussian_1d's f32 values, and
    symmetric bit for bit, so the blur is its own transpose (13b)."""
    taps = list(kernel.window(1.5).g)
    ref = losses._gaussian_1d(11, 1.5)
    assert torch.equal(torch.tensor(taps, dtype=torch.float32), ref)
    assert taps == taps[::-1]
    assert kernel.C1 == float(np.float32(0.01 ** 2))
    assert kernel.C2 == float(np.float32(0.03 ** 2))


def test_launch_counters_list_the_ssim_kernels():
    """ssim_forward and ssim_backward are kernel launch counters (a graph
    replay adds its captured calls to them)."""
    counters = launch_counters()
    assert counters["ssim_forward"] == (kernel.ssim_forward, "launches")
    assert counters["ssim_backward"] == (kernel.ssim_backward, "launches")


@pytest.mark.parametrize("bad, match", [
    ("size", "window 7"), ("dtype", "float32"), ("channels", r"\(H, W, 3\)"),
    ("shapes", "differ"), ("device", "CUDA")])
def test_route_refuses_what_the_kernels_do_not_take(bad, match):
    """Off the CPU, losses.ssim takes the kernels or raises: another
    window, dtype or channel count, unequal shapes, no CUDA device."""
    shape, size, dtype = (2, 16, 24, 3), 11, torch.float32
    if bad == "channels":
        shape = (2, 16, 24, 4)
    size = 7 if bad == "size" else size
    dtype = torch.float64 if bad == "dtype" else dtype
    a = torch.empty(shape, dtype=dtype, device="meta")
    b = a[:1] if bad == "shapes" else a
    with pytest.raises(ValueError, match=match):
        losses.ssim(a, b, size)
