"""The port's whole foveated frame against the JAX package, on the CPU.

rasterize_fov_soa with device="cpu" (plain versions of the three kernels)
against the f32 XLA route (rasterize_fov, backend "xla") and against the
JAX SoA frame on its Pallas kernels in interpret mode, whose pair rows are
quantized to u8/bf16 for inference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovsplat.ops import foveated as jfov
from fovsplat.ops.rasterize import RasterizeConfig as JConfig
from fovsplat_torch.ops import foveated as tfov
from fovsplat_torch.ops.rasterize import RasterizeConfig
from tests.test_torch_parity import ALPHA, GAZES, scene

BG = [0.1, 0.0, 0.2]
CAP = 1 << 14


def port_frame(tm, tc, gaze, **cfg):
    cfg.setdefault("pair_capacity", CAP)
    cfg.setdefault("sort_exact_depth", True)
    return tfov.rasterize_fov_soa(tm, tc, torch.tensor(gaze,
                                                       dtype=torch.float32),
                                  ALPHA, bg_color=BG,
                                  config=RasterizeConfig(**cfg))


@pytest.mark.parametrize("seed", [77, 78])
@pytest.mark.parametrize("gaze", GAZES)
def test_frame_matches_xla_route(seed, gaze):
    arrays, cam, tm, tc = scene(seed)
    out_x = jax.jit(lambda: jfov.rasterize_fov(
        *[jnp.asarray(a) for a in arrays], cam,
        gaze=jnp.asarray(gaze, jnp.float32), alpha=ALPHA,
        bg_color=jnp.asarray(BG), config=JConfig(pair_capacity=CAP,
                                                 chunk=256)))()
    out_t = port_frame(tm, tc, gaze)
    assert int(out_t["num_pairs"]) == int(out_x["binned"].num_pairs)
    assert int(out_t["overflow"]) == 0
    np.testing.assert_array_equal(out_t["tile_blend"].numpy(),
                                  np.asarray(out_x["tile_blend"]))
    img = out_t["render"].numpy()
    assert img.shape == (cam.height, cam.width, 3)
    np.testing.assert_allclose(img, np.asarray(out_x["render"]), rtol=0,
                               atol=1e-4)


def test_frame_matches_pallas_soa_frame():
    gaze = GAZES[0]
    arrays, cam, tm, tc = scene(77)
    jm = jfov.pack_fov_model(*arrays)
    cfg = JConfig(pair_capacity=CAP, chunk=256, backend="pallas",
                  pallas_chunk=128, pallas_interpret=True,
                  sort_exact_depth=True)
    out_p = jax.jit(lambda: jfov.rasterize_fov_soa(
        jm, cam, gaze=jnp.asarray(gaze, jnp.float32), alpha=ALPHA,
        bg_color=jnp.asarray(BG), config=cfg))()
    img_p = np.asarray(out_p["render"], np.float64)
    img_t = port_frame(tm, tc, gaze)["render"].numpy().astype(np.float64)
    # The Pallas route quantizes opacity and colour to u8 and the conic to
    # bf16 (expand_fov.py:441-470) and ends chains at chunk granularity.
    np.testing.assert_allclose(img_t, img_p, rtol=0, atol=1e-2)
    psnr = -10.0 * np.log10(np.mean((img_t - img_p) ** 2))
    assert psnr > 40.0, psnr


def test_overflow_is_counted():
    gaze = GAZES[1]
    _, _, tm, tc = scene(78)
    full = port_frame(tm, tc, gaze)
    kept, cand = int(full["num_pairs"]), int(full["candidates"])
    assert int(full["overflow"]) == 0 and kept > 1000 and cand > kept
    starved = port_frame(tm, tc, gaze, compact_capacity=kept - 37)
    assert int(starved["overflow"]) == 37
    assert int(starved["num_pairs"]) == kept - 37
    assert bool(torch.isfinite(starved["render"]).all())
    short = port_frame(tm, tc, gaze, pair_capacity=cand - 50,
                       compact_capacity=CAP)
    assert int(short["overflow"]) == 50
    assert int(short["num_pairs"]) <= kept


def test_options_keep_the_image():
    """clip_level_rects is output-invariant; the single fused key orders
    like the exact two-key sort on this scene."""
    gaze = GAZES[0]
    _, _, tm, tc = scene(77)
    ref = port_frame(tm, tc, gaze)
    for cfg in (dict(clip_level_rects=False), dict(sort_exact_depth=False),
                dict(chunk=300)):
        out = port_frame(tm, tc, gaze, **cfg)
        assert int(out["num_pairs"]) == int(ref["num_pairs"]), cfg
        np.testing.assert_allclose(out["render"].numpy(),
                                   ref["render"].numpy(), rtol=0, atol=1e-6,
                                   err_msg=str(cfg))
